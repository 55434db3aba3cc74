// Dense parts of one v05_noz VSS stage: the tiled GEMM with its epilogue,
// the row LayerNorm and the depthwise 3x3 conv + SiLU.  With the selective
// scan of nk_scan.cu they replace the TPU kernel
// xfmamba_tpu/ops/vss_block_pallas_v2.py::_vss_stage_kernel_v2 (:542), which
// computes a whole stage of VSSBlocks in one Pallas call.  The host wrapper
// (xfmamba_tpu_torch/ops/vss_stage.py) launches them block by block.
//
// What bounds them on the H100:
// - gemm_nt: a shared-memory tiled SIMT GEMM (64x64 tile, 4x4 outputs per
//   thread, float32 FMA).  The stage matmuls are large (M = B*H*W rows), so
//   they would be tensor-core bound; this first version runs on the FP32
//   pipes instead (67 TFLOP/s peak, well under the 989 TFLOP/s of bf16
//   wgmma).  Moving to wgmma/TMA is later work.
// - layer_norm: one warp per row, three passes over the row (L1-resident);
//   bound by device-memory bandwidth.
// - dwconv3_silu: one thread per output element, channels fastest so the
//   nine taps read coalesced NHWC rows; bound by device-memory bandwidth.
#include "common.cuh"

namespace xfm {

constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 16;
constexpr int kGemmThreads = 256;

// out[M, N] = epilogue(A[M, K] @ W[N, K]^T): W in nn.Linear layout.
// epilogue: + bias[n] (float32), exact-erf GELU, + res[m, n]; all in float32.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_kernel(const T* __restrict__ A, const T* __restrict__ Wt,
               const float* __restrict__ bias, const T* __restrict__ res,
               T* __restrict__ out, int M, int N, int K, int gelu) {
  __shared__ float As[kGemmBK][kGemmBM + 4];
  __shared__ float Ws[kGemmBK][kGemmBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.y) * kGemmBM;
  const int n0 = blockIdx.x * kGemmBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
    for (int e = tid; e < kGemmBM * kGemmBK; e += kGemmThreads) {
      const int r = e / kGemmBK;
      const int kk = e % kGemmBK;
      const int k = k0 + kk;
      const long long m = m0 + r;
      const int n = n0 + r;
      As[kk][r] = (m < M && k < K) ? to_f32(A[m * K + k]) : 0.f;
      Ws[kk][r] = (n < N && k < K) ? to_f32(Wt[static_cast<long long>(n) * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        w[i] = Ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[n];
      if (gelu) v = gelu_erf(v);
      if (res) v += to_f32(res[m * N + n]);
      out[m * N + n] = from_f32<T>(v);
    }
  }
}

// y[r, :] = (x[r, :] - mean) * rstd * w + b, statistics in float32.
template <typename IT, typename OT>
__global__ void layer_norm_kernel(const IT* __restrict__ x, const float* __restrict__ w,
                                  const float* __restrict__ b, OT* __restrict__ y,
                                  long long rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const IT* xr = x + row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + eps);
  OT* yr = y + row * C;
  for (int c = lane; c < C; c += 32) yr[c] = from_f32<OT>((to_f32(xr[c]) - mu) * rstd * w[c] + b[c]);
}

// y = silu(depthwise_conv3x3(x, zero padding 1) + bias) on NHWC maps;
// w9 is (9, C) with tap (dy, dx) at row dy * 3 + dx.
template <typename T>
__global__ void dwconv3_silu_kernel(const T* __restrict__ x, const float* __restrict__ w9,
                                    const float* __restrict__ bias, T* __restrict__ y,
                                    int B, int H, int W, int C) {
  const long long total = static_cast<long long>(B) * H * W * C;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % C);
    const long long p = idx / C;
    const int wq = static_cast<int>(p % W);
    const int h = static_cast<int>((p / W) % H);
    const long long b = p / (static_cast<long long>(W) * H);
    float acc = bias ? bias[c] : 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int hh = h + dy - 1;
      if (hh < 0 || hh >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ww = wq + dx - 1;
        if (ww < 0 || ww >= W) continue;
        acc = fmaf(to_f32(x[((b * H + hh) * W + ww) * C + c]), w9[(dy * 3 + dx) * C + c], acc);
      }
    }
    y[idx] = from_f32<T>(silu(acc));
  }
}

}  // namespace xfm

using namespace xfm;

extern "C" const char* xfm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

extern "C" int xfm_gemm_nt(const void* a, const void* w, const float* bias, const void* res,
                           void* out, long long M, int N, int K, int dtype, int gelu,
                           void* stream) {
  const dim3 grid(ceil_div(N, kGemmBN), ceil_div(M, kGemmBM));
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    gemm_nt_kernel<float><<<grid, kGemmThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), bias,
        static_cast<const float*>(res), static_cast<float*>(out), static_cast<int>(M), N, K, gelu);
  } else if (dtype == kBF16) {
    gemm_nt_kernel<__nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w), bias,
        static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out),
        static_cast<int>(M), N, K, gelu);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int xfm_layer_norm(const void* x, const float* w, const float* b, void* y,
                              long long rows, int C, int in_dtype, int out_dtype, float eps,
                              void* stream) {
  constexpr int kThreads = 256;
  const int grid = ceil_div(rows, kThreads / 32);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32 && out_dtype == kF32) {
    layer_norm_kernel<float, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), w, b, static_cast<float*>(y), rows, C, eps);
  } else if (in_dtype == kF32 && out_dtype == kBF16) {
    layer_norm_kernel<float, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), w, b, static_cast<__nv_bfloat16*>(y), rows, C, eps);
  } else if (in_dtype == kBF16 && out_dtype == kBF16) {
    layer_norm_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, b, static_cast<__nv_bfloat16*>(y), rows, C, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int xfm_dwconv3_silu(const void* x, const float* w9, const float* bias, void* y,
                                int B, int H, int W, int C, int dtype, void* stream) {
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(B) * H * W * C;
  const int grid = ceil_div(total, kThreads) < 65535 * 16 ? ceil_div(total, kThreads) : 65535 * 16;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    dwconv3_silu_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), w9, bias, static_cast<float*>(y), B, H, W, C);
  } else if (dtype == kBF16) {
    dwconv3_silu_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w9, bias, static_cast<__nv_bfloat16*>(y), B, H, W,
        C);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
