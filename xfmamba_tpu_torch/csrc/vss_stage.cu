// Dense parts of one v05_noz VSS stage: the tiled SIMT GEMM with its
// epilogue, the row LayerNorm and the depthwise 3x3 conv + SiLU.  With the
// tensor-core GEMM of gemm_tc.cu and the chunked scan of ss2d_core_n1.cu
// they replace the TPU kernel
// xfmamba_tpu/ops/vss_block_pallas_v2.py::_vss_stage_kernel_v2 (:542), which
// computes a whole stage of VSSBlocks in one Pallas call.  The host wrapper
// (xfmamba_tpu_torch/ops/vss_stage.py) launches them block by block.
//
// What bounds them on the H100:
// - gemm: a shared-memory tiled SIMT GEMM (64x64 tile, 4x4 outputs per
//   thread, float32 FMA, any strides), on the FP32 pipes (67 TFLOP/s
//   peak).  It serves the float32 products (kernel 12's rank gradients;
//   TF32 stays off in the port) and the serial sequence that
//   ops/vss_stage.py::SERIAL_OPS keeps for comparison; every bfloat16
//   product of the blocks takes gemm_tc.cu instead
//   (ops/primitives.py::gemm_plan).
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

// out[m, n] = epilogue(sum_k A(m, k) * B(n, k)), with A(m, k) at
// a[m * sam + k * sak] and B(n, k) at b[n * sbn + k * sbk].  The strides
// give every layout the block and its gradient need: A @ W^T against an
// nn.Linear weight (sak = sbk = 1), dX = dY @ W (sbn = 1) and
// dW = dY^T @ X (sam = sbn = 1, the reduction over all rows).
// Epilogue, in float32 and in this order: + bias[n], exact-erf GELU,
// * scale[m / scale_rows] (a per-sample drop-path mask), + res[m, n]; the
// output row stride is ldc (res shares it, and may alias out).  res is
// float32 or bfloat16 whatever the output's type (res_f32), so a float32
// residual stream can feed a bfloat16 output and the other way round.  With
// splits > 1 the K axis is cut into `splits` slices (grid.z) whose partial
// sums are added into a zeroed float32 out with atomicAdd, and no epilogue
// applies: that is how the weight gradients, with K = B * H * W rows and a
// small output, fill the card.
struct GemmParams {
  const void* a;
  const void* b;
  const float* bias;
  const float* scale;
  const void* res;
  void* out;
  long long M, sam, sak, sbn, sbk, ldc;
  int N, K, scale_rows, gelu, splits, res_f32;
};

// A_K / B_K: k is the contiguous axis of A / B (load order, fixed at
// compile time so the forward's A @ W^T keeps its plain index arithmetic).
template <typename T, typename OT, bool A_K, bool B_K>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmParams p) {
  __shared__ float As[kGemmBK][kGemmBM + 4];
  __shared__ float Bs[kGemmBK][kGemmBN + 4];
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.y) * kGemmBM;
  const int n0 = blockIdx.x * kGemmBN;
  // this block's slice of K, a multiple of kGemmBK
  const int kslice = ((p.K + p.splits - 1) / p.splits + kGemmBK - 1) / kGemmBK * kGemmBK;
  const int kbeg = blockIdx.z * kslice;
  const int kend = min(p.K, kbeg + kslice);
  // load order: along k when k is the contiguous axis, else along rows,
  // so that neighbouring threads read neighbouring addresses
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kGemmBK) {
    for (int e = tid; e < kGemmBM * kGemmBK; e += kGemmThreads) {
      int r = A_K ? e / kGemmBK : e % kGemmBM;
      int kk = A_K ? e % kGemmBK : e / kGemmBM;
      const long long m = m0 + r;
      As[kk][r] = (m < p.M && k0 + kk < kend)
                      ? to_f32(A[m * p.sam + (A_K ? k0 + kk : (k0 + kk) * p.sak)])
                      : 0.f;
      r = B_K ? e / kGemmBK : e % kGemmBN;
      kk = B_K ? e % kGemmBK : e / kGemmBN;
      const int n = n0 + r;
      Bs[kk][r] = (n < p.N && k0 + kk < kend)
                      ? to_f32(B[static_cast<long long>(n) * p.sbn +
                                 (B_K ? k0 + kk : (k0 + kk) * p.sbk)])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        w[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  OT* out = static_cast<OT*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.N) continue;
      const long long o = m * p.ldc + n;
      float v = acc[i][j];
      if (p.splits > 1) {
        atomicAdd(reinterpret_cast<float*>(out) + o, v);
        continue;
      }
      if (p.bias) v += p.bias[n];
      if (p.gelu) v = gelu_erf(v);
      if (p.scale) v *= p.scale[m / p.scale_rows];
      if (p.res)
        v += p.res_f32 ? static_cast<const float*>(p.res)[o]
                       : to_f32(static_cast<const __nv_bfloat16*>(p.res)[o]);
      out[o] = from_f32<OT>(v);
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
// w9 is (9, C) with tap (dy, dx) at row dy * 3 + dx.  y16, when given, also
// receives y rounded to bfloat16 (the v1 block keeps u in float32 for its
// scan and feeds x_proj the rounded copy).
template <typename T>
__global__ void dwconv3_silu_kernel(const T* __restrict__ x, const float* __restrict__ w9,
                                    const float* __restrict__ bias, T* __restrict__ y,
                                    __nv_bfloat16* __restrict__ y16, int B, int H, int W, int C) {
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
    const float v = silu(acc);
    y[idx] = from_f32<T>(v);
    if (y16) y16[idx] = __float2bfloat16(v);
  }
}

template <typename T, typename OT>
cudaError_t launch_gemm(const GemmParams& p, dim3 grid, cudaStream_t s) {
  if (p.sak == 1 && p.sbk == 1) gemm_kernel<T, OT, true, true><<<grid, kGemmThreads, 0, s>>>(p);
  else if (p.sak == 1) gemm_kernel<T, OT, true, false><<<grid, kGemmThreads, 0, s>>>(p);
  else if (p.sbk == 1) gemm_kernel<T, OT, false, true><<<grid, kGemmThreads, 0, s>>>(p);
  else gemm_kernel<T, OT, false, false><<<grid, kGemmThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace xfm

using namespace xfm;

extern "C" const char* xfm_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

extern "C" int xfm_gemm(const void* a, const void* b, const float* bias, const float* scale,
                        const void* res, void* out, long long M, int N, int K, long long sam,
                        long long sak, long long sbn, long long sbk, long long ldc,
                        int scale_rows, int gelu, int splits, int in_dtype, int out_dtype,
                        int res_dtype, void* stream) {
  if (splits < 1 || (splits > 1 && (out_dtype != kF32 || bias || scale || res || gelu)) ||
      (scale && scale_rows < 1) || (res && res_dtype != kF32 && res_dtype != kBF16))
    return cudaErrorInvalidValue;
  const GemmParams p{a, b, bias, scale, res, out, M, sam, sak, sbn, sbk, ldc,
                     N, K, scale_rows, gelu, splits, res_dtype == kF32};
  const dim3 grid(ceil_div(N, kGemmBN), ceil_div(M, kGemmBM), splits);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32 && out_dtype == kF32) return launch_gemm<float, float>(p, grid, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return launch_gemm<__nv_bfloat16, __nv_bfloat16>(p, grid, s);
  if (in_dtype == kBF16 && out_dtype == kF32) return launch_gemm<__nv_bfloat16, float>(p, grid, s);
  return cudaErrorInvalidValue;
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
                                void* y16, int B, int H, int W, int C, int dtype, void* stream) {
  if (y16 && dtype != kF32) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(B) * H * W * C;
  const int grid = ceil_div(total, kThreads) < 65535 * 16 ? ceil_div(total, kThreads) : 65535 * 16;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    dwconv3_silu_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), w9, bias, static_cast<float*>(y),
        static_cast<__nv_bfloat16*>(y16), B, H, W, C);
  } else if (dtype == kBF16) {
    dwconv3_silu_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w9, bias, static_cast<__nv_bfloat16*>(y), nullptr,
        B, H, W, C);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
