// Dense backward pieces of one v05_noz VSSBlock: the row LayerNorm
// backward and the depthwise 3x3 conv + SiLU backward.  With the strided
// GEMM of vss_stage.cu and the adjoint scan of nk_scan_bwd.cu they replace
// the TPU kernel xfmamba_tpu/ops/vss_block_v2_adjoint.py::
// _vss_block_bwd_kernel (:128), which computes a whole block's backward in
// one Pallas call.  The host sequence is
// xfmamba_tpu_torch/ops/vss_block_train.py::vss_block_bwd.
//
// What bounds them on the H100:
// - layer_norm_bwd: one warp per row (three passes over the row, held in
//   L1), bound by device-memory bandwidth.  The weight and bias gradients
//   are sums over all rows: each block adds its rows into a shared-memory
//   row with shared atomics, then adds that row into the zeroed float32
//   output with one global atomicAdd per channel, so global atomics scale
//   with the number of blocks, not of rows.
// - dwconv3_silu_bwd: two launches.  The first recomputes the conv and the
//   SiLU derivative and writes d(pre-activation) (one thread per channel,
//   walking a chunk of positions, so the nine tap-weight sums and the bias
//   sum stay in registers until one atomicAdd each at the end); the second
//   gathers the input gradient from the nine neighbours.  Both read NHWC
//   rows coalesced; bound by device-memory bandwidth.
#include "common.cuh"

namespace xfm {

// g: upstream gradient (rows, C) float32; x: the LayerNorm's input; the
// statistics are recomputed as the forward computes them.
// dx = (g*w - mean(g*w) - xhat * mean(g*w*xhat)) * rstd (+ dres);
// dw += sum_rows g * xhat; db += sum_rows g.
template <typename IT>
__global__ void layer_norm_bwd_kernel(const float* __restrict__ g, const IT* __restrict__ x,
                                      const float* __restrict__ w,
                                      const float* __restrict__ dres, float* __restrict__ dx,
                                      float* __restrict__ dw, float* __restrict__ db,
                                      long long rows, int C, float eps) {
  extern __shared__ float part[];  // [dw | db], 2 * C floats
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) part[c] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  for (long long row = static_cast<long long>(blockIdx.x) * warps + threadIdx.x / 32; row < rows;
       row += static_cast<long long>(gridDim.x) * warps) {
    const IT* xr = x + row * C;
    const float* gr = g + row * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f32(xr[c]) - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f32(xr[c]) - mu) * rstd;
      const float gg = gr[c] * w[c];
      s1 += gg;
      s2 += gg * xh;
      atomicAdd(&part[c], gr[c] * xh);
      atomicAdd(&part[C + c], gr[c]);
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
    float* dxr = dx + row * C;
    const float* dr = dres ? dres + row * C : nullptr;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f32(xr[c]) - mu) * rstd;
      float d = (gr[c] * w[c] - m1 - xh * m2) * rstd;
      if (dr) d += dr[c];
      dxr[c] = d;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    atomicAdd(&dw[c], part[c]);
    atomicAdd(&db[c], part[C + c]);
  }
}

// Pass 1 of the conv + SiLU backward.  du: gradient of u = silu(acc)
// (float32, NHWC); x: the conv input; acc = conv3x3(x) + bias is recomputed.
// Writes dacc = du * silu'(acc) and adds the tap-weight and bias gradients
// of this thread's channel over its chunk of positions.
template <typename T>
__global__ void dwconv3_silu_bwd_acc_kernel(const float* __restrict__ du,
                                            const T* __restrict__ x,
                                            const float* __restrict__ w9,
                                            const float* __restrict__ bias,
                                            float* __restrict__ dacc, float* __restrict__ dw9,
                                            float* __restrict__ dbias, int B, int H, int W, int C,
                                            int chunk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long P = static_cast<long long>(B) * H * W;
  const long long p0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long p1 = p0 + chunk < P ? p0 + chunk : P;
  float wt[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wt[t] = w9[t * C + c];
  float gw[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float gb = 0.f;
  const float b0 = bias ? bias[c] : 0.f;
  for (long long p = p0; p < p1; ++p) {
    const int wq = static_cast<int>(p % W);
    const int h = static_cast<int>((p / W) % H);
    const long long img = p / (static_cast<long long>(W) * H);
    float xv[9];
    float acc = b0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int hh = h + dy - 1;
        const int ww = wq + dx - 1;
        const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
        xv[dy * 3 + dx] = in ? to_f32(x[((img * H + hh) * W + ww) * C + c]) : 0.f;
        acc = fmaf(xv[dy * 3 + dx], wt[dy * 3 + dx], acc);
      }
    }
    const float sig = 1.f / (1.f + expf(-acc));
    const float d = du[p * C + c] * (sig * (1.f + acc * (1.f - sig)));
    dacc[p * C + c] = d;
    gb += d;
#pragma unroll
    for (int t = 0; t < 9; ++t) gw[t] = fmaf(xv[t], d, gw[t]);
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) atomicAdd(&dw9[t * C + c], gw[t]);
  atomicAdd(&dbias[c], gb);
}

// Pass 2: dx[h, w] = sum over taps (dy, dx) of dacc[h - dy + 1, w - dx + 1] * w9[dy, dx].
__global__ void dwconv3_bwd_input_kernel(const float* __restrict__ dacc,
                                         const float* __restrict__ w9, float* __restrict__ dx,
                                         int B, int H, int W, int C) {
  const long long total = static_cast<long long>(B) * H * W * C;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % C);
    const long long p = idx / C;
    const int wq = static_cast<int>(p % W);
    const int h = static_cast<int>((p / W) % H);
    const long long img = p / (static_cast<long long>(W) * H);
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int hh = h - dy + 1;
      if (hh < 0 || hh >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ww = wq - dx + 1;
        if (ww < 0 || ww >= W) continue;
        acc = fmaf(dacc[((img * H + hh) * W + ww) * C + c], w9[(dy * 3 + dx) * C + c], acc);
      }
    }
    dx[idx] = acc;
  }
}

}  // namespace xfm

using namespace xfm;

extern "C" int xfm_layer_norm_bwd(const float* g, const void* x, const float* w,
                                  const float* dres, float* dx, float* dw, float* db,
                                  long long rows, int C, int in_dtype, float eps, void* stream) {
  constexpr int kThreads = 256;
  const size_t smem = 2 * static_cast<size_t>(C) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int want = ceil_div(rows, kThreads / 32);
  const int grid = want < 132 * 8 ? want : 132 * 8;
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32) {
    layer_norm_bwd_kernel<float><<<grid, kThreads, smem, s>>>(
        g, static_cast<const float*>(x), w, dres, dx, dw, db, rows, C, eps);
  } else if (in_dtype == kBF16) {
    layer_norm_bwd_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        g, static_cast<const __nv_bfloat16*>(x), w, dres, dx, dw, db, rows, C, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int xfm_dwconv3_silu_bwd(const float* du, const void* x, const float* w9,
                                    const float* bias, float* dacc, float* dx, float* dw9,
                                    float* dbias, int B, int H, int W, int C, int dtype,
                                    void* stream) {
  constexpr int kThreads = 128;
  constexpr int kChunk = 256;
  const long long P = static_cast<long long>(B) * H * W;
  const dim3 grid1(ceil_div(C, kThreads), ceil_div(P, kChunk));
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    dwconv3_silu_bwd_acc_kernel<float><<<grid1, kThreads, 0, s>>>(
        du, static_cast<const float*>(x), w9, bias, dacc, dw9, dbias, B, H, W, C, kChunk);
  } else if (dtype == kBF16) {
    dwconv3_silu_bwd_acc_kernel<__nv_bfloat16><<<grid1, kThreads, 0, s>>>(
        du, static_cast<const __nv_bfloat16*>(x), w9, bias, dacc, dw9, dbias, B, H, W, C,
        kChunk);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kThreads2 = 256;
  const long long total = P * C;
  const int grid2 = ceil_div(total, kThreads2) < 65535 * 16 ? ceil_div(total, kThreads2) : 65535 * 16;
  dwconv3_bwd_input_kernel<<<grid2, kThreads2, 0, s>>>(dacc, w9, dx, B, H, W, C);
  return cudaGetLastError();
}
