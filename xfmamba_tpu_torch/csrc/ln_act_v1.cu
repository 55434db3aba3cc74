// The first design of kernels 19-21 (a warp a pixel), kept for the old-against-new
// timings of chip_smoke.py phase 10c and one card test: ln_act.cu holds the
// redesign.  Entries xfm_ln_act_first, xfm_seg_ln_fwd_first and
// xfm_seg_ln_bwd_first take the arguments that design's entries took.
//
// - kernel 19, entry xfm_ln_act_first, replaced
//   xfmamba_tpu/ops/ablations/pe_fused.py::_ln_act_kernel (:46): one warp per
//   pixel in the natural (rows, C) layout, statistics by warp_sum in float32.
// - kernel 20, entry xfm_seg_ln_fwd_first, replaced
//   xfmamba_tpu/ops/ablations/seg_ln.py::_seg_ln_fwd_kernel (:101).  The TPU
//   kernel packs P = lcm(C, 128) / C pixels into one row of full lanes; here
//   the packing is carried to warps: a pixel takes a segment of `seg` lanes
//   (seg = gcd(C, 32) below C = 128, else 32), so one warp serves 32 / seg
//   pixels at once (C = 48: two pixels, 16 lanes x 3 channels each) and no
//   lane idles.  The moments are segmented shuffle sums (xor offsets below
//   seg stay inside the segment).  Kernels 19 and 20 compute one function and
//   share `ln_act_fwd_kernel`; kernel 19 is its seg = 32 case.
// - kernel 21, entry xfm_seg_ln_bwd_first, replaced
//   xfmamba_tpu/ops/ablations/seg_ln.py::_seg_ln_bwd_kernel (:110).  It
//   recomputes each pixel's statistics, takes the derivative of the
//   forward's own GELU, Phi(z) + z phi(z) with erff, forms m1 = mean(gg) and
//   m2 = mean(gg xhat) per pixel and writes dx in x's dtype.  dscale and
//   dbias are column sums over the rows: each block writes its float32
//   partial row (a fixed-order pass over its rows, in thread groups summed in
//   a fixed order), and a second launch adds the partial rows in a fixed
//   order.  No float atomics, so the sums do not change from run to run.
//   Rows past the end are masked.
//
// The GELU is the erf form everywhere (the port's GELU, as the JAX suite
// pins it with GELU_TANH = False); forward and backward use the same one.
//
// What bounds them on the H100: device-memory bandwidth.  A forward reads x
// once and writes y once (the second and third passes over a pixel hit L1);
// the backward reads x and g and writes dx, and reads x and g again from L2
// for its column sums.
#include "common.cuh"

namespace xfm {
namespace ln_first {

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;

// sum over the `seg` lanes of this lane's segment (seg a power of two <= 32)
__device__ __forceinline__ float seg_sum(float v, int seg) {
  for (int off = seg >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// d/dz of 0.5 z (1 + erf(z / sqrt 2)): Phi(z) + z phi(z)
__device__ __forceinline__ float gelu_erf_grad(float z) {
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * 0.39894228040143268f * expf(-0.5f * z * z);
}

// y[r] = act((x[r] - mean) * rstd * w + b) for each pixel r of (rows, C);
// lane l serves pixel l / seg of its warp, channels l % seg + i * seg
template <typename T>
__global__ void __launch_bounds__(kLnThreads) ln_act_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    T* __restrict__ y, long long rows, int C, int seg, float eps, int act) {
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * kLnWarps + threadIdx.x / 32;
  const long long row = warp * (32 / seg) + lane / seg;
  const bool valid = row < rows;
  const int c0 = lane % seg;
  const T* xr = x + (valid ? row : 0) * C;
  float s = 0.f;
  if (valid)
    for (int c = c0; c < C; c += seg) s += to_f32(xr[c]);
  const float mu = seg_sum(s, seg) / C;
  float v = 0.f;
  if (valid) {
    for (int c = c0; c < C; c += seg) {
      const float d = to_f32(xr[c]) - mu;
      v += d * d;
    }
  }
  const float rstd = rsqrtf(seg_sum(v, seg) / C + eps);
  if (!valid) return;  // after the last shuffle
  T* yr = y + row * C;
  for (int c = c0; c < C; c += seg) {
    float z = (to_f32(xr[c]) - mu) * rstd * w[c] + b[c];
    if (act) z = gelu_erf(z);
    yr[c] = from_f32<T>(z);
  }
}

// Kernel 21, first launch.  Block j covers rows [j * rpb, (j + 1) * rpb):
// (1) each pixel's dx, its mean and rstd kept in shared memory; (2) the
// block's column sums of g' xhat and g' (g' = g * gelu'(z) with act) into
// partial[q * C + c][j] (q 0: dscale, 1: dbias).
template <typename T>
__global__ void __launch_bounds__(kLnThreads) seg_ln_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ dx, float* __restrict__ partial,
    long long rows, int C, int seg, int rpb, float eps, int act) {
  extern __shared__ float smem[];
  float* mu_s = smem;                 // (rpb,)
  float* rstd_s = smem + rpb;         // (rpb,)
  float* part = smem + 2 * rpb;       // (2 * kLnThreads,)
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / seg;
  const int c0 = lane % seg;
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const int nrows = static_cast<int>(min(static_cast<long long>(rpb), rows - r0));

  // (1) per pixel, one segment of lanes each; the loop bound is warp-uniform
  for (int base = (threadIdx.x / 32) * per_warp; base < rpb; base += kLnWarps * per_warp) {
    const int rb = base + lane / seg;
    const bool valid = rb < nrows;
    const long long off = (r0 + (valid ? rb : 0)) * C;
    const T* xr = x + off;
    const T* gr = g + off;
    float s = 0.f;
    if (valid)
      for (int c = c0; c < C; c += seg) s += to_f32(xr[c]);
    const float mu = seg_sum(s, seg) / C;
    float v = 0.f;
    if (valid) {
      for (int c = c0; c < C; c += seg) {
        const float d = to_f32(xr[c]) - mu;
        v += d * d;
      }
    }
    const float rstd = rsqrtf(seg_sum(v, seg) / C + eps);
    float s1 = 0.f, s2 = 0.f;
    if (valid) {
      for (int c = c0; c < C; c += seg) {
        const float xhat = (to_f32(xr[c]) - mu) * rstd;
        float gv = to_f32(gr[c]);
        if (act) gv *= gelu_erf_grad(xhat * w[c] + b[c]);
        const float gg = gv * w[c];
        s1 += gg;
        s2 += gg * xhat;
      }
    }
    const float m1 = seg_sum(s1, seg) / C;
    const float m2 = seg_sum(s2, seg) / C;
    if (!valid) continue;  // no shuffle below in this iteration
    if (c0 == 0) {
      mu_s[rb] = mu;
      rstd_s[rb] = rstd;
    }
    T* dxr = dx + off;
    for (int c = c0; c < C; c += seg) {
      const float xhat = (to_f32(xr[c]) - mu) * rstd;
      float gv = to_f32(gr[c]);
      if (act) gv *= gelu_erf_grad(xhat * w[c] + b[c]);
      dxr[c] = from_f32<T>((gv * w[c] - m1 - xhat * m2) * rstd);
    }
  }
  __syncthreads();

  // (2) column sums over the block's rows, in a fixed order
  const int groups = C < kLnThreads ? kLnThreads / C : 1;
  for (int cb = 0; cb < C; cb += kLnThreads) {
    const int j = groups > 1 ? threadIdx.x / C : 0;
    const int c = groups > 1 ? threadIdx.x % C : cb + threadIdx.x;
    float ds = 0.f, db = 0.f;
    if (j < groups && c < C) {
      for (int r = j; r < nrows; r += groups) {
        const long long o = (r0 + r) * C + c;
        const float xhat = (to_f32(x[o]) - mu_s[r]) * rstd_s[r];
        float gv = to_f32(g[o]);
        if (act) gv *= gelu_erf_grad(xhat * w[c] + b[c]);
        ds += gv * xhat;
        db += gv;
      }
    }
    if (groups > 1) {
      if (j < groups) {
        part[2 * (j * C + c)] = ds;
        part[2 * (j * C + c) + 1] = db;
      }
      __syncthreads();
      if (threadIdx.x < C) {
        ds = db = 0.f;
        for (int i = 0; i < groups; ++i) {
          ds += part[2 * (i * C + threadIdx.x)];
          db += part[2 * (i * C + threadIdx.x) + 1];
        }
      }
    }
    if (c < C && (groups == 1 || threadIdx.x < C)) {
      partial[static_cast<long long>(c) * gridDim.x + blockIdx.x] = ds;
      partial[static_cast<long long>(C + c) * gridDim.x + blockIdx.x] = db;
    }
  }
}

// Kernel 21, second launch: dsb[col] = sum_j partial[col][j] over the n
// blocks, one block per column, a fixed strided split and a fixed tree.
__global__ void __launch_bounds__(kLnThreads) seg_ln_bwd_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ dsb, int n) {
  __shared__ float s[kLnThreads];
  const float* pc = partial + static_cast<long long>(blockIdx.x) * n;
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += kLnThreads) v += pc[i];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int off = kLnThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) dsb[blockIdx.x] = s[0];
}

inline bool seg_ok(int C, int seg) {
  return C >= 1 && seg >= 1 && seg <= 32 && (seg & (seg - 1)) == 0;
}

cudaError_t launch_ln_act(const void* x, const float* w, const float* b, void* y,
                          long long rows, int C, int seg, int act, float eps, int dtype,
                          cudaStream_t s) {
  if (!seg_ok(C, seg) || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int grid = ceil_div(rows, static_cast<long long>(kLnWarps) * (32 / seg));
  if (dtype == kF32) {
    ln_act_fwd_kernel<float><<<grid, kLnThreads, 0, s>>>(
        static_cast<const float*>(x), w, b, static_cast<float*>(y), rows, C, seg, eps, act);
  } else if (dtype == kBF16) {
    ln_act_fwd_kernel<__nv_bfloat16><<<grid, kLnThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w, b, static_cast<__nv_bfloat16*>(y), rows, C,
        seg, eps, act);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace ln_first
}  // namespace xfm

using namespace xfm;
using namespace xfm::ln_first;

extern "C" int xfm_ln_act_first(const void* x, const float* w, const float* b, void* y,
                                long long rows, int C, int act, float eps, int dtype,
                                void* stream) {
  return launch_ln_act(x, w, b, y, rows, C, 32, act, eps, dtype,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int xfm_seg_ln_fwd_first(const void* x, const float* w, const float* b, void* y,
                                    long long rows, int C, int seg, int act, float eps,
                                    int dtype, void* stream) {
  return launch_ln_act(x, w, b, y, rows, C, seg, act, eps, dtype,
                       static_cast<cudaStream_t>(stream));
}

// partial: (2 * C, ceil(rows / rpb)) float32 scratch; dsb: (2, C) float32
extern "C" int xfm_seg_ln_bwd_first(const void* x, const void* g, const float* w,
                                    const float* b, void* dx, float* partial, float* dsb,
                                    long long rows, int C, int seg, int rpb, int act, float eps,
                                    int dtype, void* stream) {
  if (!seg_ok(C, seg) || rows < 1 || rpb < 1 || rpb > 4096) return cudaErrorInvalidValue;
  const int n = ceil_div(rows, rpb);
  const size_t smem = (2 * static_cast<size_t>(rpb) + 2 * kLnThreads) * sizeof(float);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    seg_ln_bwd_kernel<float><<<n, kLnThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), w, b,
        static_cast<float*>(dx), partial, rows, C, seg, rpb, eps, act);
  } else if (dtype == kBF16) {
    seg_ln_bwd_kernel<__nv_bfloat16><<<n, kLnThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), w, b,
        static_cast<__nv_bfloat16*>(dx), partial, rows, C, seg, rpb, eps, act);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  seg_ln_bwd_sum_kernel<<<2 * C, kLnThreads, 0, s>>>(partial, dsb, n);
  return cudaGetLastError();
}
