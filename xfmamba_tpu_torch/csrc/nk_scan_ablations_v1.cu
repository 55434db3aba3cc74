// The first design of kernels 17 and 18 (the v4 and wide-state nk scans),
// kept for old-against-new timings: `nk_scan_v4_first` / `nk_scan_v3_first`
// of ops/ablations/nk_scan_v4.py / nk_scan_wide.py launch it, and nothing on
// a model's path does.  nk_scan_ablations.cu holds the current design and
// says what it changed.
//
// Both compute kernel 2's function: for each kind k the recurrence runs flat
// over the L = H * W positions of one image, in the kind's traversal order,
//   delta = softplus(dts[l, k] + bias[k])
//   h[n]  = exp(delta * A[k, n]) * h[n] + delta * u[l] * B[l, k, n]
//   y[l] += sum_n C[l, k, n] * h[n]          (y starts at u[l] * Dsum)
//
// Kernel 17 (v4): one thread per (image, channel, state n), a block of N
// warps x 32 channels; every step's operands loaded from device memory
// inside the walk; the states' C h summed per tile of 16 positions through
// shared memory between two barriers; the kinds walked one after another,
// each kind's partial y through a float32 scratch in device memory.
//
// Kernel 18 (v3): one thread per (image, channel), blocks of 64 threads,
// the kind pairs walked one after the other, forward and reverse chain of a
// pair in one loop with exp2 of A log2(e); every step's operands loaded
// from device memory and each step's y added into a float32 scratch in
// device memory, then a pass writes the output.
#include "common.cuh"

namespace xfm {
namespace nk_ablations_v1 {

constexpr int kNkMaxN = 16;
constexpr int kV4Tile = 16;      // positions per tile of kernel 17's y reduction
constexpr int kV3Threads = 64;

struct NkParams {
  const void* u;      // (n_img, L, D)
  const void* dts;    // (n_img, L, K * D)
  const void* Bp;     // (n_img, L, K * N)
  const void* Cp;     // (n_img, L, K * N)
  const float* A;     // (K, N, D); kernel 18: pre-scaled by log2(e)
  const float* bias;  // (K, D)
  const float* Dsum;  // (D,)
  float* acc;         // (n_img, L, D) float32 scratch
  void* out;          // (n_img, L, D), u's dtype
  int H, W, D, K, N, kinds;
};

// the row-major position l = h * W + w that step t of `kind` visits
// (0 row_f, 1 col_f, 2 row_r, 3 col_r)
__device__ __forceinline__ int position(int t, int kind, int H, int W) {
  const int L = H * W;
  const int tt = kind >= 2 ? L - 1 - t : t;
  return (kind & 1) ? (tt % H) * W + tt / H : tt;
}

template <typename T>
__global__ void __launch_bounds__(32 * kNkMaxN) nk_scan_v4_kernel(NkParams p) {
  __shared__ float ys[kNkMaxN][kV4Tile][32];
  const int lane = threadIdx.x & 31;
  const int n = threadIdx.x >> 5;                   // the state this warp walks
  const int c = blockIdx.x * 32 + lane;
  const bool active = c < p.D;
  const int L = p.H * p.W;
  const long long row0 = static_cast<long long>(blockIdx.y) * L;
  const long long KD = static_cast<long long>(p.K) * p.D;
  const long long KN = static_cast<long long>(p.K) * p.N;
  const T* u = static_cast<const T*>(p.u);
  const T* dts = static_cast<const T*>(p.dts);
  const T* Bp = static_cast<const T*>(p.Bp);
  const T* Cp = static_cast<const T*>(p.Cp);
  T* out = static_cast<T*>(p.out);

  for (int k = 0; k < p.K; ++k) {
    const int kind = (p.kinds >> (2 * k)) & 3;
    const float a_n = active ? p.A[(static_cast<long long>(k) * p.N + n) * p.D + c] : 0.f;
    const float bias = active ? p.bias[k * p.D + c] : 0.f;
    const bool first = k == 0;
    const bool last = k == p.K - 1;
    float h = 0.f;
    for (int t0 = 0; t0 < L; t0 += kV4Tile) {
      const int steps = min(kV4Tile, L - t0);
      for (int j = 0; j < steps; ++j) {
        float yv = 0.f;
        if (active) {
          const long long row = row0 + position(t0 + j, kind, p.H, p.W);
          const float delta = softplus20(to_f32(dts[row * KD + k * p.D + c]) + bias);
          const long long bc = row * KN + k * p.N + n;
          h = fmaf(expf(delta * a_n), h, delta * to_f32(u[row * p.D + c]) * to_f32(Bp[bc]));
          yv = to_f32(Cp[bc]) * h;
        }
        ys[n][j][lane] = yv;
      }
      __syncthreads();  // every thread reaches it: no branch on `active` around the tile
      for (int e = threadIdx.x; e < steps * 32; e += blockDim.x) {
        const int j = e >> 5;
        const int cc = blockIdx.x * 32 + (e & 31);
        if (cc < p.D) {
          float s = 0.f;
          for (int m = 0; m < p.N; ++m) s += ys[m][j][e & 31];
          const long long o = (row0 + position(t0 + j, kind, p.H, p.W)) * p.D + cc;
          const float v = (first ? to_f32(u[o]) * p.Dsum[cc] : p.acc[o]) + s;
          if (last) {
            out[o] = from_f32<T>(v);
          } else {
            p.acc[o] = v;
          }
        }
      }
      __syncthreads();  // the tile's buffer is read before the next tile writes it
    }
  }
}

// one step of a kernel-18 chain of kind k at row `row`: all N states, then
// the position's y added into the thread's accumulator column
template <typename T, int MAXN>
__device__ __forceinline__ void v3_step(const NkParams& p, int k, long long row, int c,
                                        float bias, const float (&a)[MAXN], float (&h)[MAXN]) {
  const long long KN = static_cast<long long>(p.K) * p.N;
  const long long o = row * p.D + c;
  const float delta = softplus20(
      to_f32(static_cast<const T*>(p.dts)[row * p.K * p.D + k * p.D + c]) + bias);
  const float du = delta * to_f32(static_cast<const T*>(p.u)[o]);
  const T* bp = static_cast<const T*>(p.Bp) + row * KN + k * p.N;
  const T* cp = static_cast<const T*>(p.Cp) + row * KN + k * p.N;
  float y = 0.f;
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < p.N) {
      h[n] = fmaf(exp2f(delta * a[n]), h[n], du * to_f32(bp[n]));
      y = fmaf(to_f32(cp[n]), h[n], y);
    }
  }
  p.acc[o] += y;
}

// pair i: forward kind index (pair_f >> 4i) & 15, reverse kind index
// ((pair_r >> 4i) & 15) - 1, -1 for a forward chain alone
template <typename T, int MAXN>
__global__ void __launch_bounds__(kV3Threads) nk_scan_v3_kernel(NkParams p, int n_pairs,
                                                                 int pair_f, int pair_r) {
  const int c = blockIdx.x * kV3Threads + threadIdx.x;
  if (c >= p.D) return;  // no barrier in this kernel
  const int L = p.H * p.W;
  const long long row0 = static_cast<long long>(blockIdx.y) * L;
  const T* u = static_cast<const T*>(p.u);
  const float dsum = p.Dsum[c];
  for (int l = 0; l < L; ++l) {
    const long long o = (row0 + l) * p.D + c;
    p.acc[o] = to_f32(u[o]) * dsum;
  }
  for (int i = 0; i < n_pairs; ++i) {
    const int kf = (pair_f >> (4 * i)) & 15;
    const int kr = ((pair_r >> (4 * i)) & 15) - 1;
    const int kind_f = (p.kinds >> (2 * kf)) & 3;
    const int kind_r = kr >= 0 ? (p.kinds >> (2 * kr)) & 3 : 0;
    float af[MAXN], ar[MAXN], hf[MAXN], hr[MAXN];
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      af[n] = n < p.N ? p.A[(static_cast<long long>(kf) * p.N + n) * p.D + c] : 0.f;
      ar[n] = n < p.N && kr >= 0 ? p.A[(static_cast<long long>(kr) * p.N + n) * p.D + c] : 0.f;
      hf[n] = 0.f;
      hr[n] = 0.f;
    }
    const float bias_f = p.bias[kf * p.D + c];
    const float bias_r = kr >= 0 ? p.bias[kr * p.D + c] : 0.f;
    for (int t = 0; t < L; ++t) {
      v3_step<T, MAXN>(p, kf, row0 + position(t, kind_f, p.H, p.W), c, bias_f, af, hf);
      if (kr >= 0) v3_step<T, MAXN>(p, kr, row0 + position(t, kind_r, p.H, p.W), c, bias_r, ar, hr);
    }
  }
  T* out = static_cast<T*>(p.out);
  for (int l = 0; l < L; ++l) {
    const long long o = (row0 + l) * p.D + c;
    out[o] = from_f32<T>(p.acc[o]);
  }
}

template <typename T>
cudaError_t launch_v3(const NkParams& p, int n_img, int n_pairs, int pair_f, int pair_r,
                      cudaStream_t s) {
  const dim3 grid(ceil_div(p.D, kV3Threads), n_img);
  if (p.N <= 4) {
    nk_scan_v3_kernel<T, 4><<<grid, kV3Threads, 0, s>>>(p, n_pairs, pair_f, pair_r);
  } else {
    nk_scan_v3_kernel<T, kNkMaxN><<<grid, kV3Threads, 0, s>>>(p, n_pairs, pair_f, pair_r);
  }
  return cudaGetLastError();
}

inline bool nk_args_ok(int n_img, int H, int W, int D, int K, int N) {
  return n_img >= 1 && n_img <= 65535 && H >= 1 && W >= 1 && D >= 1 && K >= 1 && K <= 4 &&
         N >= 1 && N <= kNkMaxN;
}

}  // namespace nk_ablations_v1
}  // namespace xfm

using namespace xfm;
using namespace xfm::nk_ablations_v1;

extern "C" int xfm_nk_scan_v4_first(const void* u, const void* dts, const void* Bp, const void* Cp,
                              const float* A, const float* bias, const float* Dsum, float* acc,
                              void* out, int n_img, int H, int W, int D, int K, int N, int kinds,
                              int dtype, void* stream) {
  if (!nk_args_ok(n_img, H, W, D, K, N) || (K > 1 && !acc)) return cudaErrorInvalidValue;
  const NkParams p{u, dts, Bp, Cp, A, bias, Dsum, acc, out, H, W, D, K, N, kinds};
  const dim3 grid(ceil_div(D, 32), n_img);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    nk_scan_v4_kernel<float><<<grid, 32 * N, 0, s>>>(p);
  } else if (dtype == kBF16) {
    nk_scan_v4_kernel<__nv_bfloat16><<<grid, 32 * N, 0, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int xfm_nk_scan_v3_first(const void* u, const void* dts, const void* Bp, const void* Cp,
                              const float* A_log2e, const float* bias, const float* Dsum,
                              float* acc, void* out, int n_img, int H, int W, int D, int K, int N,
                              int kinds, int n_pairs, int pair_f, int pair_r, int dtype,
                              void* stream) {
  if (!nk_args_ok(n_img, H, W, D, K, N) || !acc || n_pairs < 1 || n_pairs > 4)
    return cudaErrorInvalidValue;
  const NkParams p{u, dts, Bp, Cp, A_log2e, bias, Dsum, acc, out, H, W, D, K, N, kinds};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_v3<float>(p, n_img, n_pairs, pair_f, pair_r, s);
  if (dtype == kBF16) return launch_v3<__nv_bfloat16>(p, n_img, n_pairs, pair_f, pair_r, s);
  return cudaErrorInvalidValue;
}
