// Selective scan over whole H x W maps for K traversal kinds and N states.
//
// One kernel serves the fusion scans of the inference path (the stage
// kernel's d_state-1 cross2d scans moved to the chunked kernel of
// ss2d_core_n1.cu; ops/cross2d_scan.py keeps this one on the same
// operands as the serial route that chip_smoke.py times beside it):
// - xfmamba_tpu/ops/vss_block_pallas_v2.py::_nk_scan_kernel_v2 (:890),
//   the ShallowFuse scan from precomputed deltas (K = 1, kind row_f,
//   N = 16);
// - ::_nk_scan_x_kernel_v2 (:944), the Cross_SS2Dv5 rank-form scan (K = 4
//   cross2d, N = 16); its out-norm LayerNorm epilogue is the row LayerNorm
//   of vss_stage.cu, launched right after this kernel by the same wrapper.
//
// For each kind k the recurrence runs flat over all L = H * W positions of
// one image, in traversal order:
//   row_f: l = t          row_r: l = L - 1 - t
//   col_f: t = w * H + h  (column-major, the state carries across columns)
//   col_r: col_f reversed
//   delta = softplus(z + bias[k]),  z = dts[l, k] or sum_r rank[l, k, r] * w_dt[k, r]
//   h[n]  = exp(delta * A[k, n]) * h[n] + delta * u[l] * B[l, k, n]
//   y[l] += sum_n C[l, k, n] * h[n]          (y starts at u[l] * Dsum)
//
// Design: one thread per (image, channel) chain, the N states in registers,
// kinds walked one after the other by the same thread, so the partial sums
// of y need no synchronisation (they go through a float32 scratch `acc`
// that only this thread touches).  In NHWC neighbouring threads take
// neighbouring channels, so every traversal reads and writes coalesced
// rows; the per-position B, C and rank values are warp-wide broadcasts.
//
// What bounds it on the H100: the dependent chain of L steps per thread
// (latency), not bandwidth or arithmetic.  The fusion calls it serves walk
// short maps (L = 49) with many chains: ShallowFuse B * 1,536, the
// Cross_SS2Dv5 call 3B * 1,536 chains of 4 * 49 steps, N = 16 states in
// registers, so a chunked split of L would buy little there.  On the long
// backbone maps (2B * 192 chains of 4 * 3,136 steps at stage 0) most
// of the card idled, which is why the stage's scans left this kernel.
#include "common.cuh"

namespace xfm {

constexpr int kScanThreads = 64;
constexpr int kScanMaxR = 64;

struct ScanParams {
  const void* u;       // (n_img, L, D)
  const void* dts;     // precomputed deltas: row stride dt_stride, kind stride D
  const void* ranks;   // rank form: row stride rank_stride, kind stride R
  const float* w_dt;   // (K, R, D)
  const void* Bp;      // B[l, k, n] at row * bc_stride + k * bc_k_stride + n * bc_n_stride
  const void* Cp;      // C, same strides as B
  const float* A;      // (K, N, D)
  const float* bias;   // (K, D)
  const float* Dsum;   // (D,)
  float* acc;          // (n_img, L, D) scratch, used when K > 1
  void* out;           // (n_img, L, D)
  int H, W, D, K, N, R, kinds;
  int dt_stride, rank_stride, bc_stride, bc_k_stride, bc_n_stride;
};

template <typename T, typename OT, int MAXN, bool RANK>
__global__ void __launch_bounds__(kScanThreads) selective_scan_kernel(ScanParams p) {
  __shared__ float wdt_s[RANK ? kScanMaxR * kScanThreads : 1];
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  const bool active = c < p.D;
  const int L = p.H * p.W;
  const long long row0 = static_cast<long long>(blockIdx.y) * L;
  const T* u = static_cast<const T*>(p.u);
  const T* Bp = static_cast<const T*>(p.Bp);
  const T* Cp = static_cast<const T*>(p.Cp);
  OT* out = static_cast<OT*>(p.out);
  const float dsum = active ? p.Dsum[c] : 0.f;

  for (int k = 0; k < p.K; ++k) {
    if (RANK) {
      __syncthreads();
      for (int r = 0; r < p.R; ++r)
        wdt_s[r * kScanThreads + threadIdx.x] =
            active ? p.w_dt[(static_cast<long long>(k) * p.R + r) * p.D + c] : 0.f;
      __syncthreads();
    }
    if (!active) continue;  // no barrier below this point in the iteration
    const int kind = (p.kinds >> (2 * k)) & 3;  // 0 row_f, 1 col_f, 2 row_r, 3 col_r
    const bool reverse = kind >= 2;
    const bool column = kind & 1;
    float a_kn[MAXN];
    float h[MAXN];
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      a_kn[n] = n < p.N ? p.A[(static_cast<long long>(k) * p.N + n) * p.D + c] : 0.f;
      h[n] = 0.f;
    }
    const float bias = p.bias[k * p.D + c];
    const bool first = k == 0;
    const bool last = k == p.K - 1;

#pragma unroll 2
    for (int t = 0; t < L; ++t) {
      const int tt = reverse ? L - 1 - t : t;
      const int l = column ? (tt % p.H) * p.W + tt / p.H : tt;
      const long long row = row0 + l;
      const long long o = row * p.D + c;
      const float uu = to_f32(u[o]);
      float z;
      if (RANK) {
        const T* rk = static_cast<const T*>(p.ranks) + row * p.rank_stride + k * p.R;
        z = 0.f;
        for (int r = 0; r < p.R; ++r) z = fmaf(to_f32(rk[r]), wdt_s[r * kScanThreads + threadIdx.x], z);
      } else {
        z = to_f32(static_cast<const T*>(p.dts)[row * p.dt_stride + static_cast<long long>(k) * p.D + c]);
      }
      const float delta = softplus20(z + bias);
      const float du = delta * uu;
      const T* bp = Bp + row * p.bc_stride + k * p.bc_k_stride;
      const T* cp = Cp + row * p.bc_stride + k * p.bc_k_stride;
      float yk = 0.f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < p.N) {
          h[n] = fmaf(expf(delta * a_kn[n]), h[n], du * to_f32(bp[n * p.bc_n_stride]));
          yk = fmaf(to_f32(cp[n * p.bc_n_stride]), h[n], yk);
        }
      }
      const float v = first ? fmaf(uu, dsum, yk) : p.acc[o] + yk;
      if (last) {
        out[o] = from_f32<OT>(v);
      } else {
        p.acc[o] = v;
      }
    }
  }
}

template <typename T, typename OT>
cudaError_t launch_scan(const ScanParams& p, int n_img, cudaStream_t s) {
  const dim3 grid(ceil_div(p.D, kScanThreads), n_img);
  const bool rank = p.ranks != nullptr;
  if (p.N <= 1) {
    if (rank) selective_scan_kernel<T, OT, 1, true><<<grid, kScanThreads, 0, s>>>(p);
    else selective_scan_kernel<T, OT, 1, false><<<grid, kScanThreads, 0, s>>>(p);
  } else {
    if (rank) selective_scan_kernel<T, OT, 16, true><<<grid, kScanThreads, 0, s>>>(p);
    else selective_scan_kernel<T, OT, 16, false><<<grid, kScanThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace xfm

using namespace xfm;

extern "C" int xfm_selective_scan(const void* u, const void* dts, const void* ranks,
                                  const float* w_dt, const void* Bp, const void* Cp,
                                  const float* A, const float* bias, const float* Dsum,
                                  float* acc, void* out, int n_img, int H, int W, int D, int K,
                                  int N, int R, int kinds, int dt_stride, int rank_stride,
                                  int bc_stride, int bc_k_stride, int bc_n_stride, int dtype,
                                  int out_dtype, void* stream) {
  if (N < 1 || N > 16 || K < 1 || K > 4 || (ranks && (R < 1 || R > kScanMaxR)) ||
      (!ranks && !dts) || (K > 1 && !acc))
    return cudaErrorInvalidValue;
  ScanParams p{u,   dts,  ranks, w_dt, Bp, Cp, A,         bias,        Dsum,       acc,
               out, H,    W,     D,    K,  N,  R,         kinds,       dt_stride,  rank_stride,
               bc_stride, bc_k_stride, bc_n_stride};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && out_dtype == kF32) return launch_scan<float, float>(p, n_img, s);
  if (dtype == kBF16 && out_dtype == kF32) return launch_scan<__nv_bfloat16, float>(p, n_img, s);
  if (dtype == kBF16 && out_dtype == kBF16)
    return launch_scan<__nv_bfloat16, __nv_bfloat16>(p, n_img, s);
  return cudaErrorInvalidValue;
}
