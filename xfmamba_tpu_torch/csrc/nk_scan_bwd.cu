// Adjoint of the selective scan of nk_scan.cu, for K traversal kinds x N
// states, deltas precomputed (dts form) or projected from ranks (rank form).
//
// It was the first design of xfmamba_tpu/ops/nk_scan_adjoint.py::
// _nk_scan_bwd_kernel (:54), the backward of the fusion scans (dts form,
// ShallowFuse K = 1 and Cross_SS2Dv5 K = 4 with N = 16), which now runs
// nk_scan_adjoint.cu; ops/nk_scan_adjoint.py::nk_scan_bwd_serial keeps
// this one for chip_smoke.py's timing in turns.  The block adjoint's
// d_state-1 cross2d scans (xfmamba_tpu/ops/vss_block_v2_adjoint.py::
// _vss_block_bwd_kernel, :128) moved to the chunked adjoint of
// ss2d_core_n1.cu; ops/cross2d_scan.py keeps this kernel's rank form on
// the same operands as the serial route that chip_smoke.py times beside it.
//
// Forward, per kind k in its traversal order t (see nk_scan.cu):
//   delta = softplus(z + bias[k]),  a_n = exp(delta * A[k, n])
//   h_n[t] = a_n[t] * h_n[t-1] + delta * u * B_n,   y += sum_n C_n h_n + u * Dsum
// Given gy = dL/dy, the adjoint runs the same kind in reverse:
//   g_n[t] = C_n[t] * gy[t] + a_n[t+1] * g_n[t+1]
//   du    += sum_n g_n delta B_n          (+ gy * Dsum once)
//   ddelta = sum_n g_n (u B_n + h_n[t-1] a_n A[k, n]);  dz = ddelta * softplus'(z + bias)
//   dB_n  = sum_channels g_n delta u,     dC_n = sum_channels gy h_n
//   dA[k, n] += g_n h_n[t-1] a_n delta,   dbias[k] += dz,   dDsum += gy u
// dz (the gradient of the pre-softplus delta, in u's dtype) is the dts
// gradient in dts form; in rank form the host turns it into the rank and
// w_dt gradients with two GEMMs.
//
// Design: as the forward, one thread per (image, channel) chain, the N
// states in registers, kinds one after the other.  Each kind runs twice
// over L: forward, storing every h_n to a float32 scratch (n_img * L, N, D)
// that the wrapper allocates (one kind at a time, so its size does not grow
// with K), then in reverse, reading h_n[t-1] back (h_n[t] is carried from
// the step before).  All threads of a block visit the same position at the
// same step, so the per-position sums over channels (dB, dC) are a warp
// shuffle reduction and one atomicAdd per warp into a zeroed float32
// buffer; dA, dbias and dDsum are summed per thread over the positions and
// added across images with one atomicAdd each.  Atomics add in a different
// order on every run, so results match the plain version to rounding only.
//
// What bounds it on the H100: as the forward, the dependent chain of 2 x L
// steps per kind (latency), plus N warp reductions and atomics per step;
// the h scratch traffic (one store and one load of N floats per step) is
// coalesced.  At the fusion scans' L = 49 the chains are short and many;
// the long backbone maps, where the serial chain left the card idle and
// the per-step reductions dominated, take the chunked adjoint instead.
#include "common.cuh"

namespace xfm {

constexpr int kScanBwdThreads = 64;
constexpr int kScanBwdMaxR = 64;

struct ScanBwdParams {
  const void* u;       // (n_img, L, D)
  const void* dts;     // dts form: row stride dt_stride, kind stride D
  const void* ranks;   // rank form: row stride rank_stride, kind stride R
  const float* w_dt;   // (K, R, D)
  const void* Bp;      // B[l, k, n] at row * bc_stride + k * bc_k_stride + n * bc_n_stride
  const void* Cp;
  const float* A;      // (K, N, D)
  const float* bias;   // (K, D)
  const float* Dsum;   // (D,)
  const float* gy;     // (n_img, L, D) float32
  float* hbuf;         // (n_img * L, N, D) scratch
  float* du;           // (n_img, L, D)
  void* dz;            // (n_img, L, K, D) in u's dtype
  float* dB;           // zeroed; dB[l, k, n] at row * dbc_stride + k * dbc_k_stride + n * dbc_n_stride
  float* dC;           // zeroed; same strides as dB
  float* dA;           // (K, N, D) zeroed
  float* dDsum;        // (D,) zeroed
  float* dbias;        // (K, D) zeroed
  int H, W, D, K, N, R, kinds;
  int dt_stride, rank_stride, bc_stride, bc_k_stride, bc_n_stride;
  int dbc_stride, dbc_k_stride, dbc_n_stride;
};

__device__ __forceinline__ int scan_pos(int t, int L, int H, int W, bool reverse, bool column) {
  const int tt = reverse ? L - 1 - t : t;
  return column ? (tt % H) * W + tt / H : tt;
}

template <typename T, int MAXN, bool RANK>
__global__ void __launch_bounds__(kScanBwdThreads) selective_scan_bwd_kernel(ScanBwdParams p) {
  __shared__ float wdt_s[RANK ? kScanBwdMaxR * kScanBwdThreads : 1];
  const int c = blockIdx.x * kScanBwdThreads + threadIdx.x;
  // inactive threads (c >= D) walk the loops with zeros: every lane takes
  // part in the warp reductions
  const bool active = c < p.D;
  const int cl = active ? c : 0;
  const int lane = threadIdx.x % 32;
  const int L = p.H * p.W;
  const long long row0 = static_cast<long long>(blockIdx.y) * L;
  const T* u = static_cast<const T*>(p.u);
  const T* Bp = static_cast<const T*>(p.Bp);
  const T* Cp = static_cast<const T*>(p.Cp);
  T* dz = static_cast<T*>(p.dz);
  const float dsum = p.Dsum[cl];
  float dD = 0.f;

  for (int k = 0; k < p.K; ++k) {
    if (RANK) {
      __syncthreads();
      for (int r = 0; r < p.R; ++r)
        wdt_s[r * kScanBwdThreads + threadIdx.x] =
            p.w_dt[(static_cast<long long>(k) * p.R + r) * p.D + cl];
      __syncthreads();
    }
    const int kind = (p.kinds >> (2 * k)) & 3;  // 0 row_f, 1 col_f, 2 row_r, 3 col_r
    const bool reverse = kind >= 2;
    const bool column = kind & 1;
    float a_kn[MAXN], h[MAXN];
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      a_kn[n] = n < p.N ? p.A[(static_cast<long long>(k) * p.N + n) * p.D + cl] : 0.f;
      h[n] = 0.f;
    }
    const float bias = p.bias[k * p.D + cl];

    auto zval = [&](long long row) {
      if (RANK) {
        const T* rk = static_cast<const T*>(p.ranks) + row * p.rank_stride + k * p.R;
        float z = 0.f;
        for (int r = 0; r < p.R; ++r)
          z = fmaf(to_f32(rk[r]), wdt_s[r * kScanBwdThreads + threadIdx.x], z);
        return z;
      }
      return to_f32(static_cast<const T*>(p.dts)[row * p.dt_stride +
                                                 static_cast<long long>(k) * p.D + cl]);
    };

    // ---- forward: recompute h and keep every state
    for (int t = 0; t < L; ++t) {
      const long long row = row0 + scan_pos(t, L, p.H, p.W, reverse, column);
      const float delta = softplus20(zval(row) + bias);
      const float du = delta * to_f32(u[row * p.D + cl]);
      const T* bp = Bp + row * p.bc_stride + k * p.bc_k_stride;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < p.N) {
          h[n] = fmaf(expf(delta * a_kn[n]), h[n], du * to_f32(bp[n * p.bc_n_stride]));
          if (active) p.hbuf[(row * p.N + n) * p.D + c] = h[n];
        }
      }
    }

    // ---- reverse: adjoint chain g, gradients; h holds h[t] on entry
    float g[MAXN], a_next[MAXN], dA_acc[MAXN];
#pragma unroll
    for (int n = 0; n < MAXN; ++n) g[n] = a_next[n] = dA_acc[n] = 0.f;
    float dbias_acc = 0.f;
    const bool first = k == 0;
    for (int t = L - 1; t >= 0; --t) {
      const long long row = row0 + scan_pos(t, L, p.H, p.W, reverse, column);
      const long long prow = t > 0 ? row0 + scan_pos(t - 1, L, p.H, p.W, reverse, column) : -1;
      const long long o = row * p.D + cl;
      const float uu = to_f32(u[o]);
      const float zb = zval(row) + bias;
      const float delta = softplus20(zb);
      const float gyv = active ? p.gy[o] : 0.f;
      const T* bp = Bp + row * p.bc_stride + k * p.bc_k_stride;
      const T* cp = Cp + row * p.bc_stride + k * p.bc_k_stride;
      float* dbp = p.dB + row * p.dbc_stride + k * p.dbc_k_stride;
      float* dcp = p.dC + row * p.dbc_stride + k * p.dbc_k_stride;
      float ddelta = 0.f, dus = 0.f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < p.N) {
          const float a = expf(delta * a_kn[n]);
          const float bn = to_f32(bp[n * p.bc_n_stride]);
          const float cn = to_f32(cp[n * p.bc_n_stride]);
          const float hprev = active && prow >= 0 ? p.hbuf[(prow * p.N + n) * p.D + c] : 0.f;
          const float gn = active ? fmaf(a_next[n], g[n], cn * gyv) : 0.f;
          g[n] = gn;
          a_next[n] = a;
          dus = fmaf(gn * delta, bn, dus);
          ddelta = fmaf(gn, fmaf(uu, bn, hprev * a * a_kn[n]), ddelta);
          dA_acc[n] = fmaf(gn * hprev, a * delta, dA_acc[n]);
          const float db_sum = warp_sum(gn * delta * uu);
          const float dc_sum = warp_sum(gyv * h[n]);
          if (lane == 0) {
            atomicAdd(dbp + n * p.dbc_n_stride, db_sum);
            atomicAdd(dcp + n * p.dbc_n_stride, dc_sum);
          }
          h[n] = hprev;
        }
      }
      if (!active) continue;
      const float dzv = ddelta * (zb > 20.f ? 1.f : 1.f / (1.f + expf(-zb)));
      dbias_acc += dzv;
      dz[row * (static_cast<long long>(p.K) * p.D) + static_cast<long long>(k) * p.D + c] =
          from_f32<T>(dzv);
      if (first) {
        p.du[o] = fmaf(gyv, dsum, dus);
        dD = fmaf(gyv, uu, dD);
      } else {
        p.du[o] += dus;
      }
    }
    if (active) {
#pragma unroll
      for (int n = 0; n < MAXN; ++n)
        if (n < p.N) atomicAdd(&p.dA[(static_cast<long long>(k) * p.N + n) * p.D + c], dA_acc[n]);
      atomicAdd(&p.dbias[k * p.D + c], dbias_acc);
    }
  }
  if (active) atomicAdd(&p.dDsum[c], dD);
}

template <typename T>
cudaError_t launch_scan_bwd(const ScanBwdParams& p, int n_img, cudaStream_t s) {
  const dim3 grid(ceil_div(p.D, kScanBwdThreads), n_img);
  const bool rank = p.ranks != nullptr;
  if (p.N <= 1) {
    if (rank) selective_scan_bwd_kernel<T, 1, true><<<grid, kScanBwdThreads, 0, s>>>(p);
    else selective_scan_bwd_kernel<T, 1, false><<<grid, kScanBwdThreads, 0, s>>>(p);
  } else {
    if (rank) selective_scan_bwd_kernel<T, 16, true><<<grid, kScanBwdThreads, 0, s>>>(p);
    else selective_scan_bwd_kernel<T, 16, false><<<grid, kScanBwdThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace xfm

using namespace xfm;

extern "C" int xfm_selective_scan_bwd(
    const void* u, const void* dts, const void* ranks, const float* w_dt, const void* Bp,
    const void* Cp, const float* A, const float* bias, const float* Dsum, const float* gy,
    float* hbuf, float* du, void* dz, float* dB, float* dC, float* dA, float* dDsum,
    float* dbias, int n_img, int H, int W, int D, int K, int N, int R, int kinds, int dt_stride,
    int rank_stride, int bc_stride, int bc_k_stride, int bc_n_stride, int dbc_stride,
    int dbc_k_stride, int dbc_n_stride, int dtype, void* stream) {
  if (N < 1 || N > 16 || K < 1 || K > 4 || (ranks && (R < 1 || R > kScanBwdMaxR)) ||
      (!ranks && !dts))
    return cudaErrorInvalidValue;
  const ScanBwdParams p{u,  dts, ranks, w_dt, Bp, Cp, A, bias, Dsum, gy, hbuf, du, dz, dB, dC,
                        dA, dDsum, dbias, H, W, D, K, N, R, kinds, dt_stride, rank_stride,
                        bc_stride, bc_k_stride, bc_n_stride, dbc_stride, dbc_k_stride,
                        dbc_n_stride};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_scan_bwd<float>(p, n_img, s);
  if (dtype == kBF16) return launch_scan_bwd<__nv_bfloat16>(p, n_img, s);
  return cudaErrorInvalidValue;
}
