// Kernel 7: the adjoint of the fusion scans (dts form, K = 1 or 4 traversal
// kinds, N <= 16 states), with no state scratch in device memory and no
// atomics.  Replaces xfmamba_tpu/ops/nk_scan_adjoint.py::_nk_scan_bwd_kernel
// (:54, pallas_call :280), which keeps the states in VMEM.
//
// Forward, per kind k in its traversal order t (see nk_scan.cu):
//   delta = softplus(z + bias[k]),  a_n = exp(delta * A[k, n])
//   h_n[t] = a_n[t] * h_n[t-1] + delta * u * B_n,   y = sum_k sum_n C_n h_n + u * Dsum
// Given gy = dL/dy, the adjoint runs the kind in reverse:
//   g_n[t] = C_n[t] * gy[t] + a_n[t+1] * g_n[t+1]
//   du    = gy * Dsum + sum_k sum_n g_n delta B_n
//   ddelta = sum_n g_n (u B_n + h_n[t-1] a_n A[k, n]);  dz = ddelta * softplus'(z + bias)
//   dB_n  = sum_channels g_n delta u,     dC_n = sum_channels gy h_n
//   dA[k, n] = sum g_n h_n[t-1] a_n delta,   dbias[k] = sum dz,   dDsum = sum gy u
//
// Design (the serial adjoint of nk_scan_bwd.cu, which stays for the rank
// form of ops/cross2d_scan.py::serial_scan_bwd, stored every h_n of a kind
// to a float32 scratch of (n_img L, N, D) and added dB / dC with a warp
// reduction and atomics at every position):
// - Four lanes per (image, kind, channel) chain, each holding the states
//   n = 4 j + lane % 4, so a warp walks 8 channels and the card gets four
//   times the threads of one per chain; the per-chain sums over n (du,
//   ddelta) take two shuffles each.
// - Kinds in parallel (blockIdx.z), each kind's gradient of u in its own
//   slice, summed by the second launch.
// - No global h: the forward walk keeps h only at the start of each
//   segment of `clen` positions of the traversal (about sqrt(L): 7 at the
//   fusion's 7 x 7), in shared memory; the reverse walk recomputes each
//   segment's states from its checkpoint into shared memory and walks them
//   back.  Decays are exp2 of log2(e)-scaled A.
// - dB / dC: at each position a warp sums its 8 channels' 32 values (16
//   states x B and C) with a reduce-scatter (7 shuffles, each lane ends
//   with one sum), the warps' sums meet in shared memory, and every 8
//   positions the block writes its channel tile's partial row.  dA, dbias
//   and dDsum are summed per chain over the positions and written per
//   image.
// - A second short launch sums the partials in a fixed order (channel
//   tiles, images, kinds): the result is the same on every run.
//
// What bounds it on the H100: at the fusion shapes the walks' dependent
// chains (3 x L steps per chain, an exp2 and a few FMAs per state) and the
// per-position reductions; the bytes (u, dts, B, C and gy read, the
// gradients written, the partials twice) are far below that.
#include "common.cuh"

namespace xfm {

constexpr int kAdjFlush = 8;       // positions between the dB / dC flushes
constexpr int kAdjMaxThreads = 256;

struct NkAdjParams {
  const void* u;      // (n_img, L, D) T
  const void* dts;    // (n_img, L, K, D) T
  const void* Bs;     // (n_img, L, K, N) T
  const void* Cs;     // (n_img, L, K, N) T
  const float* A;     // (K, N, D)
  const float* bias;  // (K, D)
  const float* gy;    // (n_img, L, D)
  float* du_part;     // (K, n_img L, D)
  void* dz;           // (n_img, L, K, D) T
  float* bc_part;     // (ctiles, n_img L, K, 2, N)
  float* dA_part;     // (n_img, K, N, D)
  float* dbias_part;  // (n_img, K, D)
  float* dD_part;     // (n_img, D)
  int n_img, H, W, D, K, N, kinds, clen, warps;
};

__device__ __forceinline__ int adj_pos(int t, int L, int H, int W, bool reverse, bool column) {
  const int tt = reverse ? L - 1 - t : t;
  return column ? (tt % H) * W + tt / H : tt;
}

// Bytes of dynamic shared memory of a block of `warps` warps.
// checkpoints and segment states, the flush buffer, a segment's chain
// values, the flush's positions and the traversal's positions.
__host__ __device__ inline int adj_smem_bytes(int L, int N, int clen, int warps) {
  const int n_ck = (L + clen - 1) / clen, ns = (N + 3) / 4;
  return ((n_ck + clen) * ns * warps * 32 + kAdjFlush * warps * 32 + 4 * clen * warps * 8 +
          kAdjFlush + L) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kAdjMaxThreads) nk_adjoint_kernel(NkAdjParams p) {
  extern __shared__ float smem[];
  const int nthr = p.warps * 32;
  const int L = p.H * p.W;
  const int n_ck = (L + p.clen - 1) / p.clen, ns = (p.N + 3) / 4;
  float* ck = smem;                               // [n_ck][ns][nthr]
  float* hs = ck + n_ck * ns * nthr;               // [clen][ns][nthr]
  float* red = hs + p.clen * ns * nthr;           // [kAdjFlush][warps][32]
  // a segment's per-chain values, [clen][8 warps] each: delta, softplus'
  // (z + bias), u and gy
  float* dseg = red + kAdjFlush * p.warps * 32;
  float* sseg = dseg + p.clen * p.warps * 8;
  float* useg = sseg + p.clen * p.warps * 8;
  float* gseg = useg + p.clen * p.warps * 8;
  int* rows_s = reinterpret_cast<int*>(gseg + p.clen * p.warps * 8);  // [kAdjFlush]
  int* pos_s = rows_s + kAdjFlush;                 // [L]: position of traversal step t
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, grp = lane & 3;
  const int chain = warp * 8 + (lane >> 2);
  const int ctile = blockIdx.x, img = blockIdx.y, k = blockIdx.z;
  const int c = ctile * 8 * p.warps + warp * 8 + (lane >> 2);
  const bool active = c < p.D;
  const int cc = active ? c : p.D - 1;
  const int code = (p.kinds >> (2 * k)) & 3;  // 0 row_f, 1 col_f, 2 row_r, 3 col_r
  const bool reverse = code >= 2, column = code & 1;
  const long long row0 = static_cast<long long>(img) * L;
  const int KD = p.K * p.D, KN = p.K * p.N;
  const T* u = static_cast<const T*>(p.u);
  const T* dts = static_cast<const T*>(p.dts);
  const T* Bs = static_cast<const T*>(p.Bs);
  const T* Cs = static_cast<const T*>(p.Cs);

  float An[4], A2[4];
  bool has[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * j + grp;
    has[j] = n < p.N;
    An[j] = has[j] ? p.A[(static_cast<long long>(k) * p.N + n) * p.D + cc] : 0.f;
    A2[j] = An[j] * kLog2e;
  }
  const float bias = p.bias[k * p.D + cc];
  for (int t = tid; t < L; t += nthr) pos_s[t] = adj_pos(t, L, p.H, p.W, reverse, column);
  __syncthreads();

  // Per-chain values (delta, its softplus' derivative, u, gy) are computed
  // once per chain, not once per lane: for four consecutive positions each
  // of the chain's four lanes takes one, and shuffles hand them round.
  const int quad = lane & ~3;
  const T* dts_k = dts + k * p.D + cc;
  const T* u_c = u + cc;
  const T* Bs_k = Bs + k * p.N + grp;
  const T* Cs_k = Cs + k * p.N + grp;
  auto delta_at = [&](int t, float* zb) {  // (delta, z + bias) of traversal step t < L
    const long long row = row0 + pos_s[t];
    *zb = to_f32(dts_k[row * KD]) + bias;
    return softplus20(*zb);
  };

  // ---- forward: the states entering each segment
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t4 = 0; t4 < L; t4 += 4) {
    float zq, dq = 0.f, uq = 0.f;
    if (t4 + grp < L) {
      dq = delta_at(t4 + grp, &zq);
      uq = to_f32(u_c[(row0 + pos_s[t4 + grp]) * p.D]);
    }
    for (int q = 0; q < 4 && t4 + q < L; ++q) {
      const int t = t4 + q;
      const float delta = __shfl_sync(0xffffffffu, dq, quad | q);
      const float du = delta * __shfl_sync(0xffffffffu, uq, quad | q);
      if (t % p.clen == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < ns) ck[(t / p.clen * ns + j) * nthr + tid] = h[j];
      }
      const T* bp = Bs_k + (row0 + pos_s[t]) * KN;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (has[j]) h[j] = fmaf(fast_exp2(delta * A2[j]), h[j], du * to_f32(bp[4 * j]));
    }
  }

  // ---- reverse, segment by segment from the last
  float g[4] = {0.f, 0.f, 0.f, 0.f}, a_next[4] = {0.f, 0.f, 0.f, 0.f};
  float dA[4] = {0.f, 0.f, 0.f, 0.f};
  float dbias_acc = 0.f, dD = 0.f;
  T* dz = static_cast<T*>(p.dz);
  float* du_part = p.du_part + static_cast<long long>(k) * p.n_img * L * p.D;
  const int cs = p.warps * 8;  // the block's chains: the stride of the segment arrays
  int step = 0;
  for (int s = n_ck - 1; s >= 0; --s) {
    const int t0 = s * p.clen, cnt = min(p.clen, L - t0);
    // the segment's states again, from its checkpoint; the chain's values
    // for the walk back into dseg / sseg / useg / gseg
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < ns) h[j] = ck[(s * ns + j) * nthr + tid];
    for (int i4 = 0; i4 < cnt; i4 += 4) {
      float zq = 0.f, dq = 0.f, uq = 0.f;
      if (i4 + grp < cnt) {
        const int t = t0 + i4 + grp;
        const long long o = (row0 + pos_s[t]) * p.D + cc;
        dq = delta_at(t, &zq);
        uq = to_f32(u_c[(row0 + pos_s[t]) * p.D]);
        const int e = (i4 + grp) * cs + chain;
        dseg[e] = dq;
        sseg[e] = zq > 20.f ? 1.f : __fdividef(1.f, 1.f + __expf(-zq));
        useg[e] = uq;
        gseg[e] = active ? p.gy[o] : 0.f;  // an idle chain adds zeros
      }
      for (int q = 0; q < 4 && i4 + q < cnt; ++q) {
        const int i = i4 + q;
        const float delta = __shfl_sync(0xffffffffu, dq, quad | q);
        const float du = delta * __shfl_sync(0xffffffffu, uq, quad | q);
        const T* bp = Bs_k + (row0 + pos_s[t0 + i]) * KN;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (has[j]) h[j] = fmaf(fast_exp2(delta * A2[j]), h[j], du * to_f32(bp[4 * j]));
          if (j < ns) hs[(i * ns + j) * nthr + tid] = h[j];
        }
      }
    }
    __syncwarp();  // the segment's chain values are in place
    for (int i = cnt - 1; i >= 0; --i, ++step) {
      const int l = pos_s[t0 + i];
      const long long row = row0 + l;
      const int e = i * cs + chain;
      const float delta = dseg[e], uu = useg[e], gyv = gseg[e];
      const T* bp = Bs_k + row * KN;
      const T* cp = Cs_k + row * KN;
      float ddelta = 0.f, dus = 0.f, v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = v[4 + j] = 0.f;
        if (!has[j]) continue;
        const float a = fast_exp2(delta * A2[j]);
        const float bn = to_f32(bp[4 * j]), cn = to_f32(cp[4 * j]);
        const float hcur = hs[(i * ns + j) * nthr + tid];
        const float hprev =
            i > 0 ? hs[((i - 1) * ns + j) * nthr + tid] : ck[(s * ns + j) * nthr + tid];
        const float gn = fmaf(a_next[j], g[j], cn * gyv);
        g[j] = gn;
        a_next[j] = a;
        dus = fmaf(gn * delta, bn, dus);
        ddelta = fmaf(gn, fmaf(uu, bn, hprev * a * An[j]), ddelta);
        dA[j] = fmaf(gn * hprev, a * delta, dA[j]);
        v[j] = gn * delta * uu;
        v[4 + j] = gyv * hcur;
      }
      // the chain's sums over its four lanes' states
      ddelta += __shfl_xor_sync(0xffffffffu, ddelta, 1);
      ddelta += __shfl_xor_sync(0xffffffffu, ddelta, 2);
      dus += __shfl_xor_sync(0xffffffffu, dus, 1);
      dus += __shfl_xor_sync(0xffffffffu, dus, 2);
      // dB / dC: the warp's 8 channels summed by a reduce-scatter over lane
      // bits 4, 3, 2; lane ends with value (lane >> 2) & 7 of its group
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const bool hi = lane & 16;
        const float send = hi ? v[e4] : v[e4 + 4];
        v[e4] = (hi ? v[e4 + 4] : v[e4]) + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const bool hi = lane & 8;
        const float send = hi ? v[e2] : v[e2 + 2];
        v[e2] = (hi ? v[e2 + 2] : v[e2]) + __shfl_xor_sync(0xffffffffu, send, 8);
      }
      {
        const bool hi = lane & 4;
        const float send = hi ? v[0] : v[1];
        v[0] = (hi ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
      }
      const int slot = step % kAdjFlush;
      red[(slot * p.warps + warp) * 32 + lane] = v[0];
      if (tid == 0) rows_s[slot] = l;
      const float dzv = ddelta * sseg[e];
      if (grp == 0 && active) {
        dz[row * KD + static_cast<long long>(k) * p.D + c] = from_f32<T>(dzv);
        du_part[row * p.D + c] = dus;
        dbias_acc += dzv;
        dD = fmaf(gyv, uu, dD);
      }
      if (slot == kAdjFlush - 1 || (s == 0 && i == 0)) {
        __syncthreads();
        // each thread sums one (position, value) over the warps in order
        for (int e1 = tid; e1 < (slot + 1) * 32; e1 += nthr) {
          const int sl = e1 / 32, ln = e1 % 32, vi = (ln >> 2) & 7;
          const int n = 4 * (vi & 3) + (ln & 3);
          if (n >= p.N) continue;
          float sum = 0.f;
          for (int w = 0; w < p.warps; ++w) sum += red[(sl * p.warps + w) * 32 + ln];
          const long long prow = row0 + rows_s[sl];
          p.bc_part[(((static_cast<long long>(ctile) * p.n_img * L + prow) * p.K + k) * 2 +
                     (vi >> 2)) * p.N + n] = sum;
        }
        __syncthreads();
      }
    }
  }
  if (grp == 0 && active) {
    p.dbias_part[(static_cast<long long>(img) * p.K + k) * p.D + c] = dbias_acc;
    if (k == 0) p.dD_part[static_cast<long long>(img) * p.D + c] = dD;
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (has[j])
        p.dA_part[((static_cast<long long>(img) * p.K + k) * p.N + 4 * j + grp) * p.D + c] = dA[j];
  }
}

struct NkFinishParams {
  const float* gy;
  const float* Dsum;
  const float* du_part;
  const float* bc_part;
  const float* dA_part;
  const float* dbias_part;
  const float* dD_part;
  float* du;      // (n_img L, D)
  float* dB;      // (n_img L, K, N)
  float* dC;
  float* dA;      // (K, N, D)
  float* dDsum;   // (D,)
  float* dbias;   // (K, D)
  long long rows;
  int D, K, N, n_img, ctiles;
};

// The partial sums in a fixed order: du over the kinds, dB / dC over the
// channel tiles, dA / dbias / dDsum over the images.
__global__ void nk_adjoint_finish_kernel(NkFinishParams q) {
  const long long n_du = q.rows * q.D, n_bc = q.rows * q.K * q.N * 2;
  const long long n_a = static_cast<long long>(q.K) * q.N * q.D;
  const long long n_b = static_cast<long long>(q.K) * q.D;
  const long long total = n_du + n_bc + n_a + n_b + q.D;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long e = i;
    if (e < n_du) {
      float v = q.gy[e] * q.Dsum[e % q.D];
      for (int k = 0; k < q.K; ++k) v += q.du_part[k * n_du + e];
      q.du[e] = v;
      continue;
    }
    e -= n_du;
    if (e < n_bc) {
      // e = ((row K + k) 2 + which) N + n
      float v = 0.f;
      for (int t = 0; t < q.ctiles; ++t) v += q.bc_part[t * n_bc + e];
      const long long n = e % q.N, which = e / q.N % 2, rk = e / (2 * q.N);
      (which ? q.dC : q.dB)[rk * q.N + n] = v;
      continue;
    }
    e -= n_bc;
    if (e < n_a) {
      float v = 0.f;
      for (int b = 0; b < q.n_img; ++b) v += q.dA_part[b * n_a + e];
      q.dA[e] = v;
      continue;
    }
    e -= n_a;
    if (e < n_b) {
      float v = 0.f;
      for (int b = 0; b < q.n_img; ++b) v += q.dbias_part[b * n_b + e];
      q.dbias[e] = v;
      continue;
    }
    e -= n_b;
    float v = 0.f;
    for (int b = 0; b < q.n_img; ++b) v += q.dD_part[b * static_cast<long long>(q.D) + e];
    q.dDsum[e] = v;
  }
}

template <typename T>
cudaError_t launch_nk_adjoint(const NkAdjParams& p, const NkFinishParams& q, cudaStream_t s) {
  const int smem = adj_smem_bytes(p.H * p.W, p.N, p.clen, p.warps);
  static bool ready = false;  // the attribute is set once, outside any stream capture
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        nk_adjoint_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(q.ctiles, p.n_img, p.K);
  nk_adjoint_kernel<T><<<grid, p.warps * 32, smem, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = q.rows * q.D + q.rows * q.K * q.N * 2 +
                          static_cast<long long>(q.K) * q.N * q.D + q.K * q.D + q.D;
  const int blocks = ceil_div(total, 256) < 65535 * 8 ? ceil_div(total, 256) : 65535 * 8;
  nk_adjoint_finish_kernel<<<blocks, 256, 0, s>>>(q);
  return cudaGetLastError();
}

}  // namespace xfm

using namespace xfm;

// Kernel 7, dts form.  u, dts, Bs, Cs contiguous (n_img, L, ...) in the
// dtype; A (K, N, D), bias (K, D), Dsum (D,), gy (n_img, L, D) float32.
// Outputs: du (n_img, L, D), dz (n_img, L, K, D) in the dtype, dB and dC
// (n_img, L, K, N), dA (K, N, D), dDsum (D,), dbias (K, D), all written
// whole.  Scratch (float32): du_part (K, n_img L, D), bc_part (ctiles,
// n_img L, K, 2, N), dA_part (n_img, K, N, D), dbias_part (n_img, K, D),
// dD_part (n_img, D).  clen (positions per segment) and warps (8 x warps
// channels per block, ctiles = ceil(D / (8 warps))) come from the host's
// plan (ops/nk_scan_adjoint.py::adjoint_plan).
extern "C" int xfm_nk_scan_adjoint(const void* u, const void* dts, const void* Bs, const void* Cs,
                                   const float* A, const float* bias, const float* Dsum,
                                   const float* gy, float* du, void* dz, float* dB, float* dC,
                                   float* dA, float* dDsum, float* dbias, float* du_part,
                                   float* bc_part, float* dA_part, float* dbias_part,
                                   float* dD_part, int n_img, int H, int W, int D, int K, int N,
                                   int kinds, int clen, int warps, int dtype, void* stream) {
  const int L = H * W;
  if (n_img < 1 || n_img > 65535 || H < 1 || W < 1 || D < 1 || K < 1 || K > 4 || N < 1 ||
      N > 16 || clen < 1 || clen > L || warps < 1 || warps * 32 > kAdjMaxThreads ||
      adj_smem_bytes(L, N, clen, warps) > 227 * 1024 || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const int ctiles = ceil_div(D, 8 * warps);
  const NkAdjParams p{u,       dts,     Bs,         Cs,      A,  bias, gy, du_part, dz,
                      bc_part, dA_part, dbias_part, dD_part, n_img, H, W, D, K, N, kinds,
                      clen,    warps};
  const NkFinishParams q{gy, Dsum, du_part, bc_part, dA_part, dbias_part, dD_part, du, dB, dC,
                         dA, dDsum, dbias, static_cast<long long>(n_img) * L, D, K, N, n_img,
                         ctiles};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_nk_adjoint<float>(p, q, s);
  return launch_nk_adjoint<__nv_bfloat16>(p, q, s);
}
