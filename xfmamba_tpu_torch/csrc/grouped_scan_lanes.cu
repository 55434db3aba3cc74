// Kernels 13 and 14: the grouped selective scan of one direction and its
// adjoint, four lanes a chain, no state in device memory, no atomics.
//
// Replaces xfmamba_tpu/ops/selective_scan_pallas.py::_grouped_scan_kernel
// (:838, pallas_call :954) and ::_grouped_scan_kernel_bwd (:979,
// pallas_call :1137).  Channels are K groups of C (kc = k * C + c); group k
// reads B[b, t, k, :] and C[b, t, k, :].  Per (image, channel) chain:
//   delta = softplus20(delta_in[t, kc] + bias[kc]),  a_n = exp(delta A[kc, n])
//   h_n[t] = a_n h_n[t-] + delta u[t, kc] B[t, k, n],  y = sum_n C[t, k, n] h_n + D[kc] u
// walked t = 0 .. L-1, or L-1 .. 0 with `reverse` (t- the position before t
// in scan order, t+ the one after).  The state entering each chunk of
// `chunk` positions, in scan order, is written out (the TPU's carr):
// ck[b, k, j, n, c] for data chunk j.  The adjoint, against the scan order:
//   lambda_n[t] = C_n[t] dy[t] + a_n[t+] lambda_n[t+]
//   du = dy D + delta sum_n lambda_n B_n
//   dz = (u sum_n lambda_n B_n + sum_n lambda_n h_n[t-] a_n A_n) softplus'(z)
//   dB_n = sum_c lambda_n delta u,  dC_n = sum_c dy h_n,  dA_n = sum lambda_n h_n[t-] a_n delta
//   dD = sum dy u,  dbias = sum dz
//
// Design (the first one, selective_scan_grouped_v1.cu, walked a chain per
// thread with its 16 states, kept one chunk of every chain's states in a
// float32 scratch in device memory and added dB / dC with atomics at every
// position):
// - A block is a slab of 8 x warps channels of one (image, group): a slab
//   never straddles two groups, and a ragged last slab masks its idle
//   channels.  Four lanes per chain, lane g holding the states n = 4 g + j,
//   so each lane reads its B and C as one 16-byte shared load, and the sums
//   over n take two shuffles.  States past N are zeros (B, C and A padded).
// - A chunk's rows (u, delta, dy, B, C) are staged in shared memory, by
//   16-byte cp.async where the rows allow it; the forward stages the next
//   chunk while it walks this one.  A pass over the staged chunk computes
//   delta, delta u and the adjoint's dy once per (position, channel) and
//   widens B and C to float32 rows of 16, so the walks read shared memory
//   only.  Decays are exp2 of log2(e)-scaled A.  The forward sums y over
//   the chain's lanes with two shuffles and writes it, and D u, in rows of
//   the slab after the chunk's walk.
// - The adjoint keeps no state in device memory.  A walk over the chunk
//   from its checkpoint keeps the state entering each segment of kLanesSeg
//   positions in shared memory; each segment, in adjoint order, is
//   recomputed into registers (its states and its decays) and walked back
//   with those decays: two exponentials per state and position, one in each
//   walk forward.  Keeping a whole chunk's decays instead (2 KB a chain)
//   would leave an SM one or two blocks.  At most 128 registers a thread:
//   two blocks of 8 warps an SM.
// - dB / dC: at each position a warp sums its 8 chains' 32 values with a
//   reduce-scatter (7 shuffles), and the lanes keep their shares of
//   sum_n lambda_n B_n and of d delta in shared memory; after each segment
//   the block sums the warps' dB / dC in order into its slab's partial
//   rows, and each chain's four lanes in order into du and d delta, written
//   in rows of the slab.  dA is summed per lane, dD and dbias per channel,
//   over the positions, and written per image.  A second short launch sums
//   the partials in a fixed order (slabs, images): no atomics, the same bits
//   on every run.
//
// What bounds it on the H100: at the XFMamba-B step's (48, 49, 2048) K=1
// N=16 call the bytes (u, delta, B, C, dy read; y, the checkpoints, du,
// d delta, dB, dC written: 0.021 ms for the forward, 0.033 for the adjoint
// at 3.35 TB/s) and the exponentials on the special-function units (0.021
// and 0.040 ms) weigh less than the latency of the walks and of the
// per-position reductions, which two blocks an SM hide only in part:
// taking the exponentials away saves 1-2%, the adjoint's reduce-scatter
// about 14%, its flushes about 14%, its walk to the segments' entry states
// about 15% (python -m xfmamba_tpu_torch.kernels.probe_grouped).
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace xfm {

constexpr int kLanesRow = 16;      // widened B / C row: the 16 states
constexpr int kLaneStates = 4;     // states a lane holds: n = 4 g + j
constexpr int kLanesSeg = 8;       // positions of an adjoint segment
constexpr int kLanesMaxWarps = 8;
constexpr int kLanesMaxChunk = 64;

struct LanesParams {
  const void* u;      // (B, L, K * C)
  const void* delta;  // (B, L, K * C), before bias and softplus
  const float* A;     // (K * C, N)
  const void* Bm;     // (B, L, K, N)
  const void* Cm;     // (B, L, K, N)
  const float* Dv;    // (K * C,) or null
  const float* bias;  // (K * C,) or null
  float* y;           // (B, L, K * C)
  float* ck;          // (B, K, n_chunks, N, C): state entering each chunk
  const float* dy;    // (B, L, K * C)
  float* du;          // (B, L, K * C)
  float* ddelta;      // (B, L, K * C)
  float* bc_part;     // (slabs, B, L, K, 2, N): each slab's dB / dC rows
  float* dA_part;     // (B, K * C, N)
  float* dbias_part;  // (B, K * C)
  float* dD_part;     // (B, K * C)
  int B, L, K, C, N, chunk, n_chunks, reverse, warps, slabs;
};

// The thread's place: its chain (channel of the slab), its lane of the
// chain, the channel it reads (an idle chain past C reads the last one and
// writes nothing).
struct LanesThread {
  int tid, lane, warp, grp, chain, cs, c0, c, k;
  bool active;
  long long img, KC, kc;
};

__device__ __forceinline__ LanesThread lanes_thread(const LanesParams& p) {
  LanesThread th;
  th.tid = threadIdx.x;
  th.lane = th.tid & 31;
  th.warp = th.tid >> 5;
  th.grp = th.lane & 3;
  th.chain = th.warp * 8 + (th.lane >> 2);
  th.cs = 8 * p.warps;
  th.c0 = blockIdx.x * th.cs;
  th.c = th.c0 + th.chain;
  th.k = blockIdx.y;
  th.img = blockIdx.z;
  th.active = th.c < p.C;
  th.KC = static_cast<long long>(p.K) * p.C;
  th.kc = static_cast<long long>(th.k) * p.C + (th.active ? th.c : p.C - 1);
  return th;
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// `cnt` rows of `len` values, row r at src + r * stride, into dst[r * width]:
// by 16-byte cp.async (the caller commits and waits) when every row start
// and length is 16-byte aligned, else value by value.
template <typename T>
__device__ __forceinline__ void lanes_stage(T* dst, int width, const T* src, long long stride,
                                            int cnt, int len) {
  constexpr int per = 16 / sizeof(T);
  if (len % per == 0 && stride % per == 0 && aligned16(src)) {
    const int pieces = len / per;
    for (int e = threadIdx.x; e < cnt * pieces; e += blockDim.x) {
      const int r = e / pieces, q = e % pieces;
      cp_async16(dst + r * width + q * per, src + r * stride + q * per, 16);
    }
  } else {
    for (int e = threadIdx.x; e < cnt * len; e += blockDim.x) {
      const int r = e / len, q = e % len;
      dst[r * width + q] = src[r * stride + q];
    }
  }
}

// A chunk's raw rows in shared memory: u and delta [chunk][cs], B and C
// [chunk][16] in the operands' type.
template <typename T>
struct LanesRaw {
  T *u, *dl, *b, *c;
};

template <typename T>
__device__ __forceinline__ LanesRaw<T> lanes_raw(T* base, int chunk, int cs) {
  LanesRaw<T> r;
  r.u = base;
  r.dl = r.u + chunk * cs;
  r.b = r.dl + chunk * cs;
  r.c = r.b + chunk * kLanesRow;
  return r;
}

__host__ __device__ inline int lanes_raw_elems(int chunk, int cs) {
  return 2 * chunk * cs + 2 * chunk * kLanesRow;
}

// Stage positions [t0, t0 + cnt) of the block's slab and group.
template <typename T>
__device__ __forceinline__ void lanes_stage_chunk(const LanesParams& p, const LanesThread& th,
                                                  const LanesRaw<T>& r, int t0, int cnt) {
  const long long row = th.img * p.L + t0;
  const int len = min(th.cs, p.C - th.c0);
  const long long col = static_cast<long long>(th.k) * p.C + th.c0;
  lanes_stage(r.u, th.cs, static_cast<const T*>(p.u) + row * th.KC + col, th.KC, cnt, len);
  lanes_stage(r.dl, th.cs, static_cast<const T*>(p.delta) + row * th.KC + col, th.KC, cnt, len);
  const long long bc = (row * p.K + th.k) * p.N;
  lanes_stage(r.b, kLanesRow, static_cast<const T*>(p.Bm) + bc, static_cast<long long>(p.K) * p.N,
              cnt, p.N);
  lanes_stage(r.c, kLanesRow, static_cast<const T*>(p.Cm) + bc, static_cast<long long>(p.K) * p.N,
              cnt, p.N);
}

// B and C of the chunk widened to float32 rows of 16, zero past N.
template <typename T>
__device__ __forceinline__ void lanes_widen_bc(const LanesParams& p, const LanesRaw<T>& r,
                                               int cnt, float* s_b, float* s_c) {
  for (int e = threadIdx.x; e < cnt * kLanesRow; e += blockDim.x) {
    const bool live = e % kLanesRow < p.N;
    s_b[e] = live ? to_f32(r.b[e]) : 0.f;
    s_c[e] = live ? to_f32(r.c[e]) : 0.f;
  }
}

// The lane's states of B or C at one position (row of 16 floats).
__device__ __forceinline__ void lanes_load(const float* row, int grp, float (&v)[kLaneStates]) {
  const float4 q = *reinterpret_cast<const float4*>(row + 4 * grp);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The lane's A and its log2(e)-scaled copy A2 (zero past N).
__device__ __forceinline__ void lanes_decays(const LanesParams& p, const LanesThread& th,
                                             float (&An)[kLaneStates], float (&A2)[kLaneStates]) {
#pragma unroll
  for (int j = 0; j < kLaneStates; ++j) {
    const int n = 4 * th.grp + j;
    An[j] = n < p.N ? p.A[th.kc * p.N + n] : 0.f;
    A2[j] = An[j] * kLog2e;
  }
}

__device__ __forceinline__ float* lanes_ck(const LanesParams& p, const LanesThread& th, int j) {
  return p.ck + ((th.img * p.K + th.k) * p.n_chunks + j) * p.N * p.C + th.c;
}

// ---------------------------------------------------------------------------
// kernel 13: the forward
// ---------------------------------------------------------------------------

// Dynamic shared memory of the forward: delta, delta u and the chains' sums
// over n [chunk][cs], the widened B, C [chunk][16], then two raw buffers.
__host__ __device__ inline int lanes_fwd_smem(int chunk, int warps, int esize) {
  const int cs = 8 * warps;
  return (3 * chunk * cs + 2 * chunk * kLanesRow) * 4 + 2 * lanes_raw_elems(chunk, cs) * esize;
}

template <typename T>
__global__ void __launch_bounds__(kLanesMaxWarps * 32) lanes_fwd_kernel(LanesParams p) {
  extern __shared__ __align__(16) float smem[];
  const LanesThread th = lanes_thread(p);
  const int cs = th.cs, chunk = p.chunk, nthr = blockDim.x;
  float* s_dt = smem;
  float* s_dtu = s_dt + chunk * cs;
  float* s_y = s_dtu + chunk * cs;  // sum_n C_n h_n
  float* s_b = s_y + chunk * cs;
  float* s_c = s_b + chunk * kLanesRow;
  T* raw0 = reinterpret_cast<T*>(s_c + chunk * kLanesRow);
  const int raw_elems = lanes_raw_elems(chunk, cs);
  float An[kLaneStates], A2[kLaneStates], h[kLaneStates];
  lanes_decays(p, th, An, A2);
#pragma unroll
  for (int j = 0; j < kLaneStates; ++j) h[j] = 0.f;
  // the prep pass and the output rows: channel tid % cs of the slab
  const int pch = th.tid % cs;
  const bool plive = th.c0 + pch < p.C;
  const long long pkc = static_cast<long long>(th.k) * p.C + (plive ? th.c0 + pch : p.C - 1);
  const float p_bias = p.bias ? p.bias[pkc] : 0.f, p_d = p.Dv ? p.Dv[pkc] : 0.f;
  float* y = p.y + th.img * p.L * th.KC + pkc;

  // the m-th chunk walked starts at position chunk_t0(m); each is staged
  // while the one before is walked
  auto chunk_t0 = [&](int m) { return (p.reverse ? p.n_chunks - 1 - m : m) * chunk; };
  lanes_stage_chunk<T>(p, th, lanes_raw(raw0, chunk, cs), chunk_t0(0),
                       min(chunk, p.L - chunk_t0(0)));
  cp_async_commit();
  for (int m = 0; m < p.n_chunks; ++m) {
    const int t0 = chunk_t0(m), cnt = min(chunk, p.L - t0);
    if (m + 1 < p.n_chunks) {
      const int t1 = chunk_t0(m + 1);
      lanes_stage_chunk<T>(p, th, lanes_raw(raw0 + ((m + 1) & 1) * raw_elems, chunk, cs), t1,
                           min(chunk, p.L - t1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const LanesRaw<T> r = lanes_raw(raw0 + (m & 1) * raw_elems, chunk, cs);
    for (int i = th.tid / cs; i < cnt; i += nthr / cs) {
      const int e = i * cs + pch;
      const float dt = plive ? softplus20_fast(to_f32(r.dl[e]) + p_bias) : 0.f;
      s_dt[e] = dt;
      s_dtu[e] = plive ? dt * to_f32(r.u[e]) : 0.f;
    }
    lanes_widen_bc<T>(p, r, cnt, s_b, s_c);
    __syncthreads();
    if (th.active) {
      float* ckj = lanes_ck(p, th, t0 / chunk);
#pragma unroll
      for (int j = 0; j < kLaneStates; ++j) {
        const int n = 4 * th.grp + j;
        if (n < p.N) ckj[static_cast<long long>(n) * p.C] = h[j];
      }
    }
#pragma unroll 4
    for (int s = 0; s < cnt; ++s) {
      const int i = p.reverse ? cnt - 1 - s : s;
      const int e = i * cs + th.chain;
      const float dt = s_dt[e], dtu = s_dtu[e];
      float bn[kLaneStates], cn[kLaneStates];
      lanes_load(s_b + i * kLanesRow, th.grp, bn);
      lanes_load(s_c + i * kLanesRow, th.grp, cn);
      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < kLaneStates; ++j) {
        h[j] = fmaf(fast_exp2(dt * A2[j]), h[j], dtu * bn[j]);
        yv = fmaf(cn[j], h[j], yv);
      }
      // the chain's four lanes in a fixed order: (l0 + l1) + (l2 + l3)
      yv += __shfl_xor_sync(0xffffffffu, yv, 1);
      yv += __shfl_xor_sync(0xffffffffu, yv, 2);
      if (th.grp == 0) s_y[e] = yv;
    }
    __syncthreads();
    // y once, in rows of the slab: the sums and D u
    for (int i = th.tid / cs; plive && i < cnt; i += nthr / cs) {
      const int e = i * cs + pch;
      y[static_cast<long long>(t0 + i) * th.KC] = fmaf(p_d, to_f32(r.u[e]), s_y[e]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// kernel 14: the adjoint
// ---------------------------------------------------------------------------

// Dynamic shared memory of the adjoint: delta, delta u and dy [chunk][cs],
// the widened B and C [chunk][16], the segments' entry states
// [segments][kLaneStates][threads], a segment's dB / dC sums
// [kLanesSeg][warps][32] and lane partials of sum_n lambda_n B_n and of
// d delta [kLanesSeg][2][threads], then the raw rows.
__host__ __device__ inline int lanes_bwd_smem(int chunk, int warps, int esize) {
  const int cs = 8 * warps, nthr = 32 * warps, nseg = (chunk + kLanesSeg - 1) / kLanesSeg;
  return (3 * chunk * cs + 2 * chunk * kLanesRow + nseg * kLaneStates * nthr +
          3 * kLanesSeg * nthr) * 4 + lanes_raw_elems(chunk, cs) * esize;
}

// Sums the lane's 8 values (states 4 g + j of dB, then of dC) over the
// warp's 8 chains by a reduce-scatter over lane bits 4, 3, 2: the lane ends
// with the sum of value (lane >> 2) & 7.
__device__ __forceinline__ float lanes_reduce_scatter(float (&v)[8], int lane) {
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
  const bool hi = lane & 4;
  const float send = hi ? v[0] : v[1];
  return (hi ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
}

// At most 128 registers: four blocks of 4 warps an SM.
template <typename T>
__global__ void __launch_bounds__(kLanesMaxWarps * 32, 2) lanes_bwd_kernel(LanesParams p) {
  extern __shared__ __align__(16) float smem[];
  const LanesThread th = lanes_thread(p);
  const int cs = th.cs, chunk = p.chunk, nthr = blockDim.x, warps = p.warps;
  const int nseg_max = (chunk + kLanesSeg - 1) / kLanesSeg;
  float* s_dt = smem;
  float* s_dtu = s_dt + chunk * cs;
  float* s_dy = s_dtu + chunk * cs;
  float* s_b = s_dy + chunk * cs;
  float* s_c = s_b + chunk * kLanesRow;
  float* s_hk = s_c + chunk * kLanesRow;         // [segment][kLaneStates][nthr]
  float* red = s_hk + nseg_max * kLaneStates * nthr;      // [kLanesSeg][warps][32]
  float* part = red + kLanesSeg * nthr;          // [kLanesSeg][2][nthr]
  const LanesRaw<T> raw = lanes_raw(reinterpret_cast<T*>(part + 2 * kLanesSeg * nthr), chunk, cs);

  float An[kLaneStates], A2[kLaneStates], g[kLaneStates], dA[kLaneStates];
  lanes_decays(p, th, An, A2);
#pragma unroll
  for (int j = 0; j < kLaneStates; ++j) g[j] = dA[j] = 0.f;
  // the prep pass and the output rows: channel tid % cs of the slab, whose
  // four lanes are threads pl .. pl + 3
  const int pch = th.tid % cs, pl = (pch / 8) * 32 + (pch % 8) * 4;
  const bool plive = th.c0 + pch < p.C;
  const long long pkc = static_cast<long long>(th.k) * p.C + (plive ? th.c0 + pch : p.C - 1);
  const float p_bias = p.bias ? p.bias[pkc] : 0.f, p_d = p.Dv ? p.Dv[pkc] : 0.f;
  float dbias_acc = 0.f, dD_acc = 0.f;
  const long long base = th.img * p.L * th.KC;
  const float* dy_g = p.dy + base + static_cast<long long>(th.k) * p.C + th.c0;
  float* du = p.du + base + pkc;
  float* ddelta = p.ddelta + base + pkc;
  // the dB / dC flush: thread tid sums value vi = (lane >> 2) & 7 of lane
  // group g = lane & 3, state 4 g + (vi & 3) of dB (vi < 4) or of dC, over
  // the warps in order, at positions tid / 32, + warps, ... of a segment
  const int f_ln = th.tid & 31, f_vi = (f_ln >> 2) & 7, f_n = 4 * (f_ln & 3) + (f_vi & 3);
  const long long f_stride = static_cast<long long>(p.K) * 2 * p.N;  // a position's row
  float* f_row = p.bc_part + (static_cast<long long>(blockIdx.x) * p.B + th.img) * p.L * f_stride +
                 (th.k * 2 + (f_vi >> 2)) * p.N + f_n;

  for (int m = 0; m < p.n_chunks; ++m) {
    const int jc = p.reverse ? m : p.n_chunks - 1 - m;  // adjoint order
    const int t0 = jc * chunk, cnt = min(chunk, p.L - t0);
    __syncthreads();  // the chunk before's flushes have read its rows
    lanes_stage_chunk<T>(p, th, raw, t0, cnt);
    lanes_stage(s_dy, cs, dy_g + static_cast<long long>(t0) * th.KC, th.KC, cnt,
                min(cs, p.C - th.c0));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = th.tid / cs; i < cnt; i += nthr / cs) {
      const int e = i * cs + pch;
      const float dt = plive ? softplus20_fast(to_f32(raw.dl[e]) + p_bias) : 0.f;
      s_dt[e] = dt;
      s_dtu[e] = plive ? dt * to_f32(raw.u[e]) : 0.f;
      if (!plive) s_dy[e] = 0.f;  // an idle chain adds zeros
    }
    lanes_widen_bc<T>(p, raw, cnt, s_b, s_c);
    __syncthreads();
    auto pos = [&](int s) { return p.reverse ? cnt - 1 - s : s; };

    // 1. from the checkpoint, in scan order: the state entering each segment
    float h[kLaneStates];
    {
      const float* ckj = lanes_ck(p, th, jc);
#pragma unroll
      for (int j = 0; j < kLaneStates; ++j) {
        const int n = 4 * th.grp + j;
        h[j] = th.active && n < p.N ? ckj[static_cast<long long>(n) * p.C] : 0.f;
      }
    }
#pragma unroll 4
    for (int s = 0; s < cnt; ++s) {
      if (s % kLanesSeg == 0) {
#pragma unroll
        for (int j = 0; j < kLaneStates; ++j)
          s_hk[((s / kLanesSeg) * kLaneStates + j) * nthr + th.tid] = h[j];
      }
      const int i = pos(s);
      const int e = i * cs + th.chain;
      const float dt = s_dt[e], dtu = s_dtu[e];
      float bn[kLaneStates];
      lanes_load(s_b + i * kLanesRow, th.grp, bn);
#pragma unroll
      for (int j = 0; j < kLaneStates; ++j) h[j] = fmaf(fast_exp2(dt * A2[j]), h[j], dtu * bn[j]);
    }

    // 2. each segment, in adjoint order: recompute, then (once the last
    //    segment's flushes are done with red and part) walk back, then flush
    const int nseg = (cnt + kLanesSeg - 1) / kLanesSeg;
    for (int sg = nseg - 1; sg >= 0; --sg) {
      const int s0 = sg * kLanesSeg, scnt = min(kLanesSeg, cnt - s0);
      float hin[kLaneStates], hw[kLanesSeg][kLaneStates], aw[kLanesSeg][kLaneStates];
#pragma unroll
      for (int j = 0; j < kLaneStates; ++j) hin[j] = s_hk[(sg * kLaneStates + j) * nthr + th.tid];
#pragma unroll
      for (int q = 0; q < kLanesSeg; ++q) {
        if (q < scnt) {
          const int i = pos(s0 + q);
          const int e = i * cs + th.chain;
          const float dt = s_dt[e], dtu = s_dtu[e];
          float bn[kLaneStates];
          lanes_load(s_b + i * kLanesRow, th.grp, bn);
#pragma unroll
          for (int j = 0; j < kLaneStates; ++j) {
            aw[q][j] = fast_exp2(dt * A2[j]);
            hw[q][j] = fmaf(aw[q][j], q ? hw[q - 1][j] : hin[j], dtu * bn[j]);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = kLanesSeg - 1; q >= 0; --q) {
        if (q < scnt) {
          const int i = pos(s0 + q);
          const int e = i * cs + th.chain;
          const float dt = s_dt[e], dtu = s_dtu[e], dyv = s_dy[e];
          float bn[kLaneStates], cn[kLaneStates], v[8];
          lanes_load(s_b + i * kLanesRow, th.grp, bn);
          lanes_load(s_c + i * kLanesRow, th.grp, cn);
          float lam_b = 0.f, dd = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = v[4 + j] = 0.f;
#pragma unroll
          for (int j = 0; j < kLaneStates; ++j) {
            const float hp = q ? hw[q - 1][j] : hin[j];
            const float lam = fmaf(cn[j], dyv, g[j]);
            g[j] = aw[q][j] * lam;
            lam_b = fmaf(lam, bn[j], lam_b);
            const float dexp = lam * hp * aw[q][j];
            dd = fmaf(dexp, An[j], dd);
            dA[j] = fmaf(dexp, dt, dA[j]);
            v[j] = lam * dtu;
            v[4 + j] = dyv * hw[q][j];
          }
          part[(2 * q) * nthr + th.tid] = lam_b;
          part[(2 * q + 1) * nthr + th.tid] = dd;
          red[(q * warps + th.warp) * 32 + th.lane] = lanes_reduce_scatter(v, th.lane);
        }
      }
      __syncthreads();
      for (int sl = th.tid >> 5; f_n < p.N && sl < scnt; sl += warps) {
        float sum = 0.f;
        for (int w = 0; w < warps; ++w) sum += red[(sl * warps + w) * 32 + f_ln];
        f_row[(t0 + pos(s0 + sl)) * f_stride] = sum;
      }
      // du and d delta in rows of the slab: each chain's four lanes summed
      // in a fixed order, (l0 + l1) + (l2 + l3)
      for (int sl = th.tid / cs; plive && sl < scnt; sl += nthr / cs) {
        const int i = pos(s0 + sl), e = i * cs + pch;
        const float4 pb = *reinterpret_cast<const float4*>(part + 2 * sl * nthr + pl);
        const float4 pd = *reinterpret_cast<const float4*>(part + (2 * sl + 1) * nthr + pl);
        const float lam_b = (pb.x + pb.y) + (pb.z + pb.w);
        const float dd = (pd.x + pd.y) + (pd.z + pd.w);
        const float z = to_f32(raw.dl[e]) + p_bias, uu = to_f32(raw.u[e]), dyv = s_dy[e];
        const float dz = fmaf(uu, lam_b, dd) * (z > 20.f ? 1.f : __fdividef(1.f, 1.f + __expf(-z)));
        const long long o = static_cast<long long>(t0 + i) * th.KC;
        du[o] = fmaf(lam_b, s_dt[e], dyv * p_d);
        ddelta[o] = dz;
        dbias_acc += dz;
        dD_acc = fmaf(dyv, uu, dD_acc);
      }
    }
  }
  if (th.active) {
#pragma unroll
    for (int j = 0; j < kLaneStates; ++j) {
      const int n = 4 * th.grp + j;
      if (n < p.N) p.dA_part[(th.img * th.KC + th.kc) * p.N + n] = dA[j];
    }
  }
  // dbias and dD: the four threads of each channel in order
  __syncthreads();
  red[th.tid] = dbias_acc;
  red[nthr + th.tid] = dD_acc;
  __syncthreads();
  if (th.tid < cs && plive) {
    float sb = 0.f, sd = 0.f;
    for (int r = 0; r < nthr / cs; ++r) {
      sb += red[r * cs + th.tid];
      sd += red[nthr + r * cs + th.tid];
    }
    p.dbias_part[th.img * th.KC + pkc] = sb;
    p.dD_part[th.img * th.KC + pkc] = sd;
  }
}

// The partials in a fixed order: dB / dC over the slabs, dA, dD and dbias
// over the images.
__global__ void lanes_finish_kernel(LanesParams p, float* dB, float* dC, float* dA, float* dD,
                                    float* dbias) {
  const long long KC = static_cast<long long>(p.K) * p.C;
  const long long n_bc = static_cast<long long>(p.B) * p.L * p.K * 2 * p.N;
  const long long n_a = KC * p.N;
  const long long total = n_bc + n_a + 2 * KC;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long e = i;
    if (e < n_bc) {
      // e = (row K + k) 2 N + which N + n
      float v = 0.f;
      for (int s = 0; s < p.slabs; ++s) v += p.bc_part[s * n_bc + e];
      const long long n = e % p.N, which = e / p.N % 2, rk = e / (2 * p.N);
      (which ? dC : dB)[rk * p.N + n] = v;
      continue;
    }
    e -= n_bc;
    if (e < n_a) {
      float v = 0.f;
      for (int b = 0; b < p.B; ++b) v += p.dA_part[b * n_a + e];
      dA[e] = v;
      continue;
    }
    e -= n_a;
    const bool is_d = e >= KC;
    e -= is_d ? KC : 0;
    const float* part = is_d ? p.dD_part : p.dbias_part;
    float v = 0.f;
    for (int b = 0; b < p.B; ++b) v += part[b * KC + e];
    (is_d ? dD : dbias)[e] = v;
  }
}

// Raises a kernel's dynamic shared memory limit once (outside any stream
// capture: the first call is never captured).
template <typename K>
cudaError_t lanes_smem_limit(K kernel, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  ready = err == cudaSuccess;
  return err;
}

template <typename T>
cudaError_t lanes_launch(LanesParams& p, bool backward, float* const* grads, cudaStream_t s) {
  const dim3 grid(p.slabs, p.K, p.B);
  const int threads = p.warps * 32;
  if (!backward) {
    static bool ready = false;
    const auto kernel = lanes_fwd_kernel<T>;
    const cudaError_t err = lanes_smem_limit(kernel, ready);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, lanes_fwd_smem(p.chunk, p.warps, sizeof(T)), s>>>(p);
    return cudaGetLastError();
  }
  static bool ready = false;
  const auto kernel = lanes_bwd_kernel<T>;
  const cudaError_t err = lanes_smem_limit(kernel, ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, lanes_bwd_smem(p.chunk, p.warps, sizeof(T)), s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(p.B) * p.L * p.K * 2 * p.N +
                          static_cast<long long>(p.K) * p.C * (p.N + 2);
  const int blocks = ceil_div(total, 256) < 65535 * 8 ? ceil_div(total, 256) : 65535 * 8;
  lanes_finish_kernel<<<blocks, 256, 0, s>>>(p, grads[0], grads[1], grads[2], grads[3],
                                             grads[4]);
  return cudaGetLastError();
}

cudaError_t run_lanes(LanesParams& p, int dtype, bool backward, float* const* grads,
                      void* stream) {
  if (p.B < 1 || p.B > 65535 || p.L < 1 || p.K < 1 || p.K > 65535 || p.C < 1 || p.N < 1 ||
      p.N > kLanesRow || p.chunk < 1 || p.chunk > kLanesMaxChunk || p.warps < 1 ||
      p.warps > kLanesMaxWarps || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  p.n_chunks = ceil_div(p.L, p.chunk);
  p.slabs = ceil_div(p.C, 8 * p.warps);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return lanes_launch<float>(p, backward, grads, s);
  return lanes_launch<__nv_bfloat16>(p, backward, grads, s);
}

}  // namespace xfm

using namespace xfm;

// Kernel 13.  u, delta, B, C contiguous in the dtype; A (K * C, N), D and
// bias (K * C,) or null, float32.  Writes y (B, L, K * C) and the
// checkpoints ck (B, K, ceil(L / chunk), N, C), float32.  A block is a slab
// of 8 x warps channels (ops/selective_scan_grouped.py::lanes_warps).
extern "C" int xfm_grouped_scan_fwd(const void* u, const void* delta, const float* A,
                                    const void* Bm, const void* Cm, const float* Dv,
                                    const float* bias, float* y, float* ck, int B, int L, int K,
                                    int C, int N, int chunk, int reverse, int warps, int dtype,
                                    void* stream) {
  LanesParams p{};
  p.u = u;
  p.delta = delta;
  p.A = A;
  p.Bm = Bm;
  p.Cm = Cm;
  p.Dv = Dv;
  p.bias = bias;
  p.y = y;
  p.ck = ck;
  p.B = B;
  p.L = L;
  p.K = K;
  p.C = C;
  p.N = N;
  p.chunk = chunk;
  p.reverse = reverse;
  p.warps = warps;
  return run_lanes(p, dtype, false, nullptr, stream);
}

// Kernel 14: two launches, the adjoint and the fixed-order sums.  From the
// forward's checkpoints and dy (B, L, K * C) float32, writes du, ddelta
// (B, L, K * C), dB, dC (B, L, K, N), dA (K * C, N), dD, dbias (K * C,),
// all float32 and whole.  Scratch (float32): bc_part (slabs, B, L, K, 2, N)
// with slabs = ceil(C / (8 warps)), dA_part (B, K * C, N), dbias_part and
// dD_part (B, K * C).
extern "C" int xfm_grouped_scan_bwd(const void* u, const void* delta, const float* A,
                                    const void* Bm, const void* Cm, const float* Dv,
                                    const float* bias, float* ck, const float* dy, float* du,
                                    float* ddelta, float* dB, float* dC, float* dA, float* dD,
                                    float* dbias, float* bc_part, float* dA_part,
                                    float* dbias_part, float* dD_part, int B, int L, int K, int C,
                                    int N, int chunk, int reverse, int warps, int dtype,
                                    void* stream) {
  LanesParams p{};
  p.u = u;
  p.delta = delta;
  p.A = A;
  p.Bm = Bm;
  p.Cm = Cm;
  p.Dv = Dv;
  p.bias = bias;
  p.ck = ck;
  p.dy = dy;
  p.du = du;
  p.ddelta = ddelta;
  p.bc_part = bc_part;
  p.dA_part = dA_part;
  p.dbias_part = dbias_part;
  p.dD_part = dD_part;
  p.B = B;
  p.L = L;
  p.K = K;
  p.C = C;
  p.N = N;
  p.chunk = chunk;
  p.reverse = reverse;
  p.warps = warps;
  float* const grads[5] = {dB, dC, dA, dD, dbias};
  return run_lanes(p, dtype, true, grads, stream);
}
