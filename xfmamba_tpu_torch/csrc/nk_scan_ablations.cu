// Kernels 17 and 18, redesigned for the H100: two alternative schedules of
// the fusion-op nk scan, the ablations that the JAX dispatcher
// xfmamba_tpu/ops/vss_block_pallas_v2.py::nk_scan_call_v2 (:1076) picks
// ahead of kernel 2 when their switches are on:
//
// - kernel 17, the v4 scan, replaces
//   xfmamba_tpu/ops/ablations/nk_scan_v4.py::_nk_scan_kernel_v4 (:50,
//   pallas_call :196), taken under FUSED_V4 at an image group of 8;
// - kernel 18, the wide-state v3 scan, replaces
//   xfmamba_tpu/ops/ablations/nk_scan_wide.py::_nk_scan_kernel_v3 (:40,
//   pallas_call :220), taken under FUSED_V3.
//
// Both compute kernel 2's function (nk_scan_fused.cu): for each kind k the
// recurrence runs flat over the L = H * W positions of one image in the
// kind's traversal order t
//   row_f: l = t    row_r: l = L - 1 - t    col_f: t = w * H + h    col_r: col_f reversed
//   delta = softplus(dts[l, k] + bias[k])
//   h[n]  = exp(delta * A[k, n]) * h[n] + delta * u[l] * B[l, k, n]
//   y[l]  = u[l] * Dsum + sum_k sum_n C[l, k, n] * h[n]
//
// The first design (nk_scan_ablations_v1.cu, kept for timings) loaded every
// step's operands from device memory inside the dependent walk, kept y in a
// float32 scratch in device memory, and walked the kinds (17) or the kind
// pairs (18) one after another.  This one takes kernel 9's frame
// (scan_whole_map.cu) and its staging helpers (staging.cuh), one launch a
// call, and keeps what sets each TPU kernel apart in the walk:
// - A block per (image, slab of S channels) holds every kind.  It stages its
//   map slice on chip at once, each operand in its dtype and in position
//   order: u and the deltas by 16-byte cp.async (element by element where
//   rows are not 16-byte aligned), B and C, whole contiguous blocks of the
//   image, by one bulk copy each; the traversal tables are computed while
//   the copies fly.  B and C are then widened into (b, c) float32 pairs.
//   The walks read shared memory and registers only.
// - Kernel 17 (v4: one chain per kind, channel and state; a and b formed
//   inline; y summed over the states inside the loop): a lane group of
//   NP = N rounded up to a power of two lanes per (kind, channel), lane n
//   holding state n.  An element pass first puts (delta, delta u) pairs in
//   traversal order.  At every step each lane forms a = exp2(delta A_n
//   log2 e) and b = (delta u) B_n, and log2(NP) shuffles sum C_n h_n over
//   the group (four at N = 16), with no barrier in the walk; the group's
//   first lane writes its kind's part of y for the step over the step's
//   delta u, which the group has read before the shuffles.  Blocks of up to
//   1024 threads, 32 registers a thread.
// - Kernel 18 (v3: all N states of a chain in one thread; the forward and
//   reverse chains of a kind pair advanced in the same loop; A pre-scaled by
//   log2 e; exp2): a thread per (kind pair, channel) holds the 2 x N states
//   and 2 x N scaled decay rates of its pair in registers, forms each step's
//   delta (a softplus, one per 16 exponentials at N = 16) and delta u from
//   the staged row, and reads B and C as 16-byte vectors that broadcast to
//   the warp.  Pairs of JAX's rule (cross2d: (row_f, row_r), (col_f,
//   col_r); bidi: (row_f, row_r) twice; unidi: each forward kind alone) run
//   in parallel; each chain's part goes to its kind's slot by position.
// - Each kind's part stays in shared memory; the block then writes y once,
//   u Dsum first (Dsum = sum_k Dk[k] in kind order) and the parts in the
//   plain twins' fixed order: kernel 17 in kind order; kernel 18 pair by
//   pair, and within a pair the chain that reaches the position first (the
//   forward one on a tie), as nk_scan_v3_plain adds them.  No scratch in
//   device memory, no atomics: the same bits on every run.
// - "Chunked" plan, for maps whose slice does not fit: kernel 17's kinds or
//   kernel 18's pairs in turns, each traversal staged and walked in chunks
//   of `chunk` steps with h carried in registers, every part added into one
//   float32 accumulator by position that starts at u Dsum: the same
//   additions in the same order as the whole plan, so the same bits.  The
//   accumulator holds a band of positions, the whole map where it fits;
//   past about 56,000 positions (4 bytes a position and channel) the block
//   walks every traversal once a band, carrying h, and adds only the band's
//   parts, so no map is refused.
//
// What bounds them on the H100 (chip_smoke.py phase 10's phase clock):
// kernel 17 runs 16 lanes where kernel 2 runs 4 and each lane-step costs
// about as many issue slots as kernel 2's four-state step, so its walk is
// bound by instruction throughput, whatever the order of the shuffles;
// kernel 18 reaches the exponentials' rate (16 an SM a clock) where its
// blocks fit, and its resident threads are bound by the shared memory each
// holds (the pairs' parts and deltas).
#include "staging.cuh"

namespace xfm {

enum AbKernel : int { kAbV4 = 0, kAbV3 = 1 };
constexpr int kAbV4Threads = 1024;  // kernel 17's block at most
constexpr int kAbV3Threads = 384;   // kernel 18's
// threads of a block at least: narrow slabs leave few chains for the
// staging, the widening, the deltas and the output
constexpr int kAbMinThreads = 128;
constexpr int kAbMaxSmem = 227 * 1024;
// phases of a block (the phase clock): issuing the copies (the tables
// meanwhile), waiting for them, widening B and C, deltas, walk, output
// (the chunked plan: its last chunk's, the output with it)
constexpr int kAbPhases = 6;

struct AbParams {
  const void* u;      // (n_img, L, D) T
  const void* dts;    // (n_img, L, K, D) T
  const void* Bs;     // (n_img, L, K, N) T
  const void* Cs;     // (n_img, L, K, N) T
  const float* A;     // (K, N, D)
  const float* bias;  // (K, D)
  const float* Dk;    // (K, D): u's skip is u sum_k Dk[k], summed in kind order
  void* out;          // (n_img, L, D) T
  int n_img, H, W, D, K, N, kinds;
  // kernel 18's pairs: pair i's forward kind (pair_f >> 4i) & 15, its
  // reverse kind ((pair_r >> 4i) & 15) - 1, -1 for a forward chain alone
  int n_pairs, pair_f, pair_r;
  int whole;  // 1: the map staged at once; 0: chunks, parts by position
  int slab;   // channels a block
  int chunk;  // traversal steps staged at once (L for the whole plan)
  int band;   // positions of the chunked plan's accumulator, walked a band at a time (L whole)
  int vec;    // 16-byte aligned base pointers: bit 0 u, 1 dts, 2 Bs and Cs, 3 bias and Dk
  unsigned long long* stamps;  // (blocks, kAbPhases + 1) global-timer readings, or null
};

// the states of a chain as the walk holds them: kernel 17's lanes a chain
// (N rounded up to a power of two), kernel 18's states a thread (4 or 16)
__host__ __device__ inline int ab_np(int kernel, int N) {
  if (kernel == kAbV3) return N <= 4 ? 4 : 16;
  int np = 1;
  while (np < N) np *= 2;
  return np;
}
__host__ __device__ inline int ab_threads(int kernel, int K, int n_pairs, int S, int N) {
  const int chains = kernel == kAbV4 ? K * S * ab_np(kernel, N) : n_pairs * S;
  return chains > kAbMinThreads ? chains : kAbMinThreads;
}

// Byte offsets of a block's dynamic shared memory.  The whole plan stages
// the map's rows (u, the deltas, B and C in their dtype) by position, every
// kind at once; the chunked plan stages a chunk's steps of the kinds it
// walks at a time (kernel 17 one kind, kernel 18 one pair) in traversal
// order.  Kernel 17: the (b, c) and (delta, delta u) pairs are in traversal
// order (the whole plan's inverse table gives a position's step); raw B and
// C share their region with the (delta, delta u) pairs, written after the
// widening, and in the whole plan each step's part of y takes the place of
// its delta u.  Kernel 18: the (b, c) pairs are by staged row, and the walk
// finds a step's row in the traversal table (whole plan); its parts are
// kept by position over raw B and C.  The chunked plan adds every part into
// one float32 accumulator of a band of `band` positions, by position.
struct AbLayout {
  int bar, pos, inv, bias, dk, u, z, b, c, pitch, bc, dx, part, total;
};

__host__ __device__ inline AbLayout ab_layout(int kernel, bool whole, int K, int L, int T, int N,
                                              int np, int S, int band, int esize) {
  const bool v4 = kernel == kAbV4;
  const int KB = whole ? K : (v4 ? 1 : 2);  // kinds staged at once
  const int rows = whole ? L : KB * T;
  AbLayout s{};
  int off = 0;
  s.bar = off, off += 16;
  s.pos = off, off = stage_align(off + (whole ? (v4 ? 0 : K * L * 4) : KB * T * 4));
  s.inv = off, off = stage_align(off + (whole && v4 ? K * L * 4 : 0));
  s.bias = off, off = stage_align(off + K * S * 4);
  s.dk = off, off = stage_align(off + K * S * 4);
  s.u = off, off = stage_align(off + rows * S * esize);
  s.z = off, off = stage_align(off + (whole ? L * K : KB * T) * S * esize);
  s.bc = off, off = stage_align(off + KB * T * np * 8);
  s.pitch = stage_pad(whole ? K * N : N, esize);
  s.b = s.dx = off;
  s.c = s.b + rows * s.pitch * esize;
  const int raw = 2 * rows * s.pitch * esize;
  if (whole && !v4) {
    s.part = s.b, off = stage_align(off + max(raw, K * L * S * 4));
  } else {
    off = stage_align(off + max(raw, v4 ? KB * T * S * 8 : 0));
    s.part = off, off += whole ? 0 : band * S * 4;
  }
  s.total = off;
  return s;
}

// the step at which a kind (code: bit 0 column-major, bit 1 reversed)
// visits position l
__device__ __forceinline__ int ab_step(int l, int code, int H, int W) {
  const int t = (code & 1) ? (l % W) * H + l / W : l;
  return code >= 2 ? H * W - 1 - t : t;
}

// one step of a kernel-18 chain: its NP states from the step's (delta,
// delta u) and (b, c) pairs, two states a 16-byte load; returns sum_n C h
// (even and odd states summed apart, then added)
template <int NP>
__device__ __forceinline__ float v3_step(float2 dx, const float2* bc, const float (&a)[NP],
                                         float (&h)[NP]) {
  float y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int n = 0; n < NP; n += 2) {
    const float4 q = *reinterpret_cast<const float4*>(bc + n);
    h[n] = fmaf(fast_exp2(dx.x * a[n]), h[n], dx.y * q.x);
    h[n + 1] = fmaf(fast_exp2(dx.x * a[n + 1]), h[n + 1], dx.y * q.z);
    y0 = fmaf(q.y, h[n], y0);
    y1 = fmaf(q.w, h[n + 1], y1);
  }
  return y0 + y1;
}

// Kernel 17 at most 32 registers a thread (two of its largest blocks an SM),
// kernel 18 at most 168, room for its 2 x N states and decay rates with
// three blocks of 128 threads an SM
template <typename T, int KERNEL, int NP, bool WHOLE>
__global__ void __launch_bounds__(KERNEL == kAbV4 ? kAbV4Threads : kAbV3Threads,
                                  KERNEL == kAbV4 ? 2 : 1)
    nk_ablation_kernel(AbParams p) {
  extern __shared__ __align__(16) float ab_smem[];
  constexpr int ES = sizeof(T);
  constexpr bool V4 = KERNEL == kAbV4;
  // elements a thread takes at a time in the passes, all loads before any
  // store (kernel 17 fewer: its 32 registers)
  constexpr int EF = V4 ? 2 : 4;
  const int L = p.H * p.W, T_ = p.chunk, D = p.D, K = p.K, N = p.N, S = p.slab;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // the kinds staged at once (the chunked plan: kernel 17 one kind, kernel
  // 18 one pair, in turns) and kind slot kb's kind in turn grp
  const int KB = WHOLE ? K : (V4 ? 1 : 2);
  const int turns = WHOLE ? 1 : (V4 ? K : p.n_pairs);
  auto pair_f = [&](int i) { return (p.pair_f >> (4 * i)) & 15; };
  auto pair_r = [&](int i) { return ((p.pair_r >> (4 * i)) & 15) - 1; };
  auto kind_of = [&](int grp, int kb) {
    if (WHOLE) return kb;
    if (V4) return grp;
    return kb == 0 || pair_r(grp) < 0 ? pair_f(grp) : pair_r(grp);
  };
  // the chain a thread walks: kernel 17, lane g of (kind slot ks, channel
  // c); kernel 18, channel c of pair pi.  A block may hold more threads than
  // chains, for its element passes: those walk a copy of the last chain and
  // write nothing
  int g = 0, ks = 0, pi = 0, c;
  bool walker;
  if (V4) {
    const int chain = tid / NP;
    g = tid % NP, ks = WHOLE ? min(chain / S, K - 1) : 0, c = chain % S;
    walker = chain < (WHOLE ? K : 1) * S;
  } else {
    pi = WHOLE ? min(tid / S, p.n_pairs - 1) : 0, c = tid % S;
    walker = tid < (WHOLE ? p.n_pairs : 1) * S;
  }
  // the element passes: a row of the slab's S channels at a time
  const int q0 = tid % S, r0 = tid / S, rstep = nthr / S;
  const int img = blockIdx.y, c0 = blockIdx.x * S;
  const int valid_c = D - c0, slab_c = min(valid_c, S), cc = min(c0 + c, D - 1);
  const long long row0 = static_cast<long long>(img) * L;
  const AbLayout lay = ab_layout(KERNEL, WHOLE, K, L, T_, N, NP, S, p.band, ES);
  char* base = reinterpret_cast<char*>(ab_smem);
  auto* bar = reinterpret_cast<unsigned long long*>(base + lay.bar);
  int* pos_s = reinterpret_cast<int*>(base + lay.pos);
  int* inv_s = reinterpret_cast<int*>(base + lay.inv);
  float* bias_s = reinterpret_cast<float*>(base + lay.bias);
  float* dk_s = reinterpret_cast<float*>(base + lay.dk);
  T* u_s = reinterpret_cast<T*>(base + lay.u);
  T* z_s = reinterpret_cast<T*>(base + lay.z);
  T* braw = reinterpret_cast<T*>(base + lay.b);
  T* craw = reinterpret_cast<T*>(base + lay.c);
  float2* bc_s = reinterpret_cast<float2*>(base + lay.bc);
  float2* dx_s = reinterpret_cast<float2*>(base + lay.dx);  // (delta, delta u), then (., part)
  float* part_s = reinterpret_cast<float*>(base + lay.part);  // parts, or the accumulator
  const T* u = static_cast<const T*>(p.u);
  const T* dts = static_cast<const T*>(p.dts);
  const T* Bs = static_cast<const T*>(p.Bs);
  const T* Cs = static_cast<const T*>(p.Cs);
  // the phase clock: thread 0 stamps each phase's end
  auto stamp = [&](int i) {
    if (p.stamps && tid == 0)
      p.stamps[(blockIdx.y * gridDim.x + blockIdx.x) * (kAbPhases + 1) + i] = stage_clock();
  };
  stamp(0);

  // rows may go by 16-byte copies where the base pointer, the row stride
  // and the slab's offset are whole 16-byte pieces
  const bool vec_u = (p.vec & 1) && D * ES % 16 == 0 && S * ES % 16 == 0;
  const bool vec_z = (p.vec & 2) && D * ES % 16 == 0 && S * ES % 16 == 0;
  const int bc_row = WHOLE ? K * N : N;  // B / C elements of a staged row
  const bool vec_bc = (p.vec & 4) && bc_row * ES % 16 == 0;
  const bool vec_v = (p.vec & 8) && D % 4 == 0 && S % 4 == 0;
  unsigned long long* bulk = WHOLE && vec_bc ? bar : nullptr;
  if (bulk) {
    if (tid == 0) stage_bar_init(bar, nthr);
    __syncthreads();
  }
  // the chunked plan walks every traversal once a band of positions
  // [b0, b0 + bn), adding only the band's parts: the same additions in the
  // same order for each position, whatever the band
  const int n_bands = WHOLE ? 1 : (L + p.band - 1) / p.band;
  for (int band = 0; band < n_bands; ++band) {
    const int b0 = WHOLE ? 0 : band * p.band, bn = WHOLE ? L : min(p.band, L - b0);
    if (!WHOLE) {
      if (b0 > 0) __syncthreads();  // the last band's output has read the accumulator
      if (q0 < valid_c) {
        // the accumulator starts at u sum_k Dk[k]
        float dsum = 0.f;
        for (int k = 0; k < K; ++k) dsum += p.Dk[k * D + c0 + q0];
        for (int l = r0; l < bn; l += rstep)
          part_s[l * S + q0] = to_f32(u[(row0 + b0 + l) * D + c0 + q0]) * dsum;
      }
    }
    for (int grp = 0; grp < turns; ++grp) {
      // the states of the turn's chains: kernel 17 its lane's one, kernel 18
      // every state of its pair's two chains; carried across chunks
      constexpr int NR = V4 ? 1 : NP;
      float hf[NR], hr[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j) hf[j] = 0.f, hr[j] = 0.f;
      for (int t0 = 0; t0 < L; t0 += T_) {
        const int tn = min(T_, L - t0);
        if (!WHOLE) {
          // the chunk's positions first: its rows are gathered by them (steps
          // past the map's end point at position 0, staged and never walked)
          if (t0 > 0 || grp > 0) __syncthreads();  // the last chunk is walked
          for (int i = tid; i < KB * T_; i += nthr) {
            const int kb = i / T_, t = i % T_;
            const int code = (p.kinds >> (2 * kind_of(grp, kb))) & 3;
            pos_s[i] = t < tn ? traversal_pos(t0 + t, code, p.H, p.W) : 0;
          }
          __syncthreads();
          const int rows = KB * T_;
          stage_rows(u_s, rows, S, slab_c, vec_u,
                     [&](int r) { return u + (row0 + pos_s[r]) * D + c0; });
          stage_rows(z_s, rows, S, slab_c, vec_z, [&](int r) {
            return dts + ((row0 + pos_s[r]) * K + kind_of(grp, r / T_)) * D + c0;
          });
          stage_rows(braw, rows, lay.pitch, N, vec_bc, [&](int r) {
            return Bs + (row0 + pos_s[r]) * K * N + kind_of(grp, r / T_) * N;
          });
          stage_rows(craw, rows, lay.pitch, N, vec_bc, [&](int r) {
            return Cs + (row0 + pos_s[r]) * K * N + kind_of(grp, r / T_) * N;
          });
        } else {
          stage_rows(u_s, L, S, slab_c, vec_u, [&](int r) { return u + (row0 + r) * D + c0; });
          stage_rows(z_s, L * K, S, slab_c, vec_z,
                   [&](int r) { return dts + (row0 * K + r) * D + c0; });
          if (bulk) {  // the image's B and C are whole contiguous blocks: one bulk copy each
            if (tid == 0) {
              stage_bulk_copy(braw, Bs + row0 * bc_row, L * bc_row * ES, bar);
              stage_bulk_copy(craw, Cs + row0 * bc_row, L * bc_row * ES, bar);
            }
          } else {
            stage_rows(braw, L, lay.pitch, bc_row, false,
                     [&](int r) { return Bs + (row0 + r) * bc_row; });
            stage_rows(craw, L, lay.pitch, bc_row, false,
                     [&](int r) { return Cs + (row0 + r) * bc_row; });
          }
        }
        if (b0 == 0 && t0 == 0 && grp == 0) {  // the per-channel vectors, zero past the D channels
          stage_rows(bias_s, K, S, slab_c, vec_v, [&](int r) { return p.bias + r * D + c0; });
          stage_rows(dk_s, K, S, slab_c, vec_v, [&](int r) { return p.Dk + r * D + c0; });
        }
        if (bulk) stage_bar_arrive(bar);
        cp_async_commit();
        // the whole plan's traversal tables while the copies are in flight:
        // kernel 17 a position's step, kernel 18 a step's position
        if (WHOLE)
          for (int i = tid; i < K * L; i += nthr) {
            const int kb = i / L, t = i % L;
            const int l = traversal_pos(t, (p.kinds >> (2 * kb)) & 3, p.H, p.W);
            if (V4) {
              inv_s[kb * L + l] = t;
            } else {
              pos_s[kb * L + t] = l;
            }
          }
        stamp(1);
        if (bulk) stage_bar_wait(bar, 0);
        cp_async_wait<0>();
        __syncthreads();
        stamp(2);
        // B and C widened into (b, c) pairs (zero past N): kernel 17 in each
        // kind's traversal order, kernel 18 by staged row.  The passes walk the
        // staged rows in their own order (a position, or the chunk's step) and
        // take EF elements a thread at a time.
        auto step_of = [&](int kb, int r) { return V4 && WHOLE ? inv_s[kb * L + r] : r; };
        if (NP % 4 == 0 && N == NP) {
          // four states at a time: 8- or 16-byte loads, two 16-byte stores
          constexpr int NQ = NP >= 4 ? NP / 4 : 1;
          const int items = tn * NQ;
          for (int kb = 0; kb < KB; ++kb)
            for (int i0 = tid; i0 < items; i0 += EF * nthr) {
              float bv[EF][4], cv[EF][4];
              int d[EF];
#pragma unroll
              for (int e = 0; e < EF; ++e) {
                const int i = min(i0 + e * nthr, items - 1), r = i / NQ, n = i % NQ * 4;
                const int o = WHOLE ? r * lay.pitch + kb * N + n : (kb * T_ + r) * lay.pitch + n;
                stage_load4(braw + o, bv[e]);
                stage_load4(craw + o, cv[e]);
                d[e] = (kb * T_ + step_of(kb, r)) * NP + n;
              }
#pragma unroll
              for (int e = 0; e < EF; ++e)
                if (i0 + e * nthr < items) {
                  auto* q = reinterpret_cast<float4*>(bc_s + d[e]);
                  q[0] = make_float4(bv[e][0], cv[e][0], bv[e][1], cv[e][1]);
                  q[1] = make_float4(bv[e][2], cv[e][2], bv[e][3], cv[e][3]);
                }
            }
        } else {
          const int items = tn * NP;
          for (int kb = 0; kb < KB; ++kb)
            for (int i0 = tid; i0 < items; i0 += EF * nthr) {
              float bv[EF], cv[EF];
              int d[EF];
#pragma unroll
              for (int e = 0; e < EF; ++e) {
                const int i = min(i0 + e * nthr, items - 1), r = i / NP, n = i % NP;
                const int o = WHOLE ? r * lay.pitch + kb * N + n : (kb * T_ + r) * lay.pitch + n;
                bv[e] = n < N ? to_f32(braw[o]) : 0.f;
                cv[e] = n < N ? to_f32(craw[o]) : 0.f;
                d[e] = (kb * T_ + step_of(kb, r)) * NP + n;
              }
#pragma unroll
              for (int e = 0; e < EF; ++e)
                if (i0 + e * nthr < items) bc_s[d[e]] = make_float2(bv[e], cv[e]);
            }
        }
        __syncthreads();  // raw B and C read: (delta, delta u) or parts take their place
        stamp(3);
        if constexpr (V4) {
          // (delta, delta u) in traversal order, for the kind's lane group
          for (int kb = 0; kb < KB; ++kb) {
            const float bias_q = bias_s[kind_of(grp, kb) * S + q0];
            for (int r1 = r0; r1 < tn; r1 += EF * rstep) {
              float zv[EF], uv[EF];
              int o[EF];
#pragma unroll
              for (int e = 0; e < EF; ++e) {
                const int r = min(r1 + e * rstep, tn - 1);
                zv[e] = to_f32(z_s[(WHOLE ? r * K + kb : kb * T_ + r) * S + q0]);
                uv[e] = to_f32(u_s[(WHOLE ? r : kb * T_ + r) * S + q0]);
                o[e] = (kb * T_ + step_of(kb, r)) * S + q0;
              }
#pragma unroll
              for (int e = 0; e < EF; ++e)
                if (r1 + e * rstep < tn) {
                  const float delta = softplus20_fast(zv[e] + bias_q);
                  dx_s[o[e]] = make_float2(delta, delta * uv[e]);
                }
            }
          }
          __syncthreads();
        }
        stamp(4);

        // the walks, from shared memory and registers only.  A step's part of
        // y goes to its kind's slot (the whole plan) or into the accumulator
        // (the chunked plan, the kinds and the pairs' chains in the plain
        // twin's order)
        if constexpr (V4) {
          // log2(NP) shuffles sum the lanes' C_n h_n at every step; the first
          // lane writes the sum over the step's delta u, which the whole group
          // has read before the shuffles
          const int kind = kind_of(grp, ks);
          const float a2 =
              g < N ? p.A[(static_cast<long long>(kind) * N + g) * D + cc] * kLog2e : 0.f;
          const float2* dxp = dx_s + ks * T_ * S + c;
          const float2* bcp = bc_s + ks * T_ * NP + g;
          float* yp = reinterpret_cast<float*>(dx_s + ks * T_ * S + c) + 1;
          // two steps at a time: four spill at 32 registers, one is slower
          // (python -m xfmamba_tpu_torch.kernels.probe v4)
#pragma unroll 2
          for (int t = 0; t < tn; ++t) {
            const float2 dx = dxp[t * S], bc = bcp[t * NP];
            hf[0] = fmaf(fast_exp2(dx.x * a2), hf[0], dx.y * bc.x);
            float y = bc.y * hf[0];
#pragma unroll
            for (int off = NP / 2; off > 0; off >>= 1) y += __shfl_xor_sync(0xffffffffu, y, off);
            if (walker && g == 0) {
              if (WHOLE) {
                yp[2 * t * S] = y;
              } else {
                const int l = pos_s[ks * T_ + t] - b0;
                if (static_cast<unsigned>(l) < static_cast<unsigned>(bn)) part_s[l * S + c] += y;
              }
            }
          }
        } else {
          // the pair's forward and reverse chain in one loop, each step's
          // delta and delta u formed from the staged row; a part goes by
          // position to its kind's slot, or into the accumulator, the forward
          // chain's first
          const int ip = WHOLE ? pi : grp, kf = pair_f(ip), kr = pair_r(ip);
          const int sf = WHOLE ? kf : 0, sr = WHOLE ? (kr >= 0 ? kr : kf) : 1;
          float af[NP], ar[NP];
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            af[n] = n < N ? p.A[(static_cast<long long>(kf) * N + n) * D + cc] * kLog2e : 0.f;
            ar[n] = n < N && kr >= 0 ? p.A[(static_cast<long long>(kr) * N + n) * D + cc] * kLog2e
                                     : 0.f;
          }
          const float bias_f = bias_s[kf * S + c], bias_r = bias_s[(kr >= 0 ? kr : kf) * S + c];
          auto chain_step = [&](int s, int t, float bias, const float(&a)[NP], float(&h)[NP],
                                int& l) {
            const int r = WHOLE ? pos_s[s * L + t] : t;
            l = WHOLE ? r : pos_s[s * T_ + t] - b0;  // chunked: in the band
            const float z = to_f32(z_s[(WHOLE ? r * K + s : s * T_ + t) * S + c]);
            const float uu = to_f32(u_s[(WHOLE ? r : s * T_ + t) * S + c]);
            const float delta = softplus20_fast(z + bias);
            return v3_step<NP>(make_float2(delta, delta * uu), bc_s + (s * T_ + r) * NP, a, h);
          };
          float* yf = part_s + (WHOLE ? kf * L * S : 0) + c;
          float* yr = part_s + (WHOLE ? sr * L * S : 0) + c;
          for (int t = 0; t < tn; ++t) {
            int lf, lr;
            const float y0 = chain_step(sf, t, bias_f, af, hf, lf);
            if (walker) {
              if (WHOLE) {
                yf[lf * S] = y0;
              } else if (static_cast<unsigned>(lf) < static_cast<unsigned>(bn)) {
                yf[lf * S] += y0;
              }
            }
            if (kr >= 0) {
              const float y1 = chain_step(sr, t, bias_r, ar, hr, lr);
              if (walker) {
                if (WHOLE) {
                  yr[lr * S] = y1;
                } else if (static_cast<unsigned>(lr) < static_cast<unsigned>(bn)) {
                  yr[lr * S] += y1;
                }
              }
            }
          }
        }
        __syncthreads();
        stamp(5);
      }
    }
    // y in the plain twin's fixed order, written once (the band's positions)
    if (q0 < valid_c) {
      T* out = static_cast<T*>(p.out) + row0 * D + c0 + q0;
      float dsum = 0.f;
      for (int k = 0; k < K; ++k) dsum += dk_s[k * S + q0];
      auto part = [&](int k, int l) {
        return V4 ? dx_s[(k * T_ + inv_s[k * L + l]) * S + q0].y : part_s[(k * L + l) * S + q0];
      };
      for (int l1 = b0 + r0; l1 < b0 + bn; l1 += EF * rstep) {
        float v[EF];
#pragma unroll
        for (int e = 0; e < EF; ++e) {
          const int l = min(l1 + e * rstep, b0 + bn - 1);
          if (!WHOLE) {
            v[e] = part_s[(l - b0) * S + q0];  // the accumulator
            continue;
          }
          v[e] = to_f32(u_s[l * S + q0]) * dsum;
          if (V4) {
            for (int k = 0; k < K; ++k) v[e] += part(k, l);
          } else {
            for (int i = 0; i < p.n_pairs; ++i) {
              const int kf = pair_f(i), kb = pair_r(i);
              const float pf = part(kf, l);
              if (kb < 0) {
                v[e] += pf;
                continue;
              }
              // the chain that reaches l first adds first, the forward one on a tie
              const float pb = part(kb, l);
              const bool f_first = ab_step(l, (p.kinds >> (2 * kf)) & 3, p.H, p.W) <=
                                   ab_step(l, (p.kinds >> (2 * kb)) & 3, p.H, p.W);
              v[e] += f_first ? pf : pb;
              v[e] += f_first ? pb : pf;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < EF; ++e)
          if (l1 + e * rstep < b0 + bn)
            out[static_cast<long long>(l1 + e * rstep) * D] = from_f32<T>(v[e]);
      }
    }
  }
  if (p.stamps) {
    __syncthreads();
    stamp(kAbPhases);
  }
}

template <typename T, int KERNEL, int NP, bool WHOLE>
cudaError_t launch_ablation(const AbParams& p, int smem, cudaStream_t s) {
  auto kernel = nk_ablation_kernel<T, KERNEL, NP, WHOLE>;
  static bool ready = false;  // the attribute is set once, outside any stream capture
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAbMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(ceil_div(p.D, p.slab), p.n_img);
  kernel<<<grid, ab_threads(KERNEL, p.K, p.n_pairs, p.slab, p.N), smem, s>>>(p);
  return cudaGetLastError();
}

// the plan is a template argument: the whole plan's walk holds none of the
// chunked plan's band and accumulator (kernel 17 has 32 registers a thread)
template <typename T, int KERNEL, int NP>
cudaError_t launch_ablation_plan(const AbParams& p, int smem, cudaStream_t s) {
  return p.whole ? launch_ablation<T, KERNEL, NP, true>(p, smem, s)
                 : launch_ablation<T, KERNEL, NP, false>(p, smem, s);
}

template <typename T>
cudaError_t launch_ablation_n(int kernel, const AbParams& p, int smem, cudaStream_t s) {
  if (kernel == kAbV3)
    return p.N <= 4 ? launch_ablation_plan<T, kAbV3, 4>(p, smem, s)
                    : launch_ablation_plan<T, kAbV3, 16>(p, smem, s);
  switch (ab_np(kAbV4, p.N)) {
    case 1: return launch_ablation_plan<T, kAbV4, 1>(p, smem, s);
    case 2: return launch_ablation_plan<T, kAbV4, 2>(p, smem, s);
    case 4: return launch_ablation_plan<T, kAbV4, 4>(p, smem, s);
    case 8: return launch_ablation_plan<T, kAbV4, 8>(p, smem, s);
    default: return launch_ablation_plan<T, kAbV4, 16>(p, smem, s);
  }
}

}  // namespace xfm

using namespace xfm;

// Bytes of dynamic shared memory a block takes (kernel 0: 17, 1: 18; the
// host's plan reads it).
extern "C" int xfm_nk_ablation_smem(int kernel, int whole, int K, int L, int chunk, int N,
                                    int slab, int band, int dtype) {
  return ab_layout(kernel, whole, K, L, chunk, N, ab_np(kernel, N), slab, band,
                   dtype == kBF16 ? 2 : 4)
      .total;
}

static int ablation_scan(int kernel, const AbParams& p, int dtype, void* stream) {
  const int L = p.H * p.W;
  if (p.n_img < 1 || p.n_img > 65535 || p.H < 1 || p.W < 1 || p.D < 1 || p.K < 1 || p.K > 4 ||
      p.N < 1 || p.N > 16 || p.slab < 1 || p.chunk < 1 || p.chunk > L || p.band < 1 ||
      p.band > L || (p.whole && (p.chunk != L || p.band != L)) ||
      (dtype != kF32 && dtype != kBF16) ||
      ab_threads(kernel, p.K, p.n_pairs, p.slab, p.N) >
          (kernel == kAbV4 ? kAbV4Threads : kAbV3Threads))
    return cudaErrorInvalidValue;
  if (kernel == kAbV3 && (p.n_pairs < 1 || p.n_pairs > p.K)) return cudaErrorInvalidValue;
  const int smem =
      xfm_nk_ablation_smem(kernel, p.whole, p.K, L, p.chunk, p.N, p.slab, p.band, dtype);
  if (smem > kAbMaxSmem) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == kF32 ? launch_ablation_n<float>(kernel, p, smem, s)
                       : launch_ablation_n<__nv_bfloat16>(kernel, p, smem, s);
}

// Kernel 17.  u, dts (n_img, L, K * D), Bs and Cs (n_img, L, K * N)
// contiguous in the dtype; A (K, N, D), bias and Dk (K, D) float32; out
// (n_img, L, D) in the dtype.  whole, slab, chunk and band: the host's plan
// (whole: chunk and band are L); vec: which base pointers are 16-byte
// aligned.
// stamps, when not null, receives kAbPhases + 1 global-timer readings of
// each block (the phase clock; the grid's blocks in x, y order).
extern "C" int xfm_nk_scan_v4(const void* u, const void* dts, const void* Bs, const void* Cs,
                              const float* A, const float* bias, const float* Dk, void* out,
                              int n_img, int H, int W, int D, int K, int N, int kinds, int whole,
                              int slab, int chunk, int band, int vec, int dtype,
                              unsigned long long* stamps, void* stream) {
  const AbParams p{u, dts, Bs, Cs, A, bias, Dk, out, n_img, H, W, D, K, N, kinds,
                   0, 0, 0, whole, slab, chunk, band, vec, stamps};
  return ablation_scan(kAbV4, p, dtype, stream);
}

// Kernel 18: kernel 17's operands, and the kind pairs (n_pairs, pair_f,
// pair_r as AbParams reads them).
extern "C" int xfm_nk_scan_v3(const void* u, const void* dts, const void* Bs, const void* Cs,
                              const float* A, const float* bias, const float* Dk, void* out,
                              int n_img, int H, int W, int D, int K, int N, int kinds,
                              int n_pairs, int pair_f, int pair_r, int whole, int slab,
                              int chunk, int band, int vec, int dtype,
                              unsigned long long* stamps, void* stream) {
  const AbParams p{u, dts, Bs, Cs, A, bias, Dk, out, n_img, H, W, D, K, N, kinds,
                   n_pairs, pair_f, pair_r, whole, slab, chunk, band, vec, stamps};
  return ablation_scan(kAbV3, p, dtype, stream);
}
