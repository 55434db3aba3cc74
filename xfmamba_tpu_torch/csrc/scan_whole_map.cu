// Kernels 9 and 10, redesigned for the H100: the whole-map scans of few
// images, one launch a call.  Replaces
// - xfmamba_tpu/ops/vss_block_pallas.py::_nk_scan_kernel (:690, pallas_call
//   :740 through nk_scan_call :720), the v1 nk scan (kernel 9): K traversal
//   kinds from precomputed deltas, y = u * sum_k D_k + sum_k C_k h_k with
//   the kinds added in kind order, output in u's dtype; and
// - xfmamba_tpu/ops/selective_scan_pallas.py::_scan_kernel (:73) and
//   ::_scan_kernel_n1 (:161) behind fused_cross_scan (pallas_call :277,
//   kernel 10): the cross2d core from precomputed deltas, B and C; each
//   direction's part C h + D_k u (rounded to bfloat16 for N = 1 with
//   bfloat16 input, as the Pallas kernel writes it), merged in float32 as
//   (p0 + p2) + (p1 + p3), the order of _core_pallas_fwd_impl.
//
// The recurrence of every kind k (nk_scan.cu) over the traversal step t of
// its flattening of the H x W map:
//   row_f: l = t    row_r: l = L - 1 - t    col_f: t = w * H + h    col_r: col_f reversed
//   delta = softplus(dts[l, k] + bias[k]),  h[n] = exp(delta A[k, n]) h[n] + delta u[l] B[l, k, n]
//   part_k[l] = sum_n C[l, k, n] h[n]
//
// The first design (scan_two_level.cu, kept for kernel 8's launch
// sequence) walked each chunk twice with every operand read from device
// memory, chained the chunks state by state with two barriers a state, and
// wrote each kind's part to a float32 scratch that a second launch summed.
// This one:
// - A block per (image, slab of S channels) holds every kind, and at
//   least 128 threads: where the chains are fewer, the others help with
//   the staging and the element passes.  The plan (ops/scan_whole_map.py)
//   takes S = 32, 16 or 8 so that one study's call spreads over the SMs.
// - "Whole" plan: the block stages its map slice on chip at once, in
//   position order: u and the deltas by 16-byte cp.async (element by
//   element where rows are not 16-byte aligned), B and C, whole contiguous
//   blocks of the image, by one bulk copy each; the inverse traversal
//   tables are computed while the copies fly.
// - Two element passes follow, each in the staged rows' own order, with
//   four loads in flight a thread: B and C widened to float32 into each
//   kind's traversal order (16-byte stores at N 16), then delta (softplus)
//   and delta u.  A walk then reads shared memory and registers only.
// - Lanes per chain: for N > 1 four lanes share a (kind, channel) chain,
//   lane g holding states g SPL .. g SPL + SPL - 1, every kind in
//   parallel; for N = 1 a lane a (kind, channel).  The decays are
//   ex2.approx of log2(e)-scaled A, independent of h, and each step's
//   operands are read a step ahead.  One shuffle a step: lanes 0 and 2
//   write the pair sums over the step's delta u and delta, and the output
//   adds the two.
// - Each kind's part stays in shared memory; the block then sums the kinds
//   in the plain version's fixed order and writes y once.  No part in
//   device memory, no atomics: the same bits on every run.
// - "Chunked" plan, for maps whose slice does not fit (kernel 10's 56 x 56
//   and 28 x 28 stage maps): the same block walks every kind's traversal in
//   chunks of `chunk` steps with h carried in registers, each chunk's rows
//   gathered in traversal order; the parts are kept by position for a band
//   of `band` positions, the whole map where it fits at a slab narrow
//   enough (down to one channel).  Past that (about 10,000 positions at
//   K 4 and N 16, 117 x 117 at N 1) the block walks every traversal once a
//   band, h from zero each time, keeps only the band's parts and writes
//   the band's y.  The steps and the sums are those of the whole plan: the
//   plans give the same bits, whatever the band, and no map is refused.
#include "staging.cuh"

namespace xfm {

constexpr int kWmMaxThreads = 4 * 4 * 32;  // four kinds x 32 channels x four lanes
constexpr int kWmMaxSmem = 227 * 1024;
// threads of a block at least: narrow slabs leave few chains for the
// staging, the widening, the deltas and the output
constexpr int kWmMinThreads = 128;
// phases of a block (the phase clock): issuing the copies (the tables
// meanwhile), waiting for them, widening B and C, deltas, walk, output
// (the chunked plan: its last chunk's, the output with it)
constexpr int kWmPhases = 6;

struct WmParams {
  const void* u;     // (n_img, L, D) T
  const void* dts;   // (n_img, L, K, D) T
  const void* Bs;    // (n_img, L, K, N) T
  const void* Cs;    // (n_img, L, K, N) T
  const float* A;    // (K, N, D), or (K, D, N) for cross
  const float* bias; // (K, D)
  const float* Dk;   // (K, D): summed in kind order into u's skip (cross 0), or each
                     // part's own (cross 1)
  void* out;         // (n_img, L, D) OT
  int n_img, H, W, D, K, N, kinds;
  int cross;         // 0: y = u sum_k D_k + part 0 + ... + part K-1;
                     // 1: part_k = C h + D_k u, y = (part 0 + part 2) + (part 1 + part 3)
  int round_part;    // cross: each part rounded to bfloat16
  int whole;         // 1: the map staged at once; 0: chunks, parts by position
  int slab;          // channels a block
  int chunk;         // traversal steps staged at once (L for the whole plan)
  int band;          // positions whose parts the chunked plan keeps at once (L whole)
  int vec;           // 16-byte aligned base pointers: bit 0 u, 1 dts, 2 Bs and Cs, 3 bias and Dk
  unsigned long long* stamps;  // (blocks, kWmPhases + 1) global-timer readings, or null
};

// states a chain's lanes hold together: 1 lane for N = 1, else 4 lanes of
// 1 (N <= 4) or 4 (N <= 16) states
__host__ __device__ inline int wm_lanes(int N) { return N == 1 ? 1 : 4; }
__host__ __device__ inline int wm_spl(int N) { return N <= 4 ? 1 : 4; }

// Byte offsets of a block's dynamic shared memory.  The staged rows (u,
// the deltas, B and C in their dtype) are the map's positions (whole plan)
// or the chunk's steps of each kind in traversal order (chunked plan).  B
// and C widened to float32, delta and delta u are in traversal order; raw
// B and C share their region with delta and delta u, written after the
// widening.  Each step's part of y takes the place of its delta u (and,
// with four lanes, its delta); the whole plan finds a position's step in
// the inverse table, the chunked plan keeps the parts of a band of
// positions by position.
struct WmLayout {
  int bar, pos, inv, bias, dk, u, z, b, c, pitch, bw, cw, delta, du, part, total;
};

__host__ __device__ inline WmLayout wm_layout(bool whole, int K, int L, int T, int N, int S,
                                              int band, int esize) {
  const int rows = whole ? L : K * T, np = wm_lanes(N) * wm_spl(N);
  WmLayout s{};
  int off = 0;
  s.bar = off, off += 16;
  s.pos = off, off = stage_align(off + (whole ? 0 : K * T * 4));
  s.inv = off, off = stage_align(off + (whole ? K * L * 4 : 0));
  s.bias = off, off = stage_align(off + K * S * 4);
  s.dk = off, off = stage_align(off + K * S * 4);
  s.u = off, off = stage_align(off + rows * S * esize);
  s.z = off, off = stage_align(off + (whole ? L * K : K * T) * S * esize);
  s.bw = off, off += K * T * np * 4;
  s.cw = off, off += K * T * np * 4;
  s.pitch = stage_pad(whole ? K * N : N, esize);
  s.b = s.delta = off;
  s.c = s.b + rows * s.pitch * esize;
  s.du = s.delta + K * T * S * 4;
  off += max(2 * rows * s.pitch * esize, 2 * K * T * S * 4);
  s.part = off, off += whole ? 0 : K * band * S * 4;
  s.total = off;
  return s;
}

// WHOLE: the plan (a template argument, so that the whole plan's walk
// holds none of the chunked plan's band)
template <typename T, typename OT, int LANES, int SPL, bool WHOLE>
__global__ void __launch_bounds__(kWmMaxThreads, 2) whole_map_scan_kernel(WmParams p) {
  extern __shared__ __align__(16) float wm_smem[];
  constexpr int ES = sizeof(T), NP = LANES * SPL;
  const int L = p.H * p.W, T_ = p.chunk, D = p.D, K = p.K, N = p.N, S = p.slab;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // a lane of chain (kind kk, channel c); a block may hold more threads
  // than chains, for its element passes: those walk a copy of the last
  // chain and write nothing
  const int g = tid % LANES, chain = tid / LANES, kk = min(chain / S, K - 1), c = chain % S;
  const bool walker = chain < K * S;
  // the element passes: a row of the slab's S channels at a time
  const int q0 = tid % S, r0 = tid / S, rstep = nthr / S;
  const int img = blockIdx.y, c0 = blockIdx.x * S;
  const int valid_c = D - c0, slab_c = min(valid_c, S), cc = min(c0 + c, D - 1);
  const long long row0 = static_cast<long long>(img) * L;
  const WmLayout lay = wm_layout(WHOLE, K, L, T_, N, S, p.band, ES);
  char* base = reinterpret_cast<char*>(wm_smem);
  auto* bar = reinterpret_cast<unsigned long long*>(base + lay.bar);
  int* pos_s = reinterpret_cast<int*>(base + lay.pos);
  int* inv_s = reinterpret_cast<int*>(base + lay.inv);
  float* bias_s = reinterpret_cast<float*>(base + lay.bias);
  float* dk_s = reinterpret_cast<float*>(base + lay.dk);
  T* u_s = reinterpret_cast<T*>(base + lay.u);
  T* z_s = reinterpret_cast<T*>(base + lay.z);
  T* braw = reinterpret_cast<T*>(base + lay.b);
  T* craw = reinterpret_cast<T*>(base + lay.c);
  float* bw_s = reinterpret_cast<float*>(base + lay.bw);
  float* cw_s = reinterpret_cast<float*>(base + lay.cw);
  float* delta_s = reinterpret_cast<float*>(base + lay.delta);  // delta, then lanes 2-3's part
  float* du_s = reinterpret_cast<float*>(base + lay.du);  // delta u, then lanes 0-1's part
  float* part_s = reinterpret_cast<float*>(base + lay.part);
  const T* u = static_cast<const T*>(p.u);
  const T* dts = static_cast<const T*>(p.dts);
  const T* Bs = static_cast<const T*>(p.Bs);
  const T* Cs = static_cast<const T*>(p.Cs);
  // the phase clock: thread 0 stamps each phase's end
  auto stamp = [&](int i) {
    if (p.stamps && tid == 0)
      p.stamps[(blockIdx.y * gridDim.x + blockIdx.x) * (kWmPhases + 1) + i] = stage_clock();
  };
  stamp(0);

  float A2[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = g * SPL + j;
    const long long a = p.cross ? (static_cast<long long>(kk) * D + cc) * N + n
                                : (static_cast<long long>(kk) * N + n) * D + cc;
    A2[j] = n < N ? p.A[a] * kLog2e : 0.f;
    h[j] = 0.f;
  }
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
  // [b0, b0 + bn), keeping only the band's parts: the same steps and the
  // same additions for each position, whatever the band
  const int band = WHOLE ? L : p.band;
  for (int b0 = 0; b0 < L; b0 += band) {
    const int bn = min(band, L - b0);
    if (!WHOLE && b0 > 0)
#pragma unroll
      for (int j = 0; j < SPL; ++j) h[j] = 0.f;
    for (int t0 = 0; t0 < L; t0 += T_) {
      const int tn = min(T_, L - t0);
      if (!WHOLE) {
        // the chunk's positions first: its rows are gathered by them (steps
        // past the map's end point at position 0, staged and never walked)
        if (t0 > 0 || b0 > 0) __syncthreads();  // the last chunk's parts are put away
        for (int i = tid; i < K * T_; i += nthr) {
          const int kb = i / T_, t = i % T_;
          pos_s[i] = t < tn ? traversal_pos(t0 + t, (p.kinds >> (2 * kb)) & 3, p.H, p.W) : 0;
        }
        __syncthreads();
        const int rows = K * T_;
        stage_rows(u_s, rows, S, slab_c, vec_u,
                   [&](int r) { return u + (row0 + pos_s[r]) * D + c0; });
        stage_rows(z_s, rows, S, slab_c, vec_z, [&](int r) {
          return dts + ((row0 + pos_s[r]) * K + r / T_) * D + c0;
        });
        stage_rows(braw, rows, lay.pitch, N, vec_bc,
                 [&](int r) { return Bs + (row0 + pos_s[r]) * K * N + (r / T_) * N; });
        stage_rows(craw, rows, lay.pitch, N, vec_bc,
                 [&](int r) { return Cs + (row0 + pos_s[r]) * K * N + (r / T_) * N; });
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
      if (t0 == 0 && b0 == 0) {  // the per-channel vectors, zero past the map's channels
        stage_rows(bias_s, K, S, slab_c, vec_v, [&](int r) { return p.bias + r * D + c0; });
        stage_rows(dk_s, K, S, slab_c, vec_v, [&](int r) { return p.Dk + r * D + c0; });
      }
      if (bulk) stage_bar_arrive(bar);
      cp_async_commit();
      if (WHOLE)  // the inverse tables while the copies are in flight
        for (int i = tid; i < K * L; i += nthr) {
          const int kb = i / L, t = i % L;
          inv_s[kb * L + traversal_pos(t, (p.kinds >> (2 * kb)) & 3, p.H, p.W)] = t;
        }
      stamp(1);
      if (bulk) stage_bar_wait(bar, 0);
      cp_async_wait<0>();
      __syncthreads();
      stamp(2);
      // B and C widened to float32 in each kind's traversal order, then
      // delta and delta u.  Both passes walk the staged rows in their own
      // order (a position, or the chunk's step) and put each value at its
      // step (the whole plan's inverse table): no load waits for another.
      // They take four elements a thread at a time, all loads before any
      // store: the compiler cannot tell the staged rows from the arrays
      // written, and would wait for each store before the next load.
      auto step_of = [&](int kb, int r) { return WHOLE ? inv_s[kb * L + r] : r; };
      if (SPL == 4 && N == 16) {
        // four states at a time: 8- or 16-byte loads, 16-byte stores
        for (int kb = 0; kb < K; ++kb)
          for (int i0 = tid; i0 < tn * 4; i0 += 4 * nthr) {
            float bv[4][4], cv[4][4];
            int d[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = min(i0 + e * nthr, tn * 4 - 1), r = i / 4, n = i % 4 * 4;
              const int o = WHOLE ? r * lay.pitch + kb * N + n : (kb * T_ + r) * lay.pitch + n;
              stage_load4(braw + o, bv[e]);
              stage_load4(craw + o, cv[e]);
              d[e] = (kb * T_ + step_of(kb, r)) * NP + n;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (i0 + e * nthr < tn * 4) {
                *reinterpret_cast<float4*>(bw_s + d[e]) =
                    make_float4(bv[e][0], bv[e][1], bv[e][2], bv[e][3]);
                *reinterpret_cast<float4*>(cw_s + d[e]) =
                    make_float4(cv[e][0], cv[e][1], cv[e][2], cv[e][3]);
              }
          }
      } else {
        for (int kb = 0; kb < K; ++kb)
          for (int i0 = tid; i0 < tn * NP; i0 += 4 * nthr) {
            float bv[4], cv[4];
            int d[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = min(i0 + e * nthr, tn * NP - 1), r = i / NP, n = i % NP;
              const int o = WHOLE ? r * lay.pitch + kb * N + n : (kb * T_ + r) * lay.pitch + n;
              bv[e] = n < N ? to_f32(braw[o]) : 0.f;
              cv[e] = n < N ? to_f32(craw[o]) : 0.f;
              d[e] = (kb * T_ + step_of(kb, r)) * NP + n;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (i0 + e * nthr < tn * NP) bw_s[d[e]] = bv[e], cw_s[d[e]] = cv[e];
          }
      }
      __syncthreads();  // raw B and C read: delta and delta u take their place
      stamp(3);
      for (int kb = 0; kb < K; ++kb) {
        const float bias_q = bias_s[kb * S + q0];
        for (int r1 = r0; r1 < tn; r1 += 4 * rstep) {
          float zv[4], uv[4];
          int o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = min(r1 + e * rstep, tn - 1);
            zv[e] = to_f32(z_s[(WHOLE ? r * K + kb : kb * T_ + r) * S + q0]);
            uv[e] = to_f32(u_s[(WHOLE ? r : kb * T_ + r) * S + q0]);
            o[e] = (kb * T_ + step_of(kb, r)) * S + q0;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (r1 + e * rstep < tn) {
              const float delta = softplus20_fast(zv[e] + bias_q);
              delta_s[o[e]] = delta;
              du_s[o[e]] = delta * uv[e];
            }
        }
      }
      __syncthreads();
      stamp(4);

      // the walk, from shared memory and registers only; each step's
      // operands are read a step ahead, and its part is written after the
      // next step's operands are read: with four lanes, the sum of lanes 0
      // and 1 over the step's delta u and that of lanes 2 and 3 over its
      // delta (one shuffle a step; the output pass adds the two)
      {
        const float* dp = delta_s + kk * T_ * S + c;
        float* yp = du_s + kk * T_ * S + c;
        float* yq = delta_s + kk * T_ * S + c;
        const float* bp = bw_s + kk * T_ * NP + g * SPL;
        const float* cp = cw_s + kk * T_ * NP + g * SPL;
        struct Step {
          float d, x, b[SPL], c[SPL];
        };
        auto load = [&](int t) {
          Step s;
          s.d = dp[t * S], s.x = yp[t * S];
          if constexpr (SPL == 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(bp + t * NP);
            const float4 c4 = *reinterpret_cast<const float4*>(cp + t * NP);
            s.b[0] = b4.x, s.b[1] = b4.y, s.b[2] = b4.z, s.b[3] = b4.w;
            s.c[0] = c4.x, s.c[1] = c4.y, s.c[2] = c4.z, s.c[3] = c4.w;
          } else {
            s.b[0] = bp[t * NP], s.c[0] = cp[t * NP];
          }
          return s;
        };
        Step cur = load(0);
  #pragma unroll 4
        for (int t = 0; t < tn; ++t) {
          const Step next = load(t + 1 < tn ? t + 1 : t);
          float y = 0.f;
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            h[j] = fmaf(fast_exp2(cur.d * A2[j]), h[j], cur.x * cur.b[j]);
            y = fmaf(cur.c[j], h[j], y);
          }
          if constexpr (LANES == 4) {
            y += __shfl_xor_sync(0xffffffffu, y, 1);
            if (walker && g == 0) yp[t * S] = y;
            if (walker && g == 2) yq[t * S] = y;
          } else if (walker) {
            yp[t * S] = y;
          }
          cur = next;
        }
      }
      __syncthreads();
      stamp(5);
      // a step's part: one slot, or with four lanes the two, lanes 0-1 first
      auto part_at = [&](int kb, int t) {
        const int o = (kb * T_ + t) * S + q0;
        return LANES == 4 ? du_s[o] + delta_s[o] : du_s[o];
      };
      // the chunked plan keeps each kind's part by position for the band
      if (!WHOLE)
        for (int kb = 0; kb < K; ++kb)
          for (int t1 = r0; t1 < tn; t1 += 4 * rstep) {
            float v[4];
            int l[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = min(t1 + e * rstep, tn - 1);
              v[e] = part_at(kb, t);
              l[e] = pos_s[kb * T_ + t];
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (t1 + e * rstep < tn && l[e] >= b0 && l[e] < b0 + bn)
                part_s[(kb * band + l[e] - b0) * S + q0] = v[e];
          }
      if (WHOLE || t0 + T_ >= L) {
        if (!WHOLE) __syncthreads();
        // y in the plain version's fixed order, written once (the band's positions)
        if (q0 < valid_c) {
          OT* out = static_cast<OT*>(p.out) + row0 * D + c0 + q0;
          float dsum = 0.f;
          for (int k = 0; k < K; ++k) dsum += dk_s[k * S + q0];
          for (int l1 = b0 + r0; l1 < b0 + bn; l1 += 4 * rstep) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int l = min(l1 + e * rstep, b0 + bn - 1);
              const float uu =
                  WHOLE ? to_f32(u_s[l * S + q0]) : to_f32(u[(row0 + l) * D + c0 + q0]);
              auto part = [&](int k) {
                const float y =
                    WHOLE ? part_at(k, inv_s[k * L + l]) : part_s[(k * band + l - b0) * S + q0];
                if (!p.cross) return y;
                const float w = fmaf(uu, dk_s[k * S + q0], y);
                return p.round_part ? __bfloat162float(__float2bfloat16(w)) : w;
              };
              if (p.cross) {
                v[e] = (part(0) + part(2)) + (part(1) + part(3));
              } else {
                v[e] = uu * dsum;
                for (int k = 0; k < K; ++k) v[e] += part(k);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (l1 + e * rstep < b0 + bn)
                out[static_cast<long long>(l1 + e * rstep) * D] = from_f32<OT>(v[e]);
          }
        }
      }
    }
  }
  if (p.stamps) {
    __syncthreads();
    stamp(kWmPhases);
  }
}

template <typename T, typename OT, int LANES, int SPL, bool WHOLE>
cudaError_t launch_whole_map(const WmParams& p, int smem, cudaStream_t s) {
  auto kernel = whole_map_scan_kernel<T, OT, LANES, SPL, WHOLE>;
  static bool ready = false;  // the attribute is set once, outside any stream capture
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWmMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(ceil_div(p.D, p.slab), p.n_img);
  const int chains = p.K * p.slab * LANES;
  kernel<<<grid, max(chains, kWmMinThreads), smem, s>>>(p);
  return cudaGetLastError();
}

// the plan is a template argument: the whole plan's walk holds none of the
// chunked plan's band
template <typename T, typename OT, int LANES, int SPL>
cudaError_t launch_whole_map_plan(const WmParams& p, int smem, cudaStream_t s) {
  return p.whole ? launch_whole_map<T, OT, LANES, SPL, true>(p, smem, s)
                 : launch_whole_map<T, OT, LANES, SPL, false>(p, smem, s);
}

template <typename T, typename OT>
cudaError_t launch_whole_map_n(const WmParams& p, int smem, cudaStream_t s) {
  if (p.N == 1) return launch_whole_map_plan<T, OT, 1, 1>(p, smem, s);
  if (p.N <= 4) return launch_whole_map_plan<T, OT, 4, 1>(p, smem, s);
  return launch_whole_map_plan<T, OT, 4, 4>(p, smem, s);
}

}  // namespace xfm

using namespace xfm;

// Bytes of dynamic shared memory a block takes (the host's plan reads it).
extern "C" int xfm_whole_map_smem(int whole, int K, int L, int chunk, int N, int slab, int band,
                                  int dtype) {
  return wm_layout(whole, K, L, chunk, N, slab, band, dtype == kBF16 ? 2 : 4).total;
}

// Kernels 9 (cross 0: Dk is Dvec, out in the dtype) and 10 (cross 1, K 4:
// out float32).  u, dts, Bs and Cs contiguous in the dtype; A float32
// (K, N, D), or (K, D, N) for cross; bias and Dk (K, D) float32.  whole,
// slab, chunk and band: the host's plan (whole: chunk and band are L); vec:
// which base pointers are 16-byte aligned.  stamps, when not null, receives
// kWmPhases + 1 global-timer readings of each block (the phase clock; the
// grid's blocks in x, y order).
extern "C" int xfm_whole_map_scan(const void* u, const void* dts, const void* Bs, const void* Cs,
                                  const float* A, const float* bias, const float* Dk, void* out,
                                  int n_img, int H, int W, int D, int K, int N, int kinds,
                                  int cross, int round_part, int whole, int slab,
                                  int chunk, int band, int vec, int dtype, int out_dtype,
                                  unsigned long long* stamps, void* stream) {
  const int L = H * W;
  if (n_img < 1 || n_img > 65535 || H < 1 || W < 1 || D < 1 || K < 1 || K > 4 || N < 1 ||
      N > 16 || (cross && K != 4) || slab < 1 || slab > 32 || chunk < 1 || chunk > L ||
      band < 1 || band > L || (whole && (chunk != L || band != L)) ||
      K * slab * wm_lanes(N) > kWmMaxThreads)
    return cudaErrorInvalidValue;
  const int smem = xfm_whole_map_smem(whole, K, L, chunk, N, slab, band, dtype);
  if (smem > kWmMaxSmem) return cudaErrorInvalidValue;
  const WmParams p{u,  dts,   Bs,         Cs,    A,    bias,  Dk,   out, n_img, H,     W,  D,
                   K,  N,     kinds,      cross, round_part, whole, slab, chunk, band, vec, stamps};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && out_dtype == kF32) return launch_whole_map_n<float, float>(p, smem, s);
  if (dtype == kBF16 && out_dtype == kBF16)
    return launch_whole_map_n<__nv_bfloat16, __nv_bfloat16>(p, smem, s);
  if (dtype == kBF16 && out_dtype == kF32)
    return launch_whole_map_n<__nv_bfloat16, float>(p, smem, s);
  return cudaErrorInvalidValue;
}
