// Kernels 2 and 3: the fusion scans of the inference path, redesigned for
// the H100.  Replaces
// - xfmamba_tpu/ops/vss_block_pallas_v2.py::_nk_scan_kernel_v2 (:890,
//   pallas_call :1113), the scan from precomputed deltas (ShallowFuse, K = 1
//   row_f; Cross_SS2Dv5's training forward, K = 4 cross2d), and
// - ::_nk_scan_x_kernel_v2 (:944, pallas_call :1032), the Cross_SS2Dv5
//   rank-form scan (K = 4); its out-norm LayerNorm is the row LayerNorm of
//   vss_stage.cu, launched by the same wrapper right after this kernel.
//
// For each kind k the recurrence runs flat over the L = H * W positions of
// one image in the kind's traversal order t (nk_scan.cu):
//   row_f: l = t    row_r: l = L - 1 - t    col_f: t = w * H + h    col_r: col_f reversed
//   delta = softplus(z + bias[k]),  z = dts[l, k] or sum_r rank[l, k, r] * w_dt[k, r]
//   h[n]  = exp(delta * A[k, n]) * h[n] + delta * u[l] * B[l, k, n]
//   y[l]  = u[l] * Dsum + sum_k sum_n C[l, k, n] * h[n]
//
// What bounds it on the H100: the exponentials, K L D N of them per image
// (462 M for the bs-32 Cross_SS2Dv5 call), on the special-function units
// (16 results per SM per clock: 0.11 ms at 1980 MHz), and the walk's issue
// slots (about five instructions per state and step); the operands are a
// few bytes per position and channel.  The first design (nk_scan.cu, kept
// for the serial routes) walked one thread per (image, channel) chain
// through the kinds one after another, with the rank projection (R FMAs),
// global loads and a float32 scratch of y on the chain.  This one:
// - Blocks of (image, 32-channel slab) with every kind ("whole" plan), two
//   an SM.  The block stages its map slice on chip at once, in position
//   order (u, the deltas or the ranks, B and C in their dtype, w_dt, bias,
//   Dsum): rows of 256 bytes or more (the ranks) by the bulk copy engine,
//   the others by 16-byte cp.async; the traversal tables are computed while
//   the copies fly.  B and C are then widened to float32 in each kind's
//   traversal order, and the walks read shared memory and registers only.
// - The rank form's z = ranks_k w_dt_k is a product on the tensor cores
//   (mma.sync from shared memory, operand rows padded off each other's
//   banks: bfloat16 operands for bfloat16 activations, 3xTF32 for float32,
//   float32 sums), for as many kinds at once as fit; softplus, delta and
//   delta * u for the whole slice follow before any walk.
// - Four lanes per (kind, channel) chain, lane g holding states
//   n = SPL g .. SPL g + SPL - 1, so every kind runs in parallel; each
//   sum over n takes two shuffles.  The decays exp2(delta A log2 e) come
//   from ex2.approx and do not depend on h; the next step's operands are
//   read before this step's part of y is written.
// - Each kind's part of y goes to shared memory (over the slot of its
//   delta * u, read at the same step); after the walks y = u Dsum + part 0
//   + part 1 + ... in that fixed order, as the plain version adds them.  No
//   scratch in device memory, no atomics: the same bits on every run.
// - Maps whose slice does not fit in shared memory take the "chunked" plan:
//   one kind per block (blockIdx.z), the traversal staged and walked in
//   chunks of `chunk` positions with h carried in registers, each kind's
//   part written once to a float32 slice, and a second launch that adds
//   u Dsum and the kinds' slices in the same fixed order.
// A block's time goes to latency more than to the exponentials (the
// phase clock, `stamps`): at the bs-32 Cross_SS2Dv5 call about 6 us of
// staging, 7 (bfloat16) to 12 (float32) of products and deltas, 6 of walk
// of some 24-30 us (NVIDIA H100 80GB HBM3).
#include "common.cuh"
#include "mma.cuh"

namespace xfm {

constexpr int kFsSlab = 32;            // channels per block
constexpr int kFsMaxThreads = 4 * 4 * kFsSlab;
constexpr int kFsMaxR = 64;
constexpr int kFsMaxSmem = 227 * 1024;
// rows of at least this many bytes go by bulk copy where the block may use
// them: the engine's requests cost more than four cp.async of 16 bytes
// below it (measured at 64 and 128-byte rows on the H100)
constexpr int kFsBulkMinBytes = 256;

// the card's global timer, in ns
__device__ __forceinline__ unsigned long long fs_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The bulk copy engine: one request copies a whole row into shared memory
// and completes on a shared-memory barrier (mbarrier) counting its bytes.
__device__ __forceinline__ void fs_bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void fs_bulk_copy(void* dst, const void* src, int bytes,
                                             unsigned long long* bar) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void fs_bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void fs_bar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n FS_WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra FS_WAIT_%=;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// phases of a block (the phase clock): staging (issuing the copies, the
// traversal tables meanwhile), waiting for them, widening B and C, deltas,
// walk, output (the chunked plan: its last chunk's)
constexpr int kFsPhases = 6;

struct FsParams {
  const void* u;      // (n_img, L, D) T
  const void* dts;    // (n_img, L, K * D) T, or null (rank form)
  const void* ranks;  // (n_img, L, K * R) T, or null
  const float* w_dt;  // (K, R, D)
  const void* Bs;     // (n_img, L, K * N) T
  const void* Cs;     // (n_img, L, K * N) T
  const float* A;     // (K, N, D)
  const float* bias;  // (K, D)
  const float* Dsum;  // (D,)
  void* out;          // (n_img, L, D) OT, written by the whole plan
  float* part;        // (K, n_img, L, D) the chunked plan's per-kind parts
  int n_img, H, W, D, K, N, R, kinds;
  int whole;          // 1: every kind of a slab in one block, the map in one chunk
  int chunk;          // traversal positions staged at once (L for the whole plan)
  int vec;            // rows that may go by 16-byte cp.async: bit 0 u, 1 dts, 2 ranks,
                      // 3 w_dt, bias and Dsum, 4 Bs and Cs
  int rk_kinds;       // rank form: the kinds whose ranks and w_dt are on chip at once
  unsigned long long* stamps;  // (blocks, kFsPhases + 1) global-timer readings, or null
};

// Byte offsets of the dynamic shared memory of a block with kb kinds and
// a chunk of T positions.  The staged rows are the map's positions in
// their order for the whole plan (rows of every kind's values), the
// chunk's positions in the kind's traversal order for the chunked plan:
// u, the deltas (dts form) or the ranks of rk_kinds kinds (rank form), B
// and C in their dtype (in the delta region, widened to float32 and put in
// traversal order before the deltas: 2 rows of at most 64 bytes fit its
// 128 a step), w_dt of rk_kinds kinds (in the du region, free until the
// deltas, and sized to hold it).
struct FsLayout {
  int bar, pos, inv, bias, dsum, u, z, rk, rk_pitch, w_pitch, bc_pitch, b, c, delta, du, total;
};

__host__ __device__ inline int fs_spl(int N) { return N <= 4 ? 1 : 4; }
__host__ __device__ inline int fs_align(int b) { return (b + 15) & ~15; }
// elements of a staged row of n: n rounded up to whole 16-byte pieces
__host__ __device__ inline int fs_pad(int n, int esize) {
  const int per = 16 / esize;
  return (n + per - 1) / per * per;
}
// the same, a whole number of words 4 past a multiple of 32: the rows g =
// 0..7 of an mma.sync fragment then fall on distinct banks
__host__ __device__ inline int fs_pad_banks(int n, int esize) {
  const int words = (n * esize + 3) / 4, padded = (words + 27) / 32 * 32 + 4;
  return padded * 4 / esize;
}

__host__ __device__ inline FsLayout fs_layout(bool whole, int kb, int T, int L, int N, int R,
                                              int esize, int rk_kinds) {
  const int np = 4 * fs_spl(N), rows = whole ? L : T;
  FsLayout s{};
  int off = 0;
  s.bar = off, off += 16;
  s.pos = off, off = fs_align(off + kb * T * 4);
  s.inv = off, off = fs_align(off + (whole ? kb * L * 4 : 0));
  s.bias = off, off += kb * kFsSlab * 4;
  s.dsum = off, off += kFsSlab * 4;
  s.u = off, off = fs_align(off + rows * kFsSlab * esize);
  if (R > 0) {
    // w_dt rows of 32 channels: 36 words put the bf16 fragment's rows k,
    // k + 2, .. (8 t words apart) and 40 the TF32 fragment's rows k, k + 1,
    // .. (8 t) on distinct banks beside its 8 columns
    s.rk_pitch = fs_pad_banks(rk_kinds * R, esize);
    s.w_pitch = esize == 2 ? 36 : 40;
    s.rk = off, off = fs_align(off + rows * s.rk_pitch * esize);
  } else {
    s.z = off, off = fs_align(off + rows * kb * kFsSlab * esize);
  }
  s.bc_pitch = fs_pad(kb * N, esize);
  s.b = off, off += kb * T * np * 4;
  s.c = off, off += kb * T * np * 4;
  s.delta = off, off += kb * T * kFsSlab * 4;
  s.du = off, off += max(kb * T * kFsSlab, R > 0 ? rk_kinds * R * s.w_pitch : 0) * 4;
  s.total = off;
  return s;
}

// position of traversal step t
__device__ __forceinline__ int fs_pos(int t, int code, int H, int W) {
  const int L = H * W, tt = code >= 2 ? L - 1 - t : t;
  return (code & 1) ? (tt % H) * W + tt / H : tt;
}

// rows x cols elements into dst (row stride cols, cols * sizeof(T) a
// multiple of 16), source row r at row(r); elements at or past `valid`
// are zero.  bulk, for rows of at least kFsBulkMinBytes: a bulk copy a row
// of `valid` elements (whole 16-byte pieces, the padding not written),
// completing on that barrier; else vec: 16-byte cp.async (the source rows
// 16-byte aligned); else element by element.
template <typename T, class Row>
__device__ __forceinline__ void fs_stage(T* dst, int rows, int cols, int valid, bool vec,
                                         const Row& row, unsigned long long* bulk = nullptr) {
  if (bulk && valid * static_cast<int>(sizeof(T)) >= kFsBulkMinBytes) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      fs_bulk_copy(dst + r * cols, row(r), valid * static_cast<int>(sizeof(T)), bulk);
  } else if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per = cols / E;
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int r = i / per, q = (i - r * per) * E;
      const int n = min(max(valid - q, 0), E);
      const T* src = row(r);
      cp_async16(dst + r * cols + q, n > 0 ? src + q : src, n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, q = i - r * cols;
      dst[i] = q < valid ? row(r)[q] : from_f32<T>(0.f);
    }
  }
}

template <typename T, typename OT, int SPL, bool RANK>
__global__ void __launch_bounds__(kFsMaxThreads, 2) fusion_scan_kernel(FsParams p) {
  extern __shared__ __align__(16) float fs_smem[];
  constexpr int NP = 4 * SPL;
  constexpr Prec PR = sizeof(T) == 2 ? Prec::kBF16 : Prec::kTF32x3;
  const int L = p.H * p.W, T_ = p.chunk, D = p.D;
  const int kb = p.whole ? p.K : 1;
  const int tid = threadIdx.x, nthr = blockDim.x, g = tid & 3, chain = tid >> 2;
  const int kk = chain / kFsSlab, c = chain % kFsSlab;
  // the element passes: a warp-wide row of the 32 channels at a time
  const int q0 = tid & (kFsSlab - 1), r0 = tid / kFsSlab, rstep = nthr / kFsSlab;
  const int img = blockIdx.y, c0 = blockIdx.x * kFsSlab, k = p.whole ? kk : blockIdx.z;
  // the slab's channels (valid_c: those of the map left from c0 on)
  const int valid_c = D - c0, slab_c = min(valid_c, kFsSlab), cc = min(c0 + c, D - 1);
  const int KD = p.K * D, KN = p.K * p.N, KR = p.K * p.R;
  const long long row0 = static_cast<long long>(img) * L;
  const FsLayout lay = fs_layout(p.whole, kb, T_, L, p.N, p.R, sizeof(T), p.rk_kinds);
  char* base = reinterpret_cast<char*>(fs_smem);
  auto* bar = reinterpret_cast<unsigned long long*>(base + lay.bar);
  int* pos_s = reinterpret_cast<int*>(base + lay.pos);
  int* inv_s = reinterpret_cast<int*>(base + lay.inv);
  float* bias_s = reinterpret_cast<float*>(base + lay.bias);
  float* dsum_s = reinterpret_cast<float*>(base + lay.dsum);
  T* u_s = reinterpret_cast<T*>(base + lay.u);
  T* rk_s = reinterpret_cast<T*>(base + lay.rk);
  float* b_s = reinterpret_cast<float*>(base + lay.b);
  float* c_s = reinterpret_cast<float*>(base + lay.c);
  float* delta_s = reinterpret_cast<float*>(base + lay.delta);
  float* du_s = reinterpret_cast<float*>(base + lay.du);  // w_dt, then delta u, then y's part
  T* braw = reinterpret_cast<T*>(delta_s);
  T* craw = braw + (p.whole ? L : T_) * lay.bc_pitch;
  float* w_s = du_s;
  const T* u = static_cast<const T*>(p.u);
  const T* Bs = static_cast<const T*>(p.Bs);
  const T* Cs = static_cast<const T*>(p.Cs);
  const T* dts = static_cast<const T*>(p.dts);
  const T* ranks = static_cast<const T*>(p.ranks);
  auto kind_of = [&](int kb_i) { return p.whole ? kb_i : static_cast<int>(blockIdx.z); };
  // the global row of staged row r: the position itself, or the chunk's
  auto grow = [&](int r) { return row0 + (p.whole ? r : pos_s[r]); };
  // the staged row of kind slot kb_i's step t
  auto srow = [&](int kb_i, int t) { return p.whole ? pos_s[kb_i * T_ + t] : t; };
  // the phase clock: thread 0 stamps each phase's end
  auto stamp = [&](int i) {
    if (p.stamps && tid == 0)
      p.stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                   (kFsPhases + 1) + i] = fs_clock();
  };

  float A2[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = g * SPL + j;
    A2[j] = n < p.N ? p.A[(static_cast<long long>(k) * p.N + n) * D + cc] * kLog2e : 0.f;
    h[j] = 0.f;
  }
  // The whole plan's first staging may use bulk copies (rows of at least
  // kFsBulkMinBytes) where every row staged is whole and aligned (a full
  // slab); the rank form's later passes and the chunked plan use cp.async.
  const int aligned = 1 | 8 | 16 | (RANK ? 4 : 2);
  unsigned long long* bulk =
      p.whole && slab_c == kFsSlab && (p.vec & aligned) == aligned ? bar : nullptr;
  if (bulk) {
    if (tid == 0) fs_bar_init(bar, nthr);
    __syncthreads();
  }
  // the rank form's ranks and w_dt of kinds kb0 .. kb0 + rk_kinds - 1
  const int rk_pass = min(p.rk_kinds, kb);
  auto stage_ranks = [&](int kb0, int tn, unsigned long long* by) {
    const int n = min(rk_pass, kb - kb0);
    fs_stage(rk_s, p.whole ? L : tn, lay.rk_pitch, n * p.R, p.vec & 4,
             [&](int r) { return ranks + grow(r) * KR + kind_of(kb0) * p.R; }, by);
    fs_stage(w_s, n * p.R, lay.w_pitch, slab_c, p.vec & 8, [&](int r) {
      return p.w_dt + (static_cast<long long>(kind_of(kb0)) * p.R + r) * D + c0;
    }, by);
  };

  for (int t0 = 0; t0 < L; t0 += T_) {
    const int tn = min(T_, L - t0);
    if (t0 > 0) __syncthreads();  // the last chunk's parts are written out
    stamp(0);
    // the chunked plan gathers its rows by position: the table first
    if (!p.whole) {
      for (int t = tid; t < tn; t += nthr)
        pos_s[t] = fs_pos(t0 + t, (p.kinds >> (2 * blockIdx.z)) & 3, p.H, p.W);
      __syncthreads();
    }
    const int rows = p.whole ? L : tn;
    fs_stage(u_s, rows, kFsSlab, slab_c, p.vec & 1,
             [&](int r) { return u + grow(r) * D + c0; }, bulk);
    if (!RANK) {
      T* z_s = reinterpret_cast<T*>(base + lay.z);
      fs_stage(z_s, rows * kb, kFsSlab, slab_c, p.vec & 2, [&](int r) {
        return dts + grow(r / kb) * KD + kind_of(r % kb) * D + c0;
      }, bulk);
    } else {
      stage_ranks(0, tn, bulk);
    }
    fs_stage(braw, rows, lay.bc_pitch, kb * p.N, p.vec & 16,
             [&](int r) { return Bs + grow(r) * KN + kind_of(0) * p.N; }, bulk);
    fs_stage(craw, rows, lay.bc_pitch, kb * p.N, p.vec & 16,
             [&](int r) { return Cs + grow(r) * KN + kind_of(0) * p.N; }, bulk);
    if (t0 == 0) {
      fs_stage(bias_s, kb, kFsSlab, slab_c, p.vec & 8,
               [&](int r) { return p.bias + kind_of(r) * D + c0; }, bulk);
      fs_stage(dsum_s, 1, kFsSlab, slab_c, p.vec & 8, [&](int) { return p.Dsum + c0; }, bulk);
    }
    if (bulk) fs_bar_arrive(bar);
    cp_async_commit();
    // the whole plan's traversal tables while the copies are in flight
    if (p.whole)
      for (int kb_i = 0; kb_i < kb; ++kb_i) {
        const int code = (p.kinds >> (2 * kb_i)) & 3;
        for (int t = tid; t < L; t += nthr) {
          const int l = fs_pos(t, code, p.H, p.W);
          pos_s[kb_i * T_ + t] = l;
          inv_s[kb_i * L + l] = t;
        }
      }
    stamp(1);
    if (bulk) fs_bar_wait(bar, 0);
    cp_async_wait<0>();
    __syncthreads();
    stamp(2);
    // B and C widened to float32 in traversal order
    for (int kb_i = 0; kb_i < kb; ++kb_i)
      for (int i = tid; i < tn * NP; i += nthr) {
        const int n = i & (NP - 1), t = i / NP;
        const int s = (kb_i * T_ + t) * NP + n, r = srow(kb_i, t) * lay.bc_pitch + kb_i * p.N + n;
        b_s[s] = n < p.N ? to_f32(braw[r]) : 0.f;
        c_s[s] = n < p.N ? to_f32(craw[r]) : 0.f;
      }
    __syncthreads();
    stamp(3);

    if (RANK) {
      // z = ranks_k w_dt_k on the tensor cores into the delta region, in
      // traversal order: a warp takes 16 staged rows x 16 channels of a kind
      const int warp = tid >> 5, warps = nthr >> 5, mt = (rows + 15) / 16;
      const int cols = slab_c;
      for (int kb0 = 0; kb0 < kb; kb0 += rk_pass) {
        if (kb0 > 0) {
          __syncthreads();  // the last kinds' products have read their operands
          stage_ranks(kb0, tn, nullptr);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        const int n = min(rk_pass, kb - kb0), items = n * mt * 2;
        for (int item = warp; item < items; item += warps) {
          const int j = item / (2 * mt), m0 = (item / 2 % mt) * 16, n0 = (item & 1) * 16;
          float acc[2][4] = {};
          mma_tiles<PR, 2>(
              acc, [&](int m, int r) { return to_f32(rk_s[m * lay.rk_pitch + j * p.R + r]); },
              [&](int r, int col) { return w_s[(j * p.R + r) * lay.w_pitch + col]; }, m0, n0, rows,
              cols, 0, p.R);
          const int kb_i = kb0 + j;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int m = tile_row(m0, e);
              if (m < rows) {
                const int t = p.whole ? inv_s[kb_i * L + m] : m;
                delta_s[(kb_i * T_ + t) * kFsSlab + tile_col(n0 + 8 * h2, e)] = acc[h2][e];
              }
            }
        }
      }
      __syncthreads();  // z in place, w_dt read
    }
    // delta = softplus(z + bias) and delta u, in traversal order
    {
      const T* z_s = reinterpret_cast<const T*>(base + lay.z);
      for (int kb_i = 0; kb_i < kb; ++kb_i)
        for (int t = r0; t < tn; t += rstep) {
          const int o = (kb_i * T_ + t) * kFsSlab + q0, sr = srow(kb_i, t);
          const float z = RANK ? delta_s[o] : to_f32(z_s[(sr * kb + kb_i) * kFsSlab + q0]);
          const float delta = softplus20_fast(z + bias_s[kb_i * kFsSlab + q0]);
          delta_s[o] = delta;
          du_s[o] = delta * to_f32(u_s[sr * kFsSlab + q0]);
        }
    }
    __syncthreads();
    stamp(4);

    // the walk: shared memory and registers only; the next step's operands
    // are read before this step's part of y is written over its delta u
    {
      const float* dp = delta_s + kk * T_ * kFsSlab + c;
      float* yp = du_s + kk * T_ * kFsSlab + c;
      const float* bp = b_s + kk * T_ * NP + g * SPL;
      const float* cp = c_s + kk * T_ * NP + g * SPL;
      struct Step {
        float d, x, b[SPL], c[SPL];
      };
      auto load = [&](int t) {
        Step s;
        s.d = dp[t * kFsSlab], s.x = yp[t * kFsSlab];
        if constexpr (SPL == 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(bp + t * NP);
          const float4 c4 = *reinterpret_cast<const float4*>(cp + t * NP);
          s.b[0] = b4.x, s.b[1] = b4.y, s.b[2] = b4.z, s.b[3] = b4.w;
          s.c[0] = c4.x, s.c[1] = c4.y, s.c[2] = c4.z, s.c[3] = c4.w;
        } else {
#pragma unroll
          for (int j = 0; j < SPL; ++j) s.b[j] = bp[t * NP + j], s.c[j] = cp[t * NP + j];
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
        y += __shfl_xor_sync(0xffffffffu, y, 1);
        y += __shfl_xor_sync(0xffffffffu, y, 2);
        if (g == 0) yp[t * kFsSlab] = y;
        cur = next;
      }
    }
    __syncthreads();
    stamp(5);

    if (!p.whole && q0 < valid_c) {
      float* part = p.part + (static_cast<long long>(blockIdx.z) * p.n_img * L + row0) * D + c0;
      for (int t = r0; t < tn; t += rstep)
        part[static_cast<long long>(pos_s[t]) * D + q0] = du_s[t * kFsSlab + q0];
    }
  }

  if (p.whole && q0 < valid_c) {
    OT* out = static_cast<OT*>(p.out) + row0 * D + c0 + q0;
    const float dsum = dsum_s[q0];
    for (int l = r0; l < L; l += rstep) {
      float v = to_f32(u_s[l * kFsSlab + q0]) * dsum;
      for (int kq = 0; kq < p.K; ++kq) v += du_s[(kq * T_ + inv_s[kq * L + l]) * kFsSlab + q0];
      out[static_cast<long long>(l) * D] = from_f32<OT>(v);
    }
  }
  if (p.stamps) {
    __syncthreads();
    stamp(kFsPhases);
  }
}

// the chunked plan's sum: y = u Dsum + part 0 + part 1 + ... in that order
template <typename T, typename OT>
__global__ void fusion_scan_sum_kernel(const T* u, const float* part, const float* Dsum, OT* out,
                                       long long total, int D, int K) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = to_f32(u[i]) * Dsum[i % D];
    for (int k = 0; k < K; ++k) v += part[k * total + i];
    out[i] = from_f32<OT>(v);
  }
}

// Launches the kernel, or with blocks_per_sm given writes there how many
// of its blocks an SM holds at once and launches nothing.
template <typename T, typename OT, int SPL, bool RANK>
cudaError_t launch_fusion_scan(const FsParams& p, int smem, cudaStream_t s, int* blocks_per_sm) {
  auto kernel = fusion_scan_kernel<T, OT, SPL, RANK>;
  static bool ready = false;  // the attribute is set once, outside any stream capture
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFsMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int kb = p.whole ? p.K : 1;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, 4 * kFsSlab * kb,
                                                         smem);
  const dim3 grid(ceil_div(p.D, kFsSlab), p.n_img, p.whole ? 1 : p.K);
  kernel<<<grid, 4 * kFsSlab * kb, smem, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.whole) return err;
  const long long total = static_cast<long long>(p.n_img) * p.H * p.W * p.D;
  const int blocks = ceil_div(total, 256) < 65535 * 8 ? ceil_div(total, 256) : 65535 * 8;
  auto sum = fusion_scan_sum_kernel<T, OT>;
  sum<<<blocks, 256, 0, s>>>(static_cast<const T*>(p.u), p.part, p.Dsum,
                             static_cast<OT*>(p.out), total, p.D, p.K);
  return cudaGetLastError();
}

template <typename T, typename OT, bool RANK>
cudaError_t launch_fusion_scan_n(const FsParams& p, int smem, cudaStream_t s, int* blocks) {
  return fs_spl(p.N) == 1 ? launch_fusion_scan<T, OT, 1, RANK>(p, smem, s, blocks)
                          : launch_fusion_scan<T, OT, 4, RANK>(p, smem, s, blocks);
}

}  // namespace xfm

using namespace xfm;

// Bytes of dynamic shared memory a block takes (the host's plan reads it).
extern "C" int xfm_fusion_scan_smem(int whole, int K, int chunk, int L, int N, int R,
                                    int rk_kinds, int dtype) {
  const int esize = dtype == kBF16 ? 2 : 4;
  return fs_layout(whole, whole ? K : 1, chunk, L, N, R, esize, rk_kinds).total;
}

// Kernels 2 (dts given) and 3 (ranks and w_dt given; the caller applies
// the out-norm).  u, dts or ranks, Bs and Cs contiguous in the dtype; A
// (K, N, D), bias (K, D), Dsum (D,), w_dt (K, R, D) float32.  out (n_img,
// L, D): the dtype (dts form) or float32 (rank form).  whole = 1: chunk
// must be L and part may be null; whole = 0: part is (K, n_img, L, D)
// float32 scratch.  vec: which operands' rows are 16-byte aligned.
// rk_kinds: the rank form's kinds on chip at once (the host's plan).
// blocks_per_sm, when not null, receives how many blocks of this launch an
// SM holds at once, and nothing is launched.  stamps, when not null,
// receives kFsPhases + 1 global-timer readings of each block (the phase
// clock; the grid's blocks in x, y, z order).
extern "C" int xfm_fusion_scan(const void* u, const void* dts, const void* ranks,
                               const float* w_dt, const void* Bs, const void* Cs, const float* A,
                               const float* bias, const float* Dsum, void* out, float* part,
                               int n_img, int H, int W, int D, int K, int N, int R, int kinds,
                               int whole, int chunk, int vec, int rk_kinds, int dtype,
                               int* blocks_per_sm, unsigned long long* stamps,
                               void* stream) {
  const int L = H * W;
  const bool rank = ranks != nullptr;
  if (n_img < 1 || n_img > 65535 || H < 1 || W < 1 || D < 1 || K < 1 || K > 4 || N < 1 ||
      N > 16 || (rank && (R < 1 || R > kFsMaxR || !w_dt)) || (!rank && (!dts || R != 0)) ||
      chunk < 1 || chunk > L || (whole && chunk != L) || (!whole && !part) || rk_kinds < 1 ||
      rk_kinds > (whole ? K : 1) || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const int smem = xfm_fusion_scan_smem(whole, K, chunk, L, N, R, rk_kinds, dtype);
  if (smem > kFsMaxSmem) return cudaErrorInvalidValue;
  const FsParams p{u, dts, ranks, w_dt, Bs, Cs, A, bias, Dsum, out, part, n_img, H, W, D, K, N,
                   R, kinds, whole, chunk, vec, rk_kinds, stamps};
  auto s = static_cast<cudaStream_t>(stream);
  int* b = blocks_per_sm;
  if (dtype == kF32)
    return rank ? launch_fusion_scan_n<float, float, true>(p, smem, s, b)
                : launch_fusion_scan_n<float, float, false>(p, smem, s, b);
  return rank ? launch_fusion_scan_n<__nv_bfloat16, float, true>(p, smem, s, b)
              : launch_fusion_scan_n<__nv_bfloat16, __nv_bfloat16, false>(p, smem, s, b);
}
