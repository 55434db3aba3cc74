// The d_state-1 cross2d scan with the rank->D delta projection in the
// kernel, and its adjoint: a tile-parallel two-level scan over 2-D tiles of
// the map, the rank products on the tensor cores.  One set of kernels
// serves two operand layouts:
// - kernels 11 and 12, replacing xfmamba_tpu/ops/selective_scan_pallas.py::
//   _scan_kernel_n1p (:298, pallas_call :414) and ::_scan_kernel_n1p_bwd
//   (:440, pallas_call :618): projections (B, L, 4, R + 2), [rank | B | C]
//   of each direction;
// - the cross2d scans of the bfloat16 backbone's VSSBlock sequence, in the
//   stage kernel (kernel 1, xfmamba_tpu/ops/vss_block_pallas_v2.py::
//   _vss_stage_kernel_v2, :542), its training forms (kernels 4 and 5, :412
//   and :658) and its adjoint (kernel 6, xfmamba_tpu/ops/
//   vss_block_v2_adjoint.py::_vss_block_bwd_kernel, :128): projection rows
//   [rank_0 .. rank_3 | B0 C0 .. B3 C3], the x_proj output of the block.
// The layout is four numbers (row stride, rank step per direction, offset
// and step of B; C follows B), so both read their rows as they are.
//
// For the four directions k of each (image, channel) chain (0 row_f,
// 1 col_f, 2 row_r, 3 col_r; the column ones walk t = w * H + h, the
// reverse ones from the last t to the first):
//   delta = softplus20(sum_r rank[l, k, r] * w_dt[k, r, c] + bias[k, c])
//   a = exp(delta * A[k, c]),  h = a * h + delta * u[l, c] * B[l, k]
//   y_k[l, c] = C[l, k] * h + Dk[k, c] * u[l, c]
//   y = (y_0 + y_2) + (y_1 + y_3)   (float32, the order of the JAX merge)
// The stage passes Dk = (Dsum, 0, 0, 0), so its skip term rides on y_0.
//
// Design.  The map is cut into tiles of at most 8 x 8 positions (TH x TW,
// chosen by the host so that the tiles split H and W evenly where they
// can), and D into slabs of 32 channels.  A direction's flattening visits a
// tile as TH row segments (rows) or TW column segments (columns), and every
// chain is a sequence of such segments in flattening order: row h's
// segments in tile-column order, then row h + 1's.  A block of 256 threads
// owns one slab and walks a fixed, strided list of (image, tile) items;
// warp j walks segment j of the tile, each lane one channel.
// Forward, three launches:
//   1. pairs: for each item and direction pair (rows, then columns), the
//      delta pre-activations z of the tile come from one tensor-core
//      product (the tile's ranks, 64 x R, times w_dt[k], R x 32; mma.sync
//      in 3xTF32 for both dtypes: bfloat16 ranks are exact in TF32 and
//      w_dt stays float32, as the plain twin has it; both operands read
//      through L1).  u (and g) and B, C are staged in shared memory by
//      coalesced loads first; delta, a and delta u B of every (row,
//      channel) are computed there in parallel, and each segment's walk
//      reads only shared memory down to its pair (product of a, h from
//      zero);
//   2. carries: one thread per (image, direction, channel) scans the pairs
//      in flattening order, loads issued 16 segments ahead: the state
//      entering every segment;
//   3. apply: z again, each segment walked from its state, y_0 + y_2 kept
//      in shared memory by the row walks and added to y_1 + y_3 by the
//      column walks, y written once; the walks write the checkpoints ck
//      (the state entering each data chunk of `chunk` positions) as they
//      pass the chunk edges.
// Where a map has at most kMaxCluster tiles (the 14 x 14 and 7 x 7 stages)
// the forward is one launch instead (ss2d_n1t_fused_kernel): a thread-block
// cluster is one image's tiles, a block a tile; delta, a and b are computed
// once and stay in shared memory, the pairs go to the block's shared
// memory, and each block scans the pairs of its chains across the cluster
// (distributed shared memory) for the states entering its own segments
// before its apply walks.  The three launches recompute z, delta, a and b
// in the apply pass, which at these maps cost more than the first design's
// whole forward; one launch takes the same steps in the same order, so the
// two routes agree bit for bit.
// Backward, four launches:
//   1. pairs: the forward pairs and the adjoint's value from zero against
//      each direction's order (lambda = C dy + a' lambda', only a, C and g);
//   2. carries: both scans, the adjoint's against the order;
//   3. apply: z again; each segment walked forward for h, then backward for
//      lambda: du merged as y is and written once; dpre = d delta *
//      sigmoid(z) replaces z in shared memory and goes straight into the
//      tensor-core products d rank_k = dpre_k w_dt[k]^T (per slab) and
//      dw_dt[k] += rank_k^T dpre_k (per block, in registers across its
//      items); dB and dC are summed over the slab's channels by a warp
//      reduce-scatter; dbias, dA, dD per thread, then over the warps;
//   4. sums: the slabs' d rank / dB / dC and the blocks' dw_dt / dbias /
//      dA / dD partials added in a fixed order (no atomics: two runs give
//      the same bits).
// In bfloat16 the two gradient products take bfloat16 operands (dpre and
// w_dt rounded where the JAX stage rounds dz and w_dt), float32 sums.
//
// What bounds it on the H100: the bytes (x, the projections and y once;
// the backward x, g, the projections, du and the projections' gradient
// once) at 3.35 TB/s: 0.691 ms per float32 bs-32 XFMamba-S forward
// (kernel 11), 0.534 ms per bs-16 step (kernel 12); the products are thin
// (R = 6-64) and the elementwise work (a softplus and an exp per
// position and direction) is below that at 67 TFLOP/s.  The three-launch
// forward reads x and the projections twice and writes pairs of 2 floats
// per (image, direction, segment, channel), as many floats as x at 8 x 8
// tiles; the one-launch forward reads them once and writes no pairs.
// The backward reads x, g and the projections twice, and its d rank, dB
// and dC leave each 32-channel slab as float32 partial rows, (n_slabs, B,
// L, 4, R + 2), that the sums launch reads back: per position n_slabs x 4
// x (R + 2) floats, from 1x x's floats at XFMamba-S's stage 0 (6 slabs,
// R 6) to 3.25x at stage 2 (24, 24) and 6.25x at stage 3 (48, 48); 8.25x
// at XFMamba-B's stage 3 (64, 64), where dpre was 4 D floats (2x x).
// Summing them over the slabs of a thread-block cluster in distributed
// shared memory, two cluster barriers per tile and direction pair, was
// slower per step on the card and was not kept.  Each segment's walk is at
// most 8 dependent steps, and the grid fills the card at every stage (the
// host picks the blocks per slab).  Measured: PERF.md §6 (NVIDIA H100
// 80GB HBM3, 700 W): latency and issue bound, at 8-24 warps an SM with
// about ten barriers per tile.
#include "common.cuh"
#include "mma.cuh"

#include <cooperative_groups.h>

#include <algorithm>

namespace xfm {

namespace cg = cooperative_groups;

constexpr int kTS = 8;             // largest tile side
constexpr int kTP = kTS * kTS;     // mma rows of a tile: p = i * 8 + j
constexpr int kCS = 32;            // channels of a slab: one a lane
constexpr int kCH = kCS / 32;      // channels of a thread
constexpr int kThreads = 256;      // 8 warps: warp j walks segment j
constexpr int kZS = kCS + 4;       // padded row stride (floats) of staged tiles
constexpr int kMaxR = 64;

struct N1TParams {
  const void* x;       // (B, L, D), NHWC
  const void* xdbl;    // (B, L, row): the projections of each position
  const float* w_dt;   // (4, R, D)
  const float* A;      // (4, D) = -exp(A_logs)
  const float* Dk;     // (4, D)
  const float* bias;   // (4, D)
  const float* g;      // (B, L, D) gradient of y
  float2* pair;        // (B, 4, NS, D): (prod a, h from 0); carries put the entering h in .y
  float* gpair;        // (B, 4, NS, D): the adjoint from 0, then the entering adjoint
  float* ck;           // (B, 4, n_chunks, D): state entering each data chunk, or null
  float* y;            // (B, L, D) forward output
  float* du;           // (B, L, D)
  float* part_x;       // (n_slabs, B, L, 4, R + 2): d rank, dB, dC per slab
  float* part_w;       // (P, 4, R, D): dw_dt per block
  float* part_s;       // (P, 3, 4, D): dbias, dA, dD per block
  float* dxdbl;        // (B, L, row) float32: d rank, dB, dC added
  float* dw_dt;        // (4, R, D)
  float* dbias;        // (4, D)
  float* dA;           // (4, D)
  float* dD;           // (4, D)
  int B, H, W, D, R, chunk, n_chunks;
  int row, rank_k, bc_off, bc_k;  // rank of k at k * rank_k, B at bc_off + k * bc_k, C after B
  int TH, TW, nth, ntw, NS, P, n_slabs;
};

enum Mode : int { kFwdPairs = 0, kFwdApply = 1, kBwdPairs = 2, kBwdApply = 3 };

// One (image, tile) item of a block.
struct N1Tile {
  int b, ti, tj, h0, w0, th, tw;
  long long base;  // b * L
};

__device__ __forceinline__ N1Tile n1t_tile(const N1TParams& p, int item) {
  N1Tile t;
  const int per_image = p.nth * p.ntw;
  t.b = item / per_image;
  const int rem = item - t.b * per_image;
  t.ti = rem / p.ntw;
  t.tj = rem - t.ti * p.ntw;
  t.h0 = t.ti * p.TH;
  t.w0 = t.tj * p.TW;
  t.th = min(p.TH, p.H - t.h0);
  t.tw = min(p.TW, p.W - t.w0);
  t.base = static_cast<long long>(t.b) * p.H * p.W;
  return t;
}

__device__ __forceinline__ bool n1t_valid(const N1Tile& t, int q) {
  return (q >> 3) < t.th && (q & 7) < t.tw;
}

// row-major position of tile row q
__device__ __forceinline__ int n1t_l(const N1TParams& p, const N1Tile& t, int q) {
  return (t.h0 + (q >> 3)) * p.W + t.w0 + (q & 7);
}

// Segment j of direction k in tile t: its length, its index in the chain's
// segment list, and the tile row and flattening index of its step m (data
// order, m = 0 first).
struct N1Seg {
  int len, s, q0, dq, t0, dt;
  bool valid;
};

__device__ __forceinline__ N1Seg n1t_seg(const N1TParams& p, const N1Tile& t, int k, int j) {
  N1Seg g;
  if ((k & 1) == 0) {  // row h0 + j, columns w0 ..
    g.valid = j < t.th;
    g.len = t.tw;
    g.s = (t.h0 + j) * p.ntw + t.tj;
    g.q0 = j * kTS;
    g.dq = 1;
    g.t0 = (t.h0 + j) * p.W + t.w0;
  } else {             // column w0 + j, rows h0 ..
    g.valid = j < t.tw;
    g.len = t.th;
    g.s = (t.w0 + j) * p.nth + t.ti;
    g.q0 = j;
    g.dq = kTS;
    g.t0 = (t.w0 + j) * p.H + t.h0;
  }
  g.dt = 1;
  return g;
}

template <typename T>
__device__ __forceinline__ float n1t_proj(const N1TParams& p, const T* xdbl, long long l, int col) {
  return to_f32(xdbl[l * p.row + col]);
}

__device__ __forceinline__ long long n1t_chain(const N1TParams& p, int b, int k) {
  return (static_cast<long long>(b) * 4 + k) * p.NS;
}

// w_dt[k][r][c0 + c], zero past D (read through L1: every item of a block
// takes the same slab)
__device__ __forceinline__ float n1t_wdt(const N1TParams& p, int k, int r, int c0, int c) {
  return c0 + c < p.D ? p.w_dt[(static_cast<long long>(k) * p.R + r) * p.D + c0 + c] : 0.f;
}

// The rank r of direction k at tile row q, zero outside the map.
template <typename T>
__device__ __forceinline__ float n1t_rank(const N1TParams& p, const N1Tile& t, int k, int q,
                                          int r) {
  return n1t_valid(t, q) ? n1t_proj(p, static_cast<const T*>(p.xdbl),
                                    t.base + n1t_l(p, t, q), k * p.rank_k + r)
                         : 0.f;
}

// z of the direction pair (k0, k0 + 2) of tile t (before bias), into
// z_s[d][q][c]: warp w takes direction d = w / 4, rows 16 (w % 4) ..
template <typename T, Prec PR>
__device__ __forceinline__ void n1t_stage_z(const N1TParams& p, const N1Tile& t, int k0, int c0,
                                            float* z_s) {
  const int w = threadIdx.x >> 5;
  const int d = w >> 2, k = k0 + 2 * d, m0 = (w & 3) * 16;
  float acc[kCS / 8][4] = {};
  auto a = [&](int q, int r) { return n1t_rank<T>(p, t, k, q, r); };
  auto b = [&](int r, int c) { return n1t_wdt(p, k, r, c0, c); };
  mma_tiles<PR, kCS / 8>(acc, a, b, m0, 0, kTP, kCS, 0, p.R);
  float* zd = z_s + d * kTP * kZS;
#pragma unroll
  for (int jt = 0; jt < kCS / 8; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) zd[tile_row(m0, e) * kZS + tile_col(8 * jt, e)] = acc[jt][e];
}

// The tile's inputs in shared memory, coalesced: u (and g, backward) as
// [q][c] over the slab, zero outside the map and past D; B and C of the
// four directions at each position, bc_s[q][2 k + {0, 1}].
template <typename T>
__device__ __forceinline__ void n1t_stage_inputs(const N1TParams& p, const N1Tile& t, int c0,
                                                 float* u_s, float* g_s, float* bc_s) {
  const T* x = static_cast<const T*>(p.x);
  const T* xdbl = static_cast<const T*>(p.xdbl);
#pragma unroll
  for (int i = threadIdx.x; i < kTP * kCS; i += kThreads) {
    const int q = i / kCS, c = i % kCS;
    const bool in = n1t_valid(t, q) && c0 + c < p.D;
    const long long o = (t.base + n1t_l(p, t, q)) * p.D + c0 + c;
    u_s[q * kZS + c] = in ? to_f32(x[o]) : 0.f;
    if (g_s) g_s[q * kZS + c] = in ? p.g[o] : 0.f;
  }
  for (int i = threadIdx.x; i < kTP * 8; i += kThreads) {
    const int q = i >> 3, v = i & 7;
    bc_s[i] = n1t_valid(t, q)
                  ? n1t_proj(p, xdbl, t.base + n1t_l(p, t, q), p.bc_off + (v >> 1) * p.bc_k + (v & 1))
                  : 0.f;
  }
}

// sigmoid(z) from delta = softplus(z): 1 - e^-delta, by its series to
// delta^6 below 0.25 (no cancellation; truncation below 5e-8 relative),
// __expf above (below 1e-6 relative there).
__device__ __forceinline__ float n1t_sigmoid_of_softplus(float delta) {
  if (delta >= 0.25f) return 1.f - __expf(-delta);
  float q = fmaf(delta, -1.f / 720, 1.f / 120);
  q = fmaf(delta, -q, 1.f / 24);
  q = fmaf(delta, -q, 1.f / 6);
  q = fmaf(delta, -q, 0.5f);
  return delta * fmaf(delta, -q, 1.f);
}

// The elementwise part of the pair (k0, k0 + 2), every (direction, row,
// channel) of the tile in parallel: z_s (before bias) becomes a =
// exp(delta A), e_s b = delta u B (forward) or delta (backward); a = 1 and
// e = 0 outside the map and past D.  Thread: one channel, every 8th row
// (a warp's rows are one column of the tile, all in or all out of the map).
template <bool BACKWARD>
__device__ __forceinline__ void n1t_elementwise(const N1TParams& p, const N1Tile& t, int k0,
                                                int c0, float* a_s, float* e_s, const float* u_s,
                                                const float* bc_s) {
  const int c = threadIdx.x % kCS, q0 = threadIdx.x / kCS;
  const bool active = c0 + c < p.D;
  const int cc = active ? c0 + c : p.D - 1;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int k = k0 + 2 * d;
    const float a_k = p.A[k * p.D + cc], bias_k = p.bias[k * p.D + cc];
#pragma unroll 4
    for (int q = q0; q < kTP; q += kThreads / kCS) {
      const int o = (d * kTP + q) * kZS + c;
      if (!n1t_valid(t, q)) {  // a row outside the map: the same for the whole warp
        a_s[o] = 1.f;
        e_s[o] = 0.f;
        continue;
      }
      const float delta = softplus20_fast(a_s[o] + bias_k);
      a_s[o] = active ? __expf(delta * a_k) : 1.f;
      e_s[o] = !active ? 0.f : BACKWARD ? delta : delta * u_s[q * kZS + c] * bc_s[q * 8 + 2 * k];
    }
  }
}

// Shared memory of a tile launch, in floats.
__host__ __device__ __forceinline__ int n1t_smem_words(int mode) {
  const bool backward = mode == kBwdPairs || mode == kBwdApply;
  const bool apply = mode == kFwdApply || mode == kBwdApply;
  return (5 + backward + apply) * kTP * kZS + kTP * 8;
}

// The dB and dC terms v[2 m + {0, 1}] of a warp's segment (m < 8), summed
// over the 32 lanes by a reduce-scatter: lanes 2i and 2i + 1 end with the
// sum of v[i].  A fixed order, the same every run.
template <int HALF, int BIT>
__device__ __forceinline__ void n1t_scatter_step(float* v) {
  const bool up = threadIdx.x & BIT;
#pragma unroll
  for (int m = 0; m < HALF; ++m) {
    const float send = up ? v[m] : v[m + HALF];
    const float keep = up ? v[m + HALF] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

__device__ __forceinline__ float n1t_reduce16(float* v) {
  n1t_scatter_step<8, 16>(v);
  n1t_scatter_step<4, 8>(v);
  n1t_scatter_step<2, 4>(v);
  n1t_scatter_step<1, 2>(v);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// f(m) for the steps m < len of a segment, in data order or (REV) against
// it; unrolled, so arrays indexed by m stay in registers.
template <bool REV, class F>
__device__ __forceinline__ void n1t_steps(int len, const F& f) {
  if constexpr (!REV) {
#pragma unroll
    for (int m = 0; m < kTS; ++m)
      if (m < len) f(m);
  } else {
#pragma unroll
    for (int m = kTS - 1; m >= 0; --m)
      if (m < len) f(m);
  }
}

// One chain's part of a tile: direction k (reverse: REV) of slab channel
// cl on segment sg, its operands in shared memory.  second: the pair's
// second direction (k0 + 2), which merges with first[] (the first
// direction's y or du at each step).
struct N1TChain {
  const N1Tile* t;
  const N1Seg* sg;
  int k, cl, c, pr;
  bool active, second;
  float a_k, d_k;
  long long chain;   // index of the segment's pair in p.pair
  float2* pair_out;  // where a pair walk puts its pair, or null
  float h_in;        // the state entering the segment (forward apply)
  const float *u_s, *g_s, *bc_s, *e_s;
  float *a_s, *y_s;
};

// The chain of slab channel lane + 32 ch in direction k0 + 2 d (the pair's
// d-th) on segment sg, its operands in the tile's shared memory.
__device__ __forceinline__ N1TChain n1t_chain_of(const N1TParams& p, const N1Tile& t,
                                                 const N1Seg& sg, int pr, int d, int ch, int c0,
                                                 float* a_s, float* e_s, const float* u_s,
                                                 const float* g_s, const float* bc_s,
                                                 float* y_s) {
  N1TChain w;
  w.t = &t;
  w.sg = &sg;
  w.k = pr + 2 * d;
  w.pr = pr;
  w.second = d == 1;
  w.cl = (threadIdx.x & 31) + 32 * ch;
  w.c = c0 + w.cl;
  w.active = w.c < p.D;
  const int cc = w.active ? w.c : p.D - 1;
  w.a_k = p.A[w.k * p.D + cc];
  w.d_k = p.Dk[w.k * p.D + cc];
  w.chain = (n1t_chain(p, t.b, w.k) + sg.s) * p.D + cc;
  w.pair_out = nullptr;
  w.h_in = 0.f;
  w.u_s = u_s;
  w.g_s = g_s;
  w.bc_s = bc_s;
  w.a_s = a_s + d * kTP * kZS;
  w.e_s = e_s + d * kTP * kZS;
  w.y_s = y_s;
  return w;
}

template <int MODE, bool REV>
__device__ __forceinline__ void n1t_walk(const N1TParams& p, const N1TChain& w, float* first,
                                         float* vbc, float& sb, float& sa, float& sd) {
  const N1Tile& t = *w.t;
  const N1Seg& sg = *w.sg;
  auto at = [&](const float* s, int m) { return s[(sg.q0 + m * sg.dq) * kZS + w.cl]; };
  auto bc = [&](int m, int which) { return w.bc_s[(sg.q0 + m * sg.dq) * 8 + 2 * w.k + which]; };
  // the step's y_k or du_k: kept (first direction), or merged and stored
  auto merge = [&](int m, float v) {
    const int q = sg.q0 + m * sg.dq;
    if (!w.second) {
      first[m] = v;
    } else if (w.pr == 0) {
      w.y_s[q * kZS + w.cl] = first[m] + v;
    } else if (w.active) {
      float* out = MODE == kFwdApply ? p.y : p.du;
      out[(t.base + n1t_l(p, t, q)) * p.D + w.c] = w.y_s[q * kZS + w.cl] + (first[m] + v);
    }
  };
  if constexpr (MODE == kFwdPairs || MODE == kBwdPairs) {
    float prod = 1.f, h = 0.f;
    n1t_steps<REV>(sg.len, [&](int m) {
      const float a = at(w.a_s, m);
      // e_s: b forward, delta backward
      h = fmaf(a, h, MODE == kFwdPairs ? at(w.e_s, m) : at(w.e_s, m) * at(w.u_s, m) * bc(m, 0));
      prod *= a;
    });
    if (w.pair_out) *w.pair_out = make_float2(prod, h);
    if constexpr (MODE == kBwdPairs) {
      float gl = 0.f;
      n1t_steps<!REV>(sg.len, [&](int m) {
        gl = at(w.a_s, m) * (bc(m, 1) * at(w.g_s, m) + gl);
      });
      if (w.active) p.gpair[w.chain] = gl;
    }
  } else if constexpr (MODE == kFwdApply) {
    float h = w.h_in;
    // the segment's first checkpoint edge in the walk's order: a forward
    // direction enters chunk j at t = j chunk, a reverse one at the chunk's
    // last position (or L - 1)
    const int L = p.H * p.W, t_last = sg.t0 + sg.len - 1;
    int edge = !REV ? (sg.t0 + p.chunk - 1) / p.chunk * p.chunk
                    : t_last == L - 1 ? t_last : (t_last + 1) / p.chunk * p.chunk - 1;
    n1t_steps<REV>(sg.len, [&](int m) {
      const int tt = sg.t0 + m;
      if (tt == edge) {
        if (p.ck && w.active)
          p.ck[((static_cast<long long>(t.b) * 4 + w.k) * p.n_chunks + tt / p.chunk) * p.D +
               w.c] = h;
        edge = REV ? tt / p.chunk * p.chunk - 1 : tt + p.chunk;
      }
      h = fmaf(at(w.a_s, m), h, at(w.e_s, m));
      merge(m, fmaf(bc(m, 1), h, at(w.u_s, m) * w.d_k));
    });
  } else {  // kBwdApply: e_s holds delta
    float hv[kTS + 1];
    const float h_in = p.pair[w.chain].y;
    float h = h_in;
    n1t_steps<REV>(sg.len, [&](int m) {
      h = fmaf(at(w.a_s, m), h, at(w.e_s, m) * at(w.u_s, m) * bc(m, 0));
      hv[m] = h;
    });
    float gcar = p.gpair[w.chain];
    n1t_steps<!REV>(sg.len, [&](int m) {
      const float a = at(w.a_s, m), delta = at(w.e_s, m), u = at(w.u_s, m), dy = at(w.g_s, m);
      const float Bv = bc(m, 0), Cv = bc(m, 1);
      // the state before step m in the direction's order
      float h_prev;
      if (REV)
        h_prev = m + 1 < sg.len ? hv[m + 1] : h_in;
      else
        h_prev = m > 0 ? hv[m > 0 ? m - 1 : 0] : h_in;
      const float lam = fmaf(Cv, dy, gcar);
      const float du_k = fmaf(lam * delta, Bv, dy * w.d_k);
      const float dexp = lam * h_prev * a;
      const float ddelta = fmaf(lam * u, Bv, dexp * w.a_k);
      const float dp = w.active ? ddelta * n1t_sigmoid_of_softplus(delta) : 0.f;
      gcar = a * lam;
      if (w.active) {
        vbc[2 * m] += lam * delta * u;
        vbc[2 * m + 1] += dy * hv[m];
        sb += dp;
        sa += dexp * delta;
        sd += dy * u;
      }
      w.a_s[(sg.q0 + m * sg.dq) * kZS + w.cl] = dp;
      merge(m, du_k);
    });
  }
}

template <typename T, int MODE, int SLOTS>
__global__ void __launch_bounds__(kThreads, MODE == kBwdApply ? 2 : 3)
    ss2d_n1t_tile_kernel(N1TParams p) {
  constexpr Prec PR = sizeof(T) == 2 ? Prec::kBF16 : Prec::kTF32x3;
  constexpr bool kBackward = MODE == kBwdPairs || MODE == kBwdApply;
  extern __shared__ float n1t_smem[];
  float* a_s = n1t_smem;                           // 2 x 64 x kZS: z, a, then dpre (backward)
  float* e_s = a_s + 2 * kTP * kZS;                // 2 x 64 x kZS: delta u B, or delta
  float* u_s = e_s + 2 * kTP * kZS;                // 64 x kZS
  float* bc_s = u_s + kTP * kZS;                   // 64 x 8
  float* g_s = bc_s + kTP * 8;                     // 64 x kZS (backward)
  float* y_s = g_s + (kBackward ? kTP * kZS : 0);  // 64 x kZS: y_0 + y_2 (apply)
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = blockIdx.x, c0 = slab * kCS;
  const long long BL = static_cast<long long>(p.B) * p.H * p.W;
  const int n_items = p.B * p.nth * p.ntw;
  const int MT = (p.R + 15) / 16;
  // backward: dw_dt tiles (slot, 16 rank rows x the slab) and the sums
  float acc_w[SLOTS][kCS / 8][4] = {};
  float s_bias[4][kCH] = {}, s_a[4][kCH] = {}, s_d[4][kCH] = {};

  for (int item = blockIdx.y; item < n_items; item += gridDim.y) {
    const N1Tile t = n1t_tile(p, item);
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {  // rows (k 0, 2), then columns (k 1, 3)
      __syncthreads();  // the last pair is done with the staged tiles
      if (pr == 0) n1t_stage_inputs<T>(p, t, c0, u_s, kBackward ? g_s : nullptr, bc_s);
      n1t_stage_z<T, Prec::kTF32x3>(p, t, pr, c0, a_s);
      __syncthreads();
      n1t_elementwise<kBackward>(p, t, pr, c0, a_s, e_s, u_s, bc_s);
      __syncthreads();
      float first[kCH][kTS];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int k = pr + 2 * d;
        const N1Seg sg = n1t_seg(p, t, k, j);
        float vbc[2 * kTS];
#pragma unroll
        for (int i = 0; i < 2 * kTS; ++i) vbc[i] = 0.f;
        if (sg.valid) {
#pragma unroll
          for (int ch = 0; ch < kCH; ++ch) {
            N1TChain w = n1t_chain_of(p, t, sg, pr, d, ch, c0, a_s, e_s, u_s, g_s, bc_s, y_s);
            if ((MODE == kFwdPairs || MODE == kBwdPairs) && w.active) w.pair_out = p.pair + w.chain;
            if (MODE == kFwdApply) w.h_in = p.pair[w.chain].y;
            if (d == 0)
              n1t_walk<MODE, false>(p, w, first[ch], vbc, s_bias[k][ch], s_a[k][ch], s_d[k][ch]);
            else
              n1t_walk<MODE, true>(p, w, first[ch], vbc, s_bias[k][ch], s_a[k][ch], s_d[k][ch]);
          }
          if (MODE == kBwdApply) {
            // dB, dC of the segment's positions, summed over the slab's channels
            const float v = n1t_reduce16(vbc);
            const int i = lane >> 1, m = i >> 1;
            if ((lane & 1) == 0 && m < sg.len) {
              const long long l = t.base + n1t_l(p, t, sg.q0 + m * sg.dq);
              p.part_x[((static_cast<long long>(slab) * BL + l) * 4 + k) * (p.R + 2) + p.R +
                       (i & 1)] = v;
            }
          }
        }
      }
      if (MODE == kBwdApply) {
        __syncthreads();  // dpre of the pair is in a_s
        const int d = j >> 2, k = pr + 2 * d, m0 = (j & 3) * 16;
        const float* dpd = a_s + d * kTP * kZS;
        // d rank_k (tile rows m0 .., all R) = dpre_k w_dt[k]^T over the slab
        auto ad = [&](int q, int c) { return dpd[q * kZS + c]; };
        auto bd = [&](int c, int r) { return n1t_wdt(p, k, r, c0, c); };
        for (int n0 = 0; n0 < p.R; n0 += 16) {
          float acc[2][4] = {};
          mma_tiles<PR, 2>(acc, ad, bd, m0, n0, kTP, p.R, 0, kCS);
#pragma unroll
          for (int jt = 0; jt < 2; ++jt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = tile_row(m0, e), r = tile_col(n0 + 8 * jt, e);
              if (r < p.R && n1t_valid(t, q))
                p.part_x[((static_cast<long long>(slab) * BL + t.base + n1t_l(p, t, q)) * 4 + k) *
                             (p.R + 2) + r] = acc[jt][e];
            }
        }
        // dw_dt[k] (rank rows 16 mt .., the slab) += rank_k^T dpre_k over the tile
#pragma unroll
        for (int dd = 0; dd < 2; ++dd)
          for (int mt = 0; mt < MT; ++mt) {
            const int gi = (2 * pr + dd) * MT + mt;
            if (gi % 8 != j) continue;
            const int kk = pr + 2 * dd;
            const float* dq = a_s + dd * kTP * kZS;
            auto ar = [&](int r, int q) { return n1t_rank<T>(p, t, kk, q, r); };
            auto br = [&](int q, int c) { return dq[q * kZS + c]; };
            if (SLOTS == 1 || gi < 8)
              mma_tiles<PR, kCS / 8>(acc_w[0], ar, br, 16 * mt, 0, p.R, kCS, 0, kTP);
            else
              mma_tiles<PR, kCS / 8>(acc_w[SLOTS - 1], ar, br, 16 * mt, 0, p.R, kCS, 0, kTP);
          }
      }
    }
  }
  if (MODE != kBwdApply) return;
  // the block's partial dw_dt
#pragma unroll
  for (int slot = 0; slot < SLOTS; ++slot) {
    const int gi = j + 8 * slot;
    if (gi >= 4 * MT) continue;
    const int k = gi / MT / 2 + 2 * ((gi / MT) & 1), mt = gi % MT;
#pragma unroll
    for (int jt = 0; jt < kCS / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = tile_row(16 * mt, e), c = c0 + tile_col(8 * jt, e);
        if (r < p.R && c < p.D)
          p.part_w[((static_cast<long long>(blockIdx.y) * 4 + k) * p.R + r) * p.D + c] =
              acc_w[slot][jt][e];
      }
  }
  // dbias, dA, dD: each thread's sums, then over the warps in order
  __syncthreads();
  float* red = a_s;  // 8 warps x 3 x 4 x kCS
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int ch = 0; ch < kCH; ++ch) {
      const int cl = lane + 32 * ch;
      red[((j * 3 + 0) * 4 + k) * kCS + cl] = s_bias[k][ch];
      red[((j * 3 + 1) * 4 + k) * kCS + cl] = s_a[k][ch];
      red[((j * 3 + 2) * 4 + k) * kCS + cl] = s_d[k][ch];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * 4 * kCS; i += kThreads) {
    const int cl = i % kCS, qk = i / kCS;
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += red[(w * 12 + qk) * kCS + cl];
    if (c0 + cl < p.D)
      p.part_s[(static_cast<long long>(blockIdx.y) * 12 + qk) * p.D + c0 + cl] = v;
  }
}

// Kernel 11 in one launch, for maps of at most kMaxCluster tiles: a
// thread-block cluster holds one image's tiles (of one slab), a block a
// tile.  Each block stages its tile, takes z on the tensor cores and
// computes delta, a and b once per direction, walks its segments to their
// pairs into its shared memory, reads the pairs of every segment of its
// chains from the cluster's blocks (distributed shared memory) for the
// state entering each of its own segments, and walks them again from
// there, as the apply launch does: no pairs in device memory, no second
// staging, product or softplus.
constexpr int kMaxCluster = 8;

// a_s, e_s (two directions each), u_s, y_s; bc_s; the pairs
// [pr][d][segment][channel] (float2); the entering states [d][segment][channel]
__host__ __device__ __forceinline__ int n1t_fused_smem_words() {
  return 6 * kTP * kZS + kTP * 8 + 2 * (2 * 2 * kTS * kCS) + 2 * kTS * kCS;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) ss2d_n1t_fused_kernel(N1TParams p) {
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float n1t_smem[];
  float* a_s = n1t_smem;
  float* e_s = a_s + 2 * kTP * kZS;
  float* u_s = e_s + 2 * kTP * kZS;
  float* y_s = u_s + kTP * kZS;
  float* bc_s = y_s + kTP * kZS;
  float2* pair_s = reinterpret_cast<float2*>(bc_s + kTP * 8);
  float* hin_s = reinterpret_cast<float*>(pair_s + 2 * 2 * kTS * kCS);
  const int j = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kCS;
  const N1Tile t = n1t_tile(p, blockIdx.y);
  const int rank = t.ti * p.ntw + t.tj;  // the block's rank in its cluster
  float unused[2 * kTS], sb, sa, sd;
#pragma unroll 1
  for (int pr = 0; pr < 2; ++pr) {  // rows (k 0, 2), then columns (k 1, 3)
    __syncthreads();  // the last pair is done with the staged tiles
    if (pr == 0) n1t_stage_inputs<T>(p, t, c0, u_s, nullptr, bc_s);
    n1t_stage_z<T, Prec::kTF32x3>(p, t, pr, c0, a_s);
    __syncthreads();
    n1t_elementwise<false>(p, t, pr, c0, a_s, e_s, u_s, bc_s);
    __syncthreads();
    float2* pairs = pair_s + pr * 2 * kTS * kCS;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const N1Seg sg = n1t_seg(p, t, pr + 2 * d, j);
      if (!sg.valid) continue;
#pragma unroll
      for (int ch = 0; ch < kCH; ++ch) {
        N1TChain w = n1t_chain_of(p, t, sg, pr, d, ch, c0, a_s, e_s, u_s, nullptr, bc_s, y_s);
        w.pair_out = pairs + (d * kTS + j) * kCS + w.cl;
        if (d == 0)
          n1t_walk<kFwdPairs, false>(p, w, unused, unused, sb, sa, sd);
        else
          n1t_walk<kFwdPairs, true>(p, w, unused, unused, sb, sa, sd);
      }
    }
    cluster.sync();  // every block's pairs are in its shared memory
    if (threadIdx.x < 2 * kCS) {
      // one thread per (direction, channel) scans the chain's pairs in its
      // order, keeping the states that enter this block's segments
      const int d = threadIdx.x / kCS, cl = threadIdx.x % kCS, k = pr + 2 * d;
      const bool cols = k & 1, reverse = k >= 2;
      const int per = cols ? p.nth : p.ntw;  // segments of a row (or column)
      const int side = cols ? p.TW : p.TH;
      const int nseg = (cols ? p.W : p.H) * per;
      auto locate = [&](int n, int& owner, int& seg) {
        const int s = reverse ? nseg - 1 - n : n, line = s / per, tl = s - line * per;
        owner = cols ? tl * p.ntw + line / side : line / side * p.ntw + tl;
        seg = line % side;
      };
      float carry = 0.f;
      for (int n0 = 0; n0 < nseg; n0 += kTS) {
        float2 v[kTS];
#pragma unroll
        for (int b = 0; b < kTS; ++b) {
          int owner, seg;
          locate(min(n0 + b, nseg - 1), owner, seg);
          v[b] = cluster.map_shared_rank(pairs, owner)[(d * kTS + seg) * kCS + cl];
        }
#pragma unroll
        for (int b = 0; b < kTS; ++b) {
          if (n0 + b >= nseg) break;
          int owner, seg;
          locate(n0 + b, owner, seg);
          if (owner == rank) hin_s[(d * kTS + seg) * kCS + cl] = carry;
          carry = fmaf(v[b].x, carry, v[b].y);
        }
      }
    }
    // the last reads of other blocks' pairs are done before any block
    // leaves; the entering states are in place
    if (pr == 1)
      cluster.sync();
    else
      __syncthreads();
    float first[kCH][kTS];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const N1Seg sg = n1t_seg(p, t, pr + 2 * d, j);
      if (!sg.valid) continue;
#pragma unroll
      for (int ch = 0; ch < kCH; ++ch) {
        N1TChain w = n1t_chain_of(p, t, sg, pr, d, ch, c0, a_s, e_s, u_s, nullptr, bc_s, y_s);
        w.h_in = hin_s[(d * kTS + j) * kCS + w.cl];
        if (d == 0)
          n1t_walk<kFwdApply, false>(p, w, first[ch], unused, sb, sa, sd);
        else
          n1t_walk<kFwdApply, true>(p, w, first[ch], unused, sb, sa, sd);
      }
    }
  }
}

// The carries: one thread per (image, direction, channel) scans the
// segments' pairs in flattening order (h entering each segment, into the
// pair's .y) and, backward, the adjoint's values against it.  The loads of
// kCarryBatch segments are issued before their scan steps.
constexpr int kCarryBatch = 16;

__global__ void __launch_bounds__(256) ss2d_n1t_carry_kernel(N1TParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 4LL * p.B * p.D) return;
  const int c = static_cast<int>(i % p.D);
  const int bk = static_cast<int>(i / p.D), k = bk & 3;
  const int nseg = (k & 1) ? p.W * p.nth : p.H * p.ntw;
  const bool reverse = k >= 2;
  float2* pair = p.pair + static_cast<long long>(bk) * p.NS * p.D + c;
  float carry = 0.f;
  for (int n0 = 0; n0 < nseg; n0 += kCarryBatch) {
    float2 v[kCarryBatch];
#pragma unroll
    for (int b = 0; b < kCarryBatch; ++b) {
      const int n = min(n0 + b, nseg - 1);
      v[b] = pair[static_cast<long long>(reverse ? nseg - 1 - n : n) * p.D];
    }
#pragma unroll
    for (int b = 0; b < kCarryBatch; ++b) {
      if (n0 + b >= nseg) break;
      const int n = n0 + b;
      pair[static_cast<long long>(reverse ? nseg - 1 - n : n) * p.D].y = carry;
      carry = fmaf(v[b].x, carry, v[b].y);
    }
  }
  if (!p.gpair) return;
  float* gpair = p.gpair + static_cast<long long>(bk) * p.NS * p.D + c;
  carry = 0.f;
  for (int n0 = 0; n0 < nseg; n0 += kCarryBatch) {
    float prod[kCarryBatch], gl[kCarryBatch];
#pragma unroll
    for (int b = 0; b < kCarryBatch; ++b) {
      const int n = min(n0 + b, nseg - 1);
      const long long o = static_cast<long long>(reverse ? n : nseg - 1 - n) * p.D;
      prod[b] = pair[o].x;
      gl[b] = gpair[o];
    }
#pragma unroll
    for (int b = 0; b < kCarryBatch; ++b) {
      if (n0 + b >= nseg) break;
      const int n = n0 + b;
      gpair[static_cast<long long>(reverse ? n : nseg - 1 - n) * p.D] = carry;
      carry = fmaf(prod[b], carry, gl[b]);
    }
  }
}

// The adjoint's sums in a fixed order: the slabs' d rank, dB and dC added
// into the projections' gradient, the blocks' dw_dt, dbias, dA and dD.
__global__ void __launch_bounds__(256) ss2d_n1t_sums_kernel(N1TParams p) {
  const long long BL = static_cast<long long>(p.B) * p.H * p.W;
  const int RC = p.R + 2;
  const long long n_x = BL * 4 * RC, n_w = 4LL * p.R * p.D, n_s = 12LL * p.D;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_x + n_w + n_s; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < n_x) {
      float v = 0.f;
      for (int s = 0; s < p.n_slabs; ++s) v += p.part_x[s * n_x + i];
      const int col = static_cast<int>(i % RC), k = static_cast<int>(i / RC % 4);
      const long long l = i / (4 * RC);
      const int dst = col < p.R ? k * p.rank_k + col : p.bc_off + k * p.bc_k + col - p.R;
      p.dxdbl[l * p.row + dst] += v;
    } else if (i < n_x + n_w) {
      const long long o = i - n_x;
      float v = 0.f;
      for (int b = 0; b < p.P; ++b) v += p.part_w[b * n_w + o];
      p.dw_dt[o] = v;
    } else {
      const long long o = i - n_x - n_w;
      float v = 0.f;
      for (int b = 0; b < p.P; ++b) v += p.part_s[b * n_s + o];
      const long long kd = o % (4LL * p.D);
      float* out = o < 4LL * p.D ? p.dbias : o < 8LL * p.D ? p.dA : p.dD;
      out[kd] = v;
    }
  }
}

constexpr int kN1TMaxSmem = 227 * 1024;

template <typename T, int MODE, int SLOTS>
cudaError_t n1t_launch_tiles(const N1TParams& p, cudaStream_t s) {
  static bool ready = false;
  auto kernel = ss2d_n1t_tile_kernel<T, MODE, SLOTS>;
  const int smem = 4 * n1t_smem_words(MODE);
  if (smem > kN1TMaxSmem) return cudaErrorInvalidValue;
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kN1TMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<dim3(p.n_slabs, p.P), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t n1t_launch_fused(const N1TParams& p, cudaStream_t s) {
  static bool ready = false;
  auto kernel = ss2d_n1t_fused_kernel<T>;
  const int smem = 4 * n1t_fused_smem_words();
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = p.nth * p.ntw;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_slabs, p.B * p.nth * p.ntw);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t n1t_run(const N1TParams& p, bool backward, bool fused, cudaStream_t s) {
  if (fused) return n1t_launch_fused<T>(p, s);
  cudaError_t err = backward ? n1t_launch_tiles<T, kBwdPairs, 1>(p, s)
                             : n1t_launch_tiles<T, kFwdPairs, 1>(p, s);
  if (err != cudaSuccess) return err;
  ss2d_n1t_carry_kernel<<<ceil_div(4LL * p.B * p.D, 256), 256, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (!backward) return n1t_launch_tiles<T, kFwdApply, 1>(p, s);
  err = p.R <= 32 ? n1t_launch_tiles<T, kBwdApply, 1>(p, s)
                  : n1t_launch_tiles<T, kBwdApply, 2>(p, s);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(p.B) * p.H * p.W * 4 * (p.R + 2) +
                      4LL * p.R * p.D + 12LL * p.D;
  ss2d_n1t_sums_kernel<<<static_cast<int>(std::min<long long>(ceil_div(n, 256), 132 * 16)), 256,
                         0, s>>>(p);
  return cudaGetLastError();
}

cudaError_t n1t_dispatch(N1TParams& p, int dtype, bool backward, bool fused, void* stream) {
  const long long L = static_cast<long long>(p.H) * p.W;
  if (p.B < 1 || p.H < 1 || p.W < 1 || p.D < 1 || p.R < 1 || p.R > kMaxR || p.chunk < 1 ||
      p.row < 1 || p.TH < 1 || p.TH > kTS || p.TW < 1 || p.TW > kTS || p.P < 1 || p.P > 65535)
    return cudaErrorInvalidValue;
  p.n_chunks = ceil_div(L, p.chunk);
  p.nth = ceil_div(p.H, p.TH);
  p.ntw = ceil_div(p.W, p.TW);
  p.NS = std::max(p.H * p.ntw, p.W * p.nth);
  p.n_slabs = ceil_div(p.D, kCS);
  if (fused && (backward || p.nth * p.ntw > kMaxCluster ||
                static_cast<long long>(p.B) * p.nth * p.ntw > 65535))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return n1t_run<float>(p, backward, fused, s);
  if (dtype == kBF16) return n1t_run<__nv_bfloat16>(p, backward, fused, s);
  return cudaErrorInvalidValue;
}

}  // namespace xfm

using namespace xfm;

// layout: (row, rank_k, bc_off, bc_k) of the projection rows; tiling: TH x
// TW tiles, P blocks per slab (see N1TParams and ops/ss2d_core_n1.py);
// fused: the forward in one cluster launch (pair unused), else three.
extern "C" int xfm_ss2d_n1_fwd(const void* x, const void* xdbl, const float* w_dt, const float* A,
                               const float* Dk, const float* bias, float* y, float* ck,
                               void* pair, int B, int H, int W, int D, int R, int chunk, int row,
                               int rank_k, int bc_off, int bc_k, int TH, int TW, int P, int fused,
                               int dtype, void* stream) {
  N1TParams p{};
  p.x = x;
  p.xdbl = xdbl;
  p.w_dt = w_dt;
  p.A = A;
  p.Dk = Dk;
  p.bias = bias;
  p.y = y;
  p.ck = ck;
  p.pair = static_cast<float2*>(pair);
  p.B = B;
  p.H = H;
  p.W = W;
  p.D = D;
  p.R = R;
  p.chunk = chunk;
  p.row = row;
  p.rank_k = rank_k;
  p.bc_off = bc_off;
  p.bc_k = bc_k;
  p.TH = TH;
  p.TW = TW;
  p.P = P;
  return n1t_dispatch(p, dtype, false, fused != 0, stream);
}

extern "C" int xfm_ss2d_n1_bwd(const void* x, const void* xdbl, const float* w_dt, const float* A,
                               const float* Dk, const float* bias, const float* g, void* pair,
                               float* gpair, float* du, float* part_x, float* part_w,
                               float* part_s, float* dxdbl, float* dw_dt, float* dbias, float* dA,
                               float* dD, int B, int H, int W, int D, int R, int chunk, int row,
                               int rank_k, int bc_off, int bc_k, int TH, int TW, int P, int dtype,
                               void* stream) {
  N1TParams p{};
  p.x = x;
  p.xdbl = xdbl;
  p.w_dt = w_dt;
  p.A = A;
  p.Dk = Dk;
  p.bias = bias;
  p.g = g;
  p.pair = static_cast<float2*>(pair);
  p.gpair = gpair;
  p.du = du;
  p.part_x = part_x;
  p.part_w = part_w;
  p.part_s = part_s;
  p.dxdbl = dxdbl;
  p.dw_dt = dw_dt;
  p.dbias = dbias;
  p.dA = dA;
  p.dD = dD;
  p.B = B;
  p.H = H;
  p.W = W;
  p.D = D;
  p.R = R;
  p.chunk = chunk;
  p.row = row;
  p.rank_k = rank_k;
  p.bc_off = bc_off;
  p.bc_k = bc_k;
  p.TH = TH;
  p.TW = TW;
  p.P = P;
  if (!gpair || !part_x || !part_w || !part_s) return cudaErrorInvalidValue;
  return n1t_dispatch(p, dtype, true, false, stream);
}
