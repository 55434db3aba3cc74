// Kernel 8: one whole v05_noz VSSBlock for inference in one cooperative
// launch.  Replaces xfmamba_tpu/ops/vss_block_pallas.py::_vss_block_kernel
// (:295, pallas_call :405), which runs the block in one Pallas call with its
// activations in VMEM; JAX takes it for the bfloat16 stages whose v2
// kernels find no image group aligned to 8 sublanes (one or two studies per
// batch, stages 2 and 3).
//
// What it computes, at the TPU kernel's rounding points (as the sequence
// of ops/vss_block_v1.py::V1_SEQUENCE_OPS does): xin, u, B, C, y and the
// residual stream stay float32; the LayerNorm outputs, the rank values, u
// for x_proj and the GELU output are rounded to the activation type T; the
// output once, at the end; GELU is exact (erf).  On x (M = n_img * H * W
// rows, d):
//   A. h1 = LN1(x)                                   -> T
//   B. xin = h1 @ w_in^T                             -> float32 (M, di)
//   C. u = silu(dwconv3x3(xin) + b_conv)             -> float32, and T for x_proj
//   D. xdbl = u @ w_xp^T                             -> float32 (M, 4R + 8)
//   E. the four d_state-1 cross2d scans (rank form: each direction's
//      delta = softplus(rank_k . w_dt[k] + b_dt[k]) inside), each into its
//      float32 part (4, M, di)
//   F. y = u * Dsum + part_0 + part_1 + part_2 + part_3 (kind order);
//      yn = LN_out(y)                                -> T
//   G. x1 = yn @ w_out^T + x                         -> float32 (M, d)
//   H. h2 = LN2(x1)                                  -> T
//   I. f1 = gelu(h2 @ w_fc1^T + b_fc1)               -> T (M, hd)
//   J. out = f1 @ w_fc2^T + b_fc2 + x1               -> T (M, d)
// A block without its MLP half (hd 0, JAX's fuse_mlp off) ends at G, which
// then writes out = yn @ w_out^T + x in T: every block of the grid skips
// phases H-J and their barriers alike, since hd is the launch's.
//
// Design.  At one study a block is small (at XFMamba-S's stage 2, 392 rows,
// 3.7 MB of bfloat16 weights, 1.45 GFLOP), so the eleven launches of the
// sequence, each through a Python wrapper, cost the host far more than the
// card's work.  Here the host makes one cudaLaunchCooperativeKernel per
// block: the grid is as many blocks as can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count), every
// block walks the work items of each phase in turn, and a grid-wide
// barrier separates the phases.  The launch is cooperative so that every
// block is resident: a barrier across blocks that are not would never
// return, and a launch that cannot be cooperative fails.  The barrier
// (v1_barrier) is a generation count in the workspace, which the host
// keeps per shape and stream: each block but the first publishes its
// arrival in a word of its own, the first block's threads wait for all of
// them and publish the next generation.  Nothing is reset between calls.
// - Products (B, D, G, I, J): 64 x 32 output tiles (64 x 64 where 32-wide
//   ones would outnumber the grid), 8 warps, k tiles of 64 through a
//   cp.async ring in shared memory (4 slots for bfloat16, 3 for float32), on
//   mma.sync through mma.cuh: one m16n8k16 per 16 of k for bfloat16 (its
//   fragments by ldmatrix), three m16n8k8 TF32 (split high and low parts)
//   for float32, sums in float32.
//   Where the output tiles are fewer than the grid's blocks, K is cut into
//   slices (at least 2 k tiles each) whose partial sums go to the
//   workspace; the block that finishes a tile's last slice (a counter per
//   tile) adds them in order, so the sums are the same on every run, and
//   the epilogue (bias, GELU, residual) runs on them.  The weights are read
//   from device memory once per call; the row tiles of a column tile find
//   them in L2.
// - LayerNorms (A, H): a warp per row, the arithmetic of vss_stage.cu's
//   layer_norm_kernel.  F (merge and out-norm) takes a block per row, so
//   the few rows of a study spread over the grid; it writes y to the
//   workspace and reads it back.
// - Conv (C): one thread per element, vss_stage.cu's dwconv3_silu_kernel.
// - Scans (E): scan_two_level.cuh's item on 64 channels x 4 chunks, 32 x 8
//   or 16 x 16 (a chunk is `segs` image rows or columns; the host picks
//   the fewest channels whose items fit one round over the grid), items
//   (channel tile, image, direction).  Each item first
//   stages its inputs (u, B, C, the rank values) and computes its deltas at
//   every position in shared memory, all 256 threads at once (STAGED,
//   where they fit: the single-study maps), so its two walks, the dependent
//   chain, read shared memory only.
//
// What bounds it on the H100: at the single-study shapes, neither the bytes
// (the weights, a few MB) nor the operations, but latency: ten grid
// barriers, the scans' dependent chains of H or W steps, and the products'
// k loops.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "scan_two_level.cuh"

namespace xfm {

constexpr int kV1Threads = 256;
constexpr int kV1BM = 64;
constexpr int kV1BK = 64;
constexpr int kV1MinSteps = 2;    // k tiles of a split at least
constexpr int kV1Phases = 10;     // A..J

// The cp.async ring's slots: four of bfloat16 tiles, three of float32 (two
// blocks an SM either way).
template <typename T>
__host__ __device__ constexpr int v1_stages() {
  return sizeof(T) == 2 ? 4 : 3;
}
// Elements of a row of a staged tile: BK and a 16-byte pad, so the eight
// rows a fragment load touches fall in different banks.
template <typename T>
__host__ __device__ constexpr int v1_ld() {
  return kV1BK + 16 / static_cast<int>(sizeof(T));
}
template <typename T, int BN>
__host__ __device__ constexpr int v1_gemm_bytes() {
  return v1_stages<T>() * (kV1BM + BN) * v1_ld<T>() * static_cast<int>(sizeof(T));
}
// Dynamic shared memory of the kernel: the products' ring at its widest,
// and at least 100 KB for the scans' staged items (two blocks an SM either
// way).
template <typename T>
__host__ __device__ constexpr int v1_smem_bytes() {
  return v1_gemm_bytes<T, 64>() > 100 * 1024 ? v1_gemm_bytes<T, 64>() : 100 * 1024;
}

// A product's output tile width: 32 columns, or 64 where 32-wide tiles
// would outnumber the grid's blocks.
__host__ __device__ inline int v1_bn(long long M, int N, int grid) {
  return (M + kV1BM - 1) / kV1BM * ((N + 31) / 32) > grid ? 64 : 32;
}

// The K slices of a product of `tiles` output tiles and K columns on a
// grid of `grid` blocks: as many as one round of items over the grid
// holds, each at least kV1MinSteps k tiles long.  Returns the k tiles of a
// slice.
__host__ __device__ inline int v1_split_steps(int tiles, int K, int grid) {
  const int nkt = (K + kV1BK - 1) / kV1BK;
  const int most = nkt / kV1MinSteps;
  int splits = grid / tiles;  // one round of items over the grid
  splits = splits < most ? splits : most;
  splits = splits < 1 ? 1 : splits;
  return (nkt + splits - 1) / splits;
}

struct V1Params {
  const void* x;  // (M, d) T
  void* out;      // (M, d) T
  const float* ln1_w;
  const float* ln1_b;
  const void* w_in;  // (di, d) T
  const float* w_conv;  // (9, di)
  const float* b_conv;  // (di,) or null
  const void* w_xp;  // (4R + 8, di) T
  const float* w_dt;  // (4, R, di)
  const float* b_dt;  // (4, di)
  const float* A;  // (4, 1, di)
  const float* Dsum;  // (di,)
  const float* lno_w;
  const float* lno_b;
  const void* w_out;  // (d, di) T
  const float* ln2_w;
  const float* ln2_b;
  const void* w_fc1;  // (hd, d) T
  const float* b_fc1;
  const void* w_fc2;  // (d, hd) T
  const float* b_fc2;
  // the workspace (zeroed once when it is made; the barrier words and the
  // split counters are left as they were found)
  unsigned* bar;      // [0] the barrier's generation, [1 + b] block b's arrival
  unsigned* counters; // a split product's slices done, per output tile
  void* h1;     // (M, d) T
  float* xin;   // (M, di), y in phase F
  float* u;     // (M, di)
  void* u_mm;   // (M, di) T (bfloat16 only; float32 reads u)
  float* xdbl;  // (M, 4R + 8)
  float* part;  // (4, M, di)
  void* yn;     // (M, di) T
  float* x1;    // (M, d)
  void* h2;     // (M, d) T
  void* f1;     // (M, hd) T
  float* gpart; // a split product's partial sums, (splits, M, N)
  unsigned long long* stamps;  // kV1Phases + 1 global-timer readings, or null
  int n_img, H, W, d, di, R, hd, segs;
  float eps;
};

struct V1Gemm {
  const void* a;     // (M, K) T
  const void* b;     // (N, K) T
  const float* bias; // (N,) or null
  const void* res;   // (M, N), float32 (res_f32) or T, or null
  void* out;         // (M, N), float32 (out_f32) or T
  int M, N, K, gelu, res_f32, out_f32;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The grid barrier: every block but the first publishes its arrival (its
// own word, no contention), block 0's threads wait for all of them and then
// publish the new generation, which the others wait for.  Reset-free: the
// words keep the last generation from call to call, and each call counts on
// from the generation it finds (the workspace, and so the words, belong to
// one stream).  The launch is cooperative, so every block is resident.
__device__ __forceinline__ void v1_barrier(unsigned* bar, unsigned gen) {
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x + 1; b < gridDim.x; b += kV1Threads)
      while (ld_acquire(bar + 1 + b) != gen) {
      }
    __syncthreads();
    if (threadIdx.x == 0) st_release(bar, gen);
  } else if (threadIdx.x == 0) {
    st_release(bar + 1 + blockIdx.x, gen);
    while (ld_acquire(bar) != gen) {
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ float v1_epilogue(const V1Gemm& g, float v, long long o, int n) {
  if (g.bias) v += g.bias[n];
  if (g.gelu) v = gelu_erf(v);
  if (g.res)
    v += g.res_f32 ? static_cast<const float*>(g.res)[o] : to_f32(static_cast<const T*>(g.res)[o]);
  return v;
}

template <typename T>
__device__ __forceinline__ void v1_store(const V1Gemm& g, float v, long long o) {
  if (g.out_f32) static_cast<float*>(g.out)[o] = v;
  else static_cast<T*>(g.out)[o] = from_f32<T>(v);
}

// Stage a k tile (rows m0.. of a, rows n0.. of b, k from k0) into one ring
// slot (As, Bs): 16-byte cp.async copies where the rows are 16-byte
// aligned (zero-filled past the edges), else element by element.
template <typename T, int BN>
__device__ __forceinline__ void v1_stage(const V1Gemm& g, T* As, T* Bs, int m0, int n0, int k0,
                                         bool vec) {
  constexpr int LD = v1_ld<T>(), PER = 16 / static_cast<int>(sizeof(T));
  const T* a = static_cast<const T*>(g.a);
  const T* b = static_cast<const T*>(g.b);
  if (vec) {
    for (int c = threadIdx.x; c < (kV1BM + BN) * (kV1BK / PER); c += kV1Threads) {
      const bool is_a = c < kV1BM * (kV1BK / PER);
      const int cc = is_a ? c : c - kV1BM * (kV1BK / PER);
      const int r = cc / (kV1BK / PER), kk = cc % (kV1BK / PER) * PER, k = k0 + kk;
      const int row = (is_a ? m0 : n0) + r, rows = is_a ? g.M : g.N;
      const T* base = is_a ? a : b;
      const int valid = row < rows ? max(0, min(PER, g.K - k)) : 0;
      const T* src = valid > 0 ? base + static_cast<long long>(row) * g.K + k : base;
      cp_async16((is_a ? As : Bs) + r * LD + kk, src, valid * static_cast<int>(sizeof(T)));
    }
    return;
  }
  for (int e = threadIdx.x; e < (kV1BM + BN) * kV1BK; e += kV1Threads) {
    const bool is_a = e < kV1BM * kV1BK;
    const int ee = is_a ? e : e - kV1BM * kV1BK;
    const int r = ee / kV1BK, kk = ee % kV1BK, k = k0 + kk;
    const int row = (is_a ? m0 : n0) + r, rows = is_a ? g.M : g.N;
    const T* base = is_a ? a : b;
    (is_a ? As : Bs)[r * LD + kk] =
        row < rows && k < g.K ? base[static_cast<long long>(row) * g.K + k] : from_f32<T>(0.f);
  }
}

// out = epilogue(a @ b^T) over the grid's blocks.  Items are 64 x BN
// output tiles times K slices (v1_split_steps); a slice's k tiles stream
// through the cp.async ring and 8 warps of 16 x BN / 2 run mma.sync on
// them.  Unsplit, the epilogue runs on the tile.  Split, each slice writes
// its partial sums to gpart and counts itself done on the tile's counter;
// the block that finishes a tile last adds the slices in order, applies the
// epilogue and resets the counter.  The sums do not depend on which block
// is last.
template <typename T, Prec PR, int BN>
__device__ void v1_gemm_bn(const V1Gemm& g, const V1Params& p, unsigned char* smem) {
  constexpr int LD = v1_ld<T>(), S = v1_stages<T>(), NT = BN / 16;
  __shared__ int last;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + S * kV1BM * LD;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps of 16 x BN / 2
  const int tiles_n = (g.N + BN - 1) / BN;
  const int tiles = (g.M + kV1BM - 1) / kV1BM * tiles_n;
  const int steps = v1_split_steps(tiles, g.K, gridDim.x);
  const int nkt = (g.K + kV1BK - 1) / kV1BK;
  const int splits = (nkt + steps - 1) / steps;
  const long long total = static_cast<long long>(g.M) * g.N;
  constexpr int PER = 16 / static_cast<int>(sizeof(T));
  const bool vec = g.K % PER == 0 && reinterpret_cast<uintptr_t>(g.a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g.b) % 16 == 0;
  for (int item = blockIdx.x; item < tiles * splits; item += gridDim.x) {
    const int tile = item % tiles, split = item / tiles;
    const int m0 = tile / tiles_n * kV1BM, n0 = tile % tiles_n * BN;
    const int kt0 = split * steps, nk = min(steps, nkt - kt0);
    float acc[NT][4] = {};
    __syncthreads();  // the previous item is done with the ring
#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (st < nk)
        v1_stage<T, BN>(g, As + st * kV1BM * LD, Bs + st * BN * LD, m0, n0, (kt0 + st) * kV1BK,
                        vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<S - 2>();
      __syncthreads();
      const int nxt = kt + S - 1;
      if (nxt < nk) {
        const int sl = nxt % S;
        v1_stage<T, BN>(g, As + sl * kV1BM * LD, Bs + sl * BN * LD, m0, n0, (kt0 + nxt) * kV1BK,
                        vec);
      }
      cp_async_commit();
      const T* At = As + kt % S * kV1BM * LD;
      const T* Bt = Bs + kt % S * BN * LD;
      if constexpr (PR == Prec::kBF16) {
        // fragments by ldmatrix, as gemm_tc.cu loads its K-major tiles
        const int lane = threadIdx.x % 32, jm = lane >> 3, rr = lane & 7;
#pragma unroll
        for (int kk = 0; kk < kV1BK; kk += 16) {
          uint32_t af[4];
          ldmatrix_x4(af, At + (wm * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8, false);
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            const int nb = wn * (BN / 2) + j * 8;
            uint32_t r[4];
            ldmatrix_x4(r, Bt + (nb + (jm >> 1) * 8 + rr) * LD + kk + (jm & 1) * 8, false);
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_bf16(acc[j], af, b0);
            mma_bf16(acc[j + 1], af, b1);
          }
        }
      } else {
        // whole tiles (zero past the edges): mma_tiles takes its unchecked path
        mma_tiles<PR, NT>(
            acc, [&](int m, int k) { return to_f32(At[m * LD + k]); },
            [&](int k, int n) { return to_f32(Bt[n * LD + k]); }, wm * 16, wn * (BN / 2), kV1BM,
            BN, 0, kV1BK);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + tile_row(wm * 16, e), n = n0 + tile_col(wn * (BN / 2) + 8 * j, e);
        if (m >= g.M || n >= g.N) continue;
        const long long o = static_cast<long long>(m) * g.N + n;
        if (splits > 1) p.gpart[split * total + o] = acc[j][e];
        else v1_store<T>(g, v1_epilogue<T>(g, acc[j][e], o, n), o);
      }
    }
    if (splits == 1) continue;
    __syncthreads();  // the block's partial sums are written
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(p.counters + tile, 1u) == static_cast<unsigned>(splits - 1);
      if (last) p.counters[tile] = 0;  // read next by another product, after a barrier
    }
    __syncthreads();
    if (!last) continue;
    __threadfence();
    for (int e = threadIdx.x; e < kV1BM * BN; e += kV1Threads) {
      const int m = m0 + e / BN, n = n0 + e % BN;
      if (m >= g.M || n >= g.N) continue;
      const long long o = static_cast<long long>(m) * g.N + n;
      // through L2 (__ldcg): the slices were written by other blocks
      float v = __ldcg(p.gpart + o);
      for (int sp = 1; sp < splits; ++sp) v += __ldcg(p.gpart + sp * total + o);
      v1_store<T>(g, v1_epilogue<T>(g, v, o, n), o);
    }
  }
}

template <typename T, Prec PR>
__device__ void v1_gemm(const V1Gemm& g, const V1Params& p, unsigned char* smem) {
  if (v1_bn(g.M, g.N, gridDim.x) == 64) v1_gemm_bn<T, PR, 64>(g, p, smem);
  else v1_gemm_bn<T, PR, 32>(g, p, smem);
}

// y[r, :] = LN(x[r, :]) * w + b: a warp per row over the grid, the
// arithmetic of vss_stage.cu's layer_norm_kernel.
template <typename IT, typename OT>
__device__ void v1_layer_norm(const IT* x, const float* w, const float* b, OT* y, int rows, int C,
                              float eps) {
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (kV1Threads / 32);
  for (int row = blockIdx.x * (kV1Threads / 32) + threadIdx.x / 32; row < rows; row += warps) {
    const IT* xr = x + static_cast<long long>(row) * C;
    float s = 0.f;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
    const float mu = warp_sum(s) / C;
    float v = 0.f;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
      const float dv = to_f32(xr[c]) - mu;
      v += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    OT* yr = y + static_cast<long long>(row) * C;
#pragma unroll 4
    for (int c = lane; c < C; c += 32)
      yr[c] = from_f32<OT>((to_f32(xr[c]) - mu) * rstd * w[c] + b[c]);
  }
}

// The sum of v over the block, in a fixed order (warps, then their sums in
// warp order); red holds kV1Threads / 32 floats.
__device__ __forceinline__ float v1_block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kV1Threads / 32; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// Phase F: y = u * Dsum + the four parts in kind order (two_level_merge_kernel's
// order), written to y, then its LayerNorm into yn: a block per row, so
// the few rows of a single study spread over the grid.
template <typename T>
__device__ void v1_merge_norm(const V1Params& p, int M, float* red) {
  const int C = p.di;
  const long long total = static_cast<long long>(M) * C;
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const long long r0 = static_cast<long long>(row) * C;
    float* yr = p.xin + r0;
    float s = 0.f;
    for (int c = threadIdx.x; c < C; c += kV1Threads) {
      float v = p.u[r0 + c] * p.Dsum[c];
#pragma unroll
      for (int k = 0; k < 4; ++k) v += p.part[k * total + r0 + c];
      yr[c] = v;
      s += v;
    }
    const float mu = v1_block_sum(s, red) / C;
    float var = 0.f;
    for (int c = threadIdx.x; c < C; c += kV1Threads) {
      const float dv = yr[c] - mu;
      var += dv * dv;
    }
    const float rstd = rsqrtf(v1_block_sum(var, red) / C + p.eps);
    T* out = static_cast<T*>(p.yn) + r0;
    for (int c = threadIdx.x; c < C; c += kV1Threads)
      out[c] = from_f32<T>((yr[c] - mu) * rstd * p.lno_w[c] + p.lno_b[c]);
  }
}

// Phase C: dwconv3_silu_kernel's arithmetic over the grid's threads.
template <typename T>
__device__ void v1_conv_silu(const V1Params& p, int M) {
  const int C = p.di, H = p.H, W = p.W;
  const long long total = static_cast<long long>(M) * C;
  T* u_mm = static_cast<T*>(p.u_mm);
  for (long long idx = static_cast<long long>(blockIdx.x) * kV1Threads + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * kV1Threads) {
    const int c = static_cast<int>(idx % C);
    const long long q = idx / C;
    const int wq = static_cast<int>(q % W);
    const int h = static_cast<int>((q / W) % H);
    const long long b = q / (static_cast<long long>(W) * H);
    float acc = p.b_conv ? p.b_conv[c] : 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int hh = h + dy - 1;
      if (hh < 0 || hh >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ww = wq + dx - 1;
        if (ww < 0 || ww >= W) continue;
        acc = fmaf(p.xin[((b * H + hh) * W + ww) * C + c], p.w_conv[(dy * 3 + dx) * C + c], acc);
      }
    }
    const float v = silu(acc);
    p.u[idx] = v;
    if (u_mm) u_mm[idx] = from_f32<T>(v);
  }
}

// Phase E: the scans, items (channel tile of CH, image, kind).  Where the
// item's inputs and deltas at every position fit in the shared memory of
// the ring, the item stages them first (STAGED).
template <typename T, int CH>
__device__ void v1_scans(const TwoLevelParams& sp, float* smem) {
  const int ctiles = (sp.D + CH - 1) / CH;
  const int items = ctiles * sp.n_img * 4;
  const int floats = two_level_smem_floats<CH>() + two_level_staged_floats(sp.H * sp.W, CH, sp.R);
  const bool staged = floats * 4 <= v1_smem_bytes<T>();
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int ctile = it % ctiles, img = it / ctiles % sp.n_img, k = it / ctiles / sp.n_img;
    if (staged)
      two_level_scan_item<float, 1, true, CH, true>(sp, ctile, img, k, threadIdx.x % CH,
                                                    threadIdx.x / CH, kV1Threads, smem);
    else
      two_level_scan_item<float, 1, true, CH>(sp, ctile, img, k, threadIdx.x % CH,
                                              threadIdx.x / CH, kV1Threads, smem);
  }
}

__device__ __forceinline__ void v1_stamp(const V1Params& p, int i) {
  if (p.stamps && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[i] = t;
  }
}

// The barrier after phase i - 1 (generation gen0 + i), then stamp i.
__device__ __forceinline__ void v1_sync(const V1Params& p, unsigned gen0, int i) {
  v1_barrier(p.bar, gen0 + i);
  v1_stamp(p, i);
}

template <typename T>
__global__ void __launch_bounds__(kV1Threads, 2) vss_block_v1_kernel(V1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned gen_s;
  float* fsmem = reinterpret_cast<float*>(smem);
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr Prec PR = kF32 ? Prec::kTF32x3 : Prec::kBF16;
  const int M = p.n_img * p.H * p.W, d = p.d, di = p.di, R = p.R, P = 4 * p.R + 8;
  const void* u_mm = kF32 ? static_cast<const void*>(p.u) : p.u_mm;
  // the generation the last call left (no block of this call publishes one
  // before every block has read it: each must arrive first)
  if (threadIdx.x == 0) gen_s = ld_acquire(p.bar);
  __syncthreads();
  const unsigned gen0 = gen_s;

  v1_stamp(p, 0);
  v1_layer_norm<T, T>(static_cast<const T*>(p.x), p.ln1_w, p.ln1_b, static_cast<T*>(p.h1), M, d,
                      p.eps);                                                               // A
  v1_sync(p, gen0, 1);
  v1_gemm<T, PR>({p.h1, p.w_in, nullptr, nullptr, p.xin, M, di, d, 0, 0, 1}, p, smem);     // B
  v1_sync(p, gen0, 2);
  v1_conv_silu<T>(p, M);                                                                    // C
  v1_sync(p, gen0, 3);
  v1_gemm<T, PR>({u_mm, p.w_xp, nullptr, nullptr, p.xdbl, M, P, di, 0, 0, 1}, p, smem);    // D
  v1_sync(p, gen0, 4);
  {                                                                                         // E
    const TwoLevelParams sp{p.u,   nullptr, p.xdbl, p.w_dt, p.xdbl + 4 * R, p.xdbl + 4 * R + 1,
                            p.A,   p.b_dt,  nullptr, p.part, p.n_img,       p.H,
                            p.W,   di,      4,       1,      R,             0xE4,
                            p.segs, 0,      P,       P,      2,             1,
                            kF32 ? 0 : 1,   0};
    // items of 64 channels x 4 chunk slots, 32 x 8 or 16 x 16, the widest
    // the chunk count allows (the host picks segs: ops/vss_block_v1.py::
    // scan_segments)
    const int chunks = max((p.H + p.segs - 1) / p.segs, (p.W + p.segs - 1) / p.segs);
    if (chunks <= kV1Threads / 64) v1_scans<T, 64>(sp, fsmem);
    else if (chunks <= kV1Threads / 32) v1_scans<T, 32>(sp, fsmem);
    else v1_scans<T, 16>(sp, fsmem);
  }
  v1_sync(p, gen0, 5);
  v1_merge_norm<T>(p, M, fsmem);                                                            // F
  v1_sync(p, gen0, 6);
  const bool mlp = p.hd > 0;
  v1_gemm<T, PR>({p.yn, p.w_out, nullptr, p.x, mlp ? p.x1 : p.out, M, d, di, 0, 0, mlp}, p,
                 smem);                                                                     // G
  if (!mlp) {
    if (p.stamps) v1_sync(p, gen0, 7);  // the clock of the last phase
    return;
  }
  v1_sync(p, gen0, 7);
  v1_layer_norm<float, T>(p.x1, p.ln2_w, p.ln2_b, static_cast<T*>(p.h2), M, d, p.eps);    // H
  v1_sync(p, gen0, 8);
  v1_gemm<T, PR>({p.h2, p.w_fc1, p.b_fc1, nullptr, p.f1, M, p.hd, d, 1, 0, 0}, p, smem);   // I
  v1_sync(p, gen0, 9);
  v1_gemm<T, PR>({p.f1, p.w_fc2, p.b_fc2, p.x1, p.out, M, d, p.hd, 0, 1, 0}, p, smem);     // J
  if (p.stamps) v1_sync(p, gen0, 10);  // the clock of the last phase
}

// The workspace's pieces, each 256-byte aligned, in V1Params order: the
// barrier words, the split counters, the activations, the partial sums of
// the largest split product.
struct V1Layout {
  long long off[13];
  long long total;
};

inline V1Layout v1_layout(long long M, int d, int di, int R, int hd, int esize, int grid) {
  const long long P = 4 * R + 8;
  // (N, K) of the five products
  const long long nk[5][2] = {{di, d}, {P, di}, {d, di}, {hd, d}, {d, hd}};
  long long gpart = 0, tiles_max = 0;
  for (const auto& q : nk) {
    if (q[0] == 0 || q[1] == 0) continue;  // no MLP (hd 0)
    const int bn = v1_bn(M, static_cast<int>(q[0]), grid);
    const int tiles = static_cast<int>((M + kV1BM - 1) / kV1BM * ((q[0] + bn - 1) / bn));
    const int nkt = static_cast<int>((q[1] + kV1BK - 1) / kV1BK);
    const int steps = v1_split_steps(tiles, static_cast<int>(q[1]), grid);
    const long long splits = (nkt + steps - 1) / steps;
    if (splits > 1 && splits * M * q[0] > gpart) gpart = splits * M * q[0];
    if (tiles > tiles_max) tiles_max = tiles;
  }
  const long long sizes[13] = {(1 + grid) * 4LL,   tiles_max * 4,  M * d * esize,
                               M * di * 4,         M * di * 4,     esize == 4 ? 0 : M * di * esize,
                               M * P * 4,          4 * M * di * 4, M * di * esize,
                               M * d * 4,          M * d * esize,  M * hd * esize,
                               gpart * 4};
  V1Layout l{};
  for (int i = 0; i < 13; ++i) {
    l.off[i] = l.total;
    l.total += (sizes[i] + 255) / 256 * 256;
  }
  return l;
}

// Resident blocks of the kernel on the current device (the cooperative
// grid), or 0 with the error in *err.
template <typename T>
int v1_grid(cudaError_t* err) {
  static int cached[64] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int per_sm = 0, sms = 0;
  *err = cudaFuncSetAttribute(vss_block_v1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              v1_smem_bytes<T>());
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vss_block_v1_kernel<T>, kV1Threads,
                                                       v1_smem_bytes<T>());
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  if (dev < 64) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

template <typename T>
cudaError_t launch_v1(V1Params p, int grid, cudaStream_t s) {
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(vss_block_v1_kernel<T>), dim3(grid), dim3(kV1Threads), args,
      v1_smem_bytes<T>(), s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace xfm

using namespace xfm;

// Bytes of the workspace of one call on M rows (on the current device's
// cooperative grid), or a negative CUDA error.
extern "C" long long xfm_vss_block_v1_workspace(long long M, int d, int di, int R, int hd,
                                                int dtype) {
  cudaError_t err;
  const int grid = dtype == kF32 ? v1_grid<float>(&err) : v1_grid<__nv_bfloat16>(&err);
  if (!grid) return -static_cast<long long>(err);
  return v1_layout(M, d, di, R, hd, dtype == kF32 ? 4 : 2, grid).total;
}

// The cooperative grid's size (blocks) for the dtype on the current device,
// or a negative CUDA error.
extern "C" int xfm_vss_block_v1_grid(int dtype) {
  cudaError_t err;
  const int grid = dtype == kF32 ? v1_grid<float>(&err) : v1_grid<__nv_bfloat16>(&err);
  return grid ? grid : -static_cast<int>(err);
}

// One block.  stamps, when given, receives kV1Phases + 1 readings of the
// global timer (ns): at the start and after each phase's barrier.
extern "C" int xfm_vss_block_v1(const void* x, void* out, const float* ln1_w, const float* ln1_b,
                                const void* w_in, const float* w_conv, const float* b_conv,
                                const void* w_xp, const float* w_dt, const float* b_dt,
                                const float* A, const float* Dsum, const float* lno_w,
                                const float* lno_b, const void* w_out, const float* ln2_w,
                                const float* ln2_b, const void* w_fc1, const float* b_fc1,
                                const void* w_fc2, const float* b_fc2, void* workspace,
                                void* stamps, int n_img, int H, int W, int d, int di, int R,
                                int hd, int segs, int dtype, void* stream) {
  if (n_img < 1 || H < 1 || W < 1 || d < 1 || di < 1 || hd < 0 || R < 1 || R > kTLMaxR ||
      segs < 1 || (H + segs - 1) / segs > kTLMaxChunks || (W + segs - 1) / segs > kTLMaxChunks ||
      (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  cudaError_t err;
  const int grid = dtype == kF32 ? v1_grid<float>(&err) : v1_grid<__nv_bfloat16>(&err);
  if (!grid) return err;
  const long long M = static_cast<long long>(n_img) * H * W;
  const V1Layout l = v1_layout(M, d, di, R, hd, dtype == kF32 ? 4 : 2, grid);
  char* ws = static_cast<char*>(workspace);
  auto f = [&](int i) { return reinterpret_cast<float*>(ws + l.off[i]); };
  auto u = [&](int i) { return reinterpret_cast<unsigned*>(ws + l.off[i]); };
  V1Params p{x,     out,   ln1_w, ln1_b, w_in,  w_conv, b_conv, w_xp,  w_dt,  b_dt,
             A,     Dsum,  lno_w, lno_b, w_out, ln2_w,  ln2_b,  w_fc1, b_fc1, w_fc2,
             b_fc2, u(0),  u(1),  ws + l.off[2], f(3), f(4),
             dtype == kF32 ? nullptr : ws + l.off[5], f(6), f(7), ws + l.off[8], f(9),
             ws + l.off[10], ws + l.off[11], f(12),
             static_cast<unsigned long long*>(stamps), n_img, H, W, d, di, R, hd, segs, 1e-5f};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_v1<float>(p, grid, s);
  return launch_v1<__nv_bfloat16>(p, grid, s);
}
