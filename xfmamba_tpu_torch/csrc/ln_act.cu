// Per-pixel LayerNorm with an optional exact (erf) GELU over NHWC maps, and
// its backward: the patch-embed / downsample glue of the JAX ablations,
// redesigned for the H100 as staged streaming passes (the first design,
// a warp a pixel, is ln_act_v1.cu).
//
// - kernel 19, entry xfm_ln_act, replaces
//   xfmamba_tpu/ops/ablations/pe_fused.py::_ln_act_kernel (:46), and
//   kernel 20, entry xfm_seg_ln_fwd, replaces
//   xfmamba_tpu/ops/ablations/seg_ln.py::_seg_ln_fwd_kernel (:101).  The
//   TPU kernels differ in how they lay pixels on the lanes (the natural
//   (rows, C) layout, or P = lcm(C, 128) / C pixels packed in a row); on
//   the card both are one function, `ln_fwd_kernel`.
// - kernel 21, entry xfm_seg_ln_bwd, replaces
//   xfmamba_tpu/ops/ablations/seg_ln.py::_seg_ln_bwd_kernel (:110):
//   `ln_bwd_kernel`, then `ln_col_sum_kernel`.
//
// What bounds them on the H100: device-memory bandwidth.  A forward reads x
// and writes y once, the backward reads x and g and writes dx once (the
// column sums add 2 C floats a block); at C 48 with the GELU the erf's
// instructions cost about as much issue time as the bytes.  The first
// design kept too few bytes in flight (a warp a pixel, scalar 2-byte
// loads: 6-12 KB an SM), and its backward took the GELU's derivative three
// times an element and re-read x and g for its column sums.  This design:
// - A grid of the card's resident blocks, each walking tiles of `tile`
//   contiguous pixels (one run of tile x C elements in NHWC) in turn, a
//   whole number of rounds of the block's pixel groups (no group idles but
//   in the last tile).  A
//   tile comes into shared memory by the bulk copy engine on an mbarrier
//   (staging.cuh), `stages` (3) tiles a block in flight, so each SM has
//   32 KB or more on the way.  A tile whose base or bytes are not whole
//   16-byte pieces (an unaligned x, the ragged last tile) is staged element
//   by element by the block's threads instead.
// - A pixel takes `tpp` threads (a power of two), each holding the same
//   16-byte pieces of its channels for every pixel it serves (element by
//   element where a pixel is no whole number of pieces): about three
//   pieces a thread, so a quarter warp reads whole 128 bytes of shared
//   memory with no bank conflict at a 96-byte pixel stride.  The mean, then
//   the centred variance, in float32 from the values in registers, summed
//   over the group by shuffles (groups wider than a warp add the warps'
//   sums in shared memory, in warp order).
// - w and b are read once a block into shared memory; y and dx go out by
//   16-byte stores (a group's consecutive pieces: whole 32-byte sectors).
// - Backward: x and g staged together (two bulk copies on one barrier);
//   g' = g gelu'(z) is evaluated once an element (one erff, one expf) and
//   kept in registers for dx; each thread adds g' xhat and g' into its own
//   channels' float32 sums across its pixels and tiles, in order.  The
//   block then adds its threads' sums in a fixed order (shuffles across a
//   warp's groups, then warp by warp) into one partial row, and a second
//   launch adds the grid's partial rows in a fixed order: no float atomics,
//   the same bits on every run.
// - A pixel the staged plan cannot take (more than kLnElems values a thread
//   at a block a pixel: C past 6,144; or a tile past shared memory) takes
//   the row path (`ln_fwd_rows_kernel`, `ln_bwd_rows_kernel`): a block a
//   pixel, each pass read from device memory (the pixel stays in L2), the
//   backward's g' w kept in its block's float32 row of scratch and its
//   column sums in its partial row, each channel by one thread in pixel
//   order.  No C is refused.
//
// The GELU is the erf form everywhere (the port's GELU, as the JAX suite
// pins it with GELU_TANH = False); forward and backward use the same one.
#include "staging.cuh"

namespace xfm {

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kLnStages = 3;               // tiles in flight a block, at most
constexpr int kLnStageBytes = 16 * 1024;   // staged bytes a tile at most, past one group round
constexpr int kLnBwdBlocks = 2;            // the backward's blocks an SM (at most 128 registers)
constexpr int kLnMaxSmem = 227 * 1024;
constexpr int kLnElems = 24;               // values of a pixel a thread holds at most

// The launch's plan, made by the host (ln_make_plan).
struct LnPlan {
  long long tiles;  // tiles of the call
  int tile;         // pixels a tile
  int stages;       // tiles in flight a block
  int stage_bytes;  // bytes of one staged tile of one tensor, whole 16-byte pieces
  int tpp;          // threads a pixel: a power of two, 1..kLnThreads
  int vec;          // the pixel is whole 16-byte pieces (else element by element)
  int rowwise;      // the row path: a block a pixel from device memory (no tile, no stage)
  int smem;         // dynamic shared memory a block
};

struct LnArgs {
  const void* x;     // (rows, C) T
  const void* g;     // (rows, C) T: the backward's upstream gradient
  const float* w;    // (C,)
  const float* b;    // (C,)
  void* y;           // (rows, C) T: y, or the backward's dx
  float* partial;    // the backward's (gridDim.x, 2 C) column sums a block
  float* scratch;    // the row path's (gridDim.x, C) g' w a block
  long long rows;
  int C, act;
  float eps;
  int aligned;       // bit 0: x (and g) 16-byte aligned, bit 1: y
  LnPlan plan;
};

// Byte offsets of a block's dynamic shared memory: the stages' barriers,
// the group sums of groups wider than a warp, w, b, then the staged tiles
// (each stage `arrays` tiles: x, and g for the backward), whose room the
// backward's column sums take after the last tile.
struct LnLayout {
  int bar, red, w, b, stage, total;
};

__host__ __device__ inline LnLayout ln_layout(int C, int stages, int stage_bytes, int arrays) {
  LnLayout l{};
  int off = 0;
  l.bar = off, off += 32;
  l.red = off, off += kLnWarps * 4;
  l.w = off, off = stage_align(off + C * 4);
  l.b = off, off = stage_align(off + C * 4);
  l.stage = off;
  off += max(stages * arrays * stage_bytes, arrays == 2 ? 2 * C * 4 : 0);
  l.total = off;
  return l;
}

// An asynchronous-proxy fence: the generic accesses to a stage before it
// are ordered before the bulk copy that refills it.
__device__ __forceinline__ void ln_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// PE consecutive staged values, widened to float32 (a 16-byte piece, or
// one element)
template <int PE>
__device__ __forceinline__ void ln_load(const float* p, float* v) {
  if constexpr (PE == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = *p;
  }
}
template <int PE>
__device__ __forceinline__ void ln_load(const __nv_bfloat16* p, float* v) {
  if constexpr (PE == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[2 * i] = __uint_as_float(u[i] << 16), v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ unsigned ln_pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// PE values to device memory in T: one 16-byte store where `vec`, else
// element by element
template <int PE>
__device__ __forceinline__ void ln_store(float* p, const float* v, bool vec) {
  if constexpr (PE == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < PE; ++e) p[e] = v[e];
}
template <int PE>
__device__ __forceinline__ void ln_store(__nv_bfloat16* p, const float* v, bool vec) {
  if constexpr (PE == 8) {
    if (vec) {
      uint4 q;
      q.x = ln_pack2(v[0], v[1]), q.y = ln_pack2(v[2], v[3]);
      q.z = ln_pack2(v[4], v[5]), q.w = ln_pack2(v[6], v[7]);
      *reinterpret_cast<uint4*>(p) = q;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < PE; ++e) p[e] = __float2bfloat16(v[e]);
}

// The sum over a pixel's tpp threads, the same bits in each of them (the
// loop bound is the same for the whole block); groups wider than a warp add
// their warps' sums in `red`, in warp order.
__device__ __forceinline__ float ln_group_sum(float v, int tpp, float* red) {
  for (int off = min(tpp, 32) >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tpp <= 32) return v;
  __syncthreads();  // the last sum's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int w0 = static_cast<int>(threadIdx.x) / tpp * (tpp >> 5);
  float s = 0.f;
  for (int i = 0; i < (tpp >> 5); ++i) s += red[w0 + i];
  return s;
}

// d/dz of 0.5 z (1 + erf(z / sqrt 2)): Phi(z) + z phi(z)
__device__ __forceinline__ float gelu_erf_grad(float z) {
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * 0.39894228040143268f * expf(-0.5f * z * z);
}

// The walk over a block's tiles shared by both kernels: tile i of the block
// (blockIdx.x + i gridDim.x) in stage i % stages; `consume(t, rn, xs, gs)`
// serves tile t of rn pixels, x staged at xs (and g at gs).  Thread 0 keeps `stages` bulk copies
// in flight; a tile the bulk copy cannot take is staged element by element
// when its turn comes.
template <typename T, int ARRAYS, class Consume>
__device__ __forceinline__ void ln_walk(const LnArgs& a, char* base, const LnLayout& lay,
                                        const Consume& consume) {
  const LnPlan& pl = a.plan;
  constexpr int ES = sizeof(T);
  const int C = a.C;
  auto* bar = reinterpret_cast<unsigned long long*>(base + lay.bar);
  const T* src[2] = {static_cast<const T*>(a.x), static_cast<const T*>(a.g)};
  auto pixels = [&](long long t) {
    return static_cast<int>(min(static_cast<long long>(pl.tile), a.rows - t * pl.tile));
  };
  auto bulk = [&](long long t) {
    return (a.aligned & 1) && static_cast<long long>(pixels(t)) * C * ES % 16 == 0;
  };
  auto stage = [&](int s, int k) {
    return reinterpret_cast<T*>(base + lay.stage + (s * ARRAYS + k) * pl.stage_bytes);
  };
  auto issue = [&](int i) {  // thread 0: the block's i-th tile by the bulk copy engine
    const long long t = blockIdx.x + static_cast<long long>(i) * gridDim.x;
    if (t >= pl.tiles || !bulk(t)) return;
    const int s = i % pl.stages;
    ln_fence_async();
    for (int k = 0; k < ARRAYS; ++k)
      stage_bulk_copy(stage(s, k), src[k] + t * pl.tile * C, pixels(t) * C * ES, &bar[s]);
    stage_bar_arrive(&bar[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) stage_bar_init(&bar[s], 1);
    for (int i = 0; i < pl.stages; ++i) issue(i);
  }
  __syncthreads();  // the barriers are initialised, w and b staged
  unsigned parity = 0;  // bit s: the phase of stage s's next wait
  for (int i = 0;; ++i) {
    const long long t = blockIdx.x + static_cast<long long>(i) * gridDim.x;
    if (t >= pl.tiles) break;
    const int s = i % pl.stages, rn = pixels(t);
    if (bulk(t)) {
      stage_bar_wait(&bar[s], (parity >> s) & 1);
      parity ^= 1u << s;
    } else {
      for (int k = 0; k < ARRAYS; ++k)
        stage_rows(stage(s, k), 1, rn * C, rn * C, false,
                   [&](int) { return src[k] + t * pl.tile * C; });
      __syncthreads();
    }
    consume(t, rn, stage(s, 0), stage(s, ARRAYS - 1));
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0) issue(i + pl.stages);
  }
}

// Kernels 19 and 20: y = act((x - mean) rstd w + b) for each pixel.  PE:
// elements a piece (16 bytes, or 1); Q: pieces a thread holds at most.
template <typename T, int PE, int Q>
__global__ void __launch_bounds__(kLnThreads) ln_fwd_kernel(LnArgs a) {
  extern __shared__ __align__(16) float ln_smem[];
  const LnPlan& pl = a.plan;
  const int C = a.C, tpp = pl.tpp, np = C / PE;
  const int gl = threadIdx.x % tpp, grp = threadIdx.x / tpp, ngrp = kLnThreads / tpp;
  char* base = reinterpret_cast<char*>(ln_smem);
  const LnLayout lay = ln_layout(C, pl.stages, pl.stage_bytes, 1);
  float* red = reinterpret_cast<float*>(base + lay.red);
  float* w_s = reinterpret_cast<float*>(base + lay.w);
  float* b_s = reinterpret_cast<float*>(base + lay.b);
  for (int c = threadIdx.x; c < C; c += kLnThreads) w_s[c] = a.w[c], b_s[c] = a.b[c];
  const bool vec_y = (a.aligned & 2) && PE > 1;
  ln_walk<T, 1>(a, base, lay, [&](long long t, int rn, const T* xs, const T*) {
    T* yt = static_cast<T*>(a.y) + t * pl.tile * C;
    // a group a pixel; the trip count is the block's (invalid groups
    // repeat the last pixel and store nothing)
    for (int p0 = 0; p0 < rn; p0 += ngrp) {
      const bool valid = p0 + grp < rn;
      const int pix = valid ? p0 + grp : rn - 1;
      float v[Q][PE];
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int pc = gl + q * tpp;
        if (pc < np) {
          ln_load<PE>(xs + pix * C + pc * PE, v[q]);
#pragma unroll
          for (int e = 0; e < PE; ++e) sum += v[q][e];
        }
      }
      const float mu = ln_group_sum(sum, tpp, red) / C;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (gl + q * tpp < np)
#pragma unroll
          for (int e = 0; e < PE; ++e) {
            const float d = v[q][e] - mu;
            var = fmaf(d, d, var);
          }
      const float rstd = rsqrtf(ln_group_sum(var, tpp, red) / C + a.eps);
      if (!valid) continue;  // no group sum below
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int pc = gl + q * tpp;
        if (pc < np) {
          float o[PE];
#pragma unroll
          for (int e = 0; e < PE; ++e) {
            const int c = pc * PE + e;
            const float z = fmaf((v[q][e] - mu) * rstd, w_s[c], b_s[c]);
            o[e] = a.act ? gelu_erf(z) : z;
          }
          ln_store<PE>(yt + static_cast<long long>(pix) * C + pc * PE, o, vec_y);
        }
      }
    }
  });
}

// Kernel 21, first launch: dx = (g' w - m1 - xhat m2) rstd with g' = g
// gelu'(z) (or g), m1 = mean(g' w), m2 = mean(g' w xhat) for each pixel;
// each thread's sums of g' xhat and g' over its channels, added across the
// block in a fixed order into partial[blockIdx.x] (dscale, then dbias).
template <typename T, int PE, int Q>
__global__ void __launch_bounds__(kLnThreads, kLnBwdBlocks) ln_bwd_kernel(LnArgs a) {
  extern __shared__ __align__(16) float ln_smem[];
  const LnPlan& pl = a.plan;
  const int C = a.C, tpp = pl.tpp, np = C / PE;
  const int lane = threadIdx.x & 31;
  const int gl = threadIdx.x % tpp, grp = threadIdx.x / tpp, ngrp = kLnThreads / tpp;
  char* base = reinterpret_cast<char*>(ln_smem);
  const LnLayout lay = ln_layout(C, pl.stages, pl.stage_bytes, 2);
  float* red = reinterpret_cast<float*>(base + lay.red);
  float* w_s = reinterpret_cast<float*>(base + lay.w);
  float* b_s = reinterpret_cast<float*>(base + lay.b);
  for (int c = threadIdx.x; c < C; c += kLnThreads) w_s[c] = a.w[c], b_s[c] = a.b[c];
  const bool vec_y = (a.aligned & 2) && PE > 1;
  float ds[Q][PE], db[Q][PE];  // this thread's channels' sums of g' xhat and g'
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int e = 0; e < PE; ++e) ds[q][e] = 0.f, db[q][e] = 0.f;
  ln_walk<T, 2>(a, base, lay, [&](long long t, int rn, const T* xs, const T* gs) {
    T* dxt = static_cast<T*>(a.y) + t * pl.tile * C;
    for (int p0 = 0; p0 < rn; p0 += ngrp) {
      const bool valid = p0 + grp < rn;
      const int pix = valid ? p0 + grp : rn - 1;
      float xv[Q][PE], gv[Q][PE];  // then xhat and g'
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int pc = gl + q * tpp;
        if (pc < np) {
          ln_load<PE>(xs + pix * C + pc * PE, xv[q]);
          ln_load<PE>(gs + pix * C + pc * PE, gv[q]);
#pragma unroll
          for (int e = 0; e < PE; ++e) sum += xv[q][e];
        }
      }
      const float mu = ln_group_sum(sum, tpp, red) / C;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (gl + q * tpp < np)
#pragma unroll
          for (int e = 0; e < PE; ++e) {
            const float d = xv[q][e] - mu;
            var = fmaf(d, d, var);
          }
      const float rstd = rsqrtf(ln_group_sum(var, tpp, red) / C + a.eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int pc = gl + q * tpp;
        if (pc < np)
#pragma unroll
          for (int e = 0; e < PE; ++e) {
            const int c = pc * PE + e;
            const float xh = (xv[q][e] - mu) * rstd;
            float gp = gv[q][e];
            if (a.act) gp *= gelu_erf_grad(fmaf(xh, w_s[c], b_s[c]));
            const float gg = gp * w_s[c];
            xv[q][e] = xh, gv[q][e] = gp;
            s1 += gg;
            s2 = fmaf(gg, xh, s2);
            if (valid) ds[q][e] = fmaf(gp, xh, ds[q][e]), db[q][e] += gp;
          }
      }
      const float m1 = ln_group_sum(s1, tpp, red) / C;
      const float m2 = ln_group_sum(s2, tpp, red) / C;
      if (!valid) continue;  // no group sum below
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int pc = gl + q * tpp;
        if (pc < np) {
          float o[PE];
#pragma unroll
          for (int e = 0; e < PE; ++e)
            o[e] = (gv[q][e] * w_s[pc * PE + e] - m1 - xv[q][e] * m2) * rstd;
          ln_store<PE>(dxt + static_cast<long long>(pix) * C + pc * PE, o, vec_y);
        }
      }
    }
  });
  // The block's column sums in a fixed order: the groups of a warp hold the
  // same channels (a butterfly across them), then row by row into acc (a
  // warp a row; a group a row where groups span warps), in the room of the
  // stages, whose last tile has been read.
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int e = 0; e < PE; ++e)
      for (int off = tpp; off < 32; off <<= 1) {
        ds[q][e] += __shfl_xor_sync(0xffffffffu, ds[q][e], off);
        db[q][e] += __shfl_xor_sync(0xffffffffu, db[q][e], off);
      }
  const bool rep = tpp >= 32 || lane < tpp;
  const int row = tpp >= 32 ? grp : threadIdx.x / 32, nrows = tpp >= 32 ? ngrp : kLnWarps;
  float* acc = reinterpret_cast<float*>(base + lay.stage);  // (2, C)
  for (int r = 0; r < nrows; ++r) {
    if (rep && row == r)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int pc = gl + q * tpp;
        if (pc < np)
#pragma unroll
          for (int e = 0; e < PE; ++e) {
            const int c = pc * PE + e;
            acc[c] = (r ? acc[c] : 0.f) + ds[q][e];
            acc[C + c] = (r ? acc[C + c] : 0.f) + db[q][e];
          }
      }
    __syncthreads();
  }
  float* out = a.partial + static_cast<long long>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += kLnThreads) out[c] = acc[c];
}

// Kernel 21, second launch: dsb[c] = sum_j partial[j][c] over the n
// blocks' rows; a block per 32 columns, eight rows of the partials at a
// time, each column's eight running sums added in order.
__global__ void __launch_bounds__(kLnThreads) ln_col_sum_kernel(const float* __restrict__ partial,
                                                                float* __restrict__ dsb, int n,
                                                                int cols) {
  __shared__ float s[kLnWarps][32];
  const int c = blockIdx.x * 32 + (threadIdx.x & 31), k = threadIdx.x >> 5;
  float v = 0.f;
  if (c < cols)
    for (int j = k; j < n; j += kLnWarps) v += partial[static_cast<long long>(j) * cols + c];
  s[k][threadIdx.x & 31] = v;
  __syncthreads();
  if (k == 0 && c < cols) {
    float t = 0.f;
    for (int i = 0; i < kLnWarps; ++i) t += s[i][threadIdx.x];
    dsb[c] = t;
  }
}

// The row path's forward: kernels 19 and 20 for a pixel the staged plan
// cannot take.  A block a pixel, the block's pixels in turn; the mean, the
// centred variance and y each a pass over the pixel in device memory.
template <typename T>
__global__ void __launch_bounds__(kLnThreads) ln_fwd_rows_kernel(LnArgs a) {
  __shared__ float red[kLnWarps];
  const int C = a.C;
  for (long long r = blockIdx.x; r < a.rows; r += gridDim.x) {
    const T* x = static_cast<const T*>(a.x) + r * C;
    T* y = static_cast<T*>(a.y) + r * C;
    float sum = 0.f, var = 0.f;
    for (int c = threadIdx.x; c < C; c += kLnThreads) sum += to_f32(x[c]);
    const float mu = ln_group_sum(sum, kLnThreads, red) / C;
    for (int c = threadIdx.x; c < C; c += kLnThreads) {
      const float d = to_f32(x[c]) - mu;
      var = fmaf(d, d, var);
    }
    const float rstd = rsqrtf(ln_group_sum(var, kLnThreads, red) / C + a.eps);
    for (int c = threadIdx.x; c < C; c += kLnThreads) {
      const float z = fmaf((to_f32(x[c]) - mu) * rstd, a.w[c], a.b[c]);
      y[c] = from_f32<T>(a.act ? gelu_erf(z) : z);
    }
  }
}

// The row path's backward, kernel 21's first launch: a block a pixel as
// the forward; g' w goes to the block's row of scratch, read back for dx,
// so that the GELU's derivative is taken once an element; channel c's sums
// of g' xhat and g' are added by thread c % kLnThreads in the block's
// partial row, pixel by pixel.
template <typename T>
__global__ void __launch_bounds__(kLnThreads) ln_bwd_rows_kernel(LnArgs a) {
  __shared__ float red[kLnWarps];
  const int C = a.C;
  float* out = a.partial + static_cast<long long>(blockIdx.x) * 2 * C;
  float* gw = a.scratch + static_cast<long long>(blockIdx.x) * C;
  for (int c = threadIdx.x; c < C; c += kLnThreads) out[c] = 0.f, out[C + c] = 0.f;
  for (long long r = blockIdx.x; r < a.rows; r += gridDim.x) {
    const T* x = static_cast<const T*>(a.x) + r * C;
    const T* g = static_cast<const T*>(a.g) + r * C;
    T* dx = static_cast<T*>(a.y) + r * C;
    float sum = 0.f, var = 0.f, s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < C; c += kLnThreads) sum += to_f32(x[c]);
    const float mu = ln_group_sum(sum, kLnThreads, red) / C;
    for (int c = threadIdx.x; c < C; c += kLnThreads) {
      const float d = to_f32(x[c]) - mu;
      var = fmaf(d, d, var);
    }
    const float rstd = rsqrtf(ln_group_sum(var, kLnThreads, red) / C + a.eps);
    for (int c = threadIdx.x; c < C; c += kLnThreads) {
      const float xh = (to_f32(x[c]) - mu) * rstd;
      float gp = to_f32(g[c]);
      if (a.act) gp *= gelu_erf_grad(fmaf(xh, a.w[c], a.b[c]));
      const float gg = gp * a.w[c];
      gw[c] = gg;
      s1 += gg;
      s2 = fmaf(gg, xh, s2);
      out[c] = fmaf(gp, xh, out[c]);
      out[C + c] += gp;
    }
    const float m1 = ln_group_sum(s1, kLnThreads, red) / C;
    const float m2 = ln_group_sum(s2, kLnThreads, red) / C;
    for (int c = threadIdx.x; c < C; c += kLnThreads) {
      const float xh = (to_f32(x[c]) - mu) * rstd;
      dx[c] = from_f32<T>((gw[c] - m1 - xh * m2) * rstd);
    }
  }
}

using LnKernel = void (*)(LnArgs);

// The kernel of a plan: forward or backward; the row path, or the staged
// one by 16-byte pieces or by elements
template <typename T>
LnKernel ln_kernel(bool backward, const LnPlan& pl) {
  constexpr int PV = 16 / sizeof(T);
  if (pl.rowwise) return backward ? ln_bwd_rows_kernel<T> : ln_fwd_rows_kernel<T>;
  if (!pl.vec)
    return backward ? ln_bwd_kernel<T, 1, kLnElems> : ln_fwd_kernel<T, 1, kLnElems>;
  return backward ? ln_bwd_kernel<T, PV, kLnElems / PV> : ln_fwd_kernel<T, PV, kLnElems / PV>;
}

inline int gcd16(long long v) {
  int g = 16;
  while (v % g) g >>= 1;
  return g;
}

// The plan of a call: the fewest threads a pixel with at most kLnElems
// values a thread, tiles of whole rounds of the block's groups (as many as
// kLnStageBytes holds, one at least) and whole 16-byte runs, three stages
// where they fit; the row path where no group holds a pixel or no stage
// fits.
cudaError_t ln_make_plan(long long rows, int C, int esize, bool backward, LnPlan* pl) {
  if (rows < 1 || C < 1) return cudaErrorInvalidValue;
  const int arrays = backward ? 2 : 1;
  pl->vec = C * esize % 16 == 0;
  const int pe = pl->vec ? 16 / esize : 1, np = C / pe;
  int tpp = 1;
  while (tpp < kLnThreads && ceil_div(np, tpp) * pe > kLnElems) tpp <<= 1;
  pl->tpp = tpp;
  pl->rowwise = ceil_div(np, tpp) * pe > kLnElems;
  pl->stages = 0;
  if (!pl->rowwise) {
    // a tile of whole group rounds and whole 16-byte pieces (a multiple of
    // m pixels)
    const long long pix = static_cast<long long>(C) * esize, round = kLnThreads / tpp;
    const long long m = 16 / gcd16(pix);
    long long tile = round * max(1LL, kLnStageBytes / (arrays * round * pix));
    tile = (tile + m - 1) / m * m;
    tile = min(tile, (rows + m - 1) / m * m);
    pl->tile = static_cast<int>(tile);
    pl->stage_bytes = stage_align(static_cast<int>(tile * pix));
    pl->tiles = (rows + tile - 1) / tile;
    for (pl->stages = kLnStages; pl->stages > 0; --pl->stages) {
      pl->smem = ln_layout(C, pl->stages, pl->stage_bytes, arrays).total;
      if (pl->smem <= kLnMaxSmem) break;
    }
  }
  if (pl->stages == 0) {
    pl->rowwise = 1;
    pl->tpp = kLnThreads;
    pl->tile = 1, pl->tiles = rows;
    pl->stage_bytes = 0, pl->smem = 0;
  }
  return cudaSuccess;
}

// Blocks of a plan's grid: the kernel's resident blocks on the card (the
// occupancy of each kernel and shared-memory size asked once), at most one
// a tile.
cudaError_t ln_grid(LnKernel kernel, const LnPlan& pl, int* grid) {
  struct Entry {
    LnKernel kernel;
    int smem, dev, blocks;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  for (int i = 0; i < used && !blocks; ++i)
    if (cache[i].kernel == kernel && cache[i].smem == pl.smem && cache[i].dev == dev)
      blocks = cache[i].blocks;
  if (!blocks) {
    // the attribute is set, and the occupancy asked, outside any stream
    // capture: a wrapper's first call of a shape comes before a capture.
    // The row path takes no dynamic shared memory (and its static array
    // leaves less than kLnMaxSmem to ask for).
    int per_sm = 0, sms = 0;
    if (pl.smem > 0)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLnMaxSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLnThreads, pl.smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidValue;
    blocks = per_sm * sms;
    if (used < 64) cache[used++] = Entry{kernel, pl.smem, dev, blocks};
  }
  *grid = static_cast<int>(min(pl.tiles, static_cast<long long>(blocks)));
  return cudaSuccess;
}

cudaError_t ln_prepare(LnArgs& a, int dtype, bool backward, LnKernel* kernel, int* grid) {
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  cudaError_t err = ln_make_plan(a.rows, a.C, dtype == kBF16 ? 2 : 4, backward, &a.plan);
  if (err != cudaSuccess) return err;
  *kernel = dtype == kF32 ? ln_kernel<float>(backward, a.plan)
                          : ln_kernel<__nv_bfloat16>(backward, a.plan);
  return ln_grid(*kernel, a.plan, grid);
}

inline int ln_aligned(const void* x, const void* g, const void* y) {
  auto al = [](const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; };
  return (al(x) && (g == nullptr || al(g))) | al(y) << 1;
}

cudaError_t launch_ln_fwd(const void* x, const float* w, const float* b, void* y,
                          long long rows, int C, int act, float eps, int dtype, cudaStream_t s) {
  if (rows == 0 && C >= 1) return cudaSuccess;
  LnArgs a{x, nullptr, w, b, y, nullptr, nullptr, rows, C, act, eps, ln_aligned(x, nullptr, y),
           {}};
  LnKernel kernel;
  int grid;
  const cudaError_t err = ln_prepare(a, dtype, false, &kernel, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kLnThreads, a.plan.smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace xfm

using namespace xfm;

// Kernel 19.  x, y (rows, C) contiguous in the dtype; w, b (C,) float32.
extern "C" int xfm_ln_act(const void* x, const float* w, const float* b, void* y,
                          long long rows, int C, int act, float eps, int dtype, void* stream) {
  return launch_ln_fwd(x, w, b, y, rows, C, act, eps, dtype, static_cast<cudaStream_t>(stream));
}

// Kernel 20: kernel 19's function.
extern "C" int xfm_seg_ln_fwd(const void* x, const float* w, const float* b, void* y,
                              long long rows, int C, int act, float eps, int dtype,
                              void* stream) {
  return launch_ln_fwd(x, w, b, y, rows, C, act, eps, dtype, static_cast<cudaStream_t>(stream));
}

// The plan of a forward (backward 0) or backward call of rows x C in the
// dtype: out = tiles, pixels a tile, stages, bytes a staged tile, threads
// a pixel, 16-byte pieces (1) or elements (0), the row path (1), shared
// memory a block, blocks (the backward's partial rows).
extern "C" int xfm_ln_plan(long long rows, int C, int dtype, int backward, long long* out) {
  LnArgs a{};
  a.rows = rows, a.C = C;
  LnKernel kernel;
  int grid = 0;
  const cudaError_t err = ln_prepare(a, dtype, backward, &kernel, &grid);
  if (err != cudaSuccess) return err;
  const LnPlan& p = a.plan;
  const long long v[] = {p.tiles, p.tile, p.stages, p.stage_bytes, p.tpp, p.vec, p.rowwise,
                         p.smem, grid};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return cudaSuccess;
}

// Kernel 21: partial holds `capacity` rows of 2 C float32 column sums,
// then `capacity` rows of C for the row path's scratch; the grid takes at
// most `capacity` blocks (a block a row).  dsb (2, C) float32 (dscale,
// dbias); dx in the dtype.  Two launches.
extern "C" int xfm_seg_ln_bwd(const void* x, const void* g, const float* w, const float* b,
                              void* dx, float* partial, float* dsb, long long rows, int C,
                              int capacity, int act, float eps, int dtype, void* stream) {
  if (capacity < 1) return cudaErrorInvalidValue;
  LnArgs a{x, g, w, b, dx, partial, partial + 2LL * capacity * C, rows, C, act, eps,
           ln_aligned(x, g, dx), {}};
  LnKernel kernel;
  int grid;
  cudaError_t err = ln_prepare(a, dtype, true, &kernel, &grid);
  if (err != cudaSuccess) return err;
  grid = min(grid, capacity);
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kLnThreads, a.plan.smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_col_sum_kernel<<<ceil_div(2 * C, 32), kLnThreads, 0, s>>>(partial, dsb, grid, 2 * C);
  return cudaGetLastError();
}
