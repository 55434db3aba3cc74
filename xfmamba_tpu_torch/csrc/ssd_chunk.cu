// Kernels 15 and 16: the chunked SSD (Mamba-2 state-space duality) scan
// and its adjoint, chunk-parallel, with the products on the tensor cores.
//
// Replaces xfmamba_tpu/ops/ssd_pallas.py::_ssd_kernel (:74; pallas_call
// :211 for inference, :337 with the chunk checkpoints for training) and
// ::_ssd_bwd_kernel (:356, pallas_call :581).  Layout (group-major): x and
// y (b, g, L, R, P), dt (b, g, L, R), B and C (b, g, L, N); head
// h = k * R + r of group k reads B[b, k] and C[b, k].  Per head and chunk
// j of c = 64 positions (rows past L: dt 0, so decay 1 and no
// contribution):
//   dt  = softplus20(dt_raw + bias_h),  cum = inclusive cumsum of A_h dt,
//   w   = cum[c - 1]
//   M   = (C_j B_j^T) * exp(cum_i - cum_l) [i >= l]
//   y_j = M (dt x) + exp(cum) (C_j s_j) + D_h x
//   s_{j+1} = exp(w_j) s_j + B_j^T ((dt x) exp(w_j - cum))
// with s_0 the initial state (or zeros) and s_j (N x P per head) the state
// entering chunk j.
//
// Design: the serial chunk walk (ssd_serial.cu) is cut into three
// launches, so every chunk runs in parallel except a pass that only moves
// bytes (Mamba-2's chunk state / state passing / chunk scan):
//   (a) ssd_state_kernel, a block per (image, group, chunk, tile of heads):
//       each head's chunk-local end state B_j^T ((dt x) exp(w_j - cum))
//       into the states array and exp(w_j) into a float32 decay array;
//   (b) ssd_pass_kernel, a thread per (image, head, state element), serial
//       over chunks: s_{j+1} = exp(w_j) s_j + local_j in place, so the
//       array ends holding the state entering each chunk (the training
//       checkpoints), and the final state goes to fin;
//   (c) ssd_scan_kernel, a block per (image, group, chunk, tile of heads):
//       C_j B_j^T once for the tile's heads, then per head M, y.
// The adjoint runs the same three steps backwards: (a) per chunk
// Q_j = C_j^T (exp(cum) dy) (the same kernel), (b) in reverse,
// ds_out[j - 1] = exp(w_j) ds_out[j] + Q_j from ds_out[n - 1] = dfin (the
// adjoint entering chunk 0 is dinit), (c) ssd_grad_kernel, per (image,
// group, chunk, tile of heads), from the checkpoint s_j and ds_out[j]:
// every product of the Pallas adjoint (dM = dy (dt x)^T, M^T dy, B ds,
// C s, the dC and dB terms of the read-out and the update, dCB B and
// dCB^T C), the cumsum adjoint and the softplus derivative.
//
// Every product runs on mma.sync (mma.cuh::mma_tiles): m16n8k16 on
// bfloat16 operands when x, B and C are bfloat16 (the MXU's native pass,
// which the Pallas kernel's data products use), and three m16n8k8 TF32
// products per step (split operands, float32-grade sums) when they are
// float32.  Operands are staged in shared memory in float32, rows padded by
// 4 floats (float32 rows by 16-byte cp.async, bfloat16 rows by 16-byte
// loads); the A fragment of each k step serves all the column tiles of P,
// and products with a triangular factor skip the k range that is zero.
// Kernels (a) and (c) stage every head of their tile at once, one warp
// scanning each head's cumsum, then each warp takes (head, 16 rows) units;
// (c) builds M = C B^T exp2(c2_i - c2_l) in the A fragment.  The adjoint's
// heads run in turn, the next head's operands loading into a second
// buffer (and its dt and cumsum done in the current head's slack) while
// the current one computes, three barriers a head; dB and dC of the chunk
// (summed over the heads, then the C B^T terms) stay in registers, dCB in
// shared memory; a block that owns every head of its group writes its dB
// and dC rows directly, otherwise they go by atomics, as do the per-block
// sums of dA, dbias and dD.  Exponents are always of differences
// (cum_i - cum_l, w - cum, taken as exp2 of log2(e)-scaled cumsums), never
// products of exp(cum) terms, which would overflow once decays grow; they
// stay in float32.
//
// What bounds it on the H100: by ssd_work's count (chip_smoke.py), the
// bytes of x, dt, B, C and y (0.86 ms per vmamba_small_m2 bs-32 float32
// forward at 3.35 TB/s) over the products at the TF32 rate.  The
// decomposition adds the per-chunk states, written in (a), read and
// written in (b) and read in (c): about 4.5 GB per bs-32 float32 forward.
// What holds the kernels back, measured: per block, the operand loads and
// the per-element work around each mma (operand loads from shared memory,
// exp2 of the decay, the TF32 split), at one or two blocks per SM; bf16
// products run little faster than 3xTF32 ones (chip_smoke.py phase 9).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace xfm {
namespace ssd {

constexpr int kC = 64;          // positions per chunk
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 8;     // heads per block
constexpr int kMaxP = 32;       // head width
constexpr int kPad = 4;         // floats of padding per shared row
constexpr int kLdc = kC + kPad;
constexpr size_t kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kC == 64 && kThreads == 256, "the tilings assume 64-row chunks and 8 warps");

struct Params {
  const void* x;      // (b, g, L, R, P) (or dy, float32, in the adjoint's state kernel)
  const void* dt;     // (b, g, L, R), before bias and softplus
  const void* Bm;     // (b, g, L, N)
  const void* Cm;     // (b, g, L, N)
  const float* A;     // (g * R,)
  const float* bias;  // (g * R,) or null
  const float* Dm;    // (g * R, P) or null
  const float* dy;    // (b, g, L, R, P)
  const float* ck;    // (b, g * R, nc, N, P): the state entering each chunk
  float* st;          // (b, g * R, nc, N, P): see each kernel
  float* decay;       // (b, g * R, nc): exp(w) of each chunk
  void* y;            // (b, g, L, R, P), x's dtype
  float* dx;          // (b, g, L, R, P)
  float* ddt;         // (b, g, L, R): gradient of the raw dt
  float* dB;          // (b, g, L, N), zeroed by the caller
  float* dC;          // (b, g, L, N), zeroed by the caller
  float* dA;          // (g * R,), accumulated
  float* dbias;       // (g * R,), accumulated
  float* dD;          // (g * R, P), accumulated
  int L, g, R, P, N, nc, tile;
};

// the products' precision for operands of type T
template <typename T>
constexpr Prec kPrec = std::is_same<T, float>::value ? Prec::kTF32x3 : Prec::kBF16;

// Rows [0, rows) of a slice whose row i starts at src + i * stride, the
// first cols elements of each, into dst (row stride ld) as float32, zero
// from row cnt on.  Float32 rows whose 16-byte pieces are aligned go by
// cp.async (the caller commits and waits); aligned bfloat16 rows by 16-byte
// loads of 8 values, kU of them in flight per thread; others element by
// element, also kU in flight.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long stride,
                                          int rows, int cnt, int cols) {
  constexpr int kU = 4;
  if constexpr (std::is_same<T, float>::value) {
    if (cols % 4 == 0 && stride % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int per = cols / 4;
      for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
        const int i = e / per, q = (e - i * per) * 4;
        cp_async16(dst + i * ld + q, i < cnt ? src + i * stride + q : src, i < cnt ? 16 : 0);
      }
      return;
    }
  } else {
    if (cols % 8 == 0 && stride % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int per = cols / 8, total = rows * per;
      for (int e0 = threadIdx.x; e0 < total; e0 += kU * blockDim.x) {
        uint4 v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = e0 + u * blockDim.x, i = e / per, q = (e - i * per) * 8;
          v[u] = e < total && i < cnt ? *reinterpret_cast<const uint4*>(src + i * stride + q)
                                      : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = e0 + u * blockDim.x, i = e / per, q = (e - i * per) * 8;
          if (e < total) {
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
            const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
            const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
            float4* o = reinterpret_cast<float4*>(dst + i * ld + q);
            o[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
            o[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
          }
        }
      }
      return;
    }
  }
  const int total = rows * cols;
  for (int e0 = threadIdx.x; e0 < total; e0 += kU * blockDim.x) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * blockDim.x, i = e / cols, q = e - i * cols;
      v[u] = e < total && i < cnt ? to_f32(src[i * stride + q]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * blockDim.x, i = e / cols, q = e - i * cols;
      if (e < total) dst[i * ld + q] = v[u];
    }
  }
}

// A lane's two raw dt values of one head's chunk (rows 2 lane and
// 2 lane + 1, 0 from row cnt on); dt points at the chunk's first row of the
// head (row stride R).  Loaded apart from warp_cum so that a warp can issue
// them early and use them later.
template <typename T>
__device__ __forceinline__ float2 dt_pair(const T* dt, int cnt, int R) {
  const int i0 = 2 * (threadIdx.x & 31);
  return make_float2(i0 < cnt ? to_f32(dt[static_cast<long long>(i0) * R]) : 0.f,
                     i0 + 1 < cnt ? to_f32(dt[static_cast<long long>(i0 + 1) * R]) : 0.f);
}

// One head's chunk by one warp, from its raw dt (dt_pair): z = dt_raw +
// bias, dt (0 from row cnt on) and c2 = log2(e) x the inclusive cumsum of
// A dt, so that exp(cum_i - cum_l) = exp2(c2_i - c2_l); zs may be null.
__device__ __forceinline__ void warp_cum(float2 raw, int cnt, float a_h, float bias_h, float* zs,
                                         float* dts, float* c2) {
  const int lane = threadIdx.x & 31, i0 = 2 * lane, i1 = i0 + 1;
  const float z0 = raw.x + bias_h, z1 = raw.y + bias_h;
  const float d0 = i0 < cnt ? softplus20(z0) : 0.f, d1 = i1 < cnt ? softplus20(z1) : 0.f;
  const float w0 = d0 * a_h, w1 = d1 * a_h;
  float s = w0 + w1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  const float c0 = excl + w0, c1 = c0 + w1;
  if (zs) {
    zs[i0] = z0;
    zs[i1] = z1;
  }
  dts[i0] = d0;
  dts[i1] = d1;
  c2[i0] = c0 * kLog2e;
  c2[i1] = c1 * kLog2e;
}

// The tile's per-head parameters into shared memory: A, bias (0 where
// absent) and, when D is given, D's rows (tile x P).
__device__ __forceinline__ void stage_params(const float* A, const float* bias, const float* Dm,
                                             long long h0, int tile, int P, float* A_s,
                                             float* bias_s, float* D_s) {
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    A_s[e] = A[h0 + e];
    bias_s[e] = bias ? bias[h0 + e] : 0.f;
  }
  if (Dm && D_s)
    for (int e = threadIdx.x; e < tile * P; e += blockDim.x) D_s[e] = Dm[h0 * P + e];
}

// The block's (group k, first head r0, image b, chunk ci) from the grid
// (chunk, group x tile, image).
struct Where {
  int ci, k, r0, t0, cnt;
  long long bg;
  __device__ Where(const Params& p) {
    const int ntile = p.R / p.tile;
    ci = blockIdx.x;
    k = blockIdx.y / ntile;
    r0 = (blockIdx.y - k * ntile) * p.tile;
    bg = static_cast<long long>(blockIdx.z) * p.g + k;
    t0 = ci * kC;
    cnt = min(kC, p.L - t0);
  }
};

// One of the adjoint's two buffers of a head's chunk: z, dt and c2 (kC
// each), x and dy (kC x ldp), the checkpoint and the state adjoint
// (N x ldp).
struct HeadBuf {
  float *dts, *c2, *zs, *xs, *ys, *st, *ds;
};

// (a) ADJ false: st[h, j] = B_j^T ((dt x) exp(w - cum)); ADJ true (S is
// float, src dy): st[h, j] = C_j^T (exp(cum) dy).  Both: decay[h, j] =
// exp(w).  Every head of the tile is staged at once (a warp computes each
// head's cumsum); then each warp takes (head, 16 rows of N) units, the NT
// column tiles of P sharing one A fragment.
template <typename T, typename S, bool ADJ, int NT>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr Prec PR = kPrec<T>;
  const int N = p.N, P = p.P, R = p.R, ldn = N + kPad, ldp = P + kPad, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  float* Ms = smem;                      // kC x ldn: B (or C) of the chunk
  float* heads = Ms + kC * ldn;          // per head: src kC x ldp, weights, dt, c2
  const int per_head = kC * ldp + 3 * kC;
  const Where w(p);
  const T* mat = static_cast<const T*>(ADJ ? p.Cm : p.Bm) + (w.bg * p.L + w.t0) * N;
  load_rows(Ms, ldn, mat, N, kC, w.cnt, N);
  const S* src = static_cast<const S*>(ADJ ? static_cast<const void*>(p.dy) : p.x);
  const long long row0 = (w.bg * p.L + w.t0) * R + w.r0;  // (first position, first head)
  for (int hh = 0; hh < p.tile; ++hh)
    load_rows(heads + hh * per_head, ldp, src + (row0 + hh) * P, static_cast<long long>(R) * P,
              kC, w.cnt, P);
  cp_async_commit();
  if (warp < p.tile) {
    const int hh = warp, head = w.k * R + w.r0 + hh;
    float* ws = heads + hh * per_head + kC * ldp;
    float* dts = ws + kC;
    float* c2 = dts + kC;
    warp_cum(dt_pair(static_cast<const T*>(p.dt) + row0 + hh, w.cnt, R), w.cnt, p.A[head],
             p.bias ? p.bias[head] : 0.f, nullptr, dts, c2);
    __syncwarp();
    const float wt = c2[kC - 1];
    for (int i = lane; i < kC; i += 32) ws[i] = ADJ ? exp2f(c2[i]) : dts[i] * exp2f(wt - c2[i]);
    if (lane == 0) p.decay[(w.bg * R + w.r0 + hh) * p.nc + w.ci] = exp2f(wt);
  }
  cp_async_wait<0>();
  __syncthreads();
  const int nmb = (N + 15) / 16;
  for (int u = warp; u < p.tile * nmb; u += kWarps) {
    const int hh = u / nmb, m0 = (u - hh * nmb) * 16;
    const float* Ss = heads + hh * per_head;
    const float* ws = Ss + kC * ldp;
    float acc[NT][4] = {};
    mma_tiles<PR, NT>(
        acc, [&](int n, int i) { return Ms[i * ldn + n]; },
        [&](int i, int q) { return Ss[i * ldp + q] * ws[i]; }, m0, 0, N, P, 0, w.cnt);
    float* out = p.st + ((w.bg * R + w.r0 + hh) * p.nc + w.ci) * static_cast<long long>(N * P);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = tile_row(m0, e), q = tile_col(8 * j, e);
        if (n < N && q < P) out[n * P + q] = acc[j][e];
      }
  }
}

// (b) per (head, 4 elements): buf[h, j] <- the carry entering chunk j, then
// carry <- decay[h, j] carry + buf[h, j]; chunks in order, or in reverse.
// The carry starts from start (or zeros) and ends in fin.  Bytes only: each
// thread moves 16-byte vectors and keeps kU chunks' loads in flight.
__global__ void __launch_bounds__(kThreads) ssd_pass_kernel(float* buf, const float* decay,
                                                             const float* start, float* fin,
                                                             long long heads, int nc, int NP,
                                                             int reverse) {
  const long long e = 4 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  if (e >= heads * NP) return;
  const long long h = e / NP;
  float4* col = reinterpret_cast<float4*>(buf + h * nc * NP + (e - h * NP));
  const long long step = NP / 4;  // float4s from one chunk to the next
  const float* dec = decay + h * nc;
  float4 s = start ? *reinterpret_cast<const float4*>(start + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kU = 8;
  for (int j0 = 0; j0 < nc; j0 += kU) {
    float4 q[kU];
    float d[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = reverse ? nc - 1 - (j0 + u) : j0 + u;
      if (j0 + u < nc) {
        q[u] = col[j * step];
        d[u] = dec[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = reverse ? nc - 1 - (j0 + u) : j0 + u;
      if (j0 + u < nc) {
        col[j * step] = s;
        s = make_float4(fmaf(d[u], s.x, q[u].x), fmaf(d[u], s.y, q[u].y),
                        fmaf(d[u], s.z, q[u].z), fmaf(d[u], s.w, q[u].w));
      }
    }
  }
  *reinterpret_cast<float4*>(fin + e) = s;
}

// C B^T of the chunk (kC x kC, lower triangle; the tiles wholly above the
// diagonal are zeros) by WARPS warps (8 or 16): WARPS / 4 of them share
// each 16 rows, each taking 256 / WARPS columns.
template <Prec PR, int WARPS>
__device__ __forceinline__ void chunk_cb(const float* Cs, const float* Bs, int ldn, int N,
                                         float* CB) {
  constexpr int kPer = WARPS / 4, kNT = 32 / WARPS;
  const int warp = threadIdx.x / 32, m0 = (warp / kPer) * 16, n0 = (warp % kPer) * 8 * kNT;
  float acc[kNT][4] = {};
  if (n0 <= m0 + 15)
    mma_tiles<PR, kNT>(
        acc, [&](int i, int n) { return Cs[i * ldn + n]; },
        [&](int n, int j) { return Bs[j * ldn + n]; }, m0, n0, kC, kC, 0, N);
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) CB[tile_row(m0, e) * kLdc + tile_col(n0 + 8 * j, e)] = acc[j][e];
}

// (c) y of each head of the tile from the state entering its chunk (st).
// Every head is staged at once; then each warp takes (head, 16 rows)
// units: M (dt x) with M = C B^T exp2(c2_i - c2_l) built in the A
// fragment, and C s, over the NT column tiles of P.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr Prec PR = kPrec<T>;
  const int N = p.N, P = p.P, R = p.R, ldn = N + kPad, ldp = P + kPad, tid = threadIdx.x;
  const int warp = tid / 32;
  float* Bs = smem;
  float* Cs = Bs + kC * ldn;
  float* CB = Cs + kC * ldn;       // kC x kLdc
  float* D_s = CB + kC * kLdc;     // tile x P (D rows), then A, bias
  float* A_s = D_s + kMaxTile * kMaxP;
  float* bias_s = A_s + kMaxTile;
  float* heads = bias_s + kMaxTile;  // per head: x kC x ldp, s N x ldp, dt, c2
  const int per_head = kC * ldp + N * ldp + 2 * kC;
  const Where w(p);
  const long long rowBC = (w.bg * p.L + w.t0) * N;
  const long long row0 = (w.bg * p.L + w.t0) * R + w.r0;
  const long long NP = static_cast<long long>(N) * P;
  load_rows(Bs, ldn, static_cast<const T*>(p.Bm) + rowBC, N, kC, w.cnt, N);
  load_rows(Cs, ldn, static_cast<const T*>(p.Cm) + rowBC, N, kC, w.cnt, N);
  for (int hh = 0; hh < p.tile; ++hh) {
    float* xs = heads + hh * per_head;
    load_rows(xs, ldp, static_cast<const T*>(p.x) + (row0 + hh) * P,
              static_cast<long long>(R) * P, kC, w.cnt, P);
    load_rows(xs + kC * ldp, ldp, p.st + ((w.bg * R + w.r0 + hh) * p.nc + w.ci) * NP, P, N, N,
              P);
  }
  cp_async_commit();
  const long long h0 = static_cast<long long>(w.k) * R + w.r0;
  if (warp < p.tile) {
    float* dts = heads + warp * per_head + kC * ldp + N * ldp;
    warp_cum(dt_pair(static_cast<const T*>(p.dt) + row0 + warp, w.cnt, R), w.cnt,
             p.A[h0 + warp], p.bias ? p.bias[h0 + warp] : 0.f, nullptr, dts, dts + kC);
  }
  stage_params(p.A, p.bias, p.Dm, h0, p.tile, P, A_s, bias_s, D_s);
  cp_async_wait<0>();
  __syncthreads();
  chunk_cb<PR, kWarps>(Cs, Bs, ldn, N, CB);
  __syncthreads();
  T* y = static_cast<T*>(p.y);
  for (int u = warp; u < p.tile * 4; u += kWarps) {
    // the rows' triangular work is spread: warp w's units cycle through them
    const int hh = u / 4, m0 = ((u + u / 8) & 3) * 16;
    const float* xs = heads + hh * per_head;
    const float* sts = xs + kC * ldp;
    const float* dts = sts + N * ldp;
    const float* c2 = dts + kC;
    float a1[NT][4] = {}, a2[NT][4] = {};
    mma_tiles<PR, NT>(
        a1,
        [&](int i, int j) { return j <= i ? CB[i * kLdc + j] * exp2f(c2[i] - c2[j]) : 0.f; },
        [&](int j, int q) { return xs[j * ldp + q] * dts[j]; }, m0, 0, kC, P, 0,
        min(w.cnt, m0 + 16));
    mma_tiles<PR, NT>(
        a2, [&](int i, int n) { return Cs[i * ldn + n]; },
        [&](int n, int q) { return sts[n * ldp + q]; }, m0, 0, kC, P, 0, N);
    const float* Dh = p.Dm ? D_s + hh * P : nullptr;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = tile_row(m0, e), q = tile_col(8 * j, e);
        if (i < w.cnt && q < P) {
          const float v = fmaf(a2[j][e], exp2f(c2[i]), a1[j][e]) +
                          (Dh ? Dh[q] * xs[i * ldp + q] : 0.f);
          y[(row0 + hh + static_cast<long long>(i) * R) * P + q] = from_f32<T>(v);
        }
      }
  }
}

// (c) of the adjoint: every gradient of the chunk from the checkpoint
// ck[h, j] and the state adjoint st[h, j] (ds_out: the gradient of the
// state leaving chunk j), by kGradThreads threads (16 warps: the work per
// head is short chains of dependent steps, so the SM needs many warps).
// The heads of the tile run in turn, the next head's operands loading
// (cp.async, a second buffer) while the current one computes.  Per head,
// for 16 rows each, warps 0-3 take M^T dy, warps 4-7 B ds, warps 8-11 C s,
// warps 12-15 dM = dy (dt x)^T, whose dS = dM * M they reduce by rows and
// columns in registers and whose dM * E they add to dCB in shared memory
// (each warp its own rows); every warp adds its (16 x 16) tiles of the
// chunk's dC and dB in registers.  After the heads: dC += dCB B,
// dB += dCB^T C.
constexpr int kGradThreads = 512;
constexpr int kGradWarps = kGradThreads / 32;

template <typename T, int NT>
__global__ void __launch_bounds__(kGradThreads) ssd_grad_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr Prec PR = kPrec<T>;
  const int N = p.N, P = p.P, R = p.R, ldn = N + kPad, ldp = P + kPad, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  float* Bs = smem;
  float* Cs = Bs + kC * ldn;
  float* CB = Cs + kC * ldn;      // kC x kLdc each: C B^T, E of the head, dCB
  float* Es = CB + kC * kLdc;
  float* dCB = Es + kC * kLdc;
  float* bufs = dCB + kC * kLdc;  // two buffers: x, dy (kC x ldp), s, ds (N x ldp), z, dt, c2
  const int per_buf = 2 * kC * ldp + 2 * N * ldp + 3 * kC;
  float* dds = bufs + 2 * per_buf;  // kC x ldp each: M^T dy then d(dt x), B ds, C s
  float* dGs = dds + kC * ldp;
  float* cst = dGs + kC * ldp;
  float* ech = cst + kC * ldp;  // exp(cum)
  float* ewc = ech + kC;        // exp(w - cum)
  float* dch = ewc + kC;        // d cum
  float* ddta = dch + kC;       // rowsum(d(dt x) x)
  float* rsum = ddta + kC;      // rowsum(dS)
  float* csum = rsum + kC;      // colsum(dS)
  float* red = csum + kC;       // 32
  float* dA_s = red + 32;       // kMaxTile
  float* dbias_s = dA_s + kMaxTile;
  float* dD_s = dbias_s + kMaxTile;  // tile x P
  float* D_s = dD_s + kMaxTile * kMaxP;  // tile x P (D rows), then A, bias
  float* A_s = D_s + kMaxTile * kMaxP;
  float* bs_s = A_s + kMaxTile;
  auto buf = [&](int b) {
    float* base = bufs + b * per_buf;
    HeadBuf hb;
    hb.xs = base;
    hb.ys = hb.xs + kC * ldp;
    hb.st = hb.ys + kC * ldp;
    hb.ds = hb.st + N * ldp;
    hb.zs = hb.ds + N * ldp;
    hb.dts = hb.zs + kC;
    hb.c2 = hb.dts + kC;
    return hb;
  };
  const Where w(p);
  const long long rowBC = (w.bg * p.L + w.t0) * N;
  const long long row0 = (w.bg * p.L + w.t0) * R + w.r0;
  const long long NP = static_cast<long long>(N) * P;
  // head hh's operands into buffer hh & 1 (the caller commits)
  auto stage = [&](int hh) {
    const HeadBuf hb = buf(hh & 1);
    const long long hrow = w.bg * R + w.r0 + hh;
    load_rows(hb.xs, ldp, static_cast<const T*>(p.x) + (row0 + hh) * P,
              static_cast<long long>(R) * P, kC, w.cnt, P);
    load_rows(hb.ys, ldp, p.dy + (row0 + hh) * P, static_cast<long long>(R) * P, kC, w.cnt, P);
    load_rows(hb.st, ldp, p.ck + (hrow * p.nc + w.ci) * NP, P, N, N, P);
    load_rows(hb.ds, ldp, p.st + (hrow * p.nc + w.ci) * NP, P, N, N, P);
  };
  // the next head's cumsum: warp kCumWarp loads its raw dt early and scans late
  constexpr int kCumWarp = kGradWarps - 1;
  const long long h0 = static_cast<long long>(w.k) * R + w.r0;
  load_rows(Bs, ldn, static_cast<const T*>(p.Bm) + rowBC, N, kC, w.cnt, N);
  load_rows(Cs, ldn, static_cast<const T*>(p.Cm) + rowBC, N, kC, w.cnt, N);
  stage(0);
  cp_async_commit();
  if (warp == kCumWarp) {
    const HeadBuf hb = buf(0);
    warp_cum(dt_pair(static_cast<const T*>(p.dt) + row0, w.cnt, R), w.cnt, p.A[h0],
             p.bias ? p.bias[h0] : 0.f, hb.zs, hb.dts, hb.c2);
  }
  stage_params(p.A, p.bias, p.Dm, h0, p.tile, P, A_s, bs_s, D_s);
  for (int e = tid; e < kC * kLdc; e += kGradThreads) dCB[e] = 0.f;
  for (int e = tid; e < 2 * kMaxTile + p.tile * P; e += kGradThreads) dA_s[e] = 0.f;
  // a head's exp(cum), exp(w - cum) and E from its c2, and zeroed dS sums,
  // by the threads from t0 on (nt of them)
  auto prepare = [&](const float* c2, int t0, int nt) {
    const float wt2 = c2[kC - 1];
    for (int i = tid - t0; i < kC; i += nt) {
      ech[i] = exp2f(c2[i]);
      ewc[i] = exp2f(wt2 - c2[i]);
      rsum[i] = csum[i] = 0.f;
    }
    for (int e = tid - t0; e < kC * kC; e += nt) {
      const int i = e / kC, j = e - i * kC;
      Es[i * kLdc + j] = j <= i ? exp2f(c2[i] - c2[j]) : 0.f;
    }
  };
  cp_async_wait<0>();
  __syncthreads();
  chunk_cb<PR, kGradWarps>(Cs, Bs, ldn, N, CB);
  prepare(buf(0).c2, 0, kGradThreads);

  // this warp's tiles of the chunk's dC and dB: rows mc.., columns nc0 + 8 j
  const int mc = (warp / 4) * 16, nc0 = (warp % 4) * 16;
  float accC[2][4] = {}, accB[2][4] = {};
  const int role = warp / 4, m0 = (warp & 3) * 16;
  for (int hh = 0; hh < p.tile; ++hh) {
    const HeadBuf hb = buf(hh & 1);
    const float *xs = hb.xs, *dys = hb.ys, *sts = hb.st, *dss = hb.ds, *dts = hb.dts,
                *c2 = hb.c2;
    const bool next = hh + 1 < p.tile;
    // head hh is staged and prepared; head hh - 1 is done with every array
    __syncthreads();
    if (next) stage(hh + 1);
    cp_async_commit();
    float2 raw_next = make_float2(0.f, 0.f);
    if (next && warp == kCumWarp)
      raw_next = dt_pair(static_cast<const T*>(p.dt) + row0 + hh + 1, w.cnt, R);
    const float wt2 = c2[kC - 1];

    if (role < 3) {
      // M^T dy (M[i][l] = 0 for i < l), B ds or C s for rows m0..
      float acc[NT][4] = {};
      float* out = role == 0 ? dds : role == 1 ? dGs : cst;
      if (role == 0)
        mma_tiles<PR, NT>(
            acc, [&](int j, int i) { return CB[i * kLdc + j] * Es[i * kLdc + j]; },
            [&](int i, int q) { return dys[i * ldp + q]; }, m0, 0, kC, P, m0, w.cnt);
      else
        mma_tiles<PR, NT>(
            acc, [&](int j, int n) { return (role == 1 ? Bs : Cs)[j * ldn + n]; },
            [&](int n, int q) { return (role == 1 ? dss : sts)[n * ldp + q]; }, m0, 0, kC, P, 0,
            N);
#pragma unroll
      for (int jt = 0; jt < NT; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = tile_row(m0, e), q = tile_col(8 * jt, e);
          if (q < P) out[j * ldp + q] = acc[jt][e];
        }
    } else {
      // dM = dy (dt x)^T for rows m0.. (the columns right of the diagonal,
      // and the rows past cnt, which are zero-padded, come out multiplied
      // by a zero of E)
      float dm[8][4] = {};
      mma_tiles<PR, 8>(
          dm, [&](int i, int q) { return dys[i * ldp + q]; },
          [&](int q, int j) { return xs[j * ldp + q] * dts[j]; }, m0, 0, kC, kC, 0, P);
      // dCB += dM * E (this warp's rows); dS = dM * E * CB by rows and columns
      float r_lo = 0.f, r_hi = 0.f;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        float c_lo = 0.f, c_hi = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = tile_row(m0, e) * kLdc + tile_col(8 * jt, e);
          const float dme = dm[jt][e] * Es[o];
          dCB[o] += dme;
          const float ds = dme * CB[o];
          if (e < 2) r_lo += ds; else r_hi += ds;
          if (e & 1) c_hi += ds; else c_lo += ds;
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          c_lo += __shfl_xor_sync(0xffffffffu, c_lo, off);
          c_hi += __shfl_xor_sync(0xffffffffu, c_hi, off);
        }
        if (lane < 4 && jt * 8 <= m0 + 15) {
          atomicAdd(csum + 8 * jt + 2 * lane, c_lo);
          atomicAdd(csum + 8 * jt + 2 * lane + 1, c_hi);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        r_lo += __shfl_xor_sync(0xffffffffu, r_lo, off);
        r_hi += __shfl_xor_sync(0xffffffffu, r_hi, off);
      }
      if ((lane & 3) == 0) {
        rsum[m0 + lane / 4] = r_lo;
        rsum[m0 + 8 + lane / 4] = r_hi;
      }
    }
    // dC += (exp(cum) dy) s^T, dB += ((dt x) exp(w - cum)) ds^T (rows past
    // cnt: x and dy are zero-padded)
    if (nc0 < N) {
      mma_tiles<PR, 2>(
          accC, [&](int i, int q) { return dys[i * ldp + q] * ech[i]; },
          [&](int q, int n) { return sts[n * ldp + q]; }, mc, nc0, kC, N, 0, P);
      mma_tiles<PR, 2>(
          accB, [&](int i, int q) { return xs[i * ldp + q] * (dts[i] * ewc[i]); },
          [&](int q, int n) { return dss[n * ldp + q]; }, mc, nc0, kC, N, 0, P);
    }
    __syncthreads();  // dds, dGs, cst, rsum, csum

    // per row (eight threads each): d(dt x) = M^T dy + (B ds) exp(w - cum),
    // then C s . dy, B ds . (dt x), d(dt x) . x
    float v = 0.f;  // this thread's part of d w
    {
      const int i = tid >> 3, part = tid & 7;
      float rc = 0.f, rt = 0.f, rx = 0.f;
      for (int q = part; q < P; q += 8) {
        const int o = i * ldp + q;
        const float d = fmaf(dGs[o], ewc[i], dds[o]);
        dds[o] = d;
        rc = fmaf(dys[o], cst[o], rc);
        rt = fmaf(dGs[o], xs[o], rt);
        rx = fmaf(d, xs[o], rx);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        rc += __shfl_xor_sync(0xffffffffu, rc, off);
        rt += __shfl_xor_sync(0xffffffffu, rt, off);
        rx += __shfl_xor_sync(0xffffffffu, rx, off);
      }
      if (part == 0) {
        v = rt * dts[i] * ewc[i];  // rowsum(B ds G), G = (dt x) exp(w - cum)
        dch[i] = rc * ech[i] - v + rsum[i] - csum[i];
        ddta[i] = rx;
      }
    }
    float u = 0.f;
    for (long long e = tid; e < NP; e += kGradThreads) {
      const int n = static_cast<int>(e / P), q = static_cast<int>(e - n * P);
      u = fmaf(dss[n * ldp + q], sts[n * ldp + q], u);
    }
    v = warp_sum(fmaf(u, exp2f(wt2), v));
    if (lane == 0) red[warp] = v;
    if (next && warp == kCumWarp) {
      const HeadBuf nb = buf((hh + 1) & 1);
      warp_cum(raw_next, w.cnt, A_s[hh + 1], bs_s[hh + 1], nb.zs, nb.dts, nb.c2);
    }
    __syncthreads();  // dch, red, dds

    // dw_j = sum_{i >= j} d cum_i + d w and the raw dt's gradient (warps
    // 0-1); dx and dD (warps 2 to kCumWarp - 1), then the next head's E
    // (warps 2 on)
    if (tid < kC) {
      const int j = tid;
      float dwt = 0.f;
#pragma unroll
      for (int k = 0; k < kGradWarps; ++k) dwt += red[k];
      float c = dch[j];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, c, off);
        if (lane + off < 32) c += o;
      }
      const float upper = warp == 0 ? warp_sum(dch[32 + lane]) : 0.f;
      const float dw = c + upper + dwt;
      const float gr = fmaf(dw, A_s[hh], ddta[j]);
      const float z = hb.zs[j];
      const float sig = z > 20.f ? 1.f : 1.f / (1.f + expf(-z));
      const float dsp = j < w.cnt ? gr * sig : 0.f;
      if (j < w.cnt) p.ddt[row0 + hh + static_cast<long long>(j) * R] = dsp;
      const float sA = warp_sum(dw * dts[j]), sb = warp_sum(dsp);
      if (lane == 0) {
        atomicAdd(dA_s + hh, sA);
        atomicAdd(dbias_s + hh, sb);
      }
    } else if (warp < kCumWarp) {
      const int t = tid - kC, nt = (kCumWarp - 2) * 32;
      const float* Dh = p.Dm ? D_s + hh * P : nullptr;
      for (int e = t; e < w.cnt * P; e += nt) {
        const int i = e / P, q = e - i * P;
        p.dx[(row0 + hh + static_cast<long long>(i) * R) * P + q] =
            fmaf(dds[i * ldp + q], dts[i], Dh ? dys[i * ldp + q] * Dh[q] : 0.f);
      }
      // dD: column sums of dy x over the chunk's rows
      const int q = t % P, step = nt / P;
      if (t < step * P) {
        float acc = 0.f;
        for (int i = t / P; i < w.cnt; i += step) acc = fmaf(dys[i * ldp + q], xs[i * ldp + q], acc);
        atomicAdd(dD_s + hh * P + q, acc);
      }
    }
    if (next && tid >= kC) prepare(buf((hh + 1) & 1).c2, kC, kGradThreads - kC);
    cp_async_wait<0>();
  }
  __syncthreads();  // dCB is complete
  // dC += dCB B, dB += dCB^T C
  if (nc0 < N) {
    mma_tiles<PR, 2>(
        accC, [&](int i, int j) { return dCB[i * kLdc + j]; },
        [&](int j, int n) { return Bs[j * ldn + n]; }, mc, nc0, kC, N, 0, min(kC, mc + 16));
    mma_tiles<PR, 2>(
        accB, [&](int j, int i) { return dCB[i * kLdc + j]; },
        [&](int i, int n) { return Cs[i * ldn + n]; }, mc, nc0, kC, N, mc, kC);
    const bool sole = p.tile == R;  // no other block adds to these rows
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = tile_row(mc, e), n = tile_col(nc0 + 8 * jt, e);
        if (i < w.cnt && n < N) {
          const long long o = rowBC + static_cast<long long>(i) * N + n;
          if (sole) {
            p.dC[o] = accC[jt][e];
            p.dB[o] = accB[jt][e];
          } else {
            atomicAdd(p.dC + o, accC[jt][e]);
            atomicAdd(p.dB + o, accB[jt][e]);
          }
        }
      }
  }
  for (int e = tid; e < p.tile * P; e += kGradThreads) atomicAdd(p.dD + h0 * P + e, dD_s[e]);
  if (tid < p.tile) {
    atomicAdd(p.dA + h0 + tid, dA_s[tid]);
    atomicAdd(p.dbias + h0 + tid, dbias_s[tid]);
  }
}

// Shared memory of each block kernel, in bytes.
size_t state_smem(int N, int P, int tile) {
  return sizeof(float) * (kC * (N + kPad) + tile * (kC * (P + kPad) + 3 * kC));
}
size_t scan_smem(int N, int P, int tile) {
  return sizeof(float) * (2 * kC * (N + kPad) + kC * kLdc + kMaxTile * kMaxP + 2 * kMaxTile +
                          tile * (kC * (P + kPad) + N * (P + kPad) + 2 * kC));
}
size_t grad_smem(int N, int P, int tile) {
  const int ldp = P + kPad;
  return sizeof(float) * (2 * kC * (N + kPad) + 3 * kC * kLdc +
                          2 * (2 * kC * ldp + 2 * N * ldp + 3 * kC) + 3 * kC * ldp + 6 * kC + 32 +
                          4 * kMaxTile + 2 * kMaxTile * kMaxP);
}

// Two blocks per SM: the shared memory each may take.
constexpr size_t kHalfSmem = 233472 / 2 - 1024;

// Heads per block: the largest divisor of R up to kMaxTile whose shared
// memory fits the budget and that still gives two blocks per SM over the
// grid (fewer heads per block only add blocks that reload the chunk's B and
// C), else 1.
int pick_tile(long long blocks, int R, int sms, size_t (*smem)(int, int, int), int N, int P,
              size_t budget) {
  int best = 1;
  for (int t = 2; t <= min(R, kMaxTile); ++t)
    if (R % t == 0 && smem(N, P, t) <= budget && blocks * (R / t) >= 2LL * sms) best = t;
  return best;
}

// Validates the geometry and fills nc; sms gets the SM count.
cudaError_t prepare(Params& p, int b, int* sms) {
  if (b < 1 || b > 65535 || p.L < 1 || p.g < 1 || p.R < 1 || p.N < 2 || p.N % 2 ||
      p.N > 64 || p.P < 2 || p.P % 2 || p.P > 32 || static_cast<long long>(p.g) * p.R > 65535)
    return cudaErrorInvalidValue;
  p.nc = ceil_div(p.L, kC);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Picks the tile for a kernel with the given shared memory and budget,
// and returns the grid (chunk, group x tile, image) and the bytes.
dim3 plan(Params& p, int b, int sms, size_t (*smem)(int, int, int), size_t budget,
          size_t* bytes) {
  p.tile = pick_tile(static_cast<long long>(b) * p.g * p.nc, p.R, sms, smem, p.N, p.P, budget);
  *bytes = smem(p.N, p.P, p.tile);
  return dim3(p.nc, p.g * (p.R / p.tile), b);
}

// Launches a block kernel.  At a kernel's first launch (outside any stream
// capture: a graph captures launches, not attributes) its shared-memory
// limit is raised to the most a block may take and its carveout to all
// shared memory, so that as many blocks share an SM as their shared memory
// allows.
template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
                   const Params& p) {
  static const void* ready[64];  // kernels whose attributes are set
  static int n_ready = 0;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const void* key = reinterpret_cast<const void*>(kernel);
  bool set = false;
  for (int i = 0; i < n_ready; ++i) set = set || ready[i] == key;
  if (!set) {
    cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
    cudaError_t err = cudaStreamIsCapturing(s, &capturing);
    if (err == cudaSuccess && capturing == cudaStreamCaptureStatusNone) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxSmem));
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
      if (err == cudaSuccess && n_ready < 64) ready[n_ready++] = key;
    }
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// The kernel instance for ceil(P / 8) column tiles of P.
template <template <int> class Pick>
cudaError_t by_tiles(int P, dim3 grid, int threads, size_t smem, cudaStream_t s,
                     const Params& p) {
  switch ((P + 7) / 8) {
    case 1: return launch(Pick<1>::kernel(), grid, threads, smem, s, p);
    case 2: return launch(Pick<2>::kernel(), grid, threads, smem, s, p);
    case 3: return launch(Pick<3>::kernel(), grid, threads, smem, s, p);
    case 4: return launch(Pick<4>::kernel(), grid, threads, smem, s, p);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename S, bool ADJ>
struct StatePick {
  template <int NT>
  struct At {
    static auto kernel() { return ssd_state_kernel<T, S, ADJ, NT>; }
  };
};
template <typename T>
struct ScanPick {
  template <int NT>
  struct At {
    static auto kernel() { return ssd_scan_kernel<T, NT>; }
  };
};
template <typename T>
struct GradPick {
  template <int NT>
  struct At {
    static auto kernel() { return ssd_grad_kernel<T, NT>; }
  };
};

}  // namespace ssd
}  // namespace xfm

using namespace xfm;
using namespace xfm::ssd;

extern "C" int xfm_ssd_chunk_state(const void* src, const void* dt, const void* mat,
                                   const float* A, const float* bias, float* st, float* decay,
                                   int b, int L, int g, int R, int P, int N, int dtype,
                                   int adjoint, void* stream) {
  Params p{};
  p.x = src;
  p.dy = static_cast<const float*>(src);
  p.dt = dt;
  p.Bm = p.Cm = mat;
  p.A = A;
  p.bias = bias;
  p.st = st;
  p.decay = decay;
  p.L = L;
  p.g = g;
  p.R = R;
  p.P = P;
  p.N = N;
  int sms = 0;
  cudaError_t err = prepare(p, b, &sms);
  if (err != cudaSuccess) return err;
  size_t smem = 0;
  const dim3 grid = plan(p, b, sms, state_smem, kHalfSmem, &smem);
  auto s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (dtype == kF32)
    return adjoint ? by_tiles<StatePick<float, float, true>::At>(P, grid, kThreads, smem, s, p)
                   : by_tiles<StatePick<float, float, false>::At>(P, grid, kThreads, smem, s, p);
  if (dtype == kBF16)
    return adjoint ? by_tiles<StatePick<BF, float, true>::At>(P, grid, kThreads, smem, s, p)
                   : by_tiles<StatePick<BF, BF, false>::At>(P, grid, kThreads, smem, s, p);
  return cudaErrorInvalidValue;
}

extern "C" int xfm_ssd_state_pass(float* buf, const float* decay, const float* start, float* fin,
                                  long long heads, int nc, int NP, int reverse, void* stream) {
  const auto misaligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (heads < 1 || nc < 1 || NP < 4 || NP % 4 || misaligned(buf) || misaligned(start) ||
      misaligned(fin))
    return cudaErrorInvalidValue;
  const long long blocks = (heads * NP / 4 + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  ssd_pass_kernel<<<grid, kThreads, 0, s>>>(buf, decay, start, fin, heads, nc, NP, reverse);
  return cudaGetLastError();
}

extern "C" int xfm_ssd_chunk_scan(const void* x, const void* dt, const void* Bm, const void* Cm,
                                  const float* A, const float* bias, const float* Dm,
                                  const float* states, void* y, int b, int L, int g, int R, int P,
                                  int N, int dtype, void* stream) {
  Params p{};
  p.x = x;
  p.dt = dt;
  p.Bm = Bm;
  p.Cm = Cm;
  p.A = A;
  p.bias = bias;
  p.Dm = Dm;
  p.st = const_cast<float*>(states);
  p.y = y;
  p.L = L;
  p.g = g;
  p.R = R;
  p.P = P;
  p.N = N;
  int sms = 0;
  cudaError_t err = prepare(p, b, &sms);
  if (err != cudaSuccess) return err;
  size_t smem = 0;
  const dim3 grid = plan(p, b, sms, scan_smem, kHalfSmem, &smem);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return by_tiles<ScanPick<float>::At>(P, grid, kThreads, smem, s, p);
  if (dtype == kBF16) return by_tiles<ScanPick<__nv_bfloat16>::At>(P, grid, kThreads, smem, s, p);
  return cudaErrorInvalidValue;
}

extern "C" int xfm_ssd_chunk_grads(const void* x, const void* dt, const void* Bm, const void* Cm,
                                   const float* A, const float* bias, const float* Dm,
                                   const float* states, const float* ds_out, const float* dy,
                                   float* dx, float* ddt, float* dB, float* dC, float* dA,
                                   float* dbias, float* dD, int b, int L, int g, int R, int P,
                                   int N, int dtype, void* stream) {
  Params p{};
  p.x = x;
  p.dt = dt;
  p.Bm = Bm;
  p.Cm = Cm;
  p.A = A;
  p.bias = bias;
  p.Dm = Dm;
  p.ck = states;
  p.st = const_cast<float*>(ds_out);
  p.dy = dy;
  p.dx = dx;
  p.ddt = ddt;
  p.dB = dB;
  p.dC = dC;
  p.dA = dA;
  p.dbias = dbias;
  p.dD = dD;
  p.L = L;
  p.g = g;
  p.R = R;
  p.P = P;
  p.N = N;
  int sms = 0;
  cudaError_t err = prepare(p, b, &sms);
  if (err != cudaSuccess) return err;
  size_t smem = 0;
  const dim3 grid = plan(p, b, sms, grad_smem, kMaxSmem, &smem);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return by_tiles<GradPick<float>::At>(P, grid, kGradThreads, smem, s, p);
  if (dtype == kBF16)
    return by_tiles<GradPick<__nv_bfloat16>::At>(P, grid, kGradThreads, smem, s, p);
  return cudaErrorInvalidValue;
}
