// The serial forms of kernels 15 and 16, the chunked SSD (Mamba-2
// state-space duality) scan and its reverse-chunk adjoint: one block walks
// every chunk of its (image, group, tile of heads) in order, every product
// on the CUDA cores.  No model path reaches them: ssd_chunk.cu's
// chunk-parallel kernels replaced them, and they stay only so that
// chip_smoke.py can time the two designs in turns in one run
// (ops/ssd_chunk.py::ssd_fwd_serial / ssd_bwd_serial).
//
// They replace xfmamba_tpu/ops/ssd_pallas.py::_ssd_kernel (:74) and
// ::_ssd_bwd_kernel (:356) as ssd_chunk.cu does.  Layout (group-major): x and
// y (b, g, L, R, P), dt (b, g, L, R), B and C (b, g, L, N); head
// h = k * R + r of group k reads B[b, k] and C[b, k].  Per head, chunk by
// chunk of c = 64 positions (rows past L: dt 0, so decay 1 and no
// contribution):
//   dt    = softplus20(dt_raw + bias_h),  cum = inclusive cumsum of A_h dt
//   M     = (C_c B_c^T) * exp(cum_i - cum_j) [i >= j]
//   y     = M (dt x) + exp(cum) (C_c state) + D_h x
//   state = exp(cum_last) state + B_c^T ((dt x) exp(cum_last - cum))
// with the state (N, P) per head carried across chunks; with checkpoints,
// the state entering chunk j goes to states[b, h, j].
//
// Design.  One block of 256 threads per (image, group, tile of heads), the
// chunks serial; every operand of a chunk is staged in shared memory in
// float32.  C_c B_c^T (64 x 64 over N) is computed once per chunk for all
// heads of the tile, each thread a 4 x 4 tile of its lower triangle.  Per
// head: the cumsum by two warp scans, the decay mask M in shared memory,
// then y and the state update as 2 x 2 register tiles (64 x P and N x P
// outputs).  The heads of the tile keep their states in shared memory; the
// tile is the largest divisor of R up to 8 that still gives two blocks per
// SM.  Exponents are taken of differences (cum_i - cum_j, cum_last - cum),
// never as products of exp(cum) terms, which would overflow once decays
// grow.
//
// The backward walks the chunks in reverse.  Per chunk it recomputes C_c
// B_c^T, and per head dt, cum, the decay E, dt x and exp(cum) from the
// checkpoint, then forms every product of the Pallas adjoint (dM = dy
// (dt x)^T, M^T dy, C_c st, B_c ds, the dB/dC terms of the read-out and
// the update), the cumsum adjoint and the softplus derivative, carrying
// the state adjoint ds (N x P per head, in shared memory) to the previous
// chunk.  dB and dC of the chunk (summed over the tile's heads, then the
// C B^T term) go to device memory with one atomic add per element, as other
// tiles of the group add to the same rows; dA, dbias and dD are summed in
// shared memory and added with atomics per block (float32 reordering).
//
// What bounds it on the H100: operations (about 100 GFLOP per
// vmamba_small_m2 bs-32 forward in float32), run here on the CUDA cores
// from shared memory, one or two operand loads per FMA.
#include "common.cuh"

namespace xfm {
namespace serial_ssd {

constexpr int kSsdChunk = 64;     // positions per chunk
constexpr int kSsdThreads = 256;  // 16 x 16 tiles of 4 x 4 cover C B^T
constexpr int kSsdMaxTile = 8;    // heads per block
constexpr size_t kSsdMaxSmem = 232448;

static_assert(kSsdChunk == 64 && kSsdThreads == 256, "the C B^T tiling assumes 64 x 64 / 256");

struct SsdParams {
  const void* x;      // (b, g, L, R, P)
  const void* dt;     // (b, g, L, R), before bias and softplus
  const void* Bm;     // (b, g, L, N)
  const void* Cm;     // (b, g, L, N)
  const float* A;     // (g * R,)
  const float* bias;  // (g * R,) or null
  const float* Dm;    // (g * R, P) or null
  const float* init;  // (b, g * R, N, P) or null (zeros)
  void* y;            // (b, g, L, R, P), x's dtype
  float* fin;         // (b, g * R, N, P)
  float* states;      // (b, g * R, n_chunks, N, P): the state entering each chunk (or null)
  const float* dy;    // (b, g, L, R, P)
  const float* dfin;  // (b, g * R, N, P) or null (zeros)
  float* dx;          // (b, g, L, R, P)
  float* ddt;         // (b, g, L, R): gradient of the raw dt
  float* dB;          // (b, g, L, N), accumulated
  float* dC;          // (b, g, L, N), accumulated
  float* dA;          // (g * R,), accumulated
  float* dbias;       // (g * R,), accumulated
  float* dD;          // (g * R, P), accumulated
  float* dinit;       // (b, g * R, N, P)
  int L, g, R, P, N, n_chunks, tile;
};

// Shared memory of a block, in floats (row strides padded by one against
// bank conflicts).
__host__ __device__ inline size_t ssd_smem_floats(bool backward, int N, int P, int tile) {
  const size_t c = kSsdChunk, ldn = N + 1, ldc = c + 1, ldp = P + 1;
  if (!backward) return 2 * c * ldn + 2 * c * ldc + 2 * c * ldp + 2 * c + tile * N * ldp;
  return 4 * c * ldn + 4 * c * ldc + 6 * c * ldp + N * ldp + tile * N * ldp + 8 * c + 32 +
         tile * (P + 2);
}

// B and C of positions t0 .. t0 + cnt - 1 into shared memory, zero past cnt.
template <typename T>
__device__ __forceinline__ void ssd_load_bc(const T* Bm, const T* Cm, int t0, int cnt, int N,
                                            float* Bs, float* Cs) {
  const int ldn = N + 1;
  for (int e = threadIdx.x; e < kSsdChunk * N; e += kSsdThreads) {
    const int i = e / N, n = e - i * N;
    const long long o = static_cast<long long>(t0 + i) * N + n;
    Bs[i * ldn + n] = i < cnt ? to_f32(Bm[o]) : 0.f;
    Cs[i * ldn + n] = i < cnt ? to_f32(Cm[o]) : 0.f;
  }
}

// CB = C B^T on the 4 x 4 tiles at or below the diagonal (the others are
// never read); the caller synchronises after it.
__device__ __forceinline__ void ssd_cb(const float* Cs, const float* Bs, int N, float* CB) {
  constexpr int ldc = kSsdChunk + 1;
  const int ldn = N + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if (tx > ty) return;
  float acc[4][4] = {};
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      cv[a] = Cs[(4 * ty + a) * ldn + n];
      bv[a] = Bs[(4 * tx + a) * ldn + n];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(cv[a], bv[bb], acc[a][bb]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) CB[(4 * ty + a) * ldc + 4 * tx + bb] = acc[a][bb];
}

// One head's dt (0 past cnt), its pre-softplus z (when zs is given) and the
// inclusive cumsum of A dt, by warps 0 and 1 each over its 32 rows;
// ssd_cum_fix, after a barrier, adds warp 0's total to warp 1's rows.
template <typename T>
__device__ __forceinline__ void ssd_dt_scan(const T* dt, int t0, int cnt, int R, int r, float a_h,
                                            float bias_h, float* zs, float* dts, float* cums) {
  const int i = threadIdx.x;
  if (i >= kSsdChunk) return;
  const float z = (i < cnt ? to_f32(dt[static_cast<long long>(t0 + i) * R + r]) : 0.f) + bias_h;
  const float d = i < cnt ? softplus20(z) : 0.f;
  if (zs) zs[i] = z;
  dts[i] = d;
  float w = d * a_h;
  const int lane = i & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, w, off);
    if (lane >= off) w += v;
  }
  cums[i] = w;
}

__device__ __forceinline__ void ssd_cum_fix(float* cums) {
  if (threadIdx.x >= 32 && threadIdx.x < kSsdChunk) cums[threadIdx.x] += cums[31];
}

// One head's (c x P) rows of an x-shaped array into shared memory, zero past cnt.
template <typename T>
__device__ __forceinline__ void ssd_load_head(const T* src, int t0, int cnt, int R, int r, int P,
                                              float* dst) {
  const int ldp = P + 1;
  for (int e = threadIdx.x; e < kSsdChunk * P; e += kSsdThreads) {
    const int i = e / P, q = e - i * P;
    dst[i * ldp + q] =
        i < cnt ? to_f32(src[(static_cast<long long>(t0 + i) * R + r) * P + q]) : 0.f;
  }
}

// The sum of v over the block, returned to every thread.
__device__ __forceinline__ float ssd_block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kSsdThreads / 32; ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_fwd_kernel(SsdParams p) {
  extern __shared__ float smem[];
  constexpr int c = kSsdChunk, ldc = c + 1;
  const int N = p.N, P = p.P, R = p.R, ldn = N + 1, ldp = P + 1, tid = threadIdx.x;
  float* Bs = smem;
  float* Cs = Bs + c * ldn;
  float* CB = Cs + c * ldn;
  float* Ms = CB + c * ldc;
  float* xs = Ms + c * ldc;
  float* us = xs + c * ldp;  // dt x, then (dt x) exp(cum_last - cum)
  float* dts = us + c * ldp;
  float* cums = dts + c;
  float* st = cums + c;  // tile x (N x ldp)

  const int k = blockIdx.y, r0 = blockIdx.x * p.tile;
  const long long b = blockIdx.z, bg = b * p.g + k;
  const T* x = static_cast<const T*>(p.x) + bg * p.L * R * P;
  const T* dt = static_cast<const T*>(p.dt) + bg * p.L * R;
  const T* Bm = static_cast<const T*>(p.Bm) + bg * p.L * N;
  const T* Cm = static_cast<const T*>(p.Cm) + bg * p.L * N;
  T* y = static_cast<T*>(p.y) + bg * p.L * R * P;
  const long long head0 = bg * R + r0;  // row of the tile's first head in the state arrays
  const int NP = N * P;

  for (int e = tid; e < p.tile * NP; e += kSsdThreads) {
    const int hh = e / NP, n = (e - hh * NP) / P, q = e % P;
    st[(hh * N + n) * ldp + q] = p.init ? p.init[head0 * NP + e] : 0.f;
  }
  for (int ci = 0; ci < p.n_chunks; ++ci) {
    const int t0 = ci * c, cnt = min(c, p.L - t0);
    __syncthreads();
    ssd_load_bc(Bm, Cm, t0, cnt, N, Bs, Cs);
    if (p.states) {
      for (int e = tid; e < p.tile * NP; e += kSsdThreads) {
        const int hh = e / NP, n = (e - hh * NP) / P, q = e % P;
        p.states[((head0 + hh) * p.n_chunks + ci) * NP + (e - hh * NP)] =
            st[(hh * N + n) * ldp + q];
      }
    }
    __syncthreads();
    ssd_cb(Cs, Bs, N, CB);
    for (int hh = 0; hh < p.tile; ++hh) {
      const int r = r0 + hh, head = k * R + r;
      float* sth = st + hh * N * ldp;
      __syncthreads();
      ssd_dt_scan(dt, t0, cnt, R, r, p.A[head], p.bias ? p.bias[head] : 0.f, nullptr, dts, cums);
      ssd_load_head(x, t0, cnt, R, r, P, xs);
      __syncthreads();
      ssd_cum_fix(cums);
      for (int e = tid; e < c * P; e += kSsdThreads) {
        const int i = e / P, q = e - i * P;
        us[i * ldp + q] = xs[i * ldp + q] * dts[i];
      }
      __syncthreads();
      for (int e = tid; e < c * c; e += kSsdThreads) {
        const int i = e / c, j = e - i * c;
        Ms[i * ldc + j] = j <= i ? CB[i * ldc + j] * expf(cums[i] - cums[j]) : 0.f;
      }
      __syncthreads();
      // y for rows (i0, i0 + 1) x columns (q0, q0 + 1)
      const float* Dh = p.Dm ? p.Dm + static_cast<long long>(head) * P : nullptr;
      for (int o = tid; o < (c / 2) * (P / 2); o += kSsdThreads) {
        const int i0 = 2 * (o / (P / 2)), q0 = 2 * (o % (P / 2));
        float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
        for (int j = 0; j <= i0 + 1; ++j) {
          const float m0 = Ms[i0 * ldc + j], m1 = Ms[(i0 + 1) * ldc + j];
          const float u0 = us[j * ldp + q0], u1 = us[j * ldp + q0 + 1];
          a00 = fmaf(m0, u0, a00);
          a01 = fmaf(m0, u1, a01);
          a10 = fmaf(m1, u0, a10);
          a11 = fmaf(m1, u1, a11);
        }
        float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
        for (int n = 0; n < N; ++n) {
          const float c0 = Cs[i0 * ldn + n], c1 = Cs[(i0 + 1) * ldn + n];
          const float v0 = sth[n * ldp + q0], v1 = sth[n * ldp + q0 + 1];
          s00 = fmaf(c0, v0, s00);
          s01 = fmaf(c0, v1, s01);
          s10 = fmaf(c1, v0, s10);
          s11 = fmaf(c1, v1, s11);
        }
        const float e0 = expf(cums[i0]), e1 = expf(cums[i0 + 1]);
        const float d0 = Dh ? Dh[q0] : 0.f, d1 = Dh ? Dh[q0 + 1] : 0.f;
        if (i0 < cnt) {
          T* yr = y + (static_cast<long long>(t0 + i0) * R + r) * P + q0;
          yr[0] = from_f32<T>(fmaf(s00, e0, a00) + d0 * xs[i0 * ldp + q0]);
          yr[1] = from_f32<T>(fmaf(s01, e0, a01) + d1 * xs[i0 * ldp + q0 + 1]);
        }
        if (i0 + 1 < cnt) {
          T* yr = y + (static_cast<long long>(t0 + i0 + 1) * R + r) * P + q0;
          yr[0] = from_f32<T>(fmaf(s10, e1, a10) + d0 * xs[(i0 + 1) * ldp + q0]);
          yr[1] = from_f32<T>(fmaf(s11, e1, a11) + d1 * xs[(i0 + 1) * ldp + q0 + 1]);
        }
      }
      __syncthreads();
      const float wt = cums[c - 1];
      for (int e = tid; e < c * P; e += kSsdThreads) {
        const int i = e / P, q = e - i * P;
        us[i * ldp + q] *= expf(wt - cums[i]);
      }
      __syncthreads();
      // state <- exp(wt) state + B^T G, for rows (n0, n0 + 1) x (q0, q0 + 1)
      const float ewt = expf(wt);
      for (int o = tid; o < (N / 2) * (P / 2); o += kSsdThreads) {
        const int n0 = 2 * (o / (P / 2)), q0 = 2 * (o % (P / 2));
        float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
        for (int i = 0; i < cnt; ++i) {
          const float b0 = Bs[i * ldn + n0], b1 = Bs[i * ldn + n0 + 1];
          const float g0 = us[i * ldp + q0], g1 = us[i * ldp + q0 + 1];
          a00 = fmaf(b0, g0, a00);
          a01 = fmaf(b0, g1, a01);
          a10 = fmaf(b1, g0, a10);
          a11 = fmaf(b1, g1, a11);
        }
        float* s0 = sth + n0 * ldp + q0;
        float* s1 = s0 + ldp;
        s0[0] = fmaf(s0[0], ewt, a00);
        s0[1] = fmaf(s0[1], ewt, a01);
        s1[0] = fmaf(s1[0], ewt, a10);
        s1[1] = fmaf(s1[1], ewt, a11);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < p.tile * NP; e += kSsdThreads) {
    const int hh = e / NP, n = (e - hh * NP) / P, q = e % P;
    p.fin[head0 * NP + e] = st[(hh * N + n) * ldp + q];
  }
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_bwd_kernel(SsdParams p) {
  extern __shared__ float smem[];
  constexpr int c = kSsdChunk, ldc = c + 1;
  const int N = p.N, P = p.P, R = p.R, ldn = N + 1, ldp = P + 1, tid = threadIdx.x;
  float* Bs = smem;
  float* Cs = Bs + c * ldn;
  float* dBc = Cs + c * ldn;   // the chunk's dB, summed over the tile's heads
  float* dCc = dBc + c * ldn;  // the chunk's dC
  float* CB = dCc + c * ldn;
  float* Es = CB + c * ldc;    // exp(cum_i - cum_j) [i >= j]
  float* dMS = Es + c * ldc;   // dM = dy (dt x)^T, then dS = dM * M
  float* dCB = dMS + c * ldc;  // summed over the tile's heads
  float* xs = dCB + c * ldc;
  float* dys = xs + c * ldp;
  float* us = dys + c * ldp;   // dt x
  float* dds = us + c * ldp;   // d(dt x)
  float* dGs = dds + c * ldp;  // B ds
  float* cst = dGs + c * ldp;  // C st
  float* st = cst + c * ldp;   // the head's checkpoint, N x ldp
  float* ds = st + N * ldp;    // tile x (N x ldp): the state adjoints
  float* zs = ds + p.tile * N * ldp;
  float* dts = zs + c;
  float* cums = dts + c;
  float* ech = cums + c;       // exp(cum)
  float* ewc = ech + c;        // exp(cum_last - cum)
  float* trs = ewc + c;        // rowsum(B ds * G)
  float* dch = trs + c;        // d cum
  float* ddta = dch + c;       // rowsum(d(dt x) * x)
  float* red = ddta + c;       // 32
  float* dD_s = red + 32;      // tile x P
  float* dA_s = dD_s + p.tile * P;
  float* dbias_s = dA_s + p.tile;

  const int k = blockIdx.y, r0 = blockIdx.x * p.tile;
  const long long b = blockIdx.z, bg = b * p.g + k;
  const T* x = static_cast<const T*>(p.x) + bg * p.L * R * P;
  const T* dt = static_cast<const T*>(p.dt) + bg * p.L * R;
  const T* Bm = static_cast<const T*>(p.Bm) + bg * p.L * N;
  const T* Cm = static_cast<const T*>(p.Cm) + bg * p.L * N;
  const float* dy = p.dy + bg * p.L * R * P;
  float* dx = p.dx + bg * p.L * R * P;
  float* ddt = p.ddt + bg * p.L * R;
  float* dB = p.dB + bg * p.L * N;
  float* dC = p.dC + bg * p.L * N;
  const long long head0 = bg * R + r0;
  const int NP = N * P;

  for (int e = tid; e < p.tile * NP; e += kSsdThreads) {
    const int hh = e / NP, n = (e - hh * NP) / P, q = e % P;
    ds[(hh * N + n) * ldp + q] = p.dfin ? p.dfin[head0 * NP + e] : 0.f;
  }
  for (int e = tid; e < p.tile * (P + 2); e += kSsdThreads) dD_s[e] = 0.f;  // and dA_s, dbias_s

  for (int ci = p.n_chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * c, cnt = min(c, p.L - t0);
    __syncthreads();
    ssd_load_bc(Bm, Cm, t0, cnt, N, Bs, Cs);
    for (int e = tid; e < c * ldn; e += kSsdThreads) dBc[e] = dCc[e] = 0.f;
    for (int e = tid; e < c * ldc; e += kSsdThreads) dCB[e] = 0.f;
    __syncthreads();
    ssd_cb(Cs, Bs, N, CB);
    for (int hh = 0; hh < p.tile; ++hh) {
      const int r = r0 + hh, head = k * R + r;
      const float a_h = p.A[head];
      float* dsh = ds + hh * N * ldp;
      __syncthreads();
      ssd_dt_scan(dt, t0, cnt, R, r, a_h, p.bias ? p.bias[head] : 0.f, zs, dts, cums);
      ssd_load_head(x, t0, cnt, R, r, P, xs);
      ssd_load_head(dy, t0, cnt, R, r, P, dys);
      const float* ck = p.states + ((head0 + hh) * p.n_chunks + ci) * NP;
      for (int e = tid; e < NP; e += kSsdThreads) st[(e / P) * ldp + e % P] = ck[e];
      __syncthreads();
      ssd_cum_fix(cums);
      __syncthreads();
      const float wt = cums[c - 1], ewt = expf(wt);
      if (tid < c) {
        ech[tid] = expf(cums[tid]);
        ewc[tid] = expf(wt - cums[tid]);
      }
      for (int e = tid; e < c * P; e += kSsdThreads) {
        const int i = e / P, q = e - i * P;
        us[i * ldp + q] = xs[i * ldp + q] * dts[i];
      }
      for (int e = tid; e < c * c; e += kSsdThreads) {
        const int i = e / c, j = e - i * c;
        Es[i * ldc + j] = j <= i ? expf(cums[i] - cums[j]) : 0.f;
      }
      __syncthreads();

      // dM = dy (dt x)^T on the pairs at or below the diagonal
      for (int o = tid; o < (c / 2) * (c / 2); o += kSsdThreads) {
        const int i0 = 2 * (o / (c / 2)), j0 = 2 * (o % (c / 2));
        float m00 = 0.f, m01 = 0.f, m10 = 0.f, m11 = 0.f;
        if (j0 <= i0) {
          for (int q = 0; q < P; ++q) {
            const float a0 = dys[i0 * ldp + q], a1 = dys[(i0 + 1) * ldp + q];
            const float u0 = us[j0 * ldp + q], u1 = us[(j0 + 1) * ldp + q];
            m00 = fmaf(a0, u0, m00);
            m01 = fmaf(a0, u1, m01);
            m10 = fmaf(a1, u0, m10);
            m11 = fmaf(a1, u1, m11);
          }
        }
        dMS[i0 * ldc + j0] = m00;
        dMS[i0 * ldc + j0 + 1] = m01;
        dMS[(i0 + 1) * ldc + j0] = m10;
        dMS[(i0 + 1) * ldc + j0 + 1] = m11;
      }
      // d(dt x) = M^T dy + (B ds) exp(cum_last - cum), and C st, for rows
      // (j0, j0 + 1) x columns (q0, q0 + 1)
      for (int o = tid; o < (c / 2) * (P / 2); o += kSsdThreads) {
        const int j0 = 2 * (o / (P / 2)), q0 = 2 * (o % (P / 2));
        float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
        for (int i = j0; i < c; ++i) {
          const float m0 = CB[i * ldc + j0] * Es[i * ldc + j0];
          const float m1 = CB[i * ldc + j0 + 1] * Es[i * ldc + j0 + 1];
          const float d0 = dys[i * ldp + q0], d1 = dys[i * ldp + q0 + 1];
          a00 = fmaf(m0, d0, a00);
          a01 = fmaf(m0, d1, a01);
          a10 = fmaf(m1, d0, a10);
          a11 = fmaf(m1, d1, a11);
        }
        float g00 = 0.f, g01 = 0.f, g10 = 0.f, g11 = 0.f;
        float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
        for (int n = 0; n < N; ++n) {
          const float b0 = Bs[j0 * ldn + n], b1 = Bs[(j0 + 1) * ldn + n];
          const float c0 = Cs[j0 * ldn + n], c1 = Cs[(j0 + 1) * ldn + n];
          const float v0 = dsh[n * ldp + q0], v1 = dsh[n * ldp + q0 + 1];
          const float w0 = st[n * ldp + q0], w1 = st[n * ldp + q0 + 1];
          g00 = fmaf(b0, v0, g00);
          g01 = fmaf(b0, v1, g01);
          g10 = fmaf(b1, v0, g10);
          g11 = fmaf(b1, v1, g11);
          s00 = fmaf(c0, w0, s00);
          s01 = fmaf(c0, w1, s01);
          s10 = fmaf(c1, w0, s10);
          s11 = fmaf(c1, w1, s11);
        }
        const int o0 = j0 * ldp + q0, o1 = o0 + ldp;
        dGs[o0] = g00;
        dGs[o0 + 1] = g01;
        dGs[o1] = g10;
        dGs[o1 + 1] = g11;
        dds[o0] = fmaf(g00, ewc[j0], a00);
        dds[o0 + 1] = fmaf(g01, ewc[j0], a01);
        dds[o1] = fmaf(g10, ewc[j0 + 1], a10);
        dds[o1 + 1] = fmaf(g11, ewc[j0 + 1], a11);
        cst[o0] = s00;
        cst[o0 + 1] = s01;
        cst[o1] = s10;
        cst[o1 + 1] = s11;
      }
      // dC += exp(cum) dy st^T and dB += exp(cum_last - cum) (dt x) ds^T,
      // rows (i0, i0 + 1) x states (n0, n0 + 1)
      for (int o = tid; o < (c / 2) * (N / 2); o += kSsdThreads) {
        const int i0 = 2 * (o / (N / 2)), n0 = 2 * (o % (N / 2));
        float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
        float b00 = 0.f, b01 = 0.f, b10 = 0.f, b11 = 0.f;
        for (int q = 0; q < P; ++q) {
          const float a0 = dys[i0 * ldp + q], a1 = dys[(i0 + 1) * ldp + q];
          const float u0 = us[i0 * ldp + q], u1 = us[(i0 + 1) * ldp + q];
          const float w0 = st[n0 * ldp + q], w1 = st[(n0 + 1) * ldp + q];
          const float v0 = dsh[n0 * ldp + q], v1 = dsh[(n0 + 1) * ldp + q];
          c00 = fmaf(a0, w0, c00);
          c01 = fmaf(a0, w1, c01);
          c10 = fmaf(a1, w0, c10);
          c11 = fmaf(a1, w1, c11);
          b00 = fmaf(u0, v0, b00);
          b01 = fmaf(u0, v1, b01);
          b10 = fmaf(u1, v0, b10);
          b11 = fmaf(u1, v1, b11);
        }
        const int o0 = i0 * ldn + n0, o1 = o0 + ldn;
        dCc[o0] = fmaf(c00, ech[i0], dCc[o0]);
        dCc[o0 + 1] = fmaf(c01, ech[i0], dCc[o0 + 1]);
        dCc[o1] = fmaf(c10, ech[i0 + 1], dCc[o1]);
        dCc[o1 + 1] = fmaf(c11, ech[i0 + 1], dCc[o1 + 1]);
        dBc[o0] = fmaf(b00, ewc[i0], dBc[o0]);
        dBc[o0 + 1] = fmaf(b01, ewc[i0], dBc[o0 + 1]);
        dBc[o1] = fmaf(b10, ewc[i0 + 1], dBc[o1]);
        dBc[o1 + 1] = fmaf(b11, ewc[i0 + 1], dBc[o1 + 1]);
      }
      __syncthreads();

      // M = CB * E: dCB += dM * E, dS = dM * M
      for (int e = tid; e < c * c; e += kSsdThreads) {
        const int i = e / c, j = e - i * c, o = i * ldc + j;
        if (j <= i) {
          const float dm = dMS[o] * Es[o];
          dCB[o] += dm;
          dMS[o] = dm * CB[o];
        } else {
          dMS[o] = 0.f;
        }
      }
      if (tid < c) {
        const int i = tid;
        float rc = 0.f, rt = 0.f, rx = 0.f;
        for (int q = 0; q < P; ++q) {
          rc = fmaf(dys[i * ldp + q], cst[i * ldp + q], rc);
          rt = fmaf(dGs[i * ldp + q], us[i * ldp + q], rt);
          rx = fmaf(dds[i * ldp + q], xs[i * ldp + q], rx);
        }
        trs[i] = rt * ewc[i];
        dch[i] = rc * ech[i] - trs[i];
        ddta[i] = rx;
      } else if (tid < c + P) {
        const int q = tid - c;
        float acc = 0.f;
        for (int i = 0; i < cnt; ++i) acc = fmaf(dys[i * ldp + q], xs[i * ldp + q], acc);
        dD_s[hh * P + q] += acc;
      }
      __syncthreads();

      // d cum_i += sum_j dS[i][j] - sum_j dS[j][i]; d w_last from the update
      float v = 0.f;
      if (tid < c) {
        float rs = 0.f, cs = 0.f;
        for (int j = 0; j < c; ++j) {
          rs += dMS[tid * ldc + j];
          cs += dMS[j * ldc + tid];
        }
        dch[tid] += rs - cs;
        v = trs[tid];
      }
      for (int e = tid; e < NP; e += kSsdThreads) {
        const int o = (e / P) * ldp + e % P;
        v = fmaf(dsh[o] * st[o], ewt, v);
      }
      const float dwt = ssd_block_sum(v, red);
      // dw_j = sum_{i >= j} d cum_i + d w_last; the raw dt's gradient
      float vA = 0.f, vb = 0.f;
      if (tid < c) {
        const int j = tid;
        float dw = dwt;
        for (int i = j; i < c; ++i) dw += dch[i];
        const float g = fmaf(dw, a_h, ddta[j]);
        const float z = zs[j];
        const float sig = z > 20.f ? 1.f : 1.f / (1.f + expf(-z));
        const float dsp = j < cnt ? g * sig : 0.f;
        if (j < cnt) ddt[static_cast<long long>(t0 + j) * R + r] = dsp;
        vA = dw * dts[j];
        vb = dsp;
      }
      const float sA = ssd_block_sum(vA, red);
      const float sb = ssd_block_sum(vb, red);
      if (tid == 0) {
        dA_s[hh] += sA;
        dbias_s[hh] += sb;
      }
      const float* Dh = p.Dm ? p.Dm + static_cast<long long>(head) * P : nullptr;
      for (int e = tid; e < cnt * P; e += kSsdThreads) {
        const int i = e / P, q = e - i * P;
        dx[(static_cast<long long>(t0 + i) * R + r) * P + q] =
            fmaf(dds[i * ldp + q], dts[i], dys[i * ldp + q] * (Dh ? Dh[q] : 0.f));
      }
      // ds <- exp(w_last) ds + C^T (exp(cum) dy)
      for (int e = tid; e < NP; e += kSsdThreads) {
        const int n = e / P, q = e - n * P;
        float acc = 0.f;
        for (int i = 0; i < cnt; ++i) acc = fmaf(Cs[i * ldn + n], dys[i * ldp + q] * ech[i], acc);
        dsh[n * ldp + q] = fmaf(dsh[n * ldp + q], ewt, acc);
      }
    }
    __syncthreads();
    // C B^T, shared by the tile's heads: dC += dCB B, dB += dCB^T C
    for (int o = tid; o < (c / 2) * (N / 2); o += kSsdThreads) {
      const int i0 = 2 * (o / (N / 2)), n0 = 2 * (o % (N / 2));
      float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
      for (int j = 0; j <= i0 + 1; ++j) {
        const float m0 = dCB[i0 * ldc + j], m1 = dCB[(i0 + 1) * ldc + j];
        const float b0 = Bs[j * ldn + n0], b1 = Bs[j * ldn + n0 + 1];
        c00 = fmaf(m0, b0, c00);
        c01 = fmaf(m0, b1, c01);
        c10 = fmaf(m1, b0, c10);
        c11 = fmaf(m1, b1, c11);
      }
      float b00 = 0.f, b01 = 0.f, b10 = 0.f, b11 = 0.f;
      for (int i = i0; i < c; ++i) {
        const float m0 = dCB[i * ldc + i0], m1 = dCB[i * ldc + i0 + 1];
        const float c0 = Cs[i * ldn + n0], c1 = Cs[i * ldn + n0 + 1];
        b00 = fmaf(m0, c0, b00);
        b01 = fmaf(m0, c1, b01);
        b10 = fmaf(m1, c0, b10);
        b11 = fmaf(m1, c1, b11);
      }
      const int o0 = i0 * ldn + n0, o1 = o0 + ldn;
      dCc[o0] += c00;
      dCc[o0 + 1] += c01;
      dCc[o1] += c10;
      dCc[o1 + 1] += c11;
      dBc[o0] += b00;
      dBc[o0 + 1] += b01;
      dBc[o1] += b10;
      dBc[o1 + 1] += b11;
    }
    __syncthreads();
    for (int e = tid; e < cnt * N; e += kSsdThreads) {
      const int i = e / N, n = e - i * N;
      const long long o = static_cast<long long>(t0 + i) * N + n;
      atomicAdd(dB + o, dBc[i * ldn + n]);
      atomicAdd(dC + o, dCc[i * ldn + n]);
    }
  }
  __syncthreads();
  for (int e = tid; e < p.tile * NP; e += kSsdThreads) {
    const int hh = e / NP, n = (e - hh * NP) / P, q = e % P;
    p.dinit[head0 * NP + e] = ds[(hh * N + n) * ldp + q];
  }
  const long long h0 = static_cast<long long>(k) * R + r0;
  for (int e = tid; e < p.tile * P; e += kSsdThreads) atomicAdd(p.dD + h0 * P + e, dD_s[e]);
  if (tid < p.tile) {
    atomicAdd(p.dA + h0 + tid, dA_s[tid]);
    atomicAdd(p.dbias + h0 + tid, dbias_s[tid]);
  }
}

// Heads per block: the largest divisor of R up to kSsdMaxTile whose shared
// memory fits and that still gives two blocks per SM, else 1.
int ssd_tile(bool backward, long long b, int g, int R, int N, int P, int sms) {
  int best = 1;
  for (int t = 2; t <= min(R, kSsdMaxTile); ++t) {
    if (R % t || ssd_smem_floats(backward, N, P, t) * sizeof(float) > kSsdMaxSmem) continue;
    if (b * g * (R / t) >= 2LL * sms) best = t;
  }
  return best;
}

template <typename T>
cudaError_t launch_ssd(const SsdParams& p, dim3 grid, size_t smem, bool backward,
                       cudaStream_t s) {
  void (*kernel)(SsdParams) = backward ? ssd_bwd_kernel<T> : ssd_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kSsdThreads, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t run_ssd(SsdParams& p, int b, int dtype, bool backward, void* stream) {
  if (b < 1 || b > 65535 || p.L < 1 || p.g < 1 || p.g > 65535 || p.R < 1 || p.N < 2 ||
      p.N % 2 || p.P < 2 || p.P % 2)
    return cudaErrorInvalidValue;
  p.n_chunks = ceil_div(p.L, kSsdChunk);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p.tile = ssd_tile(backward, b, p.g, p.R, p.N, p.P, sms);
  const size_t smem = ssd_smem_floats(backward, p.N, p.P, p.tile) * sizeof(float);
  if (smem > kSsdMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid(p.R / p.tile, p.g, b);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_ssd<float>(p, grid, smem, backward, s);
  if (dtype == kBF16) return launch_ssd<__nv_bfloat16>(p, grid, smem, backward, s);
  return cudaErrorInvalidValue;
}

}  // namespace serial_ssd
}  // namespace xfm

using namespace xfm::serial_ssd;

extern "C" int xfm_ssd_fwd_serial(const void* x, const void* dt, const void* Bm, const void* Cm,
                           const float* A, const float* bias, const float* Dm, const float* init,
                           void* y, float* fin, float* states, int b, int L, int g, int R, int P,
                           int N, int dtype, void* stream) {
  SsdParams p{};
  p.x = x;
  p.dt = dt;
  p.Bm = Bm;
  p.Cm = Cm;
  p.A = A;
  p.bias = bias;
  p.Dm = Dm;
  p.init = init;
  p.y = y;
  p.fin = fin;
  p.states = states;
  p.L = L;
  p.g = g;
  p.R = R;
  p.P = P;
  p.N = N;
  return run_ssd(p, b, dtype, false, stream);
}

extern "C" int xfm_ssd_bwd_serial(const void* x, const void* dt, const void* Bm, const void* Cm,
                           const float* A, const float* bias, const float* Dm,
                           const float* states, const float* dy, const float* dfin, float* dx,
                           float* ddt, float* dB, float* dC, float* dA, float* dbias, float* dD,
                           float* dinit, int b, int L, int g, int R, int P, int N, int dtype,
                           void* stream) {
  SsdParams p{};
  p.x = x;
  p.dt = dt;
  p.Bm = Bm;
  p.Cm = Cm;
  p.A = A;
  p.bias = bias;
  p.Dm = Dm;
  p.states = const_cast<float*>(states);
  p.dy = dy;
  p.dfin = dfin;
  p.dx = dx;
  p.ddt = ddt;
  p.dB = dB;
  p.dC = dC;
  p.dA = dA;
  p.dbias = dbias;
  p.dD = dD;
  p.dinit = dinit;
  p.L = L;
  p.g = g;
  p.R = R;
  p.P = P;
  p.N = N;
  return run_ssd(p, b, dtype, true, stream);
}
