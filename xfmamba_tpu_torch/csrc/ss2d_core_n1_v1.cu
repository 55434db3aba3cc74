// The first design of kernels 11 and 12 (widened to the stage layout), kept for
// comparison: chip_smoke.py times it against the tile-parallel kernels of
// ss2d_core_n1.cu in turns, and one card test holds it against its plain
// twin.  No main path launches it (ops/ss2d_core_n1.py::*_v1,
// ops/cross2d_scan.py::*_v1).
//
// The chunked d_state-1 cross2d scan with the rank->D delta projection in
// the kernel, and its adjoint.  One pair of kernels serves two operand
// layouts:
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
// Design: a two-level chunked scan.  A block holds 32 channels of one
// image (threadIdx.x, one warp: coalesced NHWC rows, the projection row of
// a position is a warp-wide broadcast) times n_chunks <= 16 chunks of L
// (threadIdx.y).  For each direction:
//   1. each thread walks its chunk once, computing delta and a at every
//      position, and reduces it to the pair (prod a, h from 0);
//   2. one thread per channel scans the pairs across the chunks: the state
//      entering each chunk, written out as the checkpoint;
//   3. each thread walks its chunk again from that state and writes y.
// Where the chunk's values fit in shared memory (`cache`, chosen by the
// host from the block's size), walk 1 keeps a and delta u B of every
// position there and walk 3 reads them back instead of recomputing the
// rank product, the softplus and the exp.  The positions are stepped
// incrementally, so the column directions do no division per step, and the
// ranks are read in pairs.  Each thread walks one step at a time and the
// kernels keep to 64 registers, so two 512-thread blocks share an SM: the
// walks' latency is hidden by resident warps.  (Issuing 4 steps' loads
// and arithmetic together took 120-128 registers, one block per SM, and a
// slower walk on the H100.)
// Chunks are by data position, so a forward direction and its reverse
// visit the same positions in the same thread: y_0 + y_2 needs no
// synchronisation; y_1 waits in a float32 scratch for y_3, and the
// __syncthreads of steps 1-2 order the row threads' writes of y before the
// column threads' reads.
// The adjoint runs, per direction: a walk from the checkpoint that keeps h
// (and a) in shared memory where the chunk fits, else h in a float32
// scratch (B, L, D); a walk against the order reducing the adjoint to its
// chunk pair (the same prod a, and the adjoint's value from zero); the
// scan of those pairs across the chunks (the adjoint flows against the
// direction); a last walk against the order with the gradients.  dB and dC
// are sums over channels at each position: each warp writes its lanes'
// terms for 8 positions to shared memory and one lane per position adds
// them up, then one atomic per block, position and value goes to the
// projections' gradient.  dbias, dA, dD (sums over images and positions)
// are block sums and one atomic per block and channel.
//
// What bounds it on the H100: the minimum traffic is x, the projections
// and y (forward) or x, g, du, dpre and the projections' gradient
// (adjoint) once each; the arithmetic (R FMAs, two exp and a log1p per
// step) is below that at 67 TFLOP/s in float32 at the stage widths.  The
// walks still reread x and the projections from L2 (two or three walks
// per direction) and each thread steps one chain, so at stage 0 (chunks of
// 196 positions) latency, not bandwidth, sets the time; the host picks
// more chunks where there are few chains (kernels 11/12: up to 16 chunks
// of at least 8 positions; the stage: enough chains to fill the card).
#include "common.cuh"

namespace xfm {
namespace n1v1 {

constexpr int kN1Channels = 32;  // channels of a block: one warp
constexpr int kN1MaxChunks = 16;
constexpr int kN1MaxR = 64;
constexpr int kN1Seg = 8;  // positions per dB / dC reduction

struct N1Params {
  const void* x;       // (B, L, D), NHWC
  const void* xdbl;    // (B, L, row): the projections of each position
  const float* w_dt;   // (4, R, D)
  const float* A;      // (4, D) = -exp(A_logs)
  const float* Dk;     // (4, D)
  const float* bias;   // (4, D)
  float* ck;           // (B, 4, n_chunks, D): state entering each chunk, or null
  float* y;            // (B, L, D) forward output
  float* s;            // (B, L, D) scratch of the column-pair merge
  const float* g;      // (B, L, D) gradient of y
  float* hs;           // (B, L, D) scratch: h of the current direction (no cache)
  float* du;           // (B, L, D)
  void* dpre;          // (B, L, 4, D) gradient of delta before softplus
  float* dxdbl;        // (B, L, row) float32: dB, dC columns accumulated
  float* dbias;        // (4, D) accumulated
  float* dA;           // (4, D) accumulated
  float* dD;           // (4, D) accumulated
  int H, W, D, R, chunk, n_chunks;
  int row, rank_k, bc_off, bc_k;  // rank of k at k * rank_k, B at bc_off + k * bc_k, C after B
  int dpre_bf16, cache;
};

// Per-block constants.
struct N1Block {
  int tx, j, tid, nthr, c, cc, L, t0, cnt;
  bool active;
  long long img;
};

__device__ __forceinline__ N1Block n1_block(const N1Params& p) {
  N1Block b;
  b.tx = threadIdx.x;
  b.j = threadIdx.y;
  b.tid = b.j * kN1Channels + b.tx;
  b.nthr = p.n_chunks * kN1Channels;
  b.c = blockIdx.x * kN1Channels + b.tx;
  b.active = b.c < p.D;
  b.cc = b.active ? b.c : p.D - 1;  // an idle lane loads a valid channel
  b.L = p.H * p.W;
  b.t0 = b.j * p.chunk;
  b.cnt = max(0, min(p.chunk, b.L - b.t0));
  b.img = blockIdx.y;
  return b;
}

// The row-major position l of data index t of a direction's flattening
// (rows, or columns t = w * H + h), stepped one index at a time.
struct N1Pos {
  int l, hh, ww, H, W;
  bool column;

  __device__ __forceinline__ N1Pos(int t, bool col, int H_, int W_)
      : H(H_), W(W_), column(col) {
    hh = col ? t % H_ : 0;
    ww = col ? t / H_ : 0;
    l = col ? hh * W_ + ww : t;
  }
  __device__ __forceinline__ void next() {
    if (!column) {
      ++l;
    } else if (++hh == H) {
      hh = 0;
      l = ++ww;
    } else {
      l += W;
    }
  }
  __device__ __forceinline__ void prev() {
    if (!column) {
      --l;
    } else if (hh == 0) {
      hh = H - 1;
      l = hh * W + --ww;
    } else {
      --hh;
      l -= W;
    }
  }
  // step along (forward) or against the direction's own order
  __device__ __forceinline__ void step(bool down) {
    if (down) prev(); else next();
  }
};

// w_dt of the block's channels for direction k, [r][lane].
__device__ __forceinline__ void n1_load_wdt(const N1Params& p, const N1Block& b, int k,
                                            float* wdt_s) {
  const int c0 = blockIdx.x * kN1Channels;
  for (int i = b.tid; i < p.R * kN1Channels; i += b.nthr) {
    const int r = i / kN1Channels, lane = i % kN1Channels;
    wdt_s[i] = c0 + lane < p.D ? p.w_dt[(static_cast<long long>(k) * p.R + r) * p.D + c0 + lane]
                               : 0.f;
  }
}

// One position's operands: z (pre-softplus delta), delta, a, u, B, C.
struct N1Step {
  float z, delta, a, u, B, C;
};

template <typename T>
__device__ __forceinline__ const T* n1_row(const N1Params& p, const T* xdbl, int l) {
  return xdbl + static_cast<long long>(l) * p.row;
}

__device__ __forceinline__ float2 n1_load2(const float* q) {
  return *reinterpret_cast<const float2*>(q);
}
__device__ __forceinline__ float2 n1_load2(const __nv_bfloat16* q) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q));
}

// rank . w_dt for one position.  With an even R the ranks of a direction
// start on an even element of an even-length row, so they are read in
// pairs, into two sums.
template <typename T>
__device__ __forceinline__ float n1_rank_dot(const N1Params& p, const T* rk, const float* wdt) {
  float z0 = 0.f, z1 = 0.f;
  if ((p.R & 1) == 0) {
    for (int r = 0; r < p.R; r += 2) {
      const float2 v = n1_load2(rk + r);
      z0 = fmaf(v.x, wdt[r * kN1Channels], z0);
      z1 = fmaf(v.y, wdt[(r + 1) * kN1Channels], z1);
    }
  } else {
    for (int r = 0; r < p.R; ++r) z0 = fmaf(to_f32(rk[r]), wdt[r * kN1Channels], z0);
  }
  return z0 + z1;
}

template <typename T>
__device__ __forceinline__ N1Step n1_step(const N1Params& p, const N1Block& b, const T* x,
                                          const T* xdbl, const float* wdt, int l, int k,
                                          float a_k, float bias_k) {
  const T* xd = n1_row(p, xdbl, l);
  N1Step s;
  s.z = n1_rank_dot(p, xd + k * p.rank_k, wdt) + bias_k;
  s.delta = softplus20(s.z);
  s.a = expf(s.delta * a_k);
  s.u = to_f32(x[static_cast<long long>(l) * p.D + b.cc]);
  s.B = to_f32(xd[p.bc_off + k * p.bc_k]);
  s.C = to_f32(xd[p.bc_off + k * p.bc_k + 1]);
  return s;
}

// The value entering each chunk: carry = prod * carry + loc over the
// chunks, from chunk 0 up or (backward) from the last down.  Thread
// j == 0 of each channel runs it; the caller synchronises around it.
__device__ __forceinline__ void n1_scan_chunks(const N1Params& p, const N1Block& b,
                                               const float* prod_s, const float* loc_s,
                                               float* cin_s, bool backward, float* ck_out) {
  if (b.j != 0) return;
  float carry = 0.f;
  for (int m = 0; m < p.n_chunks; ++m) {
    const int jj = backward ? p.n_chunks - 1 - m : m;
    cin_s[jj * kN1Channels + b.tx] = carry;
    if (ck_out && b.active) ck_out[static_cast<long long>(jj) * p.D + b.c] = carry;
    carry = fmaf(prod_s[jj * kN1Channels + b.tx], carry, loc_s[jj * kN1Channels + b.tx]);
  }
}

// y_k merged into y in the order (y_0 + y_2) + (y_1 + y_3); the directions
// are walked 0, 2, 1, 3.
__device__ __forceinline__ void n1_merge(float* y, float* s, long long o, int k, float v) {
  if (k == 0) {
    y[o] = v;
  } else if (k == 2) {
    y[o] += v;
  } else if (k == 1) {
    s[o] = v;
  } else {
    y[o] += s[o] + v;
  }
}

// 512 threads (16 chunks) at two blocks per SM: at most 64 registers a
// thread, so the walks' latency is hidden by resident warps.
#define N1_BOUNDS __launch_bounds__(kN1Channels * kN1MaxChunks, 2)

template <typename T>
__global__ void N1_BOUNDS ss2d_n1_fwd_kernel(N1Params p) {
  extern __shared__ float n1_smem[];
  const N1Block b = n1_block(p);
  float* wdt_s = n1_smem;                              // R x 32
  float* prod_s = wdt_s + p.R * kN1Channels;           // n_chunks x 32, three arrays
  float* loc_s = prod_s + b.nthr;
  float* cin_s = loc_s + b.nthr;
  float* cache_a = cin_s + b.nthr;                     // chunk x nthr, two arrays (cache)
  float* cache_b = cache_a + p.chunk * b.nthr;
  const long long plane = static_cast<long long>(b.L) * p.D;
  const T* x = static_cast<const T*>(p.x) + b.img * plane;
  const T* xdbl = static_cast<const T*>(p.xdbl) + b.img * b.L * p.row;
  float* y = p.y + b.img * plane;
  float* s = p.s + b.img * plane;

  for (int i = 0; i < 4; ++i) {
    const int k = (i >> 1) | ((i & 1) << 1);  // row_f, row_r, col_f, col_r
    const bool column = k & 1, reverse = k >= 2;
    const float a_k = p.A[k * p.D + b.cc], d_k = p.Dk[k * p.D + b.cc];
    const float bias_k = p.bias[k * p.D + b.cc];
    const float* wdt = wdt_s + b.tx;
    __syncthreads();  // the previous direction is done with wdt_s and cin_s
    n1_load_wdt(p, b, k, wdt_s);
    __syncthreads();
    // 1. the chunk's pair, keeping a and delta u B where they fit
    const int t_first = reverse ? b.t0 + b.cnt - 1 : b.t0;
    float prod = 1.f, h = 0.f;
    {
      N1Pos pos(t_first, column, p.H, p.W);
      for (int n = 0; n < b.cnt; ++n, pos.step(reverse)) {
        const N1Step st = n1_step(p, b, x, xdbl, wdt, pos.l, k, a_k, bias_k);
        const float bt = st.delta * st.u * st.B;
        h = fmaf(st.a, h, bt);
        prod *= st.a;
        if (p.cache) {
          cache_a[n * b.nthr + b.tid] = st.a;
          cache_b[n * b.nthr + b.tid] = bt;
        }
      }
    }
    prod_s[b.tid] = prod;
    loc_s[b.tid] = h;
    __syncthreads();
    // 2. the states entering the chunks: the checkpoints
    n1_scan_chunks(p, b, prod_s, loc_s, cin_s, reverse,
                   p.ck ? p.ck + (b.img * 4 + k) * p.n_chunks * static_cast<long long>(p.D)
                        : nullptr);
    __syncthreads();
    // 3. the chunk again from its state, and the merge into y
    h = cin_s[b.tid];
    N1Pos pos(t_first, column, p.H, p.W);
    for (int n = 0; n < b.cnt; ++n, pos.step(reverse)) {
      const int l = pos.l;
      float a, bt, C, u;
      if (p.cache) {
        a = cache_a[n * b.nthr + b.tid];
        bt = cache_b[n * b.nthr + b.tid];
        C = to_f32(n1_row(p, xdbl, l)[p.bc_off + k * p.bc_k + 1]);
        u = d_k != 0.f ? to_f32(x[static_cast<long long>(l) * p.D + b.cc]) : 0.f;
      } else {
        const N1Step st = n1_step(p, b, x, xdbl, wdt, l, k, a_k, bias_k);
        a = st.a;
        bt = st.delta * st.u * st.B;
        C = st.C;
        u = st.u;
      }
      h = fmaf(a, h, bt);
      if (b.active) n1_merge(y, s, static_cast<long long>(l) * p.D + b.c, k, fmaf(C, h, u * d_k));
    }
  }
}

__device__ __forceinline__ void store_dpre(const N1Params& p, long long i, float v) {
  if (p.dpre_bf16) {
    static_cast<__nv_bfloat16*>(p.dpre)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p.dpre)[i] = v;
  }
}

// The dB / dC terms of up to kN1Seg positions of a warp, summed over its
// lanes: lane q < kN1Seg adds up dB of slot q, lane 16 + q dC of slot q,
// and adds the sum into the projections' gradient.
__device__ __forceinline__ void n1_flush_dbc(const N1Params& p, const N1Block& b, int k,
                                             float* red, const int* pos_s, int used,
                                             float* dxdbl) {
  __syncwarp();
  const int which = b.tx >> 4, q = b.tx & 15;
  if (q < used) {
    const float* rowv = red + (which * kN1Seg + q) * (kN1Channels + 1);
    float v = 0.f;
#pragma unroll 8
    for (int lane = 0; lane < kN1Channels; ++lane) v += rowv[lane];
    atomicAdd(dxdbl + static_cast<long long>(pos_s[q]) * p.row + p.bc_off + k * p.bc_k + which,
              v);
  }
  __syncwarp();
}

template <typename T>
__global__ void N1_BOUNDS ss2d_n1_bwd_kernel(N1Params p) {
  extern __shared__ float n1_smem[];
  const N1Block b = n1_block(p);
  float* wdt_s = n1_smem;                              // R x 32
  float* prod_s = wdt_s + p.R * kN1Channels;           // n_chunks x 32, three arrays
  float* loc_s = prod_s + b.nthr;
  float* cin_s = loc_s + b.nthr;
  // per warp: dB and dC terms of kN1Seg positions, and the positions
  float* red_all = cin_s + b.nthr;
  float* red = red_all + b.j * (2 * kN1Seg * (kN1Channels + 1));
  int* pos_all = reinterpret_cast<int*>(red_all + p.n_chunks * (2 * kN1Seg * (kN1Channels + 1)));
  int* pos_s = pos_all + b.j * kN1Seg;
  float* cache_h = reinterpret_cast<float*>(pos_all + p.n_chunks * kN1Seg);  // chunk x nthr (cache)
  float* cache_a = cache_h + p.chunk * b.nthr;
  const long long plane = static_cast<long long>(b.L) * p.D;
  const T* x = static_cast<const T*>(p.x) + b.img * plane;
  const T* xdbl = static_cast<const T*>(p.xdbl) + b.img * b.L * p.row;
  const float* gy = p.g + b.img * plane;
  float* hs = p.hs ? p.hs + b.img * plane : nullptr;
  float* s = p.s + b.img * plane;
  float* du = p.du + b.img * plane;
  const long long dpre0 = b.img * plane * 4;
  float* dxdbl = p.dxdbl + b.img * b.L * p.row;

  for (int i = 0; i < 4; ++i) {
    const int k = (i >> 1) | ((i & 1) << 1);
    const bool column = k & 1, reverse = k >= 2;
    const float a_k = p.A[k * p.D + b.cc], d_k = p.Dk[k * p.D + b.cc];
    const float bias_k = p.bias[k * p.D + b.cc];
    const float* wdt = wdt_s + b.tx;
    __syncthreads();
    n1_load_wdt(p, b, k, wdt_s);
    __syncthreads();
    const float h_in =
        p.ck[((b.img * 4 + k) * p.n_chunks + b.j) * static_cast<long long>(p.D) + b.cc];
    const int t_first = reverse ? b.t0 + b.cnt - 1 : b.t0;
    const int t_last = reverse ? b.t0 : b.t0 + b.cnt - 1;
    // h at step n of the chunk (in the direction's order) at position l
    auto h_at = [&](int n, int l) {
      return p.cache ? cache_h[n * b.nthr + b.tid] : hs[static_cast<long long>(l) * p.D + b.cc];
    };
    // a. h from the checkpoint (kept in shared memory, or the scratch); the product of a
    float h = h_in, prod = 1.f;
    {
      N1Pos pos(t_first, column, p.H, p.W);
      for (int n = 0; n < b.cnt; ++n, pos.step(reverse)) {
        const N1Step st = n1_step(p, b, x, xdbl, wdt, pos.l, k, a_k, bias_k);
        h = fmaf(st.a, h, st.delta * st.u * st.B);
        prod *= st.a;
        if (p.cache) {
          cache_h[n * b.nthr + b.tid] = h;
          cache_a[n * b.nthr + b.tid] = st.a;
        } else if (b.active) {
          hs[static_cast<long long>(pos.l) * p.D + b.c] = h;
        }
      }
    }
    // b. the adjoint's chunk value from zero, against the order:
    //    lambda = C dy + gl, gl = a lambda
    float gl = 0.f;
    {
      N1Pos pos(t_last, column, p.H, p.W);
      for (int n = b.cnt - 1; n >= 0; --n, pos.step(!reverse)) {
        const int l = pos.l;
        float a, C;
        if (p.cache) {
          a = cache_a[n * b.nthr + b.tid];
          C = to_f32(n1_row(p, xdbl, l)[p.bc_off + k * p.bc_k + 1]);
        } else {
          const N1Step st = n1_step(p, b, x, xdbl, wdt, l, k, a_k, bias_k);
          a = st.a;
          C = st.C;
        }
        gl = a * fmaf(C, gy[static_cast<long long>(l) * p.D + b.cc], gl);
      }
    }
    prod_s[b.tid] = prod;
    loc_s[b.tid] = gl;
    __syncthreads();
    n1_scan_chunks(p, b, prod_s, loc_s, cin_s, !reverse, nullptr);
    __syncthreads();
    // c. the gradients, against the order from the adjoint entering the chunk
    float gcar = cin_s[b.tid];
    float s_bias = 0.f, s_a = 0.f, s_d = 0.f;
    N1Pos pos(t_last, column, p.H, p.W);
    float h_cur = b.cnt > 0 ? h_at(b.cnt - 1, pos.l) : 0.f;
    int used = 0;
    for (int n = b.cnt - 1; n >= 0; --n) {
      const int l = pos.l;
      const long long o = static_cast<long long>(l) * p.D + b.cc;
      pos.step(!reverse);  // now at n - 1
      const float h_prev = n == 0 ? h_in : h_at(n - 1, pos.l);
      const N1Step st = n1_step(p, b, x, xdbl, wdt, l, k, a_k, bias_k);
      const float dy = gy[o];
      const float lam = fmaf(st.C, dy, gcar);
      const float du_k = fmaf(lam * st.delta, st.B, dy * d_k);
      const float dexp = lam * h_prev * st.a;
      const float ddelta = fmaf(lam * st.u, st.B, dexp * a_k);
      const float dp = ddelta / (1.f + expf(-st.z));
      red[used * (kN1Channels + 1) + b.tx] = b.active ? lam * st.delta * st.u : 0.f;
      red[(kN1Seg + used) * (kN1Channels + 1) + b.tx] = b.active ? dy * h_cur : 0.f;
      if (b.tx == 0) pos_s[used] = l;
      if (++used == kN1Seg) {
        n1_flush_dbc(p, b, k, red, pos_s, used, dxdbl);
        used = 0;
      }
      s_bias += dp;
      s_a += dexp * st.delta;
      s_d += dy * st.u;
      gcar = st.a * lam;
      h_cur = h_prev;
      if (!b.active) continue;
      store_dpre(p, dpre0 + (static_cast<long long>(l) * 4 + k) * p.D + b.c, dp);
      n1_merge(du, s, static_cast<long long>(l) * p.D + b.c, k, du_k);
    }
    if (used > 0) n1_flush_dbc(p, b, k, red, pos_s, used, dxdbl);
    // the block's sums over its chunks, one atomic per channel
    __syncthreads();  // every thread has read cin_s
    prod_s[b.tid] = s_bias;
    loc_s[b.tid] = s_a;
    cin_s[b.tid] = s_d;
    __syncthreads();
    if (b.j == 0 && b.active) {
      float sb = 0.f, sa = 0.f, sd = 0.f;
      for (int jj = 0; jj < p.n_chunks; ++jj) {
        sb += prod_s[jj * kN1Channels + b.tx];
        sa += loc_s[jj * kN1Channels + b.tx];
        sd += cin_s[jj * kN1Channels + b.tx];
      }
      atomicAdd(p.dbias + k * p.D + b.c, sb);
      atomicAdd(p.dA + k * p.D + b.c, sa);
      atomicAdd(p.dD + k * p.D + b.c, sd);
    }
  }
}

// Dynamic shared memory of a launch, in bytes.
long long n1_smem_bytes(const N1Params& p, bool backward) {
  const long long nthr = static_cast<long long>(p.n_chunks) * kN1Channels;
  long long words = p.R * kN1Channels + 3 * nthr;
  if (backward) words += p.n_chunks * (2 * kN1Seg * (kN1Channels + 1) + kN1Seg);
  if (p.cache) words += 2 * p.chunk * nthr;
  return 4 * words;
}

constexpr int kMaxDynSmem = 227 * 1024;

// Allow a kernel the card's largest dynamic shared memory, once (outside
// any stream capture that a later launch may be part of, it changes
// nothing on the stream).
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  done = err == cudaSuccess;
  return err;
}

template <typename T>
cudaError_t launch_n1(const N1Params& p, int B, bool backward, cudaStream_t s) {
  static bool fwd_ready = false, bwd_ready = false;
  const dim3 grid(ceil_div(p.D, kN1Channels), B);
  const dim3 block(kN1Channels, p.n_chunks);
  const long long smem = n1_smem_bytes(p, backward);
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  const cudaError_t err = backward ? allow_max_smem(ss2d_n1_bwd_kernel<T>, bwd_ready)
                                   : allow_max_smem(ss2d_n1_fwd_kernel<T>, fwd_ready);
  if (err != cudaSuccess) return err;
  if (backward) {
    ss2d_n1_bwd_kernel<T><<<grid, block, smem, s>>>(p);
  } else {
    ss2d_n1_fwd_kernel<T><<<grid, block, smem, s>>>(p);
  }
  return cudaGetLastError();
}

cudaError_t run_n1(N1Params& p, int B, int dtype, bool backward, void* stream) {
  const long long L = static_cast<long long>(p.H) * p.W;
  if (B < 1 || B > 65535 || p.H < 1 || p.W < 1 || p.D < 1 || p.R < 1 || p.R > kN1MaxR ||
      p.chunk < 1 || p.row < 1 || (backward && !p.hs && !p.cache))
    return cudaErrorInvalidValue;
  p.n_chunks = ceil_div(L, p.chunk);
  if (p.n_chunks > kN1MaxChunks) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_n1<float>(p, B, backward, s);
  if (dtype == kBF16) return launch_n1<__nv_bfloat16>(p, B, backward, s);
  return cudaErrorInvalidValue;
}

}  // namespace n1v1
}  // namespace xfm

using namespace xfm;
using namespace xfm::n1v1;

// layout: (row, rank_k, bc_off, bc_k) of the projection rows, see N1Params.
extern "C" int xfm_ss2d_n1_fwd_v1(const void* x, const void* xdbl, const float* w_dt,
                                  const float* A, const float* Dk, const float* bias, float* y,
                                  float* s, float* ck, int B, int H, int W, int D, int R,
                                  int chunk, int row, int rank_k, int bc_off, int bc_k, int cache,
                                  int dtype, void* stream) {
  N1Params p{};
  p.x = x;
  p.xdbl = xdbl;
  p.w_dt = w_dt;
  p.A = A;
  p.Dk = Dk;
  p.bias = bias;
  p.y = y;
  p.s = s;
  p.ck = ck;
  p.H = H;
  p.W = W;
  p.D = D;
  p.R = R;
  p.chunk = chunk;
  p.row = row;
  p.rank_k = rank_k;
  p.bc_off = bc_off;
  p.bc_k = bc_k;
  p.cache = cache;
  return run_n1(p, B, dtype, false, stream);
}

extern "C" int xfm_ss2d_n1_bwd_v1(const void* x, const void* xdbl, const float* w_dt,
                                  const float* A, const float* Dk, const float* bias, float* ck,
                                  const float* g, float* hs, float* s, float* du, void* dpre,
                                  float* dxdbl, float* dbias, float* dA, float* dD, int B, int H,
                                  int W, int D, int R, int chunk, int row, int rank_k, int bc_off,
                                  int bc_k, int cache, int dpre_dtype, int dtype, void* stream) {
  N1Params p{};
  p.x = x;
  p.xdbl = xdbl;
  p.w_dt = w_dt;
  p.A = A;
  p.Dk = Dk;
  p.bias = bias;
  p.ck = ck;
  p.g = g;
  p.hs = hs;
  p.s = s;
  p.du = du;
  p.dpre = dpre;
  p.dxdbl = dxdbl;
  p.dbias = dbias;
  p.dA = dA;
  p.dD = dD;
  p.H = H;
  p.W = W;
  p.D = D;
  p.R = R;
  p.chunk = chunk;
  p.row = row;
  p.rank_k = rank_k;
  p.bc_off = bc_off;
  p.bc_k = bc_k;
  p.cache = cache;
  p.dpre_bf16 = dpre_dtype == kBF16;
  if (!ck || (dpre_dtype != kF32 && dpre_dtype != kBF16)) return cudaErrorInvalidValue;
  return run_n1(p, B, dtype, true, stream);
}
