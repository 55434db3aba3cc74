// Kernels 11 and 12: the d_state-1 cross2d SS2D core with the rank->D
// delta projection in the kernel, and its backward.
//
// Replaces xfmamba_tpu/ops/selective_scan_pallas.py::_scan_kernel_n1p
// (:298, pallas_call :414) and ::_scan_kernel_n1p_bwd (:440, pallas_call
// :618).  For the four cross2d directions k of each (image, channel) chain
// (0 row_f, 1 col_f, 2 row_r, 3 col_r; the column ones walk
// t = w * H + h, the reverse ones from the last t to the first):
//   delta = softplus20(sum_r rank[l, k, r] * w_dt[k, r, c] + bias[k, c])
//   a = exp(delta * A[k, c]),  h = a * h + delta * u[l, c] * B[l, k]
//   y_k[l, c] = C[l, k] * h + Ds[k, c] * u[l, c]
//   y = (y_0 + y_2) + (y_1 + y_3)   (float32, the order of the JAX merge)
//
// Design: a two-level chunked scan.  A block holds 32 channels of one
// image (threadIdx.x, one warp) times n_chunks <= 16 chunks of L
// (threadIdx.y).  For each direction:
//   1. each thread reduces its chunk to the pair (prod a, h from 0);
//   2. one thread per channel scans the pairs across the chunks: the state
//      entering each chunk, written out as the checkpoint;
//   3. each thread walks its chunk again from that state and writes y.
// The walk of step 3 recomputes delta rather than storing it.  Chunks are
// by data position, so a forward direction and its reverse visit the same
// positions in the same thread: y_0 + y_2 needs no synchronisation; y_1
// waits in a float32 scratch for y_3, and the __syncthreads of steps 1-2
// order the row threads' writes of y before the column threads' reads.
// The backward (kernel 12) runs, per direction: a forward walk from the
// checkpoint storing h to a float32 scratch; a walk against the order
// reducing the adjoint to its chunk pair (the same prod a, and the
// adjoint's value from zero); the scan of those pairs across the chunks
// (the adjoint flows against the direction); a last walk against the order
// with the gradients.  dB and dC (sums over channels) are warp sums and one
// atomic per warp; dbias, dA, dD (sums over images and positions) are block
// sums and one atomic per block and channel.
//
// What bounds it on the H100: the minimum traffic is x, the projections
// and y (kernel 11) or x, g, du, dpre and the projections' gradient
// (kernel 12) once each, in float32 about 0.35 ms for the 21 calls of a
// 32-image forward at 3.35 TB/s; the arithmetic (R FMAs, two exp and a
// log1p per step) is below that at 67 TFLOP/s.  This first version walks
// every chunk two (forward) or three (backward) times with the delta
// recompute, rereads x and the projections from L2, and keeps one chain
// step per thread: at stage 0 a block does 4 x 2 x 196 dependent steps per
// thread, so latency, not bandwidth, sets its time.
#include "common.cuh"

namespace xfm {

constexpr int kN1Channels = 32;  // channels of a block: one warp
constexpr int kN1MaxChunks = 16;
constexpr int kN1MaxR = 64;

struct N1Params {
  const void* x;       // (B, L, D), NHWC
  const void* xdbl;    // (B, L, 4, R + 2): [rank | B | C] of each direction
  const float* w_dt;   // (4, R, D)
  const float* A;      // (4, D) = -exp(A_logs)
  const float* Dk;     // (4, D)
  const float* bias;   // (4, D)
  float* ck;           // (B, 4, n_chunks, D): state entering each chunk
  float* y;            // (B, L, D) forward output
  float* s;            // (B, L, D) scratch of the column-pair merge
  const float* g;      // (B, L, D) gradient of y
  float* hs;           // (B, L, D) scratch: h of the current direction
  float* du;           // (B, L, D)
  float* dpre;         // (B, L, 4, D) gradient of delta before softplus
  float* dxdbl;        // (B, L, 4, R + 2): dB, dC columns accumulated
  float* dbias;        // (4, D) accumulated
  float* dA;           // (4, D) accumulated
  float* dD;           // (4, D) accumulated
  int H, W, D, R, chunk, n_chunks;
};

// Per-block constants and the position walked at step n of a chunk.
struct N1Block {
  int tx, j, c, cc, L, RC, t0, cnt;
  bool active;
  long long img;
};

__device__ __forceinline__ N1Block n1_block(const N1Params& p) {
  N1Block b;
  b.tx = threadIdx.x;
  b.j = threadIdx.y;
  b.c = blockIdx.x * kN1Channels + b.tx;
  b.active = b.c < p.D;
  b.cc = b.active ? b.c : p.D - 1;  // an idle lane loads a valid channel
  b.L = p.H * p.W;
  b.RC = p.R + 2;
  b.t0 = b.j * p.chunk;
  b.cnt = min(p.chunk, b.L - b.t0);
  b.img = blockIdx.y;
  return b;
}

// Row-major position of data index t of a direction's flattening.
__device__ __forceinline__ int n1_pos(int t, bool column, int H, int W) {
  return column ? (t % H) * W + t / H : t;
}

// w_dt of the block's channels for the four directions, [k][r][lane].
__device__ __forceinline__ void n1_load_wdt(const N1Params& p, float* wdt_s) {
  const int c0 = blockIdx.x * kN1Channels;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < 4 * p.R * kN1Channels; i += nthreads) {
    const int kr = i / kN1Channels, lane = i % kN1Channels;
    wdt_s[i] = c0 + lane < p.D ? p.w_dt[static_cast<long long>(kr) * p.D + c0 + lane] : 0.f;
  }
}

// One step's operands: z (pre-softplus delta), delta, a, u, B, C.
struct N1Step {
  float z, delta, a, u, B, C;
};

template <typename T>
__device__ __forceinline__ N1Step n1_step(const N1Params& p, const N1Block& b, const T* x,
                                          const T* xdbl, const float* wdt, int l, int k,
                                          float a_k, float bias_k) {
  const T* xd = xdbl + (static_cast<long long>(l) * 4 + k) * b.RC;
  N1Step s;
  float z = 0.f;
  for (int r = 0; r < p.R; ++r) z = fmaf(to_f32(xd[r]), wdt[r * kN1Channels], z);
  s.z = z + bias_k;
  s.delta = softplus20(s.z);
  s.a = expf(s.delta * a_k);
  s.u = to_f32(x[static_cast<long long>(l) * p.D + b.cc]);
  s.B = to_f32(xd[p.R]);
  s.C = to_f32(xd[p.R + 1]);
  return s;
}

// The value entering each chunk: carry = prod * carry + loc over the
// chunks, from chunk 0 up or (backward) from the last down.  Thread
// j == 0 of each channel runs it; the caller synchronises around it.
__device__ __forceinline__ void n1_scan_chunks(const N1Params& p, const N1Block& b,
                                               float (*prod_s)[kN1Channels],
                                               float (*loc_s)[kN1Channels],
                                               float (*cin_s)[kN1Channels], bool backward,
                                               float* ck_out) {
  if (b.j != 0) return;
  float carry = 0.f;
  for (int m = 0; m < p.n_chunks; ++m) {
    const int jj = backward ? p.n_chunks - 1 - m : m;
    cin_s[jj][b.tx] = carry;
    if (ck_out && b.active) ck_out[static_cast<long long>(jj) * p.D + b.c] = carry;
    carry = fmaf(prod_s[jj][b.tx], carry, loc_s[jj][b.tx]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kN1Channels* kN1MaxChunks) ss2d_n1_fwd_kernel(N1Params p) {
  __shared__ float wdt_s[4 * kN1MaxR * kN1Channels];
  __shared__ float prod_s[kN1MaxChunks][kN1Channels];
  __shared__ float loc_s[kN1MaxChunks][kN1Channels];
  __shared__ float cin_s[kN1MaxChunks][kN1Channels];
  const N1Block b = n1_block(p);
  const long long plane = static_cast<long long>(b.L) * p.D;
  const T* x = static_cast<const T*>(p.x) + b.img * plane;
  const T* xdbl = static_cast<const T*>(p.xdbl) + b.img * b.L * 4 * b.RC;
  float* y = p.y + b.img * plane;
  float* s = p.s + b.img * plane;
  n1_load_wdt(p, wdt_s);
  __syncthreads();

  for (int i = 0; i < 4; ++i) {
    const int k = (i >> 1) | ((i & 1) << 1);  // row_f, row_r, col_f, col_r
    const bool column = k & 1, reverse = k >= 2;
    const float a_k = p.A[k * p.D + b.cc], d_k = p.Dk[k * p.D + b.cc];
    const float bias_k = p.bias[k * p.D + b.cc];
    const float* wdt = wdt_s + k * p.R * kN1Channels + b.tx;
    // 1. the chunk's pair
    float prod = 1.f, h = 0.f;
    for (int n = 0; n < b.cnt; ++n) {
      const int t = reverse ? b.t0 + b.cnt - 1 - n : b.t0 + n;
      const N1Step st = n1_step(p, b, x, xdbl, wdt, n1_pos(t, column, p.H, p.W), k, a_k, bias_k);
      h = fmaf(st.a, h, st.delta * st.u * st.B);
      prod *= st.a;
    }
    prod_s[b.j][b.tx] = prod;
    loc_s[b.j][b.tx] = h;
    __syncthreads();
    // 2. the states entering the chunks: the checkpoints
    n1_scan_chunks(p, b, prod_s, loc_s, cin_s, reverse,
                   p.ck + (b.img * 4 + k) * p.n_chunks * static_cast<long long>(p.D));
    __syncthreads();
    // 3. the chunk again from its state, and the merge into y
    h = cin_s[b.j][b.tx];
    for (int n = 0; n < b.cnt; ++n) {
      const int t = reverse ? b.t0 + b.cnt - 1 - n : b.t0 + n;
      const int l = n1_pos(t, column, p.H, p.W);
      const N1Step st = n1_step(p, b, x, xdbl, wdt, l, k, a_k, bias_k);
      h = fmaf(st.a, h, st.delta * st.u * st.B);
      const float yk = fmaf(st.C, h, st.u * d_k);
      if (!b.active) continue;
      const long long o = static_cast<long long>(l) * p.D + b.c;
      if (k == 0) {
        y[o] = yk;
      } else if (k == 2) {
        y[o] += yk;
      } else if (k == 1) {
        s[o] = yk;
      } else {
        y[o] += s[o] + yk;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kN1Channels* kN1MaxChunks) ss2d_n1_bwd_kernel(N1Params p) {
  __shared__ float wdt_s[4 * kN1MaxR * kN1Channels];
  __shared__ float prod_s[kN1MaxChunks][kN1Channels];
  __shared__ float loc_s[kN1MaxChunks][kN1Channels];
  __shared__ float cin_s[kN1MaxChunks][kN1Channels];
  const N1Block b = n1_block(p);
  const long long plane = static_cast<long long>(b.L) * p.D;
  const T* x = static_cast<const T*>(p.x) + b.img * plane;
  const T* xdbl = static_cast<const T*>(p.xdbl) + b.img * b.L * 4 * b.RC;
  const float* gy = p.g + b.img * plane;
  float* hs = p.hs + b.img * plane;
  float* s = p.s + b.img * plane;
  float* du = p.du + b.img * plane;
  float* dpre = p.dpre + b.img * plane * 4;
  float* dxdbl = p.dxdbl + b.img * b.L * 4 * b.RC;
  n1_load_wdt(p, wdt_s);
  __syncthreads();

  for (int i = 0; i < 4; ++i) {
    const int k = (i >> 1) | ((i & 1) << 1);
    const bool column = k & 1, reverse = k >= 2;
    const float a_k = p.A[k * p.D + b.cc], d_k = p.Dk[k * p.D + b.cc];
    const float bias_k = p.bias[k * p.D + b.cc];
    const float* wdt = wdt_s + k * p.R * kN1Channels + b.tx;
    const float h_in =
        p.ck[((b.img * 4 + k) * p.n_chunks + b.j) * static_cast<long long>(p.D) + b.cc];
    // the chunk's positions in the direction's order: n -> t
    auto t_of = [&](int n) { return reverse ? b.t0 + b.cnt - 1 - n : b.t0 + n; };
    // a. h from the checkpoint, kept in the scratch; the product of a
    float h = h_in, prod = 1.f;
    for (int n = 0; n < b.cnt; ++n) {
      const int l = n1_pos(t_of(n), column, p.H, p.W);
      const N1Step st = n1_step(p, b, x, xdbl, wdt, l, k, a_k, bias_k);
      h = fmaf(st.a, h, st.delta * st.u * st.B);
      prod *= st.a;
      if (b.active) hs[static_cast<long long>(l) * p.D + b.c] = h;
    }
    // b. the adjoint's chunk value from zero, against the order:
    //    lambda = C dy + gl, gl = a lambda
    float gl = 0.f;
    for (int n = b.cnt - 1; n >= 0; --n) {
      const int l = n1_pos(t_of(n), column, p.H, p.W);
      const N1Step st = n1_step(p, b, x, xdbl, wdt, l, k, a_k, bias_k);
      gl = st.a * fmaf(st.C, gy[static_cast<long long>(l) * p.D + b.cc], gl);
    }
    prod_s[b.j][b.tx] = prod;
    loc_s[b.j][b.tx] = gl;
    __syncthreads();
    n1_scan_chunks(p, b, prod_s, loc_s, cin_s, !reverse, nullptr);
    __syncthreads();
    // c. the gradients, against the order from the adjoint entering the chunk
    float gcar = cin_s[b.j][b.tx];
    float s_bias = 0.f, s_a = 0.f, s_d = 0.f;
    float h_cur = hs[static_cast<long long>(n1_pos(t_of(b.cnt - 1), column, p.H, p.W)) * p.D + b.cc];
    for (int n = b.cnt - 1; n >= 0; --n) {
      const int l = n1_pos(t_of(n), column, p.H, p.W);
      const long long o = static_cast<long long>(l) * p.D + b.cc;
      const float h_prev =
          n == 0 ? h_in
                 : hs[static_cast<long long>(n1_pos(t_of(n - 1), column, p.H, p.W)) * p.D + b.cc];
      const N1Step st = n1_step(p, b, x, xdbl, wdt, l, k, a_k, bias_k);
      const float dy = gy[o];
      const float lam = fmaf(st.C, dy, gcar);
      const float du_k = fmaf(lam * st.delta, st.B, dy * d_k);
      const float dexp = lam * h_prev * st.a;
      const float ddelta = fmaf(lam * st.u, st.B, dexp * a_k);
      const float dp = ddelta / (1.f + expf(-st.z));
      const float db = warp_sum(b.active ? lam * st.delta * st.u : 0.f);
      const float dc = warp_sum(b.active ? dy * h_cur : 0.f);
      if (b.tx == 0) {
        float* dxd = dxdbl + (static_cast<long long>(l) * 4 + k) * b.RC;
        atomicAdd(dxd + p.R, db);
        atomicAdd(dxd + p.R + 1, dc);
      }
      s_bias += dp;
      s_a += dexp * st.delta;
      s_d += dy * st.u;
      gcar = st.a * lam;
      h_cur = h_prev;
      if (!b.active) continue;
      dpre[(static_cast<long long>(l) * 4 + k) * p.D + b.c] = dp;
      if (k == 0) {
        du[o] = du_k;
      } else if (k == 2) {
        du[o] += du_k;
      } else if (k == 1) {
        s[o] = du_k;
      } else {
        du[o] += s[o] + du_k;
      }
    }
    // the block's sums over its chunks, one atomic per channel
    prod_s[b.j][b.tx] = s_bias;
    loc_s[b.j][b.tx] = s_a;
    cin_s[b.j][b.tx] = s_d;
    __syncthreads();
    if (b.j == 0 && b.active) {
      float sb = 0.f, sa = 0.f, sd = 0.f;
      for (int jj = 0; jj < p.n_chunks; ++jj) {
        sb += prod_s[jj][b.tx];
        sa += loc_s[jj][b.tx];
        sd += cin_s[jj][b.tx];
      }
      atomicAdd(p.dbias + k * p.D + b.c, sb);
      atomicAdd(p.dA + k * p.D + b.c, sa);
      atomicAdd(p.dD + k * p.D + b.c, sd);
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_n1(const N1Params& p, int B, bool backward, cudaStream_t s) {
  const dim3 grid(ceil_div(p.D, kN1Channels), B);
  const dim3 block(kN1Channels, p.n_chunks);
  if (backward) {
    ss2d_n1_bwd_kernel<T><<<grid, block, 0, s>>>(p);
  } else {
    ss2d_n1_fwd_kernel<T><<<grid, block, 0, s>>>(p);
  }
  return cudaGetLastError();
}

cudaError_t run_n1(N1Params& p, int B, int dtype, bool backward, void* stream) {
  const long long L = static_cast<long long>(p.H) * p.W;
  if (B < 1 || B > 65535 || p.H < 1 || p.W < 1 || p.D < 1 || p.R < 1 || p.R > kN1MaxR ||
      p.chunk < 1)
    return cudaErrorInvalidValue;
  p.n_chunks = ceil_div(L, p.chunk);
  if (p.n_chunks > kN1MaxChunks) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_n1<float>(p, B, backward, s);
  if (dtype == kBF16) return launch_n1<__nv_bfloat16>(p, B, backward, s);
  return cudaErrorInvalidValue;
}

}  // namespace xfm

using namespace xfm;

extern "C" int xfm_ss2d_n1_fwd(const void* x, const void* xdbl, const float* w_dt, const float* A,
                               const float* Dk, const float* bias, float* y, float* s, float* ck,
                               int B, int H, int W, int D, int R, int chunk, int dtype,
                               void* stream) {
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
  return run_n1(p, B, dtype, false, stream);
}

extern "C" int xfm_ss2d_n1_bwd(const void* x, const void* xdbl, const float* w_dt, const float* A,
                               const float* Dk, const float* bias, float* ck, const float* g,
                               float* hs, float* s, float* du, float* dpre, float* dxdbl,
                               float* dbias, float* dA, float* dD, int B, int H, int W, int D,
                               int R, int chunk, int dtype, void* stream) {
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
  return run_n1(p, B, dtype, true, stream);
}
