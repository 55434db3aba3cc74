// The first design of kernels 13 and 14 (the grouped selective scan of one
// direction and its adjoint), kept under the _v1 entry points for timing
// beside the redesign in grouped_scan_lanes.cu.
//
// Replaces xfmamba_tpu/ops/selective_scan_pallas.py::_grouped_scan_kernel
// (:838, pallas_call :954) and ::_grouped_scan_kernel_bwd (:979,
// pallas_call :1137).  Channels are K groups of C (kc = k * C + c); group k
// reads B[b, t, k, :] and C[b, t, k, :].  Per (image, channel) chain:
//   delta = softplus20(delta_in[t, kc] + bias[kc])
//   h[n]  = exp(delta * A[kc, n]) * h[n] + delta * u[t, kc] * B[t, k, n]
//   y[t, kc] = sum_n C[t, k, n] * h[n] + D[kc] * u[t, kc]
// walked t = 0 .. L-1, or L-1 .. 0 with `reverse`.  The state entering each
// chunk of `chunk` positions, in scan order, is written out (the TPU's
// carr): ck[b, k, j, n, c] for data chunk j.
//
// Design.  One thread per chain with its N <= 16 states in registers; a
// block holds 128 channels of one (image, group), so the loads and stores
// of u, delta, dy, y, du and d(delta) are coalesced rows, and the chunk's
// B and C (chunk x N values shared by the whole block) are staged in shared
// memory once per chunk.  The TPU kernel instead steps a grid over
// (image, group, chunk, n) and scans each chunk in parallel in VMEM; here
// each thread walks its chain sequentially and the card's parallelism comes
// from the B * K * C chains (98,304 at the XFMamba-B Cross_SS2Dv5 call).
//
// The backward walks the chunks in adjoint order (the reverse of the scan
// order).  For each chunk it recomputes h from the chunk's checkpoint into
// a float32 scratch of one chunk of states per chain (B, K, chunk, N, C),
// then walks the chunk against the scan order with the adjoint
//   lambda[t] = C[t] * dy[t] + g,   g = a[t] * lambda[t]
// carrying g = a_edge * lambda across chunks (the TPU's lam and aedge in
// one register per state).  dB and dC (sums over the group's C channels)
// are reduced in the warp by a transposing butterfly (31 shuffles for the
// 2 x 16 values; lane l ends with value l) and added with one atomic per
// lane; dA, dD and dbias (sums over images and positions) stay in
// registers and take one atomic per thread and channel at the end.
//
// What bounds it on the H100: the forward moves u, delta, B, C, y and the
// checkpoints once (71 MB at the XFMamba-B step's (48, 49, 2048) N=16
// call, 0.021 ms at 3.35 TB/s) and does 7 N + 6 operations per step and
// chain (568 MFLOP there, 0.0085 ms at 67 TFLOP/s): bytes.  This first version is
// latency-bound: each thread runs its L steps one after the other (49 at
// the fusion maps, 3,136 at a 56 x 56 map), the checkpoints add N floats
// per chunk and chain, and the backward's scratch (0.2 GB at that call)
// goes through L2 and HBM.
#include "common.cuh"

namespace xfm {

constexpr int kGroupedThreads = 128;  // channels of one (image, group) per block
constexpr int kGroupedMaxN = 16;
constexpr int kGroupedMaxChunk = 64;

struct GroupedParams {
  const void* u;      // (B, L, K * C)
  const void* delta;  // (B, L, K * C), before bias and softplus
  const float* A;     // (K * C, N)
  const void* Bm;     // (B, L, K, N)
  const void* Cm;     // (B, L, K, N)
  const float* Dv;    // (K * C,) or null
  const float* bias;  // (K * C,) or null
  float* y;           // (B, L, K * C)
  float* ck;          // (B, K, n_chunks, N, C): state entering each chunk
  const float* dy;    // (B, L, K * C) gradient of y
  float* hs;          // (B, K, slots, N, C) scratch: one chunk of states per chain
  float* du;          // (B, L, K * C)
  float* ddelta;      // (B, L, K * C) gradient of delta_in
  float* dB;          // (B, L, K, N) accumulated
  float* dC;          // (B, L, K, N) accumulated
  float* dA;          // (K * C, N) accumulated
  float* dD;          // (K * C,) accumulated
  float* dbias;       // (K * C,) accumulated
  int L, K, C, N, chunk, n_chunks, slots, reverse;
};

// The block's chain: image, group, channel (an idle lane past C loads the
// last channel and writes nothing).
struct GroupedChain {
  int k, c, cc;
  bool active;
  long long img, KC, kc;
};

__device__ __forceinline__ GroupedChain grouped_chain(const GroupedParams& p) {
  GroupedChain ch;
  ch.c = blockIdx.x * kGroupedThreads + threadIdx.x;
  ch.k = blockIdx.y;
  ch.img = blockIdx.z;
  ch.active = ch.c < p.C;
  ch.cc = ch.active ? ch.c : p.C - 1;
  ch.KC = static_cast<long long>(p.K) * p.C;
  ch.kc = static_cast<long long>(ch.k) * p.C + ch.cc;
  return ch;
}

// B and C of positions t0 .. t0 + cnt - 1 of the block's (image, group)
// into shared memory; the caller synchronises around it.
template <typename T>
__device__ __forceinline__ void grouped_stage_bc(const GroupedParams& p, const GroupedChain& ch,
                                                 int t0, int cnt,
                                                 float (*b_s)[kGroupedMaxN],
                                                 float (*c_s)[kGroupedMaxN]) {
  const T* Bm = static_cast<const T*>(p.Bm);
  const T* Cm = static_cast<const T*>(p.Cm);
  for (int i = threadIdx.x; i < cnt * p.N; i += blockDim.x) {
    const int pos = i / p.N, n = i % p.N;
    const long long o = ((ch.img * p.L + t0 + pos) * p.K + ch.k) * p.N + n;
    b_s[pos][n] = to_f32(Bm[o]);
    c_s[pos][n] = to_f32(Cm[o]);
  }
}

// Sums each of the 32 values over the warp: lane l returns the sum of v[l]
// (halving butterfly, 16 + 8 + 4 + 2 + 1 shuffles).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[2 * kGroupedMaxN]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int level = 4; level >= 0; --level) {
    const int w = 1 << level;
    const bool upper = lane & w;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      // both halves read at fixed indices first, so the array stays in registers
      const float lo = v[i], hi = v[i + w];
      v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, w);
    }
  }
  return v[0];
}

template <typename T>
__global__ void __launch_bounds__(kGroupedThreads) grouped_scan_fwd_kernel(GroupedParams p) {
  __shared__ float b_s[kGroupedMaxChunk][kGroupedMaxN];
  __shared__ float c_s[kGroupedMaxChunk][kGroupedMaxN];
  const GroupedChain ch = grouped_chain(p);
  const long long base = ch.img * p.L * ch.KC + ch.kc;
  const T* u = static_cast<const T*>(p.u) + base;
  const T* delta = static_cast<const T*>(p.delta) + base;
  float* y = p.y + base;
  const float d_k = p.Dv ? p.Dv[ch.kc] : 0.f;
  const float bias_k = p.bias ? p.bias[ch.kc] : 0.f;
  float a_n[kGroupedMaxN], h[kGroupedMaxN];
#pragma unroll
  for (int n = 0; n < kGroupedMaxN; ++n) {
    a_n[n] = n < p.N ? p.A[ch.kc * p.N + n] : 0.f;
    h[n] = 0.f;
  }
  for (int m = 0; m < p.n_chunks; ++m) {
    const int j = p.reverse ? p.n_chunks - 1 - m : m;
    const int t0 = j * p.chunk, cnt = min(p.chunk, p.L - t0);
    __syncthreads();
    grouped_stage_bc<T>(p, ch, t0, cnt, b_s, c_s);
    __syncthreads();
    if (ch.active) {
      float* ckj = p.ck + ((ch.img * p.K + ch.k) * p.n_chunks + j) * p.N * p.C + ch.c;
#pragma unroll
      for (int n = 0; n < kGroupedMaxN; ++n)
        if (n < p.N) ckj[static_cast<long long>(n) * p.C] = h[n];
    }
    for (int s = 0; s < cnt; ++s) {
      const int i = p.reverse ? cnt - 1 - s : s;
      const long long o = static_cast<long long>(t0 + i) * ch.KC;
      const float uv = to_f32(u[o]);
      const float dt = softplus20(to_f32(delta[o]) + bias_k);
      const float dtu = dt * uv;
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < kGroupedMaxN; ++n) {
        if (n < p.N) {
          h[n] = fmaf(expf(dt * a_n[n]), h[n], dtu * b_s[i][n]);
          yv = fmaf(c_s[i][n], h[n], yv);
        }
      }
      if (ch.active) y[o] = fmaf(uv, d_k, yv);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kGroupedThreads) grouped_scan_bwd_kernel(GroupedParams p) {
  __shared__ float b_s[kGroupedMaxChunk][kGroupedMaxN];
  __shared__ float c_s[kGroupedMaxChunk][kGroupedMaxN];
  const GroupedChain ch = grouped_chain(p);
  const int lane = threadIdx.x & 31;
  const long long base = ch.img * p.L * ch.KC + ch.kc;
  const T* u = static_cast<const T*>(p.u) + base;
  const T* delta = static_cast<const T*>(p.delta) + base;
  const float* dy = p.dy + base;
  float* du = p.du + base;
  float* ddelta = p.ddelta + base;
  // this chain's scratch: state n after chunk position i at (i * N + n) * C
  float* hs = p.hs + (ch.img * p.K + ch.k) * p.slots * p.N * p.C + ch.cc;
  const float d_k = p.Dv ? p.Dv[ch.kc] : 0.f;
  const float bias_k = p.bias ? p.bias[ch.kc] : 0.f;
  float a_n[kGroupedMaxN], g[kGroupedMaxN], h[kGroupedMaxN], dA_acc[kGroupedMaxN];
#pragma unroll
  for (int n = 0; n < kGroupedMaxN; ++n) {
    a_n[n] = n < p.N ? p.A[ch.kc * p.N + n] : 0.f;
    g[n] = 0.f;
    dA_acc[n] = 0.f;
  }
  float dD_acc = 0.f, dbias_acc = 0.f;
  for (int m = 0; m < p.n_chunks; ++m) {
    const int j = p.reverse ? m : p.n_chunks - 1 - m;  // adjoint order
    const int t0 = j * p.chunk, cnt = min(p.chunk, p.L - t0);
    __syncthreads();
    grouped_stage_bc<T>(p, ch, t0, cnt, b_s, c_s);
    __syncthreads();
    // 1. h from the checkpoint, in scan order, into the scratch
    const float* ckj = p.ck + ((ch.img * p.K + ch.k) * p.n_chunks + j) * p.N * p.C + ch.cc;
#pragma unroll
    for (int n = 0; n < kGroupedMaxN; ++n)
      h[n] = n < p.N ? ckj[static_cast<long long>(n) * p.C] : 0.f;
    for (int s = 0; s < cnt; ++s) {
      const int i = p.reverse ? cnt - 1 - s : s;
      const long long o = static_cast<long long>(t0 + i) * ch.KC;
      const float dt = softplus20(to_f32(delta[o]) + bias_k);
      const float dtu = dt * to_f32(u[o]);
#pragma unroll
      for (int n = 0; n < kGroupedMaxN; ++n) {
        if (n < p.N) {
          h[n] = fmaf(expf(dt * a_n[n]), h[n], dtu * b_s[i][n]);
          if (ch.active) hs[static_cast<long long>(i * p.N + n) * p.C] = h[n];
        }
      }
    }
    // 2. against the scan order: h holds the state after position i, the
    //    state before it comes from the scratch (or the checkpoint)
    for (int s = 0; s < cnt; ++s) {
      const int i = p.reverse ? s : cnt - 1 - s;
      const bool first = p.reverse ? i == cnt - 1 : i == 0;  // first of the chunk in scan order
      const int ip = p.reverse ? i + 1 : i - 1;
      const long long o = static_cast<long long>(t0 + i) * ch.KC;
      const float uv = to_f32(u[o]);
      const float z = to_f32(delta[o]) + bias_k;
      const float dt = softplus20(z);
      const float dtu = dt * uv;
      const float dyv = dy[o];
      float lam_b = 0.f, dd = 0.f;
      float v[2 * kGroupedMaxN];
#pragma unroll
      for (int n = 0; n < kGroupedMaxN; ++n) {
        v[n] = 0.f;
        v[kGroupedMaxN + n] = 0.f;
        if (n < p.N) {
          const float hp = first ? ckj[static_cast<long long>(n) * p.C]
                                 : hs[static_cast<long long>(ip * p.N + n) * p.C];
          const float a = expf(dt * a_n[n]);
          const float lam = fmaf(c_s[i][n], dyv, g[n]);
          lam_b = fmaf(lam, b_s[i][n], lam_b);
          const float dexp = lam * hp * a;
          dd = fmaf(dexp, a_n[n], dd);
          dA_acc[n] = fmaf(dexp, dt, dA_acc[n]);
          if (ch.active) {
            v[n] = lam * dtu;
            v[kGroupedMaxN + n] = dyv * h[n];
          }
          g[n] = a * lam;
          h[n] = hp;
        }
      }
      const float dz = fmaf(uv, lam_b, dd) * (z > 20.f ? 1.f : 1.f / (1.f + expf(-z)));
      if (ch.active) {
        du[o] = fmaf(lam_b, dt, dyv * d_k);
        ddelta[o] = dz;
        dD_acc = fmaf(dyv, uv, dD_acc);
        dbias_acc += dz;
      }
      const float sum = warp_transpose_sum(v);
      const int n = lane % kGroupedMaxN;
      if (n < p.N) {
        float* dst = lane < kGroupedMaxN ? p.dB : p.dC;
        atomicAdd(dst + ((ch.img * p.L + t0 + i) * p.K + ch.k) * p.N + n, sum);
      }
    }
  }
  if (!ch.active) return;
#pragma unroll
  for (int n = 0; n < kGroupedMaxN; ++n)
    if (n < p.N) atomicAdd(p.dA + ch.kc * p.N + n, dA_acc[n]);
  atomicAdd(p.dD + ch.kc, dD_acc);
  atomicAdd(p.dbias + ch.kc, dbias_acc);
}

cudaError_t run_grouped(GroupedParams& p, int B, int dtype, bool backward, void* stream) {
  if (B < 1 || B > 65535 || p.L < 1 || p.K < 1 || p.K > 65535 || p.C < 1 || p.N < 1 ||
      p.N > kGroupedMaxN || p.chunk < 1 || p.chunk > kGroupedMaxChunk)
    return cudaErrorInvalidValue;
  p.n_chunks = ceil_div(p.L, p.chunk);
  p.slots = min(p.chunk, p.L);
  const dim3 grid(ceil_div(p.C, kGroupedThreads), p.K, B);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    if (backward) grouped_scan_bwd_kernel<float><<<grid, kGroupedThreads, 0, s>>>(p);
    else grouped_scan_fwd_kernel<float><<<grid, kGroupedThreads, 0, s>>>(p);
  } else if (dtype == kBF16) {
    if (backward) grouped_scan_bwd_kernel<__nv_bfloat16><<<grid, kGroupedThreads, 0, s>>>(p);
    else grouped_scan_fwd_kernel<__nv_bfloat16><<<grid, kGroupedThreads, 0, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace xfm

using namespace xfm;

extern "C" int xfm_grouped_scan_fwd_v1(const void* u, const void* delta, const float* A,
                                       const void* Bm, const void* Cm, const float* Dv,
                                       const float* bias, float* y, float* ck, int B, int L, int K,
                                       int C, int N, int chunk, int reverse, int dtype,
                                       void* stream) {
  GroupedParams p{};
  p.u = u;
  p.delta = delta;
  p.A = A;
  p.Bm = Bm;
  p.Cm = Cm;
  p.Dv = Dv;
  p.bias = bias;
  p.y = y;
  p.ck = ck;
  p.L = L;
  p.K = K;
  p.C = C;
  p.N = N;
  p.chunk = chunk;
  p.reverse = reverse;
  return run_grouped(p, B, dtype, false, stream);
}

extern "C" int xfm_grouped_scan_bwd_v1(const void* u, const void* delta, const float* A,
                                       const void* Bm, const void* Cm, const float* Dv,
                                       const float* bias, float* ck, const float* dy, float* hs,
                                       float* du, float* ddelta, float* dB, float* dC, float* dA,
                                       float* dD, float* dbias, int B, int L, int K, int C, int N,
                                       int chunk, int reverse, int dtype, void* stream) {
  GroupedParams p{};
  p.u = u;
  p.delta = delta;
  p.A = A;
  p.Bm = Bm;
  p.Cm = Cm;
  p.Dv = Dv;
  p.bias = bias;
  p.ck = ck;
  p.dy = dy;
  p.hs = hs;
  p.du = du;
  p.ddelta = ddelta;
  p.dB = dB;
  p.dC = dC;
  p.dA = dA;
  p.dD = dD;
  p.dbias = dbias;
  p.L = L;
  p.K = K;
  p.C = C;
  p.N = N;
  p.chunk = chunk;
  p.reverse = reverse;
  return run_grouped(p, B, dtype, true, stream);
}
