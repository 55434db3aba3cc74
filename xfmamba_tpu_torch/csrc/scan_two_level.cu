// Two-level selective scans over whole H x W maps, parallel along L.
//
// One scan kernel serves three TPU kernels:
// - the four d_state-1 cross2d scans of the v1 whole-block kernel
//   xfmamba_tpu/ops/vss_block_pallas.py::_vss_block_kernel (:295, kernel 8),
//   rank form: the rank->D delta projection is done here, as the TPU kernel
//   does it on the MXU inside its body;
// - the v1 nk scan ::_nk_scan_kernel (:690, kernel 9): K traversal kinds x
//   N = 16 states from precomputed deltas, output in u's dtype;
// - xfmamba_tpu/ops/selective_scan_pallas.py::_scan_kernel (:73) and
//   ::_scan_kernel_n1 (:161) behind fused_cross_scan (kernel 10): the
//   cross2d core from precomputed deltas, B and C, any N <= 16, each
//   direction's C h + D_k u kept apart (rounded to the input dtype for
//   N = 1, as the Pallas kernel writes it) and merged in float32 as
//   (y_0 + y_2) + (y_1 + y_3), the order of _core_pallas_fwd_impl.
//
// The recurrence is the one of nk_scan.cu: for kind k (bit 0 column-major,
// bit 1 reversed) over the data index t of the kind's flattening (rows, or
// columns t = w * H + h):
//   delta = softplus20(z + bias[k]),  z = dts[l, k] or sum_r rank[l, k, r] * w_dt[k, r]
//   h[n]  = exp(delta * A[k, n]) * h[n] + delta * u[l] * B[l, k, n]
//   part[k, l] = sum_n C[l, k, n] * h[n]  (+ D_k[k] u[l] for kernel 10)
// and the merge kernel adds the parts: y = u * Dsum + part[0] + ... +
// part[K - 1] in kind order (kernels 8 and 9, the order of the TPU
// kernels' y accumulation), or the cross2d pair order (kernel 10).
//
// Design, the TPU kernel's two levels with the image row (row kinds) or
// column (column kinds) as the segment, as kernel 11 (ss2d_core_n1.cu)
// uses its chunk:
//   1. each thread reduces its chunk (`segs` consecutive segments in the
//      kind's traversal) to the pair (prod a, h from 0) for each state n;
//   2. one thread per channel chains the pairs of an image's chunks in
//      traversal order (from the last chunk down for the reversed kinds):
//      the state entering each chunk (the TPU kernel's _exclusive carry);
//   3. each thread walks its chunk again from that state and writes its
//      kind's part.
// A block holds 32 channels (threadIdx.x, one warp: coalesced NHWC rows,
// the per-position B, C and rank values are warp-wide broadcasts) times
// the chunks of one (image, kind) (threadIdx.y, at most 16); the grid is
// (channel tiles, images, kinds), so a batch of one image still gives
// D / 32 x 4 blocks per image at the backbone's stage 2 and 3.  Nothing of
// size (L, D, N) is stored: only the K float32 parts.
//
// What bounds it on the H100: each thread walks its chunk twice with the
// delta recomputed (2R FMAs in rank form, a softplus and N exps per step),
// so it is operation- and latency-bound; the minimum traffic (u, the
// deltas or ranks, B, C read once, y written once) is far below that.  The
// parts cost 2K extra float32 passes over the map, small beside the walks
// at the fusion and stage-2/3 sizes this route runs at.
#include "common.cuh"

namespace xfm {

constexpr int kTLChannels = 32;  // channels of a block: one warp
constexpr int kTLMaxChunks = 16;
constexpr int kTLMaxR = 64;

struct TwoLevelParams {
  const void* u;      // (n_img, L, D)
  const void* dts;    // deltas: row stride dt_stride, kind stride D
  const void* ranks;  // rank form: row stride rank_stride, kind stride R
  const float* w_dt;  // (K, R, D)
  const void* Bp;     // B[l, k, n] at row * bc_stride + k * bc_k_stride + n * bc_n_stride
  const void* Cp;     // C, same strides as B
  const float* A;     // (K, N, D)
  const float* bias;  // (K, D)
  const float* Dk;    // (K, D) skip added to each part (kernel 10), or null
  float* part;        // (K, n_img, L, D)
  int n_img, H, W, D, K, N, R, kinds, segs;
  int dt_stride, rank_stride, bc_stride, bc_k_stride, bc_n_stride;
  int round_rank;  // rank values rounded to bfloat16 (the TPU kernel's xdbl cast)
  int round_part;  // parts rounded to bfloat16 (kernel 10's N = 1 output dtype)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int MAXN, bool RANK>
__global__ void __launch_bounds__(kTLChannels* kTLMaxChunks)
    two_level_scan_kernel(TwoLevelParams p) {
  __shared__ float wdt_s[RANK ? kTLMaxR * kTLChannels : 1];
  __shared__ float prod_s[kTLMaxChunks][kTLChannels];
  __shared__ float loc_s[kTLMaxChunks][kTLChannels];
  __shared__ float cin_s[kTLMaxChunks][kTLChannels];
  const int tx = threadIdx.x, j = threadIdx.y;
  const int c0 = blockIdx.x * kTLChannels;
  const int c = c0 + tx;
  const bool active = c < p.D;
  const int cc = active ? c : p.D - 1;  // an idle lane loads a valid channel
  const int k = blockIdx.z;
  const int L = p.H * p.W;
  const int code = (p.kinds >> (2 * k)) & 3;  // 0 row_f, 1 col_f, 2 row_r, 3 col_r
  const bool reverse = code >= 2, column = code & 1;
  const int seg_len = column ? p.H : p.W;
  const int n_seg = column ? p.W : p.H;
  const int chunk = p.segs * seg_len;
  const int n_chunks = (n_seg + p.segs - 1) / p.segs;
  const int t0 = j * chunk;
  const int cnt = j < n_chunks ? min(chunk, L - t0) : 0;
  const long long row0 = static_cast<long long>(blockIdx.y) * L;
  const T* u = static_cast<const T*>(p.u);
  const T* Bp = static_cast<const T*>(p.Bp);
  const T* Cp = static_cast<const T*>(p.Cp);

  if (RANK) {
    for (int i = j * kTLChannels + tx; i < p.R * kTLChannels; i += blockDim.y * kTLChannels) {
      const int r = i / kTLChannels, lane = i % kTLChannels;
      wdt_s[i] = c0 + lane < p.D
                     ? p.w_dt[(static_cast<long long>(k) * p.R + r) * p.D + c0 + lane]
                     : 0.f;
    }
    __syncthreads();
  }
  float a_kn[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
    a_kn[n] = n < p.N ? p.A[(static_cast<long long>(k) * p.N + n) * p.D + cc] : 0.f;
  const float bias_k = p.bias[k * p.D + cc];
  const float d_k = p.Dk ? p.Dk[k * p.D + cc] : 0.f;

  // row (image offset included) of the n-th position this thread walks
  auto row_of = [&](int i) -> long long {
    const int t = reverse ? t0 + cnt - 1 - i : t0 + i;
    return row0 + (column ? (t % p.H) * p.W + t / p.H : t);
  };
  auto delta_of = [&](long long row) -> float {
    float z;
    if (RANK) {
      const T* rk = static_cast<const T*>(p.ranks) + row * p.rank_stride + k * p.R;
      z = 0.f;
      for (int r = 0; r < p.R; ++r) {
        const float v = to_f32(rk[r]);
        z = fmaf(p.round_rank ? round_bf16(v) : v, wdt_s[r * kTLChannels + tx], z);
      }
    } else {
      z = to_f32(static_cast<const T*>(p.dts)[row * p.dt_stride + static_cast<long long>(k) * p.D + cc]);
    }
    return softplus20(z + bias_k);
  };

  // 1. the chunk's pair (prod a, h from a zero state) for every state
  float h[MAXN], prod[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    h[n] = 0.f;
    prod[n] = 1.f;
  }
  for (int i = 0; i < cnt; ++i) {
    const long long row = row_of(i);
    const float delta = delta_of(row);
    const float du = delta * to_f32(u[row * p.D + cc]);
    const T* bp = Bp + row * p.bc_stride + k * p.bc_k_stride;
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < p.N) {
        const float a = expf(delta * a_kn[n]);
        h[n] = fmaf(a, h[n], du * to_f32(bp[n * p.bc_n_stride]));
        prod[n] *= a;
      }
    }
  }
  // 2. the state entering each chunk, state by state: thread j == 0 of each
  //    channel chains the chunks in traversal order
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < p.N) {  // uniform over the block: every thread reaches the barriers
      prod_s[j][tx] = prod[n];
      loc_s[j][tx] = h[n];
      __syncthreads();
      if (j == 0) {
        float carry = 0.f;
        for (int m = 0; m < n_chunks; ++m) {
          const int jj = reverse ? n_chunks - 1 - m : m;
          cin_s[jj][tx] = carry;
          carry = fmaf(prod_s[jj][tx], carry, loc_s[jj][tx]);
        }
      }
      __syncthreads();
      h[n] = cin_s[j][tx];
    }
  }
  // 3. the chunk again from its state: this kind's part
  float* part = p.part + static_cast<long long>(k) * p.n_img * L * p.D;
  for (int i = 0; i < cnt; ++i) {
    const long long row = row_of(i);
    const float delta = delta_of(row);
    const float uu = to_f32(u[row * p.D + cc]);
    const float du = delta * uu;
    const T* bp = Bp + row * p.bc_stride + k * p.bc_k_stride;
    const T* cp = Cp + row * p.bc_stride + k * p.bc_k_stride;
    float y = 0.f;
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < p.N) {
        h[n] = fmaf(expf(delta * a_kn[n]), h[n], du * to_f32(bp[n * p.bc_n_stride]));
        y = fmaf(to_f32(cp[n * p.bc_n_stride]), h[n], y);
      }
    }
    if (p.Dk) y = fmaf(uu, d_k, y);
    if (p.round_part) y = round_bf16(y);
    if (active) part[row * p.D + c] = y;
  }
}

// out = u * Dsum + part[0] + ... + part[K - 1] (cross == 0), or
// out = (part[0] + part[2]) + (part[1] + part[3]) (cross == 1).
template <typename T, typename OT>
__global__ void two_level_merge_kernel(const T* __restrict__ u, const float* __restrict__ Dsum,
                                       const float* __restrict__ part, OT* __restrict__ out,
                                       long long total, int D, int K, int cross) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v;
    if (cross) {
      v = (part[i] + part[2 * total + i]) + (part[total + i] + part[3 * total + i]);
    } else {
      v = to_f32(u[i]) * Dsum[i % D];
      for (int k = 0; k < K; ++k) v += part[k * total + i];
    }
    out[i] = from_f32<OT>(v);
  }
}

template <typename T, typename OT>
cudaError_t launch_two_level(const TwoLevelParams& p, const float* Dsum, void* out, int cross,
                             cudaStream_t s) {
  const int n_chunks = max((p.H + p.segs - 1) / p.segs, (p.W + p.segs - 1) / p.segs);
  const dim3 grid(ceil_div(p.D, kTLChannels), p.n_img, p.K);
  const dim3 block(kTLChannels, n_chunks);
  const bool rank = p.ranks != nullptr;
  if (p.N <= 1) {
    if (rank) two_level_scan_kernel<T, 1, true><<<grid, block, 0, s>>>(p);
    else two_level_scan_kernel<T, 1, false><<<grid, block, 0, s>>>(p);
  } else {
    if (rank) two_level_scan_kernel<T, 16, true><<<grid, block, 0, s>>>(p);
    else two_level_scan_kernel<T, 16, false><<<grid, block, 0, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(p.n_img) * p.H * p.W * p.D;
  const int mgrid = ceil_div(total, kThreads) < 65535 * 16 ? ceil_div(total, kThreads) : 65535 * 16;
  two_level_merge_kernel<T, OT><<<mgrid, kThreads, 0, s>>>(
      static_cast<const T*>(p.u), Dsum, p.part, static_cast<OT*>(out), total, p.D, p.K, cross);
  return cudaGetLastError();
}

bool two_level_geometry_ok(const TwoLevelParams& p) {
  return p.n_img >= 1 && p.n_img <= 65535 && p.H >= 1 && p.W >= 1 && p.D >= 1 && p.segs >= 1 &&
         (p.H + p.segs - 1) / p.segs <= kTLMaxChunks &&
         (p.W + p.segs - 1) / p.segs <= kTLMaxChunks && p.N >= 1 && p.N <= 16 && p.K >= 1 &&
         p.K <= 4;
}

}  // namespace xfm

using namespace xfm;

// Kernels 8 (rank form, float32 in and out) and 9 (dts form, out in u's dtype).
extern "C" int xfm_scan_two_level(const void* u, const void* dts, const void* ranks,
                                  const float* w_dt, const void* Bp, const void* Cp,
                                  const float* A, const float* bias, const float* Dsum,
                                  float* part, void* out, int n_img, int H, int W, int D, int K,
                                  int N, int R, int kinds, int segs, int dt_stride,
                                  int rank_stride, int bc_stride, int bc_k_stride,
                                  int bc_n_stride, int round_rank, int dtype, int out_dtype,
                                  void* stream) {
  TwoLevelParams p{u,         dts,        ranks,       w_dt,        Bp,         Cp,
                   A,         bias,       nullptr,     part,        n_img,      H,
                   W,         D,          K,           N,           R,          kinds,
                   segs,      dt_stride,  rank_stride, bc_stride,   bc_k_stride, bc_n_stride,
                   round_rank, 0};
  if (!two_level_geometry_ok(p) || (ranks && (R < 1 || R > kTLMaxR || !w_dt)) ||
      (!ranks && !dts) || !part || !Dsum)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && out_dtype == kF32) return launch_two_level<float, float>(p, Dsum, out, 0, s);
  if (dtype == kBF16 && out_dtype == kBF16)
    return launch_two_level<__nv_bfloat16, __nv_bfloat16>(p, Dsum, out, 0, s);
  if (dtype == kBF16 && out_dtype == kF32)
    return launch_two_level<__nv_bfloat16, float>(p, Dsum, out, 0, s);
  return cudaErrorInvalidValue;
}

// Kernel 10: x (B, L, D), dts (B, L, 4, D), Bs / Cs (B, L, 4, N), A (4, N, D),
// bias and Dk (4, D); out (B, L, D) float32.
extern "C" int xfm_fused_cross_scan(const void* x, const void* dts, const void* Bp, const void* Cp,
                                    const float* A, const float* bias, const float* Dk,
                                    float* part, float* out, int n_img, int H, int W, int D,
                                    int N, int segs, int dtype, void* stream) {
  TwoLevelParams p{x,     dts,   nullptr, nullptr, Bp,    Cp,    A,     bias,  Dk,
                   part,  n_img, H,       W,       D,     4,     N,     0,
                   0 | (1 << 2) | (2 << 4) | (3 << 6), segs, 4 * D, 0,     4 * N, N,
                   1,     0,     N == 1 && dtype == kBF16};
  if (!two_level_geometry_ok(p) || !Dk || !part) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_two_level<float, float>(p, nullptr, out, 1, s);
  if (dtype == kBF16) return launch_two_level<__nv_bfloat16, float>(p, nullptr, out, 1, s);
  return cudaErrorInvalidValue;
}
