// Two-level selective scans over whole H x W maps, parallel along L.
//
// One scan, the item of scan_two_level.cuh, serves three TPU kernels:
// - the four d_state-1 cross2d scans of the v1 whole-block kernel
//   xfmamba_tpu/ops/vss_block_pallas.py::_vss_block_kernel (:295, kernel 8),
//   rank form: the rank->D delta projection is done here, as the TPU kernel
//   does it on the MXU inside its body.  Kernel 8 runs the item inside its
//   cooperative block kernel (vss_block_v1.cu); this file's kernel serves
//   its earlier launch sequence (ops/vss_block_v1.py::V1_SEQUENCE_OPS);
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
#include "scan_two_level.cuh"

namespace xfm {

constexpr int kTLChannels = 32;  // channels of a block: one warp

template <typename T, int MAXN, bool RANK>
__global__ void __launch_bounds__(kTLChannels* kTLMaxChunks)
    two_level_scan_kernel(TwoLevelParams p) {
  __shared__ float smem[two_level_smem_floats<kTLChannels>()];
  two_level_scan_item<T, MAXN, RANK, kTLChannels>(p, blockIdx.x, blockIdx.y, blockIdx.z,
                                                  threadIdx.x, threadIdx.y,
                                                  blockDim.y * kTLChannels, smem);
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
