// Staging a block's map slice in shared memory, shared by the whole-map
// scans (scan_whole_map.cu, kernels 9 and 10) and the nk ablations
// (nk_scan_ablations.cu, kernels 17 and 18): the bulk copy engine and its
// shared-memory barrier, rows by 16-byte cp.async or element by element,
// the traversal order of a kind, and the global timer of the phase clocks.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace xfm {

// The bulk copy engine: one request copies a whole block into shared memory
// and completes on a shared-memory barrier (mbarrier) counting its bytes.
__device__ __forceinline__ void stage_bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void stage_bulk_copy(void* dst, const void* src, int bytes,
                                                unsigned long long* bar) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void stage_bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void stage_bar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n STAGE_WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra STAGE_WAIT_%=;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the card's global timer, in ns (a memory clobber: the reading stays
// where the code puts it)
__device__ __forceinline__ unsigned long long stage_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

__host__ __device__ inline int stage_align(int b) { return (b + 15) & ~15; }
// elements of a staged row of n: n rounded up to whole 16-byte pieces
__host__ __device__ inline int stage_pad(int n, int esize) {
  const int per = 16 / esize;
  return (n + per - 1) / per * per;
}

// map position of traversal step t of a kind (code: bit 0 column-major,
// bit 1 reversed)
__device__ __forceinline__ int traversal_pos(int t, int code, int H, int W) {
  const int L = H * W, tt = code >= 2 ? L - 1 - t : t;
  return (code & 1) ? (tt % H) * W + tt / H : tt;
}

// rows x cols elements into dst (row stride cols, a whole number of
// 16-byte pieces), source row r at row(r); elements at or past `valid` are
// zero.  vec: 16-byte cp.async (the source rows 16-byte aligned); else
// element by element, four loads in flight a thread before their stores.
template <typename T, class Row>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int cols, int valid, bool vec,
                                           const Row& row) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per = cols / E;
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int r = i / per, q = (i - r * per) * E;
      const int n = min(max(valid - q, 0), E);
      const T* src = row(r);
      cp_async16(dst + r * cols + q, n > 0 ? src + q : src, n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i0 = threadIdx.x; i0 < rows * cols; i0 += 4 * blockDim.x) {
      T v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e * blockDim.x, r = i / cols, q = i - r * cols;
        v[e] = i < rows * cols && q < valid ? row(r)[q] : from_f32<T>(0.f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i0 + e * blockDim.x < rows * cols) dst[i0 + e * blockDim.x] = v[e];
    }
  }
}

// four consecutive staged values, widened to float32
__device__ __forceinline__ void stage_load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void stage_load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}

}  // namespace xfm
