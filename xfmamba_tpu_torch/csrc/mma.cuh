// Tensor-core helpers shared by the hand-written kernels: 16-byte cp.async,
// ldmatrix, the warp-level mma.sync products (m16n8k16 bf16 and m16n8k8
// TF32, float32 sums) and a row of 16 x 8 output tiles of a product whose
// operands are read through accessors.
//
// Fragment layouts (PTX ISA, mma.sync.aligned.m16n8k{8,16}); g = lane / 4,
// t = lane % 4:
//   bf16 A (16 x 16): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..),
//                     a[3] = (g + 8, 2t + 8..); B (16 x 8): b[0] = (2t..2t+1, g),
//                     b[1] = (2t + 8.., g), the lower k in the low half
//   TF32 A (16 x 8):  a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4), a[3] = (g + 8, t + 4);
//                     B (8 x 8): b[0] = (t, g), b[1] = (t + 4, g)
//   C (16 x 8):       c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace xfm {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p, bool trans) {
  if (trans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// float32 rounded to TF32 (10 mantissa bits, to nearest, ties away)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// two floats as a bfloat16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// How a product's float32 operands reach the tensor cores: rounded to
// bfloat16 (one m16n8k16 per 16 of k), or split into a TF32 high part and
// a TF32 remainder with three m16n8k8 per 8 of k (lo x hi + hi x lo +
// hi x hi: about 21 bits of each operand, float32-grade sums).
enum class Prec { kBF16, kTF32x3 };

// acc[t] (the 16 x 8 output tiles at rows m0.., columns n0 + 8 t..,
// t < NT) += sum over k in [k0, kend) of a(m, k) b(k, n).  a and b are
// accessors (usually lambdas over shared memory).  With CHECKED they are
// called only inside rows x kend and kend x cols, and outside the operands
// count as zero, so m, n and k need not be multiples of the tile; without,
// the caller guarantees whole tiles and k steps.  k0 must be a multiple of
// the k step (16).  The A fragment of each k step is built once for the NT
// tiles.
template <Prec PR, int NT, bool CHECKED, class FA, class FB>
__device__ __forceinline__ void mma_tiles_body(float (*acc)[4], const FA& a, const FB& b, int m0,
                                               int n0, int rows, int cols, int k0, int kend) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = m0 + g, r1 = r0 + 8;
  const bool in0 = !CHECKED || r0 < rows, in1 = !CHECKED || r1 < rows;
  auto A0 = [&](int k) { return in0 && (!CHECKED || k < kend) ? a(r0, k) : 0.f; };
  auto A1 = [&](int k) { return in1 && (!CHECKED || k < kend) ? a(r1, k) : 0.f; };
  auto Bv = [&](int k, int cn) {
    return !CHECKED || (cn < cols && k < kend) ? b(k, cn) : 0.f;
  };
  if constexpr (PR == Prec::kBF16) {
    for (int k = k0; k < kend; k += 16) {
      const int ka = k + 2 * t, kb = ka + 8;
      const uint32_t af[4] = {pack_bf16(A0(ka), A0(ka + 1)), pack_bf16(A1(ka), A1(ka + 1)),
                              pack_bf16(A0(kb), A0(kb + 1)), pack_bf16(A1(kb), A1(kb + 1))};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cn = n0 + 8 * j + g;
        const uint32_t bf[2] = {pack_bf16(Bv(ka, cn), Bv(ka + 1, cn)),
                                pack_bf16(Bv(kb, cn), Bv(kb + 1, cn))};
        mma_bf16(acc[j], af, bf);
      }
    }
  } else {
    for (int k = k0; k < kend; k += 8) {
      const float av[4] = {A0(k + t), A1(k + t), A0(k + t + 4), A1(k + t + 4)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[e] = to_tf32(av[e]);
        al[e] = to_tf32(av[e] - __uint_as_float(ah[e]));
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cn = n0 + 8 * j + g;
        const float bv[2] = {Bv(k + t, cn), Bv(k + t + 4, cn)};
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bh[e] = to_tf32(bv[e]);
          bl[e] = to_tf32(bv[e] - __uint_as_float(bh[e]));
        }
        mma_tf32(acc[j], al, bh);
        mma_tf32(acc[j], ah, bl);
        mma_tf32(acc[j], ah, bh);
      }
    }
  }
}

// mma_tiles_body, unchecked where the tiles and the k range are whole.
template <Prec PR, int NT, class FA, class FB>
__device__ __forceinline__ void mma_tiles(float (*acc)[4], const FA& a, const FB& b, int m0,
                                          int n0, int rows, int cols, int k0, int kend) {
  constexpr int kStep = PR == Prec::kBF16 ? 16 : 8;
  if (m0 + 16 <= rows && n0 + 8 * NT <= cols && (kend - k0) % kStep == 0)
    mma_tiles_body<PR, NT, false>(acc, a, b, m0, n0, rows, cols, k0, kend);
  else
    mma_tiles_body<PR, NT, true>(acc, a, b, m0, n0, rows, cols, k0, kend);
}

// The (row, column) of element e (0..3) of a thread's 16 x 8 output tile.
__device__ __forceinline__ int tile_row(int m0, int e) {
  return m0 + ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int tile_col(int n0, int e) {
  return n0 + 2 * (threadIdx.x & 3) + (e & 1);
}

}  // namespace xfm
