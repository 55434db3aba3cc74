// bfloat16 and the mma.sync products for tests/cuda_emulator (see
// cuda_runtime.h): conversions round to nearest even as the card does; a
// product gathers the warp's fragments (PTX ISA layouts of
// mma.sync.aligned.m16n8k8 tf32 and m16n8k16 bf16) and sums in double.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 {
  unsigned short v;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(uint32_t(b.v) << 16); }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u = emu_bits(f);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}

// cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away from zero
inline uint32_t emu_to_tf32(float v) { return (emu_bits(v) + 0x1000u) & 0xffffe000u; }

inline void emu_mma(float* c, const uint32_t* a, const uint32_t* b, bool bf16) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) emu_exchange[w][l][i] = __uint_as_float(a[i]);
  for (int i = 0; i < 2; ++i) emu_exchange[w][l][4 + i] = __uint_as_float(b[i]);
  __syncwarp();
  auto reg = [&](int lane, int i) { return emu_bits(emu_exchange[w][lane][i]); };
  auto half = [](uint32_t r, int hi) { return __uint_as_float(hi ? (r & 0xffff0000u) : (r << 16)); };
  auto A = [&](int r, int k) -> double {
    if (!bf16) return __uint_as_float(reg((r % 8) * 4 + k % 4, (r >= 8) + 2 * (k >= 4)));
    return half(reg((r % 8) * 4 + (k % 8) / 2, (r >= 8) + 2 * (k >= 8)), k & 1);
  };
  auto B = [&](int k, int n) -> double {
    if (!bf16) return __uint_as_float(reg(n * 4 + k % 4, 4 + (k >= 4)));
    return half(reg(n * 4 + (k % 8) / 2, 4 + (k >= 8)), k & 1);
  };
  const int g = l >> 2, t = l & 3, K = bf16 ? 16 : 8;
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), n = 2 * t + (e & 1);
    double s = 0;
    for (int k = 0; k < K; ++k) s += A(r, k) * B(k, n);
    c[e] += static_cast<float>(s);
  }
  __syncwarp();
}
