// Shared helpers for the hand-written Hopper kernels of xfmamba_tpu_torch.
//
// Every kernel reads and writes either float32 or bfloat16 activations and
// does its arithmetic in float32.  The C entry points take a dtype code
// (kF32 / kBF16), launch on the caller's stream and return
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace xfm {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// torch.nn.functional.softplus with threshold 20 (the reference CUDA scan's
// form): z if z > 20 else log1p(exp(z)).
__device__ __forceinline__ float softplus20(float z) {
  return z > 20.f ? z : log1pf(expf(z));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

inline int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

}  // namespace xfm
