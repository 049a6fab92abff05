// Helpers shared by the LM kernels: loads and stores of the element types
// the wrappers accept (dtype codes: 0 float32, 1 bfloat16), all
// arithmetic in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
// round to nearest even, as torch's .to(bfloat16) does
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 1 / (1 + e^-x), as jax.nn.sigmoid and torch.sigmoid define it
__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// log(1 + e^x) = max(x, 0) + log1p(e^-|x|), the stable form jax.nn.softplus uses
__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

}  // namespace repro
