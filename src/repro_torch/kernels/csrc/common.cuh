// Helpers shared by the kernels: loads and stores of the element types the
// LM wrappers accept (dtype codes: 0 float32, 1 bfloat16), with all
// arithmetic in float32, and the asynchronous global → shared copies
// (cp.async, sm_80 and later) that stage tiles ahead of their use; on the
// host, each kernel's registers and spill bytes.
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

// 1 / (1 + e^-x), as jax.nn.sigmoid and torch.sigmoid define it, to a few
// float32 ulps (the exp2 and reciprocal approximations of the SFU); 0 and 1
// at the extremes
__device__ __forceinline__ float sigmoidf(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// log(1 + e^x) = max(x, 0) + log1p(e^-|x|), the stable form jax.nn.softplus uses
__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// 16 bytes from global to shared memory, both 16-byte aligned; only the
// first src_bytes (0..16) are read, the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// 4 bytes from global to shared memory, both 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// close the group of copies this thread has issued since the last commit
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Largest dynamic shared memory a block may opt into on the current device
// (0 if it cannot be read). A kernel launched from several threads at shapes
// that need different amounts opts into all of it once, never into one
// launch's own need: another thread could lower that limit between its set
// and this thread's launch (CUDA error 1, invalid argument).
inline int device_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// A kernel of a source file, for the *_kernel_info functions.
struct KernelRef {
  const char* name;
  const void* fn;
};

// Registers per thread and local-memory (spill) bytes per thread of the
// i-th kernel of `table`, from cudaFuncGetAttributes. Returns 0, -1 past
// the last kernel, or the CUDA error.
template <int N>
inline int kernel_info(const KernelRef (&table)[N], int i, const char** name, int* regs,
                       int* local_bytes) {
  if (i < 0 || i >= N) return -1;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, table[i].fn);
  if (e != cudaSuccess) return (int)e;
  *name = table[i].name;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

}  // namespace repro
