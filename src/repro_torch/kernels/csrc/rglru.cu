// RG-LRU recurrence (Griffin / RecurrentGemma) for Hopper (sm_90a), with a
// plain C interface that repro_torch/kernels/rglru.py binds through ctypes.
//
// Replaces, in the JAX package, kernels/rglru.py: rglru_tpu (body
// _rglru_kernel). Same function, gates fused:
//   log a_t = -c * softplus(L) * sigmoid(r_t),  a_t = exp(log a_t)
//   beta_t  = sqrt(-expm1(2 log a_t))             (= sqrt(1 - a_t^2))
//   h_t     = a_t * h_{t-1} + beta_t * (sigmoid(i_t) * x_t)
// with h_0 given or zero, y_t = h_t in x's dtype and h_T in float32.
//
// What bounds it. Every element of x, i and r is read once and every y
// written once: 4 * B*T*D elements, two bytes each in bf16, and a few dozen
// operations per element, so it is bound by bytes (0.16 ms at RecurrentGemma's
// B=4, T=4096, D=4096). The recurrence is strictly sequential in time but
// independent per (b, channel). The TPU kernel carries h in VMEM across the
// sequential time blocks of its grid; here one thread owns one (b, channel)
// and walks T itself with h in a register, so nothing is carried between
// blocks. Neighbouring threads own neighbouring channels, so every time step
// is one coalesced row load per input. The loop is unrolled so the loads of
// later steps (which do not depend on h) are in flight while h is updated.

#include "common.cuh"

namespace {

using repro::from_float;
using repro::sigmoidf;
using repro::softplusf;
using repro::to_float;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_fwd(const T* __restrict__ x, const T* __restrict__ ig,
              const T* __restrict__ rg, const float* __restrict__ a_param,
              const float* __restrict__ h0, T* __restrict__ y,
              float* __restrict__ h_out, int Tn, int D, float c) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const float coef = -c * softplusf(a_param[d]);
  float h = h0 != nullptr ? h0[(long long)b * D + d] : 0.f;
  const long long base = (long long)b * Tn * D + d;
#pragma unroll 8
  for (int t = 0; t < Tn; ++t) {
    const long long i = base + (long long)t * D;
    const float xv = to_float(x[i]);
    const float log_a = coef * sigmoidf(to_float(rg[i]));
    const float a = expf(log_a);
    const float beta = sqrtf(-expm1f(2.f * log_a));
    const float u = beta * (sigmoidf(to_float(ig[i])) * xv);
    h = a * h + u;
    y[i] = from_float<T>(h);
  }
  h_out[(long long)b * D + d] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* ig, const void* rg,
                   const float* a_param, const float* h0, void* y, float* h_out,
                   int B, int Tn, int D, float c, cudaStream_t s) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_fwd<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(ig), static_cast<const T*>(rg),
      a_param, h0, static_cast<T*>(y), h_out, Tn, D, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, T, D) and h_out (B, D) float32 from x, ig, rg (B, T, D) of one dtype
// (repro::DType), a_param (D,) float32 and h0 (B, D) float32 or null, all
// contiguous. Returns the CUDA error.
int repro_rglru(const void* x, const void* ig, const void* rg,
                const float* a_param, const float* h0, void* y, float* h_out,
                int dtype, int B, int Tn, int D, float c, void* stream) {
  if (B > 65535 || B < 0 || Tn < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return (int)launch<float>(x, ig, rg, a_param, h0, y, h_out, B, Tn, D, c, s);
    case repro::kBF16:
      return (int)launch<__nv_bfloat16>(x, ig, rg, a_param, h0, y, h_out, B, Tn, D, c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The i-th kernel of this file: its name, registers per thread and local
// (spill) bytes per thread. Returns 0, -1 past the last kernel, or the CUDA error.
int repro_rglru_kernel_info(int i, const char** name, int* regs, int* local_bytes) {
  static const repro::KernelRef table[] = {
      {"rglru_fwd<float>", reinterpret_cast<const void*>(rglru_fwd<float>)},
      {"rglru_fwd<bf16>", reinterpret_cast<const void*>(rglru_fwd<__nv_bfloat16>)}};
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
