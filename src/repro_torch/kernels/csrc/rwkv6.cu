// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a), with a plain C
// interface that repro_torch/kernels/rwkv6.py binds through ctypes.
//
// Replaces, in the JAX package, kernels/rwkv6.py: rwkv6_tpu (body
// _rwkv6_kernel). Same function, in time order as ref.rwkv6_ref defines it:
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(d_t) S_{t-1} + k_t v_t^T,   d_t = exp(-exp(w_t))
// per (b, head), with S_0 given or zero, y in v's dtype and S_T in float32.
// The TPU kernel rewrites the scan as chunked linear attention so that the
// MXU does the work, which needs cumulative sums of log decays and therefore
// clamps the log decay at -50. This kernel runs the recurrence step by step
// and never forms those sums, so it does not clamp: d_t is exactly
// exp(-exp(w_t)) as in the oracle. Against the TPU kernel that differs only
// where exp(w_t) > 50, where both decay the state by at most 2e-22.
//
// What bounds it. Its bytes are r, k, v, w read once, y written once and
// the states (Dk*Dv*4 bytes per head) read and written once; its operations
// are 5*Dk*Dv + 5*Dk + 2*Dv per step and head (readout 2*Dk*Dv, update
// 3*Dk*Dv, the u bonus as a dot product times v, the decay). At RWKV6-7B's
// prefill (B=4, H=64, T=4096, Dk=Dv=64) that is ~0.8 GB (0.24 ms at
// 3.35 TB/s) and ~22 GFLOP of float32 (0.33 ms at 67 TFLOP/s): bound by
// operations, which have to run on the CUDA cores in this form. The
// recurrence is sequential in time, so the parallelism is
// B*H*Dv threads. One block owns one (b, head); thread j owns column j of
// the state, which lives in shared memory (16 KB at 64x64), so a thread
// reads and writes only its own column and the time loop needs no barrier
// per step. Each chunk of 16 steps of r, k and the decay is staged in shared
// memory once (the decay computed once per element, not once per thread)
// and read by every thread as a broadcast.

#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kChunk = 16;

size_t rwkv6_smem_bytes(int Dk, int Dv) {
  return sizeof(float) * ((size_t)Dk * Dv + 3 * (size_t)kChunk * Dk + Dk);
}

template <typename T>
__global__ void rwkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ w,
                          const float* __restrict__ u,
                          const float* __restrict__ s0, T* __restrict__ y,
                          float* __restrict__ s_out, int H, int Tn, int Dk,
                          int Dv) {
  extern __shared__ float smem[];
  float* S = smem;                     // (Dk, Dv)
  float* rs = S + Dk * Dv;             // (kChunk, Dk)
  float* ks = rs + kChunk * Dk;        // (kChunk, Dk)
  float* ds = ks + kChunk * Dk;        // (kChunk, Dk) decay
  float* us = ds + kChunk * Dk;        // (Dk,)
  const int tid = threadIdx.x;
  const int j = tid;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const long long kbase = (long long)bh * Tn * Dk;
  const long long vbase = (long long)bh * Tn * Dv;
  const long long sbase = (long long)bh * Dk * Dv;

  for (int i = tid; i < Dk * Dv; i += blockDim.x) S[i] = s0 != nullptr ? s0[sbase + i] : 0.f;
  for (int i = tid; i < Dk; i += blockDim.x) us[i] = u[(long long)h * Dk + i];

  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int n = min(kChunk, Tn - t0);
    __syncthreads();  // the previous chunk's r, k, d are no longer read
    for (int idx = tid; idx < n * Dk; idx += blockDim.x) {
      const long long g = kbase + (long long)t0 * Dk + idx;
      rs[idx] = to_float(r[g]);
      ks[idx] = to_float(k[g]);
      ds[idx] = expf(-expf(w[g]));
    }
    __syncthreads();
    if (j < Dv) {
      for (int tt = 0; tt < n; ++tt) {
        const long long vi = vbase + (long long)(t0 + tt) * Dv + j;
        const float vj = to_float(v[vi]);
        const float* rt = rs + tt * Dk;
        const float* kt = ks + tt * Dk;
        const float* dt = ds + tt * Dk;
        float acc = 0.f;
#pragma unroll 8
        for (int i = 0; i < Dk; ++i) {
          const float s = S[i * Dv + j];
          const float kv = kt[i] * vj;
          acc = fmaf(rt[i], s + us[i] * kv, acc);
          S[i * Dv + j] = dt[i] * s + kv;
        }
        y[vi] = from_float<T>(acc);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Dk * Dv; i += blockDim.x) s_out[sbase + i] = S[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, void* y, float* s_out,
                   int B, int H, int Tn, int Dk, int Dv, cudaStream_t s) {
  const size_t smem = rwkv6_smem_bytes(Dk, Dv);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = ((Dv + 31) / 32) * 32;
  rwkv6_fwd<T><<<B * H, threads, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      w, u, s0, static_cast<T*>(y), s_out, H, Tn, Dk, Dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block asks for.
long long repro_rwkv6_smem(int Dk, int Dv) { return (long long)rwkv6_smem_bytes(Dk, Dv); }

// y (B, H, T, Dv) and s_out (B, H, Dk, Dv) float32 from r, k (B, H, T, Dk)
// and v (B, H, T, Dv) of one dtype (repro::DType), w (B, H, T, Dk) float32,
// u (H, Dk) float32 and s0 (B, H, Dk, Dv) float32 or null, all contiguous.
// Returns the CUDA error.
int repro_rwkv6(const void* r, const void* k, const void* v, const float* w,
                const float* u, const float* s0, void* y, float* s_out,
                int dtype, int B, int H, int Tn, int Dk, int Dv, void* stream) {
  if (B < 0 || H < 0 || Tn < 0 || Dk < 1 || Dv < 1 || Dv > 1024)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return (int)launch<float>(r, k, v, w, u, s0, y, s_out, B, H, Tn, Dk, Dv, s);
    case repro::kBF16:
      return (int)launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, Tn, Dk, Dv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The i-th kernel of this file: its name, registers per thread and local
// (spill) bytes per thread. Returns 0, -1 past the last kernel, or the CUDA error.
int repro_rwkv6_kernel_info(int i, const char** name, int* regs, int* local_bytes) {
  static const repro::KernelRef table[] = {
      {"rwkv6_fwd<float>", reinterpret_cast<const void*>(rwkv6_fwd<float>)},
      {"rwkv6_fwd<bf16>", reinterpret_cast<const void*>(rwkv6_fwd<__nv_bfloat16>)}};
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
