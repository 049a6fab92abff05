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
// operations per element, so the function is bound by bytes (0.16 ms at
// RecurrentGemma's B=4, T=4096, D=4096). The recurrence is independent per
// (b, channel) but strictly sequential in time. The TPU kernel carries h in
// VMEM across the sequential time blocks of its grid. A thread per (b,
// channel) walking all of T (this kernel's first form) gives only B*D
// threads, under one block per SM at that shape, and each step waits on
// the one before: latency-bound at 26x the bytes bound.
//
// The design: a chunked scan over T, so that T is spread over the SMs.
// T is cut into chunks of kChunk=64 steps and a block takes (b, a tile of
// 128 channels, a chunk): 8,192 blocks at the prefill shape.
// Three kernels, one launch of the wrapper:
//   1. rglru_summary: each chunk but the last runs its recurrence from
//      h = 0 and writes its decay product prod(a_t) and its local end state
//      to a float32 scratch (B, chunks, 2, D);
//   2. rglru_carry: a thread per (b, channel) walks the chunks in order,
//      h_in(k+1) = prod_k * h_in(k) + local_k from h_in(0) = h_0, and writes
//      each chunk's entry state (B, chunks, D);
//   3. rglru_fwd: each chunk re-runs its recurrence from its entry state and
//      writes y (and the last chunk h_T).
// The gate math stays fused in passes 1 and 3, which therefore read x, i
// and r twice: the bytes this design moves are ~7/4 of the function's,
// ~0.28 ms at the prefill shape (plus 12 bytes of scratch per (b, chunk,
// channel)). Running the gate math twice with accurate transcendental
// functions bound both passes by instruction issue rather than bytes, so
// the sigmoids use the SFU's approximations (common.cuh). A chained
// one-kernel scan, each chunk waiting on its predecessor's state, reads the
// inputs once but was slower in a trial on the H100: its blocks hold their
// SMs while they wait, so only a few chunks run at a time. Every
// combination here runs in a fixed order (no look-back that takes whatever
// happens to be ready), so reruns are bit-identical. At T <= kChunk
// (decode, T=1) only pass 3 runs, from h_0.

#include "common.cuh"

namespace {

using repro::from_float;
using repro::sigmoidf;
using repro::softplusf;
using repro::to_float;

constexpr int kThreads = 128;
constexpr int kChunk = 64;

// a_t and beta_t * sigmoid(i_t) * x_t of element i
template <typename T>
__device__ __forceinline__ void gates(const T* __restrict__ x, const T* __restrict__ ig,
                                      const T* __restrict__ rg, long long i, float coef,
                                      float& a, float& u) {
  const float xv = to_float(x[i]);
  // The sigmoids are good to a few float32 ulps (common.cuh): they scale u
  // and log a, so their error does not build up along T. a_t itself, whose
  // error would (over ~1 / (1 - a) steps), comes from the accurate expf.
  const float log_a = coef * sigmoidf(to_float(rg[i]));
  a = expf(log_a);
  const float beta = sqrtf(-expm1f(2.f * log_a));
  u = beta * (sigmoidf(to_float(ig[i])) * xv);
}

// Pass 1: chunk blockIdx.x / tiles (never the last) from h = 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_summary(const T* __restrict__ x, const T* __restrict__ ig,
                  const T* __restrict__ rg, const float* __restrict__ a_param,
                  float* __restrict__ summary, int Tn, int D, int tiles, int chunks,
                  float c) {
  const int d = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  const int ci = blockIdx.x / tiles;
  const int b = blockIdx.y;
  if (d >= D) return;
  const float coef = -c * softplusf(a_param[d]);
  const long long base = ((long long)b * Tn + (long long)ci * kChunk) * D + d;
  float h = 0.f, prod = 1.f;
#pragma unroll 8
  for (int t = 0; t < kChunk; ++t) {
    float a, u;
    gates(x, ig, rg, base + (long long)t * D, coef, a, u);
    h = a * h + u;
    prod *= a;
  }
  float* s = summary + ((long long)b * chunks + ci) * 2 * D + d;
  s[0] = prod;
  s[D] = h;
}

// Pass 2: the entry state of every chunk, in chunk order.
__global__ void __launch_bounds__(kThreads)
    rglru_carry(const float* __restrict__ h0, const float* __restrict__ summary,
                float* __restrict__ entry, int D, int chunks) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  float h = h0 != nullptr ? h0[(long long)b * D + d] : 0.f;
  const float* s = summary + (long long)b * chunks * 2 * D + d;
  float* e = entry + (long long)b * chunks * D + d;
  e[0] = h;
#pragma unroll 8
  for (int ci = 0; ci + 1 < chunks; ++ci) {
    h = s[(long long)ci * 2 * D] * h + s[(long long)ci * 2 * D + D];
    e[(long long)(ci + 1) * D] = h;
  }
}

// Pass 3: chunk blockIdx.x / tiles from its entry state (h_0 when `entry`
// is null: a single chunk), writing y and, from the last chunk, h_T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_fwd(const T* __restrict__ x, const T* __restrict__ ig, const T* __restrict__ rg,
              const float* __restrict__ a_param, const float* __restrict__ h0,
              const float* __restrict__ entry, T* __restrict__ y, float* __restrict__ h_out,
              int Tn, int D, int tiles, int chunks, float c) {
  const int d = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  const int ci = blockIdx.x / tiles;
  const int b = blockIdx.y;
  if (d >= D) return;
  const float coef = -c * softplusf(a_param[d]);
  float h;
  if (entry != nullptr)
    h = entry[((long long)b * chunks + ci) * D + d];
  else
    h = h0 != nullptr ? h0[(long long)b * D + d] : 0.f;
  const int t0 = ci * kChunk;
  const int n = entry != nullptr ? min(kChunk, Tn - t0) : Tn;
  const long long base = ((long long)b * Tn + t0) * D + d;
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    const long long i = base + (long long)t * D;
    float a, u;
    gates(x, ig, rg, i, coef, a, u);
    h = a * h + u;
    y[i] = from_float<T>(h);
  }
  if (ci == chunks - 1) h_out[(long long)b * D + d] = h;
}

long long scratch_floats(int B, int Tn, int D) {
  if (Tn <= kChunk) return 0;
  const long long chunks = (Tn + kChunk - 1) / kChunk;
  return 3LL * B * chunks * D;
}

template <typename T>
cudaError_t launch(const void* x, const void* ig, const void* rg,
                   const float* a_param, const float* h0, float* scratch, void* y,
                   float* h_out, int B, int Tn, int D, float c, cudaStream_t s) {
  const int tiles = (D + kThreads - 1) / kThreads;
  const T* xt = static_cast<const T*>(x);
  const T* it = static_cast<const T*>(ig);
  const T* rt = static_cast<const T*>(rg);
  T* yt = static_cast<T*>(y);
  if (Tn <= kChunk) {   // one chunk: pass 3 alone, from h_0
    rglru_fwd<T><<<dim3(tiles, B), kThreads, 0, s>>>(xt, it, rt, a_param, h0, nullptr, yt,
                                                       h_out, Tn, D, tiles, 1, c);
    return cudaGetLastError();
  }
  const int chunks = (Tn + kChunk - 1) / kChunk;
  if ((long long)tiles * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* summary = scratch;
  float* entry = scratch + 2LL * B * chunks * D;
  rglru_summary<T><<<dim3(tiles * (chunks - 1), B), kThreads, 0, s>>>(
      xt, it, rt, a_param, summary, Tn, D, tiles, chunks, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rglru_carry<<<dim3(tiles, B), kThreads, 0, s>>>(h0, summary, entry, D, chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rglru_fwd<T><<<dim3(tiles * chunks, B), kThreads, 0, s>>>(
      xt, it, rt, a_param, h0, entry, yt, h_out, Tn, D, tiles, chunks, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 scratch (elements) repro_rglru needs at these sizes: 0 at
// T <= 64, else 3 * B * ceil(T / 64) * D.
long long repro_rglru_scratch(int B, int Tn, int D) { return scratch_floats(B, Tn, D); }

// y (B, T, D) and h_out (B, D) float32 from x, ig, rg (B, T, D) of one dtype
// (repro::DType), a_param (D,) float32 and h0 (B, D) float32 or null, all
// contiguous; scratch holds repro_rglru_scratch(B, T, D) floats (null when
// that is 0). Returns the CUDA error.
int repro_rglru(const void* x, const void* ig, const void* rg,
                const float* a_param, const float* h0, void* y, float* h_out,
                float* scratch, int dtype, int B, int Tn, int D, float c, void* stream) {
  if (B > 65535 || B < 0 || Tn < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaSuccess;
  if (scratch == nullptr && scratch_floats(B, Tn, D) > 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return (int)launch<float>(x, ig, rg, a_param, h0, scratch, y, h_out, B, Tn, D, c, s);
    case repro::kBF16:
      return (int)launch<__nv_bfloat16>(x, ig, rg, a_param, h0, scratch, y, h_out, B, Tn, D,
                                        c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The i-th kernel of this file: its name, registers per thread and local
// (spill) bytes per thread. Returns 0, -1 past the last kernel, or the CUDA error.
int repro_rglru_kernel_info(int i, const char** name, int* regs, int* local_bytes) {
  static const repro::KernelRef table[] = {
      {"rglru_summary<float>", reinterpret_cast<const void*>(rglru_summary<float>)},
      {"rglru_summary<bf16>", reinterpret_cast<const void*>(rglru_summary<__nv_bfloat16>)},
      {"rglru_carry", reinterpret_cast<const void*>(rglru_carry)},
      {"rglru_fwd<float>", reinterpret_cast<const void*>(rglru_fwd<float>)},
      {"rglru_fwd<bf16>", reinterpret_cast<const void*>(rglru_fwd<__nv_bfloat16>)}};
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
