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
// written once: 4 * B*T*D elements, two bytes each in bf16 (0.16 ms at
// RecurrentGemma's B=4, T=4096, D=4096). The gate math is two sigmoids,
// expf, expm1f and sqrtf an element, some 50 instructions and 7 of them on
// the special-function units: comparable work, so the kernel comes near
// its bytes only where the gates keep the SMs busy while loads are in
// flight; it runs at about twice its bytes bound, set by the gate math.
//
// rglru_chain (T > 64), one launch. The recurrence is independent per (b,
// channel) and sequential in time, and its per-element work, the gates, is
// not: so a block owns one chain, (b, a tile of 64 channels, two a lane),
// and walks all of T in chunks of kChunk=64 steps, with 8 gate warps
// forming the gates of the chunks ahead (a warp 8 steps of a chunk: a_t and
// u_t = beta_t * sigmoid(i_t) * x_t into a ring of 3 chunks in shared
// memory, 96 KB) while one scan warp runs the recurrence over the chunk
// before; named barriers mark each chunk of the ring full and empty. A gate
// warp's loads of the next chunk are in flight while it forms the current
// one (bf16; float32 inputs load in turn). 256 blocks of 288 threads at the
// prefill shape, two an SM, all resident; no block waits on another, and a
// grid larger than the card runs in waves. Where D is odd or the rows are
// not aligned for paired loads, a lane takes one channel (32-channel tiles).
// The scan keeps the three-pass form this kernel replaced, operation for
// operation: each chunk but the last runs from h = 0 to its decay product
// and local end state, the next chunk's entry state is prod * h_in +
// local, and y is each chunk re-run from its entry state, with the same
// expressions, fmaf contractions and gate approximations (the sigmoids the
// SFU's, common.cuh), so its outputs are bit-identical to that form's and
// reruns are bit-identical. (A form with a block per chunk, chained through
// entry states handed over in global memory by blocks that take tickets in
// chunk order, reads the inputs once too, but on the H100 it was slower:
// only ~3 of the 64 chunk levels fit on the card at a time, as every
// resident chunk holds 64 KB of a and u, and each block's gates took most
// of its life. With one channel a lane and no loads ahead, this form's gate
// warps waited on each chunk's loads.)
//
// rglru_fwd (T <= 64, decode): a thread per (b, channel) runs all of T
// from h_0, its gates formed on the way (the three-pass form's last pass).

#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_float;
using repro::sigmoidf;
using repro::softplusf;
using repro::to_float;

constexpr int kThreads = 128;            // rglru_fwd: channels a block
constexpr int kChunk = 64;               // steps a chunk
constexpr int kGateWarps = 8;            // kChunk / kGateWarps steps of a chunk a warp
constexpr int kRing = 3;                 // chunks of a and u in shared memory
constexpr int kChainThreads = 32 * (1 + kGateWarps);
constexpr int kBarFull = 1, kBarEmpty = 1 + kRing;   // named barriers (0 is __syncthreads)

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// a_t and u_t = beta_t * sigmoid(i_t) * x_t from the float values of one
// element's x, i and r
__device__ __forceinline__ void gates_of(float xv, float iv, float rv, float coef, float& a,
                                         float& u) {
  // The sigmoids are good to a few float32 ulps (common.cuh): they scale u
  // and log a, so their error does not build up along T. a_t itself, whose
  // error would (over ~1 / (1 - a) steps), comes from the accurate expf.
  const float log_a = coef * sigmoidf(rv);
  a = expf(log_a);
  const float beta = sqrtf(-expm1f(2.f * log_a));
  u = beta * (sigmoidf(iv) * xv);
}

// a_t and u_t of element i
template <typename T>
__device__ __forceinline__ void gates(const T* __restrict__ x, const T* __restrict__ ig,
                                      const T* __restrict__ rg, long long i, float coef,
                                      float& a, float& u) {
  gates_of(to_float(x[i]), to_float(ig[i]), to_float(rg[i]), coef, a, u);
}

// Loads of P neighbouring channels of one step, and their float values.
template <typename T, int P>
struct Lanes;
template <typename T>
struct Lanes<T, 1> {
  using raw = T;
  static __device__ __forceinline__ raw load(const T* p) { return *p; }
  static __device__ __forceinline__ float at(const raw& v, int) { return to_float(v); }
  static __device__ __forceinline__ void store(T* p, const float* h) { *p = from_float<T>(h[0]); }
};
template <>
struct Lanes<__nv_bfloat16, 2> {
  using raw = __nv_bfloat162;
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  static __device__ __forceinline__ float at(const raw& v, int e) {
    return e == 0 ? __low2float(v) : __high2float(v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* h) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(h[0], h[1]);
  }
};
template <>
struct Lanes<float, 2> {
  using raw = float2;
  static __device__ __forceinline__ raw load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float at(const raw& v, int e) { return e == 0 ? v.x : v.y; }
  static __device__ __forceinline__ void store(float* p, const float* h) {
    *reinterpret_cast<float2*>(p) = make_float2(h[0], h[1]);
  }
};

// T > kChunk: a block per chain (b, a tile of 32 P channels, P a lane);
// warp 0 scans, warps 1..8 form the gates, each loading the next chunk's
// inputs before it forms the current one's. Shared memory: a, then u,
// (kRing, kChunk, 32 P).
template <typename T, int P>
__global__ void __launch_bounds__(kChainThreads, 2)
    rglru_chain(const T* __restrict__ x, const T* __restrict__ ig, const T* __restrict__ rg,
                const float* __restrict__ a_param, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_out, int Tn, int D, int tiles,
                float c) {
  using LN = Lanes<T, P>;
  constexpr int kW = 32 * P;                // channels a block
  extern __shared__ float ring[];
  float* ka = ring;
  float* ku = ring + kRing * kChunk * kW;
  // the warp's index, known to the compiler as the same across the warp
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / tiles, d0 = (blockIdx.x - b * tiles) * kW + P * lane;
  const bool live = d0 < D;                 // D is a multiple of P
  const int dl = live ? d0 : D - P;         // a lane past D reads channels it does not write
  const long long base = (long long)b * Tn * D + dl;
  const int chunks = (Tn + kChunk - 1) / kChunk;
  if (warp > 0) {
    constexpr int kSteps = kChunk / kGateWarps;
    const int t_first = (warp - 1) * kSteps;
    float coef[P];
#pragma unroll
    for (int e = 0; e < P; ++e) coef[e] = -c * softplusf(a_param[dl + e]);
    typename LN::raw nx[kSteps], ni[kSteps], nr[kSteps];   // the next chunk's inputs
    auto load = [&](int ci) {
      const int n = min(kChunk, Tn - ci * kChunk);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        // past n (the last chunk): a step it has, never read
        const long long i = base + (long long)(ci * kChunk + min(t_first + j, n - 1)) * D;
        nx[j] = LN::load(x + i);
        ni[j] = LN::load(ig + i);
        nr[j] = LN::load(rg + i);
      }
    };
    // bf16: the next chunk's loads in flight while this one's gates form;
    // float32 pairs would take twice the registers, so they load in turn
    constexpr bool kAhead = sizeof(T) == 2;
    if (kAhead) load(0);
    for (int ci = 0; ci < chunks; ++ci) {
      const int slot = ci % kRing;
      if (!kAhead) load(ci);
      typename LN::raw cx[kSteps], ci_[kSteps], cr[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        cx[j] = nx[j];
        ci_[j] = ni[j];
        cr[j] = nr[j];
      }
      if (kAhead && ci + 1 < chunks) load(ci + 1);
      if (ci >= kRing) bar_sync(kBarEmpty + slot, kChainThreads);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        float at[P], ut[P];
#pragma unroll
        for (int e = 0; e < P; ++e)
          gates_of(LN::at(cx[j], e), LN::at(ci_[j], e), LN::at(cr[j], e), coef[e], at[e], ut[e]);
        // a lane's P channels in one store (P = 2: 8 bytes, no bank conflict)
        const int o = (slot * kChunk + t_first + j) * kW + P * lane;
        if constexpr (P == 2) {
          *reinterpret_cast<float2*>(ka + o) = make_float2(at[0], at[1]);
          *reinterpret_cast<float2*>(ku + o) = make_float2(ut[0], ut[1]);
        } else {
          ka[o] = at[0];
          ku[o] = ut[0];
        }
      }
      bar_arrive(kBarFull + slot, kChainThreads);
    }
    return;
  }
  // the scan: y of chunk ci from its entry state h, and, but in the last
  // chunk, the next entry state prod * h + local
  float h[P];
#pragma unroll
  for (int e = 0; e < P; ++e)
    h[e] = (live && h0 != nullptr) ? h0[(long long)b * D + d0 + e] : 0.f;
  for (int ci = 0; ci < chunks; ++ci) {
    const int slot = ci % kRing, n = min(kChunk, Tn - ci * kChunk);
    const long long row = base + (long long)ci * kChunk * D;
    const float* a_s = ka + slot * kChunk * kW + P * lane;
    const float* u_s = ku + slot * kChunk * kW + P * lane;
    bar_sync(kBarFull + slot, kChainThreads);
    float hr[P];
#pragma unroll
    for (int e = 0; e < P; ++e) hr[e] = h[e];
    if (ci + 1 < chunks) {
      float local[P], prod[P];
#pragma unroll
      for (int e = 0; e < P; ++e) local[e] = 0.f, prod[e] = 1.f;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) {
#pragma unroll
        for (int e = 0; e < P; ++e) {
          const float at = a_s[t * kW + e], ut = u_s[t * kW + e];
          hr[e] = at * hr[e] + ut;
          local[e] = at * local[e] + ut;
          prod[e] *= at;
        }
        if (live) LN::store(y + row + (long long)t * D, hr);
      }
#pragma unroll
      for (int e = 0; e < P; ++e) h[e] = prod[e] * h[e] + local[e];
    } else {
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
#pragma unroll
        for (int e = 0; e < P; ++e) hr[e] = a_s[t * kW + e] * hr[e] + u_s[t * kW + e];
        if (live) LN::store(y + row + (long long)t * D, hr);
      }
      if (live)
#pragma unroll
        for (int e = 0; e < P; ++e) h_out[(long long)b * D + d0 + e] = hr[e];
    }
    if (ci + kRing < chunks) bar_arrive(kBarEmpty + slot, kChainThreads);
  }
}

// T <= kChunk (decode): a thread per (b, channel) from h_0, as the
// three-pass form's last pass.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_fwd(const T* __restrict__ x, const T* __restrict__ ig, const T* __restrict__ rg,
              const float* __restrict__ a_param, const float* __restrict__ h0,
              T* __restrict__ y, float* __restrict__ h_out, int Tn, int D, float c) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const float coef = -c * softplusf(a_param[d]);
  float h = h0 != nullptr ? h0[(long long)b * D + d] : 0.f;
  const long long base = (long long)b * Tn * D + d;
#pragma unroll 8
  for (int t = 0; t < Tn; ++t) {
    const long long i = base + (long long)t * D;
    float at, ut;
    gates(x, ig, rg, i, coef, at, ut);
    h = at * h + ut;
    y[i] = from_float<T>(h);
  }
  h_out[(long long)b * D + d] = h;
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* ig, const void* rg, const float* a_param,
                   const float* h0, void* y, float* h_out, int B, int Tn, int D, float c,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* it = static_cast<const T*>(ig);
  const T* rt = static_cast<const T*>(rg);
  T* yt = static_cast<T*>(y);
  if (Tn <= kChunk) {
    rglru_fwd<T><<<dim3((D + kThreads - 1) / kThreads, B), kThreads, 0, s>>>(
        xt, it, rt, a_param, h0, yt, h_out, Tn, D, c);
    return cudaGetLastError();
  }
  // two channels a lane where the rows allow paired loads, else one
  const bool paired = D % 2 == 0 && aligned(x, 2 * sizeof(T)) && aligned(ig, 2 * sizeof(T)) &&
                      aligned(rg, 2 * sizeof(T)) && aligned(y, 2 * sizeof(T));
  const int width = paired ? 64 : 32;
  const int tiles = (D + width - 1) / width;
  if ((long long)B * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int ring_bytes = 2 * kRing * kChunk * width * (int)sizeof(float);
  auto kernel = paired ? rglru_chain<T, 2> : rglru_chain<T, 1>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<B * tiles, kChainThreads, ring_bytes, s>>>(xt, it, rt, a_param, h0, yt, h_out, Tn, D,
                                                      tiles, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, T, D) and h_out (B, D) float32 from x, ig, rg (B, T, D) of one dtype
// (repro::DType), a_param (D,) float32 and h0 (B, D) float32 or null, all
// contiguous. Returns the CUDA error.
int repro_rglru(const void* x, const void* ig, const void* rg, const float* a_param,
                const float* h0, void* y, float* h_out, int dtype, int B, int Tn, int D,
                float c, void* stream) {
  if (B < 0 || B > 65535 || Tn < 0 || D < 0) return (int)cudaErrorInvalidValue;
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
      {"rglru_chain<float, P=2>", reinterpret_cast<const void*>(rglru_chain<float, 2>)},
      {"rglru_chain<bf16, P=2>", reinterpret_cast<const void*>(rglru_chain<__nv_bfloat16, 2>)},
      {"rglru_chain<float, P=1>", reinterpret_cast<const void*>(rglru_chain<float, 1>)},
      {"rglru_chain<bf16, P=1>", reinterpret_cast<const void*>(rglru_chain<__nv_bfloat16, 1>)},
      {"rglru_fwd<float>", reinterpret_cast<const void*>(rglru_fwd<float>)},
      {"rglru_fwd<bf16>", reinterpret_cast<const void*>(rglru_fwd<__nv_bfloat16>)}};
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
