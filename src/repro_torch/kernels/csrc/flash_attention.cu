// Online-softmax (flash) attention for Hopper (sm_90a), with a plain C
// interface that repro_torch/kernels/flash_attention.py binds through ctypes.
//
// Replaces, in the JAX package, kernels/flash_attention.py: flash_attention
// (body _flash_kernel). Same function: q (B, Hq, Tq, D) against k, v
// (B, Hkv, Tk, D), GQA by kv head = q head / (Hq / Hkv), queries at the
// absolute positions i + (Tk - Tq), causal and sliding-window masks, a tanh
// logit softcap, a scale, float32 statistics and accumulator, and 0 for a
// row that sees no key. The TPU kernel walks K/V blocks as the sequential
// minor grid axis with the running (m, l, acc) in VMEM scratch; here one
// block owns one (b, q head, 64-query tile) and loops over the K/V tiles
// itself, so nothing is carried between blocks.
//
// What bounds it. Its bytes are q, k, v read once and o written once (a few
// tens of MB at RecurrentGemma's prefill), its operations 4*Tq*Tk_visible*D
// per head, so at long sequences it is bound by operations: the H100's bf16
// tensor-core peak would be the limit. This first kernel does the products
// on the CUDA cores in float32 (the same arithmetic as the oracle's float32
// upcast), so it runs well below that bound; wgmma and TMA are later work.
// What the design does: K/V tiles past the causal frontier or outside the
// window are never loaded, a K/V tile is loaded once into shared memory and
// used by all 64 queries of the block, and every thread keeps its 4 query
// rows' statistics and D/16 accumulator columns in registers.
//
// Layout of the work in a block of 256 threads: thread (ty, tx) = (tid/16,
// tid%16) owns query rows 4*ty .. 4*ty+3. For S = Q K^T it computes keys
// tx + 16*j (j < 4); for O += P V it owns dims tx + 16*n (n < DMAX/16). A
// row's 16 owners are 16 neighbouring lanes of one warp, so row max and row
// sum are shuffles. The order of every sum is fixed: two launches give the
// same bits.

#include <math_constants.h>

#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;

template <int DMAX>
constexpr size_t flash_smem_bytes() {
  // Q and K tiles with a padded row stride (conflict-free column reads),
  // the V tile, the probabilities P
  return sizeof(float) * (size_t)(kBlockQ * (DMAX + 1) + kBlockK * (DMAX + 1) +
                                  kBlockK * DMAX + kBlockQ * kBlockK);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
              int Tq, int Tk, int D, float scale, float softcap, int causal,
              int window) {
  constexpr int kStride = DMAX + 1;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // (kBlockQ, kStride)
  float* Ks = Qs + kBlockQ * kStride;    // (kBlockK, kStride)
  float* Vs = Ks + kBlockK * kStride;    // (kBlockK, DMAX)
  float* Ps = Vs + kBlockK * DMAX;       // (kBlockQ, kBlockK)

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int row0 = ty * 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const long long q_base = ((long long)b * Hq + hq) * Tq * D;
  const long long k_base = ((long long)b * Hkv + hk) * Tk * D;
  const int offset = Tk - Tq;

  for (int i = tid; i < kBlockQ * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.f;
    if (q0 + r < Tq && d < D) x = to_float(q[q_base + (long long)(q0 + r) * D + d]);
    Qs[r * kStride + d] = x;
  }

  // keys [k_begin, k_end) are the only ones any row of this tile can see
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + kBlockQ, Tq) - 1 + offset;
  int k_begin = 0, k_end = Tk;
  if (causal) k_end = min(k_end, q_hi + 1);
  if (window >= 0) k_begin = max(k_begin, q_lo - window + 1);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) acc[i][n] = 0.f;
  }

  const int kt_end = k_end > k_begin ? (k_end + kBlockK - 1) / kBlockK : 0;
  for (int kt = k_begin / kBlockK; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBlockK * DMAX; i += kThreads) {
      const int r = i / DMAX, d = i % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Tk && d < D) {
        const long long g = k_base + (long long)(k0 + r) * D + d;
        kx = to_float(k[g]);
        vx = to_float(v[g]);
      }
      Ks[r * kStride + d] = kx;
      Vs[r * DMAX + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(row0 + i) * kStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + row0 + i;
      const int qpos = qi + offset;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool visible = qi < Tq && kj < Tk;
        if (causal) visible = visible && kj <= qpos;
        if (window >= 0) visible = visible && qpos - kj < window;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = visible ? x : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // nothing visible yet: nothing to rescale (acc and l are still 0)
      const float corr = m_new == -CUDART_INF_F ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -CUDART_INF_F ? 0.f : expf(s[i][j] - m_new);
        Ps[(row0 + i) * kBlockK + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kCols; ++n) acc[i][n] *= corr;
    }
    __syncthreads();

    const int n_keys = min(kBlockK, Tk - k0);
    for (int c = 0; c < n_keys; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(row0 + i) * kBlockK + c];
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        const float vv = Vs[c * DMAX + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(p[i], vv, acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Tq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      const int d = tx + 16 * n;
      if (d < D) o[q_base + (long long)qi * D + d] = from_float<T>(acc[i][n] / safe_l);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Tq, int Tk, int D, float scale,
                   float softcap, int causal, int window, cudaStream_t s) {
  const size_t smem = flash_smem_bytes<DMAX>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd<T, DMAX><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int Tq, int Tk, int D,
                         float scale, float softcap, int causal, int window,
                         cudaStream_t s) {
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  if (D <= 128) return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
}

}  // namespace

extern "C" {

// Largest head_dim the kernel takes.
int repro_flash_max_head_dim() { return 256; }

// o (B, Hq, Tq, D) = attention of q over k, v, all contiguous, of one dtype
// (repro::DType). window < 0: no window; softcap <= 0: no softcap. Returns
// the CUDA error (cudaErrorInvalidValue for shapes the kernel does not take).
int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                          int dtype, int B, int Hq, int Hkv, int Tq, int Tk,
                          int D, float scale, float softcap, int causal,
                          int window, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Tq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return (int)launch_dtype<float>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
    case repro::kBF16:
      return (int)launch_dtype<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
