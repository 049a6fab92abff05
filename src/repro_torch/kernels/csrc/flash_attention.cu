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
// block owns one (b, q head, query tile) and loops over the K/V tiles
// itself, so nothing is carried between blocks. Two kernels, by dtype:
//
// * bfloat16: flash_fwd_bf16, on the tensor cores (below).
// * float32: flash_fwd<float>, on the CUDA cores in float32, whose products
//   keep the float32 inputs' precision (tensor-core TF32 would not).
//
// What bounds it. Its bytes are q, k, v read once and o written once (a few
// tens of MB at RecurrentGemma's prefill), its operations 4*Tq*Tk_visible*D
// per head, so at long sequences it is bound by operations: for bf16 the
// H100's tensor-core peak. Both kernels load no K/V tile past the causal
// frontier or outside the window, and load a K/V tile once into shared
// memory for all queries of the block.
//
// flash_fwd_bf16. 8 warps, 128 queries per block, each warp owning 16 query
// rows as in FlashAttention-2. S = Q K^T and O += P V are
// mma.sync.m16n8k16 bf16 x bf16 products with float32 accumulators; a bf16
// product is exact in float32, so S differs from a float32 product only in
// the order of its sums. Q, K and V tiles stay bf16 in shared memory with
// an XOR swizzle of their 16-byte chunks (chunk c of row r at c ^ (r % 8)),
// so the ldmatrix reads (Q and K as stored, V transposed) hit 8 distinct
// chunks of 4 banks each. K/V tiles of 64 keys are loaded with cp.async two
// stages deep, tile j + 1 in flight while tile j is computed; Q is loaded
// once and read per 16-wide k-slice, never held in registers, so a warp's
// registers hold its O accumulator (16 x D float32: D/2 per lane), S for
// one K tile, and one slice of P. P never goes through shared memory: the
// S accumulator, rescaled and exponentiated in registers, is already laid
// out as the A operand of the P V product. P is not rounded to bf16 as a
// whole: it is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and both
// are multiplied by V, which keeps P to about 16 bits as the plain version's
// float32 P (the JAX package's TPU kernel also takes P in float32), at the
// cost of a third product per tile. Shared memory: (128 + 2 * 2 * 64) * D
// * 2 bytes, 196,608 at D = 256 (one block of 8 warps per SM), 98,304 at
// D = 128 and 49,152 at D <= 64. Grid order: blockIdx.x is the q head, so
// the heads that share one kv head (all 16 of them under MQA) run side by
// side over the same K/V tiles, and the query tiles go from the last to the
// first, so under a causal mask the longest blocks start first.
//
// flash_fwd<float>. Thread (ty, tx) = (tid/16, tid%16) of 256 owns query
// rows 4*ty .. 4*ty+3 of a 64-query tile. For S = Q K^T it computes keys
// tx + 16*j (j < 4); for O += P V it owns dims tx + 16*n (n < DMAX/16). A
// row's 16 owners are 16 neighbouring lanes of one warp, so row max and row
// sum are shuffles.
//
// Both kernels sum in a fixed order everywhere: two launches give the same
// bits.

#include <cstdint>
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

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                       int Hkv, int Tq, int Tk, int D, float scale, float softcap,
                       int causal, int window, cudaStream_t s) {
  if (D <= 32) return launch<float, 32>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  if (D <= 64) return launch<float, 64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  if (D <= 128) return launch<float, 128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  return launch<float, 256>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
}

// ---------------------------------------------------------------------------
// flash_fwd_bf16: the tensor-core kernel for bfloat16 inputs (see the header)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBlockQ = 16 * kTcWarps;  // 16 query rows per warp
constexpr int kTcBlockK = 64;             // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int DMAX>
constexpr size_t tc_smem_bytes() {
  // Q, then two stages of K and V, all bf16
  return sizeof(bf16) * (size_t)DMAX * (kTcBlockQ + 2 * 2 * kTcBlockK);
}

// Byte offset of the 16-byte chunk c (8 elements) of row r in a swizzled
// tile with DMAX elements per row.
template <int DMAX>
__device__ __forceinline__ unsigned swz(int r, int c) {
  return (unsigned)(r * DMAX * 2 + ((c ^ (r & 7)) << 4));
}

// rows [row0, row0 + ROWS) of a (T, D) bf16 matrix into a swizzled tile;
// rows past T and columns past D are zeros (so padding adds nothing and a
// masked key's V row is 0, never garbage times 0). VEC: D % 8 == 0 and the
// matrix is 16-byte aligned, so every chunk is one cp.async.
template <int DMAX, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ g, int row0,
                                          int T, int D) {
  constexpr int kChunks = DMAX / 8;
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < T && c * 8 < D;
    if (VEC) {
      const bf16* src = ok ? g + (size_t)row * D + c * 8 : g;
      repro::cp_async16(base + swz<DMAX>(r, c), src, ok ? 16 : 0);
    } else {
      bf16* dst = reinterpret_cast<bf16*>(base + swz<DMAX>(r, c));
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c * 8 + e;
        dst[e] = ok && col < D ? g[(size_t)row * D + col] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8, float32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// (x0, x1) as bf16 pairs hi and lo with hi + lo = (x0, x1) to about 16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// registers budgeted for two blocks per SM below D = 256, whose 196,608
// bytes of shared memory leave room for one
template <int DMAX, bool VEC>
__global__ void __launch_bounds__(kTcThreads, DMAX == 256 ? 1 : 2)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int Hq, int Hkv, int Tq,
                   int Tk, int D, float scale, float softcap, int causal, int window) {
  constexpr int kNt = kTcBlockK / 8;  // n-tiles of S
  constexpr int kDt = DMAX / 8;       // n-tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks0 = Qs + kTcBlockQ * DMAX;
  bf16* Vs0 = Ks0 + 2 * kTcBlockK * DMAX;
  const unsigned q_sm = static_cast<unsigned>(__cvta_generic_to_shared(Qs));
  const unsigned k_sm = static_cast<unsigned>(__cvta_generic_to_shared(Ks0));
  const unsigned v_sm = static_cast<unsigned>(__cvta_generic_to_shared(Vs0));
  constexpr unsigned kKvStageBytes = kTcBlockK * DMAX * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hq = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBlockQ;
  const int hk = hq / (Hq / Hkv);
  const bf16* qh = q + ((size_t)b * Hq + hq) * Tq * D;
  const bf16* kh = k + ((size_t)b * Hkv + hk) * Tk * D;
  const bf16* vh = v + ((size_t)b * Hkv + hk) * Tk * D;
  const int offset = Tk - Tq;

  // keys [k_begin, k_end) are the only ones any row of this block can see
  const int q_hi = min(q0 + kTcBlockQ, Tq) - 1 + offset;
  int k_begin = 0, k_end = Tk;
  if (causal) k_end = min(k_end, q_hi + 1);
  if (window >= 0) k_begin = max(k_begin, q0 + offset - window + 1);
  const int kt_first = k_begin / kTcBlockK;
  const int kt_end = k_end > k_begin ? (k_end + kTcBlockK - 1) / kTcBlockK : 0;

  // this warp's rows and the keys they can see
  const int wq0 = q0 + warp * 16;
  const bool warp_live = wq0 < Tq;
  const int w_lo = wq0 + offset, w_hi = min(wq0 + 16, Tq) - 1 + offset;
  const int wk_begin = window >= 0 ? max(0, w_lo - window + 1) : 0;
  const int wk_end = causal ? min(Tk, w_hi + 1) : Tk;
  const int rows_pos[2] = {wq0 + g + offset, wq0 + g + 8 + offset};
  const bool rows_ok[2] = {wq0 + g < Tq, wq0 + g + 8 < Tq};

  load_tile<DMAX, kTcBlockQ, VEC>(Qs, qh, q0, Tq, D);
  if (kt_first < kt_end) {
    load_tile<DMAX, kTcBlockK, VEC>(Ks0, kh, kt_first * kTcBlockK, Tk, D);
    load_tile<DMAX, kTcBlockK, VEC>(Vs0, vh, kt_first * kTcBlockK, Tk, D);
  }
  repro::cp_async_commit();

  float acc[kDt][4];
#pragma unroll
  for (int n = 0; n < kDt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int kt = kt_first; kt < kt_end; ++kt) {
    const int stage = (kt - kt_first) & 1;
    const int k0 = kt * kTcBlockK;
    if (kt + 1 < kt_end) {  // into the stage tile kt - 1 used, freed by the barrier below
      load_tile<DMAX, kTcBlockK, VEC>(Ks0 + (stage ^ 1) * kTcBlockK * DMAX, kh,
                                      k0 + kTcBlockK, Tk, D);
      load_tile<DMAX, kTcBlockK, VEC>(Vs0 + (stage ^ 1) * kTcBlockK * DMAX, vh,
                                      k0 + kTcBlockK, Tk, D);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // tile kt (and Q) landed; tile kt + 1 may be in flight
    __syncthreads();

    if (warp_live && k0 < wk_end && k0 + kTcBlockK > wk_begin) {
      const unsigned ks = k_sm + stage * kKvStageBytes;
      const unsigned vs = v_sm + stage * kKvStageBytes;
      // S = Q K^T for this warp's 16 rows and the tile's 64 keys
      float sc[kNt][4];
#pragma unroll
      for (int n = 0; n < kNt; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_sm + swz<DMAX>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int n2 = 0; n2 < kNt / 2; ++n2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + swz<DMAX>(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kk + ((lane >> 3) & 1)));
          mma_bf16(sc[2 * n2], a, bk[0], bk[1]);
          mma_bf16(sc[2 * n2 + 1], a, bk[2], bk[3]);
        }
      }
      // does every (row, key) of this warp and tile pass every mask?
      const bool whole = wq0 + 16 <= Tq && k0 + kTcBlockK <= Tk &&
                         (!causal || k0 + kTcBlockK - 1 <= w_lo) &&
                         (window < 0 || w_hi - k0 < window);
      // scale, softcap, mask, and the online softmax; element e of n-tile n
      // is row g + 8 * (e / 2), key k0 + 8 * n + 2 * t4 + e % 2
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          if (!whole) {
            const int r = e >> 1, kj = k0 + 8 * n + 2 * t4 + (e & 1);
            bool visible = rows_ok[r] && kj < Tk;
            if (causal) visible = visible && kj <= rows_pos[r];
            if (window >= 0) visible = visible && rows_pos[r] - kj < window;
            if (!visible) x = -CUDART_INF_F;
          }
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], mneg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // nothing visible yet: nothing to rescale (acc and l are still 0)
        corr[r] = m_new == -CUDART_INF_F ? 1.f : exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        mneg[r] = m_new == -CUDART_INF_F ? 0.f : -m_new * kLog2e;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < kDt; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[n][e];
          const float p = x == -CUDART_INF_F ? 0.f : exp2f(fmaf(x, kLog2e, mneg[e >> 1]));
          sc[n][e] = p;
          l[e >> 1] += p;
        }
      }
      // O += P V, 16 keys at a time; the S fragments of n-tiles 2kk and
      // 2kk + 1 are the A fragment of keys 16kk .. 16kk + 15
#pragma unroll
      for (int kk = 0; kk < kTcBlockK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int n2 = 0; n2 < kDt / 2; ++n2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + swz<DMAX>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * n2 + (lane >> 4)));
          mma_bf16(acc[2 * n2], hi, bv[0], bv[1]);
          mma_bf16(acc[2 * n2 + 1], hi, bv[2], bv[3]);
          mma_bf16(acc[2 * n2], lo, bv[0], bv[1]);
          mma_bf16(acc[2 * n2 + 1], lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  repro::cp_async_wait<0>();
  if (!warp_live) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows_ok[r]) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];  // a row that sees no key gives 0
    bf16* orow = o + (((size_t)b * Hq + hq) * Tq + wq0 + g + 8 * r) * D;
#pragma unroll
    for (int n = 0; n < kDt; ++n) {
      const int col = 8 * n + 2 * t4;
      const float x0 = acc[n][2 * r] * inv, x1 = acc[n][2 * r + 1] * inv;
      if (VEC) {  // D % 8 == 0: col < D means col + 1 < D, and the pair is aligned
        if (col < D) *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DMAX, bool VEC>
cudaError_t launch_bf16_t(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                          int Hkv, int Tq, int Tk, int D, float scale, float softcap,
                          int causal, int window, cudaStream_t s) {
  const size_t smem = tc_smem_bytes<DMAX>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<DMAX, VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, (Tq + kTcBlockQ - 1) / kTcBlockQ, B);
  flash_fwd_bf16<DMAX, VEC><<<grid, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_bf16_d(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                          int Hkv, int Tq, int Tk, int D, float scale, float softcap,
                          int causal, int window, cudaStream_t s) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  if (D % 8 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o))
    return launch_bf16_t<DMAX, true>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  return launch_bf16_t<DMAX, false>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int Tq, int Tk, int D, float scale, float softcap, int causal,
                        int window, cudaStream_t s) {
  if (D <= 64) return launch_bf16_d<64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  if (D <= 128) return launch_bf16_d<128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  return launch_bf16_d<256>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
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
  if (dtype == repro::kBF16 && (Tq + kTcBlockQ - 1) / kTcBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return (int)launch_f32(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
    case repro::kBF16:
      return (int)launch_bf16(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The i-th kernel of this file: its name, registers per thread and local
// (spill) bytes per thread. Returns 0, -1 past the last kernel, or the CUDA error.
int repro_flash_kernel_info(int i, const char** name, int* regs, int* local_bytes) {
  static const repro::KernelRef table[] = {
      {"flash_fwd<float, 32>", reinterpret_cast<const void*>(flash_fwd<float, 32>)},
      {"flash_fwd<float, 64>", reinterpret_cast<const void*>(flash_fwd<float, 64>)},
      {"flash_fwd<float, 128>", reinterpret_cast<const void*>(flash_fwd<float, 128>)},
      {"flash_fwd<float, 256>", reinterpret_cast<const void*>(flash_fwd<float, 256>)},
      {"flash_fwd_bf16<64>", reinterpret_cast<const void*>(flash_fwd_bf16<64, true>)},
      {"flash_fwd_bf16<64, unaligned>", reinterpret_cast<const void*>(flash_fwd_bf16<64, false>)},
      {"flash_fwd_bf16<128>", reinterpret_cast<const void*>(flash_fwd_bf16<128, true>)},
      {"flash_fwd_bf16<128, unaligned>", reinterpret_cast<const void*>(flash_fwd_bf16<128, false>)},
      {"flash_fwd_bf16<256>", reinterpret_cast<const void*>(flash_fwd_bf16<256, true>)},
      {"flash_fwd_bf16<256, unaligned>", reinterpret_cast<const void*>(flash_fwd_bf16<256, false>)}};
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
