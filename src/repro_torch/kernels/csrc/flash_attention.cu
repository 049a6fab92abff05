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
// itself, so nothing is carried between blocks, keys are never split across
// blocks and no sum goes through an atomic.
//
// Which kernel runs (repro_flash_attention, below):
//
// * bfloat16, D % 8 == 0 and all four tensors 16-byte aligned:
//   flash_fwd_hopper, D padded to DMAX in {64, 128, 256} (TMA's zero fill;
//   TMA needs rows of a multiple of 16 bytes);
// * bfloat16 otherwise (D % 8 != 0, or a view whose rows TMA cannot
//   address): flash_fwd_bf16, an Ampere-style kernel (mma.sync, every
//   element loaded by the threads themselves);
// * float32: flash_fwd<float>, on the CUDA cores in float32, whose products
//   keep the float32 inputs' precision (tensor-core TF32 would not).
//
// What bounds it. Its bytes are q, k, v read once and o written once (a few
// tens of MB at the serving shapes), its operations 4 * Tq * Tk_visible * D
// per head, so at every prefill shape it is bound by operations: for bf16
// the H100's 989 TFLOP/s tensor-core peak, which only wgmma reaches. P is
// not rounded to bf16 as a whole: it enters P V as P_hi = bf16(P) and P_lo
// = bf16(P - P_hi), about 16 bits of P, as the plain version's float32 P
// (the TPU kernel also takes P in float32); that is a third product per
// tile, 1.5x the tensor work of plain flash. At D = 64 the per-score
// arithmetic around the products (scale, mask, max, exp2, the P_hi/P_lo
// split) costs about as much as the products themselves.
//
// flash_fwd_hopper. A block is NWG warpgroups of 64 query rows each: one
// (three blocks an SM) at DMAX 64, two (one block an SM) at DMAX 128 and
// 256.
// * Loads. One thread issues TMA copies: the Q tile once, then K and V tiles
//   into a ring of kStages stages, each with a "full" mbarrier (the copies'
//   bytes) and an "empty" one (every warp done with it). It refills a stage
//   as soon as every warp has given it back, and before it waits for a tile
//   it makes sure that tile was issued. The tensor maps are 3-D, (D, T,
//   B * H), encoded on the host (cuTensorMapEncodeTiled, taken through
//   cudaGetDriverEntryPointByVersion: no link against libcuda) and passed as
//   __grid_constant__ parameters, so a ragged last tile and the columns
//   D..DMAX are zero-filled and never read the next head's rows. Tiles land
//   in 64-column slabs of 128-byte rows in TMA's 128-byte swizzle, the layout
//   wgmma's descriptors read. No thread spends registers on a load.
// * Products. S = Q K^T is wgmma m64nKk16 (K the tile's keys), both operands
//   shared-memory descriptors (K-major). O += P V is m64nDk16 (D = DMAX),
//   P_hi then P_lo from registers as the A operand (the S accumulator is
//   already laid out as the A fragment), V through the transposed (MN-major)
//   B descriptor. Products are bf16 x bf16 into float32, exact, so S differs
//   from a float32 product only in the order of its sums. Each tile's S is
//   issued together with the last tile's P V, which then runs beside the
//   tile's softmax.
// * Registers. No producer warp: with one (and setmaxnreg to move its
//   registers to the consumers) ptxas of CUDA 12.9 still held every thread to
//   the 168 registers the 384-thread launch bound allows, spilled, and
//   serialized the wgmmas; without one a block of 256 threads may use 255,
//   and three 128-thread blocks an SM at DMAX 64 (64-key tiles) fit in 168.
//   No instantiation spills.
// * Tiles. K/V tiles of kBlockK keys: 128 at DMAX 128, 64 at DMAX 64 and
//   256 (the 128 x 256 Q tile and two stages of 64-key K and V fill 192 KB
//   of the 227 KB). Stages: 4 at DMAX 64, 3 at 128, 2 at 256.
// * What bounds it. At DMAX 64 the per-score work around the products
//   (scale, mask, max, exp2, the P_hi/P_lo split, the row sums: about eight
//   instructions a score, one of them on the 16-lane special-function
//   unit) takes about as long as the products, and the two only partly
//   overlap; at DMAX 128 and 256 the products (1.5x plain flash) dominate.
// * Grid. blockIdx.x is the q head, so the heads that share one kv head run
//   side by side over the same K/V tiles in L2, and the query tiles go from
//   the last to the first, so under a causal mask the longest blocks start
//   first. At DMAX 64 three 64-row blocks share an SM, so a short grid
//   (whisper's cross-attention: 384 blocks) still fills the card, and one
//   block's start overlaps the others' loops.
// * Determinism and batch invariance. A row's sums run over the K/V tiles
//   in order, each tile's products in a fixed instruction order, and the
//   tile width depends on DMAX alone. A tile a row cannot see adds exactly
//   nothing (its rescale is 1 and its P is 0), so which tiles a block
//   visits, and so B, the head count and the SM count, leave every bit of a
//   row unchanged. Two launches give the same bits.
//
// flash_fwd_bf16 (the unaligned fallback). 8 warps, 128 queries per block,
// each warp owning 16 query rows as in FlashAttention-2, S = Q K^T and
// O += P V as mma.sync.m16n8k16 products from ldmatrix reads of
// XOR-swizzled tiles, P_hi + P_lo as above, K/V tiles of 64 keys two
// stages deep, loaded element by element with zeros past T and D.
//
// flash_fwd<float>. Thread (ty, tx) = (tid/16, tid%16) of 256 owns query
// rows 4*ty .. 4*ty+3 of a 64-query tile. For S = Q K^T it computes keys
// tx + 16*j (j < 4); for O += P V it owns dims tx + 16*n (n < DMAX/16). A
// row's 16 owners are 16 neighbouring lanes of one warp, so row max and row
// sum are shuffles.

#include <cuda.h>
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
// flash_fwd_bf16: the unaligned bfloat16 kernel (see the header)
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

// rows [row0, row0 + ROWS) of a (T, D) bf16 matrix into a swizzled tile,
// element by element (any D, any alignment); rows past T and columns past
// D are zeros (so padding adds nothing and a masked key's V row is 0, never
// garbage times 0)
template <int DMAX, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ g, int row0,
                                          int T, int D) {
  constexpr int kChunks = DMAX / 8;
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < T && c * 8 < D;
    bf16* dst = reinterpret_cast<bf16*>(base + swz<DMAX>(r, c));
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = c * 8 + e;
      dst[e] = ok && col < D ? g[(size_t)row * D + col] : __float2bfloat16_rn(0.f);
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
template <int DMAX>
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

  load_tile<DMAX, kTcBlockQ>(Qs, qh, q0, Tq, D);
  if (kt_first < kt_end) {
    load_tile<DMAX, kTcBlockK>(Ks0, kh, kt_first * kTcBlockK, Tk, D);
    load_tile<DMAX, kTcBlockK>(Vs0, vh, kt_first * kTcBlockK, Tk, D);
  }

  float acc[kDt][4];
#pragma unroll
  for (int n = 0; n < kDt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int kt = kt_first; kt < kt_end; ++kt) {
    const int stage = (kt - kt_first) & 1;
    const int k0 = kt * kTcBlockK;
    if (kt + 1 < kt_end) {  // into the stage tile kt - 1 used, freed by the barrier below
      load_tile<DMAX, kTcBlockK>(Ks0 + (stage ^ 1) * kTcBlockK * DMAX, kh, k0 + kTcBlockK, Tk, D);
      load_tile<DMAX, kTcBlockK>(Vs0 + (stage ^ 1) * kTcBlockK * DMAX, vh, k0 + kTcBlockK, Tk, D);
    }
    __syncthreads();  // tile kt (and Q) stored

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
      if (col < D) orow[col] = __float2bfloat16_rn(x0);
      if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(x1);
    }
  }
}

template <int DMAX>
cudaError_t launch_bf16_unaligned(const void* q, const void* k, const void* v, void* o, int B,
                                  int Hq, int Hkv, int Tq, int Tk, int D, float scale,
                                  float softcap, int causal, int window, cudaStream_t s) {
  const size_t smem = tc_smem_bytes<DMAX>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, (Tq + kTcBlockQ - 1) / kTcBlockQ, B);
  flash_fwd_bf16<DMAX><<<grid, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_fwd_hopper: TMA loads, wgmma products (see the header)
// ---------------------------------------------------------------------------

// Shared memory of one block: the Q tile, kStages K tiles, kStages V tiles,
// each as DMAX / 64 slabs of 64 columns (128-byte rows, 128-byte swizzle,
// every slab 1024-byte aligned), then the mbarriers. Threads: NWG
// warpgroups, 64 query rows each.
template <int DMAX, int NWG>
struct HopperTile {
  static constexpr int kBlockK = DMAX == 128 ? 128 : 64;
  static constexpr int kStages = DMAX == 64 ? 4 : DMAX == 128 ? 3 : 2;
  static constexpr int kSlabs = DMAX / 64;
  static constexpr int kRowsQ = 64 * NWG;
  static constexpr int kThreads = 128 * NWG;
  static constexpr uint32_t kQSlab = kRowsQ * 128;
  static constexpr uint32_t kKvSlab = kBlockK * 128;
  static constexpr uint32_t kQBytes = kSlabs * kQSlab;
  static constexpr uint32_t kKvBytes = kSlabs * kKvSlab;  // one K (or V) tile
  static constexpr uint32_t kK = kQBytes;                  // stage s: kK + s * kKvBytes
  static constexpr uint32_t kV = kK + kStages * kKvBytes;
  static constexpr uint32_t kBar = kV + kStages * kKvBytes;  // q, full[kStages], empty[kStages]
  static constexpr size_t kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;  // + base alignment
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
  static constexpr int kBlocksPerSm = NWG == 1 ? 3 : 1;
  static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472, "the blocks an SM holds");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` more bytes of TMA copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// has the phase of `parity` completed? (does not wait)
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of `parity` has completed; a wait of about 4 s (2^33
// cycles) traps, so a fault in the protocol ends the launch with an error
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

// one TMA box of a 3-D tensor map, coordinates (column, row, matrix), into
// shared memory at dst; the copy's bytes complete on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// lbo / sbo the byte strides between 64-column slabs (MN-major; unused when
// K-major) and between 8-row groups
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup's products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving uses of registers an asynchronous wgmma
// reads or writes across its fence and wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void pin(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(r[i]);
}
template <int M, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// the accumulator operands of an m64nNk16 product: "{%0, ..., %(N/2 - 1)}"
#define REPRO_WG_D64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" "}"
#define REPRO_WG_D128 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" "}"
#define REPRO_WG_D256 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" "}"
#define REPRO_F8(d, i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_F32(d) REPRO_F8(d, 0), REPRO_F8(d, 8), REPRO_F8(d, 16), REPRO_F8(d, 24)

// d (64 x 64M, float32, the warpgroup's fragment: d[m] holds columns
// 64m .. 64m + 63) += A (64 x 16) B (16 x 64M), A and B bf16 in shared
// memory, both K-major
template <int M>
__device__ __forceinline__ void wgmma_ss(float (&d)[M][32], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<1>(float (&d)[1][32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_D64
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_F32(d[0])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<2>(float (&d)[2][32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_WG_D128
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : REPRO_F32(d[0]), REPRO_F32(d[1])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64M, float32) += A (64 x 16, bf16 from registers) B (16 x 64M,
// bf16 in shared memory, MN-major)
template <int M>
__device__ __forceinline__ void wgmma_rs(float (&d)[M][32], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<1>(float (&d)[1][32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_WG_D64
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_F32(d[0])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<2>(float (&d)[2][32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_WG_D128
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_F32(d[0]), REPRO_F32(d[1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<4>(float (&d)[4][32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REPRO_WG_D256
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : REPRO_F32(d[0]), REPRO_F32(d[1]), REPRO_F32(d[2]), REPRO_F32(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the scores of one K tile, in place, and each row's running max over them:
// RAW, s itself (the scale goes into the exponent), else x = s * scale and
// the softcap if there is one; -inf where a mask hides the key (MASK: the
// tile is not wholly visible to the warpgroup)
struct Scores {
  float scale, softcap, inv_softcap;
  int Tk, causal, window;
  int key0;           // this lane's first key in a tile: 2 * (lane % 4)
  int rows_pos[2];    // absolute positions of this lane's two rows
  bool rows_ok[2];    // the rows are < Tq
};

template <bool RAW, bool MASK, int NH>
__device__ __forceinline__ void scores(float (&sc)[NH][32], float (&mx)[2], const Scores& p,
                                       int k0) {
  // four partial maxima a row (max is exact in any order): independent
  // chains for the scheduler
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[r][j] = -CUDART_INF_F;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      float x = sc[h][e];
      if (!RAW) {
        x *= p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.inv_softcap);
      }
      if (MASK) {
        const int kj = k0 + p.key0 + 64 * h + 8 * (e >> 2) + (e & 1);
        bool visible = p.rows_ok[r] && kj < p.Tk;
        if (p.causal) visible = visible && kj <= p.rows_pos[r];
        if (p.window >= 0) visible = visible && p.rows_pos[r] - kj < p.window;
        if (!visible) x = -CUDART_INF_F;
      }
      sc[h][e] = x;
      part[r][(e >> 2) & 3] = fmaxf(part[r][(e >> 2) & 3], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(mx[r], fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3])));
}

// zero S's registers and fence them before the wgmma that accumulates into
// them (the fence also orders the P V operands written since the last one)
template <int NH>
__device__ __forceinline__ void fence_s(float (&sc)[NH][32]) {
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[h][e] = 0.f;
  pin(sc);
  wgmma_fence();
}

// S = Q K^T for the warpgroup's 64 rows and a K tile, 16 columns of D a
// step, one m64nKk16 product each: issued and committed, not waited for.
// dq, dk: descriptors of the warpgroup's Q rows and of the tile's first K
// slab
template <class L, int NH>
__device__ __forceinline__ void issue_s(float (&sc)[NH][32], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kd = 0; kd < L::kSlabs * 4; ++kd) {
    const uint32_t col = (kd % 4) * 32;  // 16 columns a step in a 64-column slab
    wgmma_ss(sc, dq + (((kd / 4) * L::kQSlab + col) >> 4),
             dk + (((kd / 4) * L::kKvSlab + col) >> 4));
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V for a V tile (dv: the descriptor of its first slab),
// 16 keys a step, one m64nDk16 product each for P_hi and P_lo: issued and
// committed, not waited for
template <class L, int NK>
__device__ __forceinline__ void issue_pv(float (&acc)[L::kSlabs][32], const uint32_t (&ph)[NK][4],
                                         const uint32_t (&pl)[NK][4], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t d = dv + ((kk * 16 * 128) >> 4);
    wgmma_rs(acc, ph[kk], d);
    wgmma_rs(acc, pl[kk], d);
  }
  wgmma_commit();
}

// The running max and sum of this lane's two rows over the tiles so far.
struct OnlineSoftmax {
  float m[2];     // the running max
  float l[2];     // this lane's part of the row sums
  float corr[2];  // the last tile's rescale of O and l
  float mneg[2];  // - the running max times mult
  float mult;     // log2 e, times the scale when the scores are raw

  __device__ __forceinline__ void init() {
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }

  // a tile's scores (s, in place) become P = 2^(x mult - m mult) in two
  // steps: take_max() takes the scores (raw, the scale goes into the exponent:
  // no softcap, a positive scale; else x = s * scale and the softcap; a
  // masked x -inf) and the new running max, to_probs() the P (0 for a masked x:
  // ex2(-inf) = 0) and the row sums
  template <int NH>
  __device__ __forceinline__ void take_max(float (&sc)[NH][32], bool raw, bool whole,
                                           const Scores& sp, int k0) {
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (raw) {
      if (whole) scores<true, false>(sc, mx, sp, k0);
      else scores<true, true>(sc, mx, sp, k0);
    } else {
      if (whole) scores<false, false>(sc, mx, sp, k0);
      else scores<false, true>(sc, mx, sp, k0);
    }
    mult = raw ? sp.scale * kLog2e : kLog2e;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // nothing visible yet: nothing to rescale (O and l are still 0)
      corr[r] = m_new == -CUDART_INF_F ? 1.f : ex2((m[r] - m_new) * mult);
      m[r] = m_new;
      mneg[r] = m_new == -CUDART_INF_F ? 0.f : -m_new * mult;
      l[r] *= corr[r];
    }
  }

  template <int NH>
  __device__ __forceinline__ void to_probs(float (&sc)[NH][32]) {
    // the tile's row sums in four partial sums a row, added in a fixed order
    float part[2][4] = {};
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        sc[h][e] = ex2(fmaf(sc[h][e], mult, mneg[r]));
        part[r][(e >> 2) & 3] += sc[h][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] += (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
  }

  // 1 / the row sums, 0 for a row that saw no key
  __device__ __forceinline__ void finish(float (&inv)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      inv[r] = t == 0.f ? 0.f : 1.f / t;
    }
  }
};

// O rescaled by the tile's correction, and the tile's P (in sc) split into
// the bf16 pairs of its P V: n-chunks 2kk and 2kk + 1 of S are the A
// fragment of keys 16kk .. 16kk + 15, register j holding row g + 8 (j % 2),
// keys 2 t + 8 (j / 2)
template <class L, int NH, int NK>
__device__ __forceinline__ void to_p(float (&sc)[NH][32], float (&acc)[L::kSlabs][32],
                                     const OnlineSoftmax& sm, uint32_t (&ph)[NK][4],
                                     uint32_t (&pl)[NK][4]) {
#pragma unroll
  for (int c = 0; c < L::kSlabs; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] *= sm.corr[(e >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = kk / 4, e0 = 8 * (kk % 4) + 2 * j;
      split_bf16(sc[h][e0], sc[h][e0 + 1], ph[kk][j], pl[kk][j]);
    }
  }
}

// The ring's copies, issued by one thread: tile i of the block's run goes
// into stage i % kStages once every warp has given back that stage's last
// tile, i - kStages. refill() issues every tile it can without waiting;
// ensure(i) issues up to tile i, waiting for stages as it must.
template <class L>
struct TileLoader {
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  uint32_t base, full0, empty0;
  int kt_first, n_tiles, z;  // z: the (batch, kv head) matrix of the maps
  int next;                  // tiles issued so far

  __device__ __forceinline__ void issue() {
    const int s = next % L::kStages;
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, 2 * L::kKvBytes);
    const int k0 = (kt_first + next) * L::kBlockK;
#pragma unroll
    for (int c = 0; c < L::kSlabs; ++c) {
      tma_load(base + L::kK + s * L::kKvBytes + c * L::kKvSlab, tm_k, full, 64 * c, k0, z);
      tma_load(base + L::kV + s * L::kKvBytes + c * L::kKvSlab, tm_v, full, 64 * c, k0, z);
    }
    ++next;
  }
  // the stage of tile `next` is free: its last tile was given back
  __device__ __forceinline__ bool stage_free(bool wait) {
    if (next < L::kStages) return true;
    const uint32_t empty = empty0 + 8 * (next % L::kStages);
    const uint32_t parity = ((next / L::kStages) & 1) ^ 1;
    if (wait) mbar_wait(empty, parity);
    return wait || mbar_test(empty, parity);
  }
  __device__ __forceinline__ void refill() {
    while (next < n_tiles && stage_free(false)) issue();
  }
  __device__ __forceinline__ void ensure(int i) {
    while (next <= i && stage_free(true)) issue();
  }

  // wait for tile i (the issuer first makes sure it was issued)
  __device__ __forceinline__ void arrived(int i, bool issuer) {
    if (issuer) ensure(i);
    mbar_wait(full0 + 8 * (i % L::kStages), (i / L::kStages) & 1);
    __syncwarp();
  }
  // this warp is done with tile i: one arrival on its stage's empty barrier
  // (and the issuer refills what it can)
  __device__ __forceinline__ void done(int i, bool issuer, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (i % L::kStages));
    if (issuer) refill();
    __syncwarp();
  }
};

// A warpgroup's fragment of a 64 x 64 product (wgmma's accumulator layout):
// element e of warp w, lane (g = lane / 4, t = lane % 4) is row
// 16 w + g + 8 ((e / 2) % 2), column 8 (e / 4) + 2 t + e % 2.
template <int DMAX, int NWG>
__global__ void __launch_bounds__(HopperTile<DMAX, NWG>::kThreads,
                                  HopperTile<DMAX, NWG>::kBlocksPerSm)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int Hq,
                     int Hkv, int Tq, int Tk, int D, float scale, float softcap, int causal,
                     int window) {
  using L = HopperTile<DMAX, NWG>;
  constexpr int kBlockK = L::kBlockK, kStages = L::kStages, kSlabs = L::kSlabs;
  constexpr int kNh = kBlockK / 64;  // 64-key halves of a K tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
                        ~1023u;
  // mbarriers: Q's, then a "full" one (the copies' bytes) and an "empty" one
  // (every warp done with it) for each stage
  const uint32_t bar_q = base + L::kBar, full0 = bar_q + 8, empty0 = full0 + 8 * kStages;

  const int hq = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kRowsQ;
  const int hk = hq / (Hq / Hkv);
  const int offset = Tk - Tq;
  // keys [k_begin, k_end) are the only ones any row of this block can see
  const int q_hi = min(q0 + L::kRowsQ, Tq) - 1 + offset;
  int k_begin = 0, k_end = Tk;
  if (causal) k_end = min(k_end, q_hi + 1);
  if (window >= 0) k_begin = max(k_begin, q0 + offset - window + 1);
  const int kt_first = k_begin / kBlockK;
  const int n_tiles = k_end > k_begin ? (k_end + kBlockK - 1) / kBlockK - kt_first : 0;

  const bool issuer = threadIdx.x == 0;
  TileLoader<L> loader{&tm_k, &tm_v, base, full0, empty0, kt_first, n_tiles, b * Hkv + hk, 0};
  if (issuer) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (issuer && n_tiles > 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < kSlabs; ++c)
      tma_load(base + c * L::kQSlab, &tm_q, bar_q, 64 * c, q0, b * Hq + hq);
    loader.refill();  // the first kStages tiles
  }

  // this warpgroup (warp-uniform to the compiler: a shuffle of lane 0's)
  // owns 64 query rows
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x % 128 / 32, 0), lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wq0 = q0 + 64 * wg;
  const bool wg_live = wq0 < Tq;
  // its rows, the keys they can see, and the tiles [i_lo, i_hi) that hold
  // any of those keys: one run of the block's tiles
  const int w_lo = wq0 + offset, w_hi = min(wq0 + 64, Tq) - 1 + offset;
  const int wk_begin = window >= 0 ? max(0, w_lo - window + 1) : 0;
  const int wk_end = causal ? min(Tk, w_hi + 1) : Tk;
  int i_lo = 0, i_hi = 0;
  if (wg_live && wk_end > wk_begin) {
    i_lo = min(max(wk_begin / kBlockK - kt_first, 0), n_tiles);
    i_hi = min(max((wk_end + kBlockK - 1) / kBlockK - kt_first, i_lo), n_tiles);
  }
  const int row = 16 * warp + g;  // this thread's rows: row, row + 8
  const Scores sp{scale, softcap, softcap > 0.f ? 1.f / softcap : 0.f, Tk, causal, window,
                  2 * t4, {wq0 + row + offset, wq0 + row + 8 + offset},
                  {wq0 + row < Tq, wq0 + row + 8 < Tq}};
  const bool raw = softcap <= 0.f && scale > 0.f;
  // does every (row, key) of the warpgroup and the tile at k0 pass every mask?
  const auto whole_tile = [wq0, Tq, Tk, causal, window, w_lo, w_hi](int k0) {
    return wq0 + 64 <= Tq && k0 + kBlockK <= Tk && (!causal || k0 + kBlockK - 1 <= w_lo) &&
           (window < 0 || w_hi - k0 < window);
  };
  // descriptors of the warpgroup's Q rows and of stage 0's K and V
  const uint64_t dq = sw128_desc(base + 64 * wg * 128, 16, 1024);
  const uint64_t dk = sw128_desc(base + L::kK, 16, 1024);
  const uint64_t dv = sw128_desc(base + L::kV, L::kKvSlab, 1024);

  float acc[kSlabs][32];
#pragma unroll
  for (int c = 0; c < kSlabs; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  OnlineSoftmax sm;
  sm.init();
  float sc[kNh][32];
  // the last tile's P as bf16 pairs hi + lo, the A fragments of its P V
  uint32_t ph[kBlockK / 16][4], pl[kBlockK / 16][4];

  int i = 0;
  for (; i < i_lo; ++i) {  // tiles no row of the warpgroup sees add nothing
    loader.arrived(i, issuer);
    loader.done(i, issuer, lane);
  }
  if (i_lo < i_hi) {
    mbar_wait(bar_q, 0);
    // the first tile: S = Q K^T, its softmax, its P
    loader.arrived(i, issuer);
    fence_s(sc);
    issue_s<L>(sc, dq, dk + (i % kStages) * (L::kKvBytes >> 4));
    wgmma_wait<0>();
    pin(sc);
    int k0 = (kt_first + i) * kBlockK;
    sm.take_max(sc, raw, whole_tile(k0), sp, k0);
    sm.to_probs(sc);
    to_p<L>(sc, acc, sm, ph, pl);
    // then each further tile's S with the last tile's P V beside it, so
    // that P V runs on the tensor cores while this tile's softmax runs
    for (++i; i < i_hi; ++i) {
      loader.arrived(i, issuer);
      pin(acc);
      pin(ph);
      pin(pl);
      fence_s(sc);
      issue_s<L>(sc, dq, dk + (i % kStages) * (L::kKvBytes >> 4));
      issue_pv<L>(acc, ph, pl, dv + ((i - 1) % kStages) * (L::kKvBytes >> 4));
      wgmma_wait<1>();  // S has landed; P V may still run
      pin(sc);
      k0 = (kt_first + i) * kBlockK;
      sm.take_max(sc, raw, whole_tile(k0), sp, k0);
      sm.to_probs(sc);
      wgmma_wait<0>();
      pin(acc);
      pin(ph);
      pin(pl);
      loader.done(i - 1, issuer, lane);
      to_p<L>(sc, acc, sm, ph, pl);
    }
    // the last tile's P V
    pin(acc);
    pin(ph);
    pin(pl);
    wgmma_fence();
    issue_pv<L>(acc, ph, pl, dv + ((i - 1) % kStages) * (L::kKvBytes >> 4));
    wgmma_wait<0>();
    pin(acc);
    pin(ph);
    pin(pl);
    loader.done(i - 1, issuer, lane);
  }
  for (; i < n_tiles; ++i) {
    loader.arrived(i, issuer);
    loader.done(i, issuer, lane);
  }
  if (!wg_live) return;

  float inv[2];
  sm.finish(inv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!sp.rows_ok[r]) continue;
    bf16* orow = o + (((size_t)b * Hq + hq) * Tq + wq0 + row + 8 * r) * D;
#pragma unroll
    for (int c = 0; c < kSlabs; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * t4;  // D % 8 == 0: col < D means col + 1 < D
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * r] * inv[r], acc[c][4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, taken through the runtime's
// entry-point query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the (D, T, n) bf16 tensor at ptr (n = batch x heads) as TMA boxes of 64
// columns x `rows` rows of one matrix, 128-byte swizzled; columns past D and
// rows past T read as zeros
bool encode_map(CUtensorMap* map, const void* ptr, int D, int T, int n, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};  // bytes
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX, int NWG>
cudaError_t launch_hopper(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                          int Hkv, int Tq, int Tk, int D, float scale, float softcap, int causal,
                          int window, cudaStream_t s) {
  using L = HopperTile<DMAX, NWG>;
  const auto kernel = flash_fwd_hopper<DMAX, NWG>;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, D, Tq, B * Hq, L::kRowsQ) ||
      !encode_map(&tk, k, D, Tk, B * Hkv, L::kBlockK) ||
      !encode_map(&tv, v, D, Tk, B * Hkv, L::kBlockK))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, (Tq + L::kRowsQ - 1) / L::kRowsQ, B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, L::kThreads, L::kSmem, s>>>(tq, tk, tv, static_cast<bf16*>(o), Hq, Hkv, Tq, Tk,
                                             D, scale, softcap, causal, window);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int Tq, int Tk, int D, float scale, float softcap, int causal,
                        int window, cudaStream_t s) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  if (D % 8 != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o)) {
    if (D <= 64) return launch_bf16_unaligned<64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
    if (D <= 128) return launch_bf16_unaligned<128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
    return launch_bf16_unaligned<256>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  }
  // no key at all: every row gives 0 (a tensor map cannot describe T = 0)
  if (Tk == 0) return cudaMemsetAsync(o, 0, (size_t)B * Hq * Tq * D * sizeof(bf16), s);
  if (D <= 64) return launch_hopper<64, 1>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  if (D <= 128) return launch_hopper<128, 2>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
  return launch_hopper<256, 2>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, softcap, causal, window, s);
}

}  // namespace

extern "C" {

// Largest head_dim the kernel takes.
int repro_flash_max_head_dim() { return 256; }

// o (B, Hq, Tq, D) = attention of q over k, v, all contiguous, of one dtype
// (repro::DType). window < 0: no window; softcap <= 0: no softcap. Returns
// the CUDA error (cudaErrorInvalidValue for shapes the kernel does not take,
// or a tensor map the driver refuses to encode).
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
// (spill) bytes per thread. Returns 0, -1 past the last kernel, or the CUDA
// error.
int repro_flash_kernel_info(int i, const char** name, int* regs, int* local_bytes) {
  static const repro::KernelRef table[] = {
      {"flash_fwd<float, 32>", reinterpret_cast<const void*>(flash_fwd<float, 32>)},
      {"flash_fwd<float, 64>", reinterpret_cast<const void*>(flash_fwd<float, 64>)},
      {"flash_fwd<float, 128>", reinterpret_cast<const void*>(flash_fwd<float, 128>)},
      {"flash_fwd<float, 256>", reinterpret_cast<const void*>(flash_fwd<float, 256>)},
      {"flash_fwd_hopper<64>", reinterpret_cast<const void*>(flash_fwd_hopper<64, 1>)},
      {"flash_fwd_hopper<128>", reinterpret_cast<const void*>(flash_fwd_hopper<128, 2>)},
      {"flash_fwd_hopper<256>", reinterpret_cast<const void*>(flash_fwd_hopper<256, 2>)},
      {"flash_fwd_bf16<64, unaligned>", reinterpret_cast<const void*>(flash_fwd_bf16<64>)},
      {"flash_fwd_bf16<128, unaligned>", reinterpret_cast<const void*>(flash_fwd_bf16<128>)},
      {"flash_fwd_bf16<256, unaligned>", reinterpret_cast<const void*>(flash_fwd_bf16<256>)}};
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
