// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a), with a plain C
// interface that repro_torch/kernels/rwkv6.py binds through ctypes.
//
// Replaces, in the JAX package, kernels/rwkv6.py: rwkv6_tpu (body
// _rwkv6_kernel). Same function as ref.rwkv6_ref defines it:
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(d_t) S_{t-1} + k_t v_t^T,   d_t = exp(-exp(w_t))
// per (b, head), with S_0 given or zero, y in v's dtype and S_T in float32.
// Two kernels: rwkv6_chunked, the prefill kernel, which runs sub-chunks of
// 16 steps on the tensor cores, and rwkv6_fwd, which runs the recurrence
// step by step on the CUDA cores and serves decode (T = 1), any T below one
// sub-chunk and the shapes the chunked kernel does not take (Dk > 64, rows
// that are not 16-byte aligned). The wrapper picks (rwkv6.chunked_form).
//
// What bounds the function. Its bytes are r, k, v (T), w (float32) read
// once and y written once, 768 bytes a step and head at Dk = Dv = 64 in
// bf16, plus the states: at RWKV6-7B's prefill (B=4, H=64, T=4096,
// Dk=Dv=64) ~0.81 GB, 0.24 ms at 3.35 TB/s. Step by step it is also
// 5*Dk*Dv float32 operations a step and head (0.33 ms at 67 TFLOP/s, on the
// CUDA cores); in sub-chunks most of that work moves to the tensor cores,
// and the function can be bound by its bytes.
//
// rwkv6_chunked. Within a sub-chunk of L = 16 steps with entry state S,
// with P_t = prod_{u<t} d_u (exclusive prefix) and Q_s = prod_{s<u<L} d_u
// (exclusive suffix),
//   y_t = (r_t * P_t)^T S + sum_{s<t} score(t, s) v_s + (r_t . (u * k_t)) v_t
//   S  <- diag(P_L) S + sum_s (k_s * Q_s) v_s^T
//   score(t, s) = sum_i r_t[i] k_s[i] prod_{s<u<t} d_u[i].
// Every decay factor is a product of per-step decays d = exp(-exp(w)) (each
// <= 1), formed once a step and channel; no log-decay cumsum and no
// quotient of cumulative products is formed, so nothing overflows at any w
// (d underflowing to 0 included), no clamp is needed (the TPU kernel clamps
// the log decay at -50), and a product of at most 16 factors is within ~16
// ulps. The pairwise factor of score(t, s) is never formed either (the TPU
// kernel's (C, C, Dk) exponent tensor and its exps): the pairs are split by
// the highest bit in which t and s differ. For level h (8, 4, 2, 1) the
// pairs with t in the upper and s in the lower half of one aligned block of
// 2h steps share the pivot p (the upper half's first step), and
//   prod_{s<u<t} d_u = prod_{p<=u<t} d_u * prod_{s<u<p} d_u,
// so a level's scores are one product (r_t * E_t) . (k_s * F_s) of 8 rows by
// 8 columns over Dk, E and F prefix and suffix products of at most h - 1
// decays within the half-blocks. Four levels give all 120 pairs; the bonus
// is the diagonal. The products run on the tensor cores, bf16 in and
// float32 sums: the readout r~ S, the update k~^T V, the four levels'
// scores and scores . V. A float32 operand enters as 2 or 3 bf16 pieces
// (x = hi + lo (+ lo2) to 2^-16 or 2^-24 of x) and a product as the terms
// of pieces a, b with a + b below the larger count (hi.hi + hi.lo + lo.hi,
// as flash_attention.cu splits P): bf16 inputs are exact in one piece; the
// state update takes k~ in 3 pieces, so S_T keeps float32 accuracy, and
// y's readout and scores 2 (y is rounded to bf16); float32 inputs take 3
// pieces everywhere.
//   A block owns one (b, head) and 64 columns of S, with 8 warps:
//   - 4 chain warps, one warpgroup, keep S^T (64 columns x Dk) in
//     accumulators for the whole launch, a warp 16 columns: the update's
//     sum lands there, and the accumulator layout is the readout's A
//     operand (bf16 pieces made in registers). In bf16 at Dk <= 64 in 4
//     tiles (RWKV6-7B's heads) the readout (m64n16k16) and the update
//     (m64n64k16) are wgmma, A from registers and B, r~ and k~, read once a
//     block from 128-byte-swizzled slots; else each warp runs them as
//     mma.sync.m16n8k16, loading r~ and k~ as B fragments itself. Scores .
//     V is mma.sync. Only the update is on the chain from one sub-chunk to
//     the next;
//   - 4 prep warps stage r, k, w, v with cp.async two sub-chunks ahead
//     (3 raw slots), form the decays and the prefix and suffix products
//     (one warp each: r~ and the bonus's partial sums, k~, the levels'
//     rows, the levels' columns; a lane a channel pair), run one level's
//     scores each (mma.sync), and hand a sub-chunk over in one of 2 slots,
//     named barriers marking each slot full and empty. So the scores and
//     the decays are formed while the chain warps run the sub-chunk before.
//   At RWKV6-7B's prefill that is 256 blocks of 256 threads, two an SM
//   (~91 KB of shared memory and at most 128 registers a thread in bf16).
//   The raw tiles are staged at a fixed row stride, zero past T, Dk and Dv,
//   so the prep reads them unguarded, and every shared-memory offset is a
//   constant of (T, NK).
//   What bounds it (H100, bf16 prefill): the prep warps' elementwise work
//   and shared-memory traffic (the products, the pieces, their stores),
//   with the chain's latency on top; not the bytes (0.24 ms at 3.35 TB/s)
//   nor the tensor cores. The sums run in a fixed order, so reruns are
//   bit-identical; a state carried across two calls gives the bits of one
//   call only where the split lies on the 16-step grid (as the TPU
//   kernel's chunks).
//
// rwkv6_fwd, the step form. A thread owns kRows=8 rows x kCols=4 columns of
// S in registers; P = Dk/8 neighbouring lanes share 4 columns; a block owns
// one (b, head) and a group of columns (all 64 at Dk=64). A step is 3
// float32 instructions per state element (readout fma, k*v, decay fma) and
// 6 float4 shared loads per thread for r, k and the decay of its 8 rows;
// each step's readout leaves one partial sum per 8-row slice in shared
// memory, added after the chunk in slice order with v_t[j] * bonus_t. r, k,
// the decay and v are staged as float32, 16 steps at a time, the raw inputs
// copied by cp.async two chunks ahead where the rows are 16-byte aligned
// (other shapes load them directly). No step depends on where a chunk
// starts, so a state carried across calls gives the same bits as one call.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_float;
using repro::to_float;

constexpr int kChunk = 16;            // steps staged at a time
constexpr int kRows = 8;              // state rows per thread
constexpr int kCols = 4;              // state columns per thread
constexpr int kUnroll = 2;            // steps of the time loop unrolled together
// floats per staged row slice: 8 rows and 4 of padding, so that the slices
// a quarter-warp reads as float4s fall in distinct banks
constexpr int kSlice = kRows + 4;
constexpr int kThreads = 128; // most threads a block has
constexpr int kMaxDk = 32 * kRows;

// Lanes per column: the least power of two P with P * kRows >= Dk.
int lanes_per_column(int Dk) {
  int p = 1;
  while (p * kRows < Dk) p *= 2;
  return p;
}

// Columns per block: a multiple of 128 / P (whole warps of kCols columns
// per thread) and of 8 (16-byte rows of v in bf16), at most 512 / P, no
// more than Dv needs.
int columns_per_block(int Dk, int Dv) {
  const int p = lanes_per_column(Dk);
  const int step = std::max(8, kCols * 32 / p);
  const int need = (Dv + step - 1) / step * step;
  return std::min(kCols * kThreads / p, need);
}

struct Layout {
  int p, cols, stride;   // lanes per column, columns per block, floats per staged step
  size_t staged, raw;    // bytes of the float32 staging and of one raw buffer
};

Layout layout(int Dk, int Dv, int esize) {
  Layout l;
  l.p = lanes_per_column(Dk);
  l.cols = columns_per_block(Dk, Dv);
  l.stride = l.p * kSlice;
  // rs, ks, ds; vs; bonus; u; the readout's partial sums
  l.staged = sizeof(float) * (3 * (size_t)kChunk * l.stride + (size_t)kChunk * l.cols +
                              kChunk + (size_t)l.p * kRows +
                              (size_t)kChunk * l.p * (l.cols + 4));
  l.staged = (l.staged + 15) / 16 * 16;
  // r, k (T), w (float), v (T)
  l.raw = (size_t)kChunk * (2 * (size_t)Dk * esize + 4 * (size_t)Dk + (size_t)l.cols * esize);
  return l;
}

// Issue the cp.async copies of chunk `ci`'s raw r, k, w and v (this block's
// columns) into `raw`. Rows are 16-byte aligned (checked by the host).
template <typename T>
__device__ void stage_raw(unsigned char* raw, const T* r, const T* k, const float* w,
                          const T* v, long long kbase, long long vbase, int t0, int n,
                          int Dk, int Dv, int j0, int nc, int cols) {
  if (n <= 0) return;
  const int tid = threadIdx.x;
  const int kbytes = n * Dk * (int)sizeof(T);
  T* rr = reinterpret_cast<T*>(raw);
  T* kr = rr + kChunk * Dk;
  float* wr = reinterpret_cast<float*>(kr + kChunk * Dk);
  T* vr = reinterpret_cast<T*>(wr + kChunk * Dk);
  const char* rsrc = reinterpret_cast<const char*>(r + kbase + (long long)t0 * Dk);
  const char* ksrc = reinterpret_cast<const char*>(k + kbase + (long long)t0 * Dk);
  const char* wsrc = reinterpret_cast<const char*>(w + kbase + (long long)t0 * Dk);
  for (int p = tid; p < kbytes / 16; p += blockDim.x) {
    cp_async16(reinterpret_cast<char*>(rr) + p * 16, rsrc + p * 16);
    cp_async16(reinterpret_cast<char*>(kr) + p * 16, ksrc + p * 16);
  }
  for (int p = tid; p < n * Dk * 4 / 16; p += blockDim.x)
    cp_async16(reinterpret_cast<char*>(wr) + p * 16, wsrc + p * 16);
  const int vbytes = nc * (int)sizeof(T);          // valid bytes of a row of v
  const int vp = (cols * (int)sizeof(T)) / 16;      // 16-byte pieces of a staged row
  for (int p = tid; p < n * vp; p += blockDim.x) {
    const int tt = p / vp, pp = p % vp;
    const char* row = reinterpret_cast<const char*>(v + vbase + (long long)(t0 + tt) * Dv + j0);
    const int left = vbytes - pp * 16;
    char* dst = reinterpret_cast<char*>(vr + tt * cols) + pp * 16;
    // past the valid columns: zero-filled, read from the row's start
    cp_async16(dst, left > 0 ? row + pp * 16 : row, left >= 16 ? 16 : (left > 0 ? left : 0));
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
    rwkv6_fwd(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ w, const float* __restrict__ u,
              const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
              int H, int Tn, int Dk, int Dv, int cols, int vec, int svec, int staged_bytes,
              int raw_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int stride = P * kSlice;
  constexpr int kQ = kRows / 4;                  // float4s of a row slice
  const int ps = cols + 4;                       // padded row of the partial sums
  const int quads = cols / kCols;
  float* rs = reinterpret_cast<float*>(smem);   // (kChunk, P, kSlice)
  float* ks = rs + kChunk * stride;
  float* ds = ks + kChunk * stride;              // decay
  float* vs = ds + kChunk * stride;              // (kChunk, cols)
  float* bon = vs + kChunk * cols;               // (kChunk,) r_t . (u * k_t)
  float* us = bon + kChunk;                      // (P * kRows,)
  float* pbuf = us + P * kRows;                  // (kChunk, P, ps)
  unsigned char* raw0 = smem + staged_bytes;
  unsigned char* raw1 = raw0 + raw_bytes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int bh = blockIdx.x, h = bh % H;
  const int j0 = blockIdx.y * cols;
  const int nc = min(cols, Dv - j0);             // valid columns of this group
  const int c0 = (tid / P) * kCols, q = tid % P; // my first column, my row slice
  const long long kbase = (long long)bh * Tn * Dk;
  const long long vbase = (long long)bh * Tn * Dv;
  const long long sbase = (long long)bh * Dk * Dv;
  const int nchunks = (Tn + kChunk - 1) / kChunk;

  if (vec) {   // the first two chunks in flight before anything else
    stage_raw<T>(raw0, r, k, w, v, kbase, vbase, 0, min(kChunk, Tn), Dk, Dv, j0, nc, cols);
    cp_async_commit();
    stage_raw<T>(raw1, r, k, w, v, kbase, vbase, kChunk, min(kChunk, Tn - kChunk), Dk, Dv,
                 j0, nc, cols);
    cp_async_commit();
  }
  // rows past Dk stay zero in the staging: they add nothing to any sum
  if (Dk < P * kRows)
    for (int i = tid; i < 3 * kChunk * stride; i += blockDim.x) rs[i] = 0.f;
  for (int i = tid; i < P * kRows; i += blockDim.x) us[i] = i < Dk ? u[(long long)h * Dk + i] : 0.f;

  // my 8 x 4 block of the state, a row of 4 columns as one 16-byte access
  // where the rows allow it (svec)
  float S[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = q * kRows + m;
    const float* row = s0 + sbase + (long long)i * Dv + j0 + c0;
    if (s0 != nullptr && i < Dk && svec && c0 + kCols <= nc) {
      const float4 x = *reinterpret_cast<const float4*>(row);
      S[m][0] = x.x;
      S[m][1] = x.y;
      S[m][2] = x.z;
      S[m][3] = x.w;
    } else {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        S[m][cc] = (s0 != nullptr && i < Dk && c0 + cc < nc) ? row[cc] : 0.f;
    }
  }

  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * kChunk;
    const int n = min(kChunk, Tn - t0);
    const unsigned char* raw = (ci & 1) ? raw1 : raw0;
    if (vec) cp_async_wait<1>();   // chunk ci has landed; ci + 1 may be in flight
    __syncthreads();               // raw ci visible; the last chunk's y written out
    const T* rsrc = vec ? reinterpret_cast<const T*>(raw) : r + kbase + (long long)t0 * Dk;
    const T* ksrc = vec ? rsrc + kChunk * Dk : k + kbase + (long long)t0 * Dk;
    const float* wsrc = vec ? reinterpret_cast<const float*>(ksrc + kChunk * Dk)
                            : w + kbase + (long long)t0 * Dk;
    const T* vsrc = vec ? reinterpret_cast<const T*>(wsrc + kChunk * Dk)
                        : v + vbase + (long long)t0 * Dv + j0;
    const int vrow = vec ? cols : Dv;
    // r, k and the decay as float32, and the bonus: a warp takes 4
    // consecutive steps at a time, their four reductions interleaved
    for (int tb = 4 * warp; tb < n; tb += 4 * nwarps) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = lane; i < Dk; i += 32) {
        const int o = (i / kRows) * kSlice + i % kRows;
        const float ui = us[i];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = tb + e;
          if (tt < n) {
            const float rv = to_float(rsrc[tt * Dk + i]);
            const float kv = to_float(ksrc[tt * Dk + i]);
            rs[tt * stride + o] = rv;
            ks[tt * stride + o] = kv;
            // the inner exp to a few ulps: it sets 1 - d only relatively
            ds[tt * stride + o] = expf(-__expf(wsrc[tt * Dk + i]));
            part[e] = fmaf(rv * ui, kv, part[e]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[e] += __shfl_xor_sync(0xffffffffu, part[e], off);
      if (lane == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tb + e < n) bon[tb + e] = part[e];
      }
    }
    for (int idx = tid; idx < n * quads; idx += blockDim.x) {
      const int tt = idx / quads, cq = (idx - tt * quads) * kCols;
      const T* src = vsrc + tt * vrow + cq;
      *reinterpret_cast<float4*>(vs + tt * cols + cq) =
          make_float4(cq < nc ? to_float(src[0]) : 0.f, cq + 1 < nc ? to_float(src[1]) : 0.f,
                      cq + 2 < nc ? to_float(src[2]) : 0.f, cq + 3 < nc ? to_float(src[3]) : 0.f);
    }
    __syncthreads();               // the chunk is staged; raw ci is free
    if (vec) {
      stage_raw<T>((ci & 1) ? raw1 : raw0, r, k, w, v, kbase, vbase, t0 + 2 * kChunk,
                   min(kChunk, Tn - t0 - 2 * kChunk), Dk, Dv, j0, nc, cols);
      cp_async_commit();
    }
    // the steps: each step's operands are loaded while the one before computes
    float4 cr[kQ], ck[kQ], cd[kQ], cv;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      cr[j] = *reinterpret_cast<const float4*>(rs + q * kSlice + 4 * j);
      ck[j] = *reinterpret_cast<const float4*>(ks + q * kSlice + 4 * j);
      cd[j] = *reinterpret_cast<const float4*>(ds + q * kSlice + 4 * j);
    }
    cv = *reinterpret_cast<const float4*>(vs + c0);
#pragma unroll kUnroll
    for (int tt = 0; tt < n; ++tt) {
      const int nt = tt + 1 < n ? tt + 1 : tt;
      float4 nr[kQ], nk[kQ], nd[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        nr[j] = *reinterpret_cast<const float4*>(rs + nt * stride + q * kSlice + 4 * j);
        nk[j] = *reinterpret_cast<const float4*>(ks + nt * stride + q * kSlice + 4 * j);
        nd[j] = *reinterpret_cast<const float4*>(ds + nt * stride + q * kSlice + 4 * j);
      }
      const float4 nv = *reinterpret_cast<const float4*>(vs + nt * cols + c0);
      const float vv[kCols] = {cv.x, cv.y, cv.z, cv.w};
      float acc[kCols][2] = {};
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const float rr[4] = {cr[j].x, cr[j].y, cr[j].z, cr[j].w};
        const float kr[4] = {ck[j].x, ck[j].y, ck[j].z, ck[j].w};
        const float dr[4] = {cd[j].x, cd[j].y, cd[j].z, cd[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            float& st = S[4 * j + e][cc];
            acc[cc][e & 1] = fmaf(rr[e], st, acc[cc][e & 1]);
            st = fmaf(dr[e], st, kr[e] * vv[cc]);
          }
        }
      }
      // this row slice's share of the readout; the slices are summed below
      const float p0 = acc[0][0] + acc[0][1], p1 = acc[1][0] + acc[1][1];
      const float p2 = acc[2][0] + acc[2][1], p3 = acc[3][0] + acc[3][1];
      *reinterpret_cast<float4*>(pbuf + (tt * P + q) * ps + c0) = make_float4(p0, p1, p2, p3);
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        cr[j] = nr[j];
        ck[j] = nk[j];
        cd[j] = nd[j];
      }
      cv = nv;
    }
    __syncthreads();               // the chunk's partial readouts are in
    // y: the P slices' partial sums in slice order, plus v times the bonus,
    // 4 columns a cell
    for (int idx = tid; idx < n * quads; idx += blockDim.x) {
      const int tt = idx / quads, cq = (idx - tt * quads) * kCols;
      if (cq >= nc) continue;
      float4 sum = *reinterpret_cast<const float4*>(pbuf + tt * P * ps + cq);
      for (int sl = 1; sl < P; ++sl) {
        const float4 p = *reinterpret_cast<const float4*>(pbuf + (tt * P + sl) * ps + cq);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      const float4 v4 = *reinterpret_cast<const float4*>(vs + tt * cols + cq);
      const float b = bon[tt];
      T* yp = y + vbase + (long long)(t0 + tt) * Dv + j0 + cq;
      yp[0] = from_float<T>(fmaf(v4.x, b, sum.x));
      if (cq + 1 < nc) yp[1] = from_float<T>(fmaf(v4.y, b, sum.y));
      if (cq + 2 < nc) yp[2] = from_float<T>(fmaf(v4.z, b, sum.z));
      if (cq + 3 < nc) yp[3] = from_float<T>(fmaf(v4.w, b, sum.w));
    }
  }
  if (vec) cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = q * kRows + m;
    float* row = s_out + sbase + (long long)i * Dv + j0 + c0;
    if (i < Dk && svec && c0 + kCols <= nc) {
      *reinterpret_cast<float4*>(row) = make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
    } else {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        if (i < Dk && c0 + cc < nc) row[cc] = S[m][cc];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int P>
cudaError_t launch_p(const void* r, const void* k, const void* v, const float* w,
                     const float* u, const float* s0, void* y, float* s_out, int B, int H,
                     int Tn, int Dk, int Dv, const Layout& l, bool vec, cudaStream_t s) {
  const size_t smem = l.staged + (vec ? 2 * l.raw : 0);
  // the whole opt-in, not this launch's size: threads launch other (Dk, Dv)
  // and `vec` at the same time (common.cuh)
  cudaError_t e = cudaFuncSetAttribute(rwkv6_fwd<T, P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       repro::device_smem_optin());
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Dv + l.cols - 1) / l.cols);
  rwkv6_fwd<T, P><<<grid, l.cols * P / kCols, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      s0, static_cast<T*>(y), s_out, H, Tn, Dk, Dv, l.cols, vec ? 1 : 0,
      Dv % 4 == 0 && aligned16(s0) && aligned16(s_out) ? 1 : 0, (int)l.staged, (int)l.raw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const float* u, const float* s0, void* y, float* s_out,
                   int B, int H, int Tn, int Dk, int Dv, cudaStream_t s) {
  const int es = (int)sizeof(T);
  const Layout l = layout(Dk, Dv, es);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  // cp.async staging: every row of r, k, w, v and every column group 16-byte aligned
  const bool vec = (Dk * es) % 16 == 0 && (Dv * es) % 16 == 0 && (l.cols * es) % 16 == 0 &&
                   aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
                   l.staged + 2 * l.raw <= (size_t)optin;
  if (l.staged > (size_t)optin) return cudaErrorInvalidValue;
#define REPRO_RWKV6_P(PP) \
  case PP:                \
    return launch_p<T, PP>(r, k, v, w, u, s0, y, s_out, B, H, Tn, Dk, Dv, l, vec, s);
  switch (l.p) {
    REPRO_RWKV6_P(1)
    REPRO_RWKV6_P(2)
    REPRO_RWKV6_P(4)
    REPRO_RWKV6_P(8)
    REPRO_RWKV6_P(16)
    REPRO_RWKV6_P(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_RWKV6_P
}

// ---------------------------------------------------------------------------
// rwkv6_chunked: sub-chunks of 16 steps on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kSub = 16;                  // steps a sub-chunk
constexpr int kGroup = 64;                // state columns a block
constexpr int kChainWarps = 4;            // 16 columns each
constexpr int kPrepWarps = 4;
constexpr int kChunkThreads = 32 * (kChainWarps + kPrepWarps);
constexpr int kPrepThreads = 32 * kPrepWarps;
constexpr int kChunkMaxDk = 64;
constexpr int kRawSlots = 3;              // raw tiles: the one in use and two in flight
constexpr int kSlots = 2;                 // sub-chunks handed from the prep to the chain warps
constexpr int kRowPad = 8;                // bf16 padding a staged row: ldmatrix rows in distinct banks
constexpr int kScRow = kSub + kRowPad;    // a row of the scores' bf16 pieces
constexpr int kVRow = kGroup + kRowPad;   // a row of v's pieces
constexpr int kScF = kSub + 1;            // a row of the float32 scores
constexpr int kBonRow = 33;               // a row of the bonus's per-lane partial sums
// named barriers (0 is __syncthreads): the prep warps among themselves, and
// a slot full (prep arrives, chain waits) and empty (chain arrives, prep waits)
constexpr int kBarPrep = 1, kBarFull = 2, kBarEmpty = 2 + kSlots;

// bf16 pieces of each operand: r~ (readout B), S (readout A), k~ (update B),
// v (A of the update and of scores . V), scores, the levels 8, 4, 2 and level 1
template <typename T>
struct Pieces;
template <>
struct Pieces<__nv_bfloat16> {
  static constexpr int r = 2, s = 2, k = 3, v = 1, sc = 2, lv = 2, l1 = 1;
};
template <>
struct Pieces<float> {
  static constexpr int r = 3, s = 3, k = 3, v = 3, sc = 3, lv = 3, l1 = 3;
};

__host__ __device__ constexpr size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of the block's shared memory, fixed by (T, NK): the raw
// tiles are sized for Dk = 16 NK, so every offset is a constant.
// Whether the chain warps run the readout and the update as warpgroup
// wgmma (bf16 at Dk <= 64 in 4 tiles: RWKV6-7B's heads), B read once a
// block from 128-byte-swizzled slots; else as per-warp mma.sync.
template <typename T, int NK>
constexpr bool kWgmma = sizeof(T) == 2 && NK == 4;

// Byte offsets of the block's shared memory, fixed by (T, NK): the raw
// tiles are sized for Dk = 16 NK, so every offset is a constant. Under
// kWgmma a piece of r~ or k~ is 16 rows of 128 bytes, 128-byte swizzled
// (the layout wgmma's descriptors read), and the slots are 1024-aligned.
template <typename T, int NK>
struct ChunkLayout {
  using PC = Pieces<T>;
  static constexpr bool wg = kWgmma<T, NK>;
  static constexpr size_t es = sizeof(T), dk = 16 * NK, row = dk + kRowPad;
  // a raw slot: r, k (kSub, 16 NK) in T, w (kSub, 16 NK) float32, v (kSub, kGroup) in T,
  // zero past T, Dk and Dv
  static constexpr size_t raw_k = up16(kSub * dk * es), raw_w = raw_k + up16(kSub * dk * es),
                          raw_v = raw_w + up16(kSub * dk * 4),
                          raw_slot = raw_v + up16(kSub * kGroup * es);
  // bf16 elements between two pieces of r~ or k~
  static constexpr int rk_piece = wg ? kSub * 64 : kSub * (int)row;
  // a slot: r~, k~, v, the scores (bf16 pieces), prod(d) over the sub-chunk
  static constexpr size_t kt = up16(PC::r * (size_t)rk_piece * 2),
                          vv = kt + up16(PC::k * (size_t)rk_piece * 2),
                          scp = vv + up16(PC::v * kSub * kVRow * 2),
                          al = scp + up16(PC::sc * kSub * kScRow * 2),
                          slot_bytes = (al + up16(dk * 4) + 1023) / 1024 * 1024;
  static constexpr int lv_piece = (int)(8 * row);   // bf16 of one (8, Dk) level operand piece
  static constexpr size_t d = kRawSlots * raw_slot, lv = d + up16(kSub * dk * 4),
                          sc = lv + up16(4 * 2 * PC::lv * (size_t)lv_piece * 2),
                          bpart = sc + up16(kSub * kScF * 4),
                          us = bpart + up16(kSub * kBonRow * 4),
                          slot = (us + up16(dk * 4) + 1023) / 1024 * 1024,
                          ys = slot + kSlots * slot_bytes,
                          total = ys + kChainWarps * kSub * 16 * es + 1024;   // + base alignment
};

// the bf16 offset of (row t, channel i) of a piece of r~ or k~ (i even)
template <bool WG, int ROW>
__device__ __forceinline__ int rk_at(int t, int i) {
  return WG ? t * 64 + ((((i >> 3) ^ (t & 7))) << 3) + (i & 7) : t * ROW + i;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&x)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&x)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&x)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(x[0]), "=r"(x[1])
               : "r"(smem_addr(p)));
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

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`
// (as flash_attention.cu's): lbo the byte stride between 64-column slabs
// (MN-major; unused here, one slab), sbo between 8-row groups
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving uses of registers an asynchronous wgmma
// reads or writes across its fence and wait
template <int M, int N>
__device__ __forceinline__ void pin(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}
template <int L, int M, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[L][M][N]) {
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int k = 0; k < N; ++k) asm volatile("" : "+r"(r[i][j][k])::"memory");
}

// d (64 x 16, float32, the warpgroup's fragment) += A (64 x 16, bf16 from
// registers) B (16 x 16, bf16 in shared memory, K-major)
__device__ __forceinline__ void wgmma_n16(float (&d)[2][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, bf16 from registers) B (16 x 64,
// bf16 in shared memory, MN-major)
#define REPRO_F4(n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_F4(0), REPRO_F4(1), REPRO_F4(2), REPRO_F4(3), REPRO_F4(4), REPRO_F4(5),
        REPRO_F4(6), REPRO_F4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef REPRO_F4

// (x0, x1) as N bf16x2 pieces, piece p at base + p * stride: the pieces sum
// to x within 2^-(8N) of x (each is x less the pieces before it, rounded)
template <int N>
__device__ __forceinline__ void put_pieces(__nv_bfloat16* base, int stride, float x0, float x1) {
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    *reinterpret_cast<__nv_bfloat162*>(base + p * stride) = h;
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

template <int N>
__device__ __forceinline__ void split_pair(uint32_t (&out)[N][4], int slot, float x0, float x1) {
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[p][slot] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// c += A . B over pieces: the terms a + b < max(NA, NB), in a fixed order
template <int NA, int NB>
__device__ __forceinline__ void mma_terms(float (&c)[4], const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][4], int half) {
  constexpr int kMax = NA > NB ? NA : NB;
#pragma unroll
  for (int x = 0; x < NA; ++x)
#pragma unroll
    for (int z = 0; z < NB; ++z)
      if (x + z < kMax) mma_bf16(c, a[x], b[z][2 * half], b[z][2 * half + 1]);
}

// Copy sub-chunk (t0, n steps) of r, k, w and this block's columns of v
// into a raw slot with cp.async, a row of r, k and w at stride 16 NK and of
// v at stride kGroup, zero-filled past n, Dk and nc (every row 16-byte
// aligned: checked by the host), so that the prep reads it unguarded.
template <int N, typename F>
__device__ __forceinline__ void for_pieces(int ptid, F f) {
#pragma unroll
  for (int j = 0; j < (N + kPrepThreads - 1) / kPrepThreads; ++j) {
    const int p = ptid + j * kPrepThreads;
    if (N % kPrepThreads == 0 || p < N) f(p);
  }
}

template <typename T, typename L>
__device__ __forceinline__ void stage_sub(unsigned char* raw, const T* r, const T* k,
                                          const float* w, const T* v, long long kbase,
                                          long long vbase, int t0, int n, int Dk, int Dv,
                                          int j0, int nc, int ptid) {
  constexpr int es = (int)sizeof(T), kRowT = (int)L::dk * es / 16, kRowW = (int)L::dk / 4;
  constexpr int kRowV = kGroup * es / 16;
  const int live_t = Dk * es / 16, live_w = Dk / 4, live_v = nc * es / 16;
  const char* rs = reinterpret_cast<const char*>(r + kbase);
  const char* ks = reinterpret_cast<const char*>(k + kbase);
  const char* ws = reinterpret_cast<const char*>(w + kbase);
  const char* vs = reinterpret_cast<const char*>(v + vbase + j0);
  for_pieces<kSub * kRowT>(ptid, [&](int p) {
    const int t = p / kRowT, c = p % kRowT;
    const bool ok = t < n && c < live_t;
    const long long off = ok ? ((long long)(t0 + t) * Dk * es + 16 * c) : (long long)t0 * Dk * es;
    cp_async16(raw + p * 16, rs + off, ok ? 16 : 0);
    cp_async16(raw + L::raw_k + p * 16, ks + off, ok ? 16 : 0);
  });
  for_pieces<kSub * kRowW>(ptid, [&](int p) {
    const int t = p / kRowW, c = p % kRowW;
    const bool ok = t < n && c < live_w;
    const long long off = ok ? ((long long)(t0 + t) * Dk * 4 + 16 * c) : (long long)t0 * Dk * 4;
    cp_async16(raw + L::raw_w + p * 16, ws + off, ok ? 16 : 0);
  });
  for_pieces<kSub * kRowV>(ptid, [&](int p) {
    const int t = p / kRowV, c = p % kRowV;
    const bool ok = t < n && c < live_v;
    const long long off = ok ? ((long long)(t0 + t) * Dv * es + 16 * c) : (long long)t0 * Dv * es;
    cp_async16(raw + L::raw_v + p * 16, vs + off, ok ? 16 : 0);
  });
}

// One level's scores: 8 rows (r_t * E_t) by 8 columns (k_s * F_s), over Dk,
// rows 8-15 of the A operand repeating rows 0-7.
template <int NA, int NB, int NK>
__device__ __forceinline__ void level_scores(float (&acc)[4], const __nv_bfloat16* A,
                                             const __nv_bfloat16* B, int piece, int lane) {
  constexpr int ROW = 16 * NK + kRowPad;
  const int q = lane >> 3, rr = lane & 7;
  uint32_t a[NK][NA][4], b[NK][NB][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int p = 0; p < NA; ++p)
      ldsm_x4(a[kk][p], A + p * piece + rr * ROW + kk * 16 + (q >> 1) * 8);
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      uint32_t x[2];
      ldsm_x2(x, B + p * piece + rr * ROW + kk * 16 + (q & 1) * 8);
      b[kk][p][0] = x[0];
      b[kk][p][1] = x[1];
    }
  }
  // the even and the odd 16-channel tiles in two sums, added at the end
  float odd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) mma_terms<NA, NB>((kk & 1) ? odd : acc, a[kk], b[kk], 0);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += odd[e];
}

// The prep warps: stage, form the decays, the products and the scores, and
// hand each sub-chunk over in a slot.
template <typename T, int NK>
__device__ __forceinline__ void chunk_prep(unsigned char* smem, const T* r, const T* k,
                                           const T* v, const float* w, const float* u, int h,
                                           int Tn, int Dk, int Dv, int j0, int nc,
                                           long long kbase, long long vbase, int pw, int lane) {
  using PC = Pieces<T>;
  using L = ChunkLayout<T, NK>;
  constexpr int DK = 16 * NK, ROW = DK + kRowPad;
  const int ptid = pw * 32 + lane;
  const int nsub = (Tn + kSub - 1) / kSub;
  float* dbuf = reinterpret_cast<float*>(smem + L::d);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* bpart = reinterpret_cast<float*>(smem + L::bpart);
  float* us = reinterpret_cast<float*>(smem + L::us);
  __nv_bfloat16* lv = reinterpret_cast<__nv_bfloat16*>(smem + L::lv);
  // level lvl's rows (side 0) or columns (side 1), piece 0
  auto level = [&](int lvl, int side) { return lv + (lvl * 2 + side) * PC::lv * L::lv_piece; };
  for (int i = ptid; i < DK; i += kPrepThreads) us[i] = i < Dk ? u[(long long)h * Dk + i] : 0.f;
  for (int i = ptid; i < kSub * kScF; i += kPrepThreads) sc[i] = 0.f;   // s > t stays 0
  for (int c = 0; c < 2; ++c) {
    if (c < nsub)
      stage_sub<T, L>(smem + c * L::raw_slot, r, k, w, v, kbase, vbase, c * kSub,
                      min(kSub, Tn - c * kSub), Dk, Dv, j0, nc, ptid);
    cp_async_commit();
  }
  const int g = lane >> 2, c4 = lane & 3;
  const int i0 = 2 * lane;               // this lane's channel pair in (c)
  const int lg = 3 - pw;                 // log2 of this warp's level in (d)
  for (int c = 0; c < nsub; ++c) {
    const int slot = c % kSlots, t0 = c * kSub, n = min(kSub, Tn - t0);
    cp_async_wait<1>();
    bar_sync(kBarPrep, kPrepThreads);    // sub-chunk c staged; c - 1's reads done
    if (c + 2 < nsub)
      stage_sub<T, L>(smem + ((c + 2) % kRawSlots) * L::raw_slot, r, k, w, v, kbase, vbase,
                      t0 + 2 * kSub, min(kSub, Tn - t0 - 2 * kSub), Dk, Dv, j0, nc, ptid);
    cp_async_commit();
    const unsigned char* raw = smem + (c % kRawSlots) * L::raw_slot;
    const T* rr_ = reinterpret_cast<const T*>(raw);
    const T* kr = reinterpret_cast<const T*>(raw + L::raw_k);
    const float* wr = reinterpret_cast<const float*>(raw + L::raw_w);
    const T* vr = reinterpret_cast<const T*>(raw + L::raw_v);
    unsigned char* sl = smem + L::slot + slot * L::slot_bytes;
    if (c >= kSlots) bar_sync(kBarEmpty + slot, kChunkThreads);   // the chain is done with it
    // (b) the decays, and v into the slot. Each phase below reads its
    // operands into registers before it stores anything: the compiler
    // cannot move a shared-memory load above a store to the same array.
    {
      constexpr int kD = kSub * DK / kPrepThreads;
      __nv_bfloat16* vv = reinterpret_cast<__nv_bfloat16*>(sl + L::vv);
      float wv[kD];
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        const int e = ptid + j * kPrepThreads, t = e / DK, i = e % DK;
        wv[j] = (t < n && i < Dk) ? wr[e] : __int_as_float(0xff800000);   // -inf: decay 1
      }
      if constexpr (sizeof(T) == 2) {
        // bf16 v is its own piece: a 16-byte row piece a thread
        static_assert(kSub * kGroup / 8 == kPrepThreads, "one 16-byte piece of v a thread");
        const int t = ptid >> 3, col = (ptid & 7) * 8;
        *reinterpret_cast<uint4*>(vv + t * kVRow + col) =
            *reinterpret_cast<const uint4*>(vr + t * kGroup + col);
      } else {
        constexpr int kV = kSub * kGroup / 2 / kPrepThreads;
        float2 vx[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) vx[j] = load2(vr + 2 * (ptid + j * kPrepThreads));
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const int e = 2 * (ptid + j * kPrepThreads), t = e / kGroup, jj = e % kGroup;
          put_pieces<PC::v>(vv + t * kVRow + jj, kSub * kVRow, vx[j].x, vx[j].y);
        }
      }
#pragma unroll
      for (int j = 0; j < kD; ++j)
        // the inner exp to a few ulps: it sets 1 - d only relatively (as rwkv6_fwd)
        dbuf[ptid + j * kPrepThreads] = expf(-__expf(wv[j]));
    }
    bar_sync(kBarPrep, kPrepThreads);
    // (c) the running products, a lane a channel pair (zero past Dk in the
    // staging, decay 1 past n and Dk): warp 0 r~ (and the bonus's partial
    // sums), warp 1 k~, warps 2 and 3 the rows and columns of levels 8, 4, 2
    if (i0 < DK) {
      float2 dd[kSub], xs[kSub];
      const T* src = (pw == 0 || pw == 2) ? rr_ : kr;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        dd[t] = load2(dbuf + t * DK + i0);
        xs[t] = load2(src + t * DK + i0);
      }
      if (pw == 0) {
        __nv_bfloat16* rt = reinterpret_cast<__nv_bfloat16*>(sl);
        float* al = reinterpret_cast<float*>(sl + L::al);
        float2 ks[kSub];
#pragma unroll
        for (int t = 0; t < kSub; ++t) ks[t] = load2(kr + t * DK + i0);
        const float2 uu = load2(us + i0);
        float a0 = 1.f, a1 = 1.f;
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
          put_pieces<PC::r>(rt + rk_at<L::wg, ROW>(t, i0), L::rk_piece, xs[t].x * a0,
                            xs[t].y * a1);
          if (t & 1)
            put_pieces<PC::l1>(level(3, 0) + (t >> 1) * ROW + i0, L::lv_piece, xs[t].x, xs[t].y);
          bpart[t * kBonRow + lane] = fmaf(xs[t].y * uu.y, ks[t].y, xs[t].x * uu.x * ks[t].x);
          a0 *= dd[t].x;
          a1 *= dd[t].y;
        }
        al[i0] = a0;
        al[i0 + 1] = a1;
      } else if (pw == 1) {        // k~ and level 1's columns
        __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(sl + L::kt);
        float q0 = 1.f, q1 = 1.f;
#pragma unroll
        for (int s = kSub - 1; s >= 0; --s) {
          put_pieces<PC::k>(kt + rk_at<L::wg, ROW>(s, i0), L::rk_piece, xs[s].x * q0,
                            xs[s].y * q1);
          if (!(s & 1))
            put_pieces<PC::l1>(level(3, 1) + (s >> 1) * ROW + i0, L::lv_piece, xs[s].x, xs[s].y);
          q0 *= dd[s].x;
          q1 *= dd[s].y;
        }
      } else if (pw == 2) {        // levels 8, 4, 2: rows r_t * prod_{p<=u<t} d_u
        float e[3][2] = {{1.f, 1.f}, {1.f, 1.f}, {1.f, 1.f}};
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
#pragma unroll
          for (int lvl = 0; lvl < 3; ++lvl) {
            const int hh = 8 >> lvl;
            if (t & hh)
              put_pieces<PC::lv>(level(lvl, 0) + ((t / (2 * hh)) * hh + t % hh) * ROW + i0,
                                 L::lv_piece, xs[t].x * e[lvl][0], xs[t].y * e[lvl][1]);
            if ((t + 1) % hh == 0) {
              e[lvl][0] = e[lvl][1] = 1.f;
            } else {
              e[lvl][0] *= dd[t].x;
              e[lvl][1] *= dd[t].y;
            }
          }
        }
      } else {                     // levels 8, 4, 2: columns k_s * prod_{s<u<p} d_u
        float f[3][2] = {{1.f, 1.f}, {1.f, 1.f}, {1.f, 1.f}};
#pragma unroll
        for (int s = kSub - 1; s >= 0; --s) {
#pragma unroll
          for (int lvl = 0; lvl < 3; ++lvl) {
            const int hh = 8 >> lvl;
            if (!(s & hh))
              put_pieces<PC::lv>(level(lvl, 1) + ((s / (2 * hh)) * hh + s % hh) * ROW + i0,
                                 L::lv_piece, xs[s].x * f[lvl][0], xs[s].y * f[lvl][1]);
            if (s % hh == 0) {
              f[lvl][0] = f[lvl][1] = 1.f;
            } else {
              f[lvl][0] *= dd[s].x;
              f[lvl][1] *= dd[s].y;
            }
          }
        }
      }
    } else if (pw == 0) {
#pragma unroll
      for (int t = 0; t < kSub; ++t) bpart[t * kBonRow + lane] = 0.f;
    }
    bar_sync(kBarPrep, kPrepThreads);
    // (d) level pw's scores (h = 8 >> pw) and, from warp 0, the diagonal
    {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (pw < 3)
        level_scores<PC::lv, PC::lv, NK>(acc, level(pw, 0), level(pw, 1), L::lv_piece, lane);
      else
        level_scores<PC::l1, PC::l1, NK>(acc, level(3, 0), level(3, 1), L::lv_piece, lane);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = g, mp = 2 * c4 + e;   // row m of the level's upper halves, column mp
        if ((m >> lg) == (mp >> lg)) {
          const int t = ((m >> lg) << (lg + 1)) + (1 << lg) + (m & ((1 << lg) - 1));
          const int s = ((mp >> lg) << (lg + 1)) + (mp & ((1 << lg) - 1));
          sc[t * kScF + s] = acc[e];
        }
      }
      if (pw == 0) {
        // the bonus of step t = lane >> 1: the lanes' partial sums, half a row each
        const float* row = bpart + (lane >> 1) * kBonRow + (lane & 1) * 16;
        float b = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) b += row[j];
        b += __shfl_xor_sync(0xffffffffu, b, 1);
        if (!(lane & 1)) sc[(lane >> 1) * (kScF + 1)] = b;
      }
    }
    bar_sync(kBarPrep, kPrepThreads);
    // (e) the scores' pieces into the slot, and hand it over
    {
      __nv_bfloat16* scp = reinterpret_cast<__nv_bfloat16*>(sl + L::scp);
      const int t = ptid >> 3, s = 2 * (ptid & 7);
      put_pieces<PC::sc>(scp + t * kScRow + s, kSub * kScRow, sc[t * kScF + s],
                         sc[t * kScF + s + 1]);
    }
    bar_arrive(kBarFull + slot, kChunkThreads);
  }
  cp_async_wait<0>();
}

// The chain warps: 16 columns of S^T each, in mma accumulators; the readout,
// scores . V and the update of each sub-chunk, and y out.
template <typename T, int NK>
__device__ __forceinline__ void chunk_chain(unsigned char* smem, const float* s0, T* y, float* s_out, int Tn,
                                            int Dk, int Dv, int j0, int nc, long long vbase,
                                            long long sbase, int warp, int lane) {
  using PC = Pieces<T>;
  using L = ChunkLayout<T, NK>;
  constexpr int DK = 16 * NK, ROW = DK + kRowPad;
  const int nsub = (Tn + kSub - 1) / kSub;
  const int g = lane >> 2, c4 = lane & 3, q = lane >> 3, rr = lane & 7;
  const int jw = 16 * warp;
  const bool active = jw < nc;
  // S^T tile n: rows j = jw + g (+8), columns i = 8n + 2 c4 (+1)
  float S[2 * NK][4];
#pragma unroll
  for (int nt = 0; nt < 2 * NK; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * nt + 2 * c4 + (e & 1), j = jw + g + 8 * (e >> 1);
      S[nt][e] = (s0 != nullptr && i < Dk && j < nc) ? s0[sbase + (long long)i * Dv + j0 + j]
                                                      : 0.f;
    }
  T* ys = reinterpret_cast<T*>(smem + L::ys) + warp * kSub * 16;
  for (int c = 0; c < nsub; ++c) {
    const int slot = c % kSlots;
    const unsigned char* sl = smem + L::slot + slot * L::slot_bytes;
    const __nv_bfloat16* rt = reinterpret_cast<const __nv_bfloat16*>(sl);
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(sl + L::kt);
    const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(sl + L::vv);
    const __nv_bfloat16* scp = reinterpret_cast<const __nv_bfloat16*>(sl + L::scp);
    const float* al = reinterpret_cast<const float*>(sl + L::al);
    bar_sync(kBarFull + slot, kChunkThreads);
    // y^T tile nt: rows j = jw + g (+8), columns t = 8 nt + 2 c4 (+1)
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (L::wg || active) {
      uint32_t va[PC::v][4];       // V^T (j, s): the A operand of scores . V and the update
#pragma unroll
      for (int p = 0; p < PC::v; ++p)
        ldsm_x4_t(va[p], vv + p * kSub * kVRow + ((q >> 1) * 8 + rr) * kVRow + jw + (q & 1) * 8);
      {
        uint32_t sb[PC::sc][4];    // scores^T (s, t), two t tiles
#pragma unroll
        for (int p = 0; p < PC::sc; ++p)
          ldsm_x4(sb[p], scp + p * kSub * kScRow + ((q >> 1) * 8 + rr) * kScRow + (q & 1) * 8);
        mma_terms<PC::v, PC::sc>(acc[0], va, sb, 0);
        mma_terms<PC::v, PC::sc>(acc[1], va, sb, 1);
      }
      if constexpr (L::wg) {
        // the readout and the update as the warpgroup's wgmma over all 64
        // columns (every chain warp takes part; columns past Dv have v = 0):
        // S^T's pieces from registers as A, r~ and k~ read once a block
        constexpr int kMs = PC::s > PC::r ? PC::s : PC::r, kMu = PC::v > PC::k ? PC::v : PC::k;
        uint32_t sa[NK][PC::s][4];
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          split_pair<PC::s>(sa[kk], 0, S[2 * kk][0], S[2 * kk][1]);
          split_pair<PC::s>(sa[kk], 1, S[2 * kk][2], S[2 * kk][3]);
          split_pair<PC::s>(sa[kk], 2, S[2 * kk + 1][0], S[2 * kk + 1][1]);
          split_pair<PC::s>(sa[kk], 3, S[2 * kk + 1][2], S[2 * kk + 1][3]);
        }
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const float2 a0 = load2(al + kk * 16 + 2 * c4), a1 = load2(al + kk * 16 + 8 + 2 * c4);
          S[2 * kk][0] *= a0.x;
          S[2 * kk][1] *= a0.y;
          S[2 * kk][2] *= a0.x;
          S[2 * kk][3] *= a0.y;
          S[2 * kk + 1][0] *= a1.x;
          S[2 * kk + 1][1] *= a1.y;
          S[2 * kk + 1][2] *= a1.x;
          S[2 * kk + 1][3] *= a1.y;
        }
        const uint32_t rt_a = smem_addr(rt), kt_a = smem_addr(kt);
        pin(S);                    // every write of S, acc and sa before the fence
        pin(acc);
        pin(sa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
#pragma unroll
          for (int x = 0; x < PC::s; ++x)
#pragma unroll
            for (int z = 0; z < PC::r; ++z)
              if (x + z < kMs)
                wgmma_n16(acc, sa[kk][x], sw128_desc(rt_a + z * L::rk_piece * 2 + kk * 32, 16, 1024));
#pragma unroll
        for (int x = 0; x < PC::v; ++x)
#pragma unroll
          for (int z = 0; z < PC::k; ++z)
            if (x + z < kMu) wgmma_n64(S, va[x], sw128_desc(kt_a + z * L::rk_piece * 2, 16, 1024));
        wgmma_commit();
        wgmma_wait_all();
        pin(S);
        pin(acc);
      } else {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          // the readout from the entry state: S^T's tiles 2kk, 2kk+1 as A, r~^T as B
          uint32_t sa[PC::s][4];
          split_pair<PC::s>(sa, 0, S[2 * kk][0], S[2 * kk][1]);
          split_pair<PC::s>(sa, 1, S[2 * kk][2], S[2 * kk][3]);
          split_pair<PC::s>(sa, 2, S[2 * kk + 1][0], S[2 * kk + 1][1]);
          split_pair<PC::s>(sa, 3, S[2 * kk + 1][2], S[2 * kk + 1][3]);
          uint32_t rb[PC::r][4];
#pragma unroll
          for (int p = 0; p < PC::r; ++p)
            ldsm_x4(rb[p], rt + p * L::rk_piece + ((q >> 1) * 8 + rr) * ROW + kk * 16 + (q & 1) * 8);
          mma_terms<PC::s, PC::r>(acc[0], sa, rb, 0);
          mma_terms<PC::s, PC::r>(acc[1], sa, rb, 1);
          // the update of the same tiles: decay, then + V^T k~
          const float2 a0 = load2(al + kk * 16 + 2 * c4), a1 = load2(al + kk * 16 + 8 + 2 * c4);
          S[2 * kk][0] *= a0.x;
          S[2 * kk][1] *= a0.y;
          S[2 * kk][2] *= a0.x;
          S[2 * kk][3] *= a0.y;
          S[2 * kk + 1][0] *= a1.x;
          S[2 * kk + 1][1] *= a1.y;
          S[2 * kk + 1][2] *= a1.x;
          S[2 * kk + 1][3] *= a1.y;
          uint32_t kb[PC::k][4];
#pragma unroll
          for (int p = 0; p < PC::k; ++p)
            ldsm_x4_t(kb[p], kt + p * L::rk_piece + ((q & 1) * 8 + rr) * ROW + kk * 16 + (q >> 1) * 8);
          mma_terms<PC::v, PC::k>(S[2 * kk], va, kb, 0);
          mma_terms<PC::v, PC::k>(S[2 * kk + 1], va, kb, 1);
        }
      }
    }
    if (c + kSlots < nsub) bar_arrive(kBarEmpty + slot, kChunkThreads);
    if (active) {
      const int t0 = c * kSub, n = min(kSub, Tn - t0);
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ys[(8 * nt + 2 * c4 + (e & 1)) * 16 + g + 8 * (e >> 1)] = from_float<T>(acc[nt][e]);
      __syncwarp();
      constexpr int kPer = 16 / (int)sizeof(T);      // elements of a 16-byte piece
      for (int p = lane; p < kSub * 16 / kPer; p += 32) {
        const int t = p / (16 / kPer), col = (p % (16 / kPer)) * kPer;
        if (t < n && jw + col < nc)
          *reinterpret_cast<uint4*>(y + vbase + (long long)(t0 + t) * Dv + j0 + jw + col) =
              *reinterpret_cast<const uint4*>(ys + t * 16 + col);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < 2 * NK; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * nt + 2 * c4 + (e & 1), j = jw + g + 8 * (e >> 1);
      if (i < Dk && j < nc) s_out[sbase + (long long)i * Dv + j0 + j] = S[nt][e];
    }
}

template <typename T, int NK>
__global__ void __launch_bounds__(kChunkThreads, sizeof(T) == 2 ? 2 : 1)
    rwkv6_chunked(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, const float* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_out,
                  int H, int Tn, int Dk, int Dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1024-aligned: the swizzle atoms of the wgmma operands
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int lane = threadIdx.x & 31;
  // the warp's index, known to the compiler as the same across the warp:
  // the branches on it below need no reconvergence
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int bh = blockIdx.x, j0 = blockIdx.y * kGroup;
  const int nc = min(kGroup, Dv - j0);
  const long long kbase = (long long)bh * Tn * Dk, vbase = (long long)bh * Tn * Dv;
  if (warp < kChainWarps)
    chunk_chain<T, NK>(smem, s0, y, s_out, Tn, Dk, Dv, j0, nc, vbase,
                       (long long)bh * Dk * Dv, warp, lane);
  else
    chunk_prep<T, NK>(smem, r, k, v, w, u, bh % H, Tn, Dk, Dv, j0, nc, kbase, vbase,
                      warp - kChainWarps, lane);
}

// 1, 2 or 4 16-channel tiles for Dk, 0 past the chunked kernel's reach
int chunk_tiles(int Dk) { return Dk <= 16 ? 1 : Dk <= 32 ? 2 : Dk <= kChunkMaxDk ? 4 : 0; }

template <typename T, int NK>
cudaError_t launch_chunked_nk(const void* r, const void* k, const void* v, const float* w,
                              const float* u, const float* s0, void* y, float* s_out, int B,
                              int H, int Tn, int Dk, int Dv, cudaStream_t s) {
  using L = ChunkLayout<T, NK>;
  const int optin = repro::device_smem_optin();
  if (L::total > (size_t)optin) return cudaErrorInvalidValue;
  // the whole opt-in, not this launch's size (common.cuh)
  cudaError_t e = cudaFuncSetAttribute(rwkv6_chunked<T, NK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Dv + kGroup - 1) / kGroup);
  rwkv6_chunked<T, NK><<<grid, kChunkThreads, L::total, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      static_cast<T*>(y), s_out, H, Tn, Dk, Dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chunked(const void* r, const void* k, const void* v, const float* w,
                           const float* u, const float* s0, void* y, float* s_out, int B, int H,
                           int Tn, int Dk, int Dv, cudaStream_t s) {
  const int es = (int)sizeof(T);
  if ((Dk * es) % 16 || (Dv * es) % 16 || !aligned16(r) || !aligned16(k) || !aligned16(v) ||
      !aligned16(w) || !aligned16(y))
    return cudaErrorInvalidValue;
  switch (chunk_tiles(Dk)) {
    case 1:
      return launch_chunked_nk<T, 1>(r, k, v, w, u, s0, y, s_out, B, H, Tn, Dk, Dv, s);
    case 2:
      return launch_chunked_nk<T, 2>(r, k, v, w, u, s0, y, s_out, B, H, Tn, Dk, Dv, s);
    case 4:
      return launch_chunked_nk<T, 4>(r, k, v, w, u, s0, y, s_out, B, H, Tn, Dk, Dv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block needs at least (float32 inputs,
// without the cp.async buffers), or -1 where Dk is past the kernel's reach.
long long repro_rwkv6_smem(int Dk, int Dv) {
  if (Dk < 1 || Dk > kMaxDk || Dv < 1) return -1;
  return (long long)layout(Dk, Dv, 4).staged;
}

// Bytes of dynamic shared memory a block of rwkv6_chunked needs, or -1
// where Dk is past its reach (Dk > 64) or dtype is not one it takes.
long long repro_rwkv6_chunked_smem(int Dk, int dtype) {
  const int nk = chunk_tiles(Dk);
  if (Dk < 1 || nk == 0) return -1;
  const bool f32 = dtype == repro::kF32;
  if (!f32 && dtype != repro::kBF16) return -1;
  switch (nk) {
    case 1:
      return (long long)(f32 ? ChunkLayout<float, 1>::total : ChunkLayout<__nv_bfloat16, 1>::total);
    case 2:
      return (long long)(f32 ? ChunkLayout<float, 2>::total : ChunkLayout<__nv_bfloat16, 2>::total);
    default:
      return (long long)(f32 ? ChunkLayout<float, 4>::total : ChunkLayout<__nv_bfloat16, 4>::total);
  }
}

// y (B, H, T, Dv) and s_out (B, H, Dk, Dv) float32 from r, k (B, H, T, Dk)
// and v (B, H, T, Dv) of one dtype (repro::DType), w (B, H, T, Dk) float32,
// u (H, Dk) float32 and s0 (B, H, Dk, Dv) float32 or null, all contiguous.
// Returns the CUDA error.
int repro_rwkv6(const void* r, const void* k, const void* v, const float* w,
                const float* u, const float* s0, void* y, float* s_out,
                int dtype, int B, int H, int Tn, int Dk, int Dv, void* stream) {
  if (B < 0 || H < 0 || Tn < 0 || Dk < 1 || Dk > kMaxDk || Dv < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  if ((long long)B * H > 0x7fffffffLL || (Dv + 7) / 8 > 65535) return (int)cudaErrorInvalidValue;
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

// repro_rwkv6 by rwkv6_chunked: the same arguments and outputs; Dk <= 64
// and every row of r, k, v (and y) 16-byte aligned (Dk and Dv times the
// element size multiples of 16, the pointers 16-byte aligned), else
// cudaErrorInvalidValue. Any T >= 0.
int repro_rwkv6_chunked(const void* r, const void* k, const void* v, const float* w,
                        const float* u, const float* s0, void* y, float* s_out,
                        int dtype, int B, int H, int Tn, int Dk, int Dv, void* stream) {
  if (B < 0 || H < 0 || Tn < 0 || Dk < 1 || chunk_tiles(Dk) == 0 || Dv < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  if ((long long)B * H > 0x7fffffffLL || (Dv + kGroup - 1) / kGroup > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return (int)launch_chunked<float>(r, k, v, w, u, s0, y, s_out, B, H, Tn, Dk, Dv, s);
    case repro::kBF16:
      return (int)launch_chunked<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, Tn, Dk,
                                                Dv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The i-th kernel of this file: its name, registers per thread and local
// (spill) bytes per thread. Returns 0, -1 past the last kernel, or the CUDA error.
int repro_rwkv6_kernel_info(int i, const char** name, int* regs, int* local_bytes) {
#define REPRO_RWKV6_REF(PP)                                                                  \
  {"rwkv6_fwd<float, P=" #PP ">", reinterpret_cast<const void*>(rwkv6_fwd<float, PP>)},      \
      {"rwkv6_fwd<bf16, P=" #PP ">", reinterpret_cast<const void*>(rwkv6_fwd<__nv_bfloat16, PP>)}
#define REPRO_RWKV6_CHUNKED(NK)                                                          \
  {"rwkv6_chunked<float, NK=" #NK ">", reinterpret_cast<const void*>(rwkv6_chunked<float, NK>)}, \
      {"rwkv6_chunked<bf16, NK=" #NK ">",                                                  \
       reinterpret_cast<const void*>(rwkv6_chunked<__nv_bfloat16, NK>)}
  static const repro::KernelRef table[] = {REPRO_RWKV6_CHUNKED(4),  REPRO_RWKV6_CHUNKED(2),
                                           REPRO_RWKV6_CHUNKED(1),
                                           REPRO_RWKV6_REF(1),  REPRO_RWKV6_REF(2),
                                           REPRO_RWKV6_REF(4),  REPRO_RWKV6_REF(8),
                                           REPRO_RWKV6_REF(16), REPRO_RWKV6_REF(32)};
#undef REPRO_RWKV6_REF
#undef REPRO_RWKV6_CHUNKED
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
