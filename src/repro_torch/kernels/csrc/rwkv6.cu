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
// where exp(w_t) > 50, where both decay the state by at most 2e-22. It has
// no overflow hazard at any w, and one kernel serves bf16, float32 and T=1.
//
// What bounds it. Its bytes are r, k, v, w read once, y written once and
// the states (Dk*Dv*4 bytes per head) read and written once; its operations
// are 5*Dk*Dv + 5*Dk + 2*Dv per step and head (readout 2*Dk*Dv, update
// 3*Dk*Dv, the u bonus as a dot product times v, the decay). At RWKV6-7B's
// prefill (B=4, H=64, T=4096, Dk=Dv=64) that is ~0.8 GB (0.24 ms at
// 3.35 TB/s) and ~22 GFLOP of float32 (0.33 ms at 67 TFLOP/s): bound by
// operations, which have to run on the CUDA cores in this form.
//
// The first form of this kernel (one block of 64 threads per (b, head),
// the state in shared memory, a thread per column walking its 64 rows with
// a load and a store per element and step) ran 30x its bound: 256 blocks of
// 2 warps, and per step 2*Dk shared-memory accesses per thread.
//
// The design. The recurrence is sequential in time, so the parallelism is
// in the state: the columns of S are independent (y_t[j] reads only column
// j, and the update of column j writes only column j), and within a column
// the readout is a sum over Dk rows. So:
//   - a thread owns a block of kRows=8 rows x kCols=4 columns of S, in
//     registers for the whole launch; P = Dk/8 neighbouring lanes (8 at
//     Dk=64) share 4 columns. A step is 3 float32 instructions per state
//     element (readout fma, k*v, decay fma) and 6 float4 shared loads per
//     thread for r, k and the decay of its 8 rows, reused over 4 columns;
//   - a block owns one (b, head) and a group of `cols` columns (all 64 at
//     Dk=64); the grid is (b*head) x column groups, 256 blocks of 4 warps
//     at RWKV6-7B's prefill;
//   - each step's readout leaves one partial sum per 8-row slice in shared
//     memory (no shuffle chain per step); after the chunk the block adds
//     the P slices in slice order and v_t[j] * bonus_t, bonus_t = r_t.(u*k_t)
//     being one scalar per step and head, formed once when the step is
//     staged;
//   - r, k, the decay exp(-exp(w)) (computed once per element) and v are
//     staged as float32 in shared memory, kChunk=16 steps at a time, the
//     8-row slices padded to 12 floats so a quarter-warp's float4 loads fall
//     in distinct banks; each step's operands are loaded while the step
//     before computes. The raw inputs are in flight two chunks ahead, copied
//     by cp.async into a double buffer (where the rows are 16-byte aligned;
//     other shapes load them directly, in the same kernel).
// What bounds it now: issuing the steps' instructions (3 float32 ones per
// state element and step, on the CUDA cores), and the staging, conversion
// and y pass, which run between the chunks' steps, not under them.
// Every sum runs in a fixed order, so reruns are bit-identical, and no step
// depends on where a chunk starts, so a state carried across calls gives
// the same bits as one call.

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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block needs at least (float32 inputs,
// without the cp.async buffers), or -1 where Dk is past the kernel's reach.
long long repro_rwkv6_smem(int Dk, int Dv) {
  if (Dk < 1 || Dk > kMaxDk || Dv < 1) return -1;
  return (long long)layout(Dk, Dv, 4).staged;
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

// The i-th kernel of this file: its name, registers per thread and local
// (spill) bytes per thread. Returns 0, -1 past the last kernel, or the CUDA error.
int repro_rwkv6_kernel_info(int i, const char** name, int* regs, int* local_bytes) {
#define REPRO_RWKV6_REF(PP)                                                                  \
  {"rwkv6_fwd<float, P=" #PP ">", reinterpret_cast<const void*>(rwkv6_fwd<float, PP>)},      \
      {"rwkv6_fwd<bf16, P=" #PP ">", reinterpret_cast<const void*>(rwkv6_fwd<__nv_bfloat16, PP>)}
  static const repro::KernelRef table[] = {REPRO_RWKV6_REF(1),  REPRO_RWKV6_REF(2),
                                           REPRO_RWKV6_REF(4),  REPRO_RWKV6_REF(8),
                                           REPRO_RWKV6_REF(16), REPRO_RWKV6_REF(32)};
#undef REPRO_RWKV6_REF
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
