// GBDT split-finding kernels for Hopper (sm_90a), with a plain C interface
// that repro_torch/kernels/histogram.py binds through ctypes.
//
// Replaces, in the JAX package, kernels/histogram.py:
//   * fused_level_split_tpu (body _level_body): one tree level, i.e. the
//     per-(node, feature, bin) grad/hess sums, the histogram-subtraction
//     assembly (sibling = parent - smaller child) and the split scan
//     (cumsum over bins, gain, masks, first argmax per node);
//   * histogram_tpu (body _hist_kernel): the sums alone.
// The TPU kernels turn the scatter into one-hot matmuls because the TPU has
// no fast scatter. Here the scatter stays a scatter, into shared memory.
//
// What bounds it. Pass 1 must read every input row once: R*F*4 bytes of
// bins plus R*12 bytes of grad, hess and node, and it writes one partial
// histogram per row chunk, n_chunks*n_acc*F*B*8 bytes, which pass 2 reads
// back. The arithmetic (two adds per row and feature) is negligible, so the
// bound is bytes over the memory rate. What the design does about it: each
// block reads one feature column of a row chunk once, stages it in shared
// memory and accumulates there; only the small partials travel through
// device memory, and the wrapper caps them (see histogram.py).
//
// Determinism. No float atomics anywhere. In pass 1 every (node, bin) cell
// of a block's shared histogram has exactly one owning thread (the thread
// with index bin % blockDim), which adds the block's rows in row order.
// Pass 2 sums the partials in chunk order. So the same inputs give the same
// bits on every run, and with one chunk the sums are in plain row order.
//
// Launches, all on the caller's stream:
//   pass 1  hist_accumulate  grid (F, n_chunks, n_node_tiles)
//   pass 2a hist_reduce      grid (n_acc, F): sum partials; in subtraction
//                            mode also parent - small and the left/right
//                            interleave back to heap order
//   pass 2b split_scan       grid (n_nodes): sequential cumsum per feature,
//                            node totals from feature 0, gain, masks, and a
//                            block-wide first argmax over f*B + b.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kRowsPerThread = 8;   // staged rows per thread and tile
constexpr int kReduceThreads = 256;
constexpr int kScanThreads = 128;

// Is candidate (a, ia) a better first argmax than (b, ib)? NaN ranks above
// every number (as an argmax over floats treats it), ties go to the smaller
// flat index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void hist_accumulate(const int* __restrict__ bins,
                                const float* __restrict__ grad,
                                const float* __restrict__ hess,
                                const int* __restrict__ node,
                                float2* __restrict__ partial, int R, int F,
                                int B, int n_acc, int chunk_rows,
                                int nodes_per_tile) {
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tile_rows = kRowsPerThread * nthreads;
  const int f = blockIdx.x;
  const int chunk = blockIdx.y;
  const int node_lo = blockIdx.z * nodes_per_tile;
  const int n_tile = min(nodes_per_tile, n_acc - node_lo);
  const int n_cells = n_tile * B;
  float2* hist = smem;                                  // (n_tile, B)
  float2* gh = smem + nodes_per_tile * B;               // (tile_rows,)
  int2* key = reinterpret_cast<int2*>(gh + tile_rows);  // (tile_rows,)

  for (int i = tid; i < n_cells; i += nthreads) hist[i] = make_float2(0.f, 0.f);
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(R, row_begin + chunk_rows);
  for (int base = row_begin; base < row_end; base += tile_rows) {
    const int n_rows = min(tile_rows, row_end - base);
    __syncthreads();  // hist zeroed / previous tile consumed
    for (int i = tid; i < n_rows; i += nthreads) {
      const int row = base + i;
      const int b = bins[(size_t)row * F + f];
      const int nd = node[row] - node_lo;
      // rows of other node tiles, the pad/dump node n_acc and bins out of
      // range add nothing (the TPU kernel's all-zero one-hot rows)
      const bool live = (unsigned)b < (unsigned)B && (unsigned)nd < (unsigned)n_tile;
      key[i] = live ? make_int2(b % nthreads, nd * B + b) : make_int2(-1, 0);
      gh[i] = make_float2(grad[row], hess[row]);
    }
    __syncthreads();
    // every thread walks every staged row (a broadcast read); only the
    // owner of the row's bin adds, so each cell sums in row order
#pragma unroll 4
    for (int i = 0; i < n_rows; ++i) {
      const int2 k = key[i];
      if (k.x == tid) {
        const float2 v = gh[i];
        float2 c = hist[k.y];
        c.x += v.x;
        c.y += v.y;
        hist[k.y] = c;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n_cells; i += nthreads) {
    const int nd = i / B, b = i - nd * B;
    partial[(((size_t)chunk * n_acc + node_lo + nd) * F + f) * B + b] = hist[i];
  }
}

__global__ void hist_reduce(const float2* __restrict__ partial,
                            const float2* __restrict__ parent,
                            const int* __restrict__ small_is_left,
                            float2* __restrict__ hist, int n_acc, int F, int B,
                            int n_chunks, int subtract) {
  const int p = blockIdx.x;  // accumulated node: the parent pair when subtracting
  const int f = blockIdx.y;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    float sg = 0.f, sh = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float2 v = partial[(((size_t)c * n_acc + p) * F + f) * B + b];
      sg += v.x;
      sh += v.y;
    }
    const float2 small = make_float2(sg, sh);
    if (!subtract) {
      hist[((size_t)p * F + f) * B + b] = small;
    } else {
      const float2 par = parent[((size_t)p * F + f) * B + b];
      const float2 big = make_float2(par.x - sg, par.y - sh);
      const bool sil = small_is_left[p] != 0;
      hist[((size_t)(2 * p) * F + f) * B + b] = sil ? small : big;
      hist[((size_t)(2 * p + 1) * F + f) * B + b] = sil ? big : small;
    }
  }
}

__global__ void split_scan(const float2* __restrict__ hist,
                           const int* __restrict__ feat_mask, float lam,
                           float mcw, int bin_limit,
                           float* __restrict__ best_gain,
                           int* __restrict__ best_feat,
                           int* __restrict__ best_split, int F, int B) {
  __shared__ float tot[2];
  __shared__ float s_gain[kScanThreads];
  __shared__ int s_idx[kScanThreads];
  const int n = blockIdx.x;
  const float2* hn = hist + (size_t)n * F * B;
  if (threadIdx.x == 0) {
    // node totals: feature 0's cumsum tail, summed in the same order as
    // feature 0's own scan below, so both see the same bits
    float gt = 0.f, ht = 0.f;
    for (int b = 0; b < B; ++b) {
      const float2 v = hn[b];
      gt += v.x;
      ht += v.y;
    }
    tot[0] = gt;
    tot[1] = ht;
  }
  __syncthreads();
  const float gt = tot[0], ht = tot[1];
  const float parent_term = gt * gt / (ht + lam);
  const int last = bin_limit - 1;  // a split at the last bin sends every row left
  float best = -CUDART_INF_F;
  int best_idx = INT_MAX;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const bool f_ok = feat_mask[f] != 0;
    const float2* hf = hn + (size_t)f * B;
    float gl = 0.f, hl = 0.f;
    for (int b = 0; b < B; ++b) {
      const float2 v = hf[b];
      gl += v.x;
      hl += v.y;
      const float gr = gt - gl, hr = ht - hl;
      float gain = gl * gl / (hl + lam) + gr * gr / (hr + lam) - parent_term;
      if (!(f_ok && hl >= mcw && hr >= mcw && b < last)) gain = -CUDART_INF_F;
      const int idx = f * B + b;
      if (better(gain, idx, best, best_idx)) {
        best = gain;
        best_idx = idx;
      }
    }
  }
  s_gain[threadIdx.x] = best;
  s_idx[threadIdx.x] = best_idx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 1; t < blockDim.x; ++t) {
      if (better(s_gain[t], s_idx[t], best, best_idx)) {
        best = s_gain[t];
        best_idx = s_idx[t];
      }
    }
    best_gain[n] = best;
    best_feat[n] = best_idx / B;
    best_split[n] = best_idx % B;
  }
}

int accumulate_threads(int B) {
  const int t = ((B + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

size_t accumulate_smem(int B, int nodes_per_tile) {
  const int tile_rows = kRowsPerThread * accumulate_threads(B);
  return (size_t)nodes_per_tile * B * sizeof(float2) +
         (size_t)tile_rows * (sizeof(float2) + sizeof(int2));
}

cudaError_t launch_accumulate(const int* bins, const float* grad,
                              const float* hess, const int* node,
                              float* partial, int R, int F, int B, int n_acc,
                              int n_chunks, int chunk_rows, int nodes_per_tile,
                              cudaStream_t stream) {
  if (R <= 0 || n_chunks <= 0) return cudaSuccess;  // a zero grid is a launch error
  const size_t smem = accumulate_smem(B, nodes_per_tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n_tiles = (n_acc + nodes_per_tile - 1) / nodes_per_tile;
  const dim3 grid(F, n_chunks, n_tiles);
  hist_accumulate<<<grid, accumulate_threads(B), smem, stream>>>(
      bins, grad, hess, node, reinterpret_cast<float2*>(partial), R, F, B,
      n_acc, chunk_rows, nodes_per_tile);
  return cudaGetLastError();
}

int reduce_threads(int B) {
  const int t = ((B + 31) / 32) * 32;
  return t < kReduceThreads ? t : kReduceThreads;
}

}  // namespace

extern "C" {

// cudaGetErrorString for the codes the functions below return.
const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest dynamic shared memory a block may opt into on `device`.
int repro_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

// Bytes of dynamic shared memory pass 1 asks for.
long long repro_accumulate_smem(int B, int nodes_per_tile) {
  return (long long)accumulate_smem(B, nodes_per_tile);
}

// hist (n_nodes, F, B, 2) = per-(node, feature, bin) sums of grad and hess.
// Rows whose node is n_nodes (padding) add nothing. Returns the CUDA error.
int repro_histogram(const int* bins, const float* grad, const float* hess,
                    const int* node, float* partial, float* hist, int R, int F,
                    int B, int n_nodes, int n_chunks, int chunk_rows,
                    int nodes_per_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0) n_chunks = 0;
  cudaError_t e = launch_accumulate(bins, grad, hess, node, partial, R, F, B,
                                    n_nodes, n_chunks, chunk_rows,
                                    nodes_per_tile, s);
  if (e != cudaSuccess) return (int)e;
  hist_reduce<<<dim3(n_nodes, F), reduce_threads(B), 0, s>>>(
      reinterpret_cast<const float2*>(partial), nullptr, nullptr,
      reinterpret_cast<float2*>(hist), n_nodes, F, B, n_chunks, 0);
  return (int)cudaGetLastError();
}

// One tree level. Direct mode (subtract == 0): node in [0, n_nodes).
// Subtraction mode: the rows are the compacted smaller children, node holds
// the parent id in [0, n_nodes/2) (n_nodes/2 = pad), parent is the previous
// level's (n_nodes/2, F, B, 2) histogram and small_is_left[p] says which
// child of pair p was accumulated. Writes hist (n_nodes, F, B, 2) and the
// per-node best split. Returns the CUDA error.
int repro_level_split(const int* bins, const float* grad, const float* hess,
                      const int* node, const float* parent,
                      const int* small_is_left, const int* feat_mask, float lam,
                      float mcw, int bin_limit, float* partial, float* hist,
                      float* best_gain, int* best_feat, int* best_split, int R,
                      int F, int B, int n_nodes, int subtract, int n_chunks,
                      int chunk_rows, int nodes_per_tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_acc = subtract ? n_nodes / 2 : n_nodes;
  if (R <= 0) n_chunks = 0;
  cudaError_t e = launch_accumulate(bins, grad, hess, node, partial, R, F, B,
                                    n_acc, n_chunks, chunk_rows,
                                    nodes_per_tile, s);
  if (e != cudaSuccess) return (int)e;
  hist_reduce<<<dim3(n_acc, F), reduce_threads(B), 0, s>>>(
      reinterpret_cast<const float2*>(partial),
      reinterpret_cast<const float2*>(parent), small_is_left,
      reinterpret_cast<float2*>(hist), n_acc, F, B, n_chunks, subtract);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  split_scan<<<n_nodes, kScanThreads, 0, s>>>(
      reinterpret_cast<const float2*>(hist), feat_mask, lam, mcw, bin_limit,
      best_gain, best_feat, best_split, F, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
