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
// back. The arithmetic (two adds per row and feature) is small, so the
// bound is bytes over the memory rate. What stands between pass 1 and that
// bound is the scatter into shared memory: many rows of one step may land
// in one (node, bin) cell, and the adds must not race.
//
// Pass 1's design. Lanes take features, not rows: a block takes a group of
// features for one tile of nodes and one chunk of rows, and each of its
// warps walks its own part of the chunk with a private histogram (nodes,
// B, features) in shared memory. With 32 features a block, lane j adds
// feature f0 + j of one row a step; where halving the features doubles the
// warps that fit (large B), a block takes 16 features and lanes j and
// j + 16 add feature f0 + j of two consecutive rows, comparing their keys
// with one shuffle: on equal keys the first row's lane adds both rows'
// values, in row order. So no two lanes of a step write one cell, whatever
// the bins: no atomics, no search for lanes with equal keys, and a step
// costs the same whatever B or the spread of the bins. The histogram keeps
// the features last, so a step's lanes touch neighbouring cells of one
// (node, bin) row. Each warp reads the nodes of 32 rows at a time (loaded
// kNodesAhead windows ahead), queues the rows of the block's node tile, and
// copies their features, grad and hess into the queue with cp.async,
// spread over the lanes so that neighbouring lanes copy neighbouring bytes
// (16-byte copies of the row-major (R, F) bins where F % 4 == 0): a node
// tile reads the bins of its own rows only. `depth` windows of copies stay
// in flight while the warp adds the rows that have landed. At the end the
// block's warps' histograms are summed in warp order into its partial.
// Shared memory: a warp's copy costs features*B*8 bytes per node, so a
// block has as many warps as copies and queues fit (one block per SM),
// and deeper queues where they cost no warp; a deep level at large B
// either keeps few nodes per tile, each tile reading the node array again,
// or keeps few warps. The wrapper's planner (histogram.py: _node_tiling)
// weighs the two.
//
// Determinism. No float atomics anywhere. A cell sums its rows within a
// warp in row order (two rows of one step summed first), the warps' copies
// in warp order, and pass 2 the partials in chunk order. So the same
// inputs give the same bits on every run. That order is not plain row
// order, so real-valued sums differ from the plain path's by rounding;
// integer-valued g/h sum exactly in any order and stay bit-equal to it.
//
// Launches, all on the caller's stream:
//   pass 1  hist_accumulate  grid (n_node_tiles, ceil(F/features), n_chunks)
//   pass 2a hist_reduce      grid (n_acc, F): sum partials; in subtraction
//                            mode also parent - small and the left/right
//                            interleave back to heap order
//   pass 2b split_scan       grid (n_nodes), a warp per feature: cumsum
//                            over bins as lane segments and a warp scan,
//                            node totals from feature 0's scan, gain,
//                            masks, and a block-wide first argmax over
//                            f*B + b.
// repro_split_scan launches pass 2b alone, on a histogram the caller built:
// the row-sharded level sums its shards' partial histograms (repro_histogram
// with the shards' nodes side by side) in shard order and scans the sum.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;

constexpr int kLanes = 32;       // features per block: one per lane
constexpr int kMaxWarps = 16;    // private histogram copies per block, at most
constexpr int kGroup = 4;        // rows read from the queue at once
constexpr int kNodesAhead = 4;   // windows whose nodes a warp has loaded ahead
constexpr int kMaxDepth = 4;     // windows of row copies a warp keeps in flight, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr int kReduceThreads = 256;
constexpr int kScanWarps = 8;

// A warp's region of pass 1's shared memory: a queue of `slots` staged rows
// (bins with a row stride of feat_stride, then node, grad, hess, then the
// rows of the window being queued), then the warp's histogram
// (nodes_per_tile, B, features) of float2, features last.
struct WarpLayout {
  int group;         // features per block: 32 / rows per step
  int features;      // min(F, group): the histogram's feature extent
  int feat_stride;   // staged bins per row, a multiple of 4 (16-byte rows)
  int depth;         // windows of 32 rows in flight
  int slots;         // queue slots: 32 * (depth + 1) + kGroup
  size_t queue_bytes;
  size_t bytes;      // the whole region, a multiple of 16
};

__host__ __device__ __forceinline__ WarpLayout warp_layout(int F, int B, int nodes_per_tile,
                                                           int rows_per_step, int depth) {
  WarpLayout l;
  l.group = kLanes / rows_per_step;
  l.features = F < l.group ? F : l.group;
  l.feat_stride = (l.features + 3) & ~3;
  l.depth = depth;
  l.slots = 32 * (depth + 1) + kGroup;
  l.queue_bytes = ((size_t)l.slots * (l.feat_stride + 3) + 32) * sizeof(int);
  const size_t hist_bytes = (size_t)nodes_per_tile * B * l.features * sizeof(float2);
  l.bytes = (l.queue_bytes + hist_bytes + 15) & ~(size_t)15;
  return l;
}

struct Queue {
  int* bins;     // (slots, feat_stride)
  int* node;     // (slots,): node within the tile
  float* grad;   // (slots,)
  float* hess;   // (slots,)
  int* rows;     // (32,): the rows of the window being queued
};

__device__ __forceinline__ Queue queue_at(unsigned char* region, const WarpLayout& l) {
  Queue q;
  q.bins = reinterpret_cast<int*>(region);
  q.node = q.bins + l.slots * l.feat_stride;
  q.grad = reinterpret_cast<float*>(q.node + l.slots);
  q.hess = q.grad + l.slots;
  q.rows = reinterpret_cast<int*>(q.hess + l.slots);
  return q;
}

// Add the n_rows queued rows from slot `first` on (a multiple of kGroup;
// the slots wrap around the queue) to the warp's histogram, one step of
// ROWS rows at a time: lane (slot s, feature j) = (lane / group, lane %
// group) adds row step + s of feature f0 + j. With two rows a step, the
// lanes of one feature compare their keys with a shuffle; on equal keys the
// first row's lane adds both rows' values, in row order, and the other lane
// adds nothing.
template <int ROWS>
__device__ __forceinline__ void add_rows(const Queue& q, const WarpLayout& l, float2* hist,
                                         int first, int n_rows, int nf, int B, int lane) {
  const int slot = lane / l.group, j = lane - slot * l.group;
  for (int done = 0; done < n_rows; done += kGroup) {
    const int n_valid = min(kGroup, n_rows - done);
    const int4 nd4 = *reinterpret_cast<const int4*>(q.node + first);
    const float4 g4 = *reinterpret_cast<const float4*>(q.grad + first);
    const float4 h4 = *reinterpret_cast<const float4*>(q.hess + first);
    const int nds[kGroup] = {nd4.x, nd4.y, nd4.z, nd4.w};
    const float gs[kGroup] = {g4.x, g4.y, g4.z, g4.w};
    const float hs[kGroup] = {h4.x, h4.y, h4.z, h4.w};
    // every step's bins first: a read after a cell's write would wait for it
    int bs[kGroup / ROWS];
#pragma unroll
    for (int step = 0; step < kGroup; step += ROWS)
      bs[step / ROWS] = q.bins[(first + step + slot) * l.feat_stride + j];
#pragma unroll
    for (int step = 0; step < kGroup; step += ROWS) {
      const int k = step + slot;  // this lane's row within the group
      const int nd = ROWS == 1 || slot == 0 ? nds[step] : nds[step + ROWS - 1];
      float2 v = ROWS == 1 || slot == 0 ? make_float2(gs[step], hs[step])
                                        : make_float2(gs[step + ROWS - 1], hs[step + ROWS - 1]);
      const int b = bs[step / ROWS];
      // bins out of range add nothing (the TPU kernel's all-zero one-hot
      // rows); a dead lane's key is its own
      const bool ok = k < n_valid && j < nf && (unsigned)b < (unsigned)B;
      int key = ok ? (nd * B + b) * l.features + j : -1 - lane;
      if (ROWS == 2) {
        const int other = __shfl_xor_sync(kFull, key, 16);
        const float og = __shfl_xor_sync(kFull, v.x, 16);
        const float oh = __shfl_xor_sync(kFull, v.y, 16);
        if (key == other) {
          if (slot == 0) {
            v.x += og;
            v.y += oh;
          } else {
            key = -1;
          }
        }
      }
      if (key >= 0) {
        const float2 c = hist[key];
        hist[key] = make_float2(c.x + v.x, c.y + v.y);
      }
    }
    first += kGroup;
    if (first == l.slots) first = 0;
  }
}

// Is candidate (a, ia) a better first argmax than (b, ib)? NaN ranks above
// every number (as an argmax over floats treats it), ties go to the smaller
// flat index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

template <bool VB, int ROWS>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    hist_accumulate(const int* __restrict__ bins, const float* __restrict__ grad,
                    const float* __restrict__ hess, const int* __restrict__ node,
                    float2* __restrict__ partial, int R, int F, int B, int n_acc,
                    int chunk_rows, int nodes_per_tile, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int node_lo = blockIdx.x * nodes_per_tile;
  const int n_tile = min(nodes_per_tile, n_acc - node_lo);
  const int chunk = blockIdx.z;
  const WarpLayout lay = warp_layout(F, B, nodes_per_tile, ROWS, depth);
  const int f0 = blockIdx.y * lay.group;
  const int nf = min(lay.group, F - f0);
  unsigned char* region = smem + warp * lay.bytes;
  const Queue q = queue_at(region, lay);
  float2* hist = reinterpret_cast<float2*>(region + lay.queue_bytes);
  const int cells = nodes_per_tile * B * lay.features;
  for (int i = lane; i < cells; i += 32) hist[i] = make_float2(0.f, 0.f);

  // this warp's rows: a contiguous part of the chunk, a multiple of 32 long
  const int chunk_begin = chunk * chunk_rows;
  const int chunk_end = min(R, chunk_begin + chunk_rows);
  const int share = ((chunk_end - chunk_begin + n_warps - 1) / n_warps + 31) / 32 * 32;
  const int row_begin = chunk_begin + warp * share;
  const int row_end = min(chunk_end, row_begin + share);
  const int n_windows = row_end > row_begin ? (row_end - row_begin + 31) / 32 : 0;

  // queue counters (slot = counter % slots): rows before `head` are added,
  // rows before `tail` are queued; before[i]: tail before the last i + 1 windows
  int head = 0, tail = 0;
  int before[kMaxDepth] = {};
  // the nodes of windows w .. w + kNodesAhead - 1, loaded ahead
  int ahead[kNodesAhead];
#pragma unroll
  for (int i = 0; i < kNodesAhead; ++i) {
    const int row = row_begin + 32 * i + lane;
    ahead[i] = row < row_end ? __ldg(node + row) : -1;
  }
  for (int w = 0; w < n_windows; ++w) {
    const int row = row_begin + 32 * w + lane;
    const int nd = ahead[0] < 0 ? -1 : ahead[0] - node_lo;
#pragma unroll
    for (int i = 0; i + 1 < kNodesAhead; ++i) ahead[i] = ahead[i + 1];
    const int far = row + 32 * kNodesAhead;
    ahead[kNodesAhead - 1] = far < row_end ? __ldg(node + far) : -1;
    // rows of other node tiles and the pad/dump node n_acc are not queued
    const bool live = (unsigned)nd < (unsigned)n_tile;
    const unsigned queued = __ballot_sync(kFull, live);
    const int n_new = __popc(queued);
    const int tail_slot = tail % lay.slots;
    const auto slot_of = [&](int t) {
      const int slot = tail_slot + t;
      return slot >= lay.slots ? slot - lay.slots : slot;
    };
    if (live) {
      const int t = __popc(queued & ((1u << lane) - 1u));
      q.node[slot_of(t)] = nd;
      q.rows[t] = row;
    }
    __syncwarp();
    // the queued rows' copies, spread over the lanes so that neighbouring
    // lanes copy neighbouring bytes: the t-th new row goes to slot tail + t
    if (VB) {
      const int c = 4 * (lane & 7);  // up to 8 chunks of 4 features by 4 rows a pass
      if (c < nf) {                  // nf % 4 == 0 when F % 4 == 0
        for (int t = lane >> 3; t < n_new; t += 4)
          cp_async16(q.bins + slot_of(t) * lay.feat_stride + c,
                     bins + (size_t)q.rows[t] * F + f0 + c);
      }
    } else if (lane < nf) {
      for (int t = 0; t < n_new; ++t)
        cp_async4(q.bins + slot_of(t) * lay.feat_stride + lane,
                  bins + (size_t)q.rows[t] * F + f0 + lane);
    }
    if (lane < n_new) {
      cp_async4(q.grad + slot_of(lane), grad + q.rows[lane]);
      cp_async4(q.hess + slot_of(lane), hess + q.rows[lane]);
    }
    repro::cp_async_commit();
    tail += n_new;
#pragma unroll
    for (int i = kMaxDepth - 1; i > 0; --i) before[i] = before[i - 1];
    before[0] = tail - n_new;
    // the windows before the last `depth` have landed
    int landed;
    switch (lay.depth) {
      case 1: repro::cp_async_wait<1>(); landed = before[0]; break;
      case 2: repro::cp_async_wait<2>(); landed = before[1]; break;
      case 3: repro::cp_async_wait<3>(); landed = before[2]; break;
      default: repro::cp_async_wait<4>(); landed = before[3]; break;
    }
    __syncwarp();  // every lane's copies and node stores are visible
    const int ready = (landed - head) / kGroup * kGroup;  // whole groups only
    if (ready > 0) add_rows<ROWS>(q, lay, hist, head % lay.slots, ready, nf, B, lane);
    head += ready;
    __syncwarp();  // the added slots and the row list are read before they are reused
  }
  repro::cp_async_wait<0>();
  __syncwarp();
  if (tail > head) add_rows<ROWS>(q, lay, hist, head % lay.slots, tail - head, nf, B, lane);
  __syncthreads();
  // the block's partial: the warps' histograms summed in warp order
  const int cs = lay.features;
  for (int i = threadIdx.x; i < n_tile * B * cs; i += blockDim.x) {
    const int j = i % cs;           // cell i is (node, bin, feature j)
    if (j >= nf) continue;
    const int nb = i / cs, nd = nb / B, b = nb - nd * B;
    float2 sum = make_float2(0.f, 0.f);
    for (int w = 0; w < n_warps; ++w) {
      const float2 o =
          reinterpret_cast<const float2*>(smem + w * lay.bytes + lay.queue_bytes)[i];
      sum.x += o.x;
      sum.y += o.y;
    }
    partial[(((size_t)chunk * n_acc + node_lo + nd) * F + f0 + j) * B + b] = sum;
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

// The exclusive prefix sum, over one feature's B bins, of this lane's bin
// segment [b_lo, b_hi): each lane sums its segment in bin order, then the
// warp scans the segment sums over lanes in a fixed tree (Kogge-Stone).
__device__ __forceinline__ float2 segment_prefix(const float2* hf, int b_lo, int b_hi,
                                                 int lane) {
  float2 s = make_float2(0.f, 0.f);
  for (int b = b_lo; b < b_hi; ++b) {
    const float2 v = hf[b];
    s.x += v.x;
    s.y += v.y;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float ox = __shfl_up_sync(kFull, s.x, off);
    const float oy = __shfl_up_sync(kFull, s.y, off);
    if (lane >= off) {
      s.x += ox;
      s.y += oy;
    }
  }
  const float px = __shfl_up_sync(kFull, s.x, 1);
  const float py = __shfl_up_sync(kFull, s.y, 1);
  return lane == 0 ? make_float2(0.f, 0.f) : make_float2(px, py);
}

// One block per node, a warp per feature. Lane l holds the bin segment
// [l*seg, (l+1)*seg) with seg = ceil(B/32); a bin's cumsum is the lane's
// exclusive prefix (segment_prefix) plus the segment's bins up to it, in
// bin order. The node totals are feature 0's cumsum at its last bin, summed
// in the same order as feature 0's own scan, so both see the same bits.
__global__ void __launch_bounds__(32 * kScanWarps)
    split_scan(const float2* __restrict__ hist, const int* __restrict__ feat_mask, float lam,
               float mcw, int bin_limit, float* __restrict__ best_gain,
               int* __restrict__ best_feat, int* __restrict__ best_split, int F, int B) {
  __shared__ float s_gain[kScanWarps];
  __shared__ int s_idx[kScanWarps];
  const int n = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float2* hn = hist + (size_t)n * F * B;
  const int seg = (B + 31) / 32;
  const int b_lo = min(B, lane * seg), b_hi = min(B, b_lo + seg);
  float2 run = segment_prefix(hn, b_lo, b_hi, lane);
  for (int b = b_lo; b < b_hi; ++b) {
    const float2 v = hn[b];
    run.x += v.x;
    run.y += v.y;
  }
  const int owner = (B - 1) / seg;  // the lane holding bin B - 1
  const float gt = __shfl_sync(kFull, run.x, owner);
  const float ht = __shfl_sync(kFull, run.y, owner);
  const float parent_term = gt * gt / (ht + lam);
  const int last = bin_limit - 1;  // a split at the last bin sends every row left
  float best = -CUDART_INF_F;
  int best_idx = INT_MAX;
  for (int f = warp; f < F; f += kScanWarps) {
    const bool f_ok = feat_mask[f] != 0;
    const float2* hf = hn + (size_t)f * B;
    const float2 pre = segment_prefix(hf, b_lo, b_hi, lane);
    float gl = pre.x, hl = pre.y;
    for (int b = b_lo; b < b_hi; ++b) {
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
  // the first argmax is a total order, so any reduction order finds it
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, best_idx, off);
    if (better(og, oi, best, best_idx)) {
      best = og;
      best_idx = oi;
    }
  }
  if (lane == 0) {
    s_gain[warp] = best;
    s_idx[warp] = best_idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kScanWarps; ++w) {
      if (better(s_gain[w], s_idx[w], best, best_idx)) {
        best = s_gain[w];
        best_idx = s_idx[w];
      }
    }
    best_gain[n] = best;
    best_feat[n] = best_idx / B;
    best_split[n] = best_idx % B;
  }
}

// Shape of a pass-1 block: rows per step (1, or 2 where halving the
// features per block doubles the warps that fit), as many warps (private
// copies) as fit in `smem_optin` bytes with one window of rows in flight
// each, at most kMaxWarps (0: not even one), and then as many windows in
// flight (up to kMaxDepth) as keep that many warps: few large histograms
// leave room for deeper queues, which few warps need to keep enough rows in
// flight.
struct AccShape {
  int rows, warps, depth;
  size_t smem;
};

AccShape accumulate_shape(int F, int B, int nodes_per_tile, int smem_optin) {
  const auto fit = [&](int rows, int depth) {
    const size_t w = (size_t)smem_optin / warp_layout(F, B, nodes_per_tile, rows, depth).bytes;
    return (int)(w < (size_t)kMaxWarps ? w : (size_t)kMaxWarps);
  };
  AccShape a{1, fit(1, 1), 1, 0};
  if (F > kLanes / 2 && fit(2, 1) > a.warps) a = AccShape{2, fit(2, 1), 1, 0};
  while (a.depth < kMaxDepth && a.warps > 0 && fit(a.rows, a.depth + 1) == a.warps) ++a.depth;
  a.smem = (size_t)a.warps * warp_layout(F, B, nodes_per_tile, a.rows, a.depth).bytes;
  return a;
}

template <bool VB, int ROWS>
cudaError_t launch_accumulate_t(const int* bins, const float* grad, const float* hess,
                                const int* node, float* partial, int R, int F, int B,
                                int n_acc, int n_chunks, int chunk_rows,
                                int nodes_per_tile, const AccShape& shape,
                                cudaStream_t stream) {
  // The kernel opts into the device's whole shared memory, not this launch's
  // need: executor threads launch it at other shapes at the same time, and a
  // limit set to one launch's size could be lowered by another thread between
  // that set and this launch (CUDA error 1, invalid argument).
  const cudaError_t e = cudaFuncSetAttribute(
      hist_accumulate<VB, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      repro::device_smem_optin());
  if (e != cudaSuccess) return e;
  const int n_tiles = (n_acc + nodes_per_tile - 1) / nodes_per_tile;
  const int group = kLanes / ROWS;
  const dim3 grid(n_tiles, (F + group - 1) / group, n_chunks);
  hist_accumulate<VB, ROWS><<<grid, 32 * shape.warps, shape.smem, stream>>>(
      bins, grad, hess, node, reinterpret_cast<float2*>(partial), R, F, B, n_acc,
      chunk_rows, nodes_per_tile, shape.depth);
  return cudaGetLastError();
}

cudaError_t launch_accumulate(const int* bins, const float* grad,
                              const float* hess, const int* node,
                              float* partial, int R, int F, int B, int n_acc,
                              int n_chunks, int chunk_rows, int nodes_per_tile,
                              cudaStream_t stream) {
  if (R <= 0 || n_chunks <= 0) return cudaSuccess;  // a zero grid is a launch error
  if (nodes_per_tile < 1 || chunk_rows < 1 || n_chunks > 65535) return cudaErrorInvalidValue;
  const AccShape shape = accumulate_shape(F, B, nodes_per_tile, repro::device_smem_optin());
  if (shape.warps < 1) return cudaErrorInvalidValue;
  // 16-byte copies where every row's bins are 16-byte aligned
  const bool vb = F % 4 == 0 && (reinterpret_cast<uintptr_t>(bins) & 15u) == 0;
  const auto go = [&](auto launch) {
    return launch(bins, grad, hess, node, partial, R, F, B, n_acc, n_chunks, chunk_rows,
                  nodes_per_tile, shape, stream);
  };
  if (shape.rows == 2) return vb ? go(launch_accumulate_t<true, 2>) : go(launch_accumulate_t<false, 2>);
  return vb ? go(launch_accumulate_t<true, 1>) : go(launch_accumulate_t<false, 1>);
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

// Shape of a pass-1 block at (F, B, nodes_per_tile) within smem_optin
// bytes of shared memory: its warps (private histogram copies; 0 if one
// copy does not fit) and its features (the grid takes ceil(F / features)
// blocks per node tile and row chunk).
int repro_accumulate_warps(int F, int B, int nodes_per_tile, int smem_optin, int* features) {
  const AccShape a = accumulate_shape(F, B, nodes_per_tile, smem_optin);
  *features = kLanes / a.rows;
  return a.warps;
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
  split_scan<<<n_nodes, 32 * kScanWarps, 0, s>>>(
      reinterpret_cast<const float2*>(hist), feat_mask, lam, mcw, bin_limit,
      best_gain, best_feat, best_split, F, B);
  return (int)cudaGetLastError();
}

// The split scan alone, on a histogram (n_nodes, F, B, 2) the caller built
// (the row-sharded level: the shards' partial histograms summed in shard
// order). The same pass as repro_level_split's last launch. Returns the
// CUDA error.
int repro_split_scan(const float* hist, const int* feat_mask, float lam, float mcw,
                     int bin_limit, float* best_gain, int* best_feat, int* best_split,
                     int n_nodes, int F, int B, void* stream) {
  if (n_nodes <= 0) return (int)cudaSuccess;  // a zero grid is a launch error
  split_scan<<<n_nodes, 32 * kScanWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(hist), feat_mask, lam, mcw, bin_limit, best_gain,
      best_feat, best_split, F, B);
  return (int)cudaGetLastError();
}

// The i-th kernel of this file: its name, registers per thread and local
// (spill) bytes per thread. Returns 0, -1 past the last kernel, or the CUDA error.
int repro_histogram_kernel_info(int i, const char** name, int* regs, int* local_bytes) {
  static const repro::KernelRef table[] = {
      {"hist_accumulate<16-byte bins>", reinterpret_cast<const void*>(hist_accumulate<true, 1>)},
      {"hist_accumulate<16-byte bins, 2 rows>", reinterpret_cast<const void*>(hist_accumulate<true, 2>)},
      {"hist_accumulate<4-byte bins>", reinterpret_cast<const void*>(hist_accumulate<false, 1>)},
      {"hist_accumulate<4-byte bins, 2 rows>", reinterpret_cast<const void*>(hist_accumulate<false, 2>)},
      {"hist_reduce", reinterpret_cast<const void*>(hist_reduce)},
      {"split_scan", reinterpret_cast<const void*>(split_scan)}};
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
