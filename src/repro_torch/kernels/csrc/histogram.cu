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
// What bounds it. A level must read every accumulated row's bins once
// (R*F*4 bytes) plus its grad, hess and node, and write the level's
// histogram; the adds are few, so the bound is bytes over the memory rate.
// What stands between the kernel and that bound is the scatter: many rows
// land in one (node, bin) cell, and their adds must not race.
//
// Fixed point. A call first takes a power-of-two grid 2^e for grad and one
// for hess: e is the smallest exponent with R * max|v| < 2^62 * 2^e (over
// the finite values), so no sum of R rounded values can overflow int64, and
// with max|v| < 2^38 * 2^e, so each rounded value keeps 38 bits (float32
// keeps 24) and splits into two 32-bit parts.
// Each row's value rounds to its grid once; a cell sums int64 with integer
// atomics, in shared memory and, across blocks, in device memory, and the
// sum converts to float32 once. Integer adds commute, so the result does
// not depend on the order of the rows, the blocks or the atomics: reruns
// are bit-identical and a permutation of the rows gives the same bits.
// Integer-valued g/h (a grid of at most 1) sum exactly, as the plain path's
// float sums of them do, so the two stay bit-equal. No float atomics.
// Non-finite values (NaN, +inf, -inf) add nothing to the integers; each
// sets a flag bit of its cell (device memory, one byte a cell), and a
// flagged cell becomes NaN (a NaN, or both infinities) or the one infinity:
// what a float sum gives in any order.
//
// Launches, all on the caller's stream (a level makes two or three):
//   1 level_stats       max|g|, max|h| and the non-finite flags of a row
//                       chunk a block; where rows are grouped (or the
//                       smaller children are picked without grouping) the
//                       chunk's row count per node; zeroes the counters,
//                       the flag bytes and the ungrouped cross-block sums
//   2 level_group       (only where rows are grouped: the level does not
//                       fit one tile) each block sums the counts into node
//                       totals, picks each pair's smaller child (ties
//                       left) in subtraction mode, scans the totals into
//                       node ranges, and writes its chunk's row ids into
//                       its part of each node's range (within that part in
//                       the order its warps reach them: integer sums make
//                       the order irrelevant): the rows grouped by node,
//                       the smaller children's only by subtraction
//   3 level_accumulate  persistent blocks walk work units (a node tile, a
//                       feature group, a chunk of the tile's rows): one
//                       histogram a block in shared memory, cells (node,
//                       bin, feature slot) with the features last, fed by
//                       native 32-bit shared atomics (kLoBits below); the
//                       tile's rows gathered by id (grouped) or read in
//                       order (one tile holds every node), 4 features of a
//                       row a thread, the 4 rows of a warp step starting
//                       at rotated features so that their adds fall in
//                       distinct banks. A tile split over several chunks
//                       adds its sums into device memory, and the last
//                       chunk to arrive (a counter) converts them; that
//                       block writes the tile's float32 histogram (and
//                       parent - small for the sibling), and the last
//                       feature group of a node tile (a counter) runs the
//                       split scan of its nodes.
// repro_split_scan launches the split scan alone, on a histogram the caller
// built: the row-sharded level sums its shards' partial histograms
// (repro_histogram with the shards' nodes side by side) in shard order and
// scans the sum.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <atomic>
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;       // block of launches 1-3
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;     // launch 3: two blocks an SM
// passes of rows whose loads a thread keeps in flight: 16-byte loads of 4
// features, or scalar loads (the leaf sums: one feature)
constexpr int kPassesVec = 2;
constexpr int kPassesScalar = 4;
constexpr int kVec = 4;             // features of a row a thread adds (one 16-byte load)
constexpr int kMaxGroup = 32;       // features per group at most: the bank count
constexpr int kMinChunkRows = 2048; // fewest rows worth a block of their own
constexpr int kStatsUnroll = 4;     // 32-row windows a warp of launches 1-2 loads at once
// A rounded value q (|q| <= 2^38) adds to a cell as two native 32-bit shared
// atomics: its low kLoBits bits (unsigned) and q >> kLoBits (signed). Over a
// window of kWindowRows rows a cell takes at most one add a row, so neither
// 32-bit sum can overflow (4096 * (2^20 - 1) < 2^32, 4096 * 2^18 = 2^30);
// after each window the cell's owner thread folds both into its int64 sum.
// (A 64-bit shared atomicAdd is a compare-and-swap loop on sm_90a:
// ATOMS.CAST.SPIN.64 in cuobjdump -sass.)
constexpr int kLoBits = 20;
constexpr int kWindowRows = 4096;
constexpr int kQBits = 38;
constexpr int kScanWarps = 8;       // the standalone split scan's block
constexpr int kMaxDevices = 64;
// a tile cell in shared memory: the window's four 32-bit sums (g low, g
// high, h low, h high) and, where a unit spans several windows, the two
// int64 sums
constexpr int kWindowCellBytes = 16;
constexpr int kFoldedCellBytes = 32;

// --------------------------------------------------------------------------
// The plan of one call: how the level is cut into tiles and units, the
// launch shapes and the scratch layout. A pure function of the shapes and
// the device, computed on the host by every entry point alike.
// --------------------------------------------------------------------------
struct Plan {
  int R, F, B, n_nodes, sub;
  int n_acc;       // nodes accumulated: n_nodes / 2 by subtraction
  int n_cnt;       // keys launch 1 counts (0: none): n_nodes by subtraction, else n_acc
  int grouped;     // rows grouped by node (launch 2 runs); else one tile holds every node
  int nt;          // nodes a tile: n_acc ungrouped, 1 grouped
  int n_tiles;     // node tiles: 1 ungrouped, n_acc grouped
  int fg, n_fg;    // features a group (<= 32) and groups
  int slots;       // feature slots a (node, bin): the power of two >= fg, features last
  int slots_shift; // log2(slots)
  int vec;         // features a thread adds of each row: min(kVec, slots)
  int lpr_shift;   // log2 of the lanes a row: slots / vec
  int cell_bytes;  // kFoldedCellBytes where a unit can span several windows
  int tile_cells;  // nt * B * slots
  int chunk_rows;  // grouped: rows a unit at most, before a tile splits
  int n_chunks;    // ungrouped: row chunks a feature group
  int P, chunk1;   // blocks of launches 1-2 and rows a block
  int grid3;       // blocks of launch 3
  int plan_ints;   // launch 3's shared ints before the histogram
  size_t smem1, smem2, smem3;
  size_t off_stats, off_counts, off_ctrl, off_starts, off_sil, off_ids, off_accum, off_flags;
  size_t bytes;    // scratch
};

struct DeviceInfo {
  int sms, optin, sm_smem, reserved;
};

std::atomic<int> g_info_ready[kMaxDevices];
DeviceInfo g_info[kMaxDevices];

cudaError_t device_info(DeviceInfo* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < kMaxDevices && g_info_ready[dev].load(std::memory_order_acquire)) {
    *out = g_info[dev];
    return cudaSuccess;
  }
  DeviceInfo d;
  if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (e = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
      (e = cudaDeviceGetAttribute(&d.sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) ||
      (e = cudaDeviceGetAttribute(&d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)))
    return e;
  if (dev >= 0 && dev < kMaxDevices) {
    g_info[dev] = d;  // every thread writes the same values
    g_info_ready[dev].store(1, std::memory_order_release);
  }
  *out = d;
  return cudaSuccess;
}

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }
int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The plan with `cell_bytes` of shared memory a tile cell; false where the
// level cannot be planned (a node's bins do not fit a block's shared memory,
// or too many nodes to count in one block).
bool plan_with(int R, int F, int B, int n_nodes, int sub, const DeviceInfo& d, int cell_bytes,
               Plan* out) {
  Plan p{};
  p.R = R; p.F = F; p.B = B; p.n_nodes = n_nodes; p.sub = sub;
  p.n_acc = sub ? n_nodes / 2 : n_nodes;
  p.cell_bytes = cell_bytes;
  const size_t budget =
      (size_t)(d.sm_smem / kBlocksPerSM - d.reserved) < (size_t)d.optin
          ? (size_t)(d.sm_smem / kBlocksPerSM - d.reserved) : (size_t)d.optin;
  const size_t misc_ints = 128;  // scan and reduction scratch
  const auto pow2_at_least = [](int x) {
    int v = 1;
    while (v < x) v <<= 1;
    return v;
  };
  const auto fits = [&](int plan_ints, int nt, int fg) {
    return align16((plan_ints + misc_ints) * 4) +
               (size_t)nt * B * pow2_at_least(fg) * cell_bytes <= budget;
  };
  const int ungrouped_ints = sub ? p.n_acc : 0;
  p.grouped = !(p.n_acc == 1 || (F <= kMaxGroup && fits(ungrouped_ints, p.n_acc, F)));
  p.nt = p.grouped ? 1 : p.n_acc;
  p.n_tiles = p.grouped ? p.n_acc : 1;
  p.plan_ints = p.grouped ? 2 * (p.n_acc + 1) + (sub ? p.n_acc : 0) : ungrouped_ints;
  const size_t head = align16((p.plan_ints + misc_ints) * 4);
  if (head >= budget) return false;
  // the most feature slots (a power of two) whose tile fits
  long long room = (long long)((budget - head) / ((size_t)p.nt * B * cell_bytes));
  if (room < 1) return false;
  int slots = kMaxGroup;
  while (slots > room) slots >>= 1;
  p.n_fg = ceil_div(F, slots);
  p.fg = ceil_div(F, p.n_fg);  // the groups as even as the count allows
  if (F % kVec == 0 && slots >= kVec && p.fg % kVec) p.fg += kVec - p.fg % kVec;  // 16-byte loads
  p.slots = pow2_at_least(p.fg);
  p.slots_shift = 0;
  while ((1 << p.slots_shift) < p.slots) ++p.slots_shift;
  p.vec = p.slots < kVec ? p.slots : kVec;
  p.lpr_shift = 0;
  while ((p.vec << p.lpr_shift) < p.slots) ++p.lpr_shift;
  p.tile_cells = p.nt * B * p.slots;
  p.grid3 = d.sms * kBlocksPerSM;
  const long long acc_rows = sub ? R / 2 : R;
  if (p.grouped) {
    const long long per_unit = ((long long)acc_rows * p.n_fg + p.grid3 - 1) / p.grid3;
    p.chunk_rows = (int)(per_unit > kMinChunkRows ? per_unit : kMinChunkRows);
    p.n_chunks = 0;
  } else {
    int c = ceil_div(p.grid3, p.n_fg);
    const int by_rows = ceil_div(R, kMinChunkRows);
    if (by_rows < c) c = by_rows;
    p.n_chunks = c < 1 ? 1 : c;
    p.chunk_rows = ceil_div(R, p.n_chunks);
  }
  p.n_cnt = (p.grouped || sub) ? (sub ? n_nodes : p.n_acc) : 0;
  int P = ceil_div(R, kMinChunkRows);
  if (P > d.sms) P = d.sms;
  p.P = P < 1 ? 1 : P;
  p.chunk1 = ceil_div(R, p.P);
  p.smem1 = align16((size_t)p.n_cnt * 4 + 64 * 4);
  p.smem2 = align16(((size_t)2 * p.n_cnt + 3 * (size_t)p.n_acc + 1 + misc_ints) * 4);
  p.smem3 = head + (size_t)p.tile_cells * cell_bytes;
  if (p.smem1 > (size_t)d.optin || p.smem2 > (size_t)d.optin || p.smem3 > (size_t)d.optin)
    return false;
  // scratch
  size_t o = 0;
  p.off_stats = o;  o = align16(o + (size_t)p.P * 4 * 4);
  p.off_counts = o; o = align16(o + (size_t)p.P * p.n_cnt * 4);
  p.off_ctrl = o;   o = align16(o + (size_t)p.n_tiles * (p.n_fg + 1) * 4);
  p.off_starts = o; o = align16(o + (p.grouped ? (size_t)(p.n_acc + 1) * 4 : 0));
  p.off_sil = o;    o = align16(o + (p.grouped && sub ? (size_t)p.n_acc * 4 : 0));
  p.off_ids = o;    o = align16(o + (p.grouped ? (size_t)R * 4 : 0));
  p.off_accum = o;
  const bool accum = p.grouped || p.n_chunks > 1;
  o = align16(o + (accum ? (size_t)p.n_tiles * p.n_fg * p.tile_cells * 16 : 0));
  p.off_flags = o;  o = align16(o + align16((size_t)p.n_acc * F * B));
  p.bytes = o;
  *out = p;
  return true;
}

// 16 bytes a cell where no unit spans two windows (the int64 sums are then
// the window's own), else 32.
bool make_plan(int R, int F, int B, int n_nodes, int sub, const DeviceInfo& d, Plan* out) {
  if (!plan_with(R, F, B, n_nodes, sub, d, kWindowCellBytes, out)) return false;
  if (out->chunk_rows <= kWindowRows) return true;
  return plan_with(R, F, B, n_nodes, sub, d, kFoldedCellBytes, out);
}

// --------------------------------------------------------------------------
// Device pieces
// --------------------------------------------------------------------------

// What each launch reads: the inputs, the outputs, the scratch and the plan.
struct Level {
  const int* bins;
  const float* grad;
  const float* hess;
  const int* node;
  const float2* parent;  // subtraction: the level above's histogram
  const int* sil_in;     // subtraction: the caller's smaller children, or null
  const int* feat_mask;  // null: no split scan (the histogram alone)
  float lam, mcw;
  int bin_limit;
  float2* hist;
  float* best_gain;
  int* best_feat;
  int* best_split;
  unsigned* stats;       // (P, 4): max|g| bits, max|h| bits, flags, 0
  int* counts;           // (P, n_cnt)
  int* ctrl;             // chunk counters (n_tiles * n_fg), then group counters (n_tiles)
  int* starts;           // grouped: node ranges (n_acc + 1)
  int* sil;              // grouped subtraction: the smaller children (n_acc)
  int* ids;              // grouped: row ids in node order
  long long* accum;      // cross-block sums: (n_tiles * n_fg, 2, tile_cells)
  unsigned* flags;       // non-finite flag bytes, (n_acc, F, B), four a word
  Plan p;
};

// The grid 2^e of a component (m: its largest finite |v|): the smallest e
// with rows * m < 2^62 * 2^e (no int64 sum overflows) and m < 2^38 * 2^e (a
// rounded value splits into the two 32-bit parts).
__device__ __forceinline__ int grid_exponent(float m, int rows) {
  if (!(m > 0.f)) return 0;
  int k_rows, k_value;
  frexp((double)rows * (double)m, &k_rows);
  frexp((double)m, &k_value);
  return max(k_rows - 62, k_value - kQBits);
}

// v * 2^-e as two exact power-of-two products (2^-e alone can leave float's range)
struct Grid {
  float s1, s2;
  int e;
};

__device__ __forceinline__ Grid make_grid(int e) {
  const int a = -e / 2, b = -e - a;
  return Grid{ldexpf(1.f, a), ldexpf(1.f, b), e};
}

__device__ __forceinline__ long long quantize(float v, const Grid& q) {
  return __float2ll_rn(v * q.s1 * q.s2);
}

__device__ __forceinline__ float unquantize(long long s, int e) {
  return ldexpf(__ll2float_rn(s), e);
}

// flag bits of a non-finite value: 1 NaN, 2 +inf, 4 -inf
__device__ __forceinline__ unsigned nonfinite_bits(float v) {
  return isnan(v) ? 1u : (v > 0.f ? 2u : 4u);
}

// a float sum's value in any order, given the finite part and the flags
__device__ __forceinline__ float with_flags(float v, unsigned bits) {
  if ((bits & 1u) || (bits & 6u) == 6u) return CUDART_NAN_F;
  if (bits & 2u) return CUDART_INF_F;
  if (bits & 4u) return -CUDART_INF_F;
  return v;
}

__device__ __forceinline__ void flag_or(unsigned* flags, size_t cell, unsigned bits) {
  atomicOr(flags + (cell >> 2), bits << (8 * (cell & 3)));
}

__device__ __forceinline__ unsigned flag_bits(const unsigned* flags, size_t cell) {
  return (__ldcg(flags + (cell >> 2)) >> (8 * (cell & 3))) & 0xffu;
}

// Exclusive prefix sum of a[0..n) in shared memory, by every thread of the
// block; returns the total. tmp: one int a warp.
__device__ int block_exclusive_scan(int* a, int n, int* tmp) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = T >> 5;
  const int per = (n + T - 1) / T;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? tmp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nw) tmp[lane] = w;
  }
  __syncthreads();
  const int total = tmp[nw - 1];
  int run = x - s + (warp > 0 ? tmp[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// The grids of this call, from launch 1's per-block maxima (every block of
// launch 3 reduces them alike). tmp: 3 ints a warp. Returns the flags.
__device__ unsigned reduce_stats(const Level& L, Grid* gq, Grid* hq, unsigned* tmp) {
  unsigned mg = 0, mh = 0, fl = 0;
  for (int i = threadIdx.x; i < L.p.P; i += blockDim.x) {
    mg = max(mg, __ldcg(L.stats + 4 * i));
    mh = max(mh, __ldcg(L.stats + 4 * i + 1));
    fl |= __ldcg(L.stats + 4 * i + 2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mg = max(mg, __shfl_xor_sync(kFull, mg, off));
    mh = max(mh, __shfl_xor_sync(kFull, mh, off));
    fl |= __shfl_xor_sync(kFull, fl, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    tmp[3 * warp] = mg;
    tmp[3 * warp + 1] = mh;
    tmp[3 * warp + 2] = fl;
  }
  __syncthreads();
  mg = mh = fl = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    mg = max(mg, tmp[3 * w]);
    mh = max(mh, tmp[3 * w + 1]);
    fl |= tmp[3 * w + 2];
  }
  __syncthreads();
  // non-negative floats order as their bit patterns
  *gq = make_grid(grid_exponent(__uint_as_float(mg), L.p.R));
  *hq = make_grid(grid_exponent(__uint_as_float(mh), L.p.R));
  return fl;
}

// Is candidate (a, ia) a better first argmax than (b, ib)? NaN ranks above
// every number (as an argmax over floats treats it), ties go to the smaller
// flat index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// The exclusive prefix sum, over one feature's B bins, of this lane's bin
// segment [b_lo, b_hi): each lane sums its segment in bin order, then the
// warp scans the segment sums over lanes in a fixed tree (Kogge-Stone).
// Loads go to L2 (__ldcg): other blocks of this launch wrote the histogram.
__device__ __forceinline__ float2 segment_prefix(const float2* hf, int b_lo, int b_hi,
                                                 int lane) {
  float2 s = make_float2(0.f, 0.f);
#pragma unroll 8
  for (int b = b_lo; b < b_hi; ++b) {
    const float2 v = __ldcg(hf + b);
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

// Node n's best split, by every thread of the block, a warp per feature.
// Lane l holds the bin segment [l*seg, (l+1)*seg) with seg = ceil(B/32); a
// bin's cumsum is the lane's exclusive prefix (segment_prefix) plus the
// segment's bins up to it, in bin order. The node totals are feature 0's
// cumsum at its last bin, summed in the same order as feature 0's own scan,
// so both see the same bits. s_gain, s_idx: one slot a warp.
__device__ void scan_node(const float2* hist, int n, const int* __restrict__ feat_mask,
                          float lam, float mcw, int bin_limit, int F, int B,
                          float* best_gain, int* best_feat, int* best_split, float* s_gain,
                          int* s_idx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float2* hn = hist + (size_t)n * F * B;
  const int seg = (B + 31) / 32;
  const int b_lo = min(B, lane * seg), b_hi = min(B, b_lo + seg);
  float2 run = segment_prefix(hn, b_lo, b_hi, lane);
#pragma unroll 8
  for (int b = b_lo; b < b_hi; ++b) {
    const float2 v = __ldcg(hn + b);
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
  for (int f = warp; f < F; f += n_warps) {
    const bool f_ok = feat_mask[f] != 0;
    const float2* hf = hn + (size_t)f * B;
    const float2 pre = segment_prefix(hf, b_lo, b_hi, lane);
    float gl = pre.x, hl = pre.y;
#pragma unroll 8
    for (int b = b_lo; b < b_hi; ++b) {
      const float2 v = __ldcg(hf + b);
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
    for (int w = 1; w < n_warps; ++w) {
      if (better(s_gain[w], s_idx[w], best, best_idx)) {
        best = s_gain[w];
        best_idx = s_idx[w];
      }
    }
    best_gain[n] = best;
    best_feat[n] = best_idx / B;
    best_split[n] = best_idx % B;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(32 * kScanWarps)
    split_scan(const float2* __restrict__ hist, const int* __restrict__ feat_mask, float lam,
               float mcw, int bin_limit, float* __restrict__ best_gain,
               int* __restrict__ best_feat, int* __restrict__ best_split, int F, int B) {
  __shared__ float s_gain[kScanWarps];
  __shared__ int s_idx[kScanWarps];
  scan_node(hist, blockIdx.x, feat_mask, lam, mcw, bin_limit, F, B, best_gain, best_feat,
            best_split, s_gain, s_idx);
}

// --------------------------------------------------------------------------
// Launch 1: the grids' maxima, the node counts, the zeroing
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) level_stats(Level L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = L.p;
  int* cnt = reinterpret_cast<int*>(smem);
  unsigned* tmp = reinterpret_cast<unsigned*>(cnt + p.n_cnt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < p.n_cnt; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  const int begin = blockIdx.x * p.chunk1;
  const int end = min(p.R, begin + p.chunk1);
  unsigned mg = 0, mh = 0, fl = 0;
  // kStatsUnroll windows of 32 rows a warp, their loads first
  for (int base = begin + 32 * warp; base < end; base += 32 * kWarps * kStatsUnroll) {
    float g[kStatsUnroll], h[kStatsUnroll];
    int key[kStatsUnroll];
#pragma unroll
    for (int i = 0; i < kStatsUnroll; ++i) {
      const int row = base + 32 * kWarps * i + lane;
      const bool valid = row < end;
      g[i] = valid ? __ldg(L.grad + row) : 0.f;
      h[i] = valid ? __ldg(L.hess + row) : 0.f;
      key[i] = valid && p.n_cnt > 0 ? __ldg(L.node + row) : -1;
    }
#pragma unroll
    for (int i = 0; i < kStatsUnroll; ++i) {
      if (isfinite(g[i])) mg = max(mg, __float_as_uint(fabsf(g[i]))); else fl |= 1u;
      if (isfinite(h[i])) mh = max(mh, __float_as_uint(fabsf(h[i]))); else fl |= 2u;
      if (p.n_cnt > 0) {
        const bool ok = (unsigned)key[i] < (unsigned)p.n_cnt;
        const unsigned peers = __match_any_sync(kFull, ok ? key[i] : -1);
        if (ok && lane == __ffs(peers) - 1) atomicAdd(cnt + key[i], __popc(peers));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mg = max(mg, __shfl_xor_sync(kFull, mg, off));
    mh = max(mh, __shfl_xor_sync(kFull, mh, off));
    fl |= __shfl_xor_sync(kFull, fl, off);
  }
  if (lane == 0) {
    tmp[3 * warp] = mg;
    tmp[3 * warp + 1] = mh;
    tmp[3 * warp + 2] = fl;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mg = max(mg, tmp[3 * w]);
      mh = max(mh, tmp[3 * w + 1]);
      fl |= tmp[3 * w + 2];
    }
    unsigned* st = L.stats + 4 * blockIdx.x;
    st[0] = mg;
    st[1] = mh;
    st[2] = fl;
    st[3] = 0;
  }
  for (int k = tid; k < p.n_cnt; k += blockDim.x)
    L.counts[(size_t)blockIdx.x * p.n_cnt + k] = cnt[k];
  // what launch 3 needs zero: its counters, the flag bytes and, ungrouped,
  // the cross-block sums (grouped: launch 2 zeroes those of split tiles)
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + tid;
  const size_t n_ctrl = (size_t)p.n_tiles * (p.n_fg + 1);
  for (size_t i = first; i < n_ctrl; i += stride) L.ctrl[i] = 0;
  const size_t n_words = ((size_t)p.n_acc * p.F * p.B + 3) / 4;
  for (size_t i = first; i < n_words; i += stride) L.flags[i] = 0u;
  if (!p.grouped && p.n_chunks > 1) {
    const size_t n = (size_t)p.n_fg * p.tile_cells * 2;
    for (size_t i = first; i < n; i += stride) L.accum[i] = 0;
  }
}

// rows a unit holds at most before a node tile splits, and its chunks
__device__ __forceinline__ int tile_chunks(int rows, int chunk_rows) {
  return rows <= chunk_rows ? 1 : (rows + chunk_rows - 1) / chunk_rows;
}

// is row key (a child) the smaller child of its pair? (subtraction)
__device__ __forceinline__ bool is_small_child(int key, const int* sil) {
  return (key & 1) == (sil[key >> 1] ? 0 : 1);
}

// --------------------------------------------------------------------------
// Launch 2: rows grouped by node (the smaller children's by subtraction)
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) level_group(Level L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = L.p;
  int* total = reinterpret_cast<int*>(smem);  // (n_cnt,)
  int* before = total + p.n_cnt;              // (n_cnt,): this block's predecessors
  int* start = before + p.n_cnt;              // (n_acc + 1,)
  int* cursor = start + p.n_acc + 1;          // (n_acc,)
  int* sil = cursor + p.n_acc;                // (n_acc,)
  int* tmp = sil + p.n_acc;                   // (kWarps,)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < p.n_cnt; k += blockDim.x) {
    int all = 0, mine = 0;
#pragma unroll 8
    for (int b = 0; b < p.P; ++b) {
      const int v = __ldcg(L.counts + (size_t)b * p.n_cnt + k);
      all += v;
      mine += b < (int)blockIdx.x ? v : 0;
    }
    total[k] = all;
    before[k] = mine;
  }
  __syncthreads();
  for (int n = tid; n < p.n_acc; n += blockDim.x) {
    int key = n;
    if (p.sub) {
      const bool left = L.sil_in ? L.sil_in[n] != 0 : total[2 * n] <= total[2 * n + 1];
      sil[n] = left;
      key = 2 * n + (left ? 0 : 1);
      if (blockIdx.x == 0) L.sil[n] = left;
    }
    start[n] = total[key];
  }
  __syncthreads();
  const int n_rows = block_exclusive_scan(start, p.n_acc, tmp);
  if (tid == 0) start[p.n_acc] = n_rows;
  __syncthreads();
  for (int n = tid; n < p.n_acc; n += blockDim.x)
    cursor[n] = start[n] + before[p.sub ? 2 * n + (sil[n] ? 0 : 1) : n];
  if (blockIdx.x == 0)
    for (int n = tid; n <= p.n_acc; n += blockDim.x) L.starts[n] = start[n];
  // zero the cross-block sums of the tiles that split into several chunks
  for (int t = blockIdx.x; t < p.n_acc; t += gridDim.x) {
    if (tile_chunks(start[t + 1] - start[t], p.chunk_rows) == 1) continue;
    long long* a = L.accum + (size_t)t * p.n_fg * p.tile_cells * 2;
    for (size_t i = tid; i < (size_t)p.n_fg * p.tile_cells * 2; i += blockDim.x) a[i] = 0;
  }
  __syncthreads();
  // this block's rows into their node ranges: one shared atomic a warp and node
  const int begin = blockIdx.x * p.chunk1;
  const int end = min(p.R, begin + p.chunk1);
  for (int base = begin + 32 * warp; base < end; base += 32 * kWarps * kStatsUnroll) {
    int key[kStatsUnroll];
#pragma unroll
    for (int i = 0; i < kStatsUnroll; ++i) {
      const int row = base + 32 * kWarps * i + lane;
      key[i] = row < end ? __ldg(L.node + row) : -1;
    }
#pragma unroll
    for (int i = 0; i < kStatsUnroll; ++i) {
      const int row = base + 32 * kWarps * i + lane;
      bool ok;
      int n;
      if (p.sub) {
        ok = (unsigned)key[i] < (unsigned)p.n_nodes && is_small_child(key[i], sil);
        n = key[i] >> 1;
      } else {
        ok = (unsigned)key[i] < (unsigned)p.n_acc;
        n = key[i];
      }
      const unsigned peers = __match_any_sync(kFull, ok ? n : -1);
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if (ok && lane == leader) pos = atomicAdd(cursor + n, __popc(peers));
      pos = __shfl_sync(kFull, pos, leader);
      if (ok) L.ids[pos + __popc(peers & ((1u << lane) - 1u))] = row;
    }
  }
}

// --------------------------------------------------------------------------
// Launch 3: accumulate, convert, subtract, scan
// --------------------------------------------------------------------------

// A tile's sums in shared memory: each component's window sums (low bits
// unsigned, the rest signed) and its int64 sums (the folded windows).
struct TileSums {
  unsigned* lo[2];
  int* hi[2];
  long long* acc[2];
};

__device__ __forceinline__ long long window_sum(unsigned lo, int hi) {
  return (long long)hi * (1LL << kLoBits) + (long long)lo;
}

// The tile's int64 sum of component k at cell c: the folded sums where the
// unit spanned several windows, else its one window's.
__device__ __forceinline__ long long tile_sum(const TileSums& T, bool folded, int k, int c) {
  return folded ? T.acc[k][c] : window_sum(T.lo[k][c], T.hi[k][c]);
}

// Each thread folds the window sums of the cells it owns into their int64
// sums and clears them (between two barriers: no atomic is in flight).
__device__ __forceinline__ void fold_window(const TileSums& T, int cells) {
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      T.acc[k][c] += window_sum(T.lo[k][c], T.hi[k][c]);
      T.lo[k][c] = 0u;
      T.hi[k][c] = 0;
    }
  }
}

// One rounded value into a cell: two native 32-bit shared atomics.
__device__ __forceinline__ void add_value(const TileSums& T, int k, int c, long long q) {
  atomicAdd(T.lo[k] + c, (unsigned)(q & ((1LL << kLoBits) - 1)));
  atomicAdd(T.hi[k] + c, (int)(q >> kLoBits));
}

// The rows at positions [w, w_end) of a unit into the tile's window sums:
// each thread adds features j0 .. j0 + nf - 1 of every rows_per_pass-th
// row from position w + slot on. A row's features are added from the
// thread's rotation on (kk[k] = (k + rot) % vec), so the rows of one warp
// step hit different shared-memory banks (a cell's feature slot is its
// lowest address bits). Positions past w_end load row w's data and add
// nothing, so the loads need no branch.
template <bool GROUPED, bool VEC, bool NONFINITE>
__device__ __forceinline__ void add_rows(const Level& L, const TileSums& T, const Grid& gq,
                                         const Grid& hq, const int* s_sil, int w, int w_end,
                                         int t, int f0, int j0, int nf, int slot, int rot,
                                         int rows_per_pass) {
  const Plan& p = L.p;
  constexpr int kUnroll = VEC ? kPassesVec : kPassesScalar;
  const int* bins = L.bins + f0 + j0;
  int kk[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) kk[k] = (k + rot) & (p.vec - 1);
  const int step = rows_per_pass * kUnroll;
  // the rows of a pass (grouped: the ids, loaded a pass ahead)
  const auto rows_at = [&](int r0, int* out) {
#pragma unroll
    for (int m = 0; m < kUnroll; ++m) {
      const int pos = r0 + m * rows_per_pass;
      const int q = pos < w_end ? pos : w;
      out[m] = GROUPED ? __ldg(L.ids + q) : q;
    }
  };
  int next[kUnroll];
  rows_at(w + slot, next);
  for (int r0 = w + slot; r0 < w_end; r0 += step) {
    int row[kUnroll], key[kUnroll];
    int4 bv[kUnroll];
    float gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int m = 0; m < kUnroll; ++m) row[m] = next[m];
    if (r0 + step < w_end) rows_at(r0 + step, next);
#pragma unroll
    for (int m = 0; m < kUnroll; ++m) {
      // a lane past the group's features reads the group's first (in bounds)
      const int* src = (nf > 0 ? bins : L.bins + f0) + (size_t)row[m] * p.F;
      if (VEC) {
        bv[m] = __ldg(reinterpret_cast<const int4*>(src));
      } else {
        bv[m].x = nf > 0 ? __ldg(src) : -1;
        bv[m].y = nf > 1 ? __ldg(src + 1) : -1;
        bv[m].z = nf > 2 ? __ldg(src + 2) : -1;
        bv[m].w = nf > 3 ? __ldg(src + 3) : -1;
      }
      gv[m] = __ldg(L.grad + row[m]);
      hv[m] = __ldg(L.hess + row[m]);
      key[m] = GROUPED ? 0 : __ldg(L.node + row[m]);
    }
#pragma unroll
    for (int m = 0; m < kUnroll; ++m) {
      bool ok = r0 + m * rows_per_pass < w_end && nf > 0;
      int nd = 0;
      if (!GROUPED) {
        if (p.sub) {
          ok = ok && (unsigned)key[m] < (unsigned)p.n_nodes && is_small_child(key[m], s_sil);
          nd = key[m] >> 1;
        } else {
          ok = ok && (unsigned)key[m] < (unsigned)p.n_acc;
          nd = key[m];
        }
      }
      if (!ok) continue;
      int4 v = bv[m];  // rotated: v[k] is feature j0 + kk[k]
      if (p.vec == kVec) {
        if (rot & 2) {
          const int x = v.x, y = v.y;
          v.x = v.z; v.y = v.w; v.z = x; v.w = y;
        }
        if (rot & 1) {
          const int x = v.x;
          v.x = v.y; v.y = v.z; v.z = v.w; v.w = x;
        }
      } else if (rot) {  // vec == 2
        const int x = v.x;
        v.x = v.y; v.y = x;
      }
      const int b4[kVec] = {v.x, v.y, v.z, v.w};
      const bool gf = !NONFINITE || isfinite(gv[m]);
      const bool hf = !NONFINITE || isfinite(hv[m]);
      const long long qg = gf ? quantize(gv[m], gq) : 0;
      const long long qh = hf ? quantize(hv[m], hq) : 0;
      const int cb = (nd * p.B << p.slots_shift) + j0;  // cell of (nd, bin 0, feature j0)
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (k >= p.vec) break;
        const int b = b4[k];
        // bins out of range add nothing (the TPU kernel's all-zero one-hot rows)
        if ((unsigned)b >= (unsigned)p.B) continue;
        const int c = cb + (b << p.slots_shift) + kk[k];
        if (gf) add_value(T, 0, c, qg);
        if (hf) add_value(T, 1, c, qh);
        if (NONFINITE && !(gf && hf)) {
          const size_t cell =
              ((size_t)((GROUPED ? t : 0) + nd) * p.F + f0 + j0 + kk[k]) * p.B + b;
          if (!gf) flag_or(L.flags, cell, nonfinite_bits(gv[m]));
          if (!hf) flag_or(L.flags, cell, nonfinite_bits(hv[m]) << 4);
        }
      }
    }
  }
}

// The float32 histogram of tile (t, fg) from its int64 sums (sum(k, c):
// shared memory, or device memory where the tile split); by subtraction
// also the sibling, parent - small. Every thread of the block.
template <typename Sum>
__device__ void finish_tile(const Level& L, Sum sum, int t, int fg, const Grid& gq,
                            const Grid& hq, bool nonfinite, const int* s_sil) {
  const Plan& p = L.p;
  const int f0 = fg * p.fg;
  const int fgw = min(p.fg, p.F - f0);
  const int node_base = p.grouped ? t : 0;
  for (int c = threadIdx.x; c < p.tile_cells; c += blockDim.x) {
    const int j = c & (p.slots - 1), r = c / p.slots;  // cell c: (node, bin, feature slot)
    const int b = r % p.B, nd = r / p.B;
    if (j >= fgw) continue;
    float vg = unquantize(sum(0, c), gq.e), vh = unquantize(sum(1, c), hq.e);
    const int n = node_base + nd, f = f0 + j;
    const size_t cell = ((size_t)n * p.F + f) * p.B + b;
    if (nonfinite) {
      const unsigned bits = flag_bits(L.flags, cell);
      vg = with_flags(vg, bits & 7u);
      vh = with_flags(vh, bits >> 4);
    }
    const float2 small = make_float2(vg, vh);
    if (!p.sub) {
      L.hist[cell] = small;
    } else {
      const float2 par = L.parent[cell];
      const float2 big = make_float2(par.x - vg, par.y - vh);
      const int left = s_sil[n];
      L.hist[((size_t)(2 * n) * p.F + f) * p.B + b] = left ? small : big;
      L.hist[((size_t)(2 * n + 1) * p.F + f) * p.B + b] = left ? big : small;
    }
  }
}

template <bool GROUPED, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) level_accumulate(Level L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = L.p;
  int* s_start = reinterpret_cast<int*>(smem);          // grouped: (n_acc + 1,)
  int* s_unit = s_start + (GROUPED ? p.n_acc + 1 : 0);  // grouped: (n_acc + 1,)
  int* s_sil = s_unit + (GROUPED ? p.n_acc + 1 : 0);    // subtraction: (n_acc,)
  int* s_tmp = reinterpret_cast<int*>(smem) + p.plan_ints;  // 64 ints
  float* s_gain = reinterpret_cast<float*>(s_tmp + 64);    // 32
  int* s_idx = reinterpret_cast<int*>(s_gain + 32);         // 32
  TileSums T;
  {
    const int n = p.tile_cells;
    unsigned* lo = reinterpret_cast<unsigned*>(
        smem + ((size_t)(p.plan_ints + 128) * 4 + 15) / 16 * 16);
    T.lo[0] = lo;
    T.hi[0] = reinterpret_cast<int*>(lo + n);
    T.lo[1] = lo + 2 * n;
    T.hi[1] = reinterpret_cast<int*>(lo + 3 * n);
    // present where a unit can span several windows (kFoldedCellBytes)
    T.acc[0] = reinterpret_cast<long long*>(lo + 4 * n);
    T.acc[1] = T.acc[0] + n;
  }
  const int tid = threadIdx.x;

  Grid gq, hq;
  const bool nonfinite =
      reduce_stats(L, &gq, &hq, reinterpret_cast<unsigned*>(s_tmp)) != 0u;
  // the plan of the units: grouped, each node's range and its units' offsets
  int n_units;
  if (GROUPED) {
    for (int n = tid; n <= p.n_acc; n += blockDim.x) s_start[n] = __ldcg(L.starts + n);
    if (p.sub)
      for (int n = tid; n < p.n_acc; n += blockDim.x) s_sil[n] = __ldcg(L.sil + n);
    __syncthreads();
    for (int n = tid; n < p.n_acc; n += blockDim.x)
      s_unit[n] = tile_chunks(s_start[n + 1] - s_start[n], p.chunk_rows) * p.n_fg;
    __syncthreads();
    n_units = block_exclusive_scan(s_unit, p.n_acc, s_tmp);
    if (tid == 0) s_unit[p.n_acc] = n_units;
    __syncthreads();
  } else {
    if (p.sub) {
      for (int n = tid; n < p.n_acc; n += blockDim.x) {
        int left_rows = 0, right_rows = 0;
        for (int b = 0; b < p.P; ++b) {
          left_rows += __ldcg(L.counts + (size_t)b * p.n_cnt + 2 * n);
          right_rows += __ldcg(L.counts + (size_t)b * p.n_cnt + 2 * n + 1);
        }
        s_sil[n] = L.sil_in ? L.sil_in[n] != 0 : left_rows <= right_rows;
      }
      __syncthreads();
    }
    n_units = p.n_chunks * p.n_fg;
  }

  // a row's features go to 1 << lpr_shift lanes, vec features a lane
  const int lanes = 1 << p.lpr_shift;
  const int j0 = (tid & (lanes - 1)) * p.vec;  // this thread's first feature in the group
  const int slot = tid >> p.lpr_shift;         // its row within a pass
  const int rot = ((tid & 31) >> p.lpr_shift) & (p.vec - 1);
  const int rows_per_pass = kThreads >> p.lpr_shift;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    int t, fg, n_ch, lo, hi;  // rows [lo, hi) of the grouped ids (or of the rows)
    if (GROUPED) {
      int a = 0, z = p.n_acc;  // the last tile whose first unit is <= u
      while (z - a > 1) {
        const int m = (a + z) >> 1;
        if (s_unit[m] <= u) a = m; else z = m;
      }
      t = a;
      const int local = u - s_unit[t];
      fg = local % p.n_fg;
      const int k = local / p.n_fg;
      const long long rows = s_start[t + 1] - s_start[t];
      n_ch = tile_chunks((int)rows, p.chunk_rows);
      lo = s_start[t] + (int)(rows * k / n_ch);
      hi = s_start[t] + (int)(rows * (k + 1) / n_ch);
    } else {
      t = 0;
      fg = u % p.n_fg;
      const int k = u / p.n_fg;
      n_ch = p.n_chunks;
      lo = (int)((long long)p.R * k / n_ch);
      hi = (int)((long long)p.R * (k + 1) / n_ch);
    }
    const int f0 = fg * p.fg;
    // the features of each row this thread adds (VEC: 0 or kVec)
    const int nf = max(0, min(p.vec, min(p.fg, p.F - f0) - j0));
    const bool folded = hi - lo > kWindowRows;  // several windows: int64 sums kept
    __syncthreads();  // the previous unit is done with the shared sums
    for (int c = tid; c < p.tile_cells; c += blockDim.x) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        T.lo[k][c] = 0u;
        T.hi[k][c] = 0;
        if (folded) T.acc[k][c] = 0;
      }
    }
    __syncthreads();

    for (int w = lo; w < hi; w += kWindowRows) {
      const int w_end = min(hi, w + kWindowRows);
      if (nonfinite)
        add_rows<GROUPED, VEC, true>(L, T, gq, hq, s_sil, w, w_end, t, f0, j0, nf, slot, rot,
                                     rows_per_pass);
      else
        add_rows<GROUPED, VEC, false>(L, T, gq, hq, s_sil, w, w_end, t, f0, j0, nf, slot, rot,
                                      rows_per_pass);
      if (folded) {
        __syncthreads();
        fold_window(T, p.tile_cells);
        __syncthreads();  // no add of the next window before every fold
      }
    }
    __syncthreads();

    // the tile's sums: this block's alone, or the last chunk's after every chunk's add
    bool finisher = true;
    long long* ag = nullptr;
    if (n_ch > 1) {
      ag = L.accum + (size_t)(t * p.n_fg + fg) * p.tile_cells * 2;
      for (int c = tid; c < p.tile_cells; c += blockDim.x) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const long long v = tile_sum(T, folded, k, c);
          if (v) atomicAdd(reinterpret_cast<unsigned long long*>(ag + k * p.tile_cells + c),
                           (unsigned long long)v);
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) s_tmp[0] = atomicAdd(L.ctrl + t * p.n_fg + fg, 1) == n_ch - 1;
      __syncthreads();
      finisher = s_tmp[0] != 0;
      __threadfence();
    }
    if (!finisher) continue;
    if (n_ch > 1) {
      const long long* a = ag;
      const int n = p.tile_cells;
      finish_tile(L, [a, n](int k, int c) { return __ldcg(a + k * n + c); }, t, fg, gq, hq,
                  nonfinite, s_sil);
    } else {
      finish_tile(L, [&T, folded](int k, int c) { return tile_sum(T, folded, k, c); }, t, fg,
                  gq, hq, nonfinite, s_sil);
    }
    if (L.feat_mask == nullptr) continue;  // the histogram alone

    // the split scan of the tile's nodes, once every feature group is written
    __threadfence();
    __syncthreads();
    if (p.n_fg > 1) {
      if (tid == 0) s_tmp[1] = atomicAdd(L.ctrl + p.n_tiles * p.n_fg + t, 1) == p.n_fg - 1;
      __syncthreads();
      if (!s_tmp[1]) continue;
      __threadfence();
    }
    const int first = p.grouped ? (p.sub ? 2 * t : t) : 0;
    const int count = p.grouped ? (p.sub ? 2 : 1) : p.n_nodes;
    for (int n = first; n < first + count; ++n)
      scan_node(L.hist, n, L.feat_mask, L.lam, L.mcw, L.bin_limit, p.F, p.B, L.best_gain,
                L.best_feat, L.best_split, s_gain, s_idx);
  }
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

// Every kernel opts into the device's whole shared memory, once a device,
// not into one launch's need: executor threads launch them at other shapes
// at the same time, and a limit set to one launch's size could be lowered
// by another thread between that set and this launch (CUDA error 1,
// invalid argument).
std::atomic<unsigned> g_opted_in[kMaxDevices];

cudaError_t opt_in(const void* kernel, unsigned bit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && (g_opted_in[dev].load(std::memory_order_acquire) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           repro::device_smem_optin());
  if (e == cudaSuccess && cached) g_opted_in[dev].fetch_or(bit, std::memory_order_acq_rel);
  return e;
}

template <bool GROUPED, bool VEC>
cudaError_t launch_accumulate(const Level& L, const Plan& p, cudaStream_t s) {
  const unsigned bit = 4u << (2 * GROUPED + VEC);
  const cudaError_t e = opt_in(reinterpret_cast<const void*>(level_accumulate<GROUPED, VEC>), bit);
  if (e != cudaSuccess) return e;
  level_accumulate<GROUPED, VEC><<<p.grid3, kThreads, p.smem3, s>>>(L);
  return cudaGetLastError();
}

// Carve the scratch and run the two or three launches of one level.
cudaError_t run_level(Level L, const Plan& p, void* scratch, cudaStream_t s) {
  unsigned char* base = static_cast<unsigned char*>(scratch);
  L.p = p;
  L.stats = reinterpret_cast<unsigned*>(base + p.off_stats);
  L.counts = reinterpret_cast<int*>(base + p.off_counts);
  L.ctrl = reinterpret_cast<int*>(base + p.off_ctrl);
  L.starts = reinterpret_cast<int*>(base + p.off_starts);
  L.sil = reinterpret_cast<int*>(base + p.off_sil);
  L.ids = reinterpret_cast<int*>(base + p.off_ids);
  L.accum = reinterpret_cast<long long*>(base + p.off_accum);
  L.flags = reinterpret_cast<unsigned*>(base + p.off_flags);
  cudaError_t e;
  if ((e = opt_in(reinterpret_cast<const void*>(level_stats), 1u))) return e;
  level_stats<<<p.P, kThreads, p.smem1, s>>>(L);
  if ((e = cudaGetLastError())) return e;
  if (p.grouped) {
    if ((e = opt_in(reinterpret_cast<const void*>(level_group), 2u))) return e;
    level_group<<<p.P, kThreads, p.smem2, s>>>(L);
    if ((e = cudaGetLastError())) return e;
  }
  // 16-byte loads of each thread's kVec features where every row's are aligned
  const bool vec = p.F % kVec == 0 && p.fg % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(L.bins) & 15u) == 0;
  if (p.grouped)
    return vec ? launch_accumulate<true, true>(L, p, s) : launch_accumulate<true, false>(L, p, s);
  return vec ? launch_accumulate<false, true>(L, p, s) : launch_accumulate<false, false>(L, p, s);
}

cudaError_t plan_for(int R, int F, int B, int n_nodes, int subtract, Plan* p) {
  if (R < 0 || F < 1 || B < 1 || n_nodes < 1 || (subtract && (n_nodes < 2 || n_nodes % 2)))
    return cudaErrorInvalidValue;
  DeviceInfo d;
  const cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return e;
  return make_plan(R, F, B, n_nodes, subtract, d, p) ? cudaSuccess : cudaErrorInvalidValue;
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

// Scratch bytes a level (or a histogram: subtract 0) of this shape needs on
// the current device; -1 where it cannot be planned (a node's bins do not
// fit a block's shared memory, or too many nodes).
long long repro_level_scratch(int R, int F, int B, int n_nodes, int subtract) {
  Plan p;
  return plan_for(R, F, B, n_nodes, subtract, &p) == cudaSuccess ? (long long)p.bytes : -1;
}

// Kernel launches a level of this shape makes: 3 where rows are grouped by
// node, else 2; -1 where it cannot be planned.
int repro_level_launches(int R, int F, int B, int n_nodes, int subtract) {
  Plan p;
  return plan_for(R, F, B, n_nodes, subtract, &p) == cudaSuccess ? (p.grouped ? 3 : 2) : -1;
}

// hist (n_nodes, F, B, 2) = per-(node, feature, bin) sums of grad and hess.
// Rows whose node is outside [0, n_nodes) (padding) add nothing. scratch:
// repro_level_scratch(R, F, B, n_nodes, 0) bytes. Returns the CUDA error.
int repro_histogram(const int* bins, const float* grad, const float* hess, const int* node,
                    void* scratch, float* hist, int R, int F, int B, int n_nodes,
                    void* stream) {
  Plan p;
  cudaError_t e = plan_for(R, F, B, n_nodes, 0, &p);
  if (e != cudaSuccess) return (int)e;
  Level L{};
  L.bins = bins;
  L.grad = grad;
  L.hess = hess;
  L.node = node;
  L.hist = reinterpret_cast<float2*>(hist);
  return (int)run_level(L, p, scratch, static_cast<cudaStream_t>(stream));
}

// One tree level. Direct mode (subtract == 0): node in [0, n_nodes).
// Subtraction mode: node holds each row's CHILD in [0, n_nodes), parent is
// the previous level's (n_nodes/2, F, B, 2) histogram; small_is_left[p]
// (null: the smaller child by row count, ties left) says which child of
// pair p is accumulated, the other is parent - small. Rows whose node is
// outside [0, n_nodes) add nothing. Writes hist (n_nodes, F, B, 2) and the
// per-node best split. scratch: repro_level_scratch(R, F, B, n_nodes,
// subtract) bytes. Returns the CUDA error.
int repro_level_split(const int* bins, const float* grad, const float* hess, const int* node,
                      const float* parent, const int* small_is_left, const int* feat_mask,
                      float lam, float mcw, int bin_limit, void* scratch, float* hist,
                      float* best_gain, int* best_feat, int* best_split, int R, int F, int B,
                      int n_nodes, int subtract, void* stream) {
  Plan p;
  cudaError_t e = plan_for(R, F, B, n_nodes, subtract, &p);
  if (e != cudaSuccess) return (int)e;
  Level L{};
  L.bins = bins;
  L.grad = grad;
  L.hess = hess;
  L.node = node;
  L.parent = reinterpret_cast<const float2*>(parent);
  L.sil_in = small_is_left;
  L.feat_mask = feat_mask;
  L.lam = lam;
  L.mcw = mcw;
  L.bin_limit = bin_limit;
  L.hist = reinterpret_cast<float2*>(hist);
  L.best_gain = best_gain;
  L.best_feat = best_feat;
  L.best_split = best_split;
  return (int)run_level(L, p, scratch, static_cast<cudaStream_t>(stream));
}

// The split scan alone, on a histogram (n_nodes, F, B, 2) the caller built
// (the row-sharded level: the shards' partial histograms summed in shard
// order). The same scan as repro_level_split's last launch. Returns the
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
      {"level_stats", reinterpret_cast<const void*>(level_stats)},
      {"level_group", reinterpret_cast<const void*>(level_group)},
      {"level_accumulate<grouped, 16-byte bins>",
       reinterpret_cast<const void*>(level_accumulate<true, true>)},
      {"level_accumulate<grouped>", reinterpret_cast<const void*>(level_accumulate<true, false>)},
      {"level_accumulate<one tile, 16-byte bins>",
       reinterpret_cast<const void*>(level_accumulate<false, true>)},
      {"level_accumulate<one tile>", reinterpret_cast<const void*>(level_accumulate<false, false>)},
      {"split_scan", reinterpret_cast<const void*>(split_scan)}};
  return repro::kernel_info(table, i, name, regs, local_bytes);
}

}  // extern "C"
