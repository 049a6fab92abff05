"""GBDT split-finding hot path as hand-written CUDA kernels for Hopper.

The paper's dominant workload is gradient-boosted trees (864 of its 1,211
search tasks run XGBoost), and histogram construction is the per-level hot
spot of histogram-based GBDT training. The kernels live in
``csrc/histogram.cu`` (its header says what bounds them and how they stay
deterministic); this module holds their ctypes wrappers:

* :func:`histogram_cuda` — per-(node, feature, bin) grad/hess sums, the
  port of the JAX package's ``histogram_tpu``;
* :func:`fused_level_split_cuda` — one tree level: the same sums, the
  histogram-subtraction assembly and the split scan, the port of
  ``fused_level_split_tpu``;
* :func:`split_scan_cuda` — that kernel's split scan alone, on a histogram
  the caller built: the row-sharded level (``ops.level_split`` with a shard
  axis) scans its shards' summed histograms with it.

Each wrapper checks its tensors, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream, raises if the launch
failed, and adds one to its ``launches`` counter. It takes CUDA tensors
only: the plain versions (``ops._histogram_scatter``, ``ref.*``) serve the
CPU. Oracles: :func:`repro_torch.kernels.ref.histogram_ref` /
:func:`repro_torch.kernels.ref.level_split_ref` /
:func:`repro_torch.kernels.ref.split_scan_ref`. Dispatch: ``ops.histogram``
/ ``ops.level_split`` / ``ops.split_scan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["histogram_cuda", "fused_level_split_cuda", "split_scan_cuda",
           "launch_counts", "reset_launch_counts"]

#: cap on the partial histograms pass 1 writes and pass 2 reads back
_PARTIAL_BYTES_CAP = 64 << 20
#: fewest rows worth a row chunk of their own
_MIN_CHUNK_ROWS = 1024
_MAX_GRID_DIM = 65535
#: cost of a row that a node tile skips, against one it adds: a skipped row
#: costs its node's 4 bytes and a lane's test, an added one its bins' copy
#: and the adds
_SKIP_COST = 0.05

_device_info: dict[int, tuple[int, int]] = {}
_tilings: dict[tuple, tuple[int, int]] = {}
_NAMES = ("histogram", "level_split", "split_scan")


def launch_counts() -> dict[str, int]:
    """Launches of the three GBDT wrappers since the last
    :func:`reset_launch_counts` (``kernels.launch_counts`` has every kernel)."""
    return _launch.launch_counts(_NAMES)


def reset_launch_counts() -> None:
    _launch.reset_launch_counts(_NAMES)


def _sm_count_and_smem(idx: int) -> tuple[int, int]:
    if idx not in _device_info:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _device_info[idx] = (sms, int(_build.load().repro_smem_optin(idx)))
    return _device_info[idx]


def _node_tiling(idx: int, n_features: int, n_bins: int, n_acc: int) -> tuple[int, int]:
    """``(nodes_per_tile, features_per_block)`` of pass 1 for ``n_acc`` nodes.

    A pass-1 block fills one SM's shared memory with private histograms,
    one per warp, of B·8 bytes per node and feature (up to 32 features, or
    16 where that doubles the warps), so the more nodes a tile holds, the
    fewer warps run. Each tile reads the node array again (and the bins of
    its own rows only), while each added warp hides more of the rows'
    copies and shared-memory round trips. The tiling taken minimises
    (1 + _SKIP_COST · tiles) / warps."""
    key = (idx, n_features, n_bins, n_acc)
    if key not in _tilings:
        lib = _build.load()
        _, smem_optin = _sm_count_and_smem(idx)
        best = None
        for npt in sorted({-(-n_acc // t) for t in range(1, n_acc + 1)}, reverse=True):
            group = ctypes.c_int()
            warps = int(lib.repro_accumulate_warps(n_features, n_bins, npt, smem_optin,
                                                   ctypes.byref(group)))
            if warps < 1:
                continue
            cost = (1 + _SKIP_COST * -(-n_acc // npt)) / warps
            if best is None or cost < best[0]:
                best = (cost, npt, group.value)
        if best is None:
            raise ValueError(f"n_bins={n_bins} does not fit one node's histograms "
                             f"in {smem_optin} bytes of shared memory")
        _tilings[key] = best[1:]
    return _tilings[key]


def _plan(device, n_rows: int, n_features: int, n_bins: int, n_acc: int):
    """Launch shape of pass 1: ``(n_chunks, chunk_rows, nodes_per_tile)``.

    Nodes are tiled by :func:`_node_tiling`. A block fills one SM, so row
    chunks make one block per SM over the (node tile, feature group) pairs,
    but never so many that the partials pass the cap, nor chunks under
    ``_MIN_CHUNK_ROWS``."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms, _ = _sm_count_and_smem(idx)
    nodes_per_tile, group = _node_tiling(idx, n_features, n_bins, n_acc)
    if n_rows == 0:
        return 0, 0, nodes_per_tile
    n_tiles = -(-n_acc // nodes_per_tile)
    n_groups = -(-n_features // group)
    n_chunks = -(-sms // (n_groups * n_tiles))
    n_chunks = min(n_chunks, -(-n_rows // _MIN_CHUNK_ROWS), _MAX_GRID_DIM,
                   max(1, _PARTIAL_BYTES_CAP // (n_acc * n_features * n_bins * 8)))
    n_chunks = max(1, n_chunks)
    chunk_rows = -(-n_rows // n_chunks)
    return -(-n_rows // chunk_rows), chunk_rows, nodes_per_tile


def _check_rows(bins, grad, hess, node):
    if bins.dim() != 2:
        raise ValueError(f"bins must be (rows, features), got shape {tuple(bins.shape)}")
    r, f = bins.shape
    _launch.check("bins", bins, torch.int32, (r, f))
    _launch.check("grad", grad, torch.float32, (r,))
    _launch.check("hess", hess, torch.float32, (r,))
    _launch.check("node", node, torch.int32, (r,))
    for t in (grad, hess, node):
        if t.device != bins.device:
            raise ValueError("bins, grad, hess and node must share one device")
    if f < 1:
        raise ValueError("bins needs at least one feature")
    return r, f


def _feat_mask(feat_mask, f: int, dev) -> torch.Tensor:
    fm = (torch.ones(f, dtype=torch.int32, device=dev) if feat_mask is None
          else torch.as_tensor(feat_mask, device=dev).to(torch.int32).contiguous())
    _launch.check("feat_mask", fm, torch.int32, (f,))
    return fm


@_launch.counted("histogram")
def histogram_cuda(bins, grad, hess, node, *, n_nodes: int, n_bins: int):
    """Per-(node, feature, bin) grad/hess sums on the card; see
    ``ref.histogram_ref``. bins: (R, F) int32 in [0, n_bins); grad, hess:
    (R,) float32; node: (R,) int32 in [0, n_nodes], where n_nodes marks a
    padding row that adds nothing. Returns (n_nodes, F, n_bins, 2) float32."""
    r, f = _check_rows(bins, grad, hess, node)
    if n_nodes < 1 or n_bins < 1:
        raise ValueError("n_nodes and n_bins must be >= 1")
    n_chunks, chunk_rows, npt = _plan(bins.device, r, f, n_bins, n_nodes)
    partial = torch.empty((max(n_chunks, 1), n_nodes, f, n_bins, 2),
                          dtype=torch.float32, device=bins.device)
    hist = torch.empty((n_nodes, f, n_bins, 2), dtype=torch.float32,
                       device=bins.device)
    with torch.cuda.device(bins.device):
        err = _build.load().repro_histogram(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), node.data_ptr(),
            partial.data_ptr(), hist.data_ptr(), r, f, n_bins, n_nodes,
            n_chunks, chunk_rows, npt,
            torch.cuda.current_stream(bins.device).cuda_stream)
    _launch.raise_on(err, "histogram kernel launch")
    _launch.count(histogram_cuda)
    return hist


@_launch.counted("level_split")
def fused_level_split_cuda(bins, grad, hess, node, *, n_nodes: int, n_bins: int,
                           lam, min_child_weight, bin_limit=None,
                           feat_mask=None, parent_hist=None,
                           small_is_left=None, return_hist: bool = True):
    """One GBDT tree level on the card; see ``ref.level_split_ref``.

    Direct mode (``parent_hist=None``): ``node`` holds each row's node in
    ``[0, n_nodes)``. Subtraction mode: the caller (``ops.level_split``) has
    compacted the rows to the SMALLER child of every sibling pair, ``node``
    holds the PARENT id in ``[0, n_nodes/2)`` (padding: ``n_nodes/2``),
    ``parent_hist`` the cached ``(n_nodes/2, F, B, 2)`` level-above
    histograms and ``small_is_left[p]`` whether pair p's smaller child is the
    left one. ``lam``, ``min_child_weight`` and ``bin_limit`` are runtime
    kernel arguments. Returns ``(hist | None, best_gain, best_feat,
    best_split)``, the bests as (n_nodes,) tensors; an all-masked node gives
    ``(-inf, 0, 0)``.

    The kernel always writes the full histogram to device memory: the split
    scan reads it back from there. ``return_hist=False`` only leaves it out
    of the result (the TPU kernel also skips the write; here that is a
    ROADMAP follow-up).
    """
    r, f = _check_rows(bins, grad, hess, node)
    dev = bins.device
    subtract = parent_hist is not None
    if subtract and (n_nodes < 2 or n_nodes % 2):
        raise ValueError(f"subtraction needs an even n_nodes, got {n_nodes}")
    n_acc = n_nodes // 2 if subtract else n_nodes
    if n_acc < 1 or n_bins < 1:
        raise ValueError("n_nodes and n_bins must be >= 1")
    if subtract:
        _launch.check("parent_hist", parent_hist, torch.float32, (n_acc, f, n_bins, 2))
        if small_is_left is None:
            raise ValueError("subtraction needs small_is_left")
        sil = small_is_left.to(torch.int32).contiguous()
        _launch.check("small_is_left", sil, torch.int32, (n_acc,))
    fm = _feat_mask(feat_mask, f, dev)
    blim = n_bins if bin_limit is None else int(bin_limit)
    n_chunks, chunk_rows, npt = _plan(dev, r, f, n_bins, n_acc)
    partial = torch.empty((max(n_chunks, 1), n_acc, f, n_bins, 2),
                          dtype=torch.float32, device=dev)
    hist = torch.empty((n_nodes, f, n_bins, 2), dtype=torch.float32, device=dev)
    best_gain = torch.empty(n_nodes, dtype=torch.float32, device=dev)
    best_feat = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    best_split = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().repro_level_split(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), node.data_ptr(),
            parent_hist.data_ptr() if subtract else None,
            sil.data_ptr() if subtract else None, fm.data_ptr(),
            float(lam), float(min_child_weight), blim,
            partial.data_ptr(), hist.data_ptr(), best_gain.data_ptr(),
            best_feat.data_ptr(), best_split.data_ptr(),
            r, f, n_bins, n_nodes, int(subtract), n_chunks, chunk_rows, npt,
            torch.cuda.current_stream(dev).cuda_stream)
    _launch.raise_on(err, "level-split kernel launch")
    _launch.count(fused_level_split_cuda)
    return (hist if return_hist else None), best_gain, best_feat, best_split



@_launch.counted("split_scan")
def split_scan_cuda(hist, *, lam, min_child_weight, bin_limit=None, feat_mask=None):
    """Each node's best split of a histogram ``hist`` (n_nodes, F, B, 2)
    float32 on the card, by the split scan of :func:`fused_level_split_cuda`
    (see ``ref.split_scan_ref``). Returns ``(best_gain, best_feat,
    best_split)`` as (n_nodes,) tensors; an all-masked node gives ``(-inf,
    0, 0)``."""
    if hist.dim() != 4 or hist.shape[-1] != 2:
        raise ValueError(f"hist must be (n_nodes, F, B, 2), got {tuple(hist.shape)}")
    n_nodes, f, n_bins, _ = hist.shape
    _launch.check("hist", hist, torch.float32, (n_nodes, f, n_bins, 2))
    dev = hist.device
    fm = _feat_mask(feat_mask, f, dev)
    blim = n_bins if bin_limit is None else int(bin_limit)
    best_gain = torch.empty(n_nodes, dtype=torch.float32, device=dev)
    best_feat = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    best_split = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().repro_split_scan(
            hist.data_ptr(), fm.data_ptr(), float(lam), float(min_child_weight), blim,
            best_gain.data_ptr(), best_feat.data_ptr(), best_split.data_ptr(),
            n_nodes, f, n_bins, torch.cuda.current_stream(dev).cuda_stream)
    _launch.raise_on(err, "split-scan kernel launch")
    _launch.count(split_scan_cuda)
    return best_gain, best_feat, best_split
