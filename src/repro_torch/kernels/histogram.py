"""GBDT split-finding hot path as hand-written CUDA kernels for Hopper.

The paper's dominant workload is gradient-boosted trees (864 of its 1,211
search tasks run XGBoost), and histogram construction is the per-level hot
spot of histogram-based GBDT training. The kernels live in
``csrc/histogram.cu`` (its header says what bounds them and how they stay
deterministic: g/h rounded to a power-of-two grid, int64 sums with integer
atomics); this module holds their ctypes wrappers:

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
failed, and adds one to its ``launches`` counter (a level is two or three
kernel launches: :func:`level_launches`). It takes CUDA tensors only: the
plain versions (``ops._histogram_scatter``, ``ref.*``) serve the CPU.
Oracles: :func:`repro_torch.kernels.ref.histogram_ref` /
:func:`repro_torch.kernels.ref.level_split_ref` /
:func:`repro_torch.kernels.ref.split_scan_ref`. Dispatch: ``ops.histogram``
/ ``ops.level_split`` / ``ops.split_scan``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, _launch

__all__ = ["histogram_cuda", "fused_level_split_cuda", "split_scan_cuda",
           "level_launches", "launch_counts", "reset_launch_counts"]

_NAMES = ("histogram", "level_split", "split_scan")


def launch_counts() -> dict[str, int]:
    """Launches of the three GBDT wrappers since the last
    :func:`reset_launch_counts` (``kernels.launch_counts`` has every kernel)."""
    return _launch.launch_counts(_NAMES)


def reset_launch_counts() -> None:
    _launch.reset_launch_counts(_NAMES)


@functools.lru_cache(maxsize=4096)
def _scratch_bytes(idx: int, r: int, f: int, n_bins: int, n_nodes: int, subtract: bool) -> int:
    with torch.cuda.device(idx):
        n = int(_build.load().repro_level_scratch(r, f, n_bins, n_nodes, int(subtract)))
    if n < 0:
        raise ValueError(f"a level of {n_nodes} nodes, {f} features and {n_bins} bins does "
                         "not fit the kernel's shared memory")
    return max(n, 16)


def _scratch(dev, r: int, f: int, n_bins: int, n_nodes: int, subtract: bool) -> torch.Tensor:
    """The kernels' scratch for one call: per-block maxima and node counts,
    counters, the grouped row ids and the int64 sums of tiles split over
    several blocks (``csrc/histogram.cu``: ``make_plan``)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch.empty(_scratch_bytes(idx, r, f, n_bins, n_nodes, bool(subtract)),
                       dtype=torch.uint8, device=dev)


def level_launches(n_rows: int, n_features: int, n_bins: int, n_nodes: int, *,
                   subtract: bool = False, device=None) -> int:
    """Kernel launches one level (or histogram) of this shape makes on the
    card: 3 where its rows are grouped by node, 2 where one tile holds
    every node (the root, the leaf sums)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    with torch.cuda.device(dev):
        n = int(_build.load().repro_level_launches(n_rows, n_features, n_bins, n_nodes,
                                                   int(subtract)))
    if n < 0:
        raise ValueError("this level does not fit the kernel's shared memory")
    return n


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


@functools.lru_cache(maxsize=64)
def _all_features(dev: torch.device, f: int) -> torch.Tensor:
    """The mask of every feature, made once a device and width (the kernels
    only read it)."""
    return torch.ones(f, dtype=torch.int32, device=dev)


def _feat_mask(feat_mask, f: int, dev) -> torch.Tensor:
    fm = (_all_features(dev, f) if feat_mask is None
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
    hist = torch.empty((n_nodes, f, n_bins, 2), dtype=torch.float32,
                       device=bins.device)
    with torch.cuda.device(bins.device):
        scratch = _scratch(bins.device, r, f, n_bins, n_nodes, False)
        err = _build.load().repro_histogram(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), node.data_ptr(),
            scratch.data_ptr(), hist.data_ptr(), r, f, n_bins, n_nodes,
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
    ``[0, n_nodes)``. Subtraction mode: ``node`` holds each row's CHILD in
    ``[0, n_nodes)`` as in direct mode, ``parent_hist`` the cached
    ``(n_nodes/2, F, B, 2)`` level-above histograms; the kernel accumulates
    the rows of one child of every sibling pair and takes the other as
    ``parent - small``. The child accumulated is the smaller one by row
    count, ties going left (the rule of ``ops._plan_smaller_child``),
    unless ``small_is_left`` (``(n_nodes/2,)``) names it. Rows whose node is
    outside ``[0, n_nodes)`` add nothing. ``lam``, ``min_child_weight`` and
    ``bin_limit`` are runtime kernel arguments. Returns ``(hist | None,
    best_gain, best_feat, best_split)``, the bests as (n_nodes,) tensors; an
    all-masked node gives ``(-inf, 0, 0)``.

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
    sil = None
    if subtract:
        _launch.check("parent_hist", parent_hist, torch.float32, (n_acc, f, n_bins, 2))
        if small_is_left is not None:
            sil = small_is_left.to(torch.int32).contiguous()
            _launch.check("small_is_left", sil, torch.int32, (n_acc,))
    fm = _feat_mask(feat_mask, f, dev)
    blim = n_bins if bin_limit is None else int(bin_limit)
    hist = torch.empty((n_nodes, f, n_bins, 2), dtype=torch.float32, device=dev)
    best_gain = torch.empty(n_nodes, dtype=torch.float32, device=dev)
    best_feat = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    best_split = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        scratch = _scratch(dev, r, f, n_bins, n_nodes, subtract)
        err = _build.load().repro_level_split(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), node.data_ptr(),
            parent_hist.data_ptr() if subtract else None,
            None if sil is None else sil.data_ptr(), fm.data_ptr(),
            float(lam), float(min_child_weight), blim,
            scratch.data_ptr(), hist.data_ptr(), best_gain.data_ptr(),
            best_feat.data_ptr(), best_split.data_ptr(),
            r, f, n_bins, n_nodes, int(subtract),
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
