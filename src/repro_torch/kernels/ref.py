"""Plain-PyTorch semantic oracles for the GBDT kernels.

Ports of ``histogram_ref``, ``split_scan_ref`` and ``level_split_ref`` from
the JAX package's ``kernels/ref.py``: one-hot contraction, cumsum, gain,
masked first argmax. They run on any device and define what the CUDA
kernels in ``csrc/histogram.cu`` must compute.
"""
from __future__ import annotations

import torch

__all__ = ["histogram_ref", "split_gains_ref", "split_scan_ref", "level_split_ref"]

#: largest (rows, F, B, 2) float32 one-hot block histogram_ref builds at once
_ONE_HOT_BYTES = 256 << 20


def histogram_ref(bins, grad, hess, node, n_nodes: int, n_bins: int):
    """Gradient/hessian histograms for GBDT split finding.

    bins: (rows, features) int32 in [0, n_bins); grad/hess: (rows,);
    node: (rows,) int32 in [0, n_nodes) — current tree-node of each row.
    Returns (n_nodes, features, n_bins, 2) f32 with [..., 0] = Σgrad and
    [..., 1] = Σhess over rows in that (node, feature-bin) cell. Out-of-range
    node or bin ids match no one-hot column and add nothing. Rows are
    contracted in blocks so the one-hot tensor stays bounded at any size.
    """
    r, f = bins.shape
    dev = bins.device
    out = torch.zeros((n_nodes, f, n_bins, 2), dtype=torch.float32, device=dev)
    step = max(1, _ONE_HOT_BYTES // max(1, f * n_bins * 8))
    node_ids = torch.arange(n_nodes, device=dev)
    bin_ids = torch.arange(n_bins, device=dev)
    for lo in range(0, r, step):
        sl = slice(lo, lo + step)
        node_oh = (node[sl, None] == node_ids).to(torch.float32)          # (R, N)
        bin_oh = (bins[sl, :, None] == bin_ids).to(torch.float32)         # (R, F, B)
        gh = torch.stack([grad[sl], hess[sl]], dim=-1).to(torch.float32)  # (R, 2)
        weighted = bin_oh[..., None] * gh[:, None, None, :]               # (R, F, B, 2)
        out += torch.einsum("rn,rfbt->nfbt", node_oh, weighted)
    return out


def split_gains_ref(hist, *, lam, min_child_weight, n_bins: int,
                    bin_limit=None, feat_mask=None):
    """Masked gain of every candidate split: (n_nodes, F, B), -inf where the
    split is not allowed. Node totals come from FEATURE 0's cumsum tail
    (every feature's bins sum to the same node total), even when feature 0
    is masked."""
    gl = torch.cumsum(hist[..., 0], dim=-1)             # (N, F, B) left sums
    hl = torch.cumsum(hist[..., 1], dim=-1)
    gt = gl[:, :1, -1:]                                  # (N, 1, 1) node totals
    ht = hl[:, :1, -1:]
    gr = gt - gl
    hr = ht - hl
    gain = gl**2 / (hl + lam) + gr**2 / (hr + lam) - gt**2 / (ht + lam)
    ok = (hl >= min_child_weight) & (hr >= min_child_weight)
    if feat_mask is not None:
        ok &= torch.as_tensor(feat_mask, device=hist.device).to(torch.bool)[None, :, None]
    # splitting at the last bin sends every row left — not a real split
    last = n_bins - 1 if bin_limit is None else bin_limit - 1
    ok &= torch.arange(n_bins, device=hist.device)[None, None, :] < last
    return torch.where(ok, gain, torch.full_like(gain, -torch.inf))


def split_scan_ref(hist, *, lam, min_child_weight, n_bins: int,
                   bin_limit=None, feat_mask=None):
    """Best-split scan over one level's histograms: cumsum → gain → masked
    argmax. ``hist``: (n_nodes, F, B, 2); returns per-node
    ``(best_gain, best_feat, best_split)``.

    This is also the scan half of the CPU path of ``ops.level_split``. A
    node whose every candidate is masked gets ``(-inf, 0, 0)``, the first
    argmax over -inf.
    """
    n_nodes, f = hist.shape[0], hist.shape[1]
    gain = split_gains_ref(hist, lam=lam, min_child_weight=min_child_weight,
                           n_bins=n_bins, bin_limit=bin_limit,
                           feat_mask=feat_mask)
    flat = gain.reshape(n_nodes, f * n_bins)
    best = torch.argmax(flat, dim=-1)                    # first max wins ties
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    feat = torch.div(best, n_bins, rounding_mode="floor").to(torch.int32)
    split = (best % n_bins).to(torch.int32)
    return best_gain, feat, split


def level_split_ref(bins, grad, hess, node, n_nodes: int, n_bins: int, *,
                    lam, min_child_weight, bin_limit=None, feat_mask=None):
    """One GBDT tree level end to end: histogram build + best-split scan.

    The oracle for the fused level kernel — always the DIRECT formulation
    (no histogram subtraction): subtraction is an implementation strategy
    whose result must match this definition. Returns
    ``(hist, best_gain, best_feat, best_split)``.
    """
    hist = histogram_ref(bins, grad, hess, node, n_nodes, n_bins)
    best_gain, feat, split = split_scan_ref(
        hist, lam=lam, min_child_weight=min_child_weight, n_bins=n_bins,
        bin_limit=bin_limit, feat_mask=feat_mask)
    return hist, best_gain, feat, split
