"""Level-wise histogram trees, worked out again in float64: what each
split of a fitted tree should have been, and what each leaf should hold.

The trees the program returns are complete binary trees in heap order:
``feat`` and ``thresh`` (2^D - 1,) per tree, ``leaves`` (2^D,). A node
that does not split carries the threshold +inf, so every row goes left.
A split's bin is recovered from its threshold: the threshold is one of the
reference's own float32 edges of that feature, and the split sends a row
right when its code is above that edge's index.

:func:`check_tree` follows a tree level by level from given row statistics
(g, h): at each level it builds the (node, feature, bin) sums of the rows
routed there by the tree's own splits above, scores every candidate split
by the gain ``GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam)`` (a candidate
is valid where both children hold at least ``min_child_weight`` of h, its
feature is in the tree's feature set, and its bin is below the last), and
measures how far the tree's split lies below the best, in units of what
that gain is the difference of: the children's scores ``GL^2/(HL+lam) +
GR^2/(HR+lam)`` of the best split (its gain plus the node's own score),
as float32 rounding scales with them. It then sums each leaf's rows and
compares the tree's leaf values with the leaf formula, in units of the
leaf's value (or of the tree's median leaf, where that is larger).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

#: a threshold that is not one of the reference's edges of its feature
BAD_SPLIT = -1


def split_bins(feat: torch.Tensor, thresh: torch.Tensor, edges32: torch.Tensor,
               n_bins: int) -> torch.Tensor:
    """(..., nodes) int64 split bins of trees given by ``feat``/``thresh``:
    ``n_bins - 1`` where the threshold is +inf (no split), the index of the
    edge equal to the threshold otherwise, :data:`BAD_SPLIT` where no edge
    of the feature equals it."""
    rows = edges32[feat.long()]                            # (..., nodes, B-1)
    t = thresh[..., None]
    idx = (rows < t).sum(-1)
    hit = torch.gather(rows, -1, torch.clamp(idx, max=rows.shape[-1] - 1)[..., None])[..., 0]
    found = (idx < rows.shape[-1]) & (hit == thresh)
    inf = torch.isinf(thresh) & (thresh > 0)
    out = torch.where(found, idx, torch.full_like(idx, BAD_SPLIT))
    return torch.where(inf, torch.full_like(idx, n_bins - 1), out)


def route_levels(codes: torch.Tensor, feat_t: torch.Tensor, split_t: torch.Tensor,
                 depth: int):
    """Yield each level's (level, node) row assignment, level-local node
    ids, and finally (depth, leaf index) of every row of ``codes`` (R, F)."""
    node = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    for level in range(depth):
        yield level, node
        g_idx = (1 << level) - 1 + node
        f = feat_t.long()[g_idx]
        b = torch.gather(codes, 1, f[:, None])[:, 0]
        node = 2 * node + (b.long() > split_t[g_idx]).long()
    yield depth, node


def leaf_index(codes, feat_t, split_t, depth: int) -> torch.Tensor:
    for _, node in route_levels(codes, feat_t, split_t, depth):
        pass
    return node


def histogram(codes_t: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
              node: torch.Tensor, n_nodes: int, n_bins: int,
              features: Sequence[int]) -> torch.Tensor:
    """(n_nodes, len(features), n_bins, 2) sums of g and h in g's dtype;
    ``codes_t`` is the (F, R) transposed codes."""
    out = torch.zeros((n_nodes, len(features), n_bins, 2), dtype=g.dtype, device=g.device)
    base = node * n_bins
    for i, f in enumerate(features):
        idx = base + codes_t[f].long()
        if g.dtype == torch.float64:
            out[:, i, :, 0] = torch.bincount(idx, g, minlength=n_nodes * n_bins).view(n_nodes, n_bins)
            out[:, i, :, 1] = torch.bincount(idx, h, minlength=n_nodes * n_bins).view(n_nodes, n_bins)
        else:                                   # the lower-precision control
            for k, v in ((0, g), (1, h)):
                acc = torch.zeros(n_nodes * n_bins, dtype=g.dtype, device=g.device)
                acc.index_add_(0, idx, v)
                out[:, i, :, k] = acc.view(n_nodes, n_bins)
    return out


def gains(hist: torch.Tensor, *, lam: float, min_child_weight: float,
          n_bins: int) -> torch.Tensor:
    """(N, F', B) gain of every candidate, -inf where it is not valid."""
    gl = torch.cumsum(hist[..., 0], dim=-1)
    hl = torch.cumsum(hist[..., 1], dim=-1)
    gt = gl[..., -1:]
    ht = hl[..., -1:]
    gr, hr = gt - gl, ht - hl
    gain = gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam) - gt ** 2 / (ht + lam)
    ok = (hl >= min_child_weight) & (hr >= min_child_weight)
    ok &= torch.arange(n_bins, device=hist.device) < n_bins - 1
    return torch.where(ok, gain, torch.full_like(gain, -torch.inf))


@dataclasses.dataclass
class TreeReading:
    split_gap: float     # widest gap of a split's gain below the best, scaled
                         # by the children's scores it was computed from
    leaf_err: float      # widest leaf-value error, scaled


def _scaled_max(gap: torch.Tensor, scale: torch.Tensor) -> float:
    """max(gap / max(scale, median of the positive scales))."""
    pos = scale[torch.isfinite(scale) & (scale > 0)]
    floor = float(pos.median()) if pos.numel() else 1.0
    denom = torch.clamp(torch.where(torch.isfinite(scale), scale, torch.zeros_like(scale)),
                        min=floor)
    return float((gap / denom).max()) if gap.numel() else 0.0


def check_tree(codes: torch.Tensor, codes_t: torch.Tensor, g: torch.Tensor,
               h: torch.Tensor, feat_t: torch.Tensor, split_t: torch.Tensor,
               leaves_t: torch.Tensor, *, depth: int, n_bins: int, lam: float,
               min_child_weight: float, gamma: float,
               features: Sequence[int], leaf_value: Callable) -> TreeReading:
    """Hold one tree (``feat_t``, ``split_t`` (2^D - 1,), ``leaves_t``
    (2^D,)) against the best splits and the leaf formula on statistics
    (g, h) (R,). ``features`` is the tree's feature set (a split on any
    other feature is invalid); ``leaf_value(G, H)`` the leaf formula."""
    dev = g.device
    f_index = torch.full((codes.shape[1],), -1, dtype=torch.int64, device=dev)
    f_index[torch.as_tensor(list(features), dtype=torch.int64, device=dev)] = torch.arange(
        len(features), device=dev)
    gaps, scales = [], []
    for level, node in route_levels(codes, feat_t, split_t, depth):
        if level == depth:
            break
        n = 1 << level
        hist = histogram(codes_t, g, h, node, n, n_bins, features).to(torch.float64)
        gain = gains(hist, lam=lam, min_child_weight=min_child_weight, n_bins=n_bins)
        best = gain.reshape(n, -1).amax(dim=1)                     # (N,)
        ids = torch.arange((1 << level) - 1, (1 << (level + 1)) - 1, device=dev)
        fi = f_index[feat_t.long()[ids]]
        s = split_t[ids]
        leaf_here = s == n_bins - 1
        usable = (fi >= 0) & (s >= 0) & ~leaf_here
        chosen = gain[torch.arange(n, device=dev), fi.clamp(min=0), s.clamp(0, n_bins - 1)]
        chosen = torch.where(usable, chosen, torch.full_like(chosen, -torch.inf))
        chosen = torch.where(leaf_here, torch.full_like(chosen, gamma), chosen)
        # a node left unsplit is sound where no valid split gains more than gamma
        gap = torch.where(leaf_here, torch.clamp(best - gamma, min=0.0), best - chosen)
        gap = torch.where(torch.isnan(gap), torch.full_like(gap, torch.inf), gap)
        gaps.append(gap)
        # what a split's gain is computed from: the children's scores, the
        # best gain plus the node's own score G^2 / (H + lam)
        gt, ht = hist[:, 0, :, 0].sum(-1), hist[:, 0, :, 1].sum(-1)
        scales.append(torch.where(torch.isfinite(best), best, torch.zeros_like(best))
                      + gt ** 2 / (ht + lam))
    leaf = node
    n_leaves = 1 << depth
    G = torch.bincount(leaf, g.to(torch.float64), minlength=n_leaves)
    H = torch.bincount(leaf, h.to(torch.float64), minlength=n_leaves)
    want = leaf_value(G, H)
    got = leaves_t.to(torch.float64)
    err = (got - want).abs()
    scale = want.abs()
    err = torch.where(torch.isnan(err), torch.full_like(err, torch.inf), err)
    return TreeReading(split_gap=_scaled_max(torch.cat(gaps), torch.cat(scales)),
                       leaf_err=_scaled_max(err, scale))


def raw_margins(x: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
                leaves: torch.Tensor, depth: int, base: float = 0.0,
                dtype=torch.float32) -> torch.Tensor:
    """``base`` plus each raw row's leaf value of every tree, added in tree
    order in ``dtype`` (float32, the configurations' precision): rows go
    right where their feature is above the split's float32 threshold."""
    r = x.shape[0]
    out = torch.zeros(r, dtype=dtype, device=x.device) + torch.tensor(base, dtype=dtype)
    for ft, tt, lt in zip(feat.long(), thresh, leaves.to(dtype)):
        local = torch.zeros(r, dtype=torch.int64, device=x.device)
        for level in range(depth):
            gi = (1 << level) - 1 + local
            xv = torch.gather(x, 1, ft[gi][:, None])[:, 0]
            local = 2 * local + (xv > tt[gi]).long()
        out = out + lt[local]
    return out


def grow_tree(codes: torch.Tensor, codes_t: torch.Tensor, g: torch.Tensor,
              h: torch.Tensor, *, depth: int, n_bins: int, lam: float,
              min_child_weight: float, gamma: float, features: Sequence[int]):
    """Grow one tree from statistics (g, h) in their own dtype, by the
    definition :func:`check_tree` holds trees to: the first best valid
    candidate of each node (features in ascending order, then bins), no
    split where it gains ``gamma`` or less. Returns ``(feat, split, leaf
    index of every row, G, H)`` with G and H the leaves' sums in g's
    dtype. This is the plain fit the controls run in a lower precision."""
    dev = g.device
    feats = torch.as_tensor(sorted(features), dtype=torch.int64, device=dev)
    feat_all, split_all = [], []
    node = torch.zeros(codes.shape[0], dtype=torch.int64, device=dev)
    for level in range(depth):
        n = 1 << level
        hist = histogram(codes_t, g, h, node, n, n_bins, feats.tolist())
        gain = gains(hist, lam=lam, min_child_weight=min_child_weight, n_bins=n_bins)
        flat = gain.reshape(n, -1)
        best = torch.argmax(flat, dim=1)
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        f = feats[torch.div(best, n_bins, rounding_mode="floor")]
        s = best % n_bins
        leaf = ~(best_gain > gamma)
        f = torch.where(leaf, torch.zeros_like(f), f)
        s = torch.where(leaf, torch.full_like(s, n_bins - 1), s)
        feat_all.append(f)
        split_all.append(s)
        b = torch.gather(codes, 1, f[node][:, None])[:, 0]
        node = 2 * node + (b.long() > s[node]).long()
    n_leaves = 1 << depth
    G = torch.zeros(n_leaves, dtype=g.dtype, device=dev).index_add_(0, node, g)
    H = torch.zeros(n_leaves, dtype=g.dtype, device=dev).index_add_(0, node, h)
    return torch.cat(feat_all), torch.cat(split_all), node, G, H


def thresholds(feat: torch.Tensor, split: torch.Tensor, edges32: torch.Tensor,
               n_bins: int) -> torch.Tensor:
    """Float32 thresholds of split bins: the split's edge, +inf for no split."""
    e = edges32[feat.long(), split.clamp(max=n_bins - 2)]
    return torch.where(split >= n_bins - 1, torch.full_like(e, torch.inf), e)
