"""Histogram-based gradient-boosted trees in PyTorch — stands in for XGBoost.

The paper runs XGBoost for 864 of its 1,211 search tasks; this is the
framework's dominant workload. We implement the ``hist`` algorithm: features
are quantile-binned once (the ``quantized_bins`` uniform-format conversion,
executor-side), then each boosting round grows one depth-``max_depth`` tree
level by level from per-(node, feature, bin) grad/hess histograms
(``ops.level_split`` — the hand-written CUDA level kernel on the card, the
scatter + scan plain path on the CPU — with histogram subtraction across
levels, DESIGN.md §3.8).

Trees are COMPLETE binary trees in heap layout: a node that stops splitting
gets a sentinel split (bin B−1 → every row routes left), so row→leaf routing
stays a fixed-shape gather chain. Training is a Python loop over rounds,
and each round a loop over levels, with every tensor on the data's device.
Hyperparameters follow XGBoost naming (eta, round, max_depth, max_bin,
lambda, gamma, min_child_weight).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import compat, tracing
from repro_torch.core.data_format import is_sharded_payload
from repro_torch.core.evaluation import stable_sigmoid
from repro_torch.core.interface import (
    Estimator,
    ResumeState,
    TrainedModel,
    register_estimator,
)
from repro_torch.device import default_device
from repro_torch.kernels import ops

__all__ = [
    "GBDTEstimator",
    "GBDTModel",
    "build_tree",
    "predict_margin",
    "predict_raw_margin",
    "batched_tree_margins",
    "model_from_reference",
]


def _f32(v) -> float:
    """A hyperparameter rounded to float32, as the reference passes it."""
    return float(np.float32(v))


def build_tree(
    bins: torch.Tensor,         # (R, F) int32 in [0, B)
    g: torch.Tensor,            # (R,) f32 gradients
    h: torch.Tensor,            # (R,) f32 hessians
    *,
    n_bins: int,
    max_depth: int,
    lam,
    gamma,
    min_child_weight,
    feat_mask=None,             # (F,) bool — forest feature subsets
    depth_limit=None,           # int: levels >= this force sentinels
    bin_limit=None,             # int: valid splits are < bin_limit - 1
    subtract: bool = True,      # histogram subtraction (DESIGN.md §3.8)
    force=None,                 # ops dispatch override, threaded to the kernel
    axis_name=None,             # ShardAxis: row-sharded data (DESIGN.md §3.9)
    row_valid=None,             # (S, Rs) bool — False on sharded pad rows
):
    """Grow one level-wise tree; returns (feat, split_bin, leaf_g, leaf_h).

    feat/split_bin: (2^D − 1,) heap-ordered internal nodes; sentinel split is
    ``split_bin == n_bins - 1`` (no row has bin > B−1, so all go left).
    leaf_g/leaf_h: (2^D,) per-leaf grad/hess sums for the caller's leaf-value
    formula (GBDT: −η·G/(H+λ); forest: −G/H = mean target).

    ``depth_limit``/``bin_limit`` let one padded shape serve configs with a
    shallower tree or a coarser quantisation (``train_batched``); levels at
    or past ``depth_limit`` are sentinels and launch nothing.

    Each level is one ``ops.level_split``. With ``subtract`` (the default)
    the level's histograms are cached and the NEXT level builds only the
    smaller child of each sibling pair, deriving the sibling as
    ``parent − small``. The leaf sums are one ``ops.histogram`` over a single
    all-zero bin column, so on the card they go through the deterministic
    histogram kernel rather than float atomics.

    With ``axis_name`` the rows arrive as shard blocks, ``bins`` (S, Rs, F)
    and ``g``/``h`` (S, Rs): every level's histogram and the leaf sums are
    the shards' partials summed in shard order (``ops.level_split`` and
    ``ops.histogram`` with the axis), so the tree does not depend on the
    shard count beyond those sums' rounding.
    """
    rows = bins.shape[:-1]
    dev = bins.device
    node = torch.zeros(rows, dtype=torch.int32, device=dev)   # level-local node
    feats, splits = [], []
    parent = None                            # previous level's histograms
    n_split = max_depth if depth_limit is None else min(max_depth, int(depth_limit))
    for level in range(n_split):
        n_nodes = 1 << level
        with tracing.span("level", thread_clock=True, level=level, nodes=n_nodes):
            keep_hist = subtract and level + 1 < n_split
            parent, best_gain, feat, split = ops.level_split(
                bins, g, h, node, n_nodes=n_nodes, n_bins=n_bins,
                lam=lam, min_child_weight=min_child_weight,
                bin_limit=bin_limit, feat_mask=feat_mask,
                parent_hist=parent if subtract else None,
                return_hist=keep_hist, force=force,
                axis_name=axis_name, row_valid=row_valid)
            is_leaf = best_gain <= gamma
            feat = torch.where(is_leaf, torch.zeros_like(feat), feat)
            # sentinel split: every row routes left
            split = torch.where(is_leaf, torch.full_like(split, n_bins - 1), split)
            feats.append(feat)
            splits.append(split)
            nl = node.long()
            row_bin = torch.gather(bins, -1, feat[nl].long()[..., None])[..., 0]
            node = 2 * node + (row_bin > split[nl]).to(torch.int32)
    leaf = ops.histogram(torch.zeros(rows + (1,), dtype=torch.int32, device=dev),
                         g, h, node, n_nodes=1 << n_split, n_bins=1, force=force,
                         axis_name=axis_name, row_valid=row_valid)
    leaf_g, leaf_h = leaf[:, 0, 0, 0], leaf[:, 0, 0, 1]
    pad = max_depth - n_split
    if pad:
        # levels past this config's own depth (a padded batch): sentinel
        # nodes, every row goes left, so leaf j of the unpadded tree is
        # leaf j << pad here and the leaf sums are the unpadded tree's
        for level in range(n_split, max_depth):
            feats.append(torch.zeros(1 << level, dtype=torch.int32, device=dev))
            splits.append(torch.full((1 << level,), n_bins - 1, dtype=torch.int32,
                                     device=dev))
        leaf_g, leaf_h = (torch.nn.functional.pad(v[:, None], (0, (1 << pad) - 1)).reshape(-1)
                          for v in (leaf_g, leaf_h))
    return torch.cat(feats), torch.cat(splits), leaf_g, leaf_h


def predict_margin(bins, feat, split, leaf_value, max_depth: int):
    """Route binned rows (..., F) through one heap-layout tree; returns the
    (...) margins."""
    local = torch.zeros(bins.shape[:-1], dtype=torch.int64, device=bins.device)
    for level in range(max_depth):
        g_idx = (1 << level) - 1 + local
        row_bin = torch.gather(bins, -1, feat[g_idx].long()[..., None])[..., 0]
        local = 2 * local + (row_bin > split[g_idx]).long()
    return leaf_value[local]


# --------------------------------------------------------------------------
# Device validation plane (DESIGN.md §3.4): raw-feature tree routing.
# --------------------------------------------------------------------------

def predict_raw_margin(x, feat, thresh, leaves, base, *, max_depth: int):
    """Margins of RAW rows through a whole heap-layout tree stack: a loop
    over the (rounds, ·) tree tensors, each level a gather + compare on
    ``x``'s device. Same float32 adds in the same tree order as the numpy
    ``GBDTModel.predict_margin``, so the two agree bit for bit. Sentinel
    splits carry ``thresh = +inf`` (``x > inf`` is False → every row routes
    left)."""
    r = x.shape[0]
    margin = torch.zeros(r, dtype=torch.float32, device=x.device) + base
    for tf, tt, tl in zip(feat, thresh, leaves):
        local = torch.zeros(r, dtype=torch.int64, device=x.device)
        for level in range(max_depth):
            g = (1 << level) - 1 + local
            xv = torch.gather(x, 1, tf[g][:, None])[:, 0]
            local = 2 * local + (xv > tt[g]).long()
        margin = margin + tl[local]
    return margin


def _tree_predict(depth: int):
    """The predict cache's program for one (depth, trees, B, x.shape)
    signature: each model's trees routed on ``x``'s device in tree order."""
    def predict(x, models) -> np.ndarray:
        out = np.empty((len(models), x.shape[0]), np.float32)
        for i, m in enumerate(models):
            feat = torch.tensor(np.asarray(m.feat, np.int64), device=x.device)
            thresh = torch.tensor(np.asarray(m.thresh, np.float32), device=x.device)
            leaves = torch.tensor(np.asarray(m.leaves, np.float32), device=x.device)
            base = torch.tensor(getattr(m, "base", 0.0), dtype=torch.float32,
                                device=x.device)
            out[i] = predict_raw_margin(x, feat, thresh, leaves, base,
                                        max_depth=depth).cpu().numpy()
        return out
    return predict


def batched_tree_margins(models, x, *, cache=None) -> np.ndarray:
    """(B, rows) margins for a stack of heap-layout tree models (GBDT with
    its base margin), each routed on the device holding ``x`` (numpy input
    goes to :func:`~repro_torch.device.default_device`). Models are grouped
    by depth, each group one program of the predict cache (``cache``,
    default :func:`~repro_torch.core.evaluation.predict_compile_cache`)
    under the reference's key ``("tree_predict", depth, pad_pow2(trees), B,
    x.shape)``."""
    from repro_torch.core.evaluation import predict_compile_cache
    from repro_torch.core.fusion import pad_pow2

    cache = cache if cache is not None else predict_compile_cache()
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, np.float32), device=default_device())
    x = x.to(torch.float32)
    out = np.empty((len(models), x.shape[0]), np.float32)
    groups: dict[int, list[int]] = {}
    for i, m in enumerate(models):
        groups.setdefault(int(m.max_depth), []).append(i)
    for depth, idxs in groups.items():
        pad_t = pad_pow2(max(np.asarray(models[i].feat).shape[0] for i in idxs))
        fn = cache.get(("tree_predict", depth, pad_t, len(idxs), tuple(x.shape)),
                       lambda depth=depth: _tree_predict(depth))
        out[idxs] = fn(x, [models[i] for i in idxs])
    return out


def _resume_gbdt_core(
    bins, y, margin0, factor, bin_limit, n_rounds, depth_limit,
    eta, lam, gamma, min_child_weight, start,
    *, n_bins: int, rounds: int, max_depth: int,
    subtract: bool = True, force=None, axis_name=None, row_valid=None,
):
    """Boost ``rounds`` MORE trees on top of a carried margin — the rung
    machinery (DESIGN.md §3.6) and, from a constant margin, a whole fit.
    Round indices continue from ``start`` and the final margin is returned
    alongside the trees (it IS the resume state: boosting's only carry is
    the ensemble margin), so rung-k-then-resume appends the exact trees a
    straight run would have grown. Rounds past ``n_rounds`` add zero-valued
    trees; levels past ``depth_limit`` force sentinel splits; bins past
    ``bin_limit`` never win. With ``axis_name`` the rows are shard blocks
    (see :func:`build_tree`) and the margin stays per shard, (S, Rs): it is
    row-local state."""
    cbins = bins if factor == 1 else torch.div(bins, factor, rounding_mode="floor")
    margin = margin0
    feats, splits, leaves = [], [], []
    for r_idx in range(start, start + rounds):
        with tracing.span("tree", index=r_idx):
            p = torch.sigmoid(margin)
            g = p - y
            h = torch.clamp_min(p * (1.0 - p), 1e-16)
            feat, split, leaf_g, leaf_h = build_tree(
                cbins, g, h, n_bins=n_bins, max_depth=max_depth,
                lam=lam, gamma=gamma, min_child_weight=min_child_weight,
                depth_limit=depth_limit, bin_limit=bin_limit,
                subtract=subtract, force=force,
                axis_name=axis_name, row_valid=row_valid)
            # an empty padded leaf is 0/(0+λ), NaN for λ=0: zero it by selection
            leaf_value = (-eta * leaf_g / (leaf_h + lam) if r_idx < n_rounds
                          else torch.zeros_like(leaf_g))
            margin = margin + predict_margin(cbins, feat, split, leaf_value, max_depth)
            feats.append(feat)
            splits.append(split)
            leaves.append(leaf_value)
    n_int, n_leaves = (1 << max_depth) - 1, 1 << max_depth
    if not feats:
        dev = bins.device
        return (torch.zeros((0, n_int), dtype=torch.int32, device=dev),
                torch.zeros((0, n_int), dtype=torch.int32, device=dev),
                torch.zeros((0, n_leaves), dtype=torch.float32, device=dev)), margin
    return (torch.stack(feats), torch.stack(splits), torch.stack(leaves)), margin


def _fit_gbdt_core(
    bins, y, base, factor, bin_limit, n_rounds, depth_limit,
    eta, lam, gamma, min_child_weight, *, n_bins: int, rounds: int,
    max_depth: int, subtract: bool = True, force=None, axis_name=None,
    row_valid=None,
):
    """One GBDT fit from the constant base margin; returns the trees
    ``(feat, split, leaf_value)`` as (rounds, ·) tensors."""
    margin0 = torch.full(bins.shape[:-1], base, dtype=torch.float32,
                         device=bins.device)
    trees, _ = _resume_gbdt_core(
        bins, y, margin0, factor, bin_limit, n_rounds, depth_limit,
        eta, lam, gamma, min_child_weight, 0, n_bins=n_bins, rounds=rounds,
        max_depth=max_depth, subtract=subtract, force=force,
        axis_name=axis_name, row_valid=row_valid)
    return trees


# --------------------------------------------------------------------------
# Sharded data plane (DESIGN.md §3.9): row-sharded fits.
#
# Inputs arrive block-stacked — bins (S, Rs, F), y (S, Rs), valid (S, Rs) —
# from ``core.data_format.shard_payload``. The cores run the SAME round
# program over the stacked blocks; the only cross-shard sums are inside
# ``ops.level_split`` (one histogram psum per level, plus one count psum
# for the global smaller-child plan) and the leaf-sum psums in
# ``build_tree``. The trees do not depend on the shard count; the resume
# margin stays per shard, (S, Rs).
# --------------------------------------------------------------------------

def run_core(core, data, *args, **kw):
    """``core(bins, y, *args, **kw)`` on a quantized payload, the tree
    families' cores' one entry: a sharded payload goes through
    ``compat.sharded_call``, with its shard axis and pad-row mask."""
    if not is_sharded_payload(data):
        return core(data["bins"], data["y"], *args, **kw)

    def per_shard(axis, bins, y, valid):
        return core(bins, y, *args, axis_name=axis, row_valid=valid, **kw)

    return compat.sharded_call(per_shard, n_shards=int(data["_n_shards"]))(
        data["bins"], data["y"], data["_shard_valid"])


class GBDTModel(TrainedModel):
    """Raw-feature predictor: thresholds are bin edges mapped back to floats."""

    def __init__(self, feat, thresh, leaves, base: float, max_depth: int):
        self.feat = np.asarray(feat)       # (rounds, 2^D − 1) int32
        self.thresh = np.asarray(thresh)   # (rounds, 2^D − 1) f32 (+inf = left)
        self.leaves = np.asarray(leaves)   # (rounds, 2^D) f32
        self.base = float(base)
        self.max_depth = max_depth

    def predict_margin(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        out = np.full((x.shape[0],), self.base, np.float32)
        for feat, thresh, leaves in zip(self.feat, self.thresh, self.leaves):
            local = np.zeros(x.shape[0], np.int64)
            for level in range(self.max_depth):
                g = (1 << level) - 1 + local
                local = 2 * local + (x[np.arange(x.shape[0]), feat[g]] > thresh[g])
            out += leaves[local]
        return out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return stable_sigmoid(self.predict_margin(x))

    # ---- device validation plane (DESIGN.md §3.4) -----------------------
    def predict_margin_device(self, x, *, cache=None) -> np.ndarray:
        """Device margins (loop over trees, gather per level); bit-identical
        to :meth:`predict_margin` — same float32 adds in the same tree
        order, sentinel thresholds route identically."""
        return batched_tree_margins([self], x, cache=cache)[0]

    def predict_proba_device(self, x, *, cache=None) -> np.ndarray:
        # same stable sigmoid as predict_proba over bit-identical margins,
        # so the device path scores EXACTLY what the numpy path would
        return stable_sigmoid(self.predict_margin_device(x, cache=cache))

    @classmethod
    def predict_margin_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return batched_tree_margins(models, x, cache=cache)

    @classmethod
    def predict_proba_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return stable_sigmoid(batched_tree_margins(models, x, cache=cache))


def model_from_reference(feat, thresh, leaves, base, max_depth) -> GBDTModel:
    """The port's model for tree arrays trained elsewhere, e.g. the
    ``feat``/``thresh``/``leaves``/``base``/``max_depth`` of a JAX-package
    ``GBDTModel``: both packages share the heap layout and threshold rule."""
    return GBDTModel(np.asarray(feat, np.int32), np.asarray(thresh, np.float32),
                     np.asarray(leaves, np.float32), float(base), int(max_depth))


@register_estimator
class GBDTEstimator(Estimator):
    name = "gbdt"
    data_format = "quantized_bins"
    budget_param = "round"

    def default_params(self) -> dict[str, Any]:
        return {
            "eta": 0.3, "round": 30, "max_depth": 6, "max_bin": 64,
            "lambda": 1.0, "gamma": 0.0, "min_child_weight": 1.0,
        }

    def format_params(self, params: Mapping[str, Any]) -> dict[str, Any]:
        """``max_bin`` is a CONVERTER parameter (§3.3): quantization happens
        at the config's own granularity, so each (dataset, max_bin) pair is
        one prepared-data cache entry shared by every config using it.
        ``_coarsen`` still handles data prepared at any finer granularity
        (factor > 1)."""
        p = {**self.default_params(), **params}
        return {"max_bins": int(p["max_bin"])}

    @staticmethod
    def _coarsen(n_bins: int, max_bin: int) -> tuple[int, int]:
        # Coarsen an n_bins-level quantisation to max_bin levels (identity
        # when the data was prepared at max_bin already, the §3.3 default):
        # coarse bin = fine bin // factor; coarse edge s = fine edge
        # (s+1)·factor − 1 (same "x > edge ⇔ bin > s" identity).
        factor = max(1, -(-n_bins // max_bin))
        return factor, -(-n_bins // factor)

    @staticmethod
    def _base_margin(data) -> float:
        # a sharded payload's (S, Rs) blocks, flattened and cut at the row
        # count: the unsharded label vector's values in its order, so the
        # prior (and the base margin) is the same bits
        y = data["y"].cpu().numpy().reshape(-1)
        if is_sharded_payload(data):
            y = y[: int(data["_n_rows"])]
        prior = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
        return float(np.log(prior / (1 - prior)))

    @staticmethod
    def _thresholds(feat_np, split_np, edges_np, factor: int, n_cbins: int):
        # Map split bins to float thresholds: coarse split s → fine edge index
        # (s+1)·factor − 1; sentinel (s ≥ n_cbins−1) or out-of-range → +inf.
        fine = (split_np + 1) * factor - 1
        in_range = (split_np < n_cbins - 1) & (fine < edges_np.shape[1])
        return np.where(
            in_range,
            edges_np[feat_np, np.minimum(fine, edges_np.shape[1] - 1)],
            np.float32(np.inf),
        ).astype(np.float32)

    @staticmethod
    def _hyper(p) -> tuple[float, float, float, float]:
        return (_f32(p["eta"]), _f32(p["lambda"]), _f32(p["gamma"]),
                _f32(p["min_child_weight"]))

    def _model(self, trees, edges, factor, n_cbins, base, max_depth) -> GBDTModel:
        feat, split, leaves = (t.cpu().numpy() for t in trees)
        thresh = self._thresholds(feat, split, edges.cpu().numpy(), factor, n_cbins)
        return GBDTModel(feat, thresh, leaves, base, max_depth)

    def train(self, data, params: Mapping[str, Any], *, force=None) -> GBDTModel:
        """``force`` pins the ops path end to end (``"ref"`` runs the
        oracles), for comparing the kernel path with the plain one."""
        p = {**self.default_params(), **params}
        factor, n_cbins = self._coarsen(int(data["n_bins"]), int(p["max_bin"]))
        max_depth, rounds = int(p["max_depth"]), int(p["round"])
        base = self._base_margin(data)
        trees = run_core(
            _fit_gbdt_core, data, _f32(base), factor, n_cbins, rounds, max_depth,
            *self._hyper(p), n_bins=n_cbins, rounds=rounds,
            max_depth=max_depth, force=force)
        return self._model(trees, data["edges"], factor, n_cbins, base, max_depth)

    # ---- adaptive search (DESIGN.md §3.6) -------------------------------
    def train_resumable(self, data, params: Mapping[str, Any], *,
                        budget: int, state: ResumeState | None = None):
        p = {**self.default_params(), **params}
        edges, y = data["edges"], data["y"]
        factor, n_cbins = self._coarsen(int(data["n_bins"]), int(p["max_bin"]))
        max_depth = int(p["max_depth"])
        base = self._base_margin(data)
        target = int(budget)
        if state is None:
            # a sharded margin is per-shard blocks, the layout of the labels,
            # so a resumed rung keeps its rows on their home shard
            start = 0
            margin0 = torch.full(y.shape, _f32(base), dtype=torch.float32,
                                 device=y.device)
            n_nodes, n_leaves = (1 << max_depth) - 1, 1 << max_depth
            prev_feat = np.zeros((0, n_nodes), np.int32)
            prev_thresh = np.zeros((0, n_nodes), np.float32)
            prev_leaves = np.zeros((0, n_leaves), np.float32)
        else:
            start = int(state.budget)
            pl = state.payload
            margin0 = torch.tensor(np.asarray(pl["margin"], np.float32),
                                   device=y.device)
            prev_feat, prev_thresh, prev_leaves = pl["feat"], pl["thresh"], pl["leaves"]
        if target > start:
            trees, margin0 = run_core(
                _resume_gbdt_core, data, margin0, factor, n_cbins, target, max_depth,
                *self._hyper(p), start, n_bins=n_cbins, rounds=target - start,
                max_depth=max_depth)
            m = self._model(trees, edges, factor, n_cbins, base, max_depth)
            prev_feat = np.concatenate([prev_feat, m.feat])
            prev_thresh = np.concatenate([prev_thresh, m.thresh])
            prev_leaves = np.concatenate([prev_leaves, m.leaves])
        model = GBDTModel(prev_feat, prev_thresh, prev_leaves, base, max_depth)
        new_state = ResumeState(self.name, max(target, start),
                                {"feat": prev_feat, "thresh": prev_thresh,
                                 "leaves": prev_leaves,
                                 "margin": margin0.cpu().numpy()})
        return model, new_state

    # ---- fused batches (core/fusion.py, DESIGN.md §3.2) -----------------
    def fuse_signature(self, params: Mapping[str, Any]):
        # max_bin is in the signature because it is a FORMAT parameter
        # (format_params): a fused batch converts once, so members must
        # share a prepared-data variant; rounds/depth still pad and mask.
        p = {**self.default_params(), **params}
        return ("gbdt", int(p["max_bin"]))

    def fuse_bucket(self, params: Mapping[str, Any]) -> tuple:
        from repro_torch.core.fusion import pad_pow2

        p = {**self.default_params(), **params}
        return (pad_pow2(int(p["round"])), int(p["max_depth"]))

    def train_batched(self, data, configs, *, cache=None) -> list[GBDTModel]:
        """One model per config, each grown through the batch's padded core:
        the depth and bin count pad to the batch maxima and each config's
        own ``depth_limit``/``bin_limit`` mask the rest, so every model has
        the batch's depth, as the reference's fused program gives. Each
        config runs its own round count: padded rounds come after the kept
        ones and cannot change them. The program comes from ``cache``
        (default the process-wide compile cache) under the reference's key,
        rounds and batch axis padded to powers of two."""
        from repro_torch.core import fusion

        ps = [{**self.default_params(), **c} for c in configs]
        n_bins = int(data["n_bins"])
        coarse = [self._coarsen(n_bins, int(p["max_bin"])) for p in ps]
        pad_bins = max((nc for _, nc in coarse), default=2)
        pad_rounds = fusion.pad_pow2(max(int(p["round"]) for p in ps))
        pad_depth = max((int(p["max_depth"]) for p in ps), default=1)
        key = ("gbdt", pad_bins, pad_rounds, pad_depth, len(fusion.pad_configs(ps)[0]),
               tuple(data["bins"].shape))
        if is_sharded_payload(data):
            key += (int(data["_n_shards"]),)
        cc = cache if cache is not None else fusion.compile_cache()
        fit = cc.get(key, lambda: self._batched_fit(pad_bins, pad_depth))
        return fit(data, ps, coarse)

    def _batched_fit(self, pad_bins: int, pad_depth: int):
        """The compile cache's program for one GBDT signature: every config
        boosted through the core at the batch's padded bins and depth."""
        def fit(data, ps, coarse):
            base = self._base_margin(data)
            models = []
            for p, (factor, n_cbins) in zip(ps, coarse):
                rounds = int(p["round"])
                trees = run_core(
                    _fit_gbdt_core, data, _f32(base), factor, n_cbins, rounds,
                    int(p["max_depth"]), *self._hyper(p), n_bins=pad_bins,
                    rounds=rounds, max_depth=pad_depth)
                models.append(self._model(trees, data["edges"], factor, n_cbins, base,
                                          pad_depth))
            return models
        return fit

    @staticmethod
    def estimate_cost(params: Mapping[str, Any], n_rows: int, n_features: int) -> float:
        """Analytic-profiler hook: histogram work dominates — R·F adds at
        the root, then histogram subtraction (DESIGN.md §3.8) builds only
        the smaller child per level, so every level below the root costs
        ~half: effective histogram levels = 1 + (D−1)/2 (plus split scans)."""
        p = {"round": 30, "max_depth": 6, "max_bin": 64, **dict(params)}
        depth = int(p["max_depth"])
        hist_levels = 1 + 0.5 * (depth - 1)
        per_tree = n_rows * n_features * hist_levels
        split_scan = (1 << depth) * n_features * int(p["max_bin"])
        return int(p["round"]) * (per_tree + split_scan) / 2e8
