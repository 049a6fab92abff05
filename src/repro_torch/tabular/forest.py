"""Random forest in PyTorch — stands in for scikit-learn's RandomForestClassifier.

Reuses the GBDT histogram tree builder (tabular/gbdt.py) with squared-error
statistics: with g = −y and h = 1 the split gain reduces to variance
reduction and the leaf value −G/H is the leaf's mean label, i.e. a
probability estimate. Per tree: a Poisson(1) bootstrap (as row weights
scaling g and h) and a random √F feature subset (as a gain mask). Tree
predictions are averaged.

Training is a Python loop over trees, each through ``build_tree`` (the
CUDA level kernel on the card). Tree t's draws come from
:mod:`repro_torch.tabular.draws`, seeded by (seed, t) alone, so resuming and
batching grow the same trees as one straight fit. g = −y·w and h = w are
integers, so every histogram sum is exact and the kernel and plain paths
grow bit-identical trees.

On a row-sharded payload (DESIGN.md §3.9) each tree draws its bootstrap
weights over the FULL row range, exactly as the unsharded fit does, and
slices them per shard; with integer g and h the cross-shard histogram sums
are exact too, so the sharded forest's trees, leaves included, are the
unsharded forest's bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.data_format import is_sharded_payload
from repro_torch.core.interface import (
    Estimator,
    ResumeState,
    TrainedModel,
    register_estimator,
)
from repro_torch.tabular.draws import forest_tree_draws
from repro_torch.tabular.gbdt import batched_tree_margins, build_tree, run_core

__all__ = ["ForestEstimator", "ForestModel"]

#: ``draws(t, device) -> (w, perm)``: tree t's bootstrap weights over the
#: full row range and feature permutation
TreeDraws = Callable[[int, torch.device], tuple[torch.Tensor, torch.Tensor]]


def _grow_forest(bins, y, draws: TreeDraws, min_samples_leaf, depth_limit, start,
                 *, n_bins: int, n_trees: int, max_depth: int, max_features: int,
                 subtract: bool = True, force=None, axis_name=None, row_valid=None):
    """Grow trees ``start .. start + n_trees``; returns ``(feat, split,
    leaf_value)`` as (n_trees, ·) tensors. Trees are independent and tree
    t's draws depend only on t, so a fit in pieces (resume) or beside other
    configs (batches) gives the trees of one straight fit. With
    ``axis_name`` the rows are shard blocks, ``bins`` (S, Rs, F): the
    draws' full (R,) weights are zero-padded to S·Rs and cut into the
    shards' blocks."""
    f = bins.shape[-1]
    dev = bins.device
    feats, splits, leaves = [], [], []
    for t in range(start, start + n_trees):
        with tracing.span("tree", index=t):
            with tracing.span("tree.draws"):
                w, perm = draws(t, dev)
            if axis_name is not None:
                w = torch.nn.functional.pad(w, (0, bins.shape[0] * bins.shape[1] - w.shape[0]))
                w = w.reshape(bins.shape[:-1])
            feat_mask = torch.zeros(f, dtype=torch.bool, device=dev)
            feat_mask[perm[:max_features]] = True
            g = -y * w
            h = w
            feat, split, leaf_g, leaf_h = build_tree(
                bins, g, h, n_bins=n_bins, max_depth=max_depth,
                lam=1e-6, gamma=0.0, min_child_weight=min_samples_leaf,
                feat_mask=feat_mask, depth_limit=depth_limit,
                subtract=subtract, force=force,
                axis_name=axis_name, row_valid=row_valid)
            feats.append(feat)
            splits.append(split)
            leaves.append(-leaf_g / torch.clamp_min(leaf_h, 1e-6))   # = weighted mean(y)
    if not feats:
        n_int = (1 << max_depth) - 1
        return (torch.zeros((0, n_int), dtype=torch.int32, device=dev),
                torch.zeros((0, n_int), dtype=torch.int32, device=dev),
                torch.zeros((0, 1 << max_depth), dtype=torch.float32, device=dev))
    return torch.stack(feats), torch.stack(splits), torch.stack(leaves)


class ForestModel(TrainedModel):
    def __init__(self, feat, thresh, leaves, max_depth: int):
        self.feat = np.asarray(feat)
        self.thresh = np.asarray(thresh)
        self.leaves = np.asarray(leaves)
        self.max_depth = max_depth

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        out = np.zeros((x.shape[0],), np.float32)
        for feat, thresh, leaves in zip(self.feat, self.thresh, self.leaves):
            local = np.zeros(x.shape[0], np.int64)
            for level in range(self.max_depth):
                g = (1 << level) - 1 + local
                local = 2 * local + (x[np.arange(x.shape[0]), feat[g]] > thresh[g])
            out += leaves[local]
        return np.clip(out / len(self.feat), 0.0, 1.0)

    # ---- device validation plane (DESIGN.md §3.4) -----------------------
    # A forest "margin" is the SUM of per-tree leaf values (base 0); the
    # probability is the tree-mean, clipped. The tree router is shared with
    # gbdt (batched_tree_margins), and the divisor is each model's REAL
    # tree count.
    def predict_margin_device(self, x, *, cache=None) -> np.ndarray:
        return batched_tree_margins([self], x, cache=cache)[0]

    def predict_proba_device(self, x, *, cache=None) -> np.ndarray:
        margin = self.predict_margin_device(x, cache=cache)
        return np.clip(margin / len(self.feat), 0.0, 1.0)

    @classmethod
    def predict_margin_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return batched_tree_margins(models, x, cache=cache)

    @classmethod
    def predict_proba_batched(cls, models, x, *, cache=None) -> np.ndarray:
        margins = batched_tree_margins(models, x, cache=cache)
        counts = np.asarray([len(m.feat) for m in models], np.float32)
        return np.clip(margins / counts[:, None], 0.0, 1.0)


@register_estimator
class ForestEstimator(Estimator):
    name = "forest"
    data_format = "quantized_bins"
    budget_param = "n_estimators"

    def default_params(self) -> dict[str, Any]:
        return {"n_estimators": 100, "max_depth": 8, "min_samples_leaf": 1.0, "seed": 0}

    @staticmethod
    def _thresholds(feat_np, split_np, edges_np):
        in_range = split_np < edges_np.shape[1]
        return np.where(
            in_range,
            edges_np[feat_np, np.minimum(split_np, edges_np.shape[1] - 1)],
            np.float32(np.inf),
        ).astype(np.float32)

    @staticmethod
    def _draws(p, data, draws) -> TreeDraws:
        """The config's draws over the payload's full row range (a sharded
        payload's too: the shards slice them)."""
        if draws is not None:
            return draws
        seed, f = int(p["seed"]), data["bins"].shape[-1]
        r = int(data["_n_rows"]) if is_sharded_payload(data) else data["bins"].shape[0]
        return lambda t, dev: forest_tree_draws(seed, t, r, f, dev)

    def _grow(self, data, p, draws, start, n_trees, max_depth, force=None):
        """Trees ``start ..`` of config ``p`` as numpy (feat, thresh, leaves)."""
        feat, split, leaves = run_core(
            _grow_forest, data, self._draws(p, data, draws),
            float(np.float32(p["min_samples_leaf"])), int(p["max_depth"]), start,
            n_bins=int(data["n_bins"]), n_trees=n_trees, max_depth=max_depth,
            max_features=max(1, int(np.sqrt(data["bins"].shape[-1]))), force=force)
        feat_np, split_np = feat.cpu().numpy(), split.cpu().numpy()
        thresh = self._thresholds(feat_np, split_np, data["edges"].cpu().numpy())
        return feat_np, thresh, leaves.cpu().numpy()

    def train(self, data, params: Mapping[str, Any], *, force=None,
              draws: TreeDraws | None = None) -> ForestModel:
        """``force`` pins the ops path (see ``kernels/ops.py``: ``"ref"``
        the oracle, ``"plain"`` the plain scatter path); ``draws(t,
        device)`` replaces the seeded draws (see draws.py)."""
        p = {**self.default_params(), **params}
        max_depth = int(p["max_depth"])
        feat, thresh, leaves = self._grow(data, p, draws, 0, int(p["n_estimators"]),
                                          max_depth, force)
        return ForestModel(feat, thresh, leaves, max_depth)

    # ---- adaptive search (DESIGN.md §3.6) -------------------------------
    def train_resumable(self, data, params: Mapping[str, Any], *,
                        budget: int, state: ResumeState | None = None,
                        draws: TreeDraws | None = None):
        p = {**self.default_params(), **params}
        max_depth = int(p["max_depth"])
        target = int(budget)
        if state is None:
            start = 0
            n_nodes, n_leaves = (1 << max_depth) - 1, 1 << max_depth
            prev_feat = np.zeros((0, n_nodes), np.int32)
            prev_thresh = np.zeros((0, n_nodes), np.float32)
            prev_leaves = np.zeros((0, n_leaves), np.float32)
        else:
            start = int(state.budget)
            pl = state.payload
            prev_feat, prev_thresh, prev_leaves = pl["feat"], pl["thresh"], pl["leaves"]
        if target > start:
            feat, thresh, leaves = self._grow(data, p, draws, start, target - start,
                                              max_depth)
            prev_feat = np.concatenate([prev_feat, feat])
            prev_thresh = np.concatenate([prev_thresh, thresh])
            prev_leaves = np.concatenate([prev_leaves, leaves])
        model = ForestModel(prev_feat, prev_thresh, prev_leaves, max_depth)
        new_state = ResumeState(self.name, max(target, start),
                                {"feat": prev_feat, "thresh": prev_thresh,
                                 "leaves": prev_leaves})
        return model, new_state

    # ---- fused batches (core/fusion.py, DESIGN.md §3.2) -----------------
    def fuse_signature(self, params: Mapping[str, Any]):
        return ("forest",)

    def fuse_bucket(self, params: Mapping[str, Any]) -> tuple:
        from repro_torch.core.fusion import pad_pow2

        p = {**self.default_params(), **params}
        return (pad_pow2(int(p["n_estimators"])), int(p["max_depth"]))

    def train_batched(self, data, configs, *, cache=None) -> list[ForestModel]:
        """One model per config, each grown to the batch's largest depth with
        its own ``max_depth`` as the depth limit (sentinel splits below it,
        so routing matches the unpadded model), as the reference's fused
        program gives. Each config grows only its own trees: the padded
        trees of the reference's program are dropped there anyway. The
        program comes from ``cache`` (default the process-wide compile
        cache) under the reference's key."""
        from repro_torch.core import fusion

        ps = [{**self.default_params(), **c} for c in configs]
        bins = data["bins"]
        pad_trees = fusion.pad_pow2(max(int(p["n_estimators"]) for p in ps))
        pad_depth = max((int(p["max_depth"]) for p in ps), default=1)
        key = ("forest", int(data["n_bins"]), pad_trees, pad_depth,
               max(1, int(np.sqrt(bins.shape[-1]))), len(fusion.pad_configs(ps)[0]),
               tuple(bins.shape))
        if is_sharded_payload(data):
            key += (int(data["_n_shards"]),)
        cc = cache if cache is not None else fusion.compile_cache()
        fit = cc.get(key, lambda: self._batched_fit(pad_depth))
        return fit(data, ps)

    def _batched_fit(self, pad_depth: int):
        """The compile cache's program for one forest signature: every
        config grown at the batch's depth."""
        def fit(data, ps):
            return [ForestModel(*self._grow(data, p, None, 0, int(p["n_estimators"]),
                                            pad_depth), pad_depth)
                    for p in ps]
        return fit

    @staticmethod
    def estimate_cost(params: Mapping[str, Any], n_rows: int, n_features: int) -> float:
        # histogram subtraction (DESIGN.md §3.8): root level full, deeper
        # levels build only the smaller child — same halving as gbdt's
        p = {"n_estimators": 100, "max_depth": 8, **dict(params)}
        hist_levels = 1 + 0.5 * (int(p["max_depth"]) - 1)
        per_tree = n_rows * max(1, int(np.sqrt(n_features))) * hist_levels
        return int(p["n_estimators"]) * per_tree / 2e8
