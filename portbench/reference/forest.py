"""Random forest, the plain definition a fitted forest is held to.

Tree t of a configuration with seed s draws, from a CPU ``torch.Generator``
seeded by ``SeedSequence([s, t])``, R uniforms turned into Poisson(1)
bootstrap weights w by the inverse CDF, then a permutation of the F
features whose first ``max(1, int(sqrt(F)))`` are the tree's features
(a copy of the draws the program documents in ``tabular/draws.py``). The
tree is level-wise to ``max_depth`` on ``g = -y w``, ``h = w`` (so the
gain is a weighted variance reduction), lambda 1e-6, min_child_weight
``min_samples_leaf``; a leaf holds ``-G / max(H, 1e-6)``, the weighted
mean label. The model's probability is the mean of its trees' leaves,
clipped to [0, 1], in float32 (the configuration's precision), the leaves
added in tree order. Trees are independent, so each checked tree is worked
out from the inputs alone.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import trees
from portbench.reference.auc import auc

DEFAULTS = {"n_estimators": 100, "max_depth": 8, "min_samples_leaf": 1.0, "seed": 0}
LAMBDA = 1e-6
MAX_BINS = 256          # the forest's format is the converter's default


def params(p: dict) -> dict:
    return {**DEFAULTS, **p}


def n_trees(p: dict) -> int:
    return int(params(p)["n_estimators"])


def depth(p: dict) -> int:
    return int(params(p)["max_depth"])


def max_bins(p: dict) -> int:
    return MAX_BINS


def _poisson1_cdf() -> torch.Tensor:
    cdf, prob, k = [], math.exp(-1.0), 0
    total = prob
    while np.float32(total) < 1.0:
        cdf.append(total)
        k += 1
        prob /= k
        total += prob
    return torch.tensor(cdf, dtype=torch.float32)


_CDF = _poisson1_cdf()


def draws(seed: int, t: int, n_rows: int, n_features: int):
    """Tree t's bootstrap weights (R,) float32 and feature permutation (F,)."""
    s = int(np.random.SeedSequence([int(seed), int(t)]).generate_state(1, np.uint64)[0])
    gen = torch.Generator().manual_seed(s)
    u = torch.rand(n_rows, generator=gen)
    w = torch.searchsorted(_CDF, u, right=True).to(torch.float32)
    return w, torch.randperm(n_features, generator=gen)


def _tree_inputs(p: dict, t: int, ref, dtype):
    n_rows, n_feat = ref.codes.shape
    w, perm = draws(int(p["seed"]), t, n_rows, n_feat)
    w = w.to(ref.y.device, dtype)
    feats = sorted(perm[:max(1, int(np.sqrt(n_feat)))].tolist())
    return -ref.y.to(dtype) * w, w, feats


def check(model, p: dict, score, ref, rng: np.random.Generator) -> dict:
    """Readings of one fitted forest: ``split_gap`` and ``leaf_err`` over
    three of its trees (the first, the last and one drawn), ``auc_gap`` of
    its validation score against the AUC of its trees' float32 mean."""
    p = params(p)
    dev = ref.codes.device
    d, nb = depth(p), ref.n_bins
    feat = torch.as_tensor(np.asarray(model.feat), device=dev).long()
    thresh = torch.as_tensor(np.asarray(model.thresh), device=dev)
    leaves = torch.as_tensor(np.asarray(model.leaves), device=dev)
    t_all = feat.shape[0]
    split = trees.split_bins(feat, thresh, ref.edges32, nb)
    gap = err = 0.0
    for t in sorted({0, t_all - 1, int(rng.integers(t_all))}):
        g, h, feats = _tree_inputs(p, t, ref, torch.float64)
        r = trees.check_tree(
            ref.codes, ref.codes_t, g, h, feat[t], split[t], leaves[t], depth=d,
            n_bins=nb, lam=LAMBDA, min_child_weight=float(p["min_samples_leaf"]),
            gamma=0.0, features=feats,
            leaf_value=lambda G, H: -G / torch.clamp(H, min=1e-6))
        gap, err = max(gap, r.split_gap), max(err, r.leaf_err)
    total = trees.raw_margins(ref.x_valid, feat, thresh, leaves, d).cpu().numpy()
    prob = np.clip(total / np.float32(t_all), 0.0, 1.0)
    want = auc(ref.y_valid, torch.from_numpy(prob))
    return {"split_gap": gap, "leaf_err": err,
            "auc_gap": abs(float(score) - want) if score is not None else math.inf}


class _Model:
    def __init__(self, feat, thresh, leaves):
        self.feat, self.thresh, self.leaves = feat, thresh, leaves


def control_fit(p: dict, ref, dtype=torch.bfloat16):
    """The plain forest in ``dtype`` in the program's place (statistics,
    histograms, gains, leaves and the validation mean in ``dtype``).
    Returns ``(model, score)``."""
    p = params(p)
    d, nb = depth(p), ref.n_bins
    feats, threshs, leaves = [], [], []
    for t in range(n_trees(p)):
        g, h, fs = _tree_inputs(p, t, ref, dtype)
        f, s, _, G, H = trees.grow_tree(
            ref.codes, ref.codes_t, g, h, depth=d, n_bins=nb, lam=LAMBDA,
            min_child_weight=float(p["min_samples_leaf"]), gamma=0.0, features=fs)
        feats.append(f)
        threshs.append(trees.thresholds(f, s, ref.edges32, nb))
        leaves.append(-G / torch.clamp(H, min=1e-6))
    feat, thresh = torch.stack(feats), torch.stack(threshs)
    model = _Model(feat.cpu().numpy(), thresh.cpu().numpy(),
                   torch.stack(leaves).to(torch.float32).cpu().numpy())
    total = trees.raw_margins(ref.x_valid, feat, thresh, torch.stack(leaves), d, dtype=dtype)
    prob = torch.clamp(total / len(leaves), 0, 1)
    return model, auc(ref.y_valid, prob.to(torch.float64))


def features_scanned(n_features: int) -> int:
    """Features a level scans: the tree's sqrt(F)."""
    return max(1, int(np.sqrt(n_features)))
