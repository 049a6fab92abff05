"""Gradient-boosted trees (XGBoost's ``hist`` method, logistic loss), the
plain definition a fitted GBDT model is held to.

Round t's statistics are ``g = p - y`` and ``h = max(p (1 - p), 1e-16)``
with ``p = sigmoid(margin)``, the margin being the base ``log(prior / (1 -
prior))`` plus the leaf values of rounds 0 .. t-1, all in float64. A
round's tree is level-wise to ``max_depth``; a leaf holds ``-eta G / (H +
lambda)``. The margin of the program's own earlier trees is what round t is
checked on (the reference follows the fit's rounds; the first round,
checked from the base alone, checks the start). The validation score is
the AUC of ``sigmoid(base + Σ leaves)`` in float32, the configuration's
precision, the margin added in tree order. Hyperparameters default as
XGBoost's do: eta 0.3, lambda 1, gamma 0, min_child_weight 1, max_depth 6.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import trees
from portbench.reference.auc import auc, sigmoid32

DEFAULTS = {"eta": 0.3, "lambda": 1.0, "gamma": 0.0, "min_child_weight": 1.0,
            "max_depth": 6, "max_bin": 64, "round": 30}


def params(p: dict) -> dict:
    return {**DEFAULTS, **p}


def n_trees(p: dict) -> int:
    return int(params(p)["round"])


def depth(p: dict) -> int:
    return int(params(p)["max_depth"])


def max_bins(p: dict) -> int:
    return int(params(p)["max_bin"])


def base_margin(y: torch.Tensor) -> float:
    prior = min(max(float(y.to(torch.float64).mean()), 1e-6), 1 - 1e-6)
    return math.log(prior / (1 - prior))


def base_margin32(y: torch.Tensor) -> float:
    """The base margin of the validation scores: the label mean taken in
    float32, the configuration's precision (the labels' sum, exact for 0/1
    labels below 2^24 rows, over their count, one float32 division)."""
    mean = np.float32(float(y.to(torch.float32).sum())) / np.float32(y.numel())
    prior = min(max(float(mean), 1e-6), 1 - 1e-6)
    return math.log(prior / (1 - prior))


def _stats(margin: torch.Tensor, y: torch.Tensor):
    p = torch.sigmoid(margin)
    return p - y, torch.clamp(p * (1 - p), min=1e-16)


def check(model, p: dict, score, ref, rng: np.random.Generator) -> dict:
    """Readings of one fitted model: ``split_gap`` and ``leaf_err`` over
    three of its rounds (the first, the last and one drawn), ``auc_gap``
    of its validation score against the AUC of its trees' float32 scores.
    ``ref`` holds the reference's own codes and edges of the format."""
    p = params(p)
    dev = ref.codes.device
    eta, lam = float(p["eta"]), float(p["lambda"])
    d, nb = depth(p), ref.n_bins
    feat = torch.as_tensor(np.asarray(model.feat), device=dev).long()
    thresh = torch.as_tensor(np.asarray(model.thresh), device=dev)
    leaves = torch.as_tensor(np.asarray(model.leaves), device=dev)
    t_all = feat.shape[0]
    split = trees.split_bins(feat, thresh, ref.edges32, nb)
    y = ref.y
    base = base_margin(y)
    margin = torch.full_like(y, base)
    checked = {0, t_all - 1, int(rng.integers(t_all))}
    gap = err = 0.0
    for t in range(t_all):
        if t in checked:
            g, h = _stats(margin, y)
            r = trees.check_tree(
                ref.codes, ref.codes_t, g, h, feat[t], split[t], leaves[t], depth=d,
                n_bins=nb, lam=lam, min_child_weight=float(p["min_child_weight"]),
                gamma=float(p["gamma"]), features=range(ref.codes.shape[1]),
                leaf_value=lambda G, H: -eta * G / (H + lam))
            gap, err = max(gap, r.split_gap), max(err, r.leaf_err)
        if t + 1 < t_all and t + 1 <= max(checked):
            idx = trees.leaf_index(ref.codes, feat[t], split[t], d)
            margin = margin + leaves[t].to(torch.float64)[idx]
    p32 = sigmoid32(trees.raw_margins(ref.x_valid, feat, thresh, leaves, d,
                                      base=base_margin32(ref.y)).cpu().numpy())
    want = auc(ref.y_valid, torch.from_numpy(p32))
    return {"split_gap": gap, "leaf_err": err,
            "auc_gap": abs(float(score) - want) if score is not None else math.inf}


class _Model:
    def __init__(self, feat, thresh, leaves):
        self.feat, self.thresh, self.leaves = feat, thresh, leaves


def control_fit(p: dict, ref, dtype=torch.bfloat16):
    """The plain fit in ``dtype`` in the program's place: statistics,
    histograms, gains, leaf values, margins and the validation score all in
    ``dtype``. Returns ``(model, score)``."""
    p = params(p)
    d, nb = depth(p), ref.n_bins
    eta, lam = float(p["eta"]), float(p["lambda"])
    y = ref.y.to(dtype)
    margin = torch.full_like(y, base_margin(ref.y))
    feats, threshs, leaves = [], [], []
    for _ in range(n_trees(p)):
        g, h = _stats(margin, y)
        f, s, node, G, H = trees.grow_tree(
            ref.codes, ref.codes_t, g, h, depth=d, n_bins=nb, lam=lam,
            min_child_weight=float(p["min_child_weight"]), gamma=float(p["gamma"]),
            features=range(ref.codes.shape[1]))
        leaf = -eta * G / (H + lam)
        margin = margin + leaf[node]
        feats.append(f)
        threshs.append(trees.thresholds(f, s, ref.edges32, nb))
        leaves.append(leaf.to(torch.float32))
    feat, thresh = torch.stack(feats), torch.stack(threshs)
    model = _Model(feat.cpu().numpy(), thresh.cpu().numpy(), torch.stack(leaves).cpu().numpy())
    valid = trees.raw_margins(ref.x_valid, feat, thresh, torch.stack(leaves), d,
                              base=base_margin(ref.y), dtype=dtype)
    return model, auc(ref.y_valid, valid.to(torch.float64))


def features_scanned(n_features: int) -> int:
    """Features a level scans: all of them."""
    return n_features
