"""Area under the ROC curve, by the Mann-Whitney rank statistic with tied
scores given their average rank, in float64 on the scores' device; and the
logistic function in float32, as a model's validation scores are made."""
from __future__ import annotations

import numpy as np
import torch


def sigmoid32(z: np.ndarray) -> np.ndarray:
    """``1 / (1 + exp(-z))`` of float32 margins in float32, never
    exponentiating a positive argument: ``exp(z) / (1 + exp(z))`` below 0."""
    z = np.asarray(z, np.float32)
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def auc(y: torch.Tensor, score: torch.Tensor) -> float:
    s = score.to(y.device, torch.float64)
    yb = y.to(torch.bool)
    n_pos = int(yb.sum())
    n_neg = int(yb.numel()) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    _, inverse, counts = torch.unique(s, sorted=True, return_inverse=True,
                                      return_counts=True)
    ends = torch.cumsum(counts, 0).to(torch.float64)          # 1-based last rank
    avg_rank = ends - (counts.to(torch.float64) - 1) / 2
    rank_sum = avg_rank[inverse][yb].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
