"""Quantile bin edges and bin codes, as the ``quantized_bins`` format
defines them, worked out again on the device from the raw rows.

Per feature, ``n_bins - 1`` edges at the quantiles ``linspace(0, 1, n_bins
+ 1)[1:-1]`` of the column by numpy's default ("linear") rule: the virtual
index ``(n - 1) * q``, its floor and the next order statistic, and numpy's
``_lerp`` (the difference taken in the column's float32, the rest in
float64, ``b - d * (1 - t)`` where ``t >= 0.5``). A row's code is the
number of edges below its value (``searchsorted(..., side="left")`` in
float64). Every step is one IEEE operation in the same order as numpy's,
so the edges and codes are numpy's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def quantize(x: torch.Tensor, max_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(edges (F, n_bins - 1) float64, codes (R, F) int32)`` of float32
    rows ``x`` (R, F), on ``x``'s device."""
    n, f = x.shape
    n_bins = min(int(max_bins), max(2, n))
    dev = x.device
    q = torch.from_numpy(np.linspace(0.0, 1.0, n_bins + 1)[1:-1]).to(dev)
    virtual = (n - 1) * q
    prev = torch.floor(virtual)
    gamma = (virtual - prev)[:, None]
    lo = prev.to(torch.int64)
    hi = torch.clamp(lo + 1, max=n - 1)
    above = virtual >= n - 1
    lo = torch.where(above, torch.full_like(lo, n - 1), lo)
    hi = torch.where(above, torch.full_like(hi, n - 1), hi)
    edges = torch.empty((f, n_bins - 1), dtype=torch.float64, device=dev)
    codes = torch.empty((n, f), dtype=torch.int32, device=dev)
    for j in range(f):
        col = x[:, j].contiguous()
        xs = torch.sort(col).values
        a, b = xs[lo], xs[hi]
        d = b - a                                   # float32, as numpy's
        d64 = d.to(torch.float64)
        t = gamma[:, 0]
        e = a.to(torch.float64) + d64 * t
        e = torch.where(t >= 0.5, b.to(torch.float64) - d64 * (1 - t), e)
        edges[j] = e
        codes[:, j] = torch.searchsorted(e, col.to(torch.float64), side="left",
                                         out_int32=True)
        del xs
    return edges, codes
