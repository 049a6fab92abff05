"""The least work of the trees a window fitted: each fit's trees routed over
its training codes level by level, the rows of each node counted, and the
counts turned into bytes and operations by ``counts/tree_level.py``."""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from portbench.counts import tree_level
from portbench.reference import trees

#: trees routed together
_CHUNK = 16


def level_counts(codes: torch.Tensor, split: torch.Tensor, feat: torch.Tensor,
                 depth: int) -> list[torch.Tensor]:
    """For trees ``feat``/``split`` (T, 2^D - 1): ``[counts (T, 2^l) for l
    in 0 .. D-1]``, the rows in each node of each level."""
    out = [[] for _ in range(depth)]
    r = codes.shape[0]
    for lo in range(0, feat.shape[0], _CHUNK):
        ft, st = feat[lo:lo + _CHUNK].long().T, split[lo:lo + _CHUNK].T   # (nodes, Tb)
        tb = ft.shape[1]
        node = torch.zeros((r, tb), dtype=torch.int64, device=codes.device)
        cols = torch.arange(tb, device=codes.device)
        for level in range(depth):
            n = 1 << level
            out[level].append(torch.bincount((node + cols * n).reshape(-1),
                                             minlength=n * tb).view(tb, n))
            g_idx = (1 << level) - 1 + node
            b = torch.gather(codes, 1, torch.gather(ft, 0, g_idx))
            node = 2 * node + (b.long() > torch.gather(st, 0, g_idx)).long()
    return [torch.cat(c) for c in out]


@dataclasses.dataclass
class Work:
    """The least work of some fits' trees, and the tree levels they grew."""
    bytes: int = 0
    flops: int = 0
    levels: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops,
                    self.levels + other.levels)


class WindowWork:
    """Bytes and operations of the trees of fits; identical fits (the same
    configuration, format and trees) are counted from the first's routing."""

    def __init__(self, reference):
        self.reference = reference     # reference/<estimator>.py
        self._seen: dict[str, Work] = {}

    def of_fit(self, fit, payload) -> Work:
        m = fit.model
        key = hashlib.blake2b(np.asarray(m.feat).tobytes() + np.asarray(m.thresh).tobytes()
                              + repr(sorted(fit.params.items())).encode(),
                              digest_size=16).hexdigest()
        if key not in self._seen:
            codes, edges = payload["bins"], payload["edges"]
            nb = int(payload["n_bins"])
            dev = codes.device
            feat = torch.as_tensor(np.asarray(m.feat), device=dev).long()
            thresh = torch.as_tensor(np.asarray(m.thresh), device=dev)
            split = trees.split_bins(feat, thresh, edges, nb)
            depth = int(m.max_depth)
            per_level = level_counts(codes, split, feat, depth)
            b = f = 0
            for t in range(feat.shape[0]):
                tb, tf = tree_level.tree_work([c[t] for c in per_level], codes.shape[0],
                                              self.reference.features_scanned(codes.shape[1]),
                                              nb)
                b, f = b + tb, f + tf
            self._seen[key] = Work(b, f, feat.shape[0] * depth)
        return self._seen[key]
