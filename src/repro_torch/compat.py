"""The SPMD launcher of the row-sharded data plane (DESIGN.md §3.9).

The JAX package's ``compat.sharded_call`` has two lowerings of one program:
``shard_map`` over a device mesh (one device per shard) and ``jax.vmap``
with an axis name on one device. The port has the second: every shard's
row block lies on the one device, stacked on a leading axis, and the
function sees the whole stack at once together with a :class:`ShardAxis`,
whose collectives reduce that leading axis. The one-device-per-shard
lowering through ``torch.distributed`` is ROADMAP Queue 1 item 5's work.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["ShardAxis", "sharded_call"]


class ShardAxis:
    """The shard axis a sharded function reduces over: its ``name``, its
    ``size`` (the shard count) and its collectives. Per-shard values are
    stacked on a leading axis of length ``size``.

    ``psum`` adds the shards in shard order, ``x[0] + x[1] + ...``, one add
    after another, so a combined value has the same bits on every run and
    every device, whatever the shard count's reduction tree would be."""

    def __init__(self, name: str, size: int):
        if size < 1:
            raise ValueError(f"a shard axis needs size >= 1, got {size}")
        self.name = name
        self.size = int(size)

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() < 1 or x.shape[0] != self.size:
            raise ValueError(f"a per-shard value of axis {self.name!r} leads with "
                             f"{self.size} shards, got shape {tuple(x.shape)}")

    def psum(self, x):
        """The sum over shards of ``x`` (size, ...), in shard order; a Python
        number is the same on every shard, so its sum is ``size * x``."""
        if not isinstance(x, torch.Tensor):
            return self.size * x
        self._check(x)
        out = x[0].clone()
        for s in range(1, self.size):
            out += x[s]
        return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over shards of ``x`` (size, ...)."""
        self._check(x)
        return x.amax(dim=0)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ShardAxis({self.name!r}, size={self.size})"


def sharded_call(f: Callable[..., Any], *, n_shards: int, axis: str = "shards",
                 mesh=None) -> Callable[..., Any]:
    """SPMD launcher for a sharded function over leading-axis-stacked args.

    The returned callable takes arguments whose tensors lead with the shard
    axis, ``(n_shards, rows_per_shard, ...)`` blocks, and calls
    ``f(shard_axis, *args)`` once with every shard's block: ``f`` batches
    its per-shard work over the leading axis (or loops over the shards
    where that launches a kernel) and combines across shards with the
    :class:`ShardAxis` collectives. Its outputs are whatever it returns,
    already reduced where they are shard-invariant.

    A ``mesh`` whose ``axis`` has ``n_shards`` devices asks for one device
    per shard: that lowering (``torch.distributed``) is not written yet,
    so it raises rather than run the one-device lowering in its place.
    """
    mesh_axes = dict(getattr(mesh, "shape", None) or {}) if mesh is not None else {}
    if mesh_axes.get(axis) == n_shards:
        raise NotImplementedError(
            "sharded_call over a device mesh (one device per shard through "
            "torch.distributed) is not ported yet: ROADMAP Queue 1 item 5")
    shard_axis = ShardAxis(axis, n_shards)

    def stacked(*args):
        for a in args:
            if isinstance(a, torch.Tensor):
                shard_axis._check(a)
        return f(shard_axis, *args)

    return stacked
