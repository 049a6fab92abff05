"""The SPMD launcher of the row-sharded data plane (DESIGN.md §3.9).

The JAX package's ``compat.sharded_call`` has two lowerings of one program:
``shard_map`` over a device mesh (one device per shard) and ``jax.vmap``
with an axis name on one device. The port has both:
  * one device: every shard's row block lies on the one device, stacked on
    a leading axis, and the function sees the whole stack at once together
    with a :class:`ShardAxis`, whose collectives reduce that leading axis;
  * a ``torch.distributed`` device mesh with a matching axis: each rank
    takes its own block ``x[rank]`` (kept as a stack of one) and calls the
    function once with a :class:`MeshAxis`, whose collectives go over the
    axis's process group.
Both sum in shard order, ``x[0] + x[1] + ...``: the mesh's ``psum`` is an
``all_gather`` of the partials followed by that sum (an ``all_reduce``
would leave the order to the backend), so the two lowerings give the same
bits.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["ShardAxis", "MeshAxis", "sharded_call"]


class ShardAxis:
    """The shard axis a sharded function reduces over: its ``name``, its
    ``size`` (the shard count) and its collectives. Per-shard values are
    stacked on a leading axis of length ``size``.

    ``psum`` adds the shards in shard order, ``x[0] + x[1] + ...``, one add
    after another, so a combined value has the same bits on every run and
    every device, whatever the shard count's reduction tree would be."""

    stacked = True      # per-shard values lead with the shards' axis

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


class MeshAxis:
    """One axis of a ``torch.distributed`` device mesh as a shard axis: its
    ``name``, its ``size`` (the ranks along it) and collectives over its
    process group.

    ``stacked=True`` is :func:`sharded_call`'s view: each rank's per-shard
    value leads with a stack of one block, as a :class:`ShardAxis` value
    leads with all of them, and a reduction returns the value without it.
    ``stacked=False`` reduces a plain per-rank value (a data-parallel
    gradient). A DTensor (a tensor-parallel gradient) is reduced on its
    local block and keeps its placements.

    ``psum`` gathers every rank's value and adds them in rank order, so it
    has the same bits as the stacked ``ShardAxis.psum``. gloo moves host
    tensors only: there a CUDA tensor is staged through pinned host memory
    (the sharded level of two gloo ranks sharing one card)."""

    def __init__(self, mesh, name: str, *, stacked: bool = False):
        self.mesh, self.name, self.stacked = mesh, name, stacked
        self.group = mesh.get_group(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, stacked on a new leading axis in rank order."""
        import torch.distributed as dist

        stage = x.is_cuda and dist.get_backend(self.group) == "gloo"
        src = x.contiguous()
        if stage:
            src = torch.empty(src.shape, dtype=src.dtype, pin_memory=True).copy_(src)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.stack(parts)
        return out.to(x.device) if stage else out

    def _reduce(self, x, combine):
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            local = self._reduce(x.to_local(), combine)
            return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                                      shape=x.shape, stride=x.stride())
        if self.stacked and (x.dim() < 1 or x.shape[0] != 1):
            raise ValueError(f"a per-shard value of mesh axis {self.name!r} leads with "
                             f"one block, got shape {tuple(x.shape)}")
        g = self._gather(x[0] if self.stacked else x)
        return combine(g)

    def psum(self, x):
        """The sum over ranks of ``x``, in rank order; a Python number is
        the same on every rank, so its sum is ``size * x``."""
        if not isinstance(x, torch.Tensor):
            return self.size * x

        def ordered(g):
            out = g[0].clone()
            for s in range(1, self.size):
                out += g[s]
            return out

        return self._reduce(x, ordered)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ranks of ``x``."""
        return self._reduce(x, lambda g: g.amax(dim=0))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"MeshAxis({self.name!r}, size={self.size})"


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

    A ``torch.distributed`` device ``mesh`` whose ``axis`` has ``n_shards``
    ranks lowers to one rank per shard: each rank calls ``f`` once with a
    stacked :class:`MeshAxis` and its own block ``args[rank:rank + 1]`` of
    every tensor. The JAX package's families never pass a mesh, and neither
    do the port's.
    """
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if not names and dict(getattr(mesh, "shape", None) or {}).get(axis) == n_shards:
        raise TypeError(
            f"sharded_call over {mesh!r}: one rank per shard needs a torch.distributed "
            "device mesh (launch.mesh.compat_make_mesh); a mesh of devices in one "
            "process has no process group to reduce over")
    if mesh is not None and axis in names and mesh.size(names.index(axis)) == n_shards:
        mesh_axis = MeshAxis(mesh, axis, stacked=True)
        rank = mesh.get_local_rank(axis)

        def per_rank(*args):
            blocks = []
            for a in args:
                if isinstance(a, torch.Tensor):
                    ShardAxis(axis, n_shards)._check(a)
                    a = a[rank:rank + 1]
                blocks.append(a)
            return f(mesh_axis, *blocks)

        return per_rank
    shard_axis = ShardAxis(axis, n_shards)

    def stacked(*args):
        for a in args:
            if isinstance(a, torch.Tensor):
                shard_axis._check(a)
        return f(shard_axis, *args)

    return stacked
