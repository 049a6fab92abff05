"""Explicit collectives over a shard axis: int8-compressed mean-reduce with
error feedback, and the plain mean-reduce.

The axis is a :class:`~repro_torch.compat.ShardAxis` (per-shard values
stacked on a leading axis of the shard count, one process) or a
:class:`~repro_torch.compat.MeshAxis` (one value per rank of a mesh axis's
process group: a data-parallel gradient, or a DTensor's local block of a
tensor-parallel one). The sums go through the axis's ``psum``, which adds
shards in shard order on either.

    q = round(g / scale) ∈ int8,  scale = max|g| / 127   (max over shards)
    Σ_shards q  on int32 (no overflow until 2^23 shards)
    mean = Σ q · scale / n;  residual g − q · scale is carried to the NEXT
    call and added to its gradient (error feedback: the cumulative mean
    stays unbiased instead of compounding the rounding).

A gradient tree is a tensor, or a dict, list or tuple of them.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.compat import MeshAxis, ShardAxis

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum", "psum_tree"]


def _leaves(tree) -> list:
    """The tensor leaves of ``tree``, in order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaves) for sub in tree)
    return next(leaves)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    scale = gf.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _per_shard_scale(g: torch.Tensor) -> torch.Tensor:
    """max |g| / 127 of each shard's block, shaped to broadcast over it."""
    flat = g.reshape(g.shape[0], -1)
    return (flat.abs().amax(dim=1) / 127.0 + 1e-30).reshape((-1,) + (1,) * (g.dim() - 1))


def _whole_scale(g: torch.Tensor) -> torch.Tensor:
    """max |g| / 127 over the whole of one rank's value (all of a DTensor's
    blocks), as a plain 0-d tensor."""
    from torch.distributed.tensor import DTensor

    m = g.abs().max()
    m = m.full_tensor() if isinstance(m, DTensor) else m
    return m / 127.0 + 1e-30


def compressed_psum(grads: Any, axis: ShardAxis | MeshAxis, residuals: Any | None = None):
    """int8 mean-reduce with error feedback. Returns ``(mean_grads,
    new_residuals)``: the means are shard-invariant, the residuals stay per
    shard (the same shapes as ``grads``). ``residuals`` holds each leaf's
    previous quantisation error."""
    n = axis.size

    def leaf(g, r):
        gf = g.float() + (0.0 if r is None else r)
        # every shard quantises with one scale: the largest shard's
        gscale = axis.pmax(_per_shard_scale(gf) if axis.stacked else _whole_scale(gf))
        q = torch.clamp(torch.round(gf / gscale), -127, 127).to(torch.int8)
        summed = axis.psum(q.to(torch.int32))
        mean = summed.float() * gscale / n
        return mean.to(g.dtype), gf - dequantize_int8(q, gscale)

    gl = _leaves(grads)
    rl = [None] * len(gl) if residuals is None else _leaves(residuals)
    out = [leaf(g, r) for g, r in zip(gl, rl)]
    return (_rebuild(grads, iter(m for m, _ in out)),
            _rebuild(grads, iter(r for _, r in out)))


def psum_tree(grads: Any, axis: ShardAxis | MeshAxis) -> Any:
    """Uncompressed mean-reduce of every leaf over the shard axis (the
    baseline the compressed path replaces): shard-invariant outputs."""
    return _rebuild(grads, iter(axis.psum(g) / axis.size for g in _leaves(grads)))
