"""Per-device bytes of a sharded tree, and the partition-spec type it reads.

Only what the row-sharded data plane needs (DESIGN.md §3.9): the JAX
package's logical-axis rules for LM parameters and states wait for the
multi-GPU LM work (ROADMAP Queue 1 items 5–6).
"""
from __future__ import annotations

from typing import Any

__all__ = ["PartitionSpec", "P", "bytes_per_device"]


class PartitionSpec(tuple):
    """Which mesh axis (or tuple of axes, or None) shards each dimension of
    a value, as ``jax.sharding.PartitionSpec``: ``P("shards")`` splits the
    leading dimension over the ``shards`` axis, ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _leaves(tree, is_leaf=lambda x: False) -> list:
    """The leaves of a nested dict/list/tuple tree, dict keys sorted (the
    order ``jax.tree.leaves`` takes), so that two trees of one structure
    align leaf by leaf."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub, is_leaf)]
    return [tree]


def bytes_per_device(shapes: Any, pspecs: Any, mesh, axis_map: dict | None = None) -> int:
    """Estimated per-device bytes of a sharded tree.

    ``shapes`` is a tree of values: tensors and arrays count their elements
    times their dtype's size, other leaves their ``.nbytes`` (0 for a plain
    number such as a payload's ``n_bins``). ``pspecs`` is a tree of the same
    structure with a :class:`PartitionSpec` per leaf (``P()`` for a
    replicated or non-array leaf): each leaf's bytes are divided by the
    sizes of the mesh axes its spec names, rounded up. ``mesh`` is a
    ``{axis: size}`` mapping or a device mesh with ``axis_names`` and
    ``devices`` (:class:`repro_torch.launch.mesh.DeviceMesh`); ``axis_map``
    maps a spec's logical axis names onto mesh axes.
    """
    if isinstance(mesh, dict):
        sizes = dict(mesh)
    else:
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    axis_map = axis_map or {}

    def leaf_bytes(leaf, spec: PartitionSpec) -> int:
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is not None and dtype is not None:
            total = 1
            for d in shape:
                total *= int(d)
            total *= dtype.itemsize
        else:
            total = int(getattr(leaf, "nbytes", 0) or 0)
        denom = 1
        for a in spec:
            if a is None:
                continue
            axes = axis_map.get(a, a)
            for ax in (axes,) if isinstance(axes, str) else axes:
                denom *= sizes.get(ax, 1)
        return -(-total // max(1, denom))

    value_leaves = _leaves(shapes)
    spec_leaves = _leaves(pspecs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    if len(value_leaves) != len(spec_leaves):
        raise ValueError(
            f"pspec tree has {len(spec_leaves)} leaves for {len(value_leaves)} "
            "value leaves: the trees must align leaf by leaf (P() for a "
            "replicated or non-array leaf)")
    return sum(leaf_bytes(v, s) for v, s in zip(value_leaves, spec_leaves))
