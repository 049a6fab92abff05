"""Sharding rules: logical axes → partition specs for params, states,
batches, and those specs as DTensor placements on a device mesh.

The port of the JAX package's ``distributed/sharding.py``. Logical axes:
  * ``dp``  — data parallel (batch); maps to ("pod", "data") on multi-pod.
  * ``tp``  — tensor/expert parallel; maps to "model".
  * FSDP    — when enabled, the non-tp dim of large params is sharded over
              "data" (ZeRO-3-style parameter sharding; the propagation of
              DTensor gathers them at use, as GSPMD does). Always on for the
              MoE giants.

Rules are matched on the param path of the JAX package's tree (dict keys
joined by ``/``, ``models.params_to_reference``), so a spec here equals
the reference's leaf for leaf.

:func:`named_shardings` turns a tree of logical specs into a tree of
DTensor placements on the mesh's compute view (:func:`compute_mesh`): a
mesh axis a spec names shards that tensor dimension (``Shard``), an axis
it does not name replicates it (``Replicate``). On a multi-pod mesh the
``pod`` and ``data`` dimensions are flattened into one ``dp`` dimension,
so ``dp`` is one mesh dimension on every mesh; a tensor dimension over
``dp`` and ``tp`` at once (the KV sequence of a batch-1 long-context
cell) is sharded on both mesh dimensions, ``dp`` the major part, which is
the order of the reference's tuple.
"""
from __future__ import annotations

from typing import Any

__all__ = [
    "PartitionSpec", "P", "param_pspecs", "batch_pspecs", "state_pspecs",
    "zero1_pspecs", "logical_to_mesh", "named_shardings", "infer_axis_map",
    "compute_mesh", "placements", "local_shape_and_offset", "bytes_per_device",
    "AxisMap", "DEFAULT_AXIS_MAP", "tree_map_with_path", "tree_leaves",
]


class PartitionSpec(tuple):
    """Which mesh axis (or tuple of axes, or None) shards each dimension of
    a value, as ``jax.sharding.PartitionSpec``: ``P("shards")`` splits the
    leading dimension over the ``shards`` axis, ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# logical name → mesh axis (or tuple of axes)
AxisMap = dict[str, Any]
DEFAULT_AXIS_MAP: AxisMap = {"dp": "data", "tp": "model"}


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def tree_map_with_path(fn, tree, *rest, path: str = "", is_leaf=_is_spec):
    """``fn(path, leaf, *rest_leaves)`` over nested dicts (and lists/tuples,
    indexed by position); ``path`` joins the keys with ``/``. A
    :class:`PartitionSpec` is a leaf."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                          path=f"{path}/{k}" if path else str(k),
                                          is_leaf=is_leaf)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                                 path=f"{path}/{i}" if path else str(i),
                                                 is_leaf=is_leaf)
                              for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _tree_map(fn, tree, *rest, is_leaf=_is_spec):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest, is_leaf=is_leaf)


def tree_leaves(tree, is_leaf=_is_spec) -> list:
    """The leaves of a nested dict/list/tuple tree, dict keys sorted (the
    order ``jax.tree.leaves`` takes), so that two trees of one structure
    align leaf by leaf."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub, is_leaf)]
    return [tree]


def _rule(path: str, shape: tuple[int, ...], fsdp: bool) -> P:
    """Logical PartitionSpec for one param leaf (leading stack dim excluded)."""
    nd = len(shape)
    f = "dp" if fsdp else None
    name = path.split("/")[-1]

    # --- RWKV channel-mix first (its wk/wv/wr collide with attention names) ---
    if "cmix/" in path:
        if name == "wk":                         # (d, f_ff) up-projection
            return P(f, "tp")
        if name == "wv":                         # (f_ff, d) down-projection
            return P("tp", f)
        if name == "wr":
            return P(f, "tp")
    # --- embeddings / heads ---
    if name == "embed":
        return P("tp", f)                       # vocab over tp
    if name == "lm_head":
        return P(f, "tp")
    if name == "pos_embed":
        return P(None, None)
    # --- MoE ---
    if name == "router":
        return P(f, "tp")
    if name in ("w_gate", "w_up") and nd == 3:   # (E, d, f_ff)
        return P("tp", f, None)
    if name == "w_down" and nd == 3:             # (E, f_ff, d)
        return P("tp", f, None)
    # --- dense FFN ---
    if name in ("w_gate", "w_up"):               # (d, f_ff)
        return P(f, "tp")
    if name == "w_down":                         # (f_ff, d)
        return P("tp", f)
    # --- attention ---
    if name in ("wq", "wk", "wv"):
        return P(f, "tp")
    if name == "wo":
        return P("tp", f)
    if name in ("bq", "bk", "bv"):
        return P("tp")
    # --- RG-LRU ---
    if name in ("w_x", "w_y"):                   # (d, lru)
        return P(f, "tp")
    if name == "conv_w":                         # (width, lru)
        return P(None, "tp")
    if name in ("ig_w", "rg_w"):                 # (lru, lru)
        return P(f, "tp")
    if name == "a_param":
        return P("tp")
    if name == "w_out":                          # (lru, d)
        return P("tp", f)
    # --- RWKV ---
    if name in ("wr", "wk", "wg", "wv") and nd == 2:
        # time-mix in-projections (d, d) / cmix (d, f_ff)-shaped handled above
        return P(f, "tp")
    if name == "w_lora_a":
        return P(f, None)
    if name == "w_lora_b":
        return P(None, "tp")
    if name == "u":
        return P("tp", None)
    # --- everything else (norms, mu_*, w0, scalars) replicated ---
    return P(*([None] * nd))


def _is_stacked(path_str: str) -> bool:
    return "blocks/" in path_str or path_str.startswith("encoder")


def param_pspecs(params_shapes: Any, fsdp: bool = False) -> Any:
    """Tree of LOGICAL PartitionSpecs matching a param (shape) tree, the
    JAX package's layout (``models.params_to_reference``).

    Stacked leaves (under blocks/ or encoder/) lead with the repeats dim,
    which is never sharded; the rule applies to the trailing dims.
    """
    def leaf_spec(ps, leaf):
        shape = tuple(leaf.shape)
        if _is_stacked(ps):
            return P(None, *_rule(ps, shape[1:], fsdp))
        return _rule(ps, shape, fsdp)

    return tree_map_with_path(leaf_spec, params_shapes)


def batch_pspecs(batch_shapes: Any, dp_size: int = 1) -> Any:
    """Batch arrays: leading dim over dp (when divisible), rest replicated."""
    def spec(leaf):
        shape = tuple(leaf.shape)
        lead = "dp" if shape and shape[0] % max(1, dp_size) == 0 else None
        return P(*((lead,) + (None,) * (len(shape) - 1)))

    return _tree_map(spec, batch_shapes)


def state_pspecs(state_shapes: Any, seq_shard: bool | str = False,
                 dp_size: int = 1, tp_size: int = 1) -> Any:
    """Decode-state tree: KV caches (…, B, Hkv, S, Dh) batch over dp and
    heads over tp — or, when ``seq_shard`` (flash-decoding for long contexts
    with few KV heads) or when Hkv doesn't divide tp, the SEQUENCE dim over
    tp ("full": over dp AND tp, for batch-1 long-context cells). Recurrent
    states: batch over dp, channels over tp. Every axis assignment is
    divisibility-checked, as the reference's explicit shardings reject
    padding.

    ``state_shapes`` is the JAX package's state tree (``blocks/b{j}``
    stacked over the repeats, ``tail{j}``) or the port's per-layer list
    (``models.init_decode_state``), whose leaves are not stacked."""

    def div(n: int, axis_size: int) -> bool:
        # axis_size ≤ 1 → sharding is a no-op; leave the dim unannotated
        return axis_size > 1 and n % axis_size == 0 and n >= axis_size

    def leaf_spec(ps, leaf):
        shape = tuple(leaf.shape)
        stacked = _is_stacked(ps)
        core = shape[1:] if stacked else shape
        name = ps.split("/")[-1]
        if name in ("k", "v") and len(core) == 4:          # (B, Hkv, S, Dh)
            b, hkv, s, _ = core
            bax = "dp" if div(b, dp_size) else None
            if seq_shard == "full" and div(s, dp_size * tp_size):
                inner = P(None, None, ("dp", "tp"), None)
            elif (seq_shard or not div(hkv, tp_size)) and div(s, tp_size):
                inner = P(bax, None, "tp", None)
            elif div(hkv, tp_size):
                inner = P(bax, "tp", None, None)
            else:
                inner = P(bax, None, None, None)
        elif name == "conv":                               # (B, w−1, lru)
            inner = P("dp" if div(core[0], dp_size) else None, None,
                      "tp" if div(core[2], tp_size) else None)
        elif name == "h":                                  # (B, lru)
            inner = P("dp" if div(core[0], dp_size) else None,
                      "tp" if div(core[1], tp_size) else None)
        elif name == "wkv":                                # (B, H, dk, dv)
            inner = P("dp" if div(core[0], dp_size) else None,
                      "tp" if div(core[1], tp_size) else None, None, None)
        elif name in ("tshift", "cshift"):                 # (B, 1, d)
            inner = P("dp" if div(core[0], dp_size) else None, None,
                      "tp" if div(core[2], tp_size) else None)
        else:
            inner = P(*([None] * len(core)))
        return P(None, *inner) if stacked else inner

    return tree_map_with_path(leaf_spec, state_shapes)


def zero1_pspecs(pspecs: Any, shapes: Any, data_size: int) -> Any:
    """ZeRO-1: shard optimizer-state leaves over "dp" on the largest dim not
    already sharded (when divisible) — params themselves stay as-is."""

    def shard_more(spec: P, leaf) -> P:
        shape = tuple(leaf.shape)
        if len(spec) < len(shape):
            spec = P(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
        used = {a for a in spec if a is not None}
        if "dp" in used or not shape:
            return spec
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if spec[i] is None and shape[i] % data_size == 0 and shape[i] >= data_size:
                parts = list(spec)
                parts[i] = "dp"
                return P(*parts)
        return spec

    return _tree_map(shard_more, pspecs, shapes)


def logical_to_mesh(pspec_tree: Any, axis_map: AxisMap) -> Any:
    """Translate logical axis names to mesh axis names (str or tuple).

    A tuple entry like ("dp", "tp") maps each member and flattens, so one
    tensor dim can span several mesh axes (e.g. KV sequence over data+model).
    """

    def one(a):
        mapped = axis_map.get(a, a)
        return mapped if isinstance(mapped, tuple) else (mapped,)

    def translate(spec: P) -> P:
        parts = []
        for a in spec:
            if a is None:
                parts.append(None)
            elif isinstance(a, tuple):
                parts.append(sum((one(x) for x in a), ()))
            else:
                parts.append(axis_map.get(a, a))
        return P(*parts)

    return _tree_map(translate, pspec_tree)


def _axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def infer_axis_map(mesh) -> AxisMap:
    """("data","model") → dp=data; ("pod","data","model") → dp=(pod,data).
    ``mesh``: a ``torch.distributed.device_mesh.DeviceMesh``, an object
    with ``axis_names``, or a ``{axis: size}`` mapping."""
    names = tuple(mesh) if isinstance(mesh, dict) else _axis_names(mesh)
    if "pod" in names:
        return {"dp": ("pod", "data"), "tp": "model"}
    return {"dp": "data", "tp": "model"}


def compute_mesh(mesh):
    """The two-dimensional ``(dp, model)`` view of a ``("data", "model")``
    or ``("pod", "data", "model")`` device mesh on which the LM's DTensors
    live: on a multi-pod mesh ``pod`` and ``data`` are flattened into one
    dimension named ``pod_data`` (pod-major, as the reference's ``dp =
    ("pod", "data")``); a two-axis mesh is returned as it is."""
    names = _axis_names(mesh)
    if names == ("data", "model"):
        return mesh
    if names == ("pod", "data", "model"):
        # made once a mesh (its tensor ops must not run under a FakeTensorMode)
        view = getattr(mesh, "_compute_view", None)
        if view is None:
            mesh["pod", "data"]._flatten("pod_data")
            view = mesh._compute_view = mesh["pod_data", "model"]
        return view
    raise ValueError(f"an LM mesh has axes ('data', 'model') or ('pod', 'data', "
                     f"'model'), got {names}")


def placements(spec: P, mesh, axis_map: AxisMap | None = None) -> tuple:
    """The DTensor placements on ``compute_mesh(mesh)`` of one logical
    ``spec``: per mesh dimension ``Shard(d)`` where the spec names that
    dimension's axis at tensor dim ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    if axis_map is None:
        axis_map = infer_axis_map(mesh)
    cm_names = _axis_names(compute_mesh(mesh))
    flat = {("pod", "data"): "pod_data"}
    out: list = [Replicate()] * len(cm_names)
    for d, a in enumerate(logical_to_mesh(spec, axis_map)):
        if a is None:
            continue
        axes = (a,) if isinstance(a, str) else tuple(a)
        if axes[:2] in flat:                               # pod+data → pod_data
            axes = (flat[axes[:2]],) + axes[2:]
        for ax in axes:
            out[cm_names.index(ax)] = Shard(d)
    return tuple(out)


def local_shape_and_offset(shape, mesh, pls) -> tuple[list[int], list[int]]:
    """This rank's block of a tensor of global ``shape`` placed by ``pls``
    on ``mesh``: its shape and its offset in the global tensor. A
    ``Shard(d)`` splits dim ``d`` as ``torch.chunk`` does (blocks of
    ceil(n / ranks), the last ones shorter or empty), mesh dimensions in
    order. Plain integers throughout, so it runs under ``FakeTensorMode``."""
    from torch.distributed.tensor import Shard

    size, off = [int(n) for n in shape], [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            n, ranks = size[p.dim], mesh.size(i)
            chunk = -(-n // ranks)
            start = min(coord[i] * chunk, n)
            size[p.dim] = min(chunk, n - start)
            off[p.dim] += start
    return size, off


def named_shardings(mesh, pspec_tree: Any, axis_map: AxisMap | None = None) -> Any:
    """A tree of DTensor placement tuples (:func:`placements`) matching a
    tree of logical specs."""
    if axis_map is None:
        axis_map = infer_axis_map(mesh)
    return _tree_map(lambda s: placements(s, mesh, axis_map), pspec_tree)


def bytes_per_device(shapes: Any, pspecs: Any, mesh, axis_map: AxisMap | None = None) -> int:
    """Estimated per-device bytes of a sharded tree.

    ``shapes`` is a tree of values: tensors and arrays count their elements
    times their dtype's size, other leaves their ``.nbytes`` (0 for a plain
    number such as a payload's ``n_bins``). ``pspecs`` is a tree of the same
    structure with a :class:`PartitionSpec` per leaf (``P()`` for a
    replicated or non-array leaf): each leaf's bytes are divided by the
    sizes of the mesh axes its spec names, rounded up. ``mesh`` is a
    ``{axis: size}`` mapping (logical names are then taken as they are,
    unless ``axis_map`` is given) or a device mesh with axis names (its
    ``axis_map`` inferred by :func:`infer_axis_map`, as the reference).
    """
    if isinstance(mesh, dict):
        sizes = dict(mesh)
        axis_map = axis_map or {}
    else:
        if axis_map is None:
            axis_map = infer_axis_map(mesh)
        shape = mesh.shape if callable(getattr(mesh, "size", None)) and hasattr(
            mesh, "mesh_dim_names") else mesh.devices.shape
        sizes = dict(zip(_axis_names(mesh), tuple(shape)))

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

    value_leaves = tree_leaves(shapes, is_leaf=lambda x: False)
    spec_leaves = tree_leaves(pspecs)
    if len(value_leaves) != len(spec_leaves):
        raise ValueError(
            f"pspec tree has {len(spec_leaves)} leaves for {len(value_leaves)} "
            "value leaves: the trees must align leaf by leaf (P() for a "
            "replicated or non-array leaf)")
    return sum(leaf_bytes(v, s) for v, s in zip(value_leaves, spec_leaves))
