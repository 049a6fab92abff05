"""Three-term roofline analysis of a traced step, per rank of a mesh.

    compute term    = FLOPs / peak FLOP/s                    (per GPU)
    memory term     = bytes accessed / HBM bandwidth         (per GPU)
    collective term = Σ_axis collective bytes(axis) / link bandwidth(axis)

The port of the JAX package's ``roofline/analysis.py``, whose numbers
come from an XLA executable (``cost_analysis`` and its HLO text). The
port has no executable: it runs the step once, on a mesh of the ``fake``
process-group backend under ``FakeTensorMode`` in the dry-run (nothing
allocated, nothing launched), or on the card, and counts while it runs
(:func:`trace_step`):
  * FLOPs per rank: ``torch.utils.flop_counter.FlopCounterMode`` over the
    ranks' local operations (a DTensor-level operation, whose shapes are
    global, is not counted; its local operations are). A trace runs the
    kernels' plain versions (``force="ref"``): the FLOPs are theirs, and
    where autograd differentiates a kernel its recomputed plain forward
    (``ops._KernelGradByPlain``) is counted too, as on the card.
  * Bytes accessed per rank: the bytes every local operation reads and
    writes, operation by operation (views excluded). Nothing is fused, so
    this bounds what a fused step moves from above.
  * Collective bytes per kind (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``) and per
    mesh axis: each collective's operand bytes, read by a
    ``torch.distributed.tensor.debug.CommDebugMode`` (this replaces the
    reference's ``parse_collective_bytes``, which parsed HLO text).
  * Argument bytes per rank: the bytes of the arguments' local shards.
  * The peak: ``torch.distributed._tools.mem_tracker.MemTracker``'s, where
    it runs; where it raises the peak is reported absent (None), not 0.

MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE) anchors the "useful fraction":
MODEL_FLOPS / (FLOPs × ranks) catches recompute and dispatch overhead.

The hardware constants (:data:`HW_H100`) are the NVIDIA H100 SXM5 80GB's
datasheet values at 700 W, not measurements.
"""
from __future__ import annotations

import dataclasses
import sys
from collections import defaultdict
from typing import Any

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["HW_H100", "CellReport", "analyze_traced", "trace_step", "model_flops",
           "active_params", "COLLECTIVES", "RankFlopCounter", "CollectiveCounter"]

# NVIDIA H100 SXM5 80GB at 700 W, per GPU, from NVIDIA's H100 Tensor Core GPU
# datasheet (dense figures, without sparsity): BF16 Tensor Core 989 TFLOP/s,
# HBM3 3.35 TB/s, 80 GB; NVLink 4 900 GB/s per GPU (the ``model`` axis, inside
# a node of 8); NDR InfiniBand 400 Gb/s = 50 GB/s per GPU (ConnectX-7, one per
# GPU: the ``data`` and ``pod`` axes, across nodes).
HW_H100 = {
    "peak_flops": 989e12,      # bf16 FLOP/s, dense
    "hbm_bw": 3.35e12,         # bytes/s
    "hbm_bytes": 80e9,         # bytes
    "link_bw": {"model": 900e9, "data": 50e9, "pod": 50e9, "pod_data": 50e9},
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

# operations that alias their input: no bytes move
_VIEWS = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute", "expand",
          "slice", "select", "unsqueeze", "squeeze", "as_strided", "detach", "alias",
          "split", "split_with_sizes", "unbind", "chunk", "_reshape_alias", "unflatten",
          "lift_fresh", "view_as", "expand_as", "narrow", "diagonal", "movedim",
          "_to_copy_noop"}


def _tensors(tree) -> list[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_shape_propagation() -> bool:
    """Whether the running op is one that DTensor's sharding propagation
    runs on global fake tensors to learn an output's shape (no rank runs
    it): a frame of ``ShardingPropagator._propagate_tensor_meta*`` is on
    the stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


class RankFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` over a rank's local operations only, which also
    adds up the bytes each operation reads and writes (:attr:`bytes`).

    ``FlopCounterMode`` would run an operation on DTensors itself, with its
    mode popped, and count its global shapes: DTensor's local operations
    would go uncounted. Here its mode hands such an operation back
    (``NotImplemented``, as ``CommDebugMode`` does) so that DTensor runs
    it, and counts the local operations DTensor then dispatches."""

    def __init__(self):
        super().__init__(display=False)
        self.bytes = 0
        self._in_kernel = 0

    def __enter__(self):
        from torch.utils.flop_counter import _FlopCounterMode

        class _Rank(_FlopCounterMode):
            def __torch_dispatch__(mode, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                if _in_shape_propagation():
                    return func(*args, **(kwargs or {}))
                return super().__torch_dispatch__(func, types, args, kwargs)

        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _Rank(self)
        self.mode.__enter__()
        return self

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet.__name__ not in _VIEWS and not self._in_kernel:
            ins = _tensors((args, kwargs))
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, _tensors(out)))
        return super()._count_flops(func_packet, out, args, kwargs)

    def kernel(self, fn, inputs):
        """``fn(*inputs)``, a kernel's plain version (``ops.kernel_io``):
        its FLOPs counted, its bytes those of the kernel's inputs and
        outputs."""
        self._in_kernel += 1
        try:
            out = fn(*inputs)
        finally:
            self._in_kernel -= 1
        self.bytes += sum(map(_nbytes, _tensors(inputs))) + sum(map(_nbytes, _tensors(out)))
        return out


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode``, which also adds up each collective's operand
    bytes per kind (:attr:`by_kind`) and per mesh axis (:attr:`by_axis`,
    the axis whose process group runs it; ``axis_of`` maps a group name to
    its axis)."""

    def __init__(self, axis_of: dict[str, str]):
        super().__init__()
        self.axis_of = axis_of
        self.by_kind: dict[str, int] = defaultdict(int)
        self.by_axis: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is not None:
            # the operand: the first tensor argument (a list of them for c10d)
            ins = _tensors(args[1] if func._overloadpacket.__name__.endswith("_")
                           and len(args) > 1 and isinstance(args[1], (list, tuple))
                           else args[0])
            nbytes = sum(map(_nbytes, ins))
            group = next((a for a in list(args) + list((kwargs or {}).values())
                          if isinstance(a, str) and a in self.axis_of), None)
            if group is None:
                group = next((getattr(a, "group_name", None) for a in args
                              if getattr(a, "group_name", None) in self.axis_of), None)
            self.by_kind[kind] += nbytes
            self.by_axis[self.axis_of.get(group, "unknown")] += nbytes
        return out


def _axis_of(mesh) -> dict[str, str]:
    """Every process group of ``mesh``'s dimensions (and of its compute
    view's flattened ``pod_data``) by name, to its axis name."""
    from repro_torch.distributed import sharding as shd

    out = {}
    for m in {id(mesh): mesh, id(shd.compute_mesh(mesh)): shd.compute_mesh(mesh)}.values():
        for name in m.mesh_dim_names:
            out[m.get_group(name).group_name] = name
    return out


def trace_step(step_fn, args: tuple, mesh, *, track_memory: bool = True) -> dict[str, Any]:
    """Run ``step_fn(*args)`` once and count, per rank: FLOPs, bytes
    accessed, collective bytes by kind and by axis (of ``mesh``; None: no
    mesh), argument bytes (the local shards of ``args``) and the peak
    memory (None where MemTracker cannot follow the run)."""
    from torch.distributed.tensor import DTensor

    local = [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(args)]
    arg_bytes = sum(map(_nbytes, local))
    flops = RankFlopCounter()
    comm = CollectiveCounter(_axis_of(mesh) if mesh is not None else {})
    peak = None
    tracker = None
    if track_memory:
        try:
            from torch.distributed._tools.mem_tracker import MemTracker

            tracker = MemTracker()
            tracker.track_external(*[t for t in local])
            tracker.__enter__()
        except Exception:                                   # noqa: BLE001
            tracker = None
    from repro_torch.kernels.ops import kernel_io

    try:
        with flops, comm, kernel_io(flops):
            step_fn(*args)
    finally:
        if tracker is not None:
            try:
                tracker.__exit__(None, None, None)
                snap = tracker.get_tracker_snapshot("peak")
                peak = float(max(sum(v for k, v in d.items() if k != "Total") or d.get("Total", 0)
                                 for d in snap.values())) if snap else None
            except Exception:                               # noqa: BLE001
                peak = None
    by_kind = {k: int(comm.by_kind.get(k, 0)) for k in COLLECTIVES}
    by_kind["total"] = sum(by_kind.values())
    return {"flops": float(flops.get_total_flops()), "bytes": float(flops.bytes),
            "collective_bytes": by_kind, "collective_by_axis": dict(comm.by_axis),
            "argument_bytes": float(arg_bytes), "peak_bytes": peak}


def model_flops(cfg, shape, n_params: int, n_params_active: int | None = None) -> float:
    """6·N·D (train) / 2·N·D (inference forward); MoE uses active params."""
    n = n_params_active if n_params_active is not None else n_params
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def active_params(cfg, n_params: int) -> int:
    """Subtract the inactive experts' weights (top_k of n_experts active)."""
    if not cfg.n_experts:
        return n_params
    expert_matrices = 3 if cfg.ffn_act in ("swiglu", "geglu") else 2
    per_expert = expert_matrices * cfg.d_model * cfg.d_ff_expert
    n_moe_layers = sum(
        1 for s in (list(cfg.pattern) * cfg.repeats) + list(cfg.tail) if s.ffn == "moe"
    )
    inactive = (cfg.n_experts - cfg.top_k) * per_expert * n_moe_layers
    return n_params - inactive


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_fraction: float            # MODEL_FLOPS / (FLOPs × devices)
    memory_stats: dict[str, float | None]
    step_time_s: float = 0.0          # max of the three terms
    collective_by_axis: dict[str, int] = dataclasses.field(default_factory=dict)
    hw: dict = dataclasses.field(default_factory=lambda: dict(HW_H100))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (
            f"{self.arch:18s} {self.shape:12s} {self.mesh:10s} "
            f"compute={self.compute_s*1e3:9.3f}ms memory={self.memory_s*1e3:9.3f}ms "
            f"collective={self.collective_s*1e3:9.3f}ms -> {self.dominant:10s} "
            f"useful={self.useful_fraction:6.1%}"
        )


def analyze_traced(counts: dict[str, Any], *, arch: str, shape, mesh_desc: str,
                   n_devices: int, cfg=None, n_params: int | None = None,
                   hw: dict = HW_H100) -> CellReport:
    """The roofline of one traced step (:func:`trace_step`'s counts); the
    counterpart of the reference's ``analyze_compiled``."""
    flops, nbytes = counts["flops"], counts["bytes"]
    by_axis = counts["collective_by_axis"]
    links = hw["link_bw"]
    slowest = min(links.values())
    compute_s = flops / hw["peak_flops"]
    memory_s = nbytes / hw["hbm_bw"]
    collective_s = sum(b / links.get(axis, slowest) for axis, b in by_axis.items())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = useful = 0.0
    if cfg is not None and n_params is not None:
        mf = model_flops(cfg, shape, n_params, active_params(cfg, n_params))
        total = flops * n_devices
        useful = mf / total if total else 0.0
    return CellReport(
        arch=arch, shape=shape.name, mesh=mesh_desc, n_devices=n_devices,
        flops_per_device=flops, bytes_per_device=nbytes,
        collective_bytes=dict(counts["collective_bytes"]), compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, dominant=dominant,
        model_flops_total=mf, useful_fraction=useful,
        memory_stats={"argument_size_in_bytes": counts["argument_bytes"],
                      "peak_bytes": counts["peak_bytes"]},
        step_time_s=max(terms.values()), collective_by_axis=dict(by_axis), hw=dict(hw))
