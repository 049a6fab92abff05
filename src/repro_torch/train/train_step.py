"""Train-step construction: loss → grads → clip → optimizer, on one device
or over a device mesh.

The port of the JAX package's ``train/train_step.py``. A step is
value-and-grad of ``train_loss``, the global-norm clip and the optimizer's
update, with the reference's non-finite guard (a step whose loss or
gradient norm is NaN/inf is DROPPED: the step counter advances, the
parameters and optimizer state stay as they were). The train state is
``{"step": int, "params": tree, "opt_state": tree}``, the params in the
JAX package's tree layout (``models.params_to_reference``), so a
checkpoint of it is the reference's.

Two DP modes over a mesh (``mesh=``, a ``torch.distributed`` device mesh
with axes ``("data", "model")`` or ``("pod", "data", "model")``):
  * ``gspmd`` — params and optimizer state are DTensors placed per
    ``param_pspecs`` / ``zero1_pspecs`` (FSDP when ``fsdp``); the batch is
    sharded over dp. DTensor's propagation inserts the collectives (the
    counterpart of GSPMD's), and the update's results are put back on the
    state's placements. The guard is in the graph (``torch.where``), as
    the reference's, so the step traces without reading a device value.
  * ``shard_map_int8`` — each dp rank takes the gradients of its own batch
    block (params gathered over dp, tensor parallelism kept on ``model``),
    reduces them with ``compressed_psum`` over the dp ranks, and carries
    the quantisation residual to the next step in ``state["residual"]``
    (each rank its own; a checkpoint leaves it out, and a restored run
    starts it at zero, as the reference never keeps it).

Without a mesh the step runs on one device, the guard on the host.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import init_params, params_to_reference, train_loss
from repro_torch.models.transformer import ArchConfig
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm, tree_leaves, tree_map

__all__ = ["build_train_step", "make_train_state_specs", "init_train_state", "opt_pspecs",
           "distribute_tree", "gather_tree", "data_size_of"]

P = shd.P


def opt_pspecs(opt_name: str, param_specs: Any, param_shapes: Any) -> Any:
    """Optimizer-state pspecs derived from param pspecs."""
    if opt_name in ("adamw",):
        return {"m": param_specs, "v": param_specs}
    if opt_name == "sgdm":
        return {"m": param_specs}
    if opt_name == "adafactor":
        def leaf(spec: P, shape) -> dict:
            nd = len(shape.shape)
            spec = P(*(tuple(spec) + (None,) * (nd - len(spec))))
            if nd >= 2:
                return {"row": P(*spec[:-1]), "col": P(*(tuple(spec[:-2]) + (spec[-1],)))}
            return {"v": spec}

        return tree_map(leaf, param_specs, param_shapes, is_leaf=lambda x: isinstance(x, P))
    raise ValueError(opt_name)


def make_train_state_specs(cfg: ArchConfig, optimizer: Optimizer, *, fsdp: bool = False,
                           zero1: bool = True, data_size: int = 1) -> tuple[Any, Any]:
    """Returns (state_shapes, state_logical_pspecs): the shapes as tensors
    on the ``meta`` device (nothing allocated), the specs as the
    reference's."""
    param_shapes = params_to_reference(cfg, init_params(cfg, device="meta"))
    p_specs = shd.param_pspecs(param_shapes, fsdp=fsdp)
    opt_shapes = optimizer.init(param_shapes)
    o_specs = opt_pspecs(optimizer.name, p_specs, param_shapes)
    if zero1:
        o_specs = shd.zero1_pspecs(o_specs, opt_shapes, data_size)
    state_shapes = {"step": torch.empty((), dtype=torch.int32, device="meta"),
                    "params": param_shapes, "opt_state": opt_shapes}
    return state_shapes, {"step": P(), "params": p_specs, "opt_state": o_specs}


def data_size_of(mesh) -> int:
    """The dp size of a mesh: the product of its axes other than ``model``."""
    size = 1
    for name, n in zip(mesh.mesh_dim_names, mesh.shape):
        if name != "model":
            size *= n
    return size


def distribute_tree(tree: Any, mesh, pspecs: Any) -> Any:
    """Each tensor leaf of ``tree`` (the same value on every rank) as a
    DTensor on ``shd.compute_mesh(mesh)`` placed per its logical spec; each
    rank keeps its own block and nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    cm = shd.compute_mesh(mesh)
    shardings = shd.named_shardings(mesh, pspecs)

    def leaf(_, t, pl):
        if not isinstance(t, torch.Tensor):
            return t
        if isinstance(t, DTensor):
            return t.redistribute(cm, pl)
        return distribute_tensor(t, cm, pl, src_data_rank=None)

    return shd.tree_map_with_path(leaf, tree, shardings, is_leaf=_is_value)


def _is_value(x) -> bool:
    return not isinstance(x, (dict, list, tuple))


def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf as the whole tensor (a collective: every rank
    calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return shd.tree_map_with_path(
        lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree, is_leaf=_is_value)


def init_train_state(cfg: ArchConfig, optimizer: Optimizer, seed: int = 0,
                     device=None, *, mesh=None, state_specs: Any = None) -> dict[str, Any]:
    """A fresh TrainState: seeded weights (``models.init_params``) in the
    JAX package's tree layout on ``device`` (the card by default), the
    optimizer's zero state, step 0. With ``mesh`` every rank draws the
    same weights and keeps its block of each, placed per ``state_specs``
    (``make_train_state_specs``)."""
    if mesh is not None:
        device = mesh.device_type if device is None else device
    params = params_to_reference(cfg, init_params(cfg, seed=seed, device=device))
    state = {"step": 0, "params": params, "opt_state": optimizer.init(params)}
    if mesh is None:
        return state
    return {"step": 0,
            "params": distribute_tree(params, mesh, state_specs["params"]),
            "opt_state": distribute_tree(state["opt_state"], mesh, state_specs["opt_state"])}


def _grads(cfg, params, batch, force, remat="none"):
    """(loss, grads) of ``train_loss`` at ``params``, grads in their tree."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = train_loss(cfg, params, batch, force=force, remat=remat)
        leaves = tree_leaves(params)
        flat = torch.autograd.grad(loss, leaves)
    by_leaf = dict(zip(map(id, leaves), flat))
    return loss.detach(), tree_map(lambda p: by_leaf[id(p)], params)


def build_train_step(cfg: ArchConfig, optimizer: Optimizer, *, grad_clip: float = 1.0,
                     dp_mode: str = "gspmd", mesh=None, force=None, state_specs: Any = None,
                     remat: str | None = None):
    """Returns ``step_fn(state, batch) -> (new_state, metrics)``, metrics
    ``{"loss", "grad_norm"}`` as 0-d float32 tensors (whole on every rank
    on a mesh). ``state`` is left as it was. ``force`` is threaded to
    ``ops`` (``"ref"``: the plain path on the card). On a mesh
    ``state_specs`` are the state's logical specs
    (``make_train_state_specs``), which the new state is placed by.
    ``remat`` (``"full"``, ``"dots"``) recomputes each layer in the
    backward; the default keeps its activations."""
    remat = remat or "none"
    if dp_mode not in ("gspmd", "shard_map_int8"):
        raise ValueError(f"unknown dp_mode {dp_mode!r}")
    if mesh is None:
        if dp_mode == "shard_map_int8":
            raise ValueError("shard_map_int8 needs the mesh")
        return _local_step(cfg, optimizer, grad_clip, force, remat)
    if state_specs is None:
        raise ValueError("a train step over a mesh needs the state's specs")
    if dp_mode == "gspmd":
        return _gspmd_step(cfg, optimizer, grad_clip, mesh, force, state_specs, remat)
    return _int8_step(cfg, optimizer, grad_clip, mesh, force, state_specs, remat)


def _local_step(cfg, optimizer, grad_clip, force, remat):
    def step_fn(state, batch):
        loss, grads = _grads(cfg, state["params"], batch, force, remat)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        # the non-finite guard: a NaN/inf step is dropped before the update
        if not bool(torch.isfinite(loss) & torch.isfinite(gnorm)):
            new_state = {**state, "step": state["step"] + 1}
        else:
            new_params, new_opt = optimizer.update(
                grads, state["opt_state"], state["params"], state["step"])
            new_state = {"step": state["step"] + 1, "params": new_params,
                         "opt_state": new_opt}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step_fn


def _update_on_mesh(optimizer, grads, gnorm, loss, state, mesh, state_specs):
    """The optimizer's update of DTensor leaves, the guard in the graph,
    and the new state put back on the state's placements."""
    from torch.distributed.tensor import DTensor

    new_params, new_opt = optimizer.update(grads, state["opt_state"], state["params"],
                                           state["step"])
    ok = torch.isfinite(loss) & torch.isfinite(gnorm)
    ok = ok.full_tensor() if isinstance(ok, DTensor) else ok

    def keep(new, old):
        return torch.where(ok, new, old)

    new_params = distribute_tree(tree_map(keep, new_params, state["params"]), mesh,
                                 state_specs["params"])
    new_opt = distribute_tree(tree_map(keep, new_opt, state["opt_state"]), mesh,
                              state_specs["opt_state"])
    return {**state, "step": state["step"] + 1, "params": new_params, "opt_state": new_opt}


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _gspmd_step(cfg, optimizer, grad_clip, mesh, force, state_specs, remat):
    from torch.distributed.tensor.experimental import implicit_replication

    def step_fn(state, batch):
        with implicit_replication():
            loss, grads = _grads(cfg, state["params"], batch, force, remat)
            grads = distribute_tree(grads, mesh, state_specs["params"])
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            new_state = _update_on_mesh(optimizer, grads, gnorm, loss, state, mesh,
                                        state_specs)
        return new_state, {"loss": _whole(loss), "grad_norm": _whole(gnorm)}

    return step_fn


def _int8_step(cfg, optimizer, grad_clip, mesh, force, state_specs, remat):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.compat import MeshAxis
    from repro_torch.distributed.collectives import compressed_psum

    cm = shd.compute_mesh(mesh)
    dp_name, tp_name = cm.mesh_dim_names
    tp_mesh, dp_axis = cm[tp_name], MeshAxis(cm, dp_name)

    def on_tp(t):
        """A 2-D DTensor as the tp-only DTensor of this dp rank's block:
        replicated over dp first (FSDP's shards gathered)."""
        if not isinstance(t, DTensor):
            return t
        whole_dp = t.redistribute(cm, (Replicate(), t.placements[1]))
        return DTensor.from_local(whole_dp.to_local(), tp_mesh, (t.placements[1],),
                                  run_check=False, shape=t.shape, stride=t.stride())

    def local_batch(t):
        """This dp rank's batch block (tp-replicated)."""
        if not isinstance(t, DTensor):
            return t
        local = t.redistribute(cm, (t.placements[0], Replicate())).to_local()
        return DTensor.from_local(local, tp_mesh, (Replicate(),), run_check=False)

    def to_mesh(t):
        """A tp-only DTensor, the same on every dp rank, back on the 2-D mesh."""
        return DTensor.from_local(t.to_local(), cm, (Replicate(), t.placements[0]),
                                  run_check=False, shape=t.shape, stride=t.stride())

    def step_fn(state, batch):
        with implicit_replication():
            params = tree_map(on_tp, state["params"])
            loss, grads = _grads(cfg, params, tree_map(local_batch, batch), force, remat)
            # each leaf's gradient on its parameter's tp placement (no partial sums)
            grads = tree_map(lambda g, p: g.redistribute(tp_mesh, p.placements), grads, params)
            grads, residual = compressed_psum(grads, dp_axis, state.get("residual"))
            loss = dp_axis.psum(_whole(loss)) / dp_axis.size
            grads, gnorm = clip_by_global_norm(tree_map(to_mesh, grads), grad_clip)
            new_state = _update_on_mesh(optimizer, grads, gnorm, loss, state, mesh,
                                        state_specs)
        new_state["residual"] = residual
        return new_state, {"loss": loss, "grad_norm": _whole(gnorm)}

    return step_fn
