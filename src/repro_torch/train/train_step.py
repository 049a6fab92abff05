"""Train-step construction on one device: loss → grads → clip → optimizer.

The port of the JAX package's ``train/train_step.py`` in its ``gspmd`` form
on one device: a step is value-and-grad of ``train_loss``, the global-norm
clip and the optimizer's update, with the reference's non-finite guard (a
step whose loss or gradient norm is NaN/inf is DROPPED: the step counter
advances, the parameters and optimizer state stay as they were). The train
state is ``{"step": int, "params": tree, "opt_state": tree}``, the params
in the JAX package's tree layout (``models.params_to_reference``), so a
checkpoint of it is the reference's.

The mesh forms are not ported yet: ``dp_mode="shard_map_int8"``, a
``mesh=`` and the partition-spec helpers raise NotImplementedError (ROADMAP
Queue 1 item 6).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import init_params, params_to_reference, train_loss
from repro_torch.models.transformer import ArchConfig
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm, tree_leaves, tree_map

__all__ = ["build_train_step", "make_train_state_specs", "init_train_state", "opt_pspecs"]

_MESH_FORMS = ("the mesh forms of the train step (data-parallel over a mesh, ZeRO-1 "
               "partition specs, the int8-compressed all-reduce) are not ported yet: "
               "ROADMAP Queue 1 item 6")


def opt_pspecs(*args, **kw):
    raise NotImplementedError(_MESH_FORMS)


def make_train_state_specs(*args, **kw):
    raise NotImplementedError(_MESH_FORMS)


def init_train_state(cfg: ArchConfig, optimizer: Optimizer, seed: int = 0,
                     device=None) -> dict[str, Any]:
    """A fresh TrainState: seeded weights (``models.init_params``) in the
    JAX package's tree layout on ``device`` (the card by default), the
    optimizer's zero state, step 0."""
    params = params_to_reference(cfg, init_params(cfg, seed=seed, device=device))
    return {"step": 0, "params": params, "opt_state": optimizer.init(params)}


def build_train_step(cfg: ArchConfig, optimizer: Optimizer, *, grad_clip: float = 1.0,
                     dp_mode: str = "gspmd", mesh=None, force=None):
    """Returns ``step_fn(state, batch) -> (new_state, metrics)``, metrics
    ``{"loss", "grad_norm"}`` as 0-d float32 tensors. ``state`` is left as
    it was. ``force`` is threaded to ``ops`` (``"ref"``: the plain path on
    the card)."""
    if dp_mode == "shard_map_int8" or mesh is not None:
        raise NotImplementedError(_MESH_FORMS)
    if dp_mode != "gspmd":
        raise ValueError(f"unknown dp_mode {dp_mode!r}")

    def step_fn(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        with torch.enable_grad():
            loss = train_loss(cfg, params, batch, force=force)
            leaves = tree_leaves(params)
            flat = torch.autograd.grad(loss, leaves)
        by_leaf = dict(zip(map(id, leaves), flat))
        grads = tree_map(lambda p: by_leaf[id(p)], params)
        loss = loss.detach()
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
