"""Optimizers on tensors: AdamW, Adafactor, SGD-momentum.

The port of the JAX package's ``train/optimizer.py``. Each optimizer is
(init, update) over a parameter tree of nested dicts of tensors (the JAX
package's layout: see ``models.transformer.params_to_reference``); its
state trees mirror the parameters. The formulas are the reference's, leaf
by leaf in float32: AdamW's bias correction ``1 − b1^t`` with ``t`` the
global step + 1, ``eps`` outside the square root, weight decay decoupled
from the moments; Adafactor's factored second moments for leaves of two or
more axes (a leaf stacked over the repeats counts as one), its relative
update clipping over the whole leaf. ``torch.optim.AdamW`` differs in
these details, so it is not used. ``update`` returns new tensors and leaves
its inputs as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["Optimizer", "adamw", "adafactor", "sgdm", "make_optimizer",
           "clip_by_global_norm", "tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts (``is_leaf`` stops early)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _unzip(out, n: int):
    """A tree of n-tuples as n trees."""
    is_tuple = lambda x: isinstance(x, tuple)  # noqa: E731
    return tuple(tree_map(lambda o, i=i: o[i], out, is_leaf=is_tuple) if isinstance(out, dict)
                 else out[i] for i in range(n))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def _f32(x: float) -> float:
    """A float32 scalar as the Python float that holds it exactly."""
    return float(np.float32(x))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / ‖grads‖)``; returns the
    clipped tree and the global norm (a 0-d float32 tensor)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params),
                "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)}

    def update(grads, state, params, step):
        t = np.float32(int(step) + 1)
        # float32 bias corrections of the float32 step, as the reference's
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)

        def leaf(g, m, v, p):
            gf, pf = g.float(), p.float()
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
            return (pf - lr * upd).to(p.dtype), m, v

        new_p, new_m, new_v = _unzip(tree_map(leaf, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v}

    return Optimizer("adamw", init, update)


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moments: O(rows + cols) state for a matrix."""

    def init(params):
        def leaf(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
            if p.dim() >= 2:
                return {"row": z(p.shape[:-1]), "col": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return tree_map(leaf, params)

    def update(grads, state, params, step):
        t = np.float32(int(step) + 1)
        beta = _f32(np.float32(1) - t ** np.float32(-decay))

        def leaf(g, s, p):
            gf = g.float()
            g2 = gf * gf + eps
            if p.dim() >= 2:
                row = beta * s["row"] + (1 - beta) * g2.mean(dim=-1)
                col = beta * s["col"] + (1 - beta) * g2.mean(dim=-2)
                row_mean = row.mean(dim=-1, keepdim=True)
                vhat = (row / torch.clamp(row_mean, min=eps))[..., None] * col[..., None, :]
                upd = gf / torch.sqrt(torch.clamp(vhat, min=eps))
                new_s = {"row": row, "col": col}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                upd = gf / torch.sqrt(torch.clamp(v, min=eps))
                new_s = {"v": v}
            # relative update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(torch.mean(upd * upd))
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            return (p.float() - lr * upd).to(p.dtype), new_s

        is_state = lambda x: isinstance(x, dict) and ("row" in x or "v" in x)  # noqa: E731
        out = tree_map(lambda s, g, p: leaf(g, s, p), state, grads, params, is_leaf=is_state)
        return _unzip(out, 2)

    return Optimizer("adafactor", init, update)


def sgdm(lr: float = 0.1, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)}

    def update(grads, state, params, step):
        del step

        def leaf(g, m, p):
            m = momentum * m + g.float()
            return (p.float() - lr * m).to(p.dtype), m

        new_p, new_m = _unzip(tree_map(leaf, grads, state["m"], params), 2)
        return new_p, {"m": new_m}

    return Optimizer("sgdm", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "sgdm":
        return sgdm(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
