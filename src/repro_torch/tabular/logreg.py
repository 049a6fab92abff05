"""Logistic regression in PyTorch — stands in for scikit-learn's LR (paper §V-A).

Full-batch Adam on L2-regularised logistic loss; ``c`` is the inverse
regularisation strength exactly as in sklearn's ``LogisticRegression(C=...)``.
The configs of a fused batch stay stacked — W (C, F), one ``x @ W.T`` per
step — and a config past its own step count freezes its whole carry, as
the JAX package's vmapped program does. Every config trains in a stack of
``STACK_WIDTH`` slots, alone or fused, so fusing never changes its result
(see ``STACK_WIDTH``). The Adam step is written out as the reference writes
it (bias correction from the global step index), in float32, so a resumed
run continues the exact sequence of a straight one. On a row-sharded
payload (DESIGN.md §3.9) the step is data-parallel: per-shard gradients,
their mean over shards, one replicated carry.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.data_format import is_sharded_payload
from repro_torch.core.evaluation import predict_compile_cache, stable_sigmoid
from repro_torch.core.interface import (
    Estimator,
    ResumeState,
    TrainedModel,
    register_estimator,
)
from repro_torch.device import default_device

__all__ = ["LogRegEstimator", "LogRegModel", "STACK_WIDTH"]

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
#: configs train in stacks of this many slots (the Session's default fused
#: batch size), the unused slots frozen from the first step. A config then
#: runs the same kernels at the same shapes whether it trains alone or in
#: any fused batch, and slots do not interact, so fusing never changes its
#: result. With the stack as wide as the batch, BLAS picks other kernels
#: for other widths (one column takes a matrix-vector path): the port's
#: MLPs at learning rate 0.3 then ended up to 0.039 apart in AUC, fused
#: against alone.
STACK_WIDTH = 16


def stacked(items: list, fill) -> list:
    """At most STACK_WIDTH ``items``, padded to STACK_WIDTH with ``fill``."""
    if len(items) > STACK_WIDTH:
        raise ValueError(f"{len(items)} configs exceed a stack of {STACK_WIDTH}")
    return list(items) + [fill] * (STACK_WIDTH - len(items))


def adam_update(ps, gs, ms, vs, lrs, i: int):
    """One Adam update of the parameter tensors ``ps`` with gradients
    ``gs``, in the reference's float operations; returns ``(ps', ms', vs')``
    as lists. ``lrs[j]`` broadcasts against ``ps[j]`` (one rate per config).
    The bias corrections ``1 − β^t`` (t = i + 1, the global step) are
    float32, as the reference's traced step index computes them."""
    t, one = np.float32(i + 1), np.float32(1.0)
    bc1, bc2 = float(one - np.float32(BETA1) ** t), float(one - np.float32(BETA2) ** t)
    mul, add, div = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    ms = add(mul(ms, BETA1), mul(gs, 1 - BETA1))
    vs = add(mul(vs, BETA2), mul(mul(gs, 1 - BETA2), gs))
    step = div(mul(lrs, div(ms, bc1)), torch._foreach_add(torch._foreach_sqrt(div(vs, bc2)), EPS))
    return torch._foreach_sub(ps, step), ms, vs


def logistic_loss(logits, y):
    """Per-element logistic loss in the reference's overflow-free form."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * y
            + torch.log1p(torch.exp(-torch.abs(logits))))


class Liveness:
    """Which configs of a stack still step at step i, as a (C,) bool
    tensor on ``device`` (None: all of them; False: none)."""

    def __init__(self, n_steps: Sequence[int], device):
        self.n_steps, self.device = list(n_steps), device
        self._key, self._mask = None, None

    def flags(self, i: int) -> list[bool]:
        return [i < k for k in self.n_steps]

    def at(self, i: int):
        key = tuple(self.flags(i))
        if not any(key):
            return False
        if all(key):
            return None
        if key != self._key:              # the pattern changes at few steps
            self._key, self._mask = key, torch.tensor(key, device=self.device)
        return self._mask


def freeze(active, new, old):
    """``new`` where the config (leading axis) is active, else ``old``."""
    if active is None:
        return new
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _sharded_grads(x, y, valid, w, b, reg, axis, n_global: int):
    """The gradients of the sharded loss (DESIGN.md §3.9): ``x`` (S, Rs, F)
    and ``y``/``valid`` (S, Rs) are the shards' row blocks. Each shard's
    loss is its valid rows' NLL sum scaled by ``S / n_global``, plus the L2
    term, so that the MEAN over shards of the per-shard gradients
    (``psum_tree``, shards added in order) is the global gradient with the
    regularisation counted once. Every shard differentiates its own copy of
    the parameters, so its gradient is its own loss's alone."""
    from repro_torch.distributed.collectives import psum_tree

    s = axis.size
    ws = w.detach()[None].repeat(s, 1, 1).requires_grad_()      # (S, C, F)
    bs = b.detach()[None].repeat(s, 1).requires_grad_()         # (S, C)
    logits = torch.bmm(x, ws.transpose(1, 2)) + bs[:, None, :]  # (S, Rs, C)
    per = logistic_loss(logits, y[..., None])
    nll = s * torch.where(valid[..., None], per, torch.zeros_like(per)).sum(1) / n_global
    loss = (nll + reg * (ws * ws).sum(2)).sum()
    return psum_tree(list(torch.autograd.grad(loss, (ws, bs))), axis)


def _adam_logreg(x, y, c, lr, n_steps: Sequence[int], carry, start: int, steps: int,
                 *, axis=None, row_valid=None, n_global: int | None = None):
    """Run global steps ``start .. start + steps`` of full-batch Adam for a
    stack of C configs. ``c``/``lr``: (C,) float32; ``carry`` =
    ((w (C, F), b (C,)), (mw, mb), (vw, vb)). Config k's steps past
    ``n_steps[k]`` leave its carry as it was. With ``axis`` (a
    :class:`~repro_torch.compat.ShardAxis`) the rows are shard blocks and
    the gradient is :func:`_sharded_grads`'; the carry stays one copy, the
    same on every shard."""
    n = x.shape[0] if n_global is None else n_global
    reg = 0.5 / (c * n)                                  # (C,)
    lr_w = lr[:, None]
    (w, b), (mw, mb), (vw, vb) = carry
    live = Liveness(n_steps, x.device)
    with torch.enable_grad():
        for i in range(start, start + steps):
            active = live.at(i)
            if active is False:
                break                                    # every config is frozen
            if axis is not None:
                grads = _sharded_grads(x, y, row_valid, w, b, reg, axis, n)
            else:
                wg = w.detach().requires_grad_()
                bg = b.detach().requires_grad_()
                logits = x @ wg.T + bg                   # (R, C)
                loss = (logistic_loss(logits, y[:, None]).mean(0)
                        + reg * (wg * wg).sum(1)).sum()
                grads = list(torch.autograd.grad(loss, (wg, bg)))
            new = adam_update([w, b], grads, [mw, mb], [vw, vb], [lr_w, lr], i)
            (w, b), (mw, mb), (vw, vb) = (
                [freeze(active, a, o) for a, o in zip(fresh, old)]
                for fresh, old in zip(new, ([w, b], [mw, mb], [vw, vb])))
    return (w, b), (mw, mb), (vw, vb)


def _zero_carry(n_configs: int, d: int, device):
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return (z(n_configs, d), z(n_configs)), (z(n_configs, d), z(n_configs)), \
        (z(n_configs, d), z(n_configs))


def idle_slot(ps, **rate) -> dict:
    """An unused stack slot beside the configs ``ps``: rate 0, so its carry
    never moves, and live to their last step, so it freezes nothing."""
    return {**rate, "steps": max(int(p["steps"]) for p in ps)}


def _f32s(values, device) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32), device=device)


def _score(x, w, b):
    return (x @ w.T + b[None, :]).T


def _batched_margins(models, x, *, cache=None) -> np.ndarray:
    """(B, rows) margins: a stacked weight batch scores as ONE matmul, the
    program of the predict cache's ``("logreg.predict", B, x.shape)``."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, np.float32), device=default_device())
    cache = cache if cache is not None else predict_compile_cache()
    fn = cache.get(("logreg.predict", len(models), tuple(x.shape)), lambda: _score)
    w = torch.tensor(np.stack([m.w for m in models]).astype(np.float32), device=x.device)
    b = _f32s([m.b for m in models], x.device)
    return fn(x.float(), w, b).cpu().numpy()


class LogRegModel(TrainedModel):
    def __init__(self, w: np.ndarray, b: float):
        self.w, self.b = np.asarray(w), float(b)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        z = np.asarray(x, np.float32) @ self.w + self.b
        return stable_sigmoid(z)

    # ---- device validation plane (DESIGN.md §3.4) -----------------------
    def predict_margin_device(self, x, *, cache=None) -> np.ndarray:
        return _batched_margins([self], x, cache=cache)[0]

    def predict_proba_device(self, x, *, cache=None) -> np.ndarray:
        return stable_sigmoid(self.predict_margin_device(x, cache=cache))

    @classmethod
    def predict_margin_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return _batched_margins(models, x, cache=cache)

    @classmethod
    def predict_proba_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return stable_sigmoid(_batched_margins(models, x, cache=cache))


@register_estimator
class LogRegEstimator(Estimator):
    name = "logreg"
    data_format = "dense_rows"
    budget_param = "steps"

    def default_params(self) -> dict[str, Any]:
        return {"c": 1.0, "lr": 0.05, "steps": 200}

    def _fit(self, data, ps, carry, start: int, steps: int):
        """Steps ``start ..`` of the configs ``ps`` in one stack; ``carry``
        holds a slot per config and per unused slot."""
        x = data["x"]
        ps = stacked(ps, idle_slot(ps, c=1.0, lr=0.0))
        args = (_f32s([p["c"] for p in ps], x.device), _f32s([p["lr"] for p in ps], x.device),
                [int(p["steps"]) for p in ps], carry, start, steps)
        if not is_sharded_payload(data):
            return _adam_logreg(x, data["y"], *args)
        return compat.sharded_call(
            lambda axis, xs, ys, vs: _adam_logreg(xs, ys, *args, axis=axis, row_valid=vs,
                                                  n_global=int(data["_n_rows"])),
            n_shards=int(data["_n_shards"]),
        )(x, data["y"], data["_shard_valid"])

    def train(self, data, params: Mapping[str, Any]) -> LogRegModel:
        return self._train_stacks(data, [{**self.default_params(), **params}])[0]

    # ---- adaptive search (DESIGN.md §3.6) -------------------------------
    def train_resumable(self, data, params: Mapping[str, Any], *,
                        budget: int, state: ResumeState | None = None):
        p = {**self.default_params(), **params, "steps": int(budget)}
        x = data["x"]
        target = int(budget)
        carry = _zero_carry(STACK_WIDTH, x.shape[-1], x.device)
        start = 0
        if state is not None:
            start = int(state.budget)
            pl = state.payload
            for (a, b), keys in zip(carry, (("w", "b"), ("mw", "mb"), ("vw", "vb"))):
                a[0], b[0] = (torch.tensor(np.asarray(pl[k], np.float32)) for k in keys)
        if target > start:
            carry = self._fit(data, [p], carry, start, target - start)
        (w, b), (mw, mb), (vw, vb) = ([a[0].cpu().numpy() for a in pair] for pair in carry)
        model = LogRegModel(w, float(b))
        new_state = ResumeState(self.name, max(target, start),
                                {"w": w, "b": b, "mw": mw, "mb": mb,
                                 "vw": vw, "vb": vb})
        return model, new_state

    # ---- fused batches (core/fusion.py, DESIGN.md §3.2) -----------------
    def fuse_signature(self, params: Mapping[str, Any]):
        return ("logreg",)

    def fuse_bucket(self, params: Mapping[str, Any]) -> tuple:
        from repro_torch.core.fusion import pad_pow2

        p = {**self.default_params(), **params}
        return (pad_pow2(int(p["steps"])),)

    def train_batched(self, data, configs, *, cache=None) -> list[LogRegModel]:
        """The configs trained stacked (see :func:`_adam_logreg`), in stacks
        of ``STACK_WIDTH``; each gets its own step count. The program comes
        from ``cache`` (default the process-wide compile cache) under the
        reference's key, steps and batch axis padded to powers of two."""
        from repro_torch.core import fusion

        ps = [{**self.default_params(), **c} for c in configs]
        x = data["x"]
        pad_steps = fusion.pad_pow2(max(int(p["steps"]) for p in ps))
        key = ("logreg", pad_steps, len(fusion.pad_configs(ps)[0]), tuple(x.shape))
        if is_sharded_payload(data):
            key += (int(data["_n_shards"]),)
        cc = cache if cache is not None else fusion.compile_cache()
        fit = cc.get(key, lambda: self._train_stacks)
        return fit(data, ps)

    def _train_stacks(self, data, ps) -> list[LogRegModel]:
        """The compile cache's program for one signature: the configs in
        stacks of ``STACK_WIDTH``."""
        x = data["x"]
        models = []
        for i in range(0, len(ps), STACK_WIDTH):
            chunk = ps[i:i + STACK_WIDTH]
            carry = _zero_carry(STACK_WIDTH, x.shape[-1], x.device)
            (w, b), _, _ = self._fit(data, chunk, carry, 0,
                                     max(int(p["steps"]) for p in chunk))
            w_np, b_np = w.cpu().numpy(), b.cpu().numpy()
            models += [LogRegModel(w_np[k], float(b_np[k])) for k in range(len(chunk))]
        return models

    @staticmethod
    def estimate_cost(params: Mapping[str, Any], n_rows: int, n_features: int) -> float:
        steps = int(params.get("steps", 200))
        flops = 4.0 * steps * n_rows * n_features  # fwd+bwd matvec
        return flops / 2e9  # effective CPU-core FLOP/s; relative scale is what LPT needs
