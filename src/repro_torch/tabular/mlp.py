"""Multilayer perceptron in PyTorch — stands in for the paper's TensorFlow MLPs.

The paper's TF grid varies ``network`` ("128_128", "64_64_64", ...) and
``learning_rate``; we accept the same string encoding. Minibatch Adam on
ReLU hidden layers in float32. The configs of a fused batch share the
architecture and batch size and train stacked: each layer is one ``bmm``
over (C, d_in, d_out), in stacks of ``logreg.STACK_WIDTH`` slots whether a
config trains alone or fused, so fusing never changes its result. Each
config draws its initial weights and then its
minibatch indices from its own generator (:mod:`repro_torch.tabular.draws`),
whose state is the resume carry's PRNG part; a config past its own step
count neither draws nor updates. On a row-sharded payload (DESIGN.md §3.9)
the step is data-parallel: the indices are drawn over the full row range,
each shard's gradient counts the rows of its own block, and the mean over
shards updates one replicated carry.
"""
from __future__ import annotations

import functools
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
from repro_torch.tabular.draws import MLPDraws, to_device
from repro_torch.tabular.logreg import (
    STACK_WIDTH,
    Liveness,
    adam_update,
    freeze,
    idle_slot,
    logistic_loss,
    stacked,
)

__all__ = ["MLPEstimator", "MLPModel"]



def _forward(params, x):
    """Logits (C, rows) of a stacked parameter batch on rows ``x`` (C, rows, d)."""
    h = x
    for i, (w, b) in enumerate(params):
        h = torch.bmm(h, w) + b[:, None, :]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h[..., 0]


def _sharded_grads(x, y, idx, params, axis):
    """The gradients of the sharded minibatch loss (DESIGN.md §3.9): ``x``
    (S, Rs, d) and ``y`` (S, Rs) are the shards' row blocks and ``idx`` (C,
    bs) the step's GLOBAL row indices, drawn over the full row range as the
    unsharded step draws them. Shard s takes the indices in its own block
    and masks the rest; its loss is its rows' sum scaled by ``S / bs``, so
    the MEAN over shards of the per-shard gradients (``psum_tree``, shards
    added in order) is the global batch-mean gradient. Every shard
    differentiates its own copy of ``params`` (the flat stacked list),
    stacked as (S·C, ...)."""
    from repro_torch.distributed.collectives import psum_tree

    s, rs = y.shape
    c, bs = idx.shape
    lo = (torch.arange(s, device=x.device) * rs)[:, None, None]
    own = (idx[None] >= lo) & (idx[None] < lo + rs)                # (S, C, bs)
    local = torch.clamp(idx[None] - lo, 0, rs - 1)
    shard = torch.arange(s, device=x.device)[:, None, None]
    xb, yb = x[shard, local], y[shard, local]                       # (S, C, bs, ·)
    leaves = [t.detach().repeat((s,) + (1,) * (t.dim() - 1)).requires_grad_()
              for t in params]
    logits = _forward(_pairs(leaves), xb.reshape(s * c, bs, -1)).reshape(s, c, bs)
    per = logistic_loss(logits, yb)
    loss = (s * torch.where(own, per, torch.zeros_like(per)).sum(-1) / bs).sum()
    grads = torch.autograd.grad(loss, leaves)
    return psum_tree([g.reshape((s, c) + g.shape[1:]) for g in grads], axis)


def _pairs(ts):
    """A flat [w0, b0, w1, b1, ...] list as [(w0, b0), (w1, b1), ...]."""
    return list(zip(ts[0::2], ts[1::2]))


def _adam_mlp(x, y, lr, n_steps: Sequence[int], carry, draws, start: int,
              steps: int, batch_size: int, *, axis=None, n_global: int | None = None):
    """Run global steps ``start .. start + steps`` of minibatch Adam for a
    stack of C configs sharing one architecture. ``lr``: (C,) float32;
    ``carry`` = (params, m, v), each a list of stacked (w (C, d_in, d_out),
    b (C, d_out)); ``draws[k].step_batches(...)`` gives config k's rows of
    its steps. Config k's steps past ``n_steps[k]`` draw nothing and change
    nothing. With ``axis`` (a :class:`~repro_torch.compat.ShardAxis`) the
    rows are shard blocks, the indices are drawn over ``n_global`` rows and
    the gradient is :func:`_sharded_grads`'; the carry stays one copy."""
    n = x.shape[0] if n_global is None else n_global
    flat = lambda layers: [t for wb in layers for t in wb]  # noqa: E731
    params, m, v = (flat(c) for c in carry)
    lrs = [lr.reshape((-1,) + (1,) * (p.dim() - 1)) for p in params]
    live = Liveness(n_steps, x.device)
    # every config's rows for the steps it runs here (i < n_steps[k]), drawn
    # at once and moved in one copy, not a draw and a copy a config a step;
    # a slot at rest reads row 0
    idx_all = torch.zeros((steps, len(draws), batch_size), dtype=torch.int64)
    for k, d in enumerate(draws):
        count = max(0, min(start + steps, n_steps[k]) - start)
        if d is not None and count:
            idx_all[:count, k] = d.step_batches(start, count, n, batch_size)
    idx_all = to_device(idx_all, x.device)
    with torch.enable_grad():
        for i in range(start, start + steps):
            active = live.at(i)
            if active is False:
                break
            idx = idx_all[i - start]                                        # (C, bs)
            if axis is not None:
                grads = _sharded_grads(x, y, idx, params, axis)
            else:
                xb, yb = x[idx], y[idx]
                leaves = [t.detach().requires_grad_() for t in params]
                loss = logistic_loss(_forward(_pairs(leaves), xb), yb).mean(1).sum()
                grads = list(torch.autograd.grad(loss, leaves))
            new = adam_update(params, grads, m, v, lrs, i)
            params, m, v = ([freeze(active, a, o) for a, o in zip(fresh, old)]
                            for fresh, old in zip(new, (params, m, v)))
    return _pairs(params), _pairs(m), _pairs(v)


def _stack(per_config):
    """Per-config layer lists → one list of stacked (w, b) layers."""
    return [tuple(torch.stack(t) for t in zip(*layer)) for layer in zip(*per_config)]


def _zeros_like(params):
    return [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]


def _stacked_forward(x, stacked):
    return _forward(stacked, x[None].expand(stacked[0][0].shape[0], *x.shape))


def _batched_logits(models, x, *, cache=None) -> np.ndarray:
    """(B, rows) logits for models grouped by architecture, each group one
    stacked forward pass: the program of the predict cache's
    ``("mlp.predict", dims, n, x.shape)``."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, np.float32), device=default_device())
    x = x.float()
    cache = cache if cache is not None else predict_compile_cache()
    out = np.empty((len(models), x.shape[0]), np.float32)
    groups: dict[tuple, list[int]] = {}
    for i, m in enumerate(models):
        groups.setdefault(tuple(w.shape for w, _ in m.params), []).append(i)
    for dims, idxs in groups.items():
        fn = cache.get(("mlp.predict", dims, len(idxs), tuple(x.shape)),
                       lambda: _stacked_forward)
        stacked = [
            tuple(torch.tensor(np.stack([models[i].params[li][k] for i in idxs]),
                               device=x.device) for k in (0, 1))
            for li in range(len(dims))
        ]
        out[idxs] = fn(x, stacked).cpu().numpy()
    return out


class MLPModel(TrainedModel):
    def __init__(self, params):
        self.params = [(np.asarray(w), np.asarray(b)) for w, b in params]

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        h = np.asarray(x, np.float32)
        for i, (w, b) in enumerate(self.params):
            h = h @ w + b
            if i < len(self.params) - 1:
                h = np.maximum(h, 0)
        return stable_sigmoid(h[:, 0])

    # ---- device validation plane (DESIGN.md §3.4) -----------------------
    def predict_margin_device(self, x, *, cache=None) -> np.ndarray:
        return _batched_logits([self], x, cache=cache)[0]

    def predict_proba_device(self, x, *, cache=None) -> np.ndarray:
        return stable_sigmoid(self.predict_margin_device(x, cache=cache))

    @classmethod
    def predict_margin_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return _batched_logits(models, x, cache=cache)

    @classmethod
    def predict_proba_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return stable_sigmoid(_batched_logits(models, x, cache=cache))


def _unstack(params, k: int):
    return [(w[k].cpu().numpy(), b[k].cpu().numpy()) for w, b in params]


@register_estimator
class MLPEstimator(Estimator):
    name = "mlp"
    data_format = "dense_rows"
    budget_param = "steps"

    def default_params(self) -> dict[str, Any]:
        return {"network": "64_64", "learning_rate": 0.003, "steps": 300, "batch_size": 128, "seed": 0}

    @staticmethod
    def _n_rows(data) -> int:
        """The payload's row count (a sharded payload's, not a block's)."""
        return int(data["_n_rows"]) if is_sharded_payload(data) else int(data["x"].shape[0])

    @staticmethod
    def _dims(p: Mapping[str, Any], n_features: int) -> tuple[int, ...]:
        hidden = tuple(int(h) for h in str(p["network"]).split("_"))
        return (n_features,) + hidden + (1,)

    def _fit(self, data, ps, draws, carry, start: int, steps: int):
        """Steps ``start ..`` of the configs ``ps`` in one stack; ``carry``
        holds a slot per config and per unused slot."""
        x = data["x"]
        ps = stacked(ps, idle_slot(ps, learning_rate=0.0))
        lr = torch.tensor(np.asarray([p["learning_rate"] for p in ps], np.float32),
                          device=x.device)
        n = self._n_rows(data)
        args = (lr, [int(p["steps"]) for p in ps], carry, stacked(draws, None), start,
                steps, int(min(ps[0]["batch_size"], n)))
        if not is_sharded_payload(data):
            return _adam_mlp(x, data["y"], *args)
        return compat.sharded_call(
            lambda axis, xs, ys: _adam_mlp(xs, ys, *args, axis=axis, n_global=n),
            n_shards=int(data["_n_shards"]))(x, data["y"])

    def _carry(self, nets):
        """The stack's carry: the configs' parameters, zero moments, and
        zeros in the unused slots."""
        net = _stack(stacked(nets, [(torch.zeros_like(w), torch.zeros_like(b))
                                    for w, b in nets[0]]))
        return net, _zeros_like(net), _zeros_like(net)

    def train(self, data, params: Mapping[str, Any], *, draws=None) -> MLPModel:
        """``draws`` replaces the config's generator (see draws.py)."""
        model, _ = self.train_resumable(
            data, params, budget=int({**self.default_params(), **params}["steps"]),
            draws=draws)
        return model

    # ---- adaptive search (DESIGN.md §3.6) -------------------------------
    def train_resumable(self, data, params: Mapping[str, Any], *,
                        budget: int, state: ResumeState | None = None, draws=None):
        p = {**self.default_params(), **params, "steps": int(budget)}
        x = data["x"]
        dev = x.device
        target = int(budget)
        if state is None:
            start = 0
            if draws is None:
                draws = MLPDraws(int(p["seed"]), dev)
            carry = self._carry([draws.init(self._dims(p, int(x.shape[-1])))])
        else:
            start = int(state.budget)
            pl = state.payload
            if draws is None:
                draws = MLPDraws(int(p["seed"]), dev, state=pl["rng_state"])
            t = lambda k: torch.tensor(np.asarray(pl[k], np.float32), device=dev)  # noqa: E731
            carry = self._carry([[(t(f"w{i}"), t(f"b{i}")) for i in range(int(pl["n_layers"]))]])
            for s, part in zip(("m", "v"), carry[1:]):
                for i, (w, b) in enumerate(part):
                    w[0], b[0] = t(f"{s}w{i}"), t(f"{s}b{i}")
        if target > start:
            carry = self._fit(data, [p], [draws], carry, start, target - start)
        net, m, v = (_unstack(c, 0) for c in carry)
        payload: dict[str, Any] = {"n_layers": len(net), "rng_state": draws.state()}
        for i in range(len(net)):
            payload[f"w{i}"], payload[f"b{i}"] = net[i]
            payload[f"mw{i}"], payload[f"mb{i}"] = m[i]
            payload[f"vw{i}"], payload[f"vb{i}"] = v[i]
        return MLPModel(net), ResumeState(self.name, max(target, start), payload)

    # ---- fused batches (core/fusion.py, DESIGN.md §3.2) -----------------
    def fuse_signature(self, params: Mapping[str, Any]):
        # the architecture and minibatch shape fix the stacked shapes; the
        # step budget and lr differ per config
        p = {**self.default_params(), **params}
        return ("mlp", str(p["network"]), int(p["batch_size"]))

    def fuse_bucket(self, params: Mapping[str, Any]) -> tuple:
        from repro_torch.core.fusion import pad_pow2

        p = {**self.default_params(), **params}
        return (pad_pow2(int(p["steps"])),)

    def train_batched(self, data, configs, *, cache=None) -> list[MLPModel]:
        """The configs trained stacked (see :func:`_adam_mlp`), in stacks of
        ``STACK_WIDTH``, each from its own generator and with its own step
        count. The program comes from ``cache`` (default the process-wide
        compile cache) under the reference's key, steps and batch axis
        padded to powers of two."""
        from repro_torch.core import fusion

        ps = [{**self.default_params(), **c} for c in configs]
        x = data["x"]
        n_feat, n = int(x.shape[-1]), self._n_rows(data)
        dims = self._dims(ps[0], n_feat)
        bs = int(min(ps[0]["batch_size"], n))
        if any(self._dims(p, n_feat) != dims
               or int(min(p["batch_size"], n)) != bs for p in ps):
            raise ValueError("mlp fused batch mixes architectures/batch sizes")
        pad_steps = fusion.pad_pow2(max(int(p["steps"]) for p in ps))
        key = ("mlp", dims, pad_steps, bs, len(fusion.pad_configs(ps)[0]), tuple(x.shape))
        if is_sharded_payload(data):
            key += (int(data["_n_shards"]),)
        cc = cache if cache is not None else fusion.compile_cache()
        fit = cc.get(key, lambda: functools.partial(self._train_stacks, dims))
        return fit(data, ps)

    def _train_stacks(self, dims, data, ps) -> list[MLPModel]:
        """The compile cache's program for one signature: the configs in
        stacks of ``STACK_WIDTH``, each from its own generator."""
        models = []
        for i in range(0, len(ps), STACK_WIDTH):
            chunk = ps[i:i + STACK_WIDTH]
            draws = [MLPDraws(int(p["seed"]), data["x"].device) for p in chunk]
            params, _, _ = self._fit(data, chunk, draws,
                                     self._carry([d.init(dims) for d in draws]),
                                     0, max(int(p["steps"]) for p in chunk))
            models += [MLPModel(_unstack(params, k)) for k in range(len(chunk))]
        return models

    @staticmethod
    def estimate_cost(params: Mapping[str, Any], n_rows: int, n_features: int) -> float:
        p = str(params.get("network", "64_64"))
        hidden = [int(h) for h in p.split("_")]
        dims = [n_features] + hidden + [1]
        flops_per_row = sum(6 * a * b for a, b in zip(dims[:-1], dims[1:]))  # fwd+bwd
        steps = int(params.get("steps", 300))
        bs = int(params.get("batch_size", 128))
        return steps * min(bs, n_rows) * flops_per_row / 2e9
