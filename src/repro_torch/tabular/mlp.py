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
count neither draws nor updates.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.data_format import refuse_sharded
from repro_torch.core.evaluation import stable_sigmoid
from repro_torch.core.interface import (
    Estimator,
    ResumeState,
    TrainedModel,
    register_estimator,
)
from repro_torch.device import default_device
from repro_torch.tabular.draws import MLPDraws
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


def _adam_mlp(x, y, lr, n_steps: Sequence[int], carry, draws, start: int,
              steps: int, batch_size: int):
    """Run global steps ``start .. start + steps`` of minibatch Adam for a
    stack of C configs sharing one architecture. ``lr``: (C,) float32;
    ``carry`` = (params, m, v), each a list of stacked (w (C, d_in, d_out),
    b (C, d_out)); ``draws[k].batch(i, ...)`` gives config k's rows of step
    i. Config k's steps past ``n_steps[k]`` draw nothing and change
    nothing."""
    n = x.shape[0]
    flat = lambda layers: [t for wb in layers for t in wb]  # noqa: E731
    pairs = lambda ts: list(zip(ts[0::2], ts[1::2]))        # noqa: E731
    params, m, v = (flat(c) for c in carry)
    lrs = [lr.reshape((-1,) + (1,) * (p.dim() - 1)) for p in params]
    live = Liveness(n_steps, x.device)
    idle = torch.zeros(batch_size, dtype=torch.int64, device=x.device)
    with torch.enable_grad():
        for i in range(start, start + steps):
            active = live.at(i)
            if active is False:
                break
            idx = torch.stack([d.batch(i, n, batch_size) if d is not None and on else idle
                               for d, on in zip(draws, live.flags(i))])   # (C, bs)
            xb, yb = x[idx], y[idx]
            leaves = [t.detach().requires_grad_() for t in params]
            loss = logistic_loss(_forward(pairs(leaves), xb), yb).mean(1).sum()
            grads = list(torch.autograd.grad(loss, leaves))
            new = adam_update(params, grads, m, v, lrs, i)
            params, m, v = ([freeze(active, a, o) for a, o in zip(fresh, old)]
                            for fresh, old in zip(new, (params, m, v)))
    return pairs(params), pairs(m), pairs(v)


def _stack(per_config):
    """Per-config layer lists → one list of stacked (w, b) layers."""
    return [tuple(torch.stack(t) for t in zip(*layer)) for layer in zip(*per_config)]


def _zeros_like(params):
    return [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]


def _batched_logits(models, x) -> np.ndarray:
    """(B, rows) logits for models grouped by architecture, each group one
    stacked forward pass."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x, np.float32), device=default_device())
    x = x.float()
    out = np.empty((len(models), x.shape[0]), np.float32)
    groups: dict[tuple, list[int]] = {}
    for i, m in enumerate(models):
        groups.setdefault(tuple(w.shape for w, _ in m.params), []).append(i)
    for dims, idxs in groups.items():
        stacked = [
            tuple(torch.tensor(np.stack([models[i].params[li][k] for i in idxs]),
                               device=x.device) for k in (0, 1))
            for li in range(len(dims))
        ]
        xs = x[None].expand(len(idxs), *x.shape)
        out[idxs] = _forward(stacked, xs).cpu().numpy()
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
        return _batched_logits([self], x)[0]

    def predict_proba_device(self, x, *, cache=None) -> np.ndarray:
        return stable_sigmoid(self.predict_margin_device(x, cache=cache))

    @classmethod
    def predict_margin_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return _batched_logits(models, x)

    @classmethod
    def predict_proba_batched(cls, models, x, *, cache=None) -> np.ndarray:
        return stable_sigmoid(_batched_logits(models, x))


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
        bs = int(min(ps[0]["batch_size"], x.shape[0]))
        return _adam_mlp(x, data["y"], lr, [int(p["steps"]) for p in ps], carry,
                         stacked(draws, None), start, steps, bs)

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
        refuse_sharded(data, "MLP")
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
        count. ``cache`` is accepted
        for the interface; eager PyTorch compiles nothing to cache."""
        del cache
        refuse_sharded(data, "MLP")
        ps = [{**self.default_params(), **c} for c in configs]
        x = data["x"]
        n_feat = int(x.shape[-1])
        dims = self._dims(ps[0], n_feat)
        bs = int(min(ps[0]["batch_size"], x.shape[0]))
        if any(self._dims(p, n_feat) != dims
               or int(min(p["batch_size"], x.shape[0])) != bs for p in ps):
            raise ValueError("mlp fused batch mixes architectures/batch sizes")
        models = []
        for i in range(0, len(ps), STACK_WIDTH):
            chunk = ps[i:i + STACK_WIDTH]
            draws = [MLPDraws(int(p["seed"]), x.device) for p in chunk]
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
