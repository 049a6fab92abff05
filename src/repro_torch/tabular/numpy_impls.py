"""A SECOND implementation family (pure NumPy, unjitted) for MLP & LogReg.

Role in the reproduction: the paper's point is that one framework can host
MULTIPLE implementations of the same algorithms (XGBoost vs sklearn's
boosting; TF vs sklearn's MLP) and that newer/faster implementations win
(Fig. 6, blue vs green). Our analogue pair is {torch (on the card)} vs
{numpy (interpreted, on the host)}: same algorithms, same interface,
different backends. These two classes are ALSO the Fig. 4 exhibit — the
complete glue code needed to plug a new implementation into the framework
(count the lines). A copy of the JAX package's module; the converted data
arrives as tensors, which ``_host`` brings to numpy.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from repro_torch.core.evaluation import stable_sigmoid
from repro_torch.core.interface import Estimator, TrainedModel, register_estimator

__all__ = ["NumpyMLPEstimator", "NumpyLogRegEstimator"]


def _host(t) -> np.ndarray:
    """A converted tensor (on any device) as a numpy array."""
    return t.cpu().numpy()


class _NumpyLogRegModel(TrainedModel):
    def __init__(self, w, b):
        self.w, self.b = w, b

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return stable_sigmoid(np.asarray(x, np.float32) @ self.w + self.b)


@register_estimator
class NumpyLogRegEstimator(Estimator):
    name = "np_logreg"
    data_format = "dense_rows"

    def train(self, data, params: Mapping[str, Any]) -> _NumpyLogRegModel:
        x, y = _host(data["x"]), _host(data["y"])
        c = float(params.get("c", 1.0))
        lr = float(params.get("lr", 0.05))
        steps = int(params.get("steps", 200))
        n, d = x.shape
        w, b = np.zeros(d, np.float32), 0.0
        for _ in range(steps):
            p = stable_sigmoid(x @ w + b).astype(np.float32)
            gw = x.T @ (p - y) / n + w / (c * n)
            gb = float(np.mean(p - y))
            w -= lr * gw
            b -= lr * gb
        return _NumpyLogRegModel(w, b)

    @staticmethod
    def estimate_cost(params, n_rows, n_features):
        return int(params.get("steps", 200)) * n_rows * n_features / 2e7


class _NumpyMLPModel(TrainedModel):
    def __init__(self, layers):
        self.layers = layers

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        h = np.asarray(x, np.float32)
        for i, (w, b) in enumerate(self.layers):
            h = h @ w + b
            if i < len(self.layers) - 1:
                h = np.maximum(h, 0.0)
        return stable_sigmoid(h[:, 0])


@register_estimator
class NumpyMLPEstimator(Estimator):
    name = "np_mlp"
    data_format = "dense_rows"

    def train(self, data, params: Mapping[str, Any]) -> _NumpyMLPModel:
        x, y = _host(data["x"]), _host(data["y"])
        hidden = [int(h) for h in str(params.get("network", "64_64")).split("_")]
        lr = float(params.get("learning_rate", 0.003))
        steps = int(params.get("steps", 300))
        bs = min(int(params.get("batch_size", 128)), x.shape[0])
        rng = np.random.default_rng(int(params.get("seed", 0)))
        dims = [x.shape[1]] + hidden + [1]
        layers = [
            (rng.normal(0, np.sqrt(2 / i), (i, o)).astype(np.float32),
             np.zeros(o, np.float32))
            for i, o in zip(dims[:-1], dims[1:])
        ]
        for _ in range(steps):                       # plain SGD, interpreted
            idx = rng.integers(0, x.shape[0], bs)
            acts, h = [x[idx]], x[idx]
            for i, (w, b) in enumerate(layers):
                h = h @ w + b
                if i < len(layers) - 1:
                    h = np.maximum(h, 0.0)
                acts.append(h)
            p = stable_sigmoid(h[:, 0]).astype(np.float32)
            grad = ((p - y[idx]) / bs)[:, None]
            for i in range(len(layers) - 1, -1, -1):
                w, b = layers[i]
                gw = acts[i].T @ grad
                gb = grad.sum(0)
                if i > 0:
                    grad = (grad @ w.T) * (acts[i] > 0)
                layers[i] = (w - lr * gw, b - lr * gb)
        return _NumpyMLPModel(layers)

    @staticmethod
    def estimate_cost(params, n_rows, n_features):
        hidden = [int(h) for h in str(params.get("network", "64_64")).split("_")]
        dims = [n_features] + hidden + [1]
        flops = sum(6 * a * b for a, b in zip(dims[:-1], dims[1:]))
        return int(params.get("steps", 300)) * min(
            int(params.get("batch_size", 128)), n_rows) * flops / 2e7
