"""Executor-side validation plane (DESIGN.md §3.4).

The paper's pipeline ends with ``multiModel.validateAll(validateDF, ...)``.
Here every model is scored where it was trained, right after training:

* **Batched device inference** — the tree families route ALL rounds'
  heap-layout trees as a gather chain on the device holding the validation
  rows (``TrainedModel.predict_proba_device`` / ``predict_proba_batched``).
  Each family's predictor for one signature (the reference's keys, e.g.
  ``("logreg.predict", n_models, x.shape)``) is built once and kept in
  :func:`predict_compile_cache`, whose counters the Session reports.

* **Executor-side scoring** — the pools call :func:`evaluate_models` right
  after training: validation data is resolved ONCE per (fingerprint, eval
  format, placement, device) through the
  :class:`~repro_torch.core.data_format.PreparedDataCache` (the
  ``eval_dense`` entries), and results stream back with
  ``TaskResult.score``/``eval_seconds`` attached.

* **Eval as a scheduled cost** — ``eval_seconds`` feeds the CostModel's
  per-family eval law and ``scheduler.charge_units`` adds the estimate to
  every unit's planned cost.

:func:`stable_sigmoid` is the shared numerically-stable numpy sigmoid every
family's ``predict_proba`` uses — the naive ``1/(1+exp(-z))`` overflows
(RuntimeWarning, precision loss) for large negative margins.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Hashable, Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.core.data_format import DenseMatrix, is_sharded_payload, prepare_cached
from repro_torch.core.fusion import CompileCache
from repro_torch.core.results import METRICS, sharded_metric

__all__ = [
    "EvalPlan",
    "evaluate_models",
    "predict_compile_cache",
    "stable_sigmoid",
]


def stable_sigmoid(z: np.ndarray) -> np.ndarray:
    """Numerically stable ``1/(1+exp(-z))``: never exponentiates a positive
    argument, so extreme margins (|z| ~ 1000) neither overflow (the naive
    form raises RuntimeWarning and rounds to exactly 0/1 via ``inf``) nor
    lose the tiny-probability tail representable in the output dtype.
    Computes in the input's floating dtype — float32 margins yield float32
    probabilities (the hot batched-scoring path must not silently double
    its output memory), float64 keeps the full tail."""
    z = np.asarray(z)
    if z.dtype not in (np.float32, np.float64):
        z = z.astype(np.float64)
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


#: process-wide predict cache, separate from fusion.compile_cache() so the
#: validation plane's traffic is observable on its own
#: (SearchStats.predict_compile_*)
_PREDICT_CACHE = CompileCache(name="predict")


def predict_compile_cache() -> CompileCache:
    """The process-wide cache handed to every family's device predictors."""
    return _PREDICT_CACHE


@dataclasses.dataclass(frozen=True)
class EvalPlan:
    """What the executors score against: validation split + metric.

    Passed to ``ExecutorBackend.submit(assignment, data, validate=plan)`` by
    the Session whenever the backend supports executor-side scoring (both
    shipped pools do); backends without the keyword keep the pre-§3.4
    driver-side fallback.
    """

    data: DenseMatrix
    metric: str = "auc"

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(
                f"unknown metric {self.metric!r}; known: {sorted(METRICS)}")


def evaluate_models(
    est,
    models: Sequence,
    plan: EvalPlan,
    *,
    prepared_cache=None,
    placement: Hashable = None,
    cache: CompileCache | None = None,
) -> tuple[list[float | None], float]:
    """Score ``models`` (one task's model, or a fused unit's whole stack)
    executor-side; returns ``(scores, per_model_eval_seconds)``.

    The eval split converts once per (fingerprint, ``est.eval_format``,
    placement, device) through the PreparedDataCache — the build time is
    folded into this call's eval seconds for the caller that built it (hits
    pay ~0), exactly like training-side conversion accounting. A model batch
    scores through ``predict_proba_batched``; the metric itself is a cheap
    O(R log R) numpy reduction on the executor thread.

    Scoring failures degrade to ``None`` scores — a trained model must
    never be lost because its evaluation raised; the Session's driver-side
    fallback (``score_of``) can still rank it lazily.
    """
    from repro_torch.core.interface import TrainedModel

    models = list(models)
    if not models or not all(isinstance(m, TrainedModel) for m in models):
        return [None] * len(models), 0.0
    cache = cache if cache is not None else _PREDICT_CACHE
    t0 = time.perf_counter()
    with tracing.span("score", models=len(models)):
        try:
            entry, _conv_s, _built = prepare_cached(
                plan.data, getattr(est, "eval_format", "eval_dense"),
                cache=prepared_cache, placement=placement)
            x = entry["x"]
            sharded = is_sharded_payload(entry)
            if sharded:
                # prediction is row-local: score the flattened (S·Rs, F) block
                # view, then reduce per-shard metric PARTIALS (§3.9) — no
                # gathered prediction vector for decomposable metrics
                n_shards, rows_per_shard = int(entry["_n_shards"]), x.shape[1]
                x = x.reshape(n_shards * rows_per_shard, *x.shape[2:])
            # the predictors return host arrays: this span ends with the copy
            with tracing.span("score.predict"):
                if len(models) > 1:
                    probs = type(models[0]).predict_proba_batched(models, x, cache=cache)
                else:
                    probs = [models[0].predict_proba_device(x, cache=cache)]
            y = plan.data.y
            with tracing.span("score.metric", metric=plan.metric):
                if sharded:
                    n_rows = int(entry["_n_rows"])
                    valid = entry["_shard_valid"].cpu().numpy()
                    y_blocks = np.zeros(valid.shape, np.asarray(y).dtype)
                    y_blocks.reshape(-1)[:n_rows] = np.asarray(y).reshape(-1)
                    scores: list[float | None] = [
                        sharded_metric(plan.metric, y_blocks,
                                       np.asarray(p).reshape(valid.shape), valid, n_rows)
                        for p in probs]
                else:
                    metric_fn = METRICS[plan.metric]
                    scores = [float(metric_fn(y, np.asarray(p))) for p in probs]
        except Exception:
            return [None] * len(models), 0.0
        total = time.perf_counter() - t0
    return scores, total / len(models)
