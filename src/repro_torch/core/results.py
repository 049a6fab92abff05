"""Model-search results: the paper's ``MultiModel`` + ``validateAll``.

Holds every trained model keyed by task, evaluates them all under a chosen
metric on validation data, and selects the best — the final stage of the
paper's Fig. 1 example (``multiModel.validateAll(validateDF, ...)``).

Since the fused validation plane (DESIGN.md §3.4) this is the DRIVER-side
convenience: streamed results already carry executor-computed scores
(``TaskResult.score``), so ``validate_all`` is for ad-hoc re-ranking on
other splits/metrics — memoized per (model, data fingerprint) so repeated
calls re-predict nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.data_format import DenseMatrix
from repro_torch.core.interface import TaskResult, TrainTask

__all__ = ["MultiModel", "ModelScore", "auc", "accuracy", "logloss", "METRICS"]


def auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve via the Mann-Whitney rank statistic."""
    y = np.asarray(y_true).astype(bool)
    s = np.asarray(scores, dtype=np.float64)
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, y.size + 1)
    # average ranks for ties
    sorted_s = s[order]
    i = 0
    while i < y.size:
        j = i
        while j + 1 < y.size and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    r_pos = ranks[y].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def accuracy(y_true: np.ndarray, scores: np.ndarray) -> float:
    return float(((scores >= 0.5) == (np.asarray(y_true) >= 0.5)).mean())


def logloss(y_true: np.ndarray, scores: np.ndarray) -> float:
    p = np.clip(np.asarray(scores, dtype=np.float64), 1e-7, 1 - 1e-7)
    y = np.asarray(y_true, dtype=np.float64)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


METRICS: dict[str, Callable[[np.ndarray, np.ndarray], float]] = {
    "auc": auc,
    "accuracy": accuracy,
    "neg_logloss": lambda y, s: -logloss(y, s),
}


# --------------------------------------------------------------------------
# Sharded eval plane (DESIGN.md §3.9): per-shard metric PARTIALS.
#
# Row-decomposable metrics (per-row means) reduce as (partial sum, valid
# count) pairs per shard — the executor never materialises a gathered
# prediction vector. AUC needs GLOBAL Mann-Whitney ranks, so it falls back
# to concatenating the shard blocks (block order reproduces row order).
# --------------------------------------------------------------------------


def _accuracy_partial(y, s, valid) -> float:
    hit = ((np.asarray(s) >= 0.5) == (np.asarray(y) >= 0.5)) & valid
    return float(hit.sum())


def _logloss_partial(y, s, valid) -> float:
    p = np.clip(np.asarray(s, dtype=np.float64), 1e-7, 1 - 1e-7)
    yy = np.asarray(y, dtype=np.float64)
    terms = -(yy * np.log(p) + (1 - yy) * np.log(1 - p))
    return float(np.where(valid, terms, 0.0).sum())


#: metric → (per-shard partial-sum fn, sign applied to the combined mean)
METRIC_PARTIALS: dict[str, tuple[Callable, float]] = {
    "accuracy": (_accuracy_partial, 1.0),
    "neg_logloss": (_logloss_partial, -1.0),
}


def sharded_metric(metric: str, y_blocks: np.ndarray, score_blocks: np.ndarray,
                   valid: np.ndarray, n_rows: int) -> float:
    """Score block-sharded predictions: ``y_blocks``/``score_blocks``/
    ``valid`` are (S, Rs) with zero-padded tails. Decomposable metrics
    combine per-shard (sum, count) partials; others gather in shard order
    (which IS row order) and run the global definition."""
    entry = METRIC_PARTIALS.get(metric)
    if entry is None:
        flat_y = np.asarray(y_blocks).reshape(-1)[:n_rows]
        flat_s = np.asarray(score_blocks).reshape(-1)[:n_rows]
        return float(METRICS[metric](flat_y, flat_s))
    partial_fn, sign = entry
    sums = sum(partial_fn(y_blocks[s], score_blocks[s], valid[s])
               for s in range(valid.shape[0]))
    counts = float(np.asarray(valid).sum())
    return sign * sums / counts


@dataclasses.dataclass
class ModelScore:
    task: TrainTask
    score: float
    train_seconds: float
    executor_id: int
    #: per-task cost breakdown (§3.3/§3.4): conversion and executor-side
    #: scoring seconds the task actually paid, and the fused batch size it
    #: rode in (1 = solo) — so launchers can print the full story per task
    convert_seconds: float = 0.0
    eval_seconds: float = 0.0
    batch_size: int = 1


class MultiModel:
    """All models produced by one search, with validation utilities.

    ``validate_all``/``best`` memoize per (data fingerprint, metric) — and
    predictions per (model, data fingerprint) across metrics — so repeated
    ranking calls (launchers print top-k, then best, then a test-split
    score) re-predict nothing.
    """

    def __init__(self, results: list[TaskResult]):
        self.results = [r for r in results if r.ok]
        self.failures = [r for r in results if not r.ok]
        self._proba_cache: dict[tuple[int, str], np.ndarray] = {}
        self._rank_cache: dict[tuple[str, str], list[ModelScore]] = {}

    def __len__(self) -> int:
        return len(self.results)

    def _proba(self, r: TaskResult, data: DenseMatrix, fp: str) -> np.ndarray:
        key = (r.task.task_id, fp)
        if key not in self._proba_cache:
            self._proba_cache[key] = r.model.predict_proba(data.x)
        return self._proba_cache[key]

    def validate_all(self, data: DenseMatrix, metric: str = "auc") -> list[ModelScore]:
        fn = METRICS[metric]
        fp = data.fingerprint()
        cached = self._rank_cache.get((fp, metric))
        if cached is not None:
            return list(cached)
        scores = []
        for r in self.results:
            s = fn(data.y, self._proba(r, data, fp))
            scores.append(ModelScore(
                task=r.task, score=s, train_seconds=r.train_seconds,
                executor_id=r.executor_id,
                convert_seconds=getattr(r, "convert_seconds", 0.0),
                eval_seconds=getattr(r, "eval_seconds", 0.0),
                batch_size=getattr(r, "batch_size", 1)))
        scores.sort(key=lambda m: -m.score)
        self._rank_cache[(fp, metric)] = scores
        return list(scores)

    def best(self, data: DenseMatrix, metric: str = "auc") -> ModelScore:
        ranked = self.validate_all(data, metric)
        if not ranked:
            raise RuntimeError("no successfully trained models to select from")
        return ranked[0]

    def model_for(self, task_id: int):
        for r in self.results:
            if r.task.task_id == task_id:
                return r.model
        raise KeyError(task_id)
