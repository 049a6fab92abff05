"""Task-cost profiling (paper §III-C).

Two profilers share one output contract (``dict[task_id, seconds]``):

* :class:`SamplingProfiler` — the paper's method, verbatim: train every task on
  a small uniform sample (1–3 % of rows) and estimate full-data cost as
  ``measured_seconds / sampling_rate`` (training time assumed ∝ data size).

* :class:`AnalyticProfiler` — the TPU-native extension: cost each task from a
  closed-form FLOPs/bytes model (or, for LM tasks, from a compiled dry-run's
  ``cost_analysis``) evaluated against the roofline machine model. Profiling a
  task costs microseconds instead of a sampled training run, so the paper's
  "profiling must stay ≪ total runtime" constraint (their Fig. 3: < 8 %)
  becomes negligible by construction.

Both attach costs via ``TrainTask.with_cost`` so the scheduler is agnostic to
where estimates came from.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from repro_torch import tracing
from repro_torch.core.data_format import DenseMatrix
from repro_torch.core.interface import TrainTask, get_estimator

__all__ = [
    "ProfileReport",
    "SamplingProfiler",
    "AnalyticProfiler",
    "attach_costs",
]


@dataclasses.dataclass
class ProfileReport:
    costs: dict[int, float]          # task_id -> estimated seconds (full data)
    profiling_seconds: float         # wall time spent profiling
    sampling_rate: float | None      # None for analytic profiling

    def ratio_of(self, execution_seconds: float) -> float:
        """Profiling overhead as a fraction of the whole search (paper Fig. 3).

        CONTRACT: ``execution_seconds`` is time spent OUTSIDE profiling
        (training/scheduling only) — this method adds ``profiling_seconds``
        itself to form the total. Passing a wall-clock total that already
        includes profiling double-counts it (profiling lands in the
        denominator twice, understating the ratio); use
        :meth:`ratio_of_total` for totals measured around the whole search.
        """
        denom = execution_seconds + self.profiling_seconds
        return self.profiling_seconds / denom if denom > 0 else 0.0

    def ratio_of_total(self, total_seconds: float) -> float:
        """Overhead fraction when ``total_seconds`` already INCLUDES the
        profiling time (e.g. one timer around the whole search). Clamped to
        [0, 1] so a slightly-stale total can't report an impossible ratio."""
        if total_seconds <= 0:
            return 0.0
        return min(1.0, self.profiling_seconds / total_seconds)


class SamplingProfiler:
    """Paper §III-C: run each task on a row-sample, divide by the rate."""

    def __init__(self, sampling_rate: float, seed: int = 0, min_rows: int = 16):
        if not 0.0 < sampling_rate <= 1.0:
            raise ValueError(f"sampling_rate must be in (0,1], got {sampling_rate}")
        self.sampling_rate = sampling_rate
        self.seed = seed
        self.min_rows = min_rows

    def profile(self, tasks: Sequence[TrainTask], data: DenseMatrix) -> ProfileReport:
        t0 = time.perf_counter()
        rate = max(self.sampling_rate, self.min_rows / max(1, data.n_rows))
        rate = min(rate, 1.0)
        sample = data.sample(rate, seed=self.seed)
        costs: dict[int, float] = {}
        # Group by (estimator, resolved format params) so the uniform->native
        # conversion is paid once per PREPARED VARIANT, mirroring the
        # executor-side prepared-data plane (§3.3) — e.g. gbdt tasks at
        # max_bin=64 and 256 profile against their own quantization. Sample
        # conversions stay out of the PreparedDataCache: the sample is a
        # different fingerprint and caching throwaway profiling data would
        # pollute the bytes gauge.
        from repro_torch.core.data_format import format_key

        by_fmt: dict[tuple, list[TrainTask]] = {}
        for t in tasks:
            est = get_estimator(t.estimator)
            fkey = format_key(est.data_format, est.format_params(dict(t.params)))
            by_fmt.setdefault((t.estimator, fkey), []).append(t)
        for (est_name, _fkey), group in by_fmt.items():
            est = get_estimator(est_name)
            converted = est.prepare(sample, group[0].params)
            for t in group:
                # a sample fit's levels are short and host-bound: their spans
                # skip the thread clock, whose reads would slow them
                with tracing.span("profile.sample", task=t.task_id), tracing.wall_clock_only():
                    s0 = time.perf_counter()
                    est.train(converted, dict(t.params))
                    costs[t.task_id] = (time.perf_counter() - s0) / rate
        return ProfileReport(
            costs=costs,
            profiling_seconds=time.perf_counter() - t0,
            sampling_rate=rate,
        )


class AnalyticProfiler:
    """Roofline cost model profiler (beyond-paper, TPU-native).

    ``cost_fn(task, n_rows, n_features) -> seconds`` defaults to the
    per-estimator ``estimate_cost`` classmethod if present; LM estimators
    instead derive seconds from dry-run cost_analysis via roofline terms
    (see repro_torch.roofline.analysis.step_time_model).
    """

    def __init__(self, cost_fn: Callable[[TrainTask, int, int], float] | None = None):
        self._cost_fn = cost_fn

    def profile(self, tasks: Sequence[TrainTask], data: DenseMatrix) -> ProfileReport:
        t0 = time.perf_counter()
        costs: dict[int, float] = {}
        for t in tasks:
            if self._cost_fn is not None:
                costs[t.task_id] = float(self._cost_fn(t, data.n_rows, data.n_features))
            else:
                est = get_estimator(t.estimator)
                fn = getattr(est, "estimate_cost", None)
                if fn is None:
                    raise ValueError(
                        f"estimator {t.estimator!r} exposes no estimate_cost and "
                        "no cost_fn was given"
                    )
                costs[t.task_id] = float(fn(dict(t.params), data.n_rows, data.n_features))
        return ProfileReport(
            costs=costs,
            profiling_seconds=time.perf_counter() - t0,
            sampling_rate=None,
        )


def attach_costs(tasks: Sequence[TrainTask], report: ProfileReport) -> list[TrainTask]:
    return [
        t.with_cost(report.costs[t.task_id]) if t.task_id in report.costs else t
        for t in tasks
    ]
