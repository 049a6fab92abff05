"""Online profile-feedback cost model (paper §III-C, closed-loop).

The paper's profilers (profiler.py) produce ONE-SHOT static estimates: a
sampled (or analytic) cost per task, computed before scheduling and never
revisited. Mis-estimates — the paper's Fig. 5 concern — therefore inflate
makespan silently: LPT packs executors against numbers that were wrong from
the start. :class:`CostModel` closes the loop:

* every completed :class:`~repro_torch.core.interface.TaskResult` is fed back via
  ``observe(task, seconds, n_rows)`` — both executor pools expose an
  ``on_result`` hook and :class:`~repro_torch.core.session.Session` wires it up, so
  observation is free and automatic;
* observations are keyed by ``(estimator family, hyperparameter bucket)`` and
  carry the data size, so the model fits a per-bucket **power-law scaling in
  data size** (``seconds ≈ a · rows^b``, the paper's linearity assumption
  generalised and learned rather than assumed);
* ``estimate``/``predict_many`` serve as a third profiler source: once a
  family has been observed, predicting a task costs microseconds and beats
  :class:`~repro_torch.core.profiler.SamplingProfiler` (which must *train* on a
  sample) — warm-up is one completed task per family;
* the model persists as JSON next to the WAL, so ``Session.resume`` and
  later sessions start warm instead of re-profiling from scratch.

``observed_drift`` quantifies how far reality has diverged from the plan;
Session uses it to trigger a mid-session :func:`repro_torch.core.scheduler.replan`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import warnings
from typing import Any, Iterable, Mapping, Sequence

from repro_torch.core.interface import TrainTask
from repro_torch.core.profiler import ProfileReport

__all__ = ["CostModel", "observed_drift", "param_bucket"]

#: learned scaling exponents are clamped here — training time is never
#: decreasing in data size, and anything past cubic is a fit artefact
_MIN_EXPONENT, _MAX_EXPONENT = 0.0, 3.0
_EPS = 1e-12


def param_bucket(params: Mapping[str, Any]) -> str:
    """Canonical coarse bucket for a hyperparameter dict.

    Numeric values collapse to their power-of-two magnitude (``400`` and
    ``512`` share a bucket; ``0.003`` and ``0.03`` do not), strings/bools stay
    verbatim. Buckets group configs whose runtime should be of the same order,
    so a handful of observations covers a whole grid axis.
    """
    parts = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, bool) or isinstance(v, str) or v is None:
            parts.append(f"{k}={v}")
        elif isinstance(v, (int, float)):
            if v > 0:
                parts.append(f"{k}~2^{round(math.log2(v))}")
            elif v < 0:
                parts.append(f"{k}~-2^{round(math.log2(-v))}")
            else:
                parts.append(f"{k}~0")
        else:
            parts.append(f"{k}={v!r}")
    return ",".join(parts)


def _shard_rows(n_rows: int, n_shards: int) -> int:
    """The §3.9 size axis: sharded laws regress on ROWS PER SHARD.

    A task trained over ``n_shards`` row shards does per-device work
    proportional to its own block (plus a size-independent psum), so the
    power law that transfers across data sizes is ``seconds ≈ a ·
    (rows/n_shards)^b`` — feeding full rows in would make a 4-shard run
    look like a law violation instead of a smaller effective size."""
    return -(-int(n_rows) // int(n_shards)) if n_shards > 1 else int(n_rows)


def _law_params(task) -> Mapping[str, Any]:
    """Params the TRAIN size/bucket laws key on.

    A rung task's params carry its ABSOLUTE budget (so prepared-data and
    compile-cache keys stay stable across rungs, §3.6), but the train time
    it reports is for the INCREMENT it actually ran — resuming at budget
    270 from 90 costs 180 rounds, not 270. Swapping the budget param to
    ``budget - prev_budget`` buckets rungs by the work they do, so rung
    observations and full-run observations share one consistent law. Eval
    laws keep the absolute params: scoring cost depends on the model the
    rung PRODUCED (all 270 trees), not on the increment."""
    bp = getattr(task, "budget_param", None)
    budget = getattr(task, "budget", None)
    if not bp or budget is None:
        return task.params
    p = dict(task.params)
    p[bp] = max(1, int(budget) - int(getattr(task, "prev_budget", 0) or 0))
    return p


@dataclasses.dataclass
class _LogStats:
    """Incremental least-squares over (x=log rows, y=log seconds)."""

    n: int = 0
    sum_x: float = 0.0
    sum_y: float = 0.0
    sum_xx: float = 0.0
    sum_xy: float = 0.0

    def add(self, x: float, y: float) -> None:
        self.n += 1
        self.sum_x += x
        self.sum_y += y
        self.sum_xx += x * x
        self.sum_xy += x * y

    def slope(self) -> float | None:
        """Regression slope, or None when every x seen so far is identical."""
        if self.n < 2:
            return None
        var = self.n * self.sum_xx - self.sum_x * self.sum_x
        if var <= _EPS * max(1.0, self.sum_xx):
            return None
        return (self.n * self.sum_xy - self.sum_x * self.sum_y) / var

    def predict(self, x: float, default_slope: float) -> float:
        """ŷ at x, anchored at the observed mean, slope clamped monotone."""
        b = self.slope()
        if b is None:
            b = default_slope
        b = min(max(b, _MIN_EXPONENT), _MAX_EXPONENT)
        mean_x = self.sum_x / self.n
        mean_y = self.sum_y / self.n
        return mean_y + b * (x - mean_x)


@dataclasses.dataclass
class _RatioStats:
    """Mean log(observed/estimated) per family — the Fig. 5 correction."""

    n: int = 0
    sum_log_ratio: float = 0.0

    def add(self, estimated: float, observed: float) -> None:
        self.n += 1
        self.sum_log_ratio += math.log(observed / estimated)

    def factor(self) -> float:
        return math.exp(self.sum_log_ratio / self.n) if self.n else 1.0


class CostModel:
    """Persistent, thread-safe runtime model learned from completed tasks.

    Duck-types the profiler protocol (``profile(tasks, data) ->
    ProfileReport``): tasks the model can estimate cost nothing; the rest go
    to ``fallback`` (typically a :class:`SamplingProfiler`) when one is set.

    ``prior`` chains a second CostModel underneath (DESIGN.md §3.5): reads
    that find no LOCAL observations fall through to the prior, and every
    observation is WRITTEN THROUGH to it as well. The multi-tenant search
    service points every session's model at one shared fleet-level prior, so
    a brand-new tenant's first plan is already warm with what other tenants
    learned — while ``save``/``to_dict`` serialize the local populations
    only, keeping per-session persistence (WAL + ``<wal>.cost.json``)
    byte-identical to the single-tenant world. Prior calls always happen
    OUTSIDE the local lock (the prior takes its own), so many sessions can
    share one prior without lock-order cycles.
    """

    VERSION = 1

    def __init__(self, path: str | None = None, *,
                 default_exponent: float = 1.0, fallback=None,
                 prior: "CostModel | None" = None):
        #: where save() writes (JSON); None keeps the model in-memory only
        self.path = path
        #: exponent assumed before a bucket has seen two distinct sizes
        #: (1.0 = the paper's "training time ∝ data size")
        self.default_exponent = default_exponent
        #: profiler consulted for tasks with no usable observations yet
        self.fallback = fallback
        #: shared CostModel consulted after local populations miss and
        #: written through on every observation (never serialized)
        self.prior = prior
        self._lock = threading.RLock()
        self._buckets: dict[str, dict[str, _LogStats]] = {}   # family -> bucket
        self._families: dict[str, _LogStats] = {}             # pooled per family
        self._ratios: dict[str, _RatioStats] = {}             # obs/est per family
        #: per-FORMAT conversion law (DESIGN.md §3.3): seconds ≈ a·rows^b of
        #: the uniform→native conversion, keyed by data_format.format_key —
        #: a separate population from training time, so the scheduler can
        #: charge the FIRST task of a cold format group with conversion
        #: included and the rest without
        self._converts: dict[str, _LogStats] = {}
        #: per-family eval law (DESIGN.md §3.4): seconds ≈ a·eval_rows^b of
        #: executor-side scoring — a third population (never mixed with
        #: training or conversion), sized on the EVAL split's rows.
        #: Bucket-resolved like the training law (scoring a 90-round
        #: depth-6 tree stack costs ~4× a 30-round depth-4 one; a "128_128"
        #: MLP forward ~4× a "64_64"), pooled per family as the fallback.
        #: Fed with the amortized per-member share for fused batches, which
        #: is exactly what `charge_units` wants back when it adds eval to
        #: every planned unit.
        self._eval_buckets: dict[str, dict[str, _LogStats]] = {}
        self._evals: dict[str, _LogStats] = {}                # pooled
        self._n_observed = 0

    @staticmethod
    def _family_key(family: str, batched: bool, n_shards: int = 1) -> str:
        """Batched (fused) execution gets its OWN family: amortized per-task
        seconds inside a vmap batch follow a different law than solo runs
        (compile amortized away, device kept busy), so the two populations
        must not pollute each other's regression. Sharded execution (§3.9)
        likewise gets a ``#s{n}`` suffix per shard count — its per-step
        psum overhead shifts the law's intercept — and those populations
        regress on rows-per-shard (:func:`_shard_rows`)."""
        key = f"{family}#batched" if batched else family
        return f"{key}#s{int(n_shards)}" if n_shards > 1 else key

    # -- write side --------------------------------------------------------
    def observe(self, task: TrainTask, seconds: float, n_rows: int,
                *, batched: bool = False, n_shards: int = 1,
                ratio_seconds: float | None = None) -> None:
        """Record one completed task. No-ops on junk (failed tasks report 0s).

        ``batched=True`` records under the family's fused-execution law;
        ``seconds`` is then the AMORTIZED share (batch total / batch size),
        which is exactly what the scheduler wants back from ``estimate``.

        ``n_shards > 1`` records under the family's sharded law (§3.9),
        regressing on rows-per-shard instead of full rows.

        ``ratio_seconds`` is what the obs/est ratio compares against
        ``task.cost`` (default: ``seconds``). The observer passes
        train + convert here: a conversion-charged task's cost includes the
        conversion estimate, so comparing it against training time alone
        would bias the family's ratio low — while the size LAW must stay on
        pure training seconds.
        """
        if seconds <= 0 or n_rows <= 0:
            return
        key = self._family_key(task.estimator, batched, n_shards)
        x, y = math.log(_shard_rows(n_rows, n_shards)), math.log(seconds)
        with self._lock:
            fam = self._buckets.setdefault(key, {})
            fam.setdefault(param_bucket(_law_params(task)), _LogStats()).add(x, y)
            self._families.setdefault(key, _LogStats()).add(x, y)
            if task.cost is not None and task.cost > 0:
                self._ratios.setdefault(key, _RatioStats()).add(
                    task.cost,
                    ratio_seconds if ratio_seconds is not None else seconds)
            self._n_observed += 1
        if self.prior is not None:      # write-through, outside our lock
            self.prior.observe(task, seconds, n_rows, batched=batched,
                               n_shards=n_shards,
                               ratio_seconds=ratio_seconds)

    def observe_convert(self, fmt_key: str, seconds: float, n_rows: int) -> None:
        """Record one actual uniform→native conversion (a prepared-data
        cache BUILD — hits cost nothing and must not be observed)."""
        if seconds <= 0 or n_rows <= 0:
            return
        with self._lock:
            self._converts.setdefault(fmt_key, _LogStats()).add(
                math.log(n_rows), math.log(seconds))
        if self.prior is not None:
            self.prior.observe_convert(fmt_key, seconds, n_rows)

    def predict_convert(self, fmt_key: str, n_rows: int) -> float | None:
        """Conversion-seconds estimate for a format at a data size, or None
        before the format has ever been observed converting (locally or in
        the prior)."""
        if n_rows <= 0:
            return None
        with self._lock:
            stats = self._converts.get(fmt_key)
            if stats is not None and stats.n:
                return math.exp(stats.predict(math.log(n_rows),
                                              self.default_exponent))
        if self.prior is not None:
            return self.prior.predict_convert(fmt_key, n_rows)
        return None

    def observe_eval(self, task: "TrainTask | str", seconds: float,
                     n_rows: int, *, n_shards: int = 1) -> None:
        """Record one executor-side scoring (§3.4; ``n_rows`` = EVAL split
        rows — a different axis than the training laws'). Pass the
        TrainTask for bucket resolution; a bare family string feeds only
        the pooled law. Sharded scoring (§3.9: partial-sum reduction over
        per-shard blocks) lands in its own ``#s{n}`` population, sized on
        eval rows-per-shard."""
        if seconds <= 0 or n_rows <= 0:
            return
        if isinstance(task, str):
            family, bucket = task, None
        else:
            family, bucket = task.estimator, param_bucket(task.params)
        family = self._family_key(family, False, n_shards)
        x, y = math.log(_shard_rows(n_rows, n_shards)), math.log(seconds)
        with self._lock:
            if bucket is not None:
                self._eval_buckets.setdefault(family, {}).setdefault(
                    bucket, _LogStats()).add(x, y)
            self._evals.setdefault(family, _LogStats()).add(x, y)
        if self.prior is not None:
            self.prior.observe_eval(task, seconds, n_rows, n_shards=n_shards)

    def predict_eval(self, task: "TrainTask | str", n_rows: int,
                     *, n_shards: int = 1) -> float | None:
        """Per-task eval-seconds estimate at an eval-split size, or None
        before the family has ever been observed scoring. Resolution
        mirrors the training law: exact (family, bucket) stats when a
        TrainTask is given, else the pooled family law; a cold SHARDED
        eval law falls back to the unsharded one (sharding assumed to buy
        nothing until it has demonstrated otherwise)."""
        if n_rows <= 0:
            return None
        if isinstance(task, str):
            family, bucket = task, None
        else:
            family, bucket = task.estimator, param_bucket(task.params)
        family = self._family_key(family, False, n_shards)
        x = math.log(_shard_rows(n_rows, n_shards))
        with self._lock:
            if bucket is not None:
                stats = self._eval_buckets.get(family, {}).get(bucket)
                if stats is not None and stats.n:
                    return math.exp(stats.predict(x, self.default_exponent))
            stats = self._evals.get(family)
            if stats is not None and stats.n:
                return math.exp(stats.predict(x, self.default_exponent))
        if self.prior is not None:
            got = self.prior.predict_eval(task, n_rows, n_shards=n_shards)
            if got is not None:
                return got
        if n_shards > 1:
            return self.predict_eval(task, n_rows)
        return None

    def observe_result(self, result, n_rows: int, eval_rows: int = 0,
                       *, n_shards: int = 1) -> None:
        """``on_result``-shaped adapter: feed a TaskResult straight in. Fused
        results carry ``batch_size > 1`` and amortized seconds, and land in
        the batched law automatically. A result that BUILT a prepared-data
        entry carries the FULL build as ``convert_seconds`` (the pools
        attach it to exactly one result per build) and feeds the per-format
        conversion law once — train and convert populations never mix. A
        result scored executor-side carries ``eval_seconds`` and (given
        ``eval_rows``, the validation split's size) feeds the per-family
        eval law; the obs/est ratio compares the task's planned cost against
        train + convert + eval, since eval-charged units plan with eval
        included. A ``timed_out`` failure feeds its elapsed time in as a
        censored observation (§3.7): the task ran AT LEAST that long, so
        the estimate that missed the deadline inflates toward reality and
        stops being trusted."""
        if not result.ok:
            if (getattr(result, "timed_out", False)
                    and result.train_seconds > 0):
                self.observe(result.task, result.train_seconds, n_rows,
                             batched=getattr(result, "batch_size", 1) > 1,
                             n_shards=n_shards)
            return
        batch_size = getattr(result, "batch_size", 1)
        conv = getattr(result, "convert_seconds", 0.0)
        eval_s = getattr(result, "eval_seconds", 0.0)
        self.observe(result.task, result.train_seconds, n_rows,
                     batched=batch_size > 1, n_shards=n_shards,
                     ratio_seconds=result.train_seconds + conv + eval_s)
        if eval_s > 0 and eval_rows > 0:
            self.observe_eval(result.task, eval_s, eval_rows,
                              n_shards=n_shards)
        if conv > 0:
            from repro_torch.core.interface import format_law_key, get_estimator

            try:
                est = get_estimator(result.task.estimator)
            except KeyError:
                return
            self.observe_convert(
                format_law_key(est, result.task.params), conv, n_rows)

    # -- read side ---------------------------------------------------------
    @property
    def n_observed(self) -> int:
        with self._lock:
            return self._n_observed

    def _family_exponent(self, family: str) -> float:
        """Count-weighted mean of the family's per-bucket slopes."""
        num = den = 0.0
        for stats in self._buckets.get(family, {}).values():
            b = stats.slope()
            if b is not None:
                b = min(max(b, _MIN_EXPONENT), _MAX_EXPONENT)
                num += b * stats.n
                den += stats.n
        return num / den if den else self.default_exponent

    def predict(self, task: TrainTask, n_rows: int,
                *, batched: bool = False, n_shards: int = 1) -> float | None:
        """Size-law prediction in seconds, or None with no relevant data.

        Resolution order: exact (family, bucket) stats, then pooled family
        stats, then the shared ``prior``'s own resolution (outside our
        lock). Monotone non-decreasing in ``n_rows`` by construction (slopes
        are clamped to [0, 3]). ``batched=True`` reads the fused-execution
        law (amortized per-task seconds); ``n_shards > 1`` reads the
        family's sharded law at rows-per-shard (§3.9).
        """
        if n_rows <= 0:
            return None
        key = self._family_key(task.estimator, batched, n_shards)
        x = math.log(_shard_rows(n_rows, n_shards))
        with self._lock:
            fam = self._buckets.get(key, {})
            stats = fam.get(param_bucket(_law_params(task)))
            if stats is not None and stats.n:
                return math.exp(stats.predict(x, self._family_exponent(key)))
            pooled = self._families.get(key)
            if pooled is not None and pooled.n:
                return math.exp(pooled.predict(x, self._family_exponent(key)))
        if self.prior is not None:
            return self.prior.predict(task, n_rows, batched=batched,
                                      n_shards=n_shards)
        return None

    def estimate(self, task: TrainTask, n_rows: int,
                 *, batched: bool = False, n_shards: int = 1) -> float | None:
        """Best cost estimate for scheduling: bucket law, else the task's own
        prior estimate corrected by the family's observed/estimated ratio,
        else the pooled family law. Still monotone in ``n_rows`` (the ratio
        branch is constant in size; the others are monotone laws).

        With ``batched=True`` the fused law answers first; before any fused
        batch of the family has been observed, the SEQUENTIAL estimate is
        the conservative fallback (fusion assumed to buy nothing until it
        has demonstrated otherwise — the ratio branch then learns the
        amortized/sequential speedup from the very first fused batch). A
        cold SHARDED law (§3.9) falls back the same way: the unsharded
        estimate answers until the first sharded observation lands.
        """
        key = self._family_key(task.estimator, batched, n_shards)
        with self._lock:
            fam = self._buckets.get(key, {})
            stats = fam.get(param_bucket(_law_params(task)))
            if stats is not None and stats.n and n_rows > 0:
                return math.exp(stats.predict(
                    math.log(_shard_rows(n_rows, n_shards)),
                    self._family_exponent(key)))
            ratio = self._ratios.get(key)
            if ratio is not None and ratio.n and task.cost is not None and task.cost > 0:
                return task.cost * ratio.factor()
        got = self.predict(task, n_rows, batched=batched, n_shards=n_shards)
        if got is None and n_shards > 1:
            return self.estimate(task, n_rows, batched=batched)
        if got is None and batched:
            return self.estimate(task, n_rows, batched=False)
        return got

    def predict_many(self, tasks: Sequence[TrainTask], n_rows: int,
                     *, n_shards: int = 1) -> dict[int, float]:
        """task_id -> estimate for every task the model can serve."""
        out: dict[int, float] = {}
        for t in tasks:
            p = self.estimate(t, n_rows, n_shards=n_shards)
            if p is not None and p > 0:
                out[t.task_id] = p
        return out

    # -- profiler protocol -------------------------------------------------
    def profile(self, tasks: Sequence[TrainTask], data) -> ProfileReport:
        """Third profiler source: model estimates where warm, fallback where
        cold. After one round of feedback the sampled-training cost of the
        paper's profiler (Fig. 3) drops to ~zero for known families."""
        import time

        t0 = time.perf_counter()
        costs = self.predict_many(tasks, getattr(data, "n_rows", 0))
        unknown = [t for t in tasks if t.task_id not in costs]
        profiling_seconds = time.perf_counter() - t0
        sampling_rate = None
        if unknown and self.fallback is not None:
            report = self.fallback.profile(unknown, data)
            costs.update(report.costs)
            profiling_seconds += report.profiling_seconds
            sampling_rate = report.sampling_rate
        return ProfileReport(costs=costs, profiling_seconds=profiling_seconds,
                             sampling_rate=sampling_rate)

    # -- persistence -------------------------------------------------------
    def to_dict(self) -> dict:
        with self._lock:
            return {
                "version": self.VERSION,
                "default_exponent": self.default_exponent,
                "n_observed": self._n_observed,
                "families": {
                    family: {
                        "pooled": dataclasses.asdict(self._families[family]),
                        "ratio": dataclasses.asdict(
                            self._ratios.get(family, _RatioStats())),
                        "buckets": {
                            bucket: dataclasses.asdict(stats)
                            for bucket, stats in buckets.items()
                        },
                    }
                    for family, buckets in self._buckets.items()
                },
                "converts": {
                    fmt_key: dataclasses.asdict(stats)
                    for fmt_key, stats in self._converts.items()
                },
                "evals": {
                    family: {
                        "pooled": dataclasses.asdict(stats),
                        "buckets": {
                            bucket: dataclasses.asdict(bstats)
                            for bucket, bstats in
                            self._eval_buckets.get(family, {}).items()
                        },
                    }
                    for family, stats in self._evals.items()
                },
            }

    def save(self, path: str | None = None) -> str:
        """Atomically write the model as JSON; returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("no path: pass one or construct CostModel(path=...)")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.path = path
        return path

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], *, path: str | None = None,
                  fallback=None, prior: "CostModel | None" = None) -> "CostModel":
        if d.get("version") != cls.VERSION:
            raise ValueError(f"unsupported cost-model version {d.get('version')!r}")
        cm = cls(path, default_exponent=float(d.get("default_exponent", 1.0)),
                 fallback=fallback, prior=prior)
        for family, entry in d.get("families", {}).items():
            cm._families[family] = _LogStats(**entry["pooled"])
            ratio = _RatioStats(**entry.get("ratio", {}))
            if ratio.n:
                cm._ratios[family] = ratio
            cm._buckets[family] = {
                bucket: _LogStats(**stats)
                for bucket, stats in entry.get("buckets", {}).items()
            }
        # optional sections: files written before the §3.3 conversion law /
        # §3.4 eval law simply lack the key and load with a cold one
        cm._converts = {
            fmt_key: _LogStats(**stats)
            for fmt_key, stats in d.get("converts", {}).items()
        }
        for family, entry in d.get("evals", {}).items():
            cm._evals[family] = _LogStats(**entry["pooled"])
            cm._eval_buckets[family] = {
                bucket: _LogStats(**stats)
                for bucket, stats in entry.get("buckets", {}).items()
            }
        cm._n_observed = int(d.get("n_observed", 0))
        return cm

    @classmethod
    def open(cls, path: str | None, *, fallback=None,
             default_exponent: float = 1.0,
             prior: "CostModel | None" = None) -> "CostModel":
        """Load the model at ``path`` if it exists, else start a fresh one
        that will save there. ``open(None)`` is a fresh in-memory model.

        A corrupt or partial file (torn write, version drift, truncated
        JSON) must not abort ``Session.resume``: the bad file is preserved
        as ``<path>.corrupt`` for post-mortem and the model starts cold
        with a warning — runtimes re-learn within a round.
        """
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    return cls.from_dict(json.load(f), path=path,
                                         fallback=fallback, prior=prior)
            except (ValueError, KeyError, TypeError) as e:
                # ValueError covers json.JSONDecodeError + version mismatch
                corrupt = path + ".corrupt"
                try:
                    os.replace(path, corrupt)
                except OSError:
                    corrupt = "<could not preserve>"
                warnings.warn(
                    f"cost model at {path} is corrupt "
                    f"({type(e).__name__}: {e}); starting cold — bad file "
                    f"preserved as {corrupt}", RuntimeWarning, stacklevel=2)
        return cls(path, default_exponent=default_exponent, fallback=fallback,
                   prior=prior)


def observed_drift(pairs: Iterable[tuple[float, float]]) -> float:
    """Mean |log(observed / estimated)| over (estimated, observed) pairs.

    0.0 means the profile was perfect; ``log 2 ≈ 0.69`` means observations
    run 2× off the estimates on (geometric) average. Pairs with a
    non-positive side are skipped — failed tasks report 0 seconds and must
    not register as drift.
    """
    logs = [abs(math.log(obs / est)) for est, obs in pairs if est > 0 and obs > 0]
    return sum(logs) / len(logs) if logs else 0.0
