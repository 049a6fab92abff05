"""Declarative search specification — the paper's Fig. 1 setup, made immutable.

A :class:`SearchSpec` replaces the eight ``ModelSearcher.set_*`` mutators with
one frozen, validated value object. It declares WHAT to search (spaces, tuner),
HOW to run it (executors, scheduler policy, profiler, pool options), WHAT to
optimise (metric, early-stop budgets) and WHERE to journal progress (WAL) —
and nothing about execution state, which lives in :class:`repro_torch.core.session.Session`.

Construct it from kwargs::

    spec = SearchSpec(spaces=[gbdt_grid, mlp_grid], n_executors=8,
                      policy="lpt", profiler=SamplingProfiler(0.01))

or declaratively from a plain dict (e.g. parsed from JSON/YAML config)::

    spec = SearchSpec.from_dict({
        "spaces": [{"estimator": "gbdt", "grid": {"eta": [0.1, 0.3]}}],
        "n_executors": 8,
        "tuner": {"kind": "asha", "budget_param": "steps",
                  "base_budget": 20, "max_budget": 100},
    })

Validation happens once, at construction (Propheticus-style): a bad policy,
metric, tuner kind or budget fails immediately, not three rounds into a search.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core.grid import GridBuilder, SearchSpace
from repro_torch.core.profiler import AnalyticProfiler, SamplingProfiler
from repro_torch.core.results import METRICS
from repro_torch.core.tuner import TUNER_KINDS, GridSearchTuner, Tuner, make_tuner

__all__ = ["SearchSpec", "POLICIES"]

#: scheduling policies understood by repro_torch.core.scheduler.schedule
POLICIES = ("lpt", "random", "round_robin", "dynamic", "lpt_dynamic")

_PROFILER_KINDS = ("sampling", "analytic", "cost_model")


def _space_from_dict(d: Mapping[str, Any]) -> SearchSpace:
    b = GridBuilder(d["estimator"])
    for param, values in d.get("grid", {}).items():
        b.add_grid(param, values)
    return b.build()


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Frozen, validated declaration of one model search."""

    spaces: tuple[SearchSpace, ...] = ()
    n_executors: int = 1
    policy: str = "lpt"
    #: a Tuner instance, a kind name ("grid" | "random" | "asha" |
    #: "surrogate", configured via ``tuner_args``), a {"kind": ..., **kwargs}
    #: mapping, or None (grid). Kind names / mappings are validated at
    #: construction and materialised fresh per Session — prefer them over
    #: instances for anything resumable: a Tuner INSTANCE carries its own
    #: mutable state across Session.resume.
    tuner: Any = None
    #: kwargs for a kind-name ``tuner`` (e.g. ``{"budget_param": "round",
    #: "base_budget": 10, "max_budget": 270}`` for "asha"); probe-validated
    #: at construction so a bad budget/eta fails HERE, not mid-search
    tuner_args: Mapping[str, Any] | None = None
    #: a profiler instance, a {"kind": "sampling"|"analytic", ...} mapping,
    #: or None (sampling at 3%, the ModelSearcher default)
    profiler: Any = None
    metric: str = "auc"
    seed: int = 0
    wal_path: str | None = None
    # -- early-stop budgets (Session enforces them mid-stream) -----------
    max_seconds: float | None = None
    max_tasks: int | None = None
    #: stop as soon as a validated result reaches this metric value
    target_metric: float | None = None
    # -- profile-feedback loop (DESIGN.md §3.1) --------------------------
    #: where the persistent CostModel JSON lives; None + a wal_path defaults
    #: to "<wal_path>.cost.json" once feedback is enabled, so the model sits
    #: next to the WAL and Session.resume starts warm
    cost_model_path: str | None = None
    #: observed/estimated drift (mean |log obs/est|, see
    #: repro_torch.core.cost_model.observed_drift) above which the Session re-runs
    #: rebalance on the remaining tasks mid-round; None disables re-planning.
    #: log(2) ≈ 0.69 means "replan when runtimes are 2× off the profile"
    replan_threshold: float | None = None
    # -- task fusion (core/fusion.py, DESIGN.md §3.2) --------------------
    #: pack same-family tasks into vmap-fused batches that train as one
    #: device program; the scheduler plans over the fused units and the
    #: pools unbatch results, so streaming/WAL/budget semantics are unchanged
    fuse: bool = False
    #: largest fused batch (configs per program); bigger batches amortize
    #: more dispatch/compile but are scheduled atomically, so very large
    #: values can cost load balance on few executors
    max_fuse: int = 16
    # -- fault plane (DESIGN.md §3.7) ------------------------------------
    #: in-session retries for a task whose train raises: the task re-queues
    #: with capped exponential backoff up to this many times, then surfaces
    #: as a terminal error TaskResult. 0 = the pre-§3.7 fail-fast behavior.
    max_task_retries: int = 0
    #: base of the retry backoff (seconds; doubles per failed attempt,
    #: capped at RetryLedger.BACKOFF_CAP). Pools take an injectable
    #: ``sleep=`` so simulated clocks pay nothing.
    retry_backoff: float = 0.05
    #: a task claimed by this many executors that ALL died is quarantined
    #: (error result, ``SearchStats.n_quarantined``) instead of re-queued,
    #: so one poison config cannot cascade-kill the pool. None disables.
    poison_threshold: int | None = 3
    #: soft deadline multiplier: a unit in flight longer than
    #: ``deadline_factor`` × its CostModel-predicted cost is speculatively
    #: duplicated on an idle executor (first completion wins) — the same
    #: machinery as ``pool_options['speculation_factor']``, which takes
    #: precedence when both are set. None disables.
    deadline_factor: float | None = None
    #: hard wall-clock timeout per unit (seconds): an overdue task is
    #: abandoned-and-requeued (burning one retry attempt) and, out of
    #: attempts, surfaces as a terminal ``timed_out`` error result whose
    #: elapsed time feeds the CostModel as a censored observation. None
    #: disables (the default — a hung worker thread then blocks forever,
    #: the pre-§3.7 behavior).
    task_timeout_seconds: float | None = None
    #: fault-injection / speculation knobs forwarded to the executor pool
    pool_options: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # -- sharded data plane (DESIGN.md §3.9) -----------------------------
    #: row-shard count for prepared data: > 1 makes every executor train
    #: and score against a ShardedPlacement (per-shard row blocks,
    #: cross-shard psums) instead of a replicated copy. 1 = replicated
    #: (the pre-§3.9 behavior). The CostModel then learns the family's
    #: sharded laws and ``SearchStats.shard_residency_bytes`` reports the
    #: per-shard footprint.
    n_shards: int = 1

    # ------------------------------------------------------------------
    def __post_init__(self):
        spaces = self.spaces
        if isinstance(spaces, SearchSpace):
            spaces = (spaces,)
        spaces = tuple(spaces)
        for sp in spaces:
            if not isinstance(sp, SearchSpace):
                raise TypeError(f"spaces must be SearchSpace, got {type(sp).__name__}")
        object.__setattr__(self, "spaces", spaces)
        object.__setattr__(self, "pool_options", dict(self.pool_options))
        if not spaces and not isinstance(self.tuner, Tuner):
            raise ValueError("a SearchSpec needs at least one space "
                             "(or a Tuner instance that carries its own tasks)")
        if self.n_executors < 1:
            raise ValueError(f"n_executors must be >= 1, got {self.n_executors}")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; known: {POLICIES}")
        if self.metric not in METRICS:
            raise ValueError(f"unknown metric {self.metric!r}; known: {sorted(METRICS)}")
        if isinstance(self.tuner, Mapping) and "kind" not in self.tuner:
            raise ValueError("declarative tuner mapping needs a 'kind' key")
        if (self.tuner is not None
                and not isinstance(self.tuner, (Tuner, Mapping, str))):
            raise TypeError("tuner must be a Tuner, a kind name, a "
                            "{'kind': ...} mapping, or None")
        if self.tuner_args is not None:
            if not isinstance(self.tuner, str):
                raise ValueError("tuner_args applies only when tuner is a "
                                 "kind name (e.g. tuner='asha')")
            object.__setattr__(self, "tuner_args", dict(self.tuner_args))
        if isinstance(self.tuner, str):
            if self.tuner not in TUNER_KINDS:
                raise ValueError(f"unknown tuner {self.tuner!r}; "
                                 f"known: {sorted(TUNER_KINDS)}")
            # probe-construct once so bad tuner_args (missing budgets, eta<2,
            # unknown kwargs) fail at construction, Propheticus-style
            make_tuner(self.tuner, spaces, **(self.tuner_args or {}))
        if isinstance(self.profiler, Mapping):
            kind = self.profiler.get("kind")
            if kind not in _PROFILER_KINDS:
                raise ValueError(f"unknown profiler kind {kind!r}; known: {_PROFILER_KINDS}")
        elif self.profiler is not None and not hasattr(self.profiler, "profile"):
            raise TypeError("profiler must expose .profile(tasks, data)")
        for name in ("max_seconds", "max_tasks", "replan_threshold"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        if self.max_tasks is not None:
            object.__setattr__(self, "max_tasks", int(self.max_tasks))
        object.__setattr__(self, "fuse", bool(self.fuse))
        object.__setattr__(self, "max_fuse", int(self.max_fuse))
        if self.max_fuse < 2:
            raise ValueError(f"max_fuse must be >= 2, got {self.max_fuse}")
        # -- fault plane (§3.7) ------------------------------------------
        object.__setattr__(self, "max_task_retries", int(self.max_task_retries))
        if self.max_task_retries < 0:
            raise ValueError(
                f"max_task_retries must be >= 0, got {self.max_task_retries}")
        if self.retry_backoff < 0:
            raise ValueError(
                f"retry_backoff must be >= 0, got {self.retry_backoff}")
        if self.poison_threshold is not None:
            object.__setattr__(self, "poison_threshold",
                               int(self.poison_threshold))
            if self.poison_threshold < 1:
                raise ValueError(
                    f"poison_threshold must be >= 1, got {self.poison_threshold}")
        for name in ("deadline_factor", "task_timeout_seconds"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        # -- sharded data plane (§3.9) -----------------------------------
        object.__setattr__(self, "n_shards", int(self.n_shards))
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    # -- construction helpers ------------------------------------------
    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SearchSpec":
        """Build a spec from a plain mapping (JSON/YAML-friendly)."""
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown SearchSpec keys: {sorted(unknown)}")
        spaces = []
        for sp in d.pop("spaces", ()):
            spaces.append(sp if isinstance(sp, SearchSpace) else _space_from_dict(sp))
        return cls(spaces=tuple(spaces), **d)

    def replace(self, **changes) -> "SearchSpec":
        """A copy with some fields swapped (the spec itself never mutates)."""
        return dataclasses.replace(self, **changes)

    # -- materialisation (called by Session, once per run) -------------
    def build_tuner(self) -> Tuner:
        if self.tuner is None:
            return GridSearchTuner(self.spaces)
        if isinstance(self.tuner, Tuner):
            return self.tuner
        if isinstance(self.tuner, str):
            return make_tuner(self.tuner, self.spaces,
                              **(self.tuner_args or {}))
        kw = dict(self.tuner)
        return make_tuner(kw.pop("kind"), self.spaces, **kw)

    def build_profiler(self):
        if self.profiler is None:
            return SamplingProfiler(sampling_rate=0.03, seed=self.seed)
        if isinstance(self.profiler, Mapping):
            kw = dict(self.profiler)
            kind = kw.pop("kind")
            if kind == "sampling":
                kw.setdefault("seed", self.seed)
                return SamplingProfiler(**kw)
            if kind == "cost_model":
                # persistent learned profiler; cold tasks fall back to the
                # declared (or default sampling) profiler
                from repro_torch.core.cost_model import CostModel

                fallback = kw.pop("fallback", None)
                if isinstance(fallback, Mapping):
                    fallback = self.replace(profiler=dict(fallback)).build_profiler()
                elif fallback is None:
                    fallback = SamplingProfiler(sampling_rate=0.03, seed=self.seed)
                return CostModel.open(kw.pop("path", self.cost_model_path),
                                      fallback=fallback, **kw)
            return AnalyticProfiler(**kw)
        return self.profiler

    @property
    def n_grid_tasks(self) -> int:
        """Size of the declared static grid (dynamic tuners may differ)."""
        return sum(len(sp) for sp in self.spaces)
