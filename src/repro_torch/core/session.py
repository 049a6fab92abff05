"""Session — the Driver's lifecycle object (paper §III-A, Tune-style trials).

A Session binds one immutable :class:`repro_torch.core.spec.SearchSpec` to one
executor backend and runs the propose → profile → schedule → execute →
observe loop with a REAL lifecycle instead of a single blocking call:

    spec = SearchSpec(spaces=[...], n_executors=8, policy="lpt")
    session = Session(spec)
    for result in session.results(train, validate):   # streams TaskResults
        print(result.task.key(), result.ok)
    multi = session.multi_model()

* ``session.results(...)`` is a generator yielding each :class:`TaskResult`
  the moment its task completes on the backend (both backends stream via
  ``ExecutorBackend.submit``), so schedulers/monitors can react mid-search;
* ``on_result`` callbacks observe the same stream without owning the loop;
* early-stop budgets (``max_seconds``, ``max_tasks``, ``target_metric`` on
  the spec) cancel cleanly mid-round — the WAL already holds every finished
  task, so nothing is lost;
* ``Session.resume(wal_path, spec)`` reconstructs a killed search from its
  write-ahead log and finishes only the remaining work;
* profile feedback (``spec.cost_model_path`` / ``spec.replan_threshold``):
  every completion updates a persistent :class:`~repro_torch.core.cost_model.CostModel`
  through the pools' ``on_result`` hook, warm families skip the profiler, and
  when observed runtimes drift past the threshold the remaining tasks are
  re-estimated and re-planned mid-round (DESIGN.md §3.1);
* task fusion (``spec.fuse`` / ``spec.max_fuse``): same-family tasks pack
  into fused batches (:mod:`repro_torch.core.fusion`) that train through
  one ``Estimator.train_batched`` call per batch; the scheduler plans over fused units (splitting
  bottleneck batches at bucket boundaries) and the pools unbatch results,
  so this streaming loop is untouched (DESIGN.md §3.2);
* the prepared-data plane (DESIGN.md §3.3): executors resolve uniform→native
  conversion through the process-wide PreparedDataCache, the CostModel
  learns a per-format conversion law from ``TaskResult.convert_seconds``,
  cold format groups have that one-time cost charged to their first unit
  before planning, and ``SearchStats.prepared_cache_hits/misses`` /
  ``convert_seconds_total`` surface the traffic;
* the fused validation plane (DESIGN.md §3.4): when ``validate`` is given
  and the backend's ``submit`` accepts an EvalPlan, each executor SCORES
  the models it trained (batched device inference, eval data resolved per
  placement through the PreparedDataCache), results stream with
  ``TaskResult.score`` attached — ``target_metric`` and dynamic-tuner
  feedback stop re-predicting on the driver — the CostModel learns a
  per-family eval law from ``eval_seconds``, and every planned unit
  carries its eval estimate (``scheduler.charge_units``);
* ``Session.run(spec, train, validate)`` is the one-shot convenience.
"""
from __future__ import annotations

import inspect
import time
from typing import Callable, Iterator, Mapping

from repro_torch import tracing
from repro_torch.core.backend import ExecutorBackend
from repro_torch.core.cost_model import CostModel, observed_drift
from repro_torch.core.data_format import DenseMatrix, prepared_data_cache
from repro_torch.core.evaluation import EvalPlan, predict_compile_cache
from repro_torch.core.executor import LocalExecutorPool
from repro_torch.core.fault import SearchWAL
from repro_torch.core.fusion import FusedBatch, compile_cache, fuse_tasks, split_for_balance
from repro_torch.core.interface import (
    TaskResult,
    format_law_key,
    get_estimator,
    prepared_cache_key,
)
from repro_torch.core.results import METRICS, MultiModel
from repro_torch.core.scheduler import (
    charge_first_of_group,
    charge_units,
    replan,
    restrict,
    schedule,
)
from repro_torch.core.spec import SearchSpec

__all__ = ["Session", "SearchStats"]

#: cost-blind policies skip profiling entirely, matching the paper's
#: random-scheduling baseline which pays no profiling overhead.
_COST_BLIND = ("random", "round_robin")

#: a replan needs at least this many fresh observations before the drift
#: signal is trusted, and a single round never replans more than this often
_MIN_REPLAN_WINDOW = 2
_MAX_REPLANS_PER_ROUND = 8


class SearchStats:
    """Bookkeeping the benchmarks read (profiling ratio, makespan, etc.)."""

    def __init__(self):
        self.profiling_seconds = 0.0
        self.total_seconds = 0.0
        self.n_tasks = 0
        self.n_failures = 0
        # -- fault plane (DESIGN.md §3.7) -------------------------------
        self.n_retries = 0              # extra attempts paid beyond the first
        self.n_quarantined = 0          # poison tasks quarantined terminally
        self.n_timeouts = 0             # results that crossed the hard deadline
        self.n_replans = 0              # mid-round drift-triggered replans
        self.n_rung_kills = 0           # rung tasks cancelled mid-flight by an
                                        # adaptive tuner (ASHA early_kill, §3.6)
        self.n_model_estimates = 0      # tasks costed by the CostModel (free)
        self.n_profiled = 0             # tasks that still needed the profiler
        self.policy = ""
        # -- task fusion (DESIGN.md §3.2) --------------------------------
        self.n_fused_batches = 0        # fused units planned across rounds
        self.n_fused_tasks = 0          # tasks that rode inside those units
        self.compile_cache_hits = 0     # this session's share of the
        self.compile_cache_misses = 0   # process-wide CompileCache traffic
        # -- prepared-data plane (DESIGN.md §3.3) ------------------------
        self.prepared_cache_hits = 0    # this session's share of the process-
        self.prepared_cache_misses = 0  # wide PreparedDataCache traffic
        #: conversion seconds actually paid (sum of TaskResult.convert_seconds
        #: over this session's results) — on a warm cache this is ~0 while
        #: the same search used to re-convert every task
        self.convert_seconds_total = 0.0
        # -- fused validation plane (DESIGN.md §3.4) ---------------------
        #: executor-side scoring seconds actually paid (sum of
        #: TaskResult.eval_seconds) — the time the old driver-side
        #: validateAll loop spent serially and invisibly
        self.eval_seconds_total = 0.0
        self.predict_compile_cache_hits = 0    # this session's share of the
        self.predict_compile_cache_misses = 0  # predict CompileCache traffic
        # -- sharded data plane (DESIGN.md §3.9) -------------------------
        #: per-shard resident bytes across the backend cache's
        #: ShardedPlacement entries at the end of the run — what ONE device
        #: of a shard group holds (bytes_per_device semantics), not the
        #: host-side stack. 0 for unsharded searches.
        self.shard_residency_bytes = 0

    @property
    def profiling_ratio(self) -> float:  # paper Fig. 3
        return self.profiling_seconds / self.total_seconds if self.total_seconds else 0.0

    @property
    def compile_cache_hit_rate(self) -> float:
        total = self.compile_cache_hits + self.compile_cache_misses
        return self.compile_cache_hits / total if total else 0.0

    @property
    def prepared_cache_hit_rate(self) -> float:
        total = self.prepared_cache_hits + self.prepared_cache_misses
        return self.prepared_cache_hits / total if total else 0.0

    @property
    def predict_compile_cache_hit_rate(self) -> float:
        total = self.predict_compile_cache_hits + self.predict_compile_cache_misses
        return self.predict_compile_cache_hits / total if total else 0.0


class Session:
    """One run (or resumed run) of one SearchSpec on one backend."""

    def __init__(self, spec: SearchSpec | Mapping, backend: ExecutorBackend | None = None):
        if isinstance(spec, Mapping):
            spec = SearchSpec.from_dict(spec)
        self.spec = spec
        if backend is not None:
            # adopt the backend's WAL so resume/skip sees one source of truth
            self._backend: ExecutorBackend | None = backend
            self.wal = backend.wal
        else:
            self._backend = None
            self.wal = SearchWAL(spec.wal_path)
        self.stats = SearchStats()
        self.stats.policy = spec.policy
        self.finished = False          # True once results() has been drained
        self.stop_reason: str | None = None
        self._results: list[TaskResult] = []
        #: the feedback CostModel (DESIGN.md §3.1); populated lazily by
        #: results() when the spec enables it, or adopted from a CostModel
        #: passed as the spec's profiler. Inspectable mid-stream.
        self.cost_model: CostModel | None = None
        self._observer_installed = False

    # ------------------------------------------------------------------
    @property
    def backend(self) -> ExecutorBackend:
        if self._backend is None:
            # fault-plane knobs (§3.7) flow from the spec; explicit
            # pool_options still win so tests can override any of them
            opts = dict(
                max_task_retries=self.spec.max_task_retries,
                retry_backoff=self.spec.retry_backoff,
                poison_threshold=self.spec.poison_threshold,
                deadline_factor=self.spec.deadline_factor,
                task_timeout_seconds=self.spec.task_timeout_seconds,
            )
            if self.spec.n_shards > 1:       # §3.9: sharded placement token
                opts["n_shards"] = self.spec.n_shards
            opts.update(self.spec.pool_options)
            self._backend = LocalExecutorPool(
                self.spec.n_executors, wal=self.wal, **opts
            )
        return self._backend

    # -- profile-feedback plumbing (DESIGN.md §3.1) --------------------
    def _default_cost_model_path(self) -> str | None:
        """Where the model persists: ``cost_model_path``, else next to the
        WAL ("<wal_path>.cost.json") once the feedback loop is enabled."""
        spec = self.spec
        if spec.cost_model_path is not None:
            return spec.cost_model_path
        if spec.wal_path and spec.replan_threshold is not None:
            return spec.wal_path + ".cost.json"
        return None

    def _ensure_cost_model(self, profiler) -> CostModel | None:
        """Resolve the session's CostModel: an explicitly-passed CostModel
        profiler is adopted (inheriting the default persistence path if it
        has none of its own); otherwise one is opened at the default path."""
        if self.cost_model is not None:
            return self.cost_model
        if isinstance(profiler, CostModel):
            if profiler.path is None:
                default = self._default_cost_model_path()
                if default is not None and profiler.n_observed == 0:
                    # pathless declared model + a default location: warm-load
                    # what a previous session persisted there, keeping the
                    # declared fallback/exponent/fleet prior
                    profiler = CostModel.open(
                        default, fallback=profiler.fallback,
                        default_exponent=profiler.default_exponent,
                        prior=profiler.prior)
                else:
                    profiler.path = default
            self.cost_model = profiler
            return profiler
        path = self._default_cost_model_path()
        if path is None and self.spec.replan_threshold is None:
            return None                       # feedback loop not requested
        self.cost_model = CostModel.open(path)
        return self.cost_model

    def _install_observer(self, backend, cm: CostModel, n_rows: int,
                          eval_rows: int = 0) -> bool:
        """Chain the cost-model observer onto the pool's ``on_result`` hook
        so EVERY completion updates the model the moment it lands — including
        results a cancelled stream never surfaces. Returns False for foreign
        backends without the hook; the caller then observes inline.
        ``eval_rows`` (the validation split's size) routes executor-side
        ``eval_seconds`` into the per-family eval law (§3.4).

        A hook installed by an earlier Session on a reused backend is
        REPLACED, not chained onto — otherwise the dead session's model
        would keep absorbing runtimes tagged with ITS training-data size."""
        if not hasattr(backend, "on_result"):
            return False
        if not self._observer_installed:
            prev = backend.on_result
            if getattr(prev, "_session_observer", False):
                prev = prev._chained_prev      # drop the stale session's hook
            n_shards = self.spec.n_shards

            def _observe(res: TaskResult, _prev=prev) -> None:
                cm.observe_result(res, n_rows, eval_rows, n_shards=n_shards)
                if _prev is not None:
                    _prev(res)

            _observe._session_observer = True
            _observe._chained_prev = prev
            backend.on_result = _observe
            self._observer_installed = True
        return True

    def _cost_batch(self, batch, train, profiler, cm: CostModel | None):
        """Attach cost estimates: CostModel answers what it has learned
        (microseconds), the profiler is paid only for cold tasks — after
        warm-up the paper's Fig. 3 profiling overhead goes to ~zero."""
        known: dict[int, float] = {}
        if cm is not None:
            known = cm.predict_many(batch, train.n_rows,
                                    n_shards=self.spec.n_shards)
            self.stats.n_model_estimates += len(known)
        unknown = [t for t in batch if t.task_id not in known]
        if unknown:
            with tracing.span("search.profile", tasks=len(unknown)):
                report = profiler.profile(unknown, train)
            self.stats.profiling_seconds += report.profiling_seconds
            self.stats.n_profiled += len(report.costs)
            known.update(report.costs)
        return [t.with_cost(known[t.task_id]) if t.task_id in known else t
                for t in batch]

    def _reestimate(self, pending, train, cm: CostModel | None, round_results):
        """Re-cost the remaining tasks from observed feedback before a replan."""
        if cm is not None:
            out = []
            for t in pending:
                p = cm.estimate(t, train.n_rows, n_shards=self.spec.n_shards)
                out.append(t.with_cost(p) if p is not None and p > 0 else t)
            return out
        # no model (foreign setup): per-family observed/estimated correction
        ratios: dict[str, list[float]] = {}
        for r in round_results:
            if r.ok and r.task.cost and r.train_seconds > 0:
                ratios.setdefault(r.task.estimator, []).append(
                    r.train_seconds / r.task.cost)
        out = []
        for t in pending:
            rs = ratios.get(t.estimator)
            out.append(t.with_cost(t.cost * sum(rs) / len(rs))
                       if rs and t.cost else t)
        return out

    @staticmethod
    def _apply_charge(u, extra: float):
        """Charge hook for charge_first_of_group: a FusedBatch is charged on
        a MEMBER (fusion.charge_member) so bucket splits / restricts — which
        re-sum member costs — keep the conversion in the plan."""
        if isinstance(u, FusedBatch):
            return u.charge_member(extra)
        return u.with_cost((u.cost or 0.0) + extra)

    def _charge_conversion(self, units, cm: CostModel | None,
                           train: DenseMatrix):
        """Conversion-aware costing (DESIGN.md §3.3): for every format group
        whose prepared-data entry is NOT resident under every placement the
        backend converts at (thread pools: the default device; mesh pools:
        one token per slice), add the CostModel's learned conversion
        estimate to the one unit that will run first
        (scheduler.charge_first_of_group — ONE charge even when several
        slices must each build, since the builds run in parallel on
        different executors). Warm formats, unknown (never-observed)
        conversions, and backends that own their data handling (custom mesh
        task_runner: no placements) are left uncharged."""
        if cm is None:
            return list(units)
        backend = self.backend
        pc = getattr(backend, "prepared_cache", None) or prepared_data_cache()
        placements_fn = getattr(backend, "prepare_placements", None)
        placements = placements_fn() if placements_fn is not None else [None]
        if not placements:
            return list(units)

        def cache_key(u):
            first = u.tasks[0] if isinstance(u, FusedBatch) else u
            try:
                est = get_estimator(first.estimator)
            except KeyError:
                return None              # foreign tasks (LM runner workloads)
            keys = [prepared_cache_key(est, train, first.params, p)
                    for p in placements]
            if all(pc.contains(k) for k in keys):
                return None              # resident everywhere it will run
            # group identity = the conversion law's family key (format key +
            # prepare-override discriminator; the fingerprint is constant
            # within a round) — two custom-prepare estimators sharing a
            # declared format stay separate groups, each charged
            return format_law_key(est, first.params)

        return charge_first_of_group(
            units, cache_key,
            lambda key: cm.predict_convert(key, train.n_rows),
            apply=self._apply_charge)

    def _charge_eval(self, units, cm: CostModel | None,
                     eval_plan: EvalPlan | None):
        """Eval-aware costing (DESIGN.md §3.4): when the backend will score
        executor-side, every unit's planned cost carries the CostModel's
        learned per-family eval estimate (``predict_eval`` at the EVAL
        split's size; None until a family has been observed scoring —
        scheduler.charge_units leaves those unchanged). Fused batches are
        charged per MEMBER so bucket splits keep each piece's share."""
        if cm is None or eval_plan is None:
            return list(units)
        n_eval = eval_plan.data.n_rows
        n_shards = self.spec.n_shards
        member_vals: dict[int, dict[int, float | None]] = {}

        def extra(u):
            if isinstance(u, FusedBatch):
                # per-member estimates (bucket-resolved), computed ONCE and
                # reused by apply — a split piece keeps exactly its own
                # members' eval share
                vals = {m.task_id: cm.predict_eval(m, n_eval,
                                                   n_shards=n_shards)
                        for m in u.tasks}
                member_vals[u.task_id] = vals
                return sum(v for v in vals.values() if v) or None
            return cm.predict_eval(u, n_eval, n_shards=n_shards)

        def apply(u, e):
            if isinstance(u, FusedBatch):
                vals = member_vals[u.task_id]
                return u.charge_each(lambda m: vals[m.task_id])
            return u.with_cost((u.cost or 0.0) + e) if u.cost is not None else u

        return charge_units(units, extra, apply=apply)

    def _fuse(self, costed, cm: CostModel | None, n_rows: int):
        """Pack a costed batch into fused units (spec.fuse) and account them."""
        units = fuse_tasks(costed, max_fuse=self.spec.max_fuse,
                           cost_model=cm, n_rows=n_rows)
        fused = [u for u in units if isinstance(u, FusedBatch)]
        self.stats.n_fused_batches += len(fused)
        self.stats.n_fused_tasks += sum(u.batch_size for u in fused)
        return units

    def _pending_units(self, assignment, pending, cm: CostModel | None, n_rows: int):
        """The fused/plain units still outstanding in the ACTIVE plan, with
        members re-costed from feedback (amortized law for fused members).
        Unit membership — and therefore unit ids — is preserved, so
        ``restrict(assignment, units)`` forms the comparable residual and the
        replan's never-worse guarantee carries over to fused rounds."""
        by_id = {t.task_id: t for t in pending}

        def recost(m):
            if cm is not None:
                est = cm.estimate(m, n_rows, batched=True,
                                  n_shards=self.spec.n_shards)
                if est is not None and est > 0:
                    return m.with_cost(est)
            return by_id.get(m.task_id, m)

        def solo_prior(m):
            # fresh pre-amortization (solo, train-only) estimate — priors
            # must NOT carry over from the active plan's units, whose
            # priors already include the last _charge_eval; re-charging
            # after this recost would otherwise compound into them
            got = by_id.get(m.task_id)
            return got.cost if got is not None else m.cost

        units = []
        for u in assignment.all_tasks():
            if isinstance(u, FusedBatch):
                alive = u.restrict(set(by_id))
                if alive is not None:
                    units.append(alive.recost(recost, prior_fn=solo_prior))
            elif u.task_id in by_id:
                units.append(by_id[u.task_id])
        return units

    # ------------------------------------------------------------------
    def results(
        self,
        train: DenseMatrix,
        validate: DenseMatrix | None = None,
        *,
        on_result: Callable[[TaskResult], None] | None = None,
    ) -> Iterator[TaskResult]:
        """Run the search, yielding TaskResults as rounds complete.

        ``validate`` is required for dynamic tuners (they need scores to
        steer) and for the ``target_metric`` budget. Closing the generator
        early is a clean cancellation; completed work stays in the WAL.
        """
        if self.finished:
            raise RuntimeError("this Session already ran; create a new one "
                               "(or Session.resume the WAL) to search again")
        spec = self.spec
        t_start = time.perf_counter()
        tuner = spec.build_tuner()
        profiler = spec.build_profiler()
        cm = self._ensure_cost_model(profiler)
        if isinstance(profiler, CostModel) and cm is not None:
            profiler = cm          # _ensure may have swapped in the warm copy
        backend = self.backend
        pool_observes = (self._install_observer(
            backend, cm, train.n_rows,
            validate.n_rows if validate is not None else 0)
            if cm is not None else False)
        metric_fn = METRICS[spec.metric]
        # executor-side scoring (§3.4): backends whose submit accepts a
        # ``validate=`` EvalPlan score each model where it trained and
        # stream TaskResult.score back; foreign backends without the
        # keyword keep the driver-side fallback (score_of, computed lazily)
        eval_plan = None
        if validate is not None:
            try:
                supports = "validate" in inspect.signature(
                    backend.submit).parameters
            except (TypeError, ValueError):
                supports = False
            if supports:
                eval_plan = EvalPlan(validate, spec.metric)
        cc = compile_cache()
        ec = predict_compile_cache()
        pc = getattr(backend, "prepared_cache", None) or prepared_data_cache()
        # Under the multi-tenant service (serve.search_service) many sessions
        # share these caches CONCURRENTLY, so a global before/after delta
        # would blend every tenant's traffic into this session's stats. A
        # backend that declares a ``tenant`` scopes the delta to that
        # tenant's ledger instead (exact — the ledgers update in the same
        # critical sections as the global counters, DESIGN.md §3.5).
        tenant = getattr(backend, "tenant", None)

        def _counts(cache):
            if tenant is not None and hasattr(cache, "tenant_counters"):
                snap = cache.tenant_counters().get(tenant, {})
                return int(snap.get("hits", 0)), int(snap.get("misses", 0))
            return cache.counters()

        cc_hits0, cc_misses0 = _counts(cc)
        ec_hits0, ec_misses0 = _counts(ec)
        pc_hits0, pc_misses0 = _counts(pc)
        if tuner.is_dynamic and validate is None:
            raise ValueError("dynamic tuners need validation data")
        # adaptive tuners (AshaController) expose kill_candidates(): rung
        # members already outperformed by enough siblings, cancelled through
        # the same stream-close + drain path a drift replan uses (§3.6)
        kill_fn = (getattr(tuner, "kill_candidates", None)
                   if tuner.is_dynamic else None)
        killed_ids: set[int] = set()
        try:
            while True:
                budget_left = (None if spec.max_tasks is None
                               else max(0, spec.max_tasks - len(self._results)))
                batch = tuner.suggest(budget_left)
                if not batch:
                    break
                remaining = self.wal.remaining(batch)
                if tuner.is_dynamic and len(remaining) < len(batch):
                    # WAL resume mid-adaptive-search: replay the journalled
                    # completions (score + carried rung state) so the tuner
                    # sees the same feedback it would have streamed live —
                    # otherwise it would re-suggest this batch forever
                    live = {t.task_id for t in remaining}
                    recs = self.wal.completed()
                    for t in batch:
                        if t.task_id in live:
                            continue
                        rec = recs[t.task_id]
                        tuner.report(TaskResult(
                            task=t, model=None, train_seconds=rec.seconds,
                            executor_id=rec.executor_id, score=rec.score,
                            convert_seconds=rec.convert_seconds,
                            eval_seconds=rec.eval_seconds,
                            resume_state=self.wal.resume_state(t.task_id)))
                batch = remaining
                if not batch:
                    if not tuner.is_dynamic:
                        break
                    continue
                # 1. profile (paper §III-C) — the CostModel serves what it
                # has learned for free, the profiler covers cold tasks
                if spec.policy in _COST_BLIND:
                    costed = list(batch)
                else:
                    costed = self._cost_batch(batch, train, profiler, cm)
                # 2. schedule (greedy job-shop / baselines) — with fusion on,
                # the plan is over fused units; bottleneck batches split at
                # bucket boundaries (fusion.split_for_balance). Cold format
                # groups get their one-time conversion charged to their
                # first unit (§3.3), so LPT stops mis-ranking them.
                units = (self._fuse(costed, cm, train.n_rows)
                         if spec.fuse else costed)
                # §3.4: every unit that will be scored executor-side carries
                # its eval estimate; §3.3: cold formats' one-time conversion
                units = self._charge_eval(units, cm, eval_plan)
                units = self._charge_conversion(units, cm, train)
                assignment = schedule(
                    units, spec.n_executors, policy=spec.policy, seed=spec.seed,
                    splitter=split_for_balance if spec.fuse else None)
                # 3. execute — stream results off the backend as they land.
                # When observed runtimes drift past spec.replan_threshold,
                # cancel the stream, re-estimate the remaining tasks from
                # feedback and re-run rebalance (scheduler.replan) mid-round.
                round_results: list[TaskResult] = []
                scores: dict[int, float] = {}  # task_id -> validation score

                def score_of(r: TaskResult) -> float:
                    if r.task.task_id not in scores:
                        # executor-scored results (§3.4) streamed their
                        # metric in — the driver-side predict below survives
                        # only as the fallback for foreign backends
                        if r.score is not None:
                            scores[r.task.task_id] = r.score
                        else:
                            scores[r.task.task_id] = metric_fn(
                                validate.y, r.model.predict_proba(validate.x))
                    return scores[r.task.task_id]

                pending = list(costed)
                done_ids: set[int] = set()
                replans_left = _MAX_REPLANS_PER_ROUND

                def take(res: TaskResult) -> None:
                    """Bookkeeping shared by the stream and straggler paths."""
                    round_results.append(res)
                    self._results.append(res)
                    done_ids.add(res.task.task_id)
                    self.stats.convert_seconds_total += getattr(
                        res, "convert_seconds", 0.0)
                    self.stats.eval_seconds_total += getattr(
                        res, "eval_seconds", 0.0)
                    if cm is not None and not pool_observes:
                        cm.observe_result(
                            res, train.n_rows,
                            validate.n_rows if validate is not None else 0,
                            n_shards=spec.n_shards)
                    if tuner.is_dynamic:
                        # feed the tuner the moment the result lands — this
                        # is what lets ASHA promote (and kill) mid-round
                        if res.ok and res.score is None and res.model is not None:
                            res.score = score_of(res)
                        tuner.report(res)
                    if on_result is not None:
                        on_result(res)

                while True:
                    stream = (backend.submit(assignment, train,
                                             validate=eval_plan)
                              if eval_plan is not None
                              else backend.submit(assignment, train))
                    stream_close = getattr(stream, "close", None)
                    window: list[tuple[float, float]] = []  # (est, observed)
                    want_replan = False
                    try:
                        for res in stream:
                            take(res)
                            yield res
                            self.stop_reason = self._budget_hit(t_start)
                            if (self.stop_reason is None
                                    and spec.target_metric is not None
                                    and validate is not None and res.ok
                                    and score_of(res) >= spec.target_metric):
                                self.stop_reason = "target_metric"
                            if self.stop_reason:
                                break
                            if res.ok and res.task.cost and res.train_seconds > 0:
                                # observed side includes the conversion AND
                                # eval the task actually paid: a cold format
                                # whose conversion dominates, or scoring the
                                # plan was blind to, now REGISTERS as drift
                                # instead of silently vanishing
                                window.append((res.task.cost,
                                               res.train_seconds
                                               + res.convert_seconds
                                               + res.eval_seconds))
                            if (spec.replan_threshold is not None
                                    and replans_left > 0
                                    and len(window) >= _MIN_REPLAN_WINDOW
                                    and observed_drift(window) > spec.replan_threshold):
                                want_replan = True
                                break
                            if kill_fn is not None:
                                kills = set(kill_fn()) - done_ids
                                if kills:
                                    # cancel the stream; the kill takes effect
                                    # when the survivors are re-planned below
                                    killed_ids |= kills
                                    want_replan = True
                                    break
                    finally:
                        if stream_close is not None:  # plain iterators lack close
                            stream_close()  # cancels workers if we broke out early
                    if want_replan and not self.stop_reason:
                        # tasks that finished while the stream was cancelling
                        # are journalled but unseen — surface them, or their
                        # trained models would be silently lost
                        drain = getattr(backend, "drain_stragglers", None)
                        if drain is not None:
                            for res in drain():
                                take(res)
                                yield res
                    if self.stop_reason:
                        break
                    pending = [t for t in pending if t.task_id not in done_ids
                               and not self.wal.is_done(t.task_id)]
                    if killed_ids:
                        survivors = [t for t in pending
                                     if t.task_id not in killed_ids]
                        self.stats.n_rung_kills += len(pending) - len(survivors)
                        pending = survivors
                    if not want_replan or not pending:
                        break
                    # feedback: re-cost the remainder, then rebalance — never
                    # accepting a plan worse than the current residual
                    pending = self._reestimate(pending, train, cm, round_results)
                    if spec.fuse:
                        pending_units = self._pending_units(
                            assignment, pending, cm, train.n_rows)
                        pending_units = self._charge_eval(
                            pending_units, cm, eval_plan)
                        pending_units = self._charge_conversion(
                            pending_units, cm, train)
                        assignment = replan(
                            pending_units, spec.n_executors,
                            current=restrict(assignment, pending_units),
                            policy=spec.policy, splitter=split_for_balance)
                    else:
                        pending = self._charge_eval(pending, cm, eval_plan)
                        pending = self._charge_conversion(pending, cm, train)
                        assignment = replan(pending, spec.n_executors,
                                            current=restrict(assignment, pending),
                                            policy=spec.policy)
                    replans_left -= 1
                    self.stats.n_replans += 1
                if cm is not None and cm.path:
                    cm.save()          # per-round checkpoint of the model
                if self.stop_reason:
                    break
                # 4. dynamic tuners were fed per-result inside take() — by
                # here the controller has already absorbed this round
        finally:
            if cm is not None and cm.path:
                try:
                    cm.save()
                except OSError:
                    pass               # a torn-down tmpdir must not mask stats
            self.stats.total_seconds = time.perf_counter() - t_start
            self.stats.n_tasks = len(self._results)
            self.stats.n_failures = sum(1 for r in self._results if not r.ok)
            self.stats.n_retries = sum(
                max(0, getattr(r, "attempts", 1) - 1) for r in self._results)
            self.stats.n_quarantined = sum(
                1 for r in self._results if getattr(r, "quarantined", False))
            self.stats.n_timeouts = sum(
                1 for r in self._results if getattr(r, "timed_out", False))
            hits, misses = _counts(cc)     # this session's cache traffic
            self.stats.compile_cache_hits = hits - cc_hits0
            self.stats.compile_cache_misses = misses - cc_misses0
            ec_hits, ec_misses = _counts(ec)
            self.stats.predict_compile_cache_hits = ec_hits - ec_hits0
            self.stats.predict_compile_cache_misses = ec_misses - ec_misses0
            pc_hits, pc_misses = _counts(pc)
            self.stats.prepared_cache_hits = pc_hits - pc_hits0
            self.stats.prepared_cache_misses = pc_misses - pc_misses0
            # §3.9: what ONE device of a shard group is resident for across
            # the cache's ShardedPlacement entries (per-shard accounting —
            # the bytes_per_device view, not the host-side stack)
            if hasattr(pc, "sharded_resident_bytes"):
                self.stats.shard_residency_bytes = pc.sharded_resident_bytes()
            self.finished = True

    def _budget_hit(self, t_start: float) -> str | None:
        spec = self.spec
        if spec.max_tasks is not None and len(self._results) >= spec.max_tasks:
            return "max_tasks"
        if (spec.max_seconds is not None
                and time.perf_counter() - t_start >= spec.max_seconds):
            return "max_seconds"
        return None

    # ------------------------------------------------------------------
    def search(
        self,
        train: DenseMatrix,
        validate: DenseMatrix | None = None,
        *,
        on_result: Callable[[TaskResult], None] | None = None,
    ) -> MultiModel:
        """Drain :meth:`results` and return every model as a MultiModel."""
        for _ in self.results(train, validate, on_result=on_result):
            pass
        return self.multi_model()

    def multi_model(self) -> MultiModel:
        """Models produced so far (usable mid-stream and after completion)."""
        return MultiModel(list(self._results))

    # ------------------------------------------------------------------
    @classmethod
    def run(
        cls,
        spec: SearchSpec | Mapping,
        train: DenseMatrix,
        validate: DenseMatrix | None = None,
        *,
        backend: ExecutorBackend | None = None,
        on_result: Callable[[TaskResult], None] | None = None,
    ) -> MultiModel:
        """One-shot: build a Session, run it to completion, return the models."""
        return cls(spec, backend=backend).search(train, validate, on_result=on_result)

    @classmethod
    def resume(
        cls,
        wal_path: str,
        spec: SearchSpec | Mapping,
        *,
        backend: ExecutorBackend | None = None,
        keep_budgets: bool = False,
    ) -> "Session":
        """Reconstruct a killed search from its write-ahead log.

        The returned Session's WAL is pre-loaded with every completion the
        dead run journalled, so ``results()`` schedules only remaining work.
        By default the budgets that stopped the original run are cleared —
        resume means "finish the search", not "stop at the same place
        again"; pass ``keep_budgets=True`` to enforce them on the resumed
        run too (e.g. a fresh wall-clock allowance per invocation).
        """
        if isinstance(spec, Mapping):
            spec = SearchSpec.from_dict(spec)
        if not keep_budgets:
            spec = spec.replace(max_seconds=None, max_tasks=None,
                                target_metric=None)
        if backend is not None and getattr(backend.wal, "path", None) != wal_path:
            # a Session adopts its backend's WAL, so resume must point the
            # backend at the journal — otherwise completed work re-runs
            backend.wal = SearchWAL(wal_path)
        return cls(spec.replace(wal_path=wal_path), backend=backend)
