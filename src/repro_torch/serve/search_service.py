"""Multi-tenant search service (DESIGN.md §3.5).

The paper frames model search as ONE data scientist's session; everything
process-wide the previous layers built — the compile cache (§3.2), the
prepared-data plane (§3.3), the validation plane (§3.4), the persistent
CostModel (§3.1) — is exactly the machinery that generalizes to MANY
concurrent searches sharing one set of executors. :class:`SearchService` is
that generalization, four pillars:

* **Admission control** — ``submit_search(spec, train, ...)`` returns a
  :class:`SearchHandle` immediately; at most ``max_active`` sessions run
  concurrently, later submissions wait in a priority/FIFO queue, and when
  the queue is ``max_queued`` deep the submit raises
  :class:`ServiceSaturated` (backpressure, not unbounded buffering).

* **Fair-share scheduling** — every active session plans with its OWN
  Session/scheduler stack (LPT, fusion, replan — unchanged), but the
  planned units are funneled through one
  :class:`~repro_torch.core.scheduler.FairShareArbiter` feeding ``n_executors``
  shared workers. Stride arbitration interleaves tenants by weighted cost,
  so a 1000-config tenant cannot starve a 10-config one; ``stats()``
  surfaces per-tenant makespan/wait/share-drift in :class:`ServiceStats`.

* **Governed shared caches** — workers run each unit inside
  ``tenant_context(tenant)``, so the process-wide caches' per-tenant
  ledgers attribute every hit/miss/byte exactly (their budgets/LRU/pinning
  live in the cache classes themselves; the service only sets budgets).

* **Fleet-level CostModel prior** — each session's CostModel chains to one
  shared fleet model (``CostModel(prior=...)``): reads fall through to it,
  observations write through. A brand-new tenant's first plan is warm with
  what every earlier tenant learned, while per-session WAL + cost-model
  persistence stays byte-identical to the single-tenant world.

The Session is UNAWARE of all this: it drives a :class:`_TenantBackend`
that duck-types the executor-pool surface (``submit``/``wal``/
``on_result``/``prepared_cache``/``drain_stragglers``), so streaming,
budgets, WAL resume and replanning work per-tenant exactly as they do on a
private pool.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
import queue as _queue
import threading
import time
from typing import Iterator, Mapping

from repro_torch.core.cost_model import CostModel
from repro_torch.core.data_format import (
    DenseMatrix,
    PreparedDataCache,
    ShardedPlacement,
    prepared_data_cache,
)
from repro_torch.core.evaluation import EvalPlan, predict_compile_cache
# private executor helpers on purpose: the service's workers must execute
# units with EXACTLY the pools' semantics (amortized fused accounting,
# solo scoring, task-level failure isolation) — re-implementing them here
# would let the two drift apart
from repro_torch.core.executor import _run_fused_unit, _score_solo, _train_solo
from repro_torch.core.fault import (
    ExecutorFailure,
    RetryLedger,
    SearchWAL,
    WALRecord,
)
from repro_torch.core.fusion import FusedBatch, compile_cache
from repro_torch.core.interface import TaskResult
from repro_torch.core.scheduler import FairShareArbiter
from repro_torch.core.session import Session
from repro_torch.core.spec import SearchSpec
from repro_torch.core.tenancy import tenant_context

__all__ = [
    "SearchService",
    "SearchHandle",
    "ServiceStats",
    "TenantStats",
    "ServiceSaturated",
]

_DONE = object()          # stream sentinel (ticket out-queues + handle queues)


class ServiceSaturated(RuntimeError):
    """Admission backpressure: active slots full AND the wait queue is at
    ``max_queued``. Callers should retry later or shed load."""


class _Ticket:
    """One ``_TenantBackend.submit`` call: the bridge between a session's
    round of planned units and the shared workers. Counters are mutated
    under the service condition lock only."""

    __slots__ = ("ctx", "data", "validate", "out", "undispatched", "inflight",
                 "cancelled", "finished", "done")

    def __init__(self, ctx: "_SessionCtx", data, validate):
        self.ctx = ctx
        self.data = data
        self.validate = validate
        self.out: _queue.Queue = _queue.Queue()   # TaskResult | _DONE
        self.undispatched = 0
        self.inflight = 0
        self.cancelled = False
        self.finished = False
        self.done = threading.Event()


class _Unit:
    """One schedulable unit (task or fused batch) tagged with its ticket."""

    __slots__ = ("ticket", "task")

    def __init__(self, ticket: _Ticket, task):
        self.ticket = ticket
        self.task = task


class _TenantBackend:
    """Executor-backend facade one session drives; units actually run on the
    service's shared workers. Duck-types the pool surface Session touches:
    ``wal``, ``on_result``, ``prepared_cache``, ``prepare_placements``,
    ``submit(assignment, data, validate=)``, ``drain_stragglers`` — plus
    ``tenant``, which scopes the session's cache-stat deltas to this
    tenant's ledger (see ``Session.results``)."""

    def __init__(self, service: "SearchService", ctx: "_SessionCtx"):
        self._service = service
        self._ctx = ctx
        self.wal = ctx.wal
        self.tenant = ctx.tenant
        self.prepared_cache = service.prepared_cache
        self.on_result = None
        self._stragglers: list[TaskResult] = []
        #: §3.9: a sharded session's units resolve prepared data under a
        #: ShardedPlacement token (tag=None, so same-shard-count sessions
        #: SHARE the per-shard entry) while replicated sessions keep the
        #: default-device entry — the two coexist in the one governed cache,
        #: each under its own key with its own byte accounting
        self.placement = (ShardedPlacement(ctx.n_shards)
                          if ctx.n_shards > 1 else None)

    def prepare_placements(self) -> list:
        # shared workers share one placement per session: the default
        # device, or the session's sharded token (§3.9)
        return [self.placement]

    def submit(self, assignment, data, validate: EvalPlan | None = None,
               ) -> Iterator[TaskResult]:
        """Stream results of one planned round, in completion order.

        Enqueues every unit with the arbiter (longest-first, preserving the
        LPT intent inside the tenant's own queue) and yields from the
        ticket's completion queue. Closing the generator mid-stream (budget
        hit, replan) mirrors pool semantics: undispatched units are
        withdrawn, in-flight units FINISH (they are on shared workers) and
        park as stragglers for ``drain_stragglers``."""
        ticket = _Ticket(self._ctx, data, validate)
        units = sorted(assignment.all_tasks(),
                       key=lambda t: -(getattr(t, "cost", None) or 0.0))
        self._service._enqueue(ticket, [_Unit(ticket, t) for t in units])
        try:
            while True:
                res = ticket.out.get()
                if res is _DONE:
                    break
                yield res
        finally:
            self._service._cancel_ticket(ticket)
            ticket.done.wait()
            while True:    # completions the closed stream never surfaced
                try:
                    res = ticket.out.get_nowait()
                except _queue.Empty:
                    break
                if res is not _DONE:
                    self._stragglers.append(res)

    def drain_stragglers(self) -> list[TaskResult]:
        got, self._stragglers = self._stragglers, []
        return got


class _SessionCtx:
    """Service-side record of one submitted search."""

    def __init__(self, service: "SearchService", session_id: str, tenant: str,
                 weight: float, priority: int, spec: SearchSpec,
                 train: DenseMatrix, validate: DenseMatrix | None):
        self.session_id = session_id
        self.tenant = tenant
        self.weight = weight
        self.priority = priority
        self.train = train
        self.validate = validate
        self.wal = SearchWAL(spec.wal_path)
        #: per-session attempt/taint bookkeeping (§3.7) — each session's
        #: spec sets its own retry budget and poison threshold, but the
        #: deaths it survives happen on the SHARED workers
        self.retry = RetryLedger(max_task_retries=spec.max_task_retries,
                                 retry_backoff=spec.retry_backoff,
                                 poison_threshold=spec.poison_threshold,
                                 sleep=service._sleep)
        self.n_shards = spec.n_shards
        self.backend = _TenantBackend(service, self)
        self.session = Session(spec, backend=self.backend)
        self.state = "queued"          # queued -> active -> done | cancelled
        self.admit = threading.Event()
        self.cancel = threading.Event()
        self.thread: threading.Thread | None = None
        self.error: BaseException | None = None
        self.submitted_at = time.perf_counter()
        self.admitted_at: float | None = None
        self.finished_at: float | None = None
        self.first_result_at: float | None = None
        self.n_results = 0
        self.n_failures = 0
        self.n_units = 0               # units this session ran on workers
        self.executed_seconds = 0.0    # wall time of those units


class SearchHandle:
    """The caller's view of a submitted search. ``results()`` streams
    :class:`TaskResult`s exactly like ``Session.results()`` (and, like it,
    can only be consumed once); ``wait()``/``cancel()``/``stats`` manage
    the run."""

    def __init__(self, ctx: _SessionCtx, service: "SearchService"):
        self._ctx = ctx
        self._service = service
        self._q: _queue.Queue = _queue.Queue()
        self._consumed = False

    @property
    def session_id(self) -> str:
        return self._ctx.session_id

    @property
    def tenant(self) -> str:
        return self._ctx.tenant

    @property
    def state(self) -> str:
        return self._ctx.state

    @property
    def session(self) -> Session:
        return self._ctx.session

    @property
    def stats(self):
        """The underlying session's ``SearchStats`` (cache deltas scoped to
        this tenant's ledger)."""
        return self._ctx.session.stats

    @property
    def queue_wait_seconds(self) -> float | None:
        if self._ctx.admitted_at is None:
            return None
        return self._ctx.admitted_at - self._ctx.submitted_at

    @property
    def time_to_first_result(self) -> float | None:
        """Submit → first streamed result (queue wait included): the
        latency fair-share protects for small tenants."""
        if self._ctx.first_result_at is None:
            return None
        return self._ctx.first_result_at - self._ctx.submitted_at

    def results(self) -> Iterator[TaskResult]:
        """Stream TaskResults as they complete; raises the session's error
        (if any) after the stream drains."""
        if self._consumed:
            raise RuntimeError("this handle's results() was already consumed")
        self._consumed = True
        while True:
            res = self._q.get()
            if res is _DONE:
                break
            yield res
        if self._ctx.error is not None:
            raise self._ctx.error

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the search finishes; True if it did."""
        th = self._ctx.thread
        if th is not None:
            th.join(timeout)
            return not th.is_alive()
        return self._ctx.state in ("done", "cancelled")

    def cancel(self) -> None:
        """Best-effort cancel: a queued session never starts; an active one
        stops at its next streamed result (in-flight units finish — they
        are already on shared workers)."""
        self._service._cancel_session(self._ctx)

    def multi_model(self):
        return self._ctx.session.multi_model()


@dataclasses.dataclass
class TenantStats:
    """Per-tenant slice of :class:`ServiceStats`."""

    tenant: str
    weight: float
    n_sessions: int = 0
    n_active: int = 0
    n_queued: int = 0
    n_results: int = 0
    n_failures: int = 0
    n_units: int = 0
    #: wall-clock worker time this tenant's units consumed
    executed_seconds: float = 0.0
    #: estimate-cost the arbiter charged (the stride currency)
    dispatched_cost: float = 0.0
    #: total submit→admit wait over this tenant's sessions
    queue_wait_seconds: float = 0.0
    #: mean submit→first-result latency over sessions that produced one
    time_to_first_result: float | None = None
    #: max submit→finish over this tenant's finished sessions
    makespan_seconds: float = 0.0
    #: observed fraction of total executed seconds vs the weight share —
    #: |observed − entitled| is this tenant's fairness drift
    share_observed: float = 0.0
    share_entitled: float = 0.0
    prepared_hits: int = 0
    prepared_misses: int = 0
    prepared_bytes: int = 0
    compile_hits: int = 0
    compile_misses: int = 0
    predict_hits: int = 0
    predict_misses: int = 0


@dataclasses.dataclass
class ServiceStats:
    """Service-wide snapshot: admission state, fairness drift, per-tenant
    accounting (which sums exactly to the shared caches' global counters —
    the §3.5 ledger invariant)."""

    mode: str
    n_executors: int
    n_active: int = 0
    n_queued: int = 0
    n_finished: int = 0
    executed_seconds: float = 0.0
    #: max over tenants of |dispatched-cost share − weight share|
    share_drift: float = 0.0
    fleet_observations: int = 0
    per_tenant: dict[str, TenantStats] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        lines = [f"service[{self.mode}] executors={self.n_executors} "
                 f"active={self.n_active} queued={self.n_queued} "
                 f"finished={self.n_finished} drift={self.share_drift:.3f} "
                 f"fleet_obs={self.fleet_observations}"]
        for t in sorted(self.per_tenant.values(), key=lambda t: t.tenant):
            ttfr = (f"{t.time_to_first_result:.2f}s"
                    if t.time_to_first_result is not None else "-")
            lines.append(
                f"  {t.tenant}: w={t.weight:g} sessions={t.n_sessions} "
                f"results={t.n_results} fail={t.n_failures} "
                f"exec={t.executed_seconds:.2f}s "
                f"share={t.share_observed:.2f}/{t.share_entitled:.2f} "
                f"wait={t.queue_wait_seconds:.2f}s ttfr={ttfr} "
                f"makespan={t.makespan_seconds:.2f}s "
                f"prepared={t.prepared_hits}h/{t.prepared_misses}m "
                f"compile={t.compile_hits}h/{t.compile_misses}m "
                f"predict={t.predict_hits}h/{t.predict_misses}m")
        return "\n".join(lines)


class SearchService:
    """Run many concurrent model searches on one shared worker pool.

    ``n_executors`` shared worker threads execute units from every active
    session, interleaved by a :class:`FairShareArbiter` (``mode="fair_share"``
    weighted stride, or ``"fifo"`` for the head-of-line baseline). At most
    ``max_active`` sessions run at once; up to ``max_queued`` more wait
    (priority desc, then submit order); beyond that ``submit_search``
    raises :class:`ServiceSaturated`.

    ``artifact_root`` namespaces default artifacts per tenant/session —
    ``<root>/<tenant>/<session_id>.wal`` (+ ``.cost.json``) — so concurrent
    sessions can never collide on default paths, and hosts the persistent
    fleet CostModel (``<root>/fleet.cost.json``). Without it, default-path
    sessions run with in-memory WALs (explicit ``spec.wal_path`` always
    wins; duplicates among live sessions are rejected).

    ``cache_budget_bytes`` / ``compile_budget_bytes`` apply byte budgets to
    the service's prepared-data cache and to the process-wide compile +
    predict caches (None leaves them unbounded). Use as a context manager
    or call :meth:`close`.
    """

    def __init__(self, n_executors: int = 4, *,
                 max_active: int = 8,
                 max_queued: int | None = None,
                 mode: str = "fair_share",
                 artifact_root: str | None = None,
                 prepared_cache: PreparedDataCache | None = None,
                 fleet_cost_model: CostModel | None = None,
                 cache_budget_bytes: int | None = None,
                 compile_budget_bytes: int | None = None,
                 failure_hook=None,
                 sleep=time.sleep):
        if n_executors <= 0:
            raise ValueError("n_executors must be positive")
        if max_active < 1:
            raise ValueError("max_active must be >= 1")
        self.n_executors = n_executors
        self.max_active = max_active
        #: chaos seam (§3.7): called as ``failure_hook(wid, task)`` before a
        #: unit runs — an ExecutorFailure simulates the worker's executor
        #: dying with the unit claimed, any other exception is a task-level
        #: train failure. Same contract as the pools' failure_hook.
        self.failure_hook = failure_hook
        #: injectable so retry backoff costs nothing under simulated clocks
        self._sleep = sleep
        self.max_queued = max_queued
        self.artifact_root = artifact_root
        self.prepared_cache = (prepared_cache if prepared_cache is not None
                               else prepared_data_cache())
        if cache_budget_bytes is not None:
            self.prepared_cache.set_budget(cache_budget_bytes)
        if compile_budget_bytes is not None:
            compile_cache().set_budget(compile_budget_bytes)
            predict_compile_cache().set_budget(compile_budget_bytes)
        if fleet_cost_model is not None:
            self._fleet = fleet_cost_model
        else:
            fleet_path = None
            if artifact_root:
                os.makedirs(artifact_root, exist_ok=True)
                fleet_path = os.path.join(artifact_root, "fleet.cost.json")
            self._fleet = CostModel.open(fleet_path)
        self._cond = threading.Condition()
        self._arbiter = FairShareArbiter(mode=mode)
        self._sessions: list[_SessionCtx] = []
        self._admit_heap: list[tuple[int, int, _SessionCtx]] = []
        self._n_active = 0
        self._seq = itertools.count()
        self._closing = False
        self._stopping = False
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             name=f"svc-worker-{i}", daemon=True)
            for i in range(n_executors)
        ]
        for w in self._workers:
            w.start()

    # -- admission ---------------------------------------------------------
    @property
    def fleet_cost_model(self) -> CostModel:
        return self._fleet

    @property
    def mode(self) -> str:
        return self._arbiter.mode

    def _resolve_paths(self, spec: SearchSpec, tenant: str,
                       session_id: str) -> SearchSpec:
        """Namespace default artifact paths per tenant/session (satellite 1:
        two path-less concurrent sessions must never share a WAL or its
        ``<wal>.cost.json``) and reject explicit duplicates among LIVE
        sessions — a shared WAL would interleave two searches' records."""
        wal_path = spec.wal_path
        if wal_path is None and self.artifact_root:
            tenant_dir = os.path.join(self.artifact_root, tenant)
            os.makedirs(tenant_dir, exist_ok=True)
            wal_path = os.path.join(tenant_dir, f"{session_id}.wal")
        live = [c for c in self._sessions if c.state in ("queued", "active")]
        if wal_path is not None:
            for other in live:
                if other.session.spec.wal_path == wal_path:
                    raise ValueError(
                        f"WAL path collision: {wal_path!r} is already in use "
                        f"by live session {other.session_id!r}")
        cost_path = spec.cost_model_path
        if cost_path is None and wal_path is not None:
            cost_path = wal_path + ".cost.json"
        return spec.replace(wal_path=wal_path, cost_model_path=cost_path,
                            n_executors=self.n_executors)

    def _session_profiler(self, spec: SearchSpec):
        """The session's CostModel, chained to the fleet prior: warm-loads
        this spec's persisted model (if any), falls back to the spec's own
        profiler for cold families, reads through to the fleet, writes every
        observation through to it."""
        base = spec.build_profiler()
        if isinstance(base, CostModel):
            if base.prior is None:
                base.prior = self._fleet
            return base
        return CostModel.open(spec.cost_model_path, fallback=base,
                              prior=self._fleet)

    def submit_search(self, spec: SearchSpec | Mapping,
                      train: DenseMatrix,
                      validate: DenseMatrix | None = None, *,
                      tenant: str = "default",
                      weight: float = 1.0,
                      priority: int = 0) -> SearchHandle:
        """Submit one search; returns immediately with a
        :class:`SearchHandle`. ``weight`` sets the tenant's fair-share
        weight (re-registering updates it); higher ``priority`` wins
        ADMISSION ordering only (fair-share governs execution)."""
        if isinstance(spec, Mapping):
            spec = SearchSpec(**spec)
        with self._cond:
            if self._closing:
                raise RuntimeError("service is closed to new submissions")
            if self._n_active >= self.max_active and self.max_queued is not None:
                queued = sum(1 for c in self._sessions if c.state == "queued")
                if queued >= self.max_queued:
                    raise ServiceSaturated(
                        f"{self._n_active} active sessions and "
                        f"{queued}/{self.max_queued} queued")
            session_id = f"{tenant}-{next(self._seq):04d}"
            run_spec = self._resolve_paths(spec, tenant, session_id)
            run_spec = run_spec.replace(
                profiler=self._session_profiler(run_spec))
            self._arbiter.ensure_tenant(tenant, weight)
            ctx = _SessionCtx(self, session_id, tenant, weight, priority,
                              run_spec, train, validate)
            handle = SearchHandle(ctx, self)
            ctx.handle = handle
            self._sessions.append(ctx)
            ctx.thread = threading.Thread(
                target=self._drive, args=(ctx, handle),
                name=f"svc-session-{session_id}", daemon=True)
            heapq.heappush(self._admit_heap,
                           (-priority, next(self._seq), ctx))
            self._admit_locked()
            ctx.thread.start()
        return handle

    def _admit_locked(self) -> None:
        while self._n_active < self.max_active and self._admit_heap:
            _, _, ctx = heapq.heappop(self._admit_heap)
            if ctx.state != "queued":      # cancelled while waiting
                continue
            ctx.state = "active"
            ctx.admitted_at = time.perf_counter()
            self._n_active += 1
            ctx.admit.set()

    def _cancel_session(self, ctx: _SessionCtx) -> None:
        with self._cond:
            ctx.cancel.set()
            if ctx.state == "queued":
                ctx.state = "cancelled"
                ctx.admit.set()            # wake the driver; it exits at once

    def _drive(self, ctx: _SessionCtx, handle: SearchHandle) -> None:
        """Per-session driver thread: waits for admission, then runs the
        REAL ``Session.results`` loop against the tenant backend, relaying
        each result to the handle."""
        ctx.admit.wait()
        try:
            if ctx.cancel.is_set():
                return
            gen = ctx.session.results(ctx.train, ctx.validate)
            try:
                for res in gen:
                    if ctx.first_result_at is None:
                        ctx.first_result_at = time.perf_counter()
                    ctx.n_results += 1
                    if not res.ok:
                        ctx.n_failures += 1
                    handle._q.put(res)
                    if ctx.cancel.is_set():
                        break
            finally:
                gen.close()                # runs Session's finally (stats, save)
        except BaseException as e:         # surfaced via handle.results()
            ctx.error = e
        finally:
            ctx.finished_at = time.perf_counter()
            with self._cond:
                if ctx.state == "active":
                    self._n_active -= 1
                ctx.state = "cancelled" if ctx.cancel.is_set() else "done"
                self._admit_locked()
                self._cond.notify_all()
            handle._q.put(_DONE)

    # -- execution ---------------------------------------------------------
    def _enqueue(self, ticket: _Ticket, units: list[_Unit]) -> None:
        with self._cond:
            if self._stopping:
                raise RuntimeError("service workers are stopped")
            ticket.undispatched += len(units)
            for u in units:
                self._arbiter.push(ticket.ctx.tenant, u,
                                   getattr(u.task, "cost", None))
            if not units:
                self._maybe_finish_locked(ticket)
            self._cond.notify_all()

    def _cancel_ticket(self, ticket: _Ticket) -> None:
        with self._cond:
            if ticket.finished:
                return
            ticket.cancelled = True
            removed = self._arbiter.discard(
                ticket.ctx.tenant, lambda u: u.ticket is ticket)
            ticket.undispatched -= removed
            self._maybe_finish_locked(ticket)

    def _maybe_finish_locked(self, ticket: _Ticket) -> None:
        if (not ticket.finished and ticket.undispatched == 0
                and ticket.inflight == 0):
            ticket.finished = True
            ticket.out.put(_DONE)
            ticket.done.set()

    def _worker_loop(self, wid: int) -> None:
        while True:
            with self._cond:
                popped = None
                while not self._stopping:
                    popped = self._arbiter.pop()
                    if popped is not None:
                        break
                    self._cond.wait()
                if popped is None:
                    return                 # stopping, queue empty
                _tenant, unit, _cost = popped
                ticket = unit.ticket
                ticket.undispatched -= 1
                ticket.inflight += 1
            try:
                self._execute_unit(wid, unit)
            finally:
                with self._cond:
                    ticket.inflight -= 1
                    self._maybe_finish_locked(ticket)

    def _execute_unit(self, wid: int, unit: _Unit) -> None:
        """Run one unit with pool semantics — WAL-done filtering, fused
        unbatching, solo scoring, task-level failure isolation — inside the
        tenant's context so every cache touch lands on its ledger."""
        ticket = unit.ticket
        ctx = ticket.ctx
        t0 = time.perf_counter()
        try:
            with tenant_context(ctx.tenant):
                results = self._run_unit(wid, unit.task, ticket)
        except ExecutorFailure:
            # the worker's executor "died" with this unit claimed (§3.7);
            # the thread itself survives — the service's model is that a
            # replacement executor is attached instantly — but the unit is
            # tainted exactly like a pool task whose executor was lost
            with self._cond:
                ctx.n_units += 1
                ctx.executed_seconds += time.perf_counter() - t0
            self._requeue_after_death(wid, unit)
            return
        elapsed = time.perf_counter() - t0
        with self._cond:
            ctx.n_units += 1
            ctx.executed_seconds += elapsed
        for res in results:
            self._surface(ticket, res)

    def _surface(self, ticket: _Ticket, res: TaskResult) -> None:
        """Deliver one result to the session: observers first (CostModel
        feedback), then the ticket's stream."""
        if ticket.ctx.backend.on_result is not None:
            try:
                ticket.ctx.backend.on_result(res)
            except Exception:
                pass                   # observers must not kill workers
        ticket.out.put(res)

    def _repush(self, ticket: _Ticket, tasks: list) -> None:
        """Re-queue retriable tasks on the arbiter (backoff already paid);
        a cancelled or finished ticket drops them, matching _cancel_ticket's
        discard of undispatched units."""
        if not tasks:
            return
        with self._cond:
            if ticket.cancelled or ticket.finished:
                return
            ticket.undispatched += len(tasks)
            for t in tasks:
                self._arbiter.push(ticket.ctx.tenant, _Unit(ticket, t),
                                   getattr(t, "cost", None))
            self._cond.notify_all()

    def _requeue_after_death(self, wid: int, unit: _Unit) -> None:
        """Taint a unit claimed by a dead executor (§3.7): quarantine past
        the session's poison threshold, else re-queue — fused units as solo
        singletons so the poison member isolates."""
        ticket = unit.ticket
        ledger = ticket.ctx.retry
        wal = ticket.ctx.wal
        members = (unit.task.singletons()
                   if isinstance(unit.task, FusedBatch) else [unit.task])
        repush = []
        for t in members:
            if wal.is_done(t.task_id):
                continue
            n = ledger.taint(t.task_id)
            if ledger.quarantined(t.task_id):
                res = TaskResult(
                    task=t, model=None, train_seconds=0.0, executor_id=wid,
                    error=f"quarantined after {n} executor deaths while "
                          "claimed (poison task)",
                    quarantined=True)
                ledger.stamp(res)
                self._surface(ticket, res)
            else:
                repush.append(t)
        self._repush(ticket, repush)

    def _run_unit(self, wid: int, task, ticket: _Ticket) -> list[TaskResult]:
        wal = ticket.ctx.wal
        ledger = ticket.ctx.retry
        solo: dict[int, object] = {}
        if isinstance(task, FusedBatch):
            pend = {m.task_id for m in task.tasks if not wal.is_done(m.task_id)}
            if not pend:
                return []
            sub = task.restrict(pend)
            solo = {sub.tasks[i].task_id: sub.unfused_task(i)
                    for i in range(len(sub.tasks))}
            hook_err: Exception | None = None
            if self.failure_hook is not None:
                try:
                    self.failure_hook(wid, task)  # may raise ExecutorFailure
                except ExecutorFailure:
                    raise
                except Exception as e:
                    # injected batch-level failure: every pending member
                    # fails this attempt; the retry filter below re-queues
                    # them SOLO so the culprit isolates on re-run (§3.7)
                    hook_err = e
            if hook_err is not None:
                results = [TaskResult(task=m, model=None, train_seconds=0.0,
                                      executor_id=wid, error=repr(hook_err),
                                      batch_size=len(sub.tasks))
                           for m in sub.tasks]
            else:
                results = _run_fused_unit(sub, ticket.data, wid,
                                          cache=self.prepared_cache,
                                          placement=ticket.ctx.backend.placement,
                                          validate=ticket.validate)
        else:
            if wal.is_done(task.task_id):
                return []
            if ledger.quarantined(task.task_id):
                results = [TaskResult(
                    task=task, model=None, train_seconds=0.0, executor_id=wid,
                    error=f"quarantined after {ledger.taints_of(task.task_id)}"
                          " executor deaths while claimed (poison task)",
                    quarantined=True)]
                return [ledger.stamp(r) for r in results]
            try:
                if self.failure_hook is not None:
                    self.failure_hook(wid, task)  # may raise ExecutorFailure
                # _train_solo dispatches RungTasks through the resumable
                # path (§3.6), so adaptive tenants get warm rungs too
                est, model, secs, conv, rstate = _train_solo(
                    task, ticket.data, cache=self.prepared_cache,
                    placement=ticket.ctx.backend.placement)
                score, eval_s = _score_solo(est, model, ticket.validate,
                                            self.prepared_cache,
                                            placement=ticket.ctx.backend.placement)
                results = [TaskResult(task=task, model=model,
                                      train_seconds=secs, executor_id=wid,
                                      convert_seconds=conv, score=score,
                                      eval_seconds=eval_s,
                                      resume_state=rstate)]
            except ExecutorFailure:
                raise
            except Exception as e:     # task-level failure, worker survives
                results = [TaskResult(task=task, model=None, train_seconds=0.0,
                                      executor_id=wid, error=repr(e))]
        surfaced: list[TaskResult] = []
        retry: list = []
        for res in results:
            if (not res.ok and not res.quarantined
                    and ledger.should_retry(res.task.task_id)):
                # bounded retry (§3.7): backoff on this worker, then back
                # on the arbiter for any shared worker to claim
                ledger.wait(res.task.task_id)
                retry.append(solo.get(res.task.task_id, res.task))
                continue
            ledger.stamp(res)
            surfaced.append(res)
        self._repush(ticket, retry)
        for res in surfaced:
            if res.ok:                 # failures stay out: resume retries them
                wal.record(WALRecord(
                    task_id=res.task.task_id, key=res.task.key(),
                    seconds=res.train_seconds, executor_id=wid,
                    score=res.score, convert_seconds=res.convert_seconds,
                    eval_seconds=res.eval_seconds))
                if res.resume_state is not None:
                    wal.record_resume(res.task.task_id, res.resume_state)
        return surfaced

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> ServiceStats:
        prepared_t = self.prepared_cache.tenant_counters()
        compile_t = compile_cache().tenant_counters()
        predict_t = predict_compile_cache().tenant_counters()
        with self._cond:
            out = ServiceStats(mode=self._arbiter.mode,
                               n_executors=self.n_executors,
                               share_drift=self._arbiter.share_drift,
                               fleet_observations=self._fleet.n_observed)
            weights = {c.tenant: c.weight for c in self._sessions}
            wsum = sum(weights.values())
            total_exec = sum(c.executed_seconds for c in self._sessions)
            per: dict[str, TenantStats] = {}
            ttfr: dict[str, list[float]] = {}
            for c in self._sessions:
                t = per.setdefault(c.tenant, TenantStats(
                    tenant=c.tenant, weight=weights[c.tenant]))
                t.n_sessions += 1
                t.n_active += c.state == "active"
                t.n_queued += c.state == "queued"
                t.n_results += c.n_results
                t.n_failures += c.n_failures
                t.n_units += c.n_units
                t.executed_seconds += c.executed_seconds
                if c.admitted_at is not None:
                    t.queue_wait_seconds += c.admitted_at - c.submitted_at
                if c.first_result_at is not None:
                    ttfr.setdefault(c.tenant, []).append(
                        c.first_result_at - c.submitted_at)
                if c.finished_at is not None:
                    t.makespan_seconds = max(
                        t.makespan_seconds, c.finished_at - c.submitted_at)
                out.n_active += c.state == "active"
                out.n_queued += c.state == "queued"
                out.n_finished += c.state in ("done", "cancelled")
            for name, t in per.items():
                t.dispatched_cost = self._arbiter.dispatched_cost.get(name, 0.0)
                if name in ttfr:
                    t.time_to_first_result = sum(ttfr[name]) / len(ttfr[name])
                if total_exec > 0:
                    t.share_observed = t.executed_seconds / total_exec
                if wsum > 0:
                    t.share_entitled = t.weight / wsum
                pt = prepared_t.get(name, {})
                t.prepared_hits = int(pt.get("hits", 0))
                t.prepared_misses = int(pt.get("misses", 0))
                t.prepared_bytes = int(pt.get("bytes", 0))
                ct = compile_t.get(name, {})
                t.compile_hits = int(ct.get("hits", 0))
                t.compile_misses = int(ct.get("misses", 0))
                et = predict_t.get(name, {})
                t.predict_hits = int(et.get("hits", 0))
                t.predict_misses = int(et.get("misses", 0))
            out.executed_seconds = total_exec
            out.per_tenant = per
        return out

    def close(self, wait: bool = True) -> None:
        """Stop accepting work and shut the workers down. ``wait=True``
        (default) drains every submitted session first; ``wait=False``
        cancels queued sessions and stops active ones at their next result.
        Persists the fleet CostModel when it has a path."""
        with self._cond:
            self._closing = True
            sessions = list(self._sessions)
        if not wait:
            for ctx in sessions:
                self._cancel_session(ctx)
        for ctx in sessions:
            if ctx.thread is not None:
                ctx.thread.join()
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for w in self._workers:
            w.join()
        if self._fleet.path and self._fleet.n_observed:
            try:
                self._fleet.save()
            except OSError:
                pass                   # a torn-down artifact root is not fatal
