"""Executors: where training tasks actually run (paper §III-A).

Two pools implement the one :class:`repro_torch.core.backend.ExecutorBackend`
protocol — ``submit(assignment, data)`` yields ``TaskResult``s as tasks
complete:

* :class:`LocalExecutorPool` — N worker threads, each the analogue of one
  Spark executor in the paper, all launching on the process's device.
  Supports static plans (LPT/random/round-robin) and dynamic pull-queues,
  executor-failure recovery, and straggler speculation.

* :class:`MeshSliceExecutorPool` — a device mesh
  (:mod:`repro_torch.launch.mesh`) partitioned into slices, each slice one
  executor. It shares the thread pool's scheduling semantics: WAL
  de-dup/resume, per-task error capture, load-balanced queues, and
  ExecutorFailure re-queue onto surviving slices; with ``n_shards > 1`` it
  schedules on shard groups of slices (DESIGN.md §3.9). Given a
  ``torch.distributed`` process mesh, each rank runs its own slice's
  queue and every rank receives every slice's results.

The uniform→native data-format conversion happens HERE (executor-side) —
never in the Driver (paper §III-B) — and is resolved through the process-wide
:class:`~repro_torch.core.data_format.PreparedDataCache` (DESIGN.md §3.3): each
(dataset fingerprint, format, converter params, placement) converts once per
process; every result reports the conversion seconds it actually paid as
``TaskResult.convert_seconds`` (0.0 on a cache hit).

Validation happens here too (DESIGN.md §3.4): ``submit(assignment, data,
validate=EvalPlan(...))`` makes each executor score the models it trained —
batched device inference against eval data resolved through the same
prepared-data cache — so results stream back already ranked-able
(``TaskResult.score``/``eval_seconds``) and the driver never re-predicts.
"""
from __future__ import annotations

import contextlib
import itertools
import queue as _queue
import threading
import time
from typing import Callable, Iterator, Sequence

import torch

from repro_torch import tracing
from repro_torch.core.data_format import (
    DenseMatrix,
    PreparedDataCache,
    ShardedPlacement,
    prepared_data_cache,
)
from repro_torch.core.evaluation import EvalPlan, evaluate_models
from repro_torch.core.fault import (
    AllExecutorsLost,
    ExecutorFailure,
    RetryLedger,
    SearchWAL,
    WALRecord,
)
from repro_torch.core.fusion import FusedBatch, charge_carrier
from repro_torch.core.interface import (
    RungTask,
    TaskResult,
    TrainTask,
    get_estimator,
    run_prepared,
    run_prepared_batched,
    run_prepared_resumable,
)
from repro_torch.core.scheduler import Assignment

__all__ = ["LocalExecutorPool", "MeshSliceExecutorPool", "ShardGroup",
           "make_slices"]

_DYNAMIC_POLICIES = ("dynamic", "lpt_dynamic")


def _run_fused_unit(unit: FusedBatch, data, eid: int,
                    cache: PreparedDataCache | None = None,
                    placement=None,
                    validate: EvalPlan | None = None) -> list[TaskResult]:
    """Train a fused batch as ONE device program and unbatch into per-member
    results. Amortized accounting: each member's ``train_seconds`` is the
    batch total divided by the members actually run, and ``batch_size``
    marks the result as fused for the CostModel's batched law. When the
    batch BUILT the prepared-data entry, the full ``convert_seconds`` goes
    to the charge-carrier member (fusion.charge_carrier: max cost, lowest
    id) — one build, one observation, on the member the planner charged.
    With ``validate`` set, the whole model stack is scored HERE (§3.4) as
    one batched predict call — members stream back with ``score`` and
    the amortized ``eval_seconds`` attached. A whole-batch exception is
    BISECTED (§3.7): the batch splits at its structural bucket boundaries
    (``split_at_buckets``) and each piece re-runs; an unsplittable piece
    degrades to solo member runs — so one poison config costs only its own
    result and every good member is salvaged. Task-level failure semantics
    throughout: the executor survives."""
    members = list(unit.tasks)
    est = get_estimator(unit.estimator)
    try:
        with tracing.span("fit.train", task=unit.task_id):
            models, total, conv = run_prepared_batched(
                est, data, [m.params for m in members],
                cache=cache, placement=placement)
        per = total / len(members)
        carrier = charge_carrier(members) if conv > 0 else -1
        scores: list = [None] * len(members)
        eval_per = 0.0
        if validate is not None:
            scores, eval_per = evaluate_models(
                est, models, validate, prepared_cache=cache,
                placement=placement)
        return [
            TaskResult(task=m, model=mod, train_seconds=per, executor_id=eid,
                       batch_size=len(members),
                       convert_seconds=conv if j == carrier else 0.0,
                       score=scores[j], eval_seconds=eval_per)
            for j, (m, mod) in enumerate(zip(members, models))
        ]
    except ExecutorFailure:
        raise
    except Exception as e:
        if len(members) == 1:
            return [TaskResult(task=members[0], model=None, train_seconds=0.0,
                               executor_id=eid, error=repr(e))]
        pieces = unit.split_at_buckets()
        if len(pieces) > 1:
            out: list[TaskResult] = []
            for piece in pieces:
                out.extend(_run_fused_unit(piece, data, eid, cache=cache,
                                           placement=placement,
                                           validate=validate))
            return out
        # single structural bucket: fall back to the singleton machinery —
        # run each member solo so only the culprit carries the error
        out = []
        for m in members:
            try:
                s_est, model, secs, conv, rstate = _train_solo(
                    m, data, cache=cache, placement=placement)
                score, eval_s = _score_solo(s_est, model, validate, cache,
                                            placement=placement)
                out.append(TaskResult(task=m, model=model, train_seconds=secs,
                                      executor_id=eid, convert_seconds=conv,
                                      score=score, eval_seconds=eval_s,
                                      resume_state=rstate))
            except ExecutorFailure:
                raise
            except Exception as e2:
                out.append(TaskResult(task=m, model=None, train_seconds=0.0,
                                      executor_id=eid, error=repr(e2)))
        return out


def _train_solo(task, data, cache: PreparedDataCache | None = None,
                placement=None):
    """Train one solo task, dispatching :class:`RungTask`s through the
    resumable path (DESIGN.md §3.6) so a promoted rung continues from its
    carried state instead of retraining from scratch; plain tasks keep the
    ``run_prepared`` path unchanged. Every solo call site (workers,
    driver-inline leftovers, mesh slices, the multi-tenant service) goes
    through here so rung semantics cannot diverge. Returns
    ``(estimator, model, train_seconds, convert_seconds, resume_state)``."""
    est = get_estimator(task.estimator)
    with tracing.span("fit.train", task=task.task_id):
        if isinstance(task, RungTask):
            model, secs, conv, rstate = run_prepared_resumable(
                est, data, task.params, budget=task.budget, state=task.state,
                cache=cache, placement=placement)
            return est, model, secs, conv, rstate
        model, secs, conv = run_prepared(est, data, task.params,
                                         cache=cache, placement=placement)
    return est, model, secs, conv, None


def _score_solo(est, model, validate: EvalPlan | None,
                cache: PreparedDataCache | None,
                placement=None) -> tuple[float | None, float]:
    """Executor-side scoring of one task's model (§3.4); returns
    ``(score, eval_seconds)`` — ``(None, 0.0)`` when scoring is off. The
    shared solo half of what ``_run_fused_unit`` does for a whole batch;
    every solo path (workers, driver-inline leftovers, mesh slices) goes
    through here so the semantics cannot diverge."""
    if validate is None:
        return None, 0.0
    scores, eval_s = evaluate_models(est, [model], validate,
                                     prepared_cache=cache,
                                     placement=placement)
    return scores[0], eval_s


class LocalExecutorPool:
    """Thread-per-executor pool with fault recovery + straggler speculation."""

    def __init__(
        self,
        n_executors: int,
        wal: SearchWAL | None = None,
        failure_hook: Callable[[int, TrainTask], None] | None = None,
        speculation_factor: float | None = None,
        on_result: Callable[[TaskResult], None] | None = None,
        prepared_cache: PreparedDataCache | None = None,
        max_task_retries: int = 0,
        retry_backoff: float = 0.05,
        poison_threshold: int | None = 3,
        deadline_factor: float | None = None,
        task_timeout_seconds: float | None = None,
        sleep: Callable[[float], None] = time.sleep,
        n_shards: int = 1,
    ):
        self._n_executors = n_executors
        #: sharded data plane (DESIGN.md §3.9): with ``n_shards > 1`` every
        #: conversion resolves under ONE ShardedPlacement token — workers
        #: train on row-sharded prepared entries (per-shard residency in
        #: the cache accounting) and the eval plane reduces shard partials.
        #: On the process's one device the shards are stacked
        #: (``compat.sharded_call``)
        self._placement_token = (
            ShardedPlacement(int(n_shards)) if int(n_shards) > 1 else None)
        self.wal = wal or SearchWAL(None)
        self.failure_hook = failure_hook  # tests inject ExecutorFailure here
        self.speculation_factor = speculation_factor
        #: soft deadline (§3.7): ``deadline_factor`` × predicted cost rides
        #: the speculation path — an overdue unit is duplicated on an idle
        #: executor, first completion wins. ``speculation_factor`` (the
        #: historical knob) takes precedence when both are set.
        self.deadline_factor = deadline_factor
        #: hard deadline (§3.7): a unit in flight longer than this many
        #: wall-clock seconds is abandoned-and-requeued (one retry attempt
        #: burned); out of attempts it surfaces as a terminal ``timed_out``
        #: error result, and the submit loop stops waiting on the hung
        #: worker (the daemon thread is left behind).
        self.task_timeout_seconds = task_timeout_seconds
        #: per-task attempt/taint bookkeeping, POOL-lifetime so a poison
        #: task re-queued across rounds keeps its history (§3.7)
        self._retry = RetryLedger(max_task_retries=max_task_retries,
                                  retry_backoff=retry_backoff,
                                  poison_threshold=poison_threshold,
                                  sleep=sleep)
        #: prepared-data cache the workers resolve conversion through; worker
        #: threads share one device, so placement is the process default
        #: (None) and the default cache is the process-wide one
        self.prepared_cache = (prepared_cache if prepared_cache is not None
                               else prepared_data_cache())
        #: called with every accepted TaskResult the moment it lands, on the
        #: worker thread — this is how the feedback CostModel observes
        #: runtimes (session.py chains onto it). Exceptions are swallowed:
        #: a broken observer must not take an executor down with it.
        self.on_result = on_result
        self._stragglers: list[TaskResult] = []
        self._dead: set[int] = set()

    def _emit(self, res: TaskResult) -> None:
        if self.on_result is not None:
            try:
                self.on_result(res)
            except Exception:
                pass

    @property
    def n_executors(self) -> int:
        return self._n_executors

    def prepare_placements(self) -> list:
        """Placement tokens this pool converts under (conversion-aware
        costing probes these to tell cold formats from resident ones):
        worker threads share the process default device — ONE token, the
        sharded one when the pool runs the sharded data plane (§3.9)."""
        return [self._placement_token]

    # ------------------------------------------------------------------
    def submit(self, assignment: Assignment, data: DenseMatrix,
               validate: EvalPlan | None = None) -> Iterator[TaskResult]:
        """Execute a static or dynamic plan, yielding results as they land.

        ``validate`` (an :class:`~repro_torch.core.evaluation.EvalPlan`) turns on
        executor-side scoring (§3.4): each model is evaluated by the worker
        that trained it — eval data resolved once through the prepared-data
        cache — and results carry ``score``/``eval_seconds``.

        Closing the iterator early cancels cleanly: workers stop pulling new
        tasks after their current one and the pool joins them.
        """
        self._stragglers = []  # per-submit buffer (see drain_stragglers)
        shared: _queue.Queue[TrainTask] = _queue.Queue()
        dynamic = assignment.policy in _DYNAMIC_POLICIES
        if dynamic:
            for t in assignment.all_tasks():
                if not self.wal.is_done(t.task_id):
                    shared.put(t)
        results: dict[int, TaskResult] = {}
        results_lock = threading.Lock()
        requeue: _queue.Queue[TrainTask] = _queue.Queue()
        out: _queue.Queue[TaskResult] = _queue.Queue()  # completion stream
        stop = threading.Event()
        in_flight: dict[int, tuple[int, float]] = {}  # task_id -> (executor, t0)
        speculated: set[int] = set()

        def accept(res: TaskResult, eid: int) -> bool:
            """First-completion-wins bookkeeping shared by all paths; the WAL
            is written (successes only) before the result is surfaced."""
            with results_lock:
                if res.task.task_id in results:
                    return False
                self._retry.stamp(res)
                results[res.task.task_id] = res
                if res.ok:
                    self.wal.record(
                        WALRecord(task_id=res.task.task_id, key=res.task.key(),
                                  seconds=res.train_seconds, executor_id=eid,
                                  score=res.score,
                                  convert_seconds=res.convert_seconds,
                                  eval_seconds=res.eval_seconds))
                    if res.resume_state is not None:
                        self.wal.record_resume(res.task.task_id,
                                               res.resume_state)
            return True

        def execute_fused(eid: int, unit: FusedBatch) -> None:
            """One fused unit: train pending members as one program, unbatch
            into per-member results that flow through the normal stream."""
            with results_lock:
                pend = {m.task_id for m in unit.tasks
                        if not self.wal.is_done(m.task_id)
                        and m.task_id not in results}
                if not pend:
                    return
                in_flight[unit.task_id] = (eid, time.perf_counter())
            with tracing.span("fit", task=unit.task_id, executor=eid):
                sub = unit.restrict(pend)
                try:
                    hook_err: Exception | None = None
                    if self.failure_hook is not None:
                        try:
                            self.failure_hook(eid, unit)  # may raise ExecutorFailure
                        except ExecutorFailure:
                            raise
                        except Exception as e:
                            # injected batch-level failure: every pending member
                            # fails this attempt; the retry filter below re-queues
                            # them SOLO, so the culprit isolates on re-run (§3.7)
                            hook_err = e
                    if hook_err is not None:
                        batch_results = [
                            TaskResult(task=m, model=None, train_seconds=0.0,
                                       executor_id=eid, error=repr(hook_err),
                                       batch_size=len(sub.tasks))
                            for m in sub.tasks]
                    else:
                        batch_results = _run_fused_unit(sub, data, eid,
                                                        cache=self.prepared_cache,
                                                        placement=self._placement_token,
                                                        validate=validate)
                except ExecutorFailure:
                    with results_lock:
                        in_flight.pop(unit.task_id, None)
                    raise
                with results_lock:
                    in_flight.pop(unit.task_id, None)
                # solo-shaped members (pre-amortization cost restored) for
                # retries: a failed member re-queues ALONE so its next attempt
                # cannot take good batch-mates down with it (§3.7)
                solo = {sub.tasks[i].task_id: sub.unfused_task(i)
                        for i in range(len(sub.tasks))}
                for res in batch_results:
                    if not res.ok and self._retry.should_retry(res.task.task_id):
                        self._retry.wait(res.task.task_id)
                        requeue.put(solo.get(res.task.task_id, res.task))
                        continue
                    if accept(res, eid):
                        self._emit(res)
                        out.put(res)

        def quarantine(eid: int, task: TrainTask, n: int | None = None) -> None:
            """Surface a poison task as a terminal quarantine error (§3.7)."""
            n = n if n is not None else self._retry.taints_of(task.task_id)
            res = TaskResult(task=task, model=None, train_seconds=0.0,
                             executor_id=eid,
                             error=f"quarantined after {n} executor deaths "
                                   "while claimed (poison task)",
                             quarantined=True)
            if accept(res, eid):
                self._emit(res)
                out.put(res)

        def execute(eid: int, task) -> None:
            if isinstance(task, FusedBatch):
                execute_fused(eid, task)
                return
            if self.wal.is_done(task.task_id):
                return
            if self._retry.quarantined(task.task_id):
                quarantine(eid, task)
                return
            with results_lock:
                if task.task_id in results:
                    return
                in_flight[task.task_id] = (eid, time.perf_counter())
            with tracing.span("fit", task=task.task_id, executor=eid):
                try:
                    if self.failure_hook is not None:
                        self.failure_hook(eid, task)  # may raise ExecutorFailure
                    est, model, secs, conv, rstate = _train_solo(
                        task, data, cache=self.prepared_cache,
                        placement=self._placement_token)
                    score, eval_s = _score_solo(est, model, validate,
                                                self.prepared_cache,
                                                placement=self._placement_token)
                    res = TaskResult(task=task, model=model, train_seconds=secs,
                                     executor_id=eid, convert_seconds=conv,
                                     score=score, eval_seconds=eval_s,
                                     resume_state=rstate)
                except ExecutorFailure:
                    with results_lock:
                        in_flight.pop(task.task_id, None)
                    raise
                except Exception as e:  # task-level failure: record, don't kill pool
                    with results_lock:
                        in_flight.pop(task.task_id, None)
                    if self._retry.should_retry(task.task_id):
                        # bounded retry (§3.7): capped exponential backoff, then
                        # back on the re-queue for any live worker to claim
                        self._retry.wait(task.task_id)
                        requeue.put(task)
                        return
                    res = TaskResult(task=task, model=None, train_seconds=0.0,
                                     executor_id=eid, error=repr(e))
                with results_lock:
                    in_flight.pop(task.task_id, None)
                # failures stay out of the WAL (accept) so resume retries them
                if accept(res, eid):
                    self._emit(res)
                    out.put(res)

        def maybe_speculate(eid: int) -> TrainTask | None:
            """Idle executor: duplicate the longest-overdue in-flight task.

            The soft deadline (§3.7) rides this same path: ``deadline_factor``
            is the unit's CostModel-predicted cost multiplier past which it
            counts as overdue. ``speculation_factor`` (the historical knob)
            takes precedence when both are set.
            """
            factor = (self.speculation_factor
                      if self.speculation_factor is not None
                      else self.deadline_factor)
            if factor is None:
                return None
            now = time.perf_counter()
            with results_lock:
                best, overdue = None, 0.0
                for tid, (owner, t0) in in_flight.items():
                    if owner == eid or tid in speculated:
                        continue
                    task = task_by_id.get(tid)
                    est_cost = task.cost if task and task.cost else None
                    if est_cost is None:
                        continue
                    over = (now - t0) / est_cost
                    if over > factor and over > overdue:
                        best, overdue = task, over
                if best is not None:
                    speculated.add(best.task_id)
                return best

        task_by_id = {t.task_id: t for t in assignment.all_tasks()}

        def requeue_after_death(eid: int, unit) -> None:
            """An executor died while running ``unit``: taint it (§3.7).

            A tainted FusedBatch re-queues as solo singletons so the poison
            member isolates instead of re-killing whole batches; a task past
            ``poison_threshold`` deaths is quarantined (terminal error
            result) instead of being handed to the next victim.
            """
            if isinstance(unit, FusedBatch):
                for m in unit.singletons():
                    if self.wal.is_done(m.task_id):
                        continue
                    requeue_after_death(eid, m)
                return
            n = self._retry.taint(unit.task_id)
            if self._retry.quarantined(unit.task_id):
                quarantine(eid, unit, n)
            else:
                requeue.put(unit)

        hard = self.task_timeout_seconds
        hung: set[int] = set()  # executors abandoned past the hard deadline
        overdue_ids: set[int] = set()  # unit ids ever abandoned as overdue
        expected: set[int] = set()
        if hard is not None:
            for u in assignment.all_tasks():
                members = u.tasks if isinstance(u, FusedBatch) else (u,)
                expected.update(m.task_id for m in members
                                if not self.wal.is_done(m.task_id))

        def check_timeouts() -> None:
            """Hard deadline (§3.7): abandon-and-requeue overdue units.

            The abandoned copy keeps running on its (hung) worker — first
            completion wins, ``accept`` dedups — but the submit loop stops
            waiting on that worker. The overrun is fed to the cost-model
            observer as a censored ``timed_out`` observation so the estimate
            that missed stops being trusted.
            """
            now = time.perf_counter()
            overdue: list[tuple[int, int, float, bool]] = []
            with results_lock:
                for tid, (owner, t0) in list(in_flight.items()):
                    if now - t0 > hard:
                        in_flight.pop(tid, None)
                        hung.add(owner)
                        overdue_ids.add(tid)
                        unit = task_by_id.get(tid)
                        retriable = (unit is not None
                                     and self._retry.should_retry(tid))
                        if retriable:
                            # re-queue INSIDE the lock: an idle worker's
                            # exit check reads in_flight under this lock,
                            # so it cannot miss the retry in between
                            requeue.put(unit)
                        overdue.append((tid, owner, now - t0, retriable))
            for tid, owner, elapsed, retriable in overdue:
                unit = task_by_id.get(tid)
                if unit is None:
                    continue
                if retriable:
                    if not isinstance(unit, FusedBatch):
                        # censored observation: surfaced to the observer
                        # only, never to the result stream
                        self._emit(TaskResult(
                            task=unit, model=None, train_seconds=elapsed,
                            executor_id=owner,
                            error=(f"deadline exceeded after {elapsed:.3f}s "
                                   "(abandoned, re-queued)"),
                            timed_out=True))
                    continue
                members = (unit.tasks if isinstance(unit, FusedBatch)
                           else (unit,))
                for m in members:
                    if self.wal.is_done(m.task_id):
                        continue
                    res = TaskResult(
                        task=m, model=None, train_seconds=elapsed,
                        executor_id=owner,
                        error=(f"hard deadline: abandoned after "
                               f"{elapsed:.3f}s on executor {owner}"),
                        timed_out=True,
                        attempts=self._retry.failures_of(tid))
                    if accept(res, owner):
                        self._emit(res)
                        out.put(res)

        def wait_for_requeue(idle: list) -> bool:
            """Idle-worker exit gate under hard deadlines (§3.7): while any
            peer still holds a unit in flight, a timeout may re-queue it —
            so stay alive to claim the retry (otherwise it would fall to
            the driver, which refuses suspect-hung work). After in_flight
            drains, loop ONE more time so a retry queued in the same
            locked section as the drain is never missed. Returns True to
            keep looping, False to exit."""
            if hard is None:
                return False
            with results_lock:
                busy = bool(in_flight)
            if busy:
                idle[0] = False
                stop.wait(0.01)
                return True
            if not idle[0]:
                idle[0] = True
                return True
            return False

        def claim(eid: int, idle: list) -> TrainTask | None:
            """The next unit for ``eid`` once its static queue is done: from
            the re-queue and, on a dynamic plan, the shared queue or a
            speculative copy. None when the worker should stop."""
            while not stop.is_set():
                try:
                    return requeue.get_nowait()
                except _queue.Empty:
                    pass
                if dynamic:
                    try:
                        return shared.get_nowait()
                    except _queue.Empty:
                        pass
                    task = maybe_speculate(eid)
                    if task is not None:
                        return task
                if not wait_for_requeue(idle):
                    return None
            return None

        def worker(eid: int, static_queue: list[TrainTask]) -> None:
            idle = [False]
            try:
                # a static plan's own queue first (a dynamic plan has none)
                for i, task in enumerate(static_queue):
                    if stop.is_set():
                        return
                    try:
                        execute(eid, task)
                    except ExecutorFailure:
                        # the claimed task is tainted; the rest of my
                        # queue was never claimed, push it plain
                        requeue_after_death(eid, task)
                        for rest in static_queue[i + 1:]:
                            if not self.wal.is_done(rest.task_id):
                                requeue.put(rest)
                        raise
                # then the shared work: a dynamic plan's queue, and what
                # dead peers re-queued
                while (task := claim(eid, idle)) is not None:
                    idle[0] = False
                    try:
                        execute(eid, task)
                    except ExecutorFailure:
                        # dying with a claimed task: taint it, hand it to
                        # survivors (or quarantine past the threshold)
                        requeue_after_death(eid, task)
                        raise
            except ExecutorFailure:
                self._dead.add(eid)

        threads = []
        static_plans: list[list] = []
        for eid in range(self._n_executors):
            q = assignment.plan[eid] if eid < len(assignment.plan) and not dynamic else []
            static_plans.append(q)
            th = threading.Thread(target=worker, args=(eid, q), daemon=True)
            threads.append(th)
            th.start()
        def join_all() -> None:
            """Join workers; never wait forever on one abandoned past the
            hard deadline (its daemon thread is left behind)."""
            for eid2, th in enumerate(threads):
                if hard is None:
                    th.join()
                else:
                    th.join(0.1 if eid2 in hung else hard + 0.5)

        try:
            while any(th.is_alive() for th in threads):
                try:
                    res = out.get(timeout=0.05)
                except _queue.Empty:
                    if hard is not None:
                        check_timeouts()
                        with results_lock:
                            covered = all(
                                tid in results or self.wal.is_done(tid)
                                for tid in expected)
                        if covered:
                            break  # every task terminal; stop waiting on hung workers
                        if not any(th.is_alive()
                                   for i, th in enumerate(threads)
                                   if i not in hung):
                            # only hung workers remain: salvage their
                            # unclaimed static work and let the driver-
                            # inline leftovers path finish the plan
                            # (duplicates dedup against ``results`` there)
                            for eid2 in hung:
                                for t in static_plans[eid2]:
                                    if not self.wal.is_done(t.task_id):
                                        requeue.put(t)
                            break
                    continue
                yield res
            join_all()
            while True:  # drain completions raced in while the last thread exited
                try:
                    res = out.get_nowait()
                except _queue.Empty:
                    break
                yield res
            # If every executor died mid-plan, some tasks may remain: run them
            # inline (the "driver as executor of last resort" recovery path).
            leftovers = []
            while True:
                try:
                    leftovers.append(requeue.get_nowait())
                except _queue.Empty:
                    break
            if dynamic:
                while True:
                    try:
                        leftovers.append(shared.get_nowait())
                    except _queue.Empty:
                        break
            while leftovers:
                task = leftovers.pop(0)
                if task.task_id in overdue_ids:
                    # A unit once abandoned past the hard deadline is suspect
                    # hung — the driver must NEVER run it inline (a genuine
                    # hang would block the whole submit with no preemption).
                    # Terminal timed_out, even with retry budget left.
                    members = (task.tasks if isinstance(task, FusedBatch)
                               else (task,))
                    for m in members:
                        if self.wal.is_done(m.task_id) or m.task_id in results:
                            continue
                        res = TaskResult(
                            task=m, model=None, train_seconds=0.0,
                            executor_id=-1,
                            error=("hard deadline: abandoned as overdue; "
                                   "not retried on the driver"),
                            timed_out=True,
                            attempts=self._retry.failures_of(task.task_id))
                        if accept(res, -1):
                            self._emit(res)
                            yield res
                    continue
                if isinstance(task, FusedBatch):
                    pend = {m.task_id for m in task.tasks
                            if not self.wal.is_done(m.task_id)
                            and m.task_id not in results}
                    if not pend:
                        continue
                    sub = task.restrict(pend)
                    solo = {sub.tasks[i].task_id: sub.unfused_task(i)
                            for i in range(len(sub.tasks))}
                    for res in _run_fused_unit(sub, data, -1,
                                               cache=self.prepared_cache,
                                               placement=self._placement_token,
                                               validate=validate):
                        if (not res.ok
                                and self._retry.should_retry(res.task.task_id)):
                            self._retry.wait(res.task.task_id)
                            leftovers.append(
                                solo.get(res.task.task_id, res.task))
                            continue
                        if accept(res, -1):
                            self._emit(res)
                            yield res
                    continue
                if not self.wal.is_done(task.task_id) and task.task_id not in results:
                    if self._retry.quarantined(task.task_id):
                        quarantine(-1, task)
                        while True:  # quarantine() parks on out; surface it
                            try:
                                yield out.get_nowait()
                            except _queue.Empty:
                                break
                        continue
                    try:
                        est, model, secs, conv, rstate = _train_solo(
                            task, data, cache=self.prepared_cache,
                            placement=self._placement_token)
                        score, eval_s = _score_solo(est, model, validate,
                                                    self.prepared_cache,
                                                    placement=self._placement_token)
                        res = TaskResult(task=task, model=model, train_seconds=secs,
                                         executor_id=-1, convert_seconds=conv,
                                         score=score, eval_seconds=eval_s,
                                         resume_state=rstate)
                        self.wal.record(WALRecord(task_id=task.task_id, key=task.key(),
                                                  seconds=secs, executor_id=-1,
                                                  score=score, convert_seconds=conv,
                                                  eval_seconds=eval_s))
                        if rstate is not None:
                            self.wal.record_resume(task.task_id, rstate)
                    except Exception as e:
                        if self._retry.should_retry(task.task_id):
                            self._retry.wait(task.task_id)
                            leftovers.append(task)
                            continue
                        res = TaskResult(task=task, model=None, train_seconds=0.0, executor_id=-1, error=repr(e))
                    self._retry.stamp(res)
                    results[task.task_id] = res
                    self._emit(res)
                    yield res
        finally:
            stop.set()
            join_all()
            # tasks that finished while the stream was being cancelled: the
            # WAL has them but the consumer never saw them. Park them for
            # drain_stragglers() so a replanning driver can re-surface them.
            while True:
                try:
                    self._stragglers.append(out.get_nowait())
                except _queue.Empty:
                    break

    def drain_stragglers(self) -> list[TaskResult]:
        """Results completed during an early ``submit`` cancellation (close /
        break-out). The Session replan loop collects these so no trained
        model is silently dropped; the buffer is cleared on read."""
        got, self._stragglers = self._stragglers, []
        return got

    def run(self, assignment: Assignment, data: DenseMatrix,
            validate: EvalPlan | None = None) -> list[TaskResult]:
        """Blocking convenience: drain :meth:`submit` into a list."""
        return list(self.submit(assignment, data, validate))

    @property
    def dead_executors(self) -> set[int]:
        return set(self._dead)


# --------------------------------------------------------------------------
# Mesh-slice executors (DESIGN.md §3.1's mesh half).
# --------------------------------------------------------------------------

#: process-unique pool ids for prepared-data placement tokens — id(slice)
#: would be recyclable after a pool is garbage-collected while its entries
#: outlive it in the process-wide cache, producing false residency hits
_POOL_IDS = itertools.count()

def is_process_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``torch.distributed`` device mesh (one rank
    per entry) rather than a :class:`repro_torch.launch.mesh.DeviceMesh`
    of devices in this process."""
    return mesh is not None and hasattr(mesh, "get_group")


def make_slices(mesh, n_slices: int, axis: str = "data"):
    """Partition ``mesh`` into ``n_slices`` submeshes along ``axis``.

    Each slice keeps every other axis intact, so a task placed on a slice
    can spread over its devices. For a
    :class:`repro_torch.launch.mesh.DeviceMesh` returns a list of
    DeviceMesh; on one card every device of every slice is the same
    ``cuda:0``: the slices are logical executors sharing it. For a
    ``torch.distributed`` device mesh returns one such mesh a slice, with
    the same axis names, each with its own process groups: every rank of
    ``mesh`` must call this, and makes every slice in the same order.
    """
    names = tuple(mesh.mesh_dim_names if is_process_mesh(mesh) else mesh.axis_names)
    grid = mesh.mesh if is_process_mesh(mesh) else mesh.devices
    axis_idx = names.index(axis)
    size = grid.shape[axis_idx]
    if size % n_slices != 0:
        raise ValueError(f"axis {axis!r} of size {size} not divisible into {n_slices} slices")
    per = size // n_slices
    slices = []
    for s in range(n_slices):
        sl = [slice(None)] * grid.ndim
        sl[axis_idx] = slice(s * per, (s + 1) * per)
        if is_process_mesh(mesh):
            from torch.distributed.device_mesh import DeviceMesh as ProcessMesh

            slices.append(ProcessMesh(mesh.device_type, grid[tuple(sl)], mesh_dim_names=names))
        else:
            from repro_torch.launch.mesh import DeviceMesh

            slices.append(DeviceMesh(grid[tuple(sl)], names))
    return slices


class ShardGroup:
    """One §3.9 scheduling unit spanning ``n_shards`` mesh slices.

    When a :class:`MeshSliceExecutorPool` runs with ``n_shards > 1`` its
    slices are bundled into consecutive groups and the GROUP — not the
    slice — is what the scheduler places tasks on: one queue, one executor
    id, one failure domain, one :class:`ShardedPlacement` cache token per
    group. ``slices`` holds the member slice handles (the submeshes whose
    devices hold the group's row blocks); ``index`` is the group's position
    in the pool, which keys its placement tag. With one device the shards
    of a group are stacked on it (``compat.sharded_call``).
    """

    __slots__ = ("slices", "index")

    def __init__(self, slices, index: int):
        self.slices = tuple(slices)
        self.index = int(index)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ShardGroup(index={self.index}, n_slices={len(self.slices)})"


def _on_slice(sl):
    """A context that makes the slice's first device the current CUDA device
    while a task runs on it; a stand-in handle or a CPU mesh changes nothing."""
    if isinstance(sl, ShardGroup):
        sl = sl.slices[0]
    dev = getattr(sl, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class MeshSliceExecutorPool:
    """Executors = submesh slices of one device mesh
    (:class:`repro_torch.launch.mesh.DeviceMesh`).

    ``task_runner(task, slice_mesh, data) -> (model-payload, seconds)`` is
    supplied by a custom substrate (the JAX package's LM search); this
    pool owns only
    placement, ordering, failure re-queue and WAL bookkeeping — the same
    scheduling semantics as LocalExecutorPool, with slices instead of threads.

    With ``task_runner=None`` the pool runs ESTIMATOR-backed tasks itself
    (the tabular workload on mesh slices): conversion resolves through the
    prepared-data cache with a PER-SLICE placement token, so each slice
    prepares a (dataset, format, params) variant once and every later task
    placed on that slice reuses the slice-resident copy — the §3.3 plane's
    mesh half. A slice that is a DeviceMesh runs its tasks with its first
    device as the current CUDA device; on one card every slice is
    ``cuda:0``, and the slices are logical executors that share it, one
    task at a time (the pool is a serial generator).

    Fused units (:class:`repro_torch.core.fusion.FusedBatch`) are run as one
    program on their slice: a custom runner is called with the BATCH and must
    return ``(payload_per_member, total_seconds)``; the pool unbatches into
    per-member results with amortized seconds. The estimator-backed default
    handles batches via ``Estimator.train_batched`` directly.

    Pass ``slices=[...]`` to supply pre-built (or stand-in) slice handles
    directly instead of partitioning a mesh — tests and custom partitioners
    use this to exercise the pool without real multi-device state.

    Given a ``torch.distributed`` device ``mesh`` (``launch.mesh.
    compat_make_mesh``; every rank builds the pool, the same tasks and the
    same static assignment), each slice is a process mesh of its own ranks
    and each rank runs only its own slice's queue: a ``task_runner`` gets
    the slice's mesh and spreads a task over its ranks (tensor parallelism
    inside the slice). ``submit`` then gathers every slice's results (from
    each slice's first rank, ``all_gather_object``) and yields them on every
    rank, slice by slice, once every queue has run. Ranks cannot pull from
    one shared queue, so the dynamic policies raise; a slice lost to
    :class:`ExecutorFailure` ends its queue with error results, since no
    other rank can take its tasks; each rank journals only its own slice's
    tasks in ``wal``.

    With ``n_shards > 1`` (§3.9) the pool bundles consecutive slices into
    :class:`ShardGroup` units of that size and SCHEDULES ON GROUPS: a
    sharded placement is one unit spanning its shard group — one queue,
    one executor id, one failure domain — and ``_placement`` hands every
    task a per-group :class:`ShardedPlacement` token, so prepared data for
    the group is built once as per-shard row blocks and ``n_executors``
    reports the group count, not the raw slice count.
    """

    def __init__(
        self,
        mesh=None,
        n_slices: int | None = None,
        task_runner: Callable[[TrainTask, object, object], tuple[object, float]] | None = None,
        wal: SearchWAL | None = None,
        slice_axis: str = "data",
        *,
        failure_hook: Callable[[int, TrainTask], None] | None = None,
        slices: Sequence[object] | None = None,
        driver_slice: object | None = None,
        on_result: Callable[[TaskResult], None] | None = None,
        prepared_cache: PreparedDataCache | None = None,
        n_shards: int = 1,
        max_task_retries: int = 0,
        retry_backoff: float = 0.05,
        poison_threshold: int | None = 3,
        sleep: Callable[[float], None] = time.sleep,
    ):
        #: this rank's slice index when the slices are process meshes
        self._own_slice: int | None = None
        if slices is not None:
            self.slices = list(slices)
        else:
            if mesh is None or n_slices is None:
                raise ValueError("provide either a mesh + n_slices or explicit slices=")
            self.slices = make_slices(mesh, n_slices, axis=slice_axis)
            if is_process_mesh(mesh):
                if n_shards != 1:
                    raise ValueError("shard groups of process-mesh slices are not supported")
                self._own_slice = next(i for i, sl in enumerate(self.slices)
                                       if sl.get_coordinate() is not None)
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if self.n_shards > 1:
            if len(self.slices) % self.n_shards:
                raise ValueError(
                    f"{len(self.slices)} slices cannot form shard groups of "
                    f"{self.n_shards}")
            self.slices = [
                ShardGroup(self.slices[g * self.n_shards:
                                       (g + 1) * self.n_shards], g)
                for g in range(len(self.slices) // self.n_shards)]
        #: None = the estimator-backed default (prepared-data plane, §3.3)
        self.task_runner = task_runner
        #: defaults to a PER-POOL cache, unlike the thread pool's process-wide
        #: one: placement tokens make cross-pool sharing impossible anyway,
        #: and a pool-owned cache lets the slices' device-resident copies be
        #: reclaimed with the pool instead of pinning the global cache forever
        self.prepared_cache = (prepared_cache if prepared_cache is not None
                               else PreparedDataCache())
        self._pool_id = next(_POOL_IDS)
        self.wal = wal or SearchWAL(None)
        self.failure_hook = failure_hook
        # where stranded tasks run when every slice is lost; defaults to
        # slice 0's handle (fine on one host where slices are logical; on
        # several, pass a driver-local mesh that outlives the slices)
        self.driver_slice = driver_slice if driver_slice is not None else self.slices[0]
        #: same contract as LocalExecutorPool.on_result: every result, as it
        #: lands, observer exceptions swallowed (CostModel feedback hook)
        self.on_result = on_result
        self._dead: set[int] = set()
        self._stragglers: list[TaskResult] = []
        #: per-task attempt/taint bookkeeping, POOL-lifetime (§3.7) — the
        #: same ledger semantics as LocalExecutorPool
        self._retry = RetryLedger(max_task_retries=max_task_retries,
                                  retry_backoff=retry_backoff,
                                  poison_threshold=poison_threshold,
                                  sleep=sleep)
        #: retriable failures collected by ``_execute`` for the current
        #: ``submit`` to re-queue (the pool is a serial generator, so the
        #: buffer needs no lock)
        self._pending_retry: list[TrainTask] = []

    def _emit(self, res: TaskResult) -> TaskResult:
        if self.on_result is not None:
            try:
                self.on_result(res)
            except Exception:
                pass
        return res

    @property
    def n_executors(self) -> int:
        return len(self.slices)

    def _queues(self, assignment: Assignment) -> list[list[TrainTask]]:
        if assignment.policy in _DYNAMIC_POLICIES:
            # single-host simulation of the pull queue: longest-first tasks go
            # to the least-loaded slice, so slice loads stay balanced.
            all_tasks = [t for t in assignment.all_tasks() if not self.wal.is_done(t.task_id)]
            queues: list[list[TrainTask]] = [[] for _ in self.slices]
            loads = [0.0] * len(self.slices)
            for t in all_tasks:
                i = loads.index(min(loads))
                queues[i].append(t)
                loads[i] += t.cost or 1.0
            return queues
        return [list(q) for q in assignment.plan]

    def _placement(self, sl):
        """Per-slice cache token: (process-unique pool id, slice index), so
        tasks on one slice share its resident prepared data, different
        slices each hold their own copy, and — when a caller INJECTS a
        shared ``prepared_cache`` across pools — a later pool can never
        collide with a dead pool's entries (an ``id()``-based token could
        be recycled). The driver fallback reuses its handle's entry when it
        is one of the slices — by default it IS slice 0.

        With ``n_shards > 1`` the scheduling units are :class:`ShardGroup`
        handles, and the token is a :class:`ShardedPlacement` tagged by
        (pool, group) — the §3.9 key under which the group's prepared data
        is built ONCE as per-shard row blocks and every family's sharded
        training/eval path dispatches."""
        idx = -1   # external driver_slice handle
        for i, s in enumerate(self.slices):
            if s is sl:
                idx = i
                break
        if self.n_shards > 1:
            return ShardedPlacement(
                self.n_shards, tag=("slice-group", self._pool_id, idx))
        return ("slice", self._pool_id, idx)

    def prepare_placements(self) -> list:
        """Placement tokens this pool converts under: one per slice for the
        estimator-backed default runner; a custom ``task_runner`` owns its
        own data handling, so the pool reports none (and the Session then
        skips conversion charging entirely)."""
        if self.task_runner is not None:
            return []
        return [self._placement(sl) for sl in self.slices]

    def _run_one(self, eid: int, task: TrainTask, sl, data,
                 validate: EvalPlan | None = None) -> TaskResult:
        """One placed task; task-level errors become TaskResult.error,
        ExecutorFailure propagates (the slice is lost). The estimator-backed
        default scores the model ON ITS SLICE (§3.4) — eval data resolves
        through the prepared cache under the slice's placement token, so
        each slice holds its own resident eval copy; a custom
        ``task_runner`` owns its payloads, so scoring is skipped."""
        conv = 0.0
        score, eval_s = None, 0.0
        rstate = None
        try:
            if self.failure_hook is not None:
                self.failure_hook(eid, task)  # may raise ExecutorFailure
            if self.task_runner is not None:
                model, secs = self.task_runner(task, sl, data)
            else:
                est, model, secs, conv, rstate = _train_solo(
                    task, data, cache=self.prepared_cache,
                    placement=self._placement(sl))
                score, eval_s = _score_solo(est, model, validate,
                                            self.prepared_cache,
                                            placement=self._placement(sl))
        except ExecutorFailure:
            raise
        except Exception as e:
            return TaskResult(task=task, model=None, train_seconds=0.0, executor_id=eid, error=repr(e))
        self.wal.record(WALRecord(task_id=task.task_id, key=task.key(), seconds=secs,
                                  executor_id=eid, score=score,
                                  convert_seconds=conv, eval_seconds=eval_s))
        if rstate is not None:
            self.wal.record_resume(task.task_id, rstate)
        return TaskResult(task=task, model=model, train_seconds=secs,
                          executor_id=eid, convert_seconds=conv,
                          score=score, eval_seconds=eval_s,
                          resume_state=rstate)

    def _run_fused(self, eid: int, unit: FusedBatch, sl, data,
                   validate: EvalPlan | None = None,
                   run_hook: bool = True) -> list[TaskResult]:
        """One fused unit as ONE placed program: the runner receives the
        batch and returns (payload per member, total seconds); results are
        unbatched with amortized per-member seconds. The estimator-backed
        default also scores the whole model stack on its slice (one batched
        predict call, §3.4). A batch-level exception is BISECTED (§3.7):
        the batch splits at its bucket boundaries and each piece re-runs,
        degrading to solo member runs, so good members are salvaged and
        only the culprit carries the error. ExecutorFailure propagates."""
        members = [m for m in unit.tasks if not self.wal.is_done(m.task_id)]
        if not members:
            return []
        sub = unit.restrict({m.task_id for m in members})
        if run_hook and self.failure_hook is not None:
            try:
                self.failure_hook(eid, unit)  # may raise ExecutorFailure
            except ExecutorFailure:
                raise
            except Exception as e:
                # injected batch-level failure: every pending member fails
                # this attempt; _execute's retry filter re-queues them SOLO
                return [TaskResult(task=m, model=None, train_seconds=0.0,
                                   executor_id=eid, error=repr(e),
                                   batch_size=len(members)) for m in members]
        if self.task_runner is None:
            # estimator-backed: the shared fused machinery (including §3.7
            # bisection); journal successes inline, as _run_one does
            results = _run_fused_unit(sub, data, eid,
                                      cache=self.prepared_cache,
                                      placement=self._placement(sl),
                                      validate=validate)
            for res in results:
                if res.ok:
                    self.wal.record(WALRecord(
                        task_id=res.task.task_id, key=res.task.key(),
                        seconds=res.train_seconds, executor_id=eid,
                        score=res.score,
                        convert_seconds=res.convert_seconds,
                        eval_seconds=res.eval_seconds))
                    if res.resume_state is not None:
                        self.wal.record_resume(res.task.task_id,
                                               res.resume_state)
            return results
        try:
            payloads, total = self.task_runner(sub, sl, data)
        except ExecutorFailure:
            raise
        except Exception as e:
            if len(members) == 1:
                return [TaskResult(task=members[0], model=None,
                                   train_seconds=0.0, executor_id=eid,
                                   error=repr(e))]
            pieces = sub.split_at_buckets()
            if len(pieces) > 1:
                out: list[TaskResult] = []
                for piece in pieces:
                    out.extend(self._run_fused(eid, piece, sl, data,
                                               validate, run_hook=False))
                return out
            # single structural bucket: singleton machinery — each member
            # runs solo so only the culprit carries the error
            return [self._run_one(eid, m, sl, data, validate)
                    for m in sub.singletons()]
        per = total / len(members)
        results = []
        for m, payload in zip(members, payloads):
            self.wal.record(WALRecord(task_id=m.task_id, key=m.key(),
                                      seconds=per, executor_id=eid,
                                      score=None))
            results.append(TaskResult(task=m, model=payload, train_seconds=per,
                                      executor_id=eid, batch_size=len(members)))
        return results

    def _run_unit(self, eid: int, task, sl, data,
                  validate: EvalPlan | None) -> tuple[list[TaskResult], dict]:
        """The raw results of one scheduled unit, and each fused member's
        solo re-queue form by task id."""
        solo: dict[int, TrainTask] = {}
        if isinstance(task, FusedBatch):
            raw = self._run_fused(eid, task, sl, data, validate)
            solo = {task.tasks[i].task_id: task.unfused_task(i)
                    for i in range(len(task.tasks))}
        elif self.wal.is_done(task.task_id):
            raw = []
        elif self._retry.quarantined(task.task_id):
            raw = [TaskResult(
                task=task, model=None, train_seconds=0.0, executor_id=eid,
                error=f"quarantined after {self._retry.taints_of(task.task_id)}"
                      " executor deaths while claimed (poison task)",
                quarantined=True)]
        else:
            raw = [self._run_one(eid, task, sl, data, validate)]
        return raw, solo

    def _execute(self, eid: int, task, sl, data,
                 validate: EvalPlan | None = None) -> list[TaskResult]:
        """Run one scheduled unit (task or fused batch); every produced
        result is emitted to ``on_result`` HERE, the moment it exists — so
        even results a cancelled stream never surfaces feed the observers.

        Retriable failures (§3.7) are filtered OUT of the returned batch
        and parked on ``_pending_retry`` — failed fused members re-queue as
        solo tasks (pre-amortization cost restored) — for ``submit`` to
        re-dispatch with backoff already paid.
        """
        with _on_slice(sl):
            raw, solo = self._run_unit(eid, task, sl, data, validate)
        results = []
        for res in raw:
            if (not res.ok and not res.quarantined
                    and self._retry.should_retry(res.task.task_id)):
                self._retry.wait(res.task.task_id)
                self._pending_retry.append(
                    solo.get(res.task.task_id, res.task))
                continue
            self._retry.stamp(res)
            results.append(res)
        for res in results:
            self._emit(res)
        return results

    def _deliver(self, batch: Sequence[TaskResult]):
        """Yield each result; if the consumer closes the stream mid-batch,
        park the not-yet-surfaced remainder for :meth:`drain_stragglers` —
        they are finished and WAL-journalled, and must not be lost."""
        for j, res in enumerate(batch):
            try:
                yield res
            except GeneratorExit:
                self._stragglers.extend(batch[j + 1:])
                raise

    def drain_stragglers(self) -> list[TaskResult]:
        """Results completed (and journalled) during an early ``submit``
        cancellation — with fused batches a close can land mid-unbatching,
        leaving finished members unseen. The Session replan loop collects
        these; the buffer is cleared on read."""
        got, self._stragglers = self._stragglers, []
        return got

    def _taint_claimed(self, eid: int, unit):
        """The slice died while running ``unit`` (§3.7): taint it. Returns
        ``(quarantine results to surface, tasks to re-queue)`` — a fused
        unit re-queues as solo singletons so the poison member isolates
        instead of re-killing whole batches; a task past
        ``poison_threshold`` deaths surfaces as a terminal quarantine
        error instead of being handed to the next victim."""
        if isinstance(unit, FusedBatch):
            qres: list[TaskResult] = []
            requeue: list[TrainTask] = []
            for m in unit.singletons():
                if self.wal.is_done(m.task_id):
                    continue
                qr, rq = self._taint_claimed(eid, m)
                qres.extend(qr)
                requeue.extend(rq)
            return qres, requeue
        n = self._retry.taint(unit.task_id)
        if self._retry.quarantined(unit.task_id):
            res = TaskResult(
                task=unit, model=None, train_seconds=0.0, executor_id=eid,
                error=f"quarantined after {n} executor deaths while "
                      "claimed (poison task)",
                quarantined=True)
            self._retry.stamp(res)
            self._emit(res)
            return [res], []
        return [], [unit]

    def submit(self, assignment: Assignment, data,
               validate: EvalPlan | None = None) -> Iterator[TaskResult]:
        """Execute the plan slice by slice, yielding each result as it lands.

        ``validate`` turns on slice-side scoring (§3.4) for the estimator-
        backed default runner: each slice evaluates the models it trained
        against its own resident copy of the eval data (per-placement cache
        entries). A custom ``task_runner`` owns its payloads — scoring is
        skipped and results stream exactly as before.

        A slice lost to :class:`ExecutorFailure` has its remaining queue
        re-distributed over the surviving slices; with no survivors the
        driver runs stranded tasks inline (executor_id=-1), matching
        LocalExecutorPool's recovery semantics.
        """
        self._stragglers = []  # per-submit buffer (see drain_stragglers)
        self._pending_retry = []
        if self._own_slice is not None:
            yield from self._deliver(self._run_rank_slice(assignment, data, validate))
            return
        queues = self._queues(assignment)
        alive = set(range(len(self.slices)))
        stranded: list[TrainTask] = []
        for eid, q in enumerate(queues):
            if eid >= len(self.slices):
                # a plan with more queues than slices (a replan built for a
                # bigger pool) must not silently drop the tail: strand it
                # for the re-queue loop instead of vanishing
                stranded.extend(q)
                continue
            sl = self.slices[eid]
            for i, task in enumerate(q):
                try:
                    results = self._execute(eid, task, sl, data, validate)
                except ExecutorFailure:
                    self._dead.add(eid)
                    alive.discard(eid)
                    qres, rq = self._taint_claimed(eid, task)
                    stranded.extend(rq)
                    stranded.extend(q[i + 1:])
                    yield from self._deliver(qres)
                    break
                yield from self._deliver(results)
        # failure re-queue: surviving slices absorb dead slices' work (and
        # every retriable failure _execute parked on _pending_retry)
        while True:
            stranded.extend(self._pending_retry)
            self._pending_retry = []
            pending = [t for t in stranded
                       if isinstance(t, FusedBatch) or not self.wal.is_done(t.task_id)]
            stranded = []
            if not pending:
                break
            if not alive:
                for task in pending:  # driver as executor of last resort
                    try:
                        results = self._execute(-1, task, self.driver_slice,
                                                data, validate)
                    except ExecutorFailure as e:
                        # every executor AND the driver-inline fallback are
                        # gone: no failure semantics left to escalate to, so
                        # the stranded tasks surface as terminal errors —
                        # they must never vanish
                        err = AllExecutorsLost(
                            f"all executors lost; driver-inline fallback "
                            f"died too: {e!r}")
                        members = task.tasks if isinstance(task, FusedBatch) else [task]
                        results = [TaskResult(task=m, model=None, train_seconds=0.0,
                                              executor_id=-1, error=repr(err))
                                   for m in members
                                   if not self.wal.is_done(m.task_id)]
                        for res in results:
                            self._retry.stamp(res)
                            self._emit(res)
                    yield from self._deliver(results)
                continue
            for idx, task in enumerate(pending):
                if not alive:  # last survivor died mid-re-queue
                    stranded.extend(pending[idx:])
                    break
                eid = sorted(alive)[idx % len(alive)]
                try:
                    results = self._execute(eid, task, self.slices[eid], data,
                                            validate)
                except ExecutorFailure:
                    self._dead.add(eid)
                    alive.discard(eid)
                    qres, rq = self._taint_claimed(eid, task)
                    stranded.extend(rq)  # retry on the next survivor
                    yield from self._deliver(qres)
                    continue
                yield from self._deliver(results)

    def _run_rank_slice(self, assignment: Assignment, data,
                        validate: EvalPlan | None) -> list[TaskResult]:
        """Run this rank's slice's queue (retries on the same slice), then
        gather every slice's results from its first rank: every slice's
        results in slice order, on every rank."""
        import torch.distributed as dist

        if assignment.policy in _DYNAMIC_POLICIES:
            raise ValueError(
                f"policy {assignment.policy!r} pulls from one queue that every slice "
                "shares; the slices of a process mesh run in separate ranks, each on its "
                "own static queue (use lpt, random or round_robin)")
        queues = self._queues(assignment)
        if len(queues) != len(self.slices):
            raise ValueError(f"a plan of {len(queues)} queues for {len(self.slices)} slices")
        eid = self._own_slice
        sl = self.slices[eid]
        pending, mine = list(queues[eid]), []
        while pending:
            task = pending.pop(0)
            try:
                mine.extend(self._execute(eid, task, sl, data, validate))
            except ExecutorFailure as e:
                self._dead.add(eid)
                lost = [task] + pending + self._pending_retry
                pending, self._pending_retry = [], []
                for unit in lost:
                    for m in (unit.tasks if isinstance(unit, FusedBatch) else [unit]):
                        res = TaskResult(task=m, model=None, train_seconds=0.0,
                                         executor_id=eid,
                                         error=f"slice {eid} lost ({e!r}); a process "
                                               "mesh cannot move its tasks to another "
                                               "rank's slice")
                        self._retry.stamp(res)
                        mine.append(self._emit(res))
            pending.extend(self._pending_retry)
            self._pending_retry = []
        leader = int(sl.mesh.flatten()[0]) == dist.get_rank()
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, (eid, mine if leader else None))
        out: list[TaskResult] = []
        for sid, results in sorted((g for g in gathered if g[1] is not None),
                                   key=lambda g: g[0]):
            if sid == eid:
                out.extend(mine)
                continue
            for res in results:
                out.append(self._emit(res))
        return out

    def run(self, assignment: Assignment, data,
            validate: EvalPlan | None = None) -> list[TaskResult]:
        """Blocking convenience: drain :meth:`submit` into a list."""
        return list(self.submit(assignment, data, validate))

    @property
    def dead_executors(self) -> set[int]:
        return set(self._dead)
