"""ExecutorBackend — the one protocol every executor pool implements.

The Driver (session.py) talks to executors through exactly one method:

    submit(assignment, data) -> Iterator[TaskResult]

``submit`` STREAMS results as tasks complete (Tune-style trial lifecycle)
instead of blocking until the whole plan has drained. That single change is
what lets the Session layer expose incremental results, early-stop budgets,
and dynamic-tuner feedback uniformly across backends — thread pools today,
mesh-slice pools on TPU, and any future async/multi-host pool.

Contract (both shipped implementations obey it; new backends must too):

* one ``TaskResult`` is yielded per unique ``task_id`` in the assignment
  that is not already recorded in the backend's WAL — duplicates from
  speculation or failure re-queue are collapsed, first completion wins;
* task-level exceptions are captured as ``TaskResult.error`` (the stream
  never raises for a bad task); executor-level failures
  (:class:`repro_torch.core.fault.ExecutorFailure`) are absorbed by re-queueing
  the dead executor's remaining work onto survivors — the driver runs
  stranded tasks inline as a last resort;
* every SUCCESSFUL completion is recorded in the WAL *before* it is
  yielded, so a consumer killed mid-stream can always resume without
  re-running finished work; failed tasks are yielded but NOT journalled —
  a resumed run retries them;
* closing the iterator early (``generator.close()`` / breaking out of a
  ``for`` loop) is a clean cancellation: the backend stops dispatching new
  tasks and releases its workers.

Optional capability — executor-side scoring (DESIGN.md §3.4): a backend MAY
accept ``submit(assignment, data, validate=EvalPlan(...))`` and score each
model where it trained, attaching ``TaskResult.score``/``eval_seconds``.
The Session detects the keyword by signature; backends without it keep the
driver-side scoring fallback, so the two-argument protocol above stays the
minimum contract.
"""
from __future__ import annotations

from typing import Iterator, Protocol, runtime_checkable

from repro_torch.core.fault import SearchWAL
from repro_torch.core.interface import TaskResult
from repro_torch.core.scheduler import Assignment

__all__ = ["ExecutorBackend"]


@runtime_checkable
class ExecutorBackend(Protocol):
    """Structural protocol for executor pools (see module docstring)."""

    #: completion log shared with the driver; used for resume + de-dup
    wal: SearchWAL

    @property
    def n_executors(self) -> int:
        """How many executors (threads / mesh slices / hosts) this pool has."""
        ...

    def submit(self, assignment: Assignment, data) -> Iterator[TaskResult]:
        """Execute ``assignment``, yielding each TaskResult as it completes."""
        ...

    @property
    def dead_executors(self) -> set[int]:
        """Executors lost to :class:`ExecutorFailure` so far (may be empty)."""
        ...
