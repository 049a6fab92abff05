"""Fault tolerance for model search: WAL checkpoint/restart, failure handling.

Large-scale runs (1000+ nodes) lose executors; a multi-hour search must not
restart from scratch. Mechanisms:

* :class:`SearchWAL` — append-only JSONL write-ahead log of task completions
  (task_id, score, seconds). On restart, completed work is skipped and only
  remaining tasks are re-scheduled (scheduler.rebalance). A truncated or
  corrupt line (torn write on crash) is skipped with a warning — a crash
  mid-append must not make the whole journal unreadable.
* :class:`ExecutorFailure` — raised by an executor; the pool catches it, marks
  the executor dead, and re-queues its unfinished tasks on the survivors.
* :class:`RetryLedger` — per-task attempt/taint bookkeeping shared by both
  pools and the search service's shared workers (DESIGN.md §3.7): bounded
  retry with capped exponential backoff for tasks whose train raises, and
  poison-task quarantine for tasks that keep killing their executors.
* Straggler speculation — in dynamic mode, when an executor has been running a
  task for > ``speculation_factor`` × its estimated cost and another executor
  is idle, a duplicate copy is launched; first completion wins (the paper's
  §III-C tail-task concern, mechanised).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from typing import Callable, Iterable

from repro_torch.core.interface import ResumeState, TrainTask

__all__ = ["SearchWAL", "ExecutorFailure", "AllExecutorsLost", "WALRecord",
           "RetryLedger"]


class ExecutorFailure(RuntimeError):
    """An executor died (injected in tests; surfaced by runtime errors)."""


class AllExecutorsLost(ExecutorFailure):
    """Every executor (including the driver-inline fallback) is gone; the
    tasks it carries surface as terminal error results, never vanish."""


class RetryLedger:
    """Per-task attempt and taint bookkeeping (DESIGN.md §3.7).

    One ledger is shared by every execution seam of a pool (or of one
    service session), so counts survive re-queues, replans and resubmits:

    * ``should_retry(task_id)`` — record one failed attempt; True while the
      task still has retry budget (``fails <= max_task_retries``).
    * ``wait(task_id)`` — capped exponential backoff before the re-queue,
      through an injectable ``sleep`` so simulated clocks (chaos tests,
      benches) pay nothing.
    * ``taint(task_id)`` — the task was claimed by an executor that died;
      after ``poison_threshold`` deaths :meth:`quarantined` flips True and
      the pool surfaces a quarantine error result instead of re-queueing,
      so one poison config cannot cascade-kill the whole pool.
    """

    #: backoff never exceeds this many seconds, however many retries
    BACKOFF_CAP = 30.0

    def __init__(self, max_task_retries: int = 0, retry_backoff: float = 0.05,
                 poison_threshold: int | None = 3,
                 sleep: Callable[[float], None] = time.sleep):
        if max_task_retries < 0:
            raise ValueError(f"max_task_retries must be >= 0, got {max_task_retries}")
        if retry_backoff < 0:
            raise ValueError(f"retry_backoff must be >= 0, got {retry_backoff}")
        if poison_threshold is not None and poison_threshold < 1:
            raise ValueError(f"poison_threshold must be >= 1, got {poison_threshold}")
        self.max_task_retries = int(max_task_retries)
        self.retry_backoff = float(retry_backoff)
        self.poison_threshold = poison_threshold
        self._sleep = sleep
        self._lock = threading.Lock()
        self._fails: dict[int, int] = {}    # task_id -> failed attempts so far
        self._taints: dict[int, int] = {}   # task_id -> executor deaths while claimed

    # -- failed-attempt accounting -------------------------------------
    def should_retry(self, task_id: int) -> bool:
        """Record one failed attempt; True while retry budget remains."""
        with self._lock:
            fails = self._fails[task_id] = self._fails.get(task_id, 0) + 1
        return fails <= self.max_task_retries

    def attempts_of(self, task_id: int) -> int:
        """Attempts charged to this task so far (the attempt that just
        produced a result included — call AFTER the should_retry/success)."""
        with self._lock:
            return self._fails.get(task_id, 0) + 1

    def failures_of(self, task_id: int) -> int:
        with self._lock:
            return self._fails.get(task_id, 0)

    def backoff_of(self, task_id: int) -> float:
        """Capped exponential backoff for the task's NEXT attempt."""
        with self._lock:
            fails = self._fails.get(task_id, 0)
        if fails <= 0 or self.retry_backoff <= 0:
            return 0.0
        return min(self.retry_backoff * (2.0 ** (fails - 1)), self.BACKOFF_CAP)

    def wait(self, task_id: int) -> None:
        delay = self.backoff_of(task_id)
        if delay > 0:
            self._sleep(delay)

    # -- poison-task quarantine ----------------------------------------
    def taint(self, task_id: int) -> int:
        """The task was claimed when its executor died; returns the count."""
        with self._lock:
            n = self._taints[task_id] = self._taints.get(task_id, 0) + 1
        return n

    def taints_of(self, task_id: int) -> int:
        with self._lock:
            return self._taints.get(task_id, 0)

    def quarantined(self, task_id: int) -> bool:
        if self.poison_threshold is None:
            return False
        with self._lock:
            return self._taints.get(task_id, 0) >= self.poison_threshold

    def stamp(self, res) -> "object":
        """Set ``res.attempts`` from the ledger: a success is one more
        attempt than its recorded failures, a terminal failure's last
        attempt was already counted by :meth:`should_retry`. ``max`` keeps
        any larger explicitly-set value (fused-unit timeouts)."""
        fails = self.failures_of(res.task.task_id)
        res.attempts = max(res.attempts, 1, fails + (1 if res.ok else 0))
        return res


@dataclasses.dataclass(frozen=True)
class WALRecord:
    task_id: int
    key: str
    seconds: float
    executor_id: int
    #: validation metric computed executor-side (§3.4); None before the
    #: validation plane, or when the submit carried no EvalPlan
    score: float | None = None
    #: uniform→native conversion seconds the task paid (0.0 on a prepared-
    #: data cache hit) — journalled so post-hoc analysis sees the cost the
    #: old pre-§3.3 accounting silently dropped. Defaults keep old WALs
    #: parseable.
    convert_seconds: float = 0.0
    #: executor-side scoring seconds (amortized share for fused members) —
    #: the §3.4 analogue of ``convert_seconds``; defaults keep old WALs
    #: parseable.
    eval_seconds: float = 0.0


class SearchWAL:
    """Append-only completion log; safe under concurrent executor threads."""

    def __init__(self, path: str | None):
        self.path = path
        self._lock = threading.Lock()
        self._done: dict[int, WALRecord] = {}
        #: task_id → wire-form ResumeState (adaptive search, DESIGN.md §3.6);
        #: kept as wire dicts so loading a WAL never imports family payloads
        self._resume: dict[int, dict] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    # crash consistency: a torn trailing line (the process
                    # died mid-append) or an isolated corrupt record must
                    # not abort resume — skip it; the un-journalled task
                    # simply re-runs, which is the WAL's normal contract
                    # for anything that never committed
                    try:
                        obj = json.loads(line)
                        # records are dispatched on the optional "kind"
                        # field; completion lines (old WALs) have none
                        if obj.get("kind") == "resume":
                            self._resume[int(obj["task_id"])] = obj["state"]
                            continue
                        rec = WALRecord(**obj)
                    except (json.JSONDecodeError, TypeError, KeyError,
                            ValueError) as e:
                        warnings.warn(
                            f"WAL {path}:{lineno}: skipping corrupt record "
                            f"({type(e).__name__}: {e}) — torn write on "
                            "crash? The task it journalled will re-run.",
                            RuntimeWarning, stacklevel=2)
                        continue
                    self._done[rec.task_id] = rec

    # -- write side -------------------------------------------------------
    def record(self, rec: WALRecord) -> None:
        with self._lock:
            self._done[rec.task_id] = rec
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(dataclasses.asdict(rec)) + "\n")
                    f.flush()
                    os.fsync(f.fileno())

    def record_resume(self, task_id: int, state: ResumeState) -> None:
        """Journal a rung's carryover so ``Session.resume`` restarts warm."""
        wire = state.to_wire()
        with self._lock:
            self._resume[int(task_id)] = wire
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps({"kind": "resume", "task_id": int(task_id),
                                        "state": wire}) + "\n")
                    f.flush()
                    os.fsync(f.fileno())

    # -- read side ----------------------------------------------------------
    def is_done(self, task_id: int) -> bool:
        with self._lock:
            return task_id in self._done

    def completed(self) -> dict[int, WALRecord]:
        with self._lock:
            return dict(self._done)

    def remaining(self, tasks: Iterable[TrainTask]) -> list[TrainTask]:
        with self._lock:
            return [t for t in tasks if t.task_id not in self._done]

    def resume_state(self, task_id: int) -> ResumeState | None:
        """The journalled carryover of a completed rung, if any."""
        with self._lock:
            wire = self._resume.get(int(task_id))
        return None if wire is None else ResumeState.from_wire(wire)
