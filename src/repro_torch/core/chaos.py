"""Deterministic fault injection for the execution plane (DESIGN.md §3.7).

Chaos testing a search runtime only pays off when a failing run can be
replayed: every fault decision here derives from a seeded hash of
``(seed, task_id, attempt)`` — never from wall-clock or a shared RNG — so
the same :class:`FaultPlan` injects the same faults into the same tasks
regardless of thread interleaving, pool flavour, or how often the suite
re-runs.

The plan compiles (:meth:`FaultPlan.build`) into an :class:`ActiveChaos`
whose ``hook(eid, task)`` plugs straight into the seam every execution
plane already exposes — ``failure_hook`` on :class:`LocalExecutorPool`,
:class:`MeshSliceExecutorPool` and :class:`SearchService`:

* **train exception** — raises :class:`ChaosTaskError`; the plane records a
  task-level failure and the retry ledger decides its fate.
* **executor death** — raises :class:`~repro_torch.core.fault.ExecutorFailure`
  at an executor's k-th dispatch; the plane taints the claimed unit and
  re-queues it on survivors.
* **poison task** — EVERY executor that claims it dies, driving the
  quarantine path.
* **hang** — sleeps through the injectable clock, driving the deadline
  paths.

Storage-level faults don't go through the hook — they corrupt artifacts
between runs: :func:`tear_wal_tail` (torn trailing WAL record, as a crash
mid-append leaves) and :func:`corrupt_json` (mangled cost-model state).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Mapping

from repro_torch.core.fault import ExecutorFailure
from repro_torch.core.fusion import FusedBatch

__all__ = ["ChaosTaskError", "FaultPlan", "ActiveChaos", "chaos_roll",
           "tear_wal_tail", "corrupt_json"]


class ChaosTaskError(RuntimeError):
    """An injected task-level training failure."""


def chaos_roll(seed: int, task_id: int, attempt: int) -> float:
    """The deterministic coin: a uniform [0, 1) draw keyed only by
    ``(seed, task_id, attempt)``. Order-independent by construction, so
    concurrent pools and the serial simulator make identical decisions."""
    h = hashlib.blake2b(f"{seed}:{task_id}:{attempt}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A declarative, seeded set of faults to inject into one run."""

    #: keys every probabilistic decision; two plans with equal seeds make
    #: identical per-task choices
    seed: int = 0
    #: probability that any given (task, attempt) raises ChaosTaskError
    task_failure_rate: float = 0.0
    #: cap on injected train failures PER TASK — with retries configured
    #: above the cap a task eventually succeeds; set it above the retry
    #: budget to force terminal failures
    max_task_faults: int = 1
    #: task ids that deterministically fail their first ``max_task_faults``
    #: attempts, independent of ``task_failure_rate``
    fail_tasks: frozenset = frozenset()
    #: (executor_id, k) pairs: that executor raises ExecutorFailure on its
    #: k-th dispatch (1-based), once
    executor_deaths: tuple = ()
    #: task ids whose EVERY claim kills the claiming executor — the
    #: quarantine driver
    poison_tasks: frozenset = frozenset()
    #: task_id -> seconds to sleep before running (deadline driver)
    hang_tasks: Mapping[int, float] = dataclasses.field(default_factory=dict)

    def build(self, sleep: Callable[[float], None] = time.sleep
              ) -> "ActiveChaos":
        """Compile into a stateful injector; ``sleep`` is injectable so
        simulated clocks pay nothing for hangs."""
        return ActiveChaos(self, sleep=sleep)


class ActiveChaos:
    """One run's live fault state: attempt counters, death bookkeeping and
    an event log. ``hook`` is the object to pass as ``failure_hook=``."""

    def __init__(self, plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self.plan = plan
        self._sleep = sleep
        self._lock = threading.Lock()
        self._attempts: dict[int, int] = {}   # task_id -> dispatches seen
        self._dispatches: dict[int, int] = {} # executor_id -> dispatch count
        self._deaths_fired: set = set()       # (eid, k) pairs already used
        self.n_train_faults = 0
        self.n_deaths = 0
        self.n_poison_kills = 0
        self.n_hangs = 0
        #: (kind, executor_id, task_id, attempt) tuples, in injection order
        self.events: list[tuple] = []

    # ------------------------------------------------------------------
    def _members(self, task) -> list:
        return list(task.tasks) if isinstance(task, FusedBatch) else [task]

    def hook(self, eid: int, task) -> None:
        """The ``failure_hook`` seam. Raises ExecutorFailure for deaths and
        poison claims, ChaosTaskError for injected train failures, sleeps
        for hangs; otherwise returns and the unit runs normally."""
        plan = self.plan
        members = self._members(task)
        with self._lock:
            self._dispatches[eid] = k = self._dispatches.get(eid, 0) + 1
            # 1. scheduled executor death at this dispatch ordinal
            if (eid, k) in plan.executor_deaths and (eid, k) not in self._deaths_fired:
                self._deaths_fired.add((eid, k))
                self.n_deaths += 1
                self.events.append(("death", eid, task.task_id, k))
                raise ExecutorFailure(
                    f"chaos: executor {eid} died at dispatch {k}")
            # 2. poison task: every claim kills the claiming executor
            for m in members:
                if m.task_id in plan.poison_tasks:
                    self.n_poison_kills += 1
                    self.events.append(("poison", eid, m.task_id,
                                        self._attempts.get(m.task_id, 0) + 1))
                    raise ExecutorFailure(
                        f"chaos: poison task {m.task_id} killed executor {eid}")
            # 3. per-member train-failure decisions (order-independent:
            # keyed by each member's own attempt ordinal)
            failing: list[int] = []
            for m in members:
                att = self._attempts[m.task_id] = \
                    self._attempts.get(m.task_id, 0) + 1
                faults_so_far = sum(1 for e in self.events
                                    if e[0] == "fault" and e[2] == m.task_id)
                if faults_so_far >= plan.max_task_faults:
                    continue
                forced = m.task_id in plan.fail_tasks
                if forced or (plan.task_failure_rate > 0.0 and
                              chaos_roll(plan.seed, m.task_id, att)
                              < plan.task_failure_rate):
                    self.n_train_faults += 1
                    self.events.append(("fault", eid, m.task_id, att))
                    failing.append(m.task_id)
            hang = max((plan.hang_tasks.get(m.task_id, 0.0) for m in members),
                       default=0.0)
            if hang > 0:
                self.n_hangs += 1
                self.events.append(("hang", eid, members[0].task_id,
                                    self._attempts.get(members[0].task_id, 0)))
        # sleep OUTSIDE the lock: a hung executor must not block the
        # injector for every other thread
        if hang > 0:
            self._sleep(hang)
        if failing:
            raise ChaosTaskError(
                f"chaos: injected train failure for task(s) {failing}")

    # ------------------------------------------------------------------
    def faults_for(self, task_id: int) -> int:
        """Injected train failures charged to one task (determinism probes)."""
        with self._lock:
            return sum(1 for e in self.events
                       if e[0] == "fault" and e[2] == task_id)


# ---------------------------------------------------------------------------
# Storage-level faults: corrupt artifacts the way real crashes do.
# ---------------------------------------------------------------------------

def tear_wal_tail(path: str, keep_fraction: float = 0.5) -> int:
    """Truncate the WAL's last line mid-record — the torn write a crash
    during ``fsync`` leaves behind. Returns the number of bytes removed."""
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        return 0
    body = data.rstrip(b"\n")
    cut = body.rfind(b"\n") + 1          # start of the last record
    last = body[cut:]
    keep = max(1, int(len(last) * keep_fraction))
    torn = data[:cut] + last[:keep]      # no trailing newline: mid-write
    with open(path, "wb") as f:
        f.write(torn)
    return len(data) - len(torn)


def corrupt_json(path: str, garbage: str = '{"version": 1, "laws": {tru'
                 ) -> None:
    """Overwrite a JSON artifact (cost-model state) with a torn/invalid
    payload, as a crash mid-rewrite leaves it."""
    with open(path, "w") as f:
        f.write(garbage)
