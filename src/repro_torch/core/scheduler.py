"""Profile-based scheduling (paper §III-C).

Allocating heterogeneous training tasks to executors to minimise makespan is
an instance of job-shop scheduling (identical-machines ``P||Cmax``), NP-hard;
the paper solves it with a greedy approximation. We implement:

  * ``lpt``          — the paper's method: Longest-Processing-Time-first greedy
                        onto the least-loaded executor (4/3 − 1/(3m) approx).
  * ``random``       — the paper's baseline: random assignment of equal COUNTS.
  * ``round_robin``  — spark-sklearn's strategy: static contiguous groups.
  * ``dynamic``      — work-queue / work-stealing (the paper's §III-C dynamic
                        discussion): executors pull the next task when idle.
                        We schedule longest-first pulls, which bounds the tail.
  * ``lpt_dynamic``  — LPT static plan + dynamic re-balancing (beyond-paper):
                        steal the largest queued task from the most-loaded
                        executor when idle. Used by the elastic/fault paths.

All methods return a :class:`Assignment`; ``simulate_makespan`` evaluates a
plan under true (possibly different from estimated) durations, which is how
the benchmarks reproduce the paper's Fig. 5.
"""
from __future__ import annotations

import dataclasses
import heapq
import random as _random
from collections import deque
from typing import Sequence

from repro_torch.core.interface import TrainTask

__all__ = [
    "Assignment",
    "FairShareArbiter",
    "charge_first_of_group",
    "charge_units",
    "schedule",
    "schedule_lpt",
    "schedule_random",
    "schedule_round_robin",
    "simulate_makespan",
    "simulate_dynamic",
    "simulate_replan",
    "lpt_lower_bound",
    "rebalance",
    "replan",
    "restrict",
    "plan_makespan_estimate",
]


@dataclasses.dataclass
class Assignment:
    """Per-executor ordered task lists plus the scheduler's own cost estimate."""

    plan: list[list[TrainTask]]
    estimated_loads: list[float]
    policy: str

    @property
    def n_executors(self) -> int:
        return len(self.plan)

    @property
    def estimated_makespan(self) -> float:
        return max(self.estimated_loads) if self.estimated_loads else 0.0

    def all_tasks(self) -> list[TrainTask]:
        return [t for q in self.plan for t in q]


def _costs(tasks: Sequence[TrainTask]) -> list[float]:
    # Tasks without a profile estimate get the mean of the known ones (or 1.0)
    # — keeps LPT well-defined when profiling is partial.
    known = [t.cost for t in tasks if t.cost is not None]
    default = (sum(known) / len(known)) if known else 1.0
    return [t.cost if t.cost is not None else default for t in tasks]


def charge_first_of_group(units: Sequence, group_key, extra_cost,
                          apply=None) -> list:
    """Conversion-aware costing (DESIGN.md §3.3): add a ONE-TIME per-group
    cost to the unit of each group that will execute first.

    ``group_key(unit) -> Hashable | None`` assigns units to groups (None =
    no charge; the Session keys on the prepared-data cache key and returns
    None for formats already resident, so only COLD formats are charged);
    ``extra_cost(key) -> float | None`` is the one-time cost (None = unknown,
    group left uncharged). Within a group the charge lands on the MAX-cost
    unit (ties: lowest task_id) — LPT places highest-cost first, so that is
    the unit that pays the conversion while the rest arrive warm.
    ``apply(unit, extra) -> unit`` performs the re-cost (default:
    ``with_cost(cost + extra)``; the Session passes a FusedBatch-aware
    variant that charges a MEMBER, so the charge survives bucket splits).
    Order is preserved.

    Before this, LPT and ``split_for_balance`` mis-ranked cold formats: a
    format's first task runs conversion + training but was costed as
    training only, so plans under-estimated exactly one task per format
    group and ``plan_makespan_estimate`` (which sums unit costs) was blind
    to conversion.
    """
    if apply is None:
        def apply(u, extra):
            return u.with_cost((u.cost or 0.0) + extra)
    best: dict = {}                       # key -> (cost, -task_id, index)
    for i, u in enumerate(units):
        key = group_key(u)
        if key is None:
            continue
        rank = (u.cost or 0.0, -getattr(u, "task_id", i))
        if key not in best or rank > best[key][:2]:
            best[key] = (*rank, i)
    charged = {}
    for key, (_, _, i) in best.items():
        extra = extra_cost(key)
        if extra is not None and extra > 0:
            charged[i] = extra
    return [apply(u, charged[i]) if i in charged else u
            for i, u in enumerate(units)]


def charge_units(units: Sequence, extra_cost, apply=None) -> list:
    """Eval-aware costing (DESIGN.md §3.4): add a RECURRING per-unit cost.

    The §3.4 sibling of :func:`charge_first_of_group` (which is one-time per
    group): every unit pays — executor-side scoring runs once per task, so
    a plan that ignores it under-costs every unit by its eval time and LPT
    mis-ranks exactly the families whose models are slow to score.

    ``extra_cost(unit) -> float | None`` (None/0 = leave the unit alone; the
    Session answers with the CostModel's learned ``predict_eval``, which is
    None until the family has been observed scoring). ``apply(unit, extra)
    -> unit`` performs the re-cost — default ``with_cost(cost + extra)``,
    skipped for units with no estimate at all (an eval charge on top of
    nothing would masquerade as a full profile); the Session passes a
    FusedBatch-aware variant that charges every MEMBER
    (``fusion.FusedBatch.charge_each``), so bucket splits and restricts
    keep each piece's share. Order is preserved.
    """
    if apply is None:
        def apply(u, extra):
            return (u.with_cost((u.cost or 0.0) + extra)
                    if u.cost is not None else u)
    out = []
    for u in units:
        extra = extra_cost(u)
        out.append(apply(u, extra) if extra is not None and extra > 0 else u)
    return out


def schedule_lpt(tasks: Sequence[TrainTask], n_executors: int) -> Assignment:
    """The paper's greedy: sort by estimated time desc, place on min-load node."""
    if n_executors <= 0:
        raise ValueError("n_executors must be positive")
    costs = _costs(tasks)
    order = sorted(range(len(tasks)), key=lambda i: -costs[i])
    plan: list[list[TrainTask]] = [[] for _ in range(n_executors)]
    heap = [(0.0, e) for e in range(n_executors)]  # (load, executor)
    heapq.heapify(heap)
    for i in order:
        load, e = heapq.heappop(heap)
        plan[e].append(tasks[i])
        heapq.heappush(heap, (load + costs[i], e))
    loads = [sum(_costs(q)) if q else 0.0 for q in plan]
    return Assignment(plan=plan, estimated_loads=loads, policy="lpt")


def schedule_random(tasks: Sequence[TrainTask], n_executors: int, seed: int = 0) -> Assignment:
    """Paper baseline: equal task COUNTS, random membership (cost-blind)."""
    if n_executors <= 0:
        raise ValueError("n_executors must be positive")
    rng = _random.Random(seed)
    idx = list(range(len(tasks)))
    rng.shuffle(idx)
    plan: list[list[TrainTask]] = [[] for _ in range(n_executors)]
    for j, i in enumerate(idx):
        plan[j % n_executors].append(tasks[i])
    loads = [sum(_costs(q)) if q else 0.0 for q in plan]
    return Assignment(plan=plan, estimated_loads=loads, policy="random")


def schedule_round_robin(tasks: Sequence[TrainTask], n_executors: int) -> Assignment:
    """spark-sklearn style: contiguous equal-size groups in grid order."""
    if n_executors <= 0:
        raise ValueError("n_executors must be positive")
    plan: list[list[TrainTask]] = [[] for _ in range(n_executors)]
    per = -(-len(tasks) // n_executors) if tasks else 0  # ceil
    for j, t in enumerate(tasks):
        plan[min(j // per, n_executors - 1) if per else 0].append(t)
    loads = [sum(_costs(q)) if q else 0.0 for q in plan]
    return Assignment(plan=plan, estimated_loads=loads, policy="round_robin")


def schedule(tasks: Sequence[TrainTask], n_executors: int, policy: str = "lpt",
             seed: int = 0, *, splitter=None) -> Assignment:
    """Plan ``tasks`` — or fused units: anything with ``task_id``/``cost``/
    ``with_cost`` schedules identically (``repro_torch.core.fusion.FusedBatch``
    duck-types this), so every policy below is batch-aware for free.

    ``splitter(units, n_executors) -> units`` runs first when given —
    typically :func:`repro_torch.core.fusion.split_for_balance`, which cuts
    bottleneck fused batches at bucket boundaries so a batch bigger than the
    ideal per-executor load stops being the makespan floor.
    """
    if splitter is not None:
        tasks = splitter(tasks, n_executors)
    if policy == "lpt":
        return schedule_lpt(tasks, n_executors)
    if policy == "random":
        return schedule_random(tasks, n_executors, seed=seed)
    if policy == "round_robin":
        return schedule_round_robin(tasks, n_executors)
    if policy in ("dynamic", "lpt_dynamic"):
        # Dynamic policies have no static plan; executors pull from a shared
        # queue ordered longest-first. Represent as a single shared queue.
        costs = _costs(tasks)
        order = sorted(range(len(tasks)), key=lambda i: -costs[i])
        queue = [tasks[i] for i in order]
        plan = [queue] + [[] for _ in range(n_executors - 1)]
        return Assignment(plan=plan, estimated_loads=[sum(costs)] + [0.0] * (n_executors - 1), policy=policy)
    raise ValueError(f"unknown scheduling policy {policy!r}")


# --------------------------------------------------------------------------
# Evaluation helpers (used by tests + the Fig.5 benchmark).
# --------------------------------------------------------------------------

def lpt_lower_bound(true_costs: Sequence[float], n_executors: int) -> float:
    """Trivial lower bound on OPT makespan: max(mean load, longest task)."""
    if not true_costs:
        return 0.0
    return max(sum(true_costs) / n_executors, max(true_costs))


def simulate_makespan(assignment: Assignment, true_cost: dict[int, float]) -> float:
    """Makespan of a STATIC plan under true per-task durations."""
    return max(
        (sum(true_cost[t.task_id] for t in q) for q in assignment.plan),
        default=0.0,
    )


def simulate_dynamic(
    tasks: Sequence[TrainTask],
    n_executors: int,
    true_cost: dict[int, float],
    longest_first: bool = True,
) -> float:
    """Makespan of the dynamic (pull-queue) policy under true durations.

    Longest-first pulls implement the classical LPT list-scheduling bound; the
    paper notes even dynamic scheduling suffers when the LAST pulled task is
    long, which longest-first ordering provably mitigates.
    """
    order = sorted(tasks, key=lambda t: -(true_cost[t.task_id])) if longest_first else list(tasks)
    heap = [(0.0, e) for e in range(n_executors)]
    heapq.heapify(heap)
    for t in order:
        load, e = heapq.heappop(heap)
        heapq.heappush(heap, (load + true_cost[t.task_id], e))
    return max(load for load, _ in heap)


def rebalance(
    remaining: Sequence[TrainTask],
    n_executors: int,
    policy: str = "lpt",
) -> Assignment:
    """Re-plan after executor loss/gain (elastic scaling / fault recovery).

    The WAL (fault.py) supplies ``remaining``; this is just a re-run of the
    greedy on the surviving pool — the paper's scheduler is stateless, which
    is exactly what makes elastic re-planning cheap.
    """
    return schedule(remaining, n_executors, policy=policy)


# --------------------------------------------------------------------------
# Profile-feedback re-planning (DESIGN.md §3.1).
# --------------------------------------------------------------------------

def plan_makespan_estimate(assignment: Assignment) -> float:
    """Policy-aware makespan estimate of a plan under its tasks' costs.

    Static plans answer directly (max per-executor load); dynamic pull-queue
    plans are evaluated by list-scheduling their queue longest-first — their
    ``estimated_loads`` pile everything on queue 0 and would be meaningless
    as a makespan.

    Conversion cost is included exactly when the units were costed through
    :func:`charge_first_of_group` (the Session does this for cold format
    groups before planning and before each replan) — the estimate always
    reads the units' own costs, so one-time conversion charges flow into it.
    """
    tasks = assignment.all_tasks()
    if not tasks:
        return 0.0
    if assignment.policy in ("dynamic", "lpt_dynamic"):
        costs = _costs(tasks)
        return simulate_dynamic(
            tasks, assignment.n_executors,
            {t.task_id: c for t, c in zip(tasks, costs)})
    return assignment.estimated_makespan


def restrict(assignment: Assignment, remaining: Sequence[TrainTask]) -> Assignment:
    """The residual of a plan: drop completed tasks, adopt updated costs.

    ``remaining`` is matched by ``task_id``; the returned plan keeps the
    original executor placement and ordering but carries ``remaining``'s
    (possibly re-estimated) task objects, so its estimate is comparable with
    a fresh :func:`replan` of the same tasks.
    """
    by_id = {t.task_id: t for t in remaining}
    plan = [[by_id[t.task_id] for t in q if t.task_id in by_id]
            for q in assignment.plan]
    loads = [sum(_costs(q)) if q else 0.0 for q in plan]
    return Assignment(plan=plan, estimated_loads=loads, policy=assignment.policy)


def replan(
    remaining: Sequence[TrainTask],
    n_executors: int,
    *,
    current: Assignment | None = None,
    policy: str = "lpt",
    splitter=None,
) -> Assignment:
    """Mid-session re-plan: re-run :func:`rebalance` on the remaining tasks.

    Called by the Session when observed runtimes have drifted from the
    profile (see ``repro_torch.core.cost_model.observed_drift``) — ``remaining``
    should carry costs re-estimated from the feedback CostModel. When
    ``current`` (the residual of the active plan, via :func:`restrict`, with
    the SAME updated costs) is given, the cheaper of {rebalanced, current} is
    returned — so a replan NEVER increases the estimated makespan.

    ``splitter`` (see :func:`schedule`) applies to the FRESH side only: a
    replan may split a fused batch at bucket boundaries when that improves
    the balance, while the current residual keeps its units intact — the
    better of the two still wins, so splitting can only help.
    """
    fresh = rebalance(splitter(remaining, n_executors) if splitter is not None
                      else remaining, n_executors, policy=policy)
    if current is not None and (
            plan_makespan_estimate(current) < plan_makespan_estimate(fresh)):
        return current
    return fresh


class _RatioFeedback:
    """Default feedback for :func:`simulate_replan`: per-family mean
    observed/estimated ratio — the poor man's CostModel, no size axis."""

    def __init__(self):
        self._ratios: dict[str, list[float]] = {}

    def observe(self, task: TrainTask, seconds: float) -> None:
        if task.cost and task.cost > 0 and seconds > 0:
            self._ratios.setdefault(task.estimator, []).append(seconds / task.cost)

    def predict(self, task: TrainTask) -> float | None:
        rs = self._ratios.get(task.estimator)
        if rs and task.cost:
            return task.cost * sum(rs) / len(rs)
        return None


def simulate_replan(
    tasks: Sequence[TrainTask],
    n_executors: int,
    true_cost: dict[int, float],
    *,
    threshold: float = 0.25,
    feedback=None,
    min_window: int = 2,
    max_replans: int = 8,
) -> dict:
    """Device-free event simulation of static LPT + profile-feedback replans.

    Plans with the tasks' ESTIMATED costs, executes under ``true_cost``.
    Each completion is fed to ``feedback`` (``observe(task, seconds)`` /
    ``predict(task) -> seconds | None``; defaults to a per-family ratio
    corrector). When the drift of completions since the last plan exceeds
    ``threshold``, unstarted tasks are re-estimated and re-packed LPT onto
    the executors' current frontiers. This is the benchmark's Fig. 5-style
    mis-estimate recovery path and the reference semantics for the live
    Session replan loop.

    Returns ``{"makespan", "replans", "observed"}``.
    """
    from repro_torch.core.cost_model import observed_drift

    if n_executors <= 0:
        raise ValueError("n_executors must be positive")
    est = {t.task_id: c for t, c in zip(tasks, _costs(tasks))}
    queues = [list(q) for q in schedule_lpt(list(tasks), n_executors).plan]
    fb = feedback if feedback is not None else _RatioFeedback()
    ready = [0.0] * n_executors         # per-executor frontier (last finish)
    heap: list[tuple[float, int, int, TrainTask]] = []  # (finish, seq, eid, task)
    busy: set[int] = set()
    seq = 0

    def start_next(eid: int, now: float | None = None) -> None:
        nonlocal seq
        if not queues[eid]:
            busy.discard(eid)
            return
        if now is not None:
            ready[eid] = max(ready[eid], now)   # an idle executor restarts NOW
        t = queues[eid].pop(0)
        finish = ready[eid] + true_cost[t.task_id]
        ready[eid] = finish
        heapq.heappush(heap, (finish, seq, eid, t))
        busy.add(eid)
        seq += 1

    for e in range(n_executors):
        start_next(e)
    window: list[tuple[float, float]] = []
    makespan, replans, observed = 0.0, 0, 0
    while heap:
        finish, _, eid, task = heapq.heappop(heap)
        busy.discard(eid)
        makespan = max(makespan, finish)
        obs = true_cost[task.task_id]
        fb.observe(task, obs)
        observed += 1
        window.append((est[task.task_id], obs))
        remaining = [t for q in queues for t in q]
        if (remaining and replans < max_replans and len(window) >= min_window
                and observed_drift(window) > threshold):
            recosted = []
            for t in remaining:
                p = fb.predict(t)
                recosted.append(t.with_cost(p) if p is not None and p > 0 else t)
            # LPT onto executors seeded with their current frontiers: busy
            # executors free up at ready[e] >= now, idle ones are free NOW.
            costs = _costs(recosted)
            order = sorted(range(len(recosted)), key=lambda i: -costs[i])
            loads = [(max(ready[e], finish), e) for e in range(n_executors)]
            heapq.heapify(loads)
            queues = [[] for _ in range(n_executors)]
            for i in order:
                load, e = heapq.heappop(loads)
                queues[e].append(recosted[i])
                heapq.heappush(loads, (load + costs[i], e))
            for t, c in zip(recosted, costs):
                est[t.task_id] = c           # drift now measured vs new plan
            window = []
            replans += 1
            for e in range(n_executors):     # wake executors the replan fed
                if e not in busy:
                    start_next(e, now=finish)
        if eid not in busy:
            start_next(eid)
    return {"makespan": makespan, "replans": replans, "observed": observed}


# --------------------------------------------------------------------------
# Multi-tenant fair-share arbitration (DESIGN.md §3.5).
# --------------------------------------------------------------------------

class FairShareArbiter:
    """Stride-scheduling arbiter over per-tenant unit queues.

    The multi-tenant service (``repro_torch.serve.search_service``) funnels every
    active session's ready units through ONE of these; shared workers ask it
    ``pop()`` whenever they go idle. Two modes:

    * ``"fair_share"`` (stride scheduling): each tenant carries a *pass*
      value; ``pop`` serves the ready tenant with the LOWEST pass and then
      advances it by ``cost / weight`` of the dispatched unit. Over time
      every tenant's dispatched cost converges to its weight share — a
      1000-config tenant cannot starve a 10-config one, it merely runs
      alongside it. When an idle tenant becomes ready again its pass is
      caught up to the minimum ready pass (never reset below its own), so
      sleeping does not bank credit — the classic stride/deficit guard.
    * ``"fifo"``: strict arrival order of tenants — a tenant's queue drains
      completely before a later tenant runs (head-of-line blocking on
      purpose; this is the baseline ``serve_bench`` contrasts against).

    Costs are the units' profile estimates (``None``/non-positive charges a
    nominal 1.0 — unprofiled work still advances the pass). Pure data
    structure, no locking: the service calls it under its own lock, and the
    benchmark drives the SAME object from a deterministic event clock.
    Ties break by tenant arrival order, so dispatch order is reproducible.
    """

    #: pass charge for units with no usable cost estimate
    NOMINAL_COST = 1.0

    def __init__(self, mode: str = "fair_share"):
        if mode not in ("fair_share", "fifo"):
            raise ValueError(f"unknown arbiter mode {mode!r}")
        self.mode = mode
        self._queues: dict[str, deque] = {}      # tenant -> deque[(item, cost)]
        self._weights: dict[str, float] = {}
        self._pass: dict[str, float] = {}
        self._arrival: dict[str, int] = {}       # tenant -> registration order
        self._n_seen = 0
        #: total dispatched cost per tenant — the observed-share numerator
        #: behind ServiceStats' drift reporting
        self.dispatched_cost: dict[str, float] = {}

    def ensure_tenant(self, tenant: str, weight: float = 1.0) -> None:
        """Register ``tenant`` (idempotent; re-registering updates weight)."""
        if weight <= 0:
            raise ValueError(f"tenant weight must be positive, got {weight}")
        if tenant not in self._queues:
            self._queues[tenant] = deque()
            self._pass[tenant] = 0.0
            self._arrival[tenant] = self._n_seen
            self._n_seen += 1
            self.dispatched_cost[tenant] = 0.0
        self._weights[tenant] = float(weight)

    def push(self, tenant: str, item, cost: float | None = None) -> None:
        """Queue one unit for ``tenant`` (FIFO within the tenant)."""
        self.ensure_tenant(tenant, self._weights.get(tenant, 1.0))
        q = self._queues[tenant]
        if not q:
            # idle -> ready: catch the pass up to the busy minimum so the
            # tenant gets service soon but claims no credit for idle time
            ready = [self._pass[t] for t, qq in self._queues.items() if qq]
            if ready:
                self._pass[tenant] = max(self._pass[tenant], min(ready))
        q.append((item, cost))

    def pop(self):
        """Dispatch decision: ``(tenant, item, cost)`` or None when empty."""
        ready = [t for t, q in self._queues.items() if q]
        if not ready:
            return None
        if self.mode == "fifo":
            tenant = min(ready, key=lambda t: self._arrival[t])
        else:
            tenant = min(ready, key=lambda t: (self._pass[t], self._arrival[t]))
        item, cost = self._queues[tenant].popleft()
        charge = cost if cost is not None and cost > 0 else self.NOMINAL_COST
        self._pass[tenant] += charge / self._weights[tenant]
        self.dispatched_cost[tenant] += charge
        return tenant, item, cost

    def discard(self, tenant: str, pred) -> int:
        """Drop queued units of ``tenant`` matching ``pred(item)`` (the
        service's session-cancellation path); returns how many were removed."""
        q = self._queues.get(tenant)
        if not q:
            return 0
        kept = deque(e for e in q if not pred(e[0]))
        removed = len(q) - len(kept)
        self._queues[tenant] = kept
        return removed

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def share_drift(self) -> float:
        """max over tenants of |observed share − weight share| of dispatched
        cost (0.0 until anything dispatched). The fairness gauge surfaced in
        ``ServiceStats``: FIFO on mixed tenants drifts toward 1, fair-share
        stays near 0 once steady."""
        total = sum(self.dispatched_cost.values())
        wsum = sum(self._weights[t] for t in self.dispatched_cost)
        if total <= 0 or wsum <= 0:
            return 0.0
        return max(abs(c / total - self._weights[t] / wsum)
                   for t, c in self.dispatched_cost.items())
