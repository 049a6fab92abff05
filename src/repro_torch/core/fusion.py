"""Task fusion: hyperparameter-batched training units (DESIGN.md §3.2).

The paper's search trains many configurations of the SAME estimator family
(864 of its 1,211 tasks are XGBoost), yet a one-task-per-program executor
pays a fresh dispatch — and, across structural hyperparameters, a fresh
compile — for every tiny config. On accelerators the natural packing is
``vmap`` over hyperparameters: a family of configs becomes one large fused
program. This module owns the three driver-side pieces:

* :func:`fuse_tasks` groups ``TrainTask``s by ``(family, fuse signature)``
  into :class:`FusedBatch` units. A batch duck-types the scheduler's view of
  a task (``task_id``/``cost``/``with_cost``), so every existing policy —
  LPT, dynamic pull queues, replan — plans over fused units unchanged.
  Member tasks are re-costed with AMORTIZED per-task estimates (the
  CostModel learns a separate law for batched execution), and the batch's
  cost is their sum.
* :class:`CompileCache` is the process-wide program cache keyed on the
  batch's static-shape signature (padded structural maxima + batch size +
  data shape), with the reference's keys. PyTorch runs eagerly, so an entry
  is the per-signature program a family builds: the callable bound to that
  signature. The first batch of a
  signature builds it; later batches of the same shape reuse it — hit
  accounting surfaces in ``SearchStats``.
* :func:`split_for_balance` splits bottleneck batches at fuse-bucket
  boundaries so LPT/:func:`~repro_torch.core.scheduler.replan` can trade fusion
  efficiency against load balance (a fused batch is atomic on one executor).

Execution stays in the pools (executor.py): a FusedBatch runs as ONE device
program via ``Estimator.run_batched`` and is unbatched into per-task
``TaskResult``s, so Session streaming, the WAL, ``on_result`` and the
cost-model observer are untouched.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable, Hashable, Sequence

from repro_torch.core.interface import RungTask, TrainTask, get_estimator
from repro_torch.core.tenancy import TenantLedger

__all__ = [
    "FusedBatch",
    "CompileCache",
    "charge_carrier",
    "compile_cache",
    "fuse_tasks",
    "pad_pow2",
    "split_for_balance",
]


def pad_pow2(n: int) -> int:
    """Round a padded scan length up to the next power of two.

    Batched paths pad structural params (rounds / trees / steps) to the
    per-batch max; rounding that max to a power of two buckets the compile
    signature, so batches whose maxima differ only within a bucket share ONE
    compiled program (masking keeps the extra iterations inert). The price —
    at most 2× masked scan length, 1.33× expected — buys the ≥90% cache hit
    rate that makes fusion pay off on compile-bound populations.
    """
    return 1 << max(0, int(n) - 1).bit_length()


def pad_configs(configs: Sequence) -> tuple[list, int]:
    """Pad a config stack to a power-of-two length by replicating the last
    config; returns ``(padded, n_real)`` and the caller discards outputs past
    ``n_real``. This buckets the BATCH axis of the compile signature the same
    way ``pad_pow2`` buckets scan lengths: a WAL-restricted 13-member batch
    or a bucket-split piece pads to 16 and reuses the full-width program
    instead of compiling a fresh one per odd size.
    """
    n = len(configs)
    target = pad_pow2(n)
    return list(configs) + [configs[-1]] * (target - n), n


@dataclasses.dataclass(frozen=True)
class FusedBatch:
    """One schedulable unit of same-family tasks trained as a single program.

    Duck-types the slice of ``TrainTask`` the scheduler touches: ``task_id``
    (synthetic, negative — derived from the smallest member id so it is
    stable across re-plans and never collides with real task ids), ``cost``
    (estimated seconds for the WHOLE batch on one executor) and
    ``with_cost``. ``buckets`` parallels ``tasks`` and marks the structural
    fuse-bucket of each member; :meth:`split_at_buckets` cuts along it.
    """

    tasks: tuple[TrainTask, ...]
    signature: tuple
    buckets: tuple[Hashable, ...]
    cost: float | None = None
    #: each member's cost BEFORE the amortized (batched-law) re-estimate —
    #: restored when a split strands a member back into sequential execution,
    #: so LPT and the sequential obs/est ratio see a solo-cost estimate, not
    #: the amortized one. Empty = members were never re-costed.
    prior_costs: tuple = ()

    def __post_init__(self):
        if not self.tasks:
            raise ValueError("a FusedBatch needs at least one task")
        if len(self.buckets) != len(self.tasks):
            raise ValueError("buckets must parallel tasks")
        if self.prior_costs and len(self.prior_costs) != len(self.tasks):
            raise ValueError("prior_costs must parallel tasks")

    @property
    def estimator(self) -> str:
        return self.tasks[0].estimator

    @property
    def batch_size(self) -> int:
        return len(self.tasks)

    @property
    def task_id(self) -> int:
        return -1 - min(t.task_id for t in self.tasks)

    def with_cost(self, cost: float) -> "FusedBatch":
        return dataclasses.replace(self, cost=float(cost))

    def member_ids(self) -> set[int]:
        return {t.task_id for t in self.tasks}

    def _prior_of(self, i: int):
        return self.prior_costs[i] if self.prior_costs else self.tasks[i].cost

    def unfused_task(self, i: int = 0) -> TrainTask:
        """Member ``i`` as a standalone sequential task, its pre-amortization
        cost restored (a stranded singleton runs solo, so scheduling and the
        CostModel's sequential ratio must see the solo estimate)."""
        t = self.tasks[i]
        prior = self._prior_of(i)
        return t if prior == t.cost else dataclasses.replace(t, cost=prior)

    def singletons(self) -> "list[TrainTask]":
        """Every member as a standalone sequential task (pre-amortization
        costs restored) — a tainted batch re-queues this way so a poison
        member isolates instead of re-killing whole batches (§3.7)."""
        return [self.unfused_task(i) for i in range(len(self.tasks))]

    def restrict(self, keep_ids) -> "FusedBatch | None":
        """The sub-batch of members still pending, or None if none are."""
        kept = [i for i, t in enumerate(self.tasks) if t.task_id in keep_ids]
        if not kept:
            return None
        tasks = tuple(self.tasks[i] for i in kept)
        return dataclasses.replace(
            self, tasks=tasks, buckets=tuple(self.buckets[i] for i in kept),
            prior_costs=tuple(self._prior_of(i) for i in kept),
            cost=_sum_costs(tasks))

    def recost(self, fn, prior_fn=None) -> "FusedBatch":
        """Member-wise re-estimate (``fn(task) -> task``), buckets kept and
        the batch cost re-summed — the replan path's refresh. ``prior_fn``
        (``task -> cost | None``) rebuilds ``prior_costs`` alongside;
        without it the stored priors are kept, which is only correct when
        they are still fresh — a caller that re-applies per-member charges
        after recosting (the Session's eval charge) MUST pass it, or each
        replan would compound another charge into the priors."""
        tasks = tuple(fn(t) for t in self.tasks)
        priors = (tuple(prior_fn(t) for t in self.tasks)
                  if prior_fn is not None else self.prior_costs)
        return dataclasses.replace(self, tasks=tasks, prior_costs=priors,
                                   cost=_sum_costs(tasks))

    def charge_member(self, extra: float) -> "FusedBatch":
        """Add a one-time cost (conversion-aware costing, §3.3) to the
        MAX-cost member (ties: lowest task_id). Charging a member — not the
        batch — survives every cost-resumming operation (``restrict``,
        ``split_at_buckets``), so a conversion charge is not silently
        dropped when the scheduler splits the bottleneck batch; and it is
        the same member the executors attach the actual build's
        ``convert_seconds`` to, keeping the drift window's estimated and
        observed sides aligned."""
        i = charge_carrier(self.tasks)
        tasks = list(self.tasks)
        tasks[i] = tasks[i].with_cost((tasks[i].cost or 0.0) + extra)
        tasks = tuple(tasks)
        return dataclasses.replace(self, tasks=tasks, cost=_sum_costs(tasks))

    def charge_each(self, extra_fn) -> "FusedBatch":
        """Add a RECURRING per-member cost (eval-aware costing, §3.4) to
        every member AND its pre-amortization prior — unlike the one-time
        :meth:`charge_member` conversion charge, every member pays its own
        eval, and updating ``prior_costs`` too means a stranded singleton's
        restored solo cost still includes scoring. Members without a cost
        estimate are skipped (a charge on top of nothing would masquerade
        as a full estimate). ``extra_fn(task) -> float | None``."""
        extras = [extra_fn(t) or 0.0 for t in self.tasks]
        tasks = tuple(
            t.with_cost(t.cost + e) if t.cost is not None and e > 0 else t
            for t, e in zip(self.tasks, extras))
        priors = tuple(
            (p + e) if p is not None and e > 0 else p
            for p, e in zip((self._prior_of(i) for i in range(len(self.tasks))),
                            extras))
        return dataclasses.replace(self, tasks=tasks, prior_costs=priors,
                                   cost=_sum_costs(tasks))

    def split_at_buckets(self) -> "list[FusedBatch]":
        """Split into one batch per distinct structural bucket (batch-aware
        rebalancing). A single-bucket batch returns ``[self]`` — bucket
        boundaries are the only sanctioned cut points, because members of one
        bucket share padded shapes and splitting them buys no balance that a
        smaller ``max_fuse`` would not."""
        groups: dict[Hashable, list[int]] = {}
        for i, b in enumerate(self.buckets):
            groups.setdefault(b, []).append(i)
        if len(groups) <= 1:
            return [self]
        out = []
        for members in groups.values():
            tasks = tuple(self.tasks[i] for i in members)
            out.append(FusedBatch(
                tasks=tasks, signature=self.signature,
                buckets=tuple(self.buckets[i] for i in members),
                prior_costs=tuple(self._prior_of(i) for i in members),
                cost=_sum_costs(tasks)))
        return out


def _sum_costs(tasks: Sequence[TrainTask]) -> float | None:
    known = [t.cost for t in tasks if t.cost is not None]
    return sum(known) if known else None


def charge_carrier(tasks: Sequence[TrainTask]) -> int:
    """Index of the member that carries one-time (conversion) charges and,
    on the executor side, reports the actual build's ``convert_seconds``:
    max cost, ties broken by lowest task_id — deterministic, so the planner
    and the pools agree on who pays."""
    return max(range(len(tasks)),
               key=lambda i: ((tasks[i].cost or 0.0), -tasks[i].task_id))


# --------------------------------------------------------------------------
# Compile cache.
# --------------------------------------------------------------------------

#: Nominal resident size charged per cached program when the caller gives no
#: measured ``nbytes``. Compiled callables don't expose their executable +
#: constant footprint portably, so budget enforcement needs a proxy weight;
#: 1 MiB makes ``budget_bytes`` read as "roughly N programs".
DEFAULT_PROGRAM_NBYTES = 1 << 20


class CompileCache:
    """Process-wide cache of batched programs, keyed on the static shape
    signature. ``get`` returns the cached callable or builds (and counts a
    miss for) a new one; a hit reuses the SAME program object.
    ``build_seconds`` sums the builders' wall
    time: what the hits saved, a miss at a time.

    Governance mirrors :class:`repro_torch.core.data_format.PreparedDataCache`
    (DESIGN.md §3.5): an optional byte budget with LRU eviction (entries
    weigh ``nbytes`` when the builder's caller knows it, else
    :data:`DEFAULT_PROGRAM_NBYTES`), pin/unpin refcounts, and per-tenant
    hit/miss/bytes ledgers updated in the same critical sections as the
    global counters. No in-flight de-dup: racing builders both compile and
    the first insert wins — same semantics as before, and the loser's bytes
    are NOT charged (its program is dropped on the floor)."""

    def __init__(self, *, name: str = "compile",
                 budget_bytes: int | None = None):
        self.name = name
        self._fns: OrderedDict[Hashable, tuple[Callable, int]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_built = 0
        self.build_seconds = 0.0
        self._bytes = 0
        self._budget = budget_bytes
        self._pins: dict[Hashable, int] = {}
        self._ledger = TenantLedger()

    def get(self, key: Hashable, builder: Callable[[], Callable], *,
            nbytes: int | None = None) -> Callable:
        with self._lock:
            got = self._fns.get(key)
            if got is not None:
                self.hits += 1
                self._ledger.add("hits")
                self._fns.move_to_end(key)
                return got[0]
            self.misses += 1
            self._ledger.add("misses")
        t0 = time.perf_counter()
        built = builder()          # build outside the lock: builds may be slow
        weight = int(nbytes) if nbytes is not None else DEFAULT_PROGRAM_NBYTES
        with self._lock:
            self.build_seconds += time.perf_counter() - t0
            got = self._fns.get(key)
            if got is not None:    # lost the insert race; keep the first
                return got[0]
            self._fns[key] = (built, weight)
            self._bytes += weight
            self.bytes_built += weight
            self._ledger.add("bytes", weight)
            self._evict_locked(keep=key)
            return built

    def _evict_locked(self, keep: Hashable = None) -> None:
        if self._budget is None:
            return
        while self._bytes > self._budget:
            victim = next((k for k in self._fns
                           if k != keep and not self._pins.get(k)), None)
            if victim is None:
                return
            _, weight = self._fns.pop(victim)
            self._bytes -= weight
            self.evictions += 1

    def pin(self, key: Hashable) -> None:
        with self._lock:
            self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key: Hashable) -> None:
        with self._lock:
            n = self._pins.get(key, 0) - 1
            if n <= 0:
                self._pins.pop(key, None)
            else:
                self._pins[key] = n
            self._evict_locked()

    def set_budget(self, budget_bytes: int | None) -> None:
        with self._lock:
            self._budget = budget_bytes
            self._evict_locked()

    @property
    def budget_bytes(self) -> int | None:
        with self._lock:
            return self._budget

    def contains(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._fns

    def counters(self) -> tuple[int, int]:
        with self._lock:
            return self.hits, self.misses

    def tenant_counters(self) -> dict[str, dict[str, float]]:
        """Per-tenant ``{"hits", "misses", "bytes"}`` — sums exactly to the
        globals; see :class:`repro_torch.core.tenancy.TenantLedger`."""
        with self._lock:
            return self._ledger.snapshot()

    @property
    def n_entries(self) -> int:
        with self._lock:
            return len(self._fns)

    @property
    def bytes_cached(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def hit_rate(self) -> float:
        hits, misses = self.counters()
        total = hits + misses
        return hits / total if total else 0.0

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0
            self.bytes_built = 0
            self.build_seconds = 0.0
            self._bytes = 0
            self._pins.clear()
            self._ledger.clear()


_GLOBAL_CACHE = CompileCache()


def compile_cache() -> CompileCache:
    """The process-wide cache shared by every estimator's batched path."""
    return _GLOBAL_CACHE


# --------------------------------------------------------------------------
# Grouping.
# --------------------------------------------------------------------------

def _amortized(task: TrainTask, cost_model, n_rows: int) -> TrainTask:
    """Re-cost a member with the CostModel's batched (amortized) law; the
    sequential estimate is the conservative fallback before any fused batch
    of the family has been observed."""
    if cost_model is None:
        return task
    est = cost_model.estimate(task, n_rows, batched=True)
    return task.with_cost(est) if est is not None and est > 0 else task


def fuse_tasks(
    tasks: Sequence[TrainTask],
    *,
    max_fuse: int = 16,
    cost_model=None,
    n_rows: int = 0,
) -> list:
    """Pack tasks into fused units; unfusable tasks pass through unchanged.

    Tasks are grouped by ``(estimator, Estimator.fuse_signature, resolved
    format_params)`` — the last guards the prepared-data plane (§3.3): a
    fused batch converts its data ONCE, so members must agree on the
    converter kwargs even when an estimator's ``fuse_signature`` forgets to
    capture a format-bearing hyperparameter. Groups are sorted inside by
    structural ``fuse_bucket`` (so a batch pads over near-equal shapes,
    keeping masked waste small) then by ``task_id`` (so chunking is
    deterministic and re-fusing the same pending set yields the same units),
    and chunked into batches of at most ``max_fuse``. A chunk of one is
    returned as the bare task — fusing a singleton buys nothing.

    Returns a mixed list of ``TrainTask`` and :class:`FusedBatch` that any
    ``scheduler.schedule*`` policy accepts directly.
    """
    if max_fuse < 2:
        raise ValueError(f"max_fuse must be >= 2, got {max_fuse}")
    groups: dict[tuple, list[tuple[TrainTask, Hashable]]] = {}
    passthrough: list[tuple[int, TrainTask]] = []
    order: dict[tuple, int] = {}
    from repro_torch.core.data_format import format_key

    for i, t in enumerate(tasks):
        if isinstance(t, RungTask):
            # rung tasks run solo: the batched trainer can neither consume a
            # carried ResumeState nor produce one per member (§3.6), and a
            # promoted rung's warm resume beats amortized batching anyway
            passthrough.append((i, t))
            continue
        est = get_estimator(t.estimator)
        sig = est.fuse_signature(t.params)
        if sig is None:
            passthrough.append((i, t))
            continue
        key = (t.estimator, sig,
               format_key(est.data_format, est.format_params(dict(t.params))))
        order.setdefault(key, i)
        groups.setdefault(key, []).append((t, est.fuse_bucket(t.params)))
    units: list[tuple[int, object]] = list(passthrough)
    for key, members in groups.items():
        # sort by the bucket VALUE (estimators return like-typed tuples
        # within a family, so they compare numerically) — repr() would order
        # (128,) before (16,), straddling chunks across distant shapes
        members.sort(key=lambda tb: (tb[1], tb[0].task_id))
        for at in range(0, len(members), max_fuse):
            chunk = members[at:at + max_fuse]
            if len(chunk) == 1:
                units.append((order[key], chunk[0][0]))
                continue
            fused = tuple(_amortized(t, cost_model, n_rows) for t, _ in chunk)
            units.append((order[key], FusedBatch(
                tasks=fused, signature=key,
                buckets=tuple(b for _, b in chunk),
                prior_costs=tuple(t.cost for t, _ in chunk),
                cost=_sum_costs(fused))))
    units.sort(key=lambda iu: iu[0])        # keep the caller's task order
    return [u for _, u in units]


def split_for_balance(units: Sequence, n_executors: int) -> list:
    """Split bottleneck fused batches at bucket boundaries until no
    splittable batch exceeds the ideal per-executor load.

    A fused batch is atomic on one executor; when its estimated cost is
    larger than ``total / n_executors`` it IS the makespan floor, so trading
    some fusion efficiency for schedulable pieces is the right call — this
    is the scheduler-facing half of batch-aware planning, used both at
    initial planning and by the Session's replan path.
    """
    if n_executors <= 0:
        raise ValueError("n_executors must be positive")
    out = list(units)
    while True:
        costs = [getattr(u, "cost", None) or 0.0 for u in out]
        total = sum(costs)
        if total <= 0:
            return out
        ideal = total / n_executors
        splittable = [
            (c, i) for i, (u, c) in enumerate(zip(out, costs))
            if c > ideal and isinstance(u, FusedBatch)
            and len(set(u.buckets)) > 1
        ]
        if not splittable:
            return out
        _, i = max(splittable)
        # singleton pieces degrade to bare tasks (with their solo cost
        # restored) — a one-config vmap buys nothing and would still pay
        # its own compile signature
        out[i:i + 1] = [p.unfused_task() if p.batch_size == 1 else p
                        for p in out[i].split_at_buckets()]
