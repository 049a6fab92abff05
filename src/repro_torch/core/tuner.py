"""Hyperparameter Tuner module (paper §III-A, §IV-B).

Static tuners (grid, random) generate the full set of model configurations up
front — the mode the paper evaluates. Dynamic tuners (the paper's §IV-B
extension point) consume streamed results and propose new work; the shipped
example is :class:`AshaController` — asynchronous successive halving over
resumable rungs (DESIGN.md §3.6), grounded in Tune's trial-scheduler design.

Protocol (this release): ``suggest(budget) -> list[TrainTask]`` /
``report(TaskResult)``. The Session calls ``report`` per streamed result —
typed, carrying score/eval_seconds/resume_state — and ``suggest`` at round
boundaries with the remaining task allowance as a hint. The pre-rung
``propose()``/``observe(pairs)`` surface survives one release as a
deprecation shim in both directions: legacy subclasses keep working under
the new Session (buffered results are flushed through their ``observe``),
and legacy callers of ``propose``/``observe`` are forwarded with a warning.
"""
from __future__ import annotations

import abc
import math
import random as _random
import warnings
from typing import Any, Mapping, Sequence

from repro_torch.core.grid import SearchSpace, enumerate_tasks
from repro_torch.core.interface import ResumeState, RungTask, TaskResult, TrainTask

__all__ = [
    "Tuner",
    "GridSearchTuner",
    "RandomSearchTuner",
    "AshaController",
    "SuccessiveHalvingTuner",
    "SurrogateTuner",
    "TUNER_KINDS",
    "make_tuner",
]


class Tuner(abc.ABC):
    """Produces batches of tasks; consumes streamed results between batches.

    Subclasses implement :meth:`suggest`/:meth:`report`. A pre-rung subclass
    that still overrides ``propose``/``observe`` is bridged automatically:
    ``suggest`` flushes buffered results through its ``observe`` and returns
    its ``propose``.
    """

    def suggest(self, budget: int | None = None) -> list[TrainTask]:
        """Next batch of tasks ([] = done). ``budget`` is an advisory hint —
        the caller's remaining task allowance; tuners may cap their batch to
        it and re-emit the remainder on the next call."""
        if type(self).propose is not Tuner.propose:   # legacy subclass
            warnings.warn(
                f"{type(self).__name__} implements the deprecated Tuner "
                "propose()/observe() protocol; implement suggest()/report() "
                "(one-release shim)", DeprecationWarning, stacklevel=2)
            buf = getattr(self, "_legacy_buffer", None)
            if buf:
                self._legacy_buffer = []
                self.observe([(r.task, r.score) for r in buf
                              if r.ok and r.score is not None])
            return self.propose()
        raise NotImplementedError(
            f"{type(self).__name__} implements neither suggest() nor propose()")

    def report(self, result: TaskResult) -> None:
        """Feed back one streamed result. Static tuners ignore this; a
        legacy subclass gets it buffered until the next :meth:`suggest`."""
        if type(self).observe is not Tuner.observe:   # legacy subclass
            if getattr(self, "_legacy_buffer", None) is None:
                self._legacy_buffer: list[TaskResult] = []
            self._legacy_buffer.append(result)

    @property
    def is_dynamic(self) -> bool:
        return False

    # -- deprecated pre-rung surface (one release) ------------------------
    def propose(self) -> list[TrainTask]:
        """Deprecated: use :meth:`suggest`."""
        warnings.warn("Tuner.propose() is deprecated; use suggest()",
                      DeprecationWarning, stacklevel=2)
        return self.suggest()

    def observe(self, results: Sequence[tuple[TrainTask, float]]) -> None:
        """Deprecated: use :meth:`report` with the streamed TaskResult."""
        warnings.warn(
            "Tuner.observe(pairs) is deprecated; use report(TaskResult)",
            DeprecationWarning, stacklevel=2)
        for task, score in results:
            self.report(TaskResult(task=task, model=None, train_seconds=0.0,
                                   executor_id=-1, score=float(score)))


class GridSearchTuner(Tuner):
    """The paper's default: every grid point, one shot."""

    def __init__(self, spaces: Sequence[SearchSpace]):
        self._tasks = enumerate_tasks(spaces)
        self._done = False

    def suggest(self, budget: int | None = None) -> list[TrainTask]:
        del budget
        if self._done:
            return []
        self._done = True
        return list(self._tasks)


class RandomSearchTuner(Tuner):
    """Bergstra & Bengio random search over the union of the grids."""

    def __init__(self, spaces: Sequence[SearchSpace], n_samples: int, seed: int = 0):
        all_tasks = enumerate_tasks(spaces)
        rng = _random.Random(seed)
        n = min(n_samples, len(all_tasks))
        self._tasks = rng.sample(all_tasks, n)
        self._done = False

    def suggest(self, budget: int | None = None) -> list[TrainTask]:
        del budget
        if self._done:
            return []
        self._done = True
        return list(self._tasks)


def _per_estimator(value: int | Mapping[str, int], estimator: str,
                   what: str) -> int:
    if isinstance(value, Mapping):
        try:
            return int(value[estimator])
        except KeyError:
            raise ValueError(f"{what} mapping has no entry for estimator "
                             f"{estimator!r}") from None
    return int(value)


class AshaController(Tuner):
    """Asynchronous successive halving over resumable rungs (DESIGN.md §3.6).

    Every config starts at ``base_budget`` (in ``budget_param`` units — the
    estimator's declared :attr:`~repro_torch.core.interface.Estimator.budget_param`
    when not given); each rung multiplies the budget by ``eta``, clamped at
    ``max_budget``. When a rung's scores come back, the top
    ``ceil(issued / eta)`` configs are promoted to the next rung as
    :class:`RungTask`s carrying the previous rung's
    :class:`~repro_torch.core.interface.ResumeState`, so a promotion trains only
    the INCREMENT. Everything else is never scheduled again — that is where
    the makespan goes.

    ``base_budget``/``max_budget`` take an int (uniform) or a per-estimator
    mapping, so one controller can ladder a mixed-family grid.

    ``early_kill`` (optional, fraction in (0, 1]) arms mid-flight kills: once
    that fraction of a rung's issued tasks have reported scores, the still-
    running rest are declared moot — :meth:`kill_candidates` hands their ids
    to the Session, which cancels them through the existing replan path. A
    late straggler that completes anyway is un-killed and competes normally.
    Default off: promotion order is then deterministic (rung barriers).
    """

    def __init__(
        self,
        spaces: Sequence[SearchSpace],
        budget_param: str | Mapping[str, str] | None = None,
        base_budget: int | Mapping[str, int] | None = None,
        max_budget: int | Mapping[str, int] | None = None,
        eta: int = 3,
        early_kill: float | None = None,
    ):
        if base_budget is None or max_budget is None:
            raise ValueError("AshaController requires base_budget and max_budget")
        if int(eta) < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        if early_kill is not None and not (0.0 < float(early_kill) <= 1.0):
            raise ValueError(f"early_kill must be in (0, 1], got {early_kill}")
        self._configs = enumerate_tasks(spaces)
        if not self._configs:
            raise ValueError("AshaController over an empty search space")
        self._eta = int(eta)
        self._early_kill = None if early_kill is None else float(early_kill)
        self._n = len(self._configs)
        self._id0 = max(t.task_id for t in self._configs) + 1
        # resolve + validate per estimator NOW (SearchSpec construction-time
        # validation rides on this): unknown estimator, missing budget_param,
        # or a bad ladder all fail before any training is scheduled
        self._bp: dict[str, str] = {}
        self._base: dict[str, int] = {}
        self._max: dict[str, int] = {}
        for t in self._configs:
            if t.estimator in self._bp:
                continue
            self._bp[t.estimator] = self._resolve_bp(budget_param, t.estimator)
            base = _per_estimator(base_budget, t.estimator, "base_budget")
            cap = _per_estimator(max_budget, t.estimator, "max_budget")
            if base < 1 or cap < 1:
                raise ValueError(f"budgets must be >= 1 (estimator "
                                 f"{t.estimator!r}: base {base}, max {cap})")
            self._base[t.estimator] = min(base, cap)
            self._max[t.estimator] = cap
        # per-rung bookkeeping, grown as rungs open
        self._issued: list[set[int]] = []
        self._completed: list[dict[int, float]] = []
        self._promoted: list[set[int]] = []
        self._killed: list[set[int]] = []
        self._meta: dict[int, tuple[int, int]] = {}   # task_id -> (config, rung)
        self._states: dict[int, ResumeState] = {}     # config -> latest carryover
        self._retired: set[int] = set()               # finished, errored or killed

    @staticmethod
    def _resolve_bp(budget_param, estimator: str) -> str:
        if isinstance(budget_param, str) and budget_param:
            return budget_param
        if isinstance(budget_param, Mapping):
            try:
                return str(budget_param[estimator])
            except KeyError:
                raise ValueError(f"budget_param mapping has no entry for "
                                 f"estimator {estimator!r}") from None
        from repro_torch.core.interface import get_estimator

        bp = get_estimator(estimator).budget_param
        if not bp:
            raise ValueError(
                f"estimator {estimator!r} declares no budget_param; pass "
                "budget_param= to the asha tuner")
        return bp

    @property
    def is_dynamic(self) -> bool:
        return True

    # -- ladder -----------------------------------------------------------
    def _rung_budget(self, estimator: str, rung: int) -> int:
        b = self._base[estimator]
        for _ in range(rung):
            b = min(self._max[estimator], b * self._eta)
        return b

    def _tid(self, config: int, rung: int) -> int:
        # deterministic across restarts: the WAL identifies rungs by id
        return self._id0 + rung * self._n + config

    def _make_task(self, config: int, rung: int) -> RungTask:
        cfg = self._configs[config]
        bp = self._bp[cfg.estimator]
        budget = self._rung_budget(cfg.estimator, rung)
        prev = self._rung_budget(cfg.estimator, rung - 1) if rung else 0
        params = dict(cfg.params)
        params[bp] = budget
        return RungTask(task_id=self._tid(config, rung), estimator=cfg.estimator,
                        params=params, config_id=config, rung=rung,
                        budget=budget, prev_budget=prev, budget_param=bp,
                        state=self._states.get(config))

    def _ensure_rung(self, rung: int) -> None:
        while len(self._issued) <= rung:
            self._issued.append(set())
            self._completed.append({})
            self._promoted.append(set())
            self._killed.append(set())

    # -- protocol ---------------------------------------------------------
    def suggest(self, budget: int | None = None) -> list[TrainTask]:
        self._ensure_rung(0)
        candidates: list[tuple[int, int]] = []       # (config, rung)
        for idx in range(self._n):
            if idx not in self._issued[0] and idx not in self._retired:
                candidates.append((idx, 0))
        for r in range(len(self._completed)):
            comp = self._completed[r]
            if not comp:
                continue
            quota = max(1, math.ceil(len(self._issued[r]) / self._eta))
            ranked = sorted(comp.items(), key=lambda kv: (-kv[1], kv[0]))
            for idx, _score in ranked[:quota]:
                if idx in self._promoted[r] or idx in self._retired:
                    continue
                est = self._configs[idx].estimator
                if self._rung_budget(est, r + 1) <= self._rung_budget(est, r):
                    # at the cap: this config's ladder is complete
                    self._promoted[r].add(idx)
                    self._retired.add(idx)
                    continue
                candidates.append((idx, r + 1))
        if budget is not None:
            candidates = candidates[:max(0, int(budget))]
        out = []
        for idx, rung in candidates:
            self._ensure_rung(rung)
            if rung > 0:
                self._promoted[rung - 1].add(idx)
            t = self._make_task(idx, rung)
            self._issued[rung].add(idx)
            self._meta[t.task_id] = (idx, rung)
            out.append(t)
        return out

    def report(self, result: TaskResult) -> None:
        meta = self._meta.get(result.task.task_id)
        if meta is None:
            return
        idx, rung = meta
        self._ensure_rung(rung)
        if not result.ok or result.score is None:
            self._retired.add(idx)
            return
        if idx in self._killed[rung]:      # straggler beat the kill: un-kill
            self._killed[rung].discard(idx)
            self._retired.discard(idx)
        self._completed[rung][idx] = float(result.score)
        st = getattr(result, "resume_state", None)
        if st is not None:
            self._states[idx] = st

    def kill_candidates(self) -> set[int]:
        """Task ids of in-flight rung members declared moot (``early_kill``);
        the caller cancels them via its replan path. Idempotent — a config is
        killed once, and a kill is revoked if its result arrives anyway."""
        if self._early_kill is None:
            return set()
        out: set[int] = set()
        for r, issued in enumerate(self._issued):
            pending = {i for i in issued
                       if i not in self._completed[r]
                       and i not in self._killed[r] and i not in self._retired}
            if not pending:
                continue
            if len(self._completed[r]) >= math.ceil(self._early_kill * len(issued)):
                for idx in pending:
                    self._killed[r].add(idx)
                    self._retired.add(idx)
                    out.add(self._tid(idx, r))
        return out


class SuccessiveHalvingTuner(AshaController):
    """Successive halving with rung barriers — :class:`AshaController` with
    mid-flight kills off and the historical positional signature.

    (Bugfix note: the pre-rung implementation of this class re-emitted plain
    ``TrainTask``s each rung, silently retraining every survivor from
    scratch at the full absolute budget and duplicating the ladder
    bookkeeping; it now inherits the RungTask/``train_resumable`` path, so a
    promotion trains only the increment.)
    """

    def __init__(
        self,
        spaces: Sequence[SearchSpace],
        budget_param: str,
        base_budget: int,
        max_budget: int,
        eta: int = 3,
    ):
        super().__init__(spaces, budget_param=budget_param,
                         base_budget=base_budget, max_budget=max_budget,
                         eta=eta, early_kill=None)


class SurrogateTuner(Tuner):
    """Cheap Bayesian-flavoured proposer (dynamic tuner example #2).

    Maintains per-(estimator, param, value) mean scores and proposes the
    unevaluated grid points with the highest optimistic estimate
    (mean + exploration bonus) — a discrete UCB over the grid. Stands in for
    the paper's "Bayesian optimization" plug-in without an external GP dep.
    """

    def __init__(self, spaces: Sequence[SearchSpace], batch_size: int = 16, rounds: int = 8, c: float = 0.3, seed: int = 0):
        self._all = enumerate_tasks(spaces)
        self._remaining = {t.task_id: t for t in self._all}
        self._batch = batch_size
        self._rounds = rounds
        self._c = c
        self._rng = _random.Random(seed)
        self._stats: dict[tuple[str, str, Any], list[float]] = {}
        self._round = 0

    @property
    def is_dynamic(self) -> bool:
        return True

    def _score(self, task: TrainTask) -> float:
        vals, n = 0.0, 0
        for k, v in task.params.items():
            s = self._stats.get((task.estimator, k, v))
            if s:
                vals += sum(s) / len(s)
                n += 1
        if n == 0:
            return float("inf")  # unexplored region → explore first
        return vals / n + self._c / math.sqrt(n)

    def suggest(self, budget: int | None = None) -> list[TrainTask]:
        del budget
        if self._round >= self._rounds or not self._remaining:
            return []
        self._round += 1
        cands = list(self._remaining.values())
        self._rng.shuffle(cands)  # tie-break randomly
        cands.sort(key=self._score, reverse=True)
        batch = cands[: self._batch]
        for t in batch:
            del self._remaining[t.task_id]
        return batch

    def report(self, result: TaskResult) -> None:
        if not result.ok or result.score is None:
            return
        for k, v in result.task.params.items():
            self._stats.setdefault((result.task.estimator, k, v), []).append(
                float(result.score))


#: declarative tuner registry — SearchSpec's ``tuner=`` strings resolve here
TUNER_KINDS: dict[str, type[Tuner]] = {
    "grid": GridSearchTuner,
    "random": RandomSearchTuner,
    "asha": AshaController,
    "surrogate": SurrogateTuner,
}


def make_tuner(kind: str, spaces: Sequence[SearchSpace], **kw) -> Tuner:
    try:
        cls = TUNER_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown tuner kind {kind!r}; known: {sorted(TUNER_KINDS)}"
        ) from None
    return cls(spaces, **kw)
