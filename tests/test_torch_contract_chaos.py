"""The JAX package's ``tests/test_chaos.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    Chaos suite for the fault plane (DESIGN.md §3.7).

    Every probabilistic scenario derives from the seeded, order-independent
    :func:`repro_torch.core.chaos.chaos_roll`, so a failure here replays exactly.
    CI sweeps ``CHAOS_SEED`` (0, 1, 2); locally any seed must pass.
"""
import os
import threading

import pytest

import repro_torch.tabular  # noqa: F401 — registers estimators
from repro_torch.core import (
    Estimator,
    ExecutorFailure,
    GridBuilder,
    SearchSpec,
    SearchWAL,
    Session,
    TrainedModel,
    enumerate_tasks,
    register_estimator,
    unregister_estimator,
)
from repro_torch.core.chaos import (
    ActiveChaos,
    ChaosTaskError,
    FaultPlan,
    chaos_roll,
    corrupt_json,
    tear_wal_tail,
)
from repro_torch.core.cost_model import CostModel
from repro_torch.core.data_format import PreparedDataCache
from repro_torch.core.evaluation import EvalPlan
from repro_torch.core.executor import LocalExecutorPool, MeshSliceExecutorPool
from repro_torch.core.fault import RetryLedger, WALRecord
from repro_torch.core.fusion import FusedBatch, fuse_tasks
from repro_torch.core.interface import RungTask
from repro_torch.core.scheduler import schedule
from repro_torch.serve.search_service import SearchService

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")

SEED = int(os.environ.get("CHAOS_SEED", "0"))

_NOSLEEP = lambda s: None  # noqa: E731 — retries/backoff pay nothing in tests


class _StubModel(TrainedModel):
    def predict_proba(self, x):
        import numpy as np
        return np.full((x.shape[0],), 0.5, dtype=np.float32)


class _FastEstimator(Estimator):
    name = "chaosfast"
    data_format = "dense_rows"

    def train(self, data, params):
        return _StubModel()

    def train_batched(self, data, configs, *, cache=None):
        return [_StubModel() for _ in configs]

    def fuse_signature(self, params):
        return ()


@pytest.fixture
def fast_estimator():
    register_estimator(_FastEstimator)
    yield _FastEstimator
    unregister_estimator("chaosfast")


def _tasks(n, estimator="chaosfast"):
    return enumerate_tasks(
        [GridBuilder(estimator).add_grid("i", list(range(n))).build()])


# ---------------------------------------------------------------------------
# The deterministic coin and plan-level determinism
# ---------------------------------------------------------------------------

def test_chaos_roll_is_deterministic_and_uniform():
    assert chaos_roll(SEED, 7, 1) == chaos_roll(SEED, 7, 1)
    assert chaos_roll(SEED, 7, 1) != chaos_roll(SEED, 7, 2)
    assert chaos_roll(SEED, 7, 1) != chaos_roll(SEED + 1, 7, 1)
    draws = [chaos_roll(SEED, t, a) for t in range(50) for a in range(1, 4)]
    assert all(0.0 <= d < 1.0 for d in draws)
    # roughly uniform: a pathological hash would cluster
    assert 0.2 < sum(draws) / len(draws) < 0.8


def test_fault_plan_decisions_independent_of_interleaving(higgs_small,
                                                          fast_estimator):
    """Two runs of the same plan on a 3-thread pool inject train faults
    into the SAME tasks — thread scheduling must not change decisions."""
    train, _ = higgs_small

    def run_once():
        chaos = FaultPlan(seed=SEED, task_failure_rate=0.4).build(_NOSLEEP)
        pool = LocalExecutorPool(3, failure_hook=chaos.hook,
                                 max_task_retries=3, retry_backoff=0.0)
        list(pool.submit(schedule(_tasks(12), 3, policy="dynamic"), train))
        return sorted((e[2], e[3]) for e in chaos.events if e[0] == "fault")

    assert run_once() == run_once()


# ---------------------------------------------------------------------------
# Bounded retry: recovery and exhaustion (tentpole i)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_injected_failure_recovers_within_retry_budget(higgs_small, kind,
                                                       fast_estimator):
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED, fail_tasks=frozenset({2}),
                      max_task_faults=2).build(_NOSLEEP)
    if kind == "local":
        pool = LocalExecutorPool(2, failure_hook=chaos.hook,
                                 max_task_retries=3, retry_backoff=0.0)
    else:
        pool = MeshSliceExecutorPool(
            slices=["s0", "s1"], failure_hook=chaos.hook,
            max_task_retries=3, retry_backoff=0.0)
    tasks = _tasks(6)
    results = list(pool.submit(schedule(tasks, 2, policy="dynamic"), train))
    assert sorted(r.task.task_id for r in results) == list(range(6))
    assert all(r.ok for r in results)
    by_id = {r.task.task_id: r for r in results}
    assert by_id[2].attempts == 3          # two injected faults + success
    assert all(by_id[i].attempts == 1 for i in range(6) if i != 2)
    assert all(pool.wal.is_done(t.task_id) for t in tasks)


@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_retry_exhaustion_is_terminal(higgs_small, kind, fast_estimator):
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED, fail_tasks=frozenset({1}),
                      max_task_faults=50).build(_NOSLEEP)
    if kind == "local":
        pool = LocalExecutorPool(2, failure_hook=chaos.hook,
                                 max_task_retries=2, retry_backoff=0.0)
    else:
        pool = MeshSliceExecutorPool(
            slices=["s0", "s1"], failure_hook=chaos.hook,
            max_task_retries=2, retry_backoff=0.0)
    results = list(pool.submit(schedule(_tasks(4), 2, policy="dynamic"),
                               train))
    assert sorted(r.task.task_id for r in results) == list(range(4))
    errs = [r for r in results if not r.ok]
    assert len(errs) == 1 and errs[0].task.task_id == 1
    assert errs[0].attempts == 3           # 1 initial + 2 retries, all burned
    assert "chaos" in errs[0].error
    assert not pool.wal.is_done(1)         # failures stay out of the WAL


def test_retry_backoff_is_capped_exponential():
    slept = []
    ledger = RetryLedger(max_task_retries=40, retry_backoff=0.05,
                         sleep=slept.append)
    for _ in range(12):
        assert ledger.should_retry(9)
        ledger.wait(9)
    assert slept[:4] == [0.05, 0.1, 0.2, 0.4]
    assert max(slept) == RetryLedger.BACKOFF_CAP
    assert slept == sorted(slept)          # monotone up to the cap


# ---------------------------------------------------------------------------
# Poison-task quarantine (tentpole i)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_poison_task_quarantined_within_threshold(higgs_small, kind,
                                                  fast_estimator):
    """A task that kills every executor that claims it is quarantined after
    at most poison_threshold deaths; every other task still completes."""
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED,
                      poison_tasks=frozenset({3})).build(_NOSLEEP)
    if kind == "local":
        pool = LocalExecutorPool(4, failure_hook=chaos.hook,
                                 poison_threshold=2, retry_backoff=0.0)
    else:
        pool = MeshSliceExecutorPool(
            slices=[f"s{i}" for i in range(4)], failure_hook=chaos.hook,
            poison_threshold=2, retry_backoff=0.0)
    results = list(pool.submit(schedule(_tasks(8), 4, policy="dynamic"),
                               train))
    assert sorted(r.task.task_id for r in results) == list(range(8))
    poisoned = [r for r in results if r.task.task_id == 3]
    assert len(poisoned) == 1 and poisoned[0].quarantined
    assert not poisoned[0].ok and "quarantined" in poisoned[0].error
    assert chaos.n_poison_kills <= 2       # quarantine bounded the damage
    assert all(r.ok for r in results if r.task.task_id != 3)


def test_scheduled_executor_death_requeues_on_survivors(higgs_small,
                                                        fast_estimator):
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED,
                      executor_deaths=((0, 2),)).build(_NOSLEEP)
    pool = LocalExecutorPool(3, failure_hook=chaos.hook, retry_backoff=0.0)
    results = list(pool.submit(schedule(_tasks(9), 3, policy="dynamic"),
                               train))
    assert chaos.n_deaths == 1
    assert pool.dead_executors == {0}
    assert sorted(r.task.task_id for r in results) == list(range(9))
    assert all(r.ok for r in results)


# ---------------------------------------------------------------------------
# Fused-batch bisection: good members are salvaged (tentpole i)
# ---------------------------------------------------------------------------

def test_fused_batch_bisection_salvages_good_members(higgs_small):
    """A batch whose fused train raises is bisected down to the culprit:
    good members surface ok, only the poison config carries the error."""
    train, _ = higgs_small

    class _FlakyBatch(Estimator):
        name = "flakybatch"
        data_format = "dense_rows"

        def train(self, data, params):
            if params.get("i") == 1:
                raise ChaosTaskError("poison config")
            return _StubModel()

        def train_batched(self, data, configs, *, cache=None):
            if any(p.get("i") == 1 for p in configs):
                raise ChaosTaskError("poison config in batch")
            return [_StubModel() for _ in configs]

        def fuse_signature(self, params):
            return ()

    register_estimator(_FlakyBatch)
    try:
        tasks = [t.with_cost(1.0) for t in _tasks(4, estimator="flakybatch")]
        units = fuse_tasks(tasks, max_fuse=4)
        assert len(units) == 1 and isinstance(units[0], FusedBatch)
        pool = LocalExecutorPool(1, retry_backoff=0.0)
        results = list(pool.submit(schedule(units, 1, policy="dynamic"),
                                   train))
        assert sorted(r.task.task_id for r in results) == list(range(4))
        bad = [r for r in results if not r.ok]
        assert [r.task.task_id for r in bad] == [1]
        assert all(r.ok for r in results if r.task.task_id != 1)
        assert all(pool.wal.is_done(i) for i in (0, 2, 3))
        assert not pool.wal.is_done(1)
    finally:
        unregister_estimator("flakybatch")


def test_fused_member_retries_solo_after_injected_batch_failure(
        higgs_small, fast_estimator):
    """A chaos hook failing a fused unit burns ONE attempt per member, and
    the members re-queue solo — the whole batch is not retrained."""
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED, fail_tasks=frozenset({0, 1, 2, 3}),
                      max_task_faults=1).build(_NOSLEEP)
    tasks = [t.with_cost(1.0) for t in _tasks(4)]
    units = fuse_tasks(tasks, max_fuse=4)
    assert len(units) == 1 and isinstance(units[0], FusedBatch)
    pool = LocalExecutorPool(2, failure_hook=chaos.hook,
                             max_task_retries=1, retry_backoff=0.0)
    results = list(pool.submit(schedule(units, 2, policy="dynamic"), train))
    assert sorted(r.task.task_id for r in results) == list(range(4))
    assert all(r.ok for r in results)
    assert all(r.attempts == 2 for r in results)
    # the solo re-runs rolled their own (per-task) chaos attempts
    assert all(chaos.faults_for(i) == 1 for i in range(4))


# ---------------------------------------------------------------------------
# Deadlines: soft (speculation) and hard (abandon-and-requeue) (tentpole ii)
# ---------------------------------------------------------------------------

def test_deadline_factor_drives_speculation(higgs_small, fast_estimator):
    """deadline_factor rides the speculation path: an overdue task is
    duplicated on an idle executor and the first completion wins."""
    train, _ = higgs_small
    hangs = {4}
    lock = threading.Lock()

    def hook(eid, task):
        with lock:
            first = task.task_id in hangs
            hangs.discard(task.task_id)
        if first:
            import time as _t
            _t.sleep(0.8)

    pool = LocalExecutorPool(2, failure_hook=hook, deadline_factor=3.0)
    tasks = [t.with_cost(0.01) for t in _tasks(6)]
    results = list(pool.submit(schedule(tasks, 2, policy="dynamic"), train))
    # first-completion-wins: exactly one result per config, duplicates dedup
    assert sorted(r.task.task_id for r in results) == list(range(6))
    assert all(r.ok for r in results)


def test_hard_timeout_abandons_and_requeues(higgs_small, fast_estimator):
    """First attempt hangs past the hard deadline: the unit is abandoned
    (the overrun feeds the observer as a censored timed_out observation)
    and the retry completes; the hung worker never blocks the stream."""
    train, _ = higgs_small
    hangs = {2}
    lock = threading.Lock()
    observed = []

    def hook(eid, task):
        with lock:
            first = task.task_id in hangs
            hangs.discard(task.task_id)
        if first:
            import time as _t
            _t.sleep(3.0)

    pool = LocalExecutorPool(2, failure_hook=hook, task_timeout_seconds=0.3,
                             max_task_retries=1, retry_backoff=0.0,
                             on_result=observed.append)
    results = list(pool.submit(schedule(_tasks(5), 2, policy="dynamic"),
                               train))
    assert sorted(r.task.task_id for r in results) == list(range(5))
    assert all(r.ok for r in results)
    # the censored overrun reached the observer, flagged timed_out
    timeouts = [r for r in observed if r.timed_out]
    assert timeouts and timeouts[0].task.task_id == 2
    assert timeouts[0].train_seconds >= 0.3


def test_hard_timeout_exhaustion_is_terminal_timed_out(higgs_small,
                                                       fast_estimator):
    """A task that hangs on every attempt surfaces as a terminal timed_out
    error result — the stream finishes despite the hung workers."""
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED, hang_tasks={1: 5.0}).build()
    pool = LocalExecutorPool(2, failure_hook=chaos.hook,
                             task_timeout_seconds=0.3, max_task_retries=1,
                             retry_backoff=0.0)
    results = list(pool.submit(schedule(_tasks(4), 2, policy="dynamic"),
                               train))
    assert sorted(r.task.task_id for r in results) == list(range(4))
    bad = [r for r in results if not r.ok]
    assert len(bad) == 1 and bad[0].task.task_id == 1
    assert bad[0].timed_out and "deadline" in bad[0].error
    assert all(r.ok for r in results if r.task.task_id != 1)


def test_timed_out_overrun_feeds_cost_model():
    """CostModel.observe_result treats a timed_out failure as a censored
    runtime observation — the estimate that missed stops being trusted."""
    from repro_torch.core.interface import TaskResult, TrainTask
    cm = CostModel(None)
    t = TrainTask(task_id=0, estimator="gbdt", params={"round": 5})
    cm.observe_result(TaskResult(task=t, model=None, train_seconds=2.5,
                                 executor_id=0, error="deadline",
                                 timed_out=True), n_rows=1000)
    assert cm.n_observed == 1
    # a plain failure still contributes nothing
    cm.observe_result(TaskResult(task=t, model=None, train_seconds=0.0,
                                 executor_id=0, error="boom"), n_rows=1000)
    assert cm.n_observed == 1


# ---------------------------------------------------------------------------
# Storage faults: torn WAL tail (satellite 1), corrupt cost model (satellite 2)
# ---------------------------------------------------------------------------

def test_torn_wal_tail_skips_last_record_with_warning(tmp_path):
    path = str(tmp_path / "wal.jsonl")
    wal = SearchWAL(path)
    for i in range(3):
        wal.record(WALRecord(task_id=i, key=f"k{i}", seconds=1.0,
                             executor_id=0))
    assert tear_wal_tail(path) > 0
    with pytest.warns(RuntimeWarning, match="corrupt record"):
        reopened = SearchWAL(path)
    # the torn record re-runs; the committed prefix survives
    assert sorted(reopened.completed()) == [0, 1]


def test_torn_resume_line_skipped_with_warning(tmp_path):
    path = str(tmp_path / "wal.jsonl")
    wal = SearchWAL(path)
    wal.record(WALRecord(task_id=0, key="k0", seconds=1.0, executor_id=0))
    with open(path, "a") as f:  # torn mid-append resume record
        f.write('{"kind": "resume", "task_id": 1, "state": {"bud')
    with pytest.warns(RuntimeWarning, match="corrupt record"):
        reopened = SearchWAL(path)
    assert sorted(reopened.completed()) == [0]
    assert reopened.resume_state(1) is None


def test_wal_garbage_line_mid_file_skipped(tmp_path):
    path = str(tmp_path / "wal.jsonl")
    wal = SearchWAL(path)
    wal.record(WALRecord(task_id=0, key="k0", seconds=1.0, executor_id=0))
    with open(path, "a") as f:  # garbage line, then a valid record after it
        import dataclasses as _dc
        import json as _json
        f.write("not json at all\n")
        f.write(_json.dumps(_dc.asdict(
            WALRecord(task_id=2, key="k2", seconds=1.0, executor_id=1))) + "\n")
    with pytest.warns(RuntimeWarning, match="corrupt record"):
        reopened = SearchWAL(path)
    assert sorted(reopened.completed()) == [0, 2]


def test_corrupt_cost_model_starts_cold_and_preserves_file(tmp_path):
    path = str(tmp_path / "model.cost.json")
    cm = CostModel(path)
    from repro_torch.core.interface import TrainTask
    for _ in range(3):
        cm.observe(TrainTask(task_id=0, estimator="gbdt",
                             params={"round": 5}), 1.0, 1000)
    cm.save()
    corrupt_json(path)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        reloaded = CostModel.open(path)
    assert reloaded.n_observed == 0        # cold start, not a crash
    assert os.path.exists(path + ".corrupt")
    # and the cold model can save over the bad path again
    reloaded.observe(TrainTask(task_id=0, estimator="gbdt",
                               params={"round": 5}), 1.0, 1000)
    reloaded.save()
    assert CostModel.open(path).n_observed == 1


def test_prepared_cache_build_failure_does_not_poison_key():
    cache = PreparedDataCache()
    calls = []

    def flaky_builder():
        calls.append(1)
        if len(calls) == 1:
            raise ChaosTaskError("injected conversion failure")
        return "prepared"

    with pytest.raises(ChaosTaskError):
        cache.get("k", flaky_builder)
    value, _, built = cache.get("k", flaky_builder)   # retry rebuilds
    assert value == "prepared" and built and len(calls) == 2


# ---------------------------------------------------------------------------
# Service chaos: retries, worker deaths and quarantine on shared workers
# ---------------------------------------------------------------------------

def test_service_retries_and_quarantines(higgs_small, fast_estimator):
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED, fail_tasks=frozenset({1}),
                      max_task_faults=2,
                      poison_tasks=frozenset({4})).build(_NOSLEEP)
    svc = SearchService(n_executors=3, failure_hook=chaos.hook,
                        sleep=_NOSLEEP)
    try:
        spec = SearchSpec(
            spaces=[GridBuilder("chaosfast").add_grid(
                "i", list(range(6))).build()],
            n_executors=3, policy="dynamic",
            max_task_retries=3, retry_backoff=0.0, poison_threshold=2)
        handle = svc.submit_search(spec, train, tenant="chaos")
        results = list(handle.results())
        assert sorted(r.task.task_id for r in results) == list(range(6))
        by_id = {r.task.task_id: r for r in results}
        assert by_id[1].ok and by_id[1].attempts == 3
        assert by_id[4].quarantined and not by_id[4].ok
        assert chaos.n_poison_kills <= 2
        assert all(by_id[i].ok for i in range(6) if i != 4)
    finally:
        svc.close()


def test_session_end_to_end_chaos_stats(higgs_small, fast_estimator):
    """Session + LocalExecutorPool under chaos: spec-level retry knobs flow
    into the pool and the run's SearchStats account for the damage."""
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED, fail_tasks=frozenset({0}),
                      max_task_faults=1).build(_NOSLEEP)
    spec = SearchSpec(
        spaces=[GridBuilder("chaosfast").add_grid(
            "i", list(range(5))).build()],
        n_executors=2, policy="dynamic",
        max_task_retries=2, retry_backoff=0.0,
        pool_options={"failure_hook": chaos.hook})
    session = Session(spec)
    results = list(session.results(train))
    assert sorted(r.task.task_id for r in results) == list(range(5))
    assert all(r.ok for r in results)
    assert session.stats.n_retries == 1
    assert session.stats.n_quarantined == 0
    assert session.stats.n_failures == 0


# ---------------------------------------------------------------------------
# Satellite 4: eval failures degrade (score=None), never retry, never
# double-journal — on the solo, fused-member and rung paths
# ---------------------------------------------------------------------------

def _wal_journal_counts(path):
    import json as _json
    counts = {}
    with open(path) as f:
        for line in f:
            obj = _json.loads(line)
            if obj.get("kind") != "resume":
                tid = obj["task_id"]
                counts[tid] = counts.get(tid, 0) + 1
    return counts


class _EvalBoomModel(TrainedModel):
    def predict_proba(self, x):
        raise RuntimeError("scoring exploded")

    def predict_proba_device(self, x, *, cache=None):
        raise RuntimeError("scoring exploded")

    @classmethod
    def predict_proba_batched(cls, models, x, *, cache=None):
        raise RuntimeError("scoring exploded")


class _EvalBoomEstimator(Estimator):
    name = "evalboom"
    data_format = "dense_rows"
    budget_param = "round"      # lets RungTasks ride the resumable path

    def train(self, data, params):
        return _EvalBoomModel()

    def train_batched(self, data, configs, *, cache=None):
        return [_EvalBoomModel() for _ in configs]

    def fuse_signature(self, params):
        return ()


@pytest.fixture
def evalboom():
    register_estimator(_EvalBoomEstimator)
    yield _EvalBoomEstimator
    unregister_estimator("evalboom")


def test_eval_failure_solo_degrades_under_retry(higgs_small, tmp_path,
                                                evalboom):
    train, valid = higgs_small
    wal_path = str(tmp_path / "wal.jsonl")
    pool = LocalExecutorPool(2, wal=SearchWAL(wal_path),
                             max_task_retries=3, retry_backoff=0.0)
    tasks = _tasks(3, estimator="evalboom")
    results = list(pool.submit(schedule(tasks, 2, policy="dynamic"), train,
                               validate=EvalPlan(valid, "auc")))
    assert sorted(r.task.task_id for r in results) == list(range(3))
    # trained models survive their broken evaluation: ok, score=None, and
    # crucially NO retry was burned on the eval failure
    assert all(r.ok and r.score is None and r.model is not None
               for r in results)
    assert all(r.attempts == 1 for r in results)
    assert all(c == 1 for c in _wal_journal_counts(wal_path).values())


def test_eval_failure_fused_members_degrade_under_retry(higgs_small,
                                                        tmp_path, evalboom):
    train, valid = higgs_small
    wal_path = str(tmp_path / "wal.jsonl")
    tasks = [t.with_cost(1.0) for t in _tasks(4, estimator="evalboom")]
    units = fuse_tasks(tasks, max_fuse=4)
    assert len(units) == 1 and isinstance(units[0], FusedBatch)
    pool = LocalExecutorPool(1, wal=SearchWAL(wal_path),
                             max_task_retries=3, retry_backoff=0.0)
    results = list(pool.submit(schedule(units, 1, policy="dynamic"), train,
                               validate=EvalPlan(valid, "auc")))
    assert sorted(r.task.task_id for r in results) == list(range(4))
    assert all(r.ok and r.score is None and r.model is not None
               for r in results)
    assert all(r.attempts == 1 for r in results)
    assert all(c == 1 for c in _wal_journal_counts(wal_path).values())


def test_eval_failure_on_retried_task_still_journals_once(higgs_small,
                                                          tmp_path,
                                                          evalboom):
    """A task that fails training once THEN trains but can't score: the
    retry happens for the train failure only, the final ok result with
    score=None journals exactly once."""
    train, valid = higgs_small
    wal_path = str(tmp_path / "wal.jsonl")
    chaos = FaultPlan(seed=SEED, fail_tasks=frozenset({0}),
                      max_task_faults=1).build(_NOSLEEP)
    pool = LocalExecutorPool(2, wal=SearchWAL(wal_path),
                             failure_hook=chaos.hook,
                             max_task_retries=2, retry_backoff=0.0)
    results = list(pool.submit(
        schedule(_tasks(3, estimator="evalboom"), 2, policy="dynamic"),
        train, validate=EvalPlan(valid, "auc")))
    by_id = {r.task.task_id: r for r in results}
    assert by_id[0].ok and by_id[0].score is None and by_id[0].attempts == 2
    assert all(c == 1 for c in _wal_journal_counts(wal_path).values())


def test_eval_failure_rung_task_degrades(higgs_small, tmp_path, evalboom):
    """The rung (resumable, §3.6) path shares the same degradation: a rung
    whose predictor raises still yields its trained model, score=None,
    without burning a retry or double-journalling."""
    train, valid = higgs_small
    wal_path = str(tmp_path / "wal.jsonl")
    rung = RungTask(task_id=0, estimator="evalboom",
                    params={"round": 3}, cost=1.0,
                    config_id=0, rung=0, budget=3, prev_budget=0,
                    budget_param="round")
    pool = LocalExecutorPool(1, wal=SearchWAL(wal_path),
                             max_task_retries=2, retry_backoff=0.0)
    results = list(pool.submit(
        schedule([rung], 1, policy="dynamic"), train,
        validate=EvalPlan(valid, "auc")))
    [res] = results
    assert res.ok and res.model is not None and res.score is None
    assert res.attempts == 1
    assert _wal_journal_counts(wal_path) == {0: 1}


# ---------------------------------------------------------------------------
# Quarantine counters surface in stats
# ---------------------------------------------------------------------------

def test_session_counts_quarantined_tasks(higgs_small, fast_estimator):
    train, _ = higgs_small
    chaos = FaultPlan(seed=SEED, poison_tasks=frozenset({2})).build(_NOSLEEP)
    spec = SearchSpec(
        spaces=[GridBuilder("chaosfast").add_grid(
            "i", list(range(5))).build()],
        n_executors=4, policy="dynamic",
        poison_threshold=2, retry_backoff=0.0,
        pool_options={"failure_hook": chaos.hook})
    session = Session(spec)
    results = list(session.results(train))
    assert sorted(r.task.task_id for r in results) == list(range(5))
    assert session.stats.n_quarantined == 1
    assert session.stats.n_failures == 1
