"""The JAX package's ``tests/test_cost_model.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

Left out, because it tests the JAX package's benchmark harness, not the
port: ``test_compare_to_baseline_partial_run_skips_missing_keys``.

The reference file's own description:

    Profile-feedback subsystem: CostModel learning/persistence, drift-triggered
    replanning, the profiler-contract fix, and the device-free recovery sim that
    the CI bench gate reproduces (DESIGN.md §3.1).
"""
import json
import math
import time

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_stub import given, settings, st

import repro_torch.tabular  # noqa: F401 — registers estimators
from repro_torch.core import (
    AnalyticProfiler,
    CostModel,
    Estimator,
    GridBuilder,
    LocalExecutorPool,
    MeshSliceExecutorPool,
    ProfileReport,
    SamplingProfiler,
    SearchSpec,
    Session,
    TrainTask,
    TrainedModel,
    get_estimator,
    observed_drift,
    param_bucket,
    plan_makespan_estimate,
    register_estimator,
    replan,
    restrict,
    schedule,
    simulate_makespan,
    simulate_replan,
    unregister_estimator,
)

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


def _task(tid=0, est="gbdt", cost=None, **params):
    return TrainTask(task_id=tid, estimator=est, params=params, cost=cost)


# ---------------------------------------------------------------------------
# param_bucket + observed_drift
# ---------------------------------------------------------------------------

def test_param_bucket_groups_magnitudes():
    # same power-of-two magnitude -> same bucket; different magnitude -> not
    assert param_bucket({"round": 400}) == param_bucket({"round": 512})
    assert param_bucket({"round": 30}) != param_bucket({"round": 300})
    assert param_bucket({"lr": 0.003}) != param_bucket({"lr": 0.03})
    # strings/bools verbatim, key order irrelevant
    assert param_bucket({"a": 1, "net": "64_64"}) == param_bucket({"net": "64_64", "a": 1})
    assert param_bucket({"net": "64_64"}) != param_bucket({"net": "128_64"})


def test_observed_drift():
    assert observed_drift([]) == 0.0
    assert observed_drift([(2.0, 2.0), (5.0, 5.0)]) == 0.0
    assert observed_drift([(1.0, 2.0)]) == pytest.approx(math.log(2))
    # symmetric: over- and under-estimates both count
    assert observed_drift([(2.0, 1.0)]) == pytest.approx(math.log(2))
    # failed tasks report 0 observed seconds and must not register
    assert observed_drift([(1.0, 0.0), (0.0, 1.0)]) == 0.0


# ---------------------------------------------------------------------------
# CostModel: learning, fallbacks, persistence
# ---------------------------------------------------------------------------

def test_cost_model_learns_bucket_then_family():
    cm = CostModel()
    assert cm.predict(_task(est="gbdt", round=60), 1000) is None
    cm.observe(_task(est="gbdt", round=60), seconds=2.0, n_rows=1000)
    # exact bucket
    assert cm.predict(_task(tid=9, est="gbdt", round=60), 1000) == pytest.approx(2.0)
    # same family, unseen bucket -> pooled family stats
    assert cm.predict(_task(tid=9, est="gbdt", round=5000), 1000) == pytest.approx(2.0)
    # other family -> nothing
    assert cm.predict(_task(tid=9, est="mlp", steps=60), 1000) is None
    # junk observations are ignored
    cm.observe(_task(est="gbdt", round=60), seconds=0.0, n_rows=1000)
    cm.observe(_task(est="gbdt", round=60), seconds=1.0, n_rows=0)
    assert cm.n_observed == 1


def test_cost_model_scaling_law_from_observations():
    cm = CostModel()
    # quadratic-ish growth observed at two sizes -> learned exponent ~2
    cm.observe(_task(est="mlp", steps=64), seconds=1.0, n_rows=1000)
    cm.observe(_task(tid=1, est="mlp", steps=64), seconds=4.0, n_rows=2000)
    pred = cm.predict(_task(tid=9, est="mlp", steps=64), 4000)
    assert pred == pytest.approx(16.0, rel=0.05)


def test_cost_model_ratio_prior_corrects_unseen_bucket():
    cm = CostModel()
    # observed task ran 4x over its estimate (cost=0.5 -> 2.0s)
    cm.observe(_task(est="gbdt", round=60, cost=0.5), seconds=2.0, n_rows=1000)
    # unseen bucket, but the task carries its own (equally wrong) estimate:
    # estimate() scales it by the family's observed/estimated ratio
    t = _task(tid=9, est="gbdt", round=7, cost=1.0)
    assert cm.estimate(t, 1000) == pytest.approx(4.0)
    # predict() (pure size law) falls back to the family mean instead
    assert cm.predict(t, 1000) == pytest.approx(2.0)


def test_cost_model_json_roundtrip(tmp_path):
    path = str(tmp_path / "cm.json")
    cm = CostModel(path)
    cm.observe(_task(est="gbdt", round=60, cost=1.0), seconds=2.0, n_rows=1000)
    cm.observe(_task(tid=1, est="mlp", steps=300), seconds=0.5, n_rows=1000)
    cm.save()
    loaded = CostModel.open(path)
    assert loaded.n_observed == 2
    for t in (_task(tid=9, est="gbdt", round=60), _task(tid=9, est="mlp", steps=300)):
        assert loaded.predict(t, 2000) == pytest.approx(cm.predict(t, 2000))
    # ratio prior survives the roundtrip too
    t = _task(tid=9, est="gbdt", round=9, cost=3.0)
    assert loaded.estimate(t, 1000) == pytest.approx(cm.estimate(t, 1000))
    # the file is plain JSON (the documented persistence format)
    with open(path) as f:
        payload = json.load(f)
    assert payload["version"] == 1 and "gbdt" in payload["families"]


def test_cost_model_open_missing_path_is_fresh(tmp_path):
    cm = CostModel.open(str(tmp_path / "nope.json"))
    assert cm.n_observed == 0
    assert cm.path is not None          # will save there later


@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(min_value=1e-3, max_value=1e3), min_size=1, max_size=6),
       st.lists(st.integers(min_value=10, max_value=10**6), min_size=1, max_size=6))
def test_cost_model_predictions_monotone_in_data_size(secs, sizes):
    """Property: more rows never predicts less time."""
    cm = CostModel()
    for i, (s, n) in enumerate(zip(secs, sizes)):
        cm.observe(_task(tid=i, est="fam", units=4), seconds=s, n_rows=n)
    probe = _task(tid=99, est="fam", units=4, cost=1.0)
    grid = [10, 100, 1_000, 10_000, 100_000, 1_000_000]
    preds = [cm.predict(probe, n) for n in grid]
    ests = [cm.estimate(probe, n) for n in grid]
    assert all(p is not None for p in preds)
    for seq in (preds, ests):
        for a, b in zip(seq, seq[1:]):
            assert a <= b * (1 + 1e-9)


# ---------------------------------------------------------------------------
# CostModel as the third profiler source
# ---------------------------------------------------------------------------

class _Flat(TrainedModel):
    def predict_proba(self, x):
        import numpy as np
        return np.full((x.shape[0],), 0.5, dtype=np.float32)


class _Counting(Estimator):
    name = "counting2"
    data_format = "dense_rows"
    trained: list = []

    def train(self, data, params):
        type(self).trained.append(dict(params))
        return _Flat()


@pytest.fixture
def counting2():
    _Counting.trained = []
    register_estimator(_Counting)
    yield _Counting
    unregister_estimator("counting2")


def test_cost_model_profile_beats_sampling_after_warmup(higgs_small, counting2):
    train, _ = higgs_small
    tasks = [_task(tid=i, est="counting2", i=i) for i in range(4)]
    cm = CostModel(fallback=SamplingProfiler(0.5))
    # cold: the fallback must actually train (the paper's sampled profile)
    report = cm.profile(tasks, train)
    assert set(report.costs) == {0, 1, 2, 3}
    cold_trained = len(counting2.trained)
    assert cold_trained > 0
    # warm up the model, then profile again: zero training, instant answers
    for t in tasks:
        cm.observe(t, seconds=0.05, n_rows=train.n_rows)
    report2 = cm.profile(tasks, train)
    assert set(report2.costs) == {0, 1, 2, 3}
    assert len(counting2.trained) == cold_trained     # fallback never invoked
    assert report2.profiling_seconds < 0.05           # vs a training run
    assert report2.sampling_rate is None


def test_spec_builds_cost_model_profiler(tmp_path):
    sp = GridBuilder("logreg").add_grid("c", [0.1]).build()
    spec = SearchSpec.from_dict({
        "spaces": [{"estimator": "logreg", "grid": {"c": [0.1]}}],
        "profiler": {"kind": "cost_model",
                     "fallback": {"kind": "sampling", "sampling_rate": 0.11}},
        "cost_model_path": str(tmp_path / "cm.json"),
        "replan_threshold": 0.5,
    })
    prof = spec.build_profiler()
    assert isinstance(prof, CostModel)
    assert prof.path == str(tmp_path / "cm.json")
    assert isinstance(prof.fallback, SamplingProfiler)
    assert prof.fallback.sampling_rate == 0.11
    with pytest.raises(ValueError):
        SearchSpec(spaces=[sp], replan_threshold=0.0)
    with pytest.raises(ValueError):
        SearchSpec(spaces=[sp], replan_threshold=-1)


# ---------------------------------------------------------------------------
# ProfileReport contract fix
# ---------------------------------------------------------------------------

def test_ratio_of_contract_and_total_variant():
    report = ProfileReport(costs={}, profiling_seconds=2.0, sampling_rate=0.03)
    # ratio_of takes time EXCLUDING profiling and adds it itself
    assert report.ratio_of(8.0) == pytest.approx(0.2)
    # ratio_of_total takes a total that already INCLUDES profiling
    assert report.ratio_of_total(10.0) == pytest.approx(0.2)
    # the old double-count bug: passing the total to ratio_of understates
    assert report.ratio_of(10.0) < report.ratio_of_total(10.0)
    # clamping + degenerate inputs
    assert report.ratio_of_total(1.0) == 1.0
    assert report.ratio_of_total(0.0) == 0.0
    assert report.ratio_of(0.0) == 1.0


# ---------------------------------------------------------------------------
# Scheduler: replan / restrict / simulate_replan
# ---------------------------------------------------------------------------

def test_restrict_keeps_placement_and_new_costs():
    tasks = [_task(tid=i, est="a", i=i, cost=float(i + 1)) for i in range(6)]
    a = schedule(tasks, 2, policy="lpt")
    remaining = [t.with_cost(10.0) for t in tasks if t.task_id % 2 == 0]
    r = restrict(a, remaining)
    assert sorted(t.task_id for t in r.all_tasks()) == [0, 2, 4]
    assert all(t.cost == 10.0 for t in r.all_tasks())
    assert r.policy == "lpt"


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=0.01, max_value=100.0), min_size=1, max_size=16),
       st.integers(min_value=1, max_value=6),
       st.integers(min_value=0, max_value=15),
       st.sampled_from(["lpt", "dynamic", "lpt_dynamic"]))
def test_replan_never_increases_estimated_makespan(costs, m, n_done, policy):
    """Property: replan returns the better of {fresh
    rebalance, current residual}, so the estimate can only improve."""
    tasks = [_task(tid=i, est="fam", i=i, cost=c) for i, c in enumerate(costs)]
    assignment = schedule(tasks, m, policy=policy)
    remaining = tasks[min(n_done, len(tasks)):]
    if not remaining:
        return
    # re-estimation moves costs around before the replan, as in the Session
    remaining = [t.with_cost(t.cost * (1 + (t.task_id % 5))) for t in remaining]
    residual = restrict(assignment, remaining)
    out = replan(remaining, m, current=residual, policy=policy)
    assert plan_makespan_estimate(out) <= plan_makespan_estimate(residual) * (1 + 1e-9)
    assert sorted(t.task_id for t in out.all_tasks()) == \
        sorted(t.task_id for t in remaining)


def _mis_estimated(n=40, m=4, factor=4.0):
    tasks, true = [], {}
    for i in range(n):
        fam = ("slow", "fast")[i % 2]
        true_cost = 4.0 + (i % 7) if fam == "slow" else 1.0
        est = true_cost / factor if fam == "slow" else true_cost
        tasks.append(_task(tid=i, est=fam, i=i // 2, cost=est))
        true[i] = true_cost
    return tasks, true, m


def test_simulate_replan_matches_static_when_threshold_never_trips():
    tasks, true, m = _mis_estimated()
    static = simulate_makespan(schedule(tasks, m, policy="lpt"), true)
    out = simulate_replan(tasks, m, true, threshold=1e9)
    assert out["replans"] == 0
    assert out["makespan"] == pytest.approx(static)
    assert out["observed"] == len(tasks)


def test_simulate_replan_recovers_makespan_gap():
    """Mirror of the CI-gated benchmark acceptance: feedback + replan claws
    back >= 25% of the static->oracle gap on a 4x mis-estimated task set."""
    tasks, true, m = _mis_estimated()
    static = simulate_makespan(schedule(tasks, m, policy="lpt"), true)
    oracle = simulate_makespan(
        schedule([t.with_cost(true[t.task_id]) for t in tasks], m, policy="lpt"), true)
    out = simulate_replan(tasks, m, true, threshold=0.25)
    assert out["replans"] >= 1
    assert static > oracle                      # the mis-estimate really hurts
    recovery = (static - out["makespan"]) / (static - oracle)
    assert recovery >= 0.25, f"recovered only {recovery:.1%}"
    # sanity: never better than the oracle's lower bound family
    assert out["makespan"] >= max(true.values()) - 1e-9


# ---------------------------------------------------------------------------
# Executor pools: on_result hook + straggler drain
# ---------------------------------------------------------------------------

class _Sleepy(Estimator):
    name = "sleepy"
    data_format = "dense_rows"

    def train(self, data, params):
        time.sleep(params["ms"] / 1000.0)
        return _Flat()


@pytest.fixture
def sleepy():
    register_estimator(_Sleepy)
    yield _Sleepy
    unregister_estimator("sleepy")


@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_pools_invoke_on_result_hook(higgs_small, kind, counting2):
    train, _ = higgs_small
    seen = []
    if kind == "local":
        pool = LocalExecutorPool(2, on_result=seen.append)
    else:
        pool = MeshSliceExecutorPool(
            task_runner=lambda task, sl, data:
                get_estimator(task.estimator).run(data, task.params),
            slices=["s0", "s1"], on_result=seen.append)
    tasks = [_task(tid=i, est="counting2", i=i) for i in range(5)]
    results = list(pool.submit(schedule(tasks, 2, policy="round_robin"), train))
    assert sorted(r.task.task_id for r in seen) == sorted(r.task.task_id for r in results)


def test_pool_observer_exceptions_are_swallowed(higgs_small, counting2):
    train, _ = higgs_small

    def bad_observer(res):
        raise RuntimeError("broken observer")

    pool = LocalExecutorPool(2, on_result=bad_observer)
    tasks = [_task(tid=i, est="counting2", i=i) for i in range(4)]
    results = list(pool.submit(schedule(tasks, 2, policy="lpt"), train))
    assert len(results) == 4 and all(r.ok for r in results)


def test_local_pool_straggler_drain_loses_nothing(higgs_small, sleepy):
    train, _ = higgs_small
    pool = LocalExecutorPool(1)
    tasks = [_task(tid=i, est="sleepy", ms=30, cost=0.03) for i in range(3)]
    stream = pool.submit(schedule(tasks, 1, policy="lpt"), train)
    first = next(stream)
    stream.close()                      # cancel with work possibly in flight
    stragglers = pool.drain_stragglers()
    seen = {first.task.task_id} | {r.task.task_id for r in stragglers}
    # every journalled completion was surfaced through one of the two paths
    assert set(pool.wal.completed()) == seen
    assert pool.drain_stragglers() == []          # buffer clears on read


# ---------------------------------------------------------------------------
# Session integration: feedback loop end to end
# ---------------------------------------------------------------------------

def _sleepy_spec(tmp_path, *, est_ms, real_ms, n=6, **kw):
    """Analytic profile says est_ms; reality sleeps real_ms."""
    spaces = [GridBuilder("sleepy").add_grid("ms", [real_ms])
              .add_grid("i", list(range(n))).build()]
    return SearchSpec(
        spaces=spaces, n_executors=2, policy="lpt",
        profiler=AnalyticProfiler(cost_fn=lambda t, r, f: est_ms / 1000.0),
        **kw)


def test_session_replans_on_drift_and_completes_everything(tmp_path, higgs_small, sleepy):
    train, _ = higgs_small
    spec = _sleepy_spec(tmp_path, est_ms=10, real_ms=60,  # 6x under-estimated
                        replan_threshold=0.5,
                        cost_model_path=str(tmp_path / "cm.json"))
    session = Session(spec)
    out = list(session.results(train))
    assert session.stats.n_replans >= 1
    # the replan loop surfaced every task exactly once — nothing lost, no dupes
    assert sorted(r.task.task_id for r in out) == list(range(6))
    assert all(r.ok for r in out)
    # the model persisted next to the WAL path we chose and is warm
    warm = CostModel.open(str(tmp_path / "cm.json"))
    assert warm.n_observed >= 2
    probe = _task(tid=99, est="sleepy", ms=60, i=0)
    assert warm.predict(probe, train.n_rows) == pytest.approx(0.06, rel=0.5)


def test_session_cost_model_warm_start_skips_profiler(tmp_path, higgs_small, sleepy):
    train, _ = higgs_small
    path = str(tmp_path / "cm.json")
    cold = Session(_sleepy_spec(tmp_path, est_ms=20, real_ms=20, n=4,
                                cost_model_path=path))
    cold.search(train)
    assert cold.stats.n_profiled == 4 and cold.stats.n_model_estimates == 0
    # a LATER session over the same families starts warm: zero profiling
    warm = Session(_sleepy_spec(tmp_path, est_ms=20, real_ms=20, n=4,
                                cost_model_path=path))
    warm.search(train)
    assert warm.stats.n_model_estimates == 4
    assert warm.stats.n_profiled == 0
    assert warm.stats.profiling_seconds == 0.0


def test_session_default_cost_model_path_sits_next_to_wal(tmp_path, higgs_small, sleepy):
    train, _ = higgs_small
    wal = str(tmp_path / "search.wal")
    spec = _sleepy_spec(tmp_path, est_ms=20, real_ms=20, n=3,
                        wal_path=wal, replan_threshold=5.0)
    Session(spec).search(train)
    warm = CostModel.open(wal + ".cost.json")
    assert warm.n_observed == 3         # persisted without an explicit path


def test_declared_cost_model_profiler_persists_next_to_wal(tmp_path, higgs_small, sleepy):
    """A spec-declared {"kind": "cost_model"} profiler with no explicit path
    must still inherit the <wal>.cost.json default — and a later session
    declaring the same profiler must warm-load what it persisted."""
    train, _ = higgs_small
    wal = str(tmp_path / "w.jsonl")
    spaces = [GridBuilder("sleepy").add_grid("ms", [10])
              .add_grid("i", [0, 1, 2]).build()]

    def spec(wal_path):
        return SearchSpec(spaces=spaces, n_executors=1, policy="lpt",
                          profiler={"kind": "cost_model",
                                    "fallback": {"kind": "sampling",
                                                 "sampling_rate": 0.5}},
                          wal_path=wal_path, replan_threshold=5.0)

    s1 = Session(spec(wal))
    s1.search(train)
    assert s1.cost_model.path == wal + ".cost.json"
    assert CostModel.open(wal + ".cost.json").n_observed == 3

    s2 = Session(spec(str(tmp_path / "w2.jsonl"))
                 .replace(cost_model_path=wal + ".cost.json"))
    s2.search(train)
    assert s2.stats.n_model_estimates == 3      # warm-loaded, zero profiling
    assert s2.stats.n_profiled == 0


def test_reused_backend_replaces_stale_session_observer(tmp_path, higgs_small, counting2):
    """Two sessions sharing one pool: the second REPLACES the first's
    observer (no unbounded chain, no cross-feeding the dead session's model)."""
    train, _ = higgs_small
    user_hook_calls = []
    pool = LocalExecutorPool(1, on_result=user_hook_calls.append)
    spaces = [GridBuilder("counting2").add_grid("i", [0, 1]).build()]

    def spec(name):
        return SearchSpec(spaces=spaces, n_executors=1,
                          profiler=SamplingProfiler(0.5),
                          cost_model_path=str(tmp_path / name))

    s1 = Session(spec("cm1.json"), backend=pool)
    s1.search(train)
    n1 = s1.cost_model.n_observed
    assert n1 == 2
    from repro_torch.core import SearchWAL
    pool.wal = SearchWAL(None)      # fresh journal: same task ids run again
    s2 = Session(spec("cm2.json"), backend=pool)
    s2.search(train)
    # session 1's model stopped growing; session 2's observed its own run
    assert s1.cost_model.n_observed == n1
    assert s2.cost_model.n_observed == 2
    # the chain is observer -> original user hook, depth 1, both runs seen
    assert getattr(pool.on_result, "_session_observer", False)
    assert not getattr(pool.on_result._chained_prev, "_session_observer", False)
    assert len(user_hook_calls) == 4


def test_session_without_feedback_has_no_cost_model(higgs_small, counting2):
    train, _ = higgs_small
    spaces = [GridBuilder("counting2").add_grid("i", [0, 1]).build()]
    session = Session(SearchSpec(spaces=spaces, n_executors=1,
                                 profiler=SamplingProfiler(0.5)))
    session.search(train)
    assert session.cost_model is None
    assert session.stats.n_replans == 0
