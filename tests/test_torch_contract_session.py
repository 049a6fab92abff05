"""The JAX package's ``tests/test_session.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    Session/SearchSpec/ExecutorBackend behaviour: streaming results, budgets,
    WAL resume, and fault-recovery parity across both backend implementations.
"""
import threading

import pytest

import repro_torch.tabular  # noqa: F401 — registers estimators
from repro_torch.core import (
    Estimator,
    ExecutorBackend,
    ExecutorFailure,
    GridBuilder,
    LocalExecutorPool,
    MeshSliceExecutorPool,
    SamplingProfiler,
    SearchSpec,
    SearchWAL,
    Session,
    TrainedModel,
    enumerate_tasks,
    get_estimator,
    register_estimator,
    schedule,
    unregister_estimator,
)

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


def small_spaces():
    return [
        GridBuilder("logreg").add_grid("c", [0.05, 0.3]).add_grid("steps", [60]).build(),
        GridBuilder("mlp").add_grid("network", ["16_16"]).add_grid("steps", [60]).build(),
        GridBuilder("gbdt").add_grid("round", [5]).add_grid("max_depth", [3]).build(),
        GridBuilder("forest").add_grid("n_estimators", [5]).add_grid("max_depth", [4]).build(),
    ]


# ---------------------------------------------------------------------------
# SearchSpec: declarative construction + validation
# ---------------------------------------------------------------------------

def test_spec_validates_at_construction():
    sp = GridBuilder("logreg").add_grid("c", [0.1]).build()
    with pytest.raises(ValueError):
        SearchSpec(spaces=[sp], policy="nope")
    with pytest.raises(ValueError):
        SearchSpec(spaces=[sp], metric="nope")
    with pytest.raises(ValueError):
        SearchSpec(spaces=[sp], n_executors=0)
    with pytest.raises(ValueError):
        SearchSpec(spaces=())                      # no spaces, no tuner
    with pytest.raises(ValueError):
        SearchSpec(spaces=[sp], tuner={"no_kind": 1})
    with pytest.raises(TypeError):
        SearchSpec(spaces=[sp], profiler=object())


def test_spec_is_frozen_and_replace_copies():
    sp = GridBuilder("logreg").add_grid("c", [0.1, 0.3]).build()
    spec = SearchSpec(spaces=[sp], n_executors=2)
    with pytest.raises(AttributeError):
        spec.policy = "random"
    spec2 = spec.replace(policy="random", n_executors=4)
    assert spec.policy == "lpt" and spec2.policy == "random"
    assert spec2.spaces == spec.spaces
    assert spec.n_grid_tasks == 2


def test_spec_from_dict_declarative():
    spec = SearchSpec.from_dict({
        "spaces": [{"estimator": "logreg", "grid": {"c": [0.1, 0.3]}},
                   {"estimator": "gbdt", "grid": {"round": [5], "max_depth": [3, 4]}}],
        "n_executors": 3,
        "policy": "dynamic",
        "tuner": {"kind": "random", "n_samples": 3},
        "profiler": {"kind": "sampling", "sampling_rate": 0.05},
        "max_tasks": 2,
    })
    assert spec.n_grid_tasks == 4
    assert spec.spaces[0].estimator == "logreg"
    tuner = spec.build_tuner()
    assert len(tuner.propose()) == 3
    assert spec.build_profiler().sampling_rate == 0.05
    with pytest.raises(ValueError):
        SearchSpec.from_dict({"spaces": [], "bogus_key": 1})


# ---------------------------------------------------------------------------
# Streaming: results arrive incrementally, callbacks see them mid-search
# ---------------------------------------------------------------------------

def test_results_stream_incrementally(higgs_small):
    train, _ = higgs_small
    spec = SearchSpec(spaces=small_spaces(), n_executors=2,
                      profiler=SamplingProfiler(0.05))
    session = Session(spec)
    seen_flags = []
    gen = session.results(train, on_result=lambda r: seen_flags.append(session.finished))
    first = next(gen)                       # one task has completed ...
    assert first.ok
    assert not session.finished             # ... while the search is still live
    rest = list(gen)
    assert session.finished
    assert 1 + len(rest) == 5
    # the callback observed every result, all before the search finished
    assert len(seen_flags) == 5
    assert not any(seen_flags)


def test_multi_model_usable_mid_stream(higgs_small):
    train, valid = higgs_small
    spec = SearchSpec(spaces=small_spaces(), n_executors=2,
                      profiler=SamplingProfiler(0.05))
    session = Session(spec)
    gen = session.results(train)
    next(gen)
    assert len(session.multi_model()) == 1  # partial results are queryable
    list(gen)
    assert session.multi_model().best(valid).score > 0.6


def test_session_refuses_second_run(higgs_small):
    train, _ = higgs_small
    spec = SearchSpec(spaces=small_spaces()[:1], n_executors=1,
                      profiler=SamplingProfiler(0.1))
    session = Session(spec)
    session.search(train)
    with pytest.raises(RuntimeError):
        next(session.results(train))


# ---------------------------------------------------------------------------
# Budgets: early-stop mid-stream
# ---------------------------------------------------------------------------

def test_max_tasks_budget_stops_early(higgs_small):
    train, _ = higgs_small
    spec = SearchSpec(spaces=small_spaces(), n_executors=2,
                      profiler=SamplingProfiler(0.05), max_tasks=2)
    session = Session(spec)
    out = list(session.results(train))
    assert len(out) == 2
    assert session.stop_reason == "max_tasks"


def test_target_metric_budget_stops_on_good_model(higgs_small):
    train, valid = higgs_small
    spaces = [GridBuilder("logreg").add_grid("c", [0.05, 0.1, 0.3, 0.9]).build()]
    spec = SearchSpec(spaces=spaces, n_executors=1,
                      profiler=SamplingProfiler(0.1), target_metric=0.6)
    session = Session(spec)
    out = list(session.results(train, valid))
    assert session.stop_reason == "target_metric"
    assert len(out) < 4                     # stopped before the full grid


# ---------------------------------------------------------------------------
# Resume: a killed search completes without re-running WAL-recorded tasks
# ---------------------------------------------------------------------------

class _CountingModel(TrainedModel):
    def predict_proba(self, x):
        import numpy as np
        return np.full((x.shape[0],), 0.5, dtype=np.float32)


class _CountingEstimator(Estimator):
    name = "counting"
    data_format = "dense_rows"
    trained: list = []                       # class-level: shared across lookups

    def train(self, data, params):
        type(self).trained.append(params["i"])
        return _CountingModel()


@pytest.fixture
def counting_estimator():
    _CountingEstimator.trained = []
    register_estimator(_CountingEstimator)
    yield _CountingEstimator
    unregister_estimator("counting")


def test_resume_completes_without_rerunning(higgs_small, tmp_path, counting_estimator):
    train, _ = higgs_small
    wal_path = str(tmp_path / "wal.jsonl")
    spaces = [GridBuilder("counting").add_grid("i", list(range(6))).build()]
    # round_robin is cost-blind → no profiling runs to pollute the counts
    spec = SearchSpec(spaces=spaces, n_executors=1, policy="round_robin",
                      wal_path=wal_path, max_tasks=2)
    killed = Session(spec)
    got = list(killed.results(train))
    assert killed.stop_reason == "max_tasks" and len(got) == 2
    journalled_before = len(SearchWAL(wal_path).completed())
    assert journalled_before >= 2            # in-flight work may add one more

    resumed = Session.resume(wal_path, spec)
    multi = resumed.search(train)
    # the resumed run trained ONLY what the killed run hadn't journalled ...
    assert len(multi) == 6 - journalled_before
    assert len(SearchWAL(wal_path).completed()) == 6
    # ... and across both runs every config trained exactly once
    counts = {i: counting_estimator.trained.count(i) for i in range(6)}
    assert counts == {i: 1 for i in range(6)}, counts


# ---------------------------------------------------------------------------
# ExecutorBackend parity: both implementations satisfy the protocol and the
# same fault-recovery contract
# ---------------------------------------------------------------------------

def _estimator_task_runner(task, slice_mesh, data):
    """Mesh-slice runner that trains via the registry, like a real substrate."""
    return get_estimator(task.estimator).run(data, task.params)


def _make_backend(kind, n, failure_hook=None):
    if kind == "local":
        return LocalExecutorPool(n, failure_hook=failure_hook)
    return MeshSliceExecutorPool(
        task_runner=_estimator_task_runner,
        slices=[f"slice{i}" for i in range(n)],
        failure_hook=failure_hook,
    )


@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_backend_satisfies_protocol(kind):
    backend = _make_backend(kind, 2)
    assert isinstance(backend, ExecutorBackend)
    assert backend.n_executors == 2
    assert backend.dead_executors == set()


@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_backend_fault_recovery_parity(higgs_small, kind):
    """Kill executor 0 on its first task: the other executors absorb its
    queue and every task still completes — identical contract on both
    backends (the mesh pool historically lacked this)."""
    train, _ = higgs_small
    killed = []
    lock = threading.Lock()

    def failure_hook(eid, task):
        with lock:
            if eid == 0 and not killed:
                killed.append(task.task_id)
                raise ExecutorFailure(f"executor {eid} died")

    backend = _make_backend(kind, 3, failure_hook=failure_hook)
    tasks = enumerate_tasks(small_spaces())
    assignment = schedule(tasks, 3, policy="round_robin")
    results = list(backend.submit(assignment, train))
    assert killed, "hook never fired"
    assert backend.dead_executors == {0}
    assert sorted(r.task.task_id for r in results) == sorted(t.task_id for t in tasks)
    assert all(r.ok for r in results)
    assert all(backend.wal.is_done(t.task_id) for t in tasks)


@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_backend_fault_recovery_dynamic_parity(higgs_small, kind):
    """Same contract under the dynamic pull-queue policy: a task claimed by
    a dying executor is handed back to survivors, never silently dropped."""
    train, _ = higgs_small
    killed = []
    lock = threading.Lock()

    def failure_hook(eid, task):
        with lock:
            if eid == 0 and not killed:
                killed.append(task.task_id)
                raise ExecutorFailure(f"executor {eid} died mid-task")

    backend = _make_backend(kind, 2, failure_hook=failure_hook)
    tasks = enumerate_tasks(small_spaces())
    results = list(backend.submit(schedule(tasks, 2, policy="dynamic"), train))
    assert killed, "hook never fired"
    assert sorted(r.task.task_id for r in results) == sorted(t.task_id for t in tasks)
    assert all(r.ok for r in results)


def test_resume_on_mesh_backend(higgs_small, tmp_path, counting_estimator):
    """Session.resume points a caller-supplied backend at the journal, so a
    mesh/LM search killed mid-way is resumable too."""
    train, _ = higgs_small
    wal_path = str(tmp_path / "wal.jsonl")
    spaces = [GridBuilder("counting").add_grid("i", list(range(5))).build()]
    spec = SearchSpec(spaces=spaces, n_executors=2, policy="round_robin",
                      wal_path=wal_path, max_tasks=2)
    killed_pool = MeshSliceExecutorPool(
        task_runner=_estimator_task_runner, slices=["s0", "s1"],
        wal=SearchWAL(wal_path))
    killed = Session(spec, backend=killed_pool)
    assert len(list(killed.results(train))) == 2

    fresh_pool = MeshSliceExecutorPool(        # note: no WAL of its own
        task_runner=_estimator_task_runner, slices=["s0", "s1"])
    resumed = Session.resume(wal_path, spec, backend=fresh_pool)
    resumed.search(train)
    counts = {i: counting_estimator.trained.count(i) for i in range(5)}
    assert counts == {i: 1 for i in range(5)}, counts
    assert len(SearchWAL(wal_path).completed()) == 5


@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_backend_task_error_capture_parity(higgs_small, kind, counting_estimator):
    """A task-level exception becomes TaskResult.error on both backends and
    is NOT journalled (a resume retries it)."""
    train, _ = higgs_small

    class _Boom(Estimator):
        name = "boom"

        def train(self, data, params):
            raise ValueError("bad hyperparameters")

    register_estimator(_Boom)
    try:
        spaces = [GridBuilder("counting").add_grid("i", [0, 1]).build(),
                  GridBuilder("boom").build()]
        tasks = enumerate_tasks(spaces)
        backend = _make_backend(kind, 2)
        results = list(backend.submit(schedule(tasks, 2, policy="round_robin"), train))
        assert len(results) == 3
        errs = [r for r in results if not r.ok]
        assert len(errs) == 1 and "bad hyperparameters" in errs[0].error
        assert not backend.wal.is_done(errs[0].task.task_id)
        assert all(backend.wal.is_done(r.task.task_id) for r in results if r.ok)
    finally:
        unregister_estimator("boom")


def test_session_runs_on_mesh_backend(higgs_small):
    """The Session driver is backend-agnostic: the same spec runs unchanged
    on mesh-slice executors."""
    train, valid = higgs_small
    backend = MeshSliceExecutorPool(
        task_runner=_estimator_task_runner,
        slices=["slice0", "slice1"],
    )
    spec = SearchSpec(spaces=small_spaces(), n_executors=2,
                      profiler=SamplingProfiler(0.05))
    multi = Session.run(spec, train, backend=backend)
    assert len(multi) == 5
    assert multi.best(valid).score > 0.6
