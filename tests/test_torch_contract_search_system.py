"""The JAX package's ``tests/test_search_system.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    End-to-end model-search behaviour (paper §III): driver → tuner →
    profiler → scheduler → executors, plus the fault-tolerance contracts.
"""
import os
import threading

import numpy as np
import pytest

import repro_torch.tabular  # noqa: F401 — registers estimators
from repro_torch.core import (
    AnalyticProfiler,
    ExecutorFailure,
    GridBuilder,
    ModelSearcher,
    SamplingProfiler,
    SearchWAL,
    SuccessiveHalvingTuner,
    SurrogateTuner,
    attach_costs,
    available_formats,
    convert,
    enumerate_tasks,
)
from repro_torch.core.data_format import DenseMatrix

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


def small_spaces():
    return [
        GridBuilder("logreg").add_grid("c", [0.05, 0.3]).add_grid("steps", [60]).build(),
        GridBuilder("mlp").add_grid("network", ["16_16"]).add_grid("steps", [60]).build(),
        GridBuilder("gbdt").add_grid("round", [5]).add_grid("max_depth", [3]).build(),
        GridBuilder("forest").add_grid("n_estimators", [5]).add_grid("max_depth", [4]).build(),
    ]


def test_grid_builder_cartesian():
    g = (GridBuilder("gbdt").add_grid("eta", [0.1, 0.3, 0.9])
         .add_grid("round", [30, 60, 90]).add_grid("max_bin", [32, 64, 128]).build())
    assert len(g) == 27                       # the paper's XGBoost grid
    tasks = enumerate_tasks([g])
    assert len({t.key() for t in tasks}) == 27


def test_search_end_to_end_lpt(higgs_small):
    train, valid = higgs_small
    s = ModelSearcher(n_executors=2).set_scheduler("lpt").set_profiler(
        SamplingProfiler(0.05)
    )
    for sp in small_spaces():
        s.add_space(sp)
    multi = s.model_search(train)
    assert len(multi) == 5                    # logreg:2 + mlp:1 + gbdt:1 + forest:1
    best = multi.best(valid, metric="auc")
    assert best.score > 0.7
    assert s.stats.profiling_seconds > 0
    assert s.stats.profiling_ratio < 0.9


def test_search_policies_same_results(higgs_small):
    """Scheduling policy affects time, never which models are produced."""
    train, valid = higgs_small
    scores = {}
    for policy in ("lpt", "random", "round_robin", "dynamic"):
        s = ModelSearcher(n_executors=3, seed=1).set_scheduler(policy)
        s.set_profiler(SamplingProfiler(0.05))
        for sp in small_spaces():
            s.add_space(sp)
        multi = s.model_search(train)
        ranked = multi.validate_all(valid, metric="auc")
        scores[policy] = {m.task.key(): round(m.score, 4) for m in ranked}
    base = scores["lpt"]
    for policy, sc in scores.items():
        assert sc == base, f"{policy} changed model outcomes"


def test_analytic_profiler_orders_like_sampling(higgs_small):
    train, _ = higgs_small
    spaces = [
        GridBuilder("gbdt").add_grid("round", [3, 60]).add_grid("max_depth", [3]).build(),
        GridBuilder("logreg").add_grid("c", [0.3]).build(),
    ]
    tasks = enumerate_tasks(spaces)
    rep = AnalyticProfiler().profile(tasks, train)
    costs = [rep.costs[t.task_id] for t in tasks]
    assert costs[1] > costs[0]                 # 60 rounds > 3 rounds
    # logreg under the heavyweight ensemble (the §3.8 subtraction discount
    # halves gbdt's histogram estimate, so the margin needs 60 rounds)
    assert costs[2] < costs[1]


def test_wal_restart_skips_completed(higgs_small, tmp_path):
    train, _ = higgs_small
    wal_path = str(tmp_path / "wal.jsonl")
    s1 = ModelSearcher(n_executors=2).set_wal(wal_path).set_profiler(
        SamplingProfiler(0.05)
    )
    for sp in small_spaces():
        s1.add_space(sp)
    m1 = s1.model_search(train)
    assert os.path.exists(wal_path)
    # restart: everything already in the WAL → nothing re-runs
    s2 = ModelSearcher(n_executors=2).set_wal(wal_path).set_profiler(
        SamplingProfiler(0.05)
    )
    for sp in small_spaces():
        s2.add_space(sp)
    m2 = s2.model_search(train)
    assert len(m2) == 0
    wal = SearchWAL(wal_path)
    assert len(wal.completed()) == len(m1)


def test_executor_failure_recovery(higgs_small):
    """Kill executor 0 on its first task: others absorb its queue."""
    train, valid = higgs_small
    killed = []

    def failure_hook(eid, task):
        if eid == 0 and not killed:
            killed.append(task.task_id)
            raise ExecutorFailure(f"executor {eid} died")

    s = (ModelSearcher(n_executors=3)
         .set_profiler(SamplingProfiler(0.05))
         .set_pool_options(failure_hook=failure_hook))
    for sp in small_spaces():
        s.add_space(sp)
    multi = s.model_search(train)
    assert len(multi) == 5                     # every task still completed
    assert multi.best(valid).score > 0.6


def test_straggler_speculation(higgs_small):
    """A task stuck on a slow executor is duplicated; first result wins."""
    train, _ = higgs_small
    slow_once = threading.Event()

    def failure_hook(eid, task):
        # executor 0 sleeps a long time on its first task (a "straggler")
        if eid == 0 and not slow_once.is_set():
            slow_once.set()
            import time
            time.sleep(1.5)

    s = (ModelSearcher(n_executors=2)
         .set_scheduler("dynamic")
         .set_profiler(SamplingProfiler(0.05))
         .set_pool_options(failure_hook=failure_hook, speculation_factor=3.0))
    for sp in small_spaces():
        s.add_space(sp)
    multi = s.model_search(train)
    assert len(multi) == 5


def test_successive_halving_tuner(higgs_small):
    train, valid = higgs_small
    spaces = [
        GridBuilder("logreg").add_grid("c", [0.005, 0.05, 0.3, 0.9]).build(),
    ]
    tuner = SuccessiveHalvingTuner(spaces, budget_param="steps",
                                   base_budget=20, max_budget=100, eta=2)
    s = (ModelSearcher(n_executors=2).set_tuner(tuner)
         .set_profiler(SamplingProfiler(0.1)))
    multi = s.model_search(train, valid)
    # budgets 20/40/80/100 → rungs of 4, 2, 1, 1 configs = 8 evaluations
    assert len(multi) == 8


def test_surrogate_tuner_explores_then_exploits(higgs_small):
    train, valid = higgs_small
    spaces = [GridBuilder("logreg").add_grid(
        "c", [0.001, 0.01, 0.1, 0.3, 0.9, 2.0]).build()]
    tuner = SurrogateTuner(spaces, batch_size=2, rounds=3)
    s = (ModelSearcher(n_executors=2).set_tuner(tuner)
         .set_profiler(SamplingProfiler(0.1)))
    multi = s.model_search(train, valid)
    assert len(multi) == 6


def test_data_format_converters(higgs_small):
    train, _ = higgs_small
    assert set(available_formats()) >= {
        "dense_rows", "dense_cols", "quantized_bins", "sparse_csr"
    }
    rows = convert(train, "dense_rows")
    cols = convert(train, "dense_cols")
    np.testing.assert_allclose(np.asarray(rows["x"]).T, np.asarray(cols["xt"]),
                               rtol=1e-6)
    q = convert(train, "quantized_bins")
    assert int(q["bins"].max()) < int(q["n_bins"])
    csr = convert(train, "sparse_csr")
    assert int(csr["indptr"][-1]) == len(csr["values"])


def test_dense_matrix_validation():
    with pytest.raises(ValueError):
        DenseMatrix(np.zeros((4, 2)), np.zeros(3))
    with pytest.raises(ValueError):
        DenseMatrix(np.zeros(4), np.zeros(4))
    d = DenseMatrix(np.random.randn(100, 5), np.random.randint(0, 2, 100))
    sample = d.sample(0.25)
    assert sample.n_rows == 25
    parts = d.split((0.6, 0.2, 0.2))
    assert sum(p.n_rows for p in parts) == 100
