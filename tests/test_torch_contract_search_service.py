"""The JAX package's ``tests/test_search_service.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    Multi-tenant SearchService (DESIGN.md §3.5): fair-share arbitration,
    admission control/backpressure, per-tenant artifact namespacing, streaming
    parity with a plain Session, exact cache accounting across concurrent
    sessions, the fleet-level CostModel prior, and WAL resume through the
    service.
"""
import os
import threading

import numpy as np
import pytest

import repro_torch.tabular  # noqa: F401 — registers estimators
from repro_torch.core import (
    Estimator,
    GridBuilder,
    SearchSpec,
    TrainedModel,
    register_estimator,
    unregister_estimator,
)
from repro_torch.core.data_format import PreparedDataCache
from repro_torch.core.scheduler import FairShareArbiter
from repro_torch.data.synthetic import make_higgs_like
from repro_torch.serve import SearchService, ServiceSaturated

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


@pytest.fixture(scope="module")
def tiny_data():
    data = make_higgs_like(400, seed=7)
    train, valid = data.split((0.8, 0.2), seed=1)
    train, mu, sd = train.standardize()
    valid, _, _ = valid.standardize(mu, sd)
    return train, valid


class _Scored(TrainedModel):
    def __init__(self, c):
        self.c = c

    def predict_proba(self, x):
        return 1.0 / (1.0 + np.exp(-self.c * np.asarray(x)[:, 0]))


class _Toy(Estimator):
    name = "svc_toy"
    data_format = "dense_rows"
    trained: list = []
    gate: threading.Event | None = None

    def train(self, data, params):
        if type(self).gate is not None:
            assert type(self).gate.wait(20), "test gate never released"
        type(self).trained.append(dict(params))
        return _Scored(float(params.get("c", 1.0)))

    @staticmethod
    def estimate_cost(params, n_rows, n_features):
        return 1e-4 * n_rows * params.get("c", 1.0)


@pytest.fixture
def toy():
    _Toy.trained = []
    _Toy.gate = None
    register_estimator(_Toy)
    yield _Toy
    _Toy.gate = None
    unregister_estimator("svc_toy")


def _toy_spec(n=3, **kw):
    sp = GridBuilder("svc_toy").add_grid("c", [0.1 * (i + 1) for i in range(n)]).build()
    # analytic profiler: cold-task costing never trains, so _Toy.trained
    # counts are exactly the real training runs
    kw.setdefault("profiler", {"kind": "analytic"})
    return SearchSpec(spaces=[sp], n_executors=2, **kw)


# ---------------------------------------------------------------------------
# FairShareArbiter (unit)
# ---------------------------------------------------------------------------

def test_arbiter_interleaves_small_tenant_through_big_backlog():
    arb = FairShareArbiter()
    arb.ensure_tenant("big")
    arb.ensure_tenant("small")
    for i in range(6):
        arb.push("big", f"b{i}")
    for i in range(2):
        arb.push("small", f"s{i}")
    order = []
    while True:
        got = arb.pop()
        if got is None:
            break
        order.append(got[1])
    # equal weights: small's 2 units dispatch within the first 4 slots
    # instead of waiting behind big's 6 (the FIFO failure mode)
    assert set(order[:4]) >= {"s0", "s1"}
    assert len(order) == 8


def test_arbiter_fifo_mode_is_head_of_line():
    arb = FairShareArbiter(mode="fifo")
    arb.ensure_tenant("big")
    arb.ensure_tenant("small")
    for i in range(6):
        arb.push("big", f"b{i}")
    for i in range(2):
        arb.push("small", f"s{i}")
    order = [arb.pop()[1] for _ in range(8)]
    assert order == [f"b{i}" for i in range(6)] + ["s0", "s1"]


def test_arbiter_weights_bias_dispatch_cost():
    arb = FairShareArbiter()
    arb.ensure_tenant("heavy", weight=3.0)
    arb.ensure_tenant("light", weight=1.0)
    for i in range(40):
        arb.push("heavy", ("h", i), cost=1.0)
        arb.push("light", ("l", i), cost=1.0)
    first = [arb.pop()[0] for _ in range(40)]
    n_heavy = sum(1 for t in first if t == "heavy")
    # 3:1 weights -> ~30 of the first 40 dispatches go to heavy
    assert 27 <= n_heavy <= 33
    assert arb.share_drift < 0.1


def test_arbiter_discard_and_len():
    arb = FairShareArbiter()
    arb.ensure_tenant("t")
    for i in range(5):
        arb.push("t", i)
    assert len(arb) == 5
    assert arb.discard("t", lambda x: x % 2 == 0) == 3
    assert len(arb) == 2
    assert [arb.pop()[1] for _ in range(2)] == [1, 3]
    assert arb.pop() is None


def test_arbiter_rejects_bad_args():
    with pytest.raises(ValueError):
        FairShareArbiter(mode="lifo")
    arb = FairShareArbiter()
    with pytest.raises(ValueError):
        arb.ensure_tenant("t", weight=0.0)


# ---------------------------------------------------------------------------
# Streaming parity + namespaced artifacts
# ---------------------------------------------------------------------------

def test_service_streams_like_a_session(toy, tiny_data, tmp_path):
    train, valid = tiny_data
    svc = SearchService(n_executors=2, artifact_root=str(tmp_path),
                        prepared_cache=PreparedDataCache())
    try:
        h = svc.submit_search(_toy_spec(4), train, valid, tenant="alice")
        results = list(h.results())
        assert len(results) == 4
        assert all(r.ok for r in results)
        # executor-side scoring flowed through, exactly like a pool backend
        assert all(r.score is not None for r in results)
        assert h.stats.n_tasks == 4
        assert len(h.multi_model()) == 4
        assert h.state == "done"
        assert h.time_to_first_result is not None
        # results() is one-shot, like Session.results()
        with pytest.raises(RuntimeError):
            next(h.results())
    finally:
        svc.close()


def test_service_namespaces_default_artifacts_per_tenant(toy, tiny_data, tmp_path):
    """Satellite 1: two path-less concurrent sessions must never share a WAL
    (or its ``<wal>.cost.json``) — each gets <root>/<tenant>/<session>.wal."""
    train, _ = tiny_data
    svc = SearchService(n_executors=2, artifact_root=str(tmp_path),
                        prepared_cache=PreparedDataCache())
    try:
        spec = _toy_spec(2)
        h1 = svc.submit_search(spec, train, tenant="alice")
        h2 = svc.submit_search(spec, train, tenant="alice")
        h3 = svc.submit_search(spec, train, tenant="bob")
        paths = {h.session.spec.wal_path for h in (h1, h2, h3)}
        assert len(paths) == 3
        for h in (h1, h2, h3):
            wal = h.session.spec.wal_path
            assert wal == os.path.join(str(tmp_path), h.tenant,
                                       f"{h.session_id}.wal")
            assert h.session.spec.cost_model_path == wal + ".cost.json"
        for h in (h1, h2, h3):
            h.wait(60)
            assert os.path.exists(h.session.spec.wal_path)
    finally:
        svc.close()


def test_service_rejects_live_wal_collision(toy, tiny_data, tmp_path):
    train, _ = tiny_data
    gate = threading.Event()
    _Toy.gate = gate
    svc = SearchService(n_executors=1, prepared_cache=PreparedDataCache())
    try:
        wal = str(tmp_path / "shared.wal")
        h1 = svc.submit_search(_toy_spec(2, wal_path=wal), train, tenant="a")
        with pytest.raises(ValueError, match="collision"):
            svc.submit_search(_toy_spec(2, wal_path=wal), train, tenant="b")
        gate.set()
        assert h1.wait(60)
        # once the first session finished, the path is reusable
        h2 = svc.submit_search(_toy_spec(2, wal_path=wal), train, tenant="b")
        assert h2.wait(60)
    finally:
        _Toy.gate = None
        gate.set()
        svc.close()


# ---------------------------------------------------------------------------
# Admission control / backpressure
# ---------------------------------------------------------------------------

def test_admission_bounds_active_and_queued(toy, tiny_data):
    train, _ = tiny_data
    gate = threading.Event()
    _Toy.gate = gate
    svc = SearchService(n_executors=1, max_active=1, max_queued=1,
                        prepared_cache=PreparedDataCache())
    try:
        h1 = svc.submit_search(_toy_spec(2), train, tenant="a")
        h2 = svc.submit_search(_toy_spec(2), train, tenant="b")
        # slot busy (gate holds h1 mid-train) + queue full -> backpressure
        assert h1.state == "active" and h2.state == "queued"
        with pytest.raises(ServiceSaturated):
            svc.submit_search(_toy_spec(2), train, tenant="c")
        st = svc.stats()
        assert st.n_active == 1 and st.n_queued == 1
        gate.set()
        assert h1.wait(60) and h2.wait(60)
        # both sessions ran fully once the slot freed up
        assert len(list(h1.results())) == 2
        assert len(list(h2.results())) == 2
        assert h2.queue_wait_seconds > 0.0
    finally:
        _Toy.gate = None
        gate.set()
        svc.close()


def test_cancel_queued_session_never_starts(toy, tiny_data):
    train, _ = tiny_data
    gate = threading.Event()
    _Toy.gate = gate
    svc = SearchService(n_executors=1, max_active=1,
                        prepared_cache=PreparedDataCache())
    try:
        h1 = svc.submit_search(_toy_spec(1), train, tenant="a")
        h2 = svc.submit_search(_toy_spec(1), train, tenant="b")
        h2.cancel()
        gate.set()
        assert h1.wait(60) and h2.wait(60)
        assert h2.state == "cancelled"
        assert list(h2.results()) == []
        assert len(_Toy.trained) == 1           # b never trained anything
    finally:
        _Toy.gate = None
        gate.set()
        svc.close()


def test_close_rejects_new_submissions(toy, tiny_data):
    train, _ = tiny_data
    svc = SearchService(n_executors=1, prepared_cache=PreparedDataCache())
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit_search(_toy_spec(1), train, tenant="a")


# ---------------------------------------------------------------------------
# Exact per-tenant accounting across concurrent sessions (satellite 2)
# ---------------------------------------------------------------------------

def test_two_session_cache_accounting_is_exact(toy, tiny_data):
    train, valid = tiny_data
    pc = PreparedDataCache()
    svc = SearchService(n_executors=2, prepared_cache=pc)
    try:
        handles = [svc.submit_search(_toy_spec(4), train, valid,
                                     tenant=t, weight=w)
                   for t, w in (("alice", 2.0), ("bob", 1.0))]
        for h in handles:
            assert all(r.ok for r in h.results())
        hits, misses = pc.counters()
        snap = pc.tenant_counters()
        assert sum(v.get("hits", 0) for v in snap.values()) == hits
        assert sum(v.get("misses", 0) for v in snap.values()) == misses
        assert sum(v.get("bytes", 0) for v in snap.values()) == pc.bytes_built
        # both tenants actually touched the shared cache
        assert set(snap) >= {"alice", "bob"}
        # the train variant was BUILT once, process-wide: one tenant paid the
        # miss, every other prepare was a hit (eval variant adds one more)
        assert misses == 2                      # train + validate variants
        st = svc.stats()
        ts = st.per_tenant
        assert ts["alice"].prepared_hits + ts["bob"].prepared_hits == hits
        assert ts["alice"].n_results == ts["bob"].n_results == 4
        assert abs(ts["alice"].share_entitled - 2 / 3) < 1e-9
        assert "alice" in st.summary()
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Fleet-level CostModel prior
# ---------------------------------------------------------------------------

def test_fleet_prior_warms_new_tenants_first_plan(toy, tiny_data, tmp_path):
    train, _ = tiny_data
    svc = SearchService(n_executors=2, artifact_root=str(tmp_path),
                        prepared_cache=PreparedDataCache())
    try:
        h1 = svc.submit_search(_toy_spec(3), train, tenant="veteran")
        assert len(list(h1.results())) == 3
        # every observation wrote through to the fleet model
        assert svc.fleet_cost_model.n_observed >= 3
        # a brand-new tenant's FIRST plan priced tasks from the fleet prior
        # (n_model_estimates > 0 before it observed anything), profiling none
        h2 = svc.submit_search(_toy_spec(3), train, tenant="rookie")
        assert len(list(h2.results())) == 3
        assert h2.stats.n_model_estimates > 0
        assert h2.stats.n_profiled == 0
        # write-through kept per-session persistence intact and distinct
        cm_path = h2.session.spec.cost_model_path
        assert cm_path != h1.session.spec.cost_model_path
    finally:
        svc.close()
    # close() persisted the fleet for the next service instance
    fleet_file = os.path.join(str(tmp_path), "fleet.cost.json")
    assert os.path.exists(fleet_file)
    svc2 = SearchService(n_executors=1, artifact_root=str(tmp_path),
                         prepared_cache=PreparedDataCache())
    try:
        assert svc2.fleet_cost_model.n_observed >= 6
    finally:
        svc2.close()


# ---------------------------------------------------------------------------
# WAL resume through the service
# ---------------------------------------------------------------------------

def test_wal_resume_skips_done_tasks_through_service(toy, tiny_data, tmp_path):
    train, _ = tiny_data
    wal = str(tmp_path / "resume.wal")
    svc = SearchService(n_executors=2, prepared_cache=PreparedDataCache())
    try:
        h1 = svc.submit_search(_toy_spec(4, wal_path=wal), train, tenant="a")
        assert len(list(h1.results())) == 4
        n_first = len(_Toy.trained)
        assert n_first == 4
        # resubmit the SAME spec: the fresh session adopts the WAL and skips
        # every completed task — nothing retrains
        h2 = svc.submit_search(_toy_spec(4, wal_path=wal), train, tenant="a")
        h2.wait(60)
        assert len(_Toy.trained) == n_first
        assert h2.state == "done"
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Real estimators end-to-end (fused units through the shared workers)
# ---------------------------------------------------------------------------

def test_service_runs_fused_real_estimators(tiny_data, tmp_path):
    train, valid = tiny_data
    sp = GridBuilder("logreg").add_grid("c", [0.05, 0.3, 1.0]).add_grid(
        "steps", [40]).build()
    spec = SearchSpec(spaces=[sp], n_executors=2, fuse=True)
    svc = SearchService(n_executors=2, artifact_root=str(tmp_path),
                        prepared_cache=PreparedDataCache())
    try:
        h = svc.submit_search(spec, train, valid, tenant="alice")
        results = list(h.results())
        assert len(results) == 3
        assert all(r.ok and r.score is not None for r in results)
        # fusion actually happened on the shared workers
        assert any(r.batch_size > 1 for r in results)
        best = h.multi_model().best(valid)
        assert best.score > 0.5
    finally:
        svc.close()
