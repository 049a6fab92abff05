"""The JAX package's ``tests/test_prepared_data.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    The prepared-data plane (DESIGN.md §3.3): fingerprinted device-resident
    dataset cache, parameterized converters, conversion-aware scheduling.

    Covers: fingerprint stability, converter-param cache keying, in-flight
    build de-duplication, fused+sequential paths sharing one entry, per-slice
    mesh placement reuse, the WAL/CostModel conversion accounting that used to
    vanish, and the acceptance criterion — a 64-config gbdt grid converts
    exactly once per (dataset-fingerprint, max_bins) pair.
"""
import threading

import numpy as np
import pytest

import repro_torch.tabular  # noqa: F401  (registers the estimators)
from repro_torch.core import (
    CostModel,
    DenseMatrix,
    LocalExecutorPool,
    MeshSliceExecutorPool,
    SearchSpec,
    Session,
    TrainTask,
    charge_first_of_group,
    convert,
    format_key,
    get_estimator,
    plan_makespan_estimate,
    prepare_cached,
    prepared_data_cache,
    register_converter,
    run_prepared,
    run_prepared_batched,
    schedule,
    unregister_converter,
)
from repro_torch.core.data_format import PreparedDataCache, payload_nbytes
from repro_torch.core.fusion import fuse_tasks
from repro_torch.core.interface import Estimator

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


@pytest.fixture
def data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    return DenseMatrix(x, y)


@pytest.fixture(autouse=True)
def _clean_global_cache():
    prepared_data_cache().clear()
    yield
    prepared_data_cache().clear()


# --------------------------------------------------------------------------
# Fingerprint.
# --------------------------------------------------------------------------

def test_fingerprint_stable_across_equal_content_copies(data):
    twin = DenseMatrix(data.x.copy(), data.y.copy(), data.feature_names)
    assert data.fingerprint() == twin.fingerprint()
    # memoized: second call returns the same string object
    assert data.fingerprint() is data.fingerprint()


def test_fingerprint_changes_with_content(data):
    x2 = data.x.copy()
    x2[0, 0] += 1.0
    assert DenseMatrix(x2, data.y).fingerprint() != data.fingerprint()
    assert DenseMatrix(data.x, 1.0 - data.y).fingerprint() != data.fingerprint()
    named = DenseMatrix(data.x, data.y, tuple("f" + str(i) for i in range(6)))
    assert named.fingerprint() != data.fingerprint()


# --------------------------------------------------------------------------
# Converter registry: params, unregister, idempotent re-registration.
# --------------------------------------------------------------------------

def test_parameterized_convert(data):
    q64 = convert(data, "quantized_bins", max_bins=64)
    q256 = convert(data, "quantized_bins")
    assert int(q64["n_bins"]) == 64
    assert int(q256["n_bins"]) == 256
    with pytest.raises(ValueError):
        convert(data, "quantized_bins", max_bins=1)


def test_format_key_canonical():
    assert format_key("dense_rows") == "dense_rows"
    assert format_key("quantized_bins", {"max_bins": 64}) == \
        "quantized_bins(max_bins=64)"
    # sorted items: dict order does not matter
    assert format_key("f", {"b": 2, "a": 1}) == format_key("f", {"a": 1, "b": 2})
    assert format_key("quantized_bins", {"max_bins": 64}) != \
        format_key("quantized_bins", {"max_bins": 256})


def test_unregister_and_idempotent_reregistration():
    def conv(d):
        return {"n": d.n_rows}

    register_converter("test-fmt")(conv)
    # same function again: no-op (hot reload / re-import)
    register_converter("test-fmt")(conv)

    def other(d):
        return {}

    with pytest.raises(ValueError):
        register_converter("test-fmt")(other)
    unregister_converter("test-fmt")
    register_converter("test-fmt")(other)   # name free again
    unregister_converter("test-fmt")
    unregister_converter("test-fmt")        # idempotent


# --------------------------------------------------------------------------
# CSR is actually CSR.
# --------------------------------------------------------------------------

def test_sparse_csr_roundtrip():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(40, 7)).astype(np.float32)
    x[rng.random(size=x.shape) < 0.6] = 0.0
    d = DenseMatrix(x, np.zeros(40))
    csr = convert(d, "sparse_csr")
    values = np.asarray(csr["values"])
    col_idx = np.asarray(csr["col_idx"])
    indptr = np.asarray(csr["indptr"])
    assert indptr[0] == 0 and indptr[-1] == len(values) == np.count_nonzero(x)
    dense = np.zeros(csr["shape"], np.float32)
    for r in range(x.shape[0]):
        lo, hi = indptr[r], indptr[r + 1]
        # within-row column indices strictly ascend (CSR canonical form)
        assert np.all(np.diff(col_idx[lo:hi]) > 0)
        dense[r, col_idx[lo:hi]] = values[lo:hi]
    np.testing.assert_array_equal(dense, x)


# --------------------------------------------------------------------------
# PreparedDataCache mechanics.
# --------------------------------------------------------------------------

def test_cache_keys_on_converter_params(data):
    cache = PreparedDataCache()
    a, s_a, built_a = prepare_cached(data, "quantized_bins", {"max_bins": 64},
                                     cache=cache)
    b, s_b, built_b = prepare_cached(data, "quantized_bins", {"max_bins": 256},
                                     cache=cache)
    c, s_c, built_c = prepare_cached(data, "quantized_bins", {"max_bins": 64},
                                     cache=cache)
    assert built_a and built_b and not built_c
    assert s_a > 0 and s_b > 0 and s_c == 0.0
    assert c is a and b is not a
    assert cache.counters() == (1, 2)
    assert cache.bytes_cached >= payload_nbytes(a)
    assert cache.n_entries == 2
    cache.clear()
    assert cache.counters() == (0, 0) and cache.bytes_cached == 0


def test_cache_shared_across_equal_content_copies(data):
    cache = PreparedDataCache()
    twin = DenseMatrix(data.x.copy(), data.y.copy())
    prepare_cached(data, "dense_rows", cache=cache)
    _, secs, built = prepare_cached(twin, "dense_rows", cache=cache)
    assert not built and secs == 0.0
    assert cache.counters() == (1, 1)


def test_cache_deduplicates_concurrent_builds(data):
    cache = PreparedDataCache()
    builds = []
    gate = threading.Event()

    def builder():
        builds.append(1)
        gate.wait(2.0)
        return {"x": np.zeros(4)}

    results = []

    def worker():
        results.append(cache.get("k", builder))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join()
    assert len(builds) == 1                      # conversion ran EXACTLY once
    assert cache.counters() == (3, 1)
    assert sum(1 for _, _, built in results if built) == 1
    assert len({id(v) for v, _, _ in results}) == 1


def test_cache_failed_build_does_not_poison_key():
    cache = PreparedDataCache()
    with pytest.raises(RuntimeError):
        cache.get("k", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    value, _, built = cache.get("k", lambda: {"ok": np.ones(2)})
    assert built and value["ok"].sum() == 2


# --------------------------------------------------------------------------
# run_prepared / run_prepared_batched: shared entries, convert_seconds.
# --------------------------------------------------------------------------

def test_fused_and_sequential_share_one_entry(data):
    cache = PreparedDataCache()
    est = get_estimator("gbdt")
    params = {"round": 3, "max_depth": 2, "max_bin": 32}
    model, train_s, conv_s = run_prepared(est, data, params, cache=cache)
    assert conv_s > 0 and train_s > 0
    configs = [dict(params, eta=e) for e in (0.1, 0.3)]
    models, _total, conv_b = run_prepared_batched(est, data, configs,
                                                  cache=cache)
    # the batch HIT the sequential path's entry: one conversion total
    assert conv_b == 0.0
    assert cache.counters() == (1, 1)
    # bit-identical data -> bit-identical margins for the matching config
    mb = models[1]
    np.testing.assert_array_equal(model.predict_proba(data.x),
                                  mb.predict_proba(data.x))


def test_prepare_override_is_honored_and_keyed_per_estimator(data):
    """A subclass's prepare() override IS what the executor path caches —
    under a key discriminated by estimator name, so it can't collide with
    other users of the same declared format."""
    from repro_torch.core.interface import prepared_cache_key

    class Scaled(Estimator):
        name = "scaled-prepare"
        data_format = "dense_rows"

        def prepare(self, raw, params=None):
            return {"x": raw.x * 2.0, "y": raw.y}

        def train(self, d, params):
            return d["x"][0, 0]          # leak the prepared payload

    est = Scaled()
    cache = PreparedDataCache()
    model, _secs, conv = run_prepared(est, data, {}, cache=cache)
    assert conv > 0
    assert model == data.x[0, 0] * 2.0   # trained on the OVERRIDDEN payload
    # keyed apart from the plain dense_rows entry of standard estimators
    assert prepared_cache_key(est, data, {}) != \
        prepared_cache_key(get_estimator("logreg"), data, {})
    _, _, conv2 = run_prepared(est, data, {}, cache=cache)
    assert conv2 == 0.0 and cache.counters() == (1, 1)


def test_run_batched_rejects_mixed_formats(data):
    """A batch converts once, so mixed format params must fail loud instead
    of silently training some members on another config's layout."""
    est = get_estimator("gbdt")
    with pytest.raises(ValueError, match="format-uniform"):
        est.run_batched(data, [{"max_bin": 32, "round": 2, "max_depth": 2},
                               {"max_bin": 64, "round": 2, "max_depth": 2}])
    with pytest.raises(ValueError, match="format-uniform"):
        run_prepared_batched(est, data,
                             [{"max_bin": 32}, {"max_bin": 64}],
                             cache=PreparedDataCache())


def test_legacy_run_override_falls_back_uncached(data):
    class Legacy(Estimator):
        name = "legacy-override"

        def train(self, d, params):
            raise AssertionError("train must not be called via run()")

        def run(self, raw, params):
            return "legacy-model", 0.5

    cache = PreparedDataCache()
    model, secs, conv = run_prepared(Legacy(), data, {}, cache=cache)
    assert (model, secs, conv) == ("legacy-model", 0.5, 0.0)
    assert cache.counters() == (0, 0)            # bypassed entirely


def test_local_pool_reports_convert_seconds(data):
    tasks = [TrainTask(task_id=i, estimator="logreg",
                       params={"c": 0.1, "steps": 5}, cost=1.0)
             for i in range(3)]
    cache = PreparedDataCache()
    pool = LocalExecutorPool(1, prepared_cache=cache)
    results = pool.run(schedule(tasks, 1, policy="lpt"), data)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2]
    paid = [r for r in results if r.convert_seconds > 0]
    assert len(paid) == 1                        # only the builder paid
    assert cache.counters() == (2, 1)


# --------------------------------------------------------------------------
# Mesh pool: per-slice placement reuse via the estimator-backed default.
# --------------------------------------------------------------------------

def test_mesh_pool_per_slice_placement_reuse(data):
    cache = PreparedDataCache()
    pool = MeshSliceExecutorPool(slices=["s0", "s1"], prepared_cache=cache)
    tasks = [TrainTask(task_id=i, estimator="logreg",
                       params={"c": 0.1, "steps": 5}, cost=1.0)
             for i in range(6)]
    results = pool.run(schedule(tasks, 2, policy="lpt"), data)
    assert sorted(r.task.task_id for r in results) == list(range(6))
    assert all(r.ok for r in results)
    # one conversion PER SLICE (each slice holds its own resident copy),
    # every later task on the slice reuses it
    assert cache.counters() == (4, 2)
    assert sum(1 for r in results if r.convert_seconds > 0) == 2


def test_mesh_pool_default_runner_fused_batches(data):
    cache = PreparedDataCache()
    pool = MeshSliceExecutorPool(slices=["s0"], prepared_cache=cache)
    tasks = [TrainTask(task_id=i, estimator="logreg",
                       params={"c": 0.1 * (i + 1), "steps": 5}, cost=1.0)
             for i in range(4)]
    (unit,) = fuse_tasks(tasks, max_fuse=4)
    results = pool.run(schedule([unit], 1, policy="lpt"), data)
    assert sorted(r.task.task_id for r in results) == [0, 1, 2, 3]
    assert all(r.ok and r.batch_size == 4 for r in results)
    assert cache.counters() == (0, 1)
    # one build, one carrier: the FULL convert_seconds rides on exactly one
    # member (fusion.charge_carrier — where the planner puts the charge)
    assert sum(1 for r in results if r.convert_seconds > 0) == 1


# --------------------------------------------------------------------------
# Conversion law + conversion-aware scheduling.
# --------------------------------------------------------------------------

def test_cost_model_conversion_law_roundtrip(tmp_path):
    cm = CostModel(str(tmp_path / "cm.json"))
    key = format_key("quantized_bins", {"max_bins": 64})
    assert cm.predict_convert(key, 1000) is None
    cm.observe_convert(key, 0.5, 1000)
    cm.observe_convert(key, 1.0, 2000)
    p = cm.predict_convert(key, 1500)
    assert p is not None and 0.5 <= p <= 1.0
    # bigger data never predicts cheaper conversion
    assert cm.predict_convert(key, 4000) >= cm.predict_convert(key, 1000)
    cm.save()
    warm = CostModel.open(str(tmp_path / "cm.json"))
    assert warm.predict_convert(key, 1500) == pytest.approx(p)


def test_observe_result_feeds_conversion_law(data):
    cm = CostModel()
    task = TrainTask(task_id=0, estimator="gbdt",
                     params={"round": 3, "max_depth": 2, "max_bin": 32})
    from repro_torch.core.interface import TaskResult

    cm.observe_result(TaskResult(task=task, model=object(), train_seconds=0.2,
                                 executor_id=0, convert_seconds=0.4),
                      data.n_rows)
    key = format_key("quantized_bins", {"max_bins": 32})
    assert cm.predict_convert(key, data.n_rows) == pytest.approx(0.4, rel=1e-6)
    # a cache-hit result (convert_seconds == 0) adds nothing
    cm.observe_result(TaskResult(task=task, model=object(), train_seconds=0.2,
                                 executor_id=0), data.n_rows)
    assert cm.predict_convert(key, data.n_rows) == pytest.approx(0.4, rel=1e-6)


def test_charge_first_of_group():
    tasks = [TrainTask(task_id=i, estimator="gbdt",
                       params={"max_bin": 32 if i < 2 else 64}, cost=float(i + 1))
             for i in range(4)]
    charged = charge_first_of_group(
        tasks,
        group_key=lambda t: t.params["max_bin"],
        extra_cost=lambda key: {32: 10.0, 64: None}[key])
    # the MAX-cost unit of the cold 32-bin group pays; unknown-cost group
    # (64) stays uncharged; everything else untouched
    assert [t.cost for t in charged] == [1.0, 12.0, 3.0, 4.0]
    # the charge flows into the plan's makespan estimate
    plan = schedule(charged, 2, policy="lpt")
    assert plan_makespan_estimate(plan) >= 12.0


def test_session_charges_cold_formats(data):
    """End-to-end: a warm conversion law + a cold cache => the first unit of
    each format group is costed with conversion included; a warm cache =>
    no charge."""
    cm = CostModel()
    key = format_key("quantized_bins", {"max_bins": 32})
    cm.observe_convert(key, 5.0, data.n_rows)
    spec = SearchSpec.from_dict({
        "spaces": [{"estimator": "gbdt", "grid": {"eta": [0.1, 0.3]}}],
        "n_executors": 1})
    session = Session(spec)
    tasks = [TrainTask(task_id=i, estimator="gbdt",
                       params={"max_bin": 32}, cost=1.0) for i in range(3)]
    charged = session._charge_conversion(tasks, cm, data)
    assert sorted(t.cost for t in charged) == pytest.approx([1.0, 1.0, 6.0])
    # once the entry is resident the same call charges nothing
    prepare_cached(data, "quantized_bins", {"max_bins": 32})
    uncharged = session._charge_conversion(tasks, cm, data)
    assert [t.cost for t in uncharged] == [1.0, 1.0, 1.0]


def test_fused_charge_survives_bucket_split():
    """The conversion charge rides on a MEMBER (charge_member), so
    split_at_buckets / restrict — which re-sum member costs — keep it."""
    from repro_torch.core.fusion import FusedBatch

    tasks = tuple(TrainTask(task_id=i, estimator="gbdt",
                            params={"round": 4 if i < 2 else 64}, cost=1.0)
                  for i in range(4))
    unit = FusedBatch(tasks=tasks, signature=("gbdt", 64),
                      buckets=(0, 0, 1, 1), cost=4.0)
    charged = unit.charge_member(10.0)
    assert charged.cost == pytest.approx(14.0)
    pieces = charged.split_at_buckets()
    assert sum(p.cost for p in pieces) == pytest.approx(14.0)
    kept = charged.restrict({0, 1, 2, 3})
    assert kept.cost == pytest.approx(14.0)


def test_charge_conversion_respects_mesh_placements(data):
    """Mesh backend: a format counts as warm only when EVERY slice holds
    it; resident-everywhere groups are not re-charged (and a custom
    task_runner reports no placements => no charging at all)."""
    cm = CostModel()
    key = format_key("dense_rows")
    cm.observe_convert(key, 5.0, data.n_rows)
    cache = PreparedDataCache()
    pool = MeshSliceExecutorPool(slices=["s0", "s1"], prepared_cache=cache)
    spec = SearchSpec.from_dict({
        "spaces": [{"estimator": "logreg", "grid": {"c": [0.1]}}],
        "n_executors": 2})
    session = Session(spec, backend=pool)
    tasks = [TrainTask(task_id=i, estimator="logreg",
                       params={"c": 0.1, "steps": 5}, cost=1.0)
             for i in range(4)]
    charged = session._charge_conversion(tasks, cm, data)
    assert sorted(t.cost for t in charged) == pytest.approx([1, 1, 1, 6])
    # run the plan: both slices build their resident copy -> warm everywhere
    list(pool.submit(schedule(charged, 2, policy="lpt"), data))
    assert cache.counters()[1] == 2
    uncharged = session._charge_conversion(tasks, cm, data)
    assert [t.cost for t in uncharged] == [1.0] * 4


# --------------------------------------------------------------------------
# Acceptance: 64-config gbdt grid converts once per (fingerprint, max_bins).
# --------------------------------------------------------------------------

def test_session_64_config_grid_converts_once_per_variant(data):
    spec = SearchSpec.from_dict({
        "spaces": [{
            "estimator": "gbdt",
            "grid": {
                "eta": [0.1, 0.3],
                "lambda": [0.5, 1.0],
                "gamma": [0.0, 0.1],
                "min_child_weight": [1.0, 2.0],
                "round": [1, 2],
                "max_depth": [2],
                "max_bin": [16, 32],
            },
        }],
        "n_executors": 2,
        "policy": "lpt",
        "profiler": {"kind": "analytic"},
    })
    assert spec.n_grid_tasks == 64
    session = Session(spec)
    results = list(session.results(data))
    assert len(results) == 64 and all(r.ok for r in results)
    # EXACTLY one conversion per (dataset-fingerprint, max_bins) pair —
    # across 64 tasks on 2 racing executor threads
    assert session.stats.prepared_cache_misses == 2
    assert session.stats.prepared_cache_hits == 62
    assert session.stats.prepared_cache_hit_rate == pytest.approx(62 / 64)
    # the conversion seconds the search actually paid are surfaced (and
    # equal the sum over the two builder tasks)
    paid = [r.convert_seconds for r in results if r.convert_seconds > 0]
    assert len(paid) == 2
    assert session.stats.convert_seconds_total == pytest.approx(sum(paid))


def test_session_fused_and_sequential_rounds_share_cache(data):
    """A fused session and a sequential session over the same grid hit the
    SAME process-wide entries: the second run converts nothing."""
    base = {
        "spaces": [{"estimator": "gbdt",
                    "grid": {"eta": [0.1, 0.3, 0.9],
                             "round": [1, 2], "max_depth": [2],
                             "max_bin": [16]}}],
        "n_executors": 2,
        "profiler": {"kind": "analytic"},
    }
    fused = Session(SearchSpec.from_dict({**base, "fuse": True, "max_fuse": 3}))
    list(fused.results(data))
    assert fused.stats.prepared_cache_misses == 1
    seq = Session(SearchSpec.from_dict(base))
    results = list(seq.results(data))
    assert seq.stats.prepared_cache_misses == 0
    assert seq.stats.prepared_cache_hits == len(results)
    assert seq.stats.convert_seconds_total == 0.0


def test_wal_journals_convert_seconds(data, tmp_path):
    from repro_torch.core import SearchWAL

    wal_path = str(tmp_path / "wal.jsonl")
    pool = LocalExecutorPool(1, wal=SearchWAL(wal_path),
                             prepared_cache=PreparedDataCache())
    tasks = [TrainTask(task_id=i, estimator="logreg",
                       params={"c": 0.1, "steps": 5}, cost=1.0)
             for i in range(2)]
    pool.run(schedule(tasks, 1, policy="lpt"), data)
    recs = SearchWAL(wal_path).completed()
    assert sorted(recs) == [0, 1]
    assert sum(1 for r in recs.values() if r.convert_seconds > 0) == 1
