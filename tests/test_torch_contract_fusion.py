"""The JAX package's ``tests/test_fusion.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    Task-fusion correctness (core/fusion.py + tabular train_batched paths).

    Covers the DESIGN.md §3.2 contract: batched-vs-sequential parity (identical
    per-task metrics within 1e-5 on the device-free CPU path), padding/masking
    for heterogeneous structural params, scheduler/replan behaviour over fused
    units including bucket splitting, compile-cache hit accounting surfaced via
    ``SearchStats``, and unbatched results flowing through WAL/CostModel
    unchanged.
"""
import numpy as np
import pytest

import repro_torch.tabular  # noqa: F401
from repro_torch.core import (
    CompileCache,
    DenseMatrix,
    FusedBatch,
    SearchSpec,
    SearchWAL,
    Session,
    TrainTask,
    auc,
    compile_cache,
    convert,
    fuse_tasks,
    get_estimator,
    replan,
    restrict,
    schedule,
    split_for_balance,
)
from repro_torch.core.cost_model import CostModel
from repro_torch.core.fusion import pad_pow2
from repro_torch.core.interface import Estimator, register_estimator, unregister_estimator

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


@pytest.fixture(scope="module")
def small_data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 10)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] + 0.3 * rng.normal(size=500) > 0).astype(np.float32)
    return DenseMatrix(x, y)


def mk_tasks(estimator, param_list, costs=None, start=0):
    return [
        TrainTask(task_id=start + i, estimator=estimator, params=p,
                  cost=None if costs is None else costs[i])
        for i, p in enumerate(param_list)
    ]


# --------------------------------------------------------------------------
# Batched-vs-sequential parity, including structural padding/masking.
# --------------------------------------------------------------------------

PARITY_CASES = [
    ("gbdt", "quantized_bins", [
        # heterogeneous round / max_depth / max_bin in ONE batch: rounds and
        # depth are masked, bins are coarsened per config under a shared pad
        {"round": 8, "max_depth": 3, "max_bin": 32, "eta": 0.3},
        {"round": 14, "max_depth": 4, "max_bin": 64, "eta": 0.1, "lambda": 0.5},
        {"round": 4, "max_depth": 5, "max_bin": 128, "eta": 0.9, "gamma": 0.1},
        {"round": 11, "max_depth": 3, "max_bin": 32, "min_child_weight": 3.0},
    ]),
    ("forest", "quantized_bins", [
        {"n_estimators": 4, "max_depth": 3, "seed": 0},
        {"n_estimators": 7, "max_depth": 5, "seed": 1},
        {"n_estimators": 3, "max_depth": 4, "seed": 2, "min_samples_leaf": 2.0},
    ]),
    ("logreg", "dense_rows", [
        {"c": 0.1, "steps": 60},
        {"c": 1.0, "steps": 150, "lr": 0.1},
        {"c": 0.3, "steps": 90},
    ]),
    ("mlp", "dense_rows", [
        {"network": "16_16", "steps": 40, "learning_rate": 0.01, "seed": 0},
        {"network": "16_16", "steps": 90, "learning_rate": 0.003, "seed": 1},
    ]),
]


@pytest.mark.parametrize("family,fmt,configs",
                         PARITY_CASES, ids=[c[0] for c in PARITY_CASES])
def test_batched_matches_sequential(small_data, family, fmt, configs):
    est = get_estimator(family)
    data = convert(small_data, fmt)
    batched = est.train_batched(data, configs)
    assert len(batched) == len(configs)
    x, y = small_data.x, small_data.y
    for cfg, mb in zip(configs, batched):
        ms = est.train(data, cfg)
        ps, pb = ms.predict_proba(x), mb.predict_proba(x)
        assert float(np.abs(ps - pb).max()) < 1e-5, cfg
        assert abs(auc(y, ps) - auc(y, pb)) < 1e-5, cfg


def test_mlp_batched_rejects_mixed_architectures(small_data):
    est = get_estimator("mlp")
    data = convert(small_data, "dense_rows")
    with pytest.raises(ValueError):
        est.train_batched(data, [{"network": "8_8", "steps": 5},
                                 {"network": "16", "steps": 5}])


def test_pad_pow2():
    assert [pad_pow2(n) for n in (1, 2, 3, 8, 9, 150, 256)] == \
        [1, 2, 4, 8, 16, 256, 256]


# --------------------------------------------------------------------------
# Grouping, signatures and the compile cache.
# --------------------------------------------------------------------------

class _UnfusableEstimator(Estimator):
    name = "unfusable-stub"

    def train(self, data, params):  # pragma: no cover - never trained here
        raise NotImplementedError


@pytest.fixture
def unfusable():
    register_estimator(_UnfusableEstimator)
    yield _UnfusableEstimator.name
    unregister_estimator(_UnfusableEstimator.name)


def test_fuse_tasks_groups_by_family_and_signature(unfusable):
    tasks = (
        mk_tasks("gbdt", [{"round": 5}] * 5) +
        mk_tasks("logreg", [{"steps": 50}] * 3, start=5) +
        mk_tasks(unfusable, [{}], start=8) +
        mk_tasks("mlp", [{"network": "8"}, {"network": "16"}], start=9)
    )
    units = fuse_tasks(tasks, max_fuse=16)
    fused = [u for u in units if isinstance(u, FusedBatch)]
    singles = [u for u in units if not isinstance(u, FusedBatch)]
    assert sorted(u.estimator for u in fused) == ["gbdt", "logreg"]
    # the unfusable task and the two architecture-singleton mlp tasks pass
    # through as plain tasks
    assert sorted(t.task_id for t in singles) == [8, 9, 10]
    # every input task appears exactly once
    all_ids = sorted(
        [t.task_id for t in singles]
        + [m.task_id for u in fused for m in u.tasks])
    assert all_ids == list(range(11))


def test_fuse_tasks_chunks_and_is_deterministic():
    tasks = mk_tasks("logreg", [{"steps": 50 + i} for i in range(10)],
                     costs=[1.0] * 10)
    a = fuse_tasks(tasks, max_fuse=4)
    b = fuse_tasks(list(reversed(tasks)), max_fuse=4)
    assert [u.batch_size for u in a] == [4, 4, 2]
    # chunking is sorted (bucket, task_id): input order does not matter
    assert [[m.task_id for m in u.tasks] for u in a] == \
        [[m.task_id for m in u.tasks] for u in b]
    assert a[0].cost == pytest.approx(4.0)   # sum of member costs


def test_fused_batch_ids_stable_and_disjoint():
    tasks = mk_tasks("logreg", [{"steps": 50}] * 6)
    units = fuse_tasks(tasks, max_fuse=3)
    ids = [u.task_id for u in units]
    assert len(set(ids)) == len(ids)
    assert all(i < 0 for i in ids)           # never collides with real tasks
    # restricting away non-minimal members keeps the id stable
    u = units[0]
    sub = u.restrict({min(u.member_ids()), max(u.member_ids())})
    assert sub.task_id == u.task_id


def test_compile_cache_counts_and_reuses():
    cache = CompileCache()
    built = []

    def builder():
        built.append(1)
        return lambda: "fn"

    f1 = cache.get(("sig", 1), builder)
    f2 = cache.get(("sig", 1), builder)
    f3 = cache.get(("sig", 2), builder)
    assert f1 is f2 and f1 is not f3
    assert (cache.hits, cache.misses, len(built)) == (1, 2, 2)
    assert cache.hit_rate == pytest.approx(1 / 3)
    cache.clear()
    assert cache.counters() == (0, 0) and cache.n_entries == 0


def test_batched_training_hits_compile_cache(small_data):
    est = get_estimator("logreg")
    data = convert(small_data, "dense_rows")
    cache = CompileCache()
    # steps 150/200 share a pow-2 pad bucket (256): one compile, then hits
    est.train_batched(data, [{"steps": 150}, {"steps": 200}], cache=cache)
    est.train_batched(data, [{"steps": 160}, {"steps": 180}], cache=cache)
    est.train_batched(data, [{"steps": 140}, {"steps": 130}], cache=cache)
    assert cache.misses == 1 and cache.hits == 2


def test_batch_axis_pads_to_shared_signature(small_data):
    """A WAL-restricted / split odd-sized batch pads its batch axis pow-2
    (replicated last config, outputs discarded) and reuses the full-width
    compiled program instead of compiling a fresh odd size."""
    est = get_estimator("logreg")
    data = convert(small_data, "dense_rows")
    cache = CompileCache()
    four = est.train_batched(
        data, [{"steps": 200, "c": 0.1 * (i + 1)} for i in range(4)],
        cache=cache)
    three = est.train_batched(
        data, [{"steps": 200, "c": 0.1 * (i + 1)} for i in range(3)],
        cache=cache)
    assert len(four) == 4 and len(three) == 3
    assert cache.misses == 1 and cache.hits == 1
    # the shared real configs produce identical models either way
    x = small_data.x
    for a, b in zip(four[:3], three):
        assert float(np.abs(a.predict_proba(x) - b.predict_proba(x)).max()) == 0.0


def test_fuse_buckets_sort_numerically():
    """Chunks group numerically-adjacent buckets — a repr() sort would put
    (128,) before (16,) and fuse distant shapes into one padded program."""
    steps_by_bucket = {16: 10, 32: 30, 64: 60, 128: 120, 256: 250}
    tasks = []
    for i, steps in enumerate(sorted(steps_by_bucket.values())):
        tasks += mk_tasks("logreg", [{"steps": steps}] * 2, start=2 * i)
    units = fuse_tasks(tasks, max_fuse=4)
    est = get_estimator("logreg")
    for u in units:
        buckets = [est.fuse_bucket(m.params)[0] for m in u.tasks]
        # every chunk spans at most one pow-2 neighbour pair, never a gap
        assert max(buckets) <= 2 * min(buckets)


# --------------------------------------------------------------------------
# Scheduler integration: fused units, splitting, replan.
# --------------------------------------------------------------------------

def _fused_units_with_buckets():
    heavy = mk_tasks("gbdt", [{"round": 40}] * 4, costs=[4.0] * 4)
    light = mk_tasks("gbdt", [{"round": 5}] * 4, costs=[1.0] * 4, start=4)
    units = fuse_tasks(heavy + light, max_fuse=8)
    assert len(units) == 1 and units[0].batch_size == 8
    assert len(set(units[0].buckets)) == 2
    return units


def test_split_at_buckets():
    (unit,) = _fused_units_with_buckets()
    pieces = unit.split_at_buckets()
    assert sorted(p.batch_size for p in pieces) == [4, 4]
    assert {m.task_id for p in pieces for m in p.tasks} == unit.member_ids()
    assert sum(p.cost for p in pieces) == pytest.approx(unit.cost)
    # a single-bucket batch refuses to split
    assert pieces[0].split_at_buckets() == [pieces[0]]


def test_split_for_balance_splits_bottleneck():
    units = _fused_units_with_buckets()
    out = split_for_balance(units, n_executors=2)
    assert len(out) == 2
    est = schedule(out, 2, policy="lpt").estimated_makespan
    assert est < schedule(units, 2, policy="lpt").estimated_makespan


def test_schedule_accepts_fused_units_in_all_policies():
    units = _fused_units_with_buckets() + mk_tasks(
        "logreg", [{"steps": 10}], costs=[0.5], start=99)
    for policy in ("lpt", "random", "round_robin", "dynamic"):
        plan = schedule(units, 2, policy=policy)
        assert sorted(u.task_id for u in plan.all_tasks()) == \
            sorted(u.task_id for u in units)


def test_replan_with_splitter_never_worse():
    units = _fused_units_with_buckets()
    current = schedule(units, 2, policy="lpt")
    out = replan(units, 2, current=restrict(current, units),
                 splitter=split_for_balance)
    assert out.estimated_makespan <= current.estimated_makespan
    # the fresh side actually used the split pieces
    assert len(out.all_tasks()) > len(units)


def test_split_singleton_restores_solo_cost():
    """A member stranded back into sequential execution by a bucket split
    must carry its SOLO cost estimate again — not the amortized batched one
    — or LPT under-packs the executor and the sequential obs/est ratio of
    the CostModel learns a spurious speedup."""

    class FakeAmortized:
        def estimate(self, task, n_rows, *, batched=False):
            return task.cost / 5.0 if batched else task.cost

    heavy = mk_tasks("gbdt", [{"round": 40}] * 3, costs=[10.0] * 3)
    light = mk_tasks("gbdt", [{"round": 5}] * 1, costs=[1.0], start=3)
    (unit,) = fuse_tasks(heavy + light, max_fuse=4,
                         cost_model=FakeAmortized(), n_rows=100)
    # members carry amortized costs inside the batch (10/5 and 1/5)
    assert sorted(round(t.cost, 3) for t in unit.tasks) == [0.2, 2.0, 2.0, 2.0]
    out = split_for_balance([unit], n_executors=4)
    singles = [u for u in out if not isinstance(u, FusedBatch)]
    assert len(singles) == 1
    assert singles[0].cost == pytest.approx(1.0)        # solo cost restored


def test_fuse_bucket_matches_padding():
    """Buckets round UP (pad_pow2) exactly like train_batched's padding, so
    every same-bucket chunk shares one compiled signature."""
    est = get_estimator("logreg")
    assert est.fuse_bucket({"steps": 150}) == (256,)    # not nearest (128)
    assert est.fuse_bucket({"steps": 129}) == est.fuse_bucket({"steps": 256})
    gb = get_estimator("gbdt")
    # max_bin is a FORMAT parameter (§3.3): it moved from the bucket into
    # fuse_signature, so batches never mix prepared-data variants
    assert gb.fuse_bucket({"round": 33, "max_depth": 4, "max_bin": 32}) == \
        (64, 4)
    assert gb.fuse_signature({"max_bin": 32}) != gb.fuse_signature({"max_bin": 64})


def test_fused_batch_recost_keeps_buckets():
    (unit,) = _fused_units_with_buckets()
    re = unit.recost(lambda t: t.with_cost(2.0))
    assert re.buckets == unit.buckets
    assert re.cost == pytest.approx(2.0 * unit.batch_size)
    assert re.task_id == unit.task_id


# --------------------------------------------------------------------------
# Session integration: stats, WAL, cost-model batched law.
# --------------------------------------------------------------------------

def _fused_spec(**kw):
    spaces = [{"estimator": "logreg",
               "grid": {"c": [0.1, 0.3, 0.9], "steps": [40, 60]}}]
    return SearchSpec.from_dict({
        "spaces": spaces, "n_executors": 2, "policy": "lpt",
        "profiler": {"kind": "analytic"}, "fuse": True, "max_fuse": 4, **kw})


def test_session_fused_stats_and_stream(small_data, tmp_path):
    train, valid = small_data.split((0.8, 0.2), seed=0)
    compile_cache().clear()
    session = Session(_fused_spec(wal_path=str(tmp_path / "wal.jsonl")))
    results = list(session.results(train, valid))
    assert len(results) == 6
    assert all(r.ok for r in results)
    # the bulk rode in fused batches (split_for_balance may strand a task
    # or two as singletons when it cuts a bottleneck batch)
    assert sum(r.batch_size > 1 for r in results) >= 4
    assert session.stats.n_fused_tasks == 6
    assert session.stats.n_fused_batches == 2
    assert session.stats.compile_cache_misses >= 1
    # per-task amortized seconds land in the WAL for every member
    wal = SearchWAL(str(tmp_path / "wal.jsonl"))
    assert all(wal.is_done(r.task.task_id) for r in results)
    # resume: nothing left to run
    resumed = Session.resume(str(tmp_path / "wal.jsonl"), _fused_spec())
    assert list(resumed.results(train, valid)) == []
    # a second search of the same shapes is all cache hits — SearchStats
    # reports this session's share of the process-wide CompileCache traffic
    rerun = Session(_fused_spec())
    list(rerun.results(train, valid))
    assert rerun.stats.compile_cache_misses == 0
    assert rerun.stats.compile_cache_hits >= 1


def test_session_fused_results_match_unfused(small_data):
    train, valid = small_data.split((0.8, 0.2), seed=0)
    fused = Session(_fused_spec()).search(train, valid)
    plain = Session(_fused_spec(fuse=False)).search(train, valid)
    by_id = {r.task.task_id: r for r in plain.results}
    for r in fused.results:
        pf = r.model.predict_proba(valid.x)
        pp = by_id[r.task.task_id].model.predict_proba(valid.x)
        assert float(np.abs(pf - pp).max()) < 1e-5


def test_fused_results_feed_batched_cost_law(small_data, tmp_path):
    train, valid = small_data.split((0.8, 0.2), seed=0)
    cm = CostModel()
    spec = _fused_spec(profiler=cm, replan_threshold=50.0,
                       wal_path=str(tmp_path / "w.jsonl"),
                       cost_model_path=str(tmp_path / "cm.json"))
    session = Session(spec)
    list(session.results(train, valid))
    model = session.cost_model
    task = TrainTask(task_id=0, estimator="logreg", params={"c": 0.1, "steps": 40})
    batched = model.estimate(task, train.n_rows, batched=True)
    assert batched is not None and batched > 0
    # the batched law is its own family: observing fused results must not
    # have created a sequential law out of thin air
    assert model.predict(task, train.n_rows, batched=False) is None
    # a fully-unseen family answers None either way — fuse_tasks then keeps
    # the task's prior (sequential) cost as the conservative amortized guess
    other = TrainTask(task_id=1, estimator="gbdt", params={}, cost=2.5)
    assert model.estimate(other, train.n_rows, batched=True) is None
    twin = TrainTask(task_id=2, estimator="gbdt", params={}, cost=2.5)
    (unit,) = fuse_tasks([other, twin], max_fuse=4,
                         cost_model=model, n_rows=train.n_rows)
    assert unit.cost == pytest.approx(5.0)
