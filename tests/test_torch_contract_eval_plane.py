"""The JAX package's ``tests/test_eval_plane.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    Fused validation plane (DESIGN.md §3.4): jitted predictor parity,
    executor-side scoring in both pools, scored streaming without driver-side
    prediction, the CostModel eval law, and the memoized MultiModel.
"""
import numpy as np
import pytest

import repro_torch.tabular  # noqa: F401  (registers the estimators)
from repro_torch.core import (
    CostModel,
    DenseMatrix,
    GridBuilder,
    LocalExecutorPool,
    MeshSliceExecutorPool,
    MultiModel,
    SearchSpec,
    Session,
    TaskResult,
    TrainTask,
    charge_units,
    get_estimator,
    schedule,
    stable_sigmoid,
)
from repro_torch.core.evaluation import EvalPlan, evaluate_models, predict_compile_cache
from repro_torch.core.fault import WALRecord
from repro_torch.core.fusion import FusedBatch
from repro_torch.core.results import auc
from repro_torch.tabular.forest import ForestModel
from repro_torch.tabular.gbdt import GBDTModel
from repro_torch.tabular.logreg import LogRegModel
from repro_torch.tabular.mlp import MLPModel

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")


@pytest.fixture(scope="module")
def small_data():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 8)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.normal(size=400) > 0).astype(np.float32)
    data = DenseMatrix(x, y)
    train, valid = data.split((0.75, 0.25), seed=0)
    return train, valid


# ---------------------------------------------------------------------------
# stable sigmoid (satellite: overflow fix)
# ---------------------------------------------------------------------------

class TestStableSigmoid:
    def test_extreme_margins_no_overflow(self):
        z = np.array([-1e4, -1000.0, -100.0, 0.0, 100.0, 1000.0, 1e4])
        with np.errstate(over="raise", invalid="raise"):
            p = stable_sigmoid(z)
        assert np.all((p >= 0.0) & (p <= 1.0))
        assert p[3] == 0.5
        assert p[0] == 0.0 and p[-1] == 1.0

    def test_matches_naive_in_safe_range(self):
        z = np.linspace(-30, 30, 101)
        naive = 1.0 / (1.0 + np.exp(-z))
        np.testing.assert_allclose(stable_sigmoid(z), naive, rtol=1e-12)

    def test_keeps_tiny_tail_precision(self):
        # naive float64 at z=-745 overflows exp and rounds to exactly 0 via
        # inf; the stable form returns the representable subnormal tail
        assert stable_sigmoid(np.array([-700.0]))[0] > 0.0

    def test_model_predict_proba_extreme_margins(self):
        # a gbdt model whose leaves pile up to huge |margin| must not warn
        feat = np.zeros((1, 1), np.int32)
        thresh = np.zeros((1, 1), np.float32)
        leaves = np.array([[-2000.0, 2000.0]], np.float32)
        m = GBDTModel(feat, thresh, leaves, base=0.0, max_depth=1)
        x = np.array([[-1.0], [1.0]], np.float32)
        with np.errstate(over="raise", invalid="raise"):
            p = m.predict_proba(x)
        assert p[0] == 0.0 and p[1] == 1.0


# ---------------------------------------------------------------------------
# jitted predictor parity (satellite: bit-level / ~1e-6 across families)
# ---------------------------------------------------------------------------

class TestJittedParity:
    def test_gbdt_solo_bitwise(self, small_data):
        train, valid = small_data
        est = get_estimator("gbdt")
        m, _ = est.run(train, {"round": 5, "max_depth": 3, "max_bin": 32})
        np.testing.assert_array_equal(m.predict_margin(valid.x),
                                      m.predict_margin_device(valid.x))
        np.testing.assert_array_equal(m.predict_proba(valid.x),
                                      m.predict_proba_device(valid.x))

    def test_gbdt_fused_depth_padded_bitwise(self, small_data):
        # heterogeneous rounds AND depths: train_batched pads depth with
        # sentinel splits; the batched predictor must route identically
        train, valid = small_data
        est = get_estimator("gbdt")
        configs = [{"round": r, "max_depth": d, "max_bin": 32, "eta": e}
                   for r, d, e in [(3, 2, 0.1), (5, 3, 0.3), (7, 3, 0.5),
                                   (4, 2, 0.9)]]
        models, _ = est.run_batched(train, configs)
        batched = GBDTModel.predict_margin_batched(models, valid.x)
        for i, m in enumerate(models):
            np.testing.assert_array_equal(m.predict_margin(valid.x), batched[i])

    def test_gbdt_mixed_depth_stack(self, small_data):
        # predict_*_batched groups by depth, so even a stack fused units
        # never produce (solo models of different depths) scores correctly
        train, valid = small_data
        est = get_estimator("gbdt")
        m2, _ = est.run(train, {"round": 3, "max_depth": 2, "max_bin": 32})
        m4, _ = est.run(train, {"round": 4, "max_depth": 4, "max_bin": 32})
        batched = GBDTModel.predict_proba_batched([m2, m4, m2], valid.x)
        np.testing.assert_array_equal(batched[0], m2.predict_proba(valid.x))
        np.testing.assert_array_equal(batched[1], m4.predict_proba(valid.x))
        np.testing.assert_array_equal(batched[2], batched[0])

    def test_forest_solo_and_batched_bitwise(self, small_data):
        train, valid = small_data
        est = get_estimator("forest")
        solo, _ = est.run(train, {"n_estimators": 5, "max_depth": 3})
        np.testing.assert_array_equal(solo.predict_proba(valid.x),
                                      solo.predict_proba_device(valid.x))
        models, _ = est.run_batched(train, [
            {"n_estimators": n, "max_depth": 3, "seed": s}
            for n, s in [(3, 0), (5, 1), (4, 2)]])
        batched = ForestModel.predict_proba_batched(models, valid.x)
        for i, m in enumerate(models):
            np.testing.assert_array_equal(m.predict_proba(valid.x), batched[i])

    def test_logreg_parity(self, small_data):
        train, valid = small_data
        est = get_estimator("logreg")
        m, _ = est.run(train, {"steps": 50})
        np.testing.assert_allclose(m.predict_proba(valid.x),
                                   m.predict_proba_device(valid.x), atol=1e-6)
        models, _ = est.run_batched(train, [{"steps": 50, "c": c}
                                            for c in (0.1, 0.5, 1.0)])
        batched = LogRegModel.predict_proba_batched(models, valid.x)
        for i, m in enumerate(models):
            np.testing.assert_allclose(m.predict_proba(valid.x), batched[i],
                                       atol=1e-6)

    def test_mlp_parity(self, small_data):
        train, valid = small_data
        est = get_estimator("mlp")
        m, _ = est.run(train, {"steps": 30, "network": "16_16"})
        np.testing.assert_allclose(m.predict_proba(valid.x),
                                   m.predict_proba_device(valid.x), atol=1e-6)
        models, _ = est.run_batched(train, [
            {"steps": 30, "network": "16_16", "seed": s} for s in (0, 1, 2)])
        batched = MLPModel.predict_proba_batched(models, valid.x)
        for i, m in enumerate(models):
            np.testing.assert_allclose(m.predict_proba(valid.x), batched[i],
                                       atol=1e-6)

    def test_predict_compile_cache_reuses_programs(self, small_data):
        train, valid = small_data
        est = get_estimator("gbdt")
        m, _ = est.run(train, {"round": 6, "max_depth": 3, "max_bin": 32})
        cache = predict_compile_cache()
        m.predict_proba_device(valid.x)
        hits0, misses0 = cache.counters()
        m.predict_proba_device(valid.x)       # same (depth, pad, B, shape)
        hits1, misses1 = cache.counters()
        assert hits1 == hits0 + 1 and misses1 == misses0


# ---------------------------------------------------------------------------
# executor-side scoring (tentpole: both pools)
# ---------------------------------------------------------------------------

def _tasks(estimator, grids):
    return [TrainTask(task_id=i, estimator=estimator, params=p, cost=1.0)
            for i, p in enumerate(grids)]


class TestExecutorScoring:
    def test_local_pool_scores_match_driver(self, small_data):
        train, valid = small_data
        tasks = _tasks("gbdt", [{"round": 3, "max_depth": 2, "max_bin": 32,
                                 "eta": e} for e in (0.1, 0.3, 0.9)])
        pool = LocalExecutorPool(2)
        results = pool.run(schedule(tasks, 2), train, EvalPlan(valid, "auc"))
        assert len(results) == 3
        for r in results:
            assert r.ok and r.score is not None and r.eval_seconds > 0
            expected = auc(valid.y, r.model.predict_proba(valid.x))
            assert abs(r.score - expected) < 1e-6

    def test_local_pool_wal_carries_score(self, small_data):
        train, valid = small_data
        tasks = _tasks("logreg", [{"c": 0.1, "steps": 20}])
        pool = LocalExecutorPool(1)
        [res] = pool.run(schedule(tasks, 1), train, EvalPlan(valid, "auc"))
        rec = pool.wal.completed()[tasks[0].task_id]
        assert rec.score == res.score
        assert rec.eval_seconds == res.eval_seconds > 0

    def test_no_validate_means_no_score(self, small_data):
        train, _ = small_data
        tasks = _tasks("logreg", [{"c": 0.1, "steps": 20}])
        [res] = LocalExecutorPool(1).run(schedule(tasks, 1), train)
        assert res.score is None and res.eval_seconds == 0.0

    def test_fused_unit_scores_whole_batch(self, small_data):
        train, valid = small_data
        spec = SearchSpec(
            spaces=[GridBuilder("gbdt").add_grid("eta", [0.1, 0.3, 0.5, 0.9])
                    .add_grid("round", [3, 5]).build()],
            n_executors=2, fuse=True, max_fuse=4)
        session = Session(spec)
        results = list(session.results(train, valid))
        assert all(r.ok and r.score is not None for r in results)
        fused = [r for r in results if r.batch_size > 1]
        assert fused, "expected fused batches in this grid"
        assert all(r.eval_seconds > 0 for r in fused)

    def test_mesh_pool_scores_per_slice(self, small_data):
        train, valid = small_data
        pool = MeshSliceExecutorPool(slices=["s0", "s1"])
        tasks = _tasks("logreg", [{"c": c, "steps": 20}
                                  for c in (0.1, 0.3, 1.0, 3.0)])
        results = pool.run(schedule(tasks, 2, policy="round_robin"), train,
                           EvalPlan(valid, "auc"))
        assert all(r.ok and r.score is not None for r in results)
        # per-placement residency: each slice builds its own train entry
        # AND its own eval entry — 4 builds total, the rest are hits
        hits, misses = pool.prepared_cache.counters()
        assert misses == 4
        assert hits == 2 * len(tasks) - misses

    def test_mesh_custom_runner_skips_scoring(self, small_data):
        train, valid = small_data

        def runner(task, sl, data):
            return 0.123, 0.01              # opaque payload (LM loss style)

        pool = MeshSliceExecutorPool(slices=["s0"], task_runner=runner)
        tasks = _tasks("logreg", [{"c": 0.1}])
        [res] = pool.run(schedule(tasks, 1), train, EvalPlan(valid, "auc"))
        assert res.ok and res.score is None and res.model == 0.123

    def test_eval_failure_degrades_to_none_score(self, small_data):
        train, valid = small_data

        class Boom(GBDTModel):
            def predict_proba_device(self, x, *, cache=None):
                raise RuntimeError("scoring exploded")

            @classmethod
            def predict_proba_batched(cls, models, x, *, cache=None):
                raise RuntimeError("scoring exploded")

        est = get_estimator("gbdt")
        m, _ = est.run(train, {"round": 2, "max_depth": 2, "max_bin": 32})
        boom = Boom(m.feat, m.thresh, m.leaves, m.base, m.max_depth)
        scores, eval_s = evaluate_models(est, [boom], EvalPlan(valid, "auc"))
        assert scores == [None] and eval_s == 0.0


# ---------------------------------------------------------------------------
# scored streaming: no driver-side predict on the streaming path
# ---------------------------------------------------------------------------

class TestScoredStreaming:
    def test_stream_carries_scores_with_poisoned_numpy_predictor(
            self, small_data, monkeypatch):
        train, valid = small_data

        def boom(self, x):
            raise AssertionError("driver-side numpy predict on streaming path")

        monkeypatch.setattr(GBDTModel, "predict_proba", boom)
        monkeypatch.setattr(GBDTModel, "predict_margin", boom)
        monkeypatch.setattr(LogRegModel, "predict_proba", boom)
        spec = SearchSpec(
            spaces=[GridBuilder("gbdt").add_grid("eta", [0.1, 0.3])
                    .add_grid("round", [3, 5]).build(),
                    GridBuilder("logreg").add_grid("c", [0.1, 1.0]).build()],
            n_executors=2, target_metric=0.9999)
        session = Session(spec)
        results = list(session.results(train, valid))
        assert results, "stream yielded nothing"
        assert all(r.ok and r.score is not None for r in results)
        assert session.stats.eval_seconds_total > 0

    def test_target_metric_stops_from_streamed_score(self, small_data):
        train, valid = small_data
        spec = SearchSpec(
            spaces=[GridBuilder("logreg").add_grid(
                "c", [0.1, 0.3, 1.0, 3.0]).build()],
            n_executors=1, target_metric=0.0)   # any score >= 0 stops it
        session = Session(spec)
        results = list(session.results(train, valid))
        assert session.stop_reason == "target_metric"
        assert len(results) < 4

    def test_predict_compile_stats_surface(self, small_data):
        train, valid = small_data
        spec = SearchSpec(
            spaces=[GridBuilder("logreg").add_grid("c", [0.1, 1.0]).build()],
            n_executors=1)
        session = Session(spec)
        list(session.results(train, valid))
        st = session.stats
        assert st.predict_compile_cache_hits + st.predict_compile_cache_misses > 0
        assert 0.0 <= st.predict_compile_cache_hit_rate <= 1.0

    def test_foreign_backend_falls_back_to_driver_scoring(self, small_data):
        """A backend whose submit lacks the validate kwarg still works —
        the Session computes scores driver-side, lazily."""
        train, valid = small_data

        class MinimalBackend:
            def __init__(self):
                from repro_torch.core.fault import SearchWAL

                self.wal = SearchWAL(None)
                self._inner = LocalExecutorPool(1, wal=self.wal)

            n_executors = 1
            dead_executors = frozenset()

            def submit(self, assignment, data):
                return self._inner.submit(assignment, data)

        spec = SearchSpec(
            spaces=[GridBuilder("logreg").add_grid("c", [0.1]).build()],
            n_executors=1, target_metric=0.0)
        session = Session(spec, backend=MinimalBackend())
        results = list(session.results(train, valid))
        assert results and results[0].score is None     # no executor score
        assert session.stop_reason == "target_metric"   # driver fallback


# ---------------------------------------------------------------------------
# eval as a scheduled cost (tentpole part iii)
# ---------------------------------------------------------------------------

class TestEvalLaw:
    def _task(self, tid=0, **params):
        return TrainTask(task_id=tid, estimator="gbdt",
                         params={"round": 10, "max_depth": 4, **params})

    def test_observe_predict_roundtrip(self):
        cm = CostModel()
        t = self._task()
        assert cm.predict_eval(t, 1000) is None
        cm.observe_eval(t, 0.1, 1000)
        cm.observe_eval(t, 0.4, 4000)
        est = cm.predict_eval(t, 2000)
        assert est is not None and 0.1 < est < 0.4
        # monotone in eval rows (law exponents are clamped >= 0)
        assert cm.predict_eval(t, 8000) >= cm.predict_eval(t, 1000)

    def test_bucket_resolution_beats_pooled(self):
        cm = CostModel()
        big = self._task(0, round=90, max_depth=6)
        small = self._task(1, round=10, max_depth=3)
        cm.observe_eval(big, 1.0, 1000)
        cm.observe_eval(small, 0.05, 1000)
        assert cm.predict_eval(big, 1000) == pytest.approx(1.0)
        assert cm.predict_eval(small, 1000) == pytest.approx(0.05)
        # an unseen bucket falls back to the pooled family law
        other = self._task(2, round=30, max_depth=5)
        pooled = cm.predict_eval(other, 1000)
        assert pooled is not None and 0.05 < pooled < 1.0
        # a bare family string reads the pooled law directly
        assert cm.predict_eval("gbdt", 1000) == pytest.approx(pooled)

    def test_eval_law_persists(self, tmp_path):
        path = str(tmp_path / "cm.json")
        cm = CostModel(path)
        t = self._task()
        cm.observe_eval(t, 0.2, 1000)
        cm.save()
        warm = CostModel.open(path)
        assert warm.predict_eval(t, 1000) == pytest.approx(0.2)

    def test_observe_result_feeds_eval_law(self):
        cm = CostModel()
        t = self._task()
        res = TaskResult(task=t, model=object(), train_seconds=1.0,
                         executor_id=0, eval_seconds=0.25)
        cm.observe_result(res, n_rows=5000, eval_rows=1000)
        assert cm.predict_eval(t, 1000) == pytest.approx(0.25)

    def test_charge_units_adds_recurring_cost(self):
        tasks = [TrainTask(task_id=i, estimator="gbdt",
                           params={"round": 10, "max_depth": 4}, cost=2.0)
                 for i in range(3)]
        charged = charge_units(tasks, lambda t: 0.5)
        assert [t.cost for t in charged] == [2.5, 2.5, 2.5]
        # None extra and cost-less units pass through untouched
        uncosted = [TrainTask(task_id=9, estimator="gbdt", params={})]
        assert charge_units(uncosted, lambda t: 0.5)[0].cost is None
        assert charge_units(tasks, lambda t: None)[0].cost == 2.0

    def test_fused_charge_each_survives_split(self):
        tasks = tuple(
            TrainTask(task_id=i, estimator="gbdt",
                      params={"round": r, "max_depth": 4}, cost=1.0)
            for i, r in enumerate((8, 8, 16, 16)))
        unit = FusedBatch(tasks=tasks, signature=("gbdt",),
                          buckets=(8, 8, 16, 16), cost=4.0,
                          prior_costs=(1.0, 1.0, 1.0, 1.0))
        charged = unit.charge_each(lambda m: 0.25)
        assert charged.cost == pytest.approx(5.0)
        pieces = charged.split_at_buckets()
        assert sum(p.cost for p in pieces) == pytest.approx(5.0)
        # a stranded singleton's restored solo cost keeps its eval share
        assert charged.unfused_task(0).cost == pytest.approx(1.25)

    def test_session_drift_window_includes_eval(self, small_data):
        """Planned costs carry predict_eval once the law is warm: second
        session plans with eval included (cost model estimates > 0)."""
        train, valid = small_data
        cm = CostModel()
        spec = SearchSpec(
            spaces=[GridBuilder("logreg").add_grid("c", [0.1, 1.0]).build()],
            n_executors=1, profiler=cm, replan_threshold=100.0)
        s1 = Session(spec)
        list(s1.results(train, valid))
        t = TrainTask(task_id=0, estimator="logreg", params={"c": 0.1})
        assert cm.predict_eval(t, valid.n_rows) is not None


# ---------------------------------------------------------------------------
# MultiModel memoization + ModelScore breakdown (satellite)
# ---------------------------------------------------------------------------

class _CountingModel:
    def __init__(self):
        self.calls = 0

    def predict_proba(self, x):
        self.calls += 1
        return np.linspace(0.1, 0.9, x.shape[0])


class TestMultiModelMemo:
    def _results(self, n=3):
        out = []
        for i in range(n):
            t = TrainTask(task_id=i, estimator="gbdt", params={"i": i})
            out.append(TaskResult(task=t, model=_CountingModel(),
                                  train_seconds=1.0 + i, executor_id=0,
                                  batch_size=2, convert_seconds=0.1 * i,
                                  eval_seconds=0.01 * (i + 1)))
        return out

    def test_validate_all_memoizes_predictions(self, small_data):
        _, valid = small_data
        mm = MultiModel(self._results())
        mm.validate_all(valid, metric="auc")
        mm.validate_all(valid, metric="auc")
        mm.best(valid, metric="auc")
        assert all(r.model.calls == 1 for r in mm.results)
        # a different metric reuses the SAME predictions
        mm.validate_all(valid, metric="accuracy")
        assert all(r.model.calls == 1 for r in mm.results)

    def test_different_data_recomputes(self, small_data):
        train, valid = small_data
        mm = MultiModel(self._results())
        mm.validate_all(valid)
        mm.validate_all(train)
        assert all(r.model.calls == 2 for r in mm.results)

    def test_model_score_carries_breakdown(self, small_data):
        _, valid = small_data
        mm = MultiModel(self._results())
        ranked = mm.validate_all(valid)
        by_id = {s.task.task_id: s for s in ranked}
        assert by_id[1].convert_seconds == pytest.approx(0.1)
        assert by_id[1].eval_seconds == pytest.approx(0.02)
        assert by_id[1].batch_size == 2
        assert by_id[2].train_seconds == pytest.approx(3.0)

    def test_returned_ranking_is_a_copy(self, small_data):
        _, valid = small_data
        mm = MultiModel(self._results())
        first = mm.validate_all(valid)
        first.clear()
        assert len(mm.validate_all(valid)) == 3


# ---------------------------------------------------------------------------
# WAL round trip
# ---------------------------------------------------------------------------

class TestWALEvalFields:
    def test_record_roundtrip(self, tmp_path):
        from repro_torch.core.fault import SearchWAL

        path = str(tmp_path / "wal.jsonl")
        wal = SearchWAL(path)
        wal.record(WALRecord(task_id=1, key="k", seconds=1.0, executor_id=0,
                             score=0.93, convert_seconds=0.1,
                             eval_seconds=0.02))
        again = SearchWAL(path)
        rec = again.completed()[1]
        assert rec.score == pytest.approx(0.93)
        assert rec.eval_seconds == pytest.approx(0.02)

    def test_pre_eval_wal_lines_parse(self, tmp_path):
        path = tmp_path / "wal.jsonl"
        path.write_text('{"task_id": 5, "key": "k", "seconds": 2.0, '
                        '"executor_id": 1, "convert_seconds": 0.5}\n')
        from repro_torch.core.fault import SearchWAL

        rec = SearchWAL(str(path)).completed()[5]
        assert rec.score is None and rec.eval_seconds == 0.0
