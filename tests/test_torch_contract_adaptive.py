"""The JAX package's ``tests/test_adaptive.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and the device
predictors' ``predict_*_jax`` as ``predict_*_device``, on the CPU
(``set_default_device("cpu")``).

The reference file's own description:

    Adaptive search (DESIGN.md §3.6): resumable training parity, ASHA rungs
    on the streaming Session, WAL mid-rung resume, and the Tuner API shims.
"""
import json
import warnings

import numpy as np
import pytest

import repro_torch.tabular  # noqa: F401  (registers the four estimators)
from repro_torch.core import (
    AshaController,
    Estimator,
    GridBuilder,
    ResumeState,
    RungTask,
    SamplingProfiler,
    SearchSpec,
    Session,
    SuccessiveHalvingTuner,
    TaskResult,
    TrainTask,
    Tuner,
    get_estimator,
    run_prepared,
    run_prepared_resumable,
)
from repro_torch.core.cost_model import CostModel
from repro_torch.core.grid import enumerate_tasks
from repro_torch.core.tuner import GridSearchTuner, make_tuner

from repro_torch import set_default_device  # noqa: E402

set_default_device("cpu")

# family → (params, (rung budget, final budget)); budgets small enough to
# keep the whole module fast but big enough that a wrong carry would show
_FAMILIES = {
    "logreg": ({"c": 1.0, "lr": 0.05}, (20, 50)),
    "mlp": ({"network": "16_16", "learning_rate": 0.03, "batch_size": 64},
            (10, 30)),
    "gbdt": ({"eta": 0.3, "max_depth": 4, "max_bin": 32}, (3, 7)),
    "forest": ({"max_depth": 4}, (2, 5)),
}
#: tree families append rounds/trees to heap-layout stacks — bit-exact;
#: the Adam families rebuild the jitted program for the resumed segment, so
#: parity is numeric (observed ~1e-7, bound 1e-6 per the acceptance bar)
_BIT_EXACT = ("gbdt", "forest")


def _model_arrays(model) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in vars(model).items()
            if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_resume_parity(family, higgs_small):
    """rung-k-then-resume-to-n matches straight-to-n: bit-exact for the
    tree families, <= 1e-6 on predictions for the Adam families."""
    train, valid = higgs_small
    est = get_estimator(family)
    params, (k, n) = _FAMILIES[family]
    assert est.budget_param is not None
    # straight run through the plain train path at the full budget
    plain, _, _ = run_prepared(est, train, {**params, est.budget_param: n})
    # rung at k, then resume to n from the carried state
    m_k, _, _, s_k = run_prepared_resumable(est, train, params, budget=k)
    assert isinstance(s_k, ResumeState) and s_k.budget == k
    m_n, _, _, s_n = run_prepared_resumable(est, train, params,
                                            budget=n, state=s_k)
    assert s_n.budget == n
    p_plain = plain.predict_proba(valid.x)
    p_chain = m_n.predict_proba(valid.x)
    if family in _BIT_EXACT:
        assert np.array_equal(p_plain, p_chain)
        a, b = _model_arrays(plain), _model_arrays(m_n)
        assert set(a) == set(b)
        for name in a:   # trees, thresholds, leaves: identical bit for bit
            assert np.array_equal(a[name], b[name]), name
    else:
        np.testing.assert_allclose(p_chain, p_plain, atol=1e-6)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_resume_state_wire_roundtrip(family, higgs_small):
    """A ResumeState survives WAL journalling (JSON) bit-for-bit: resuming
    from the round-tripped state reproduces the direct resume exactly."""
    train, valid = higgs_small
    est = get_estimator(family)
    params, (k, n) = _FAMILIES[family]
    _, _, _, s_k = run_prepared_resumable(est, train, params, budget=k)
    wire = json.loads(json.dumps(s_k.to_wire()))      # through real JSON
    s_rt = ResumeState.from_wire(wire)
    direct, _, _, _ = run_prepared_resumable(est, train, params,
                                             budget=n, state=s_k)
    rehydrated, _, _, _ = run_prepared_resumable(est, train, params,
                                                 budget=n, state=s_rt)
    assert np.array_equal(direct.predict_proba(valid.x),
                          rehydrated.predict_proba(valid.x))


def test_default_train_resumable_falls_back_to_scratch():
    """Families without resume support still work under ASHA: the base
    implementation trains from scratch at the absolute budget."""

    class Stub(Estimator):
        name = "stub"
        data_format = "dense_rows"
        budget_param = "iters"

        def default_params(self):
            return {"iters": 5}

        def train(self, data, params):
            return dict(params)

    est = Stub()
    model, state = est.train_resumable(None, {"c": 2}, budget=7)
    assert model["iters"] == 7 and model["c"] == 2
    assert state is None              # nothing to carry — every rung is cold


# ---------------------------------------------------------------------------
# AshaController unit behaviour
# ---------------------------------------------------------------------------

def _space4():
    return GridBuilder("logreg").add_grid("c", [0.01, 0.1, 1.0, 10.0]).build()


def _ok(task, score, state=None):
    return TaskResult(task=task, model=None, train_seconds=0.1,
                      executor_id=0, score=score, resume_state=state)


def test_asha_promotes_top_fraction_and_carries_state():
    ctl = AshaController([_space4()], budget_param="steps",
                         base_budget=20, max_budget=80, eta=2)
    wave = ctl.suggest()
    assert len(wave) == 4 and all(t.rung == 0 and t.budget == 20 for t in wave)
    states = {}
    for i, t in enumerate(wave):
        states[t.config_id] = ResumeState("logreg", 20, {"mark": np.float32(i)})
        ctl.report(_ok(t, 0.5 + 0.1 * i, states[t.config_id]))
    promo = ctl.suggest()
    assert len(promo) == 2            # ceil(4 / 2)
    assert all(isinstance(t, RungTask) and t.rung == 1 and t.budget == 40
               and t.prev_budget == 20 for t in promo)
    # top scorers by config, with their own carried states
    assert sorted(t.config_id for t in promo) == [2, 3]
    for t in promo:
        assert t.state is states[t.config_id]
    # budget params carry the ABSOLUTE budget (cache-key stability)
    assert all(t.params["steps"] == 40 for t in promo)


def test_asha_errors_retire_configs():
    ctl = AshaController([_space4()], budget_param="steps",
                         base_budget=10, max_budget=40, eta=2)
    wave = ctl.suggest()
    for t in wave[:2]:
        ctl.report(TaskResult(task=t, model=None, train_seconds=0.0,
                              executor_id=0, error="boom"))
    for t in wave[2:]:
        ctl.report(_ok(t, 0.9))
    promo = ctl.suggest()
    # errored configs never promote; survivors ladder on
    assert {t.config_id for t in promo} <= {2, 3} and promo


def test_asha_ladder_terminates_at_cap():
    ctl = AshaController([_space4()], budget_param="steps",
                         base_budget=20, max_budget=100, eta=2)
    total = []
    while True:
        wave = ctl.suggest()
        if not wave:
            break
        total.extend(wave)
        for t in wave:
            ctl.report(_ok(t, 0.5 + 0.01 * t.config_id))
    # budgets 20/40/80/100 → rungs of 4, 2, 1, 1
    assert [t.budget for t in total] == [20] * 4 + [40] * 2 + [80, 100]
    assert ctl.suggest() == []        # stays done


def test_asha_suggest_budget_hint_defers_without_losing_work():
    ctl = AshaController([_space4()], budget_param="steps",
                         base_budget=20, max_budget=40, eta=2)
    first = ctl.suggest(2)
    assert len(first) == 2
    rest = ctl.suggest()
    assert len(rest) == 2             # the capped remainder re-emerges
    assert {t.config_id for t in first} | {t.config_id for t in rest} \
        == {0, 1, 2, 3}


def test_kill_candidates_and_straggler_unkill():
    ctl = AshaController([_space4()], budget_param="steps",
                         base_budget=10, max_budget=40, eta=2,
                         early_kill=0.5)
    wave = ctl.suggest()
    assert ctl.kill_candidates() == set()     # nothing completed yet
    for t in wave[:2]:
        ctl.report(_ok(t, 0.9))
    kills = ctl.kill_candidates()
    assert kills == {wave[2].task_id, wave[3].task_id}
    assert ctl.kill_candidates() == set()     # idempotent
    # a straggler that finishes anyway is un-killed and competes again
    ctl.report(_ok(wave[2], 0.99))
    promo = ctl.suggest()
    assert wave[2].config_id in {t.config_id for t in promo}


def test_successive_halving_is_asha_without_kills():
    tuner = SuccessiveHalvingTuner([_space4()], budget_param="steps",
                                   base_budget=20, max_budget=100, eta=2)
    assert isinstance(tuner, AshaController)
    assert tuner.kill_candidates() == set()


# ---------------------------------------------------------------------------
# Deprecation shims (one release)
# ---------------------------------------------------------------------------

def test_propose_observe_shims_forward_with_warning():
    tuner = GridSearchTuner([_space4()])
    with pytest.warns(DeprecationWarning):
        batch = tuner.propose()
    assert len(batch) == 4
    ctl = AshaController([_space4()], budget_param="steps",
                         base_budget=20, max_budget=40, eta=2)
    wave = ctl.suggest()
    with pytest.warns(DeprecationWarning):
        ctl.observe([(t, 0.5 + 0.1 * t.config_id) for t in wave])
    assert len(ctl.suggest()) == 2    # the pairs reached report()


def test_legacy_tuner_subclass_bridged_through_session(higgs_small):
    """A pre-rung subclass (propose/observe only) still drives a Session."""
    train, valid = higgs_small

    class Legacy(Tuner):
        def __init__(self):
            self.tasks = enumerate_tasks([_space4()])
            self.rounds = 0
            self.seen = []

        @property
        def is_dynamic(self):
            return True

        def propose(self):
            if self.rounds >= 2:
                return []
            self.rounds += 1
            half = len(self.tasks) // 2
            lo = (self.rounds - 1) * half
            return self.tasks[lo:lo + half]

        def observe(self, pairs):
            self.seen.extend(pairs)

    tuner = Legacy()
    spec = SearchSpec(spaces=[_space4()], n_executors=2, tuner=tuner,
                      profiler=SamplingProfiler(0.2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        results = list(Session(spec).results(train, valid))
    assert len(results) == 4
    # every round's scores were flushed through observe() (round 1's before
    # round 2 proposed; round 2's on the terminal suggest)
    assert len(tuner.seen) == 4


# ---------------------------------------------------------------------------
# Declarative tuner config on SearchSpec
# ---------------------------------------------------------------------------

def test_spec_tuner_kind_validation():
    sp = _space4()
    with pytest.raises(ValueError, match="unknown tuner"):
        SearchSpec(spaces=[sp], tuner="simulated_annealing")
    with pytest.raises(ValueError):   # probe-construct: missing budgets
        SearchSpec(spaces=[sp], tuner="asha")
    with pytest.raises(ValueError):   # probe-construct: bad eta
        SearchSpec(spaces=[sp], tuner="asha",
                   tuner_args={"budget_param": "steps", "base_budget": 10,
                               "max_budget": 40, "eta": 1})
    with pytest.raises(ValueError, match="tuner_args"):
        SearchSpec(spaces=[sp], tuner_args={"eta": 2})
    spec = SearchSpec(spaces=[sp], tuner="asha",
                      tuner_args={"budget_param": "steps", "base_budget": 10,
                                  "max_budget": 40})
    assert isinstance(spec.build_tuner(), AshaController)
    # each build materialises a FRESH controller (resume safety)
    assert spec.build_tuner() is not spec.build_tuner()


def test_make_tuner_registry():
    with pytest.raises(ValueError, match="unknown tuner kind"):
        make_tuner("nope", [_space4()])
    t = make_tuner("asha", [_space4()], budget_param="steps",
                   base_budget=10, max_budget=40)
    assert isinstance(t, AshaController)


# ---------------------------------------------------------------------------
# CostModel: rungs observed/estimated at their INCREMENT
# ---------------------------------------------------------------------------

def test_cost_model_buckets_rungs_by_increment():
    cm = CostModel()
    # a plain 180-round task observed once: the 2^7-ish bucket
    full = TrainTask(task_id=1, estimator="gbdt", params={"round": 180})
    cm.observe(full, seconds=2.0, n_rows=1000)
    # an absolute-270 task in the 2^8 bucket, much slower
    big = TrainTask(task_id=2, estimator="gbdt", params={"round": 270})
    cm.observe(big, seconds=3.5, n_rows=1000)
    # a rung at absolute budget 270 resuming from 90 runs a 180-round
    # increment — it must read the 180 bucket, not the 270 one
    rung = RungTask(task_id=900, estimator="gbdt", params={"round": 270},
                    config_id=0, rung=2, budget=270, prev_budget=90,
                    budget_param="round")
    assert cm.estimate(rung, 1000) == pytest.approx(2.0)
    assert cm.estimate(big, 1000) == pytest.approx(3.5)
    # observing the rung feeds the increment bucket too (blended law)
    cm.observe(rung, seconds=2.2, n_rows=1000)
    assert 2.0 < cm.estimate(full, 1000) < 2.2
    # eval laws stay on ABSOLUTE params: scoring depends on the model
    # produced (all 270 trees), not the increment trained
    cm.observe_eval(big, seconds=0.5, n_rows=500)
    assert cm.predict_eval(rung, 500) == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# End to end: ASHA on the streaming Session, WAL mid-rung resume
# ---------------------------------------------------------------------------

_ASHA_ARGS = {"budget_param": "steps", "base_budget": 20,
              "max_budget": 100, "eta": 2}


def test_asha_session_streams_rungs(higgs_small):
    train, valid = higgs_small
    spec = SearchSpec(spaces=[_space4()], n_executors=2, tuner="asha",
                      tuner_args=_ASHA_ARGS, profiler=SamplingProfiler(0.1))
    session = Session(spec)
    results = list(session.results(train, valid))
    # budgets 20/40/80/100 → rungs of 4, 2, 1, 1
    assert len(results) == 8
    assert all(isinstance(r.task, RungTask) for r in results)
    assert all(r.ok and r.score is not None for r in results)
    # losers are killed at the rung: the work actually trained is the sum
    # of INCREMENTS, far below the exhaustive grid's 4 x 100 steps
    spent = sum(r.task.budget - r.task.prev_budget for r in results)
    assert spent < 4 * 100 / 2
    # the ladder reached the cap, and promotion followed the scores: the
    # rung-1 members are exactly the top-2 rung-0 configs by streamed score
    deepest = max(results, key=lambda r: r.task.rung)
    assert deepest.task.budget == 100
    rung0 = sorted((r for r in results if r.task.rung == 0),
                   key=lambda r: (-r.score, r.task.config_id))
    top2 = {r.task.config_id for r in rung0[:2]}
    assert {r.task.config_id for r in results if r.task.rung == 1} == top2
    # promoted rungs actually resumed (warm states journalled per result)
    assert all(r.resume_state is not None for r in results)


def test_asha_session_resumes_mid_ladder_from_wal(tmp_path, higgs_small):
    train, valid = higgs_small
    wal = str(tmp_path / "asha.wal")
    spec = SearchSpec(spaces=[_space4()], n_executors=2, tuner="asha",
                      tuner_args=_ASHA_ARGS, profiler=SamplingProfiler(0.1),
                      wal_path=wal, max_tasks=4)
    first = Session(spec)
    got = list(first.results(train, valid))
    assert first.stop_reason == "max_tasks" and len(got) == 4
    assert all(r.task.rung == 0 for r in got)
    # resume with the SAME declarative spec: the fresh controller replays
    # rung 0 from the WAL (scores + carried states) and runs only the
    # remaining rungs — from-scratch budgets would differ numerically
    second = Session.resume(wal, spec)
    rest = list(second.results(train, valid))
    assert len(rest) == 4 and all(r.task.rung >= 1 for r in rest)
    assert all(r.ok and r.score is not None for r in rest)
    # nothing re-trained: task ids are disjoint from the first run's
    assert {r.task.task_id for r in got}.isdisjoint(
        {r.task.task_id for r in rest})
    # the resumed ladder still reaches the cap
    assert max(r.task.budget for r in rest) == 100
    # parity with an uninterrupted run on the same data: same final score
    solo = Session(spec.replace(wal_path=None, max_tasks=None))
    solo_results = list(solo.results(train, valid))
    best_resumed = max(r.score for r in got + rest)
    best_solo = max(r.score for r in solo_results)
    assert best_resumed == pytest.approx(best_solo, abs=1e-6)


def test_asha_with_early_kill_completes(higgs_small):
    """early_kill armed end-to-end: the session completes, every reported
    result is consistent, and the ladder still reaches the cap."""
    train, valid = higgs_small
    spec = SearchSpec(spaces=[_space4()], n_executors=2, tuner="asha",
                      tuner_args={**_ASHA_ARGS, "early_kill": 0.5},
                      profiler=SamplingProfiler(0.1))
    session = Session(spec)
    results = list(session.results(train, valid))
    assert results and all(r.ok for r in results)
    assert max(r.task.budget for r in results) == 100
    assert session.stats.n_rung_kills >= 0
