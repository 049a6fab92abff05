"""The port's span recorder (``repro_torch.tracing``) on the CPU: when it
records, what a span holds, the spans the search, the executors, the
scorer and the tree families open, that tracing changes no tree and no
score, and that no span reaches the profiler's events."""
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.tabular  # noqa: F401,E402  (registers the port's estimators)
from repro_torch import set_default_device, tracing  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DenseMatrix,
    EvalPlan,
    GridBuilder,
    SamplingProfiler,
    SearchSpec,
    Session,
    get_estimator,
)
from repro_torch.core.evaluation import evaluate_models  # noqa: E402

set_default_device("cpu")

GBDT = {"round": 3, "max_depth": 3, "max_bin": 16, "eta": 0.3}
FOREST = {"n_estimators": 3, "max_depth": 3}


@pytest.fixture(autouse=True)
def clean():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 5)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.3 * rng.normal(size=600) > 0).astype(np.float32)
    return DenseMatrix(x[:400], y[:400]), DenseMatrix(x[400:], y[400:])


def fit(family, params, train):
    est = get_estimator(family)
    return est, est.train(est.prepare(train, params), dict(params))


def by_name(found):
    out = {}
    for s in found:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_by_default_records_nothing():
    with tracing.span("a", x=1) as s:
        pass
    assert s is None
    assert tracing.span("a") is tracing.span("b")          # one shared no-op
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_on_under_enable_and_off_after():
    tracing.enable()
    with tracing.span("a", x=1):
        pass
    tracing.disable()
    with tracing.span("b"):
        pass
    (s,) = tracing.spans()
    assert (s.name, s.tags, s.parent) == ("a", {"x": 1}, None)
    assert s.end_ns >= s.start_ns and s.cpu_start_ns is None and s.cpu_end_ns is None
    assert s.thread == threading.get_ident()
    tracing.reset()
    assert tracing.spans() == []


def test_on_while_a_profiler_session_is_active_and_off_after():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("traced"):
            pass
    with tracing.span("after"):
        pass
    assert [s.name for s in tracing.spans()] == ["traced"]


def test_a_spans_bounds_bracket_readings_taken_inside_it():
    tracing.enable()
    with tracing.span("a"):
        inside = [time.perf_counter_ns() for _ in range(3)]
        with tracing.span("b"):
            inside.append(time.perf_counter_ns())
    b, a = tracing.spans()
    assert a.start_ns <= min(inside) and max(inside) <= a.end_ns
    assert a.start_ns <= b.start_ns <= inside[-1] <= b.end_ns <= a.end_ns
    assert b.parent == a.id


def test_parents_on_two_threads_at_once():
    """Each thread's spans nest in its own spans, however the threads
    interleave; a child without a ``task`` tag takes its parent's."""
    tracing.enable()
    barrier = threading.Barrier(2, timeout=10)

    def work(k):
        with tracing.span("outer", task=k):
            barrier.wait()
            with tracing.span("inner"):
                barrier.wait()
            barrier.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    found = by_name(tracing.spans())
    outer = {s.tags["task"]: s for s in found["outer"]}
    assert len(outer) == 2 and outer[0].thread != outer[1].thread
    for s in found["inner"]:
        assert s.parent == outer[s.tags["task"]].id
        assert s.thread == outer[s.tags["task"]].thread


def test_only_spans_that_ask_read_the_thread_clock():
    tracing.enable()
    with tracing.span("plain", x=1):
        with tracing.span("timed", thread_clock=True, x=2):
            sum(range(10**5))
    timed, plain = tracing.spans()
    assert plain.cpu_start_ns is None and plain.cpu_end_ns is None
    assert timed.cpu_start_ns is not None and timed.cpu_end_ns > timed.cpu_start_ns
    assert (timed.tags, plain.tags) == ({"x": 2}, {"x": 1})


def test_wall_clock_only_skips_the_cpu_clock_on_its_thread():
    tracing.enable()
    with tracing.span("outer", thread_clock=True):
        with tracing.wall_clock_only():
            with tracing.span("inner", thread_clock=True):
                pass
        with tracing.span("after", thread_clock=True):
            pass
    inner, after, outer = tracing.spans()
    assert inner.cpu_start_ns is None and inner.cpu_end_ns is None
    assert inner.parent == outer.id and inner.end_ns >= inner.start_ns
    assert after.cpu_end_ns >= after.cpu_start_ns and outer.cpu_end_ns >= outer.cpu_start_ns


def test_spans_past_the_limit_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 2)
    tracing.enable()
    for _ in range(5):
        with tracing.span("a"):
            pass
    assert len(tracing.spans()) == 2 and tracing.dropped() == 3
    tracing.reset()
    assert tracing.dropped() == 0


def test_a_gbdt_fit_records_a_tree_a_round_and_a_level_a_depth(data):
    tracing.enable()
    fit("gbdt", GBDT, data[0])
    found = by_name(tracing.spans())
    trees = found["tree"]
    assert [t.tags["index"] for t in trees] == list(range(GBDT["round"]))
    for t in trees:
        levels = [s for s in found["level"] if s.parent == t.id]
        assert [(s.tags["level"], s.tags["nodes"]) for s in levels] == [(0, 1), (1, 2), (2, 4)]
        assert all(t.start_ns <= s.start_ns <= s.end_ns <= t.end_ns for s in levels)
    assert len(found["level"]) == GBDT["round"] * GBDT["max_depth"]
    # the levels read the thread clock (``level_wait_ms``); the trees do not
    assert all(s.cpu_end_ns >= s.cpu_start_ns for s in found["level"])
    assert all(t.cpu_start_ns is None for t in trees)


def test_a_forest_fit_records_one_draws_span_a_tree(data):
    tracing.enable()
    fit("forest", FOREST, data[0])
    found = by_name(tracing.spans())
    trees = {t.id: t for t in found["tree"]}
    assert len(trees) == FOREST["n_estimators"]
    assert Counter(s.parent for s in found["tree.draws"]) == Counter(list(trees))
    assert len(found["level"]) == FOREST["n_estimators"] * FOREST["max_depth"]


def test_a_two_executor_search_records_its_layers(data):
    train, valid = data
    b = GridBuilder("gbdt")
    b.add_grid("round", [2, 3])
    b.add_grid("max_depth", [2])
    b.add_grid("max_bin", [16])
    spec = SearchSpec(spaces=[b.build()], n_executors=2, policy="lpt",
                      profiler=SamplingProfiler(0.5), metric="auc", seed=0)
    tracing.enable()
    results = list(Session(spec).results(train, valid))
    found = by_name(tracing.spans())
    ids = {s.id: s for ss in found.values() for s in ss}
    (profile,) = found["search.profile"]
    assert profile.parent is None and profile.tags["tasks"] == 2
    assert sorted(s.tags["task"] for s in found["profile.sample"]) == [0, 1]
    assert all(s.parent == profile.id for s in found["profile.sample"])
    # the sample fits' levels read no CPU clock; the executors' fits' levels do
    sampled = {s.id for s in found["tree"] if ids[s.parent].name == "profile.sample"}
    levels = [s for s in found["level"] if s.parent in sampled]
    assert levels and all(s.cpu_start_ns is None for s in levels)
    fitted = [s for s in found["level"] if s.parent not in sampled]
    assert fitted and all(s.cpu_end_ns >= s.cpu_start_ns for s in fitted)
    fits = {s.tags["task"]: s for s in found["fit"]}
    assert sorted(fits) == sorted(r.task.task_id for r in results) == [0, 1]
    assert {s.tags["executor"] for s in fits.values()} <= {0, 1}
    for name, parent in (("fit.train", "fit"), ("score", "fit"), ("score.metric", "score"),
                         ("score.predict", "score")):
        assert sorted(s.tags["task"] for s in found[name]) == [0, 1], name
        for s in found[name]:
            up = ids[s.parent]
            assert up.name == parent and up.tags["task"] == s.tags["task"]
            assert s.thread == fits[s.tags["task"]].thread
    assert all(s.tags["metric"] == "auc" for s in found["score.metric"])
    assert all(s.parent is None for s in found["fit"])
    # the fits' trees hang under their training, the samples' under the profiler
    for t in found["tree"]:
        chain, up = [], ids.get(t.parent)
        while up is not None:
            chain.append(up.name)
            up = ids.get(up.parent)
        assert chain[:2] in (["fit.train", "fit"], ["profile.sample", "search.profile"])


def test_trees_and_scores_are_bit_identical_with_tracing_on_and_off(data):
    train, valid = data
    plan = EvalPlan(valid, "auc")
    out = {}
    for on in (False, True):
        if on:
            tracing.enable()
        got = []
        for family, params in (("gbdt", GBDT), ("forest", FOREST)):
            est, model = fit(family, params, train)
            scores, _ = evaluate_models(est, [model], plan)
            got.append((np.asarray(model.feat), np.asarray(model.thresh),
                        np.asarray(model.leaves), scores[0]))
        out[on] = got
    assert tracing.spans()
    for (f0, t0, l0, s0), (f1, t1, l1, s1) in zip(out[False], out[True]):
        assert np.array_equal(f0, f1) and np.array_equal(t0, t1) and np.array_equal(l0, l1)
        assert s0 == s1


def test_no_span_reaches_the_profilers_events(data):
    """Spans are the program's own records: a profiler session sees none of
    their names, so a device trace reads the same with spans on or off."""
    from torch.profiler import ProfilerActivity, profile

    train, valid = data
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        est, model = fit("gbdt", GBDT, train)
        evaluate_models(est, [model], EvalPlan(valid, "auc"))
    span_names = {s.name for s in tracing.spans()}
    assert {"tree", "level", "score", "score.metric"} <= span_names
    events = {e.name for e in prof.events()}
    assert events and not events & span_names
