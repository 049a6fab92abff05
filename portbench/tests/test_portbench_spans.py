"""The readers of the program's spans (``portbench/spans.py`` and the five
metrics that use it) on spans and a device trace made by hand, whose idle
time is known exactly, and their None where the spans are absent."""
import sys

import numpy as np
import pytest

from portbench import harness, manifest, spans, trace, window
from repro_torch import tracing

S = 10**9          # ns a second
MS = 10**6

NAMES = ("idle_scoring", "score_metric_s", "idle_draws", "idle_profiling", "level_wait_ms")


def make(name, start, end, *, parent=None, thread=1, cpu=None):
    """A closed span from ``start`` to ``end`` host seconds; ``cpu`` its
    thread's CPU seconds (all of it by default)."""
    s = tracing.Span(name, {})
    s.parent = parent.id if parent is not None else None
    s.thread = thread
    s.start_ns, s.end_ns = int(round(start * S)), int(round(end * S))
    cpu_ns = s.end_ns - s.start_ns if cpu is None else int(round(cpu * S))
    s.cpu_start_ns, s.cpu_end_ns = 0, cpu_ns
    return s


def context(summary=None):
    """The rate's window [0.5, 8] s (its start to the last result) over a
    trace busy in [0, 0.5], [2, 2.5], [3, 4], [6, 7] and [9.5, 9.9] s."""
    if summary is None:
        names = ["a", "b", "a", "c", "b"]
        starts = (np.array([0, 2000, 3000, 6000, 9500], np.int64) * MS)
        ends = (np.array([500, 2500, 4000, 7000, 9900], np.int64) * MS)
        summary = trace.reduce((names, starts, ends), window_s=10.0)
    fits = [window.Fit(params={}, trees=1, arrived=8.0, train_s=1.0, eval_s=1.0, ok=True,
                       score=0.5, model=None)]
    win = window.Window(t_begin=0.5, t_end=10.0, fits=fits)
    return harness.Context(cell=manifest.cell("forest-higgs.grid"), window=win, setup={},
                           trace=summary)


@pytest.fixture
def recorded(monkeypatch):
    found = []
    monkeypatch.setattr(spans, "recorded", lambda: found)
    return found


def read(name, ctx):
    return manifest.metric(name).read(ctx)


@pytest.mark.parametrize("metric, span_name", [("idle_scoring", "score"),
                                               ("idle_draws", "tree.draws"),
                                               ("idle_profiling", "search.profile")])
def test_idle_inside_spans_over_the_rate_window(recorded, metric, span_name):
    # [1, 3.5] holds busy [2, 2.5] and [3, 3.5]: idle 1.5 s; [7.5, 9] is cut
    # to [7.5, 8], all idle: 0.5 s; [8.5, 9] lies past the last result
    recorded += [make(span_name, 1.0, 3.5), make(span_name, 7.5, 9.0),
                 make(span_name, 8.5, 9.0), make("other", 0.0, 8.0)]
    assert read(metric, context()) == pytest.approx(100 * 2.0 / 7.5, abs=1e-9)


def test_idle_counts_overlapping_spans_once(recorded):
    # two executors scoring at once: the union [1, 4.5] holds busy [2, 2.5]
    # and [3, 4], so 2 s idle, not 1.5 + 2 s
    recorded += [make("score", 1.0, 3.5, thread=1), make("score", 3.0, 4.5, thread=2)]
    assert read("idle_scoring", context()) == pytest.approx(100 * 2.0 / 7.5, abs=1e-9)


def test_idle_of_a_span_on_a_busy_card_is_zero(recorded):
    recorded.append(make("score", 6.0, 7.0))
    assert read("idle_scoring", context()) == pytest.approx(0.0, abs=1e-12)


def test_score_metric_s_is_the_median_of_the_spans_ending_in_the_window(recorded):
    recorded += [make("score.metric", 2.0, 3.0), make("score.metric", 4.0, 7.0),
                 make("score.metric", 5.9, 7.9), make("score.metric", 8.9, 9.0),
                 make("score.metric", 0.0, 0.4), make("score", 0.0, 9.0)]
    assert read("score_metric_s", context()) == pytest.approx(2.0, abs=1e-9)


def test_level_wait_ms_leaves_out_the_profilers_sample_fits(recorded):
    fit = make("fit.train", 1.0, 2.0)
    tree = make("tree", 1.0, 1.9, parent=fit)
    sample = make("profile.sample", 3.0, 4.0)
    sample_tree = make("tree", 3.0, 3.9, parent=sample)
    recorded += [
        make("level", 1.000, 1.002, parent=tree, cpu=0.0015),     # 0.5 ms off the CPU
        make("level", 5.000, 5.001, cpu=0.0005),                  # 0.5 ms, no parent
        make("level", 3.0, 3.010, parent=sample_tree, cpu=0.0),   # a sample fit's: out
        make("level", 8.5, 8.6, cpu=0.0),                         # after the last result
        tree, fit, sample_tree, sample]
    wall_only = make("level", 6.0, 6.5)                           # read no CPU clock: out
    wall_only.cpu_start_ns = wall_only.cpu_end_ns = None
    recorded.append(wall_only)
    assert read("level_wait_ms", context()) == pytest.approx(0.5, abs=1e-9)


def test_level_wait_ms_is_zero_for_a_loop_that_never_leaves_the_cpu(recorded):
    recorded += [make("level", 1.0 + i, 1.5 + i) for i in range(3)]
    assert read("level_wait_ms", context()) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_no_reading_without_the_recorder(monkeypatch, name):
    """A program without ``repro_torch.tracing`` (the parent of the change
    that adds it) gives no reading, and raises nothing."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spans.recorded() is None
    assert read(name, context()) is None


@pytest.mark.parametrize("name", NAMES)
def test_no_reading_where_no_span_of_the_kind_is_in_the_window(recorded, name):
    recorded += [make("other", 1.0, 2.0), make("score", 8.5, 9.0),
                 make("score.metric", 8.5, 9.0), make("level", 8.5, 9.0)]
    assert read(name, context()) is None


@pytest.mark.parametrize("name", ["idle_scoring", "idle_draws", "idle_profiling"])
def test_idle_shares_need_the_trace(recorded, name):
    recorded += [make("score", 1.0, 2.0), make("tree.draws", 1.0, 2.0),
                 make("search.profile", 1.0, 2.0)]
    ctx = context()
    ctx.trace = None
    assert read(name, ctx) is None


def test_the_real_recorder_is_read(monkeypatch):
    """Without the stand-in, the readers read ``tracing.spans()``."""
    monkeypatch.setattr(tracing, "_records", [make("score.metric", 1.0, 1.25)])
    assert [s.name for s in spans.recorded()] == ["score.metric"]
    assert read("score_metric_s", context()) == pytest.approx(0.25)


@pytest.mark.parametrize("name", NAMES)
def test_no_reading_from_a_record_that_dropped_spans(monkeypatch, name):
    """Past the recorder's limit the spans are a part of the window's: the
    readers give None rather than read them."""
    monkeypatch.setattr(tracing, "_records", [
        make("score", 1.0, 3.5), make("score.metric", 1.0, 1.25),
        make("tree.draws", 1.0, 3.5), make("search.profile", 1.0, 3.5),
        make("level", 1.0, 1.5, cpu=0.25)])
    assert read(name, context()) is not None
    monkeypatch.setattr(tracing, "_dropped", 1)
    assert spans.recorded() is None
    assert read(name, context()) is None
