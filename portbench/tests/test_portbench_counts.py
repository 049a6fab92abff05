"""The byte and operation counts and the trace's reduction at small shapes,
against counts made by hand."""
import numpy as np
import pytest
import torch

from portbench import trace, work
from portbench.counts import tree_level
from portbench.reference import trees


def test_root_level_bytes_by_hand():
    # 10 rows, 3 features, 4 bins, one node: codes 10*3 (a byte each), g and
    # h 10*8, no node ids (one node), the histogram 1*3*4*8, one decision 12
    assert tree_level.level_bytes(10, 10, 3, 1, 4, False) == 30 + 80 + 0 + 96 + 12
    assert tree_level.level_flops(10, 3, 1, 4) == 60 + 144


def test_codes_and_node_ids_are_charged_at_their_least_width():
    assert [tree_level.width(n) for n in (2, 256, 257, 65536, 65537)] == [1, 1, 2, 2, 3]
    # 257 bins: two bytes a code; 512 nodes: two bytes a node id
    cells = 512 * 3 * 257
    assert (tree_level.level_bytes(5, 10, 3, 512, 257, False)
            == 5 * (2 * 3 + 8) + 10 * 2 + cells * 8 + 512 * 12)


def test_subtraction_level_reads_the_smaller_children_and_the_parents():
    # level 1 of 10 rows split 7 / 3: the 3 rows' codes and g, h; every
    # row's node (a byte); the parent's histogram (1*3*4*8) read, two written
    want = 3 * (3 + 8) + 10 * 1 + 96 + 2 * 96 + 2 * 12
    assert tree_level.level_bytes(3, 10, 3, 2, 4, True) == want
    b, f = tree_level.tree_work([torch.tensor([10]), torch.tensor([7, 3])], 10, 3, 4)
    root = tree_level.level_bytes(10, 10, 3, 1, 4, False)
    # the leaf sums: g, h and a leaf byte of each row, 8 bytes a leaf
    assert b == root + want + tree_level.leaf_sum_bytes(10, 4) == root + want + 10 * 9 + 4 * 8
    assert f == tree_level.level_flops(10, 3, 1, 4) + tree_level.level_flops(3, 3, 2, 4) + 20


def test_level_counts_route_rows_as_the_tree_does():
    codes = torch.tensor([[0, 3], [1, 0], [2, 2], [3, 1], [1, 3]], dtype=torch.int32)
    # root splits feature 0 at bin 1 (rows with code > 1 go right: rows 2, 3);
    # node 1 (left) splits feature 1 at bin 2, node 2 does not split
    feat = torch.tensor([[0, 1, 0]])
    split = torch.tensor([[1, 2, 3]])
    c = work.level_counts(codes, split, feat, 2)
    assert c[0].tolist() == [[5]]
    assert c[1].tolist() == [[3, 2]]
    leaf = trees.leaf_index(codes, feat[0], split[0], 2)
    assert leaf.tolist() == [1, 0, 2, 2, 1]


def test_split_bins_recover_edges_and_flag_strangers():
    edges = torch.tensor([[0.5, 1.5, 2.5], [-1.0, 0.0, 1.0]])
    feat = torch.tensor([0, 1, 1, 0])
    thresh = torch.tensor([1.5, -1.0, float("inf"), 0.7])
    got = trees.split_bins(feat, thresh, edges, 4).tolist()
    assert got == [1, 0, 3, trees.BAD_SPLIT]


def test_trace_union_and_gaps():
    names = ["a", "b", "c", "a"]
    starts = np.array([0, 5, 20, 100], np.int64) * 1000
    ends = np.array([10, 12, 30, 110], np.int64) * 1000
    s = trace.reduce((names, starts, ends), window_s=1e-3)
    assert abs(s.busy_s - 32e-6) < 1e-12            # [0, 12] + [20, 30] + [100, 110]
    assert s.launches == {"a": 2, "b": 1, "c": 1}
    assert abs(s.seconds["a"] - 20e-6) < 1e-12
    assert [g[0] for g in s.idle_gaps] == ["before a", "before c"]
    assert abs(s.idle_gaps[0][1] - 70e-6) < 1e-12 and abs(s.idle_gaps[1][1] - 8e-6) < 1e-12
    assert s.seconds_of(("a", "c")) == (s.seconds["a"] + s.seconds["c"], 3)


def test_trace_cut_to_host_spans():
    # the trace's clock runs 1 ms ahead of the host's: host second t is
    # trace ns t * 1e9 + 1e6
    names = ["a", "b", "c", "a"]
    starts = np.array([0, 5, 20, 100], np.int64) * 1000 + 10**6
    ends = np.array([10, 12, 30, 110], np.int64) * 1000 + 10**6
    s = trace.reduce((names, starts, ends), window_s=1e-3, offset_ns=10**6)
    # [8, 25] and [22, 105] us on the host clock: one cut [8, 105]
    cut = s.within([(8e-6, 25e-6), (22e-6, 105e-6)])
    assert abs(cut.window_s - 97e-6) < 1e-12
    assert abs(cut.busy_s - (4e-6 + 10e-6 + 5e-6)) < 1e-12   # [8, 12] + [20, 30] + [100, 105]
    assert cut.launches == {"a": 2, "b": 1, "c": 1}
    assert abs(cut.seconds["a"] - 7e-6) < 1e-12
    # two cuts apart; spans that hold nothing give an empty cut
    two = s.within([(0.0, 6e-6), (104e-6, 1.0)])
    assert two.launches == {"a": 2, "b": 1}
    assert abs(two.busy_s - (6e-6 + 6e-6)) < 1e-12             # b lies within a's [0, 6]
    assert s.within([]).window_s == 0 and s.within([(2.0, 3.0)]).busy_s == 0


def test_trace_readers_read_within_the_fits_training_and_the_rates_window():
    """The kernels', level loops' and device's readers count only what ran
    while the fits that came back were training (or, for the device, in the
    rate's window): a sample fit before them and the drain after the last
    result are left out."""
    from portbench import harness, manifest, window, work as work_mod

    ms = 1_000_000
    # host seconds 0..10; the trace's clock equals the host's (offset 0)
    names = ["level_accumulate", "level_stats", "level_accumulate", "gather", "level_stats"]
    starts = np.array([0, 2000, 3000, 6000, 9500], np.int64) * ms
    ends = np.array([500, 2500, 4000, 7000, 9900], np.int64) * ms
    summary = trace.reduce((names, starts, ends), window_s=10.0)
    fits = [window.Fit(params={}, trees=1, arrived=5.0, train_s=3.0, eval_s=1.0, ok=True,
                       score=0.5, model=None, trained=(1.0, 4.0)),
            window.Fit(params={}, trees=1, arrived=8.0, train_s=2.0, eval_s=0.0, ok=True,
                       score=0.5, model=None, trained=(6.0, 8.0))]
    win = window.Window(t_begin=0.5, t_end=10.0, fits=fits)
    cell = manifest.cell("gbdt-higgs.refit")
    ctx = harness.Context(cell=cell, window=win, setup={}, trace=summary,
                          work=work_mod.Work(bytes=int(3.35e12 * 0.3), flops=1, levels=10))
    read = lambda name: manifest.metric(name).read(ctx)   # noqa: E731
    # training spans [1, 4] and [6, 8]: 5 s, of which 0.5 + 1 + 1 s busy;
    # the level kernels 1.5 s (the root's at 0 s and the last at 9.5 s are out)
    assert abs(read("level_kernel_roofline") - 100 * 0.3 / 1.5) < 1e-9
    assert read("level_launches") == 2 / 10
    assert abs(read("level_host_ms") - 1e3 * (5.0 - 2.5) / 10) < 1e-9
    # the rate's window [0.5, 8]: busy 0.5 + 1 + 1 s of 7.5
    assert abs(read("device_idle") - 100 * (1 - 2.5 / 7.5)) < 1e-9


def test_a_trace_on_another_clock_is_refused():
    starts = np.array([5 * 10**9], np.int64)
    events = (["k"], starts, starts + 10)
    trace._on_the_host_clock(events, 4.0, 6.0, 0)
    with pytest.raises(RuntimeError, match="outside the traced window"):
        trace._on_the_host_clock(events, 4.0, 6.0, 10**12)
