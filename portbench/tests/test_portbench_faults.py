"""A run with the timed path broken underneath comes out not correct.

Each cell is run at a small size on the CPU (the look for a card is
skipped; the rest of the run is the benchmark's own) with one fault
planted in the program for the run:

* ``state``: a step returns its state unchanged: boosting never moves its
  margin; a forest's every tree reuses the first tree's draws;
* ``half``: half of the rows left out of every level and leaf sum, the
  sums taken over the rest;
* ``tree``: an answer altered where it is produced: the root's split moved
  one bin;
* ``score``: an answer altered where it is produced: each validation
  score 0.01 off.

One chip holds each cell, so there is no exchange between chips to leave out.
"""
import pytest
import torch

from portbench.tests import tiny

CELLS = ["gbdt-higgs.refit", "gbdt-higgs.grid", "forest-higgs.grid"]
FAULTS = ["state", "half", "tree", "score"]


def _wrap_build_tree(monkeypatch, wrapper):
    from repro_torch.tabular import forest, gbdt

    original = gbdt.build_tree
    patched = wrapper(original)
    monkeypatch.setattr(gbdt, "build_tree", patched)
    monkeypatch.setattr(forest, "build_tree", patched)


def _plant(monkeypatch, fault):
    import repro_torch.tabular  # noqa: F401
    from repro_torch.core import evaluation, executor
    from repro_torch.tabular import forest, gbdt

    if fault == "state":
        monkeypatch.setattr(gbdt, "predict_margin",
                            lambda bins, *a, **k: torch.zeros(bins.shape[:-1]))
        draws = forest.forest_tree_draws
        monkeypatch.setattr(forest, "forest_tree_draws",
                            lambda seed, t, *a: draws(seed, 0, *a))
    elif fault == "half":
        def wrapper(build):
            def half(bins, g, h, **kw):
                keep = torch.arange(g.shape[-1]) < g.shape[-1] // 2
                return build(bins, g * keep, h * keep, **kw)
            return half
        _wrap_build_tree(monkeypatch, wrapper)
    elif fault == "tree":
        def wrapper(build):
            def moved(bins, g, h, **kw):
                feat, split, lg, lh = build(bins, g, h, **kw)
                split = split.clone()
                if split[0] < kw["n_bins"] - 2:
                    split[0] += 1
                return feat, split, lg, lh
            return moved
        _wrap_build_tree(monkeypatch, wrapper)
    else:
        score = evaluation.evaluate_models

        def off(*a, **k):
            scores, secs = score(*a, **k)
            return [s + 0.01 if s is not None else s for s in scores], secs
        monkeypatch.setattr(evaluation, "evaluate_models", off)
        monkeypatch.setattr(executor, "evaluate_models", off)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    _plant(monkeypatch, fault)
    r = tiny.run(workload)
    assert r["attempted"] >= 1
    assert not r["correct"], r["compared"]
