"""The port's random forest against the JAX package's, on the CPU.

Forest statistics are integers (g = −y·w, h = w with Poisson weights), so
every histogram sum is exact in float32 and the trees can be held bit for
bit: with the JAX package's own draws fed through the seam
(``FixedForestDraws``), ``feat``/``split``/``thresh``/``leaves`` equal
``repro.tabular.forest``'s. The port's own draws (``draws.py``) are held to
determinism and to tree t's independence of the tree count, which makes
resume and batching bit-exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

import repro.tabular  # noqa: F401,E402  (registers the JAX estimators)
import repro_torch.tabular  # noqa: F401,E402  (registers the port's estimators)
from repro.core.interface import get_estimator as jget  # noqa: E402
from repro.tabular import forest as jforest  # noqa: E402
from repro_torch import set_default_device  # noqa: E402
from repro_torch.core.data_format import DenseMatrix, shard_payload  # noqa: E402
from repro_torch.core.interface import ResumeState, get_estimator  # noqa: E402
from repro_torch.tabular import forest  # noqa: E402
from repro_torch.tabular.draws import FixedForestDraws, forest_tree_draws  # noqa: E402

set_default_device("cpu")

N_TREES = 10
SEED = 3


def _port(dm):
    return DenseMatrix(dm.x, dm.y, dm.feature_names)


@pytest.fixture(scope="module")
def prepared(higgs_small):
    train, valid = higgs_small
    return (jget("forest").prepare(train, {}), get_estimator("forest").prepare(_port(train), {}),
            valid)


def _jax_draws(seed, n_trees, r, f) -> FixedForestDraws:
    """Tree t's draws as ``repro.tabular.forest`` makes them."""
    key = jax.random.key(seed)
    ws, perms = [], []
    for t in range(n_trees):
        kb, kf = jax.random.split(jax.random.fold_in(key, t))
        ws.append(np.asarray(jax.random.poisson(kb, 1.0, (r,)).astype(jnp.float32)))
        perms.append(np.asarray(jax.random.permutation(kf, f)))
    return FixedForestDraws(np.stack(ws), np.stack(perms))


def _trees_equal(a, b):
    for k in ("feat", "thresh", "leaves"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.mark.parametrize("depth", [4, 8])
def test_forest_bit_equal_to_reference_with_its_draws(prepared, depth):
    jdata, tdata, valid = prepared
    params = {"n_estimators": N_TREES, "max_depth": depth, "seed": SEED}
    r, f = tdata["bins"].shape
    draws = _jax_draws(SEED, N_TREES, r, f)
    jm = jget("forest").train(jdata, params)
    tm = get_estimator("forest").train(tdata, params, draws=draws)
    _trees_equal(tm, jm)
    # the split bins too, from both cores; subtraction equals direct
    kw = dict(n_bins=int(tdata["n_bins"]), n_trees=N_TREES, max_depth=depth,
              max_features=max(1, int(np.sqrt(f))))
    want = jforest._fit_forest(jdata["bins"], jdata["y"], jax.random.key(SEED),
                               jnp.float32(1.0), jnp.int32(depth), **kw)
    for subtract in (True, False):
        got = forest._grow_forest(tdata["bins"], tdata["y"], draws, 1.0, depth, 0,
                                  subtract=subtract, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tm.predict_proba(valid.x), jm.predict_proba(valid.x))


def test_forest_plain_path_and_device_margins(prepared):
    _, tdata, valid = prepared
    params = {"n_estimators": 4, "max_depth": 6, "seed": SEED}
    est = get_estimator("forest")
    a = est.train(tdata, params)
    _trees_equal(est.train(tdata, params, force="ref"), a)
    _trees_equal(est.train(tdata, params), a)                   # deterministic
    np.testing.assert_array_equal(a.predict_margin_device(valid.x),
                                  forest.batched_tree_margins([a], valid.x)[0])
    np.testing.assert_array_equal(a.predict_proba_device(torch.from_numpy(valid.x)),
                                  np.clip(a.predict_margin_device(valid.x) / 4, 0, 1))
    np.testing.assert_allclose(a.predict_proba_device(valid.x), a.predict_proba(valid.x),
                               atol=1e-6)


def test_forest_resume_equals_straight(prepared):
    _, tdata, valid = prepared
    params = {"n_estimators": N_TREES, "max_depth": 5, "seed": SEED}
    est = get_estimator("forest")
    straight = est.train(tdata, params)
    _, s4 = est.train_resumable(tdata, params, budget=4)
    wire = ResumeState.from_wire(s4.to_wire())
    resumed, s10 = est.train_resumable(tdata, params, budget=10, state=wire)
    assert s10.budget == 10
    _trees_equal(resumed, straight)


def _unpadded(model, depth: int):
    """A depth-padded tree stack cut back to ``depth``: its first levels,
    and leaf j of the cut tree is padded leaf j << (pad − depth). Checks
    that every node below ``depth`` is a sentinel."""
    n_int = (1 << depth) - 1
    np.testing.assert_array_equal(model.feat[:, n_int:], 0)
    assert np.isinf(model.thresh[:, n_int:]).all()
    step = 1 << (model.max_depth - depth)
    return model.feat[:, :n_int], model.thresh[:, :n_int], model.leaves[:, ::step]


def test_forest_train_batched_equals_sequential(prepared):
    _, tdata, valid = prepared
    configs = [{"n_estimators": 3, "max_depth": 3, "seed": 1},
               {"n_estimators": 5, "max_depth": 5, "seed": 2, "min_samples_leaf": 4.0},
               {"n_estimators": 2, "max_depth": 4, "seed": 1}]
    est = get_estimator("forest")
    batched = est.train_batched(tdata, configs)
    for cfg, bm in zip(configs, batched):
        solo = est.train(tdata, cfg)
        assert bm.max_depth == 5 and len(bm.feat) == cfg["n_estimators"]
        for got, want in zip(_unpadded(bm, cfg["max_depth"]),
                             (solo.feat, solo.thresh, solo.leaves)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(bm.predict_proba(valid.x), solo.predict_proba(valid.x))
    np.testing.assert_array_equal(
        forest.ForestModel.predict_proba_batched(batched[:1], valid.x)[0],
        batched[0].predict_proba_device(valid.x))


def test_port_forest_draws_seeded_and_count_independent():
    draw = functools.partial(forest_tree_draws, 5, n_rows=300, n_features=28, device="cpu")
    w3, p3 = draw(3)
    w3b, p3b = draw(3)
    assert torch.equal(w3, w3b) and torch.equal(p3, p3b)
    assert not torch.equal(w3, draw(4)[0])
    assert not torch.equal(w3, forest_tree_draws(6, 3, 300, 28, "cpu")[0])
    assert w3.dtype == torch.float32 and bool((w3 == w3.round()).all()) and w3.min() >= 0
    assert abs(float(w3.mean()) - 1.0) < 0.2                      # Poisson(1)
    assert sorted(p3.tolist()) == list(range(28))


def test_port_forest_first_trees_do_not_depend_on_the_count(prepared):
    _, tdata, _ = prepared
    est = get_estimator("forest")
    three = est.train(tdata, {"n_estimators": 3, "max_depth": 4, "seed": 9})
    six = est.train(tdata, {"n_estimators": 6, "max_depth": 4, "seed": 9})
    for k in ("feat", "thresh", "leaves"):
        np.testing.assert_array_equal(getattr(six, k)[:3], getattr(three, k))


def test_forest_sharded_payload_is_refused(prepared):
    """(Named for the slice that refused it.) A sharded payload now trains:
    its trees, leaves included, are the unsharded forest's bit for bit
    (``test_torch_sharded.py`` holds the whole grid)."""
    _, tdata, _ = prepared
    params = {"n_estimators": 2, "max_depth": 4, "seed": 3}
    est = get_estimator("forest")
    base = est.train(tdata, params)
    got = est.train(shard_payload(tdata, 3), params)
    for k in ("feat", "thresh", "leaves"):
        np.testing.assert_array_equal(getattr(got, k), getattr(base, k))
