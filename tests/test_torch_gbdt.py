"""The port's GBDT against the JAX package's, on the CPU.

Whole trees are bit-identical where every float sum is exact (integer-valued
grad/hess). Trained models can differ: ``torch.sigmoid`` and
``jax.nn.sigmoid`` differ by an ulp on some inputs and the frameworks'
cumsums add in other orders, so a near-tie split may flip. Trained models
are therefore held to JAX's validation AUC within ``AUC_TOL``, and the
port is held bit-exact against itself. Gaps measured on these configs:
0 and 2.0e-3 for ``train`` (the second is 30 rounds at depth 6), 0 for
``train_resumable``, 0 and 1.0e-4 for ``train_batched``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

import repro.tabular  # noqa: F401,E402  (registers the JAX estimators)
import repro_torch.tabular  # noqa: F401,E402  (registers the port's gbdt)
from repro.core.interface import ResumeState as JResumeState  # noqa: E402
from repro.core.interface import get_estimator as jget  # noqa: E402
from repro.core.results import auc  # noqa: E402
from repro.tabular import gbdt as jgbdt  # noqa: E402
from repro_torch import set_default_device  # noqa: E402
from repro_torch.core.data_format import DenseMatrix  # noqa: E402
from repro_torch.core.interface import ResumeState, get_estimator  # noqa: E402
from repro_torch.tabular import gbdt  # noqa: E402

set_default_device("cpu")

AUC_TOL = 5e-3
CONFIGS = [
    {"round": 10, "max_depth": 4, "max_bin": 32, "eta": 0.3},
    {"round": 30, "max_depth": 6, "max_bin": 64, "eta": 0.1},
]


def _port(dm):
    return DenseMatrix(dm.x, dm.y, dm.feature_names)


@pytest.fixture(scope="module")
def prepared(higgs_small):
    train, valid = higgs_small
    out = {}
    for mb in sorted({c["max_bin"] for c in CONFIGS}):
        out[mb] = (jget("gbdt").prepare(train, {"max_bin": mb}),
                   get_estimator("gbdt").prepare(_port(train), {"max_bin": mb}))
    return out, valid


@pytest.mark.parametrize("depth,nb", [(d, b) for d in (1, 3, 6) for b in (16, 64, 256)])
def test_build_tree_bit_identical_on_integer_stats(depth, nb):
    rng = np.random.default_rng(depth * 1000 + nb)
    r, f = 500, 7
    bins = rng.integers(0, nb, size=(r, f)).astype(np.int32)
    g = rng.integers(-8, 9, size=r).astype(np.float32)
    h = rng.integers(1, 5, size=r).astype(np.float32)
    kw = dict(n_bins=nb, max_depth=depth, lam=1.0, gamma=0.0, min_child_weight=1.0)
    want = jax.jit(functools.partial(jgbdt.build_tree, **kw))(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h))
    got = gbdt.build_tree(torch.from_numpy(bins), torch.from_numpy(g),
                          torch.from_numpy(h), **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    plain = gbdt.build_tree(torch.from_numpy(bins), torch.from_numpy(g),
                            torch.from_numpy(h), force="ref", **kw)
    for a, b in zip(got[:2], plain[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_train_auc_matches_reference(prepared, cfg):
    params = CONFIGS[cfg]
    (jdata, tdata), valid = prepared[0][params["max_bin"]], prepared[1]
    jm = jget("gbdt").train(jdata, params)
    tm = get_estimator("gbdt").train(tdata, params)
    gap = abs(auc(valid.y, jm.predict_proba(valid.x)) - auc(valid.y, tm.predict_proba(valid.x)))
    assert gap <= AUC_TOL, gap
    assert tm.feat.shape == jm.feat.shape and tm.leaves.shape == jm.leaves.shape
    # device margins: bit-equal to the numpy predictor
    np.testing.assert_array_equal(tm.predict_margin_device(valid.x), tm.predict_margin(valid.x))
    np.testing.assert_array_equal(tm.predict_proba_device(torch.from_numpy(valid.x)),
                                  tm.predict_proba(valid.x))


def test_train_resumable_matches_reference_and_itself(prepared):
    params = CONFIGS[0]
    (jdata, tdata), valid = prepared[0][params["max_bin"]], prepared[1]
    est = get_estimator("gbdt")
    straight = est.train(tdata, params)
    _, s4 = est.train_resumable(tdata, params, budget=4)
    wire = ResumeState.from_wire(s4.to_wire())
    resumed, s10 = est.train_resumable(tdata, params, budget=10, state=wire)
    for k in ("feat", "thresh", "leaves"):
        np.testing.assert_array_equal(getattr(resumed, k), getattr(straight, k))
    assert s10.budget == 10
    jm, _ = jget("gbdt").train_resumable(jdata, params, budget=10)
    gap = abs(auc(valid.y, jm.predict_proba(valid.x))
              - auc(valid.y, resumed.predict_proba(valid.x)))
    assert gap <= AUC_TOL, gap


def test_rung_trained_in_jax_resumes_in_the_port(prepared):
    params = CONFIGS[0]
    (jdata, tdata), valid = prepared[0][params["max_bin"]], prepared[1]
    jm4, js4 = jget("gbdt").train_resumable(jdata, params, budget=4)
    state = ResumeState.from_wire(JResumeState.to_wire(js4))
    model, _ = get_estimator("gbdt").train_resumable(tdata, params, budget=10, state=state)
    np.testing.assert_array_equal(model.feat[:4], jm4.feat)
    assert model.feat.shape[0] == 10
    jm10 = jget("gbdt").train(jdata, params)
    gap = abs(auc(valid.y, jm10.predict_proba(valid.x))
              - auc(valid.y, model.predict_proba(valid.x)))
    assert gap <= AUC_TOL, gap


def test_train_batched_matches_reference(prepared):
    configs = [{"round": 6, "max_depth": 3, "max_bin": 32, "eta": 0.3},
               {"round": 10, "max_depth": 4, "max_bin": 32, "eta": 0.1}]
    (jdata, tdata), valid = prepared[0][32], prepared[1]
    jms = jget("gbdt").train_batched(jdata, configs)
    tms = get_estimator("gbdt").train_batched(tdata, configs)
    for jm, tm in zip(jms, tms):
        assert tm.max_depth == jm.max_depth == 4
        assert tm.feat.shape == jm.feat.shape
        gap = abs(auc(valid.y, jm.predict_proba(valid.x)) - auc(valid.y, tm.predict_proba(valid.x)))
        assert gap <= AUC_TOL, gap
    solo = get_estimator("gbdt").train(tdata, configs[1])
    np.testing.assert_array_equal(tms[1].leaves, solo.leaves)


def test_model_from_reference_margins_bit_equal(prepared):
    params = CONFIGS[1]
    (jdata, _), valid = prepared[0][params["max_bin"]], prepared[1]
    jm = jget("gbdt").train(jdata, params)
    tm = gbdt.model_from_reference(jm.feat, jm.thresh, jm.leaves, jm.base, jm.max_depth)
    want = jm.predict_margin(valid.x)
    np.testing.assert_array_equal(tm.predict_margin(valid.x), want)
    np.testing.assert_array_equal(tm.predict_margin_device(valid.x), want)
    np.testing.assert_array_equal(tm.predict_margin_device(valid.x),
                                  jm.predict_margin_jax(valid.x))


def test_port_training_is_deterministic(prepared):
    params = CONFIGS[1]
    tdata = prepared[0][params["max_bin"]][1]
    a = get_estimator("gbdt").train(tdata, params)
    b = get_estimator("gbdt").train(tdata, params)
    for k in ("feat", "thresh", "leaves"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
