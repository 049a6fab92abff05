"""The port's logistic regression, MLP and numpy families against the JAX
package's, on the CPU, and the estimator registry.

Adam normalises each gradient component by its own running scale, so float32
differences of an ulp in a small gradient (the two frameworks sum rows in
other orders) move a step by much more than an ulp. Logreg is worst: the
labels are balanced, so the bias's first gradients are rounding noise. Hence
tolerances, each measured on these inputs:

* logreg after 200 steps: w and b within ``LOGREG_PARAM_TOL`` (measured
  1.8e-3 and 1.3e-3 at c = 0.9, 1.1e-6 at c = 0.011, where the stronger
  penalty pulls both runs to one optimum), probabilities within
  ``LOGREG_PROBA_TOL`` (measured 5.4e-4);
* MLP ``64_64_64`` after 100 steps, with JAX's initial weights and minibatch
  indices fed through the seam: params within ``MLP_PARAM_TOL`` (measured
  1.1e-6), probabilities within ``MLP_PROBA_TOL`` (measured 7.2e-7).

Resume (k + (n − k) steps against n) is held to 1e-6, as
``tests/test_adaptive.py`` holds the reference; the numpy families, whose
code is the reference's, are held bit for bit.
"""
import jax
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

import repro.tabular  # noqa: F401,E402  (registers the JAX estimators)
import repro_torch.tabular  # noqa: F401,E402  (registers the port's estimators)
from repro.core.interface import get_estimator as jget  # noqa: E402
from repro.tabular import mlp as jmlp  # noqa: E402
from repro_torch import set_default_device  # noqa: E402
from repro_torch.core.data_format import DenseMatrix  # noqa: E402
from repro_torch.core.interface import (  # noqa: E402
    ResumeState,
    estimator_names,
    get_estimator,
)
from repro_torch.tabular.draws import FixedMLPDraws, MLPDraws  # noqa: E402

set_default_device("cpu")

LOGREG_PARAM_TOL = 5e-3
LOGREG_PROBA_TOL = 2e-3
MLP_PARAM_TOL = 1e-5
MLP_PROBA_TOL = 1e-5
RESUME_TOL = 1e-6


def _port(dm):
    return DenseMatrix(dm.x, dm.y, dm.feature_names)


@pytest.fixture(scope="module")
def prepared(higgs_small):
    train, valid = higgs_small
    return jget("logreg").prepare(train, {}), get_estimator("logreg").prepare(_port(train), {}), valid


def _close_logreg(tm, jm, valid):
    np.testing.assert_allclose(tm.w, jm.w, atol=LOGREG_PARAM_TOL, rtol=0)
    assert abs(tm.b - jm.b) <= LOGREG_PARAM_TOL
    np.testing.assert_allclose(tm.predict_proba(valid.x), jm.predict_proba(valid.x),
                               atol=LOGREG_PROBA_TOL, rtol=0)


@pytest.mark.parametrize("c", [0.011, 0.9])
def test_logreg_matches_reference(prepared, c):
    jdata, tdata, valid = prepared
    params = {"c": c, "steps": 200}
    tm = get_estimator("logreg").train(tdata, params)
    _close_logreg(tm, jget("logreg").train(jdata, params), valid)
    np.testing.assert_array_equal(tm.predict_margin_device(valid.x),
                                  tm.predict_margin_batched([tm], valid.x)[0])
    np.testing.assert_allclose(tm.predict_proba_device(torch.from_numpy(valid.x)),
                               tm.predict_proba(valid.x), atol=1e-6)


def test_logreg_step_padded_batch_matches_reference(prepared):
    jdata, tdata, valid = prepared
    configs = [{"c": 0.011, "steps": 120}, {"c": 0.9, "steps": 200, "lr": 0.03}]
    tms = get_estimator("logreg").train_batched(tdata, configs)
    for tm, jm in zip(tms, jget("logreg").train_batched(jdata, configs)):
        _close_logreg(tm, jm, valid)
    # the shorter config froze at its own step count
    solo = get_estimator("logreg").train(tdata, configs[0])
    np.testing.assert_allclose(tms[0].w, solo.w, atol=RESUME_TOL, rtol=0)


def _jax_mlp_draws(seed, dims, n_rows, steps, batch_size) -> FixedMLPDraws:
    """The initial weights and minibatch indices ``repro.tabular.mlp`` draws."""
    key = jax.random.key(seed)
    init = [(np.asarray(w), np.asarray(b)) for w, b in jmlp._init_params(key, dims)]
    batches = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        batches.append(np.asarray(jax.random.randint(k, (batch_size,), 0, n_rows)))
    return FixedMLPDraws(init, np.stack(batches), "cpu")


def test_mlp_matches_reference_with_its_draws(prepared):
    jdata, tdata, valid = prepared
    params = {"network": "64_64_64", "learning_rate": 0.003, "steps": 100,
              "batch_size": 128, "seed": 3}
    n, f = tdata["x"].shape
    draws = _jax_mlp_draws(3, (f, 64, 64, 64, 1), n, 100, 128)
    tm = get_estimator("mlp").train(tdata, params, draws=draws)
    jm = jget("mlp").train(jdata, params)
    assert [w.shape for w, _ in tm.params] == [w.shape for w, _ in jm.params]
    for (tw, tb), (jw, jb) in zip(tm.params, jm.params):
        np.testing.assert_allclose(tw, jw, atol=MLP_PARAM_TOL, rtol=0)
        np.testing.assert_allclose(tb, jb, atol=MLP_PARAM_TOL, rtol=0)
    np.testing.assert_allclose(tm.predict_proba(valid.x), jm.predict_proba(valid.x),
                               atol=MLP_PROBA_TOL, rtol=0)
    np.testing.assert_allclose(tm.predict_proba_device(valid.x), tm.predict_proba(valid.x),
                               atol=1e-6)


@pytest.mark.parametrize("family,params,k,n", [
    ("logreg", {"c": 0.3}, 40, 100),
    ("mlp", {"network": "32_16", "steps": 60}, 25, 60),
])
def test_resume_matches_straight(prepared, family, params, k, n):
    _, tdata, valid = prepared
    est = get_estimator(family)
    straight = est.train(tdata, {**params, est.budget_param: n})
    _, s_k = est.train_resumable(tdata, params, budget=k)
    wire = ResumeState.from_wire(s_k.to_wire())
    for key, value in s_k.payload.items():
        np.testing.assert_array_equal(np.asarray(wire.payload[key]), np.asarray(value))
    resumed, s_n = est.train_resumable(tdata, params, budget=n, state=wire)
    assert s_n.budget == n
    np.testing.assert_allclose(resumed.predict_proba(valid.x), straight.predict_proba(valid.x),
                               atol=RESUME_TOL, rtol=0)


def test_mlp_batched_equals_sequential_and_rejects_mixed(prepared):
    _, tdata, valid = prepared
    configs = [{"network": "32_32", "learning_rate": 0.01, "steps": 30, "seed": 1},
               {"network": "32_32", "learning_rate": 0.003, "steps": 50, "seed": 2}]
    est = get_estimator("mlp")
    for bm, cfg in zip(est.train_batched(tdata, configs), configs):
        solo = est.train(tdata, cfg)
        np.testing.assert_allclose(bm.predict_proba(valid.x), solo.predict_proba(valid.x),
                                   atol=RESUME_TOL, rtol=0)
    with pytest.raises(ValueError, match="mixes architectures"):
        est.train_batched(tdata, [configs[0], {**configs[1], "network": "64"}])


def test_mlp_draws_seeded():
    a, b = MLPDraws(4, "cpu"), MLPDraws(4, "cpu")
    for (wa, ba), (wb, bb) in zip(a.init((5, 8, 1)), b.init((5, 8, 1))):
        assert torch.equal(wa, wb) and torch.equal(ba, bb) and not ba.any()
    assert torch.equal(a.batch(0, 100, 16), b.batch(0, 100, 16))
    state = a.state()
    nxt = a.batch(1, 100, 16)
    assert torch.equal(MLPDraws(4, "cpu", state=state).batch(1, 100, 16), nxt)
    assert not torch.equal(MLPDraws(5, "cpu").init((5, 8, 1))[0][0],
                           MLPDraws(4, "cpu").init((5, 8, 1))[0][0])


@pytest.mark.parametrize("family,params", [
    ("np_logreg", {"c": 0.5, "steps": 50}),
    ("np_mlp", {"network": "16_8", "steps": 40, "seed": 2}),
])
def test_numpy_families_bit_equal_to_reference(prepared, family, params):
    jdata, tdata, valid = prepared
    tm = get_estimator(family).train(tdata, params)
    jm = jget(family).train(jdata, params)
    np.testing.assert_array_equal(tm.predict_proba(valid.x), jm.predict_proba(valid.x))


def test_registry_has_all_six_families():
    assert set(estimator_names()) >= {"gbdt", "forest", "logreg", "mlp", "np_logreg", "np_mlp"}
