"""The port's LM train path against the JAX package's, on the CPU.

For the smoke config of every ported architecture, the JAX package's own
weights (``repro.models.init_params``) carried over by
``params_from_reference``/``params_to_reference`` and the same
``TokenStream`` batches go through both packages' train path:

* ``train_loss`` within 1e-5 relative, and every gradient leaf within 1e-4
  of that leaf's largest |gradient|, with ``compute_dtype="float32"`` (as
  ``tests/test_torch_models.py``): in bf16 both packages round every
  layer's products and a loss differs by 4e-5–3e-4 relative, which the
  bf16 case holds to 1e-3;
* five AdamW steps (the JAX package's value-and-grad jitted once an
  architecture, its clip and update as its train step runs them): every
  step's loss within 1e-4 relative;
* one step of Adafactor and of SGD-momentum likewise (the first step's
  loss and gradient norm, the second step's loss); and each optimizer's
  update from the same gradients within 1e-5 of each leaf's scale;
* the non-finite guard: at ``lr=1e30`` a step whose loss is not finite is
  dropped, and the parameters stay finite.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro_torch import configs, models, set_default_device  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.train import build_train_step, make_optimizer  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402

set_default_device("cpu")

ARCHS = ("qwen2_1_5b", "tinyllama_1_1b", "gemma_2b", "gemma3_12b", "recurrentgemma_9b",
         "rwkv6_7b")
BATCH, SEQ = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |value|
STEPS_RTOL = 1e-4


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), compute_dtype=dtype),
            dataclasses.replace(configs.get_smoke_config(arch), compute_dtype=dtype))


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = jmodels.init_params(jcfg, jax.random.key(1))
    stream = TokenStream(BATCH, SEQ, cfg.vocab, seed=0)
    return request.param, jcfg, cfg, jparams, stream


@pytest.fixture(scope="module")
def jax_vg(case):
    """The JAX package's ``value_and_grad`` of ``train_loss``, jitted once
    an architecture (one XLA compile serves every step and batch)."""
    jcfg = case[1]
    return jax.jit(jax.value_and_grad(lambda p, b: jmodels.train_loss(jcfg, p, b)))


@pytest.fixture(scope="module")
def jax_value_and_grad(case, jax_vg):
    """The JAX package's loss and gradients on batch 0."""
    _, _, _, jparams, stream = case
    return jax_vg(jparams, _jbatch(stream.batch_at(0)))


def _tree(jtree):
    """A JAX tree as the port's: nested dicts of CPU tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jtree)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _leaves_close(got, want, tol, what):
    """Every leaf of the port's tree within ``tol`` of the JAX leaf's scale,
    leaf for leaf in ``jax.tree.leaves`` order."""
    want_leaves = jax.tree.leaves(want)
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves), what
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.detach().float().numpy() - w).max())
        assert err <= tol * scale, (what, err / scale)


_JAX_UPDATES: dict = {}


def _jax_optimizer(name, **kw):
    """The JAX package's optimizer ``name`` and its clip-and-update, jitted
    once a process (elementwise programs: a fraction of a model's compile)."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _JAX_UPDATES:
        jopt = jtrain.make_optimizer(name, **kw)

        def clip_update(grads, state, params, step):
            grads, gnorm = jtrain.optimizer.clip_by_global_norm(grads, 1.0)
            return jopt.update(grads, state, params, step) + (gnorm,)

        _JAX_UPDATES[key] = (jopt, jax.jit(clip_update))
    return _JAX_UPDATES[key]


def _jax_steps(jax_vg, name, kw, jparams, stream, n):
    """``n`` steps of the JAX package's train step (``build_train_step``'s
    gspmd form: value and grad, the global-norm clip at 1.0, the update);
    returns each step's (loss, grad norm)."""
    jopt, clip_update = _jax_optimizer(name, **kw)
    params, state, out = jparams, jopt.init(jparams), []
    for i in range(n):
        loss, grads = jax_vg(params, _jbatch(stream.batch_at(i)))
        params, state, gnorm = clip_update(grads, state, params, jnp.int32(i))
        out.append((float(loss), float(gnorm)))
    return out


def test_train_loss_matches_reference(case, jax_value_and_grad):
    _, _, cfg, jparams, stream = case
    b = stream.batch_at(0)
    want = float(jax_value_and_grad[0])
    got = float(models.train_loss(cfg, _tree(jparams), b))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


def test_gradients_match_reference(case, jax_value_and_grad):
    _, _, cfg, jparams, stream = case
    b = stream.batch_at(0)
    jgrads = jax_value_and_grad[1]
    tree = tree_map(lambda t: t.requires_grad_(), _tree(jparams))
    leaves = tree_leaves(tree)
    grads = torch.autograd.grad(models.train_loss(cfg, tree, b), leaves)
    by_leaf = dict(zip(map(id, leaves), grads))
    _leaves_close(tree_map(lambda t: by_leaf[id(t)], tree), jgrads, GRAD_TOL, "gradient")


def test_adamw_steps_match_reference(case, jax_vg):
    _, _, cfg, jparams, stream = case
    want = _jax_steps(jax_vg, "adamw", {"lr": 3e-3}, jparams, stream, 5)
    opt = make_optimizer("adamw", lr=3e-3)
    step = build_train_step(cfg, opt)
    params = _tree(jparams)
    state = {"step": 0, "params": params, "opt_state": opt.init(params)}
    for i in range(5):
        state, m = step(state, stream.batch_at(i))
        assert abs(float(m["loss"]) - want[i][0]) <= STEPS_RTOL * abs(want[i][0]), i
    assert state["step"] == 5


@pytest.mark.parametrize("name,kw", [("adafactor", {"lr": 1e-2}),
                                     ("sgdm", {"lr": 0.1})])
def test_one_step_of_other_optimizers_matches_reference(case, jax_vg, name, kw):
    """The first step's loss and gradient norm, and the second step's loss
    (on the first step's update), within 1e-4 relative."""
    _, _, cfg, jparams, stream = case
    want = _jax_steps(jax_vg, name, kw, jparams, stream, 2)
    opt = make_optimizer(name, **kw)
    step = build_train_step(cfg, opt)
    params = _tree(jparams)
    state = {"step": 0, "params": params, "opt_state": opt.init(params)}
    for i in range(2):
        state, m = step(state, stream.batch_at(i))
        for j, key in enumerate(("loss", "grad_norm") if i == 0 else ("loss",)):
            assert abs(float(m[key]) - want[i][j]) <= STEPS_RTOL * abs(want[i][j]), (i, key)


@pytest.mark.parametrize("name,kw", [("adamw", {"lr": 3e-3, "weight_decay": 0.1}),
                                     ("adafactor", {"lr": 1e-2}),
                                     ("sgdm", {"lr": 0.1})])
def test_optimizer_update_matches_reference(case, jax_value_and_grad, name, kw):
    """One update from the same (the JAX package's clipped) gradients, at
    the third step: the new parameters and optimizer state within 1e-5 of
    each leaf's scale. Adafactor divides a gradient by a factored second
    moment, so near-zero gradient entries amplify the two packages' float32
    gradient noise; fed the same gradients, only the formulas are held."""
    _, _, _, jparams, _ = case
    (jopt, clip_update), opt = _jax_optimizer(name, **kw), make_optimizer(name, **kw)
    jgrads, _ = jtrain.optimizer.clip_by_global_norm(jax_value_and_grad[1], 1.0)
    jstate = jopt.init(jparams)
    state = opt.init(_tree(jparams))
    for step in range(3):
        # the gradients are clipped already: clipping them again changes nothing
        jnew, jstate_next, _ = clip_update(jgrads, jstate, jparams, jnp.int32(step))
        new, state_next = opt.update(_tree(jgrads), state, _tree(jparams), step)
        jstate, state = jstate_next, state_next
    _leaves_close(new, jnew, 1e-5, f"{name} params")
    _leaves_close(state, jstate, 1e-5, f"{name} state")


def test_nonfinite_step_is_dropped(case):
    """lr=1e30: the first update throws the weights far out, the next
    step's loss is not finite, and that step leaves the state as it was."""
    _, _, cfg, jparams, stream = case
    opt = make_optimizer("adamw", lr=1e30)
    step = build_train_step(cfg, opt)
    params = _tree(jparams)
    state = {"step": 0, "params": params, "opt_state": opt.init(params)}
    dropped = 0
    for i in range(3):
        before = state
        state, m = step(state, stream.batch_at(i))
        assert state["step"] == i + 1
        if not bool(torch.isfinite(m["loss"]) & torch.isfinite(m["grad_norm"])):
            dropped += 1
            assert state["params"] is before["params"]
            assert state["opt_state"] is before["opt_state"]
    assert dropped >= 1
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state["params"]))


def test_bf16_train_loss_within_bf16_noise_of_reference(case):
    arch, _, _, jparams, stream = case
    jcfg, cfg = _cfgs(arch, "bfloat16")
    b = stream.batch_at(0)
    want = float(jmodels.train_loss(jcfg, jparams, _jbatch(b)))
    got = float(models.train_loss(cfg, _tree(jparams), b))
    assert abs(got - want) <= 1e-3 * abs(want)


def test_params_to_reference_inverts_params_from_reference(case):
    _, _, cfg, jparams, _ = case
    tree = models.params_to_reference(cfg, models.params_from_reference(
        cfg, jax.tree.map(np.asarray, jparams)))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, tree)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, jparams))
    for got, want in zip(tree_leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lm_loss_masks_labels_and_chunks():
    """Labels < 0 add nothing; the chunking (a remainder chunk included)
    does not change the mean."""
    cfg = configs.get_smoke_config("tinyllama_1_1b")
    params = models.init_params(cfg, seed=0, device="cpu")
    b = TokenStream(2, 40, cfg.vocab, seed=1).batch_at(0)
    hidden = models.forward_hidden(cfg, params, b)
    full = models.lm_loss(cfg, params, hidden, b["labels"])
    one = models.lm_loss(dataclasses.replace(cfg, loss_chunk=40), params, hidden, b["labels"])
    torch.testing.assert_close(full, one, rtol=1e-6, atol=0)
    labels = b["labels"].copy()
    labels[:, 20:] = -1
    masked = models.lm_loss(cfg, params, hidden, labels)
    head = models.lm_loss(cfg, params, hidden[:, :20], b["labels"][:, :20])
    torch.testing.assert_close(masked, head, rtol=1e-6, atol=0)
