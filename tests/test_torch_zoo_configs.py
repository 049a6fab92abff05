"""The rest of the LM zoo in the port against the JAX package's, on the CPU.

Whisper-medium (a bidirectional encoder over the audio stub's frames,
cross-attention in every decoder layer, learned positions, LayerNorm, GELU),
InternVL2-1B (the vision stub's patches over the leading positions, GQA,
QKV bias), Qwen3-MoE-235B (128 experts top-8, qk-norm) and Arctic-480B
(128 experts top-2 beside a dense residual FFN): their smoke configs, with
``compute_dtype="float32"`` and the JAX package's own weights carried over by
``params_from_reference``, give prefill and stepwise-decode logits within
2e-3 of the JAX package's (``tests/test_torch_models.py``'s gate), the same
greedy tokens from ``ServeEngine``, and the same training loss and
gradients. The full configs equal the JAX package's field for field, and
their weights have the JAX package's shapes and dtypes, leaf for leaf (the
port's on the ``meta`` device, the JAX package's from ``jax.eval_shape``).
The stub inputs are seeded normal draws, as ``tests/test_models.py`` makes
them; the training launcher draws them as the JAX package's stream does.
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
from repro.data.pipeline import make_lm_stream as jmake_lm_stream  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs, models, set_default_device  # noqa: E402
from repro_torch.data.pipeline import make_lm_stream  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402

set_default_device("cpu")

ZOO = ("whisper_medium", "internvl2_1b", "qwen3_moe_235b", "arctic_480b")
TOL = dict(atol=2e-3, rtol=2e-3)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |value|, as tests/test_torch_train.py
# tests/test_models.py::test_param_counts_match_published's ranges
COUNTS = {"whisper_medium": (0.6e9, 0.9e9), "internvl2_1b": (0.4e9, 0.9e9),
          "qwen3_moe_235b": (230e9, 240e9), "arctic_480b": (460e9, 490e9)}


def _stubs(cfg, b, seed):
    """The stub frontends' inputs, seeded normal draws (tests/test_models.py)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio_stub":
        out["enc_embeds"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.normal(size=(b, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return out


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            **_stubs(cfg, b, seed + 100)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module", params=ZOO)
def pair(request):
    """(JAX config, port config, JAX params, port params) of one arch."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(request.param),
                               compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config(request.param),
                              compute_dtype="float32")
    jparams = jmodels.init_params(jcfg, jax.random.key(1))
    params = models.params_from_reference(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def test_every_architecture_is_ported():
    assert configs.PORTED == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        assert configs.get_config(arch.replace("_", "-")).name == jconfigs.get_config(arch).name


def test_prefill_logits_match_reference(pair):
    """Prefill over 20 tokens, with the stub inputs the config reads."""
    jcfg, cfg, jparams, params = pair
    batch = _batch(cfg, 2, 20)
    jl, _ = jax.jit(lambda p, s, b: jmodels.prefill(jcfg, p, s, b))(
        jparams, jmodels.init_decode_state(jcfg, 2, 32, jnp.float32), _jbatch(batch))
    logits, _ = models.prefill(cfg, params, models.init_decode_state(cfg, 2, 32, torch.float32),
                               batch)
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(jl), **TOL)


def test_stepwise_decode_matches_reference(pair):
    """A prefill, then decode steps one token at a time in both packages:
    whisper's after a 1-token prefill (which fills the cross-attention
    cache), the others' after 10 tokens (for InternVL past its 8 patches,
    since a decode from scratch has no patches: tests/test_models.py)."""
    jcfg, cfg, jparams, params = pair
    batch = _batch(cfg, 2, 18, seed=2)
    start = 1 if cfg.encoder_layers else 10
    pre = {**batch, "tokens": batch["tokens"][:, :start]}
    jst = jmodels.init_decode_state(jcfg, 2, 32, jnp.float32)
    st = models.init_decode_state(cfg, 2, 32, torch.float32)
    jl, jst = jmodels.prefill(jcfg, jparams, jst, _jbatch(pre))
    logits, st = models.prefill(cfg, params, st, pre)
    np.testing.assert_allclose(_np(logits), _np(jl), **TOL)
    jdecode = jax.jit(lambda p, s, t, i: jmodels.decode_step(jcfg, p, s, t, i))
    toks = batch["tokens"]
    for i in range(start, 18):
        jl, jst = jdecode(jparams, jst, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        logits, st = models.decode_step(cfg, params, st, toks[:, i:i + 1], i)
        np.testing.assert_allclose(_np(logits), _np(jl), **TOL)


def test_serve_engine_matches_reference_engine(pair):
    """Both packages' ServeEngine (the JAX one on a 1x1 mesh) serve one
    ragged wave with zero stub inputs: the same greedy tokens."""
    jcfg, cfg, jparams, params = pair

    def wave(cls):
        rng = np.random.default_rng(0)
        return [cls(i, rng.integers(0, cfg.vocab, size=n).astype(np.int32), max_new_tokens=m)
                for i, (n, m) in enumerate(((5, 4), (11, 3), (9, 5)))]

    jengine = JServeEngine(jcfg, jparams, make_test_mesh(1, 1), batch_size=4, max_len=24,
                           cache_dtype=jnp.float32)
    engine = ServeEngine(cfg, params, batch_size=4, max_len=24, cache_dtype=torch.float32)
    got = [r.output for r in engine.serve(wave(Request))]
    assert [len(o) for o in got] == [4, 3, 5]
    assert got == [r.output for r in jengine.serve(wave(JRequest))]


def test_train_loss_and_gradients_match_reference(pair):
    """``train_loss`` and its gradient, leaf for leaf, against the JAX
    package's ``value_and_grad``: the MoE's drops, the encoder and the
    stubs' inputs all carry gradients."""
    jcfg, cfg, jparams, _ = pair
    batch = _batch(cfg, 2, 24, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.train_loss(jcfg, p, b)))(jparams, _jbatch(batch))
    tree = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), jparams)
    leaves = tree_leaves(tree)
    loss = models.train_loss(cfg, tree, batch)
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_TOL * scale


def test_params_to_reference_round_trips(pair):
    jcfg, cfg, jparams, params = pair
    tree = models.params_to_reference(cfg, params)
    got, want = tree_leaves(tree), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert models.count_params(params) == sum(leaf.size for leaf in want)


@pytest.mark.parametrize("arch", ZOO)
def test_full_config_equals_the_reference(arch):
    def spec_fields(spec):
        return {f.name: getattr(spec, f.name) for f in dataclasses.fields(models.LayerSpec)}

    for mine, ref in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch))):
        for field in dataclasses.fields(mine):
            got, want = getattr(mine, field.name), getattr(ref, field.name)
            if field.name in ("pattern", "tail"):
                got, want = (tuple(spec_fields(s) for s in x) for x in (got, want))
            assert got == want, (arch, field.name)


@pytest.mark.parametrize("arch", ZOO)
def test_full_config_param_shapes_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    mine = models.params_to_reference(cfg, models.init_params(cfg, device="meta"))
    want = jax.eval_shape(lambda k: jmodels.init_params(jcfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, want))
    for got, ref in zip(tree_leaves(mine), jax.tree.leaves(want)):
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(ref.shape)
        assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)
    lo, hi = COUNTS[arch]
    assert lo <= models.count_params(mine) <= hi


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
def test_stub_extras_match_the_reference_stream(arch):
    """``make_lm_stream(extras=...)``: the JAX stream's draws, in this
    process (the reference seeds them with a per-process string hash)."""
    from repro_torch.launch.train import _stub_extras

    cfg = configs.get_smoke_config(arch)
    extras = _stub_extras(cfg, 2)
    assert set(extras) == {"enc_embeds" if cfg.frontend == "audio_stub" else "patch_embeds"}
    stream = make_lm_stream(2, 16, cfg.vocab, seed=3, extras=extras, device="cpu")
    jstream = jmake_lm_stream(make_test_mesh(1, 1), 2, 16, cfg.vocab, seed=3, extras=extras)
    try:
        for step in (0, 1, 5):
            got, want = stream.get(step), jstream.get(step)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    finally:
        stream.close()
        jstream.close()


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b", "qwen3-moe-235b-a22b",
                                  "arctic-480b"])
def test_launchers_serve_and_train_on_the_cpu(arch, capsys):
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train

    assert serve(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                  "--new-tokens", "3", "--batch", "2"]) == 0
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out
    assert train(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch",
                  "2", "--seq-len", "16"]) == 0
    assert "nan_skips=0" in capsys.readouterr().out
