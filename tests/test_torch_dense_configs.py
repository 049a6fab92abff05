"""The four dense LM configs of the port against the JAX package's, on the CPU.

Qwen2-1.5B (QKV bias, GQA), TinyLlama-1.1B (untied ``lm_head``), Gemma-2B
(``embed_scale``, GeGLU, MQA) and Gemma3-12B (5:1 local:global attention,
window and RoPE θ per layer, qk-norm, post-norms): their smoke configs, with
``compute_dtype="float32"`` and the JAX package's own weights carried over
by ``params_from_reference``, give prefill and stepwise-decode logits within
2e-3 of the JAX package's (``tests/test_torch_models.py``'s gate), and
``ServeEngine`` the same greedy tokens. The full configs equal the JAX
package's field for field, and their weights have the JAX package's shapes,
leaf for leaf (the port's on the ``meta`` device, the JAX package's from
``jax.eval_shape``: nothing is allocated).
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
from repro_torch import configs, models, set_default_device  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

set_default_device("cpu")

DENSE = ("qwen2_1_5b", "tinyllama_1_1b", "gemma_2b", "gemma3_12b")
TOL = dict(atol=2e-3, rtol=2e-3)
# (params, head_dim, n_heads, n_kv_heads, window of the first layer)
FULL = {"qwen2_1_5b": (1.54e9, 128, 12, 2, None),
        "tinyllama_1_1b": (1.10e9, 64, 32, 4, None),
        "gemma_2b": (2.51e9, 256, 8, 1, None),
        "gemma3_12b": (11.8e9, 256, 16, 8, 1024)}


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(request.param),
                               compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config(request.param),
                              compute_dtype="float32")
    jparams = jmodels.init_params(jcfg, jax.random.key(1))
    params = models.params_from_reference(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def test_dense_configs_are_ported():
    assert set(DENSE) <= set(configs.PORTED)
    for arch in DENSE:
        assert configs.get_config(arch.replace("_", "-")).name == jconfigs.get_config(arch).name


def test_prefill_logits_match_reference(pair):
    """Prefill over 40 tokens: longer than Gemma3's smoke window (16)."""
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, 40)
    jl, _ = jmodels.prefill(jcfg, jparams, jmodels.init_decode_state(jcfg, 2, 64, jnp.float32),
                            {"tokens": jnp.asarray(toks)})
    logits, _ = models.prefill(cfg, params, models.init_decode_state(cfg, 2, 64, torch.float32),
                               {"tokens": toks})
    assert logits.shape == (2, cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(jl), **TOL)


def test_stepwise_decode_matches_reference(pair):
    """Prefill 12 tokens, then decode 12 more one at a time (past the window);
    the JAX package's decode step jitted once."""
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, 24, seed=2)
    jst = jmodels.init_decode_state(jcfg, 2, 32, jnp.float32)
    st = models.init_decode_state(cfg, 2, 32, torch.float32)
    jl, jst = jmodels.prefill(jcfg, jparams, jst, {"tokens": jnp.asarray(toks[:, :12])})
    logits, st = models.prefill(cfg, params, st, {"tokens": toks[:, :12]})
    np.testing.assert_allclose(_np(logits), _np(jl), **TOL)
    jdecode = jax.jit(lambda p, s, t, i: jmodels.decode_step(jcfg, p, s, t, i))
    for i in range(12, 24):
        jl, jst = jdecode(jparams, jst, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        logits, st = models.decode_step(cfg, params, st, toks[:, i:i + 1], i)
        np.testing.assert_allclose(_np(logits), _np(jl), **TOL)


def test_bf16_prefill_logits_near_reference(pair):
    """The smoke config as it ships (bf16 compute): within 2e-2 of max
    |logit|, both packages rounding every layer to bf16."""
    jcfg, cfg, jparams, params = pair
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, cfg))
    toks = _tokens(cfg, 2, 20, seed=4)
    jl, _ = jmodels.prefill(jcfg, jparams, jmodels.init_decode_state(jcfg, 2, 32),
                            {"tokens": jnp.asarray(toks)})
    logits, _ = models.prefill(cfg, params, models.init_decode_state(cfg, 2, 32),
                               {"tokens": toks})
    scale = float(np.abs(_np(jl)).max())
    assert float(np.abs(_np(logits) - _np(jl)).max()) <= 2e-2 * scale


def test_serve_engine_greedy_tokens(pair):
    """The port's ServeEngine serves a ragged wave, the unpadded request's
    first token being its own prefill's greedy token."""
    _, cfg, _, params = pair
    rng = np.random.default_rng(0)
    wave = [Request(i, rng.integers(0, cfg.vocab, size=n).astype(np.int32), max_new_tokens=4)
            for i, n in enumerate((5, 9))]
    out = ServeEngine(cfg, params, batch_size=2, max_len=24,
                      cache_dtype=torch.float32).serve(wave)
    assert [len(r.output) for r in out] == [4, 4]
    st = models.init_decode_state(cfg, 1, 24, torch.float32)
    logits, st = models.prefill(cfg, params, st, {"tokens": out[1].prompt[None]})
    assert int(logits.argmax(-1)) == out[1].output[0]


def test_params_to_reference_round_trips(pair):
    jcfg, cfg, jparams, params = pair
    tree = models.params_to_reference(cfg, params)
    for got, want in zip(tree_leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DENSE)
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
    n, head_dim, n_heads, n_kv, window = FULL[arch]
    cfg = configs.get_config(arch)
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.pattern[0].window) == \
        (head_dim, n_heads, n_kv, window)


@pytest.mark.parametrize("arch", DENSE)
def test_full_config_param_shapes_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    mine = models.params_to_reference(cfg, models.init_params(cfg, device="meta"))
    want = jax.eval_shape(lambda k: jmodels.init_params(jcfg, k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, want))
    for got, ref in zip(tree_leaves(mine), jax.tree.leaves(want)):
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(ref.shape) and got.dtype == torch.float32
    n = models.count_params(mine)
    assert abs(n - FULL[arch][0]) <= 0.01 * FULL[arch][0], n
