"""The port's LM stack against the JAX package's, on the CPU.

The smoke configs of both ported families, with ``compute_dtype="float32"``
for a tight comparison, run with the JAX package's own weights
(``repro.models.init_params``) carried over by ``params_from_reference``.
Prefill logits, stepwise decode logits and the final hidden states must
match the JAX package's within ``atol=rtol=2e-3``, the tolerance
``tests/test_models.py`` holds its own prefill/decode consistency to; the
port's prefill against its own decode steps likewise.
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
from repro_torch import configs, set_default_device  # noqa: E402
from repro_torch import models  # noqa: E402

set_default_device("cpu")

ARCHS = ("recurrentgemma_9b", "rwkv6_7b")
TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX config, port config, JAX params, port params) of one arch."""
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


def test_prefill_logits_match_reference(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, 24)
    jl, _ = jmodels.prefill(jcfg, jparams, jmodels.init_decode_state(jcfg, 2, 64, jnp.float32),
                            {"tokens": jnp.asarray(toks)})
    logits, _ = models.prefill(cfg, params, models.init_decode_state(cfg, 2, 64, torch.float32),
                               {"tokens": toks})
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(jl), **TOL)


def test_forward_hidden_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, 20, seed=1)
    jh = jmodels.forward_hidden(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    h = models.forward_hidden(cfg, params, {"tokens": toks})
    assert h.shape == (2, 20, cfg.d_model)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


def test_stepwise_decode_matches_reference(pair):
    """Prefill 10 tokens, then decode 8 more one at a time in both packages."""
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, 18, seed=2)
    jst = jmodels.init_decode_state(jcfg, 2, 32, jnp.float32)
    st = models.init_decode_state(cfg, 2, 32, torch.float32)
    jl, jst = jmodels.prefill(jcfg, jparams, jst, {"tokens": jnp.asarray(toks[:, :10])})
    logits, st = models.prefill(cfg, params, st, {"tokens": toks[:, :10]})
    np.testing.assert_allclose(_np(logits), _np(jl), **TOL)
    for i in range(10, 18):
        jl, jst = jmodels.decode_step(jcfg, jparams, jst, jnp.asarray(toks[:, i:i + 1]),
                                      jnp.int32(i))
        logits, st = models.decode_step(cfg, params, st, toks[:, i:i + 1], i)
        np.testing.assert_allclose(_np(logits), _np(jl), **TOL)


def test_prefill_matches_own_decode(pair):
    """Prefill logits at position S-1 == decode-step logits after feeding
    the same S tokens one at a time (tests/test_models.py's check, in the port)."""
    _, cfg, _, params = pair
    toks = _tokens(cfg, 2, 16, seed=3)
    want, _ = models.prefill(cfg, params, models.init_decode_state(cfg, 2, 64, torch.float32),
                             {"tokens": toks})
    st = models.init_decode_state(cfg, 2, 64, torch.float32)
    for i in range(16):
        logits, st = models.decode_step(cfg, params, st, toks[:, i:i + 1], i)
    np.testing.assert_allclose(_np(logits), _np(want), **TOL)


def test_params_from_reference_unstacks_in_layer_order(pair):
    jcfg, cfg, jparams, params = pair
    specs = models.layer_specs(cfg)
    n_pat = len(cfg.pattern)
    assert len(params.layers) == cfg.n_layers == len(specs)
    for idx, layer in enumerate(params.layers):
        if idx < cfg.repeats * n_pat:
            want = jparams["blocks"][f"b{idx % n_pat}"]["norm1"]["scale"][idx // n_pat]
        else:
            want = jparams[f"tail{idx - cfg.repeats * n_pat}"]["norm1"]["scale"]
        np.testing.assert_array_equal(_np(layer["norm1"]["scale"]), np.asarray(want))
    n_ref = sum(leaf.size for leaf in jax.tree.leaves(jparams))
    assert models.count_params(params) == n_ref


def test_init_params_has_the_reference_shapes(pair):
    """Seeded port weights: the JAX package's tree, leaf for leaf in shape."""
    jcfg, cfg, jparams, params = pair
    mine = models.init_params(cfg, seed=0)
    again = models.init_params(cfg, seed=0)
    carried = dict(params.named_parameters())
    for name, p in mine.named_parameters():
        assert p.shape == carried[name].shape and p.dtype == torch.float32, name
        assert torch.equal(p, dict(again.named_parameters())[name]), name
    assert set(dict(mine.named_parameters())) == set(carried)


def test_full_configs_are_the_assigned_ones():
    """Every field of the port's config, and of its layer specs, equals the
    JAX config's (the port carries only the fields it reads)."""
    def spec_fields(spec):
        return {f.name: getattr(spec, f.name) for f in dataclasses.fields(models.LayerSpec)}

    for arch in ARCHS:
        pairs = ((configs.get_config(arch), jconfigs.get_config(arch)),
                 (configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)))
        for mine, ref in pairs:
            for field in dataclasses.fields(mine):
                got, want = getattr(mine, field.name), getattr(ref, field.name)
                if field.name in ("pattern", "tail"):
                    got, want = (tuple(spec_fields(s) for s in x) for x in (got, want))
                assert got == want, (arch, field.name)
    rg = configs.get_config("recurrentgemma-9b")
    assert rg.n_layers == 38 and [s.kind for s in models.layer_specs(rg)].count("rglru") == 26
    assert configs.get_config("rwkv6-7b").n_layers == 32


def test_unported_pieces_raise():
    """Every module of the JAX package is ported: the LM search on mesh
    slices runs on the CPU (tests/test_torch_lm_search.py). A mesh larger
    than the launch's ranks (training over a mesh runs under torchrun,
    tests/test_torch_distributed_mesh.py) and an unknown architecture
    raise. Every architecture of the JAX package is ported
    (tests/test_torch_zoo_configs.py)."""
    from repro_torch.launch.search import main as search
    from repro_torch.launch.train import main as train

    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        train(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu", "--steps", "1",
               "--mesh", "2,1"])
    assert search(["--workload", "lm", "--device", "cpu", "--steps", "1"]) == 0
    with pytest.raises(KeyError):
        configs.get_config("no-such-model")
    assert models.init_params(configs.get_smoke_config("qwen3-moe-235b-a22b")).layers[0]["moe"]


def test_entry_points_need_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    cfg = configs.get_smoke_config("rwkv6_7b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    set_default_device(None)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.init_params(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.init_decode_state(cfg, 1, 8)
        assert models.init_params(cfg, device="cpu").embed.device.type == "cpu"
    finally:
        set_default_device("cpu")
