"""The port's mixture-of-experts layer and blocked attention against the JAX
package's, on the CPU.

``moe_apply`` runs the reference's sorted capacity dispatch; a slot is
dropped when its rank among its expert's slots, in token-major order,
reaches the capacity. Held here at a capacity factor that drops slots and
at one that drops none, with and without Arctic's dense residual FFN, in
float32: within 1e-5 of the JAX package's output, and both within 1e-5 of
a per-token loop that keeps exactly the slots the rule keeps (so the same
slots were dropped). ``attention_xla_blocked`` (the plain attention in
query blocks that ``ops.attention`` takes on the CPU past 2,048 queries)
against the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import Init as JInit  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import aux_load_balance_loss, moe_apply  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402

MOE_TOL = dict(atol=1e-5, rtol=1e-5)
D, E, FF, K = 32, 8, 48, 2


def _silu(v):
    return v / (1.0 + np.exp(-v))


def _per_token(p, x, top_k, capacity_factor):
    """The MoE as a loop over tokens, in float64: route, keep a slot while
    its expert has taken fewer than ``cap`` slots in token-major order,
    sum each kept expert's weighted SwiGLU output. Returns (y, dropped)."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    t, e = xt.shape[0], p["router"].shape[1]
    logits = xt @ np.asarray(p["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    cap = max(8, int(np.ceil(t * top_k * capacity_factor / e)))
    taken = np.zeros(e, int)
    y = np.zeros_like(xt)
    dropped = 0
    for i in range(t):
        top = np.argsort(-probs[i], kind="stable")[:top_k]
        w = probs[i, top] / max(probs[i, top].sum(), 1e-9)
        for ex, wj in zip(top, w):
            if taken[ex] >= cap:
                dropped += 1
                continue
            taken[ex] += 1
            wg, wu, wd = (np.asarray(p[n][ex], np.float64) for n in ("w_gate", "w_up", "w_down"))
            y[i] += wj * ((_silu(xt[i] @ wg) * (xt[i] @ wu)) @ wd)
    if "dense" in p:
        dp = {k: np.asarray(v, np.float64) for k, v in p["dense"].items()}
        y += (_silu(xt @ dp["w_gate"]) * (xt @ dp["w_up"])) @ dp["w_down"]
    return y.reshape(x.shape), dropped


@pytest.fixture(scope="module", params=[0, 96], ids=["moe", "moe_dense_residual"])
def moe_params(request):
    return jax.tree.map(np.array, jmoe.init_moe(
        JInit(jax.random.key(7)), D, E, FF, dense_residual_ff=request.param))


@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True), (8.0, False)])
def test_moe_apply_matches_reference(moe_params, capacity_factor, drops):
    x = np.random.default_rng(0).normal(size=(3, 40, D)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jmoe.moe_apply(
        p, x, top_k=K, capacity_factor=capacity_factor))(
        jax.tree.map(jnp.asarray, moe_params), jnp.asarray(x)))
    got = moe_apply(jax.tree.map(torch.from_numpy, moe_params), torch.from_numpy(x),
                    top_k=K, capacity_factor=capacity_factor)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **MOE_TOL)
    loop, dropped = _per_token(moe_params, x, K, capacity_factor)
    assert (dropped > 0) == drops
    np.testing.assert_allclose(got.numpy(), loop, **MOE_TOL)
    np.testing.assert_allclose(want, loop, **MOE_TOL)


def test_moe_capacity_is_the_reference_formula():
    assert capacity(120, 2, 0.5, 8) == 15 and capacity(4, 2, 1.25, 128) == 8
    assert capacity(16384, 8, 1.25, 128) == 1280 and capacity(4096, 2, 1.25, 128) == 80


def test_moe_gradient_matches_reference(moe_params):
    """The gradient of a scalar of the output w.r.t. the input and the
    router: the drops and the renormalised top-k weights carry through."""
    x = np.random.default_rng(1).normal(size=(2, 30, D)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jnp.sin(jmoe.moe_apply(p, x, top_k=K, capacity_factor=0.5)))

    jgx, jgp = jax.jit(jax.grad(jloss, argnums=(1, 0)))(
        jax.tree.map(jnp.asarray, moe_params), jnp.asarray(x))
    p = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), moe_params)
    xt = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(torch.sin(moe_apply(p, xt, top_k=K, capacity_factor=0.5)))
    gx, grouter = torch.autograd.grad(loss, [xt, p["router"]])
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **MOE_TOL)
    np.testing.assert_allclose(grouter.numpy(), np.asarray(jgp["router"]), **MOE_TOL)


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(E), size=50).astype(np.float32)
    top_e = np.argsort(-probs, axis=-1)[:, :K].astype(np.int64)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(top_e), E))
    got = float(aux_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(top_e), E))
    assert abs(got - want) <= 1e-6 * abs(want)


BLOCKED = [  # b, hq, hkv, tq, tk, causal, window, softcap, block_q
    (2, 4, 2, 100, 100, True, None, None, 32),      # GQA, causal, ragged last block
    (1, 4, 1, 70, 70, True, 20, None, 16),          # MQA, window
    (1, 2, 2, 50, 90, True, None, 30.0, 16),        # Tq < Tk: queries at the last positions
    (2, 2, 2, 64, 40, False, None, None, 16),       # bidirectional, Tq > Tk
    (1, 2, 2, 40, 40, True, None, None, 64),        # one block: attention_ref itself
]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,causal,window,cap,block_q", BLOCKED)
@pytest.mark.parametrize("matmul_dtype", ["float32", "input"])
def test_attention_xla_blocked_matches_reference(b, hq, hkv, tq, tk, causal, window, cap,
                                                 block_q, matmul_dtype):
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, hq, tq, 16), (b, hkv, tk, 16), (b, hkv, tk, 16)))
    kw = dict(causal=causal, window=window, logit_softcap=cap, block_q=block_q,
              matmul_dtype=matmul_dtype)
    want = np.asarray(jax.jit(lambda *a: jref.attention_xla_blocked(*a, **kw))(
        *map(jnp.asarray, (q, k, v))))
    got = ref.attention_xla_blocked(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5, equal_nan=True)


def test_ops_attention_takes_the_blocked_path_past_2048_queries(monkeypatch):
    calls = []
    blocked = ref.attention_xla_blocked
    monkeypatch.setattr(ref, "attention_xla_blocked",
                        lambda *a, **kw: calls.append(a[0].shape) or blocked(*a, **kw))
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((1, 1, t, 8), generator=gen) for t in (2049, 2049, 2049))
    out = ops.attention(q, k, v)
    assert calls == [(1, 1, 2049, 8)]
    torch.testing.assert_close(out, ref.attention_ref(q, k, v), atol=1e-6, rtol=1e-5)
    ops.attention(q[:, :, :2048], k, v)
    ops.attention(q, k, v, force="ref")
    assert len(calls) == 1
