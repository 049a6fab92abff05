"""The port's LM kernel layer against the JAX package's.

The same seeded numpy inputs go through ``repro.kernels`` (JAX on the CPU:
the oracle ``ref.*`` and the Pallas kernel in interpret mode through
``ops.*(..., force="kernel")``, as ``tests/test_kernels.py`` runs them) and
``repro_torch.kernels.ops`` on CPU tensors, which is the plain PyTorch
version. Tolerances: float32 within 2e-5 of the JAX oracle (the same
arithmetic, another framework's transcendental functions and sum order),
bf16 within 2e-2 (each side rounds one float32 result to bf16: up to one
bf16 ulp); against the chunked Pallas RWKV-6 kernel 5e-3, the tolerance
``tests/test_kernels.py`` holds it to the oracle with. The CUDA kernels
themselves run only on a card: ``test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATTN_GRID = [  # the shape grid of tests/test_kernels.py
    (1, 2, 2, 128, 64, True, None),
    (2, 4, 2, 256, 64, True, None),      # GQA
    (1, 4, 1, 256, 128, True, None),     # MQA
    (1, 2, 2, 256, 64, False, None),     # bidirectional
    (1, 2, 1, 256, 64, True, 64),        # sliding window
]
RAGGED_ATTN = [  # b, hq, hkv, tq, tk, d, window: shapes the TPU dispatch sends to XLA
    (2, 4, 2, 100, 100, 32, None),
    (1, 4, 1, 1, 64, 16, None),          # decode-style Tq=1
    (1, 2, 1, 37, 90, 16, 20),           # chunked-prefill offset, window
]


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _both(arrays, dtype="float32"):
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(port, want, tol):
    np.testing.assert_allclose(_np(port), _np(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,t,d,causal,window", ATTN_GRID)
def test_attention_matches_reference(b, hq, hkv, t, d, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(0, (b, hq, t, d), (b, hkv, t, d),
                                            (b, hkv, t, d)), dtype)
    kw = dict(causal=causal, window=window)
    got = ops.attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    _close(got, jref.attention_ref(jq, jk, jv, **kw), tol)
    _close(got, jops.attention(jq, jk, jv, block_q=128, block_k=128, force="kernel", **kw),
           tol)


def test_attention_softcap_matches_reference():
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, *[(1, 2, 128, 64)] * 3))
    got = ops.attention(q, k, v, logit_softcap=30.0)
    _close(got, jref.attention_ref(jq, jk, jv, logit_softcap=30.0), 2e-5)
    _close(got, jops.attention(jq, jk, jv, logit_softcap=30.0, block_q=64, block_k=64,
                               force="kernel"), 2e-5)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,window", RAGGED_ATTN)
def test_attention_ragged_shapes_match_reference(b, hq, hkv, tq, tk, d, window):
    (jq, jk, jv), (q, k, v) = _both(_inputs(2, (b, hq, tq, d), (b, hkv, tk, d),
                                            (b, hkv, tk, d)))
    got = ops.attention(q, k, v, window=window, force="ref")
    _close(got, jref.attention_ref(jq, jk, jv, window=window), 2e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_decode_attention_matches_reference(window):
    b, hq, hkv, s, d, n = 2, 4, 2, 48, 32, 30
    (jq, jk, jv), (q, k, v) = _both(_inputs(3, (b, hq, 1, d), (b, hkv, s, d), (b, hkv, s, d)))
    got = ops.decode_attention(q, k, v, n, window=window)
    _close(got, jref.decode_attention_ref(jq, jk, jv, n, window=window), 2e-5)
    # one decode position == the last row of full attention over the prefix
    full = ops.attention(torch.cat([torch.zeros(b, hq, n - 1, d), q], 2), k[:, :, :n],
                         v[:, :, :n], window=window)
    _close(got[:, :, 0], full[:, :, -1], 2e-5)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,d", [(1, 64, 128), (2, 128, 256), (1, 8, 128), (3, 1, 64),
                                   (2, 13, 40)])
def test_rglru_matches_reference(b, t, d):
    arrays = _inputs(4, (b, t, d), (b, t, d), (b, t, d), (d,), (b, d))
    (jx, jig, jrg, ja, jh0), (x, ig, rg, a, h0) = _both(arrays)
    for th0, jh in ((None, None), (h0, jh0)):
        y, h = ops.rglru(x, ig, rg, a, th0)
        yr, hr = jref.rglru_ref(jx, jig, jrg, ja, jh)
        _close(y, yr, 2e-5)
        _close(h, hr, 2e-5)
    if t % 8 == 0 and d % 128 == 0:       # shapes the Pallas kernel takes
        yk, hk = jops.rglru(jx, jig, jrg, ja, force="kernel")
        y, h = ops.rglru(x, ig, rg, a)
        _close(y, yk, 2e-5)
        _close(h, hk, 2e-5)


def test_rglru_bf16_matches_reference():
    arrays = _inputs(5, (2, 32, 128), (2, 32, 128), (2, 32, 128), (128,))
    (jx, jig, jrg, _), (x, ig, rg, _) = _both(arrays, "bfloat16")
    ja, a = jnp.asarray(arrays[3]), torch.from_numpy(arrays[3])
    y, h = ops.rglru(x, ig, rg, a)
    yr, hr = jref.rglru_ref(jx, jig, jrg, ja)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(y, yr, 2e-2)
    _close(h, hr, 2e-5)


def test_rglru_state_chaining():
    """[0:T] in one call == [0:T/2] then [T/2:T] with the carried state."""
    (x, ig, rg, a) = _both(_inputs(6, *[(1, 64, 128)] * 3, (128,)))[1]
    y, h = ops.rglru(x, ig, rg, a)
    y1, h1 = ops.rglru(x[:, :29], ig[:, :29], rg[:, :29], a)
    y2, h2 = ops.rglru(x[:, 29:], ig[:, 29:], rg[:, 29:], a, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


# The chunked scan of csrc/rglru.cu, written out in plain PyTorch: each chunk
# but the last runs from h = 0 to its decay product and local end state, the
# entry states are carried in chunk order (h_in(k+1) = prod_k * h_in(k) +
# local_k), and every chunk re-runs from its entry state. Held to the JAX
# oracle in float32 at 2e-5: the carry re-associates the products of up to
# 64 decays and their sums, a few float32 roundings per chunk.
RGLRU_CHUNK = 64
DECAYS = ["random", "zero", "one", "mixed"]


def _rglru_chunked(x, ig, rg, a_param, h0, c=8.0, chunk=RGLRU_CHUNK):
    b, t, d = x.shape
    log_a = -c * torch.nn.functional.softplus(a_param) * torch.sigmoid(rg)
    a = torch.exp(log_a)
    u = torch.sqrt(-torch.expm1(2.0 * log_a)) * torch.sigmoid(ig) * x
    starts = list(range(0, t, chunk))
    entry = [h0]
    if len(starts) > 1:
        for t0 in starts[:-1]:
            h, prod = torch.zeros(b, d), torch.ones(b, d)
            for i in range(t0, t0 + chunk):
                h = a[:, i] * h + u[:, i]
                prod = prod * a[:, i]
            entry.append(prod * entry[-1] + h)
    ys, h = [], h0
    for t0, h in zip(starts, entry):
        for i in range(t0, min(t0 + chunk, t)):
            h = a[:, i] * h + u[:, i]
            ys.append(h)
    return (torch.stack(ys, 1) if ys else torch.zeros(b, 0, d)), h


def _rglru_decay_inputs(seed, b, t, d, decay):
    """a_t near 0 (a_param 10, rec_gate >= 10: a ~ 1e-35), near 1 (a_param
    -20: a ~ 1 - 2e-8, the state carried across every chunk), random, or
    the three side by side per channel."""
    x, ig, rg, a, h0 = _inputs(seed, (b, t, d), (b, t, d), (b, t, d), (d,), (b, d))
    zero, one = np.full(d, 10.0, np.float32), np.full(d, -20.0, np.float32)
    lane = np.arange(d) % 3
    if decay == "zero":
        a, rg = zero, np.abs(rg) + 10.0
    elif decay == "one":
        a = one
    elif decay == "mixed":
        a = np.where(lane == 0, zero, np.where(lane == 1, one, a)).astype(np.float32)
        rg = np.where(lane == 0, np.abs(rg) + 10.0, rg).astype(np.float32)
    return [np.ascontiguousarray(v, np.float32) for v in (x, ig, rg, a, h0)]


@pytest.mark.parametrize("t", [1, RGLRU_CHUNK - 1, RGLRU_CHUNK, RGLRU_CHUNK + 1, 200])
@pytest.mark.parametrize("decay", DECAYS)
def test_rglru_chunked_scan_matches_reference(t, decay):
    arrays = _rglru_decay_inputs(12, 2, t, 48, decay)
    (jx, jig, jrg, ja, jh0), (x, ig, rg, a, h0) = _both(arrays)
    y, h = _rglru_chunked(x, ig, rg, a, h0)
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    yr, hr = jref.rglru_ref(jx, jig, jrg, ja, jh0)
    _close(y, yr, 2e-5)
    _close(h, hr, 2e-5)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,t,dk,dv,chunk", [
    (1, 2, 64, 32, 32, 16),
    (2, 2, 128, 64, 64, 64),
    (1, 1, 96, 16, 64, 32),
    (2, 3, 1, 16, 16, 1),                # one decode step
    (1, 2, 21, 8, 12, 7),                # ragged T
])
def test_rwkv6_matches_reference(b, h, t, dk, dv, chunk):
    arrays = _inputs(7, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), (b, h, t, dk), (h, dk),
                     (b, h, dk, dv))
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _both(arrays)
    for ts0, js in ((None, None), (s0, js0)):
        y, s = ops.rwkv6(r, k, v, w, u, ts0)
        yr, sr = jref.rwkv6_ref(jr, jk, jv, jw, ju, js)
        _close(y, yr, 2e-5)
        _close(s, sr, 2e-5)
    yk, sk = jops.rwkv6(jr, jk, jv, jw, ju, chunk=chunk, force="kernel")
    y, s = ops.rwkv6(r, k, v, w, u)
    _close(y, yk, 5e-3)
    _close(s, sk, 5e-3)


def test_rwkv6_bf16_matches_reference():
    arrays = _inputs(8, (2, 2, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16),
                     (2, 16))
    (jr, jk, jv, _, _), (r, k, v, _, _) = _both(arrays, "bfloat16")
    jw, ju = jnp.asarray(arrays[3]), jnp.asarray(arrays[4])
    w, u = torch.from_numpy(arrays[3]), torch.from_numpy(arrays[4])
    y, s = ops.rwkv6(r, k, v, w, u)
    yr, sr = jref.rwkv6_ref(jr, jk, jv, jw, ju)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(y, yr, 2e-2)
    _close(s, sr, 2e-5)


def test_rwkv6_state_chaining():
    (r, k, v, w, u) = _both(_inputs(9, *[(1, 2, 64, 32)] * 4, (2, 32)))[1]
    y, s = ops.rwkv6(r, k, v, w, u)
    y1, s1 = ops.rwkv6(*(x[:, :, :40] for x in (r, k, v, w)), u)
    y2, s2 = ops.rwkv6(*(x[:, :, 40:] for x in (r, k, v, w)), u, s1)
    assert torch.equal(torch.cat([y1, y2], 2), y) and torch.equal(s2, s)


# The split of csrc/rwkv6.cu, written out in plain PyTorch: Dv cut into
# column groups that run alone; a column's readout r_t . S[:, j] as partial
# sums over 8-row slices of Dk, added in slice order; and the bonus a scalar
# per step and head, y_t[j] = readout + v_t[j] * (r_t . (u * k_t)). Held to
# the JAX oracle in float32 at 2e-5: the same products, summed in another
# order (slices, then the bonus added last).
def _rwkv6_column_groups(r, k, v, w, u, s0, cols, rows=8):
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    decay = torch.exp(-torch.exp(w))
    bonus = torch.einsum("bhti,hi,bhti->bht", r, u, k)
    y = torch.zeros(b, h, t, dv)
    s_out = torch.zeros(b, h, dk, dv)
    for j0 in range(0, dv, cols):
        cs = slice(j0, min(j0 + cols, dv))
        s = s0[..., cs].clone()
        for i in range(t):
            parts = [(r[:, :, i, sl, None] * s[:, :, sl]).sum(2)
                     for sl in (slice(i0, i0 + rows) for i0 in range(0, dk, rows))]
            readout = parts[0]
            for p in parts[1:]:
                readout = readout + p
            y[:, :, i, cs] = readout + v[:, :, i, cs] * bonus[:, :, i, None]
            s = decay[:, :, i, :, None] * s + k[:, :, i, :, None] * v[:, :, i, None, cs]
        s_out[..., cs] = s
    return y, s_out


def _rwkv6_decay_w(w, decay):
    """w = -8 (decay exp(-3.4e-4): the state barely fades), w = +4 (decay
    ~2e-24: gone in a step), the two alternating per channel, or random."""
    if decay == "random":
        return w
    if decay == "mixed":
        return np.broadcast_to(np.where(np.arange(w.shape[-1]) % 2 == 0, -8.0, 4.0),
                               w.shape).astype(np.float32)
    return np.full_like(w, float(decay))


@pytest.mark.parametrize("b,h,t,dk,dv,cols", [
    (1, 2, 21, 64, 64, 64),              # one group, RWKV6-7B's head
    (2, 2, 20, 64, 100, 64),             # two groups, the second ragged
    (1, 1, 17, 128, 64, 32),             # 16 slices, two groups
    (1, 2, 9, 12, 20, 64),               # a slice padded past Dk
    (2, 1, 1, 16, 16, 64),               # one decode step
])
@pytest.mark.parametrize("decay", ["random", "-8", "+4", "mixed"])
def test_rwkv6_column_groups_match_reference(b, h, t, dk, dv, cols, decay):
    arrays = _inputs(13, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), (b, h, t, dk), (h, dk),
                     (b, h, dk, dv))
    arrays[3] = _rwkv6_decay_w(arrays[3], decay)
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _both(arrays)
    y, s = _rwkv6_column_groups(r, k, v, w, u, s0, cols)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    yr, sr = jref.rwkv6_ref(jr, jk, jv, jw, ju, js0)
    _close(y, yr, 2e-5)
    _close(s, sr, 2e-5)


# The sub-chunk form of csrc/rwkv6.cu's rwkv6_chunked, written out in plain
# PyTorch: sub-chunks of 16 steps (the last padded with r = k = v = 0 and
# decay 1) carried through the state; every decay factor a product of
# per-step decays d = exp(-exp(w)), one factor at a time (exclusive prefix
# products for the readout rows, exclusive suffix products for the update's
# keys); the strictly lower triangle of scores split by levels h = 8, 4, 2,
# 1, a level's pairs (t in the upper, s in the lower half of one aligned
# block of 2h steps) one product of rows r_t * prod_{p<=u<t} d_u by columns
# k_s * prod_{s<u<p} d_u, p the upper half's first step; the bonus on the
# diagonal; and every product taken as the kernel takes it on the tensor
# cores, its float32 operands as bf16 pieces (each the operand less the
# pieces before it, rounded) and the terms of pieces a, b with a + b below
# the larger count, exact products summed in float32. PIECES: the pieces of
# (r~, S, k~, v, scores, levels 8-2, level 1) in the kernel's bf16 and
# float32 modes. Held, on the same seeded inputs, to the JAX oracle within
# 1e-4 of scale and to the JAX package's Pallas kernel at this file's 5e-3.
RWKV6_SUB = 16
PIECES = {"bfloat16": (2, 2, 3, 1, 2, 2, 1), "float32": (3, 3, 3, 3, 3, 3, 3)}


def _pieces(x, n):
    out = []
    for _ in range(n):
        out.append(_bf16(x))
        x = x - out[-1]
    return out


def _pieces_product(eq, a, b, na, nb):
    pa, pb, most = _pieces(a, na), _pieces(b, nb), max(na, nb)
    return sum(torch.einsum(eq, pa[i], pb[j]) for i in range(na) for j in range(nb)
               if i + j < most)


def _rwkv6_sub_chunks(r, k, v, w, u, s0, pieces):
    n_r, n_s, n_k, n_v, n_sc, n_lv, n_l1 = pieces
    b, h, t, dk = r.shape
    sub = RWKV6_SUB
    decay = torch.exp(-torch.exp(w))
    s = s0.clone()
    ys = []
    steps = torch.arange(sub)
    for t0 in range(0, t, sub):
        n = min(sub, t - t0)

        def chunk(x, fill):
            pad = torch.full(x.shape[:2] + (sub - n, x.shape[-1]), fill)
            return torch.cat([x[:, :, t0:t0 + n], pad], 2)

        rc, kc, vc, dc = chunk(r, 0.0), chunk(k, 0.0), chunk(v, 0.0), chunk(decay, 1.0)
        prefix, suffix = [torch.ones(b, h, dk)], [torch.ones(b, h, dk)]
        for i in range(sub):
            prefix.append(prefix[-1] * dc[:, :, i])
            suffix.insert(0, suffix[0] * dc[:, :, sub - 1 - i])
        r_dec = rc * torch.stack(prefix[:sub], 2)
        k_dec = kc * torch.stack(suffix[1:], 2)
        scores = torch.zeros(b, h, sub, sub)
        for hh in (8, 4, 2, 1):
            e, f = [None] * sub, [None] * sub
            for i in range(sub):            # prod_{p<=u<t} d_u, from p up
                e[i] = torch.ones(b, h, dk) if i % hh == 0 else e[i - 1] * dc[:, :, i - 1]
            for i in reversed(range(sub)):  # prod_{s<u<p} d_u, from p - 1 down
                f[i] = torch.ones(b, h, dk) if (i + 1) % hh == 0 else f[i + 1] * dc[:, :, i + 1]
            npc = n_l1 if hh == 1 else n_lv
            level = _pieces_product("bhti,bhsi->bhts", rc * torch.stack(e, 2),
                                    kc * torch.stack(f, 2), npc, npc)
            pairs = ((steps[:, None] // (2 * hh) == steps[None, :] // (2 * hh))
                     & (steps[:, None] & hh != 0) & (steps[None, :] & hh == 0))
            scores = torch.where(pairs, level, scores)
        bonus = torch.einsum("bhti,hi,bhti->bht", rc, u, kc)
        scores = scores + torch.diag_embed(bonus)
        y = (_pieces_product("bhsj,bhts->bhtj", vc, scores, n_v, n_sc)
             + _pieces_product("bhij,bhti->bhtj", s, r_dec, n_s, n_r))
        s = (prefix[sub][..., None] * s
             + _pieces_product("bhsj,bhsi->bhij", vc, k_dec, n_v, n_k))
        ys.append(y[:, :, :n])
    return torch.cat(ys, 2), s


def _rwkv6_decay_w_fast_slow(w):
    """w along T within each channel: 15 (decay exp(-exp(15)) = 0 in
    float32) at the steps where (step + channel) % 3 == 0, else -8 (the
    state barely fades): where the TPU kernel clamps its log decay, and a
    quotient of cumulative decay products would divide by 0."""
    steps = np.arange(w.shape[2])[:, None] + np.arange(w.shape[3])[None, :]
    return np.broadcast_to(np.where(steps % 3 == 0, 15.0, -8.0), w.shape).astype(np.float32)


@pytest.mark.parametrize("b,h,t,dk,dv,chunk,with_s0", [
    (1, 2, 40, 16, 24, 8, True),          # off the sub-chunk grid: 2 sub-chunks and 8 steps
    (2, 1, 32, 32, 16, 16, False),        # on the grid
    (1, 1, 16, 8, 8, 16, True),           # one sub-chunk, Dk padded to a tile in the kernel
])
@pytest.mark.parametrize("decay", ["random", "-8", "+4", "mixed", "fast_slow"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_rwkv6_sub_chunks_match_reference(b, h, t, dk, dv, chunk, with_s0, decay, mode):
    arrays = _inputs(15, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), (b, h, t, dk), (h, dk),
                     (b, h, dk, dv))
    if mode == "bfloat16":              # the kernel's bf16 inputs: r, k, v exact in bf16
        arrays[:3] = [_bf16(torch.from_numpy(a)).numpy() for a in arrays[:3]]
    arrays[3] = (_rwkv6_decay_w_fast_slow(arrays[3]) if decay == "fast_slow"
                 else _rwkv6_decay_w(arrays[3], decay))
    if not with_s0:
        arrays[5] = np.zeros_like(arrays[5])
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _both(arrays)
    y, s = _rwkv6_sub_chunks(r, k, v, w, u, s0, PIECES[mode])
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    yr, sr = jref.rwkv6_ref(jr, jk, jv, jw, ju, js0)
    for got, want in ((y, yr), (s, sr)):
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4 * scale, rtol=1e-4)
    yk, sk = jops.rwkv6(jr, jk, jv, jw, ju, js0, chunk=chunk, force="kernel")
    _close(y, yk, 5e-3)
    _close(s, sk, 5e-3)


# The decomposition of csrc/flash_attention.cu's flash_fwd_hopper, written
# out in plain PyTorch: 64-row query groups (one warpgroup each, in blocks
# of `block_rows`), K/V tiles of 128 keys at DMAX 128 and 64 otherwise, the
# online softmax with the per-tile rescale (scores raw and the scale in the
# exponent when there is no softcap), and P entering P V as bf16 P_hi + P_lo,
# the bf16 products exact in float32 and summed in float32. `own_tiles`:
# each group visits only the tiles its rows can see (the kernel); else every
# tile its block's rows can see, which must change no bit of a row (the
# kernel's batch invariance: how many rows a block holds decides which tiles
# it visits). Held to the JAX package's Pallas flash_attention (interpret
# mode) and to attention_ref at this file's bf16 tolerance, and in float32,
# before the output's bf16 rounding, within 1e-4 of attention_ref on the same
# bf16 values (P to about 16 bits: 2**-16 of each weight).
def _bf16(x):
    return x.to(torch.bfloat16).float()


def _flash_hopper_decomposition(q, k, v, *, causal, window, softcap, block_rows, own_tiles):
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dmax = 64 if d <= 64 else 128 if d <= 128 else 256
    bk = 128 if dmax == 128 else 64
    scale = d ** -0.5
    raw = softcap is None
    mult = scale * np.log2(np.e) if raw else np.log2(np.e)
    q, k, v = q.float(), k.float(), v.float()
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    offset = tk - tq
    out = torch.zeros(b, hq, tq, d)

    def key_range(lo_row, hi_row):      # keys rows lo_row..hi_row - 1 can see
        begin = max(0, lo_row + offset - window + 1) if window is not None else 0
        end = min(tk, hi_row - 1 + offset + 1) if causal else tk
        return begin, end

    for r0 in range(0, tq, 64):
        r1 = min(r0 + 64, tq)
        blk0 = r0 // block_rows * block_rows
        lo, hi = (r0, r1) if own_tiles else (blk0, min(blk0 + block_rows, tq))
        begin, end = key_range(lo, hi)
        pos = torch.arange(r0, r1) + offset
        m = torch.full((b, hq, r1 - r0), -torch.inf)
        l = torch.zeros(b, hq, r1 - r0)
        acc = torch.zeros(b, hq, r1 - r0, d)
        for k0 in range(begin // bk * bk, end if end > begin else 0, bk):
            kj = torch.arange(k0, min(k0 + bk, tk))
            s_ = q[:, :, r0:r1] @ k[:, :, kj].transpose(-1, -2)
            x = s_ if raw else s_ * scale
            if softcap is not None:
                x = softcap * torch.tanh(x / softcap)
            seen = torch.ones(r1 - r0, len(kj), dtype=torch.bool)
            if causal:
                seen &= kj[None] <= pos[:, None]
            if window is not None:
                seen &= pos[:, None] - kj[None] < window
            x = x.masked_fill(~seen, -torch.inf)
            m_new = torch.maximum(m, x.amax(-1))
            live = m_new > -torch.inf
            corr = torch.where(live, torch.exp2((m - m_new) * mult), torch.ones(()))
            mneg = torch.where(live, -m_new * mult, torch.zeros(()))
            p = torch.exp2(x * mult + mneg[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None]
            hi_p = _bf16(p)
            acc = acc + hi_p @ v[:, :, kj] + _bf16(p - hi_p) @ v[:, :, kj]
            m = m_new
        out[:, :, r0:r1] = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                                       torch.zeros(()))
    return out


@pytest.mark.parametrize("b,hq,hkv,t,d,causal,window,softcap", [
    (1, 2, 1, 256, 64, True, None, None),          # MQA, DMAX 64: 64-key tiles
    (2, 4, 2, 256, 128, True, 100, None),          # GQA, window, DMAX 128: 128-key tiles
    (1, 2, 2, 256, 72, False, None, 30.0),         # D padded to DMAX 128, softcap
    (1, 2, 1, 128, 256, True, None, None),         # DMAX 256: 64-key tiles
])
def test_flash_hopper_decomposition_matches_reference(b, hq, hkv, t, d, causal, window,
                                                      softcap):
    from repro.kernels.flash_attention import flash_attention as jflash

    arrays = [_bf16(torch.from_numpy(a)).numpy()
              for a in _inputs(14, (b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    (jq, jk, jv), (q, k, v) = _both(arrays, "bfloat16")
    kw = dict(causal=causal, window=window)
    got = _flash_hopper_decomposition(q, k, v, softcap=softcap, block_rows=64, own_tiles=True,
                                      **kw)
    # a 64-row group of a 128-row block, visiting the whole block's tiles
    assert torch.equal(got, _flash_hopper_decomposition(q, k, v, softcap=softcap,
                                                         block_rows=128, own_tiles=False, **kw))
    want32 = ops.attention(q.float(), k.float(), v.float(), logit_softcap=softcap, **kw)
    _close(got, want32, 1e-4)
    got16 = got.to(torch.bfloat16)
    _close(got16, jref.attention_ref(jq, jk, jv, logit_softcap=softcap, **kw), 2e-2)
    _close(got16, jflash(jq, jk, jv, logit_softcap=softcap, block_q=128, block_k=128,
                         interpret=True, **kw), 2e-2)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path_and_force_kernel_raises():
    from repro_torch.kernels import launch_counts, reset_launch_counts

    (q, k, v) = _both(_inputs(10, *[(1, 2, 16, 8)] * 3))[1]
    x, a = torch.from_numpy(_inputs(11, (1, 4, 8))[0]), torch.zeros(8)
    reset_launch_counts()
    ops.attention(q, k, v)
    ops.rglru(x, x, x, a)
    ops.rwkv6(q, q, q, q, q[0, :, 0])
    assert all(n == 0 for n in launch_counts().values())
    for call in (lambda: ops.attention(q, k, v, force="kernel"),
                 lambda: ops.rglru(x, x, x, a, force="kernel"),
                 lambda: ops.rwkv6(q, q, q, q, q[0, :, 0], force="kernel")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
