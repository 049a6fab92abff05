"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips where CUDA is absent.
The file imports only PyTorch and the port, so it also runs on a machine
without JAX (``--noconftest`` skips the JAX fixtures of ``conftest.py``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: histograms within ``atol=1e-4, rtol=1e-5`` of the plain path
(float sums in another order); split decisions tie-aware (the kernel's
candidate has a plain-path gain within ``GAIN_RTOL`` of the plain best);
integer-valued grad/hess bit-equal (every sum is exact); two launches
bit-identical. The LM kernels' tolerances are stated above their tests.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

GAIN_RTOL = 1e-4
LEVEL_GRID = [(200, 5, 16, 1), (500, 7, 64, 4), (400, 12, 256, 4), (300, 9, 16, 32),
              (600, 3, 64, 32), (250, 6, 256, 32), (1, 4, 8, 2), (3000, 28, 256, 16),
              (5000, 3, 256, 256),      # 256 nodes × 256 bins: many node tiles
              (1003, 28, 64, 8),        # R not a multiple of 32 or of a staged tile
              (20001, 8, 256, 64)]      # B=256 at 64 nodes: several node tiles
# bins a quantized real feature gives: 90 % of the rows in bin 0, or every
# row in one bin, where neighbouring rows most often share a cell
SKEW_GRID = [("skewed", 5003, 28, 64, 1), ("skewed", 4001, 7, 256, 8),
             ("one_bin", 3001, 12, 32, 4), ("one_bin", 1000, 5, 256, 1)]
HIST_GRID = [(100, 5, 8, 1), (500, 7, 16, 4), (1000, 3, 64, 8), (50, 19, 24, 3),
             (128, 13, 48, 5), (37, 9, 8, 2), (20000, 1, 1, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _fixture(seed, r, f, nb, nn, device, integer=False, skew=None):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(r, f)).astype(np.int32)
    if skew == "skewed":
        bins[rng.random((r, f)) < 0.9] = 0
    elif skew == "one_bin":
        bins[:] = nb // 2
    if integer:
        g = rng.integers(-8, 9, size=r).astype(np.float32)
        h = rng.integers(1, 5, size=r).astype(np.float32)
    else:
        g = rng.normal(size=r).astype(np.float32)
        h = (np.abs(rng.normal(size=r)) + 0.1).astype(np.float32)
    node = rng.integers(0, nn, size=r).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (bins, g, h, node)]


def _assert_tie_aware(plain_hist, got, kw):
    gains = ref.split_gains_ref(plain_hist, **kw)
    flat = gains.reshape(gains.shape[0], -1)
    best = flat.max(dim=1).values
    _, bg, bf, bs = got
    pick = flat[torch.arange(flat.shape[0], device=flat.device),
                bf.long() * kw["n_bins"] + bs.long()]
    finite = torch.isfinite(best)
    assert torch.equal(torch.isfinite(bg), finite)
    tol = GAIN_RTOL * best[finite].abs().clamp_min(1.0)
    assert bool(((best - pick)[finite].abs() <= tol).all())
    assert bool(((bf[~finite] == 0) & (bs[~finite] == 0)).all())


def _parent(t, nn, nb):
    return ops._histogram_scatter(t[0], t[1], t[2], t[3] // 2, nn // 2, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("r,f,nb,nn", LEVEL_GRID)
def test_cuda_level_split_vs_plain(cuda, r, f, nb, nn):
    t = _fixture(0, r, f, nb, nn, cuda)
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    plain = ops._histogram_scatter(*t, nn, nb)
    got = ops.level_split(*t, force="kernel", **kw)
    torch.testing.assert_close(got[0], plain, atol=1e-4, rtol=1e-5)
    _assert_tie_aware(plain, got, dict(lam=1.0, min_child_weight=1.0, n_bins=nb))
    again = ops.level_split(*t, force="kernel", **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    slim = ops.level_split(*t, force="kernel", return_hist=False, **kw)
    assert slim[0] is None and all(torch.equal(a, b) for a, b in zip(got[1:], slim[1:]))
    if nn > 1:
        sub = ops.level_split(*t, parent_hist=_parent(t, nn, nb), **kw)
        torch.testing.assert_close(sub[0], plain, atol=1e-4, rtol=1e-5)
        _assert_tie_aware(plain, sub, dict(lam=1.0, min_child_weight=1.0, n_bins=nb))


@pytest.mark.cuda
@pytest.mark.parametrize("r,f,nb,nn", [(600, 5, 32, 16), (5000, 3, 256, 256)])
def test_cuda_integer_stats_bit_equal(cuda, r, f, nb, nn):
    t = _fixture(1, r, f, nb, nn, cuda, integer=True)
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    plain = ops.level_split(*[x.cpu() for x in t], **kw)
    direct = ops.level_split(*t, **kw)
    sub = ops.level_split(*t, parent_hist=_parent(t, nn, nb), **kw)
    for got in (direct, sub):
        assert torch.equal(got[0].cpu(), plain[0])
        # exact sums, same IEEE gain formula: only the cumsum order differs,
        # and on integers it is exact too
        assert torch.equal(got[2].cpu(), plain[2]) and torch.equal(got[3].cpu(), plain[3])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,r,f,nb,nn", SKEW_GRID)
def test_cuda_level_split_skewed_bins(cuda, kind, r, f, nb, nn):
    t = _fixture(5, r, f, nb, nn, cuda, skew=kind)
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    plain = ops._histogram_scatter(*t, nn, nb)
    got = ops.level_split(*t, force="kernel", **kw)
    torch.testing.assert_close(got[0], plain, atol=1e-4, rtol=1e-5)
    _assert_tie_aware(plain, got, dict(lam=1.0, min_child_weight=1.0, n_bins=nb))
    assert all(torch.equal(a, b) for a, b in zip(got, ops.level_split(*t, force="kernel", **kw)))
    torch.testing.assert_close(ops.histogram(*t, n_nodes=nn, n_bins=nb), plain,
                               atol=1e-4, rtol=1e-5)
    if nn > 1:
        sub = ops.level_split(*t, parent_hist=_parent(t, nn, nb), **kw)
        torch.testing.assert_close(sub[0], plain, atol=1e-4, rtol=1e-5)
        _assert_tie_aware(plain, sub, dict(lam=1.0, min_child_weight=1.0, n_bins=nb))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,r,f,nb,nn", SKEW_GRID + [(None, 20001, 8, 256, 64)])
def test_cuda_integer_stats_bit_equal_skewed_and_tiled(cuda, kind, r, f, nb, nn):
    t = _fixture(6, r, f, nb, nn, cuda, integer=True, skew=kind)
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    plain = ops._histogram_scatter(*[x.cpu() for x in t], nn, nb)
    assert torch.equal(ops.histogram(*t, n_nodes=nn, n_bins=nb).cpu(), plain)
    assert torch.equal(ops.level_split(*t, **kw)[0].cpu(), plain)
    if nn > 1:
        sub = ops.level_split(*t, parent_hist=_parent(t, nn, nb), **kw)
        assert torch.equal(sub[0].cpu(), plain)


@pytest.mark.cuda
def test_cuda_masks_and_all_masked_nodes(cuda):
    t = _fixture(2, 4000, 10, 32, 8, cuda)
    mask = torch.arange(10, device=cuda) % 3 == 0
    kw = dict(n_nodes=8, n_bins=32, lam=0.5, min_child_weight=1.0, bin_limit=16)
    got = ops.level_split(*t, feat_mask=mask, **kw)
    plain = ops._histogram_scatter(*t, 8, 32)
    _assert_tie_aware(plain, got, dict(lam=0.5, min_child_weight=1.0, n_bins=32,
                                       bin_limit=16, feat_mask=mask))
    real = torch.isfinite(got[1])
    assert bool(mask[got[2][real].long()].all() and (got[3][real] < 15).all())
    none = ops.level_split(*t, feat_mask=torch.zeros(10, dtype=torch.bool, device=cuda), **kw)
    assert bool(torch.isneginf(none[1]).all() and (none[2] == 0).all() and (none[3] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("r,f,nb,nn", HIST_GRID)
def test_cuda_histogram_vs_plain(cuda, r, f, nb, nn):
    t = _fixture(3, r, f, nb, nn, cuda)
    got = ops.histogram(*t, n_nodes=nn, n_bins=nb)
    torch.testing.assert_close(got, ops._histogram_scatter(*t, nn, nb), atol=1e-4, rtol=1e-5)
    assert torch.equal(got, ops.histogram(*t, n_nodes=nn, n_bins=nb))


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_check_inputs(cuda):
    from repro_torch.kernels.histogram import launch_counts, reset_launch_counts

    t = _fixture(4, 100, 3, 8, 2, cuda)
    reset_launch_counts()
    ops.histogram(*t, n_nodes=2, n_bins=8)
    ops.level_split(*t, n_nodes=2, n_bins=8, lam=1.0, min_child_weight=1.0)
    assert launch_counts() == {"histogram": 1, "level_split": 1, "split_scan": 0}
    with pytest.raises(ValueError, match="int32"):
        ops.histogram(t[0].long(), *t[1:], n_nodes=2, n_bins=8)


# ---------------------------------------------------------------------------
# The fixed-point level kernel (csrc/histogram.cu): g/h rounded to one
# power-of-two grid a call, int64 sums, rows grouped by node. Integer sums
# commute, so any row order gives the same bits; non-finite values give the
# plain float sums' NaN and infinities.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("r,f,nb,nn", [(30000, 28, 64, 1), (20000, 7, 256, 8),
                                       (40000, 28, 32, 64)])
def test_cuda_level_split_row_permutation_invariant(cuda, r, f, nb, nn):
    """The same rows in another order: bit-equal histograms and equal
    decisions, direct and by subtraction, on real-valued g/h."""
    t = _fixture(70, r, f, nb, nn, cuda)
    perm = torch.from_numpy(np.random.default_rng(71).permutation(r)).to(cuda)
    s = [x[perm].contiguous() for x in t]
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    parents = [None] + ([_parent(t, nn, nb)] if nn > 1 else [])
    for ph in parents:
        a = ops.level_split(*t, parent_hist=ph, **kw)
        b = ops.level_split(*s, parent_hist=ph, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ops.histogram(*t, n_nodes=nn, n_bins=nb),
                       ops.histogram(*s, n_nodes=nn, n_bins=nb))


@pytest.mark.cuda
@pytest.mark.parametrize("nn", [1, 8, 64])
def test_cuda_level_split_nonfinite_stats(cuda, nn):
    """NaN, +inf and -inf in g and h (one cell meets both infinities) on
    integer g/h: the kernel's histogram is the plain path's, NaN for NaN and
    the same infinities, the rest bit-equal; the decisions are the plain
    scan's on it."""
    r, f, nb = 6000, 5, 16
    t = _fixture(72, r, f, nb, nn, cuda, integer=True)
    bins, g, h, node = t
    bins[:8] = 3
    node[:8] = 0
    g[0], g[1], g[2] = float("inf"), float("-inf"), float("nan")
    h[3] = float("inf")
    g[4] = float("inf")
    bins[4] = 5
    h[5], h[6] = float("-inf"), float("inf")
    bins[5:7] = 6
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    plain = ops.level_split(*[x.cpu() for x in t], **kw)
    assert bool(torch.isnan(plain[0]).any() and torch.isinf(plain[0]).any())
    for got in (ops.level_split(*t, **kw), [ops.histogram(*t, n_nodes=nn, n_bins=nb)]):
        torch.testing.assert_close(got[0].cpu(), plain[0], rtol=0, atol=0, equal_nan=True)
    got = ops.level_split(*t, **kw)
    want = ref.split_scan_ref(got[0].cpu(), lam=1.0, min_child_weight=1.0, n_bins=nb)
    assert torch.equal(got[2].cpu(), want[1]) and torch.equal(got[3].cpu(), want[2])
    if nn > 1:
        sub = ops.level_split(*t, parent_hist=_parent(t, nn, nb), **kw)
        want = ops.level_split(*[x.cpu() for x in t],
                               parent_hist=_parent([x.cpu() for x in t], nn, nb), **kw)
        torch.testing.assert_close(sub[0].cpu(), want[0], rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_cuda_histogram_grid_edges(cuda):
    """Tiny g keeps its relative precision (against float64 sums); past
    2**24 rows the row count sets the grid (R * max|g| near 2**62: 2**25
    rows of |g| < 2**35), and g on that grid sums exactly, rounded once."""
    t = _fixture(73, 50000, 4, 16, 4, cuda)
    tiny = t[1] * 1e-30
    got = ops.histogram(t[0], tiny, t[2], t[3], n_nodes=4, n_bins=16)
    flat = ((t[3].long()[:, None] * 4 + torch.arange(4, device=cuda)) * 16
            + t[0].long()).reshape(-1)
    want = torch.zeros(4 * 4 * 16, dtype=torch.float64, device=cuda).index_add_(
        0, flat, tiny.double()[:, None].expand(-1, 4).reshape(-1)).reshape(4, 4, 16)
    torch.testing.assert_close(got[..., 0].double(), want, rtol=1e-6, atol=0)
    r = 2 ** 25
    gen = torch.Generator(device=cuda).manual_seed(74)
    k = torch.randint(-(2 ** 15), 2 ** 15, (r,), generator=gen, device=cuda)
    bins = torch.randint(0, 2, (r, 1), generator=gen, device=cuda, dtype=torch.int32)
    node = torch.zeros(r, dtype=torch.int32, device=cuda)
    got = ops.histogram(bins, (k * 2.0 ** 20).float(), torch.ones(r, device=cuda), node,
                        n_nodes=1, n_bins=2)
    exact = torch.zeros(2, dtype=torch.int64, device=cuda).index_add_(0, bins[:, 0].long(), k)
    assert torch.equal(got[0, 0, :, 0], (exact.float() * 2.0 ** 20))
    assert torch.equal(got[0, 0, :, 1], torch.bincount(bins[:, 0].long(), minlength=2).float())


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("r,f,nb,nn", [(120000, 28, 256, 512), (50000, 1, 32, 16),
                                       (50000, 7, 64, 32), (40000, 28, 64, 4)])
def test_cuda_deep_levels_and_unaligned_rows(cuda, r, f, nb, nn, integer):
    """N = 512 at B = 256 and F = 1, 7, 28: direct and by subtraction
    against the plain path (bit-equal on integer g/h, within tolerance and
    tie-aware on real g/h), and the accumulated child forced either way
    (``small_is_left``) gives the same histogram on integer g/h."""
    from repro_torch.kernels.histogram import fused_level_split_cuda

    t = _fixture(75, r, f, nb, nn, cuda, integer=integer)
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    plain = ops._histogram_scatter(*t, nn, nb)
    parent = _parent(t, nn, nb)
    for got in (ops.level_split(*t, **kw), ops.level_split(*t, parent_hist=parent, **kw)):
        if integer:
            assert torch.equal(got[0], plain)
        else:
            torch.testing.assert_close(got[0], plain, atol=1e-4, rtol=1e-5)
            _assert_tie_aware(plain, got, dict(lam=1.0, min_child_weight=1.0, n_bins=nb))
    if integer:
        for left in (True, False):
            sil = torch.full((nn // 2,), left, dtype=torch.bool, device=cuda)
            forced = fused_level_split_cuda(*t, parent_hist=parent, small_is_left=sil, **kw)
            assert torch.equal(forced[0], plain)


@pytest.mark.cuda
@pytest.mark.parametrize("nn", [1, 64, 512])
def test_cuda_leaf_sums(cuda, nn):
    """The leaf sums (F = 1, B = 1) at N = 1, 64 and 512, with pad rows on
    node N: within tolerance of the plain path on real g/h, bit-equal on
    integer g/h, two launches bit-identical."""
    for integer in (False, True):
        t = _fixture(76 + nn, 100000, 1, 1, nn + 1, cuda, integer=integer)
        got = ops.histogram(*t, n_nodes=nn, n_bins=1)
        plain = ops._histogram_scatter(*t, nn, 1)
        if integer:
            assert torch.equal(got, plain)
        else:
            torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-5)
        assert torch.equal(got, ops.histogram(*t, n_nodes=nn, n_bins=1))


@pytest.mark.cuda
def test_cuda_level_launch_counts(cuda):
    """Two kernel launches where one tile holds the level (the root, the
    leaf sums), three where rows are grouped by node."""
    from repro_torch.kernels.histogram import level_launches

    assert level_launches(800000, 28, 64, 1) == 2
    assert level_launches(800000, 1, 1, 64) == 2
    assert level_launches(800000, 28, 64, 8) == 3
    assert level_launches(600000, 28, 256, 512, subtract=True) == 3


# ---------------------------------------------------------------------------
# LM kernels: flash attention, RG-LRU, RWKV-6
#
# Tolerances: float32 inputs within rtol 1e-4 (attention: atol 1e-5; the
# recurrences: atol 1e-4, sums of up to 64 terms in another order and
# expf/expm1f against PyTorch's); bf16 outputs within one bf16 ulp of the
# output's scale (2**-8 of max|out|, plus the same relative bound), since
# the kernel and the plain version each round a float32 result to bf16 once.
# ---------------------------------------------------------------------------

ATTN_GRID = [  # b, hq, hkv, tq, tk, d, causal, window, softcap
    (1, 2, 2, 128, 128, 64, True, None, None),
    (2, 4, 2, 100, 100, 64, True, None, None),      # GQA, ragged T
    (1, 4, 1, 77, 77, 256, True, 32, None),          # MQA, window, D=256
    (1, 2, 2, 65, 65, 32, False, None, None),        # bidirectional
    (2, 8, 2, 130, 130, 128, True, None, 50.0),      # softcap
    (2, 4, 2, 1, 64, 64, True, None, None),          # decode-style Tq=1
    (1, 2, 1, 40, 200, 16, True, 50, None),          # chunked prefill offset
    (1, 2, 2, 200, 40, 64, True, None, None),        # Tq > Tk: rows see no key
    (4, 16, 16, 1500, 1500, 64, False, None, None),  # whisper-medium's encoder
    (4, 16, 16, 384, 1500, 64, False, None, None),   # its cross-attention, Tq < Tk
    (2, 4, 4, 32, 24, 16, False, None, None),        # cross-attention, Tq > Tk
    (1, 14, 2, 256, 256, 64, True, None, None),      # InternVL2-1B, GQA group 7
    (1, 64, 4, 512, 512, 128, True, None, None),     # Qwen3-MoE, GQA group 16
]


def _lm(seed, *shapes, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
            for s in shapes]


def _bf16_close(got, want):
    tol = 2.0 ** -8 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=2.0 ** -8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window,cap", ATTN_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_vs_plain(cuda, b, hq, hkv, tq, tk, d, causal, window,
                                       cap, dtype):
    dt = getattr(torch, dtype)
    q, k, v = _lm(5, (b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d), device=cuda, dtype=dt)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    got = ops.attention(q, k, v, force="kernel", **kw)
    want = ref.attention_ref(q, k, v, **kw)
    assert got.dtype == dt and got.shape == q.shape
    dead = torch.isnan(want)            # rows that see no key: NaN in the oracle, 0 here
    assert bool((got[dead] == 0).all())
    got, want = got.masked_fill(dead, 0), want.masked_fill(dead, 0)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    else:
        _bf16_close(got, want)
    assert torch.equal(got, ops.attention(q, k, v, force="kernel", **kw).masked_fill(dead, 0))


def _bf16_row_close(got, want):
    """One bf16 ulp per row, as chip_smoke.py holds the serving shapes:
    |err| <= 2**-8 * (max |want| over the row + |want|)."""
    want = want.float()
    row_max = want.abs().amax(dim=-1, keepdim=True)
    err = (got.float() - want).abs()
    assert bool((err <= 2.0 ** -8 * (row_max + want.abs())).all()), float(err.max())


# the bf16 tensor-core kernel: every head_dim tile width, Tq from one query
# to several query tiles (Tq < Tk, queries at the last Tq positions), MQA and
# GQA, a window, a softcap and both
TC_VARIANTS = {"mqa_window": (4, 1, 33, None), "gqa_softcap": (8, 2, None, 30.0),
               "mqa_window_softcap": (4, 1, 200, 20.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(TC_VARIANTS))
@pytest.mark.parametrize("tq", [1, 15, 64, 1000])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_flash_attention_bf16_tensor_cores(cuda, d, tq, variant):
    hq, hkv, window, cap = TC_VARIANTS[variant]
    tk = tq + 29
    q, k, v = _lm(18, (2, hq, tq, d), (2, hkv, tk, d), (2, hkv, tk, d), device=cuda,
                  dtype=torch.bfloat16)
    kw = dict(causal=True, window=window, logit_softcap=cap)
    got = ops.attention(q, k, v, force="kernel", **kw)
    _bf16_row_close(got, ref.attention_ref(q, k, v, **kw))
    assert torch.equal(got, ops.attention(q, k, v, force="kernel", **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_flash_attention_bf16_rows_without_keys(cuda, d):
    q, k, v = _lm(19, (1, 4, 150, d), (1, 1, 40, d), (1, 1, 40, d), device=cuda,
                  dtype=torch.bfloat16)
    got = ops.attention(q, k, v, force="kernel")
    want = ref.attention_ref(q, k, v)
    dead = torch.isnan(want).all(dim=-1)     # the first 110 queries see no key
    assert int(dead[0, 0].sum()) == 110
    assert bool((got[dead] == 0).all())
    _bf16_row_close(got[~dead], want[~dead])
    assert torch.equal(got, ops.attention(q, k, v, force="kernel"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,with_h0", [(1, 64, 128, False), (2, 100, 96, True),
                                           (3, 1, 256, True), (2, 37, 33, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rglru_vs_plain(cuda, b, t, d, with_h0, dtype):
    dt = getattr(torch, dtype)
    x, ig, rg = _lm(6, (b, t, d), (b, t, d), (b, t, d), device=cuda, dtype=dt)
    a, h0 = _lm(7, (d,), (b, d), device=cuda)
    h0 = h0 if with_h0 else None
    y, h = ops.rglru(x, ig, rg, a, h0, force="kernel")
    y_r, h_r = ref.rglru_ref(x, ig, rg, a, h0)
    assert y.dtype == dt and h.dtype == torch.float32
    torch.testing.assert_close(h, h_r, atol=1e-4, rtol=1e-4)
    if dt == torch.float32:
        torch.testing.assert_close(y, y_r, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(y, y_r)
    y2, h2 = ops.rglru(x, ig, rg, a, h0, force="kernel")
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
def test_cuda_rglru_state_chaining(cuda):
    x, ig, rg = _lm(8, (2, 64, 128), (2, 64, 128), (2, 64, 128), device=cuda)
    (a,) = _lm(9, (128,), device=cuda)
    y, h = ops.rglru(x, ig, rg, a, force="kernel")
    y1, h1 = ops.rglru(x[:, :40], ig[:, :40], rg[:, :40], a, force="kernel")
    y2, h2 = ops.rglru(x[:, 40:], ig[:, 40:], rg[:, 40:], a, h1, force="kernel")
    # the same float32 steps in the same order: bit-equal
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,dk,dv,with_s0", [(1, 2, 64, 32, 32, False),
                                                 (2, 2, 100, 64, 64, True),
                                                 (1, 1, 96, 16, 64, False),
                                                 (2, 3, 1, 64, 64, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_vs_plain(cuda, b, h, t, dk, dv, with_s0, dtype):
    dt = getattr(torch, dtype)
    r, k, v = _lm(10, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), device=cuda, dtype=dt)
    w, u, s0 = _lm(11, (b, h, t, dk), (h, dk), (b, h, dk, dv), device=cuda)
    s0 = s0 if with_s0 else None
    y, s = ops.rwkv6(r, k, v, w, u, s0, force="kernel")
    y_r, s_r = ref.rwkv6_ref(r, k, v, w, u, s0)
    assert y.dtype == dt and s.dtype == torch.float32
    torch.testing.assert_close(s, s_r, atol=1e-4, rtol=1e-4)
    if dt == torch.float32:
        torch.testing.assert_close(y, y_r, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(y, y_r)
    y2, s2 = ops.rwkv6(r, k, v, w, u, s0, force="kernel")
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
def test_cuda_rwkv6_state_chaining(cuda):
    """A split on the chunked kernel's 16-step grid (at 32): the two calls
    run the same sub-chunks from the same states, so they give the bits of
    one call."""
    r, k, v, w = _lm(12, *[(1, 2, 64, 32)] * 4, device=cuda)
    (u,) = _lm(13, (2, 32), device=cuda)
    y, s = ops.rwkv6(r, k, v, w, u, force="kernel")
    y1, s1 = ops.rwkv6(*(x[:, :, :32] for x in (r, k, v, w)), u, force="kernel")
    y2, s2 = ops.rwkv6(*(x[:, :, 32:] for x in (r, k, v, w)), u, s1, force="kernel")
    assert torch.equal(torch.cat([y1, y2], 2), y) and torch.equal(s2, s)


# The edges of the recurrences' designs (csrc/rglru.cu, csrc/rwkv6.cu): RG-LRU
# from T = 65 on scans T in chunks of 64 steps in one launch, a block a
# (batch, 32 channels) chain (each chunk's decay product and local end state,
# the next chunk's entry state from them, a re-run of the chunk from its
# entry state), at T <= 64 step by step; RWKV-6 from T = 16 on runs sub-chunks of 16
# steps on the tensor cores (rwkv6_chunked: Dk <= 64, a block 64 columns of
# the state, so Dv past 64 in column groups), below that and at Dk > 64 or
# rows that are not 16-byte aligned it runs step by step (rwkv6_fwd: a
# thread 8 rows x 4 columns of the state, staged 16 steps at a time, Dv in
# column groups of 64 at Dk=64, 32 at Dk=128). Tolerances as above: the
# chunked scans form each chunk's entry state as prod(a) * h + local, and
# RWKV-6's sub-chunks take float32 operands into the tensor cores as bf16
# pieces, other float32 orders than the step-by-step oracle.
RGLRU_CHUNK, RWKV6_STAGE = 64, 16


def _rglru_held(x, ig, rg, a, h0, dt):
    y, h = ops.rglru(x, ig, rg, a, h0, force="kernel")
    y_r, h_r = ref.rglru_ref(x, ig, rg, a, h0)
    assert y.dtype == dt and bool(torch.isfinite(y.float()).all() and torch.isfinite(h).all())
    torch.testing.assert_close(h, h_r, atol=1e-4, rtol=1e-4)
    if dt == torch.float32:
        torch.testing.assert_close(y, y_r, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(y, y_r)
    y2, h2 = ops.rglru(x, ig, rg, a, h0, force="kernel")
    assert torch.equal(y, y2) and torch.equal(h, h2)
    return y, h


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, RGLRU_CHUNK - 1, RGLRU_CHUNK, RGLRU_CHUNK + 1,
                               2 * RGLRU_CHUNK - 1, 2 * RGLRU_CHUNK, 2 * RGLRU_CHUNK + 1, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 33])
def test_cuda_rglru_chunk_edges(cuda, t, dtype, d):
    """d=160: two 128-channel tiles of rglru_fwd (T <= 64), the second
    ragged, and five 32-channel chains of rglru_chain; d=33: one ragged
    tile, and two chains, the second of one channel."""
    dt = getattr(torch, dtype)
    b = 2
    x, ig, rg = _lm(20, (b, t, d), (b, t, d), (b, t, d), device=cuda, dtype=dt)
    a, h0 = _lm(21, (d,), (b, d), device=cuda)
    for init in (None, h0):
        _rglru_held(x, ig, rg, a, init, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["zero", "one", "mixed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rglru_extreme_decays(cuda, decay, dtype):
    """a_t near 0 (softplus(10) * sigmoid(10) * 8 ~ 80: a ~ 1e-35) and near 1
    (softplus(-20) ~ 2e-9: a ~ 1 - 2e-8, the state carried across every
    chunk), and both side by side per channel."""
    dt = getattr(torch, dtype)
    b, t, d = 2, 3 * RGLRU_CHUNK + 17, 256
    x, ig, rg = _lm(22, (b, t, d), (b, t, d), (b, t, d), device=cuda)
    a, h0 = _lm(23, (d,), (b, d), device=cuda)
    zero = torch.full((d,), 10.0, device=cuda)
    one = torch.full((d,), -20.0, device=cuda)
    if decay == "zero":
        a, rg = zero, rg.abs() + 10.0
    elif decay == "one":
        a = one
    else:
        a = torch.where(torch.arange(d, device=cuda) % 3 == 0, zero,
                        torch.where(torch.arange(d, device=cuda) % 3 == 1, one, a))
        rg = torch.where(torch.arange(d, device=cuda) % 3 == 0, rg.abs() + 10.0, rg)
    _rglru_held(x.to(dt), ig.to(dt), rg.to(dt), a, h0, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [37, 100, RGLRU_CHUNK])
def test_cuda_rglru_state_across_a_split(cuda, split):
    """A state carried from one call to the next, the split on or off a
    chunk boundary: both calls within tolerance of the plain version of the
    whole sequence (the chunks then start elsewhere, so not bit-equal)."""
    b, t, d = 2, 300, 128
    x, ig, rg = _lm(24, (b, t, d), (b, t, d), (b, t, d), device=cuda)
    a, h0 = _lm(25, (d,), (b, d), device=cuda)
    y1, h1 = ops.rglru(x[:, :split], ig[:, :split], rg[:, :split], a, h0, force="kernel")
    y2, h2 = ops.rglru(x[:, split:], ig[:, split:], rg[:, split:], a, h1, force="kernel")
    y_r, h_r = ref.rglru_ref(x, ig, rg, a, h0)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h2, h_r, atol=1e-4, rtol=1e-4)


def _rwkv6_held(r, k, v, w, u, s0, dt):
    y, s = ops.rwkv6(r, k, v, w, u, s0, force="kernel")
    y_r, s_r = ref.rwkv6_ref(r, k, v, w, u, s0)
    assert y.dtype == dt and bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
    torch.testing.assert_close(s, s_r, atol=1e-4, rtol=1e-4)
    if dt == torch.float32:
        torch.testing.assert_close(y, y_r, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(y, y_r)
    y2, s2 = ops.rwkv6(r, k, v, w, u, s0, force="kernel")
    assert torch.equal(y, y2) and torch.equal(s, s2)
    return y, s


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, RWKV6_STAGE - 1, RWKV6_STAGE, RWKV6_STAGE + 1,
                               2 * RWKV6_STAGE - 1, 2 * RWKV6_STAGE + 1, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_staging_edges(cuda, t, dtype):
    dt = getattr(torch, dtype)
    b, h, dk, dv = 2, 2, 64, 64
    r, k, v = _lm(26, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), device=cuda, dtype=dt)
    w, u, s0 = _lm(27, (b, h, t, dk), (h, dk), (b, h, dk, dv), device=cuda)
    for init in (None, s0):
        _rwkv6_held(r, k, v, w, u, init, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["-8", "+4", "mixed", "fast_slow"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_extreme_decays(cuda, decay, dtype):
    """w = -8 (decay exp(-3.4e-4): the state barely fades over the run), w =
    +4 (decay exp(-54.6) ~ 2e-24: gone in a step), the two per channel, and
    fast and slow steps along T within a channel (w = 15, where the decay
    underflows to 0, at every third step and 5 steps in 16, else -8): the
    case the TPU kernel clamps its log decay for, where a quotient of
    cumulative decay products would divide by 0."""
    dt = getattr(torch, dtype)
    b, h, t, dk, dv = 2, 2, 3 * RWKV6_STAGE + 5, 64, 64
    r, k, v = _lm(28, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), device=cuda, dtype=dt)
    u, s0 = _lm(29, (h, dk), (b, h, dk, dv), device=cuda)
    if decay == "mixed":
        w = torch.where(torch.arange(dk, device=cuda) % 2 == 0, -8.0, 4.0).expand(b, h, t, dk)
    elif decay == "fast_slow":
        w = torch.from_numpy(_rwkv6_fast_slow_w(b, h, t, dk)).to(cuda)
    else:
        w = torch.full((b, h, t, dk), float(decay), device=cuda)
    _rwkv6_held(r, k, v, w.contiguous(), u, s0, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv", [(64, 64), (64, 48), (64, 100), (64, 160), (128, 64),
                                   (16, 12), (32, 200), (12, 20), (8, 64), (256, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_column_groups(cuda, dk, dv, dtype):
    """One column group (Dv=64 at Dk=64) and several (Dv=100 and 160 at
    Dk=64, Dv=64 at Dk=128, 200 at Dk=32, 40 at Dk=256), groups that Dv
    does not fill (48, 100, 12, 20, 200, 40), every lanes-per-column count
    (Dk=8: 1, 12 and 16: 2, 32: 4, 64: 8, 128: 16, 256: 32) with row slices
    padded past Dk (12), and rows that are not 16-byte aligned (Dk=12),
    which load without cp.async."""
    dt = getattr(torch, dtype)
    b, h, t = 2, 3, 37
    r, k, v = _lm(30, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), device=cuda, dtype=dt)
    w, u, s0 = _lm(31, (b, h, t, dk), (h, dk), (b, h, dk, dv), device=cuda)
    _rwkv6_held(r, k, v, w, u, s0, dt)


@pytest.mark.cuda
def test_cuda_rwkv6_state_across_a_split_off_the_staging(cuda):
    """A state carried across a split at 37, off the chunked kernel's
    16-step grid: the second call's sub-chunks start elsewhere than one
    call's, so its sums run in another order (as the TPU kernel's chunks
    would); both calls are held to the plain version of the whole sequence
    at this file's tolerances, and a split at 32 gives the bits of one call."""
    b, h, t, dk, dv = 1, 4, 80, 64, 64
    r, k, v = _lm(32, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), device=cuda,
                  dtype=torch.bfloat16)
    w, u = _lm(33, (b, h, t, dk), (h, dk), device=cuda)
    y, s = _rwkv6_held(r, k, v, w, u, None, torch.bfloat16)
    y_r, s_r = ref.rwkv6_ref(r, k, v, w, u)
    y1, s1 = ops.rwkv6(*(x[:, :, :37] for x in (r, k, v, w)), u, force="kernel")
    y2, s2 = ops.rwkv6(*(x[:, :, 37:] for x in (r, k, v, w)), u, s1, force="kernel")
    _bf16_close(torch.cat([y1, y2], 2), y_r)
    torch.testing.assert_close(s2, s_r, atol=1e-4, rtol=1e-4)
    y1, s1 = ops.rwkv6(*(x[:, :, :32] for x in (r, k, v, w)), u, force="kernel")
    y2, s2 = ops.rwkv6(*(x[:, :, 32:] for x in (r, k, v, w)), u, s1, force="kernel")
    assert torch.equal(torch.cat([y1, y2], 2), y) and torch.equal(s2, s)


def _rwkv6_fast_slow_w(b, h, t, dk):
    """w along T within each channel: 15 (decay exp(-exp(15)) = 0 in
    float32) at the steps where (step + channel) % 3 == 0, else -8."""
    steps = np.arange(t)[:, None] + np.arange(dk)[None, :]
    w = np.where(steps % 3 == 0, 15.0, -8.0).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(w, (b, h, t, dk)))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [RWKV6_STAGE - 1, RWKV6_STAGE, RWKV6_STAGE + 1,
                               2 * RWKV6_STAGE + 1, 300])
@pytest.mark.parametrize("dk,dv", [(64, 64), (16, 48), (32, 160)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_sub_chunk_edges(cuda, t, dk, dv, dtype):
    """T around one and two sub-chunks and a ragged 300 (18 sub-chunks and
    12 steps), with and without s0: 15 steps run the step kernel, the rest
    the chunked one; Dk 16 and 32 (one and two 16-channel tiles) and Dv 48
    and 160 (a group Dv does not fill; three groups, the last ragged)."""
    from repro_torch.kernels.rwkv6 import chunked_form

    dt = getattr(torch, dtype)
    b, h = 2, 3
    r, k, v = _lm(34, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), device=cuda, dtype=dt)
    w, u, s0 = _lm(35, (b, h, t, dk), (h, dk), (b, h, dk, dv), device=cuda)
    assert chunked_form(t, dk, dv, r.element_size(), 0) == (t >= RWKV6_STAGE)
    for init in (None, s0):
        _rwkv6_held(r, k, v, w, u, init, dt)


@pytest.mark.cuda
def test_cuda_rglru_more_chunks_than_the_card_holds(cuda):
    """B=8, T=8192, D=4096: 1,024 chains of 128 chunks in one launch, more
    blocks than the card holds at once (four an SM): a block walks its
    chain alone and waits on no other block, so the later ones start as
    the first finish."""
    b, t, d = 8, 8192, 4096
    gen = torch.Generator(device=cuda).manual_seed(36)
    x, ig, rg = (torch.randn((b, t, d), generator=gen, device=cuda).bfloat16()
                 for _ in range(3))
    a = torch.randn(d, generator=gen, device=cuda)
    h0 = torch.randn((b, d), generator=gen, device=cuda)
    y, h = ops.rglru(x, ig, rg, a, h0, force="kernel")
    y_r, h_r = ref.rglru_ref(x, ig, rg, a, h0)
    _bf16_close(y, y_r)
    torch.testing.assert_close(h, h_r, atol=1e-4, rtol=1e-4)
    y2, h2 = ops.rglru(x, ig, rg, a, h0, force="kernel")
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,t", [("rglru", 300), ("rglru", 1), ("rwkv6", 100),
                                      ("rwkv6", 1)])
def test_cuda_recurrences_replayed_in_a_cuda_graph(cuda, kernel, t):
    """Each recurrence captured in a CUDA graph and replayed twice: both
    replays bit-equal to each other and to an eager call."""
    if kernel == "rglru":
        from repro_torch.kernels.rglru import rglru_cuda as fn

        x, ig, rg = _lm(37, (2, t, 160), (2, t, 160), (2, t, 160), device=cuda,
                        dtype=torch.bfloat16)
        a, h0 = _lm(38, (160,), (2, 160), device=cuda)
        args = (x, ig, rg, a, h0)
    else:
        from repro_torch.kernels.rwkv6 import rwkv6_cuda as fn

        r, k, v = _lm(39, *[(2, 3, t, 64)] * 3, device=cuda, dtype=torch.bfloat16)
        w, u, s0 = _lm(40, (2, 3, t, 64), (3, 64), (2, 3, 64, 64), device=cuda)
        args = (r, k, v, w, u, s0)
    eager = fn(*args)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(tuple(o.clone() for o in out))
    for got in replays:
        assert all(torch.equal(p, q) for p, q in zip(got, eager))


@pytest.mark.cuda
def test_cuda_lm_wrappers_count_launches_and_check_inputs(cuda):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru import rglru_cuda

    q, k = _lm(14, (1, 2, 8, 16), (1, 1, 8, 16), device=cuda)
    x, a = _lm(15, (1, 4, 8), (8,), device=cuda)
    reset_launch_counts()
    ops.attention(q, k, k)
    ops.rglru(x, x, x, a)
    ops.rwkv6(q, q, q, q, q[0, :, 0])
    ops.decode_attention(q[:, :, :1], k, k, 8)     # plain PyTorch: no kernel
    assert launch_counts() == {"flash_attention": 1, "histogram": 0, "level_split": 0,
                               "split_scan": 0, "rglru": 1, "rwkv6": 1}
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="float32"):
        rglru_cuda(x, x, x, a.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q, *_lm(16, (1, 3, 8, 16), (1, 3, 8, 16), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "rwkv6_7b"])
def test_cuda_lm_path_matches_plain_path(cuda, arch):
    """The smoke configs in float32 on the card: prefill and decode logits
    through the kernels within 1e-4 of the plain path (float32 sums in
    another order), and the same greedy tokens from both serves."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, init_decode_state, init_params, prefill
    from repro_torch.serve import Request, ServeEngine

    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(17).integers(0, cfg.vocab, (3, 21)))
    states = [init_decode_state(cfg, 3, 32, torch.float32, cuda) for _ in range(2)]
    reset_launch_counts()
    logits = [prefill(cfg, params, st, {"tokens": toks}, force=f)[0]
              for st, f in zip(states, (None, "ref"))]
    assert sum(launch_counts().values()) > 0
    torch.testing.assert_close(logits[0], logits[1], atol=1e-4, rtol=1e-4)
    for pos in range(21, 25):
        nxt = torch.argmax(logits[1], -1)[:, None]
        logits = [decode_step(cfg, params, st, nxt, pos, force=f)[0]
                  for st, f in zip(states, (None, "ref"))]
        torch.testing.assert_close(logits[0], logits[1], atol=1e-4, rtol=1e-4)
    waves = [[Request(i, toks[i, : 21 - 5 * i].numpy(), max_new_tokens=6) for i in range(3)]
             for _ in range(2)]
    outs = [ServeEngine(cfg, params, batch_size=4, max_len=32, cache_dtype=torch.float32,
                        force=f).serve(w) for w, f in zip(waves, (None, "ref"))]
    assert [r.output for r in outs[0]] == [r.output for r in outs[1]]


# ---------------------------------------------------------------------------
# The forest on the card. Its statistics are integers (g = -y*w, h = w with
# Poisson bootstrap weights), so every histogram sum is exact: the kernel
# path and the plain path grow bit-identical trees.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("r,nn", [(20000, 1), (30000, 64), (60000, 512)])
def test_cuda_forest_level_mask_and_poisson_stats_bit_equal(cuda, r, nn):
    """A forest level at B = 256: 5 of 28 features unmasked, Poisson integer
    hessians, direct and subtraction; histograms and decisions equal to the
    plain path's on the CPU."""
    rng = np.random.default_rng(nn)
    f, nb = 28, 256
    bins = rng.integers(0, nb, size=(r, f)).astype(np.int32)
    w = rng.poisson(1.0, size=r).astype(np.float32)
    y = rng.integers(0, 2, size=r).astype(np.float32)
    node = rng.integers(0, nn, size=r).astype(np.int32)
    mask = np.zeros(f, bool)
    mask[rng.permutation(f)[:5]] = True
    host = [torch.from_numpy(a) for a in (bins, -y * w, w, node)]
    t = [a.to(cuda) for a in host]
    kw = dict(n_nodes=nn, n_bins=nb, lam=1e-6, min_child_weight=1.0)
    plain = ops.level_split(*host, feat_mask=torch.from_numpy(mask), **kw)
    got = [ops.level_split(*t, feat_mask=torch.from_numpy(mask).to(cuda), **kw)]
    if nn > 1:
        got.append(ops.level_split(*t, feat_mask=torch.from_numpy(mask).to(cuda),
                                   parent_hist=_parent(t, nn, nb), **kw))
    for g in got:
        assert torch.equal(g[0].cpu(), plain[0])
        assert torch.equal(g[2].cpu(), plain[2]) and torch.equal(g[3].cpu(), plain[3])
        real = torch.isfinite(g[1]).cpu()
        assert bool(torch.from_numpy(mask)[g[2].cpu()[real].long()].all())


@pytest.mark.cuda
def test_cuda_forest_kernel_path_equals_plain_path_at_depth_10(cuda):
    """Whole forests at depth 10 on 256 bins: the kernel path and the plain
    paths (``force="ref"``, the oracle, and ``force="plain"``, the scatter)
    on the card grow the same trees, bit for bit, and two kernel runs and a
    resume 2 + 2 do too."""
    from repro_torch.core import convert, get_estimator
    from repro_torch.data.synthetic import make_higgs_like

    import repro_torch.tabular  # noqa: F401  (registers the forest)

    data = convert(make_higgs_like(30000, seed=3), "quantized_bins", device=cuda)
    assert int(data["n_bins"]) == 256
    est = get_estimator("forest")
    params = {"n_estimators": 4, "max_depth": 10, "seed": 5}
    kern = est.train(data, params)
    again = est.train(data, params)
    plain = est.train(data, params, force="ref")
    scatter = est.train(data, params, force="plain")
    _, half = est.train_resumable(data, params, budget=2)
    resumed, _ = est.train_resumable(data, params, budget=4, state=half)
    for other in (again, plain, scatter, resumed):
        for k in ("feat", "thresh", "leaves"):
            np.testing.assert_array_equal(getattr(kern, k), getattr(other, k))
    assert kern.feat.shape == (4, 1023) and np.isfinite(kern.leaves).all()


@pytest.mark.cuda
def test_cuda_level_split_from_threads_at_other_shapes(cuda):
    """Executor threads share the card and launch the level kernel at other
    shapes at once (a forest at B = 256 beside a GBDT at B = 32): every
    launch succeeds and gives what it gives alone."""
    import sys
    import threading

    shapes = [(32, 8), (256, 64), (64, 1), (256, 512)]
    cases = [_fixture(40 + i, 30000, 28, nb, nn, cuda, integer=True)
             for i, (nb, nn) in enumerate(shapes)]
    alone = [ops.level_split(*t, n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
             for t, (nb, nn) in zip(cases, shapes)]
    errors, bad = [], []

    def worker(k):
        try:
            t, (nb, nn) = cases[k % 4], shapes[k % 4]
            for _ in range(40):
                got = ops.level_split(*t, n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
                if not all(torch.equal(a, b) for a, b in zip(got, alone[k % 4])):
                    bad.append(k)
        except Exception as exc:        # recorded, asserted below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:3]
    assert not bad


# ---------------------------------------------------------------------------
# The row-sharded level (DESIGN.md §3.9): the shards' partial histograms
# from one histogram launch, summed in shard order, scanned by the level
# kernel's split scan alone (split_scan_cuda).
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes,f,nb", [(1, 28, 64), (8, 5, 256), (64, 28, 32), (3, 1, 1)])
def test_cuda_split_scan_vs_plain(cuda, n_nodes, f, nb):
    """The split scan on a histogram the caller built: the plain scan's
    decisions (tie-aware; only the cumsum order differs), masks and
    bin_limit honoured, counted, and two launches bit-identical."""
    from repro_torch.kernels.histogram import launch_counts, split_scan_cuda

    t = _fixture(50, 4000, f, nb, n_nodes, cuda)
    hist = ops._histogram_scatter(*t, n_nodes, nb)
    kw = dict(lam=1.0, min_child_weight=1.0, n_bins=nb)
    before = launch_counts()["split_scan"]
    got = split_scan_cuda(hist, lam=1.0, min_child_weight=1.0)
    assert launch_counts()["split_scan"] == before + 1
    _assert_tie_aware(hist, (None, *got), kw)
    again = split_scan_cuda(hist, lam=1.0, min_child_weight=1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the fused level kernel's scan on the same histogram: the same pass
    fused = ops.level_split(*t, n_nodes=n_nodes, n_bins=nb, lam=1.0, min_child_weight=1.0)
    mine = split_scan_cuda(fused[0], lam=1.0, min_child_weight=1.0)
    assert all(torch.equal(a, b) for a, b in zip(mine, fused[1:]))
    mask = torch.arange(f, device=cuda) % 2 == 0
    masked = split_scan_cuda(hist, lam=1.0, min_child_weight=1.0, feat_mask=mask,
                             bin_limit=max(1, nb // 2))
    _assert_tie_aware(hist, (None, *masked),
                      dict(kw, feat_mask=mask, bin_limit=max(1, nb // 2)))
    with pytest.raises(ValueError, match="n_nodes, F, B, 2"):
        split_scan_cuda(hist[..., :1], lam=1.0, min_child_weight=1.0)


def _shard_blocks(t, n_shards):
    """Rows (R, ·) as zero-padded (S, ceil(R/S), ·) blocks and their mask."""
    from repro_torch.core.data_format import shard_payload

    sh = shard_payload(dict(zip(("bins", "g", "h", "node"), t)), n_shards)
    return [sh[k] for k in ("bins", "g", "h", "node", "_shard_valid")]


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("r,f,nb,nn", [(30001, 28, 64, 8), (20000, 7, 256, 64)])
def test_cuda_sharded_level_vs_unsharded(cuda, n_shards, r, f, nb, nn):
    """The sharded level on the card against the unsharded one, direct and
    by subtraction: histograms within float tolerance and decisions
    tie-aware on real g/h; bit-identical histograms and decisions on
    integer g/h; every launch counted; two runs bit-identical."""
    from repro_torch.compat import sharded_call
    from repro_torch.kernels.histogram import launch_counts

    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    for integer in (False, True):
        t = _fixture(60 + n_shards, r, f, nb, nn, cuda, integer=integer)
        parent = _parent(t, nn, nb)
        blocks = _shard_blocks(t, n_shards)
        for ph in (None, parent):
            base = ops.level_split(*t, parent_hist=ph, **kw)
            before = launch_counts()
            run = sharded_call(
                lambda axis, b, g, h, node, valid: ops.level_split(
                    b, g, h, node, axis_name=axis, row_valid=valid, parent_hist=ph, **kw),
                n_shards=n_shards)
            got = run(*blocks)
            after = launch_counts()
            assert after["histogram"] == before["histogram"] + 1
            assert after["split_scan"] == before["split_scan"] + 1
            assert after["level_split"] == before["level_split"]
            assert all(torch.equal(a, b) for a, b in zip(got, run(*blocks)))
            if integer:
                assert all(torch.equal(a, b) for a, b in zip(got, base))
            else:
                torch.testing.assert_close(got[0], base[0], atol=1e-4, rtol=1e-5)
                _assert_tie_aware(base[0], got,
                                  dict(lam=1.0, min_child_weight=1.0, n_bins=nb))


@pytest.mark.cuda
def test_cuda_sharded_gbdt_and_forest_match_unsharded(cuda):
    """Whole sharded fits on the card: the forest's trees (integer sums)
    equal the unsharded ones bit for bit, the GBDT's decisions match on
    this data and its leaves agree to float rounding."""
    import repro_torch.tabular  # noqa: F401  (registers the estimators)
    from repro_torch.core import convert, get_estimator
    from repro_torch.core.data_format import shard_payload
    from repro_torch.data.synthetic import make_higgs_like

    data = convert(make_higgs_like(20000, seed=4), "quantized_bins", max_bins=64,
                   device=cuda)
    forest = get_estimator("forest")
    fp = {"n_estimators": 3, "max_depth": 6, "seed": 2}
    base = forest.train(data, fp)
    for n in (2, 4):
        got = forest.train(shard_payload(data, n), fp)
        for k in ("feat", "thresh", "leaves"):
            np.testing.assert_array_equal(getattr(got, k), getattr(base, k))
    gbdt = get_estimator("gbdt")
    gp = {"round": 3, "max_depth": 4, "max_bin": 64}
    base = gbdt.train(data, gp)
    got = gbdt.train(shard_payload(data, 4), gp)
    np.testing.assert_array_equal(got.feat, base.feat)
    np.testing.assert_array_equal(got.thresh, base.thresh)
    np.testing.assert_allclose(got.leaves, base.leaves, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# RWKV-6 launched from several threads at other (Dk, Dv) and staging modes:
# each launch opts the kernel into the device's whole shared memory, so no
# thread can lower the limit another thread's launch needs.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_rwkv6_from_threads_at_other_shapes(cuda):
    """8 threads launch RWKV-6 at once at (Dk, Dv) whose launches need other
    shared memory, with and without the cp.async staging (Dk=12 rows are
    not 16-byte aligned): every launch succeeds and gives what it gives
    alone."""
    import sys
    import threading

    shapes = [(64, 64, "bfloat16"), (128, 64, "float32"), (12, 20, "float32"),
              (32, 200, "bfloat16"), (256, 40, "float32")]
    cases = []
    for j, (dk, dv, dtype) in enumerate(shapes):
        b, h, t = 2, 2, 70
        r, k, v = _lm(70 + j, (b, h, t, dk), (b, h, t, dk), (b, h, t, dv), device=cuda,
                      dtype=getattr(torch, dtype))
        w, u = _lm(80 + j, (b, h, t, dk), (h, dk), device=cuda)
        cases.append((r, k, v, w, u))
    alone = [ops.rwkv6(*c, force="kernel") for c in cases]
    errors, bad = [], []

    def worker(j):
        try:
            c = cases[j % len(cases)]
            for _ in range(30):
                got = ops.rwkv6(*c, force="kernel")
                if not all(torch.equal(a, b) for a, b in zip(got, alone[j % len(cases)])):
                    bad.append(j)
        except Exception as exc:        # recorded, asserted below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(j,)) for j in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:3]
    assert not bad


# ---------------------------------------------------------------------------
# The port's draws are made on a CPU generator and moved: the same bits on
# the card as on the CPU, and an MLP rung trained on the card resumes on
# the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_draws_are_the_cpu_draws(cuda):
    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.tabular.draws import MLPDraws, forest_tree_draws

    for t in (0, 7):
        wc, pc = forest_tree_draws(11, t, 5000, 28, "cpu")
        wg, pg = forest_tree_draws(11, t, 5000, 28, cuda)
        assert wg.is_cuda and torch.equal(wg.cpu(), wc) and torch.equal(pg.cpu(), pc)
    a, b = MLPDraws(5, "cpu"), MLPDraws(5, cuda)
    for (wa, ba), (wb, bb) in zip(a.init((28, 64, 1)), b.init((28, 64, 1))):
        assert wb.is_cuda and torch.equal(wb.cpu(), wa) and torch.equal(bb.cpu(), ba)
    for i in range(3):
        assert torch.equal(b.batch(i, 1000, 32).cpu(), a.batch(i, 1000, 32))
    assert np.array_equal(a.state(), b.state())
    cfg = configs.get_smoke_config("rwkv6-7b")
    pc, pg = init_params(cfg, seed=3, device="cpu"), init_params(cfg, seed=3, device=cuda)
    sc, sg = pc.state_dict(), pg.state_dict()
    assert sc.keys() == sg.keys()
    for k in sc:
        assert sg[k].is_cuda and torch.equal(sg[k].cpu(), sc[k]), k


@pytest.mark.cuda
def test_cuda_mlp_rung_resumes_on_the_cpu(cuda):
    """An MLP rung trained on the card (its carry and generator state in the
    resume payload) resumes on the CPU, and the model matches a straight
    CPU fit to float rounding (the card's and the CPU's matmuls add in
    other orders)."""
    import repro_torch.tabular  # noqa: F401  (registers the estimators)
    from repro_torch.core import convert, get_estimator
    from repro_torch.core.interface import ResumeState
    from repro_torch.data.synthetic import make_higgs_like

    raw = make_higgs_like(3000, seed=6)
    est = get_estimator("mlp")
    params = {"network": "32_32", "learning_rate": 0.003, "steps": 60, "seed": 4}
    on_card = convert(raw, "dense_rows", device=cuda)
    on_cpu = convert(raw, "dense_rows", device="cpu")
    _, state = est.train_resumable(on_card, params, budget=30)
    wire = ResumeState.from_wire(state.to_wire())
    resumed, _ = est.train_resumable(on_cpu, params, budget=60, state=wire)
    straight = est.train(on_cpu, params)
    np.testing.assert_allclose(resumed.predict_proba(raw.x), straight.predict_proba(raw.x),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The dense configs' attention shapes, and gradients through the kernels
# ---------------------------------------------------------------------------

# (Hq, Hkv, D, window) of TinyLlama-1.1B, Qwen2-1.5B, Gemma-2B and
# Gemma3-12B's local layers, at a prompt longer than Gemma3's window
DENSE_HEADS = {"tinyllama": (32, 4, 64, None), "qwen2": (12, 2, 128, None),
               "gemma_2b": (8, 1, 256, None), "gemma3_local": (16, 8, 256, 1024),
               "gemma3_global": (16, 8, 256, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DENSE_HEADS))
def test_cuda_flash_attention_dense_config_heads(cuda, name):
    hq, hkv, d, window = DENSE_HEADS[name]
    q, k, v = _lm(20, (2, hq, 1300, d), (2, hkv, 1300, d), (2, hkv, 1300, d), device=cuda,
                  dtype=torch.bfloat16)
    got = ops.attention(q, k, v, window=window)
    _bf16_row_close(got, ref.attention_ref(q, k, v, window=window))
    assert torch.equal(got, ops.attention(q, k, v, force="kernel", window=window))


def _grad_pair(cuda, fn, plain, inputs, seed):
    """``fn`` (ops on the card, the kernel path) and ``plain`` on the same
    leaves: their outputs and the gradients of one weighted sum of them."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)
    want = plain(*inputs)
    want = want if isinstance(want, tuple) else (want,)
    (wts,) = [_lm(seed, *[o.shape for o in outs], device=cuda)]
    live = [x for x in inputs if x is not None]
    g = torch.autograd.grad(sum((o.float() * w).sum() for o, w in zip(outs, wts)), live)
    g_r = torch.autograd.grad(sum((o.float() * w).sum() for o, w in zip(want, wts)), live)
    return outs, want, g, g_r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_gradients_through_the_kernel(cuda, dtype):
    from repro_torch.kernels import launch_counts, reset_launch_counts

    dt = getattr(torch, dtype)
    q, k, v = (t.requires_grad_() for t in _lm(21, (2, 8, 300, 64), (2, 2, 300, 64),
                                               (2, 2, 300, 64), device=cuda, dtype=dt))
    reset_launch_counts()
    outs, want, g, g_r = _grad_pair(
        cuda, lambda *a: ops.attention(*a, window=100),
        lambda *a: ref.attention_ref(*a, window=100), (q, k, v), 22)
    assert launch_counts()["flash_attention"] == 1
    if dt == torch.float32:
        torch.testing.assert_close(outs[0], want[0], atol=1e-5, rtol=1e-4)
        for a, b in zip(g, g_r):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    else:
        _bf16_row_close(outs[0], want[0].detach())
        for a, b in zip(g, g_r):
            _bf16_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rglru_gradients_through_the_kernel(cuda, dtype):
    dt = getattr(torch, dtype)
    x, ig, rg = (t.requires_grad_() for t in _lm(23, *[(2, 150, 96)] * 3, device=cuda,
                                                 dtype=dt))
    a, h0 = (t.requires_grad_() for t in _lm(24, (96,), (2, 96), device=cuda))
    outs, want, g, g_r = _grad_pair(cuda, ops.rglru, ref.rglru_ref, (x, ig, rg, a, h0), 25)
    torch.testing.assert_close(outs[1], want[1], atol=1e-4, rtol=1e-4)
    close = ((lambda p, q: torch.testing.assert_close(p, q, atol=1e-4, rtol=1e-4))
             if dt == torch.float32 else _bf16_close)
    close(outs[0], want[0].detach())
    for p, q in zip(g, g_r):
        close(p, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_gradients_through_the_kernel(cuda, dtype):
    dt = getattr(torch, dtype)
    r, k, v = (t.requires_grad_() for t in _lm(26, *[(1, 2, 80, 64)] * 3, device=cuda,
                                               dtype=dt))
    w, u, s0 = (t.requires_grad_() for t in _lm(27, (1, 2, 80, 64), (2, 64), (1, 2, 64, 64),
                                                device=cuda))
    outs, want, g, g_r = _grad_pair(cuda, ops.rwkv6, ref.rwkv6_ref, (r, k, v, w, u, s0), 28)
    torch.testing.assert_close(outs[1], want[1], atol=1e-4, rtol=1e-4)
    close = ((lambda p, q: torch.testing.assert_close(p, q, atol=1e-4, rtol=1e-4))
             if dt == torch.float32 else _bf16_close)
    close(outs[0], want[0].detach())
    for p, q in zip(g, g_r):
        close(p, q)


@pytest.mark.cuda
def test_cuda_train_step_through_the_kernels(cuda):
    """One train step of each ported architecture's smoke config on the card:
    the loss and gradient norm within bf16 noise (1e-2 relative) of the same
    step with ``force="ref"``, the kernels launched once a layer."""
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train import build_train_step, init_train_state, make_optimizer

    for arch in ("tinyllama_1_1b", "gemma3_12b", "recurrentgemma_9b", "rwkv6_7b"):
        cfg = configs.get_smoke_config(arch)
        opt = make_optimizer("adamw", lr=1e-3)
        state = init_train_state(cfg, opt, seed=0, device=cuda)
        b = {k: torch.from_numpy(v).to(cuda)
             for k, v in TokenStream(2, 64, cfg.vocab, seed=0).batch_at(0).items()}
        reset_launch_counts()
        _, m = build_train_step(cfg, opt)(state, b)
        launched = launch_counts()
        _, m_ref = build_train_step(cfg, opt, force="ref")(state, b)
        assert launch_counts() == launched, arch
        assert sum(launched.values()) == cfg.n_layers, arch
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(m_ref[key])) <= 1e-2 * abs(float(m_ref[key])), \
                (arch, key)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b", "qwen3-moe-235b-a22b",
                                  "arctic-480b"])
def test_cuda_zoo_smoke_prefill_through_the_kernel(cuda, arch):
    """The smoke configs in float32 on the card, with seeded stub inputs:
    the prefill through the flash kernel within 2e-3 of the plain path
    (tests/test_torch_zoo_configs.py's gate against the JAX package),
    launching it once per self-attention, cross-attention and encoder
    layer; a rerun gives the same bits (the MoE's combine has no atomics)."""
    import dataclasses

    from repro_torch import configs, models
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32")
    params = models.init_params(cfg, seed=3, device=cuda)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))).to(cuda)}
    if cfg.frontend == "audio_stub":
        batch["enc_embeds"] = _lm(6, (2, cfg.encoder_seq, cfg.d_model), device=cuda)[0]
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = _lm(6, (2, cfg.num_patches, cfg.d_model), device=cuda)[0]

    def run(force=None):
        state = models.init_decode_state(cfg, 2, 48, torch.float32, cuda)
        return models.prefill(cfg, params, state, batch, force=force)[0]

    reset_launch_counts()
    got = run()
    specs = models.layer_specs(cfg)
    want_launches = (sum(s.kind == "attn" for s in specs) + sum(s.cross_attn for s in specs)
                     + cfg.encoder_layers)
    assert launch_counts()["flash_attention"] == want_launches
    torch.testing.assert_close(got, run("ref"), atol=2e-3, rtol=2e-3)
    assert torch.equal(got, run())


@pytest.mark.cuda
def test_cuda_moe_apply_matches_the_cpu(cuda):
    """``moe_apply`` on the card at a capacity factor that drops slots, with
    Arctic's dense residual, in float32: within 1e-5 of the CPU's (the
    same slots dropped), bit-identical on a rerun."""
    from repro_torch.models import init_moe, moe_apply
    from repro_torch.models.layers import Init

    p = init_moe(Init(torch.Generator().manual_seed(2)), 32, 8, 48, dense_residual_ff=64)
    x = _lm(7, (3, 50, 32), device="cpu")[0]
    want = moe_apply(p, x, top_k=2, capacity_factor=0.5)
    pc = {k: ({kk: vv.to(cuda) for kk, vv in v.items()} if isinstance(v, dict) else v.to(cuda))
          for k, v in p.items()}
    got = moe_apply(pc, x.to(cuda), top_k=2, capacity_factor=0.5)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, moe_apply(pc, x.to(cuda), top_k=2, capacity_factor=0.5))


# ---------------------------------------------------------------------------
# the Hopper bf16 flash kernel (flash_fwd_hopper: TMA loads, wgmma)
# ---------------------------------------------------------------------------

# every Tq and Tk of {1, 63, 64, 65, 127, 128, 129, 1000}, each around a tile
# edge (64- and 128-key tiles, 64-row warpgroups), Tq below, at and above Tk
HOPPER_T = [(1, 1), (1, 1000), (63, 63), (63, 129), (64, 64), (65, 128), (127, 127),
            (128, 65), (129, 129), (1000, 1000), (1000, 63), (129, 1)]
HOPPER_MASKS = {"causal": dict(causal=True), "bidirectional": dict(causal=False),
                "window": dict(causal=True, window=70),
                "softcap": dict(causal=True, logit_softcap=30.0)}


def _kernel_names(fn):
    """Names of the CUDA kernels ``fn()`` launches, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type.name == "CUDA"}


def _held_with_dead_rows(got, want):
    """Rows that see no key (NaN in the oracle) are 0; every other row within
    one bf16 ulp of its own scale (``_bf16_row_close``)."""
    dead = torch.isnan(want).all(dim=-1)
    assert bool((got[dead] == 0).all())
    _bf16_row_close(got[~dead], want[~dead])


@pytest.mark.cuda
@pytest.mark.parametrize("mask", sorted(HOPPER_MASKS))
@pytest.mark.parametrize("group", [1, 2, 8, 16])
@pytest.mark.parametrize("d", [8, 64, 72, 128, 256])
def test_cuda_flash_hopper_vs_plain(cuda, d, group, mask):
    """Every Tq/Tk pair of HOPPER_T at this head_dim (D padded to 64, 128 or
    256), GQA group and mask: within one bf16 ulp a row of the plain version,
    rows without a key 0, a rerun bit-identical."""
    kw = HOPPER_MASKS[mask]
    for tq, tk in HOPPER_T:
        q, k, v = _lm(40 + tq + tk, (2, 2 * group, tq, d), (2, 2, tk, d), (2, 2, tk, d),
                      device=cuda, dtype=torch.bfloat16)
        got = ops.attention(q, k, v, force="kernel", **kw)
        _held_with_dead_rows(got, ref.attention_ref(q, k, v, **kw))
        assert torch.equal(got, ops.attention(q, k, v, force="kernel", **kw)), (tq, tk)


@pytest.mark.cuda
def test_cuda_flash_routes_by_head_dim_and_alignment(cuda):
    """D % 8 == 0 on aligned tensors runs flash_fwd_hopper; D = 33, and a
    view whose rows start off a 16-byte boundary, run the unaligned kernel:
    each right, each counted as one flash launch."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    q, k, v = _lm(50, (2, 4, 200, 64), (2, 2, 200, 64), (2, 2, 200, 64), device=cuda,
                  dtype=torch.bfloat16)
    q33, k33, v33 = (t[..., :33].contiguous() for t in (q, k, v))
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_off = flat[1:].view(q.shape)                 # contiguous, 2 bytes off alignment
    q_off.copy_(q)
    for args, kernel in (((q, k, v), "flash_fwd_hopper"), ((q33, k33, v33), "flash_fwd_bf16"),
                         ((q_off, k, v), "flash_fwd_bf16")):
        reset_launch_counts(["flash_attention"])
        names = _kernel_names(lambda: ops.attention(*args, force="kernel"))
        assert any(kernel in n for n in names), (kernel, names)
        assert launch_counts(["flash_attention"]) == {"flash_attention": 1}
        _held_with_dead_rows(ops.attention(*args, force="kernel"), ref.attention_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d,hq,hkv,t", [(64, 16, 2, 1000), (128, 8, 2, 700), (256, 4, 1, 300)])
def test_cuda_flash_hopper_batch_invariant(cuda, d, hq, hkv, t):
    """A row's output is bit-equal launched at B = 4 and at B = 1."""
    q, k, v = _lm(51, (4, hq, t, d), (4, hkv, t, d), (4, hkv, t, d), device=cuda,
                  dtype=torch.bfloat16)
    for kw in (dict(causal=True), dict(causal=False), dict(causal=True, window=100)):
        whole = ops.attention(q, k, v, force="kernel", **kw)
        for i in range(4):
            one = ops.attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                v[i:i + 1].contiguous(), force="kernel", **kw)
            assert torch.equal(one[0], whole[i]), (kw, i)
