"""The level kernel's fixed-point decomposition, written out in plain PyTorch.

``csrc/histogram.cu`` (the port's GBDT level and histogram kernels) rounds
each row's grad and hess to a power-of-two grid once: 2**e with e the
smallest exponent for which R * max|v| < 2**62 * 2**e (no int64 sum can
overflow) and max|v| < 2**38 * 2**e (a rounded value keeps 38 bits and
splits into two 32-bit parts), over the finite values. It groups the rows by node (only the
smaller child of each sibling pair by subtraction, ties going left), sums
the rounded values as int64, and converts each cell's sum to float32 once.
A non-finite value adds nothing to the integers and sets a flag bit of its
cell (NaN, +inf, -inf); a flagged cell is NaN (a NaN, or both infinities)
or the one infinity. By subtraction the sibling is parent - small in
float32. The kernel itself runs only on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``); here the same
arithmetic runs on the CPU and is held to the JAX package's oracle
(``histogram_ref``, ``level_split_ref``) and plain path
(``_histogram_scatter``, ``_plan_smaller_child``): within ``atol=1e-4,
rtol=1e-5`` on real-valued g/h (the card tests' tolerance), bit-equal on
integer-valued g/h and under any row order, decisions tie-aware at
``GAIN_RTOL``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GAIN_RTOL = 1e-4
HIST_TOL = dict(atol=1e-4, rtol=1e-5)
NAN, POS_INF, NEG_INF = 1, 2, 4          # a cell's flag bits, as the kernel keeps them


def grid_exponent(v: torch.Tensor, rows: int) -> int:
    """The smallest e with rows * max|v| < 2**62 * 2**e and max|v| < 2**38 *
    2**e (finite values; e = 0 where every value is 0), by frexp in double
    as the kernel's ``grid_exponent``."""
    finite = v[torch.isfinite(v)].abs()
    m = float(finite.max()) if finite.numel() else 0.0
    if not m > 0:
        return 0
    return max(math.frexp(rows * m)[1] - 62, math.frexp(m)[1] - 38)


def quantize(v: torch.Tensor, e: int) -> torch.Tensor:
    """Round v to the grid 2**e: v * 2**-e is exact, rounded half to even
    (``__float2ll_rn``). Non-finite values give 0."""
    x = torch.where(torch.isfinite(v), v, torch.zeros_like(v)).double() * 2.0 ** -e
    return torch.round(x).long()


def flush(s: torch.Tensor, e: int) -> torch.Tensor:
    """An int64 sum to float32 once (round to nearest even), times 2**e
    (``ldexpf``: exact in double, rounded once where float32 underflows)."""
    return (s.to(torch.float32).double() * 2.0 ** e).float()


def with_flags(v: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    nan = (bits & NAN).bool() | ((bits & (POS_INF | NEG_INF)) == (POS_INF | NEG_INF))
    v = torch.where((bits & POS_INF).bool(), torch.full_like(v, math.inf), v)
    v = torch.where((bits & NEG_INF).bool(), torch.full_like(v, -math.inf), v)
    return torch.where(nan, torch.full_like(v, math.nan), v)


def nonfinite_bits(v: torch.Tensor) -> torch.Tensor:
    bits = torch.zeros(v.shape, dtype=torch.long)
    bits = torch.where(torch.isnan(v), torch.full_like(bits, NAN), bits)
    bits = torch.where(torch.isposinf(v), torch.full_like(bits, POS_INF), bits)
    return torch.where(torch.isneginf(v), torch.full_like(bits, NEG_INF), bits)


def card_plan(node: torch.Tensor, n_nodes: int, subtract: bool):
    """The card's grouping (launches 1-2): each accumulated node's rows,
    ``(small_is_left | None, ids, starts)``. By subtraction a row is kept
    when its child is the smaller of its pair by row count (ties left) and
    is grouped under its parent. The order within a node does not change
    any sum; here it is row order."""
    valid = (node >= 0) & (node < n_nodes)
    cnt = torch.bincount(node[valid].long(), minlength=n_nodes)
    rows = torch.arange(node.shape[0])
    if subtract:
        sil = cnt[0::2] <= cnt[1::2]
        small = torch.stack([sil, ~sil], dim=1).reshape(-1)
        keep = valid & small[node.clamp(0, n_nodes - 1).long()]
        acc = node.long() // 2
        n_acc = n_nodes // 2
    else:
        sil, keep, acc, n_acc = None, valid, node.long(), n_nodes
    kept = rows[keep]
    ids = kept[torch.argsort(acc[keep], stable=True)]
    starts = torch.cat([torch.zeros(1, dtype=torch.long),
                        torch.cumsum(torch.bincount(acc[keep], minlength=n_acc), 0)])
    return sil, ids, starts


def fixed_point_histogram(bins, g, h, node, n_nodes, n_bins, *, parent=None,
                          accumulator="int64"):
    """What ``fused_level_split_cuda`` / ``histogram_cuda`` compute, in plain
    PyTorch: (n_nodes, F, B, 2) float32. ``accumulator="float32"`` is the
    mutation check: float32 sums in grouped row order in place of the
    integers."""
    r, f = bins.shape
    subtract = parent is not None
    sil, ids, starts = card_plan(node, n_nodes, subtract)
    n_acc = starts.numel() - 1
    acc_node = torch.repeat_interleave(torch.arange(n_acc), starts.diff())
    b = bins[ids].long()                                         # (rows, F)
    ok = (b >= 0) & (b < n_bins)
    cell = ((acc_node[:, None] * f + torch.arange(f)[None, :]) * n_bins
            + b.clamp(0, n_bins - 1))
    cell = torch.where(ok, cell, torch.full_like(cell, n_acc * f * n_bins))  # dump cell
    size = n_acc * f * n_bins + 1
    out = []
    for v in (g, h):
        vr = v[ids][:, None].expand(-1, f)
        if accumulator == "float32":
            s = torch.zeros(size, dtype=torch.float32).index_add_(
                0, cell.reshape(-1), vr.reshape(-1))
            out.append(s[:-1])
            continue
        e = grid_exponent(v, r)
        s = torch.zeros(size, dtype=torch.long).index_add_(
            0, cell.reshape(-1), quantize(vr, e).reshape(-1))
        bits = torch.zeros(size, dtype=torch.long)
        for flag in (NAN, POS_INF, NEG_INF):
            hit = (nonfinite_bits(vr) == flag).long().reshape(-1)
            seen = torch.zeros(size, dtype=torch.long).index_add_(0, cell.reshape(-1), hit)
            bits |= torch.where(seen > 0, flag, 0)
        out.append(with_flags(flush(s, e), bits)[:-1])
    small = torch.stack(out, dim=-1).reshape(n_acc, f, n_bins, 2)
    if not subtract:
        return small
    big = parent - small
    silb = sil[:, None, None, None]
    return torch.stack([torch.where(silb, small, big), torch.where(silb, big, small)],
                       dim=1).reshape(n_nodes, f, n_bins, 2)


def _fixture(seed, r, f, nb, nn, integer=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(r, f)).astype(np.int32)
    if integer:
        g = rng.integers(-8, 9, size=r).astype(np.float32)
        h = rng.integers(1, 5, size=r).astype(np.float32)
    else:
        g = rng.normal(size=r).astype(np.float32)
        h = (np.abs(rng.normal(size=r)) + 0.1).astype(np.float32)
    node = rng.integers(0, nn, size=r).astype(np.int32)
    return bins, g, h, node


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_plain(bins, g, h, node, nn, nb):
    return np.asarray(jops._histogram_scatter(*(jnp.asarray(a) for a in (bins, g, h, node)),
                                              nn, nb))


def _float64_hist(bins, g, h, node, nn, nb) -> np.ndarray:
    """The histogram's sums in float64 (numpy, row order)."""
    r, f = bins.shape
    out = np.zeros((nn * f * nb, 2))
    flat = ((node.astype(np.int64)[:, None] * f + np.arange(f)) * nb + bins).reshape(-1)
    np.add.at(out, flat, np.repeat(np.stack([g, h], axis=1).astype(np.float64), f, axis=0))
    return out.reshape(nn, f, nb, 2)


def _assert_tie_aware(oracle_hist, feat, split, kw):
    gains = ref.split_gains_ref(torch.from_numpy(np.array(oracle_hist)), **kw)
    flat = gains.reshape(gains.shape[0], -1)
    best = flat.max(dim=1).values
    pick = flat[torch.arange(flat.shape[0]), feat.long() * kw["n_bins"] + split.long()]
    finite = torch.isfinite(best)
    assert torch.equal(torch.isfinite(pick), finite)
    gap = (best - pick)[finite].abs()
    assert bool((gap <= GAIN_RTOL * best[finite].abs().clamp_min(1.0)).all()), gap.max()


CASES = [(300, 5, 16, 1), (600, 7, 32, 8), (500, 3, 64, 32), (257, 28, 16, 4)]


@pytest.mark.parametrize("r,f,nb,nn", CASES)
def test_fixed_point_histogram_matches_the_oracle(r, f, nb, nn):
    arrays = _fixture(0, r, f, nb, nn)
    got = fixed_point_histogram(*_torch(*arrays), nn, nb)
    oracle = np.asarray(jref.histogram_ref(*(jnp.asarray(a) for a in arrays), nn, nb))
    np.testing.assert_allclose(got.numpy(), oracle, **HIST_TOL)
    np.testing.assert_allclose(got.numpy(), _jax_plain(*arrays, nn, nb), **HIST_TOL)
    # one rounding of a sum exact up to the grid: within an ulp of the float64 sums
    exact = _float64_hist(*arrays, nn, nb)
    ulp = np.spacing(np.abs(exact).astype(np.float32))
    assert bool((np.abs(got.numpy() - exact) <= ulp).all())


@pytest.mark.parametrize("r,f,nb,nn", CASES)
def test_fixed_point_integer_stats_bit_equal(r, f, nb, nn):
    arrays = _fixture(1, r, f, nb, nn, integer=True)
    got = fixed_point_histogram(*_torch(*arrays), nn, nb)
    np.testing.assert_array_equal(got.numpy(), _jax_plain(*arrays, nn, nb))
    oracle = np.asarray(jref.histogram_ref(*(jnp.asarray(a) for a in arrays), nn, nb))
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("accumulator", ["int64", "float32"])
def test_row_order_changes_no_bit(accumulator):
    """Two orders of the same rows give the same bits with the int64 sums;
    the mutation (float32 sums in grouped order) is caught: its bits move."""
    bins, g, h, node = _torch(*_fixture(2, 800, 6, 16, 4))
    perm = torch.from_numpy(np.random.default_rng(3).permutation(800))
    a = fixed_point_histogram(bins, g, h, node, 4, 16, accumulator=accumulator)
    b = fixed_point_histogram(bins[perm], g[perm], h[perm], node[perm], 4, 16,
                              accumulator=accumulator)
    if accumulator == "int64":
        assert torch.equal(a, b)
    else:
        assert not torch.equal(a, b)
        torch.testing.assert_close(a, b, **HIST_TOL)


def test_nonfinite_cells_match_the_plain_path():
    """NaN, +inf and -inf in g and h (one cell meets both infinities): the
    flagged cells are the plain float sums' NaN and infinities, the rest
    bit-equal (integer values)."""
    bins, g, h, node = _fixture(4, 400, 5, 8, 4, integer=True)
    bins[:8] = 3
    node[:8] = 1
    g[0], g[1], g[2] = np.inf, -np.inf, np.nan      # node 1, bin 3: NaN in g
    h[3] = np.inf                                    # ... +inf in h
    g[4] = np.inf                                    # another cell: +inf alone
    bins[4] = 5
    h[5], h[6] = -np.inf, np.inf
    bins[5:7] = 6                                    # both infinities in h: NaN
    got = fixed_point_histogram(*_torch(bins, g, h, node), 4, 8)
    want = _jax_plain(bins, g, h, node, 4, 8)
    assert np.isnan(want).any() and np.isinf(want).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_grid_edges():
    """Tiny values keep their relative precision; past 2**24 rows the row
    count sets the grid (R * max|g| < 2**62 * 2**e); values on a coarse grid
    (multiples of 2**31 up to 2**54: a grid of 2**16) sum exactly, then
    round once: the exact sum rounded to float32."""
    bins, g, h, node = _fixture(5, 300, 3, 8, 2)
    tiny = (torch.from_numpy(g) * 1e-30).float()
    got = fixed_point_histogram(*_torch(bins), tiny, torch.from_numpy(h),
                                torch.from_numpy(node), 2, 8)
    want = _float64_hist(bins, tiny.numpy(), h, node, 2, 8)
    assert grid_exponent(tiny, 300) < -120
    np.testing.assert_allclose(got[..., 0].numpy(), want[..., 0], rtol=1e-6, atol=0)
    one = torch.ones(1)
    assert grid_exponent(one, 2 ** 25) == -36 and grid_exponent(one, 2 ** 20) == -37
    rng = np.random.default_rng(6)
    big = (rng.integers(-(2 ** 23), 2 ** 23, size=300) * 2.0 ** 31).astype(np.float32)
    assert grid_exponent(torch.from_numpy(big), 300) == 16
    got = fixed_point_histogram(*_torch(bins, big, h, node), 2, 8)[..., 0].numpy()
    exact = np.zeros((2, 3, 8), dtype=object)
    for i in range(300):
        for f in range(3):
            exact[node[i], f, bins[i, f]] += int(big[i])
    np.testing.assert_array_equal(got, exact.astype(np.float64).astype(np.float32))


@pytest.mark.parametrize("r,f,nb,nn", [(600, 5, 32, 16), (500, 7, 64, 4), (300, 9, 16, 32)])
def test_card_plan_is_the_smaller_child_plan(r, f, nb, nn):
    """The card's grouping keeps the rows ``_plan_smaller_child`` keeps
    (the port's and the JAX package's), with the same small_is_left, each
    parent's rows one contiguous range."""
    node = torch.from_numpy(_fixture(7, r, f, nb, nn)[3])
    sil, ids, starts = card_plan(node, nn, True)
    want_sil, idx, valid = ops._plan_smaller_child(node, nn, r)
    assert torch.equal(sil, want_sil)
    np.testing.assert_array_equal(
        sil.numpy(), np.asarray(jops._plan_smaller_child(jnp.asarray(node.numpy()), nn, r)[0]))
    assert torch.equal(torch.sort(ids).values, torch.sort(idx[valid].long()).values)
    for p in range(nn // 2):
        mine = ids[starts[p]:starts[p + 1]]
        assert bool((node[mine] // 2 == p).all())


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("r,f,nb,nn", [(600, 5, 32, 16), (400, 12, 64, 4)])
def test_fixed_point_level_by_subtraction(r, f, nb, nn, integer):
    """A whole level by subtraction: the parent from the plain path, the
    smaller children in fixed point, the siblings parent - small; against
    the JAX oracle's direct level within tolerance (bit-equal on integer
    g/h), decisions tie-aware."""
    arrays = _fixture(8, r, f, nb, nn, integer=integer)
    bins, g, h, node = _torch(*arrays)
    parent = ops._histogram_scatter(bins, g, h, node // 2, nn // 2, nb)
    got = fixed_point_histogram(bins, g, h, node, nn, nb, parent=parent)
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    oh, _, _, _ = jops.level_split(*(jnp.asarray(a) for a in arrays), force="ref", **kw)
    if integer:
        np.testing.assert_array_equal(got.numpy(), _jax_plain(*arrays, nn, nb))
    np.testing.assert_allclose(got.numpy(), np.asarray(oh), **HIST_TOL)
    _, bf, bs = ref.split_scan_ref(got, lam=1.0, min_child_weight=1.0, n_bins=nb)
    _assert_tie_aware(oh, bf, bs, dict(lam=1.0, min_child_weight=1.0, n_bins=nb))
