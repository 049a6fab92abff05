"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips where CUDA is absent.
The file imports only PyTorch and the port, so it also runs on a machine
without JAX (``--noconftest`` skips the JAX fixtures of ``conftest.py``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: histograms within ``atol=1e-4, rtol=1e-5`` of the plain path
(float sums in another order); split decisions tie-aware (the kernel's
candidate has a plain-path gain within ``GAIN_RTOL`` of the plain best);
integer-valued grad/hess bit-equal (every sum is exact); two launches
bit-identical.
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

GAIN_RTOL = 1e-4
LEVEL_GRID = [(200, 5, 16, 1), (500, 7, 64, 4), (400, 12, 256, 4), (300, 9, 16, 32),
              (600, 3, 64, 32), (250, 6, 256, 32), (1, 4, 8, 2), (3000, 28, 256, 16),
              (5000, 3, 256, 256)]      # 256 nodes × 256 bins: two node tiles
HIST_GRID = [(100, 5, 8, 1), (500, 7, 16, 4), (1000, 3, 64, 8), (50, 19, 24, 3),
             (128, 13, 48, 5), (37, 9, 8, 2), (20000, 1, 1, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _fixture(seed, r, f, nb, nn, device, integer=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(r, f)).astype(np.int32)
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
    assert launch_counts() == {"histogram": 1, "level_split": 1}
    with pytest.raises(ValueError, match="int32"):
        ops.histogram(t[0].long(), *t[1:], n_nodes=2, n_bins=8)
