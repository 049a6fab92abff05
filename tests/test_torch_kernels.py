"""The port's GBDT kernel layer against the JAX package's.

The same seeded numpy inputs go through ``repro.kernels`` (JAX on the CPU:
the XLA path, ``force="ref"`` and the Pallas kernel in interpret mode) and
``repro_torch.kernels`` (PyTorch). Histograms on the CPU path are
bit-equal (``index_add_`` in row order equals JAX's scatter-add). Split
decisions are held to the JAX oracle tie-aware: the two frameworks' cumsums
differ in the last bits, so a near-tie may flip, and a decision passes when
it is the oracle's or its gain under the oracle's histogram is within
``GAIN_RTOL`` of the oracle's best. The CUDA kernels themselves run only on
a card: ``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GAIN_RTOL = 1e-4

HIST_GRID = [(100, 5, 8, 1), (500, 7, 16, 4), (1000, 3, 64, 8),
             (50, 19, 24, 3), (128, 13, 48, 5), (37, 9, 8, 2)]
LEVEL_GRID = [(200, 5, 16, 1), (500, 7, 64, 4), (400, 12, 256, 4),
              (300, 9, 16, 32), (600, 3, 64, 32), (250, 6, 256, 32)]


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


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_tie_aware(oracle_hist, feat, split, kw):
    """(feat, split) per node is the oracle's best up to GAIN_RTOL."""
    gains = ref.split_gains_ref(torch.from_numpy(np.array(oracle_hist)), **kw)
    flat = gains.reshape(gains.shape[0], -1)
    best = flat.max(dim=1).values
    pick = flat[torch.arange(flat.shape[0]),
                torch.as_tensor(feat).long() * kw["n_bins"] + torch.as_tensor(split).long()]
    finite = torch.isfinite(best)
    assert torch.equal(torch.isfinite(pick), finite)
    gap = (best - pick)[finite].abs()
    assert bool((gap <= GAIN_RTOL * best[finite].abs().clamp_min(1.0)).all()), gap.max()


@pytest.mark.parametrize("r,f,nb,nn", HIST_GRID)
def test_histogram_matches_reference(r, f, nb, nn):
    arrays = _fixture(0, r, f, nb, nn)
    want = np.asarray(jops._histogram_scatter(*_jax(*arrays), nn, nb))
    got = ops.histogram(*_torch(*arrays), n_nodes=nn, n_bins=nb)
    assert got.shape == (nn, f, nb, 2)
    np.testing.assert_array_equal(got.numpy(), want)          # bit-exact
    kernel = jops.histogram(*_jax(*arrays), n_nodes=nn, n_bins=nb, force="kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=1e-4)
    oracle = np.asarray(jref.histogram_ref(*_jax(*arrays), nn, nb))
    port_oracle = ops.histogram(*_torch(*arrays), n_nodes=nn, n_bins=nb, force="ref")
    np.testing.assert_allclose(port_oracle.numpy(), oracle, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4)


@pytest.mark.parametrize("r,f,nb,nn", LEVEL_GRID)
def test_level_split_matches_reference(r, f, nb, nn):
    arrays = _fixture(1, r, f, nb, nn)
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    scan_kw = dict(lam=1.0, min_child_weight=1.0, n_bins=nb)
    jh, _, _, _ = jops.level_split(*_jax(*arrays), **kw)
    oh, _, _, _ = jops.level_split(*_jax(*arrays), force="ref", **kw)
    th, _, tf, ts = ops.level_split(*_torch(*arrays), **kw)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(th.numpy(), np.asarray(oh), atol=1e-4)
    _assert_tie_aware(oh, tf, ts, scan_kw)
    rh, _, rf, rs = ops.level_split(*_torch(*arrays), force="ref", **kw)
    np.testing.assert_allclose(rh.numpy(), np.asarray(oh), atol=1e-4)
    _assert_tie_aware(oh, rf, rs, scan_kw)
    # the JAX package's Pallas kernel, in interpret mode as its tests run it
    kh, _, kf, ks = jops.level_split(*_jax(*arrays), force="kernel", **kw)
    np.testing.assert_allclose(th.numpy(), np.asarray(kh), atol=1e-4)
    _assert_tie_aware(th, kf, ks, scan_kw)
    if nn > 1:
        # subtraction: same compacted rows, same parent → bit-equal histograms
        parent_j = jops._histogram_scatter(*_jax(*arrays[:3]), jnp.asarray(arrays[3] // 2),
                                           nn // 2, nb)
        parent_t = torch.from_numpy(np.array(parent_j))
        sj, _, _, _ = jops.level_split(*_jax(*arrays), parent_hist=parent_j, **kw)
        sh, _, sf, ss = ops.level_split(*_torch(*arrays), parent_hist=parent_t, **kw)
        np.testing.assert_array_equal(sh.numpy(), np.asarray(sj))
        np.testing.assert_allclose(sh.numpy(), np.asarray(oh), atol=1e-4)
        _assert_tie_aware(oh, sf, ss, scan_kw)


@pytest.mark.parametrize("r,f,nb,nn", LEVEL_GRID)
def test_plan_smaller_child_matches_reference(r, f, nb, nn):
    node = _fixture(2, r, f, nb, max(nn, 2))[3]
    nn = max(nn, 2)
    want = jops._plan_smaller_child(jnp.asarray(node), nn, r)
    got = ops._plan_smaller_child(torch.from_numpy(node), nn, r)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("case", ["fixture_330", "fixture_350"])
def test_level_split_subtraction_bit_equality(case):
    """Integer g/h make every sum exact (the reference's 600-row fixture),
    and an empty right sibling makes ``parent − 0`` exact even with real
    g/h (its 300-row fixture): subtraction equals the direct build bit for
    bit, in both packages."""
    if case == "fixture_330":
        r, f, nb, nn = 600, 5, 32, 16
        arrays = list(_fixture(3, r, f, nb, nn, integer=True))
    else:
        r, f, nb, nn = 300, 4, 16, 8
        arrays = list(_fixture(4, r, f, nb, nn))
        arrays[3] = (2 * (arrays[3] // 2)).astype(np.int32)   # even nodes only
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    direct, _, df, ds = ops.level_split(*_torch(*arrays), **kw)
    parent = ops._histogram_scatter(*_torch(*arrays[:3]),
                                    torch.from_numpy(arrays[3] // 2), nn // 2, nb)
    sub, _, sf, ss = ops.level_split(*_torch(*arrays), parent_hist=parent, **kw)
    assert torch.equal(sub, direct)
    assert torch.equal(sf, df) and torch.equal(ss, ds)
    jd, _, _, _ = jops.level_split(*_jax(*arrays), **kw)
    np.testing.assert_array_equal(direct.numpy(), np.asarray(jd))


@pytest.mark.parametrize("force", [None, "ref"])
def test_all_masked_node_gives_minus_inf_feat0_split0(force):
    arrays = _fixture(5, 200, 6, 16, 4)
    kw = dict(n_nodes=4, n_bins=16, lam=1.0, min_child_weight=1.0,
              feat_mask=np.zeros(6, bool))
    _, bg, bf, bs = ops.level_split(*_torch(*arrays), force=force, **kw)
    assert bool(torch.isneginf(bg).all())
    assert bool((bf == 0).all() and (bs == 0).all())
    _, jg, jf, js = jops.level_split(*_jax(*arrays), force=force,
                                     **{**kw, "feat_mask": jnp.zeros(6, bool)})
    np.testing.assert_array_equal(np.asarray(jg), bg.numpy())
    np.testing.assert_array_equal(np.asarray(jf), bf.numpy())
    np.testing.assert_array_equal(np.asarray(js), bs.numpy())


def test_level_split_feat_mask_and_bin_limit():
    arrays = _fixture(6, 500, 10, 32, 8)
    mask = np.arange(10) % 3 == 0
    kw = dict(n_nodes=8, n_bins=32, lam=0.5, min_child_weight=1.0, bin_limit=16)
    oh, _, _, _ = jops.level_split(*_jax(*arrays), force="ref",
                                   feat_mask=jnp.asarray(mask), **kw)
    for force in (None, "ref"):
        _, bg, bf, bs = ops.level_split(*_torch(*arrays), force=force,
                                        feat_mask=torch.from_numpy(mask), **kw)
        real = torch.isfinite(bg)
        assert bool(torch.from_numpy(mask)[bf[real].long()].all())
        assert bool((bs[real] < 15).all())
        _assert_tie_aware(oh, bf, bs, dict(lam=0.5, min_child_weight=1.0, n_bins=32,
                                           bin_limit=16, feat_mask=mask))


@pytest.mark.parametrize("force", [None, "ref"])
def test_level_split_return_hist_false_same_decisions(force):
    arrays = _fixture(7, 200, 5, 16, 4)
    kw = dict(n_nodes=4, n_bins=16, lam=1.0, min_child_weight=1.0, force=force)
    full = ops.level_split(*_torch(*arrays), **kw)
    slim = ops.level_split(*_torch(*arrays), return_hist=False, **kw)
    assert slim[0] is None
    for a, b in zip(full[1:], slim[1:]):
        assert torch.equal(a, b)


def test_kernel_path_refuses_cpu_tensors_and_sharding():
    arrays = _torch(*_fixture(8, 50, 3, 8, 2))
    kw = dict(n_nodes=2, n_bins=8, lam=1.0, min_child_weight=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.level_split(*arrays, force="kernel", **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.histogram(*arrays, n_nodes=2, n_bins=8, force="kernel")
    # the sharded branch takes a shard axis over stacked blocks, not a name
    with pytest.raises(TypeError, match="ShardAxis"):
        ops.level_split(*arrays, axis_name="shards", **kw)
