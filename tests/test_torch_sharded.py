"""The port's row-sharded data plane (DESIGN.md §3.9) on the CPU: the
non-lane cases of the JAX package's ``tests/test_sharded.py`` against
``repro_torch``, and the port's sharded level against the JAX package's.

On one device the shards' row blocks are stacked on a leading axis
(``compat.sharded_call``) and their partial sums are added in shard order.
Sharded GBDT and forest split decisions must equal the unsharded ones
across depths {1, 3, 6} × bins {16, 64, 256} × shards {2, 4, 8}; logreg and
MLP margins within 1e-6; an 8-shard placement's per-device residency within
full-copy/8 plus pad slack. The JAX package's one-device-per-shard lowering
(its ci.yml ``sharded`` lane) has no counterpart here yet (ROADMAP Queue 1
item 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.tabular  # noqa: F401,E402  (registers the JAX estimators)
import repro_torch.tabular  # noqa: F401,E402  (registers the port's estimators)
from repro.core import get_estimator as jget  # noqa: E402
from repro.core.data_format import shard_payload as jshard_payload  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import compat, set_default_device  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CostModel,
    DenseMatrix,
    GridBuilder,
    SearchSpec,
    Session,
    TrainTask,
    convert,
    get_estimator,
    prepared_data_cache,
    schedule,
)
from repro_torch.core.data_format import (  # noqa: E402
    PreparedDataCache,
    ShardedPlacement,
    is_sharded_payload,
    payload_nbytes,
    prepare_cached,
    shard_payload,
    shard_pspecs,
)
from repro_torch.core.executor import MeshSliceExecutorPool, ShardGroup, make_slices  # noqa: E402
from repro_torch.distributed.collectives import compressed_psum, psum_tree  # noqa: E402
from repro_torch.distributed.sharding import P, bytes_per_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.tabular.draws import FixedForestDraws, MLPDraws, forest_tree_draws  # noqa: E402

set_default_device("cpu")

SHARDS = (2, 4, 8)
DEPTHS = (1, 3, 6)
BINS = (16, 64, 256)


@pytest.fixture(autouse=True)
def _clean_global_cache():
    prepared_data_cache().clear()
    yield
    prepared_data_cache().clear()


def _toy(rows: int = 120, features: int = 5, seed: int = 11) -> DenseMatrix:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, features)).astype(np.float32)
    margin = x[:, 0] + 0.5 * x[:, 1] * x[:, 2] - 0.25 * x[:, 3]
    y = (margin + 0.3 * rng.standard_normal(rows) > 0).astype(np.float32)
    return DenseMatrix(x, y)


@pytest.fixture(scope="module")
def tiny():
    return _toy()


# ---------------------------------------------------------------------------
# sharded payload layout
# ---------------------------------------------------------------------------

def test_shard_payload_roundtrip_and_global_stats(tiny):
    """Row order survives flatten-then-slice; global quantile edges are the
    FULL dataset's (sharding happens after conversion, §3.9)."""
    prep = convert(tiny, "quantized_bins", max_bins=64)
    for n in SHARDS:
        sh = shard_payload(prep, n)
        assert is_sharded_payload(sh) and not is_sharded_payload(prep)
        assert sh["_n_shards"] == n and sh["_n_rows"] == tiny.x.shape[0]
        rs = -(-tiny.x.shape[0] // n)
        assert tuple(sh["bins"].shape[:2]) == (n, rs)
        assert sh["bins"].device == prep["bins"].device
        flat = sh["bins"].reshape(n * rs, -1)[: tiny.x.shape[0]]
        assert torch.equal(flat, prep["bins"])
        assert int(sh["_shard_valid"].sum()) == tiny.x.shape[0]
        assert torch.equal(sh["edges"], prep["edges"])
        assert int(sh["n_bins"]) == int(prep["n_bins"])
    with pytest.raises(ValueError, match="already sharded"):
        shard_payload(shard_payload(prep, 2), 2)


def test_eight_shard_residency_bound(tiny):
    """Per-device resident bytes for an 8-shard placement <= full-copy/8 +
    pad slack (one padded row per row-leading leaf, plus the mask)."""
    prep = convert(tiny, "quantized_bins", max_bins=64)
    full = payload_nbytes(prep)
    n_rows = tiny.x.shape[0]
    for n in SHARDS:
        per_shard = payload_nbytes(shard_payload(prep, n))
        rs = -(-n_rows // n)
        pad_rows = n * rs - n_rows
        slack = (full // n_rows) * (pad_rows + 1) + n * rs + 4096
        assert per_shard <= full // n + slack, (n, per_shard, full)
    assert payload_nbytes(shard_payload(prep, 8)) < full


def test_bytes_per_device_accepts_prepared_payload_trees(tiny):
    """``bytes_per_device`` takes the payload and its ``shard_pspecs`` tree
    (tensors by shape and dtype, scalars ~0, a plain {axis: size} mesh)
    and agrees with the cache's per-shard accounting."""
    prep = convert(tiny, "quantized_bins", max_bins=64)
    sh = shard_payload(prep, 8)
    specs = shard_pspecs(sh)
    assert specs["bins"] == P("shards") and specs["edges"] == P()
    per8 = bytes_per_device(sh, specs, {"shards": 8})
    assert per8 == payload_nbytes(sh)
    assert per8 < payload_nbytes(prep)
    assert bytes_per_device(sh, specs, {"shards": 1}) >= payload_nbytes(prep)
    assert bytes_per_device(sh, specs, make_mesh((8,), ("shards",), "cpu")) == per8
    with pytest.raises(ValueError):
        bytes_per_device(sh, {"bins": P("shards")}, {"shards": 8})


# ---------------------------------------------------------------------------
# acceptance grid: split-decision / margin parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("bins", BINS)
def test_gbdt_split_parity_grid(tiny, depth, bins):
    """Per-shard histograms + one shard-order psum before the split scan
    choose the SAME (feature, threshold) at every node as the unsharded
    build; a rung resumed on the sharded payload equals its straight fit."""
    est = get_estimator("gbdt")
    params = {"round": 2, "max_depth": depth, "max_bin": bins, "eta": 0.3}
    prep = est.prepare(tiny, params)
    base = est.train(prep, params)
    for n in SHARDS:
        sh = shard_payload(prep, n)
        model = est.train(sh, params)
        np.testing.assert_array_equal(model.feat, base.feat, err_msg=f"shards={n}")
        np.testing.assert_array_equal(model.thresh, base.thresh, err_msg=f"shards={n}")
        np.testing.assert_allclose(model.leaves, base.leaves, rtol=0, atol=1e-5,
                                   err_msg=f"shards={n}")
        assert float(model.base) == float(base.base)
    _, s1 = est.train_resumable(sh, params, budget=1)
    resumed, _ = est.train_resumable(sh, params, budget=2, state=s1)
    for k in ("feat", "thresh", "leaves"):
        np.testing.assert_array_equal(getattr(resumed, k), getattr(model, k))


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("bins", BINS)
def test_forest_split_parity_grid(tiny, depth, bins):
    """The forest rides the same cross-shard histogram path; its bootstrap
    weights are drawn over the FULL row range before slicing, and with
    integer g/h every sum is exact: the trees match bit for bit."""
    est = get_estimator("forest")
    params = {"n_estimators": 3, "max_depth": depth, "seed": 0}
    prep = convert(tiny, "quantized_bins", max_bins=bins)
    base = est.train(prep, params)
    for n in SHARDS:
        model = est.train(shard_payload(prep, n), params)
        for k in ("feat", "thresh", "leaves"):
            np.testing.assert_array_equal(getattr(model, k), getattr(base, k),
                                          err_msg=f"{k} shards={n}")


@pytest.mark.parametrize("family,params", [
    ("logreg", {"c": 1.0, "lr": 0.05, "steps": 80}),
    ("mlp", {"network": "16_16", "learning_rate": 0.01, "steps": 60,
             "batch_size": 32, "seed": 0}),
])
def test_dp_families_margin_parity(tiny, family, params):
    """logreg/MLP do a data-parallel gradient mean (``psum_tree``): margins
    within 1e-6 of the unsharded fit for every shard count, and a fused
    batch and a resumed rung on the sharded payload equal its plain fit."""
    est = get_estimator(family)
    prep = est.prepare(tiny, params)
    base = est.train(prep, params).predict_proba(tiny.x)
    for n in SHARDS:
        got = est.train(shard_payload(prep, n), params).predict_proba(tiny.x)
        np.testing.assert_allclose(got, base, rtol=0, atol=1e-6,
                                   err_msg=f"{family} shards={n}")
    sh = shard_payload(prep, 4)
    straight = est.train(sh, params).predict_proba(tiny.x)
    fused = est.train_batched(sh, [params, {**params, "steps": 20}])
    np.testing.assert_array_equal(fused[0].predict_proba(tiny.x), straight)
    _, s = est.train_resumable(sh, params, budget=25)
    resumed, _ = est.train_resumable(sh, params, budget=params["steps"], state=s)
    np.testing.assert_array_equal(resumed.predict_proba(tiny.x), straight)


# ---------------------------------------------------------------------------
# the level against the JAX package's sharded level
# ---------------------------------------------------------------------------

def _level_blocks(seed, n_shards, rows, f, nb, nn, integer):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, (rows, f)).astype(np.int32)
    if integer:
        g = rng.integers(-8, 9, rows).astype(np.float32)
        h = rng.integers(1, 5, rows).astype(np.float32)
    else:
        g = rng.standard_normal(rows).astype(np.float32)
        h = (rng.random(rows) + 0.1).astype(np.float32)
    node = rng.integers(0, nn, rows).astype(np.int32)
    payload = {"bins": bins, "g": g, "h": h, "node": node}
    # the JAX package's shard_payload, so both packages get the same blocks
    return {k: np.array(v) for k, v in jshard_payload(payload, n_shards).items()
            if k in payload or k == "_shard_valid"}


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("integer", [False, True])
def test_sharded_level_matches_the_reference(n_shards, subtract, integer):
    """The same seeded blocks through JAX's ``_sharded_level_split`` (under
    ``jax.vmap`` with the shard axis) and the port's sharded branch: the
    same decisions, and on integer-valued g/h bit-identical histograms. On
    real-valued g/h the two add the shards in different orders (the port in
    shard order, XLA's reduction as it likes), so the histograms agree to
    float rounding and the decisions are held tie-aware against the port's
    own gains, as the port's kernel tests hold them."""
    rows, f, nb, nn = 301, 4, 16, 8
    blk = _level_blocks(7, n_shards, rows, f, nb, nn, integer)
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    full_node = blk["node"].reshape(-1)[:rows]
    parent = None
    if subtract:
        flat = {k: blk[k].reshape((-1,) + blk[k].shape[2:])[:rows] for k in ("bins", "g", "h")}
        parent = np.asarray(jops._histogram_scatter(
            jnp.asarray(flat["bins"]), jnp.asarray(flat["g"]), jnp.asarray(flat["h"]),
            jnp.asarray(full_node // 2), nn // 2, nb))

    def jax_level(b, g, h, node, valid):
        return jops._sharded_level_split(
            b, g, h, node, axis_name="shards", row_valid=valid,
            parent_hist=None if parent is None else jnp.asarray(parent), **kw)

    want = jax.vmap(jax_level, axis_name="shards")(
        *(jnp.asarray(blk[k]) for k in ("bins", "g", "h", "node", "_shard_valid")))
    want = [np.asarray(w[0]) for w in want]            # shard-invariant outputs
    got = compat.sharded_call(
        lambda axis, b, g, h, node, valid: ops.level_split(
            b, g, h, node, axis_name=axis, row_valid=valid,
            parent_hist=None if parent is None else torch.from_numpy(parent), **kw),
        n_shards=n_shards)(*(torch.from_numpy(blk[k])
                             for k in ("bins", "g", "h", "node", "_shard_valid")))
    got = [t.numpy() for t in got]
    if integer:
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
        return
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    from repro_torch.kernels import ref
    gains = ref.split_gains_ref(torch.from_numpy(got[0]), lam=1.0, min_child_weight=1.0,
                                n_bins=nb).reshape(nn, -1)
    pick_j = torch.from_numpy(want[2].astype(np.int64) * nb + want[3])[:, None]
    best = gains.max(dim=1).values
    assert torch.allclose(gains.gather(1, pick_j)[:, 0], best, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_histogram_equals_the_unsharded_one_on_integer_stats(n_shards):
    """Every level of a sharded tree sums the shards' partials; on integer
    g/h those sums are exact, so the sharded level's histogram (direct and
    by subtraction) is the unsharded histogram bit for bit."""
    rows, f, nb, nn = 203, 3, 8, 4
    blk = _level_blocks(3, n_shards, rows, f, nb, nn, integer=True)
    flat = {k: torch.from_numpy(blk[k].reshape((-1,) + blk[k].shape[2:])[:rows])
            for k in ("bins", "g", "h", "node")}
    kw = dict(n_nodes=nn, n_bins=nb, lam=1.0, min_child_weight=1.0)
    parent = ops._histogram_scatter(flat["bins"], flat["g"], flat["h"], flat["node"] // 2,
                                    nn // 2, nb)
    base = ops.level_split(flat["bins"], flat["g"], flat["h"], flat["node"], **kw)
    for ph in (None, parent):
        got = compat.sharded_call(
            lambda axis, b, g, h, node, valid: ops.level_split(
                b, g, h, node, axis_name=axis, row_valid=valid, parent_hist=ph, **kw),
            n_shards=n_shards)(*(torch.from_numpy(blk[k])
                                 for k in ("bins", "g", "h", "node", "_shard_valid")))
        for a, b in zip(got, base):
            assert torch.equal(a, b)


def test_sharded_forest_and_logreg_match_the_reference_sharded_programs(tiny):
    """Fed the JAX package's draws, the port's sharded forest grows the JAX
    package's sharded trees bit for bit; the sharded logreg, after
    ``test_torch_linear.py``'s 200 steps, stays within its tolerances of
    JAX's sharded logreg (Adam's first steps turn rounding into a few 1e-3
    at 60 steps, sharded or not)."""
    params = {"n_estimators": 3, "max_depth": 4, "seed": 5}
    jprep = jget("forest").prepare(tiny, {})
    tprep = get_estimator("forest").prepare(tiny, {})
    r, f = tprep["bins"].shape
    key = jax.random.key(5)
    ws, perms = [], []
    for t in range(3):
        kb, kf = jax.random.split(jax.random.fold_in(key, t))
        ws.append(np.asarray(jax.random.poisson(kb, 1.0, (r,)).astype(jnp.float32)))
        perms.append(np.asarray(jax.random.permutation(kf, f)))
    draws = FixedForestDraws(np.stack(ws), np.stack(perms))
    jm = jget("forest").train(jshard_payload(jprep, 4), params)
    tm = get_estimator("forest").train(shard_payload(tprep, 4), params, draws=draws)
    for k in ("feat", "thresh", "leaves"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k), err_msg=k)
    lparams = {"c": 0.9, "lr": 0.05, "steps": 200}
    jl = jget("logreg").train(jshard_payload(jget("logreg").prepare(tiny, lparams), 4),
                              lparams)
    tl = get_estimator("logreg").train(
        shard_payload(get_estimator("logreg").prepare(tiny, lparams), 4), lparams)
    np.testing.assert_allclose(tl.w, jl.w, rtol=0, atol=5e-3)
    np.testing.assert_allclose(tl.predict_proba(tiny.x), jl.predict_proba(tiny.x),
                               rtol=0, atol=2e-3)


# ---------------------------------------------------------------------------
# draws: drawn on a CPU generator, over the full row range
# ---------------------------------------------------------------------------

def test_draws_are_seeded_cpu_draws_and_resume_from_their_state():
    """The forest's and the MLP's draws come from a CPU generator whatever
    the device (so the card draws what the CPU draws, a card test holds):
    the same seed gives the same bits, the MLP's saved state restores its
    stream, and a sharded forest's per-shard weights are the full draw cut
    into blocks."""
    w1, p1 = forest_tree_draws(4, 2, 50, 7, "cpu")
    w2, p2 = forest_tree_draws(4, 2, 50, 7, torch.device("cpu"))
    assert torch.equal(w1, w2) and torch.equal(p1, p2)
    assert not torch.equal(w1, forest_tree_draws(4, 3, 50, 7, "cpu")[0])
    a = MLPDraws(3, "cpu")
    init = a.init((5, 4, 1))
    first = a.batch(0, 100, 8)
    state = a.state()
    after = a.batch(1, 100, 8)
    b = MLPDraws(3, "cpu")
    for (wa, _), (wb, _) in zip(init, b.init((5, 4, 1))):
        assert torch.equal(wa, wb)
    assert torch.equal(b.batch(0, 100, 8), first)
    assert torch.equal(MLPDraws(3, "cpu", state=state).batch(1, 100, 8), after)
    assert a.gen.device.type == "cpu" and MLPDraws(3, "meta").gen.device.type == "cpu"


# ---------------------------------------------------------------------------
# cache: placement-keyed entries, exactly-once builds, coexistence
# ---------------------------------------------------------------------------

def test_sharded_cache_exactly_once_and_coexistence(tiny):
    cache = PreparedDataCache()
    placement = ShardedPlacement(4)
    rep, _, built_rep = prepare_cached(tiny, "quantized_bins",
                                       {"max_bins": 64}, cache=cache)
    sh1, _, built1 = prepare_cached(tiny, "quantized_bins", {"max_bins": 64},
                                    cache=cache, placement=placement)
    sh2, _, built2 = prepare_cached(tiny, "quantized_bins", {"max_bins": 64},
                                    cache=cache, placement=ShardedPlacement(4))
    assert built_rep and built1 and not built2  # identity = (n, axis, tag)
    assert sh2 is sh1 and is_sharded_payload(sh1) and not is_sharded_payload(rep)
    assert cache.n_entries == 2  # replicated + sharded coexist
    resident = cache.sharded_resident_bytes()
    assert 0 < resident < payload_nbytes(rep)
    assert resident == payload_nbytes(sh1)
    assert cache.bytes_cached == payload_nbytes(rep) + resident
    _, _, built8 = prepare_cached(tiny, "quantized_bins", {"max_bins": 64},
                                  cache=cache, placement=ShardedPlacement(8))
    assert built8 and cache.n_entries == 3


def test_sharded_placement_identity():
    a, b = ShardedPlacement(4), ShardedPlacement(4)
    assert a == b and hash(a) == hash(b)
    assert ShardedPlacement(4) != ShardedPlacement(8)
    assert ShardedPlacement(4, tag=("slice-group", 1, 0)) != a
    with pytest.raises(ValueError):
        ShardedPlacement(1)


# ---------------------------------------------------------------------------
# the shard axis and its collectives
# ---------------------------------------------------------------------------

def _grad_tree(rng, n):
    return {
        "w": torch.from_numpy(rng.standard_normal((n, 6, 3)).astype(np.float32)),
        "b": torch.from_numpy((10.0 * rng.standard_normal((n, 3))).astype(np.float32)),
    }


def test_compressed_psum_int8_roundtrip_with_residual_carry():
    """int8 round trip: one step's error bounded by the shared scale;
    carrying the residual into the next step keeps the CUMULATIVE mean
    unbiased (error feedback) instead of compounding."""
    rng = np.random.default_rng(5)
    grads = _grad_tree(rng, 8)
    true = {k: v.mean(0) for k, v in grads.items()}
    axis = compat.ShardAxis("dp", 8)
    mean1, res1 = compressed_psum(grads, axis)
    for k in grads:
        assert res1[k].shape == grads[k].shape
        scale = grads[k].abs().max() / 127.0
        assert (mean1[k] - true[k]).abs().max() <= 2 * scale
    mean2, _ = compressed_psum(grads, axis, res1)
    for k in grads:
        cum = mean1[k] + mean2[k]
        scale = 2 * grads[k].abs().max() / 127.0
        assert (cum - 2 * true[k]).abs().max() <= 2 * scale


def test_psum_tree_is_the_mean_in_shard_order():
    rng = np.random.default_rng(6)
    grads = _grad_tree(rng, 8)
    out = psum_tree(grads, compat.ShardAxis("dp", 8))
    for k, g in grads.items():
        want = g[0].clone()
        for s in range(1, 8):
            want = want + g[s]               # one add after another, in order
        assert torch.equal(out[k], want / 8)
        torch.testing.assert_close(out[k], g.mean(0), rtol=0, atol=1e-6)


def test_sharded_call_psum_matches_numpy_and_refuses_a_mesh():
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)

    def per_shard(axis, blocks):
        return axis.psum(blocks.sum(1)), axis.psum(1), blocks * 2.0

    total, n, doubled = compat.sharded_call(per_shard, n_shards=8)(x)
    assert float(total) == float(x.sum()) and n == 8
    assert torch.equal(doubled, x * 2.0)
    with pytest.raises(ValueError, match="8 shards"):
        compat.sharded_call(per_shard, n_shards=8)(x[:4])
    mesh = make_mesh((8,), ("shards",), "cpu")
    # one rank per shard needs a torch.distributed mesh (tests/test_torch_sharded_mesh.py)
    with pytest.raises(TypeError, match="torch.distributed"):
        compat.sharded_call(per_shard, n_shards=8, mesh=mesh)
    # a mesh without a matching shards axis keeps the one-device lowering
    assert compat.sharded_call(per_shard, n_shards=8,
                               mesh=make_mesh((2,), ("data",), "cpu"))(x)[1] == 8


# ---------------------------------------------------------------------------
# scheduler / pool: a sharded placement is ONE unit spanning its shard group
# ---------------------------------------------------------------------------

def test_mesh_pool_shard_groups(tiny):
    pool = MeshSliceExecutorPool(slices=["s0", "s1", "s2", "s3"], n_shards=2,
                                 prepared_cache=PreparedDataCache())
    assert pool.n_executors == 2
    assert all(isinstance(g, ShardGroup) and len(g.slices) == 2
               for g in pool.slices)
    tokens = pool.prepare_placements()
    assert all(isinstance(t, ShardedPlacement) and t.n_shards == 2
               for t in tokens)
    assert len(set(tokens)) == 2  # each group keys its own partition


def test_mesh_pool_rejects_ragged_shard_groups():
    with pytest.raises(ValueError):
        MeshSliceExecutorPool(slices=["s0", "s1", "s2"], n_shards=2)


def test_make_slices_partitions_a_device_mesh():
    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    slices = make_slices(mesh, 2)
    assert [s.shape for s in slices] == [{"data": 2, "model": 1}] * 2
    assert all(s.device == torch.device("cpu") for s in slices)
    with pytest.raises(ValueError):
        make_slices(mesh, 3)
    pool = MeshSliceExecutorPool(mesh, 4, n_shards=2, prepared_cache=PreparedDataCache())
    assert pool.n_executors == 2


def test_mesh_pool_sharded_training_matches_replicated(tiny):
    est = get_estimator("logreg")
    params = {"c": 1.0, "lr": 0.05, "steps": 60}
    task = TrainTask(task_id=0, estimator="logreg", params=params, cost=1.0)
    base = est.train(est.prepare(tiny, params), params).predict_proba(tiny.x)
    pool = MeshSliceExecutorPool(make_mesh((2,), ("data",), "cpu"), 2, n_shards=2,
                                 prepared_cache=PreparedDataCache())
    results = pool.run(schedule([task], pool.n_executors), tiny)
    assert len(results) == 1 and results[0].ok
    got = results[0].model.predict_proba(tiny.x)
    np.testing.assert_allclose(got, base, rtol=0, atol=1e-6)
    assert pool.prepared_cache.sharded_resident_bytes() > 0


# ---------------------------------------------------------------------------
# cost model: shard-count-aware laws (rows-per-shard is the bucketed size)
# ---------------------------------------------------------------------------

def _task(family="gbdt", cost=1.0):
    return TrainTask(task_id=0, estimator=family, params={}, cost=cost)


def test_cost_model_shard_laws_and_fallback():
    cm = CostModel()
    t = _task()
    for n_rows, secs in ((1000, 1.0), (4000, 4.0), (16000, 16.0)):
        cm.observe(t, secs, n_rows)
    cold = cm.estimate(t, 8000, n_shards=4)
    assert cold == pytest.approx(cm.estimate(t, 8000), rel=1e-6)
    for n_rows, secs in ((4000, 0.4), (16000, 1.6)):
        cm.observe(t, secs, n_rows, n_shards=4)
    warm = cm.estimate(t, 8000, n_shards=4)
    assert warm is not None and warm < cold
    assert cm.estimate(t, 8000) == pytest.approx(cold, rel=1e-6)


def test_cost_model_shard_laws_persist_roundtrip(tmp_path):
    cm = CostModel(path=str(tmp_path / "cost.json"))
    t = _task()
    for n_rows, secs in ((4000, 0.4), (16000, 1.6)):
        cm.observe(t, secs, n_rows, n_shards=4)
    cm.observe_eval(t, 0.05, 4000, n_shards=4)
    d = cm.to_dict()
    assert "gbdt#s4" in d["families"]
    cm2 = CostModel.from_dict(d)
    assert cm2.estimate(t, 8000, n_shards=4) == pytest.approx(
        cm.estimate(t, 8000, n_shards=4), rel=1e-9)
    assert cm2.predict_eval(t, 8000, n_shards=4) == pytest.approx(
        cm.predict_eval(t, 8000, n_shards=4), rel=1e-9)


def test_cost_model_predict_eval_shard_fallback():
    cm = CostModel()
    t = _task()
    for n_rows, secs in ((1000, 0.01), (4000, 0.04)):
        cm.observe_eval(t, secs, n_rows)
    assert cm.predict_eval(t, 2000, n_shards=4) == pytest.approx(
        cm.predict_eval(t, 2000), rel=1e-6)


# ---------------------------------------------------------------------------
# spec + session plumbing
# ---------------------------------------------------------------------------

def test_spec_n_shards_validation():
    space = GridBuilder("logreg").add_grid("c", [1.0]).build()
    assert SearchSpec(spaces=[space]).n_shards == 1
    assert SearchSpec(spaces=[space], n_shards=4).n_shards == 4
    with pytest.raises(ValueError):
        SearchSpec(spaces=[space], n_shards=0)


def test_session_sharded_parity_and_residency(tiny):
    """A 2-sharded Session scores every config within 1e-6 of the
    replicated run (the sharded eval plane reduces per-shard metric
    partials) and reports shard residency below a full copy's bytes."""
    valid = _toy(rows=80, seed=12)
    space = GridBuilder("logreg").add_grid("c", [0.1, 1.0]).build()

    def run(n_shards):
        spec = SearchSpec(spaces=[space], n_executors=2, n_shards=n_shards, seed=0)
        session = Session(spec)
        results = {tuple(sorted(r.task.params.items())): r.score
                   for r in session.results(tiny, valid)}
        return results, session.stats

    base, st1 = run(1)
    got, st2 = run(2)
    assert set(got) == set(base) and len(base) == 2
    for key, score in got.items():
        assert score == pytest.approx(base[key], abs=1e-6)
    assert st1.shard_residency_bytes == 0
    prep = get_estimator("logreg").prepare(tiny, {})
    assert 0 < st2.shard_residency_bytes < payload_nbytes(prep)
