"""The port's data plane against the JAX package's, its device rule, and
the guard that keeps the port free of JAX.

The same ``higgs_small`` rows go through both packages' converters; the
payloads must be bit-equal (bins are int32 in both, edges float32).
"""
import ast
import threading
from pathlib import Path

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import data_format as jdf  # noqa: E402
from repro_torch import default_device, set_default_device  # noqa: E402
from repro_torch.core import data_format as tdf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

set_default_device("cpu")


def _port(dm):
    return tdf.DenseMatrix(dm.x, dm.y, dm.feature_names)


@pytest.mark.parametrize("max_bins", [16, 64, 256])
def test_quantized_bins_bit_equal(higgs_small, max_bins):
    train, _ = higgs_small
    want = jdf.convert(train, "quantized_bins", max_bins=max_bins)
    got = tdf.convert(_port(train), "quantized_bins", max_bins=max_bins)
    assert got["bins"].dtype == torch.int32 and got["edges"].dtype == torch.float32
    for key in ("bins", "edges", "y"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["n_bins"] == want["n_bins"]
    assert tdf.payload_nbytes(got) == jdf.payload_nbytes(want)


def _awkward_columns():
    """Ties, both signed zeros, a constant column, NaN and infinities."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 5, size=(3000, 7)).astype(np.float32)
    x[:, 3] = 0.0
    x[::7, 4] = -0.0
    x[::3, 1] *= -1.0
    x[:, 5] = rng.standard_normal(3000)
    x[5, 5], x[9, 6], x[10, 6] = np.nan, np.inf, -np.inf
    return x


@pytest.mark.parametrize("max_bins", [2, 16, 256])
def test_quantized_bins_bit_equal_on_awkward_columns(max_bins):
    """Edges and bins bit for bit as the JAX package's converter gives them
    (np.quantile's own selection, a searchsorted per feature) where sorted
    columns could differ: signed zeros, NaN, infinities, ties."""
    x = _awkward_columns()
    dm = jdf.DenseMatrix(x, np.zeros(len(x), np.float32))
    want = jdf.convert(dm, "quantized_bins", max_bins=max_bins)
    got = tdf.convert(_port(dm), "quantized_bins", max_bins=max_bins)
    np.testing.assert_array_equal(got["bins"].numpy(), np.asarray(want["bins"]))
    np.testing.assert_array_equal(got["edges"].numpy().view(np.int32),
                                  np.asarray(want["edges"]).view(np.int32))


@pytest.mark.parametrize("fmt", ["dense_rows", "dense_cols", "eval_dense", "sparse_csr"])
def test_other_converters_equal(higgs_small, fmt):
    _, valid = higgs_small
    want = jdf.convert(valid, fmt)
    got = tdf.convert(_port(valid), fmt)
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "shape":
            assert got[key] == value
        else:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value))
    assert tdf.payload_nbytes(got) == jdf.payload_nbytes(want)


def test_fingerprint_split_sample_standardize_match(higgs_small):
    train, _ = higgs_small
    port = _port(train)
    assert port.fingerprint() == train.fingerprint()
    for a, b in zip(port.split((0.6, 0.4), seed=3), train.split((0.6, 0.4), seed=3)):
        np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(port.sample(0.1, seed=2).x, train.sample(0.1, seed=2).x)
    np.testing.assert_array_equal(port.standardize()[0].x, train.standardize()[0].x)


def test_prepared_cache_keys_carry_the_device(higgs_small):
    train, _ = higgs_small
    port = _port(train)
    cache = tdf.PreparedDataCache()
    got, secs, built = tdf.prepare_cached(port, "quantized_bins", {"max_bins": 32},
                                          cache=cache, device="cpu")
    assert built and secs >= 0 and got["bins"].device.type == "cpu"
    key = tdf.prepare_key(port, "quantized_bins", {"max_bins": 32}, device="cpu")
    assert key[-1] == "cpu" and cache.contains(key)
    meta = tdf.prepare_key(port, "quantized_bins", {"max_bins": 32}, device="meta")
    assert meta != key and not cache.contains(meta)
    again, secs2, built2 = tdf.prepare_cached(port, "quantized_bins", {"max_bins": 32},
                                              cache=cache)
    assert again is got and not built2 and secs2 == 0.0
    assert cache.counters() == (1, 1)


def test_prepared_cache_dedups_concurrent_builds_and_honours_budget(higgs_small):
    train, _ = higgs_small
    port = _port(train)
    calls = []
    cache = tdf.PreparedDataCache()

    def builder():
        calls.append(1)
        return tdf.convert(port, "dense_rows")

    threads = [threading.Thread(target=cache.get, args=("k", builder)) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and cache.counters() == (5, 1)
    size = cache.bytes_cached
    cache.pin("k")
    cache.get("k2", builder)
    cache.set_budget(size)               # k pinned: k2 is the victim
    assert cache.contains("k") and not cache.contains("k2")
    cache.unpin("k")
    assert cache.tenant_counters()["-"]["misses"] == cache.misses


def test_sharded_placements_are_not_ported_yet():
    """(Named for the slice that had not ported them.) Sharded placements
    and payloads now exist: a 2-shard placement is a key, one shard is
    refused, and a 2-shard payload stacks the rows in two zero-padded
    blocks on the payload's device."""
    assert tdf.ShardedPlacement(2) == tdf.ShardedPlacement(2)
    with pytest.raises(ValueError):
        tdf.ShardedPlacement(1)
    payload = {"y": torch.arange(3, dtype=torch.float32)}
    assert tdf.shard_payload(payload, 1) == payload
    sh = tdf.shard_payload(payload, 2)
    assert torch.equal(sh["y"], torch.tensor([[0.0, 1.0], [2.0, 0.0]]))
    assert torch.equal(sh["_shard_valid"], torch.tensor([[True, True], [True, False]]))
    assert (sh["_n_shards"], sh["_n_rows"]) == (2, 3)


def test_default_device_needs_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        set_default_device(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            default_device()
        with pytest.raises(RuntimeError):
            default_device("cuda")
        assert default_device("cpu") == torch.device("cpu")
        set_default_device("cpu")
        assert default_device() == torch.device("cpu")
    finally:
        set_default_device("cpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(p.relative_to(ROOT)), name) for p in files for name in _imports(p)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert repro_torch.__name__ == "repro_torch"
