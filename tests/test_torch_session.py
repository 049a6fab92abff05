"""One search, run by both packages: the same GBDT grid on ``higgs_small``
through the JAX package's ``Session`` and the port's.

Task keys and their order must match and every task must succeed; each
config's validation AUC must be within ``AUC_TOL`` of JAX's (trained models
differ only through near-tie splits, see ``test_torch_gbdt.py``).
"""
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
pytest.importorskip("torch")

import repro.tabular  # noqa: F401,E402  (registers the JAX estimators)
import repro_torch.tabular  # noqa: F401,E402  (registers the port's gbdt)
from repro.core import GridBuilder as JGridBuilder  # noqa: E402
from repro.core import SearchSpec as JSearchSpec  # noqa: E402
from repro.core import Session as JSession  # noqa: E402
from repro_torch import set_default_device  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DenseMatrix,
    GridBuilder,
    LocalExecutorPool,
    SamplingProfiler,
    SearchSpec,
    Session,
)
from repro_torch.core.data_format import ShardedPlacement  # noqa: E402

set_default_device("cpu")

AUC_TOL = 5e-3
GRID = {"eta": [0.1, 0.3], "max_bin": [16, 32], "round": [8], "max_depth": [4]}


def _space(builder_cls):
    b = builder_cls("gbdt")
    for k, v in GRID.items():
        b.add_grid(k, v)
    return b.build()


def _port(dm):
    return DenseMatrix(dm.x, dm.y, dm.feature_names)


def _scores(results):
    return {r.task.key(): r.score for r in results}


@pytest.fixture(scope="module")
def jax_results(higgs_small):
    train, valid = higgs_small
    spec = JSearchSpec(spaces=[_space(JGridBuilder)], n_executors=2, policy="round_robin")
    return list(JSession(spec).results(train, valid))


def test_session_matches_reference(higgs_small, jax_results):
    train, valid = higgs_small
    spec = SearchSpec(spaces=[_space(GridBuilder)], n_executors=2, policy="round_robin")
    session = Session(spec)
    results = list(session.results(_port(train), _port(valid)))
    assert all(r.ok for r in results) and all(r.ok for r in jax_results)
    assert sorted(r.task.key() for r in results) == sorted(r.task.key() for r in jax_results)
    assert [r.task.task_id for r in sorted(results, key=lambda r: r.task.task_id)] == \
        list(range(len(jax_results)))
    want, got = _scores(jax_results), _scores(results)
    gaps = {k: abs(got[k] - want[k]) for k in want}
    assert max(gaps.values()) <= AUC_TOL, gaps
    assert session.stats.prepared_cache_misses >= 1
    best = session.multi_model().best(_port(valid))
    assert best.score == pytest.approx(max(got.values()))


@pytest.mark.parametrize("options", [
    {"policy": "lpt", "profiler": SamplingProfiler(0.05)},
    {"policy": "lpt", "fuse": True},
    {"policy": "dynamic"},
])
def test_port_session_paths_agree(higgs_small, options):
    """Profiled LPT (the chip smoke's setup), fused batches and dynamic
    queues all train the same deterministic models as round robin."""
    train, valid = higgs_small
    base = list(Session(SearchSpec(spaces=[_space(GridBuilder)], n_executors=2,
                                   policy="round_robin")).results(_port(train), _port(valid)))
    other = list(Session(SearchSpec(spaces=[_space(GridBuilder)], n_executors=2,
                                    **options)).results(_port(train), _port(valid)))
    assert all(r.ok for r in other)
    a, b = _scores(base), _scores(other)
    assert a.keys() == b.keys()
    assert all(np.isclose(a[k], b[k], rtol=0, atol=1e-12) for k in a), (a, b)


def test_sharded_pool_is_not_ported_yet():
    """(Named for the slice that had not ported it.) A 2-shard pool now
    resolves its conversions under one sharded placement."""
    pool = LocalExecutorPool(2, n_shards=2)
    (token,) = pool.prepare_placements()
    assert isinstance(token, ShardedPlacement) and token.n_shards == 2
