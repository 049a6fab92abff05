"""GPipe pipeline parallelism (``distributed/pipeline.py``) on process
groups of CPU ranks (gloo), against the JAX package's ``pipeline_apply``.

One group of 4 ranks, spawned in child processes by
``launch.mesh.run_local_ranks`` (never in the pytest process) with a
timeout, runs every multi-rank case; the JAX side runs in a subprocess
with 4 fake host devices. The cases:

* the JAX package's pipeline test (``tests/test_distributed.py``): S = 4
  stages of ``gelu(h @ w)`` (the tanh form, ``jax.nn.gelu``'s default), B =
  8, D = 16, M = 4, on the same numpy-made w and x, within 1e-5 of the JAX
  package's ``pipeline_apply``, the reference test's own tolerance;
* S ∈ {1, 2, 4} stages (on a (4 / S, S) data × stage mesh) × M ∈ {1, 2, 8}
  microbatches: bit-equal to the stages applied in order to each
  microbatch, on every rank;
* DTensor leaves placed by ``stage_params_sharding`` (each rank holding
  its own stage) give the plain leaves' bits; a two-leaf params dict; a
  batch that does not divide into M raises ``ValueError``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed.pipeline import bubble_fraction as ref_bubble_fraction  # noqa: E402
from repro_torch.distributed.pipeline import bubble_fraction  # noqa: E402
from repro_torch.launch.mesh import run_local_ranks  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
TIMEOUT = 120
S, B, D, M = 4, 8, 16, 4
JAX_TOL = 1e-5

_JAX = """
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.launch.mesh import compat_make_mesh
from repro.distributed.pipeline import pipeline_apply
d = {dir!r}
w, x = np.load(d + "/w.npy"), np.load(d + "/x.npy")
mesh = compat_make_mesh(({S},), ("stage",))
fn = lambda p, h: jax.nn.gelu(h @ p["w"])
with compat.set_mesh(mesh):
    y = pipeline_apply(fn, {{"w": jnp.asarray(w)}}, jnp.asarray(x), mesh, n_microbatches={M})
np.save(d + "/y_jax.npy", np.asarray(y))
"""

_RANKS = """
import json
import numpy as np, torch, torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import distribute_tensor
from repro_torch import set_default_device
set_default_device("cpu")
from repro_torch.distributed.pipeline import pipeline_apply, stage_params_sharding
from repro_torch.launch.mesh import compat_make_mesh

d = {dir!r}
out = {{}}
gelu = lambda p, h: F.gelu(h @ p["w"], approximate="tanh")
affine = lambda p, h: F.gelu(h @ p["w"] + p["b"], approximate="tanh")

def sequential(fn, params, x, n_stages, n_mb):
    outs = []
    for xm in x.reshape((n_mb, -1) + tuple(x.shape[1:])):
        for s in range(n_stages):
            xm = fn({{k: v[s] for k, v in params.items()}}, xm)
        outs.append(xm)
    return torch.cat(outs)

# the JAX package's case, on a stage axis of 4 ranks
mesh = compat_make_mesh(({S},), ("stage",), device="cpu")
rank = dist.get_rank()
w, x = (torch.from_numpy(np.load(d + f"/{{n}}.npy")) for n in ("w", "x"))
y = pipeline_apply(gelu, {{"w": w}}, x, mesh, n_microbatches={M})
if rank == 0:
    np.save(d + "/y_torch.npy", y.numpy())
pl = stage_params_sharding(mesh, {{"w": w}})
wd = distribute_tensor(w, mesh, pl["w"])
out["dtensor"] = dict(equal=bool(torch.equal(
    pipeline_apply(gelu, {{"w": wd}}, x, mesh, n_microbatches={M}), y)),
    local_shape=list(wd.to_local().shape))

# S stages on a (4 / S, S) data x stage mesh, M microbatches
rng = np.random.default_rng(1)
for n_stages in (1, 2, 4):
    mesh2 = compat_make_mesh((4 // n_stages, n_stages), ("data", "stage"), device="cpu")
    params = {{"w": torch.from_numpy(rng.standard_normal((n_stages, {D}, {D}))
                                    .astype(np.float32) * 0.3)}}
    xs = torch.from_numpy(rng.standard_normal(({B}, {D})).astype(np.float32))
    for n_mb in (1, 2, 8):
        got = pipeline_apply(gelu, params, xs, mesh2, n_microbatches=n_mb)
        out[f"grid {{n_stages}} {{n_mb}}"] = bool(torch.equal(
            got, sequential(gelu, params, xs, n_stages, n_mb)))
    pl2 = stage_params_sharding(mesh2, {{"a": params["w"], "b": {{"c": params["w"][:, 0]}}}})
    out[f"placements {{n_stages}}"] = [[repr(p) for p in pl2["a"]], [repr(p) for p in pl2["b"]["c"]]]

# a two-leaf params dict
two = {{"w": torch.from_numpy(rng.standard_normal(({S}, {D}, {D})).astype(np.float32) * 0.3),
        "b": torch.from_numpy(rng.standard_normal(({S}, {D})).astype(np.float32))}}
out["two_leaf"] = bool(torch.equal(pipeline_apply(affine, two, x, mesh, n_microbatches=2),
                                   sequential(affine, two, x, {S}, 2)))

# a batch that does not divide into the microbatches
try:
    pipeline_apply(gelu, {{"w": w}}, x, mesh, n_microbatches=3)
    out["raises"] = None
except ValueError as e:
    out["raises"] = str(e)
print("OUT " + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The JAX package's output and every rank's results, on the same w, x."""
    d = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    np.save(d / "w.npy", (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32))
    np.save(d / "x.npy", rng.standard_normal((B, D)).astype(np.float32))
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={S}"}
    res = subprocess.run([sys.executable, "-c", _JAX.format(dir=str(d), S=S, M=M)],
                         capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    texts = run_local_ranks(_RANKS.format(dir=str(d), S=S, B=B, D=D, M=M), 4,
                            timeout=TIMEOUT, env=ENV)
    ranks = [json.loads(next(line[4:] for line in t.splitlines() if line.startswith("OUT ")))
             for t in texts]
    return {"jax": np.load(d / "y_jax.npy"), "torch": np.load(d / "y_torch.npy"),
            "ranks": ranks}


def test_pipeline_matches_the_jax_package(runs):
    err = float(np.abs(runs["torch"] - runs["jax"]).max())
    assert runs["torch"].shape == (B, D)
    assert err < JAX_TOL, err


@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("n_mb", [1, 2, 8])
def test_pipeline_is_the_stages_in_order_on_every_rank(runs, n_stages, n_mb):
    assert all(r[f"grid {n_stages} {n_mb}"] for r in runs["ranks"])


def test_dtensor_leaves_hold_one_stage_and_give_the_same_bits(runs):
    for r in runs["ranks"]:
        assert r["dtensor"] == {"equal": True, "local_shape": [1, D, D]}


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_stage_params_sharding_shards_dim_0_over_stage(runs, n_stages):
    """Every leaf of a nested tree: dim 0 sharded over ``stage``, replicated
    over ``data`` (the reference's ``P("stage", None, ...)``)."""
    want = ["Replicate()", "Shard(dim=0)"]
    for r in runs["ranks"]:
        assert r[f"placements {n_stages}"] == [want, want]


def test_two_leaf_params(runs):
    assert all(r["two_leaf"] for r in runs["ranks"])


def test_batch_not_divisible_into_microbatches_raises(runs):
    for r in runs["ranks"]:
        assert r["raises"] is not None and "not divisible into 3 microbatches" in r["raises"]


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
def test_bubble_fraction_is_the_reference(n_stages):
    for n_mb in (1, 2, 3, 4, 8, 16):
        assert bubble_fraction(n_stages, n_mb) == ref_bubble_fraction(n_stages, n_mb)
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(2, 4) == 0.2
