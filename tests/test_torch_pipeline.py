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
  batch that does not divide into M raises ``ValueError``;
* the backward, for the loss ``sum(y * c)`` that every rank computes:
  ``w``'s and ``x``'s gradients within 1e-5 of ``jax.grad`` of the JAX
  package's ``pipeline_apply`` on every rank; on the grid above, within
  1e-6 of autograd through the stages in order (bit-equal at M = 1: the
  microbatches' contributions are summed in another order only when there
  are several); DTensor leaves' gradients (``full_tensor()``) equal to the
  plain leaves'; the two-leaf dict; only ``x`` requiring grad; a second
  backward giving the same bits; a ``stage_fn`` whose only gradient is a
  tensor it closes over raises ``ValueError`` on every rank.
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
SEQ_GRAD_TOL = 1e-6

_JAX = """
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.launch.mesh import compat_make_mesh
from repro.distributed.pipeline import pipeline_apply
d = {dir!r}
w, x = np.load(d + "/w.npy"), np.load(d + "/x.npy")
mesh = compat_make_mesh(({S},), ("stage",))
fn = lambda p, h: jax.nn.gelu(h @ p["w"])
c = np.load(d + "/c.npy")
loss = lambda w, x: jnp.sum(pipeline_apply(fn, {{"w": w}}, x, mesh, n_microbatches={M}) * c)
with compat.set_mesh(mesh):
    y = pipeline_apply(fn, {{"w": jnp.asarray(w)}}, jnp.asarray(x), mesh, n_microbatches={M})
    gw, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
np.save(d + "/y_jax.npy", np.asarray(y))
np.save(d + "/gw_jax.npy", np.asarray(gw))
np.save(d + "/gx_jax.npy", np.asarray(gx))
"""

_RANKS = """
import json
import numpy as np, torch, torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, distribute_tensor
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

# the gradients of sum(run(params, x) * c) from fresh leaves of their
# values: params' leaves that require grad, in key order, then x if it does
def grads(run, params, x, c):
    p = {{k: v.detach().clone().requires_grad_(v.requires_grad) for k, v in params.items()}}
    xg = x.detach().clone().requires_grad_(x.requires_grad)
    (run(p, xg) * c).sum().backward()
    got = [p[k].grad for k in sorted(p) if p[k].requires_grad]
    return [g.full_tensor() if isinstance(g, DTensor) else g for g in got] + (
        [xg.grad] if x.requires_grad else [])

def compare(got, want):
    return dict(err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
                equal=all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
                n=len(got))

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

# the backward of the JAX package's case; a rerun; DTensor leaves; only x
c = torch.from_numpy(np.load(d + "/c.npy"))
pipe = lambda fn, n_mb, m=mesh: lambda p, h: pipeline_apply(fn, p, h, m, n_microbatches=n_mb)
wx = ({{"w": w.requires_grad_()}}, x.requires_grad_())
gw, gx = grads(pipe(gelu, {M}), *wx, c)
np.save(d + f"/gw_torch_{{rank}}.npy", gw.numpy())
np.save(d + f"/gx_torch_{{rank}}.npy", gx.numpy())
out["rerun"] = compare(grads(pipe(gelu, {M}), *wx, c), [gw, gx])
wdg = distribute_tensor(w.detach(), mesh, pl["w"]).requires_grad_()
out["dtensor_grad"] = compare(grads(pipe(gelu, {M}), {{"w": wdg}}, x, c), [gw, gx])
out["only_x"] = compare(grads(pipe(gelu, {M}), {{"w": w.detach()}}, x, c), [gx])
w.requires_grad_(False)
x.requires_grad_(False)

# S stages on a (4 / S, S) data x stage mesh, M microbatches
rng = np.random.default_rng(1)
for n_stages in (1, 2, 4):
    mesh2 = compat_make_mesh((4 // n_stages, n_stages), ("data", "stage"), device="cpu")
    params = {{"w": torch.from_numpy(rng.standard_normal((n_stages, {D}, {D}))
                                    .astype(np.float32) * 0.3)}}
    xs = torch.from_numpy(rng.standard_normal(({B}, {D})).astype(np.float32))
    cs = torch.from_numpy(rng.standard_normal(({B}, {D})).astype(np.float32))
    for n_mb in (1, 2, 8):
        got = pipeline_apply(gelu, params, xs, mesh2, n_microbatches=n_mb)
        out[f"grid {{n_stages}} {{n_mb}}"] = bool(torch.equal(
            got, sequential(gelu, params, xs, n_stages, n_mb)))
        px = ({{"w": params["w"].requires_grad_()}}, xs.requires_grad_())
        out[f"grad {{n_stages}} {{n_mb}}"] = compare(
            grads(pipe(gelu, n_mb, mesh2), *px, cs),
            grads(lambda p, h: sequential(gelu, p, h, n_stages, n_mb), *px, cs))
        params["w"].requires_grad_(False)
        xs.requires_grad_(False)
    pl2 = stage_params_sharding(mesh2, {{"a": params["w"], "b": {{"c": params["w"][:, 0]}}}})
    out[f"placements {{n_stages}}"] = [[repr(p) for p in pl2["a"]], [repr(p) for p in pl2["b"]["c"]]]

# a two-leaf params dict
two = {{"w": torch.from_numpy(rng.standard_normal(({S}, {D}, {D})).astype(np.float32) * 0.3),
        "b": torch.from_numpy(rng.standard_normal(({S}, {D})).astype(np.float32))}}
out["two_leaf"] = bool(torch.equal(pipeline_apply(affine, two, x, mesh, n_microbatches=2),
                                   sequential(affine, two, x, {S}, 2)))
two_g, xg = {{k: v.requires_grad_() for k, v in two.items()}}, x.detach().requires_grad_()
want = grads(lambda p, h: sequential(affine, p, h, {S}, 2), two_g, xg, c)
plain_g = grads(pipe(affine, 2), two_g, xg, c)
out["two_leaf_grad"] = compare(plain_g, want)
two_d = {{k: distribute_tensor(v.detach(), mesh, pl["w"]).requires_grad_() for k, v in two.items()}}
out["two_leaf_dtensor_grad"] = compare(grads(pipe(affine, 2), two_d, xg, c), plain_g)

# a stage_fn whose only gradient would be a tensor it closes over
shift = torch.ones({D}, requires_grad=True)
try:
    pipeline_apply(lambda p, h: gelu(p, h) + shift, {{"w": w}}, x, mesh, n_microbatches={M})
    out["closure_raises"] = None
except ValueError as e:
    out["closure_raises"] = str(e)

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
    np.save(d / "c.npy", rng.standard_normal((B, D)).astype(np.float32))
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
            "ranks": ranks,
            "grad_jax": [np.load(d / f"{n}_jax.npy") for n in ("gw", "gx")],
            "grad_torch": [[np.load(d / f"{n}_torch_{r}.npy") for n in ("gw", "gx")]
                           for r in range(4)]}


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


def test_pipeline_gradients_match_the_jax_package_on_every_rank(runs):
    """``jax.grad`` of the reference's ``pipeline_apply`` (its ``ppermute``
    ring, masked ``where``s and closing ``psum``) and ``backward()`` of the
    port's, for the same loss: ``w``'s and ``x``'s gradients on every rank."""
    gw_jax, gx_jax = runs["grad_jax"]
    for gw, gx in runs["grad_torch"]:
        assert gw.shape == (S, D, D) and gx.shape == (B, D)
        assert float(np.abs(gw - gw_jax).max()) < JAX_TOL
        assert float(np.abs(gx - gx_jax).max()) < JAX_TOL


@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("n_mb", [1, 2, 8])
def test_pipeline_gradients_are_the_stages_in_order_on_every_rank(runs, n_stages, n_mb):
    for r in runs["ranks"]:
        got = r[f"grad {n_stages} {n_mb}"]
        assert got["n"] == 2 and got["err"] <= SEQ_GRAD_TOL, got
        assert got["equal"] or n_mb > 1, got


def test_dtensor_leaves_gradients_are_the_plain_leaves(runs):
    """The DTensor's gradient (each rank its stage's block) gathered with
    ``full_tensor()`` equals the plain leaf's, summed over the stages."""
    for r in runs["ranks"]:
        assert r["dtensor_grad"] == {"err": 0.0, "equal": True, "n": 2}
        assert r["two_leaf_dtensor_grad"] == {"err": 0.0, "equal": True, "n": 3}


def test_two_leaf_gradients(runs):
    for r in runs["ranks"]:
        got = r["two_leaf_grad"]
        assert got["n"] == 3 and got["err"] <= SEQ_GRAD_TOL, got


def test_only_x_requires_grad(runs):
    """No stage parameter requires grad: every rank still runs every hop's
    backward, and ``x``'s gradient is the one with the parameters'."""
    for r in runs["ranks"]:
        assert r["only_x"] == {"err": 0.0, "equal": True, "n": 1}


def test_a_second_backward_gives_the_same_bits(runs):
    for r in runs["ranks"]:
        assert r["rerun"] == {"err": 0.0, "equal": True, "n": 2}


def test_a_gradient_only_through_a_closed_over_tensor_raises(runs):
    for r in runs["ranks"]:
        assert r["closure_raises"] is not None
        assert "neither x nor a leaf of stage_params" in r["closure_raises"]
