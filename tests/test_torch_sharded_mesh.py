"""The one-rank-per-shard lowering of ``compat.sharded_call`` and
checkpoints across layouts, on process groups of CPU ranks (gloo).

The JAX package's ``sharded`` lane (``tests/test_sharded.py``), each group
of ranks spawned in child processes by ``launch.mesh.run_local_ranks``
(never in the pytest process) with a timeout:

* ``psum_tree`` over 8 ranks equals the numpy mean, and the stacked
  one-process ``psum_tree`` bit for bit;
* ``sharded_call`` over a mesh axis of 8 ranks is bit-equal to the stacked
  lowering (both add the shards in shard order);
* the GBDT tree of the row-sharded data plane (``build_tree`` with its
  level histograms, smaller-child counts and leaf sums psum'd over the
  shard axis) is bit-equal on 4 ranks to the stacked lowering's.

And ``Trainer`` checkpoints moved between layouts, in float32 compute:
a 2 × 2 run saved at step 3 resumes on one device with the losses of the
uninterrupted 2 × 2 run, and a one-device checkpoint resumes on the 2 × 2
mesh with the uninterrupted one-device run's losses (each within 1e-5
relative: the two layouts add some products in another order).
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import run_local_ranks  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
TIMEOUT = 120
RESUME_RTOL = 1e-5


def _ranks(code: str, n: int) -> str:
    head = ("import numpy as np, torch, torch.distributed as dist\n"
            "from repro_torch import set_default_device\n"
            "set_default_device('cpu')\n")
    tail = "\ndist.barrier()\ndist.destroy_process_group()\n"
    return run_local_ranks(head + code + tail, n, timeout=TIMEOUT, env=ENV)[0]


def _numbers(out: str, tag: str) -> list[float]:
    line = next(line for line in out.splitlines() if line.startswith(tag + " "))
    return [float(x) for x in re.findall(r"[-+0-9.e]+", line[len(tag):])]


@pytest.fixture(scope="module")
def group_8() -> str:
    """Rank 0's output of the two 8-rank cases, run in one group."""
    return _ranks("""
from repro_torch import compat
from repro_torch.compat import MeshAxis, ShardAxis
from repro_torch.distributed.collectives import psum_tree
from repro_torch.launch.mesh import compat_make_mesh

# psum_tree over a mesh axis of 8 ranks
mesh = compat_make_mesh((8,), ("shards",), device="cpu")
r0 = dist.get_rank() == 0
g = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32))
got = psum_tree({"g": g[dist.get_rank()]}, MeshAxis(mesh, "shards"))["g"]
stacked = psum_tree({"g": g}, ShardAxis("shards", 8))["g"]
if r0:
    print("PSUM_REL", float((got - g.mean(0)).abs().max()))
    print("PSUM_BITEQ", int(torch.equal(got, stacked)))

# sharded_call's two lowerings
x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 5, 3)).astype(np.float32))
def per_shard(axis, block):
    return axis.psum(block.sum(1)), axis.pmax(block.amax(1)), axis.psum(1)
spmd = compat.sharded_call(per_shard, n_shards=8, mesh=mesh)(x)
stacked = compat.sharded_call(per_shard, n_shards=8)(x)
if r0:
    print("CALL_BITEQ", int(all(torch.equal(a, b) for a, b in zip(spmd[:2], stacked[:2]))))
    print("CALL_COUNT", spmd[2], stacked[2])
    print("CALL_REL", float((spmd[0] - x.sum((0, 1))).abs().max()))
""", 8)


def test_psum_tree_over_8_ranks(group_8):
    assert _numbers(group_8, "PSUM_REL")[0] < 1e-6
    assert _numbers(group_8, "PSUM_BITEQ") == [1]


def test_sharded_call_mesh_lowering_is_bit_equal_to_the_stacked_one(group_8):
    assert _numbers(group_8, "CALL_BITEQ") == [1]
    assert _numbers(group_8, "CALL_COUNT") == [8, 8]
    assert _numbers(group_8, "CALL_REL")[0] < 1e-5


@pytest.fixture(scope="module")
def group_4(tmp_path_factory) -> tuple[str, Path]:
    """Rank 0's output of the three 4-rank cases, run in one group, and the
    directory the checkpoint cases wrote."""
    root = tmp_path_factory.mktemp("ckpt")
    out = _ranks(f"""
import dataclasses
from repro_torch import compat, configs
from repro_torch.data.pipeline import make_lm_stream
from repro_torch.launch.mesh import compat_make_mesh, make_test_mesh
from repro_torch.tabular.gbdt import build_tree
from repro_torch.train import Trainer, make_optimizer

# the GBDT tree of the row-sharded data plane, both lowerings
shards = compat_make_mesh((4,), ("shards",), device="cpu")
r0 = dist.get_rank() == 0
rng = np.random.default_rng(11)
S, RS, F, B = 4, 300, 5, 64
bins = torch.from_numpy(rng.integers(0, B, (S, RS, F)).astype(np.int32))
g = torch.from_numpy(rng.standard_normal((S, RS)).astype(np.float32))
h = torch.from_numpy(rng.uniform(0.1, 1.0, (S, RS)).astype(np.float32))
valid = torch.ones((S, RS), dtype=torch.bool)
valid[-1, -37:] = False
kw = dict(n_bins=B, max_depth=4, lam=1.0, gamma=0.0, min_child_weight=1.0)
def per_shard(axis, bins, g, h, valid):
    return build_tree(bins, g, h, axis_name=axis, row_valid=valid, **kw)
spmd = compat.sharded_call(per_shard, n_shards=S, mesh=shards)(bins, g, h, valid)
stacked = compat.sharded_call(per_shard, n_shards=S)(bins, g, h, valid)
if r0:
    print("LEAVES", len(spmd), len(stacked))
    print("SPLITS", int(len(spmd) == len(stacked)
                        and all(torch.equal(x, y) for x, y in zip(spmd, stacked))))

# Trainer checkpoints across layouts, float32
mesh = make_test_mesh(2, 2, device="cpu")
cfg = dataclasses.replace(configs.get_smoke_config("tinyllama_1_1b"), compute_dtype="float32")
def run(steps, mesh_, ckpt=None, every=3):
    s = make_lm_stream(8, 32, cfg.vocab, mesh=mesh_, device="cpu")
    tr = Trainer(cfg, make_optimizer("adamw", lr=3e-3), s, ckpt_dir=ckpt, ckpt_every=every,
                 mesh=mesh_, fsdp=True, zero1=True)
    m = tr.run(steps)
    s.close()
    return {{h["step"]: h["loss"] for h in m.history}}

# a 2 x 2 run saved at step 3, resumed on one device
run(3, mesh, {str(root / "mesh")!r})
whole = run(6, mesh)
if r0:
    resumed = run(6, None, {str(root / "mesh")!r}, every=100)
    print("M2D_STEPS", *sorted(resumed))
    print("M2D_RESUMED", *[resumed[s] for s in sorted(resumed)])
    print("M2D_WHOLE", *[whole[s] for s in sorted(resumed)])
    # a one-device run saved at step 3, for the mesh to resume
    run(3, None, {str(root / "one")!r})
dist.barrier()
resumed = run(6, mesh, {str(root / "one")!r}, every=100)
if r0:
    whole = run(6, None)
    print("D2M_STEPS", *sorted(resumed))
    print("D2M_RESUMED", *[resumed[s] for s in sorted(resumed)])
    print("D2M_WHOLE", *[whole[s] for s in sorted(resumed)])
""", 4)
    return out, root


def test_gbdt_sharded_tree_parity_on_4_ranks(group_4):
    out, _ = group_4
    n = _numbers(out, "LEAVES")
    assert n[0] == n[1] > 0
    assert _numbers(out, "SPLITS") == [1]


def test_mesh_checkpoint_resumes_on_one_device(group_4):
    out, root = group_4
    assert _numbers(out, "M2D_STEPS") == [3, 4, 5]
    for a, b in zip(_numbers(out, "M2D_RESUMED"), _numbers(out, "M2D_WHOLE"), strict=True):
        assert abs(a - b) <= RESUME_RTOL * abs(b)
    assert sorted(p.name for p in (root / "mesh").iterdir()) == ["ckpt-3.json", "ckpt-3.npz"]


def test_one_device_checkpoint_resumes_on_the_mesh(group_4):
    out, _ = group_4
    assert _numbers(out, "D2M_STEPS") == [3, 4, 5]
    for a, b in zip(_numbers(out, "D2M_RESUMED"), _numbers(out, "D2M_WHOLE"), strict=True):
        assert abs(a - b) <= RESUME_RTOL * abs(b)
