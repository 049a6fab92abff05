"""The LM's mesh forms on process groups of CPU ranks (gloo).

Four of the JAX package's multi-device tests (``tests/test_distributed.py``;
its pipeline test waits with ``distributed/pipeline.py``), each group of
ranks spawned in child processes by ``launch.mesh.run_local_ranks`` (never
in the pytest process), with a timeout so that a hung rendezvous fails:

* the int8-compressed all-reduce over 8 ranks (``compressed_psum`` over a
  ``MeshAxis``): within 2 % of the true mean, the error-feedback residual
  under 0.1, and equal to the stacked one-process ``compressed_psum``
  within 1e-6;
* the FSDP + ZeRO-1 ``Trainer`` on a 2 × 2 mesh: the last of 10 steps'
  losses below the first (bf16 compute), and, in float32 compute, each of
  the first 5 losses within 1e-4 relative of the mesh-less port's (in bf16
  the row-parallel products' partial sums are rounded to bf16 before their
  all-reduce, which moves a loss by ~1e-4 relative on its own);
* ``dp_mode="shard_map_int8"`` on the 2 × 2 mesh: the last of 8 losses
  below the first;
* the sharded ``ServeEngine`` on gemma_2b's smoke config (one KV head, so
  its cache is sharded on the sequence over ``model``): 16 tokens, equal
  to the mesh-less engine's.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import run_local_ranks  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ENV = {"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1", "PYTHONHASHSEED": "0"}
TIMEOUT = 120


def _ranks(code: str, n: int) -> str:
    """Rank 0's output of ``code`` run as ``n`` gloo ranks."""
    head = ("import numpy as np, torch, torch.distributed as dist\n"
            "from repro_torch import set_default_device\n"
            "set_default_device('cpu')\n")
    tail = "\ndist.barrier()\ndist.destroy_process_group()\n"
    return run_local_ranks(head + code + tail, n, timeout=TIMEOUT, env=ENV)[0]


def _numbers(out: str, tag: str) -> list[float]:
    line = next(line for line in out.splitlines() if line.startswith(tag + " "))
    return [float(x) for x in re.findall(r"[-+0-9.e]+(?:nan|inf)?", line[len(tag):])]


def test_int8_compressed_allreduce_over_8_ranks():
    out = _ranks("""
from repro_torch.compat import MeshAxis, ShardAxis
from repro_torch.distributed.collectives import compressed_psum
from repro_torch.launch.mesh import compat_make_mesh
mesh = compat_make_mesh((8,), ("dp",), device="cpu")
g = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32))
r = dist.get_rank()
mean, res = compressed_psum({"g": g[r]}, MeshAxis(mesh, "dp"))
smean, sres = compressed_psum({"g": g}, ShardAxis("dp", 8))
true = g.mean(0)
rel = float((mean["g"] - true).abs().max() / true.abs().max())
resid = float(torch.stack([torch.as_tensor(x) for x in [res["g"]]]).abs().max())
gap = max(float((mean["g"] - smean["g"]).abs().max()), float((res["g"] - sres["g"][r]).abs().max()))
all_resid = [torch.zeros(64) for _ in range(8)]
dist.all_gather(all_resid, res["g"])
if r == 0:
    print("REL", rel)
    print("RESID", float(torch.stack(all_resid).abs().max()))
    print("GAP", gap)
""", 8)
    assert _numbers(out, "REL")[0] < 0.02
    assert _numbers(out, "RESID")[0] < 0.1
    assert _numbers(out, "GAP")[0] <= 1e-6


@pytest.fixture(scope="module")
def group_2x2() -> str:
    """Rank 0's output of the three 2 x 2 cases, run in one group of 4."""
    return _ranks("""
import dataclasses
from repro_torch import configs
from repro_torch.data.pipeline import make_lm_stream
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import Trainer, make_optimizer
mesh = make_test_mesh(2, 2, device="cpu")
r0 = dist.get_rank() == 0

# the FSDP + ZeRO-1 Trainer, bf16, and float32 against one device
cfg = configs.get_smoke_config("tinyllama_1_1b")
stream = make_lm_stream(8, 32, cfg.vocab, mesh=mesh)
m = Trainer(cfg, make_optimizer("adamw", lr=3e-3), stream, mesh=mesh, fsdp=True,
            zero1=True).run(10)
stream.close()
f32 = dataclasses.replace(cfg, compute_dtype="float32")
runs = []
for mesh_ in (mesh, None):
    s = make_lm_stream(8, 32, cfg.vocab, mesh=mesh_, device="cpu")
    runs.append(Trainer(f32, make_optimizer("adamw", lr=3e-3), s, mesh=mesh_, fsdp=True,
                        zero1=True).run(5))
    s.close()
if r0:
    print("BF16", *[h["loss"] for h in m.history])
    print("MESH", *[h["loss"] for h in runs[0].history])
    print("LOCAL", *[h["loss"] for h in runs[1].history])

# shard_map_int8
cfg = configs.get_smoke_config("qwen2_1_5b")
stream = make_lm_stream(8, 32, cfg.vocab, mesh=mesh)
m = Trainer(cfg, make_optimizer("adamw", lr=3e-3), stream, mesh=mesh,
            dp_mode="shard_map_int8").run(8)
stream.close()
if r0:
    print("INT8", *[h["loss"] for h in m.history])

# the sharded ServeEngine
cfg = configs.get_smoke_config("gemma_2b")
params = init_params(cfg, seed=0, device="cpu")
def wave():
    return [Request(i, np.arange(1, 5 + i, dtype=np.int32), max_new_tokens=4)
            for i in range(4)]
done = ServeEngine(cfg, params, batch_size=4, max_len=64, mesh=mesh).serve(wave())
ref = ServeEngine(cfg, params, batch_size=4, max_len=64).serve(wave())
if r0:
    print("TOKENS", sum(len(r.output) for r in done))
    print("EQUAL", int([r.output for r in done] == [r.output for r in ref]))
""", 4)


def test_fsdp_zero1_trainer_on_a_2x2_mesh(group_2x2):
    bf16 = _numbers(group_2x2, "BF16")
    assert len(bf16) == 10 and bf16[-1] < bf16[0], bf16
    mesh, local = _numbers(group_2x2, "MESH"), _numbers(group_2x2, "LOCAL")
    assert len(mesh) == len(local) == 5
    for a, b in zip(mesh, local):
        assert abs(a - b) <= 1e-4 * abs(b), (mesh, local)


def test_shard_map_int8_dp_mode_on_a_2x2_mesh(group_2x2):
    losses = _numbers(group_2x2, "INT8")
    assert len(losses) == 8 and losses[-1] < losses[0], losses


def test_sharded_serve_engine_gemma_2b_smoke(group_2x2):
    assert _numbers(group_2x2, "TOKENS") == [16]
    assert _numbers(group_2x2, "EQUAL") == [1]
