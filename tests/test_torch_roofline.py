"""The port's roofline analysis (``repro_torch.roofline``) on the CPU.

The JAX package's ``tests/test_roofline.py`` held to the port's
counterparts: ``model_flops`` and ``active_params`` equal the JAX
package's exactly for every architecture and shape, the parameter counts
too; the collective counter sees a known all-reduce and all-gather on a
``fake`` process group (in a child process: no group in the pytest
process) with their bytes per kind and per mesh axis; a 256³ matmul traces
to exactly 2·256³ FLOPs; and the three terms and the dominant one follow
the H100 datasheet constants.
"""
import jax
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import count_params as jcount_params  # noqa: E402
from repro.roofline.analysis import active_params as jactive_params  # noqa: E402
from repro.roofline.analysis import model_flops as jmodel_flops  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import run_local_ranks  # noqa: E402
from repro_torch.models import count_params, init_params  # noqa: E402
from repro_torch.roofline import HW_H100, active_params, analyze_traced, model_flops, \
    trace_step  # noqa: E402

del jax


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    n = count_params(init_params(cfg, device="meta"))
    assert n == jcount_params(jcfg)
    assert active_params(cfg, n) == jactive_params(jcfg, n)
    for name, shape in configs.SHAPES.items():
        assert model_flops(cfg, shape, n) == jmodel_flops(jcfg, jconfigs.SHAPES[name], n)
        assert model_flops(cfg, shape, n, active_params(cfg, n)) == \
            jmodel_flops(jcfg, jconfigs.SHAPES[name], n, jactive_params(jcfg, n))


def test_model_flops_conventions_and_moe_active_params():
    cfg = configs.get_config("tinyllama_1_1b")
    n = count_params(init_params(cfg, device="meta"))
    assert model_flops(cfg, configs.SHAPES["train_4k"], n) == 6.0 * n * 4096 * 256
    assert model_flops(cfg, configs.SHAPES["decode_32k"], n) == 2.0 * n * 128
    moe = configs.get_config("qwen3_moe_235b")
    act = active_params(moe, count_params(init_params(moe, device="meta")))
    assert 18e9 < act < 26e9, act / 1e9            # "A22B"
    assert active_params(configs.get_config("qwen2_1_5b"), 100) == 100


def test_matmul_flops_and_the_three_terms():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    counts = trace_step(lambda a, b: a @ b, (a, b), None, track_memory=False)
    assert counts["flops"] == 2 * 256 ** 3
    assert counts["collective_bytes"]["total"] == 0
    assert counts["argument_bytes"] == 2 * 256 * 256 * 4
    assert counts["bytes"] == 3 * 256 * 256 * 4      # two operands read, one written
    rep = analyze_traced(counts, arch="toy", shape=configs.SHAPES["train_4k"],
                         mesh_desc="1", n_devices=1)
    assert rep.flops_per_device == 2 * 256 ** 3
    assert rep.compute_s == 2 * 256 ** 3 / HW_H100["peak_flops"]
    assert rep.memory_s == 3 * 256 * 256 * 4 / HW_H100["hbm_bw"]
    assert rep.dominant in ("compute", "memory", "collective")
    assert rep.step_time_s == max(rep.compute_s, rep.memory_s, rep.collective_s)
    assert HW_H100["peak_flops"] == 989e12 and HW_H100["hbm_bw"] == 3.35e12


def test_collective_counter_sees_a_fake_all_reduce_and_all_gather():
    out = run_local_ranks("""
import torch
import torch.distributed._functional_collectives as funcol
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.roofline import analyze_traced, trace_step
from repro_torch import configs
fake_process_group(8)
mesh = compat_make_mesh((2, 4), ("data", "model"), device="cpu")
x = torch.ones(16, 128)
y = torch.ones(4, 256, dtype=torch.bfloat16)
def step(x, y):
    funcol.all_reduce(x, "sum", mesh["data"]).wait()
    funcol.all_gather_tensor(y, 0, mesh["model"]).wait()
c = trace_step(step, (x, y), mesh, track_memory=False)
rep = analyze_traced(c, arch="toy", shape=configs.SHAPES["train_4k"], mesh_desc="2x4",
                     n_devices=8)
print("AR", c["collective_bytes"]["all-reduce"], "AG", c["collective_bytes"]["all-gather"])
print("AXES", c["collective_by_axis"]["data"], c["collective_by_axis"]["model"])
print("TERM", rep.collective_s, 16 * 128 * 4 / 50e9 + 4 * 256 * 2 / 900e9)
""", 1, timeout=120, env={"PYTHONPATH": str(__import__("pathlib").Path(__file__)
                                          .resolve().parents[1] / "src")})[0]
    line = next(l for l in out.splitlines() if l.startswith("AR "))
    assert line.split() == ["AR", str(16 * 128 * 4), "AG", str(4 * 256 * 2)]
    axes = next(l for l in out.splitlines() if l.startswith("AXES ")).split()[1:]
    assert axes == [str(16 * 128 * 4), str(4 * 256 * 2)]
    got, want = map(float, next(l for l in out.splitlines() if l.startswith("TERM ")).split()[1:])
    assert got == pytest.approx(want, rel=1e-12)
