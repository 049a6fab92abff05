"""The dry-run machinery on SMALL fake meshes (``launch.dryrun.run_cell``).

The JAX package's ``tests/test_dryrun_small.py``: four representative
cells traced on a fake (2, 4) ``("data", "model")`` mesh, and TinyLlama's
train cell on the (2, 2, 2) ``("pod", "data", "model")`` mesh, in the
scan form (one repeat of the layer pattern), with the reference's
assertions: a dominant term, FLOPs > 0, collective bytes > 0 (a sharded
step communicates), the pod mesh described as ``2x2x2`` over 8 ranks.
The cells run in two child processes, which make the ``fake`` process
group (never the pytest process). The full 32 × 8 / 2 × 32 × 8 sweeps run through
``python -m repro_torch.launch.dryrun``.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import run_local_ranks  # noqa: E402

ENV = {"PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src"), "OMP_NUM_THREADS": "2"}


CELLS = [("qwen2_1_5b", "train_4k"), ("rwkv6_7b", "decode_32k"),
         ("qwen3_moe_235b", "train_4k"), ("whisper_medium", "prefill_32k")]


def _traced(cells, pod: bool) -> dict:
    """The reports of ``cells`` on a (2, 4) mesh (and, with ``pod``,
    TinyLlama's train cell on the (2, 2, 2) mesh) from one child process,
    which makes a ``fake`` group of 8 ranks."""
    code = f"""
import json
from repro_torch.launch.dryrun import fake_process_group, run_cell
from repro_torch.launch.mesh import compat_make_mesh
fake_process_group(8)
mesh = compat_make_mesh((2, 4), ("data", "model"), device="cpu")
for arch, shape in {list(cells)!r}:
    rep, secs = run_cell(arch, shape, mesh=mesh, scan=True, verbose=False)
    print("REPORT", json.dumps({{"cell": [arch, shape], "dominant": rep.dominant,
                                "flops": rep.flops_per_device,
                                "coll": rep.collective_bytes["total"], "mesh": rep.mesh,
                                "args": rep.memory_stats["argument_size_in_bytes"]}}))
if {pod!r}:
    pod = compat_make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    rep, _ = run_cell("tinyllama_1_1b", "train_4k", mesh=pod, scan=True, verbose=False)
    print("POD", json.dumps({{"mesh": rep.mesh, "n": rep.n_devices,
                             "axes": sorted(rep.collective_by_axis)}}))
"""
    out = run_local_ranks(code, 1, timeout=120, env=ENV)[0]
    got = {}
    for line in out.splitlines():
        if line.startswith("REPORT "):
            rep = json.loads(line[7:])
            got[tuple(rep["cell"])] = rep
        elif line.startswith("POD "):
            got["pod"] = json.loads(line[4:])
    return got


@pytest.fixture(scope="module")
def reports():
    """Every cell's report, from two child processes of a few cells each."""
    return {**_traced(CELLS[:2], pod=True), **_traced(CELLS[2:], pod=False)}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_traces_on_small_mesh(reports, arch, shape):
    rep = reports[(arch, shape)]
    assert rep["dominant"] in ("compute", "memory", "collective")
    assert rep["flops"] > 0
    assert rep["coll"] > 0          # sharded step must communicate
    assert rep["mesh"] == "2x4" and rep["args"] > 0


def test_multipod_mesh_small(reports):
    """pod axis shards: the same cell traces on a (2, 2, 2) pod mesh."""
    pod = reports["pod"]
    assert (pod["mesh"], pod["n"]) == ("2x2x2", 8)
    assert "pod_data" in pod["axes"]
