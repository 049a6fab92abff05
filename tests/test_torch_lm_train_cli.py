"""The port's training launcher, its train_lm and multi-tenant examples, on
the CPU; and the kernels' gradient path in ``ops``. (The quickstart
example's three searches, 85 tasks on 4 executor threads, took 225 s
beside the other test files: too long for the suite; run it by hand.)

``ops.attention``/``rglru``/``rwkv6`` launch a CUDA kernel through ctypes,
which records no autograd graph, so when a gradient is needed they run it
inside ``_KernelGradByPlain``, whose backward differentiates the plain
version. Here the kernel is stood in for by the plain version run under
``torch.no_grad()`` (a launch that records nothing, as the card's does):
the gradients through the Function must equal the plain path's autograd
exactly, and its output must carry a ``grad_fn``. The card's own test of
the same is ``tests/test_torch_kernels_cuda.py``.
"""
import re

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro_torch import set_default_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

set_default_device("cpu")


def test_train_launcher_trains_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main

    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq-len", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "training tinyllama-smoke from step 0 on cpu" in out
    assert "nan_skips=0" in out and "step     3" in out
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == ["ckpt-2.npz", "ckpt-4.npz"]
    assert main(argv[:-4] + ["--steps", "5", "--ckpt-dir", str(tmp_path)]) == 0
    assert "from step 4" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--mesh", "2,1"], ["--dp-mode", "shard_map_int8"]])
def test_train_launcher_mesh_forms_not_ported(flags):
    """The mesh forms, once refused, now train: as the ranks of a gloo
    group in child processes (a mesh of 2 ranks for ``--mesh 2,1``, a 1 x 1
    mesh for ``--dp-mode shard_map_int8``). A mesh larger than the launch's
    ranks raises before any process group is made."""
    from pathlib import Path

    from repro_torch.launch.mesh import run_local_ranks
    from repro_torch.launch.train import main

    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq-len", "16", *flags]
    if flags[0] == "--mesh":
        with pytest.raises(RuntimeError, match="needs 2 ranks"):
            main(argv)
    n = 2 if flags[0] == "--mesh" else 1
    outs = run_local_ranks(f"from repro_torch.launch.train import main; main({argv!r})", n,
                           timeout=120, env={"PYTHONPATH": str(Path(__file__).resolve()
                                                               .parents[1] / "src"),
                                             "OMP_NUM_THREADS": "1"})
    assert "training qwen2-smoke from step 0 on mesh" in outs[0], outs[0][-2000:]
    assert "done: final loss" in outs[0] and "nan_skips=0" in outs[0]
    assert all("done" not in o for o in outs[1:])          # rank 0 prints


def test_train_lm_example_lowers_the_loss(capsys, tmp_path):
    from repro_torch.examples.train_lm import main

    assert main(["--device", "cpu", "--steps", "12", "--batch", "4", "--seq-len", "32",
                 "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    last, first = map(float, re.search(r"final loss (\S+) \(from (\S+)\)", out).groups())
    assert last < first - 0.05, out


def test_multi_tenant_example_runs_on_the_cpu(capsys):
    from repro_torch.examples.multi_tenant_search import main

    assert main(["--device", "cpu", "--rows", "800"]) == 0
    assert "multi-tenant search OK" in capsys.readouterr().out


def _no_graph(fn):
    """``fn`` as a launch that records no autograd graph."""
    def launch(*args):
        with torch.no_grad():
            return fn(*args)
    return launch


def _inputs(shapes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [None if s is None else torch.randn(s, generator=gen, dtype=torch.float64)
            .requires_grad_() for s in shapes]


CASES = {
    "attention": (lambda q, k, v: ref.attention_ref(q, k, v, causal=True, window=5),
                  [(2, 4, 9, 8), (2, 2, 9, 8), (2, 2, 9, 8)]),
    "rglru": (lambda x, i, r, a, h0: ref.rglru_ref(x, i, r, a, h0),
              [(2, 7, 6), (2, 7, 6), (2, 7, 6), (6,), (2, 6)]),
    "rglru_no_h0": (lambda x, i, r, a, h0: ref.rglru_ref(x, i, r, a, h0),
                    [(2, 7, 6), (2, 7, 6), (2, 7, 6), (6,), None]),
    "rwkv6": (ref.rwkv6_ref, [(1, 2, 6, 4), (1, 2, 6, 4), (1, 2, 6, 3), (1, 2, 6, 4),
                              (2, 4), (1, 2, 4, 3)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_gradients_go_through_the_plain_version(name):
    plain, shapes = CASES[name]
    xs = _inputs(shapes)
    out = ops._launch(_no_graph(plain), plain, *xs)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.grad_fn is not None for o in outs)
    want_outs = plain(*xs)
    want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
    for o, w in zip(outs, want_outs):
        assert torch.equal(o, w.detach())
    weights = [torch.randn(o.shape, dtype=o.dtype, generator=torch.Generator().manual_seed(1))
               for o in outs]
    live = [x for x in xs if x is not None]
    got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, weights)), live)
    want = torch.autograd.grad(sum((o * w).sum() for o, w in zip(want_outs, weights)), live)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_launch_without_grad_is_the_bare_kernel():
    plain, shapes = CASES["attention"]
    xs = [x.detach() for x in _inputs(shapes)]
    out = ops._launch(_no_graph(plain), plain, *xs)
    assert out.grad_fn is None and not out.requires_grad
    with torch.no_grad():
        out = ops._launch(_no_graph(plain), plain, *_inputs(shapes))
    assert out.grad_fn is None


def test_ops_on_the_cpu_differentiate_the_plain_path():
    q, k, v = _inputs(CASES["attention"][1])
    out = ops.attention(q, k, v)
    assert out.grad_fn is not None
    y, h = ops.rwkv6(*_inputs(CASES["rwkv6"][1]))
    assert y.grad_fn is not None and h.grad_fn is not None
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.attention_ref(q, k, v).detach().numpy())
