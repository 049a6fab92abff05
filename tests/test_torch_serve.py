"""The port's serving path against the JAX package's, and the port's imports.

``ServeEngine`` of the port and of the JAX package (on a 1×1 CPU mesh) serve
the same wave of ragged requests with the same weights (the JAX package's,
carried by ``params_from_reference``), a float32 cache and float32 compute:
they must give the same greedy tokens. The launcher runs on the CPU when it
is asked for. The port and ``chip_smoke.py`` must not import JAX or the JAX
package, which a subprocess checks.
"""
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs, set_default_device  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

set_default_device("cpu")

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LENS = (5, 11, 3)
NEW_TOKENS = (6, 4, 7)


def _wave(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, vocab, size=n).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPT_LENS, NEW_TOKENS))]


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "rwkv6_7b"])
def test_serve_matches_reference_engine(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype="float32")
    jparams = jmodels.init_params(jcfg, jax.random.key(0))
    params = params_from_reference(cfg, jax.tree.map(np.asarray, jparams))
    jengine = JServeEngine(jcfg, jparams, make_test_mesh(1, 1), batch_size=4, max_len=32,
                           cache_dtype=jnp.float32)
    engine = ServeEngine(cfg, params, batch_size=4, max_len=32, cache_dtype=torch.float32)
    want = [r.output for r in jengine.serve(_wave(JRequest, cfg.vocab))]
    got = [r.output for r in engine.serve(_wave(Request, cfg.vocab))]
    assert [len(o) for o in got] == list(NEW_TOKENS)
    assert got == want
    st = engine.last_stats
    assert st.prompt_len == max(PROMPT_LENS) and st.decode_steps == max(NEW_TOKENS) - 1
    assert st.decode_tokens == sum(NEW_TOKENS) - len(NEW_TOKENS)
    # the same wave again: the same tokens
    assert [r.output for r in engine.serve(_wave(Request, cfg.vocab))] == got


def test_serve_stops_at_max_len_and_checks_the_wave():
    cfg = configs.get_smoke_config("rwkv6_7b")
    from repro_torch.models import init_params

    engine = ServeEngine(cfg, init_params(cfg, seed=1), batch_size=2, max_len=12)
    reqs = engine.serve([Request(0, np.arange(10, dtype=np.int32), max_new_tokens=8)])
    assert len(reqs[0].output) == 3          # positions 10 and 11, then max_len
    with pytest.raises(ValueError, match="batch_size"):
        engine.serve([Request(i, np.ones(2, np.int32)) for i in range(3)])
    with pytest.raises(ValueError, match="max_len"):
        engine.serve([Request(0, np.ones(13, np.int32))])


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
                 "--requests", "3", "--new-tokens", "4", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of repro_torch, and chip_smoke.py's own imports, in a
    fresh interpreter: neither ``jax`` nor ``repro`` may be loaded."""
    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert {"repro_torch.kernels.flash_attention", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.tabular.forest",
            "repro_torch.launch.search"} <= set(names)
    code = (
        "import importlib, importlib.util, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")
