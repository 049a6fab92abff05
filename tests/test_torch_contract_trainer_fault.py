"""The JAX package's ``tests/test_trainer_fault.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch``, on the CPU: the
port's ``Trainer`` takes a ``device=`` where the reference takes a 1×1
``Mesh``, and ``make_lm_stream`` a ``device=`` where the reference takes
the mesh. Added: a checkpoint the JAX package's ``Trainer`` wrote restores
into the port's, whose next steps give the JAX package's losses (float32
compute, within 1e-4 relative: ``tests/test_torch_train.py``'s tolerance
for steps).

The reference file's own description:

    Trainer-level fault tolerance: crash-resume, transient retry, NaN skip.
"""
import dataclasses

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import make_lm_stream  # noqa: E402
from repro_torch.train import Trainer, make_optimizer  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402


@pytest.fixture
def device():
    return "cpu"


def _mk(device, tmp_path=None, **kw):
    cfg = configs.get_smoke_config("qwen2_1_5b")
    stream = make_lm_stream(batch=4, seq_len=32, vocab=cfg.vocab, seed=0, device=device)
    tr = Trainer(cfg, make_optimizer("adamw", lr=3e-3), stream,
                 ckpt_dir=str(tmp_path) if tmp_path else None,
                 ckpt_every=5, device=device, **kw)
    return tr, stream


def test_crash_resume_identical_to_uninterrupted(device, tmp_path):
    """Train 6 steps, 'crash', resume to 10 == training 10 straight
    (same data stream, same ckpt step → bitwise-equal losses)."""
    tr1, s1 = _mk(device, tmp_path / "a")
    tr1.run(6)                                # ckpt at step 5
    tr1b, s1b = _mk(device, tmp_path / "a")   # new process, same dir
    start = tr1b.init_or_restore()
    assert start == 5
    m1 = tr1b.run(10)
    s1.close(), s1b.close()

    tr2, s2 = _mk(device, tmp_path / "b")
    m2 = tr2.run(10)
    s2.close()
    resumed = {h["step"]: h["loss"] for h in m1.history}
    straight = {h["step"]: h["loss"] for h in m2.history}
    for step in range(5, 10):
        np.testing.assert_allclose(resumed[step], straight[step], rtol=1e-5), step


def test_transient_failure_retried(device):
    boom = {"left": 2}

    def failure_hook(step):
        if step == 3 and boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("injected transient device error")

    tr, s = _mk(device, None, failure_hook=failure_hook, max_retries=3)
    m = tr.run(6)
    s.close()
    assert m.retries == 2
    assert len(m.history) == 6                # all steps completed


def test_hard_failure_restores_checkpoint(device, tmp_path):
    calls = {"n": 0}

    def failure_hook(step):
        # step 7 fails persistently the first 4 times it is attempted
        if step == 7 and calls["n"] < 4:
            calls["n"] += 1
            raise RuntimeError("persistent fault")

    tr, s = _mk(device, tmp_path, failure_hook=failure_hook, max_retries=2)
    m = tr.run(9)
    s.close()
    assert m.restores >= 1                    # rolled back to ckpt-5
    assert m.history[-1]["step"] == 8         # and still finished


def test_nonfinite_step_dropped(device):
    """A poisoned batch (NaN loss) must not corrupt the params."""
    cfg = configs.get_smoke_config("qwen2_1_5b")
    stream = make_lm_stream(batch=4, seq_len=32, vocab=cfg.vocab, seed=0, device=device)
    tr = Trainer(cfg, make_optimizer("adamw", lr=1e30), stream, device=device)
    # lr=1e30 → immediate inf/NaN updates; the guard drops them
    m = tr.run(3)
    stream.close()
    leaves = tree_leaves(tr.state["params"])
    assert all(bool(torch.isfinite(leaf).all()) for leaf in leaves)
    assert m.nan_skips >= 1


def test_jax_trainer_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's Trainer trains 2 steps and checkpoints; the port's
    Trainer resumes from that checkpoint and its steps 2-3 give the losses
    of the JAX Trainer's uninterrupted run."""
    pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.data.pipeline import make_lm_stream as jax_stream
    from repro.launch.mesh import make_test_mesh
    from repro.train import Trainer as JTrainer
    from repro.train import make_optimizer as jax_optimizer

    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2_1_5b"),
                               compute_dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2_1_5b"), compute_dtype="float32")
    mesh = make_test_mesh(data=1, model=1)
    js = jax_stream(mesh, batch=4, seq_len=32, vocab=jcfg.vocab, seed=0)
    jtr = JTrainer(jcfg, jax_optimizer("adamw", lr=3e-3), mesh, js,
                   ckpt_dir=str(tmp_path), ckpt_every=2)
    jtr.init_or_restore(seed=0)
    straight = {h["step"]: h["loss"] for h in jtr.run(2).history}
    jtr2 = JTrainer(jcfg, jax_optimizer("adamw", lr=3e-3), mesh, js)
    jtr2.state = jtr.state
    straight.update({h["step"]: h["loss"] for h in jtr2.run(4).history})
    js.close()

    stream = make_lm_stream(batch=4, seq_len=32, vocab=cfg.vocab, seed=0, device="cpu")
    tr = Trainer(cfg, make_optimizer("adamw", lr=3e-3), stream, ckpt_dir=str(tmp_path),
                 ckpt_every=100, device="cpu")
    assert tr.init_or_restore() == 2
    resumed = {h["step"]: h["loss"] for h in tr.run(4).history}
    stream.close()
    assert sorted(resumed) == [2, 3]
    for step in (2, 3):
        np.testing.assert_allclose(resumed[step], straight[step], rtol=1e-4)
