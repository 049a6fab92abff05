"""The JAX package's ``tests/test_checkpoint.py`` contracts, run against the port.

The same tests with ``repro`` read as ``repro_torch`` and ``jnp`` arrays as
tensors (a restored tree is nested dicts of tensors; bfloat16 leaves stay
bfloat16), on the CPU. Added: a checkpoint written by the JAX package
restores into the port, and one written by the port into the JAX package,
leaf for leaf.

The reference file's own description:

    Checkpoint/restart + data-pipeline determinism (fault-tolerance layer).
"""
import os

import numpy as np
import pytest

# the port needs PyTorch; where it is not installed only the JAX suite runs
torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402


def tree_eq(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    tree = {
        "step": torch.tensor(7, dtype=torch.int32),
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "nested": {"b": torch.ones(5, dtype=torch.bfloat16)}},
    }
    save_checkpoint(str(tmp_path), 7, tree)
    step, restored = restore_checkpoint(str(tmp_path))
    assert step == 7
    tree_eq(tree, restored)


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, {"x": torch.tensor(float(s))})
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert kept == ["ckpt-3.npz", "ckpt-4.npz"]


def test_save_every_policy(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=5, keep=0, async_save=False)
    saved = [s for s in range(1, 21) if mgr.maybe_save(s, {"x": torch.tensor(float(s))})]
    assert saved == [5, 10, 15, 20]


def test_async_save_visible_after_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=3, async_save=True)
    mgr.maybe_save(1, {"x": torch.arange(1000.0)})
    mgr.wait()
    step, tree = restore_checkpoint(str(tmp_path))
    assert step == 1 and tree["x"].shape == (1000,)


def test_no_partial_checkpoint_on_disk(tmp_path):
    """Temp files never count as checkpoints (atomic-publish contract)."""
    # simulate a crashed writer: leave a temp file behind
    with open(tmp_path / ".tmp-ckpt-9.npz", "wb") as f:
        f.write(b"garbage")
    assert latest_step(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 2, {"x": torch.tensor(1.0)})
    assert latest_step(str(tmp_path)) == 2


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"))


def test_token_stream_restart_determinism():
    """batch(step) is a pure function of (seed, step) — the resume contract."""
    s1 = TokenStream(4, 16, 1000, seed=3)
    s2 = TokenStream(4, 16, 1000, seed=3)
    for step in (0, 5, 17):
        b1, b2 = s1.batch_at(step), s2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    # different seeds/steps differ
    assert not np.array_equal(s1.batch_at(0)["tokens"], s1.batch_at(1)["tokens"])


def _mixed_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"step": np.int32(5),
            "params": {"blocks": {"b0": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32)}},
                       "embed": rng.normal(size=(6, 4)).astype(np.float32)},
            "opt_state": {"m": {"half": rng.normal(size=(3,)).astype(np.float32)}}}


def test_jax_written_checkpoint_restores_into_the_port(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.checkpoint import save_checkpoint as jax_save

    tree = _mixed_tree(0)
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["opt_state"]["bf16"] = jnp.arange(4, dtype=jnp.bfloat16) / 3
    jax_save(str(tmp_path), 5, jtree)
    step, got = restore_checkpoint(str(tmp_path))
    assert step == 5
    assert got["opt_state"]["bf16"].dtype == torch.bfloat16
    want = (torch.arange(4, dtype=torch.float32) / 3).to(torch.bfloat16)
    assert torch.equal(got["opt_state"]["bf16"], want)
    del got["opt_state"]["bf16"]
    tree_eq(got, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def test_port_written_checkpoint_restores_into_jax(tmp_path):
    pytest.importorskip("jax")
    from repro.checkpoint import restore_checkpoint as jax_restore

    tree = _mixed_tree(1)
    port = {k: v for k, v in tree.items()}
    port["params"] = {"blocks": {"b0": {"w": torch.from_numpy(tree["params"]["blocks"]["b0"]["w"])}},
                      "embed": torch.from_numpy(tree["params"]["embed"])}
    port["opt_state"] = {"m": {"half": torch.from_numpy(tree["opt_state"]["m"]["half"]).to(
        torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 5, port)
    step, got = jax_restore(str(tmp_path))
    assert step == 5 and got["step"].dtype == np.int32
    np.testing.assert_array_equal(got["params"]["blocks"]["b0"]["w"],
                                  tree["params"]["blocks"]["b0"]["w"])
    assert str(got["opt_state"]["m"]["half"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(got["opt_state"]["m"]["half"], np.float32),
        port["opt_state"]["m"]["half"].float().numpy())
