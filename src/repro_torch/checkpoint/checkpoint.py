"""Checkpointing: atomic, async-capable snapshots of a tree for restarts.

The port of the JAX package's ``checkpoint/checkpoint.py``, with its
on-disk format, so a checkpoint written by either package restores into
the other: one ``.npz`` per snapshot with flattened ``/``-joined key paths
(bfloat16 leaves stored as uint16, their dtype named in a JSON sidecar
with the step). Writes go to a temp file then ``os.replace``: a crash
mid-write can never corrupt the latest good checkpoint.

A tree is nested dicts (lists and tuples index by position) whose leaves
are tensors, numpy arrays or Python scalars. It is restored as nested
dicts of CPU tensors, or of tensors on ``device=``.

``CheckpointManager`` adds: save-every-N policy, retention of the last K
snapshots, an async mode (the host write on a worker thread, so the
device step loop never waits for the disk), and restore-latest.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]


def _host(leaf) -> np.ndarray | torch.Tensor:
    """A leaf on the host, a copy that later device work cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _host_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return _host(tree)


def _items(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _items(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                dtypes[key] = "bfloat16"
                leaf = leaf.view(torch.int16).numpy().view(np.uint16)
            else:
                leaf = leaf.numpy()
        flat[key] = np.asarray(leaf)
    return flat, dtypes


def _unflatten(flat: dict[str, np.ndarray], dtypes: dict[str, str], device) -> Any:
    tree: dict = {}
    for key, value in flat.items():
        if dtypes.get(key) == "bfloat16":
            t = torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(value)
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t if device is None else t.to(device)
    return tree


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    flat, dtypes = _flatten(tree)
    tmp = os.path.join(directory, f".tmp-ckpt-{step}.npz")
    final = os.path.join(directory, f"ckpt-{step}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    meta = {"step": int(step), "n_leaves": len(flat), "dtypes": dtypes}
    with open(os.path.join(directory, f".tmp-ckpt-{step}.json"), "w") as f:
        json.dump(meta, f)
    os.replace(os.path.join(directory, f".tmp-ckpt-{step}.json"),
               os.path.join(directory, f"ckpt-{step}.json"))
    os.replace(tmp, final)                                  # atomic publish
    return final


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := re.fullmatch(r"ckpt-(\d+)\.npz", name)))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int | None = None,
                       device=None) -> tuple[int, Any]:
    """Load a snapshot as nested dicts of tensors (on ``device`` if given,
    else the CPU)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    dtypes: dict[str, str] = {}
    meta_path = os.path.join(directory, f"ckpt-{step}.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(directory, f"ckpt-{step}.npz")) as z:
        tree = _unflatten({k: z[k] for k in z.files}, dtypes, device)
    return step, tree


class CheckpointManager:
    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def maybe_save(self, step: int, tree: Any) -> bool:
        if step % self.every:
            return False
        host_tree = _host_tree(tree)              # sync copy off the device
        if self.async_save:
            self.wait()                            # one in-flight write max
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree), daemon=True)
            self._thread.start()
        else:
            self._write(step, host_tree)
        return True

    def _write(self, step: int, host_tree: Any) -> None:
        save_checkpoint(self.directory, step, host_tree)
        self._gc()

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep] if self.keep else []:
            for ext in ("npz", "json"):
                try:
                    os.remove(os.path.join(self.directory, f"ckpt-{s}.{ext}"))
                except FileNotFoundError:
                    pass

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, device=None):
        self.wait()
        return restore_checkpoint(self.directory, device=device)
