"""Restartable, prefetching data pipeline for LM training, on one device
or over a device mesh.

The port of the JAX package's ``data/pipeline.py``: ``Stream`` wraps a
deterministic step-indexed source (``TokenStream``: batch(step) is a pure
function of (seed, step), the restart contract) and puts each batch on
``device``. A one-deep prefetch thread overlaps host batch synthesis and
the copy with the device step: on the card a batch is copied from pinned
host memory with ``non_blocking=True`` (on the thread's default stream,
which the step also runs on, so the step sees the batch complete).

``ShardedStream(source, mesh)`` is the reference's: every rank draws the
same global batch and keeps its ``batch_pspecs`` block (the leading dim
over dp where it divides), as a DTensor on the mesh.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.synthetic import TokenStream
from repro_torch.device import default_device

__all__ = ["Stream", "ShardedStream", "place_batch", "make_lm_stream"]


def place_batch(batch: dict[str, np.ndarray], device=None, *,
                mesh=None) -> dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: from pinned memory without a
    wait on the card, as they are on the CPU. With ``mesh`` each value is
    a DTensor placed per ``batch_pspecs`` (its leading dim over dp where
    it divides); the rank copies only its own block to its device."""
    if mesh is not None:
        return _place_on_mesh(batch, mesh)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _place_on_mesh(batch: dict[str, np.ndarray], mesh) -> dict[str, torch.Tensor]:
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd

    cm = shd.compute_mesh(mesh)
    dp = 1
    for name, n in zip(cm.mesh_dim_names, cm.shape):
        dp *= n if name != "model" else 1
    specs = shd.batch_pspecs(batch, dp)
    dev = torch.device(cm.device_type, torch.cuda.current_device()) \
        if cm.device_type == "cuda" else torch.device(cm.device_type)
    out = {}
    for k, v in batch.items():
        pls = shd.placements(specs[k], mesh)
        size, off = shd.local_shape_and_offset(v.shape, cm, pls)
        block = v[tuple(slice(o, o + n) for o, n in zip(off, size))]
        t = torch.from_numpy(np.ascontiguousarray(block))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = DTensor.from_local(t, cm, pls, run_check=False, shape=torch.Size(v.shape),
                                    stride=torch.empty(v.shape, device="meta").stride())
    return out


class Stream:
    """Prefetching wrapper: ``get(step)`` returns the batch of ``step`` on
    ``device`` (the card by default)."""

    def __init__(self, source: Callable[[int], dict[str, np.ndarray]], device=None,
                 prefetch: int = 1, *, mesh=None):
        self.source = source
        self.mesh = mesh
        self.device = torch.device(mesh.device_type) if mesh is not None else \
            default_device(device)
        self._q: queue.Queue[tuple[int, Any]] = queue.Queue(maxsize=max(1, prefetch))
        self._next_step: int | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _worker(self, start: int, q: queue.Queue, stop: threading.Event) -> None:
        # q/stop are bound per worker so a superseded worker can never feed
        # the replacement's queue
        step = start
        while not stop.is_set():
            q.put((step, place_batch(self.source(step), self.device, mesh=self.mesh)))
            step += 1

    def get(self, step: int) -> dict[str, torch.Tensor]:
        # sequential access hits the prefetch queue; random access restarts it
        if self._thread is None or self._next_step != step:
            self.close()
            self._stop = threading.Event()
            self._q = queue.Queue(maxsize=1)
            self._thread = threading.Thread(
                target=self._worker, args=(step, self._q, self._stop), daemon=True)
            self._thread.start()
        got_step, batch = self._q.get()
        assert got_step == step
        self._next_step = step + 1
        return batch

    def close(self) -> None:
        if self._thread is not None:
            self._stop.set()
            try:
                self._q.get_nowait()     # unblock a worker stuck on put()
            except queue.Empty:
                pass
            # a worker left running past the process group's end (a mesh
            # stream) can abort the interpreter's exit
            self._thread.join(timeout=30)
            self._thread = None


class ShardedStream(Stream):
    """The reference's mesh stream: ``get(step)`` returns the batch of
    ``step`` placed on ``mesh`` (:func:`place_batch`)."""

    def __init__(self, source: Callable[[int], dict[str, np.ndarray]], mesh,
                 prefetch: int = 1):
        super().__init__(source, prefetch=prefetch, mesh=mesh)


def make_lm_stream(batch: int, seq_len: int, vocab: int, seed: int = 0,
                   extras: dict[str, tuple] | None = None, *, device=None,
                   mesh=None) -> Stream:
    """The ``TokenStream`` of ``seed`` as a :class:`Stream` on ``device``,
    with the stub frontends' inputs: ``extras`` maps a batch key to its
    ``(shape, dtype)``, drawn as the reference draws them. The reference
    seeds that draw with ``hash(("extras", seed, step))``, a string hash
    that Python randomises per process unless ``PYTHONHASHSEED`` is fixed,
    so the extras equal the reference's within one process only (fix
    ``PYTHONHASHSEED`` for the same frames on every rank of a mesh). With
    ``mesh`` it is a :class:`ShardedStream`."""
    ts = TokenStream(batch, seq_len, vocab, seed=seed)

    def source(step: int) -> dict[str, np.ndarray]:
        b = ts.batch_at(step)
        if extras:
            rng = np.random.default_rng(hash(("extras", seed, step)) % (2**31))
            for name, (shape, dtype) in extras.items():
                b[name] = rng.normal(size=shape).astype(dtype)
        return b

    return ShardedStream(source, mesh) if mesh is not None else Stream(source, device)
