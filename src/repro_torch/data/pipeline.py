"""Restartable, prefetching data pipeline for LM training on one device.

The port of the JAX package's ``data/pipeline.py`` without the mesh:
``Stream`` wraps a deterministic step-indexed source (``TokenStream``:
batch(step) is a pure function of (seed, step), the restart contract) and
puts each batch on ``device``. A one-deep prefetch thread overlaps host
batch synthesis and the copy with the device step: on the card a batch is
copied from pinned host memory with ``non_blocking=True`` (on the
thread's default stream, which the step also runs on, so the step sees the
batch complete).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.synthetic import TokenStream
from repro_torch.device import default_device

__all__ = ["Stream", "place_batch", "make_lm_stream"]


def place_batch(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: from pinned memory without a
    wait on the card, as they are on the CPU."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Stream:
    """Prefetching wrapper: ``get(step)`` returns the batch of ``step`` on
    ``device`` (the card by default)."""

    def __init__(self, source: Callable[[int], dict[str, np.ndarray]], device=None,
                 prefetch: int = 1):
        self.source = source
        self.device = default_device(device)
        self._q: queue.Queue[tuple[int, Any]] = queue.Queue(maxsize=max(1, prefetch))
        self._next_step: int | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _worker(self, start: int, q: queue.Queue, stop: threading.Event) -> None:
        # q/stop are bound per worker so a superseded worker can never feed
        # the replacement's queue
        step = start
        while not stop.is_set():
            q.put((step, place_batch(self.source(step), self.device)))
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
            self._thread = None


def make_lm_stream(batch: int, seq_len: int, vocab: int, seed: int = 0,
                   extras: dict[str, tuple] | None = None, *, device=None) -> Stream:
    """The ``TokenStream`` of ``seed`` as a :class:`Stream` on ``device``,
    with the stub frontends' inputs: ``extras`` maps a batch key to its
    ``(shape, dtype)``, drawn as the reference draws them. The reference
    seeds that draw with ``hash(("extras", seed, step))``, a string hash
    that Python randomises per process unless ``PYTHONHASHSEED`` is fixed,
    so the extras equal the reference's within one process only."""
    ts = TokenStream(batch, seq_len, vocab, seed=seed)

    def source(step: int) -> dict[str, np.ndarray]:
        b = ts.batch_at(step)
        if extras:
            rng = np.random.default_rng(hash(("extras", seed, step)) % (2**31))
            for name, (shape, dtype) in extras.items():
                b[name] = rng.normal(size=shape).astype(dtype)
        return b

    return Stream(source, device)
