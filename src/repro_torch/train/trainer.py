"""The training-loop driver: step loop + checkpoint/restart + fault recovery.

The port of the JAX package's ``train/trainer.py``, on one device
(``device=``) or over a ``torch.distributed`` device mesh (``mesh=``, the
reference's ``Mesh``; :mod:`repro_torch.train.train_step` has its two DP
modes). A mesh state is checkpointed whole, in the reference's format:
every rank gathers each leaf and rank 0 writes it, synchronously, then
all ranks meet at a barrier so each sees the file; a restore reads the
whole tree on every rank and places it on the mesh, so a checkpoint moves
between one device and any mesh. Fault model:
  * process crash / preemption → restart resumes from the latest checkpoint;
    the data stream is step-indexed so resumed training consumes exactly the
    batches it would have seen (no skips, no repeats);
  * transient step failure (injected via ``failure_hook``) → retry the step;
    after ``max_retries`` the state is restored from the last checkpoint
    (protects against corrupted device state after a failed launch);
  * NaN/inf loss or gradient norm → the update is dropped (train_step's
    guard), counted in ``nan_skips``.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.device import default_device
from repro_torch.models.transformer import ArchConfig
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.train_step import build_train_step, data_size_of, distribute_tree, \
    gather_tree, init_train_state, make_train_state_specs

__all__ = ["Trainer", "TrainMetrics"]


class TrainMetrics:
    def __init__(self):
        self.history: list[dict[str, float]] = []
        self.nan_skips = 0
        self.retries = 0
        self.restores = 0

    def log(self, step: int, loss: float, gnorm: float, secs: float) -> None:
        self.history.append(
            {"step": step, "loss": loss, "grad_norm": gnorm, "seconds": secs})


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        optimizer: Optimizer,
        stream,                        # data.pipeline.Stream
        ckpt_dir: str | None = None,
        ckpt_every: int = 50,
        grad_clip: float = 1.0,
        dp_mode: str = "gspmd",
        failure_hook: Callable[[int], None] | None = None,
        max_retries: int = 2,
        *,
        device=None,
        force=None,
        mesh=None,
        fsdp: bool = False,
        zero1: bool = True,
    ):
        self.cfg, self.optimizer, self.stream, self.mesh = cfg, optimizer, stream, mesh
        self.device = torch.device(mesh.device_type) if mesh is not None else \
            default_device(device)
        self._writer = mesh is None or dist.get_rank() == 0
        self.ckpt = (CheckpointManager(ckpt_dir, every=ckpt_every, async_save=mesh is None)
                     if ckpt_dir else None)
        self.metrics = TrainMetrics()
        self.failure_hook = failure_hook
        self.max_retries = max_retries
        self.state_specs = None
        if mesh is not None:
            _, self.state_specs = make_train_state_specs(cfg, optimizer, fsdp=fsdp, zero1=zero1,
                                                    data_size=data_size_of(mesh))
        self._step_fn = build_train_step(cfg, optimizer, grad_clip=grad_clip,
                                         dp_mode=dp_mode, mesh=mesh, force=force,
                                         state_specs=self.state_specs)
        self.state: Any = None

    # ------------------------------------------------------------------
    def _restore(self) -> int:
        step, tree = self.ckpt.restore_latest(device=self.device)
        tree = {**tree, "step": int(tree["step"])}
        if self.mesh is not None:
            specs = self.state_specs
            tree = {"step": tree["step"],
                    "params": distribute_tree(tree["params"], self.mesh, specs["params"]),
                    "opt_state": distribute_tree(tree["opt_state"], self.mesh,
                                                 specs["opt_state"])}
        self.state = tree
        self.metrics.restores += 1
        return self.state["step"]

    def _snapshot(self) -> dict:
        """The state as the reference checkpoints it (an int32 step), whole:
        a mesh state's leaves gathered (every rank takes part)."""
        state = {k: self.state[k] for k in ("params", "opt_state")}
        if self.mesh is not None:
            state = gather_tree(state)
        return {**state, "step": np.int32(self.state["step"])}

    def _maybe_save(self, step: int) -> None:
        if step % self.ckpt.every:
            return
        snap = self._snapshot()
        if self._writer:
            self.ckpt.maybe_save(step, snap)
        if self.mesh is not None:
            dist.barrier()

    def init_or_restore(self, seed: int = 0) -> int:
        """Fresh init, or resume from the latest checkpoint if one exists."""
        if self.ckpt and latest_step(self.ckpt.directory) is not None:
            return self._restore()
        self.state = init_train_state(self.cfg, self.optimizer, seed, device=self.device,
                                      mesh=self.mesh, state_specs=self.state_specs)
        return 0

    def run(self, n_steps: int) -> TrainMetrics:
        step = self.init_or_restore() if self.state is None else self.state["step"]
        while step < n_steps:
            batch = self.stream.get(step)
            t0 = time.perf_counter()
            tries = 0
            while True:
                try:
                    if self.failure_hook is not None:
                        self.failure_hook(step)     # may raise (injected fault)
                    new_state, m = self._step_fn(self.state, batch)
                    loss = float(m["loss"])
                    break
                except Exception:
                    tries += 1
                    self.metrics.retries += 1
                    if tries > self.max_retries:
                        # device state suspect → restore last checkpoint
                        if self.ckpt:
                            self.ckpt.wait()   # flush any in-flight async save
                        if self.ckpt and latest_step(self.ckpt.directory) is not None:
                            step = self._restore()
                            batch = self.stream.get(step)
                            tries = 0
                        else:
                            raise
            gnorm = float(m["grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                self.metrics.nan_skips += 1      # the update was dropped
            self.state = new_state
            self.metrics.log(step, loss, gnorm, time.perf_counter() - t0)
            step += 1
            if self.ckpt:
                self._maybe_save(step)
        if self.ckpt:
            self.ckpt.wait()
        return self.metrics
