"""The random draws of the forest and the MLP, from seeded torch generators.

PyTorch cannot reproduce ``jax.random``'s draws, so the port makes its own
and keeps the properties the JAX package relies on:

* **Forest** — tree ``t`` of a config draws a Poisson(1) row-weight vector
  (the bootstrap, by inverse CDF from uniforms) and a feature permutation
  from a generator seeded by ``(seed, t)`` alone, through
  ``np.random.SeedSequence([seed, t])``. Tree
  t's draws therefore do not depend on how many trees ran before or how
  many a batch pads to, which is what makes resume and batching bit-exact
  (the reference gets this from ``fold_in(key, t)``).
* **MLP** — one generator per config draws the He-normal initial weights
  and then each step's minibatch indices, in that order. Its state
  (:meth:`MLPDraws.state`, a uint8 array) rides in the resume payload in
  place of the JAX key.

Every draw is made on a CPU generator and then moved to the device, so one
seed gives the same forest and the same MLP on the card and on the CPU
(PyTorch's CPU and CUDA generators are different algorithms), and an MLP
rung trained on one resumes on the other. The sharded cores draw the same
full ``(n_rows,)`` vectors and slice them per shard: no draw sees the
shard count. Nothing draws from the process-global generator: executor
threads share the card, and a global stream would make each config's draws
depend on what the other thread ran.

Both cores also take precomputed draws (:class:`FixedForestDraws`,
:class:`FixedMLPDraws`), so tests can feed the JAX package's own draws.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "seed_of",
    "forest_tree_draws",
    "FixedForestDraws",
    "MLPDraws",
    "FixedMLPDraws",
    "to_device",
]


def seed_of(*entropy: int) -> int:
    """A 64-bit generator seed from non-negative integers, e.g. (seed, t)."""
    return int(np.random.SeedSequence([int(e) for e in entropy])
               .generate_state(1, np.uint64)[0])


def _poisson1_cdf() -> torch.Tensor:
    """Poisson(1)'s CDF at k = 0, 1, ... in float32, up to where it rounds
    to 1."""
    cdf, p, k = [], math.exp(-1.0), 0
    total = p
    while np.float32(total) < 1.0:
        cdf.append(total)
        k += 1
        p /= k
        total += p
    return torch.tensor(cdf, dtype=torch.float32)


#: the bootstrap's inverse CDF
_POISSON1_CDF = _poisson1_cdf()


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A CPU draw on ``device``. To the card it goes from pinned memory
    without waiting for the card (a copy from pageable memory would wait
    for the stream to drain at every tree and every MLP step)."""
    device = torch.device(device)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def forest_tree_draws(seed: int, t: int, n_rows: int, n_features: int,
                      device) -> tuple[torch.Tensor, torch.Tensor]:
    """Tree ``t``'s bootstrap weights (R,) float32 ~ Poisson(1) and feature
    permutation (F,) int64, drawn on the CPU and moved to ``device``. The
    weights are the inverse CDF of R uniforms (``torch.poisson`` on the CPU
    takes ~40 ns a row, ~6 ms a tree at 150,000 rows; this ~8 ns)."""
    gen = torch.Generator().manual_seed(seed_of(seed, t))
    u = torch.rand(n_rows, generator=gen)
    w = torch.searchsorted(_POISSON1_CDF, u, right=True).to(torch.float32)
    perm = torch.randperm(n_features, generator=gen)
    return to_device(w, device), to_device(perm, device)


class FixedForestDraws:
    """Precomputed per-tree draws: ``weights`` (T, R) and ``perms`` (T, F),
    row t for absolute tree index t."""

    def __init__(self, weights, perms):
        self.weights = np.array(weights, np.float32)
        self.perms = np.array(perms, np.int64)

    def __call__(self, t: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(self.weights[t]).to(device),
                torch.from_numpy(self.perms[t]).to(device))


class MLPDraws:
    """One config's generator: initial weights first, then step indices.
    The generator is a CPU one whatever ``device`` is, so its state (and the
    draws) are the same on every device."""

    def __init__(self, seed: int, device, state: np.ndarray | None = None):
        self.gen = torch.Generator()
        if state is None:
            self.gen.manual_seed(seed_of(seed))
        else:
            self.gen.set_state(torch.from_numpy(np.asarray(state, np.uint8)))
        self.device = device

    def init(self, dims: Sequence[int]) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """He-normal weights and zero biases, layer by layer."""
        out = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            w = to_device(torch.randn((d_in, d_out), generator=self.gen), self.device)
            out.append((w * math.sqrt(2.0 / d_in),
                        torch.zeros(d_out, dtype=torch.float32, device=self.device)))
        return out

    def step_batches(self, start: int, count: int, n_rows: int,
                     batch_size: int) -> torch.Tensor:
        """Steps ``start .. start + count``'s minibatch row indices, (count,
        batch_size) int64 on the CPU, in one draw: the same numbers, and the
        same generator state after, as ``count`` draws of one step each (the
        step index is implied by the generator's position)."""
        del start
        return torch.randint(0, n_rows, (count, batch_size), generator=self.gen)

    def batch(self, i: int, n_rows: int, batch_size: int) -> torch.Tensor:
        """Step ``i``'s minibatch row indices, on the device."""
        return to_device(self.step_batches(i, 1, n_rows, batch_size)[0], self.device)

    def state(self) -> np.ndarray:
        return self.gen.get_state().numpy().copy()


class FixedMLPDraws:
    """Precomputed MLP draws: ``init`` as a list of (w, b) arrays and
    ``batches`` (steps, batch) with row i the indices of global step i."""

    def __init__(self, init, batches, device):
        self.params = [(np.array(w, np.float32), np.array(b, np.float32))
                       for w, b in init]
        self.batches = np.array(batches, np.int64)
        self.device = device

    def init(self, dims: Sequence[int]) -> list[tuple[torch.Tensor, torch.Tensor]]:
        got = tuple([self.params[0][0].shape[0]] + [w.shape[1] for w, _ in self.params])
        if got != tuple(dims):
            raise ValueError(f"precomputed init has dims {got}, the config {tuple(dims)}")
        return [(torch.from_numpy(w).to(self.device), torch.from_numpy(b).to(self.device))
                for w, b in self.params]

    def step_batches(self, start: int, count: int, n_rows: int,
                     batch_size: int) -> torch.Tensor:
        del n_rows, batch_size
        return torch.from_numpy(self.batches[start:start + count])

    def batch(self, i: int, n_rows: int, batch_size: int) -> torch.Tensor:
        return to_device(self.step_batches(i, 1, n_rows, batch_size)[0], self.device)

    def state(self) -> np.ndarray:
        return np.zeros(0, np.uint8)
