"""The random draws of the forest and the MLP, from seeded torch generators.

PyTorch cannot reproduce ``jax.random``'s draws, so the port makes its own
and keeps the properties the JAX package relies on:

* **Forest** — tree ``t`` of a config draws a Poisson(1) row-weight vector
  (the bootstrap) and a feature permutation from a generator seeded by
  ``(seed, t)`` alone, through ``np.random.SeedSequence([seed, t])``. Tree
  t's draws therefore do not depend on how many trees ran before or how
  many a batch pads to, which is what makes resume and batching bit-exact
  (the reference gets this from ``fold_in(key, t)``).
* **MLP** — one generator per config draws the He-normal initial weights
  and then each step's minibatch indices, in that order. Its state
  (:meth:`MLPDraws.state`, a uint8 array) rides in the resume payload in
  place of the JAX key.

Nothing draws from the process-global generator: executor threads share the
card, and a global stream would make each config's draws depend on what
the other thread ran.

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
]


def seed_of(*entropy: int) -> int:
    """A 64-bit generator seed from non-negative integers, e.g. (seed, t)."""
    return int(np.random.SeedSequence([int(e) for e in entropy])
               .generate_state(1, np.uint64)[0])


def forest_tree_draws(seed: int, t: int, n_rows: int, n_features: int,
                      device) -> tuple[torch.Tensor, torch.Tensor]:
    """Tree ``t``'s bootstrap weights (R,) float32 ~ Poisson(1) and feature
    permutation (F,) int64, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, t))
    w = torch.poisson(torch.ones(n_rows, dtype=torch.float32, device=device),
                      generator=gen)
    perm = torch.randperm(n_features, generator=gen, device=device)
    return w, perm


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
    """One config's generator: initial weights first, then step indices."""

    def __init__(self, seed: int, device, state: np.ndarray | None = None):
        self.gen = torch.Generator(device=device)
        if state is None:
            self.gen.manual_seed(seed_of(seed))
        else:
            self.gen.set_state(torch.from_numpy(np.asarray(state, np.uint8)))
        self.device = device

    def init(self, dims: Sequence[int]) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """He-normal weights and zero biases, layer by layer."""
        out = []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            w = torch.randn((d_in, d_out), generator=self.gen, device=self.device)
            out.append((w * math.sqrt(2.0 / d_in),
                        torch.zeros(d_out, dtype=torch.float32, device=self.device)))
        return out

    def batch(self, i: int, n_rows: int, batch_size: int) -> torch.Tensor:
        """Step ``i``'s minibatch row indices (the step index is implied by
        the generator's position)."""
        del i
        return torch.randint(0, n_rows, (batch_size,), generator=self.gen,
                             device=self.device)

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

    def batch(self, i: int, n_rows: int, batch_size: int) -> torch.Tensor:
        del n_rows, batch_size
        return torch.from_numpy(self.batches[i]).to(self.device)

    def state(self) -> np.ndarray:
        return np.zeros(0, np.uint8)
