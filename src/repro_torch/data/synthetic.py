"""Synthetic datasets matched to the paper's workloads (offline container).

* :func:`make_higgs_like` — the HIGGS dataset is 28 numeric kinematic features
  from Monte-Carlo physics events, balanced binary labels, 100k row samples in
  the paper. We generate 28 features where the label depends on smooth
  nonlinear interactions (products, trig of "angles", quadratic "masses") plus
  noise — learnable by GBDT/MLP, not linearly separable.

* :func:`make_secom_like` — SECOM: 1,567 rows × 590 sensor features, heavy
  class imbalance (~6.6 % positives), many dead/duplicated sensors. We match
  dimensionality, imbalance, dead columns and correlated sensor groups.

* :func:`token_batch` / :func:`TokenStream` — deterministic token streams for
  LM substrate tests/benchmarks (Zipf-ish unigram distribution).

AUC numbers on these are *parity checks between schedulers/frameworks*
(paper Fig. 7's point), not absolute UCI reproductions — see DESIGN.md §8.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.data_format import DenseMatrix

__all__ = ["make_higgs_like", "make_secom_like", "token_batch", "TokenStream"]


def make_higgs_like(n_rows: int = 10_000, seed: int = 0) -> DenseMatrix:
    rng = np.random.default_rng(seed)
    n_low = 21   # "low-level" detector features
    n_high = 7   # "high-level" derived features
    x_low = rng.normal(size=(n_rows, n_low)).astype(np.float32)
    # derived features: pairwise products + trig, as HIGGS's high-level
    # features are functions of the low-level ones
    x_high = np.stack(
        [
            x_low[:, 0] * x_low[:, 1],
            x_low[:, 2] * x_low[:, 3],
            np.sin(x_low[:, 4]) * x_low[:, 5],
            x_low[:, 6] ** 2 - x_low[:, 7] ** 2,
            np.cos(x_low[:, 8]) + x_low[:, 9],
            x_low[:, 10] * x_low[:, 11] * np.sign(x_low[:, 12]),
            np.abs(x_low[:, 13]) - np.abs(x_low[:, 14]),
        ],
        axis=1,
    ).astype(np.float32)
    x = np.concatenate([x_low, x_high], axis=1)
    logits = (
        1.8 * x_high[:, 0]
        - 1.2 * x_high[:, 3]
        + 0.9 * np.tanh(x_high[:, 2])
        + 0.6 * x_low[:, 15]
        - 0.4 * x_low[:, 16] * x_low[:, 17]
        + 0.5 * rng.normal(size=n_rows)
    )
    y = (logits > np.median(logits)).astype(np.float32)  # balanced, like HIGGS
    names = tuple(f"low_{i}" for i in range(n_low)) + tuple(f"high_{i}" for i in range(n_high))
    return DenseMatrix(x, y, names)


def make_secom_like(n_rows: int = 1_567, n_features: int = 590, seed: int = 0, pos_rate: float = 0.066) -> DenseMatrix:
    rng = np.random.default_rng(seed)
    n_groups = 30  # correlated sensor groups
    latent = rng.normal(size=(n_rows, n_groups)).astype(np.float32)
    loadings = rng.normal(size=(n_groups, n_features)).astype(np.float32) * (
        rng.random((n_groups, n_features)) < 0.15
    )
    x = latent @ loadings + 0.6 * rng.normal(size=(n_rows, n_features)).astype(np.float32)
    # dead sensors (constant columns) — SECOM has many
    dead = rng.choice(n_features, size=n_features // 10, replace=False)
    x[:, dead] = rng.normal(size=n_features // 10).astype(np.float32)[None, :]
    # label from a sparse subset of latents, heavy imbalance
    score = latent[:, 0] - 0.8 * latent[:, 1] * latent[:, 2] + 0.5 * rng.normal(size=n_rows)
    thresh = np.quantile(score, 1.0 - pos_rate)
    y = (score > thresh).astype(np.float32)
    return DenseMatrix(x.astype(np.float32), y)


def token_batch(batch: int, seq_len: int, vocab: int, seed: int = 0) -> np.ndarray:
    """One Zipf-distributed token batch (int32) for LM tests."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    return rng.choice(vocab, size=(batch, seq_len), p=p).astype(np.int32)


class TokenStream:
    """Deterministic, restartable LM data pipeline (step-indexed batches).

    Restartability is the fault-tolerance contract: batch(step) is a pure
    function of (seed, step), so training resumed from a checkpoint consumes
    exactly the batches it would have seen without the failure.
    """

    def __init__(self, batch: int, seq_len: int, vocab: int, seed: int = 0):
        self.batch, self.seq_len, self.vocab, self.seed = batch, seq_len, vocab, seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        tokens = token_batch(self.batch, self.seq_len + 1, self.vocab, seed=hash((self.seed, step)) % (2**31))
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
