"""HIGGS-like rows drawn on the device from the run's seed.

A copy, rewritten in torch, of ``repro_torch.data.synthetic.make_higgs_like``:
21 "low-level" standard normals, 7 "high-level" features derived from them
(products, trig, squares, as HIGGS's are functions of the low-level
ones), and a balanced label from a smooth nonlinear score plus noise. The
rows are drawn on the card by one generator in a few large calls, split
0.6 / 0.2 / 0.2 by a seeded permutation and standardized on the training
part, as ``launch/search.py::tabular_data`` does, and handed to the program
as host ``DenseMatrix``es, the type its interface takes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    """What the harness hands both sides: standardized float32 rows and
    {0, 1} float32 labels, on the host."""
    x_train: np.ndarray
    y_train: np.ndarray
    x_valid: np.ndarray
    y_valid: np.ndarray


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def draw(n_rows: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Generator]:
    """(x (R, 28) float32, y (R,) float32) on ``device``, and the generator
    after the draw."""
    gen = generator(seed, device)
    x_low = torch.randn((n_rows, 21), generator=gen, device=device)
    noise = torch.randn((n_rows,), generator=gen, device=device)
    xl = x_low.T
    x_high = torch.stack([
        xl[0] * xl[1],
        xl[2] * xl[3],
        torch.sin(xl[4]) * xl[5],
        xl[6] ** 2 - xl[7] ** 2,
        torch.cos(xl[8]) + xl[9],
        xl[10] * xl[11] * torch.sign(xl[12]),
        torch.abs(xl[13]) - torch.abs(xl[14]),
    ], dim=1)
    logits = (1.8 * x_high[:, 0] - 1.2 * x_high[:, 3] + 0.9 * torch.tanh(x_high[:, 2])
              + 0.6 * x_low[:, 15] - 0.4 * x_low[:, 16] * x_low[:, 17] + 0.5 * noise)
    y = (logits > torch.median(logits)).to(torch.float32)
    return torch.cat([x_low, x_high], dim=1), y, gen


def make(spec: dict, seed: int, device) -> Inputs:
    n_rows = int(spec["rows"])
    x, y, gen = draw(n_rows, seed, device)
    perm = torch.randperm(n_rows, generator=gen, device=device)
    fractions = spec.get("split", (0.6, 0.2, 0.2))
    total = sum(fractions)
    n_train = int(n_rows * fractions[0] / total)
    n_valid = int(n_rows * fractions[1] / total)
    tr, va = perm[:n_train], perm[n_train:n_train + n_valid]
    x_tr = x[tr]
    mean = x_tr.mean(dim=0)
    std = x_tr.std(dim=0, unbiased=False)
    std = torch.where(std < 1e-12, torch.ones_like(std), std)
    x_tr = (x_tr - mean) / std
    x_va = (x[va] - mean) / std
    del x
    return Inputs(x_train=x_tr.cpu().numpy(), y_train=y[tr].cpu().numpy(),
                  x_valid=x_va.cpu().numpy(), y_valid=y[va].cpu().numpy())
