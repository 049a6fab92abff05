"""The comparison that decides ``correct``, against the plain reference.

What is compared, once the window has closed and the peak memory was read:

* ``edges_bad``, ``codes_bad``: the program's ``quantized_bins`` payloads
  of the formats the checked fits trained on, against the reference's own
  quantization of the same raw rows (``reference/bins.py``): exact, limit 0.
* ``unscored``: fits of the window that came back failed or without a
  validation score: limit 0 (every configuration comes back scored).
* ``split_gap``, ``leaf_err``, ``auc_gap``: the widest readings of a sample
  of the window's fits drawn from the seed, the fit with the most trees
  always among them (``reference/<estimator>.py::check``): how far a
  tree's split lies below the best split of its node, how far a leaf
  value lies from the leaf formula (both in float64), and how far the
  validation score lies from the AUC of the fit's own trees' scores in
  float32, the configurations' precision.

Each number has the limit ``limits/<cell>.json`` gives it; the run is
correct when every number is at or below its limit and at least one fit
was checked.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import manifest
from portbench.reference import bins


@dataclasses.dataclass
class RefData:
    """The reference's own view of one format of the training rows."""
    n_bins: int
    edges32: torch.Tensor
    codes: torch.Tensor         # (R, F) int32
    codes_t: torch.Tensor       # (F, R)
    y: torch.Tensor             # float64
    x_valid: torch.Tensor
    y_valid: torch.Tensor


def pick_fits(fits, n: int, rng: np.random.Generator) -> list:
    """The fit with the most trees (the first such) and ``n - 1`` others
    drawn from ``rng``, of the fits that came back scored."""
    ok = [f for f in fits if f.ok]
    if not ok:
        return []
    longest = max(range(len(ok)), key=lambda i: ok[i].trees)
    rest = [i for i in range(len(ok)) if i != longest]
    extra = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [ok[longest]] + [ok[rest[int(i)]] for i in sorted(extra)]


def judge(cell, inputs, fits, seed: int, device, *, program_payload, release,
          n_fits: int) -> tuple[bool, dict]:
    """``(correct, {name: (value, limit)})``. ``program_payload(max_bins)``
    gives the program's payload of a format (``bins``, ``edges``);
    ``release()`` frees the program's state before the trees are checked."""
    rng = np.random.default_rng(int(seed))
    ref_mod = manifest.reference(cell.config["estimator"])
    chosen = pick_fits(fits, n_fits, rng)
    numbers = {"unscored": sum(1 for f in fits if not f.ok)}
    x = torch.from_numpy(inputs.x_train).to(device)
    y = torch.from_numpy(inputs.y_train).to(device, torch.float64)
    xv = torch.from_numpy(inputs.x_valid).to(device)
    yv = torch.from_numpy(inputs.y_valid).to(device)
    refs, edges_bad, codes_bad = {}, 0, 0
    for mb in sorted({ref_mod.max_bins(f.params) for f in chosen}):
        edges64, codes = bins.quantize(x, mb)
        prog = program_payload(mb)
        e32 = edges64.to(torch.float32)
        pe = prog["edges"].to(device)
        pc = prog["bins"].to(device)
        edges_bad += (int((pe != e32).sum()) if pe.shape == e32.shape else e32.numel())
        codes_bad += (int((pc != codes).sum()) if pc.shape == codes.shape else codes.numel())
        del pe, pc, prog
        refs[mb] = RefData(n_bins=e32.shape[1] + 1, edges32=e32, codes=codes,
                           codes_t=codes.T.contiguous(), y=y, x_valid=xv, y_valid=yv)
    del x
    release()
    numbers.update(edges_bad=edges_bad, codes_bad=codes_bad)
    worst = {"split_gap": 0.0, "leaf_err": 0.0, "auc_gap": 0.0}
    for f in chosen:
        r = ref_mod.check(f.model, f.params, f.score, refs[ref_mod.max_bins(f.params)], rng)
        for k in worst:
            worst[k] = max(worst[k], float(r[k]))
    numbers.update(worst)
    return verdict(numbers, cell.limits, len(chosen))


def verdict(numbers: dict, limits: dict, n_checked: int) -> tuple[bool, dict]:
    """``(correct, {name: (value, limit)})``: correct when every number that
    has a limit is at or below it and at least one fit was checked. The
    runs and the control (``control.py``) are judged by this alone."""
    compared = {k: (v, limits[k]) for k, v in numbers.items() if k in limits}
    correct = n_checked > 0 and all(v <= lim for v, lim in compared.values())
    compared["checked"] = (n_checked, ">= 1")
    return correct, compared
