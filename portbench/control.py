"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in bfloat16, the
precision below the configurations' float32, judged by the same
comparison (``check.verdict`` against the cell's limits), which has to
find it not correct. Its readings set the upper end of each limit
(``PERF.md`` gives them); the benchmark's runs do not run it.

    python3 portbench/control.py --workload gbdt-higgs.refit --seeds 11,12,13

On the card at the cell's own size: the seed's rows, the reference's own
quantization of them (the integer codes, which hold no precision to
lower), and the fit of the configuration a run always checks (the cell's
with the most trees) grown, scored and then checked as a run's fits are.
Prints one JSON line a seed: the readings, ``correct`` and ``compared``
(each number with its limit).
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def checked_params(cell) -> dict:
    """The configuration of the cell with the most trees (then the deepest),
    the first such in the grid's order: the fit every run checks."""
    cfg = cell.config
    fixed = cfg.get("fixed", {})
    if cell.traffic["kind"] == "refit":
        return {**fixed, **cell.traffic["params"]}
    keys = list(cfg["grid"])
    grid = [{**fixed, **dict(zip(keys, combo))}
            for combo in itertools.product(*cfg["grid"].values())]
    from portbench import manifest

    ref = manifest.reference(cfg["estimator"])
    return max(grid, key=lambda p: (ref.n_trees(p), ref.depth(p)))


def readings(cell, seed: int, device, dtype=None) -> dict:
    """Split, leaf and score readings of the control fit at ``seed``, and
    the comparison's verdict on them under the cell's limits."""
    import torch

    from portbench import check, manifest
    from portbench.reference import bins

    dtype = dtype or torch.bfloat16
    cfg = cell.config
    inputs = manifest.dataset(cfg["dataset"]["kind"]).make(cfg["dataset"], seed, device)
    ref_mod = manifest.reference(cfg["estimator"])
    p = checked_params(cell)
    x = torch.from_numpy(inputs.x_train).to(device)
    edges, codes = bins.quantize(x, ref_mod.max_bins(p))
    del x
    e32 = edges.to(torch.float32)
    ref = check.RefData(n_bins=e32.shape[1] + 1, edges32=e32, codes=codes,
                        codes_t=codes.T.contiguous(),
                        y=torch.from_numpy(inputs.y_train).to(device, torch.float64),
                        x_valid=torch.from_numpy(inputs.x_valid).to(device),
                        y_valid=torch.from_numpy(inputs.y_valid).to(device))
    t0 = time.perf_counter()
    model, score = ref_mod.control_fit(p, ref, dtype)
    fit_s = time.perf_counter() - t0
    r = ref_mod.check(model, p, score, ref, np.random.default_rng(int(seed)))
    correct, compared = check.verdict(r, cell.limits, 1)
    return {**r, "fit_s": fit_s, "params": p, "seed": seed, "correct": correct,
            "compared": {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import manifest

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps({"workload": args.workload, **readings(cell, int(s), "cuda")}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
