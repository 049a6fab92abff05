"""Cells of ``BENCHMARK.json`` cut to a size a CPU test run holds: a few
thousand rows, a grid of a few small configurations, a window of a second
or two. Only the sizes change; the drivers, the reference and the
comparison are the benchmark's own."""
from __future__ import annotations

import time

from portbench import harness, manifest

ROWS = 3000
#: long enough for a fit to come back while other test workers load the CPU
SECONDS = 4.0


def cell(name: str) -> manifest.Cell:
    c = manifest.cell(name)
    c.config["dataset"]["rows"] = ROWS
    if c.traffic["kind"] == "grid":
        if c.config["estimator"] == "gbdt":
            c.config["grid"] = {"eta": [0.3], "round": [3, 4], "max_bin": [16, 32],
                                "max_depth": [3]}
        else:
            c.config["grid"] = {"n_estimators": [3, 4], "max_depth": [3, 4]}
    else:
        c.traffic["params"] = {**c.traffic["params"], "round": 4, "max_bin": 32,
                               "max_depth": 3}
    return c


def run(name: str, seed: int = 20260101, seconds: float = SECONDS) -> dict:
    """One untraced run of the cut cell on the CPU, set-up counted from here."""
    return harness.run_cell(cell(name), seed, seconds, False, "cpu", time.perf_counter())
