"""One run of one cell: inputs, set-up, the measured window, the metrics,
the comparison that decides ``correct``, and the result line.

``run.py`` calls :func:`run_cell` on the card; the CPU tests call it with
``device="cpu"`` at small sizes (a traced run needs the card).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

from portbench import check, manifest
from portbench.trace import DeviceTrace, Summary
from portbench.window import Window
from portbench.work import Work

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Modules whose top-level name (the part before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a metric reader may read."""
    cell: manifest.Cell
    window: Window
    setup: dict                       # setup_s, and convert_s: set-up's conversions
    trace: Summary | None = None
    work: Work | None = None    # least bytes and operations, and levels, of the window's trees
    peaks: dict = dataclasses.field(default_factory=manifest.peaks)

    def rate_span(self) -> list[tuple[float, float]]:
        """The rate's window: its start to its last result."""
        return [(self.window.t_begin, self.window.t_last)]


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _work(cell, win: Window, payloads: dict) -> Work:
    from portbench.work import WindowWork

    ref_mod = manifest.reference(cell.config["estimator"])
    ww = WindowWork(ref_mod)
    total = Work()
    for fit in win.fits:
        if fit.ok:
            total = total + ww.of_fit(fit, payloads[ref_mod.max_bins(fit.params)])
    return total


def _release(state) -> None:
    import torch

    from repro_torch.core import prepared_data_cache
    from repro_torch.core.evaluation import predict_compile_cache
    from repro_torch.core.fusion import compile_cache

    state.payloads.clear()
    prepared_data_cache().clear()
    compile_cache().clear()
    predict_compile_cache().clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The result line of one run (see ``run.py``); ``t_start`` is the host
    clock at the process's start, from which set-up is counted."""
    import torch

    import repro_torch.tabular  # noqa: F401  (registers the estimators)
    from repro_torch import set_default_device

    set_default_device(device)
    cfg, tr = cell.config, cell.traffic
    inputs = manifest.dataset(cfg["dataset"]["kind"]).make(cfg["dataset"], seed, device)
    drv = manifest.driver(tr["kind"])
    state = drv.setup(cell, inputs, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    summary = None
    if trace:
        with DeviceTrace() as dt:
            win = drv.window(state, seconds)
        summary = dt.summary
    else:
        win = drv.window(state, seconds)
    _sync(device)
    cuda = str(device).startswith("cuda")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    work = _work(cell, win, state.payloads) if trace else None
    ctx = Context(cell=cell, window=win,
                  setup={"setup_s": setup_s, "convert_s": state.convert_s},
                  trace=summary, work=work)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = manifest.metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t_check = time.perf_counter()
    correct, compared = check.judge(
        cell, inputs, win.fits, seed, device,
        program_payload=lambda mb: state.payloads[mb], release=lambda: _release(state),
        n_fits=int(tr.get("check_fits", 3)))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": bool(correct), "attempted": len(win.fits),
              "failed": sum(1 for f in win.fits if not f.ok), "metrics": metrics,
              "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.top_ops, "idle_gaps": summary.idle_gaps}
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    print(f"setup {setup_s:.1f} s, window {win.t_end - win.t_begin:.1f} s "
          f"({len(win.fits)} fits, last at {win.t_last - win.t_begin:.1f} s), "
          f"check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    return result
