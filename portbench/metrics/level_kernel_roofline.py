"""Kernels (kernels/ops.py, kernels/histogram.py, csrc/histogram.cu): the
least time of the levels and leaf sums of the fits that came back in the
window (their least bytes at the peak memory rate, ``counts/tree_level.py``)
over the device time of the GBDT kernels while those fits were training
(the union of their training spans), in percent. The profiler's sample
fits run outside the spans; a fit still in flight on another executor
inside them adds time without bytes, so the share reads low by its part."""

KERNELS = ("level_stats", "level_group", "level_accumulate", "split_scan")


def read(ctx):
    if ctx.trace is None or ctx.work is None or ctx.work.bytes <= 0:
        return None
    seconds, _ = ctx.trace.within(ctx.window.training).seconds_of(KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * ctx.work.bytes / ctx.peaks["hbm_bytes_per_s"] / seconds
