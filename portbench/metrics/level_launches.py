"""Kernels: device launches of the GBDT kernels while the fits that came
back in the window were training (the union of their training spans), over
the tree levels those fits grew (counted from their trees; the trees' leaf
sums are launches too). A fit still in flight on another executor inside
the spans adds launches without levels."""

KERNELS = ("level_stats", "level_group", "level_accumulate", "split_scan")


def read(ctx):
    if ctx.trace is None or ctx.work is None or ctx.work.levels <= 0:
        return None
    _, launches = ctx.trace.within(ctx.window.training).seconds_of(KERNELS)
    return launches / ctx.work.levels if launches else None
