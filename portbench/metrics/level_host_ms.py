"""Level loops (tabular/gbdt.py, tabular/forest.py, tabular/draws.py): the
seconds in which the card ran nothing while a fit that came back was
training (the union of their training spans), over the tree levels those
fits grew (counted from their trees), in milliseconds a level. Scoring,
profiling and the search between fits lie outside the spans; with two
executors, the other's scoring lies inside where it overlaps."""


def read(ctx):
    if ctx.trace is None or ctx.work is None or ctx.work.levels <= 0:
        return None
    t = ctx.trace.within(ctx.window.training)
    if t.window_s <= 0:
        return None
    return 1e3 * (t.window_s - t.busy_s) / ctx.work.levels
