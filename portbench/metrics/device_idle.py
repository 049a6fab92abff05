"""Device: the share of the rate's window (its start to its last result) in
which no operation ran on the card (one minus the union of the device
operations' intervals), in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.within(ctx.rate_span())
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
