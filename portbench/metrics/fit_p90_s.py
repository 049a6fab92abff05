"""Executors (core/executor.py): the 90th percentile over the window's fits
of ``TaskResult.train_seconds + eval_seconds``. Host clocks, but a fit ends
in a host copy of its trees, so the card has finished its work."""
import statistics


def read(ctx):
    s = [f.train_s + f.eval_s for f in ctx.window.fits if f.ok]
    if len(s) < 2:
        return None
    return statistics.quantiles(s, n=10, method="inclusive")[8]
