"""The program's spans for the metric readers.

A traced run wraps its window in a ``torch.profiler`` session, which turns
on the port's recorder (``repro_torch.tracing``): every span the program
opened in the window is kept, stamped on ``perf_counter_ns``, the host
clock the rate's window and :meth:`trace.Summary.within` use. A program
without the recorder gives None here, and so does a record that dropped
spans past its limit: its readers give None rather than read a part.
"""
from __future__ import annotations

import importlib

NS = 1e-9


def recorded():
    """The closed spans of the program's recorder, or None where the
    program has none or the recorder dropped spans."""
    try:
        tracing = importlib.import_module("repro_torch.tracing")
    except ImportError:
        return None
    if tracing.dropped():
        return None
    return tracing.spans()


def idle_share(ctx, names) -> float | None:
    """The seconds in which the card ran nothing inside the union of the
    spans named ``names`` (clipped to the rate's window), over the rate's
    window, in percent. None without a trace, without the recorder, or
    where no such span reaches into the window."""
    found = recorded()
    if ctx.trace is None or found is None:
        return None
    (lo, hi), = ctx.rate_span()
    cuts = [(max(s.start_ns * NS, lo), min(s.end_ns * NS, hi))
            for s in found if s.name in names]
    cuts = [(b, e) for b, e in cuts if e > b]
    if not cuts or hi <= lo:
        return None
    t = ctx.trace.within(cuts)
    return 100.0 * (t.window_s - t.busy_s) / (hi - lo)


def ending_in_window(ctx, name: str) -> list | None:
    """The spans named ``name`` that end inside the rate's window, or None
    without the recorder."""
    found = recorded()
    if found is None:
        return None
    (lo, hi), = ctx.rate_span()
    return [s for s in found if s.name == name and lo <= s.end_ns * NS <= hi]
