"""Search layer (core/session.py, profiler.py, scheduler.py): the share of
the window's searches' seconds spent profiling, from each search's
``SearchStats`` (profiling seconds over total seconds), in percent."""


def read(ctx):
    searches = ctx.window.searches
    total = sum(s.total_seconds for s in searches)
    if not searches or total <= 0:
        return None
    return 100.0 * sum(s.profiling_seconds for s in searches) / total
