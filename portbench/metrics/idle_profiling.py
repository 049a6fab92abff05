"""Search (core/session.py, core/profiler.py): the share of the rate's
window in which the card ran nothing while a search profiled its
configurations (the union of the program's ``search.profile`` spans: the
row sample converted and every configuration fitted on it), in percent.
May overlap other spans' idle shares (an executor still scoring the last
search's fit), so the shares need not sum to ``device_idle``."""
from portbench import spans


def read(ctx):
    return spans.idle_share(ctx, ("search.profile",))
