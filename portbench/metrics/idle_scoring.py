"""Executors (core/evaluation.py): the share of the rate's window in which
the card ran nothing while an executor was scoring (the union of the
program's ``score`` spans: the eval rows resolved, the prediction and its
copy to the host, the metric), in percent. The idle shares of different
spans may overlap (one executor scores while the other draws or trains),
so they need not sum to ``device_idle``."""
from portbench import spans


def read(ctx):
    return spans.idle_share(ctx, ("score",))
