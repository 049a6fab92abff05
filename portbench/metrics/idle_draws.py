"""Level loops (tabular/forest.py, tabular/draws.py): the share of the
rate's window in which the card ran nothing while a forest tree's
bootstrap weights and feature permutation were drawn (the union of the
program's ``tree.draws`` spans), in percent. May overlap other spans'
idle shares (the other executor scoring), so the shares need not sum to
``device_idle``."""
from portbench import spans


def read(ctx):
    return spans.idle_share(ctx, ("tree.draws",))
