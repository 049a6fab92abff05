"""Executors (core/evaluation.py, core/results.py): the median length of
the program's ``score.metric`` spans (the validation metric's reduction
on the host, AUC in every cell) that end in the rate's window, in
seconds."""
import statistics

from portbench import spans


def read(ctx):
    found = spans.ending_in_window(ctx, "score.metric")
    return statistics.median(s.seconds for s in found) if found else None
