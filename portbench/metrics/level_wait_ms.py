"""Level loops (tabular/gbdt.py ``build_tree``): the level loop's time off
the CPU, over the program's ``level`` spans that end in the rate's window
outside the profiler's sample fits (no ``profile.sample`` ancestor): the
sum of each span's wall time less its thread's CPU time, over their
count, in milliseconds a level (spans that read no CPU clock are left
out). Waits for the interpreter lock, blocking waits that sleep and
preemption all count; a span is the host's enqueue of the level, not the
card's work."""
from portbench import spans


def read(ctx):
    found = spans.ending_in_window(ctx, "level")
    if not found:
        return None
    by_id = {s.id: s for s in spans.recorded()}

    def sampled(s) -> bool:
        up = by_id.get(s.parent)
        while up is not None and up.name != "profile.sample":
            up = by_id.get(up.parent)
        return up is not None

    kept = [s for s in found if s.cpu_end_ns is not None and not sampled(s)]
    if not kept:
        return None
    off = sum((s.end_ns - s.start_ns) - (s.cpu_end_ns - s.cpu_start_ns) for s in kept)
    return 1e-6 * off / len(kept)
