"""The device trace of a window, from ``torch.profiler`` (CUPTI).

Only device activity is recorded (kernels, copies, sets), so the host pays
little for the trace. :func:`reduce` turns the events into the union of
the intervals in which an operation ran on the device (``busy_s``), the
seconds and launches of each kernel name, the operations that took most
time and the longest gaps in which the device was idle, each named by the
operation that ended it. :meth:`Summary.within` reads the same within
spans of the host's clock (``time.perf_counter``), such as the rate's
window or the fits' training: the profiler stamps its events on the Unix
clock, and the trace keeps the offset between the two clocks.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    seconds: dict           # operation name -> device seconds
    launches: dict          # operation name -> count
    top_ops: list           # [[name, seconds], ...] at most 10
    idle_gaps: list         # [[name, seconds], ...] at most 10
    events: tuple = ((), np.zeros(0, np.int64), np.zeros(0, np.int64))
    #: the trace's clock (ns) less the host's ``perf_counter`` (ns)
    offset_ns: int = 0

    def seconds_of(self, parts) -> tuple[float, int]:
        """Seconds and launches of the operations whose name holds any of
        ``parts``."""
        s = n = 0
        for name, v in self.seconds.items():
            if any(p in name for p in parts):
                s += v
                n += self.launches[name]
        return s, n

    def within(self, spans) -> "Summary":
        """The trace cut to the union of ``spans``, ``(begin, end)`` pairs of
        the host's ``perf_counter`` seconds: every operation's interval
        clipped to it, and ``window_s`` its length."""
        names, starts, ends = self.events
        cuts = _union([(int(round(b * 1e9)) + self.offset_ns,
                        int(round(e * 1e9)) + self.offset_ns) for b, e in spans if e > b])
        names = np.asarray(names, dtype=object)
        keep_n, keep_s, keep_e = [], [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
        for lo, hi in cuts:
            s, e = np.maximum(starts, lo), np.minimum(ends, hi)
            i = np.flatnonzero(e > s)
            keep_n += names[i].tolist()
            keep_s.append(s[i])
            keep_e.append(e[i])
        length = sum(hi - lo for lo, hi in cuts) * 1e-9
        return reduce((keep_n, np.concatenate(keep_s), np.concatenate(keep_e)), length,
                      self.offset_ns)


def _union(spans):
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class DeviceTrace:
    """``with DeviceTrace() as t: ...`` then ``t.summary``."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._offset = _clock_offset_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window_s = t1 - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            events = _device_events(self._prof)
            _on_the_host_clock(events, self._t0, t1, self._offset)
            self.summary = reduce(events, window_s, self._offset)
        return False


def _clock_offset_ns() -> int:
    """``time.time_ns()`` (the profiler's clock) less ``perf_counter_ns()``,
    the tightest of a few readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def _on_the_host_clock(events, t0: float, t1: float, offset_ns: int) -> None:
    """Raise unless the trace's events lie in the traced window once the
    offset is applied: a trace stamped on another clock cannot be cut."""
    _, starts, ends = events
    if len(starts) == 0:
        return
    lo, hi = int(t0 * 1e9) + offset_ns - 10**9, int(t1 * 1e9) + offset_ns + 10**9
    if int(starts.min()) < lo or int(ends.max()) > hi:
        raise RuntimeError(
            f"the device trace's events ({int(starts.min())} .. {int(ends.max())} ns) lie "
            f"outside the traced window on the Unix clock ({lo} .. {hi} ns)")


def _device_events(prof):
    """(names, start ns, end ns) of every device operation in the trace."""
    from torch.autograd import DeviceType

    names, starts, ends = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        names.append(e.name())
        s = e.start_ns()
        starts.append(s)
        ends.append(s + e.duration_ns())
    return names, np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def reduce(events, window_s: float, offset_ns: int = 0) -> Summary:
    names, starts, ends = events
    seconds, launches = {}, {}
    for name, s, e in zip(names, starts.tolist(), ends.tolist()):
        seconds[name] = seconds.get(name, 0.0) + (e - s) * 1e-9
        launches[name] = launches.get(name, 0) + 1
    if len(starts) == 0:
        return Summary(window_s, 0.0, seconds, launches, [], [], events, offset_ns)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    before = np.concatenate(([s[0]], reach[:-1]))
    busy_ns = np.clip(reach - np.maximum(s, before), 0, None).sum()
    gap = np.clip(s - before, 0, None)
    idx = np.argsort(gap)[::-1][:10]
    gaps = [[f"before {names[order[i]]}", float(gap[i]) * 1e-9] for i in idx if gap[i] > 0]
    top = sorted(seconds.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s=window_s, busy_s=float(busy_ns) * 1e-9, seconds=seconds,
                   launches=launches, top_ops=[[k, v] for k, v in top], idle_gaps=gaps,
                   events=events, offset_ns=offset_ns)
