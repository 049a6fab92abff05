"""Program spans: what the host was doing, on ``time.perf_counter_ns``.

``with span("fit", task=7): ...`` records one :class:`Span` when tracing
is on: its name, its start and end on ``perf_counter_ns``, the thread, the
enclosing span on the same thread (``parent``) and its tags. A span with
no ``task`` tag takes its parent's, so every span of a fit carries the
fit's task id. A span opened with ``thread_clock=True`` (the level loop's)
also reads the thread's CPU time at both ends (``thread_time_ns``): that
read is a system call, several µs on a busy host, so other spans skip it,
and so does every span a thread opens inside :func:`wall_clock_only`.

Tracing is on after :func:`enable` (off after :func:`disable`) and while a
``torch.profiler`` session is active, whatever its activities: a traced
run records spans with no switch of its own. Off, :func:`span` reads two
flags and returns one shared no-op. The spans stay out of the profiler:
nothing here emits a profiler event, so a device trace reads the same
with spans on or off. Lay them over a device trace by their
``perf_counter`` stamps.

Records stay in memory, at most :data:`LIMIT` of them (the rest are
counted by :func:`dropped`); :func:`spans` returns them and :func:`reset`
clears them. Nothing clears them on its own: a long-lived process that is
profiled again and again (a ``SearchService``) calls :func:`reset` before
each session it wants to read.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

__all__ = ["LIMIT", "Span", "disable", "dropped", "enable", "reset", "span", "spans",
           "wall_clock_only"]

#: records kept; later ones are dropped and counted
LIMIT = 10**6

_on = False
_records: list = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Thread:
    """A thread's open spans, innermost last, and whether its spans may read
    the CPU clock."""

    __slots__ = ("stack", "cpu")

    def __init__(self):
        self.stack = []
        self.cpu = True


def _thread() -> _Thread:
    t = getattr(_local, "t", None)
    if t is None:
        t = _local.t = _Thread()
    return t


class Span:
    """One span; ``end_ns`` and ``cpu_end_ns`` are None while it is open, and
    ``cpu_start_ns`` and ``cpu_end_ns`` stay None unless it was opened with
    ``thread_clock=True`` outside :func:`wall_clock_only`."""

    __slots__ = ("name", "tags", "id", "parent", "thread", "start_ns", "end_ns",
                 "cpu_start_ns", "cpu_end_ns", "_clock", "_stack")

    def __init__(self, name: str, tags: dict, thread_clock: bool = False):
        self.name = name
        self.tags = tags
        self.id = next(_ids)
        self.end_ns = self.cpu_end_ns = None
        self._clock = thread_clock

    def __enter__(self) -> "Span":
        t = _thread()
        stack = t.stack
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        if up is not None and "task" not in self.tags and "task" in up.tags:
            self.tags["task"] = up.tags["task"]
        self.thread = threading.get_ident()
        self._stack = stack
        stack.append(self)
        self.cpu_start_ns = time.thread_time_ns() if self._clock and t.cpu else None
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self.cpu_start_ns is not None:
            self.cpu_end_ns = time.thread_time_ns()
        stack, self._stack = self._stack, None
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:        # closed out of order (a generator closed late)
            stack.remove(self)
        _keep(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Off:
    """The shared span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _keep(s: Span) -> None:
    global _dropped
    if len(_records) < LIMIT:
        _records.append(s)
    else:
        with _lock:
            _dropped += 1


def span(name: str, thread_clock: bool = False, **tags):
    """A context manager: a :class:`Span` when tracing is on, else a no-op
    whose ``__enter__`` returns None. ``thread_clock`` makes the span read
    the thread's CPU time too."""
    if _on or _profiler._is_profiler_enabled:
        return Span(name, tags, thread_clock)
    return _OFF


@contextlib.contextmanager
def wall_clock_only():
    """Spans this thread opens inside read only ``perf_counter_ns``, even
    those that ask for the thread clock."""
    t = _thread()
    cpu, t.cpu = t.cpu, False
    try:
        yield
    finally:
        t.cpu = cpu


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording outside profiler sessions; the records stay."""
    global _on
    _on = False


def spans() -> list[Span]:
    """The closed spans, in the order they closed."""
    return list(_records)


def dropped() -> int:
    """Spans closed past :data:`LIMIT` and not kept."""
    return _dropped


def reset() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
