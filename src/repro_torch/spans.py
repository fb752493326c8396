"""The program's own spans: named intervals of the host's time, with the
counters of the work inside them, on the profiler's clock.

``span(name, device=False)`` is a context manager put where the work
happens (``core/deploy/engine.py``, ``train/train_step.py``).  It records
only while a recording is on: inside :func:`recording`, or while torch's
profiler runs (``torch.profiler.profile``), whose spans then go to a
recording of their own that :func:`take_profiled` hands over; that one
keeps the newest ``PROFILED_MAX`` spans, so a process that profiles and
never takes them holds no more.  Otherwise it returns one shared no-op
object, which is false: no allocation, no CUDA event, no
``record_function``; the cost is a check of two module-level values (the
second is ``torch.autograd.profiler._is_profiler_enabled``, the flag torch
keeps for such Python checks).

A recorded span is a :class:`Span`: its name, its parent (the innermost
span open on the same thread when it began, in the same recording), start
and end in ns from ``time.time_ns()``, the thread's identifier and its
attributes (the counters, given by ``set`` inside the span; a call site
computes them only where the span is true, so they cost nothing when
nothing records).  ``time.time_ns()`` is the clock on which the profiler's
events are cut to a traced window, so an idle gap of the device can be put
down to the span around it.  Each span also enters
``torch.profiler.record_function(name)``, so the profiler's timeline shows
it; its host interval lies inside that range.  On the device's timeline
that range is a user annotation, not a kernel: a reader of a profile's
device events leaves those out.

With ``device=True`` and CUDA initialized, a span records a
``torch.cuda.Event(enable_timing=True)`` on the current stream at entry
and at exit.  Its ``device_ms`` is the device's time from the stream
reaching the first event to it reaching the second: the span's work and
any stall of the device in between (the device waiting on the host
counts).  The events are read when the recording is closed or handed
over, which waits for the second event.

Counters are attributes of spans, not a second structure.  Spans stay in
memory; nothing here writes a file.  This module imports nothing of the
package.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

# spans the profiler's recording keeps: a traced benchmark window makes a
# few thousand
PROFILED_MAX = 1 << 16


class Recording:
    """The spans of one recording, in the order they began; with
    ``limit``, the newest ``limit`` of them."""

    __slots__ = ("spans", "_open")

    def __init__(self, limit: int | None = None):
        self.spans = [] if limit is None else deque(maxlen=limit)
        self._open: dict[int, list[Span]] = {}   # thread -> open spans

    def resolve(self) -> list[Span]:
        """Read each closed device span's events into its ``device_ms``
        (waiting for them) and return the spans."""
        for s in self.spans:
            if s._events is not None and s.end_ns:
                start, end = s._events
                end.synchronize()
                s.device_ms = start.elapsed_time(end)
                s._events = None
        return list(self.spans)


class Span:
    """One recorded span; ``set`` adds its counters."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "thread", "attrs",
                 "device_ms", "_rec", "_device", "_rf", "_events")

    def __init__(self, rec: Recording, name: str, device: bool):
        self.name, self.attrs, self.device_ms = name, {}, None
        self._rec, self._device, self._events = rec, device, None
        self.parent = None
        self.start_ns = self.end_ns = 0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        self.thread = threading.get_ident()
        stack = self._rec._open.setdefault(self.thread, [])
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        if self._device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._rec.spans.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        self._rf.__exit__(*exc)
        self._rf = None
        self._rec._open[self.thread].pop()


class _Off:
    """The span of no recording: false, and does nothing."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        return None


_OFF = _Off()
_active: Recording | None = None     # entered by recording()
_profiled: Recording | None = None   # spans made under the profiler


def span(name: str, device: bool = False):
    """A span named ``name`` (see the module docstring); ``device`` times
    it on the device as well."""
    rec = _active
    if rec is None:
        if not _profiler._is_profiler_enabled:
            return _OFF
        rec = _profile_recording()
    return Span(rec, name, device)


def _profile_recording() -> Recording:
    global _profiled
    if _profiled is None:
        _profiled = Recording(PROFILED_MAX)
    return _profiled


@contextlib.contextmanager
def recording():
    """Record every span made while the block runs, the profiler on or
    off; yields the list of spans, resolved when the block ends."""
    global _active
    prev, rec = _active, Recording()
    _active = rec
    try:
        yield rec.spans
    finally:
        _active = prev
        rec.resolve()


def take_profiled() -> list[Span]:
    """Hand over the spans recorded under torch's profiler, outside any
    :func:`recording`, since the last call (the newest ``PROFILED_MAX``),
    resolved; the next ones go to a new recording."""
    global _profiled
    rec, _profiled = _profiled, None
    return [] if rec is None else rec.resolve()
