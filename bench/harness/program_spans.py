"""The port's own spans in a traced window: ``repro_torch.spans``.

The port records its spans while torch's profiler runs (its module
docstring); after the run the first reader that asks takes them from the
port, keeps those that began inside the window, and leaves them on the
window's ``Trace`` as ``program`` for the other readers of the run.  A
``Trace`` that already carries ``program`` is read as it is.  A port
without spans, or a window in which none began, gives nothing.

A record is read by its attributes: ``name``, ``parent`` (a record or
None), ``start_ns`` and ``end_ns`` (``time.time_ns()``, the clock of the
window's bounds), ``thread``, ``attrs`` (its counters) and ``device_ms``
(None where it was not timed on the device).
"""

from __future__ import annotations


def records(run) -> list | None:
    """The program's spans that began in the traced window of ``run``, in
    the order they began, or None."""
    t = run.trace
    if t is None:
        return None
    if getattr(t, "program", None) is None:
        try:
            from repro_torch import spans
        except ImportError:
            return None
        t.program = [s for s in spans.take_profiled()
                     if t.t0_ns <= s.start_ns < t.t1_ns]
    return t.program or None


def by_parent(recs: list, name: str, parent: str) -> dict:
    """The records named ``name`` grouped by their nearest enclosing
    record named ``parent`` (keyed by its identity); those outside any such
    record are left out."""
    out: dict = {}
    for s in recs:
        if s.name != name:
            continue
        p = s.parent
        while p is not None and p.name != parent:
            p = p.parent
        if p is not None:
            out.setdefault(id(p), []).append(s)
    return out

