"""The share of the traced window, in %, in which the device was idle
while the innermost of the port's spans (``repro_torch.spans``) around
the idle gap's middle was one of ``spans``: the gaps ``idle_share`` sums
(``Trace.gaps()``), put down to the program span the host was in by
``Trace.breakdown``'s sweep, with the program's spans as its marks (a
span begins after the span around it).
Summed over every span name, with the idle under no program span, the
shares make ``idle_share``.  Nothing where the port recorded no span or
the profiler saw no device span."""

import dataclasses

from harness.program_spans import records


def read(run, *, spans, **_):
    recs = records(run)
    t = run.trace
    if not recs or not t.device:
        return None
    marks = [(s.start_ns, s.end_ns, s.name) for s in recs]
    idle = dataclasses.replace(t, host=marks, blocking=[]).breakdown(
        top=len(marks) + 1)["idle_gaps"]
    return 100.0 * sum(v for n, v in idle if n in spans) / t.window_s
