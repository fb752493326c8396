"""repro_torch.core.liveloop — so far only its traces.

:mod:`~repro_torch.core.liveloop.traces` is the counterpart of the
reference's: seeded workload-scenario synthesis (bursty/long-tail/mixed/
ramp/spike arrival shapes), trace replay through the serve engine, and
re-synthesis of traces from serve-tagged FitnessCache records.  The
reference's canary state machine, evolution controller and operator CLI
are later work (ROADMAP.md, queue 1).
"""

from .traces import (SCENARIOS, ReplayReport, TimedRequest, Trace,
                     demo_requests, replay, synthesize, trace_from_records,
                     trace_from_spec)

__all__ = [
    "SCENARIOS", "ReplayReport", "TimedRequest", "Trace",
    "demo_requests", "replay", "synthesize", "trace_from_records",
    "trace_from_spec",
]
