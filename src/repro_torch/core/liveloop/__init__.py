"""repro_torch.core.liveloop — continuous evolution under replayed traffic,
the counterpart of the reference's ``repro.core.liveloop``.

The subsystem that closes evolve→serve→measure→promote as one control
loop (GEVO's re-validate-winners-in-the-target-application methodology
made operational):

* :mod:`~repro_torch.core.liveloop.traces` — seeded workload-scenario
  synthesis (bursty/long-tail/mixed/ramp/spike arrival shapes), replay through
  the serve engine, and re-synthesis of traces from serve-tagged
  FitnessCache records;
* :mod:`~repro_torch.core.liveloop.canary` — the journaled promotion state
  machine (candidate→canary→promoted | rolled_back) with deterministic
  traffic splits and pure-function guardrail verdicts;
* :mod:`~repro_torch.core.liveloop.controller` — the background evolution
  loop: a GevoML island over the full serve-plan space (engine schedule + KV
  memory plan + replica layout) with the live surrogate, candidate export
  through the ArtifactRegistry, canary windows (multi-replica plans
  canary through the deploy
  :class:`~repro_torch.core.deploy.router.Router`), and journal/registry
  reconciliation, all kill-anywhere resumable;
* ``python -m repro_torch.core.liveloop`` — the operator CLI (``synth``,
  ``run``, ``status``, ``promote``, ``rollback``).
"""

from .canary import (CANARY, CANDIDATE, PROMOTED, ROLLED_BACK, CanaryBook,
                     Guardrails, split_indices, verdict_of)
from .controller import LiveLoopController, genome_fingerprint, simulate
from .traces import (SCENARIOS, ReplayReport, TimedRequest, Trace,
                     demo_requests, replay, synthesize, trace_from_records,
                     trace_from_spec)

__all__ = [
    "CANARY", "CANDIDATE", "PROMOTED", "ROLLED_BACK",
    "CanaryBook", "Guardrails", "split_indices", "verdict_of",
    "LiveLoopController", "genome_fingerprint", "simulate",
    "SCENARIOS", "ReplayReport", "TimedRequest", "Trace",
    "demo_requests", "replay", "synthesize", "trace_from_records",
    "trace_from_spec",
]
