"""The deployment layer: close the evolve → select → export → serve
gap.

Searches (:mod:`repro_torch.core.search`, :mod:`repro_torch.core.islands`)
end with recorded Pareto fronts; this package turns a recorded front into
served traffic:

* :class:`ParetoFront` — load any recorded search output and
  :meth:`~ParetoFront.select` under a constraint (the paper's "fastest
  variant within a 2% accuracy relaxation" as code);
* :class:`ArtifactRegistry` / :class:`Artifact` — fingerprinted, atomically
  written winner manifests keyed by ``(kind, name, shape)``, with
  byte-exact round-trips and verified resolution;
* :class:`ServeEngine` — the continuous-batching serving loop (request
  queue, micro-batched prefill + decode interleaving, default/evolved
  variant routing, measured latency fed back into the shared
  :class:`~repro_torch.core.evaluator.FitnessCache` under a ``serve`` tag),
  on the GPU unless the caller names another device;
* :class:`KVPlan` (:mod:`~repro_torch.core.deploy.kvplan`) — the KV memory
  plan (page size, cache dtype, replica layout) as searchable genome knobs
  merged into :func:`serve_schedule_space`, with the paged codec and its
  measured decode-error oracle;
* :class:`Router` (:mod:`~repro_torch.core.deploy.router`) — fan traffic
  over N engine replicas, sharing one set of weights on the device or each
  placed on a submesh of a launch mesh (:func:`replica_meshes`; one
  process a rank), with heartbeat-monitored failover and aggregate fitness
  feedback.

``python -m repro_torch.core.deploy`` selects from recorded fronts and
manages the registry; ``python -m repro_torch.core.deploy.router`` serves
a synthesized trace through a router.
"""

from .engine import (DEFAULT_ENGINE_SCHEDULE, DEFAULT_SERVE_PLAN,
                     ENGINE_SPACE, SERVE_PLAN_KEYS, SERVE_SPACE,
                     ServeEngine, ServeRequest, ServeResult,
                     apply_plan_artifact, build_serve_workload, demo_trace,
                     engine_schedule_from, oneshot_generate,
                     serve_plan_from, serve_schedule_space)
from .front import FrontMember, ParetoFront
from .kvplan import (DEFAULT_KV_PLAN, KV_ERROR_GATE, KV_SPACE, KVPlan,
                     PagedKVCache, cache_error, measure_cache_error,
                     quantize_pages, roundtrip_error)
from .registry import Artifact, ArtifactRegistry, shape_tag
from .router import Router, build_router, replica_meshes

__all__ = [
    "ParetoFront", "FrontMember",
    "Artifact", "ArtifactRegistry", "shape_tag",
    "ServeEngine", "ServeRequest", "ServeResult",
    "apply_plan_artifact", "engine_schedule_from", "serve_plan_from",
    "oneshot_generate", "demo_trace", "build_serve_workload",
    "serve_schedule_space",
    "SERVE_SPACE", "ENGINE_SPACE", "SERVE_PLAN_KEYS",
    "DEFAULT_ENGINE_SCHEDULE", "DEFAULT_SERVE_PLAN",
    "KVPlan", "PagedKVCache", "KV_SPACE", "DEFAULT_KV_PLAN",
    "KV_ERROR_GATE", "cache_error", "roundtrip_error", "quantize_pages",
    "measure_cache_error",
    "Router", "build_router", "replica_meshes",
]
