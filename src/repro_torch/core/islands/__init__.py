"""The island-model search orchestrator (re-exported from
:mod:`repro_torch.core`): asynchronous multi-population GEVO with
migration, a shared concurrency-safe fitness cache, and fault-tolerant
bit-exact resume.

Public surface:

* :class:`IslandOrchestrator`, :class:`IslandResult` — run N GevoML
  populations with periodic migration over one workload;
* :class:`IslandSpec`, :func:`default_island_specs` — per-island search
  configuration and the heterogeneous default palette;
* :func:`plan`, :class:`CorePlan` — map islands (and their evaluator
  workers) onto the machine's cores and cards;
* ``TOPOLOGIES``, :func:`migration_edges` — ring / full / broadcast_best
  migration patterns;
* :func:`run_island_epoch` — the per-epoch worker entry point (also the
  spawn target for process-mode islands).

``python -m repro_torch.core.islands`` runs a fleet from the command line.
"""

from .config import (CONTEXT_RESERVE_BYTES, CorePlan, IslandSpec,
                     default_island_specs, plan)
from .migration import compute_migration, select_migrants
from .orchestrator import IslandOrchestrator, IslandResult
from .topology import TOPOLOGIES, migration_edges
from .worker import run_island_epoch

__all__ = [
    "IslandOrchestrator", "IslandResult",
    "IslandSpec", "default_island_specs",
    "CorePlan", "plan", "CONTEXT_RESERVE_BYTES",
    "TOPOLOGIES", "migration_edges",
    "compute_migration", "select_migrants",
    "run_island_epoch",
]
