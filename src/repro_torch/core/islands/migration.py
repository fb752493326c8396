"""Migrant selection and the migration log's wire format.

Migrants are selected by the same NSGA-II (rank, crowding) environmental
selection the search uses for elites, so "send your best" means exactly what
selection means everywhere else in the engine.  A migration round is
recorded as JSON-able docs (patch docs + fitness + source island), which is
what the orchestrator's manifest persists — a resumed run replays the
recorded migrants instead of recomputing them, so resume is bit-exact even
when the process died between writing the migration log and running the
receiving islands.
"""

from __future__ import annotations

import numpy as np

from ..nsga2 import rank_select
from .topology import POOL, migration_edges

# A migrant doc: {"src": island-index | "pool", "edits": patch_doc,
#                 "fitness": [time, error]}


def select_migrants(pop_docs: list[dict], n: int) -> list[dict]:
    """Top-``n`` members of one population (docs with a "fitness" field) by
    NSGA-II (rank, crowding) — deterministic for a fixed input order."""
    if not pop_docs or n < 1:
        return []
    objs = np.array([d["fitness"] for d in pop_docs], dtype=float)
    _, _, idx = rank_select(objs, min(n, len(pop_docs)))
    return [pop_docs[i] for i in idx]


def compute_migration(topology: str, populations: list[list[dict]],
                      n_migrants: int) -> dict[str, list[dict]]:
    """One migration round: for each destination island, the migrant docs it
    receives under ``topology``.  ``populations[i]`` is island *i*'s
    population as checkpoint docs (``{"edits": ..., "fitness": ...}``).
    Keys are stringified island indices (JSON object keys)."""
    n = len(populations)
    out: dict[str, list[dict]] = {str(i): [] for i in range(n)}
    if n < 2 or n_migrants < 1:
        return out
    edges = migration_edges(topology, n)
    pooled = None
    for dst, srcs in edges.items():
        for src in srcs:
            if src == POOL:
                if pooled is None:
                    union = [dict(d, src=j)
                             for j, pop in enumerate(populations)
                             for d in pop]
                    pooled = select_migrants(union, n_migrants)
                picks = pooled
            else:
                picks = [dict(d, src=src)
                         for d in select_migrants(populations[src],
                                                  n_migrants)]
            out[str(dst)].extend(
                {"src": m["src"], "edits": m["edits"],
                 "fitness": list(m["fitness"])} for m in picks)
    return out
