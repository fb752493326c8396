"""Migration topologies: who sends elites to whom.

A topology is a pure function from island count to a directed edge map
``{dst: (src, ...)}``.  Three are built in:

* ``ring`` — island *i* receives from island *i-1* (mod N).  The classic
  island-model default: discoveries percolate slowly, preserving diversity
  the longest.
* ``full`` — every island receives from every other island.  Fastest
  mixing, closest to a single panmictic population.
* ``broadcast_best`` — every island receives the *globally* best migrants,
  selected from the pooled populations of all islands (NSGA-II rank +
  crowding over the union).  One-to-all elitism: strong exploitation
  pressure, still diversity-preserving because only ``n_migrants``
  individuals move.
"""

from __future__ import annotations

TOPOLOGIES = ("ring", "full", "broadcast_best")

# broadcast_best pools all populations before selecting; the edge map uses
# this sentinel as the source tag instead of an island index.
POOL = "pool"


def validate_topology(name: str) -> str:
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; "
                         f"choose from {TOPOLOGIES}")
    return name


def migration_edges(topology: str, n_islands: int) -> dict[int, tuple]:
    """Directed migration edges ``{dst: (src, ...)}`` for ``n_islands``.
    Sources are island indices, or the ``POOL`` sentinel for topologies that
    select from the pooled union of all populations."""
    validate_topology(topology)
    if n_islands < 2:
        return {i: () for i in range(n_islands)}
    if topology == "ring":
        return {i: ((i - 1) % n_islands,) for i in range(n_islands)}
    if topology == "full":
        return {i: tuple(j for j in range(n_islands) if j != i)
                for i in range(n_islands)}
    return {i: (POOL,) for i in range(n_islands)}   # broadcast_best
