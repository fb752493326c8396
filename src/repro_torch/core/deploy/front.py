"""Pareto-front queries: turn any recorded search output into a deployable
selection.

The paper's headline result is a *selection under a constraint* — the
fastest GEVO-ML variant within a 2% accuracy relaxation (90.43% speedup at
91.2%→89.3% on MobileNet).  After a search has run, that rule is all a
deployment needs: "of the recorded front, give me the member minimizing
objective A subject to objective B staying within a slack of the front's
best".  :class:`ParetoFront` is that query layer, decoupled from the search
engine — it loads from *any* recorded output (a GevoML checkpoint, an
island-run directory, a GEVO-Shard result json, or its own export doc) and
answers :meth:`select` without rebuilding the workload or re-evaluating
anything.

A loaded front carries, per member, the fitness tuple plus the member's
*recipe* (patch edit docs for IR searches, decoded genomes for schedule
searches) and provenance, so the selected winner can be handed straight to
the :class:`~repro_torch.core.deploy.registry.ArtifactRegistry` for serving.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ..nsga2 import pareto_front as _pareto_indices

OBJECTIVES = ("time", "error")


@dataclass(frozen=True)
class FrontMember:
    """One recorded Pareto-front member: its fitness tuple, the recipe that
    reproduces it (``patch`` edit docs for IR variants, ``genome`` for
    schedule variants — whichever the source recorded), and ``source``
    provenance (island name, checkpoint path, ...)."""

    fitness: tuple[float, float]
    patch: tuple | None = None       # canonical edit docs (JSON-able)
    genome: dict | None = None       # decoded schedule genome, if recorded
    source: str = ""

    def to_doc(self) -> dict:
        return {"fitness": list(self.fitness),
                "patch": list(self.patch) if self.patch is not None else None,
                "genome": self.genome, "source": self.source}

    @staticmethod
    def from_doc(d: dict) -> "FrontMember":
        patch = d.get("patch")
        return FrontMember(
            fitness=tuple(d["fitness"]),
            patch=tuple(patch) if patch is not None else None,
            genome=d.get("genome"), source=d.get("source", ""))


@dataclass(frozen=True)
class ParetoFront:
    """An immutable, queryable recorded Pareto front.

    ``objectives`` names the fitness axes (both minimized; the default
    ``("time", "error")`` matches every workload family in this repo);
    ``origin`` records where the front came from.  Construct with
    :meth:`load` (any recorded search output), :meth:`from_members`, or the
    ``SearchResult.to_front()`` / ``IslandResult.to_front()`` hooks.
    """

    members: tuple[FrontMember, ...]
    objectives: tuple[str, str] = OBJECTIVES
    origin: str = ""
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.members:
            raise ValueError("a ParetoFront needs at least one member")
        if len(self.objectives) != 2:
            raise ValueError("fronts in this repo are 2-objective")

    def __len__(self) -> int:
        return len(self.members)

    def __iter__(self):
        return iter(self.members)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_members(members, objectives=OBJECTIVES, origin="",
                     meta=None, prune=True) -> "ParetoFront":
        """Build from an iterable of :class:`FrontMember` (or their docs).
        ``prune=True`` drops dominated members and duplicates — loaders feed
        whole populations through this, so a front query never returns a
        dominated individual."""
        ms = [m if isinstance(m, FrontMember) else FrontMember.from_doc(m)
              for m in members]
        if prune and ms:
            objs = np.array([m.fitness for m in ms], dtype=float)
            keep = _pareto_indices(objs)
            seen, pruned = set(), []
            for i in sorted(keep, key=lambda k: ms[k].fitness):
                if ms[i].fitness not in seen:
                    seen.add(ms[i].fitness)
                    pruned.append(ms[i])
            ms = pruned
        return ParetoFront(members=tuple(ms), objectives=tuple(objectives),
                           origin=origin, meta=dict(meta or {}))

    @staticmethod
    def load(path: str) -> "ParetoFront":
        """Load a front from any recorded search output:

        * a front export doc (written by :meth:`export`),
        * a GevoML checkpoint json (``gen_NNNN.json`` / ``latest.json`` —
          the checkpointed population, pruned to its front),
        * a GEVO-Shard / autotune result json (``--out``; its ``pareto``
          list of genome+fitness records),
        * an island-run directory or its ``manifest.json`` (every island's
          latest checkpointed population, merged and pruned).
        """
        if os.path.isdir(path):
            return ParetoFront._load_island_dir(path)
        doc = json.load(open(path))
        if "members" in doc:                       # native export
            return ParetoFront(
                members=tuple(FrontMember.from_doc(m) for m in doc["members"]),
                objectives=tuple(doc.get("objectives", OBJECTIVES)),
                origin=doc.get("origin", path), meta=doc.get("meta", {}))
        if "population" in doc:                    # GevoML checkpoint
            return ParetoFront.from_members(
                (FrontMember(fitness=tuple(p["fitness"]),
                             patch=tuple(p["edits"]), source=path)
                 for p in doc["population"]),
                origin=path,
                meta={"gen": doc.get("gen"),
                      "program_fingerprint": doc.get("program_fingerprint")})
        if "pareto" in doc:                        # autotune --out result
            return ParetoFront.from_members(
                (FrontMember(fitness=tuple(p["fitness"]),
                             genome=p.get("genome"), source=path)
                 for p in doc["pareto"]),
                origin=path, meta={"arch": doc.get("arch"),
                                   "shape": doc.get("shape")})
        if "specs" in doc and "rounds" in doc:     # island manifest
            return ParetoFront._load_island_dir(os.path.dirname(path) or ".")
        raise ValueError(f"unrecognized front source {path!r}")

    @staticmethod
    def _load_island_dir(root: str) -> "ParetoFront":
        manifest_path = os.path.join(root, "manifest.json")
        if not os.path.exists(manifest_path):
            raise ValueError(f"{root!r} is not an island run "
                             "(no manifest.json)")
        manifest = json.load(open(manifest_path))
        members = []
        for spec in manifest["specs"]:
            latest = os.path.join(root, spec["name"], "latest.json")
            if not os.path.exists(latest):
                continue   # island never checkpointed (crashed run)
            ck = json.load(open(latest))
            members.extend(
                FrontMember(fitness=tuple(p["fitness"]),
                            patch=tuple(p["edits"]), source=spec["name"])
                for p in ck["population"])
        if not members:
            raise ValueError(f"island run {root!r} has no checkpointed "
                             "populations to build a front from")
        return ParetoFront.from_members(
            members, origin=root,
            meta={"workload_fingerprint": manifest["workload_fingerprint"],
                  "n_islands": len(manifest["specs"])})

    # -- persistence --------------------------------------------------------
    def to_doc(self) -> dict:
        return {"kind": "pareto_front",
                "objectives": list(self.objectives),
                "origin": self.origin,
                "meta": self.meta,
                "members": [m.to_doc() for m in self.members]}

    def export(self, path: str) -> None:
        """Write the front as a standalone doc (atomic; loadable with
        :meth:`load`) — the handoff format between a finished search and the
        deployment layer."""
        from ..serialize import atomic_write_json
        atomic_write_json(path, self.to_doc(), sort_keys=True)

    # -- queries ------------------------------------------------------------
    def _axis(self, name: str) -> int:
        try:
            return self.objectives.index(name)
        except ValueError:
            raise KeyError(f"unknown objective {name!r}; this front has "
                           f"{self.objectives}") from None

    def best(self, objective: str = "time") -> FrontMember:
        """Unconstrained argmin along one objective."""
        ax = self._axis(objective)
        return min(self.members, key=lambda m: m.fitness[ax])

    def select(self, minimize: str = "time", *, within: float | None = None,
               on: str = "error", relative: bool = False,
               limit: float | None = None) -> FrontMember:
        """The paper's deployment rule as code: the member minimizing
        ``minimize`` subject to a constraint on the other objective.

        * ``within`` — slack against the front's best on ``on``:
          ``select("time", within=0.02)`` is "min time s.t.
          error <= best_error + 0.02", exactly the 2%-accuracy-relaxation
          rule behind the paper's 90.43% MobileNet speedup (accuracy
          91.2%→89.3% ⇔ error slack 0.02 absolute).  With
          ``relative=True`` the slack is multiplicative:
          ``best_on * (1 + within)``.
        * ``limit`` — an absolute bound on ``on`` instead of (or tighter
          than) the slack, e.g. "min time s.t. error <= 0.12".

        Raises :class:`ValueError` when no member satisfies the constraint
        (an unsatisfiable ``limit``) — deployment should fail loudly rather
        than silently ship the wrong variant."""
        ax_min, ax_on = self._axis(minimize), self._axis(on)
        bound = float("inf")
        if within is not None:
            best_on = min(m.fitness[ax_on] for m in self.members)
            bound = best_on * (1.0 + within) if relative else best_on + within
        if limit is not None:
            bound = min(bound, limit)
        feasible = [m for m in self.members if m.fitness[ax_on] <= bound]
        if not feasible:
            raise ValueError(
                f"no front member satisfies {on} <= {bound:.6g} "
                f"(front {on} range: "
                f"{min(m.fitness[ax_on] for m in self.members):.6g}.."
                f"{max(m.fitness[ax_on] for m in self.members):.6g})")
        return min(feasible, key=lambda m: m.fitness[ax_min])
