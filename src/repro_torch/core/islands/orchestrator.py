"""The island-model orchestrator: N concurrent GEVO populations with
migration, one shared fitness cache, and fault-tolerant bit-exact resume.

The islands run on one device, the GPU unless the caller names another
(``device="cpu"``).  Spawned islands rebuild the workload there from its
:class:`~repro_torch.core.evaluator.WorkloadSpec`; how many processes a
machine takes, with its cards counted, is :func:`~.config.plan`'s call.

Execution model
---------------

Time is divided into **epochs** of ``migrate_every`` generations.  Within an
epoch every island advances independently (sequentially in-process, or
concurrently in spawned worker processes — bit-identical either way, since
candidate generation is island-RNG-driven and ``static`` fitness is
deterministic); islands synchronize only at epoch boundaries, where the
migration topology moves each source's NSGA-II-best ``n_migrants``
individuals into their destinations' populations.  Migrant fitness travels
through the **shared fitness cache** (one JSONL file, concurrency-safe
appends, per-island writer tags), so a migrant is never re-executed by its
destination — the cache's ``cross_hits`` counter is the receipt.

Fault tolerance
---------------

All state is on disk under ``root_dir``:

* ``manifest.json`` — orchestrator config + the migration log.  Each
  round's migrants are recorded (atomically) *before* any island runs its
  epoch, so a crash mid-migration resumes from the recorded migrants
  rather than recomputing against half-advanced populations.
* ``island-K/`` — each island's ordinary GevoML checkpoints (population,
  RNG state, per-operator stats, evaluator counters per generation).
* ``cache.jsonl`` — the shared fitness store (crash-safe appends).

``run(..., resume=True)`` replays injection only for islands that had not
yet checkpointed the epoch's first generation, restores every counter from
the island checkpoints, and provably reaches the same final Pareto front
and migration log as an uninterrupted run (property-tested in
``tests/test_islands_props.py``).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import shutil
from dataclasses import dataclass, field

import numpy as np

from ...device import check_device, resolve_device
from ..evaluator import FitnessCache, workload_fingerprint
from ..nsga2 import pareto_front
from ..search import GevoML, Individual, SearchResult
from ..serialize import atomic_write_json
from .config import IslandSpec, default_island_specs
from .migration import compute_migration
from .topology import validate_topology
from .worker import island_payload, run_island_epoch

MANIFEST_VERSION = 1


@dataclass
class IslandResult:
    """The orchestrator's report: per-island SearchResults, the merged
    Pareto front (tagged with the contributing island), the migration log,
    and aggregated cache statistics."""

    original_fitness: tuple[float, float]
    names: list[str]
    islands: list[SearchResult]
    pareto: list[Individual]
    pareto_sources: list[str]         # island name per pareto member
    migration_log: list[dict] = field(default_factory=list)
    cache_stats: dict = field(default_factory=dict)

    def best_by_time(self) -> Individual:
        return min(self.pareto, key=lambda i: i.fitness[0])

    def best_by_error(self) -> Individual:
        return min(self.pareto, key=lambda i: i.fitness[1])

    @property
    def cross_island_hits(self) -> int:
        return self.cache_stats.get("cross_island_hits", 0)

    def to_front(self, origin: str = "islands"):
        """The merged cross-island Pareto front as a deployable
        :class:`~repro_torch.core.deploy.ParetoFront` (each member's ``source``
        is the contributing island's name)."""
        from ..deploy.front import FrontMember, ParetoFront
        from ..serialize import patch_doc
        return ParetoFront.from_members(
            (FrontMember(fitness=i.fitness, patch=tuple(patch_doc(i.patch)),
                         source=src)
             for i, src in zip(self.pareto, self.pareto_sources)),
            origin=origin,
            meta={"original_fitness": list(self.original_fitness),
                  "islands": list(self.names),
                  "cross_island_hits": self.cross_island_hits})

    def export_front(self, path: str, origin: str = "islands") -> None:
        """Write the merged front doc for the deployment layer."""
        self.to_front(origin).export(path)


class IslandOrchestrator:
    """Run ``len(specs)`` GevoML populations over one workload with periodic
    migration and a shared persistent fitness cache.

    ``specs`` defaults to :func:`default_island_specs(n_islands)` — a
    heterogeneous palette of operator mixes and rates.  ``processes=True``
    runs each island's epoch in its own spawned worker (workloads travel by
    pickle or :class:`WorkloadSpec`); the search trajectory is identical to
    in-process mode.  ``root_dir`` owns all on-disk state; a fresh run
    clears previous island checkpoints there (the cache file is kept — its
    entries are content-addressed and stay valid).  ``device`` is where the
    islands run: the GPU unless the caller names another; it must be the
    kind of device the workload was built on."""

    BACKENDS = ("processes", "mesh")

    def __init__(self, workload, *, root_dir: str,
                 n_islands: int = 4, specs: list[IslandSpec] | None = None,
                 migrate_every: int = 2, n_migrants: int = 2,
                 topology: str = "ring", pop_size: int = 8,
                 n_elite: int | None = None, max_tries: int = 40,
                 processes: bool = False, eval_workers: int = 0,
                 cache_path: str | None = None, verbose: bool = False,
                 backend: str = "processes", screen: bool = False,
                 surrogate: bool = False, surrogate_keep: float = 0.5,
                 device=None):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose from {self.BACKENDS}")
        self.backend = backend
        self.device = resolve_device(device)
        check_device(workload, self.device)
        if migrate_every < 1:
            raise ValueError("migrate_every must be >= 1")
        if n_migrants < 0:
            raise ValueError("n_migrants must be >= 0")
        self.w = workload
        self.root_dir = root_dir
        self.specs = (list(specs) if specs is not None
                      else default_island_specs(n_islands))
        if not self.specs:
            raise ValueError("need at least one island")
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"island names must be unique, got {names}")
        self.migrate_every = migrate_every
        self.n_migrants = n_migrants
        self.topology = validate_topology(topology)
        self.pop_size = pop_size
        self.n_elite = (n_elite if n_elite is not None
                        else max(1, pop_size // 2))
        self.max_tries = max_tries
        self.processes = processes
        self.eval_workers = eval_workers
        self.screen = screen   # static patch screen on every island
        # surrogate pre-rank on every island; with the shared persistent
        # cache, each island's model trains on ALL islands' measurements
        self.surrogate = surrogate
        self.surrogate_keep = surrogate_keep
        self.cache_path = cache_path or os.path.join(root_dir, "cache.jsonl")
        self.verbose = verbose
        self.fingerprint = workload_fingerprint(workload)

    # -- paths ----------------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root_dir, "manifest.json")

    def island_dir(self, i: int) -> str:
        return os.path.join(self.root_dir, self.specs[i].name)

    # -- manifest -------------------------------------------------------------
    def _base_manifest(self) -> dict:
        return {"version": MANIFEST_VERSION,
                "workload_fingerprint": self.fingerprint,
                "topology": self.topology,
                "migrate_every": self.migrate_every,
                "n_migrants": self.n_migrants,
                "specs": [s.to_doc() for s in self.specs],
                "rounds": []}

    def _load_manifest(self) -> dict:
        if not os.path.exists(self.manifest_path):
            raise FileNotFoundError(
                f"no manifest at {self.manifest_path}; nothing to resume")
        doc = json.load(open(self.manifest_path))
        if doc["workload_fingerprint"] != self.fingerprint:
            raise ValueError(
                "island manifest was written for a different workload "
                f"(fingerprint {doc['workload_fingerprint'][:12]}… != "
                f"{self.fingerprint[:12]}…)")
        base = self._base_manifest()
        for key in ("topology", "migrate_every", "n_migrants", "specs"):
            if doc.get(key) != base[key]:
                raise ValueError(
                    f"cannot resume: manifest {key!r} differs from this "
                    f"orchestrator's configuration")
        return doc

    # -- island checkpoint access --------------------------------------------
    def _island_gen(self, i: int) -> int:
        """Latest checkpointed generation of island ``i`` (-1 if none)."""
        path = os.path.join(self.island_dir(i), "latest.json")
        if not os.path.exists(path):
            return -1
        return json.load(open(path))["gen"]

    def _island_population_at(self, i: int, gen: int) -> list[dict]:
        path = os.path.join(self.island_dir(i), f"gen_{gen:04d}.json")
        return json.load(open(path))["population"]

    # -- migration ------------------------------------------------------------
    def _round_migrants(self, manifest: dict, rnd: int, start_gen: int
                        ) -> dict[str, list[dict]]:
        """Migrants for epoch ``rnd`` (empty for the first epoch).  Uses the
        manifest's recorded round when present (mid-migration resume), else
        selects from the island populations checkpointed at the previous
        epoch's final generation and records the round atomically *before*
        any island runs."""
        if rnd == 0 or len(self.specs) < 2 or self.n_migrants < 1:
            return {str(i): [] for i in range(len(self.specs))}
        for rec in manifest["rounds"]:
            if rec["round"] == rnd:
                return rec["migrants"]
        pops = [self._island_population_at(i, start_gen - 1)
                for i in range(len(self.specs))]
        migrants = compute_migration(self.topology, pops, self.n_migrants)
        manifest["rounds"].append(
            {"round": rnd, "start_gen": start_gen, "migrants": migrants})
        atomic_write_json(self.manifest_path, manifest)
        return migrants

    # -- epochs ---------------------------------------------------------------
    def _epoch_payloads(self, migrants: dict[str, list[dict]],
                        end_gen: int, start_gen: int,
                        island_gens: list[int], on_generation=None
                        ) -> list[tuple[int, dict]]:
        todo = []
        for i, spec in enumerate(self.specs):
            if island_gens[i] >= end_gen - 1:
                continue   # island already finished this epoch
            inject = (migrants.get(str(i), [])
                      if island_gens[i] < start_gen else [])
            payload = island_payload(
                self.w, spec,
                checkpoint_dir=self.island_dir(i),
                cache_path=self.cache_path,
                generations=end_gen,
                resume=island_gens[i] >= 0,
                migrants=inject,
                pop_size=self.pop_size, n_elite=self.n_elite,
                max_tries=self.max_tries,
                eval_workers=self.eval_workers,
                verbose=False,
                inline=not self.processes,
                screen=self.screen,
                surrogate=self.surrogate,
                surrogate_keep=self.surrogate_keep,
                device=str(self.device))
            if on_generation is not None:
                if self.processes:
                    raise ValueError("on_generation requires in-process "
                                     "islands (processes=False)")
                payload["on_generation"] = (
                    lambda gen, row, _name=spec.name:
                    on_generation(_name, gen, row))
            todo.append((i, payload))
        return todo

    def _run_epoch(self, todo: list[tuple[int, dict]]) -> None:
        if not todo:
            return
        if not self.processes:
            for _, payload in todo:
                run_island_epoch(payload)
            return
        # each spawned island takes its share of the host's cores for
        # torch's CPU threads; all of them each would oversubscribe the host
        threads = max(1, (os.cpu_count() or 1) // len(todo))
        ctx = mp.get_context("spawn")
        with ctx.Pool(len(todo)) as pool:
            pool.map(run_island_epoch,
                     [dict(p, threads=threads) for _, p in todo])

    # -- results --------------------------------------------------------------
    def _island_result(self, i: int, generations: int) -> SearchResult:
        """Reconstruct island ``i``'s SearchResult from its checkpoints (a
        resumed run whose start generation equals the target runs zero
        generations and evaluates nothing)."""
        from ..evaluator import SerialEvaluator
        spec = self.specs[i]
        cache = FitnessCache(self.cache_path, writer=spec.name)
        with SerialEvaluator(self.w, cache=cache) as ev:
            s = GevoML(self.w, pop_size=spec.pop_size or self.pop_size,
                       n_elite=spec.n_elite or self.n_elite,
                       init_mutations=spec.init_mutations,
                       crossover_rate=spec.crossover_rate,
                       mutation_rate=spec.mutation_rate,
                       max_tries=self.max_tries, seed=spec.seed,
                       operators=spec.operators, evaluator=ev,
                       checkpoint_dir=self.island_dir(i))
            res = s.run(generations=generations, resume=True)
            res.evaluator_stats = s.evaluator.stats()
            return res

    # -- main entry -----------------------------------------------------------
    def run(self, generations: int = 8, *, resume: bool = False,
            on_generation=None) -> IslandResult:
        """Advance every island to ``generations`` total generations with
        migration every ``migrate_every``.  ``resume=True`` continues from
        the on-disk state (and may extend ``generations`` beyond the
        previous call's).  ``on_generation(island_name, gen, history_row)``
        fires after each island generation's checkpoint lands (in-process
        mode only).

        With ``backend="mesh"`` the fleet runs as one tensorized population
        array (:class:`~repro_torch.core.tensor_evo.TensorIslandFleet`) instead
        of spawned GevoML processes: same topologies, migration rule,
        shared cache (writer tags ``tensor:<axis>``), manifest, and
        epoch-granular bit-exact resume — but the whole fleet lives on the
        device as one (islands, pop, knobs) tensor."""
        if self.backend == "mesh":
            if on_generation is not None:
                raise ValueError("on_generation requires the process "
                                 "backend (backend='processes')")
            if self.surrogate:
                raise ValueError(
                    "surrogate pre-rank drives the process backend; the "
                    "mesh fleet steps all islands on the device (use "
                    "TensorGevoML(surrogate=True) for a guided tensor "
                    "search)")
            from ..tensor_evo.islands import TensorIslandFleet
            with TensorIslandFleet(
                    self.w, root_dir=self.root_dir, specs=self.specs,
                    migrate_every=self.migrate_every,
                    n_migrants=self.n_migrants, topology=self.topology,
                    pop_size=self.pop_size, n_elite=self.n_elite,
                    cache_path=self.cache_path,
                    verbose=self.verbose, device=self.device) as fleet:
                return fleet.run(generations, resume=resume)
        n = len(self.specs)
        if resume:
            manifest = self._load_manifest()
            island_gens = [self._island_gen(i) for i in range(n)]
        else:
            os.makedirs(self.root_dir, exist_ok=True)
            for i in range(n):
                shutil.rmtree(self.island_dir(i), ignore_errors=True)
            manifest = self._base_manifest()
            atomic_write_json(self.manifest_path, manifest)
            island_gens = [-1] * n

        n_rounds = (generations + self.migrate_every - 1) // self.migrate_every
        for rnd in range(n_rounds):
            start = rnd * self.migrate_every
            end = min(start + self.migrate_every, generations)
            if all(g >= end - 1 for g in island_gens):
                continue   # epoch fully checkpointed before the resume
            migrants = self._round_migrants(manifest, rnd, start)
            todo = self._epoch_payloads(migrants, end, start, island_gens,
                                        on_generation)
            if self.verbose:
                moved = sum(len(v) for v in migrants.values())
                print(f"[islands] epoch {rnd}: generations {start}..{end - 1}"
                      f" on {len(todo)} island(s)"
                      + (f", {moved} migrants" if moved else ""), flush=True)
            self._run_epoch(todo)
            island_gens = [max(g, end - 1) for g in island_gens]

        return self._collect(generations, manifest)

    def _collect(self, generations: int, manifest: dict) -> IslandResult:
        results = [self._island_result(i, generations)
                   for i in range(len(self.specs))]
        names = [s.name for s in self.specs]
        pool, sources = [], []
        for name, res in zip(names, results):
            pool.extend(res.population)
            sources.extend([name] * len(res.population))
        objs = np.array([i.fitness for i in pool])
        front = pareto_front(objs)
        seen, pareto, pareto_src = set(), [], []
        for idx in sorted(front, key=lambda k: pool[k].fitness):
            if pool[idx].fitness not in seen:
                seen.add(pool[idx].fitness)
                pareto.append(pool[idx])
                pareto_src.append(sources[idx])
        per_island = {name: getattr(res, "evaluator_stats", {})
                      for name, res in zip(names, results)}
        shared = FitnessCache(self.cache_path)
        cache_stats = {
            "entries": len(shared),
            "path": self.cache_path,
            "cross_island_hits": sum(s.get("cross_hits", 0)
                                     for s in per_island.values()),
            "per_island": per_island,
        }
        shared.close()
        return IslandResult(
            original_fitness=results[0].original_fitness,
            names=names, islands=results,
            pareto=pareto, pareto_sources=pareto_src,
            migration_log=manifest["rounds"],
            cache_stats=cache_stats)
