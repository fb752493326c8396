"""TensorIslandFleet: N island populations as one (islands, pop, knobs)
tensor on one device, advanced a generation at a time.

The process-based orchestrator (:mod:`repro_torch.core.islands`) maps
islands onto worker *processes*; this backend maps them onto the leading
axis of one tensor on the device.  Each generation scores every lane of
every island in one batched fitness call, then steps each island with the
engine's selection and variation under the island's own rates and its own
``torch.Generator`` — so an island's trajectory depends only on its seed
and its migrants, never on how many islands share the card.  Island
heterogeneity (the rate palette of :func:`default_island_specs`) survives
as per-island crossover/mutation rates.

What stays identical to the process backend:

* **epochs** — ``migrate_every`` generations between synchronizations;
* **migration** — the same
  :func:`~repro_torch.core.islands.migration.compute_migration`
  over the same topologies (``ring``/``full``/``broadcast_best``), fed with
  checkpoint-style population docs built from the bit-exact NumPy scoring
  path; incoming migrants replace each destination's worst lanes (NSGA-II
  order), capped at half the island — ``GevoML._inject_migrants``'s rule;
* **the shared fitness cache** — every island records its epoch-boundary
  population under its own writer tag (``tensor:<island axis index>``), so
  cross-island hits are countable exactly as in the process fleet;
* **manifest + resume** — ``manifest.json`` records each round's migrants
  before the epoch runs; state (population tensor + each island's
  generator state) snapshots per epoch, and ``run(resume=True)`` replays
  bit-exactly (the step is a deterministic function of the restored
  tensors).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ...device import check_device, resolve_device
from ..evaluator import FitnessCache, workload_fingerprint
from ..fitness import InvalidVariant
from ..search import Individual, SearchResult
from ..serialize import atomic_write_json, patch_doc, patch_from_doc
from ..islands.config import IslandSpec, default_island_specs
from ..islands.migration import compute_migration
from ..islands.orchestrator import MANIFEST_VERSION, IslandResult
from ..islands.topology import validate_topology
from . import nsga2 as tnsga
from .engine import TensorGevoML, seeded_generator

MESH_WRITER_PREFIX = "tensor:"


def mesh_writer_tag(axis_index: int) -> str:
    """The cache writer tag of mesh-island ``axis_index`` — one tag per
    lane of the island axis, unique by construction."""
    return f"{MESH_WRITER_PREFIX}{axis_index}"


def island_seed(seed: int, spec_seed: int) -> int:
    """The generator seed of one island: the fleet's seed and the island's
    own, mixed (``numpy.random.SeedSequence``)."""
    ss = np.random.SeedSequence([seed % 2**32, spec_seed % 2**32])
    return int(ss.generate_state(1, np.uint64)[0])


class TensorIslandFleet:
    """N tensorized islands over one workload, on one device (the GPU
    unless the caller names another) along the leading axis of the
    population tensor.

    ``specs`` defaults to the standard heterogeneous palette (only the
    rates and seeds apply — the tensor engine has no operator registry);
    spec names become directory names, writer tags come from the axis
    index."""

    def __init__(self, workload, *, root_dir: str, n_islands: int = 4,
                 specs: list[IslandSpec] | None = None,
                 migrate_every: int = 2, n_migrants: int = 2,
                 topology: str = "ring", pop_size: int = 1024,
                 n_elite: int = 16, seed: int = 0,
                 cache_path: str | None = None, verbose: bool = False,
                 device=None):
        self.device = resolve_device(device)
        check_device(workload, self.device)
        if migrate_every < 1:
            raise ValueError("migrate_every must be >= 1")
        if n_migrants < 0:
            raise ValueError("n_migrants must be >= 0")
        self.w = workload
        self.root_dir = root_dir
        self.specs = (list(specs) if specs is not None
                      else default_island_specs(
                          n_islands, operators={"attr_tweak": 1.0},
                          base_seed=seed))
        if not self.specs:
            raise ValueError("need at least one island")
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"island names must be unique, got {names}")
        tags = [mesh_writer_tag(i) for i in range(len(self.specs))]
        if len(set(tags)) != len(tags):  # impossible by construction; keep
            raise ValueError(f"writer tags must be unique, got {tags}")
        self.writer_tags = tags
        self.migrate_every = migrate_every
        self.n_migrants = n_migrants
        self.topology = validate_topology(topology)
        self.pop_size = pop_size
        self.n_elite = min(n_elite, pop_size)
        self.seed = seed
        self.cache_path = cache_path or os.path.join(root_dir, "cache.jsonl")
        self.verbose = verbose
        self.fingerprint = workload_fingerprint(workload)
        # one engine supplies the device step + the NumPy-exact scorer; its
        # own cache stays in-memory (per-island writers own the shared file)
        self.engine = TensorGevoML(
            workload, pop_size=pop_size, n_elite=self.n_elite, seed=seed,
            device=self.device)
        self.encoding = self.engine.encoding
        self._evals: list | None = None   # per-island writer-tagged caches

    # -- paths / manifest -----------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root_dir, "manifest.json")

    @property
    def state_path(self) -> str:
        return os.path.join(self.root_dir, "mesh_state.npz")

    def _base_manifest(self) -> dict:
        return {"version": MANIFEST_VERSION, "backend": "mesh",
                "device": self.device.type,
                "workload_fingerprint": self.fingerprint,
                "topology": self.topology,
                "migrate_every": self.migrate_every,
                "n_migrants": self.n_migrants,
                "specs": [s.to_doc() for s in self.specs],
                "writer_tags": self.writer_tags,
                "gen": -1, "rounds": []}

    def _load_manifest(self) -> dict:
        if not os.path.exists(self.manifest_path):
            raise FileNotFoundError(
                f"no manifest at {self.manifest_path}; nothing to resume")
        doc = json.load(open(self.manifest_path))
        if doc["workload_fingerprint"] != self.fingerprint:
            raise ValueError(
                "mesh manifest was written for a different workload "
                f"(fingerprint {doc['workload_fingerprint'][:12]}… != "
                f"{self.fingerprint[:12]}…)")
        if doc.get("backend") != "mesh":
            raise ValueError("manifest belongs to the process backend; "
                             "resume it with IslandOrchestrator")
        base = self._base_manifest()
        for key in ("topology", "migrate_every", "n_migrants", "specs",
                    "device"):
            if doc.get(key) != base[key]:
                raise ValueError(
                    f"cannot resume: manifest {key!r} differs from this "
                    f"fleet's configuration")
        return doc

    # -- per-island writer-tagged evaluation ---------------------------------
    def _island_evaluators(self):
        """One writer-tagged evaluator per island over the shared cache
        file (created lazily; reused across epochs so hit counters
        accumulate).  They score through the engine's batched fitness, so
        each error class runs its kernel once for the whole fleet."""
        if self._evals is None:
            from .evaluator import TensorEvaluator
            self._evals = [
                TensorEvaluator(self.w, cache=FitnessCache(
                    self.cache_path, writer=tag))
                for tag in self.writer_tags]
            for ev in self._evals:
                ev.batched = self.engine.batched
        return self._evals

    def _score_island(self, i: int, rows: np.ndarray):
        """Bit-exact outcomes of island ``i``'s population, recorded in the
        shared cache under its writer tag.  Returns (patches, outcomes)."""
        ev = self._island_evaluators()[i]
        ev.cache.reload()   # absorb other islands' epoch records
        patches = [self.encoding.to_patch(row) for row in rows]
        return patches, ev.evaluate_batch(patches)

    # -- the fleet's step -----------------------------------------------------
    def step(self, idx, generators, cx, mut):
        """One generation of every island: one batched fitness call over
        all ``(islands * pop)`` lanes, then each island's selection and
        variation under its rates and generator.  Returns the next
        population tensor and one metrics dict an island."""
        n, pop, knobs = idx.shape
        objs, valid = self.engine.objectives_fn()(idx.reshape(n * pop,
                                                              knobs))
        objs, valid = objs.reshape(n, pop, 2), valid.reshape(n, pop)
        step = self.engine.step_fn()
        nxt, metrics = [], []
        for i in range(n):
            row, m = step(idx[i], generators[i], cx[i], mut[i],
                          objs=(objs[i], valid[i]))
            nxt.append(row)
            metrics.append(m)
        return torch.stack(nxt), metrics

    def _init_state(self):
        """Per-island generators (the fleet's seed mixed with each spec's
        seed) and initial populations (lane 0 = baseline everywhere, rest
        random)."""
        gens, pops = [], []
        for spec in self.specs:
            gen = seeded_generator(self.device,
                                   island_seed(self.seed, spec.seed))
            pops.append(self.engine.init_pop(gen))
            gens.append(gen)
        return torch.stack(pops), gens

    # -- migration ------------------------------------------------------------
    def _population_docs(self, idx_np: np.ndarray) -> list[list[dict]]:
        """Checkpoint-style docs per island (valid lanes only) — the format
        ``compute_migration`` consumes, so both backends share one
        migration implementation."""
        docs = []
        for i in range(len(self.specs)):
            patches, outs = self._score_island(i, idx_np[i])
            docs.append([{"edits": patch_doc(p), "fitness": list(o.fitness)}
                         for p, o in zip(patches, outs) if o.ok])
        return docs

    def _inject(self, idx_np: np.ndarray, migrants: dict) -> np.ndarray:
        """Fold migrant docs into each island: decode to rows, drop rows the
        island already holds, cap at half the population, replace the worst
        lanes by NSGA-II selection order (``_inject_migrants``'s rule)."""
        out = idx_np.copy()
        for i in range(len(self.specs)):
            incoming = migrants.get(str(i), [])
            if not incoming:
                continue
            have = {tuple(r) for r in idx_np[i].tolist()}
            rows, fits = [], []
            for m in incoming:
                row = self.encoding.from_patch(
                    patch_from_doc(m["edits"]), self.w.program)
                t = tuple(int(v) for v in row)
                if t not in have:
                    have.add(t)
                    rows.append(row)
                    fits.append(tuple(m["fitness"]))
            rows = rows[:max(1, self.pop_size // 2)]
            if not rows:
                continue
            _, _, order, _ = self._rank_rows(idx_np[i])
            worst = order[len(order) - len(rows):]
            out[i, worst, :] = np.stack(rows).astype(out.dtype)
        return out

    def _rank_rows(self, rows: np.ndarray):
        """NumPy-exact (rank, crowd, selection order, objs) of one island's
        lanes; invalid lanes get (inf, inf) objectives like the engine."""
        time, valid, err, _ = self.engine.batched.evaluate_np(rows)
        finite = valid & np.isfinite(time) & np.isfinite(err)
        objs = np.stack([np.where(finite, time, np.inf),
                         np.where(finite, err, np.inf)], axis=1)
        rank, crowd = tnsga.rank_crowd(objs, xp=np)
        order = tnsga.selection_order(rank, crowd, xp=np)
        return rank, crowd, order, objs

    # -- state snapshots ------------------------------------------------------
    def _save_state(self, idx, generators, gen: int, original,
                    manifest: dict) -> None:
        tmp = self.state_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, idx=idx.cpu().numpy(),
                     rng=np.stack([g.get_state().numpy()
                                   for g in generators]))
        os.replace(tmp, self.state_path)
        manifest["gen"] = gen
        manifest["original_fitness"] = list(original)
        atomic_write_json(self.manifest_path, manifest)

    # -- main entry -----------------------------------------------------------
    def run(self, generations: int = 8, *, resume: bool = False
            ) -> IslandResult:
        """Advance every island to ``generations`` total generations."""
        n = len(self.specs)
        if resume:
            manifest = self._load_manifest()
            state = np.load(self.state_path)
            idx = torch.as_tensor(state["idx"], dtype=torch.int64,
                                  device=self.device)
            generators = []
            for rng in state["rng"]:
                gen = torch.Generator(device=self.device)
                gen.set_state(torch.as_tensor(rng))
                generators.append(gen)
            start_gen = manifest["gen"] + 1
            original = tuple(manifest["original_fitness"])
        else:
            os.makedirs(self.root_dir, exist_ok=True)
            base = self.encoding.baseline_row()[None, :]
            first = self.engine.evaluator.evaluate_rows(base)[0]
            if not first.ok:
                raise InvalidVariant(
                    f"original program failed evaluation: {first.error}")
            original = first.fitness
            idx, generators = self._init_state()
            manifest = self._base_manifest()
            start_gen = 0
            self._save_state(idx, generators, -1, original, manifest)

        cx = [s.crossover_rate for s in self.specs]
        mut = [s.mutation_rate for s in self.specs]
        gen = start_gen
        while gen < generations:
            rnd = gen // self.migrate_every
            if gen % self.migrate_every == 0 and gen > 0:
                idx_np = idx.cpu().numpy()
                migrants = self._round_migrants(manifest, rnd, gen, idx_np)
                idx = torch.as_tensor(self._inject(idx_np, migrants),
                                      device=self.device)
            end = min((rnd + 1) * self.migrate_every, generations)
            for g in range(gen, end):
                idx, metrics = self.step(idx, generators, cx, mut)
                if self.verbose:
                    bt = min(float(m["best_time"]) for m in metrics)
                    nv = sum(int(m["n_valid"]) for m in metrics)
                    print(f"[mesh gen {g:3d}] best_time={bt:.3e} "
                          f"valid={nv}/{n * self.pop_size}", flush=True)
            gen = end
            self._save_state(idx, generators, gen - 1, original, manifest)
        return self._collect(idx.cpu().numpy(), original, manifest,
                             generations)

    def _round_migrants(self, manifest: dict, rnd: int, start_gen: int,
                        idx_np: np.ndarray) -> dict:
        """This round's migrant docs: the manifest's record when present
        (mid-epoch resume replays them), else computed from the current
        populations and recorded atomically before the epoch runs."""
        if len(self.specs) < 2 or self.n_migrants < 1:
            return {str(i): [] for i in range(len(self.specs))}
        for rec in manifest["rounds"]:
            if rec["round"] == rnd:
                return rec["migrants"]
        migrants = compute_migration(self.topology,
                                     self._population_docs(idx_np),
                                     self.n_migrants)
        manifest["rounds"].append(
            {"round": rnd, "start_gen": start_gen, "migrants": migrants})
        atomic_write_json(self.manifest_path, manifest)
        return migrants

    # -- results --------------------------------------------------------------
    def _collect(self, idx_np: np.ndarray, original, manifest: dict,
                 generations: int) -> IslandResult:
        names = [s.name for s in self.specs]
        results, pool, sources = [], [], []
        for i, name in enumerate(names):
            patches, outs = self._score_island(i, idx_np[i])
            pop = [Individual(p, o.fitness)
                   for p, o in zip(patches, outs) if o.ok]
            objs = np.array([ind.fitness for ind in pop]) if pop else \
                np.empty((0, 2))
            pf = [pop[j] for j in tnsga.pareto_front(objs)] if pop else []
            seen, pareto = set(), []
            for ind in sorted(pf, key=lambda x: x.fitness):
                if ind.fitness not in seen:
                    seen.add(ind.fitness)
                    pareto.append(ind)
            res = SearchResult(original_fitness=original, population=pop,
                               pareto=pareto,
                               history=[{"gen": generations - 1,
                                         "pareto_size": len(pareto)}])
            res.evaluator_stats = self._island_evaluators()[i].stats()
            results.append(res)
            pool.extend(pop)
            sources.extend([name] * len(pop))
        objs = np.array([ind.fitness for ind in pool])
        front = tnsga.pareto_front(objs)
        seen, pareto, pareto_src = set(), [], []
        for j in sorted(front, key=lambda k: pool[k].fitness):
            if pool[j].fitness not in seen:
                seen.add(pool[j].fitness)
                pareto.append(pool[j])
                pareto_src.append(sources[j])
        per_island = {name: getattr(res, "evaluator_stats", {})
                      for name, res in zip(names, results)}
        shared = FitnessCache(self.cache_path)
        cache_stats = {
            "entries": len(shared),
            "path": self.cache_path,
            "writer_tags": self.writer_tags,
            "cross_island_hits": sum(s.get("cross_hits", 0)
                                     for s in per_island.values()),
            "per_island": per_island,
        }
        shared.close()
        return IslandResult(
            original_fitness=original, names=names, islands=results,
            pareto=pareto, pareto_sources=pareto_src,
            migration_log=manifest["rounds"], cache_stats=cache_stats)

    def close(self) -> None:
        self.engine.close()
        if self._evals is not None:
            for ev in self._evals:
                ev.close()
            self._evals = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
