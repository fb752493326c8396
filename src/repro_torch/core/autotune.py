"""GEVO-Shard: the paper's evolutionary search applied to the DISTRIBUTION
PLAN of a pod-scale model, on the shared GEVO engine (the counterpart of
``src/repro/core/autotune.py``).

The genome is the per-cell performance knobs (remat policy, attention
implementation and block size, loss chunking, FSDP on/off, microbatching),
encoded as a :class:`~repro_torch.core.schedule.ScheduleSpace` program;
variation is the registered ``attr_tweak`` operator (one gene per edit,
exactly the old mutate semantics) plus the search loop's messy crossover
over patches; selection is :class:`~repro_torch.core.search.GevoML`'s
NSGA-II on ``argmin(step_time, device_memory)``; evaluation flows through
a :class:`~repro_torch.core.evaluator.SerialEvaluator` with the
content-addressed :class:`~repro_torch.core.evaluator.FitnessCache`
(optionally persistent via ``--cache``), with a genome-level memo on top
so each unique plan is traced exactly once.  Fitness is the dry run's
three-term roofline on the H100 and its memory estimate
(``launch/dryrun.py``: the plan's sharded step traced once on a fake
production mesh) — one trace per plan instead of the paper's 48
GPU-hours of retraining.  There is no measured time mode, as there is
none in the reference.

``GENOME_SPACE`` / ``genome_keys`` / ``default_genome`` / ``apply_genome``
semantics and the CLI are unchanged; results additionally report evaluator
cache stats and per-operator search stats.

``--islands N`` runs the same genome space as N heterogeneous in-process
islands (ring migration, shared persistent cache) through
:mod:`repro_torch.core.islands` — the runner closure does not pickle, so
islands alternate within this process while the genome memo and fitness
cache are shared across all of them.  ``--out`` writes the result, whose
``pareto`` ``python -m repro_torch.core.deploy select --front`` reads.

CLI:  PYTHONPATH=src python -m repro_torch.core.autotune --arch qwen3-0.6b \
          --shape train_4k --generations 2 --pop 4 [--islands 3]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .evaluator import FitnessCache, SerialEvaluator
from .fitness import InvalidVariant, KernelWorkload
from .schedule import ScheduleSpace

GENOME_SPACE: dict[str, list] = {
    "remat": ["none", "full"],
    "attn_impl": ["naive", "blockwise"],
    "attn_block": [256, 512, 1024, 2048],
    "loss_chunk": [0, 512, 1024],
    "fsdp": [True, False],
    "microbatches": [1, 2, 4],
}

_TRAIN_ONLY = {"loss_chunk", "microbatches", "remat"}


def genome_keys(kind: str) -> list[str]:
    keys = list(GENOME_SPACE)
    if kind != "train":
        keys = [k for k in keys if k not in _TRAIN_ONLY]
    return keys


def default_genome(cfg, kind: str) -> dict:
    g = {"remat": cfg.remat, "attn_impl": cfg.attn_impl,
         "attn_block": cfg.attn_block, "loss_chunk": cfg.loss_chunk,
         "fsdp": cfg.fsdp, "microbatches": 1}
    return {k: g[k] for k in genome_keys(kind)}


def apply_genome(cfg, genome: dict):
    micro = genome.get("microbatches", 1)
    fields = {k: v for k, v in genome.items() if k != "microbatches"}
    return cfg.scaled(**fields), micro


class GevoShard:
    def __init__(self, arch: str, shape: str = "train_4k", *,
                 multi_pod: bool = False, pop_size: int = 6,
                 n_elite: int = 3, seed: int = 0, verbose: bool = True,
                 cache_path: str | None = None, islands: int = 0,
                 islands_dir: str | None = None):
        from ..configs import SHAPES, get_config
        self.arch, self.shape, self.multi_pod = arch, shape, multi_pod
        self.cfg = get_config(arch)
        self.kind = SHAPES[shape][2]
        self.keys = genome_keys(self.kind)
        self.pop_size = pop_size
        self.n_elite = min(n_elite, pop_size)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.verbose = verbose
        self.cache_path = cache_path
        self.islands = islands
        self.islands_dir = islands_dir
        self.records: list[dict] = []
        self._genome_fits: dict[tuple, tuple | None] = {}
        self.space = ScheduleSpace.of(
            f"gevo-shard/{arch}/{shape}/{'2pod' if multi_pod else '1pod'}",
            {k: tuple(GENOME_SPACE[k]) for k in self.keys})
        self.base = default_genome(self.cfg, self.kind)
        self.workload = KernelWorkload(
            name=f"gevo-shard/{arch}/{shape}",
            program=self.space.encode(self.base),
            space=self.space,
            runner=self.evaluate,
            time_mode="static",  # roofline fitness: deterministic per plan
            kind="shard")

    # -- fitness: one dry-run trace + roofline per unique plan --------------
    def evaluate(self, genome: dict) -> tuple[float, float]:
        key = tuple(genome[k] for k in self.keys)
        if key in self._genome_fits:
            fit = self._genome_fits[key]
            if fit is None:
                raise InvalidVariant(f"plan {genome} failed to compile")
            return fit
        from ..launch.dryrun import run_cell
        cfg2, micro = apply_genome(self.cfg, genome)
        rec = run_cell(self.arch, self.shape, self.multi_pod,
                       cfg_override=cfg2, microbatches=micro)
        self.records.append({"genome": dict(genome),
                             "rec": {k: rec.get(k) for k in
                                     ("status", "compile_s", "roofline")}})
        if rec["status"] != "ok":
            self._genome_fits[key] = None
            raise InvalidVariant(
                f"plan {genome} failed to compile: {rec.get('error')}")
        fit = (rec["roofline"]["step_s"],
               rec["memory"].get("temp_size_in_bytes", 0) / 1e9)
        self._genome_fits[key] = fit
        self.records[-1]["fitness"] = fit
        if self.verbose:
            print(f"  eval {genome} -> step={fit[0]:.3f}s mem={fit[1]:.1f}GB",
                  flush=True)
        return fit

    # -- genome-level variation (kept for unit tests / external callers; ----
    # -- the search loop now varies Patches through the attr_tweak operator) -
    def _mutate(self, genome: dict) -> dict:
        g = dict(genome)
        k = self.keys[int(self.rng.integers(len(self.keys)))]
        choices = [c for c in GENOME_SPACE[k] if c != g[k]]
        g[k] = choices[int(self.rng.integers(len(choices)))]
        return g

    def _crossover(self, a: dict, b: dict) -> dict:
        return {k: (a[k] if self.rng.random() < 0.5 else b[k])
                for k in self.keys}

    # -- decode + baseline fold-in (shared by single-pop and island runs) ---
    def _assemble(self, original_fitness, pareto_individuals):
        decode = lambda ind: self.space.decode(  # noqa: E731
            ind.patch.apply(self.workload.program))
        # the engine's population holds only >=1-edit variants; fold the
        # baseline plan back into the front (the pre-engine loop seeded
        # the population with it)
        from .nsga2 import pareto_front
        cand = ([(self.base, tuple(original_fitness), "<original>")]
                + [(decode(i), i.fitness, i.patch.describe())
                   for i in pareto_individuals])
        keep = pareto_front(np.array([c[1] for c in cand]))
        pareto = [{"genome": cand[i][0], "fitness": list(cand[i][1]),
                   "patch": cand[i][2]} for i in sorted(keep)]
        return {
            "arch": self.arch, "shape": self.shape,
            "baseline": {"genome": self.base,
                         "fitness": list(original_fitness)},
            "pareto": pareto,
            "best_step": min((tuple(p["fitness"]) for p in pareto),
                             key=lambda f: f[0]),
            "n_compiles": len(self._genome_fits),
        }

    def _run_islands(self, generations: int):
        """Multi-population search: N in-process islands over the plan
        genome (the runner closure does not pickle, so islands alternate in
        this process; evaluation still flows through one shared persistent
        cache and the full migration machinery)."""
        import tempfile

        from .islands import IslandOrchestrator, default_island_specs
        root = self.islands_dir or tempfile.mkdtemp(prefix="gevoshard_isl_")
        specs = default_island_specs(self.islands,
                                     operators={"attr_tweak": 1.0},
                                     base_seed=self.seed)
        orch = IslandOrchestrator(
            self.workload, root_dir=root, specs=specs,
            pop_size=self.pop_size, n_elite=self.n_elite,
            migrate_every=2, n_migrants=2, topology="ring",
            cache_path=self.cache_path, verbose=self.verbose,
            device="cpu")  # the dry run traces on the host
        res = orch.run(generations=generations)
        out = self._assemble(res.original_fitness, res.pareto)
        out["islands"] = {
            "n": self.islands, "root_dir": root, "topology": "ring",
            "migration_rounds": len(res.migration_log),
            "cross_island_hits": res.cross_island_hits,
            "cache": res.cache_stats["entries"],
            "per_island": {name: r.operator_stats()
                           for name, r in zip(res.names, res.islands)},
        }
        return out

    # -- the search: shared NSGA-II + evaluator engine ----------------------
    def run(self, generations: int = 4):
        from .search import GevoML
        if self.islands >= 2:
            return self._run_islands(generations)
        # the with-block owns the evaluator (GevoML.close is a no-op for a
        # caller-provided one), so a persistent cache handle never leaks
        with SerialEvaluator(self.workload,
                             cache=FitnessCache(self.cache_path)) as ev:
            # mutation_rate=1.0 preserves the pre-engine loop's semantics
            # (every offspring was crossover + exactly one gene mutation)
            s = GevoML(self.workload, pop_size=self.pop_size,
                       n_elite=self.n_elite, init_mutations=1,
                       mutation_rate=1.0, operators={"attr_tweak": 1.0},
                       seed=self.seed, evaluator=ev,
                       verbose=self.verbose)
            res = s.run(generations=generations)
            out = self._assemble(res.original_fitness, res.pareto)
            out["evaluator"] = s.evaluator.stats()
            out["operators"] = res.operator_stats()
            return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pop", type=int, default=6)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default=None,
                    help="persistent fitness-cache path (JSONL); rerun with "
                         "the same path to re-measure nothing")
    ap.add_argument("--islands", type=int, default=0,
                    help="run N heterogeneous islands (ring migration, "
                         "shared cache) instead of one population; 0/1 = "
                         "single population")
    ap.add_argument("--islands-dir", default=None,
                    help="island state directory (manifest, checkpoints, "
                         "shared cache); default: fresh temp dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # monotonic clock, like fitness.measured_time — time.time() jumps with
    # wall-clock adjustments and can even go backwards mid-run
    t0 = time.perf_counter()
    s = GevoShard(args.arch, args.shape, multi_pod=args.multi_pod,
                  pop_size=args.pop, seed=args.seed, cache_path=args.cache,
                  islands=args.islands, islands_dir=args.islands_dir)
    res = s.run(args.generations)
    res["wall_s"] = round(time.perf_counter() - t0, 4)
    res["records"] = s.records
    print(json.dumps({k: v for k, v in res.items() if k != "records"},
                     indent=1, default=str))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)


if __name__ == "__main__":
    main()
