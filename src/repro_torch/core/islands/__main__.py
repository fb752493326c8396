"""Island-model GEVO: N populations, migration, one shared fitness cache.

Runs :class:`repro_torch.core.IslandOrchestrator` over any of the engine's
scenario families — the paper's IR-level workloads (2fcNet training,
MobileNet prediction) or the kernel-schedule spaces (rmsnorm,
flash_attention, mamba_scan, joint).  Each island gets its own RNG
stream, operator mix, and mutation rate (heterogeneous palette by
default); elites migrate every K generations over a configurable topology;
all islands share one concurrency-safe fitness cache, so a migrant is
never re-evaluated by its destination.  Runs on the GPU; on a host without
one pass ``--device cpu``.  Run:

    python -m repro_torch.core.islands --workload twofc --device cpu \\
        --islands 2 --generations 2
    python -m repro_torch.core.islands --workload joint --engine tensor \\
        --islands 4 --pop 1024 --generations 6

Flags:

    --workload NAME     twofc | mobilenet | rmsnorm | flash_attention |
                        mamba_scan | joint (all three kernels, one genome)
    --engine E          python (GevoML islands, default) | tensor (the
                        whole fleet as one tensor on the device; kernel
                        workloads only)
    --islands N         number of islands (default 4)
    --generations G     total generations (default 6)
    --pop P             population size per island (default 8)
    --migrate-every K   generations between migrations (default 2)
    --migrants M        NSGA-II-best individuals each source sends (2)
    --topology T        ring | full | broadcast_best (default ring)
    --processes MODE    auto | on | off — island worker processes; "auto"
                        consults repro_torch.core.islands.plan(), which
                        counts cores and cards (default off)
    --root DIR          state directory (manifest + island checkpoints +
                        shared cache); enables --resume.  Default: temp dir
    --export-front PATH write the merged Pareto front (ParetoFront.load)
    --resume            continue a killed run from --root (bit-exact)
    --surrogate         cache-trained cost model pre-ranks offspring on
                        every island (the shared cache trains all models)
    --surrogate-keep F  fraction of generated offspring that is executed
    --seed S            base seed of the island palette (default 0)
    --device DEV        cuda (default) | cpu
"""

import argparse
import tempfile

from ...device import resolve_device
from . import TOPOLOGIES, IslandOrchestrator, default_island_specs, plan

WORKLOADS = ("twofc", "mobilenet", "rmsnorm", "flash_attention",
             "mamba_scan", "joint")
KERNELS = ("rmsnorm", "flash_attention", "mamba_scan", "joint")


def build_workload(name: str, device):
    """(workload, operators) for the orchestrator, at the reference
    example's sizes: IR workloads use the heterogeneous operator palette,
    schedule spaces pin attr_tweak."""
    if name == "twofc":
        from ...workloads.twofc import build_twofc_training_workload
        return build_twofc_training_workload(
            batch=32, hidden=64, steps=60, n_train=2048, n_test=1024,
            device=device), None
    if name == "mobilenet":
        from ...workloads.mobilenet import \
            build_mobilenet_prediction_workload
        print("Pretraining MobileNet on synthetic CIFAR10...")
        return build_mobilenet_prediction_workload(
            alpha=0.125, n_eval=512, n_pretrain=2000, pretrain_epochs=2,
            verbose=True, device=device), None
    if name == "joint":
        from ...kernels.workloads import build_joint_kernel_workload
        return (build_joint_kernel_workload(device=device),
                {"attr_tweak": 1.0})
    from ...kernels.workloads import build_kernel_workload
    return (build_kernel_workload(name, time_mode="static", device=device),
            {"attr_tweak": 1.0})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.islands")
    ap.add_argument("--workload", default="twofc", choices=WORKLOADS)
    ap.add_argument("--engine", default="python",
                    choices=("python", "tensor"),
                    help="tensor = the fleet as one tensor on the device "
                         "(kernel workloads only)")
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--generations", type=int, default=6)
    ap.add_argument("--pop", type=int, default=8,
                    help="population size per island")
    ap.add_argument("--migrate-every", type=int, default=2)
    ap.add_argument("--migrants", type=int, default=2)
    ap.add_argument("--topology", default="ring", choices=TOPOLOGIES)
    ap.add_argument("--processes", default="off",
                    choices=("auto", "on", "off"))
    ap.add_argument("--root", default=None,
                    help="state directory (default: fresh temp dir)")
    ap.add_argument("--export-front", default=None, metavar="PATH",
                    help="write the merged Pareto front as a deployable "
                         "front doc (ParetoFront.load)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed run from --root")
    ap.add_argument("--surrogate", action="store_true",
                    help="surrogate pre-rank on every island: a cost model "
                         "trained from the shared fitness cache keeps only "
                         "the predicted-Pareto slice of each generation's "
                         "offspring")
    ap.add_argument("--surrogate-keep", type=float, default=0.5,
                    help="fraction of generated offspring the surrogate "
                         "lets through (default 0.5)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda)")
    args = ap.parse_args(argv)
    if args.resume and not args.root:
        ap.error("--resume requires --root")
    if args.surrogate and args.engine == "tensor":
        ap.error("--surrogate drives the python island engine; for the "
                 "tensor engine use TensorGevoML(surrogate=True) directly")
    if args.engine == "tensor" and args.workload not in KERNELS:
        ap.error("--engine tensor needs a kernel-schedule workload "
                 f"({', '.join(KERNELS)})")
    device = resolve_device(args.device)

    print(f"Building {args.workload} workload on {device}...")
    w, operators = build_workload(args.workload, device)
    t0, e0 = w.evaluate(w.program)
    print(f"  original fitness: time={t0:.3e}s  error={e0:.4f}")

    if args.engine == "tensor":
        processes, eval_workers = False, 0
        print("  engine: tensor (the fleet as one tensor on the device, "
              "no island processes)")
    elif args.processes == "auto":
        p = plan(args.islands, time_mode=w.time_mode,
                 cards=0 if device.type == "cpu" else None)
        processes, eval_workers = p.processes, p.eval_workers
        print(f"  plan: {p.describe()}")
    else:
        processes, eval_workers = args.processes == "on", 0
    if processes and getattr(w, "spec", None) is None:
        print("  (workload has no WorkloadSpec; falling back to "
              "in-process islands)")
        processes = False

    specs = default_island_specs(args.islands, operators=operators,
                                 base_seed=args.seed)
    root = args.root or tempfile.mkdtemp(prefix="gevo_islands_")
    print(f"\n{args.islands} islands (pop {args.pop} each), "
          f"{args.generations} generations, migrate every "
          f"{args.migrate_every} ({args.topology}, {args.migrants} "
          f"migrants), state in {root}")
    for s in specs:
        ops = s.operators if isinstance(s.operators, str) else \
            ",".join((s.operators or {"all": 1}).keys())
        print(f"  {s.name}: operators={ops} mut={s.mutation_rate} "
              f"seed={s.seed}")

    orch = IslandOrchestrator(
        w, root_dir=root, specs=specs, pop_size=args.pop,
        migrate_every=args.migrate_every, n_migrants=args.migrants,
        topology=args.topology, processes=processes,
        eval_workers=eval_workers, verbose=True,
        backend="mesh" if args.engine == "tensor" else "processes",
        surrogate=args.surrogate, surrogate_keep=args.surrogate_keep,
        device=device)
    res = orch.run(generations=args.generations, resume=args.resume)

    print("\nMerged Pareto front (argmin(time, error)):")
    for ind, src in zip(res.pareto, res.pareto_sources):
        t, e = ind.fitness
        mark = f"  time -{(1 - t / t0) * 100:.1f}%" if t < t0 * 0.999 else ""
        print(f"  time={t:.3e}  err={e:.4f}  [{src}]{mark}")
    moved = sum(len(v) for r in res.migration_log
                for v in r["migrants"].values())
    cs = res.cache_stats
    print(f"\n{len(res.migration_log)} migration rounds ({moved} migrants "
          f"moved); shared cache: {cs['entries']} unique genomes, "
          f"{res.cross_island_hits} cross-island hits")
    for name, isl in zip(res.names, res.islands):
        bt = min(i.fitness[0] for i in isl.pareto)
        be = min(i.fitness[1] for i in isl.pareto)
        ev = cs["per_island"].get(name, {})
        print(f"  {name}: best time={bt:.3e} best err={be:.4f} "
              f"evals={ev.get('n_evals', '?')} "
              f"cross_hits={ev.get('cross_hits', '?')}")
    if args.export_front:
        res.export_front(args.export_front, origin=root)
        print(f"\nexported merged front to {args.export_front} "
              f"(load it with repro_torch.core.deploy.ParetoFront.load)")
    print(f"\nresume any time with: --root {root} --resume")
    return res


if __name__ == "__main__":
    main()
