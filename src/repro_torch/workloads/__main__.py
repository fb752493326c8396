"""GEVO-ML on the paper's IR workloads, on the GPU: NSGA-II evolves patches
of the workload's program — sampled from the operator registry (delete /
copy / swap / insert / const_perturb) — and the Pareto front trades run time
against model error.  The counterpart of the reference's
``examples/quickstart.py`` (2fcNet training, at its sizes) and
``examples/gevo_mobilenet.py`` (MobileNet prediction, at its default sizes),
plus the tinyformer.  Run:

    python -m repro_torch.workloads --workload twofc --time-mode measured

Flags:

    --workload NAME     twofc (default) | mobilenet | tinyformer
    --time-mode MODE    static (deterministic roofline, default) | measured
                        (median CUDA-event time of the variant)
    --operators SPEC    sampling mix: "all" (default), "legacy"
                        (paper's copy/delete), or "copy=1,swap=2,..."
    --minimize          ddmin the best-by-time patch down to its key
                        mutations (reuses the fitness cache)
    --parallel N        evaluate variants in N worker processes
    --cache PATH        persistent fitness cache (JSONL); rerun with the
                        same path and the search re-measures nothing
    --checkpoint DIR    write per-generation snapshots
    --resume            continue from the latest snapshot in --checkpoint
    --generations G / --pop P
    --device DEV        cuda (default) | cpu
    --screen            static patch screen: invalid / noop / equivalent
                        variants resolve without execution
    --surrogate         surrogate pre-rank of each generation's offspring;
                        --surrogate-keep F keeps that fraction (0.5)
"""

import argparse

from ..core import GevoML, OperatorWeights, minimize_patch
from ..core.evaluator import make_evaluator

WORKLOADS = ("twofc", "mobilenet", "tinyformer")


def build(name: str, time_mode: str, device):
    """The workload at the sizes of the reference's examples."""
    if name == "twofc":
        from .twofc import build_twofc_training_workload
        return build_twofc_training_workload(
            batch=32, hidden=64, steps=80, n_train=2048, n_test=1024,
            lr=0.01, time_mode=time_mode, device=device)
    if name == "mobilenet":
        from .mobilenet import build_mobilenet_prediction_workload
        return build_mobilenet_prediction_workload(
            alpha=0.125, n_eval=512, n_pretrain=2000, pretrain_epochs=2,
            time_mode=time_mode, verbose=True, device=device)
    from .tinyformer import build_tinyformer_prediction_workload
    return build_tinyformer_prediction_workload(
        n_eval=512, n_pretrain=2048, steps=400, time_mode=time_mode,
        device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.workloads")
    ap.add_argument("--workload", default="twofc", choices=WORKLOADS)
    ap.add_argument("--time-mode", default="static",
                    choices=("static", "measured"))
    ap.add_argument("--operators", default="all",
                    help='mutation mix: "all", "legacy", or '
                         '"name=w,name=w,..."')
    ap.add_argument("--minimize", action="store_true",
                    help="minimize the best-by-time patch to its key "
                         "mutations")
    ap.add_argument("--parallel", type=int, default=0,
                    help="evaluation worker processes (0/1 = in-process)")
    ap.add_argument("--cache", default=None,
                    help="persistent fitness cache path (JSONL)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory (one snapshot per generation)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --checkpoint")
    ap.add_argument("--generations", type=int, default=5)
    ap.add_argument("--pop", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda)")
    ap.add_argument("--screen", action="store_true",
                    help="static patch screen: invalid / noop / equivalent "
                         "variants resolve without execution (in measured "
                         "time, invalid ones only)")
    ap.add_argument("--surrogate", action="store_true",
                    help="surrogate pre-rank: a cache-trained cost model "
                         "keeps only the predicted-Pareto slice of each "
                         "generation's offspring for execution")
    ap.add_argument("--surrogate-keep", type=float, default=0.5,
                    help="fraction of generated offspring the surrogate "
                         "lets through (default 0.5)")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint:
        ap.error("--resume requires --checkpoint")
    weights = OperatorWeights.parse(args.operators)

    print(f"Building the {args.workload} workload ({args.time_mode} "
          "time)...")
    w = build(args.workload, args.time_mode, args.device)
    print(f"  program: {len(w.program.ops)} HLO-lite ops, "
          f"{len(w.program.inputs)} inputs, on {w.device}")
    t0, e0 = w.evaluate(w.program)
    print(f"  original fitness: time={t0:.3e}s  error={e0:.4f}\n")

    mode = (f"{args.parallel} workers" if args.parallel > 1 else "serial")
    print(f"Running GEVO-ML (NSGA-II, pop={args.pop}, {args.generations} "
          f"generations, operators={{{', '.join(weights.names())}}}, "
          f"{mode} evaluation)...")
    evaluator = make_evaluator(w, parallel=args.parallel,
                               cache_path=args.cache, screen=args.screen,
                               features=args.surrogate)
    try:
        search = GevoML(w, pop_size=args.pop, n_elite=args.pop // 2, seed=0,
                        verbose=True, operators=weights, evaluator=evaluator,
                        checkpoint_dir=args.checkpoint,
                        surrogate=args.surrogate,
                        surrogate_keep=args.surrogate_keep)
        res = search.run(generations=args.generations, resume=args.resume)

        # compare against the baseline the search itself measured
        t0, e0 = res.original_fitness
        print("\nPareto front (argmin(time, error)):")
        for ind in res.pareto:
            t, e = ind.fitness
            marks = []
            if t < t0 * 0.999:
                marks.append(f"time -{(1 - t / t0) * 100:.1f}%")
            if e < e0 - 1e-4:
                marks.append(f"error -{(e0 - e) * 100:.2f}pp")
            print(f"  time={t:.3e}  err={e:.4f}  {' '.join(marks)}")
            print(f"    patch: {ind.patch.describe()}")
        be = res.best_by_error()
        print(f"\nbest error {be.fitness[1]:.4f} vs original {e0:.4f} "
              f"({search.n_evals} fitness evaluations, "
              f"{search.n_invalid} invalid variants resampled, "
              f"cache hit rate {search.cache.hit_rate:.0%})")
        if args.screen:
            ev = search.evaluator
            print(f"static screen: {ev.n_screened} variants resolved "
                  f"without execution {dict(sorted(ev.screened_by.items()))}")
        if args.surrogate:
            st = search.guide.stats()
            print(f"surrogate pre-rank: kept {st['kept']}/{st['ranked']} "
                  f"ranked offspring across {st['refits']} refits")
        print("per-operator proposed/applied/valid/elite:")
        for name, row in res.operator_stats().items():
            print(f"  {name:>14}: {row['proposed']:4d} / "
                  f"{row['applied']:4d} / {row['valid']:4d} / "
                  f"{row['elite']:4d}")
        if args.minimize:
            bt = res.best_by_time()
            small, fit = minimize_patch(bt.patch, search.evaluator,
                                        expect_fitness=bt.fitness)
            print(f"\nminimized best-by-time patch: {len(bt.patch)} -> "
                  f"{len(small)} edits at identical fitness {fit}")
            print(f"  key mutations: {small.describe()}")
        if args.cache:
            print(f"fitness cache: {len(search.cache)} entries at "
                  f"{args.cache}")
    finally:
        evaluator.close()


if __name__ == "__main__":
    main()
