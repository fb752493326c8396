"""GEVO over the CUDA kernel layer: evolve a kernel's schedule.

The schedule genome (implementation choice, block sizes, epilogue fusion) is
encoded as an HLO-lite program of knob constants, mutated through the
registered ``attr_tweak`` operator, and searched with the NSGA-II +
cached-evaluator engine — fitness is ``argmin(time, max |out - ref|)``, with
every candidate schedule executed against the kernel's oracle.  Runs on the
GPU; on a host without one pass ``--device cpu`` (the kernels' plain
versions, static time only being meaningful).  Run:

    python -m repro_torch.kernels --kernel rmsnorm --time-mode measured

Flags:

    --kernel NAME       rmsnorm | flash_attention | mamba_scan
    --time-mode MODE    static (deterministic roofline, default) | measured
                        (median CUDA-event time of the variant)
    --minimize          ddmin the best-by-time patch to its key tweaks
    --device DEV        cuda (default) | cpu
    --screen            static patch screen (invalid variants resolve
                        without a launch)
    --surrogate         surrogate pre-rank of each generation's offspring;
                        --surrogate-keep F keeps that fraction (0.5)
    --parallel N / --cache PATH / --generations G / --pop P
"""

import argparse

from ..core import minimize_patch
from ..core.evaluator import make_evaluator
from .workloads import (KERNELS, SHAPES, build_kernel_workload,
                        evolve_kernel_schedule)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels")
    ap.add_argument("--kernel", default="rmsnorm", choices=KERNELS)
    ap.add_argument("--time-mode", default="static",
                    choices=("static", "measured"))
    ap.add_argument("--generations", type=int, default=5)
    ap.add_argument("--pop", type=int, default=8)
    ap.add_argument("--minimize", action="store_true",
                    help="minimize the best-by-time patch to its key tweaks")
    ap.add_argument("--parallel", type=int, default=0,
                    help="evaluation worker processes (0/1 = in-process)")
    ap.add_argument("--cache", default=None,
                    help="persistent fitness cache path (JSONL)")
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

    print(f"Building {args.kernel} schedule workload "
          f"({SHAPES[args.kernel]}, {args.time_mode} time)...")
    w = build_kernel_workload(args.kernel, time_mode=args.time_mode,
                              device=args.device)
    print(f"  schedule space: {w.space.size()} configs over "
          f"{{{', '.join(w.space.names())}}}")
    t0, e0 = w.evaluate(w.program)
    print(f"  default schedule [{w.space.describe(w.program)}]: "
          f"time={t0:.3e}s  err={e0:.2e}\n")

    print(f"Evolving schedules (NSGA-II, pop={args.pop}, "
          f"{args.generations} generations, operator=attr_tweak)...")
    evaluator = make_evaluator(w, parallel=args.parallel,
                               cache_path=args.cache, screen=args.screen,
                               features=args.surrogate)
    try:
        search, res, best, within_tol = evolve_kernel_schedule(
            w, generations=args.generations, pop_size=args.pop, seed=0,
            evaluator=evaluator, verbose=True, surrogate=args.surrogate,
            surrogate_keep=args.surrogate_keep)

        # compare against the baseline sample the search itself used (in
        # measured mode the preamble's t0 is an independent measurement)
        t0, _ = res.original_fitness
        print("\nPareto front (argmin(time, error)):")
        for ind in res.pareto:
            t, e = ind.fitness
            genome = w.space.decode(ind.patch.apply(w.program))
            mark = (f"  time -{(1 - t / t0) * 100:.1f}%"
                    if t < t0 * 0.999 else "")
            print(f"  time={t:.3e}  err={e:.2e}{mark}")
            print(f"    schedule: "
                  f"{', '.join(f'{k}={v}' for k, v in genome.items())}")
        gate = "" if within_tol else "  (no schedule met the error gate!)"
        print(f"\nbest-by-time schedule beats default by "
              f"{(1 - best.fitness[0] / t0) * 100:.1f}%{gate} "
              f"({search.n_evals} evaluations, "
              f"cache hit rate {search.cache.hit_rate:.0%})")
        if args.screen:
            ev = search.evaluator
            print(f"static screen: {ev.n_screened} variants resolved "
                  f"without execution {dict(sorted(ev.screened_by.items()))}")
        if args.surrogate:
            st = search.guide.stats()
            print(f"surrogate pre-rank: kept {st['kept']}/{st['ranked']} "
                  f"ranked offspring across {st['refits']} refits")
        if args.minimize:
            small, _ = minimize_patch(best.patch, search.evaluator,
                                      expect_fitness=best.fitness)
            print(f"minimized best-by-time patch: {len(best.patch)} -> "
                  f"{len(small)} edits at identical fitness; "
                  f"key tweaks: {small.describe()}")
    finally:
        evaluator.close()


if __name__ == "__main__":
    main()
