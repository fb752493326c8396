#!/usr/bin/env python3
"""Find the highest rate a serving cell's engine sustains, once, on the
card: the cell's mix offered at each rate for ``--seconds``, with the
requests finished inside the window, the backlog left at its close and the
first-token tail at each (every request due in the window is drained,
whatever the mix's ``drain``).  Not part of a benchmark run; the cell's
traffic file then holds a rate fixed from the knee as a number: four fifths
of it where a tail is measured, above it where the rate completed is.

    python3 bench/sweep.py --workload <name> --rates 3 5 8 12 --seconds 20
"""

import argparse
import json
import sys
import time

from run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args(argv)
    _environment()
    import gc

    import torch
    from harness import cells, serve
    from harness.trace import Tracer
    cell = cells.cell(args.workload)
    for rate in args.rates:
        cell.traffic.update(rate=rate, drain="all")
        t0 = time.perf_counter()
        run = serve.run(cell, seed=args.seed, seconds=args.seconds,
                        tracer=Tracer(False), device="cuda",
                        clock=lambda: time.perf_counter() - t0, check=False,
                        drain_s=5.0)
        done = run.extra["done_in_window"]
        print(json.dumps({"rate": rate, "due": run.attempted,
                          "done_in_window": done,
                          "completed_per_s": done / args.seconds,
                          "unanswered_after_drain": run.failed,
                          "tokens_per_s": run.e2e["serve_tokens_per_s"],
                          "ttft_p90_s": run.extra["ttft_p90_s"],
                          "decode_ms_median": sorted(run.step_ms["decode"])[
                              len(run.step_ms["decode"]) // 2]
                          if run.step_ms["decode"] else None,
                          "notes": run.notes}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
