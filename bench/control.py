#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, at the cell's
own size: the program's compared numbers over many seeds (the lower
readings), the control's (the plain reference computed from fp8 operands,
in the program's place) and the faults' a training cell can have (the
upper readings).  Not part of a benchmark run.

    python3 bench/control.py --workload <name> --seeds 1 2 3 ... \
        [--seconds 8] [--out control.jsonl]

Training: per seed, the program's first steps (sound, and with half of
each batch left out, the mean taken over the rest), the float32
reference's and the fp8 control's; a step that returns its state unchanged
reads 1 on the change by definition and needs no run.  Serving: per seed,
a short window at the cell's own load, then the served tokens' widest gap
under the float32 reference and the fp8 control's widest gap at the same
positions.  One JSON line a seed.
"""

import argparse
import gc
import json
import sys
import time

from run import _environment, since_start


def half_batch(step):
    """The fault: half of each batch left out, the mean over the rest."""
    def faulty(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in
                            batch.items()})
    return faulty


def free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_seed(cell, seed: int) -> dict:
    from harness import train
    out = {}
    for label, fault in (("program", None), ("half_batch", half_batch)):
        state, step, tokens, got = train.program_steps(cell, seed, "cuda",
                                                       fault=fault)
        del state, step, tokens
        free()
        out[label] = got
    ref = train.reference_steps(cell, seed, "cuda")
    free()
    out["control"] = train.reference_steps(cell, seed, "cuda", "fp8")
    free()
    row = {"seed": seed, "reference_loss": ref["loss"]}
    for label in ("program", "half_batch", "control"):
        g = train._gaps(out[label], ref)
        row[label] = {k: g[k] for k in ("loss_gap", "grad_gap", "change_gap",
                                        "grad_gap_median",
                                        "change_gap_median", "grad_leaf",
                                        "change_leaf")}
        row[label]["loss"] = out[label]["loss"]
    row["left_out"] = train._gaps(out["program"], ref)["left_out"]
    return row


def serve_seed(cell, seed: int, seconds: float) -> dict:
    from harness import serve
    from harness.trace import Tracer
    t0 = time.perf_counter()
    run = serve.run(cell, seed=seed, seconds=seconds, tracer=Tracer(False),
                    device="cuda", clock=lambda: time.perf_counter() - t0,
                    control="fp8")
    free()
    return {"seed": seed, "program": {"served_token_gap": run.checks[0][1]},
            "control": {"served_token_gap": run.extra["control_gap"]},
            "tokens_per_s": run.e2e["serve_tokens_per_s"],
            "ttft_p90_s": run.extra["ttft_p90_s"],
            "attempted": run.attempted, "failed": run.failed,
            "notes": run.notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from harness import cells
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = cells.cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        row = (train_seed(cell, seed) if cell.runner == "train"
               else serve_seed(cell, seed, args.seconds))
        row["workload"] = args.workload
        row["s"] = time.perf_counter() - t
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    print(f"since start {since_start():.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
