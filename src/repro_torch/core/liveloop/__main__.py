"""CLI for the live loop: ``python -m repro_torch.core.liveloop <command>``.

The counterpart of the reference's ``repro.core.liveloop`` CLI.  ``run
--mode real`` replays on the GPU unless ``--device`` names another device;
the modeled loop and the journal commands touch no device.

Commands:

* ``synth`` — synthesize a workload scenario trace to a JSON file;
* ``run`` — drive a loop N ticks at a root directory (creating it from a
  trace file or a named scenario on first run, resuming otherwise);
* ``status`` — the loop's journaled state: tick, canary, incumbent,
  cache size;
* ``promote`` — operator override: promote the active canary now;
* ``rollback`` — operator override: roll back the active canary (or
  demote the incumbent), blocking its fingerprint.

Everything acts through the same journals the controller uses, so a
``promote`` issued while a loop is stopped is visible to the resumed
loop — and vice versa.
"""

from __future__ import annotations

import argparse
import json
import sys

from .canary import CanaryBook, Guardrails
from .controller import LiveLoopController
from .traces import SCENARIOS, Trace, synthesize


def _add_synth(sub):
    p = sub.add_parser("synth", help="synthesize a scenario trace")
    p.add_argument("--scenario", default="bursty", choices=SCENARIOS)
    p.add_argument("--n-requests", type=int, default=16)
    p.add_argument("--max-prompt", type=int, default=16)
    p.add_argument("--gen", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--out", required=True, help="trace JSON path")


def _add_run(sub):
    p = sub.add_parser("run", help="drive the loop N ticks (resumable)")
    p.add_argument("--root", required=True, help="loop state directory")
    p.add_argument("--ticks", type=int, default=4)
    p.add_argument("--trace", help="trace JSON to start from (first run)")
    p.add_argument("--scenario", choices=SCENARIOS,
                   help="or synthesize this scenario on first run")
    p.add_argument("--n-requests", type=int, default=16)
    p.add_argument("--max-prompt", type=int, default=16)
    p.add_argument("--gen", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--arch", default="qwen3-0.6b")
    p.add_argument("--mode", default="modeled", choices=("modeled", "real"))
    p.add_argument("--device", default=None,
                   help="torch device of --mode real replays (default: the "
                        "GPU; without one, pass --device cpu)")
    p.add_argument("--gens-per-tick", type=int, default=2)
    p.add_argument("--pop", type=int, default=8)
    p.add_argument("--fraction", type=float, default=0.5)
    p.add_argument("--windows", type=int, default=2,
                   help="measurement windows per canary verdict")
    p.add_argument("--min-throughput-ratio", type=float, default=None,
                   help="promotion floor on canary/baseline throughput "
                        "(default: 1.0 for --mode modeled, whose shadow "
                        "replays are deterministic; 0.95 for --mode real, "
                        "leaving noise headroom)")
    p.add_argument("--no-surrogate", action="store_true")
    p.add_argument("--inject-regression", action="store_true",
                   help="fault drill: slow every canary measurement 3x "
                        "(the rollback path, exercised on purpose)")
    p.add_argument("--verbose", action="store_true")


def _add_root_cmd(sub, name, help_):
    p = sub.add_parser(name, help=help_)
    p.add_argument("--root", required=True)


def _controller(args) -> LiveLoopController:
    trace = None
    if args.trace:
        trace = Trace.load(args.trace)
    elif args.scenario:
        trace = synthesize(args.scenario, vocab=args.vocab,
                           n_requests=args.n_requests,
                           max_prompt=args.max_prompt, gen=args.gen,
                           seed=args.seed)
    fault = None
    if args.inject_regression:
        def fault(genome, metrics):
            m = dict(metrics)
            m["throughput_tok_s"] = round(m["throughput_tok_s"] / 3.0, 6)
            m["mean_ttft_s"] = round(m["mean_ttft_s"] * 3.0, 6)
            m["mean_latency_s"] = round(m["mean_latency_s"] * 3.0, 6)
            return m
    ratio = args.min_throughput_ratio
    if ratio is None:
        ratio = 1.0 if args.mode == "modeled" else 0.95
    return LiveLoopController(
        args.root, trace=trace, arch=args.arch, mode=args.mode,
        gens_per_tick=args.gens_per_tick, pop=args.pop, seed=args.seed,
        fraction=args.fraction,
        guardrails=Guardrails(windows=args.windows,
                              min_throughput_ratio=ratio),
        fault_hook=fault, surrogate=not args.no_surrogate,
        verbose=args.verbose, device=args.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.liveloop",
        description="continuous evolution under replayed traffic with "
                    "canary promotion")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_synth(sub)
    _add_run(sub)
    _add_root_cmd(sub, "status", "journaled loop state")
    _add_root_cmd(sub, "promote", "force-promote the active canary")
    _add_root_cmd(sub, "rollback", "force-rollback (and block) the canary")
    args = ap.parse_args(argv)

    if args.command == "synth":
        trace = synthesize(args.scenario, vocab=args.vocab,
                           n_requests=args.n_requests,
                           max_prompt=args.max_prompt, gen=args.gen,
                           seed=args.seed)
        trace.save(args.out)
        print(json.dumps(trace.summary(), indent=1))
        return 0

    if args.command == "run":
        ctl = _controller(args)
        for summary in ctl.run(args.ticks):
            print(json.dumps(summary))
        print(json.dumps({"status": ctl.status()}, indent=1))
        return 0

    if args.command == "status":
        import os
        state_path = os.path.join(args.root, "state.json")
        if not os.path.exists(state_path):
            print(f"no live loop at {args.root}", file=sys.stderr)
            return 1
        ctl = LiveLoopController(args.root)
        print(json.dumps(ctl.status(), indent=1))
        return 0

    # promote / rollback act on the journal directly — no controller (and
    # no model) needed, and a stopped loop picks the change up on resume
    import os
    book_path = os.path.join(args.root, "canary.json")
    if not os.path.exists(book_path):
        print(f"no canary journal at {book_path}", file=sys.stderr)
        return 1
    book = CanaryBook(book_path)
    state_path = os.path.join(args.root, "state.json")
    tick = 0
    if os.path.exists(state_path):
        tick = json.load(open(state_path)).get("tick", 0)
    if args.command == "promote":
        out = book.force_promote(tick=tick)
    else:
        out = book.force_rollback(tick=tick)
    if out is None:
        print("nothing to act on (no active canary"
              + ("" if args.command == "promote" else " or incumbent")
              + ")", file=sys.stderr)
        return 1
    print(json.dumps({"result": out, "status": book.status()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
