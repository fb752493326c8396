#!/usr/bin/env python3
"""Where two timing spreads on the card come from (run on a GPU).

    python3 tools/timing_spread.py [--part spread|instances|canary|both]

``spread``: the measured fitness of the unmutated MobileNet (alpha 1.0,
batch 64, as ``chip_smoke.py``'s ``programs`` phase builds it) evaluated
again and again, in ``chip_smoke.py``'s order (each evaluation followed by
its ``replay_profile`` under torch.profiler) and without the profiler
between them; the SM clock before each; and per-replay CUDA-event times of
one graph right after its capture and after 300 back-to-back replays.

``instances``: MobileNet's graph captured again and again (each capture
with its own constants and buffers, as each evaluation makes them): each
instance's median replay time by CUDA events, its kernels' device times
from torch.profiler, and where its buffers lie.

``canary``: the real live loop's A/A windows (qwen3-0.6b's smoke config,
its default trace), each measured four ways: three replays of one plan
after three of the other (the controller's old window), fifteen and
thirty-one of each in turns, and fifteen in turns with Python's garbage
collector off; the ratios and how many fall under the 0.95 floor.

``captures``: the measured fitness of the unmutated MobileNet evaluated
six times with each count of program graphs its time is the mean of
(``core/fitness.py`` ``PROGRAM_INSTANCES``: 1, 3, 5): each evaluation's
graph instances' times (s a replay, ``LAST_INSTANCES``) and their spread,
each triple's spread, the six's, and the wall seconds of an evaluation.

``device_canary``: 24 A/A windows (three runs' worth of ``chip_smoke.py``'s
8) of the real live loop, each measured in turns, fifteen replays a plan,
each replay under torch.profiler (``_device_timed``): by the
device's busy time and by CUDA events around the same replays; how many
fall under the 0.95 floor.

``placement``: 8 program graphs each of 2fcNet and MobileNet, each timed
over 3 graph instances on its own buffers and constants and over 3 more,
each after its buffers and constants were moved to new memory: whether
an instance's speed follows its graph or where its data lies.

Each part prints one JSON line; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def event_times(torch, run, n: int) -> list:
    """Per-call device times (ms) of ``n`` calls of ``run``, enqueued
    while the stream spins, as ``measured_time`` times them."""
    for cycles in (2_000_000, 8_000_000, 32_000_000, 128_000_000):
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        pairs = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            pairs.append((a, b))
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead:
            return [a.elapsed_time(b) for a, b in pairs]
    raise RuntimeError("the host never got ahead of the spin")


def spread_part(torch) -> dict:
    import chip_smoke as C
    from repro_torch.core.interp import ProgramGraph
    from repro_torch.workloads.mobilenet import \
        build_mobilenet_prediction_workload
    w = build_mobilenet_prediction_workload(
        alpha=1.0, batch=64, n_eval=2048, n_pretrain=6000, pretrain_epochs=3,
        time_mode="measured")
    inputs = {"images": w.images[:w.batch]}
    per_eval = len(w.images) // w.batch
    out = {"part": "spread"}
    for label, profiled in (("chip_smoke_order", True),
                            ("no_profiler", False),
                            ("chip_smoke_order_2", True)):
        rows = []
        for _ in range(4):
            clock = smi("clocks.sm,power.draw,temperature.gpu")
            t, _ = w.evaluate(w.program)
            row = {"measured_s": t, "sm_clock_before": clock}
            if profiled:
                row["busy_s"] = C.replay_profile(torch, w, inputs,
                                                 per_eval)["device_busy_s"]
            rows.append(row)
        ts = [r["measured_s"] for r in rows]
        out[label] = {"rows": rows, "spread": max(ts) / min(ts) - 1}
    images = torch.as_tensor(w.images[:w.batch]).to("cuda")
    seqs = []
    for _ in range(3):
        with ProgramGraph(w.program, "cuda") as g:
            g.load({"images": images})
            g.run()
            torch.cuda.synchronize()
            clock0 = smi("clocks.sm")
            cold = event_times(torch, g.run, 40)
            for _ in range(300):
                g.run()
            torch.cuda.synchronize()
            clock1 = smi("clocks.sm")
            warm = event_times(torch, g.run, 40)
        seqs.append({"clock_cold": clock0, "cold_ms": cold,
                     "clock_warm": clock1, "warm_ms": warm,
                     "cold_median": statistics.median(cold),
                     "warm_median": statistics.median(warm)})
    out["replays"] = seqs
    return out


def instances_part(torch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    from repro_torch.core.interp import ProgramGraph
    from repro_torch.workloads.mobilenet import \
        build_mobilenet_prediction_workload
    w = build_mobilenet_prediction_workload(
        alpha=1.0, batch=64, n_eval=2048, n_pretrain=6000, pretrain_epochs=3,
        time_mode="measured")
    images = torch.as_tensor(w.images[:w.batch]).to("cuda")
    rows = []
    for _ in range(12):
        with ProgramGraph(w.program, "cuda") as g:
            g.load({"images": images})
            g.run()
            torch.cuda.synchronize()
            med = statistics.median(event_times(torch, g.run, 20))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                g.run()
                torch.cuda.synchronize()
            spans = C.device_spans(torch, prof)
            ptrs = [t.data_ptr() for t in (*g._buffers.values(),
                                           *g._env0.values())]
        by_name: dict = {}
        for start, end, name in spans:
            by_name[name] = by_name.get(name, 0.0) + (end - start)
        rows.append({"event_ms": med, "kernels": len(spans),
                     "busy_us": C.busy_us(spans), "by_name": by_name,
                     "names": [n for _, _, n in spans],
                     "ptr_mod_2mib": [p % (2 << 20) for p in ptrs[:6]],
                     "ptr_mod_4k": [p % 4096 for p in ptrs[:6]]})
    fast = min(rows, key=lambda r: r["event_ms"])
    slow = max(rows, key=lambda r: r["event_ms"])
    diff = sorted(((slow["by_name"].get(n, 0.0) - fast["by_name"].get(n, 0.0),
                    n) for n in set(fast["by_name"]) | set(slow["by_name"])),
                  reverse=True)
    for r in rows:
        r.pop("by_name")
        r["names"] = hash(tuple(r["names"]))
    return {"part": "instances", "rows": rows,
            "same_kernels": fast["names"] == slow["names"],
            "slow_minus_fast_us": diff[:8] + diff[-3:]}


def captures_part(torch) -> dict:
    from repro_torch.core import fitness
    from repro_torch.workloads.mobilenet import \
        build_mobilenet_prediction_workload
    w = build_mobilenet_prediction_workload(
        alpha=1.0, batch=64, n_eval=2048, n_pretrain=6000, pretrain_epochs=3,
        time_mode="measured")
    out = {"part": "captures", "default": fitness.PROGRAM_INSTANCES,
           "by_captures": {}}
    saved = fitness.PROGRAM_INSTANCES
    try:
        for k in (1, 3, 5):
            fitness.PROGRAM_INSTANCES = k
            ts, walls, inst = [], [], []
            for _ in range(6):
                t0 = time.perf_counter()
                t, _ = w.evaluate(w.program)
                walls.append(time.perf_counter() - t0)
                ts.append(t)
                inst.append(list(fitness.LAST_INSTANCES))
            out["by_captures"][k] = {
                "measured_s": ts,
                "instances_s": inst,
                "instance_spreads": [max(i) / min(i) - 1 for i in inst],
                "triple_spreads": [max(ts[i:i + 3]) / min(ts[i:i + 3]) - 1
                                   for i in (0, 3)],
                "spread": max(ts) / min(ts) - 1,
                "wall_s_per_evaluation": statistics.median(walls)}
    finally:
        fitness.PROGRAM_INSTANCES = saved
    return out


def _recapture(g) -> None:
    """Release ``g``'s captured graph and capture its op list again, on
    the same constants and input buffers."""
    from repro_torch.device import CudaGraph
    g._graph.release()
    graph = CudaGraph(g.device)
    g._static = graph.capture(g._outputs_of_run)
    g._graph = graph


def placement_part(torch) -> dict:
    """Whether a graph instance's speed follows its program graph: for
    2fcNet and MobileNet (as the ``programs`` phase builds them), 8
    program graphs, each timed as the measured fitness times it
    (``measured_time``) over 3 instances captured on its own buffers and
    constants (``_recapture``), then over 3 more, each captured after its
    buffers and constants were copied to new memory (allocated while the
    old was held, so at other addresses)."""
    import numpy as np

    from repro_torch.core.fitness import measured_time
    from repro_torch.core.interp import ProgramGraph
    from repro_torch.workloads.mobilenet import \
        build_mobilenet_prediction_workload
    from repro_torch.workloads.twofc import build_twofc_training_workload
    twofc = build_twofc_training_workload(time_mode="measured")
    mobilenet = build_mobilenet_prediction_workload(
        alpha=1.0, batch=64, n_eval=2048, n_pretrain=6000, pretrain_epochs=3,
        time_mode="measured")
    eye = np.eye(twofc.num_classes, dtype=np.float32)
    inputs = {"twofc": {**twofc.init_weights, "x": twofc.train_x[:32],
                        "y_onehot": eye[twofc.train_y[:32]]},
              "mobilenet": {"images": mobilenet.images[:mobilenet.batch]}}
    out = {"part": "placement"}
    for name, w in (("twofc", twofc), ("mobilenet", mobilenet)):
        rows = []
        for _ in range(8):
            with ProgramGraph(w.program, "cuda") as g:
                g.load(inputs[name])
                g.run()
                same, moved = [], []
                for i in range(3):
                    if i:
                        _recapture(g)
                    same.append(measured_time(g.run, "cuda"))
                for _ in range(3):
                    g._buffers = {k: v.clone()
                                  for k, v in g._buffers.items()}
                    g._env0 = {k: v.clone() for k, v in g._env0.items()}
                    _recapture(g)
                    moved.append(measured_time(g.run, "cuda"))
            rows.append({"same": same, "moved": moved})
        out[name] = rows
    return out


def device_canary_part(torch) -> dict:
    from repro_torch.configs import smoke_config
    from repro_torch.core.deploy.engine import DEFAULT_SERVE_PLAN
    from repro_torch.core.liveloop import LiveLoopController
    from repro_torch.core.liveloop.controller import _device_timed
    from repro_torch.core.liveloop.traces import synthesize
    vocab = smoke_config("qwen3-0.6b").vocab
    out = {"part": "device_canary", "windows": []}
    with tempfile.TemporaryDirectory() as tmp:
        ctl = LiveLoopController(f"{tmp}/loop", mode="real",
                                 trace=synthesize(vocab=vocab))
        g = dict(DEFAULT_SERVE_PLAN)
        for w in range(24):
            tr = ctl._window_slice(2000 + w)
            busy = _device_timed(ctl._replayer(tr, g))
            # busy time and CUDA events over the same profiled replays
            out["windows"].append({"requests": len(tr), **dict(zip(
                ("busy_turns_15", "events_turns_15"),
                _window((busy, busy), 15, True, False,
                        keys=("throughput_busy_tok_s",
                              "throughput_event_tok_s"))))})
    out["under_0.95"] = {k: sum(w[k] < 0.95 for w in out["windows"])
                         for k in ("busy_turns_15", "events_turns_15")}
    return out


def _window(ones, repeats: int, interleave: bool, no_gc: bool,
            keys=None):
    """The throughput ratio candidate / base of one A/A window: each
    plan's median of ``repeats`` replays, taken in turns or one plan's
    after the other's, with the garbage collector off or on; with
    ``keys``, the ratio by each of those throughputs of the same
    replays."""
    import gc
    if keys is not None:
        runs = ([], [])
        for side in [0, 1] * repeats:
            runs[side].append(ones[side]())
        return tuple(statistics.median(r[k] for r in runs[1])
                     / statistics.median(r[k] for r in runs[0])
                     for k in keys)
    runs = ([], [])
    order = ([0, 1] * repeats if interleave
             else [0] * repeats + [1] * repeats)
    if no_gc:
        gc.collect()
        gc.disable()
    try:
        for side in order:
            runs[side].append(ones[side]()["throughput_tok_s"])
    finally:
        gc.enable()
    return statistics.median(runs[1]) / statistics.median(runs[0])


def canary_part(torch) -> dict:
    from repro_torch.configs import smoke_config
    from repro_torch.core.deploy.engine import DEFAULT_SERVE_PLAN
    from repro_torch.core.liveloop import LiveLoopController
    from repro_torch.core.liveloop.traces import synthesize
    vocab = smoke_config("qwen3-0.6b").vocab
    methods = {"sequential_3": (3, False, False),
               "turns_15": (15, True, False),
               "turns_31": (31, True, False),
               "turns_15_no_gc": (15, True, True)}
    out = {"part": "canary", "windows": []}
    with tempfile.TemporaryDirectory() as tmp:
        ctl = LiveLoopController(f"{tmp}/loop", mode="real",
                                 trace=synthesize(vocab=vocab))
        g = dict(DEFAULT_SERVE_PLAN)
        for w in range(12):
            tr = ctl._window_slice(1000 + w)
            one = ctl._replayer(tr, g)      # warms the pair once
            out["windows"].append({"requests": len(tr), **{
                name: _window((one, one), *m) for name, m in
                methods.items()}})
    out["under_0.95"] = {name: sum(w[name] < 0.95 for w in out["windows"])
                         for name in methods}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", default="both",
                    choices=("spread", "instances", "canary", "both",
                             "captures", "device_canary", "placement"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("timing_spread.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    print(smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    if args.part in ("canary", "both"):
        print(json.dumps(canary_part(torch)), flush=True)
    if args.part in ("spread", "both"):
        print(json.dumps(spread_part(torch)), flush=True)
    if args.part == "instances":
        print(json.dumps(instances_part(torch)), flush=True)
    if args.part == "captures":
        print(json.dumps(captures_part(torch)), flush=True)
    if args.part == "device_canary":
        print(json.dumps(device_canary_part(torch)), flush=True)
    if args.part == "placement":
        print(json.dumps(placement_part(torch)), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
