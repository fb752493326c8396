#!/usr/bin/env python3
"""Run one cell of the PyTorch/CUDA port's benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).
The cell is an entry of ``BENCHMARK.json``'s ``workloads``; the files it
names are read from ``bench/`` (``harness/__init__.py``).  With
``--trace 0`` the run reports the cell's end-to-end metrics; with
``--trace 1`` it profiles the measured window and reports the cell's
per-layer metrics.  Either way it checks what the timed path produced
against the plain reference, prints each compared number beside its limit
as the last lines of standard error, and prints one JSON object as the
last line of standard output.  It needs the CUDA devices the cell asks
for, and exits nonzero with no result without them, or if a module of
JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache at a fixed place inside the checkout
CACHE = ROOT / "build" / "bench_cache"


def since_start() -> float:
    """Seconds since this process started (the kernel's record of it, to
    its clock tick), or since this file began running where there is no
    such record."""
    try:
        stat = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        up = float(Path("/proc/uptime").read_text().split()[0])
        return up - int(stat[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T0


def _environment() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def reader(name: str, root: Path = ROOT):
    """The reader module ``bench/metrics/<name>.py`` of ``root``."""
    key = f"metrics.{name}"
    if key not in sys.modules or Path(sys.modules[key].__file__) != \
            root / "bench" / "metrics" / f"{name}.py":
        spec = importlib.util.spec_from_file_location(
            key, root / "bench" / "metrics" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def per_layer(cell, run, root: Path = ROOT) -> dict:
    from harness.cells import metric_params
    out = {}
    for m in cell.per_layer:
        params = dict(metric_params(m["name"], root))
        value = reader(params.pop("reader"), root).read(run, **params)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell, run, trace: bool, root: Path = ROOT) -> dict:
    import torch
    if trace:
        metrics = per_layer(cell, run, root)
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in run.e2e}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": run.memory_peak}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_ns() / 1e9
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in run.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from harness import cells, imports
    from harness.trace import Tracer
    bad = imports.reference_violations(BENCH / "reference")
    if bad:
        print(f"the references import what they may not: {bad}",
              file=sys.stderr)
        return 2
    cell = cells.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    runner = importlib.import_module(f"harness.{cell.runner}")
    run = runner.run(cell, seed=args.seed, seconds=args.seconds,
                     tracer=Tracer(bool(args.trace)), device="cuda",
                     clock=since_start)
    found = imports.loaded()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 4
    line = result(cell, run, bool(args.trace))
    for note in run.notes:
        print(note, file=sys.stderr)
    print(f"memory: device allocated peak {run.memory_peak} B, reserved "
          f"peak {torch.cuda.max_memory_reserved()} B; host resident peak "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B",
          file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, v in line["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
