"""Probe of the rmsnorm and Mamba-scan backward kernels on one GPU.

    python3 tools/bwd_ab.py [--label NAME] [--kernels rmsnorm,mamba_scan]
                            [VARIANT.cu ...]

Builds this checkout's rmsnorm and mamba_scan libraries and prints the
``ptxas`` registers and spills of their backward kernels.  Then, for each
backward shape of ``chip_smoke.py``'s train phase (``BWD_PATH`` and
``BWD_FULL``; ``--shapes full`` for full width alone), it holds the kernel
against its plain version (``BWD_TOL``, two calls the same bits), times
it (median of 20 calls, L2 flushed before each) and gives the device time
of every CUDA kernel one call launches, by torch.profiler.  For rmsnorm it
does the same for ``F.rms_norm``'s backward (``torch.autograd.grad`` on a
graph built once, so the forward is not timed).  Every time is taken
twice: as ``chip_smoke.time_ms`` takes it, and with a spin kernel holding
the stream while the host enqueues the call (``chip_smoke.spin_ms``),
which leaves the host's work out.

Each VARIANT.cu is another ``rmsnorm.cu`` or ``mamba_scan.cu`` with the
same C interface (which one, its file name's prefix says), built with the
tree's flags and headers under ``build/``; at every shape of its kernel it
is checked and timed in turns with the tree's (tree, variants, variants,
tree), through the tree's wrappers.  A variant that needs other settings
of those wrappers declares them in lines ``// ab: MODULE NAME VALUE``; a
variant that fails its check is timed all the same, one that does not
launch is dropped.  Every line carries ``--label``.  One JSON line a
shape; the card's name and power limit last.  Exits nonzero without a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def device_ms(torch, fn, calls: int = 5) -> dict:
    """Device milliseconds one call of ``fn`` spends in each CUDA kernel
    it launches, by torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:72]: e.device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=str(ROOT.name))
    ap.add_argument("--kernels", default="rmsnorm,mamba_scan")
    ap.add_argument("--shapes", choices=("all", "full"), default="all",
                    help="every training-run shape and full width, or "
                         "full width alone")
    ap.add_argument("variants", nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bwd_ab.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    kernels = args.kernels.split(",")
    build.build(tuple(kernels))
    libs = {k: {"tree": build.library(k)} for k in kernels}
    logs = {(k, "tree"): build.library_path(k).with_suffix(".log")
            .read_text() for k in kernels}
    procs = {}
    for src in args.variants:
        kernel = next(k for k in kernels if Path(src).name.startswith(k))
        out = build.BUILD_DIR / f"ab_{Path(src).stem}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        procs[(kernel, Path(src).stem)] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out), src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    for (kernel, name), (out, proc) in procs.items():
        logs[(kernel, name)] = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{logs[(kernel, name)]}")
        lib = ctypes.CDLL(str(out))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[kernel][name] = lib
    for (kernel, name), text in logs.items():
        for r in cs.ptxas_report(text):
            if "bwd" in r["kernel"]:
                print(json.dumps({"label": args.label, "library": name,
                                  "ptxas": kernel, **r}), flush=True)

    # a variant may declare Python settings of the tree's wrappers it needs
    # while it is in use, one a line: "// ab: MODULE NAME VALUE"
    import importlib
    overrides = {}
    for src in args.variants:
        for ln in Path(src).read_text().splitlines():
            if ln.startswith("// ab: "):
                mod, attr, value = ln[len("// ab: "):].split()
                overrides.setdefault(Path(src).stem, []).append(
                    (importlib.import_module(mod), attr, int(value)))
    saved = {(m, a): getattr(m, a) for v in overrides.values()
             for m, a, _ in v}

    def use(kernel, name):
        build._LOADED[kernel] = libs[kernel][name]
        for (m, a), v in saved.items():
            setattr(m, a, v)
        for m, a, v in overrides.get(name, []):
            setattr(m, a, v)

    for name, lib in libs.get("mamba_scan", {}).items():
        out = (ctypes.c_int * 2)()
        fn = lib.mamba_scan_bwd_occupancy
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        err = fn(16, 0, out)
        print(json.dumps({"label": args.label, "library": name,
                          "occupancy_n16_f32": [err, out[0], out[1]]}),
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rates = cs.device_rates()
    for kernel in kernels:
        shapes = [cs.BWD_FULL[kernel]]
        if args.shapes == "all":
            shapes[:0] = cs.BWD_PATH[kernel]
        for s, dtype in shapes:
            use(kernel, "tree")
            i, _ = cs.bwd_inputs(torch, kernel, s, dtype, gen, full=True)
            row = {"label": args.label, "kernel": kernel, "shape": s,
                   "dtype": dtype, "max_abs_err": {}, "ms": {},
                   "device_ms": {}}

            def call():
                return cs.run_bwd(kernel, i, plain=False)
            for name in list(libs[kernel]):
                use(kernel, name)
                try:
                    row["max_abs_err"][name] = cs.bwd_check(torch, kernel, i,
                                                            dtype)
                except Exception as e:  # a variant kept for its time
                    if name == "tree":
                        raise
                    row["max_abs_err"][name] = str(e)[:120]
                    if "CUDA error" in str(e):  # it does not launch
                        del libs[kernel][name]
                        continue
                row["device_ms"][name] = device_ms(torch, call)
            names = list(libs[kernel])
            for name in [*names, *reversed(names)]:
                use(kernel, name)
                row["ms"].setdefault(name, []).append(
                    cs.time_ms(torch, call, reps=20, flush=flush))
                row.setdefault("spin_ms", {}).setdefault(name, []).append(
                    cs.spin_ms(torch, call, reps=20, flush=flush))
            use(kernel, "tree")
            row["bound_ms"], row["bound_by"] = cs.bwd_bound(
                kernel, s, dtype, rates)[:2]
            lib = cs.bwd_library_call(torch, kernel, i)
            if lib is not None:
                row["library_ms"] = cs.time_ms(torch, lib, reps=20,
                                                flush=flush)
                row["library_spin_ms"] = cs.spin_ms(torch, lib, reps=20,
                                                    flush=flush)
                row["library_device_ms"] = device_ms(torch, lib)
            print(json.dumps(row), flush=True)
            del i
            torch.cuda.empty_cache()
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
