"""A/B probe of the bf16 flash-attention backward on one GPU.

    python3 tools/flash_bwd_ab.py [VARIANT.cu ...]

Builds the tree's ``csrc/flash_attention.cu`` and each variant source (an
alternative ``flash_attention.cu`` with the same C interface, compiled
with the tree's flags and headers next to it under ``build/``), prints the
``ptxas`` registers, spills and wgmma serialization of the bf16 backward
kernels, and holds every library's backward against the plain version at
ragged shapes, a qwen3-0.6b training step's attention (8, 16, 1024, 128)
and full width (1, 16, 4096, 128), causal, bf16 (``chip_smoke.py``'s
``BWD_TOL``).  At the two large shapes it times each library in turns
(tree, variants, variants, tree), SDPA's backward beside them, and the
device time of each kernel by torch.profiler.  One JSON line a shape; the
card's name and power limit last.  Every library gets the shared memory
of six 64-row slabs and the tree's stages, and a scratch padded to 256
rows a (batch, head), so a variant whose layout differs from the tree's
runs through the tree's wrapper.  Exits nonzero without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPES = ([{"B": 1, "H": 2, "S": S, "hd": hd, "causal": True}
           for S in (100, 320) for hd in (32, 64, 128)]
          + [{"B": 1, "H": 2, "S": 96, "hd": hd, "causal": False}
             for hd in (32, 64, 128)]
          + [{"B": 8, "H": 16, "S": 1024, "hd": 128, "causal": True},
             {"B": 1, "H": 16, "S": 4096, "hd": 128, "causal": True}])


def main(variants: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab.py: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    fa.bwd_smem_bytes = lambda hd, dtype=torch.bfloat16: (
        fa.ALIGN_SLACK + fa.BARRIER_BYTES + 6 * 64 * hd * 2
        + fa.BWD_STAGES * (2 * 64 * hd * 2 + 512))
    fa.bwd_scratch_floats = lambda bh, Sq, dtype: 2 * bh * (Sq + 256)

    build.build(("flash_attention",))
    logs = {"tree": build.library_path(
        "flash_attention").with_suffix(".log").read_text()}
    libs = {"tree": build.library("flash_attention")}
    procs = {}
    for src in variants:
        out = build.BUILD_DIR / f"ab_{Path(src).stem}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        procs[Path(src).stem] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out), src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    for name, (out, proc) in procs.items():
        logs[name] = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{logs[name]}")
        lib = ctypes.CDLL(str(out))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    for name, text in logs.items():
        for ln in text.splitlines():
            if "serialized" in ln:
                print(json.dumps({"ptxas_note": name, "line": ln[:300]}))
        for r in cs.ptxas_report(text):
            if any(k in r["kernel"] for k in cs.FLASH_BWD_BF16):
                print(json.dumps({"ptxas": name, **r}), flush=True)

    def use(name):
        build._LOADED["flash_attention"] = libs[name]

    gen = torch.Generator(device="cuda").manual_seed(20)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rates = cs.device_rates()
    for s in SHAPES:
        full = s["S"] >= 1024
        i, _ = cs.bwd_inputs(torch, "flash_attention", s, "bfloat16", gen,
                             full=full)
        row = {"shape": s, "max_abs_err": {}}
        for name in libs:
            use(name)
            row["max_abs_err"][name] = cs.bwd_check(
                torch, "flash_attention", i, "bfloat16")
        if full:
            row["ms"] = {n: [] for n in libs}
            for name in [*libs, *reversed(list(libs))]:
                use(name)
                row["ms"][name].append(cs.time_ms(
                    torch, lambda: cs.run_bwd("flash_attention", i,
                                              plain=False),
                    reps=20, flush=flush))
            row["sdpa_ms"] = cs.time_ms(
                torch, cs.bwd_library_call(torch, "flash_attention", i),
                reps=20, flush=flush)
            row["bound_ms"] = cs.bwd_bound("flash_attention", s, "bfloat16",
                                           rates)[0]
            row["kernel_device_ms"] = {}
            for name in libs:
                use(name)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        cs.run_bwd("flash_attention", i, plain=False)
                    torch.cuda.synchronize()
                row["kernel_device_ms"][name] = {
                    e.key.split("::")[-1].split("(")[0][:32]:
                    e.device_time_total / 5 / 1e3
                    for e in prof.key_averages() if e.device_time_total > 0}
        use("tree")
        print(json.dumps(row), flush=True)
        del i
        torch.cuda.empty_cache()
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
