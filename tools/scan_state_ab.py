#!/usr/bin/env python3
"""Time the selective-scan kernel of another source against this tree's, in
one process on one GPU: Falcon-Mamba-7B's full width (Bt 1, L 4096,
D 8192, N 16) in bf16, chunk 64, and the model's f32 prefill shape (L 512),
the L2 cache flushed before each timed call, median of 20 calls a round.

    git show <commit>:src/repro_torch/csrc/mamba_scan.cu > build/scan_ab/base.cu
    PYTHONPATH=src python tools/scan_state_ab.py --baseline build/scan_ab/base.cu

The baseline is a ``mamba_scan.cu`` whose C entry takes no final-state
pointer (the kernel before ``h_last``); it is built here with the port's
``nvcc`` flags and headers.  Rounds run baseline, this tree (y only), this
tree (y and the final state), then the same in reverse order, three times;
the baseline's and this tree's y must be equal bit for bit.  Prints one
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _baseline(src: Path):
    """The baseline's launcher, built into build/scan_ab/."""
    from repro_torch.kernels import build
    out = ROOT / "build" / "scan_ab" / (src.stem + ".so")
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(out), str(src)], check=True)
    fn = ctypes.CDLL(str(out)).mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan.mamba_scan import geometry, smem_bytes
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    if not torch.cuda.is_available():
        print("scan_state_ab: no CUDA device", file=sys.stderr)
        return 2
    base_fn = _baseline(args.baseline)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(L, dtype):
        seq = (1, L, 8192)
        return (torch.nn.functional.softplus(
                    torch.randn(seq, generator=gen, device="cuda")).to(dtype),
                torch.randn(seq, generator=gen, device="cuda").to(dtype),
                -torch.exp(0.3 * torch.randn((8192, 16), generator=gen,
                                             device="cuda")),
                torch.randn((1, L, 16), generator=gen,
                            device="cuda").to(dtype),
                torch.randn((1, L, 16), generator=gen,
                            device="cuda").to(dtype))

    def baseline(dt, x, A, B, C):
        Bt, L, D = x.shape
        y = torch.empty_like(x)
        geo = geometry({"Bt": Bt, "L": L, "D": D, "N": 16})
        err = base_fn(dt.data_ptr(), x.data_ptr(), A.data_ptr(),
                      B.data_ptr(), C.data_ptr(), y.data_ptr(), Bt, L, D, 16,
                      64, build.DTYPE_CODES[x.dtype], geo["lanes"],
                      geo["channels"],
                      smem_bytes({"chunk": 64}, {"N": 16}, x.dtype),
                      build.stream_ptr(x.device))
        if err:
            raise RuntimeError(f"baseline launch: CUDA error {err}")
        return y

    def ms(fn):
        for _ in range(2):
            fn()
        pairs = []
        for _ in range(20):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    out = {"gpu": _smi(), "shapes": {}}
    for name, L, dtype in (("full_bf16", 4096, torch.bfloat16),
                           ("model_f32", 512, torch.float32)):
        args_ = inputs(L, dtype)
        variants = {
            "baseline": lambda: baseline(*args_),
            "y": lambda: mamba_scan(*args_, chunk=64),
            "y_and_h_last": lambda: mamba_scan(*args_, chunk=64,
                                               return_state=True)}
        if not torch.equal(variants["baseline"](), variants["y"]()):
            raise AssertionError(f"{name}: y differs from the baseline's")
        order = list(variants) + list(variants)[::-1]
        rounds = {k: [] for k in variants}
        for _ in range(args.rounds):
            for k in order:
                rounds[k].append(ms(variants[k]))
        out["shapes"][name] = {
            "L": L, "dtype": str(dtype)[6:], "ms_by_round": rounds,
            "median_ms": {k: statistics.median(v)
                          for k, v in rounds.items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
