#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``     — the card (``nvidia-smi``), versions, and the build of the
                    three CUDA kernels from ``src/repro_torch/csrc`` (one
                    ``nvcc`` per source, started together); the count of
                    ``HGMMA`` (tensor-core) instructions in the built flash
                    library and of ``MUFU.EX2`` (ex2-unit) instructions in
                    the scan's (``cuobjdump -sass``), and the ``ptxas``
                    registers and spills of every kernel instantiation.
2. ``search_shapes`` — every kernel genome of the three schedule spaces at
                    the search's evaluation shapes in float32, and the
                    default schedules in bfloat16: the kernel against its
                    plain PyTorch version and the ``ref.py`` oracle;
                    flash attention at head dim 128 in float32 over every
                    block_q x block_k that fits shared memory; flash in
                    bfloat16 over every block_q x block_k of the joint
                    space that divides S, at head dims 32, 64 and 128,
                    against the plain version and bit-identical across
                    block_q for each block_k; rmsnorm bit-identical across
                    block_rows, and the scan across chunk, in float32 and
                    bfloat16.
3. ``full_width`` — each kernel at the width of a configured model, bf16,
                    default schedule: times of the kernel, its plain
                    version and the library call, the bound, the error;
                    for the scan also the floor its exponentials set
                    (``exp_floor_ms``) and its device time from
                    torch.profiler beside the CUDA-event time.
4. ``overheads``  — the per-block and per-timestep costs of the cost
                    model's H100 record, measured.
5. ``search``     — the main path: the measured kernel-schedule search
                    (``evolve_kernel_schedule``; each variant timed as a
                    CUDA graph whose replays add their launches to the
                    wrappers' counts) on each kernel, and the joint
                    three-kernel workload in static mode, each with the
                    launch counts set to 0 before it; each measured search
                    must launch its kernel, the joint one all three.  Then
                    a measured flash-attention search with the static
                    screen and the surrogate pre-rank, each statically
                    invalid verdict held against the message executing the
                    patch on the card gives, byte for byte.
6. ``profile``    — where the main path's time goes: a measured search
                    under torch.profiler; per kernel, the host cost of a
                    wrapper call at the search shapes and the measured
                    fitness of the default schedule beside the kernel's
                    device time from torch.profiler.
7. ``programs``   — the paper's own loop on IR programs at full width:
                    2fcNet training (784-128-10, batch 32, 200 SGD steps)
                    and MobileNet prediction at alpha 1.0 (MobileNetV1's
                    widths, batch 64 on 32x32 inputs, pretrained here,
                    2048 images scored).  Each program and 32 seeded
                    mutants of it through the interpreter on the card
                    against the interpreter on the CPU (same verdict,
                    outputs within tolerance, two eager runs on the card
                    and the measured fitness's CUDA graph bit for bit);
                    three measured evaluations of each unmutated program,
                    each beside the device's busy time over the graph's
                    replays (torch.profiler); a measured GEVO search (pop
                    12, 2 generations) on each, whose reserved device
                    memory must stay flat, with its kernel and graph
                    launches per evaluation and the device's idle share;
                    a measured 2fcNet search with the static screen and
                    the surrogate pre-rank, its invalid verdicts held
                    against the card's messages.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
the script exits nonzero.  Without a CUDA device, or outside a checkout of
the repository, it exits nonzero before printing a result.
"""

from __future__ import annotations

import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Tolerances of tests/test_kernels.py (absolute).  In bf16 an output may
# also differ by one rounding step of bf16 (relative 2**-7), since the
# kernel and the plain version sum in different orders before the cast.
ATOL = {"float32": {"flash_attention": 2e-5, "mamba_scan": 1e-4,
                    "rmsnorm": 1e-5},
        "bfloat16": {"flash_attention": 2e-2, "mamba_scan": 5e-2,
                     "rmsnorm": 3e-2}}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
# At full width a causal row p of random q, k, v averages about p values, so
# its output is near sqrt(e / p) (about 0.03 at S = 4096): the flash check
# there is held to a few times the error of a right kernel (1e-3 on the
# card), not to the search-shape tolerance.
FULL_ATOL = {"flash_attention": 4e-3}
# Every block_q x block_k of flash's space at head dim 128 in f32 (the
# search shapes have head dim 64): the hd-128 instantiations, the 1024-thread
# one (block_q 256) among them.
FLASH_HD128 = {"B": 1, "H": 2, "S": 512, "hd": 128}
# The bf16 sweep of flash: the search shape, FLASH_HD128, and S = 384 at
# each head dim (the only sequence length here that block_k 48 and 192
# divide), which is also the small shape of head dim 32.
FLASH_BF16_SHAPES = ({"B": 1, "H": 2, "S": 256, "hd": 64}, FLASH_HD128,
                     {"B": 1, "H": 2, "S": 384, "hd": 32},
                     {"B": 1, "H": 2, "S": 384, "hd": 64},
                     {"B": 1, "H": 2, "S": 384, "hd": 128})

# qwen3-0.6b (configs/qwen3_0_6b.py): d_model 1024, 16 heads of 128 (KV heads
# expanded to 16); falcon-mamba-7b (configs/falcon_mamba_7b.py): d_inner
# 2 * 4096, ssm_state 16.  4096 tokens.
FULL = {"rmsnorm": {"rows": 16384, "d": 1024},
        "flash_attention": {"B": 1, "H": 16, "S": 4096, "hd": 128},
        "mamba_scan": {"Bt": 1, "L": 4096, "D": 8192, "N": 16}}

SOURCES = {k: f"src/repro_torch/csrc/{k}.cu"
           for k in ("rmsnorm", "flash_attention", "mamba_scan")}
REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:17",
            "flash_attention":
                "src/repro/kernels/flash_attention/flash_attention.py:25",
            "mamba_scan": "src/repro/kernels/mamba_scan/mamba_scan.py:28"}


def emit(doc: dict) -> None:
    print(json.dumps(doc), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def device_rates() -> dict:
    """The rates ``bound_ms`` divides by, from the port's one record of the
    card: HBM bytes/s and f32 FLOP/s of ``kernels.costs.H100``, bf16
    tensor-core FLOP/s of ``core.fitness.PEAK_FLOPS``."""
    from repro_torch.core.fitness import PEAK_FLOPS
    from repro_torch.kernels.costs import H100
    return {"record": H100.name, "bw": H100.hbm_bw, "bf16": PEAK_FLOPS,
            "f32": H100.peak_flops}


def time_ms(torch, fn, *, reps: int, flush=None) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after two warm-up
    calls; ``flush`` (a large tensor) is zeroed before each timed call so
    the 50 MB L2 cache starts cold, as for a caller that has just moved
    other data."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(torch, name, what, got, want, dtype_name,
                atol=None) -> float:
    torch.cuda.synchronize()
    atol = ATOL[dtype_name][name] if atol is None else atol
    rtol = RTOL[dtype_name]
    err = max_err(torch, got, want)
    excess = float(((got.float() - want.float()).abs()
                    - rtol * want.float().abs()).max())
    if not excess <= atol:
        raise AssertionError(f"{name} ({what}, {dtype_name}): max |diff| "
                             f"{err:.3e} beyond atol {atol} + rtol {rtol}")
    return err


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{name}"
    if Path(default).exists():
        return default
    raise RuntimeError(f"{name} not found")


def _demangle(names: list) -> list:
    """Readable kernel names (``flash_bf16_kernel<128, 128, 2>``) where
    ``c++filt`` is at hand, else the mangled ones."""
    if not names or shutil.which("c++filt") is None:
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.split("\n")
    short = []
    for raw, name in zip(names, out):
        m = re.search(r"::(\w+(?:<[^()]*>)?)\(", name)
        short.append(m.group(1) if m else raw)
    return short


def ptxas_report(log_text: str) -> list:
    """Registers and spill bytes of every kernel instantiation, from the
    ``ptxas -v`` report that the build keeps beside a library, and whether
    ptxas serialized its wgmma instructions (warning C7518)."""
    rows, current = [], None
    serialized = set(re.findall(
        r"wgmma\.mma_async instructions are serialized.*?function '(\w+)'",
        log_text))
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            current = {"kernel": m.group(1), "registers": None,
                       "spill_stores": 0, "spill_loads": 0,
                       "wgmma_serialized": m.group(1) in serialized}
            rows.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            current["registers"] = int(m.group(1))
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def phase_device(torch, build) -> dict:
    t0 = time.perf_counter()
    per_source = build.build()
    total = time.perf_counter() - t0
    spills, ptxas = {}, {}
    for name in build.SOURCES:
        log = build.library_path(name).with_suffix(".log")
        ptxas[name] = ptxas_report(log.read_text() if log.exists() else "")
        spills[name] = sum(1 for r in ptxas[name] if r["spill_stores"])
    sass = subprocess.run(
        [_tool("cuobjdump"), "-sass",
         str(build.library_path("flash_attention"))],
        check=True, capture_output=True, text=True, timeout=300).stdout
    hgmma = len(re.findall(r"\bHGMMA\.", sass))
    if hgmma == 0:
        raise AssertionError("flash_attention: no HGMMA instruction in the "
                             "built library")
    sass = subprocess.run(
        [_tool("cuobjdump"), "-sass", str(build.library_path("mamba_scan"))],
        check=True, capture_output=True, text=True, timeout=300).stdout
    ex2 = len(re.findall(r"\bMUFU\.EX2\b", sass))
    if ex2 == 0:
        raise AssertionError("mamba_scan: no MUFU.EX2 instruction in the "
                             "built library")
    doc = {"phase": "device", "gpu": nvidia_smi(),
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "build_s": {k: round(v, 2) for k, v in per_source.items()},
           "build_total_s": round(total, 2),
           "flash_hgmma_instructions": hgmma,
           "scan_mufu_ex2_instructions": ex2,
           "ptxas_spill_reports": spills, "ptxas": ptxas}
    emit(doc)
    return doc


def run_kernel(kernel, knobs, inputs, *, plain: bool):
    """The kernel (or its plain version) under ``knobs`` on ``inputs``."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_plain
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_plain
    i = inputs
    if kernel == "rmsnorm":
        scale = i["scale"]
        if knobs.get("epilogue") == "unfused":
            scale = scale.new_ones(scale.shape)
        br = min(knobs["block_rows"], i["x"].shape[0])
        y = (rmsnorm_plain(i["x"], scale, eps=1e-6, block_rows=br) if plain
             else rmsnorm(i["x"], scale, block_rows=br))
        return y * i["scale"] if knobs.get("epilogue") == "unfused" else y
    if kernel == "flash_attention":
        q = i["q"]
        bq, bk = min(knobs["block_q"], q.shape[2]), min(knobs["block_k"],
                                                        q.shape[2])
        if plain:
            return flash_attention_plain(q, i["k"], i["v"], causal=True,
                                         scale=q.shape[-1] ** -0.5,
                                         block_q=bq, block_k=bk)
        return flash_attention(q, i["k"], i["v"], causal=True, block_q=bq,
                               block_k=bk)
    args = (i["dt"], i["x"], i["A"], i["B"], i["C"])
    ch = min(knobs["chunk"], i["x"].shape[1])
    return mamba_scan_plain(*args, chunk=ch) if plain else \
        mamba_scan(*args, chunk=ch)


def run_ref(kernel, inputs):
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    i = inputs
    if kernel == "rmsnorm":
        return rmsnorm_ref(i["x"], i["scale"])
    if kernel == "flash_attention":
        return attention_ref(i["q"], i["k"], i["v"], causal=True)
    return mamba_scan_ref(i["dt"], i["x"], i["A"], i["B"], i["C"])


def to_dtype(torch, kernel, inputs, dtype):
    """Inputs in ``dtype``; the scan's A and rmsnorm's scale stay f32."""
    keep = {"A", "scale"}
    return {k: v if k in keep else v.to(dtype).contiguous()
            for k, v in inputs.items()}


def all_genomes(space):
    names = space.names()
    for values in itertools.product(*(space.choices(n) for n in names)):
        yield dict(zip(names, values))


def phase_search_shapes(torch, wl) -> dict:
    dev = torch.device("cuda")
    out = {}
    for kernel in wl.KERNELS:
        space = wl.kernel_space(kernel)
        base = wl.inputs_from_numpy(kernel, wl.numpy_inputs(kernel, 0), dev)
        genomes = [g for g in all_genomes(space) if g["impl"] == "pallas"]
        worst = {"plain": 0.0, "ref": 0.0}
        for g in genomes:
            got = run_kernel(kernel, g, base, plain=False)
            worst["plain"] = max(worst["plain"], check_close(
                torch, kernel, f"{g} vs plain", got,
                run_kernel(kernel, g, base, plain=True), "float32"))
            worst["ref"] = max(worst["ref"], check_close(
                torch, kernel, f"{g} vs ref", got, run_ref(kernel, base),
                "float32"))
        bf = to_dtype(torch, kernel, base, torch.bfloat16)
        g = wl.BASELINES[kernel]
        got = run_kernel(kernel, g, bf, plain=False)
        bf_err = {
            "plain": check_close(torch, kernel, "default vs plain", got,
                                 run_kernel(kernel, g, bf, plain=True),
                                 "bfloat16"),
            "ref": check_close(torch, kernel, "default vs ref", got,
                               run_ref(kernel, bf), "bfloat16")}
        out[kernel] = {"genomes_f32": len(genomes), "max_err_f32": worst,
                       "max_err_bf16_default": bf_err}
    out["flash_attention_hd128"] = flash_hd128(torch, wl)
    out["flash_attention_bf16"] = [flash_bf16_sweep(torch, wl, s)
                                   for s in FLASH_BF16_SHAPES]
    out["rmsnorm_block_rows_bit_identical"] = rmsnorm_bit_identity(torch, wl)
    out["mamba_scan_chunk_bit_identical"] = scan_bit_identity(torch, wl)
    emit({"phase": "search_shapes", "tolerances": {"atol": ATOL,
                                                   "rtol": RTOL},
          "kernels": out})
    return out


def flash_hd128(torch, wl) -> dict:
    """Flash attention at head dim 128, f32, over every block_q x block_k
    of its space that fits a block's shared memory, against the plain
    version."""
    from repro_torch.kernels.costs import H100
    from repro_torch.kernels.flash_attention.flash_attention import \
        smem_bytes
    s = FLASH_HD128
    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (s["B"], s["H"], s["S"], s["hd"])
    inputs = {n: torch.randn(shape, generator=gen, device="cuda")
              for n in ("q", "k", "v")}
    space = wl.kernel_space("flash_attention")
    checked, over, worst = 0, [], 0.0
    for bq, bk in itertools.product(space.choices("block_q"),
                                    space.choices("block_k")):
        knobs = {"block_q": bq, "block_k": bk}
        if smem_bytes(knobs, s, torch.float32) > H100.smem_per_block:
            over.append(knobs)
            continue
        got = run_kernel("flash_attention", knobs, inputs, plain=False)
        worst = max(worst, check_close(
            torch, "flash_attention", f"hd128 {knobs} vs plain", got,
            run_kernel("flash_attention", knobs, inputs, plain=True),
            "float32"))
        checked += 1
    return {"shape": s, "genomes_f32": checked, "max_err_f32": worst,
            "over_shared_memory": over}


def flash_bf16_sweep(torch, wl, s) -> dict:
    """Flash attention in bf16 at shape ``s``, causal, over every block_q x
    block_k of the joint space that divides S and that the bf16 shared
    memory admits: each genome against its plain version, and the outputs
    of one block_k bit-identical across block_q."""
    from repro_torch.kernels.costs import H100
    from repro_torch.kernels.flash_attention.flash_attention import \
        smem_bytes
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (s["B"], s["H"], s["S"], s["hd"])
    inputs = {n: torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for n in ("q", "k", "v")}
    space = wl.joint_space()
    fits = [c for c in space.choices("flash_attention.block_q")
            if s["S"] % c == 0]
    checked, worst, identical = 0, 0.0, {}
    for bk in space.choices("flash_attention.block_k"):
        if s["S"] % bk:
            continue
        first = None
        for bq in fits:
            knobs = {"block_q": bq, "block_k": bk}
            if smem_bytes(knobs, s, torch.bfloat16) > H100.smem_per_block:
                continue
            got = run_kernel("flash_attention", knobs, inputs, plain=False)
            worst = max(worst, check_close(
                torch, "flash_attention", f"bf16 {s} {knobs} vs plain", got,
                run_kernel("flash_attention", knobs, inputs, plain=True),
                "bfloat16"))
            checked += 1
            if first is None:
                first = got
            elif not torch.equal(first, got):
                raise AssertionError(f"flash_attention bf16 {s}: block_q "
                                     f"{bq} changes the output at block_k "
                                     f"{bk}")
        identical[bk] = first is not None
    return {"shape": s, "genomes_bf16": checked, "max_err_bf16": worst,
            "bit_identical_across_block_q": identical}


def rmsnorm_bit_identity(torch, wl) -> dict:
    """rmsnorm's output at every block_rows of the joint space that divides
    the rows, at the search shape and at full width, in f32 and bf16: one
    output, bit for bit."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    choices = wl.joint_space().choices("rmsnorm.block_rows")
    for s in (wl.SHAPES["rmsnorm"], FULL["rmsnorm"]):
        x = torch.randn((s["rows"], s["d"]), generator=gen, device="cuda")
        scale = torch.randn(s["d"], generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            xs = x.to(dtype)
            brs = [b for b in choices if s["rows"] % b == 0]
            outs = [run_kernel("rmsnorm", {"block_rows": b},
                               {"x": xs, "scale": scale}, plain=False)
                    for b in brs]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise AssertionError(f"rmsnorm {s} {dtype}: block_rows "
                                     "changes the output")
            out[f"{s['rows']}x{s['d']} {str(dtype)[6:]}"] = brs
    return out


def scan_bit_identity(torch, wl) -> dict:
    """The scan's output at every chunk of the joint space that divides L,
    at the search shape and at Bt 2, L 384, D 40 (where chunk 12 and 48
    divide, and D is not a multiple of a block's channels), in f32 and
    bf16: one output, bit for bit."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    choices = wl.joint_space().choices("mamba_scan.chunk")
    for s in (wl.SHAPES["mamba_scan"], {"Bt": 2, "L": 384, "D": 40, "N": 16}):
        seq = (s["Bt"], s["L"], s["D"])
        base = {"dt": torch.nn.functional.softplus(
                    torch.randn(seq, generator=gen, device="cuda")),
                "x": torch.randn(seq, generator=gen, device="cuda"),
                "A": -torch.exp(0.3 * torch.randn((s["D"], s["N"]),
                                                  generator=gen,
                                                  device="cuda")),
                "B": torch.randn((s["Bt"], s["L"], s["N"]), generator=gen,
                                 device="cuda"),
                "C": torch.randn((s["Bt"], s["L"], s["N"]), generator=gen,
                                 device="cuda")}
        for dtype in (torch.float32, torch.bfloat16):
            inputs = to_dtype(torch, "mamba_scan", base, dtype)
            chunks = [c for c in choices if s["L"] % c == 0]
            outs = [run_kernel("mamba_scan", {"chunk": c}, inputs,
                               plain=False) for c in chunks]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise AssertionError(f"mamba_scan {s} {dtype}: chunk changes "
                                     "the output")
            out[f"{s['Bt']}x{s['L']}x{s['D']}x{s['N']} {str(dtype)[6:]}"] = \
                chunks
    return out


def full_inputs(torch, kernel, gen):
    dev = torch.device("cuda")
    s = FULL[kernel]
    bf = torch.bfloat16

    def normal(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    if kernel == "rmsnorm":
        return {"x": normal(s["rows"], s["d"]),
                "scale": normal(s["d"], dtype=torch.float32)}
    if kernel == "flash_attention":
        shape = (s["B"], s["H"], s["S"], s["hd"])
        return {"q": normal(*shape), "k": normal(*shape),
                "v": normal(*shape)}
    seq = (s["Bt"], s["L"], s["D"])
    return {"dt": torch.nn.functional.softplus(
                torch.randn(seq, generator=gen, device=dev)).to(bf),
            "x": normal(*seq),
            "A": -torch.exp(torch.randn((s["D"], s["N"]), generator=gen,
                                        device=dev) * 0.3),
            "B": normal(s["Bt"], s["L"], s["N"]),
            "C": normal(s["Bt"], s["L"], s["N"])}


def bound(kernel, rates) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, operations) of one call at full width in
    bf16: each input read once, each output written once; operations of
    the data this run needs (the causal half of attention)."""
    s = FULL[kernel]
    if kernel == "rmsnorm":
        n = s["rows"] * s["d"]
        nbytes = 2 * n * 2 + s["d"] * 4
        ops, rate = 4 * n, rates["f32"]
    elif kernel == "flash_attention":
        B, H, S, hd = s["B"], s["H"], s["S"], s["hd"]
        nbytes = 4 * B * H * S * hd * 2
        ops, rate = 4 * hd * B * H * (S * (S + 1) // 2), rates["bf16"]
    else:
        Bt, L, D, N = s["Bt"], s["L"], s["D"], s["N"]
        nbytes = 3 * Bt * L * D * 2 + D * N * 4 + 2 * Bt * L * N * 2
        ops, rate = 6 * Bt * L * D * N, rates["f32"]
    t_bytes, t_ops = nbytes / rates["bw"], ops / rate
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, ops


def exp_floor(torch) -> dict:
    """The least time of the scan's exponentials at full width: one for
    each of Bt L D N elements, on the special-function units at 16 a clock
    an SM, on every SM, at the card's maximum SM clock."""
    s = FULL["mamba_scan"]
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])  # "1980 MHz"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = s["Bt"] * s["L"] * s["D"] * s["N"]
    return {"exp_floor_ms": n / (16 * sms * mhz * 1e6) * 1e3,
            "exponentials": n, "sms": sms, "sm_clock_max_mhz": mhz}


def profiler_ms(torch, fn, name: str, *, reps: int, flush=None) -> float:
    """Median device time in ms of the kernels whose name holds ``name``,
    one a call of ``fn``, from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
    if len(spans) != reps:
        raise AssertionError(f"profiler: {len(spans)} device spans of "
                             f"{name!r} for {reps} calls")
    return statistics.median(spans) / 1e3


def library_call(torch, kernel, inputs):
    F = torch.nn.functional
    i = inputs
    if kernel == "rmsnorm":
        w = i["scale"].to(i["x"].dtype)
        return lambda: F.rms_norm(i["x"], (i["x"].shape[-1],), w, 1e-6)
    if kernel == "flash_attention":
        return lambda: F.scaled_dot_product_attention(i["q"], i["k"], i["v"],
                                                      is_causal=True)
    return None


def phase_full_width(torch, wl) -> dict:
    rates = device_rates()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for kernel in wl.KERNELS:
        inputs = full_inputs(torch, kernel, gen)
        knobs = wl.BASELINES[kernel]
        got = run_kernel(kernel, knobs, inputs, plain=False)
        want = run_kernel(kernel, knobs, inputs, plain=True)
        err = check_close(torch, kernel, "full width vs plain", got, want,
                          "bfloat16", atol=FULL_ATOL.get(kernel))
        finite = bool(torch.isfinite(got.float()).all())
        if not finite or got.shape != want.shape:
            raise AssertionError(f"{kernel}: output not finite or of shape "
                                 f"{tuple(got.shape)}")
        del got, want
        ms = time_ms(torch, lambda: run_kernel(kernel, knobs, inputs,
                                               plain=False),
                     reps=20, flush=flush)
        plain_ms = time_ms(torch, lambda: run_kernel(kernel, knobs, inputs,
                                                     plain=True),
                           reps=3, flush=flush)
        lib = library_call(torch, kernel, inputs)
        library_ms = (time_ms(torch, lib, reps=20, flush=flush)
                      if lib is not None else None)
        bound_ms, bound_by, nbytes, ops = bound(kernel, rates)
        out[kernel] = {"shape": FULL[kernel], "dtype": "bfloat16",
                       "schedule": knobs, "max_abs_err": err,
                       "kernel_ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "bytes": nbytes,
                       "operations": ops}
        if kernel == "mamba_scan":
            out[kernel].update(exp_floor(torch))
            out[kernel]["profiler_ms"] = profiler_ms(
                torch, lambda: run_kernel(kernel, knobs, inputs, plain=False),
                "scan_kernel", reps=20, flush=flush)
        del inputs
        torch.cuda.empty_cache()
    emit({"phase": "full_width", "rates": rates,
          "atol": {k: FULL_ATOL.get(k, ATOL["bfloat16"][k])
                   for k in wl.KERNELS}, "kernels": out})
    return out


def phase_overheads(torch) -> dict:
    """The two overheads of the cost model's device record, measured with
    the kernels themselves: what one more block costs at equal work
    (rmsnorm, 65536 rows of 32 f32, 1 vs 256 rows a block), and what one
    more step of the sequential scan costs (one block of 8 channels,
    L = 4096 vs 256)."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((65536, 32), generator=gen, device="cuda")
    scale = torch.randn(32, generator=gen, device="cuda")
    t_many = time_ms(torch, lambda: rmsnorm(x, scale, block_rows=1), reps=50)
    t_few = time_ms(torch, lambda: rmsnorm(x, scale, block_rows=256),
                    reps=50)
    grid_step_s = (t_many - t_few) * 1e-3 / (65536 - 256)

    def scan_ms(L):
        D, N = 8, 16
        dt = torch.rand((1, L, D), generator=gen, device="cuda")
        xs = torch.randn((1, L, D), generator=gen, device="cuda")
        A = -torch.rand((D, N), generator=gen, device="cuda")
        B = torch.randn((1, L, N), generator=gen, device="cuda")
        C = torch.randn((1, L, N), generator=gen, device="cuda")
        return time_ms(torch, lambda: mamba_scan(dt, xs, A, B, C, chunk=64),
                       reps=20)

    t_short, t_long = scan_ms(256), scan_ms(4096)
    seq_step_s = (t_long - t_short) * 1e-3 / (4096 - 256)
    doc = {"phase": "overheads", "gpu": nvidia_smi(),
           "rmsnorm_65536_blocks_ms": t_many, "rmsnorm_256_blocks_ms": t_few,
           "grid_step_s": grid_step_s, "scan_L256_ms": t_short,
           "scan_L4096_ms": t_long, "seq_step_s": seq_step_s}
    emit(doc)
    return doc


def phase_search(torch, wl, counters) -> dict:
    """The main path: GEVO's kernel-schedule search on the card, as four
    paths — the measured search of each kernel and the joint static search
    — each counted from zero.  A measured search must launch its own
    kernel; the joint search must launch all three."""

    def reset():
        for c in counters.values():
            c.launches = 0

    def read(path, need):
        got = {k: c.launches for k, c in counters.items()}
        idle = [k for k in need if got[k] <= 0]
        if idle:
            raise AssertionError(f"{path}: kernels never launched: {idle}")
        return got

    fronts, launches = {}, {"measured": {}, "joint_static": {}}
    t0 = time.perf_counter()
    for kernel in wl.KERNELS:
        reset()
        w = wl.build_kernel_workload(kernel, time_mode="measured")
        search, res, best, ok = wl.evolve_kernel_schedule(
            w, generations=2, pop_size=6, seed=0)
        launches["measured"][kernel] = read(f"measured {kernel}",
                                            [kernel])
        search.close()
        fronts[kernel] = {
            "original": list(res.original_fitness),
            "pareto": [{"fitness": list(i.fitness),
                        "schedule": w.space.decode(i.patch.apply(w.program))}
                       for i in res.pareto],
            "best": w.space.decode(best.patch.apply(w.program)),
            "within_tol": ok, "evals": search.n_evals}
    screened = screened_guided_search(
        torch, wl.build_kernel_workload("flash_attention",
                                        time_mode="measured"),
        kernel_screened_search)
    reset()
    wj = wl.build_joint_kernel_workload()
    search, res, best, ok = wl.evolve_kernel_schedule(
        wj, generations=2, pop_size=6, seed=0)
    launches["joint_static"] = read("joint static", wl.KERNELS)
    search.close()
    fronts["joint_static"] = {
        "original": list(res.original_fitness),
        "pareto": [list(i.fitness) for i in res.pareto],
        "evals": search.n_evals}
    emit({"phase": "search", "seconds": time.perf_counter() - t0,
          "launches": launches, "fronts": fronts,
          "screened_guided_flash_attention": screened})
    return launches


# The kernel of each wrapper, by a part of its name in a profile.
KERNEL_NAMES = {"rmsnorm": "rmsnorm_", "flash_attention": "flash_",
                "mamba_scan": "scan_kernel"}


def graph_timing(torch, wl, kernel) -> dict:
    """The measured fitness of ``kernel``'s default schedule at the search
    shapes (its CUDA graph's replays, per call) beside the kernel's device
    time a call that torch.profiler reads over the same evaluation."""
    from torch.profiler import ProfilerActivity, profile
    w = wl.build_kernel_workload(kernel, time_mode="measured")
    w.evaluate(w.program)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        measured_s, _ = w.evaluate(w.program)
        torch.cuda.synchronize()
    spans = [end - start for start, end, name in device_spans(torch, prof)
             if KERNEL_NAMES[kernel] in name]
    kernel_us = statistics.median(spans)
    return {"measured_us_per_call": measured_s * 1e6,
            "profiler_kernel_us_per_call": kernel_us,
            "measured_over_kernel": measured_s * 1e6 / kernel_us,
            "kernel_spans": len(spans)}


def phase_profile(torch, wl) -> dict:
    """Where the main path's time goes: one measured search (flash
    attention, pop 6, 1 generation) under torch.profiler — device time by
    kernel and the device's idle share of the window — and, per kernel at
    its search shape, the host time of one wrapper call in a tight loop
    against the CUDA-event time the measured fitness reads."""
    from torch.profiler import ProfilerActivity, profile
    w = wl.build_kernel_workload("flash_attention", time_mode="measured")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search, *_ = wl.evolve_kernel_schedule(w, generations=1, pop_size=6,
                                               seed=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    search.close()
    spans = device_spans(torch, prof)
    by_name: dict[str, float] = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    busy = busy_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]

    dispatch = {}
    dev = torch.device("cuda")
    for kernel in wl.KERNELS:
        inputs = wl.inputs_from_numpy(kernel, wl.numpy_inputs(kernel, 0),
                                      dev)
        fn = wl._variant_fn(kernel, wl.BASELINES[kernel])
        fn(inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(inputs)
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        event_us = time_ms(torch, lambda: fn(inputs), reps=50) * 1e3
        dispatch[kernel] = {"loop_us_per_call": host_us,
                            "event_us_per_call": event_us,
                            **graph_timing(torch, wl, kernel)}
    doc = {"phase": "profile", "window_us": wall_us,
           "device_events": len(spans),
           "device_busy_us": busy if spans else None,
           "device_idle_share": (1 - busy / wall_us) if spans else None,
           "device_us_by_kernel": dict(top), "dispatch": dispatch}
    emit(doc)
    return doc


# The programs phase: f32 dot and conv chains on the card against the CPU,
# |card - cpu| <= PROGRAM_RTOL |cpu| + PROGRAM_ATOL max(1, max |cpu|) per
# output (NaN and inf where the CPU has them).
PROGRAM_RTOL, PROGRAM_ATOL = 1e-4, 1e-5
MUTANTS = 32
# Reserved device memory may differ between generations of a measured
# search by one segment of torch's caching allocator (2 MiB) at most.
RESERVED_SLACK = 2 * 2 ** 20
# The unmutated program's measured time over three evaluations: the
# spread (max / min - 1) the acceptance asks for.
REPEAT_SPREAD = 0.05


def bits(torch, t):
    """``t``'s bits, so NaNs compare equal to themselves."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(view[t.dtype]) if t.dtype in view else t


def seeded_mutants(program, n: int, seed: int = 0) -> list:
    """``n`` patches of 1 to 3 edits each, sampled with the port's edit
    registry over every universal operator, from one seed."""
    import numpy as np
    from repro_torch.core.edits import (EditError, OperatorWeights, Patch,
                                        sample_edit)
    rng = np.random.default_rng(seed)
    weights = OperatorWeights.parse("all")
    patches = []
    while len(patches) < n:
        patch = Patch()
        for _ in range(int(rng.integers(1, 4))):
            try:
                nxt = patch.append(sample_edit(patch.apply(program), rng,
                                               weights))
                nxt.apply(program)
            except EditError:
                continue
            patch = nxt
        if len(patch):
            patches.append(patch)
    return patches


def sampled_patches(program, n: int, seed: int) -> list:
    """``n`` patches of 1 to 3 edits each sampled on ``program`` itself
    (as the reference's property tests draw them), kept whether or not the
    edits compose: one that does not is an invalid variant."""
    import numpy as np
    from repro_torch.core.edits import (EditError, OperatorWeights, Patch,
                                        sample_edit)
    rng = np.random.default_rng(seed)
    weights = OperatorWeights.parse("all")
    patches = []
    while len(patches) < n:
        try:
            patches.append(Patch(tuple(
                sample_edit(program, rng, weights)
                for _ in range(int(rng.integers(1, 4))))))
        except EditError:
            continue
    return patches


def run_program(torch, program, inputs, device, graph: bool = False):
    """(outputs, None) or (None, error) of one program on ``device``:
    eagerly, or with ``graph`` through the measured fitness's CUDA graph
    (two replays, the second returned)."""
    from repro_torch.core.fitness import DEVICE_FAULTS
    from repro_torch.core.interp import ProgramGraph, jit_program
    try:
        if graph:
            with ProgramGraph(program, device) as g:
                g.load(inputs)
                g.run()
                outs = [o.clone() for o in g.run()]
        else:
            outs = jit_program(program, device)(inputs)
        if device != "cpu":
            torch.cuda.synchronize()
        return outs, None
    except DEVICE_FAULTS:
        raise
    except Exception as e:  # the variant fails, as the reference counts it
        return None, f"{type(e).__name__}: {e}"


def cross_check(torch, name, program, inputs, patches) -> dict:
    """The program and each mutant on the card (twice eagerly, once as the
    measured fitness's CUDA graph) and on the CPU: the same verdict,
    outputs within the tolerance, the card's two eager runs and the graph's
    replay bit for bit.  ``max_share_of_tolerance`` is the largest
    |card - cpu| / (rtol |cpu| + atol max(1, max |cpu|)) seen: at most 1."""
    worst_abs, worst_share, invalid, repeats = 0.0, 0.0, 0, 0
    for patch in [None] + list(patches):
        prog = program if patch is None else patch.apply(program)
        what = f"{name} {'original' if patch is None else patch.describe()}"
        cpu, cpu_err = run_program(torch, prog, inputs, "cpu")
        gpu, gpu_err = run_program(torch, prog, inputs, "cuda")
        again, _ = run_program(torch, prog, inputs, "cuda")
        replay, replay_err = run_program(torch, prog, inputs, "cuda",
                                         graph=True)
        if (cpu is None) != (gpu is None):
            raise AssertionError(f"{what}: the CPU says {cpu_err}, the card "
                                 f"says {gpu_err}")
        if gpu_err != replay_err:
            raise AssertionError(f"{what}: eagerly the card says {gpu_err}, "
                                 f"through the graph {replay_err}")
        if cpu is None:
            invalid += 1
            continue
        for c, g, g2, r in zip(cpu, gpu, again, replay, strict=True):
            if c.dtype != g.dtype or c.shape != g.shape:
                raise AssertionError(f"{what}: {g.dtype} {tuple(g.shape)} on "
                                     f"the card, {c.dtype} {tuple(c.shape)} "
                                     "on the CPU")
            if not torch.equal(bits(torch, g), bits(torch, g2)):
                raise AssertionError(f"{what}: two runs on the card differ")
            if r.dtype != g.dtype or not torch.equal(bits(torch, g),
                                                     bits(torch, r)):
                raise AssertionError(f"{what}: the graph's replay differs "
                                     "from the eager run on the card")
            gc, cf = g.cpu().to(torch.float64), c.to(torch.float64)
            if not (torch.equal(torch.isnan(gc), torch.isnan(cf))
                    and torch.equal(torch.isinf(gc), torch.isinf(cf))):
                raise AssertionError(f"{what}: NaN or inf where the CPU "
                                     "has none")
            ok = torch.isfinite(cf)
            if not bool(ok.any()):
                continue
            scale = max(1.0, float(cf[ok].abs().max()))
            diff = (gc[ok] - cf[ok]).abs()
            share = float((diff / (PROGRAM_RTOL * cf[ok].abs()
                                   + PROGRAM_ATOL * scale)).max())
            if share > 1.0:
                raise AssertionError(f"{what}: card and CPU disagree (max "
                                     f"|diff| {float(diff.max()):.3e})")
            worst_abs = max(worst_abs, float(diff.max()))
            worst_share = max(worst_share, share)
        repeats += 1
    return {"programs": len(patches) + 1, "invalid_on_both": invalid,
            "max_abs_err": worst_abs, "max_share_of_tolerance": worst_share,
            "bit_identical_repeats": repeats,
            "graph_replays_bit_identical_to_eager": repeats}


def device_spans(torch, prof) -> list:
    """(start, end, name) of every device event of a profile, in order,
    but for the spin ``measured_time`` holds the stream with while the host
    enqueues the timed calls (``torch.cuda._sleep``'s ``spin_kernel``)."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name)


def busy_us(spans) -> float:
    """Microseconds in which at least one of ``spans`` ran."""
    total, cur = 0.0, None
    for start, end, *_ in spans:
        if cur is None or start > cur[1]:
            total += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return total + (0.0 if cur is None else cur[1] - cur[0])


def graph_launches(prof) -> int:
    return sum(1 for e in prof.events() if e.name == "cudaGraphLaunch")


def profile_evaluation(torch, w) -> dict:
    """One measured evaluation of ``w``'s program under torch.profiler:
    the kernels it ran on the device, the graph launches that ran most of
    them, the device's busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        measured_s, _ = w.evaluate(w.program)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(torch, prof)
    copies = sum(1 for _, _, n in spans if n.startswith(("Memcpy", "Memset")))
    if not spans:
        raise AssertionError(f"{w.name}: the profiler saw no device work")
    busy = busy_us(spans)
    return {"kernel_launches": len(spans) - copies, "copies": copies,
            "graph_launches": graph_launches(prof), "measured_s": measured_s,
            "window_us": wall_us, "device_busy_us": busy,
            "device_idle_share": 1 - busy / wall_us}


def replay_profile(torch, w, inputs, per_eval: int) -> dict:
    """The measured fitness's timing of ``w``'s program, repeated outside
    the workload: the program's graph on ``inputs``, timed by
    ``measured_time`` as an evaluation times it, under torch.profiler.
    Beside the measured time a replay, the device's busy time a replay over
    the same replays; both also scaled by the replays an evaluation counts
    (``per_eval``: steps or batches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fitness import measured_time
    from repro_torch.core.interp import ProgramGraph
    with ProgramGraph(w.program, "cuda") as g:
        g.load(inputs)
        g.run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            per_replay = measured_time(g.run, "cuda")
            torch.cuda.synchronize()
    replays = graph_launches(prof)
    busy = busy_us(device_spans(torch, prof)) * 1e-6 / replays
    return {"replays": replays, "measured_s_per_replay": per_replay,
            "device_busy_s_per_replay": busy,
            "measured_s": per_replay * per_eval,
            "device_busy_s": busy * per_eval,
            "measured_over_busy": per_replay / busy}


def measured_search(torch, w) -> dict:
    """GevoML on ``w`` (pop 12, 2 generations, measured time) through
    ``make_evaluator``: wall time, evaluations per second, the front, and
    the device memory torch holds reserved after each generation, which
    must not grow with the variants evaluated (each variant's graph and
    its memory pool are released after its evaluation)."""
    from repro_torch.core.evaluator import make_evaluator
    from repro_torch.core.search import GevoML
    evaluator = make_evaluator(w)
    reserved = [torch.cuda.memory_reserved()]

    def on_generation(gen, row):
        reserved.append(torch.cuda.memory_reserved())

    t0 = time.perf_counter()
    try:
        search = GevoML(w, pop_size=12, n_elite=6, seed=0, operators="all",
                        evaluator=evaluator)
        res = search.run(generations=2, on_generation=on_generation)
    finally:
        evaluator.close()
    wall = time.perf_counter() - t0
    if max(reserved[1:]) > reserved[1] + RESERVED_SLACK:
        raise AssertionError(f"{w.name}: reserved device memory grew over "
                             f"the search: {reserved}")
    return {"wall_s": wall, "evaluations": search.n_evals,
            "evaluations_per_s": search.n_evals / wall,
            "invalid": search.n_invalid,
            "reserved_bytes_by_generation": reserved,
            "original": list(res.original_fitness),
            "pareto": [{"fitness": list(i.fitness),
                        "patch": i.patch.describe()} for i in res.pareto]}


def recording_invalid(screen) -> list:
    """Make ``screen`` record each patch it calls invalid, with its
    message; returns the list it appends ``(patch, message)`` to."""
    seen = []
    classify = screen.classify

    def recorded(patch):
        res = classify(patch)
        if res.label == "invalid":
            seen.append((patch, res.outcome.error))
        return res

    screen.classify = recorded
    return seen


def check_invalid_messages(w, verdicts) -> int:
    """Execute each statically invalid patch on the card: it must fail
    with the screen's message, byte for byte."""
    from repro_torch.core.edits import EditError
    from repro_torch.core.fitness import InvalidVariant
    for patch, message in verdicts:
        try:
            w.evaluate(patch.apply(w.program))
            got = None
        except (EditError, InvalidVariant) as e:
            got = str(e)
        if got != message:
            raise AssertionError(f"{w.name} {patch.describe()}: the screen "
                                 f"says {message!r}, the card {got!r}")
    return len(verdicts)


def screened_guided_search(torch, w, search_fn) -> dict:
    """A measured search with the static screen and the surrogate pre-rank
    (``search_fn(w)`` runs it and returns the search), then every
    statically invalid verdict it handed out, and those of 64 sampled
    patches, held against the message executing the patch on the card
    gives."""
    from repro_torch.core.analysis import make_screen
    t0 = time.perf_counter()
    holder = {}
    search = search_fn(w, holder)
    wall = time.perf_counter() - t0
    ev = search.evaluator
    verdicts = holder["invalid"]
    sampled = make_screen(w)
    extra = recording_invalid(sampled)
    for patch in sampled_patches(w.program, 2 * MUTANTS, seed=2):
        sampled.classify(patch)
    checked = check_invalid_messages(w, verdicts + extra)
    out = {"wall_s": wall, "evaluations": ev.n_evals,
           "evaluations_per_s": ev.n_evals / wall,
           "n_screened": ev.n_screened,
           "screened_by": dict(ev.screened_by),
           "surrogate": search.guide.stats(),
           "invalid_verdicts_in_search": len(verdicts),
           "invalid_verdicts_sampled": len(extra),
           "invalid_messages_equal_on_the_card": checked}
    search.close()
    return out


def kernel_screened_search(w, holder):
    from repro_torch.core.evaluator import make_evaluator
    from repro_torch.kernels.workloads import evolve_kernel_schedule
    ev = make_evaluator(w, screen=True)
    holder["invalid"] = recording_invalid(ev.screen)
    search, *_ = evolve_kernel_schedule(w, generations=4, pop_size=8,
                                        seed=2, evaluator=ev, surrogate=True)
    return search


def ir_screened_search(w, holder):
    from repro_torch.core.search import GevoML
    search = GevoML(w, pop_size=12, n_elite=6, seed=1, operators="all",
                    screen=True, surrogate=True)
    holder["invalid"] = recording_invalid(search.evaluator.screen)
    search.run(generations=3)
    return search


def phase_programs(torch) -> dict:
    """The paper's loop on IR programs at full width (see the module
    docstring): 2fcNet training at the builder's defaults, MobileNet
    prediction at alpha 1.0."""
    import numpy as np
    from repro_torch.core.fitness import static_time
    from repro_torch.workloads.mobilenet import \
        build_mobilenet_prediction_workload
    from repro_torch.workloads.twofc import build_twofc_training_workload
    t0 = time.perf_counter()
    twofc = build_twofc_training_workload(time_mode="measured")
    t1 = time.perf_counter()
    mobilenet = build_mobilenet_prediction_workload(
        alpha=1.0, batch=64, n_eval=2048, n_pretrain=6000, pretrain_epochs=3,
        time_mode="measured")
    t2 = time.perf_counter()
    eye = np.eye(twofc.num_classes, dtype=np.float32)
    inputs = {"twofc": {**twofc.init_weights, "x": twofc.train_x[:32],
                        "y_onehot": eye[twofc.train_y[:32]]},
              "mobilenet": {"images": mobilenet.images[:mobilenet.batch]}}
    out = {"phase": "programs", "gpu": nvidia_smi(),
           "build_s": {"twofc": t1 - t0,
                       "mobilenet_with_pretraining": t2 - t1},
           "tolerance": {"rtol": PROGRAM_RTOL, "atol_of_max": PROGRAM_ATOL}}
    for name, w in (("twofc", twofc), ("mobilenet", mobilenet)):
        ops = len(w.program.ops)
        cc = cross_check(torch, name, w.program, inputs[name],
                         seeded_mutants(w.program, MUTANTS))
        emit({"phase": "programs", "step": "card_vs_cpu", "workload": name,
              "ops": ops, **cc})
        per_eval = w.steps if name == "twofc" else len(w.images) // w.batch
        repeats = []
        for _ in range(3):
            t, e = w.evaluate(w.program)
            if not (np.isfinite(t) and 0.0 <= e < 0.9):
                raise AssertionError(f"{name}: unmutated fitness ({t}, {e})")
            repeats.append({"measured_s": t, "error": e,
                            **replay_profile(torch, w, inputs[name],
                                             per_eval)})
        times = [r["measured_s"] for r in repeats]
        unmutated = {"measured_s": times, "error": e,
                     "spread": max(times) / min(times) - 1,
                     "within_spread": max(times) / min(times) - 1
                     <= REPEAT_SPREAD,
                     "static_s": static_time(w.program) * per_eval,
                     "replays_profiled": repeats}
        search = measured_search(torch, w)
        prof = profile_evaluation(torch, w)
        emit({"phase": "programs", "step": "search", "workload": name,
              "gpu": out["gpu"], "unmutated": unmutated, **search,
              "profiled_evaluation": prof})
        screened = (screened_guided_search(torch, w, ir_screened_search)
                    if name == "twofc" else None)
        if screened is not None:
            emit({"phase": "programs", "step": "screened_guided_search",
                  "workload": name, **screened})
        out[name] = {"ops": ops, "programs_checked": cc["programs"],
                     "max_abs_err": cc["max_abs_err"],
                     "unmutated_measured_s": times,
                     "unmutated_device_busy_s": [r["device_busy_s"]
                                                 for r in repeats],
                     "search_wall_s": search["wall_s"],
                     "evaluations_per_s": search["evaluations_per_s"],
                     "kernel_launches_per_evaluation":
                         prof["kernel_launches"],
                     "graph_launches_per_evaluation":
                         prof["graph_launches"],
                     "device_idle_share": prof["device_idle_share"]}
    emit(out)
    return out


def main() -> int:
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels import workloads as wl
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    phase_device(torch, build)
    phase_search_shapes(torch, wl)
    full = phase_full_width(torch, wl)
    phase_overheads(torch)
    counters = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "mamba_scan": mamba_scan}
    launches = phase_search(torch, wl, counters)
    phase_profile(torch, wl)
    phase_programs(torch)

    # launches: in the kernel's own measured search; launches_joint_static:
    # in the joint static search
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": launches["measured"][k][k],
         "launches_joint_static": launches["joint_static"][k],
         "max_abs_err": full[k]["max_abs_err"], "ms": full[k]["kernel_ms"],
         "plain_ms": full[k]["plain_ms"], "bound_ms": full[k]["bound_ms"],
         "bound_by": full[k]["bound_by"],
         "library_ms": full[k]["library_ms"],
         **({"profiler_ms": full[k]["profiler_ms"]}
            if "profiler_ms" in full[k] else {})} for k in wl.KERNELS]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
