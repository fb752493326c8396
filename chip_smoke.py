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
                    registers and spills of every kernel instantiation;
                    for the bf16 flash backward's two kernels at each
                    head dim also their HGMMA counts, each above 0, with
                    no spill and no serialized wgmma.
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
                    block_rows, and the scan (output and final state)
                    across chunk, in float32 and bfloat16.
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
                    three measured evaluations of each unmutated program
                    (each the mean over ``PROGRAM_INSTANCES`` program
                    graphs on memory of their own, every instance's time
                    and their spread printed), within 5% of each other,
                    each beside the
                    device's busy time over the graph's
                    replays (torch.profiler); a measured GEVO search (pop
                    12, 2 generations) on each, whose reserved device
                    memory must stay flat, with its kernel and graph
                    launches per evaluation and the device's idle share;
                    a measured 2fcNet search with the static screen and
                    the surrogate pre-rank, its invalid verdicts held
                    against the card's messages.
8. ``islands``    — the island model (``core/islands``): the device memory
                    one more process takes on the card (its CUDA context
                    and a built workload; ``plan()`` reserves
                    ``CONTEXT_RESERVE_BYTES`` a context); 2fcNet in static
                    time, 4 islands x pop 8, 4 generations, with the
                    process backend as ``plan()`` chooses it here, against
                    the same search in-process (manifests, populations and
                    merged fronts bit for bit); a measured flash-attention
                    search on 2 islands that ``plan()`` keeps in one
                    process (no other process beside it, reserved memory
                    flat), with its kernel launches counted from zero.
9. ``tensor``     — the tensorized engine (``core/tensor_evo``) on the
                    joint workload: ``TensorGevoML``, pop 1024, 5
                    generations, counted from zero (every launch comes from
                    filling the error tables, one a launchable error class
                    of the kernel, and the count is asserted); the device
                    step's time and validity bit for bit against the numpy
                    path over one generation's lanes, its errors, ranks and
                    selection order too; every reported fitness against
                    ``SerialEvaluator``; a kill after generation 3 and a
                    resume ending at the unbroken run's population; a
                    4-island x 1024 ``backend="mesh"`` fleet, 4
                    generations, migrating every 2, and its resume; the
                    step's generations and lanes per second and the
                    device's idle share over one generation
                    (torch.profiler), for the engine and the fleet, and
                    where a step's time goes (objectives, ranking with
                    its fronts, selection order); the same search's
                    evaluations per second under ``engine="python"``.
10. ``serve``     — the model stack and the continuous-batching server
                    (``models/``, ``core/deploy/engine.py``): the scan's
                    final state against the plain version's (search shape
                    f32 and bf16, full width bf16) and the scan's time at
                    full width with and without it and in f32 at the
                    model's prefill shape; qwen3-0.6b and falcon-mamba-7b
                    at full width, 2 layers, f32, TF32 off: prefill (509
                    tokens) and 4 decode steps on the card against the
                    CPU, and the engine's greedy tokens against the direct
                    loop's; both at full width and depth in bf16, weights
                    made on the card: ``ServeEngine(max_slots=4,
                    prefill_chunk=2)`` on 8 requests of 509 and 254
                    prompt tokens and 32 generated, 2 arriving a tick,
                    with the kernels' launches counted from zero (rmsnorm
                    in both, flash in qwen3, the scan in falcon-mamba),
                    each request's first-token logits and tokens against
                    the direct loop, tokens/s, TTFT, s/token, peak memory
                    and the device's idle share over one decode tick
                    (torch.profiler); both in f32 at full depth, the
                    engine's tokens against the direct loop's (reported);
                    a measured GEVO search (pop 4, 2 generations) over
                    qwen3-0.6b's serving plan.
11. ``router``    — the multi-replica router (``core/deploy/router.py``)
                    on the serve phase's weights (full width and depth,
                    bf16) and trace: ``build_router(max_slots=4,
                    prefill_chunk=2, replicas=2)`` (the KV plan clamps a
                    replica to 1 slot at this length) with the kernels'
                    launches counted from zero (rmsnorm in both, flash in
                    qwen3, the scan in falcon-mamba), both replicas
                    answering, each request's tokens against the single
                    engine's (token agreement); tokens/s, mean TTFT and
                    s/token of one engine of 4 slots against two replicas
                    of 2 (in turns: one, two, two, one) and the device's
                    idle share over one decode-only router tick
                    (torch.profiler).  qwen3-0.6b at full width, 2 layers,
                    f32, TF32 off, two replicas of 2 slots: replica 0
                    killed at tick 4, every request's tokens equal to the
                    direct loop's; then a launch rmsnorm's C entry refuses
                    inside replica 1's step leaves ``Router.step`` as a
                    ``DeviceFault``, both replicas alive.  The same model,
                    one replica of 4 slots over the trace, without a mesh
                    and placed on the ``(1, 1)`` mesh of a NCCL group of
                    one rank (``build_router(mesh=)``: the replica serves
                    on its local blocks under the tensor-parallel
                    ``Dist``, here whole, with no gather a tick), in
                    turns: tokens bit for bit, the same launches,
                    s/token both ways,
                    every kernel call of the meshed runs held against its
                    plain version; ``python -m repro_torch.launch.serve
                    --mesh 1x1`` at full width and depth, every request
                    answered.
12. ``liveloop``  — the live loop (``core/liveloop``) on the card:
                    ``python -m repro_torch.core.liveloop synth`` and ``run
                    --mode real`` (qwen3-0.6b at its smoke config, head
                    dim 16 run padded to the flash kernel's 32, 2 ticks,
                    pop 4, one generation a tick) through ``main(argv)``,
                    its journal and windows, its kernel launches counted
                    from zero, and every distinct call it made of a
                    kernel's wrapper held again against the plain version
                    on the same inputs; 8 A/A canary
                    windows of the incumbent against itself, each measured
                    the controller's old way (three replays of one plan,
                    then three of the other) and its way on the card
                    (``CARD_WINDOW_REPEATS`` of each, in turns, each by
                    the device's busy time from torch.profiler, and by
                    CUDA events around the same replays), with
                    their throughput and TTFT ratios and how many fall
                    under the real guardrail's 0.95 floor; ``python -m
                    repro_torch.launch.serve --arch qwen3-0.6b --liveloop
                    <root> --replicas 2`` at full width, every request
                    answered.
13. ``train``     — training (``optim/``, ``train/``, ``python -m
                    repro_torch.launch.train``) and the three backward
                    kernels: (a) each backward kernel against its plain
                    version in f32 and bf16 at small ragged shapes, at
                    the training runs' shapes and at full width (rmsnorm
                    8192 x 1024 and flash B1 H16 S4096 hd128 in bf16, the
                    scan Bt1 L4096 D8192 N16 in f32), on the forward
                    kernel's outputs (its lse and tile-start states held
                    against the plain forward's, its o, y and h_last the
                    same bits with them), two calls the same bits (in
                    bf16 flash beside SDPA's backward's own error), with
                    its time, the plain version's, the library call's
                    (the backward of ``F.rms_norm``, of SDPA: the median
                    of three rounds, each call timed with a spin kernel
                    holding the stream while the host enqueues it, so
                    autograd's host work is left out; the plain event
                    time beside it) and the bound at full width and at
                    each training run's shape; the
                    ``ptxas`` registers and spills (none allowed) of the
                    scan's and rmsnorm's backward kernels, and at each of
                    their shapes the dynamic shared memory of a block and
                    the blocks an SM holds at once; (b) the loss and every
                    gradient of qwen3-0.6b and falcon-mamba-7b at full
                    width, 2 layers, f32, TF32 off, on the card against
                    the CPU, and in bf16 against the f32 card's; (c)
                    qwen3-0.6b at full width and depth in bf16, AdamW,
                    batch 8 x 1024 tokens, 30 steps through
                    ``launch.train``'s main, and (d)
                    falcon-mamba-7b at full width cut to 4 of 64 layers,
                    batch 2 x 2048, 20 steps: the loss falling on the
                    pipeline's Markov stream, every forward and backward
                    kernel launched as often a step as the layers imply
                    (counted from zero), s/step, tokens/s, peak memory and
                    the idle share of a step; (e) 6 steps straight against
                    3, a checkpoint, a restore and 3 more: parameters and
                    losses bit for bit.  The serve, router and live-loop
                    phases launch no backward kernel.
14. ``mesh``      — the mesh (``launch/mesh.py``, ``launch/shardings.py``,
                    the sharded and compressed train steps): ``python -m
                    repro_torch.launch.train --mesh smoke`` on
                    granite-moe-3b-a800m at full width (4 of 32 layers,
                    bf16, 4 x 1024, 4 steps) through the expert-parallel
                    MoE (its own NCCL group of one rank), s/step,
                    tokens/s, peak memory and launches a step; then a
                    NCCL group of one rank (``make_smoke_mesh(2, 2)``
                    refusing, naming the devices it needs) and its
                    ``(1, 1)`` mesh: one AdamW step sharded (the
                    tensor-parallel step on a model axis of one rank)
                    against one unsharded, bit for bit (loss, gradient
                    norm, every parameter), for qwen3-0.6b at full width
                    and depth and falcon-mamba-7b at 4 of 64 layers,
                    and for every other family at full width, depth cut:
                    qwen2-vl-72b 2 of 80 layers, hubert-xlarge 4 of 48,
                    granite-moe-3b-a800m 4 of 32 through the
                    expert-parallel branch (against the same step on
                    whole parameters), zamba2-1.2b 7 of 38,
                    deepseek-v3-671b 1 of 61 (13.4B parameters, SGD), and
                    a second step of each timed; granite's prefill
                    through the EP path against ``moe_dense`` (f32, 4
                    layers, a capacity factor that drops nothing); the
                    compressed step on one rank (the residual x - deq
                    exactly, the parameters within 0.05 of the exact
                    step's).  Every path's launches are counted from
                    zero.  Then each kernel, forward and backward, at the
                    per-rank shapes of a 16-way model split at full
                    width (flash on 1 of qwen3-0.6b's 16 heads, its q/k
                    norm, the scan on 512 of falcon-mamba-7b's 8192
                    channels) against its plain version, and flash at
                    the other families' per-rank shapes (hubert's 1
                    non-causal head of 80, zamba2's shared block's 2 of
                    64, qwen2-vl's 4 of 128).
15. ``dryrun``    — the dry run (``launch/dryrun.py``) against the real
                    step: qwen3-0.6b at full width and depth (8 x 1024)
                    and falcon-mamba-7b at 4 of 64 layers (2 x 2048),
                    bf16, AdamW, the sharded step on a NCCL group of one
                    rank and its ``(1, 1)`` mesh, launches counted from
                    zero, under ``FlopCounterMode``, peak memory from a
                    reset; then the same cells' dry runs on a fake group:
                    each kernel's events equal its launches, the aten dot
                    FLOPs equal ``FlopCounterMode``'s exactly, argument +
                    temp within 10% of the step's footprint, the card's
                    allocated memory unmoved, the roofline's ``step_s``
                    beside the measured s/step; ``remat="full"`` on
                    qwen3-0.6b: loss and gradients bit for bit, forward
                    kernels twice a checkpointed layer, the peak and the
                    estimate both lower; the production cell qwen3-0.6b
                    ``train_4k`` on 16x16: status ok.

Then a ``{"phase_seconds": {...}}`` line (each phase's wall time), a
``{"kernels": [...]}`` line (the three kernels and their three
backward kernels; ``launches_mesh`` counts the mesh phase's runs,
``launches_dryrun`` the dryrun phase's real steps), the
card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
the script exits nonzero.  Without a CUDA device, or outside a checkout of
the repository, it exits nonzero before printing a result.
"""

from __future__ import annotations

import contextlib
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
    card (``kernels.costs.H100``): HBM bytes/s, f32 and bf16 tensor-core
    FLOP/s."""
    from repro_torch.kernels.costs import H100
    return {"record": H100.name, "bw": H100.hbm_bw, "bf16": H100.tensor_flops,
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


# cycles a spin kernel first holds the stream while the host enqueues a
# timed call (about 1 ms at the H100's clock), and the tries, each 4 times
# longer, before a call the host could not get ahead of fails
SPIN_CYCLES, SPIN_TRIES = 2_000_000, 6


def spin_ms(torch, fn, *, reps: int, flush) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, L2 flushed before
    each call, with a spin kernel holding the stream while the host
    enqueues the call: the device's time alone, none of the host's work (a
    wrapper's, autograd's) between the events.  A call the host enqueued
    only after its spin ended is timed again behind a spin 4 times longer
    (autograd's host work for a library backward varied from ~0.1 to over
    1 ms between runs)."""
    for _ in range(2):
        fn()
    pairs = []
    cycles = SPIN_CYCLES
    for _ in range(reps):
        for _ in range(SPIN_TRIES):
            flush.zero_()
            torch.cuda._sleep(cycles)
            spun = torch.cuda.Event()
            spun.record()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            if not spun.query():
                break
            cycles *= 4
        else:
            raise AssertionError("spin_ms: the host did not enqueue the call "
                                 f"within {cycles // 4} cycles")
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


def sass_counts(sass: str, pattern: str) -> dict:
    """Per kernel function of a ``cuobjdump -sass`` listing, the number of
    instructions matching ``pattern``."""
    parts = sass.split("Function : ")[1:]
    names = _demangle([part.split()[0] for part in parts])
    return {n: len(re.findall(pattern, part))
            for n, part in zip(names, parts)}


# the bf16 flash backward's tensor-core kernels, one per head dim each
FLASH_BWD_BF16 = ("flash_bwd_dkdv_bf16_kernel", "flash_bwd_dq_bf16_kernel")


def flash_bwd_report(ptxas: list, hgmma: dict) -> dict:
    """Registers, spills and HGMMA count of every instantiation of the bf16
    flash backward's kernels; raise unless each of the six has HGMMA
    instructions, no spill and no serialized wgmma."""
    out = {r["kernel"]: {"registers": r["registers"],
                         "spill_stores": r["spill_stores"],
                         "spill_loads": r["spill_loads"],
                         "wgmma_serialized": r["wgmma_serialized"],
                         "hgmma": hgmma.get(r["kernel"], 0)}
           for r in ptxas if any(k in r["kernel"] for k in FLASH_BWD_BF16)}
    bad = {k: r for k, r in out.items()
           if not r["hgmma"] or r["spill_stores"] or r["spill_loads"]
           or r["wgmma_serialized"]}
    if len(out) != 2 * 3 or bad:
        raise AssertionError(f"flash_attention_bwd (bf16): {len(out)} "
                             f"kernels, not 6, or no HGMMA, spills or "
                             f"serialized wgmma: {bad}")
    return out


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
    flash_bwd = flash_bwd_report(ptxas["flash_attention"],
                                 sass_counts(sass, r"\bHGMMA\."))
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
           "flash_bwd_bf16": flash_bwd,
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
    """The scan's output and final state at every chunk of the joint space
    that divides L, at the search shape and at Bt 2, L 384, D 40 (where
    chunk 12 and 48 divide, and D is not a multiple of a block's channels),
    in f32 and bf16: one output and one state, bit for bit."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
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
            outs = [mamba_scan(*(inputs[k] for k in "dt x A B C".split()),
                               chunk=c, return_state=True) for c in chunks]
            if not all(torch.equal(outs[0][0], y) and torch.equal(
                    outs[0][1], h) for y, h in outs[1:]):
                raise AssertionError(f"mamba_scan {s} {dtype}: chunk changes "
                                     "the output or the final state")
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


def bound_of(cost, rate, rates) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, operations) of a ``kernels.costs``
    count at the rate ``rate`` of its operations."""
    t_bytes, t_ops = cost.bytes / rates["bw"], cost.operations / rate
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, cost.bytes, cost.operations


def bound(kernel, rates) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, operations) of one call at full width in
    bf16 (the scale in f32), from ``kernels.costs``' count: each input
    read once, each output written once; operations of the data this run
    needs (the causal half of attention)."""
    import torch

    from repro_torch.kernels import costs
    bf = torch.bfloat16
    cost = getattr(costs, f"{kernel}_fwd_cost")(**FULL[kernel], dtype=bf)
    return bound_of(cost, rates["bf16"] if cost.matmul else rates["f32"],
                    rates)


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
# spread (max / min - 1) the acceptance asks for, asserted since each
# measured time is the mean over PROGRAM_INSTANCES program graphs on
# memory of their own (a graph replays at one of two speeds about 8%
# apart, set by where its memory lies).
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
            "profiled_measured_s": per_replay * per_eval,
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
    from repro_torch.core.fitness import LAST_INSTANCES, PROGRAM_INSTANCES, \
        static_time
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
        repeats, walls = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            t, e = w.evaluate(w.program)
            walls.append(time.perf_counter() - t0)
            if not (np.isfinite(t) and 0.0 <= e < 0.9):
                raise AssertionError(f"{name}: unmutated fitness ({t}, {e})")
            # each graph instance's time of this evaluation (s a replay)
            inst = list(LAST_INSTANCES)
            if len(inst) != PROGRAM_INSTANCES:
                raise AssertionError(f"{name}: {len(inst)} graph instances "
                                     f"recorded, not {PROGRAM_INSTANCES}")
            repeats.append({"measured_s": t, "error": e,
                            "instances_s": inst,
                            "instance_spread": max(inst) / min(inst) - 1,
                            **replay_profile(torch, w, inputs[name],
                                             per_eval)})
        times = [r["measured_s"] for r in repeats]
        spread = max(times) / min(times) - 1
        inst_spreads = [r["instance_spread"] for r in repeats]
        unmutated = {"measured_s": times, "error": e,
                     "instances": PROGRAM_INSTANCES,
                     "instances_s": [r["instances_s"] for r in repeats],
                     "instance_spreads": inst_spreads,
                     # the fault-2 evidence: slow instances showed in an
                     # evaluation and the medians held within the limit
                     "median_held_against_slow_instance":
                         max(inst_spreads) > REPEAT_SPREAD
                         and spread <= REPEAT_SPREAD,
                     "wall_s_per_evaluation": walls,
                     "spread": spread,
                     "within_spread": spread <= REPEAT_SPREAD,
                     "static_s": static_time(w.program) * per_eval,
                     "replays_profiled": repeats}
        if not unmutated["within_spread"]:
            emit({"phase": "programs", "step": "unmutated",
                  "workload": name, "unmutated": unmutated})
            raise AssertionError(f"{name}: three measured evaluations of "
                                 f"the unmutated program spread "
                                 f"{unmutated['spread']:.4f} > "
                                 f"{REPEAT_SPREAD}: {times}")
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
                     "unmutated_instance_spreads": inst_spreads,
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


# -- islands and the tensorized engine ----------------------------------------

# The islands phase: 2fcNet at the builder's defaults in static time, 4
# islands x pop 8, 4 generations; a measured flash-attention search on 2
# islands.  The tensor phase: the joint workload, pop 1024 (its depth cut
# from 10 and 6 generations to 5 and 4, to keep the script well inside its
# time limit; the kill after generation 3 and two migrations remain).
ISLANDS = {"n_islands": 4, "pop_size": 8, "generations": 4,
           "migrate_every": 2, "n_migrants": 2}
TENSOR_POP, TENSOR_GENERATIONS, TENSOR_KILL_AFTER = 1024, 5, 3
FLEET = {"n_islands": 4, "pop_size": 1024, "generations": 4,
         "migrate_every": 2, "n_migrants": 2}


def context_probe(kind: str) -> int:
    """In a spawned process: build ``kind``'s workload on the card and
    evaluate it once; return the device memory in use on the card then
    (every process's)."""
    import torch
    if kind == "twofc":
        from repro_torch.workloads.twofc import build_twofc_training_workload
        w = build_twofc_training_workload()
    else:
        from repro_torch.kernels.workloads import build_kernel_workload
        w = build_kernel_workload(kind, time_mode="measured")
    w.evaluate(w.program)
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    return total - free


def context_bytes(torch, kind: str) -> int:
    """The device memory one more process takes on the card: its CUDA
    context, the kernel libraries and ``kind``'s workload, built and
    evaluated once (what :data:`CONTEXT_RESERVE_BYTES` reserves)."""
    import multiprocessing as mp
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    with mp.get_context("spawn").Pool(1) as pool:
        used = pool.apply(context_probe, (kind,))
    return used - (total - free)


def island_key(res) -> dict:
    """What two island runs must share bit for bit: the merged front,
    every island's population and the migration log."""
    from repro_torch.core.serialize import patch_doc
    return {"pareto": [(patch_doc(i.patch), i.fitness) for i in res.pareto],
            "sources": res.pareto_sources,
            "populations": [[(patch_doc(i.patch), i.fitness)
                             for i in isl.population] for isl in res.islands],
            "migration_log": res.migration_log}


def phase_islands(torch, wl, counters) -> dict:
    """The island model on the card: 2fcNet in static time with the
    process backend as ``plan()`` chooses it here, against the same search
    in-process (manifests and fronts bit for bit); then a measured
    flash-attention search on 2 islands, which ``plan()`` keeps in one
    process, with reserved memory flat over its generations."""
    import multiprocessing as mp
    import tempfile

    from repro_torch.core.islands import (CONTEXT_RESERVE_BYTES,
                                          IslandOrchestrator,
                                          default_island_specs, plan)
    from repro_torch.workloads.twofc import build_twofc_training_workload
    t0 = time.perf_counter()
    contexts = {k: context_bytes(torch, k)
                for k in ("twofc", "flash_attention")}
    if max(contexts.values()) > CONTEXT_RESERVE_BYTES:
        raise AssertionError(f"a context takes {contexts}, more than the "
                             f"{CONTEXT_RESERVE_BYTES} plan() reserves")
    w = build_twofc_training_workload()
    chosen = plan(ISLANDS["n_islands"], time_mode="static")
    kw = dict(n_islands=ISLANDS["n_islands"], pop_size=ISLANDS["pop_size"],
              migrate_every=ISLANDS["migrate_every"],
              n_migrants=ISLANDS["n_migrants"], topology="ring")
    root = Path(tempfile.mkdtemp(prefix="islands_", dir=ROOT / "build"))
    runs, walls, manifests = {}, {}, {}
    for name, processes in (("planned", chosen.processes),
                            ("in_process", False)):
        t = time.perf_counter()
        orch = IslandOrchestrator(w, root_dir=str(root / name),
                                  processes=processes,
                                  eval_workers=chosen.eval_workers
                                  if processes else 0, **kw)
        res = orch.run(generations=ISLANDS["generations"])
        walls[name] = time.perf_counter() - t
        runs[name] = res
        manifests[name] = json.loads((root / name / "manifest.json")
                                     .read_text())
    same_manifest = manifests["planned"] == manifests["in_process"]
    same_front = island_key(runs["planned"]) == island_key(
        runs["in_process"])
    if not (same_manifest and same_front):
        raise AssertionError("process islands differ from in-process "
                             f"islands (manifest equal: {same_manifest}, "
                             f"fronts equal: {same_front})")

    # measured time: plan() keeps the islands in this process
    wf = wl.build_kernel_workload("flash_attention", time_mode="measured")
    mplan = plan(2, time_mode="measured")
    if mplan.processes or mplan.eval_workers:
        raise AssertionError(f"measured islands left the process: "
                             f"{mplan.describe()}")
    reserved, children = [torch.cuda.memory_reserved()], []

    def on_generation(island, gen, row):
        reserved.append(torch.cuda.memory_reserved())
        children.append(len(mp.active_children()))

    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    morch = IslandOrchestrator(
        wf, root_dir=str(root / "measured"), processes=mplan.processes,
        specs=default_island_specs(2, operators={"attr_tweak": 1.0}),
        pop_size=6, migrate_every=2, n_migrants=1)
    mres = morch.run(generations=4, on_generation=on_generation)
    mwall = time.perf_counter() - t
    launches = {k: c.launches for k, c in counters.items()}
    if launches["flash_attention"] <= 0:
        raise AssertionError("measured islands never launched flash")
    if any(children):
        raise AssertionError(f"measured islands ran beside {children} "
                             "other processes")
    if max(reserved[1:]) > reserved[1] + RESERVED_SLACK:
        raise AssertionError(f"reserved device memory grew over the "
                             f"measured islands: {reserved}")
    out = {"phase": "islands", "seconds": time.perf_counter() - t0,
           "gpu": nvidia_smi(),
           "context_bytes": contexts,
           "context_reserve_bytes": CONTEXT_RESERVE_BYTES,
           "plan": {"describe": chosen.describe(),
                    "processes": chosen.processes,
                    "eval_workers": chosen.eval_workers,
                    "cores": chosen.cores, "cards": chosen.cards,
                    "contexts": chosen.contexts,
                    "max_contexts": chosen.max_contexts},
           "twofc_static": {
               "wall_s": walls, "manifest_equal": same_manifest,
               "front_equal": same_front,
               "pareto": [list(i.fitness) for i in runs["planned"].pareto],
               "cross_island_hits": {
                   k: r.cross_island_hits for k, r in runs.items()}},
           "flash_measured": {
               "plan": mplan.describe(), "wall_s": mwall,
               "other_processes_by_generation": children,
               "reserved_bytes_by_generation": reserved,
               "cross_island_hits": mres.cross_island_hits,
               "pareto": [list(i.fitness) for i in mres.pareto]},
           "launches": launches}
    emit(out)
    return out


def expected_fill_launches(batched) -> dict:
    """Kernel launches that filling ``batched``'s error tables must make:
    one for each error class whose implementation is the kernel and which
    some completion of the class's other knobs makes launchable (the
    unfused rmsnorm epilogue launches the kernel once too)."""
    from repro_torch.core.fitness import InvalidVariant
    from repro_torch.kernels.costs import schedule_time
    enc = batched.encoding
    out = {}
    for block in batched.spec.blocks:
        knobs = dict(block.knob_map)
        space = {k: enc.space.choices(s) for k, s in knobs.items()}
        classes = set()
        for values in itertools.product(*space.values()):
            genome = dict(zip(space, values))
            if genome["impl"] != "pallas":
                continue
            try:
                schedule_time(block.kernel, genome, **dict(block.shape))
            except InvalidVariant:
                continue
            classes.add(tuple(genome[k] for k in block.error_knobs))
        out[block.kernel] = len(classes)
    return out


def step_rate(torch, step, n: int) -> float:
    """Generations per second of ``step()`` over ``n`` calls."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t)


def idle_share(torch, step) -> dict:
    """One ``step()`` under torch.profiler: its wall time, the device's
    busy time and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans = device_spans(torch, prof)
    if not spans:
        raise AssertionError("the profiler saw no device work in a step")
    busy = busy_us(spans)
    return {"window_us": wall_us, "device_busy_us": busy,
            "device_kernels": len(spans),
            "device_idle_share": 1 - busy / wall_us}


def step_breakdown(torch, eng, idx, gen, n: int = 10) -> dict:
    """Milliseconds a generation step spends, on average over ``n`` steps
    (each part bracketed by synchronizations): the objectives, the ranking
    and crowding (its front-peeling loop reads one flag back to the host
    per front), the selection order, and the whole step."""
    from repro_torch.core.tensor_evo import nsga2
    step, parts, fronts = eng.step_fn(), {}, []

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
        return out

    for _ in range(n):
        objs, _ = timed("objectives", lambda: eng.objectives_fn()(idx))
        rank, crowd = timed("rank_crowd",
                            lambda: nsga2.rank_crowd(objs, xp=eng.xp))
        timed("selection_order",
              lambda: nsga2.selection_order(rank, crowd, xp=eng.xp))
        fronts.append(int(rank.max()) + 1)
        idx, _ = timed("step", lambda: step(idx, gen, 0.8, 0.5))
    out = {f"{k}_ms": v * 1e3 / n for k, v in parts.items()}
    out["fronts"] = fronts
    return out


def phase_tensor(torch, wl, counters) -> dict:
    """The tensorized engine on the card (see the module docstring)."""
    import tempfile

    import numpy as np

    from repro_torch.core import GevoML, IslandOrchestrator
    from repro_torch.core.evaluator import SerialEvaluator
    from repro_torch.core.islands import default_island_specs
    from repro_torch.core.tensor_evo import (TensorGevoML,
                                             TensorIslandFleet, nsga2)
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="tensor_", dir=ROOT / "build"))
    w = wl.build_joint_kernel_workload()

    class Kill(Exception):
        pass

    def engine(name, **kw):
        return TensorGevoML(w, pop_size=TENSOR_POP, n_elite=16, seed=0,
                            checkpoint_dir=str(root / name), **kw)

    def reset():
        for c in counters.values():
            c.launches = 0

    # the main path: one engine, TENSOR_GENERATIONS, counted from zero
    reset()
    eng = engine("full")
    t = time.perf_counter()
    res = eng.run(generations=TENSOR_GENERATIONS)
    wall = time.perf_counter() - t
    launches = {k: c.launches for k, c in counters.items()}
    expected = {**{k: 0 for k in counters},
                **expected_fill_launches(eng.batched)}
    if launches != expected:
        raise AssertionError(f"fill_error_tables launched {launches}, "
                             f"expected {expected}")

    # the device step against the numpy path on one generation's lanes
    idx = torch.as_tensor(np.load(root / "full" / "state_latest.npz")["idx"],
                          device="cuda")
    idx_np = idx.cpu().numpy()
    t_dev, v_dev = eng.batched.torch_terms_fn("cuda")(idx)
    t_np, v_np, _ = eng.batched.terms(np, idx_np)
    t_np = np.asarray(t_np, np.float64)
    time_equal = bool(np.array_equal(t_dev.cpu().numpy().view(np.int64),
                                     t_np.view(np.int64)))
    valid_equal = bool(np.array_equal(v_dev.cpu().numpy(), v_np))
    objs, valid = eng.objectives_fn()(idx)
    err_np = eng.batched.errors_np(idx_np, v_np)
    err_equal = bool(np.array_equal(
        objs[:, 1].cpu().numpy()[v_np], err_np[v_np]))
    rank, crowd = nsga2.rank_crowd(objs, xp=eng.xp)
    order = nsga2.selection_order(rank, crowd, xp=eng.xp)
    rank_np, crowd_np = nsga2.rank_crowd(objs.cpu().numpy())
    order_np = nsga2.selection_order(rank_np, crowd_np)
    rank_equal = bool(np.array_equal(rank.cpu().numpy(), rank_np))
    order_equal = bool(np.array_equal(order.cpu().numpy(), order_np))
    if not (time_equal and valid_equal and err_equal and rank_equal
            and order_equal):
        raise AssertionError(
            f"the device step differs from the numpy path: time "
            f"{time_equal}, validity {valid_equal}, error {err_equal}, "
            f"rank {rank_equal}, selection order {order_equal}")

    # the reported fitness against SerialEvaluator, member by member
    with SerialEvaluator(w) as se:
        serial = se.evaluate_batch([i.patch for i in res.population])
    serial_equal = all(o.fitness == i.fitness
                       for o, i in zip(serial, res.population))
    if not serial_equal:
        raise AssertionError("the engine's fitness differs from "
                             "SerialEvaluator's")

    # kill after generation 3, resume, and end where the unbroken run did
    def bomb(gen, row):
        if gen == TENSOR_KILL_AFTER:
            raise Kill

    try:
        engine("killed").run(generations=TENSOR_GENERATIONS,
                             on_generation=bomb)
        raise AssertionError("the kill never fired")
    except Kill:
        pass
    resumed = engine("killed").run(generations=TENSOR_GENERATIONS,
                                   resume=True)
    full_state = np.load(root / "full" / "state_latest.npz")
    res_state = np.load(root / "killed" / "state_latest.npz")
    resume_equal = (bool(np.array_equal(full_state["idx"],
                                        res_state["idx"]))
                    and [i.fitness for i in resumed.population]
                    == [i.fitness for i in res.population])
    if not resume_equal:
        raise AssertionError("a resumed engine ended elsewhere than the "
                             "unbroken run")

    # the step's throughput and the device's idle share over a generation
    step, gen = eng.step_fn(), torch.Generator(device="cuda")
    gen.manual_seed(1)
    state = {"idx": idx}

    def one():
        state["idx"], _ = step(state["idx"], gen, 0.8, 0.5)

    one()
    engine_rate = step_rate(torch, one, 10)
    engine_idle = idle_share(torch, one)
    breakdown = step_breakdown(torch, eng, state["idx"], gen)

    # the fleet: backend="mesh", 4 x 1024, FLEET generations, counted from 0
    reset()
    specs = default_island_specs(FLEET["n_islands"],
                                 operators={"attr_tweak": 1.0})
    t = time.perf_counter()
    orch = IslandOrchestrator(
        w, root_dir=str(root / "mesh"), specs=specs,
        pop_size=FLEET["pop_size"], n_elite=16,
        migrate_every=FLEET["migrate_every"],
        n_migrants=FLEET["n_migrants"], backend="mesh")
    fres = orch.run(FLEET["generations"])
    fleet_wall = time.perf_counter() - t
    fleet_launches = {k: c.launches for k, c in counters.items()}
    if min(fleet_launches[k] for k in wl.KERNELS) <= 0:
        raise AssertionError(f"the fleet left a kernel unlaunched: "
                             f"{fleet_launches}")
    fkw = dict(specs=specs, pop_size=FLEET["pop_size"], n_elite=16,
               migrate_every=FLEET["migrate_every"],
               n_migrants=FLEET["n_migrants"])
    with TensorIslandFleet(w, root_dir=str(root / "fleet_killed"),
                           **fkw) as fleet:
        fleet.run(FLEET["generations"] // 2)
    with TensorIslandFleet(w, root_dir=str(root / "fleet_killed"),
                           **fkw) as fleet:
        fleet.run(FLEET["generations"], resume=True)
        fstate = {k: torch.as_tensor(v) for k, v in
                  np.load(fleet.state_path).items()}
        generators = []
        for rng in fstate["rng"]:
            g = torch.Generator(device="cuda")
            g.set_state(rng)
            generators.append(g)
        fidx = fstate["idx"].to("cuda")
        cx = [s.crossover_rate for s in specs]
        mut = [s.mutation_rate for s in specs]
        fstate_ = {"idx": fidx}

        def fleet_step():
            fstate_["idx"], _ = fleet.step(fstate_["idx"], generators,
                                           cx, mut)

        fleet_step()
        fleet_rate = step_rate(torch, fleet_step, 6)
        fleet_idle = idle_share(torch, fleet_step)
    mesh_state = np.load(root / "mesh" / "mesh_state.npz")
    killed_state = np.load(root / "fleet_killed" / "mesh_state.npz")
    fleet_resume_equal = bool(np.array_equal(mesh_state["idx"],
                                             killed_state["idx"]))
    if not fleet_resume_equal:
        raise AssertionError("a resumed fleet ended elsewhere than the "
                             "unbroken run")

    # the same search under engine="python" on the card
    t = time.perf_counter()
    with GevoML(w, pop_size=128, n_elite=16, seed=0,
                operators={"attr_tweak": 1.0}, engine="python") as py:
        py.run(generations=2)
        py_evals = py.n_evals
    py_wall = time.perf_counter() - t

    out = {"phase": "tensor", "seconds": time.perf_counter() - t0,
           "gpu": nvidia_smi(),
           "engine": {"pop": TENSOR_POP, "generations": TENSOR_GENERATIONS,
                      "wall_s": wall, "launches": launches,
                      "expected_launches": expected,
                      "time_bits_equal": time_equal,
                      "validity_equal": valid_equal,
                      "error_equal": err_equal, "rank_equal": rank_equal,
                      "selection_order_equal": order_equal,
                      "fitness_equal_serial": serial_equal,
                      "resume_equal": resume_equal,
                      "generations_per_s": engine_rate,
                      "lanes_per_s": engine_rate * TENSOR_POP,
                      "step": engine_idle, "step_breakdown": breakdown,
                      "pareto": [list(i.fitness) for i in res.pareto]},
           "fleet": {**FLEET, "wall_s": fleet_wall,
                     "launches": fleet_launches,
                     "resume_equal": fleet_resume_equal,
                     "generations_per_s": fleet_rate,
                     "lanes_per_s": fleet_rate * FLEET["n_islands"]
                     * FLEET["pop_size"],
                     "step": fleet_idle,
                     "cross_island_hits": fres.cross_island_hits,
                     "pareto": [list(i.fitness) for i in fres.pareto]},
           "python_engine": {"pop": 128, "generations": 2,
                             "evaluations": py_evals, "wall_s": py_wall,
                             "evaluations_per_s": py_evals / py_wall}}
    emit(out)
    return out


# --------------------------------------------------------------------------
# 10. serve: the model stack and the continuous-batching server
# --------------------------------------------------------------------------

# The served models, at full width (configs/qwen3_0_6b.py,
# configs/falcon_mamba_7b.py), and the trace: demo_requests alternates
# prompts of 509 and 254 tokens (neither a multiple of a flash tile or the
# scan's chunk, so both pad), 2 arrivals a tick.
SERVE_ARCHS = ("qwen3-0.6b", "falcon-mamba-7b")
SERVE_TRACE = {"n_requests": 8, "prompt_len": 509, "gen": 32}
SERVE_ENGINE = {"max_slots": 4, "prefill_chunk": 2}
SERVE_STAGGER = 2
# Card against CPU: 2 layers at full width in f32, TF32 off, 4 decode steps
# after a 509-token prefill.  |card - cpu| <= a |cpu| + b max(1, max |cpu|):
# both sides sum the same products in other orders (cuBLAS against MKL over
# up to 16384 terms, the flash kernel's tiles against the plain version's,
# ex2.approx in the scan against exp2), about 1e-6 relative a matmul,
# compounded over a dozen matmuls, softmax and the 151,936-way head; a = 1e-3
# and b = 1e-4 leave room for that and none for a fault (a misplaced pad or
# cache row moves logits by O(1)).
CARD_CPU_LAYERS, CARD_CPU_STEPS = 2, 4
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-3, 1e-4
# bf16 at full depth: each request's first-token logits from the engine
# against the direct loop's (one prompt a prefill).  A request the engine
# prefilled alone ran the same kernels on the same shapes: bit for bit.
# One prefilled beside another prompt of its length went through matmuls
# that cuBLAS rounds unlike a batch of one, and bf16 carries that through
# every layer (64 in falcon-mamba-7b): its logit vector is held to a
# relative L2 error of 0.1, where another prompt's logits would be ~1.4
# away (two independent vectors of equal norm).
SERVE_BF16_REL_L2 = 0.1
SERVE_GEVO = {"pop_size": 4, "generations": 2, "n_requests": 8,
              "prompt_len": 64, "gen": 8}


def within(torch, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= rtol |want| + atol max(1, max |want|);
    returns the largest |got - want|."""
    g, w = got.float().cpu(), want.float().cpu()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"shape {tuple(g.shape)} against "
                             f"{tuple(w.shape)}, or not finite")
    diff = (g - w).abs()
    bound = rtol * w.abs() + atol * max(1.0, float(w.abs().max()))
    if not bool((diff <= bound).all()):
        raise AssertionError(f"max |diff| {float(diff.max()):.3e} beyond "
                             f"{rtol} |want| + {atol} max(1, max |want|)")
    return float(diff.max())


def splice_caches(T, cfg, pre: dict, P: int, total: int, device) -> dict:
    """A prefill's caches in decode caches of ``total`` positions (the
    direct loop's splice: token-indexed leaves take the P positions)."""
    full = T.init_cache(cfg, pre[next(iter(pre))].shape[1], total,
                        device=device)
    for k, f in full.items():
        p = pre[k]
        if p.shape == f.shape:
            f.copy_(p)
        elif p.dim() == f.dim() and p.shape[2] == P and f.shape[2] == total:
            f[:, :, :P] = p
    return full


def direct_loop(torch, T, cfg, params, prompt, gen: int, tokens=None):
    """The engine-independent oracle: prefill one prompt, then ``gen - 1``
    decode steps, greedy (or feeding ``tokens``).  Returns (first-token
    logits, every step's logits, tokens, caches)."""
    dev = params.device
    P = len(prompt)
    logits, pre = T.prefill(params, {"tokens": prompt[None]}, cfg)
    caches = splice_caches(T, cfg, pre, P, P + gen, dev)
    steps = [logits]
    out = [int(logits.argmax(-1)[0]) if tokens is None else tokens[0]]
    for t in range(gen - 1):
        tb = {"tokens": torch.tensor([[out[-1]]], device=dev),
              "positions": torch.tensor([[P + t]], device=dev)}
        logits, caches = T.decode_step(params, tb, caches, P + t, cfg)
        steps.append(logits)
        out.append(int(logits.argmax(-1)[0]) if tokens is None
                   else tokens[t + 1])
    return steps[0], steps, out, caches


def card_against_cpu(torch, arch: str) -> dict:
    """The port's prefill and decode steps of ``arch`` at full width, 2
    layers, f32, on the card against the same on the CPU (same weights,
    same tokens); then the engine's greedy tokens against the direct loop's
    on the card."""
    import copy

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import ServeEngine
    from repro_torch.core.interp import full_f32
    from repro_torch.core.liveloop.traces import demo_requests
    from repro_torch.models import transformer as T
    cfg = get_config(arch).scaled(n_layers=CARD_CPU_LAYERS, dtype="float32")
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    P = SERVE_TRACE["prompt_len"]
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, P)
    gen = CARD_CPU_STEPS + 1
    t0 = time.perf_counter()
    _, want, toks, want_caches = direct_loop(torch, T, cfg, cpu, prompt, gen)
    cpu_s = time.perf_counter() - t0
    with full_f32():
        _, got, _, got_caches = direct_loop(torch, T, cfg, card, prompt, gen,
                                            tokens=toks)
        errs = {f"logits_{i}": within(torch, g, w, CARD_CPU_RTOL,
                                      CARD_CPU_ATOL)
                for i, (g, w) in enumerate(zip(got, want))}
        errs.update({f"cache_{k}": within(torch, got_caches[k],
                                          want_caches[k], CARD_CPU_RTOL,
                                          CARD_CPU_ATOL)
                     for k in want_caches})
        # all at once: each tick prefills two prompts of one length as a
        # batch, and the decode step runs four lanes
        reqs = demo_requests(cfg, n_requests=4, prompt_len=P,
                             gen=CARD_CPU_STEPS)
        eng = ServeEngine(cfg, card, max_len=P + CARD_CPU_STEPS,
                          **SERVE_ENGINE)
        served = {r.uid: r.tokens for r in eng.run(reqs)}
        direct = {r.uid: direct_loop(torch, T, cfg, card, r.tokens,
                                     CARD_CPU_STEPS)[2] for r in reqs}
    if served != direct:
        raise AssertionError(f"{arch} f32: the engine's tokens {served} "
                             f"differ from the direct loop's {direct}")
    del card, cpu
    torch.cuda.empty_cache()
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "vocab": cfg.vocab, "dtype": "float32"},
            "prompt_len": P, "decode_steps": CARD_CPU_STEPS,
            "max_abs_err": errs, "cpu_s": cpu_s,
            "engine_tokens_equal_direct": True}


def full_depth_f32_agreement(torch, arch: str) -> dict:
    """``arch`` at full width and depth in f32 (TF32 off) on the card: the
    engine (all four requests at once, so prompts of one length share a
    prefill and the decode step runs four lanes) against the direct loop,
    token for token.  The bf16 server's disagreements are rounding only if
    they vanish here; reported, held to nothing."""
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import ServeEngine
    from repro_torch.core.interp import full_f32
    from repro_torch.core.liveloop.traces import demo_requests
    from repro_torch.models import transformer as T
    cfg = get_config(arch).scaled(dtype="float32")
    params = T.init_params(cfg, device="cuda")
    gen = 8
    reqs = demo_requests(cfg, n_requests=4,
                         prompt_len=SERVE_TRACE["prompt_len"], gen=gen)
    with full_f32():
        eng = ServeEngine(cfg, params,
                          max_len=SERVE_TRACE["prompt_len"] + gen,
                          **SERVE_ENGINE)
        served = {r.uid: r.tokens for r in eng.run(reqs)}
        direct = {r.uid: direct_loop(torch, T, cfg, params, r.tokens,
                                     gen)[2] for r in reqs}
    del params, eng
    torch.cuda.empty_cache()
    agree = sum(a == b for r in reqs
                for a, b in zip(served[r.uid], direct[r.uid]))
    return {"n_layers": cfg.n_layers, "requests": len(reqs), "gen": gen,
            "token_agreement": agree / (len(reqs) * gen)}


def decode_idle_share(torch, engine, cfg, prompts) -> dict:
    """One decode-only engine tick under torch.profiler: every prompt
    admitted and prefilled in one tick, the next tick profiled."""
    from repro_torch.core.deploy import ServeRequest
    for i, p in enumerate(prompts):
        engine.submit(ServeRequest(uid=f"idle{i}", tokens=p,
                                   max_new_tokens=4))
    engine.step()
    if engine.queue:
        raise AssertionError("the idle-share tick must find every prompt "
                             "admitted")
    out = idle_share(torch, engine.step)
    while engine.busy:
        engine.step()
    return out


def serve_model(torch, arch: str, counters, keep: dict) -> dict:
    """``arch`` at full width and depth in bf16, weights made on the card:
    the engine on the trace, its launches counted from zero, each
    request's first-token logits and tokens against the direct loop.  The
    config, the weights and the engine's tokens stay in ``keep[arch]`` for
    the router."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import ServeEngine
    from repro_torch.core.liveloop.traces import demo_requests
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = T.init_params(cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = demo_requests(cfg, **SERVE_TRACE)
    max_len = SERVE_TRACE["prompt_len"] + SERVE_TRACE["gen"]
    # warm-up (library handles, first launches) outside the measured run
    ServeEngine(cfg, params, max_len=max_len, **SERVE_ENGINE).run(
        demo_requests(cfg, n_requests=2, prompt_len=max_len // 2, gen=2))
    recorded = []
    prefill = T.prefill

    def recording(params_, batch, cfg_, *dist):
        logits, caches = prefill(params_, batch, cfg_, *dist)
        recorded.append((batch["tokens"].cpu().numpy(), logits.cpu()))
        return logits, caches

    engine = ServeEngine(cfg, params, max_len=max_len, **SERVE_ENGINE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the weights that earlier models keep on the card for the router are
    # taken off the peak: it is this model's alone
    held = sum(t.numel() * t.element_size() for m in keep.values()
               for t in itertools.chain(m["params"].parameters(),
                                        m["params"].buffers()))
    for fn in counters.values():
        fn.launches = 0
    T.prefill = recording
    try:
        results = engine.run(reqs, stagger=SERVE_STAGGER)
        torch.cuda.synchronize()
    finally:
        T.prefill = prefill
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() - held
    stats = engine.stats()
    want_kernels = ("rmsnorm", "flash_attention") if arch.startswith("qwen") \
        else ("rmsnorm", "mamba_scan")
    for k in want_kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{arch}: the server never launched {k}")
    first = {}   # prompt -> (first-token logits, prompts in its prefill)
    for toks, logits in recorded:
        for row, tk in zip(logits, toks):
            first[np.asarray(tk, np.int64).tobytes()] = (row, len(toks))
    by_uid = {r.uid: r for r in results}
    if len(by_uid) != len(reqs):
        raise AssertionError(f"{arch}: {len(by_uid)} of {len(reqs)} "
                             "requests answered")
    alone, grouped, agree, total = [], [], 0, 0
    for req in reqs:
        logits, _, toks, _ = direct_loop(torch, T, cfg, params, req.tokens,
                                         SERVE_TRACE["gen"])
        got, batch = first[np.asarray(req.tokens, np.int64).tobytes()]
        want = logits[0].cpu()
        if batch == 1:
            if not torch.equal(got, want):
                raise AssertionError(f"{arch} {req.uid}: a prefill of one "
                                     "prompt differs from the direct loop's")
            alone.append(req.uid)
        else:
            rel = float((got.float() - want.float()).norm()
                        / want.float().norm())
            if not rel <= SERVE_BF16_REL_L2:
                raise AssertionError(f"{arch} {req.uid}: first-token logits "
                                     f"{rel:.3f} (relative L2) from the "
                                     "direct loop's")
            grouped.append(rel)
        served = by_uid[req.uid].tokens
        if len(served) != SERVE_TRACE["gen"] or not all(
                0 <= t < cfg.vocab for t in served):
            raise AssertionError(f"{arch} {req.uid}: tokens {served}")
        agree += sum(a == b for a, b in zip(served, toks))
        total += len(toks)
    per = stats["per_variant"]["default"]
    idle = decode_idle_share(torch, ServeEngine(
        cfg, params, max_len=max_len, max_slots=4, prefill_chunk=4),
        cfg, [r.tokens for r in reqs[:4]])
    keep[arch] = {"cfg": cfg, "params": params, "tokens": {
        uid: r.tokens for uid, r in by_uid.items()}}
    del engine
    torch.cuda.empty_cache()
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "vocab": cfg.vocab, "dtype": cfg.dtype},
            "init_s": init_s, "launches": launches,
            "requests": len(results), "gen_tokens": stats["gen_tokens"],
            "wall_s": stats["wall_s"],
            "tokens_per_s": stats["throughput_tok_s"],
            "mean_ttft_s": per["mean_ttft_s"],
            "mean_latency_s": per["mean_latency_s"],
            "s_per_token": per["s_per_token"],
            "prefill_batches": stats["prefill_batches"],
            "decode_batches": stats["decode_batches"],
            "peak_allocated_bytes": peak,
            "first_logits_bitwise_equal": alone,
            "first_logits_rel_l2_grouped": grouped,
            "token_agreement": agree / total, "tokens_compared": total,
            "decode_tick": idle}


def serve_gevo(torch) -> dict:
    """A measured GEVO search over the serving plan of qwen3-0.6b at full
    width on the card: its front."""
    from repro_torch.core.deploy import build_serve_workload
    from repro_torch.core.search import GevoML
    g = SERVE_GEVO
    wl = build_serve_workload("qwen3-0.6b", smoke=False,
                              n_requests=g["n_requests"],
                              prompt_len=g["prompt_len"], gen=g["gen"],
                              device="cuda")
    t0 = time.perf_counter()
    res = GevoML(wl, pop_size=g["pop_size"], n_elite=2, seed=0,
                 mutation_rate=1.0, operators={"attr_tweak": 1.0}).run(
        generations=g["generations"])
    wall = time.perf_counter() - t0
    front = [{"genome": wl.space.decode(ind.patch.apply(wl.program)),
              "s_per_token": ind.fitness[0],
              "mean_latency_s": ind.fitness[1]} for ind in res.pareto]
    if not front or not all(f["s_per_token"] > 0 for f in front):
        raise AssertionError(f"serve GEVO: front {front}")
    return {"workload": wl.name, **g, "wall_s": wall,
            "original": list(res.original_fitness), "front": front}


def scan_state(torch, wl) -> dict:
    """The scan's final state (``return_state``) against the plain
    version's, at the search shape in f32 and bf16 and at full width in
    bf16, with the scan's tolerances; and the scan's time at full width
    with and without it, and in f32 at the model's prefill shape (509
    tokens padded to 512)."""
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_plain
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    cases = [("search", wl.SHAPES["mamba_scan"], torch.float32),
             ("search", wl.SHAPES["mamba_scan"], torch.bfloat16),
             ("full", FULL["mamba_scan"], torch.bfloat16)]
    for where, s, dtype in cases:
        inputs = full_inputs(torch, "mamba_scan", gen) if where == "full" \
            else to_dtype(torch, "mamba_scan",
                          full_inputs_small(torch, s, gen), dtype)
        args = [inputs[k] for k in ("dt", "x", "A", "B", "C")]
        y, h = mamba_scan(*args, chunk=64, return_state=True)
        yp, hp = mamba_scan_plain(*args, chunk=min(64, s["L"]),
                                  return_state=True)
        name = str(dtype)[6:]
        out[f"{where} {name}"] = {
            "y": check_close(torch, "mamba_scan", f"{where} y", y, yp, name),
            "h_last": check_close(torch, "mamba_scan", f"{where} h_last",
                                  h, hp, name)}
        del inputs, args, y, h, yp, hp
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    inputs = full_inputs(torch, "mamba_scan", gen)
    args = [inputs[k] for k in ("dt", "x", "A", "B", "C")]
    out["full_bf16_ms"] = {
        "y": time_ms(torch, lambda: mamba_scan(*args, chunk=64), reps=20,
                     flush=flush),
        "y_and_h_last": time_ms(torch, lambda: mamba_scan(
            *args, chunk=64, return_state=True), reps=20, flush=flush)}
    model = {"Bt": 1, "L": 512, "D": FULL["mamba_scan"]["D"],
             "N": FULL["mamba_scan"]["N"]}
    f32 = full_inputs_small(torch, model, gen)
    args = [f32[k] for k in ("dt", "x", "A", "B", "C")]
    out["model_f32_ms"] = {"shape": model, "y_and_h_last": time_ms(
        torch, lambda: mamba_scan(*args, chunk=64, return_state=True),
        reps=20, flush=flush)}
    del flush, inputs, f32, args
    torch.cuda.empty_cache()
    return out


def full_inputs_small(torch, s, gen):
    dev = torch.device("cuda")
    seq = (s["Bt"], s["L"], s["D"])
    return {"dt": torch.nn.functional.softplus(
                torch.randn(seq, generator=gen, device=dev)),
            "x": torch.randn(seq, generator=gen, device=dev),
            "A": -torch.exp(torch.randn((s["D"], s["N"]), generator=gen,
                                        device=dev) * 0.3),
            "B": torch.randn((s["Bt"], s["L"], s["N"]), generator=gen,
                             device=dev),
            "C": torch.randn((s["Bt"], s["L"], s["N"]), generator=gen,
                             device=dev)}


def inference_only(path: str, launches: dict) -> None:
    """Serving records no autograd graph: a backward kernel launched on
    ``path`` is a fault."""
    bwd = {b: launches[b] for b in BWD_NAMES.values() if launches[b]}
    if bwd:
        raise AssertionError(f"{path}: backward kernels launched: {bwd}")


def phase_serve(torch, wl, counters, keep: dict) -> dict:
    """The model stack and the server on the card (see the module
    docstring); the served models' weights stay in ``keep``."""
    out = {"phase": "serve", "gpu": nvidia_smi(),
           "tolerance": {"card_cpu": {"rtol": CARD_CPU_RTOL,
                                      "atol_of_max": CARD_CPU_ATOL},
                         "first_logits_bf16_rel_l2": SERVE_BF16_REL_L2}}
    out["scan_state"] = scan_state(torch, wl)
    out["card_against_cpu"] = {a: card_against_cpu(torch, a)
                               for a in SERVE_ARCHS}
    out["server"] = {a: serve_model(torch, a, counters, keep)
                     for a in SERVE_ARCHS}
    out["full_depth_f32"] = {a: full_depth_f32_agreement(torch, a)
                             for a in SERVE_ARCHS}
    out["gevo"] = serve_gevo(torch)
    out["launches"] = {k: sum(m["launches"][k]
                              for m in out["server"].values())
                       for k in counters}
    inference_only("serve", out["launches"])
    emit(out)
    return out


# The router (core/deploy/router.py) on the card.  The main path: the
# served models' weights behind build_router with this genome, on the serve
# phase's trace.  The KV plan's modeled 32 KiB budget clamps each replica
# to the slots that fit at max_len 541 (one); the layouts compared beside
# it are built from engines directly: one engine of 4 slots against two
# replicas of 2, run in turns (one, two, two, one).
ROUTER_GENOME = {"max_slots": 4, "prefill_chunk": 2, "replicas": 2}
ROUTER_LAYOUTS = (("1x4", 1, 4), ("2x2", 2, 2), ("2x2", 2, 2),
                  ("1x4", 1, 4))
# failover: qwen3-0.6b at full width, 2 layers, f32, TF32 off, two
# replicas of 2 slots; replica 0 killed at this tick of the trace's replay
ROUTER_FAILOVER_LAYERS, ROUTER_KILL_TICK = 2, 4
# the router on a launch mesh: qwen3-0.6b at full width, 2 layers, f32,
# TF32 off, one replica of 4 slots over the serve trace, without a mesh and
# on the (1, 1) mesh of a NCCL group of one rank, in turns; then
# launch.serve --mesh 1x1 at full width and depth through its main
ROUTER_MESH_GENOME = {"max_slots": 4, "prefill_chunk": 2, "replicas": 1}
ROUTER_MESH_TURNS = ("plain", "mesh", "mesh", "plain")
ROUTER_MESH_SERVE = ["--arch", "qwen3-0.6b", "--mesh", "1x1", "--requests",
                     "4", "--prompt-len", "64", "--gen", "8"]
# the live loop: the real backend on the card, qwen3-0.6b (its smoke
# config), then 8 A/A canary windows and the served plan
LIVELOOP_RUN = ["--mode", "real", "--ticks", "2", "--pop", "4",
                "--gens-per-tick", "1"]
LIVELOOP_AA_WINDOWS = 8


def layout(cfg, params, replicas: int, slots: int, max_len: int):
    """One engine of ``slots`` slots, or a router over ``replicas`` such
    engines, all on the weights ``params``."""
    from repro_torch.core.deploy import Router, ServeEngine
    engines = [ServeEngine(cfg, params, max_len=max_len, max_slots=slots,
                           prefill_chunk=SERVE_ENGINE["prefill_chunk"],
                           seed=i) for i in range(replicas)]
    return engines[0] if replicas == 1 else Router(engines)


def serving_numbers(stats: dict) -> dict:
    per = stats["per_variant"]["default"]
    return {"tokens_per_s": stats["throughput_tok_s"],
            "mean_ttft_s": per["mean_ttft_s"],
            "s_per_token": per["s_per_token"], "wall_s": stats["wall_s"],
            "ticks": stats["ticks"]}


def router_model(torch, arch: str, counters, model: dict) -> dict:
    """``arch`` at full width and depth in bf16 on the serve phase's
    weights: ``build_router`` on the trace, its launches counted from
    zero, both replicas answering, every request's tokens against the
    single engine's; then one engine of 4 slots against two replicas of 2,
    and the device's idle share over one decode-only router tick."""
    from repro_torch.core.deploy import build_router
    from repro_torch.core.liveloop.traces import demo_requests
    cfg, params = model["cfg"], model["params"]
    max_len = SERVE_TRACE["prompt_len"] + SERVE_TRACE["gen"]
    router = build_router(cfg, params, genome=ROUTER_GENOME,
                          max_len=max_len)
    slots = [r.engine.max_slots for r in router.replicas]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    results = router.run(demo_requests(cfg, **SERVE_TRACE),
                         stagger=SERVE_STAGGER)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    stats = router.stats()
    want_kernels = ("rmsnorm", "flash_attention") if arch.startswith("qwen") \
        else ("rmsnorm", "mamba_scan")
    for k in want_kernels:
        if launches[k] <= 0:
            raise AssertionError(f"{arch}: the router never launched {k}")
    if not all(r["n_completed"] > 0 for r in stats["per_replica"]):
        raise AssertionError(f"{arch}: a replica answered nothing: "
                             f"{stats['per_replica']}")
    single = model["tokens"]
    got = {r.uid: r.tokens for r in results}
    if sorted(got) != sorted(single) or not all(
            len(t) == SERVE_TRACE["gen"]
            and all(0 <= x < cfg.vocab for x in t) for t in got.values()):
        raise AssertionError(f"{arch}: the router answered {got}")
    agree = sum(a == b for u in single for a, b in zip(got[u], single[u]))
    runs = []
    for name, replicas, n_slots in ROUTER_LAYOUTS:
        target = layout(cfg, params, replicas, n_slots, max_len)
        target.run(demo_requests(cfg, **SERVE_TRACE), stagger=SERVE_STAGGER)
        torch.cuda.synchronize()
        runs.append({"layout": name, **serving_numbers(target.stats())})
    idle = decode_idle_share(torch, layout(cfg, params, 2, 2, max_len), cfg,
                             [r.tokens for r in demo_requests(
                                 cfg, **SERVE_TRACE)[:4]])
    del router
    torch.cuda.empty_cache()
    return {"slots_a_replica": slots, "launches": launches,
            "requests": len(results),
            "per_replica_completed": [r["n_completed"]
                                      for r in stats["per_replica"]],
            "token_agreement_with_engine":
                agree / (len(single) * SERVE_TRACE["gen"]),
            "build_router": serving_numbers(stats), "layouts": runs,
            "router_tick": idle}


def router_failover(torch) -> dict:
    """qwen3-0.6b at full width, 2 layers, f32, TF32 off: two replicas of
    2 slots replaying the trace, replica 0 killed at ``ROUTER_KILL_TICK``;
    every request completes with the direct loop's tokens.  Then a launch
    that rmsnorm's C entry refuses (no shared memory granted, so nothing is
    launched and the context stays sound) inside replica 1's step: it must
    leave ``Router.step`` as a DeviceFault with both replicas alive."""
    from collections import deque

    from repro_torch.configs import get_config
    from repro_torch.core.interp import full_f32
    from repro_torch.core.liveloop.traces import demo_requests
    from repro_torch.device import DeviceFault
    from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
    from repro_torch.models import transformer as T
    cfg = get_config("qwen3-0.6b").scaled(n_layers=ROUTER_FAILOVER_LAYERS,
                                          dtype="float32")
    params = T.init_params(cfg, device="cuda")
    max_len = SERVE_TRACE["prompt_len"] + SERVE_TRACE["gen"]
    reqs = demo_requests(cfg, **SERVE_TRACE)
    with full_f32():
        router = layout(cfg, params, 2, 2, max_len)
        pending, tick = deque(reqs), 0
        while pending or router.busy:
            for _ in range(min(SERVE_STAGGER, len(pending))):
                router.submit(pending.popleft())
            if tick == ROUTER_KILL_TICK:
                router.kill_replica(0)
            router.step()
            tick += 1
        got = {r.uid: r.tokens for r in router.completed}
        want = {r.uid: direct_loop(torch, T, cfg, params, r.tokens,
                                   SERVE_TRACE["gen"])[2] for r in reqs}
    if router.n_requeued <= 0 or router.n_live != 1:
        raise AssertionError(f"failover: requeued {router.n_requeued}, "
                             f"live {router.n_live}")
    if got != want:
        raise AssertionError(f"failover: tokens {got} differ from the "
                             f"direct loop's {want}")
    out = {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "dtype": "float32"}, "kill_tick": ROUTER_KILL_TICK,
           "requests": len(got), "requeued": router.n_requeued,
           "ticks": router.n_ticks, "tokens_equal_direct": True}
    router = layout(cfg, params, 2, 2, max_len)
    victim = router.replicas[1].engine
    begin, smem = victim.begin_step, rmsnorm_ops.smem_bytes

    def refused():
        rmsnorm_ops.smem_bytes = lambda *a: 0
        try:
            return begin()
        finally:
            rmsnorm_ops.smem_bytes = smem
    victim.begin_step = refused
    for r in reqs[:4]:
        router.submit(r)
    try:
        router.step()
    except DeviceFault as e:
        out["device_fault"] = f"{type(e).__name__}: {e}"
    else:
        raise AssertionError("a refused launch in a replica's step did not "
                             "leave Router.step")
    if router.n_live != 2 or router.n_requeued:
        raise AssertionError("a device fault failed a replica")
    torch.cuda.synchronize()
    del params, router, victim
    torch.cuda.empty_cache()
    return out


def router_mesh(torch, counters) -> dict:
    """The router's replica placed on the (1, 1) mesh of a NCCL group of
    one rank against the same router without a mesh (``ROUTER_MESH_*``),
    in turns: every request's tokens bit for bit, the same kernel launches
    (counted from zero in each run), s/token both ways (the meshed replica
    serves on its local blocks under the tensor-parallel ``Dist``, made
    once at build: on ``(1, 1)`` the whole tensors, the one-device
    operations, no gather a tick), and every distinct kernel
    call of the meshed runs held against its plain version; then
    ``launch.serve --mesh 1x1`` through its main, which starts and ends a
    group of its own."""
    import tempfile

    import torch.distributed as torch_dist
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import build_router
    from repro_torch.core.interp import full_f32
    from repro_torch.core.liveloop.traces import demo_requests
    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import transformer as T
    cfg = get_config("qwen3-0.6b").scaled(n_layers=ROUTER_FAILOVER_LAYERS,
                                          dtype="float32")
    params = T.init_params(cfg, device="cuda")
    max_len = SERVE_TRACE["prompt_len"] + SERVE_TRACE["gen"]
    runs, calls = [], {}
    with tempfile.TemporaryDirectory() as d:
        init_process_group("cuda", 0, 1, str(Path(d) / "init"))
        try:
            if torch_dist.get_backend() != "nccl":
                raise AssertionError(f"backend {torch_dist.get_backend()}")
            mesh = make_smoke_mesh(1, 1, device_type="cuda")
            with full_f32():
                for turn in ROUTER_MESH_TURNS:
                    router = build_router(
                        cfg, params, genome=ROUTER_MESH_GENOME,
                        max_len=max_len, mesh=mesh if turn == "mesh" else None)
                    hear = [0.0]
                    if turn == "mesh":
                        split_path(router)
                        router._hear = timed_exchange(router._hear, hear)
                    torch.cuda.synchronize()
                    for fn in counters.values():
                        fn.launches = 0
                    with (recorded_calls(calls) if turn == "mesh"
                          else contextlib.nullcontext()):
                        t0 = time.perf_counter()
                        results = router.run(demo_requests(cfg, **SERVE_TRACE),
                                             stagger=SERVE_STAGGER)
                        torch.cuda.synchronize()
                    runs.append({"turn": turn,
                                 "run_s": time.perf_counter() - t0,
                                 "exchange_s": hear[0],
                                 "launches": {k: fn.launches
                                              for k, fn in counters.items()},
                                 "tokens": {r.uid: r.tokens for r in results},
                                 **serving_numbers(router.stats())})
                    del router
        finally:
            torch_dist.destroy_process_group()
    plain = next(r for r in runs if r["turn"] == "plain")
    for r in runs:
        if r["tokens"] != plain["tokens"] or len(r["tokens"]) != len(
                demo_requests(cfg, **SERVE_TRACE)):
            raise AssertionError(f"router mesh: {r['turn']} tokens differ")
        if r["launches"] != plain["launches"]:
            raise AssertionError(f"router mesh: launches {r['launches']} "
                                 f"against {plain['launches']}")
    for k in ("rmsnorm", "flash_attention"):
        if plain["launches"][k] <= 0:
            raise AssertionError(f"router mesh: {k} never launched")
    inference_only("router mesh", plain["launches"])
    held = hold_calls(torch, counters, calls)
    if {r["kernel"] for r in held} != {"rmsnorm", "flash_attention"}:
        raise AssertionError(f"router mesh: held {held}")
    del params
    torch.cuda.empty_cache()
    _, served = captured(serve_main, ROUTER_MESH_SERVE)
    if "requests=4" not in served or "replicas=1/1" not in served \
            or "mesh={'data': 1, 'model': 1}" not in served:
        raise AssertionError(f"router mesh: serve printed {served!r}")
    s_per_token = {t: [r["s_per_token"] for r in runs if r["turn"] == t]
                   for t in ("plain", "mesh")}
    print(f"router mesh s/token: {s_per_token}", flush=True)
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "dtype": "float32", **ROUTER_MESH_GENOME},
            "tokens_equal": True, "launches": plain["launches"],
            "s_per_token": s_per_token,
            "runs": [{k: v for k, v in r.items() if k != "tokens"}
                     for r in runs],
            "held": held, "serve": served.splitlines()}


def timed_exchange(hear, total: list):
    """``MeshRouter._hear`` adding its host seconds to ``total[0]``: the
    per-tick exchange of every rank's outcome, what a meshed router does
    that the plain one does not besides its engine's split path."""
    def timed(record):
        t0 = time.perf_counter()
        try:
            return hear(record)
        finally:
            total[0] += time.perf_counter() - t0
    return timed


def split_path(router) -> None:
    """The meshed replica's engine serves under the tensor-parallel
    ``Dist`` on plain local tensors (weights and lane caches), with its
    placed DTensors only as the record."""
    from torch.distributed.tensor import DTensor
    engine = router.replicas[router.replica].engine.real
    batch = engine.batches["default"]
    if not (engine.dist.tensor_parallel and engine.dist.active) or any(
            isinstance(t, DTensor) for t in [*engine.params.parameters(),
                                             *batch.caches.values()]) \
            or not isinstance(next(router.placed.parameters()), DTensor):
        raise AssertionError("router mesh: the replica does not serve on "
                             "its local blocks")


def phase_router(torch, counters, keep: dict) -> dict:
    """The multi-replica router on the card (see the module docstring)."""
    out = {"phase": "router", "gpu": nvidia_smi(),
           "models": {a: router_model(torch, a, counters, keep[a])
                      for a in SERVE_ARCHS}}
    out["failover"] = router_failover(torch)
    out["mesh"] = router_mesh(torch, counters)
    out["launches"] = {k: sum(m["launches"][k]
                              for m in out["models"].values())
                       for k in counters}
    inference_only("router", out["launches"])
    emit(out)
    return out


def captured(main, argv) -> tuple:
    """``main(argv)`` with its standard output captured: (value, output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = main(argv)
    return value, buf.getvalue()


# the module that calls each kernel's wrapper in the model stack
WRAPPER_SITES = {"rmsnorm": "repro_torch.models.layers",
                 "flash_attention": "repro_torch.models.attention",
                 "mamba_scan": "repro_torch.models.mamba"}


@contextlib.contextmanager
def recorded_calls(calls: dict):
    """While open, the model stack's calls of the kernels' wrappers go
    through as they are, and the first call of each distinct signature
    (kernel, shapes, dtypes, keywords) leaves a copy of its inputs in
    ``calls``."""
    import importlib
    saved = []
    for name, module in WRAPPER_SITES.items():
        mod = importlib.import_module(module)
        wrapper = getattr(mod, name)

        def recording(*args, _name=name, _wrapper=wrapper, **kw):
            key = (_name, " ".join(f"{tuple(a.shape)}:{a.dtype}"
                                   for a in args), repr(sorted(kw.items())))
            if key not in calls:
                calls[key] = ([a.detach().clone() for a in args], kw)
            return _wrapper(*args, **kw)
        saved.append((mod, name, wrapper))
        setattr(mod, name, recording)
    try:
        yield calls
    finally:
        for mod, name, wrapper in saved:
            setattr(mod, name, wrapper)


def hold_calls(torch, counters, calls: dict) -> list:
    """Each recorded call made again on the card: the wrapper (its kernel)
    against the kernel's plain version on the same inputs, at the
    tolerance of its dtype (``ATOL``, ``RTOL``).  Rows of kernel, input
    shapes and dtype, keywords and max |diff|."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_plain
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_plain
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_plain

    def plain(name, args, kw):
        if name == "rmsnorm":
            x, scale = args
            x2 = x.reshape(-1, x.shape[-1])
            br = min(kw.get("block_rows", 128), x2.shape[0])
            return rmsnorm_plain(x2, scale, eps=kw.get("eps", 1e-6),
                                 block_rows=br).reshape(x.shape)
        if name == "flash_attention":
            q, k, v = args
            return flash_attention_plain(
                q, k, v, causal=kw.get("causal", True),
                scale=q.shape[-1] ** -0.5,
                block_q=min(kw.get("block_q", 128), q.shape[2]),
                block_k=min(kw.get("block_k", 128), k.shape[2]))
        return mamba_scan_plain(*args, chunk=min(kw.get("chunk", 64),
                                                 args[1].shape[1]),
                                return_state=kw.get("return_state", False))

    rows = []
    for (name, shapes, kws), (args, kw) in calls.items():
        got, want = counters[name](*args, **kw), plain(name, args, kw)
        got, want = ((got, want) if isinstance(got, torch.Tensor)
                     else (got[0], want[0]))
        dtype_name = str(args[0].dtype).removeprefix("torch.")
        err = check_close(torch, name, f"liveloop call {shapes} {kws}", got,
                          want, dtype_name)
        rows.append({"kernel": name, "inputs": shapes, "keywords": kws,
                     "max_abs_err": err})
    return rows


def _clock_ratios(base: dict, cand: dict) -> dict:
    """A window's candidate / base throughput by each device clock its
    replays carried (``median_by_clock``, each plan's median)."""
    b, c = base.get("median_by_clock", {}), cand.get("median_by_clock", {})
    return {k: c[k] / b[k] for k in b if k in c}


def phase_liveloop(torch, counters) -> dict:
    """The live loop on the card (see the module docstring)."""
    import tempfile

    from repro_torch.configs import smoke_config
    from repro_torch.core.deploy.engine import DEFAULT_SERVE_PLAN
    from repro_torch.core.liveloop import LiveLoopController
    from repro_torch.core.liveloop.__main__ import main as liveloop_main
    from repro_torch.launch.serve import main as serve_main
    out = {"phase": "liveloop", "gpu": nvidia_smi()}
    with tempfile.TemporaryDirectory() as tmp:
        trace, root = f"{tmp}/trace.json", f"{tmp}/loop"
        vocab = smoke_config("qwen3-0.6b").vocab
        calls = {}
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with recorded_calls(calls):
            rc = [captured(liveloop_main, ["synth", "--out", trace,
                                           "--vocab", str(vocab)])[0],
                  captured(liveloop_main, ["run", "--root", root, "--trace",
                                           trace, *LIVELOOP_RUN])[0]]
            torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        out["launches"] = {k: fn.launches for k, fn in counters.items()}
        if rc != [0, 0]:
            raise AssertionError(f"liveloop: synth/run exited {rc}")
        for k in ("rmsnorm", "flash_attention"):
            if out["launches"][k] <= 0:
                raise AssertionError(f"liveloop: the loop never launched {k}")
        inference_only("liveloop", out["launches"])
        # every distinct call the loop made of a wrapper, against the plain
        # version (these launches come after the count was read)
        out["held"] = hold_calls(torch, counters, calls)
        if {r["kernel"] for r in out["held"]} != {"rmsnorm",
                                                   "flash_attention"}:
            raise AssertionError("liveloop: recorded calls of "
                                 f"{sorted({r['kernel'] for r in out['held']})}")
        state = json.load(open(f"{root}/state.json"))
        book = json.load(open(f"{root}/canary.json"))
        if state["tick"] != 2 or state["mode"] != "real":
            raise AssertionError(f"liveloop: state {state}")
        out["state"] = state
        out["canary"] = {k: book[k] for k in ("active", "promoted",
                                              "blocked", "history")}
        ctl = LiveLoopController(root)
        incumbent = ctl.book.promoted
        g = dict(incumbent["genome"] if incumbent else DEFAULT_SERVE_PLAN)
        floor = ctl.book.rails.min_throughput_ratio
        # each window measured the old way (the controller's median of
        # three replays of one plan, then of the other) and as the real
        # loop now measures it on the card (CARD_WINDOW_REPEATS each, in
        # turns, each replay's throughput by busy time); the same replays
        # give the ratio of the medians by busy time and by CUDA events
        windows = {"before": [], "after": [], "after_busy": [],
                   "after_events": []}
        for w in range(LIVELOOP_AA_WINDOWS):
            tr = ctl._window_slice(1000 + w)
            pairs = {"before": (ctl._replay_real(tr, g),
                                ctl._replay_real(tr, g)),
                     "after": ctl.measure(g, g, 1000 + w)}
            for k, (base, cand) in pairs.items():
                windows[k].append({
                    "throughput": cand["throughput_tok_s"]
                    / base["throughput_tok_s"],
                    "ttft": cand["mean_ttft_s"] / base["mean_ttft_s"],
                    "n": base["n"]})
            base, cand = pairs["after"]
            for c, ratio in _clock_ratios(base, cand).items():
                windows[f"after_{c}"].append({"throughput": ratio,
                                              "n": base["n"]})
        out["aa_canary"] = {
            "genome": g, "floor": floor,
            "windows": windows,
            "under_floor": {k: sum(w["throughput"] < floor for w in v)
                            for k, v in windows.items() if v}}
        _, served = captured(serve_main, ["--arch", "qwen3-0.6b",
                                          "--liveloop", root,
                                          "--replicas", "2"])
        if "requests=8" not in served or "replicas=2/2" not in served:
            raise AssertionError(f"liveloop: serve printed {served!r}")
        out["serve"] = served.splitlines()
    emit(out)
    return out


# Training (models/, optim/, train/, launch/train.py) on the card.  The
# backward kernels against their plain versions, |card - plain| <= rtol
# |plain| + atol max(1, max |plain|): in f32 1e-5 / 1e-4 (the same f32
# products summed in other orders, over up to 4096 keys or steps), in bf16
# 2**-7 (one rounding step of the output) / 1e-2 (the forward's bf16 scale).
BWD_NAMES = {"rmsnorm": "rmsnorm_bwd",
             "flash_attention": "flash_attention_bwd",
             "mamba_scan": "mamba_scan_bwd"}
BWD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 1e-2)}
# small ragged shapes: rows, lengths and channels no multiple of the tiles
BWD_SMALL = {
    "rmsnorm": ({"rows": 7, "d": 48}, {"rows": 130, "d": 1024},
                {"rows": 33, "d": 10}),
    "flash_attention": ({"B": 1, "H": 2, "S": 100, "hd": 64, "causal": True},
                        {"B": 2, "H": 1, "S": 96, "hd": 32, "causal": False},
                        {"B": 1, "H": 2, "S": 200, "hd": 128,
                         "causal": True}),
    "mamba_scan": ({"Bt": 2, "L": 24, "D": 40, "N": 4, "chunk": 8},
                   {"Bt": 1, "L": 18, "D": 33, "N": 16, "chunk": 6})}
# full width, timed: the layer norms of a qwen3-0.6b training step (8 x
# 1024 tokens, d 1024) and its attention at 4096 tokens, bf16; the scan at
# falcon-mamba-7b's width in f32, as mamba1 feeds it
BWD_FULL = {"rmsnorm": ({"rows": 8192, "d": 1024}, "bfloat16"),
            "flash_attention": ({"B": 1, "H": 16, "S": 4096, "hd": 128,
                                 "causal": True}, "bfloat16"),
            "mamba_scan": ({"Bt": 1, "L": 4096, "D": 8192, "N": 16,
                            "chunk": 64}, "float32")}
# the other shapes the training runs give each kernel, checked and timed:
# qwen3-0.6b's q/k norms (8 x 1024 tokens x 16 heads of 128) and
# falcon-mamba-7b's norms (2 x 2048 tokens, d 4096), bf16; qwen3-0.6b's
# attention (8 x 16 heads x 1024); falcon-mamba-7b's scan (2 x 2048)
BWD_PATH = {"rmsnorm": (({"rows": 131072, "d": 128}, "bfloat16"),
                        ({"rows": 4096, "d": 4096}, "bfloat16")),
            "flash_attention": (({"B": 8, "H": 16, "S": 1024, "hd": 128,
                                  "causal": True}, "bfloat16"),),
            "mamba_scan": (({"Bt": 2, "L": 2048, "D": 8192, "N": 16,
                             "chunk": 64}, "float32"),)}
# the training runs through launch.train's main: qwen3-0.6b at full width
# and depth; falcon-mamba-7b at full width cut to 4 of 64 layers (AdamW's
# f32 moments of 7B parameters do not fit 80 GB beside the weights)
TRAIN_RUNS = {
    "qwen3-0.6b": ["--arch", "qwen3-0.6b", "--batch", "8", "--seq", "1024",
                   "--steps", "30", "--log-every", "10"],
    "falcon-mamba-7b": ["--arch", "falcon-mamba-7b", "--scale",
                        "n_layers=4", "--batch", "2", "--seq", "2048",
                        "--steps", "20", "--log-every", "10"]}
TRAIN_RESUME = ["--arch", "qwen3-0.6b", "--scale", "n_layers=2", "--batch",
                "2", "--seq", "256", "--lr", "1e-3", "--log-every", "100"]
TRAIN_CARD_CPU = {"batch": 1, "seq": 100}
# The same 2-layer gradients in bf16 (the training runs' dtype: bf16
# weights rounded from the f32 ones, the bf16 kernels) against the f32
# card's, leaf by leaf, |g16 - g32| / |g32| in L2 at most 0.1: the serve
# phase's limit for bf16 logits, some 50 times bf16's unit roundoff
# (2**-9), where a gradient that drops a term or a tile of a kernel's
# output, or scales it wrongly, is off by O(1); the loss within 1e-2
# relative (a few roundings of logits in bf16).
TRAIN_BF16_REL_L2, TRAIN_BF16_LOSS_RTOL = 0.1, 1e-2


def flash_tile(S: int, causal: bool) -> tuple[int, int]:
    """The forward kernel's (tile, padded length) for S keys: the model's
    rule (``attention_tiles``) when causal; else the largest bf16 block_k
    up to 128 that divides S, unpadded."""
    from types import SimpleNamespace

    from repro_torch.kernels.flash_attention.flash_attention import \
        BF16_BLOCK_K
    from repro_torch.models.attention import attention_tiles
    if causal:
        cfg = SimpleNamespace(attn_impl="naive", attn_block=128, causal=True)
        return attention_tiles(cfg, S, None)
    return next(t for t in sorted(BF16_BLOCK_K, reverse=True)
                if t <= 128 and S % t == 0), S


def bwd_inputs(torch, kernel, s, dtype, gen, *, full: bool = False):
    """Seeded inputs of a backward kernel on the card, with the forward
    outputs it needs made by the forward kernel as the model makes them
    (flash's o and lse on inputs padded at the end to the tile when
    causal, cut back; the scan's tile-start states), and an output
    gradient.  The forward's new outputs are held against the plain
    forward's (o at the forward's tolerance, at full width ``FULL_ATOL``;
    lse and the states at the f32 ``BWD_TOL``), and the outputs it had
    before must keep their bits when they are asked for.  Returns (inputs,
    the forward's max |diff| by output)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import _launch
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_plain
    from repro_torch.kernels.mamba_scan.ops import _forward as scan_forward
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)

    def rnd(*shape, d=dt):
        return torch.randn(shape, generator=gen, device=dev).to(d)

    if kernel == "rmsnorm":
        # the scale in the model's dtype, as its norm weights are
        return {"x": rnd(s["rows"], s["d"]), "scale": rnd(s["d"]),
                "dy": rnd(s["rows"], s["d"])}, {}
    if kernel == "flash_attention":
        S, causal = s["S"], s["causal"]
        shape = (s["B"], s["H"], S, s["hd"])
        q, k, v, do = (rnd(*shape) for _ in range(4))
        scale = s["hd"] ** -0.5
        tile, Sp = flash_tile(S, causal)
        pad = [torch.nn.functional.pad(t, (0, 0, 0, Sp - S)).contiguous()
               for t in (q, k, v)]
        kw = dict(causal=causal, scale=scale, block_q=tile, block_k=tile)
        o, lse = _launch(*pad, **kw, want_lse=True)
        if not torch.equal(o, _launch(*pad, **kw, want_lse=False)):
            raise AssertionError(f"flash_attention {s} {dtype}: o changed "
                                 "with lse requested")
        o, lse = o[:, :, :S].contiguous(), lse[:, :, :S].contiguous()
        blk = 128 if S % 128 == 0 else S
        o_plain, lse_plain = flash_attention_plain(
            q, k, v, causal=causal, scale=scale, block_q=blk, block_k=blk,
            return_lse=True)
        fwd = {"o": check_close(torch, "flash_attention",
                                f"forward with lse {s}", o, o_plain, dtype,
                                atol=FULL_ATOL["flash_attention"] if full
                                else None),
               "lse": within(torch, lse, lse_plain, *BWD_TOL["float32"])}
        return {"q": q, "k": k, "v": v, "o": o, "do": do, "lse": lse,
                "causal": causal, "scale": scale}, fwd
    seq = (s["Bt"], s["L"], s["D"])
    i = {"dt": torch.nn.functional.softplus(
             torch.randn(seq, generator=gen, device=dev)).to(dt),
         "x": rnd(*seq), "dy": rnd(*seq),
         "A": -torch.exp(torch.randn((s["D"], s["N"]), generator=gen,
                                     device=dev) * 0.3),
         "B": rnd(s["Bt"], s["L"], s["N"]), "C": rnd(s["Bt"], s["L"], s["N"]),
         "dh": rnd(s["Bt"], s["D"], s["N"], d=torch.float32),
         "chunk": s["chunk"]}
    ins = [i[n] for n in ("dt", "x", "A", "B", "C")]
    y, h, i["hc"] = scan_forward(*ins, chunk=s["chunk"], return_state=True,
                                 return_chunks=True)
    y0, h0 = scan_forward(*ins, chunk=s["chunk"], return_state=True,
                          return_chunks=False)
    if not (torch.equal(y, y0) and torch.equal(h, h0)):
        raise AssertionError(f"mamba_scan {s} {dtype}: y or h_last changed "
                             "with the chunk states requested")
    _, _, hc_plain = mamba_scan_plain(*ins, chunk=s["chunk"],
                                      return_state=True, return_chunks=True)
    return i, {"h_chunks": within(torch, i["hc"], hc_plain,
                                  *BWD_TOL["float32"])}


def run_bwd(kernel, i, *, plain: bool) -> tuple:
    """The backward kernel (or its plain version) on ``i``."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_bwd_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.mamba_scan.mamba_scan import \
        mamba_scan_bwd_plain
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_bwd
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd_plain
    if kernel == "rmsnorm":
        fn = rmsnorm_bwd_plain if plain else rmsnorm_bwd
        return fn(i["x"], i["scale"], i["dy"], eps=1e-6)
    if kernel == "flash_attention":
        fn = flash_attention_bwd_plain if plain else flash_attention_bwd
        return fn(i["q"], i["k"], i["v"], i["o"], i["do"], i["lse"],
                  causal=i["causal"], scale=i["scale"])
    fn = mamba_scan_bwd_plain if plain else mamba_scan_bwd
    return fn(i["dt"], i["x"], i["A"], i["B"], i["C"], i["dy"], i["hc"],
              i["dh"], chunk=i["chunk"])


def bwd_check(torch, kernel, i, dtype) -> float:
    """The kernel against its plain version on ``i`` within BWD_TOL (f32
    tolerances for the f32 outputs: the scan's dA), and the same bits from
    a second call; the largest |diff|."""
    got, want = run_bwd(kernel, i, plain=False), run_bwd(kernel, i,
                                                          plain=True)
    again = run_bwd(kernel, i, plain=False)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{BWD_NAMES[kernel]} ({dtype}): two calls "
                             "gave other bits")
    errs = []
    for g, w in zip(got, want):
        name = "float32" if w.dtype == torch.float32 else dtype
        errs.append(within(torch, g, w, *BWD_TOL[name]))
    return max(errs)


def bwd_library_call(torch, kernel, i):
    """One PyTorch call computing the same gradient, or None: the
    backward of ``F.rms_norm``, of SDPA."""
    F = torch.nn.functional
    if kernel == "rmsnorm":
        x = i["x"].detach().requires_grad_()
        w = i["scale"].to(x.dtype).detach().requires_grad_()
        y = F.rms_norm(x, (x.shape[-1],), w, 1e-6)
        return lambda: torch.autograd.grad(y, (x, w), i["dy"],
                                           retain_graph=True)
    if kernel == "flash_attention":
        q, k, v = (i[n].detach().requires_grad_() for n in "qkv")
        o = F.scaled_dot_product_attention(q, k, v, is_causal=i["causal"])
        return lambda: torch.autograd.grad(o, (q, k, v), i["do"],
                                           retain_graph=True)
    return None


def bwd_library_err(torch, kernel, i) -> float:
    """The library call's own largest |diff| from the plain version on
    ``i``: SDPA's backward, which in bf16 rounds P to bf16 too, beside the
    kernel's, shows what a tensor-core backward costs in accuracy.
    Reported, not held to a limit."""
    got = bwd_library_call(torch, kernel, i)()
    want = run_bwd(kernel, i, plain=True)
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


# the backward kernels redesigned with registers and shared memory in mind:
# ptxas must report no spill for any instantiation
BWD_REGISTER_KERNELS = {"mamba_scan": "scan_bwd_kernel",
                        "rmsnorm": "rmsnorm_bwd_row_kernel"}
# rounds of 20 timed calls of a library call's backward (F.rms_norm's,
# SDPA's), whose event time moved 1.4-9x between runs of the same code:
# the row's library_ms is the median of the rounds' spin-held times
LIBRARY_ROUNDS = 3


def bwd_resources(torch) -> dict:
    """For the scan's and rmsnorm's backward kernels: registers and spills
    of every instantiation (``ptxas -v``); at each shape the training runs
    and full width give them, the threads and dynamic shared memory of a
    block and the blocks (and so warps) an SM holds at once, by the CUDA
    occupancy API.  Raise on a spill."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan.mamba_scan import (
        mamba_scan_bwd_geometry, mamba_scan_bwd_occupancy)
    from repro_torch.kernels.rmsnorm.rmsnorm import (rmsnorm_bwd_geometry,
                                                     rmsnorm_bwd_occupancy)
    out = {}
    for name, kern in BWD_REGISTER_KERNELS.items():
        log = build.library_path(name).with_suffix(".log").read_text()
        rows = {r["kernel"]: {k: r[k] for k in ("registers", "spill_stores",
                                                 "spill_loads")}
                for r in ptxas_report(log) if kern in r["kernel"]}
        bad = {k: r for k, r in rows.items()
               if r["spill_stores"] or r["spill_loads"]}
        if not rows or bad:
            raise AssertionError(f"{BWD_NAMES[name]}: {len(rows)} "
                                 f"instantiations, spills: {bad}")
        shapes = []
        for s, dtype in (*BWD_PATH[name], BWD_FULL[name]):
            dt = getattr(torch, dtype)
            if name == "mamba_scan":
                geo = mamba_scan_bwd_geometry(s, dt)
                occ = mamba_scan_bwd_occupancy(s["N"], dt)
                per_sm = occ["blocks_per_sm"]
            else:
                geo = rmsnorm_bwd_geometry(s["rows"], s["d"], dt)
                per_sm = rmsnorm_bwd_occupancy(s["d"], dt, dt)
                occ = {"blocks_per_sm": per_sm}
            shapes.append({"shape": s, "dtype": dtype,
                           "threads": geo["threads"], "smem": geo["smem"],
                           **occ,
                           "warps_per_sm": per_sm * geo["threads"] // 32})
        out[BWD_NAMES[name]] = {"ptxas": rows, "shapes": shapes}
    return out


def bwd_bound(kernel, s, dtype, rates) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, operations) of one backward call, from
    ``kernels.costs``' count: each input read once (the forward's outputs
    it takes among them, and the last state's gradient for the scan),
    each output written once (the scale and its gradient in the input's
    dtype); the operations the gradient needs (flash: the five products
    of FA2's backward over the causal half, 10 hd a pair; rmsnorm ~10 and
    the scan ~13 f32 operations an element)."""
    import torch

    from repro_torch.kernels import costs
    dt = getattr(torch, dtype)
    if kernel == "rmsnorm":
        cost = costs.rmsnorm_bwd_cost(rows=s["rows"], d=s["d"], dtype=dt,
                                      scale_dtype=dt)
    elif kernel == "flash_attention":
        cost = costs.flash_attention_bwd_cost(
            B=s["B"], H=s["H"], S=s["S"], hd=s["hd"], dtype=dt,
            causal=s["causal"])
    else:
        cost = costs.mamba_scan_bwd_cost(
            Bt=s["Bt"], L=s["L"], D=s["D"], N=s["N"], dtype=dt,
            chunk=s["chunk"])
    rate = rates["bf16"] if cost.matmul and dtype == "bfloat16" \
        else rates["f32"]
    return bound_of(cost, rate, rates)


def train_kernels(torch) -> dict:
    """(a): each backward kernel against its plain version at the small
    ragged shapes in f32 and bf16, at the main path's shapes and at full
    width, on inputs the forward kernel made, two calls the same bits; in
    bf16 flash also SDPA's backward's own error; at full width and at
    the training runs' shapes its time (also with the host held out), the
    plain version's, the library call's and the bound."""
    rates = device_rates()
    gen = torch.Generator(device="cuda").manual_seed(20)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}

    def case(kernel, s, dtype, full=False):
        i, fwd = bwd_inputs(torch, kernel, s, dtype, gen, full=full)
        row = {"shape": s, "dtype": dtype, "forward_max_abs_err": fwd,
               "max_abs_err": bwd_check(torch, kernel, i, dtype)}
        if kernel == "flash_attention" and dtype == "bfloat16":
            row["library_max_abs_err"] = bwd_library_err(torch, kernel, i)
        return i, row

    def timed(kernel, i, s, dtype) -> dict:
        def call():
            return run_bwd(kernel, i, plain=False)
        ms = time_ms(torch, call, reps=20, flush=flush)
        plain_ms = time_ms(torch, lambda: run_bwd(kernel, i, plain=True),
                           reps=1 if kernel == "mamba_scan" else 3,
                           flush=flush)
        row = {"kernel_ms": ms, "plain_ms": plain_ms,
               "kernel_spin_ms": spin_ms(torch, call, reps=20, flush=flush),
               "library_ms": None}
        lib = bwd_library_call(torch, kernel, i)
        if lib is not None:
            # the library call's device time alone: timed as the kernel
            # is, its events also hold autograd's host work (~0.3 ms)
            rounds = [spin_ms(torch, lib, reps=20, flush=flush)
                      for _ in range(LIBRARY_ROUNDS)]
            row.update(library_ms=statistics.median(rounds),
                       library_rounds_ms=rounds,
                       library_event_ms=time_ms(torch, lib, reps=20,
                                                flush=flush))
        bound_ms, bound_by, nbytes, ops = bwd_bound(kernel, s, dtype, rates)
        return {**row, "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "operations": ops}

    for kernel, name in BWD_NAMES.items():
        checked = [case(kernel, s, dtype)[1] for s in BWD_SMALL[kernel]
                   for dtype in ("float32", "bfloat16")]
        for s, dtype in BWD_PATH[kernel]:  # what a training step calls
            i, row = case(kernel, s, dtype, full=True)
            row.update(timed(kernel, i, s, dtype))
            checked.append(row)
            del i
            torch.cuda.empty_cache()
        s, dtype = BWD_FULL[kernel]
        i, row = case(kernel, s, dtype, full=True)
        out[name] = {"checked": checked, **row, **timed(kernel, i, s, dtype)}
        del i
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


def train_card_against_cpu(torch, arch: str, counters) -> dict:
    """(b): the loss and every gradient of ``arch`` at full width, 2
    layers, f32, TF32 off, on the card against the CPU (same weights, a
    ragged 100-token batch: flash pads to its tile, the scan to its
    chunk), with the serve phase's card-against-CPU tolerance; the card's
    backward kernels launched."""
    import copy

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.interp import full_f32
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import loss_and_grads
    cfg = get_config(arch).scaled(n_layers=CARD_CPU_LAYERS, dtype="float32")
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(0)
    shape = (TRAIN_CARD_CPU["batch"], TRAIN_CARD_CPU["seq"])
    b = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(cfg, cpu, b)
    cpu_s = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    with full_f32():
        got_loss, got = loss_and_grads(cfg, card, b)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    want_k = ("rmsnorm", "flash_attention") if arch.startswith("qwen") \
        else ("rmsnorm", "mamba_scan")
    for k in want_k:
        if not launches[k] or not launches[BWD_NAMES[k]]:
            raise AssertionError(f"{arch}: a gradient on the card did not "
                                 f"launch {k} and {BWD_NAMES[k]}")
    errs = {"loss": within(torch, got_loss, want_loss, CARD_CPU_RTOL,
                           CARD_CPU_ATOL)}
    worst = max((within(torch, got[n], want[n], CARD_CPU_RTOL,
                        CARD_CPU_ATOL), n) for n in want)
    errs["grad_max_abs_err"], errs["grad_worst_leaf"] = worst
    want_names = sorted(want)
    del cpu, want
    errs["bf16"] = bf16_against_f32(torch, arch, cfg, card, b, got_loss, got,
                                    counters, want_k)
    del card, got
    torch.cuda.empty_cache()
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "vocab": cfg.vocab, "dtype": "float32"},
            "tokens": shape, "gradients": len(want_names),
            "launches": launches, "cpu_s": cpu_s, **errs}


def bf16_against_f32(torch, arch, cfg, card, b, loss32, grads32, counters,
                     want_k) -> dict:
    """The loss and gradients of ``card``'s weights rounded to bf16 (the
    leaves the model keeps in f32 stay so) against the f32 card's, within
    ``TRAIN_BF16_REL_L2`` and ``TRAIN_BF16_LOSS_RTOL``; the bf16 backward
    kernels launched."""
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import loss_and_grads
    cfg16 = cfg.scaled(dtype="bfloat16")
    model = T.init_params(cfg16, device="cuda")
    f32 = dict(card.named_parameters())
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(f32[n])
    for fn in counters.values():
        fn.launches = 0
    loss, grads = loss_and_grads(cfg16, model, b)
    torch.cuda.synchronize()
    for k in want_k:
        if not counters[BWD_NAMES[k]].launches:
            raise AssertionError(f"{arch} bf16: no launch of {BWD_NAMES[k]}")
    loss_rel = abs(float(loss) - float(loss32)) / abs(float(loss32))
    rel = {}
    for n, g32 in grads32.items():
        g = grads[n].float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{arch} bf16: gradient {n} not finite")
        norm = float(g32.norm())
        rel[n] = float((g - g32).norm()) / norm if norm else float(g.norm())
    worst = max(rel, key=rel.get)
    if not (loss_rel <= TRAIN_BF16_LOSS_RTOL
            and rel[worst] <= TRAIN_BF16_REL_L2):
        raise AssertionError(f"{arch} bf16 against f32: loss {loss_rel:.3e} "
                             f"relative, gradient {worst} {rel[worst]:.3e} "
                             f"(relative L2): {rel}")
    del model, grads
    return {"loss_rel": loss_rel, "grad_rel_l2": rel,
            "grad_worst_leaf": worst}


def expected_train_launches(cfg) -> dict:
    """Forward (and, as many, backward) launches of each kernel a training
    step of ``cfg`` makes: rmsnorm at each layer's norms and the final
    one, flash once an attention layer, the scan once a mamba1 layer (with
    ``remat="full"`` the forwards of a checkpointed body run twice)."""
    if cfg.family == "ssm":
        return {"rmsnorm": cfg.n_layers + 1, "flash_attention": 0,
                "mamba_scan": cfg.n_layers}
    if cfg.family == "hybrid":  # a mamba2 layer: its norm and gated norm;
        G = cfg.n_layers // cfg.attn_every  # the shared block's two, flash
        return {"rmsnorm": 2 * cfg.n_layers + 2 * G + 1,
                "flash_attention": G, "mamba_scan": 0}
    if cfg.mla:  # the q and kv norms; the attention is torch ops
        return {"rmsnorm": 4 * cfg.n_layers + 1, "flash_attention": 0,
                "mamba_scan": 0}
    per = 2 + (2 if cfg.qk_norm else 0)
    return {"rmsnorm": cfg.n_layers * per + 1,
            "flash_attention": cfg.n_layers, "mamba_scan": 0}


def train_run(torch, arch: str, counters) -> dict:
    """(c) and (d): ``launch.train``'s main on the card, its launches
    counted from zero; falling loss, the launches a step the layer count
    implies, s/step, tokens/s, peak memory, the idle share of one more
    step."""
    import numpy as np
    from repro_torch.launch import train as L
    argv = TRAIN_RUNS[arch]
    stamps = []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res, printed = captured(lambda a: L.main(a, on_step=on_step), argv)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg, steps = res["cfg"], len(res["losses"])
    losses = res["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch}: losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"{arch}: the loss did not fall ({first} -> "
                             f"{last}): {losses}")
    want = expected_train_launches(cfg)
    for k, n in want.items():
        for name in (k, BWD_NAMES[k]):
            if launches[name] != n * steps:
                raise AssertionError(f"{arch}: {launches[name]} launches of "
                                     f"{name} in {steps} steps, the layers "
                                     f"imply {n} a step")
    step_s = np.diff([t0] + stamps)
    steady = float(np.median(step_s[1:]))
    B, S = res["batch"](0)["labels"].shape
    idle = idle_share(torch, lambda: res["step_fn"](res["state"],
                                                    res["batch"](steps)))
    del res
    torch.cuda.empty_cache()
    return {"argv": argv, "config": {"n_layers": cfg.n_layers,
                                     "d_model": cfg.d_model,
                                     "vocab": cfg.vocab, "dtype": cfg.dtype},
            "steps": steps, "losses": losses, "first5": first,
            "last5": last, "first_step_s": float(step_s[0]),
            "s_per_step": steady, "tokens_per_s": B * S / steady,
            "peak_allocated_bytes": peak, "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "step": idle, "printed": printed.splitlines()[-3:]}


def train_resume(torch) -> dict:
    """(e): 6 steps straight against 3, a checkpoint, a restore into a
    fresh run and 3 more, all through ``launch.train``'s main: the
    parameters and losses bit for bit."""
    import tempfile

    from repro_torch.launch import train as L
    straight, _ = captured(L.main, TRAIN_RESUME + ["--steps", "6"])
    with tempfile.TemporaryDirectory() as d:
        captured(L.main, TRAIN_RESUME + ["--steps", "3", "--ckpt", d])
        resumed, printed = captured(L.main, TRAIN_RESUME + [
            "--steps", "6", "--ckpt", d, "--ckpt-every", "100"])
    if resumed["start"] != 3 or "resumed from step 3" not in printed:
        raise AssertionError(f"resume: {printed!r}")
    a = dict(straight["state"]["params"].named_parameters())
    unequal = [n for n, p in resumed["state"]["params"].named_parameters()
               if not torch.equal(p, a[n])]
    if unequal or resumed["losses"] != straight["losses"][3:]:
        raise AssertionError(f"resume: parameters {unequal[:4]} or losses "
                             f"{resumed['losses']} against "
                             f"{straight['losses'][3:]}")
    n = sum(p.numel() for p in a.values())
    del straight, resumed, a
    torch.cuda.empty_cache()
    return {"argv": TRAIN_RESUME, "parameters": n,
            "bit_identical_after_resume": True}


def phase_train(torch, counters) -> dict:
    """Training on the card (see the module docstring); ``counters`` holds
    the three forward wrappers and the three backward ones."""
    out = {"phase": "train", "gpu": nvidia_smi(),
           "tolerance": {"bwd": BWD_TOL,
                         "card_cpu": {"rtol": CARD_CPU_RTOL,
                                      "atol_of_max": CARD_CPU_ATOL},
                         "bf16_f32": {"grad_rel_l2": TRAIN_BF16_REL_L2,
                                      "loss_rtol": TRAIN_BF16_LOSS_RTOL}}}
    out["kernels"] = train_kernels(torch)
    out["bwd_resources"] = bwd_resources(torch)
    out["card_against_cpu"] = {a: train_card_against_cpu(torch, a, counters)
                               for a in SERVE_ARCHS}
    out["runs"] = {a: train_run(torch, a, counters) for a in TRAIN_RUNS}
    out["resume"] = train_resume(torch)
    out["launches"] = {k: sum(r["launches"][k] for r in out["runs"].values())
                       for k in counters}
    emit(out)
    return out


# The mesh (launch/mesh.py, launch/shardings.py, the sharded train step):
# a NCCL group of one rank and its (1, 1) mesh.  (a) the sharded step
# against the one-device step, AdamW from the same seed and batch, bit
# for bit: qwen3-0.6b at full width and depth, falcon-mamba-7b at full
# width cut to 4 of 64 layers as in the train phase; the two steps run one
# after the other.  (b) granite-moe-3b-a800m at full width, 4 of 32
# layers: the prefill through Dist's expert-parallel path (capacity factor
# 48 / 8 = 6, which drops nothing) against moe_dense in f32, TF32 off,
# within the serve phase's card-against-CPU limit; then launch.train
# --mesh smoke, bf16, through the EP path (capacity factor 1.25, the
# reference's).  (c) the compressed step on one rank (qwen3-0.6b, 2
# layers): the residual x - deq exactly, the parameters within 0.05 of
# each leaf's largest value of the exact step's (the reference's bound).
MESH_BITWISE = {"qwen3-0.6b": {"n_layers": 28, "batch": 4, "seq": 1024},
                "falcon-mamba-7b": {"n_layers": 4, "batch": 2, "seq": 1024}}
# (e) every other family's (1, 1) tensor-parallel step against its
# unsharded step, bit for bit, at full width, depth cut to fit the card
# and the run's time: qwen2-vl-72b 2 of 80 layers (4.3B parameters, M-RoPE,
# q/k/v biases; SGD, as AdamW's f32 moments and update temporaries of its
# 1.25B-parameter embedding and head ran out of the card's memory),
# hubert-xlarge 4 of 48 (non-causal, head dim 80, frame
# embeddings), granite-moe-3b-a800m 4 of 32 through the expert-parallel
# branch as the granite train run takes it, zamba2-1.2b 7 of 38 (one group
# of 6 mamba2 layers with the shared block, one trailing layer) and
# deepseek-v3-671b 1 of 61 (13.4B parameters: MLA, moe_dense over its 256
# experts and the shared expert, SGD without momentum so that weights and
# gradients alone take the card, 27 GB each in bf16; the unsharded result
# kept on the host)
MESH_FAMILIES = {
    "qwen2-vl-72b": {"n_layers": 2, "batch": 2, "seq": 1024, "opt": "sgd"},
    "hubert-xlarge": {"n_layers": 4, "batch": 4, "seq": 1024},
    "granite-moe-3b-a800m": {"n_layers": 4, "batch": 4, "seq": 1024,
                             "ep": True},
    "zamba2-1.2b": {"n_layers": 7, "batch": 2, "seq": 1024},
    "deepseek-v3-671b": {"n_layers": 1, "batch": 1, "seq": 512,
                         "opt": "sgd", "overrides": {"moe_mode": "dense"}}}
MESH_GRANITE_PREFILL = {"n_layers": 4, "batch": 2, "seq": 512}
MESH_GRANITE_TRAIN = ["--arch", "granite-moe-3b-a800m", "--scale",
                      "n_layers=4", "--batch", "4", "--seq", "1024",
                      "--steps", "4", "--log-every", "1", "--mesh", "smoke"]
MESH_COMPRESSED = {"arch": "qwen3-0.6b", "n_layers": 2, "batch": 4,
                   "seq": 512, "lr": 0.05, "rel": 0.05}


def timed_step(torch, step, state, b) -> float:
    """The host time of one more ``step`` on ``state``, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, b)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def plain_sgd(lr: float):
    """SGD without momentum, in place (no state and no temporary:
    deepseek's one full-width layer, 13.4B parameters in bf16, and
    qwen2-vl's two, hold their weights and gradients on the card and
    little more)."""
    from repro_torch.optim.optimizers import Optimizer

    def update(grads, state, params, step):
        import torch
        with torch.no_grad():
            for k, p in params.items():
                p.add_(grads[k], alpha=-lr)
        return params, state

    return Optimizer(lambda params: {}, update, 0.0)


def mesh_sharded_against_unsharded(torch, arch: str, mesh, counters) -> dict:
    """(a) and (e) for one arch (``MESH_BITWISE``, ``MESH_FAMILIES``): loss,
    gradient norm and every parameter after one step, the tensor-parallel
    step on ``mesh`` against the unsharded step (for the expert-parallel
    branch the same ``Dist`` step on whole parameters, since the one-device
    step takes ``moe_dense``), bit for bit, compared a parameter at a time
    on the host; the sharded step's launches counted from zero; the time
    of a second step of each."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.shardings import (distribute, gather,
                                              param_specs, to_shardings)
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainState, make_train_step
    run = {**MESH_BITWISE, **MESH_FAMILIES}[arch]
    cfg = get_config(arch).scaled(n_layers=run["n_layers"],
                                  **run.get("overrides", {}))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=run["seq"],
                         global_batch=run["batch"])
    b = device_batch(cfg, pipe, 0, "cuda")

    def fresh():
        return T.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")

    opt = plain_sgd(1e-3) if run.get("opt") == "sgd" else adamw(lr=3e-4)
    dist = T.Dist(mesh=mesh)
    params = fresh()
    state = TrainState(params, opt.init(dict(params.named_parameters())))
    step = make_train_step(cfg, opt, dist if run.get("ep") else T.Dist())
    state, m = step(state, b)
    want = {n: p.detach().to("cpu", copy=True) for n, p in
            state["params"].named_parameters()}
    want_m = {k: v.detach().to("cpu", copy=True) for k, v in m.items()}
    unsharded_s = timed_step(torch, step, state, b)
    del state, params, m
    torch.cuda.empty_cache()

    params = fresh()
    params = distribute(params, to_shardings(mesh, param_specs(params, mesh)))
    opt_state = opt.init(dict(params.named_parameters()))
    opt_state = distribute(opt_state, to_shardings(
        mesh, param_specs(opt_state, mesh)))
    state = TrainState(params, opt_state)
    step = make_train_step(cfg, opt, dist)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    state, m = step(state, b)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    unequal = [n for n, p in gather(state["params"]).items()
               if not torch.equal(p.cpu(), want[n])]
    for k in ("loss", "grad_norm"):
        if not torch.equal(m[k].cpu(), want_m[k]):
            unequal.append(k)
    if unequal:
        raise AssertionError(f"{arch}: the (1, 1) sharded step differs from "
                             f"the unsharded one in {unequal[:6]}")
    if cfg.remat == "full":
        remat_launches(cfg, launches)
    else:
        for k, n in expected_train_launches(cfg).items():
            for name in (k, BWD_NAMES[k]):
                if launches[name] != n:
                    raise AssertionError(
                        f"{arch}: {launches[name]} launches of {name} in "
                        f"the sharded step, the layers imply {n}")
    n_params = sum(p.numel() for p in want.values())
    out = {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                      "vocab": cfg.vocab, "dtype": cfg.dtype,
                      "family": cfg.family, "moe_mode": cfg.moe_mode,
                      "remat": cfg.remat,
                      "optimizer": run.get("opt", "adamw")},
           "cut": f"{cfg.n_layers} of {get_config(arch).n_layers} layers",
           "parameters": n_params,
           "unsharded_step": "the Dist step on whole parameters"
           if run.get("ep") else "the one-device step",
           "tokens": [run["batch"], run["seq"]],
           "parameters_compared": len(want), "bit_identical": True,
           "loss": float(want_m["loss"]),
           "grad_norm": float(want_m["grad_norm"]),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "second_step_s": {"unsharded": unsharded_s,
                             "sharded": timed_step(torch, step, state, b)},
           "placements": sorted({str(p.placements) for p in
                                 state["params"].parameters()}),
           "launches": launches}
    del state, params, m, want
    torch.cuda.empty_cache()
    return out


def mesh_granite_prefill(torch, mesh, counters) -> dict:
    """(b), first half: granite's prefill through the EP path against
    moe_dense, f32, TF32 off, every rmsnorm and flash launched."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.interp import full_f32
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import expert_pad
    run = MESH_GRANITE_PREFILL
    cfg = get_config("granite-moe-3b-a800m").scaled(
        n_layers=run["n_layers"], dtype="float32")
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    b = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (run["batch"], run["seq"])).astype(np.int32),
        device="cuda")}
    cf = expert_pad(cfg, cfg.expert_shards) / cfg.top_k
    with full_f32():
        want, _ = T.prefill(params, b, cfg)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got, _ = T.prefill(params, b, cfg, T.Dist(mesh=mesh,
                                                  capacity_factor=cf))
        torch.cuda.synchronize()
        ep_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in expected_train_launches(cfg).items():
        if launches[k] != n or launches[BWD_NAMES[k]]:
            raise AssertionError(f"granite prefill: {launches[k]} launches of "
                                 f"{k} (the layers imply {n}), "
                                 f"{launches[BWD_NAMES[k]]} backward")
    err = within(torch, got, want, CARD_CPU_RTOL, CARD_CPU_ATOL)
    del params
    torch.cuda.empty_cache()
    return {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "experts_padded": expert_pad(cfg, cfg.expert_shards),
                       "top_k": cfg.top_k, "head_dim": cfg.hd,
                       "dtype": "float32"},
            "cut": f"{cfg.n_layers} of 32 layers",
            "tokens": [run["batch"], run["seq"]], "capacity_factor": cf,
            "logits_max_abs_err_vs_dense": err, "ep_prefill_s": ep_s,
            "tolerance": {"rtol": CARD_CPU_RTOL, "atol_of_max": CARD_CPU_ATOL},
            "launches": launches}


def mesh_granite_train(torch, counters) -> dict:
    """(b), second half: ``launch.train --mesh smoke`` on the card (its own
    NCCL group of one rank): s/step, tokens/s, peak memory and launches a
    step of the EP train step."""
    import numpy as np
    from repro_torch.launch import train as L
    stamps = []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res, printed = captured(lambda a: L.main(a, on_step=on_step),
                            MESH_GRANITE_TRAIN)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg, steps, losses = res["cfg"], len(res["losses"]), res["losses"]
    if cfg.moe_mode != "ep_a2a" or not res["dist"].active:
        raise AssertionError("granite's mesh run did not take the EP path")
    if "mesh={'data': 1, 'model': 1}" not in printed \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"granite mesh run: {printed[-400:]}")
    for k, n in expected_train_launches(cfg).items():
        for name in (k, BWD_NAMES[k]):
            if launches[name] != n * steps:
                raise AssertionError(f"granite mesh run: {launches[name]} "
                                     f"launches of {name} in {steps} steps, "
                                     f"the layers imply {n} a step")
    step_s = np.diff([t0] + stamps)
    steady = float(np.median(step_s[1:]))
    B, S = res["batch"](0)["labels"].shape
    del res
    torch.cuda.empty_cache()
    return {"argv": MESH_GRANITE_TRAIN, "steps": steps, "losses": losses,
            "first_step_s": float(step_s[0]), "s_per_step": steady,
            "tokens_per_s": B * S / steady, "peak_allocated_bytes": peak,
            "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "printed": printed.splitlines()[-3:]}


def mesh_compressed(torch, mesh, counters) -> dict:
    """(c): the compressed step on one rank against the exact step."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import device_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import (dequantize_int8, quantize_int8,
                                   sgd_momentum)
    from repro_torch.train.train_step import (TrainState, loss_and_grads,
                                              make_train_step)
    run = MESH_COMPRESSED
    cfg = get_config(run["arch"]).scaled(n_layers=run["n_layers"])
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=run["seq"],
                         global_batch=run["batch"])
    b = device_batch(cfg, pipe, 0, "cuda")
    opt = sgd_momentum(lr=run["lr"])
    base = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    _, local = loss_and_grads(cfg, base, b)
    exact = copy.deepcopy(base)
    se = TrainState(exact, opt.init(dict(exact.named_parameters())))
    se, me = make_train_step(cfg, opt)(se, b)
    sc = TrainState(base, opt.init(dict(base.named_parameters())))
    for fn in counters.values():
        fn.launches = 0
    sc, mc = make_train_step(cfg, opt, T.Dist(mesh=mesh),
                             compress_grads=True)(sc, b)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for n, g in local.items():
        q, scale = quantize_int8(g.to(torch.float32))
        if not torch.equal(sc["residuals"][n],
                           g.to(torch.float32) - dequantize_int8(q, scale)):
            raise AssertionError(f"compressed step: residual of {n} is not "
                                 f"x - deq")
    worst = 0.0
    ex = dict(se["params"].named_parameters())
    for n, p in sc["params"].named_parameters():
        w = ex[n].detach().float()
        rel = float((p.detach().float() - w).abs().max()
                    / (w.abs().max() + 1e-9))
        worst = max(worst, rel)
    if not worst < run["rel"]:
        raise AssertionError(f"compressed step: parameters {worst} of their "
                             f"largest value from the exact step's")
    if not launches["rmsnorm"] or not launches["flash_attention_bwd"]:
        raise AssertionError(f"compressed step launched {launches}")
    out = {"config": {"n_layers": cfg.n_layers, "dtype": cfg.dtype},
           "tokens": [run["batch"], run["seq"]],
           "loss_exact": float(me["loss"]), "loss_compressed":
           float(mc["loss"]), "param_max_rel_err": worst,
           "bound": run["rel"], "residual_exact": True,
           "launches": launches}
    del se, sc, exact, base, local
    torch.cuda.empty_cache()
    return out


# (d) each kernel, forward and backward, at the per-rank shapes of a
# 16-way model split at full width (train_4k on 16 x 16: 16 sequences of
# 4096 a rank): flash on 1 of qwen3-0.6b's 16 heads, the q/k norm of that
# head, the scan on 512 of falcon-mamba-7b's 8192 channels; against the
# plain versions at the tolerances of the train phase (BWD_TOL; the
# forward's o at FULL_ATOL), two calls the same bits, each timed.
MESH_TP_SHAPES = {
    "rmsnorm": ({"rows": 65536, "d": 128}, "bfloat16"),
    "flash_attention": ({"B": 16, "H": 1, "S": 4096, "hd": 128,
                         "causal": True}, "bfloat16"),
    "mamba_scan": ({"Bt": 16, "L": 4096, "D": 512, "N": 16, "chunk": 64},
                   "float32")}


def mesh_tp_kernels(torch) -> dict:
    """(d): the kernels at a 16-way split's per-rank shapes (above)."""
    from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_plain
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_plain
    gen = torch.Generator(device="cuda").manual_seed(28)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for kernel, (s, dtype) in MESH_TP_SHAPES.items():
        i, fwd = bwd_inputs(torch, kernel, s, dtype, gen, full=True)
        if kernel == "rmsnorm":
            got = rmsnorm(i["x"], i["scale"], eps=1e-6, block_rows=128)
            want = rmsnorm_plain(i["x"], i["scale"], eps=1e-6,
                                 block_rows=128)
            fwd["y"] = check_close(torch, kernel, f"per-rank {s}", got,
                                   want, dtype)
        elif kernel == "mamba_scan":
            ins = [i[n] for n in ("dt", "x", "A", "B", "C")]
            got = mamba_scan(*ins, chunk=s["chunk"])
            want = mamba_scan_plain(*ins, chunk=s["chunk"])
            fwd["y"] = check_close(torch, kernel, f"per-rank {s}", got,
                                   want, dtype)
        out[kernel] = {
            "shape": s, "dtype": dtype, "forward_max_abs_err": fwd,
            "backward_max_abs_err": bwd_check(torch, kernel, i, dtype),
            "backward_ms": time_ms(torch, lambda: run_bwd(
                kernel, i, plain=False), reps=20, flush=flush)}
        del i
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


# (f) flash at the per-rank shapes a 16-way split gives the other
# families' attention in train_4k on 16 x 16 (16 sequences of 4096 a
# rank): hubert-xlarge's 1 of 16 heads of 80, non-causal (the wrapper pads
# it to 128); zamba2-1.2b's shared block, 2 of 32 heads of 64; qwen2-vl-72b's
# 4 of 64 heads of 128; through the wrapper's autograd Function (the
# forward and the backward kernel), against the plain forward and backward
# (BWD_TOL; the forward at FULL_ATOL), two calls the same bits, timed.
MESH_TP_FLASH = {
    "hubert-xlarge": {"B": 16, "H": 1, "S": 4096, "hd": 80,
                      "causal": False},
    "zamba2-1.2b shared block": {"B": 16, "H": 2, "S": 4096, "hd": 64,
                                 "causal": True},
    "qwen2-vl-72b": {"B": 16, "H": 4, "S": 4096, "hd": 128,
                     "causal": True}}


def mesh_tp_flash(torch) -> dict:
    """(f): flash forward and backward at the per-rank shapes above."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(29)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, s in MESH_TP_FLASH.items():
        shape = (s["B"], s["H"], s["S"], s["hd"])
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        tile, _ = flash_tile(s["S"], s["causal"])
        scale = s["hd"] ** -0.5

        def fwd_bwd():
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            o = flash_attention(qq, kk, vv, causal=s["causal"],
                                block_q=tile, block_k=tile)
            return (o, *torch.autograd.grad(o, (qq, kk, vv), do))

        got, again = fwd_bwd(), fwd_bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash at {name}'s per-rank shape: two "
                                 "calls gave other bits")
        o_p, lse_p = flash_attention_plain(
            q, k, v, causal=s["causal"], scale=scale, block_q=128,
            block_k=128, return_lse=True)
        grads_p = flash_attention_bwd_plain(q, k, v, o_p, do, lse_p,
                                            causal=s["causal"], scale=scale)
        fwd_err = check_close(torch, "flash_attention",
                              f"per-rank {name} {s}", got[0], o_p,
                              "bfloat16", atol=FULL_ATOL["flash_attention"])
        bwd_err = max(within(torch, g, w, *BWD_TOL["bfloat16"])
                      for g, w in zip(got[1:], grads_p))
        with torch.no_grad():
            fwd_ms = time_ms(torch, lambda: flash_attention(
                q, k, v, causal=s["causal"], block_q=tile, block_k=tile),
                reps=10, flush=flush)
        out[name] = {"shape": s, "dtype": "bfloat16", "tile": tile,
                     "forward_max_abs_err": fwd_err,
                     "backward_max_abs_err": bwd_err,
                     "forward_ms": fwd_ms,
                     "forward_backward_ms": time_ms(torch, fwd_bwd, reps=10,
                                                    flush=flush)}
        del q, k, v, do, got, again, o_p, lse_p, grads_p
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


def phase_mesh(torch, counters) -> dict:
    """The mesh on the card (see the comment above ``MESH_BITWISE``); the
    group is NCCL, never gloo, and no failure of a collective is caught."""
    import tempfile

    import torch.distributed as torch_dist
    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
    out = {"phase": "mesh", "gpu": nvidia_smi(),
           "cuda_devices": torch.cuda.device_count()}
    # launch.train --mesh smoke starts (and ends) its own group
    out["granite_train"] = mesh_granite_train(torch, counters)
    with tempfile.TemporaryDirectory() as d:
        init_process_group("cuda", 0, 1, str(Path(d) / "init"))
        try:
            if torch_dist.get_backend() != "nccl":
                raise AssertionError(f"backend {torch_dist.get_backend()}")
            try:
                make_smoke_mesh(2, 2, device_type="cuda")
            except ValueError as e:
                out["refused_2x2"] = str(e)
            else:
                if torch.cuda.device_count() < 4:
                    raise AssertionError("a 2x2 NCCL mesh on one card")
            mesh = make_smoke_mesh(1, 1, device_type="cuda")
            out["mesh"] = {"shape": list(mesh.shape),
                           "names": list(mesh.mesh_dim_names)}
            out["bitwise"] = {a: mesh_sharded_against_unsharded(
                torch, a, mesh, counters) for a in MESH_BITWISE}
            out["families"] = {a: mesh_sharded_against_unsharded(
                torch, a, mesh, counters) for a in MESH_FAMILIES}
            out["granite_prefill"] = mesh_granite_prefill(torch, mesh,
                                                          counters)
            out["compressed"] = mesh_compressed(torch, mesh, counters)
        finally:
            torch_dist.destroy_process_group()
    out["tp_kernels"] = mesh_tp_kernels(torch)
    out["tp_flash"] = mesh_tp_flash(torch)
    runs = [out["granite_train"], *out["bitwise"].values(),
            *out["families"].values(), out["granite_prefill"],
            out["compressed"]]
    out["launches"] = {k: sum(r["launches"][k] for r in runs)
                       for k in counters}
    emit(out)
    return out


# The dry run (launch/dryrun.py) against the real step on the card.  (1)
# qwen3-0.6b at full width and depth (8 x 1024) and falcon-mamba-7b at 4 of
# 64 layers (2 x 2048), bf16, AdamW: the real sharded step on a NCCL group
# of one rank and its (1, 1) mesh (``make_cell(..., device="cuda")``), with
# the launches counted from zero, FlopCounterMode over it and its peak
# memory from a reset; then, with that group ended, the dry run of the same
# cell on a fake group of one rank: each kernel's events equal its
# launches, the aten dot FLOPs equal FlopCounterMode's exactly, argument +
# temp within DRYRUN_MEM_RTOL of the real footprint (the peak less what was
# allocated before the cell was made), nothing allocated on the card by
# the dry run, and the roofline's step_s beside the measured s/step (no
# bound).  (2) remat="full" on qwen3-0.6b at the same shape: the loss and
# every gradient bit for bit against remat="none", the forward kernels
# launched twice in each checkpointed layer, and the step's peak and the
# dry run's estimate both lower, still within DRYRUN_MEM_RTOL.  (3) the
# production cell qwen3-0.6b train_4k on 16x16: status ok.
DRYRUN_RUNS = {"qwen3-0.6b": {"n_layers": 28, "batch": 8, "seq": 1024},
               "falcon-mamba-7b": {"n_layers": 4, "batch": 2, "seq": 2048}}
DRYRUN_MEM_RTOL = 0.10


def real_step(torch, arch, cfg, shape, mesh, counters) -> dict:
    """The cell's real step on the card: launches, FlopCounterMode's
    count, the footprint (peak less the memory before the cell was made)
    and the host time of a second step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.specs import make_cell
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cell = make_cell(arch, shape, mesh, cfg_override=cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with FlopCounterMode(display=False) as fc:
        state, m = cell.fn(*cell.args)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    loss = float(m["loss"])
    if not torch.isfinite(m["loss"]).item():
        raise AssertionError(f"{arch}: loss {loss}")
    step_s = timed_step(torch, cell.fn, state, cell.args[1])
    del cell, state, m
    torch.cuda.empty_cache()
    return {"launches": launches, "flops": fc.get_total_flops(),
            "footprint_bytes": peak - before, "peak_allocated_bytes": peak,
            "loss": loss, "s_per_step": step_s}


def dry_step(torch, arch, cfg, shape) -> dict:
    """The dry run of the same cell on a fake (1, 1) mesh; the card's
    allocated memory must not move."""
    from repro_torch.launch.dryrun import run_cell
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rec = run_cell(arch, shape, False, cfg_override=cfg,
                   mesh=((1, 1), ("data", "model")))
    if rec["status"] != "ok":
        raise AssertionError(f"{arch}: the dry run failed: {rec['error']}\n"
                             f"{rec['traceback']}")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError(f"{arch}: the dry run allocated "
                             f"{torch.cuda.memory_allocated() - before} "
                             "bytes on the card")
    return rec


def dry_against_real(arch, dry, real) -> dict:
    """(1)'s checks of one cell: events against launches, FLOPs exactly,
    memory within DRYRUN_MEM_RTOL; the step times side by side."""
    kernels = dry["hlo"]["kernels"]
    for name, n in real["launches"].items():
        kernel, bwd = (name[:-4], "bwd") if name.endswith("_bwd") \
            else (name, "fwd")
        got = kernels.get(f"{kernel}/{bwd}", {"events": 0})["events"]
        if got != n:
            raise AssertionError(f"{arch}: the dry run counts {got} calls "
                                 f"of {name}, the step launched {n}")
    aten = sum(dry["hlo"]["aten_flops"].values())
    if aten != real["flops"]:
        raise AssertionError(f"{arch}: dry-run dot FLOPs {aten} against "
                             f"FlopCounterMode's {real['flops']}")
    mem = dry["memory"]
    est = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    rel = est / real["footprint_bytes"] - 1
    if abs(rel) > DRYRUN_MEM_RTOL:
        raise AssertionError(f"{arch}: dry-run memory {est} against the "
                             f"step's {real['footprint_bytes']} "
                             f"({rel:+.3f})")
    step_s = dry["roofline"]["step_s"]
    return {"events_equal_launches": True, "dot_flops": aten,
            "flops_equal": True, "memory_estimate_bytes": est,
            "memory_real_bytes": real["footprint_bytes"],
            "memory_rel_err": rel, "roofline": dry["roofline"],
            "roofline_step_s": step_s,
            "measured_s_per_step": real["s_per_step"],
            "measured_over_roofline": real["s_per_step"] / step_s,
            "trace_s": dry["compile_s"], "build_s": dry["lower_s"]}


def remat_bitwise(torch, arch, cfg, shape) -> dict:
    """(2): the loss and every gradient of one batch with remat="full"
    against remat="none", on the card, bit for bit."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.specs import make_cell
    from repro_torch.train.train_step import loss_and_grads
    cell = make_cell(arch, shape, MeshShape((1, 1)), cfg_override=cfg,
                     device="cuda")
    params, b = cell.args[0]["params"], cell.args[1]
    loss0, g0 = loss_and_grads(cfg, params, b)
    loss1, g1 = loss_and_grads(cfg.scaled(remat="full"), params, b)
    torch.cuda.synchronize()
    unequal = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    if not torch.equal(loss0, loss1) or unequal:
        raise AssertionError(f"remat: loss {float(loss0)} / {float(loss1)}, "
                             f"gradients differ in {unequal[:6]}")
    n = len(g0)
    del cell, params, g0, g1
    torch.cuda.empty_cache()
    return {"gradients_compared": n, "bit_identical": True,
            "loss": float(loss0)}


def remat_launches(cfg, launches) -> None:
    """The forward kernels twice in each checkpointed layer (rmsnorm's
    final norm once), the backward kernels as without remat."""
    plain = expected_train_launches(cfg)
    want = {"rmsnorm": 2 * (plain["rmsnorm"] - 1) + 1,
            "flash_attention": 2 * plain["flash_attention"],
            "mamba_scan": 2 * plain["mamba_scan"]}
    for k, n in want.items():
        if launches[k] != n or launches[BWD_NAMES[k]] != plain[k]:
            raise AssertionError(f"remat: {launches[k]} launches of {k} "
                                 f"(want {n}), {launches[BWD_NAMES[k]]} of "
                                 f"its backward (want {plain[k]})")


def phase_dryrun(torch, counters) -> dict:
    """The dry run on the card (see the comment above ``DRYRUN_RUNS``):
    the real steps on a NCCL group of one rank, ended before the dry runs
    start their fake groups; no failure is caught."""
    import tempfile

    import torch.distributed as torch_dist
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
    out = {"phase": "dryrun", "gpu": nvidia_smi(),
           "tolerance": {"memory_rel": DRYRUN_MEM_RTOL, "flops": "exact",
                         "events": "exact"}}
    cells = {a: (get_config(a).scaled(n_layers=r["n_layers"]),
                 (r["seq"], r["batch"], "train"))
             for a, r in DRYRUN_RUNS.items()}
    remat_cfg = cells["qwen3-0.6b"][0].scaled(remat="full")
    real = {}
    with tempfile.TemporaryDirectory() as d:
        init_process_group("cuda", 0, 1, str(Path(d) / "init"))
        try:
            mesh = make_smoke_mesh(1, 1, device_type="cuda")
            for arch, (cfg, shape) in cells.items():
                real[arch] = real_step(torch, arch, cfg, shape, mesh,
                                       counters)
            real["remat"] = real_step(torch, "qwen3-0.6b", remat_cfg,
                                      cells["qwen3-0.6b"][1], mesh, counters)
        finally:
            torch_dist.destroy_process_group()
    remat_launches(remat_cfg, real["remat"]["launches"])
    out["cells"] = {}
    for arch, (cfg, shape) in cells.items():
        dry = dry_step(torch, arch, cfg, shape)
        out["cells"][arch] = {"config": {"n_layers": cfg.n_layers,
                                         "d_model": cfg.d_model,
                                         "dtype": cfg.dtype},
                              "tokens": list(shape[1::-1]),
                              "launches": real[arch]["launches"],
                              **dry_against_real(arch, dry, real[arch])}
    dry = dry_step(torch, "qwen3-0.6b", remat_cfg, cells["qwen3-0.6b"][1])
    remat = dry_against_real("qwen3-0.6b remat", dry, real["remat"])
    plain = out["cells"]["qwen3-0.6b"]
    if not (remat["memory_real_bytes"] < plain["memory_real_bytes"]
            and remat["memory_estimate_bytes"]
            < plain["memory_estimate_bytes"]):
        raise AssertionError(f"remat: memory {remat['memory_real_bytes']} "
                             f"(estimate {remat['memory_estimate_bytes']}) "
                             f"against {plain['memory_real_bytes']} "
                             f"({plain['memory_estimate_bytes']})")
    out["remat"] = {"launches": real["remat"]["launches"],
                    "bitwise": remat_bitwise(torch, "qwen3-0.6b",
                                             cells["qwen3-0.6b"][0],
                                             cells["qwen3-0.6b"][1]),
                    **remat}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    prod = run_cell("qwen3-0.6b", "train_4k", False)
    if prod["status"] != "ok" or torch.cuda.memory_allocated() != before:
        raise AssertionError(f"production cell: {prod.get('error')}\n"
                             f"{prod.get('traceback')}")
    out["production"] = {k: prod[k] for k in
                         ("arch", "shape", "mesh", "devices", "memory",
                          "roofline", "compile_s", "lower_s", "wall_s")}
    out["production"]["collective_bytes"] = prod["hlo"]["collective_bytes"]
    out["launches"] = {k: real["qwen3-0.6b"]["launches"][k]
                       + real["falcon-mamba-7b"]["launches"][k]
                       for k in counters}
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
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_bwd
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd

    seconds = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        try:
            return phase(torch, *args)
        finally:
            seconds[name] = time.perf_counter() - t0

    timed("device", phase_device, build)
    timed("search_shapes", phase_search_shapes, wl)
    full = timed("full_width", phase_full_width, wl)
    timed("overheads", phase_overheads)
    # every wrapper, forward and backward: each path's reset and read
    # covers all six
    counters = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "mamba_scan": mamba_scan, "rmsnorm_bwd": rmsnorm_bwd,
                "flash_attention_bwd": flash_attention_bwd,
                "mamba_scan_bwd": mamba_scan_bwd}
    launches = timed("search", phase_search, wl, counters)
    timed("profile", phase_profile, wl)
    timed("programs", phase_programs)
    islands = timed("islands", phase_islands, wl, counters)
    tensor = timed("tensor", phase_tensor, wl, counters)
    keep = {}
    serve = timed("serve", phase_serve, wl, counters, keep)
    router = timed("router", phase_router, counters, keep)
    keep.clear()
    torch.cuda.empty_cache()
    liveloop = timed("liveloop", phase_liveloop, counters)
    train = timed("train", phase_train, counters)
    mesh = timed("mesh", phase_mesh, counters)
    dry = timed("dryrun", phase_dryrun, counters)
    emit({"phase_seconds": seconds})

    # launches: in the kernel's own measured search (a backward kernel has
    # none: its main path is training, so its row gives that count);
    # launches_joint_static: in the joint static search; launches_islands:
    # in the measured flash-attention islands; launches_tensor and
    # launches_fleet: in the tensorized engine's run and the mesh fleet's;
    # launches_serve: in the server's runs of qwen3-0.6b and
    # falcon-mamba-7b; launches_router: in build_router's runs of both;
    # launches_router_mesh: in one run of the router's replica on the
    # (1, 1) mesh;
    # launches_liveloop: in the real live loop's two ticks;
    # launches_train: in the training runs of both models;
    # launches_mesh: in the mesh phase's runs under Dist;
    # launches_dryrun: in the dryrun phase's real steps of both models
    # (without remat).  Every count was read from the wrapper's counter
    # after that path alone.
    forward_of = {b: k for k, b in BWD_NAMES.items()}
    timed = {**{k: full[k] for k in wl.KERNELS}, **train["kernels"]}
    rows = [
        {"name": n, "route": "cuda",
         "source": SOURCES[forward_of.get(n, n)],
         "replaces": REPLACES[forward_of.get(n, n)],
         "launches": (launches["measured"][n][n] if n in wl.KERNELS
                      else train["launches"][n]),
         "launches_joint_static": launches["joint_static"][n],
         "launches_islands": islands["launches"][n],
         "launches_tensor": tensor["engine"]["launches"][n],
         "launches_fleet": tensor["fleet"]["launches"][n],
         "launches_serve": serve["launches"][n],
         "launches_router": router["launches"][n],
         "launches_router_mesh": router["mesh"]["launches"][n],
         "launches_liveloop": liveloop["launches"][n],
         "launches_train": train["launches"][n],
         "launches_mesh": mesh["launches"][n],
         "launches_dryrun": dry["launches"][n],
         "max_abs_err": timed[n]["max_abs_err"], "ms": timed[n]["kernel_ms"],
         "plain_ms": timed[n]["plain_ms"], "bound_ms": timed[n]["bound_ms"],
         "bound_by": timed[n]["bound_by"],
         "library_ms": timed[n]["library_ms"],
         **({"profiler_ms": timed[n]["profiler_ms"]}
            if "profiler_ms" in timed[n] else {})}
        for n in (*wl.KERNELS, *BWD_NAMES.values())]
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
