"""Fitness evaluation for GEVO-ML variants: argmin(time, error).

Section 4.3: individuals are only required to *execute successfully*; output
error is an objective, not a validity gate.  Two time modes:

* ``measured`` — the variant's run time on the device its inputs live on:
  CUDA-event timings on a GPU, the host clock on the CPU.
* ``static``  — a deterministic roofline estimate.  Used in CI and on hosts
  without a GPU so search results are reproducible.

This slice carries the kernel-schedule task (:class:`KernelWorkload`); the
IR-program tasks of the reference (``PredictionWorkload``,
``TrainingWorkload``) need the IR interpreter and come with it.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .ir import Program, op_bytes, op_flops
from .schedule import ScheduleSpace

# H100 SXM data-sheet rates (dense, no sparsity): bf16 tensor-core FLOP/s and
# HBM3 bytes/s.  The kernel cost model's device record
# (``repro_torch.kernels.costs.H100``) takes its HBM rate from here and adds
# the f32 rates of the CUDA cores.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


class InvalidVariant(Exception):
    """The variant failed to execute (or broke the training feedback loop)."""


class DeviceFault(RuntimeError):
    """A kernel failed to build, or the device refused or faulted a launch
    that passed every gate.  That says nothing about the variant, so it is
    never folded into :class:`InvalidVariant`: it stops the evaluation."""


# faults of the device or the build that evaluation lets through; torch
# raises AcceleratorError for CUDA errors it finds at a synchronisation
DEVICE_FAULTS = (DeviceFault,
                 getattr(torch, "AcceleratorError", DeviceFault))


def static_time(program: Program, peak_flops: float = PEAK_FLOPS,
                hbm_bw: float = HBM_BW) -> float:
    """Roofline time estimate: sum over ops of max(compute, memory) time."""
    types = program.types()
    t = 0.0
    for op in program.ops:
        ots = [types[o] for o in op.operands]
        t += max(op_flops(op, ots) / peak_flops, op_bytes(op, ots) / hbm_bw)
    return t


def _device_of(out) -> torch.device:
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (tuple, list)) and out:
        return _device_of(out[0])
    if isinstance(out, dict) and out:
        return _device_of(next(iter(out.values())))
    return torch.device("cpu")


def measured_time(fn, inputs, repeats: int = 5, warmup: int = 2) -> float:
    """Median seconds of ``fn(inputs)`` after ``warmup`` calls.  On a CUDA
    device each call is bracketed by CUDA events and the device is
    synchronised before reading them; on the CPU the host clock times it."""
    out = None
    for _ in range(warmup):
        out = fn(inputs)
    device = _device_of(out)
    if device.type == "cuda":
        pairs = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(inputs)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(device)
        times = [s.elapsed_time(e) * 1e-3 for s, e in pairs]
    else:
        times = []
        for _ in range(repeats):
            t0 = _time.perf_counter()
            fn(inputs)
            times.append(_time.perf_counter() - t0)
    return float(np.median(times))


def _check_finite_scalar(x) -> float:
    v = float(x)
    if not np.isfinite(v):
        raise InvalidVariant("non-finite objective")
    return v


@dataclass
class KernelWorkload:
    """Kernel-schedule task: ``program`` is a schedule genome encoded as
    HLO-lite constant ops (:mod:`repro_torch.core.schedule`), and fitness is
    ``argmin(kernel time, max numerical error vs the kernel's reference)``.

    ``runner(genome)`` executes the scheduled kernel (so un-launchable or
    crashing configurations surface as :class:`InvalidVariant`, the paper's
    execute-successfully gate) and returns ``(time_s, max_abs_error)`` —
    time measured on the workload's device in ``measured`` mode, or a
    deterministic schedule-aware roofline estimate in ``static`` mode (see
    ``repro_torch.kernels.costs``).  Builders for the CUDA kernels live in
    ``repro_torch.kernels.workloads``."""

    name: str
    program: Program                 # the encoded schedule genome
    space: ScheduleSpace
    runner: Callable[[dict], tuple[float, float]]  # genome -> (time, err)
    time_mode: str = "static"
    kind: str = "kernel"
    # rebuild recipe for ParallelEvaluator workers (see core/evaluator.py);
    # required for parallel eval: runner is a closure and does not pickle
    spec: object | None = None
    # batched-fitness recipe of the tensorized engine; None until that
    # engine is ported.  Not part of the fingerprint.
    tensor_spec: object | None = None
    # launchability probe: the same static gate check the runner performs
    # first (``schedule_time`` raising InvalidVariant).  Optional and
    # advisory — not fingerprinted.
    static_probe: Callable[[dict], float] | None = None
    # feature probe: genome -> flat {name: float} of roofline/shared-memory
    # counters (``kernels.costs.schedule_features``).  Optional and
    # advisory — not fingerprinted.
    feature_probe: Callable[[dict], dict] | None = None

    def evaluate(self, program: Program) -> tuple[float, float]:
        try:
            genome = self.space.decode(program)
            t, err = self.runner(genome)
            return _check_finite_scalar(t), _check_finite_scalar(err)
        except (InvalidVariant, *DEVICE_FAULTS):
            raise
        except Exception as e:  # ScheduleError, rejected schedule, numerics
            raise InvalidVariant(str(e)) from e
