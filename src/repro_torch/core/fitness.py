"""Fitness evaluation for GEVO-ML variants: argmin(time, error).

Section 4.3: individuals are only required to *execute successfully*; output
error is an objective, not a validity gate.  Two time modes:

* ``measured`` — the variant's run time on its device: on a GPU the
  variant is captured once as a CUDA graph and its replays are timed with
  CUDA events (the counterpart of the reference timing the one XLA
  executable it compiles per variant); on the CPU the host clock times the
  eager call.
* ``static``  — a deterministic roofline estimate.  Used in CI and on hosts
  without a GPU so search results are reproducible.

Three tasks: inference (:class:`PredictionWorkload`) and training
(:class:`TrainingWorkload`) of an IR program, which
:mod:`~repro_torch.core.interp` executes, and the kernel-schedule task
(:class:`KernelWorkload`).  The IR tasks run on their ``device``: the GPU
unless the builder was told otherwise.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..device import DeviceFault, resolve_device
from .interp import ProgramGraph
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


# The spin ``measured_time`` holds the stream with: at least _SPIN_CYCLES,
# and twice what the host took to enqueue as many warm-up calls as there are
# timed ones, counted at _SPIN_HZ (at least the H100's top SM clock, 1.98
# GHz, so the spin lasts no shorter than that); it may grow fourfold
# _SPIN_TRIES - 1 times until the host has enqueued every timed call before
# the device reaches them.
_SPIN_CYCLES = 1_000_000
_SPIN_HZ = 2e9
_SPIN_TRIES = 6


def measured_time(run, device, repeats: int = 5, warmup: int = 2) -> float:
    """Median seconds of one ``run()`` after ``warmup`` calls.

    On a CUDA device each timed call (a graph replay, on the measured
    paths) is bracketed by a pair of CUDA events, and the device first
    spins on the stream (``torch.cuda._sleep``) while the host enqueues
    every pair, so the calls run back to back and the events read the
    device's time, not the host's rate of launching; the spin grows until
    the host gets ahead of it.  On the CPU the host clock times each
    call."""
    device = torch.device(device)
    t0 = _time.perf_counter()
    for _ in range(warmup):
        run()
    host_s = (_time.perf_counter() - t0) / max(warmup, 1)
    if device.type != "cuda":
        times = []
        for _ in range(repeats):
            t0 = _time.perf_counter()
            run()
            times.append(_time.perf_counter() - t0)
        return float(np.median(times))
    cycles = max(_SPIN_CYCLES, int(2 * repeats * host_s * _SPIN_HZ))
    for _ in range(_SPIN_TRIES):
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        pairs = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            pairs.append((start, end))
        ahead = not spun.query()
        torch.cuda.synchronize(device)
        if ahead:
            return float(np.median([s.elapsed_time(e) * 1e-3
                                    for s, e in pairs]))
        cycles *= 4
    raise DeviceFault(f"measured_time: the host did not enqueue {repeats} "
                      f"timed calls while the device spun {cycles // 4} "
                      "cycles")


def _check_finite_scalar(x) -> float:
    v = float(x)
    if not np.isfinite(v):
        raise InvalidVariant("non-finite objective")
    return v


@dataclass
class PredictionWorkload:
    """Inference task (MobileNet/CIFAR10 in the paper): minimize forward-pass
    time and prediction error on a held-in dataset.  The data moves to the
    device once an evaluation; the correct predictions are counted there."""

    name: str
    program: Program                 # inputs: {"images"}; outputs: [logits]
    images: np.ndarray               # (N, ...) held-in eval data
    labels: np.ndarray               # (N,)
    batch: int = 256
    time_mode: str = "static"
    kind: str = "prediction"
    # rebuild recipe for ParallelEvaluator workers (see core/evaluator.py);
    # optional — this workload also pickles whole
    spec: object | None = None
    device: str | None = None        # None: the GPU

    def evaluate(self, program: Program) -> tuple[float, float]:
        dev = resolve_device(self.device)   # no GPU is not the variant's fault
        try:
            n = (len(self.images) // self.batch) * self.batch
            images = torch.as_tensor(self.images[:n]).to(dev)
            labels = torch.as_tensor(self.labels[:n]).to(dev)
            correct = torch.zeros((), dtype=torch.int64, device=dev)
            t_meas = 0.0
            with ProgramGraph(program, dev) as graph:
                for i in range(0, n, self.batch):
                    graph.load({"images": images[i:i + self.batch]})
                    out = graph.run()[0]
                    if out.ndim != 2 or out.shape[0] != self.batch:
                        raise InvalidVariant(
                            f"bad logits shape {tuple(out.shape)}")
                    if self.time_mode == "measured" and i == 0:
                        t_meas = measured_time(graph.run, dev) * \
                            (n // self.batch)
                    # np.nan_to_num and np.argmax of the reference, on the
                    # device
                    pred = torch.nan_to_num(out.to(torch.float32),
                                            nan=-1e30).argmax(-1)
                    correct += (pred == labels[i:i + self.batch]).sum()
                error = 1.0 - int(correct) / max(n, 1)
            t = t_meas if self.time_mode == "measured" else \
                static_time(program) * (n // self.batch)
            return _check_finite_scalar(t), _check_finite_scalar(error)
        except (InvalidVariant, *DEVICE_FAULTS):
            raise
        except Exception as e:  # any execution failure invalidates the variant
            raise InvalidVariant(str(e)) from e


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
    # batched-fitness recipe of the tensorized engine
    # (core.tensor_evo.TensorFitnessSpec).  Not part of the fingerprint.
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


@dataclass
class TrainingWorkload:
    """Training task (2fcNet/MNIST in the paper): the IR program is ONE full
    SGD step (forward + backward + update, Figure 5).  Fitness retrains from
    the initial weights with the *variant* step on the device, then measures
    error with the reference forward pass on the final weights."""

    name: str
    program: Program                 # inputs: weights... + {"x","y_onehot"}
    weight_names: tuple[str, ...]    # program inputs that are weights, in
                                     # 1:1 order with program outputs
    init_weights: dict[str, np.ndarray]
    train_x: np.ndarray
    train_y: np.ndarray              # int labels
    eval_fn: Callable[[dict[str, np.ndarray]], float]  # -> error in [0,1]
    batch: int = 32
    steps: int = 200
    num_classes: int = 10
    time_mode: str = "static"
    kind: str = "training"
    # rebuild recipe for ParallelEvaluator workers (see core/evaluator.py);
    # required for parallel eval: eval_fn is a closure and does not pickle
    spec: object | None = None
    device: str | None = None        # None: the GPU

    def _batches(self, xs: torch.Tensor, ys: torch.Tensor):
        n = (len(self.train_x) // self.batch) * self.batch
        i = 0
        while True:
            j = i % n
            yield xs[j:j + self.batch], ys[j:j + self.batch]
            i += self.batch

    def evaluate(self, program: Program) -> tuple[float, float]:
        dev = resolve_device(self.device)   # no GPU is not the variant's fault
        try:
            expected_shapes = {k: tuple(v.shape)
                               for k, v in self.init_weights.items()}
            onehot = torch.eye(self.num_classes, dtype=torch.float32,
                               device=dev)
            batches = self._batches(
                torch.as_tensor(self.train_x).to(dev),
                onehot[torch.as_tensor(self.train_y).to(dev).long()])
            t_meas = 0.0
            with ProgramGraph(program, dev) as graph:
                graph.load(self.init_weights)
                outs = [torch.as_tensor(self.init_weights[k])
                        for k in self.weight_names]
                for step in range(self.steps):
                    x, y1h = next(batches)
                    graph.load({"x": x, "y_onehot": y1h})
                    outs = graph.run()
                    if len(outs) != len(self.weight_names):
                        raise InvalidVariant("variant lost weight outputs")
                    for k, o in zip(self.weight_names, outs):
                        if tuple(o.shape) != expected_shapes[k]:
                            # the variant changed a weight shape: the
                            # training feedback loop is broken -> invalid
                            raise InvalidVariant(
                                f"weight {k} shape drifted to "
                                f"{tuple(o.shape)}")
                    if self.time_mode == "measured" and step == 1:
                        t_meas = measured_time(graph.run, dev) * self.steps
                    graph.load(dict(zip(self.weight_names, outs)))
                final = {k: o.to(torch.float32).cpu().numpy()
                         for k, o in zip(self.weight_names, outs)}
            if any(not np.all(np.isfinite(v)) for v in final.values()):
                raise InvalidVariant("weights diverged to non-finite")
            error = self.eval_fn(final)
            t = t_meas if self.time_mode == "measured" else \
                static_time(program) * self.steps
            return _check_finite_scalar(t), _check_finite_scalar(error)
        except (InvalidVariant, *DEVICE_FAULTS):
            raise
        except Exception as e:
            raise InvalidVariant(str(e)) from e
