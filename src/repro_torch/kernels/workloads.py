"""Kernel-schedule workload builders: the hand-written CUDA kernels as GEVO
scenarios.

Each builder wires one kernel (``rmsnorm`` / ``flash_attention`` /
``mamba_scan``) into a :class:`~repro_torch.core.fitness.KernelWorkload`
whose genome is a :class:`~repro_torch.core.schedule.ScheduleSpace` over the
kernel's schedule knobs — implementation choice (``ref`` oracle vs the
kernel, spelled ``pallas`` as in the reference package so patch keys match),
block sizes / chunking, and for rmsnorm the epilogue-fusion choice
(``unfused`` applies the scale multiply as a separate torch op after the
kernel).  Names, choice tuples and baselines are the reference's
(``src/repro/kernels/workloads.py``).

Fitness = ``(time, max |out - ref|)``:

* the kernel is always *executed* on fixed seeded inputs (the plain PyTorch
  version on CPU tensors, the CUDA kernel on the GPU) — the error objective
  is the real numerical gap against the kernel's ``ref.py`` oracle, which
  is evaluated once on the CPU from the same numpy inputs;
* time is the schedule-aware roofline (``repro_torch.kernels.costs``) in
  ``static`` mode (deterministic: parallel == serial), or in ``measured``
  mode the device time of one call of the variant: ``GRAPH_CALLS`` calls
  captured as one CUDA graph, its replays timed by CUDA events
  (:func:`graph_time`); on the CPU, the host clock over the eager call.

Builders are deterministic given their kwargs and attach a
:class:`~repro_torch.core.evaluator.WorkloadSpec`, so ParallelEvaluator
workers and spawned islands rebuild them, and a
:class:`~repro_torch.core.tensor_evo.TensorFitnessSpec`, the recipe of the
tensorized engine's batched fitness (errors by class of ``ERROR_KNOBS``).
Every block choice of the per-kernel spaces divides its evaluation
dimension and fits the shared-memory gate, so every genome is launchable.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.evaluator import WorkloadSpec
from ..core.fitness import MEASURED_CAPTURES, KernelWorkload, \
    measured_time, record_instances
from ..core.schedule import ScheduleSpace
from ..device import CudaGraph, resolve_device
from .costs import schedule_features, schedule_time
from .cpu import init_vector_math
from .flash_attention.ops import flash_attention
from .flash_attention.ref import attention_ref
from .mamba_scan.ops import mamba_scan
from .mamba_scan.ref import mamba_scan_ref
from .rmsnorm.ops import rmsnorm
from .rmsnorm.ref import rmsnorm_ref

KERNELS = ("rmsnorm", "flash_attention", "mamba_scan")

# Evaluation shapes (the reference's): every block choice below divides its
# dimension (launchability by construction).
SHAPES: dict[str, dict[str, int]] = {
    "rmsnorm": {"rows": 512, "d": 512},
    "flash_attention": {"B": 1, "H": 2, "S": 256, "hd": 64},
    "mamba_scan": {"Bt": 1, "L": 128, "D": 32, "N": 16},
}

_SPACES: dict[str, dict[str, tuple]] = {
    "rmsnorm": {"impl": ("pallas", "ref"),
                "block_rows": (32, 64, 128, 256, 512),
                "epilogue": ("fused", "unfused")},
    "flash_attention": {"impl": ("pallas", "ref"),
                        "block_q": (32, 64, 128, 256),
                        "block_k": (32, 64, 128, 256)},
    "mamba_scan": {"impl": ("pallas", "ref"),
                   "chunk": (8, 16, 32, 64, 128)},
}

# The kernels' shipped defaults — the search baseline (empty patch).
BASELINES: dict[str, dict] = {
    "rmsnorm": {"impl": "pallas", "block_rows": 128, "epilogue": "fused"},
    "flash_attention": {"impl": "pallas", "block_q": 128, "block_k": 128},
    "mamba_scan": {"impl": "pallas", "chunk": 64},
}

# which evaluation-shape dimension each block-size knob must divide
BLOCK_DIMS = {"block_rows": "rows", "block_q": "S", "block_k": "S",
              "chunk": "L"}

# The input tensors of each kernel, in call order.
INPUT_NAMES: dict[str, tuple[str, ...]] = {
    "rmsnorm": ("x", "scale"),
    "flash_attention": ("q", "k", "v"),
    "mamba_scan": ("dt", "x", "A", "B", "C"),
}

# The knobs a kernel's *numerical error* depends on.  The excluded knobs
# only partition independent rows of the iteration space: the CUDA kernels
# keep each row's arithmetic independent of rmsnorm's block_rows and of
# flash's block_q (see the notes in csrc/), so error is constant over them.
ERROR_KNOBS: dict[str, tuple[str, ...]] = {
    "rmsnorm": ("impl", "epilogue"),
    "flash_attention": ("impl", "block_k"),
    "mamba_scan": ("impl", "chunk"),
}


def kernel_space(kernel: str) -> ScheduleSpace:
    if kernel not in _SPACES:
        raise KeyError(f"unknown kernel {kernel!r}; choose from {KERNELS}")
    return ScheduleSpace.of(f"kernel/{kernel}", _SPACES[kernel])


def numpy_inputs(kernel: str, seed: int) -> dict[str, np.ndarray]:
    """The seeded float32 inputs of ``kernel`` at its evaluation shape."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    s = SHAPES[kernel]
    if kernel == "rmsnorm":
        return {"x": normal(s["rows"], s["d"]), "scale": normal(s["d"])}
    if kernel == "flash_attention":
        shape = (s["B"], s["H"], s["S"], s["hd"])
        return {"q": normal(*shape), "k": normal(*shape),
                "v": normal(*shape)}
    seq = (s["Bt"], s["L"], s["D"])
    return {"dt": np.logaddexp(np.float32(0), normal(*seq)),   # softplus
            "x": normal(*seq),
            "A": -np.exp(normal(s["D"], s["N"]) * np.float32(0.3)),
            "B": normal(s["Bt"], s["L"], s["N"]),
            "C": normal(s["Bt"], s["L"], s["N"])}


def inputs_from_numpy(kernel: str, arrays: dict, device) -> dict:
    """The port's input dict for ``kernel`` on ``device`` from the numpy
    arrays both packages are fed (contiguous copies, dtypes kept)."""
    names = INPUT_NAMES[kernel]
    if set(arrays) != set(names):
        raise ValueError(f"{kernel} takes inputs {names}, got "
                         f"{tuple(sorted(arrays))}")
    return {n: torch.from_numpy(np.ascontiguousarray(arrays[n])).to(device)
            for n in names}


def _variant_fn(kernel: str, genome: dict):
    """The scheduled computation as ``fn(inputs_dict) -> output``."""
    if kernel == "rmsnorm":
        if genome["impl"] == "ref":
            return lambda i: rmsnorm_ref(i["x"], i["scale"])
        br = genome["block_rows"]
        if genome["epilogue"] == "fused":
            return lambda i: rmsnorm(i["x"], i["scale"], block_rows=br)

        def unfused(i):
            ones = torch.ones(i["x"].shape[-1], dtype=torch.float32,
                              device=i["x"].device)
            return rmsnorm(i["x"], ones, block_rows=br) * i["scale"]
        return unfused
    if kernel == "flash_attention":
        if genome["impl"] == "ref":
            return lambda i: attention_ref(i["q"], i["k"], i["v"],
                                           causal=True)
        bq, bk = genome["block_q"], genome["block_k"]
        return lambda i: flash_attention(i["q"], i["k"], i["v"], causal=True,
                                         block_q=bq, block_k=bk)
    if genome["impl"] == "ref":
        return lambda i: mamba_scan_ref(i["dt"], i["x"], i["A"], i["B"],
                                        i["C"])
    ch = genome["chunk"]
    return lambda i: mamba_scan(i["dt"], i["x"], i["A"], i["B"], i["C"],
                                chunk=ch)


# Calls of the scheduled computation in the one graph a measured evaluation
# replays: one call at the search shapes runs for a few microseconds, about
# what launching a graph costs the device, so a graph of one call would time
# its launch as much as the kernel.
GRAPH_CALLS = 16
# The wrappers whose ``launches`` a replay adds to.
COUNTERS = (rmsnorm, flash_attention, mamba_scan)


def graph_time(fn, inputs) -> float:
    """Seconds of one ``fn(inputs)`` on the inputs' device.  On a GPU,
    ``GRAPH_CALLS`` calls are captured as one CUDA graph after one eager
    run of them (outputs go to the graph's own memory, the inputs stay
    where they are, so a kernel's pointers are the same on every replay),
    and :func:`~repro_torch.core.fitness.measured_time` times its replays;
    the time is the median over ``MEASURED_CAPTURES`` such graphs, each
    released before the next is captured (each graph's time kept in
    ``core/fitness.py`` ``LAST_INSTANCES``).  Each replay adds
    the launches its capture recorded to the wrappers' counts.  On the
    CPU, the host clock over the eager call."""
    device = next(iter(inputs.values())).device
    if device.type != "cuda":
        return measured_time(lambda: fn(inputs), device)

    def calls():
        for _ in range(GRAPH_CALLS):
            fn(inputs)

    times = []
    for _ in range(MEASURED_CAPTURES):
        graph = CudaGraph(device)
        try:
            graph.eager(calls)
            before = [c.launches for c in COUNTERS]
            graph.capture(calls)
            # the capture records launches; only replays make them
            recorded = [c.launches - b for c, b in zip(COUNTERS, before)]
            for c, b in zip(COUNTERS, before):
                c.launches = b

            def replay():
                graph.replay()
                for c, n in zip(COUNTERS, recorded):
                    c.launches += n

            times.append(measured_time(replay, device) / GRAPH_CALLS)
        finally:
            graph.release()
    return record_instances(times)


def _ref_output(kernel: str, arrays: dict) -> np.ndarray:
    """The oracle's output, evaluated on the CPU from the numpy inputs."""
    init_vector_math()
    out = _variant_fn(kernel, {"impl": "ref"})(
        inputs_from_numpy(kernel, arrays, "cpu"))
    return out.to(torch.float32).numpy()


def _kernel_error(kernel: str, genome: dict, inputs, ref_out) -> float:
    """Execute one scheduled kernel and return max |out - ref|."""
    out = _variant_fn(kernel, genome)(inputs)
    got = out.to(torch.float32).cpu().numpy()
    return float(np.max(np.abs(got - ref_out)))


def build_kernel_workload(kernel: str = "rmsnorm", *,
                          time_mode: str = "static", seed: int = 0,
                          device=None) -> KernelWorkload:
    """One CUDA kernel as a GEVO scenario: schedule genome + (time, error)
    fitness.  Runs on the GPU unless ``device`` names another device.
    Deterministic given kwargs (required by WorkloadSpec)."""
    from ..core.tensor_evo.fitness import KernelBlock, TensorFitnessSpec

    dev = resolve_device(device)
    space = kernel_space(kernel)
    shape = SHAPES[kernel]
    arrays = numpy_inputs(kernel, seed)
    inputs = inputs_from_numpy(kernel, arrays, dev)
    ref_out = _ref_output(kernel, arrays)

    def static_probe(genome: dict) -> float:
        # the exact gate check the runner performs first
        return schedule_time(kernel, genome, **shape)

    def runner(genome: dict) -> tuple[float, float]:
        t = static_probe(genome)  # validates launchability
        err = _kernel_error(kernel, genome, inputs, ref_out)
        if time_mode == "measured":
            t = graph_time(_variant_fn(kernel, genome), inputs)
        return t, err

    def feature_probe(genome: dict) -> dict:
        return schedule_features(kernel, genome, **shape)

    return KernelWorkload(
        name=f"kernel/{kernel}",
        program=space.encode(BASELINES[kernel]),
        space=space,
        runner=runner,
        static_probe=static_probe,
        feature_probe=feature_probe,
        time_mode=time_mode,
        spec=WorkloadSpec.make(
            "repro_torch.kernels.workloads:build_kernel_workload",
            kernel=kernel, time_mode=time_mode, seed=seed, device=str(dev)),
        tensor_spec=TensorFitnessSpec(blocks=(KernelBlock.make(
            kernel, shape, ERROR_KNOBS[kernel],
            lambda g: _kernel_error(kernel, g, inputs, ref_out)),)),
    )


# Extended choice lists for the joint (all-kernels) space.  Deliberately
# include values that do NOT divide the evaluation shapes (48/192 vs 512 and
# 256; 12/48 vs 128): those configurations fail the launchability gates.
_JOINT_SPACES: dict[str, dict[str, tuple]] = {
    "rmsnorm": {"impl": ("pallas", "ref"),
                "block_rows": (32, 48, 64, 128, 192, 256, 512),
                "epilogue": ("fused", "unfused")},
    "flash_attention": {"impl": ("pallas", "ref"),
                        "block_q": (16, 32, 48, 64, 128, 192, 256),
                        "block_k": (16, 32, 48, 64, 128, 192, 256)},
    "mamba_scan": {"impl": ("pallas", "ref"),
                   "chunk": (8, 12, 16, 32, 48, 64, 128)},
}


def joint_space() -> ScheduleSpace:
    """One schedule space over every kernel's knobs, prefixed
    ``<kernel>.<knob>``."""
    params = {f"{kernel}.{knob}": choices
              for kernel in KERNELS
              for knob, choices in _JOINT_SPACES[kernel].items()}
    return ScheduleSpace.of("kernel/joint", params)


def build_joint_kernel_workload(*, time_mode: str = "static", seed: int = 0,
                                device=None) -> KernelWorkload:
    """All three kernels as ONE genome: fitness is (sum of schedule times,
    max of kernel errors) over the prefixed joint space.  Static time only:
    a summed wall-clock of three separate launches measures dispatch, not
    schedules."""
    from ..core.tensor_evo.fitness import KernelBlock, TensorFitnessSpec

    if time_mode != "static":
        raise ValueError("joint workload supports time_mode='static' only")
    dev = resolve_device(device)
    space = joint_space()
    arrays = {k: numpy_inputs(k, seed) for k in KERNELS}
    inputs = {k: inputs_from_numpy(k, arrays[k], dev) for k in KERNELS}
    refs = {k: _ref_output(k, arrays[k]) for k in KERNELS}

    def sub_genome(genome: dict, kernel: str) -> dict:
        return {knob: genome[f"{kernel}.{knob}"]
                for knob in _JOINT_SPACES[kernel]}

    def static_probe(genome: dict) -> float:
        # gates first, in kernel order — the first unlaunchable kernel's
        # message is the variant's invalidity reason
        t = 0.0
        for kernel in KERNELS:
            t += schedule_time(kernel, sub_genome(genome, kernel),
                               **SHAPES[kernel])
        return t

    def runner(genome: dict) -> tuple[float, float]:
        t = static_probe(genome)
        err = None
        for kernel in KERNELS:
            e = _kernel_error(kernel, sub_genome(genome, kernel),
                              inputs[kernel], refs[kernel])
            err = e if err is None else max(err, e)
        return t, err

    def feature_probe(genome: dict) -> dict:
        feats: dict[str, float] = {}
        for kernel in KERNELS:
            sub = schedule_features(kernel, sub_genome(genome, kernel),
                                    **SHAPES[kernel])
            feats.update({f"{kernel}.{k}": v for k, v in sub.items()})
        return feats

    def error_fn(kernel: str):
        return lambda g: _kernel_error(kernel, g, inputs[kernel],
                                       refs[kernel])

    blocks = tuple(
        KernelBlock.make(
            kernel, SHAPES[kernel], ERROR_KNOBS[kernel], error_fn(kernel),
            knob_map={knob: f"{kernel}.{knob}"
                      for knob in _JOINT_SPACES[kernel]})
        for kernel in KERNELS)
    baseline = {f"{kernel}.{knob}": BASELINES[kernel][knob]
                for kernel in KERNELS
                for knob in _JOINT_SPACES[kernel]}
    return KernelWorkload(
        name="kernel/joint",
        program=space.encode(baseline),
        space=space,
        runner=runner,
        static_probe=static_probe,
        feature_probe=feature_probe,
        time_mode=time_mode,
        spec=WorkloadSpec.make(
            "repro_torch.kernels.workloads:build_joint_kernel_workload",
            time_mode=time_mode, seed=seed, device=str(dev)),
        tensor_spec=TensorFitnessSpec(blocks=blocks),
    )


def kernel_artifact(kernel: str, genome: dict,
                    fitness: tuple[float, float] | None = None,
                    meta: dict | None = None):
    """A deployable :class:`~repro_torch.core.deploy.Artifact` for one
    evolved kernel schedule, keyed by the kernel's evaluation shape — the
    form the registry stores and ``resolve_kernel_schedule`` looks up."""
    from ..core.deploy import Artifact
    return Artifact(kind="kernel", name=kernel, shape=SHAPES[kernel],
                    genome=dict(genome), fitness=fitness,
                    meta=dict(meta or {}))


def resolve_kernel_schedule(registry, kernel: str, shape=None) -> dict:
    """The schedule a path should run ``kernel`` with: the registry's
    winner for ``(kernel, shape)`` when one is registered and it decodes
    into the kernel's schedule space, else the shipped ``BASELINES``
    default.  ``registry=None`` gives the default, so call sites can be
    unconditional."""
    if registry is not None:
        art = registry.resolve(kernel, shape or SHAPES[kernel],
                               kind="kernel")
        if art is not None and kernel_space(kernel).contains(art.genome):
            return dict(art.genome)
    return dict(BASELINES[kernel])


def scheduled_kernel_fn(kernel: str, registry=None, shape=None):
    """The kernel as ``fn(inputs_dict) -> output`` under the resolved
    schedule (the registry's winner, else the shipped default): the hand-
    written kernel on CUDA tensors, its plain version on CPU tensors, as
    every wrapper call runs.  This is how a schedule search's winner
    reaches an execution path."""
    return _variant_fn(kernel, resolve_kernel_schedule(registry, kernel,
                                                       shape))


def evolve_kernel_schedule(workload, *, generations: int = 6,
                           pop_size: int = 10, seed: int = 0,
                           evaluator=None, verbose: bool = False,
                           err_tol: float = 1e-3, surrogate: bool = False,
                           surrogate_keep: float = 0.5):
    """The canonical kernel-schedule search configuration: NSGA-II over
    ``attr_tweak`` patches (a high mutation rate and a 2-tweak init drive
    the search; crossover recombines tweaks).

    Returns ``(search, result, best, within_tol)`` where ``best`` is the
    fastest Pareto member whose error stays within the default schedule's
    error + ``err_tol`` — or, when nothing meets the gate
    (``within_tol=False``), the fastest member outright.  The caller owns
    ``evaluator`` (or, when None, the search's internal one — closed by
    ``search.close()``).  ``surrogate`` adds the cache-trained pre-rank
    (:mod:`repro_torch.core.surrogate`), keeping ``surrogate_keep`` of each
    generation's novel candidates."""
    from ..core.search import GevoML
    s = GevoML(workload, pop_size=pop_size, n_elite=pop_size // 2,
               seed=seed, init_mutations=2, mutation_rate=0.9,
               operators={"attr_tweak": 1.0}, evaluator=evaluator,
               verbose=verbose, surrogate=surrogate,
               surrogate_keep=surrogate_keep)
    res = s.run(generations=generations)
    _, e_def = res.original_fitness
    ok = [i for i in res.pareto if i.fitness[1] <= e_def + err_tol]
    best = min(ok or res.pareto, key=lambda i: i.fitness[0])
    return s, res, best, bool(ok)
