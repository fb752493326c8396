"""The per-epoch island runner: one function, two transports.

``run_island_epoch`` advances one island to a target generation.  It is a
plain top-level function so the orchestrator can call it directly
(in-process mode) or ship it to a spawned worker process (process mode) —
both paths execute identical code, and because candidate generation is
RNG-driven and ``static`` fitness is deterministic, both produce bit-equal
checkpoints.

Workload transport: a spawned worker rebuilds the workload from the
deterministic :class:`~repro_torch.core.evaluator.WorkloadSpec` the builder
attached (which names the device), so no CUDA tensor crosses the process
boundary and the worker opens its own CUDA context only after it has
started; a workload without a spec travels by pickle.  The payload carries
the device the islands run on; a spawned worker that cannot reach it
raises :class:`~repro_torch.device.DeviceFault`, and so does a kernel build
or launch fault inside it.  All search state lives in the island's
checkpoint directory; the shared fitness cache file is the only channel
workers write concurrently (safe: the cache appends whole lines atomically
under an advisory lock).
"""

from __future__ import annotations

import importlib
import pickle
import traceback

from ...device import resolve_device
from ..edits import Patch
from ..evaluator import (FitnessCache, ParallelEvaluator, SerialEvaluator,
                         WorkloadSpec)
from ..fitness import DEVICE_FAULTS, DeviceFault
from .config import IslandSpec


def island_payload(workload, spec: IslandSpec, *, checkpoint_dir: str,
                   cache_path: str | None, generations: int, resume: bool,
                   migrants: list[dict] | None, pop_size: int,
                   n_elite: int, max_tries: int, eval_workers: int = 0,
                   verbose: bool = False, inline: bool = True,
                   screen: bool = False, surrogate: bool = False,
                   surrogate_keep: float = 0.5, device=None) -> dict:
    """Build the (picklable, unless ``inline``) argument doc for
    :func:`run_island_epoch`.  ``inline=True`` keeps the live workload
    object for in-process execution; ``inline=False`` converts it to
    spec-or-pickle transport for a spawned worker.  ``device``: where the
    island evaluates, resolved as the orchestrator resolves it (the GPU
    unless the caller names another)."""
    payload = {
        "island": spec.to_doc(),
        "checkpoint_dir": checkpoint_dir,
        "cache_path": cache_path,
        "generations": generations,
        "resume": resume,
        "migrants": migrants or [],
        "pop_size": pop_size,
        "n_elite": n_elite,
        "max_tries": max_tries,
        "eval_workers": eval_workers,
        "verbose": verbose,
        "screen": screen,
        "surrogate": surrogate,
        "surrogate_keep": surrogate_keep,
        "device": str(resolve_device(device)),
    }
    if inline:
        payload["workload"] = workload
        return payload
    payload["workload"] = None
    from ..edits import operator_modules
    mods = operator_modules()
    if "__main__" in mods:
        raise ValueError(
            "a custom edit operator is registered in __main__, which "
            "spawned island workers cannot re-import; move the "
            "@register_edit class into an importable module to use "
            "process-mode islands")
    payload["edit_modules"] = mods
    wl_spec = getattr(workload, "spec", None)
    if wl_spec is not None:
        payload["pickled"] = None
        payload["spec"] = wl_spec
        return payload
    try:
        payload["pickled"] = pickle.dumps(workload)
    except Exception as e:
        raise ValueError(
            f"workload {getattr(workload, 'name', '?')!r} is not "
            "picklable and has no WorkloadSpec; process-mode islands "
            "need one (or use in-process islands)") from e
    return payload


def _materialize_workload(payload: dict):
    if payload["workload"] is not None:
        return payload["workload"]
    import torch
    device = torch.device(payload["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceFault(f"island worker {payload['island']['name']!r} "
                          f"cannot reach {payload['device']}")
    if payload.get("threads"):
        torch.set_num_threads(payload["threads"])
    for mod in payload.get("edit_modules", ()):
        importlib.import_module(mod)   # re-register custom edit operators
    if payload.get("pickled") is not None:
        return pickle.loads(payload["pickled"])
    spec: WorkloadSpec = payload["spec"]
    return spec.build()


def run_island_epoch(payload: dict) -> dict:
    """Advance one island to ``payload["generations"]`` total generations,
    injecting ``payload["migrants"]`` (patch docs) iff the island has not
    yet checkpointed the epoch's first generation.  Returns a small summary
    doc; the authoritative state is the island's checkpoint directory.  In
    a spawned worker, a fault of the device or the kernel build comes back
    to the orchestrator as a :class:`DeviceFault` carrying the traceback."""
    if payload["workload"] is not None:
        return _run_island_epoch(payload)
    try:
        return _run_island_epoch(payload)
    except DEVICE_FAULTS as e:
        raise DeviceFault(
            f"in island worker {payload['island']['name']!r}: "
            f"{type(e).__name__}: {e}\n{traceback.format_exc()}") from None


def _run_island_epoch(payload: dict) -> dict:
    from ..search import GevoML   # late: workers import this module first

    workload = _materialize_workload(payload)
    spec = IslandSpec.from_doc(payload["island"])
    cache = FitnessCache(payload["cache_path"], writer=spec.name)
    if payload.get("eval_workers", 0) > 1:
        evaluator = ParallelEvaluator(workload,
                                      n_workers=payload["eval_workers"],
                                      cache=cache)
    else:
        evaluator = SerialEvaluator(workload, cache=cache)
    with evaluator:
        search = GevoML(
            workload,
            pop_size=spec.pop_size or payload["pop_size"],
            n_elite=spec.n_elite or payload["n_elite"],
            init_mutations=spec.init_mutations,
            crossover_rate=spec.crossover_rate,
            mutation_rate=spec.mutation_rate,
            max_tries=payload["max_tries"],
            seed=spec.seed,
            verbose=payload.get("verbose", False),
            operators=spec.operators,
            evaluator=evaluator,
            checkpoint_dir=payload["checkpoint_dir"],
            screen=payload.get("screen", False),
            surrogate=payload.get("surrogate", False),
            surrogate_keep=payload.get("surrogate_keep", 0.5))
        search.run(
            generations=payload["generations"],
            resume=payload["resume"],
            migrants=[Patch.from_doc(d["edits"])
                      for d in payload["migrants"]],
            on_generation=payload.get("on_generation"))
        return {"name": spec.name,
                "gen": payload["generations"] - 1,
                "evaluator": search.evaluator.stats()}
