"""Patch/schedule featurizers: the numeric vectors the surrogate regresses.

Two workload families, two featurizers, one contract — ``__call__(patch)``
returns a fixed-length ``list[float]`` (raising when the patch cannot be
featurized; callers treat that as "pass through unranked"):

* :class:`ScheduleFeaturizer` — schedule-space workloads
  (:class:`~repro_torch.core.fitness.KernelWorkload`).  One-hot per knob choice
  (the genome is categorical; a linear model over one-hots is a full
  per-choice lookup table), plus the workload's ``feature_probe`` counters
  when present — the roofline/shared-memory terms
  ``kernels.costs.schedule_features`` already computes for the launch gates.
* :class:`ProgramFeaturizer` — program-patching workloads
  (e.g. :class:`~repro_torch.core.fitness.PredictionWorkload`).  Edit-kind counts,
  canonical-normal-form structure (:mod:`repro_torch.core.analysis.dataflow`:
  normalized op count, dead ops, opcode histogram) and the static roofline
  time (the port's H100 rates) — features of *what the patch did*, not just
  what it says.

Feature order is fixed at construction (knob/choice declaration order,
sorted probe keys, sorted vocabularies), so vectors from different processes
over the same workload align — a requirement for training on a shared
persistent FitnessCache.
"""

from __future__ import annotations

import math

import numpy as np

from ..analysis.dataflow import dead_ops, normalize
from ..edits import Patch, registered_ops
from ..fitness import static_time


class ScheduleFeaturizer:
    """Genome -> one-hot knob choices (+ sorted ``feature_probe`` counters).

    ``of_genome`` featurizes a decoded genome directly (the tensor engine's
    path — no Patch round-trip); ``__call__`` featurizes a patch by applying
    it to the workload baseline and decoding, raising
    :class:`~repro_torch.core.schedule.ScheduleError` on mangled programs."""

    def __init__(self, workload):
        self.workload = workload
        self.space = workload.space
        self.probe = getattr(workload, "feature_probe", None)
        self._knobs = tuple((k, self.space.choices(k))
                            for k in self.space.names())
        names = [f"{knob}={c!r}" for knob, choices in self._knobs
                 for c in choices]
        self._probe_keys: tuple[str, ...] = ()
        if self.probe is not None:
            # probe the baseline once to pin the counter-key order
            base = self.space.decode(workload.program)
            self._probe_keys = tuple(sorted(self.probe(base)))
            names += list(self._probe_keys)
        self.feature_names = tuple(names)

    def of_genome(self, genome: dict) -> list[float]:
        row = [1.0 if genome[knob] == c else 0.0
               for knob, choices in self._knobs for c in choices]
        if self.probe is not None:
            d = self.probe(genome)
            row += [float(d.get(k, 0.0)) for k in self._probe_keys]
        return row

    def __call__(self, patch) -> list[float]:
        prog = Patch.coerce(patch).apply(self.workload.program)
        return self.of_genome(self.space.decode(prog))


class ProgramFeaturizer:
    """Patch -> edit-kind counts + normal-form structure + static roofline.

    The opcode histogram vocabulary is the baseline program's opcodes (plus
    an ``other`` bucket for opcodes edits introduce), so the vector length
    is fixed per workload."""

    def __init__(self, workload):
        self.workload = workload
        base = workload.program
        self._kinds = tuple(sorted(registered_ops()))
        self._opcodes = tuple(sorted({op.opcode for op in base.ops}))
        self._base_time = static_time(base)
        self.feature_names = tuple(
            ["n_edits"]
            + [f"edit:{k}" for k in self._kinds]
            + ["n_ops", "n_norm_ops", "n_dead",
               "log_static_time", "d_static_time"]
            + [f"op:{o}" for o in self._opcodes] + ["op:other"])

    def __call__(self, patch) -> list[float]:
        p = Patch.coerce(patch)
        prog = p.apply(self.workload.program)
        norm = normalize(prog)
        t = static_time(prog)
        kinds = p.kinds()
        hist = {o: 0 for o in self._opcodes}
        other = 0
        for op in norm.ops:
            if op.opcode in hist:
                hist[op.opcode] += 1
            else:
                other += 1
        row = [float(len(p))]
        row += [float(sum(1 for k in kinds if k == kind))
                for kind in self._kinds]
        row += [float(len(prog.ops)), float(len(norm.ops)),
                float(len(dead_ops(prog))),
                math.log(max(t, 1e-30)), t - self._base_time]
        row += [float(hist[o]) for o in self._opcodes]
        row.append(float(other))
        return row


def make_featurizer(workload):
    """The featurizer matching a workload's family, or None when nothing
    applies (no schedule space and no patchable program)."""
    if getattr(workload, "space", None) is not None:
        return ScheduleFeaturizer(workload)
    if getattr(workload, "program", None) is not None:
        return ProgramFeaturizer(workload)
    return None


def feature_matrix(featurizer, patches) -> np.ndarray:
    """Stack featurizations; raises if any patch fails (callers that want
    pass-through semantics featurize one at a time)."""
    return np.asarray([featurizer(p) for p in patches], float)
