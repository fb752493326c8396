"""Schedule genomes as HLO-lite programs — kernel tuning on the Patch algebra.

The original GEVO frames schedule knobs (block sizes, launch geometry,
implementation choice) and code edits as ONE search space.  This module makes
that literal for the repo: a :class:`ScheduleSpace` encodes a schedule genome
*as an HLO-lite program* — one scalar ``i32`` constant op per knob, whose
``attrs`` carry the knob name and its declared choice list, with the stored
value an index into the choices.  Because the genome IS a
:class:`~repro_torch.core.ir.Program`:

* the ``attr_tweak`` edit operator (:mod:`repro_torch.core.edits.schedule_ops`)
  mutates it through the same registry as ``delete``/``copy``/...;
* a schedule variant is a first-class :class:`~repro_torch.core.edits.Patch`, so it
  gets canonical hashing, doc round-trip, ddmin ``minimize_patch``, and the
  persistent :class:`~repro_torch.core.evaluator.FitnessCache` for free;
* ``program_fingerprint`` covers the knob names, choice lists, and baseline
  indices, so cache keys distinguish schedule spaces exactly.

Grid shape is derived (``dim // block``), and the block-size choice lists are
declared against shapes they divide, so every genome in a space is launchable
— property-tested in ``tests/test_schedule.py``.  Consumers are
:class:`~repro_torch.core.fitness.KernelWorkload` (the hand-written CUDA
kernels, ``repro_torch.kernels.workloads``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ir import Program


class ScheduleError(Exception):
    """A program is not (or no longer) a well-formed genome of this space —
    e.g. another edit kind deleted or cloned a knob constant.  The fitness
    layer folds this into variant invalidity."""


def _knob_ops(prog: Program):
    return [op for op in prog.ops
            if op.opcode == "constant" and "knob" in op.attrs]


@dataclass(frozen=True)
class ScheduleSpace:
    """An ordered set of categorical schedule knobs ``name -> choices``.

    ``params`` is a tuple of ``(knob, choices)`` pairs; choices are JSON-able
    scalars (ints, floats, strings, bools) so encoded programs serialize and
    fingerprint canonically."""

    name: str
    params: tuple[tuple[str, tuple], ...]

    @staticmethod
    def of(name: str, params) -> "ScheduleSpace":
        """Build from a ``{knob: choices}`` mapping (insertion-ordered)."""
        items = params.items() if isinstance(params, dict) else params
        return ScheduleSpace(name, tuple((k, tuple(v)) for k, v in items))

    def __post_init__(self):
        seen = set()
        for knob, choices in self.params:
            if knob in seen:
                raise ValueError(f"duplicate knob {knob!r}")
            seen.add(knob)
            if len(choices) < 1:
                raise ValueError(f"knob {knob!r} has no choices")
            if len(set(choices)) != len(choices):
                raise ValueError(f"knob {knob!r} has duplicate choices")

    # -- queries ------------------------------------------------------------
    def names(self) -> tuple[str, ...]:
        return tuple(k for k, _ in self.params)

    def choices(self, knob: str) -> tuple:
        for k, c in self.params:
            if k == knob:
                return c
        raise KeyError(knob)

    def size(self) -> int:
        n = 1
        for _, c in self.params:
            n *= len(c)
        return n

    def default(self) -> dict:
        """The all-first-choice genome (builders usually encode an explicit
        baseline instead)."""
        return {k: c[0] for k, c in self.params}

    def random(self, rng: np.random.Generator) -> dict:
        return {k: c[int(rng.integers(len(c)))] for k, c in self.params}

    def contains(self, genome: dict) -> bool:
        return (set(genome) == set(self.names())
                and all(genome[k] in c for k, c in self.params))

    # -- genome <-> HLO-lite program ----------------------------------------
    def encode(self, genome: dict | None = None) -> Program:
        """The genome as an HLO-lite program: one scalar i32 constant per
        knob, value = index into the knob's choices; every knob is a program
        output.  This is the ``KernelWorkload.program`` the search patches."""
        genome = dict(self.default(), **(genome or {}))
        if not self.contains(genome):
            raise ScheduleError(
                f"genome {genome} not in space {self.name!r}")
        prog = Program(name=f"schedule/{self.name}")
        for knob, choices in self.params:
            v = prog.add_op(
                "constant", [],
                {"value": np.asarray(choices.index(genome[knob]), np.int32),
                 "dtype": "i32", "knob": knob, "choices": choices})
            prog.outputs.append(v)
        prog.verify()
        return prog

    def decode(self, prog: Program) -> dict:
        """Recover the genome; raises :class:`ScheduleError` if the program
        was mangled out of the space (knob missing/duplicated, index out of
        range, choices drifted from this space's declaration)."""
        genome: dict = {}
        for op in _knob_ops(prog):
            knob = op.attrs["knob"]
            if knob in genome:
                raise ScheduleError(f"knob {knob!r} duplicated")
            try:
                declared = self.choices(knob)
            except KeyError:
                raise ScheduleError(f"unknown knob {knob!r}") from None
            if tuple(op.attrs.get("choices", ())) != declared:
                raise ScheduleError(f"knob {knob!r} choices drifted")
            idx = int(op.attrs["value"])
            if not 0 <= idx < len(declared):
                raise ScheduleError(f"knob {knob!r} index {idx} out of range")
            genome[knob] = declared[idx]
        missing = set(self.names()) - set(genome)
        if missing:
            raise ScheduleError(f"knobs {sorted(missing)} missing")
        return genome

    def describe(self, prog: Program) -> str:
        g = self.decode(prog)
        return ", ".join(f"{k}={g[k]}" for k in self.names())
