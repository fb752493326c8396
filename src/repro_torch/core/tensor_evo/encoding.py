"""Fixed-shape array encoding for :class:`ScheduleSpace` genomes.

A population is an ``(pop, n_knobs)`` int32 matrix of *choice indices* —
the tensorized twin of the per-knob ``i32`` constant ops a schedule program
carries (:mod:`repro_torch.core.schedule`).  The encoding round-trips
through the engine's canonical representations:

* **index row <-> genome dict** — gather through the space's choice lists;
* **index row <-> Patch** — the *canonical patch* of a row is one
  ``attr_tweak`` edit per knob whose index differs from the baseline
  program, in declared knob order, with a fixed seed (``attr_tweak.apply``
  consumes no randomness, so the fixed seed is sound and the patch — and
  therefore its content hash — is a pure function of the row).  Applying
  the canonical patch to the baseline program and decoding it recovers the
  row bit-exactly, which is how tensor-engine results re-enter the
  Patch/doc world (fronts, deployment, the fitness cache).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..edits import Patch
from ..edits.base import Edit
from ..schedule import ScheduleSpace

# attr_tweak.apply is seed-free, so canonical patches pin this value; it is
# part of the canonical-patch identity (changing it would change hashes).
CANONICAL_SEED = 0


@dataclass(frozen=True)
class GenomeEncoding:
    """Array <-> genome/Patch codec for one space over one baseline program.

    ``program`` must be the workload's baseline (the program patches apply
    to): knob-constant uids and baseline indices are read from it."""

    space: ScheduleSpace
    knob_uids: tuple[int, ...]      # uid of each knob's constant op
    base_idx: tuple[int, ...]       # baseline choice index per knob
    _tables: dict = field(default_factory=dict, hash=False, compare=False)

    @staticmethod
    def of(space: ScheduleSpace, program) -> "GenomeEncoding":
        by_knob = {op.attrs["knob"]: op for op in program.ops
                   if op.opcode == "constant" and "knob" in op.attrs}
        missing = set(space.names()) - set(by_knob)
        if missing:
            raise ValueError(f"program lacks knob constants {sorted(missing)}")
        uids, base = [], []
        for knob, choices in space.params:
            op = by_knob[knob]
            if tuple(op.attrs.get("choices", ())) != choices:
                raise ValueError(f"knob {knob!r} choices drifted from space")
            uids.append(op.uid)
            base.append(int(op.attrs["value"]))
        return GenomeEncoding(space=space, knob_uids=tuple(uids),
                              base_idx=tuple(base))

    # -- shape/choice metadata ----------------------------------------------
    @property
    def n_knobs(self) -> int:
        return len(self.space.params)

    def n_choices(self) -> np.ndarray:
        return np.array([len(c) for _, c in self.space.params], np.int32)

    def choice_values(self, knob: str) -> tuple:
        return self.space.choices(knob)

    def baseline_row(self) -> np.ndarray:
        return np.array(self.base_idx, np.int32)

    # -- index row <-> genome dict -------------------------------------------
    def indices_of(self, genome: dict) -> np.ndarray:
        return np.array([choices.index(genome[k])
                         for k, choices in self.space.params], np.int32)

    def genome_of(self, row) -> dict:
        row = np.asarray(row)
        return {k: choices[int(row[j])]
                for j, (k, choices) in enumerate(self.space.params)}

    # -- index row <-> canonical Patch --------------------------------------
    def to_patch(self, row) -> Patch:
        """The canonical attr_tweak patch producing ``row`` from the
        baseline: one edit per differing knob, declared knob order."""
        row = np.asarray(row)
        edits = []
        for j, uid in enumerate(self.knob_uids):
            idx = int(row[j])
            if not 0 <= idx < len(self.space.params[j][1]):
                raise ValueError(f"knob {self.space.params[j][0]!r} index "
                                 f"{idx} out of range")
            if idx != self.base_idx[j]:
                edits.append(Edit("attr_tweak", target_uid=uid,
                                  seed=CANONICAL_SEED, param=float(idx)))
        return Patch(tuple(edits))

    def from_patch(self, patch, program) -> np.ndarray:
        """Index row of an arbitrary patch (canonical or search-produced):
        apply it to the baseline and decode.  Raises
        :class:`~repro_torch.core.edits.EditError` /
        :class:`~repro_torch.core.schedule.ScheduleError` exactly where the
        serial path would."""
        genome = self.space.decode(Patch.coerce(patch).apply(program))
        return self.indices_of(genome)

    # -- gather tables for batched fitness -----------------------------------
    def value_table(self, knob: str, flag=None) -> np.ndarray:
        """Per-choice lookup table for one knob: numeric choice values
        (``flag=None``) or the boolean ``choice == flag`` mask.  Cached per
        (knob, flag); gather with ``table[idx_matrix[:, j]]``."""
        key = (knob, flag)
        if key not in self._tables:
            choices = self.space.choices(knob)
            if flag is None:
                self._tables[key] = np.asarray(choices, np.int64)
            else:
                self._tables[key] = np.array([c == flag for c in choices])
        return self._tables[key]

    def knob_pos(self, knob: str) -> int:
        for j, (k, _) in enumerate(self.space.params):
            if k == knob:
                return j
        raise KeyError(knob)
