"""The schedule edit operator, registered on import (with the built-ins).

``attr_tweak`` retargets one schedule-knob constant (an op carrying ``knob``
/ ``choices`` attrs, see :mod:`repro_torch.core.schedule`) to another of its
declared choices.  It is how kernel-schedule search and GEVO-Shard vary
genomes through the same registry, Patch hashing, and evaluator engine as
the IR-level operators; on programs without knob constants it proposes
nothing (``EditError``), so it is inert in plain IR searches.
"""

from __future__ import annotations

import numpy as np

from ..ir import Program
from .base import Edit, EditError, EditOp, register_edit
from .ops import _seed


@register_edit("attr_tweak")
class AttrTweakOp(EditOp):
    """Set a schedule-knob constant to another of its declared choices.

    ``param`` is the new choice *index* (a small non-negative integer stored
    in the Edit's float slot); apply validates it against the knob's declared
    choice list, so a crossover that lands a tweak on a different knob with
    fewer choices fails as :class:`EditError`, never out-of-range."""

    universal = False  # targets schedule programs; excluded from "all" mix

    @staticmethod
    def _targets(prog: Program) -> list:
        return [op for op in prog.ops
                if op.opcode == "constant" and "knob" in op.attrs
                and len(op.attrs.get("choices", ())) > 1]

    def propose(self, prog: Program, rng: np.random.Generator) -> Edit:
        targets = self._targets(prog)
        if not targets:
            raise EditError("no schedule knobs to tweak")
        op = targets[int(rng.integers(len(targets)))]
        cur = int(op.attrs["value"])
        alts = [i for i in range(len(op.attrs["choices"])) if i != cur]
        idx = alts[int(rng.integers(len(alts)))]
        return Edit("attr_tweak", target_uid=op.uid, seed=_seed(rng),
                    param=float(idx))

    def apply(self, prog: Program, edit: Edit,
              rng: np.random.Generator) -> None:
        i = prog.op_index_by_uid(edit.target_uid)
        if i is None:
            raise EditError(
                f"attr_tweak target uid {edit.target_uid} not found")
        op = prog.ops[i]
        if op.opcode != "constant" or "knob" not in op.attrs:
            raise EditError("attr_tweak target is not a schedule knob")
        idx = int(edit.param)
        if idx != edit.param or not 0 <= idx < len(op.attrs["choices"]):
            raise EditError(
                f"attr_tweak choice {edit.param!r} out of range for knob "
                f"{op.attrs['knob']!r}")
        op.attrs["value"] = np.asarray(idx, dtype=op.attrs["value"].dtype)

    def describe(self, edit: Edit) -> str:
        return (f"attr_tweak(uid={edit.target_uid} := "
                f"choice[{int(edit.param)}])")
