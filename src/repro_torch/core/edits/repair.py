"""Typed use-def repair shared by all edit operators.

* **tensor-resize repair** — when no same-typed value exists, a randomly
  chosen value is *resized* to fit: shrink by slicing values off the tensor's
  edges (centered), grow by padding with constant **1** (paper Figure 3).
  Donor values whose trailing dim is a multiple of 128 get a small bonus;
  the score is kept exactly as in :mod:`repro.core.edits.repair`, so a
  seeded edit repairs a program into the same variant in both packages.
* ``pick_donor``/``rebind_use`` — scored donor selection + slot rewiring used
  by delete (dangling uses), copy (operand reconnection), and insert
  (operand-replace).
* ``retype`` — post-edit type recomputation; raises :class:`EditError` when a
  repair left the program type-incorrect (repair should prevent this).
"""

from __future__ import annotations

import numpy as np

from ..ir import IRTypeError, Program, TensorType
from .base import EditError


def resize_value(prog: Program, value: int, target: TensorType,
                 insert_at: int) -> tuple[int, int]:
    """Insert pad/slice/reshape/convert ops so ``value`` becomes ``target``.

    Returns (new_value, new_insert_cursor).  Shrinking slices centered
    (dropping values from the tensor's edges); growing pads with value 1.
    """
    cur = prog.type_of(value)
    if cur.dtype != target.dtype:
        value = prog.add_op("convert", [value], {"new_dtype": target.dtype},
                            insert_at=insert_at)
        insert_at += 1
        cur = prog.type_of(value)

    # Rank adjustment: add leading 1-dims, or slice+drop extra leading dims.
    if cur.rank < target.rank:
        new_shape = (1,) * (target.rank - cur.rank) + cur.shape
        value = prog.add_op("reshape", [value], {"new_shape": new_shape},
                            insert_at=insert_at)
        insert_at += 1
    elif cur.rank > target.rank:
        extra = cur.rank - target.rank
        limit = (1,) * extra + cur.shape[extra:]
        if cur.shape[:extra] != (1,) * extra:
            value = prog.add_op(
                "slice", [value],
                {"start": (0,) * cur.rank, "limit": limit,
                 "strides": (1,) * cur.rank}, insert_at=insert_at)
            insert_at += 1
        value = prog.add_op("reshape", [value],
                            {"new_shape": cur.shape[extra:]},
                            insert_at=insert_at)
        insert_at += 1
    cur = prog.type_of(value)

    # Per-dim shrink (centered slice) then grow (pad with 1).
    if any(c > t for c, t in zip(cur.shape, target.shape)):
        start = tuple((c - t) // 2 if c > t else 0
                      for c, t in zip(cur.shape, target.shape))
        limit = tuple(s + min(c, t) for s, c, t
                      in zip(start, cur.shape, target.shape))
        value = prog.add_op("slice", [value],
                            {"start": start, "limit": limit,
                             "strides": (1,) * cur.rank}, insert_at=insert_at)
        insert_at += 1
        cur = prog.type_of(value)
    if any(c < t for c, t in zip(cur.shape, target.shape)):
        low = tuple((t - c) // 2 for c, t in zip(cur.shape, target.shape))
        high = tuple(t - c - l for c, t, l
                     in zip(cur.shape, target.shape, low))
        value = prog.add_op("pad", [value],
                            {"low": low, "high": high, "value": 1.0},
                            insert_at=insert_at)
        insert_at += 1
    assert prog.type_of(value) == target
    return value, insert_at


def pick_donor(prog: Program, scope: list[int], target: TensorType,
               rng: np.random.Generator, exclude: set[int] = frozenset()
               ) -> tuple[int, bool]:
    """Pick an in-scope value to stand in for a ``target``-typed use.

    Returns (value, needs_resize).  Prefers exact type matches; among
    resize donors, prefers same-dtype and 128-aligned (last dim % 128 == 0 or
    matching) shapes.
    """
    cands = [v for v in scope if v not in exclude]
    if not cands:
        raise EditError("no in-scope values to rebind")
    exact = [v for v in cands if prog.type_of(v) == target]
    if exact:
        return exact[int(rng.integers(len(exact)))], False

    def score(v: int) -> float:
        t = prog.type_of(v)
        s = 0.0
        if t.dtype == target.dtype:
            s += 4.0
        if t.rank == target.rank:
            s += 2.0
        if t.shape and target.shape and t.shape[-1] == target.shape[-1]:
            s += 2.0
        if t.shape and t.shape[-1] % 128 == 0:
            s += 0.5  # 128-aligned donor (same score as the reference)
        return s

    weights = np.array([score(v) + 1e-3 for v in cands])
    probs = weights / weights.sum()
    return int(cands[int(rng.choice(len(cands), p=probs))]), True


def rebind_use(prog: Program, op_index: int, slot: int, target: TensorType,
               rng: np.random.Generator, exclude: set[int]) -> int:
    """Rebind operand ``slot`` of op at ``op_index`` to a repaired donor.
    Returns how many ops were inserted (callers must shift indices)."""
    scope = prog.defs_before(op_index)
    donor, needs = pick_donor(prog, scope, target, rng, exclude)
    inserted = 0
    if needs:
        cursor = op_index
        donor, new_cursor = resize_value(prog, donor, target, cursor)
        inserted = new_cursor - cursor
    prog.ops[op_index + inserted].operands[slot] = donor
    return inserted


def retype(prog: Program) -> None:
    """Recompute result types downstream of rebinds; raise EditError if the
    program no longer type-checks (repair should prevent this)."""
    from ..ir import infer_type
    env = {vid: t for _, vid, t in prog.inputs}
    for op in prog.ops:
        try:
            op.type = infer_type(op.opcode, [env[o] for o in op.operands],
                                 op.attrs)
        except (KeyError, IRTypeError) as e:
            raise EditError(f"retype failed at {op.opcode}: {e}") from e
        env[op.result] = op.type
