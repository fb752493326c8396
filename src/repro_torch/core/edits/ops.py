"""The built-in edit operators, registered on import.

* ``delete`` / ``copy`` — the paper's Section 4.1 operators, ported onto the
  :class:`~repro_torch.core.edits.base.EditOp` protocol (sharing the tensor-resize
  repair in :mod:`repro_torch.core.edits.repair`).
* ``swap`` — exchange two same-typed operand bindings between two ops
  (GEVO's swap, restricted to type-preserving exchanges so repair is never
  needed).
* ``insert`` — operand-replace: rewire one operand of an op to another
  in-scope value, repaired to type (GEVO's operand-replacement mutation).
* ``const_perturb`` — scale a scalar float constant (the "learning-rate-like"
  mutation the paper's Section 6 analysis attributes wins to: changing
  effective learning rates / gradient scales).
"""

from __future__ import annotations

import numpy as np

from ..ir import Program, TensorType
from .base import Edit, EditError, EditOp, register_edit
from .repair import pick_donor, rebind_use, resize_value


def _seed(rng: np.random.Generator) -> int:
    return int(rng.integers(2 ** 31))


@register_edit("delete")
class DeleteOp(EditOp):
    """Remove an operation; every dangling use of its result is rebound to
    another in-scope value of the same type, chosen at random."""

    def propose(self, prog: Program, rng: np.random.Generator) -> Edit:
        if not prog.ops:
            raise EditError("empty program")
        uids = [op.uid for op in prog.ops]
        return Edit("delete", target_uid=int(rng.choice(uids)),
                    seed=_seed(rng))

    def apply(self, prog: Program, edit: Edit,
              rng: np.random.Generator) -> None:
        idx = prog.op_index_by_uid(edit.target_uid)
        if idx is None:
            raise EditError(f"delete target uid {edit.target_uid} not found")
        victim = prog.ops.pop(idx)
        dead = {victim.result}
        # Repair dangling operand uses (scan repeatedly: repairs insert ops).
        i = 0
        while i < len(prog.ops):
            op = prog.ops[i]
            for slot, o in enumerate(op.operands):
                if o in dead:
                    i += rebind_use(prog, i, slot, victim.type, rng, dead)
                    break
            else:
                i += 1
                continue
        # Repair dangling outputs.
        for k, o in enumerate(prog.outputs):
            if o in dead:
                scope = prog.defs_before(len(prog.ops))
                donor, needs = pick_donor(prog, scope, victim.type, rng, dead)
                if needs:
                    donor, _ = resize_value(prog, donor, victim.type,
                                            len(prog.ops))
                prog.outputs[k] = donor


@register_edit("copy")
class CopyOp(EditOp):
    """Clone an operation to another program point, rebind its operands to
    in-scope values, and splice its result into a downstream operation
    (paper Figure 5: the copied broadcast replaces the 1/batch constant)."""

    def propose(self, prog: Program, rng: np.random.Generator) -> Edit:
        if not prog.ops:
            raise EditError("empty program")
        uids = [op.uid for op in prog.ops]
        return Edit("copy", target_uid=int(rng.choice(uids)),
                    dest_uid=int(rng.choice(uids)), seed=_seed(rng))

    def apply(self, prog: Program, edit: Edit,
              rng: np.random.Generator) -> None:
        src_idx = prog.op_index_by_uid(edit.target_uid)
        dst_idx = prog.op_index_by_uid(edit.dest_uid)
        if src_idx is None or dst_idx is None:
            raise EditError("copy anchors not found")
        src = prog.ops[src_idx]
        if src.opcode == "constant":
            clone_operand_types: list[TensorType] = []
        else:
            clone_operand_types = [prog.type_of(o) for o in src.operands]

        clone = src.clone()
        clone.result = prog.fresh_value()
        clone.uid = prog.fresh_uid()
        prog.ops.insert(dst_idx, clone)
        pos = dst_idx

        # Rebind clone operands to in-scope values ("connects variables").
        scope = set(prog.defs_before(pos))
        for slot, (o, t) in enumerate(zip(list(clone.operands),
                                          clone_operand_types)):
            if o in scope:
                continue
            inserted = rebind_use(prog, pos, slot, t, rng, {clone.result})
            pos += inserted
            scope = set(prog.defs_before(pos))

        # Splice the clone's result into a downstream consumer.
        consumer_idx = None
        for j in range(pos + 1, len(prog.ops)):
            if prog.ops[j].operands:
                consumer_idx = j
                break
        if consumer_idx is None:
            # No downstream op with operands: rewire a program output instead.
            k = int(rng.integers(len(prog.outputs)))
            target = prog.type_of(prog.outputs[k])
            v = clone.result
            if prog.type_of(v) != target:
                v, _ = resize_value(prog, v, target, len(prog.ops))
            prog.outputs[k] = v
            return
        consumer = prog.ops[consumer_idx]
        slot = int(rng.integers(len(consumer.operands)))
        target = prog.type_of(consumer.operands[slot])
        v = clone.result
        if prog.type_of(v) != target:
            v, _ = resize_value(prog, v, target, consumer_idx)
        consumer.operands[slot] = v

    def describe(self, edit: Edit) -> str:
        return f"copy(uid={edit.target_uid} -> before uid={edit.dest_uid})"


@register_edit("swap")
class SwapOp(EditOp):
    """Exchange one operand binding between two operations, restricted to
    pairs whose bindings have identical types (so no downstream type
    changes and no repair).  The RNG (seeded by the edit) picks among the
    scope-legal same-typed slot pairs."""

    def propose(self, prog: Program, rng: np.random.Generator) -> Edit:
        # Bucket operand bindings by type so anchors are drawn from pairs
        # that can actually swap (uniform op-pair sampling almost never
        # lands on one: same type + scope legality is a ~2% hit rate).
        buckets: dict[object, list[tuple[int, int]]] = {}
        for idx, op in enumerate(prog.ops):
            for v in op.operands:
                buckets.setdefault(prog.type_of(v), []).append((idx, v))
        cands = [b for b in buckets.values()
                 if len({v for _, v in b}) > 1]
        if not cands:
            raise EditError("no same-typed operand pair to swap")
        for _ in range(32):
            b = cands[int(rng.integers(len(cands)))]
            (ia, va), (ib, vb) = (b[int(rng.integers(len(b)))]
                                  for _ in range(2))
            if ia == ib or va == vb:
                continue
            if ia > ib:
                (ia, va), (ib, vb) = (ib, vb), (ia, va)
            # later op's binding must be in scope at the earlier op
            if vb in set(prog.defs_before(ia)):
                return Edit("swap", target_uid=prog.ops[ia].uid,
                            dest_uid=prog.ops[ib].uid, seed=_seed(rng))
        raise EditError("no same-typed operand pair to swap")

    def apply(self, prog: Program, edit: Edit,
              rng: np.random.Generator) -> None:
        ia = prog.op_index_by_uid(edit.target_uid)
        ib = prog.op_index_by_uid(edit.dest_uid)
        if ia is None or ib is None:
            raise EditError("swap anchors not found")
        if ia == ib:
            raise EditError("swap needs two distinct ops")
        if ia > ib:
            ia, ib = ib, ia
        a, b = prog.ops[ia], prog.ops[ib]
        # The later op's operand moves to the earlier op, so it must already
        # be in scope there (this also excludes a's own result cycling back).
        scope_a = set(prog.defs_before(ia))
        pairs = []
        for sa, va in enumerate(a.operands):
            ta = prog.type_of(va)
            for sb, vb in enumerate(b.operands):
                if vb != va and vb in scope_a and prog.type_of(vb) == ta:
                    pairs.append((sa, sb))
        if not pairs:
            raise EditError("no same-typed operand pair to swap")
        sa, sb = pairs[int(rng.integers(len(pairs)))]
        a.operands[sa], b.operands[sb] = b.operands[sb], a.operands[sa]

    def describe(self, edit: Edit) -> str:
        return f"swap(uid={edit.target_uid} <-> uid={edit.dest_uid})"


@register_edit("insert")
class InsertOp(EditOp):
    """Operand-replace: rewire one randomly chosen operand of the target op
    to a different in-scope value, tensor-resize-repaired to the slot's
    type.  This is GEVO's insert/operand-replacement — it introduces a new
    dataflow edge without cloning any computation."""

    def propose(self, prog: Program, rng: np.random.Generator) -> Edit:
        uids = [op.uid for op in prog.ops if op.operands]
        if not uids:
            raise EditError("no operand-bearing ops to rewire")
        return Edit("insert", target_uid=int(rng.choice(uids)),
                    seed=_seed(rng))

    def apply(self, prog: Program, edit: Edit,
              rng: np.random.Generator) -> None:
        idx = prog.op_index_by_uid(edit.target_uid)
        if idx is None:
            raise EditError(f"insert target uid {edit.target_uid} not found")
        op = prog.ops[idx]
        if not op.operands:
            raise EditError("insert target has no operands")
        slot = int(rng.integers(len(op.operands)))
        current = op.operands[slot]
        rebind_use(prog, idx, slot, prog.type_of(current), rng, {current})

    def describe(self, edit: Edit) -> str:
        return f"insert(rewire an operand of uid={edit.target_uid})"


@register_edit("const_perturb")
class ConstPerturbOp(EditOp):
    """Scale a scalar float constant by ``edit.param`` — the
    "learning-rate-like" mutation: on the 2fcNet step the eligible targets
    are exactly the lr, 1/batch, and epsilon constants whose perturbation
    the paper's Section 6 analysis credits for accuracy wins."""

    SCALES = (0.1, 0.2, 0.5, 0.8, 1.25, 2.0, 5.0, 10.0)

    @staticmethod
    def _targets(prog: Program) -> list[int]:
        return [op.uid for op in prog.ops
                if op.opcode == "constant" and op.type.size == 1
                and op.type.dtype in ("f32", "bf16")]

    def propose(self, prog: Program, rng: np.random.Generator) -> Edit:
        uids = self._targets(prog)
        if not uids:
            raise EditError("no scalar float constants to perturb")
        scale = float(self.SCALES[int(rng.integers(len(self.SCALES)))])
        return Edit("const_perturb", target_uid=int(rng.choice(uids)),
                    seed=_seed(rng), param=scale)

    def apply(self, prog: Program, edit: Edit,
              rng: np.random.Generator) -> None:
        idx = prog.op_index_by_uid(edit.target_uid)
        if idx is None:
            raise EditError(
                f"const_perturb target uid {edit.target_uid} not found")
        op = prog.ops[idx]
        if (op.opcode != "constant" or op.type.size != 1
                or op.type.dtype not in ("f32", "bf16")):
            raise EditError("const_perturb target is not a scalar float "
                            "constant")
        if edit.param == 0.0:
            raise EditError("const_perturb scale must be non-zero")
        value = op.attrs["value"]
        op.attrs["value"] = np.asarray(value * np.float32(edit.param),
                                       dtype=value.dtype)

    def describe(self, edit: Edit) -> str:
        return f"const_perturb(uid={edit.target_uid} *= {edit.param:g})"
