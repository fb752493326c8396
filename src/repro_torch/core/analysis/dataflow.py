"""Dataflow analyses over the HLO-lite IR: def-use, liveness, folding, and
the canonical normal form.

These are the static facts the patch-effect classifier
(:mod:`repro_torch.core.analysis.classify`) trades executions for.  GEVO mutants
are overwhelmingly *structurally* boring — ``copy`` clones an op whose
result never reaches an output, ``delete`` + repair cancels itself out, two
different edit lists produce the same live computation — and every such fact
is decidable from the graph alone:

* :func:`live_values` / :func:`dead_ops` — backward reachability from the
  program outputs.  The interpreter executes *every* op in list order
  (:mod:`repro_torch.core.interp`), so an op whose result never reaches an output
  contributes nothing to any output value: eliminating it cannot change what
  the program computes (property-tested bit-exactly in
  ``tests/test_analysis_props.py``).
* :func:`fold_constants` — conservative compile-time evaluation.  Only ops
  whose numpy semantics are IEEE-identical to the interpreter (which
  follows jnp) on this repo's dtypes are folded (elementwise add/subtract/multiply/float-divide/
  maximum/minimum/negate/abs/sign, shape ops, select/compare), and a fold
  producing a non-finite float is abandoned — transcendentals, reductions,
  dot/conv, and anything ulp-hazardous stay in the program.
* :func:`normalize` — fold + DCE to a fixpoint: the canonical executable
  form of a variant.
* :func:`canonical_fingerprint` — a content hash of the normal form with
  SSA ids densely renumbered and mutation-bookkeeping (uids, counters)
  stripped, so two patches that produce the same live computation collide
  regardless of how they got there.  This is the ``equivalent`` key of the
  patch-effect classifier.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from ..ir import Operation, Program

# -- def-use / liveness ------------------------------------------------------


def def_use_chains(program: Program) -> dict[int, list[tuple[int, int]]]:
    """value id -> [(op_index, operand_slot)] for every use in the program.
    Inputs and op results both appear (with an empty list when unused)."""
    chains: dict[int, list[tuple[int, int]]] = {
        vid: [] for _, vid, _ in program.inputs}
    for op in program.ops:
        chains.setdefault(op.result, [])
    for i, op in enumerate(program.ops):
        for j, o in enumerate(op.operands):
            chains.setdefault(o, []).append((i, j))
    return chains


def live_values(program: Program) -> set[int]:
    """Value ids that can reach a program output (backward reachability; one
    reverse sweep suffices because ops are in topological order)."""
    live = set(program.outputs)
    for op in reversed(program.ops):
        if op.result in live:
            live.update(op.operands)
    return live


def dead_ops(program: Program) -> list[Operation]:
    """Ops whose results never reach an output — executed, then discarded."""
    live = live_values(program)
    return [op for op in program.ops if op.result not in live]


def eliminate_dead(program: Program) -> Program:
    """The program with dead ops removed; outputs (and all surviving value
    ids) unchanged, so ``interp.evaluate`` returns bit-identical outputs."""
    live = live_values(program)
    out = program.clone()
    out.ops = [op for op in out.ops if op.result in live]
    return out


# -- conservative constant folding -------------------------------------------

# numpy implementations that are IEEE-bit-identical to the interpreter
# for this IR's dtypes.  divide is float-only (numpy int/int promotes to
# float64; jnp promotes differently) — enforced in _fold_one.
_FOLD_BINARY = {
    "add": np.add, "subtract": np.subtract, "multiply": np.multiply,
    "divide": np.divide, "maximum": np.maximum, "minimum": np.minimum,
}
_FOLD_UNARY = {"negate": np.negative, "abs": np.abs, "sign": np.sign}
_FOLD_COMPARE = {"EQ": np.equal, "NE": np.not_equal, "LT": np.less,
                 "LE": np.less_equal, "GT": np.greater,
                 "GE": np.greater_equal}

_NP_DTYPE = {"f32": np.float32, "i32": np.int32, "bool": np.bool_}


def _fold_one(op: Operation, consts: dict[int, np.ndarray]
              ) -> np.ndarray | None:
    """The op's value as an ndarray when it folds exactly, else None."""
    if op.type.dtype not in _NP_DTYPE:
        return None   # bf16: no exact numpy twin
    if any(o not in consts for o in op.operands):
        return None
    xs = [consts[o] for o in op.operands]
    a = op.attrs
    oc = op.opcode
    out = None
    if oc in _FOLD_BINARY:
        if oc == "divide" and op.type.dtype != "f32":
            return None
        out = _FOLD_BINARY[oc](xs[0], xs[1])
    elif oc in _FOLD_UNARY:
        out = _FOLD_UNARY[oc](xs[0])
    elif oc == "reshape":
        out = np.reshape(xs[0], tuple(a["new_shape"]))
    elif oc == "transpose":
        out = np.transpose(xs[0], tuple(a["permutation"]))
    elif oc == "slice":
        idx = tuple(slice(s, l, st) for s, l, st in
                    zip(a["start"], a["limit"],
                        a.get("strides", (1,) * xs[0].ndim)))
        out = xs[0][idx]
    elif oc == "pad":
        low, high = tuple(a["low"]), tuple(a["high"])
        if any(v < 0 for v in low + high):
            return None   # negative padding: np.pad has no exact twin
        out = np.pad(xs[0], list(zip(low, high)), mode="constant",
                     constant_values=a.get("value", 0.0))
    elif oc == "broadcast_in_dim":
        bdims = tuple(a["broadcast_dimensions"])
        if list(bdims) != sorted(bdims):
            return None   # unsorted dims would need a transpose; skip
        shape = tuple(a["shape"])
        ones = [1] * len(shape)
        for i, d in enumerate(bdims):
            ones[d] = xs[0].shape[i]
        out = np.broadcast_to(np.reshape(xs[0], ones), shape)
    elif oc == "select":
        out = np.where(xs[0], xs[1], xs[2])
    elif oc == "compare":
        out = _FOLD_COMPARE[a["direction"]](xs[0], xs[1])
    if out is None:
        return None
    # ascontiguousarray makes a 0-d value 1-d; the constant keeps the op's
    # shape (the reference folds a 0-d value to shape (1,), and the folded
    # program then fails Program.verify)
    out = np.ascontiguousarray(out, dtype=_NP_DTYPE[op.type.dtype]
                               ).reshape(np.shape(out))
    if out.dtype.kind == "f" and not np.all(np.isfinite(out)):
        return None   # inf/nan folds risk semantic drift; leave to runtime
    return out


def fold_constants(program: Program) -> Program:
    """One folding sweep: ops computable exactly from constant operands are
    replaced in place by ``constant`` ops (same result id, type, and uid, so
    downstream references and patch anchors survive)."""
    out = program.clone()
    consts: dict[int, np.ndarray] = {
        op.result: op.attrs["value"] for op in out.ops
        if op.opcode == "constant"}
    for i, op in enumerate(out.ops):
        if op.opcode == "constant":
            continue
        val = _fold_one(op, consts)
        if val is None:
            continue
        folded = Operation(
            opcode="constant", operands=[],
            attrs={"value": val, "dtype": op.type.dtype},
            result=op.result, type=op.type, uid=op.uid)
        # schedule knob metadata must never be invented by folding, and
        # folding never touches existing knob constants (they fold from
        # nothing) — so plain constant attrs are always correct here
        out.ops[i] = folded
        consts[op.result] = val
    return out


def normalize(program: Program, max_rounds: int = 8) -> Program:
    """Canonical executable form: constant folding + dead-code elimination to
    a fixpoint.  Outputs are bit-identical to the input program's (the
    differential property suite asserts this on random mutants)."""
    prog = program
    for _ in range(max_rounds):
        folded = eliminate_dead(fold_constants(prog))
        if (len(folded.ops) == len(prog.ops)
                and all(a.opcode == b.opcode
                        for a, b in zip(folded.ops, prog.ops))):
            return folded
        prog = folded
    return prog


# -- canonical fingerprint ---------------------------------------------------


def _canon_attr(v):
    if isinstance(v, dict):
        return {k: _canon_attr(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return [_canon_attr(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def canonical_fingerprint(program: Program) -> str:
    """Content hash of the program's *computation*: SSA values densely
    renumbered in definition order, op uids / allocation counters / program
    name stripped, constants hashed by dtype+shape+bytes.  Two variants hash
    equal iff their input signature, op sequence (opcode, operands, attrs),
    and output lists are identical after renumbering — the ``equivalent``
    relation of the patch-effect classifier.  Call on :func:`normalize`
    output to also identify variants that differ only in dead or foldable
    code."""
    remap: dict[int, int] = {}
    for _, vid, _ in program.inputs:
        remap[vid] = len(remap)
    for op in program.ops:
        remap[op.result] = len(remap)
    arrays: list[np.ndarray] = []
    ops = []
    for op in program.ops:
        attrs = {}
        for k, v in sorted(op.attrs.items()):
            if isinstance(v, np.ndarray):
                attrs[k] = {"__array__": len(arrays)}
                arrays.append(v)
            else:
                attrs[k] = _canon_attr(v)
        ops.append([op.opcode, [remap[o] for o in op.operands], attrs,
                    [list(op.type.shape), op.type.dtype]])
    doc = {
        "inputs": [[n, remap[v], [list(t.shape), t.dtype]]
                   for n, v, t in program.inputs],
        "ops": ops,
        "outputs": [remap[o] for o in program.outputs],
    }
    h = hashlib.sha256()
    h.update(json.dumps(doc, sort_keys=True,
                        separators=(",", ":")).encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()
