"""HLO-lite graph IR — the program representation GEVO-ML searches over.

This mirrors the MLIR/HLO-dialect programs shown in the paper (Figures 1, 5):
an SSA list of strongly-typed tensor operations.  Tensors of different shapes
are different types (the property that forces the paper's tensor-resize
repair operator).

Design notes
------------
* Values are integers (SSA ids).  Operations carry a stable ``uid`` that
  survives program mutation, so patch edits can address operations robustly
  (the GEVO patch representation).
* Type inference is table-driven (`infer_type`); mutation/repair use it to
  discover type mismatches before execution.
* The IR is deliberately small but complete enough to express the paper's two
  workloads (MobileNet forward; 2fcNet forward+backward+SGD) and arbitrary
  mutants thereof.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np

# --------------------------------------------------------------------------
# Types
# --------------------------------------------------------------------------

_DTYPES = ("f32", "bf16", "i32", "bool")


@dataclass(frozen=True)
class TensorType:
    shape: tuple[int, ...]
    dtype: str = "f32"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise IRTypeError(f"unknown dtype {self.dtype!r}")
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        per = {"f32": 4, "bf16": 2, "i32": 4, "bool": 1}[self.dtype]
        return self.size * per

    def __str__(self) -> str:
        dims = "x".join(str(d) for d in self.shape) or "scalar"
        return f"tensor<{dims}:{self.dtype}>"


class IRTypeError(Exception):
    """Raised when an operation's operands do not satisfy its type rules."""


class IRVerifyError(Exception):
    """Raised when a program violates SSA / use-def invariants."""


# --------------------------------------------------------------------------
# Operations
# --------------------------------------------------------------------------

# opcode -> arity (None = variadic handled specially)
ELEMENTWISE_BINARY = (
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "power",
)
ELEMENTWISE_UNARY = (
    "exponential", "log", "negate", "tanh", "rsqrt", "abs", "sign",
)
OPCODES = ELEMENTWISE_BINARY + ELEMENTWISE_UNARY + (
    "constant",            # attrs: value (np.ndarray)
    "dot",                 # attrs: dims=((lhs_c, rhs_c), (lhs_b, rhs_b))
    "reshape",             # attrs: new_shape
    "broadcast_in_dim",    # attrs: shape, broadcast_dimensions
    "transpose",           # attrs: permutation
    "reduce_sum",          # attrs: dims
    "reduce_max",          # attrs: dims
    "pad",                 # attrs: low, high, value (float)
    "slice",               # attrs: start, limit, strides
    "select",              # (pred, on_true, on_false)
    "compare",             # attrs: direction in {EQ,NE,LT,LE,GT,GE}
    "convert",             # attrs: new_dtype
    "conv",                # attrs: strides, padding, feature_group_count  (NHWC x HWIO)
    "avg_pool",            # attrs: window, strides, padding
    "max_pool",            # attrs: window, strides, padding
)


@dataclass
class Operation:
    opcode: str
    operands: list[int]
    attrs: dict[str, Any]
    result: int
    type: TensorType
    uid: int  # stable across mutation; clones get fresh uids

    def clone(self) -> "Operation":
        return Operation(
            opcode=self.opcode,
            operands=list(self.operands),
            attrs={k: (v.copy() if isinstance(v, np.ndarray) else v)
                   for k, v in self.attrs.items()},
            result=self.result,
            type=self.type,
            uid=self.uid,
        )


@dataclass
class Program:
    """An SSA program: typed inputs, an op list in topological order, outputs."""

    inputs: list[tuple[str, int, TensorType]] = field(default_factory=list)
    ops: list[Operation] = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)
    name: str = "program"
    _next_value: int = 0
    _next_uid: int = 0

    # -- construction helpers ------------------------------------------------
    def fresh_value(self) -> int:
        v = self._next_value
        self._next_value += 1
        return v

    def fresh_uid(self) -> int:
        u = self._next_uid
        self._next_uid += 1
        return u

    def add_input(self, name: str, ttype: TensorType) -> int:
        vid = self.fresh_value()
        self.inputs.append((name, vid, ttype))
        return vid

    def add_op(self, opcode: str, operands: Iterable[int],
               attrs: dict[str, Any] | None = None,
               insert_at: int | None = None) -> int:
        attrs = dict(attrs or {})
        operands = list(operands)
        ttype = infer_type(opcode, [self.type_of(o) for o in operands], attrs)
        op = Operation(opcode=opcode, operands=operands, attrs=attrs,
                       result=self.fresh_value(), type=ttype,
                       uid=self.fresh_uid())
        if insert_at is None:
            self.ops.append(op)
        else:
            self.ops.insert(insert_at, op)
        return op.result

    def constant(self, value: np.ndarray | float, dtype: str = "f32",
                 insert_at: int | None = None) -> int:
        arr = np.asarray(value, dtype={"f32": np.float32, "bf16": np.float32,
                                       "i32": np.int32, "bool": np.bool_}[dtype])
        return self.add_op("constant", [], {"value": arr, "dtype": dtype},
                           insert_at=insert_at)

    # -- queries -------------------------------------------------------------
    def type_of(self, value: int) -> TensorType:
        for _, vid, t in self.inputs:
            if vid == value:
                return t
        for op in self.ops:
            if op.result == value:
                return op.type
        raise IRVerifyError(f"unknown value %{value}")

    def types(self) -> dict[int, TensorType]:
        env = {vid: t for _, vid, t in self.inputs}
        for op in self.ops:
            env[op.result] = op.type
        return env

    def op_index_by_uid(self, uid: int) -> int | None:
        for i, op in enumerate(self.ops):
            if op.uid == uid:
                return i
        return None

    def defs_before(self, index: int) -> list[int]:
        """All value ids in scope immediately before ops[index]."""
        vals = [vid for _, vid, _ in self.inputs]
        vals.extend(op.result for op in self.ops[:index])
        return vals

    def uses_of(self, value: int) -> list[tuple[int, int]]:
        """(op_index, operand_slot) pairs that read ``value``."""
        out = []
        for i, op in enumerate(self.ops):
            for j, o in enumerate(op.operands):
                if o == value:
                    out.append((i, j))
        return out

    def clone(self) -> "Program":
        return Program(
            inputs=list(self.inputs),
            ops=[op.clone() for op in self.ops],
            outputs=list(self.outputs),
            name=self.name,
            _next_value=self._next_value,
            _next_uid=self._next_uid,
        )

    # -- verification ----------------------------------------------------------
    def verify(self) -> None:
        seen: dict[int, TensorType] = {vid: t for _, vid, t in self.inputs}
        if len(seen) != len(self.inputs):
            raise IRVerifyError("duplicate input value ids")
        for i, op in enumerate(self.ops):
            if op.opcode not in OPCODES:
                raise IRVerifyError(f"op {i}: unknown opcode {op.opcode!r}")
            for o in op.operands:
                if o not in seen:
                    raise IRVerifyError(
                        f"op {i} ({op.opcode}): operand %{o} not defined before use")
            expected = infer_type(op.opcode, [seen[o] for o in op.operands], op.attrs)
            if expected != op.type:
                raise IRVerifyError(
                    f"op {i} ({op.opcode}): recorded type {op.type} != inferred {expected}")
            if op.result in seen:
                raise IRVerifyError(f"op {i}: SSA violation — %{op.result} reassigned")
            seen[op.result] = op.type
        for o in self.outputs:
            if o not in seen:
                raise IRVerifyError(f"output %{o} undefined")

    # -- printing --------------------------------------------------------------
    def __str__(self) -> str:
        lines = [f"func @{self.name}("
                 + ", ".join(f"%{vid}: {t} /*{n}*/" for n, vid, t in self.inputs)
                 + ") {"]
        for op in self.ops:
            args = ", ".join(f"%{o}" for o in op.operands)
            attrs = ""
            if op.opcode != "constant" and op.attrs:
                attrs = " {" + ", ".join(f"{k}={v}" for k, v in op.attrs.items()) + "}"
            lines.append(f"  %{op.result} = hlo.{op.opcode} {args}{attrs} : {op.type}")
        lines.append("  return " + ", ".join(f"%{o}" for o in self.outputs))
        lines.append("}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Type inference
# --------------------------------------------------------------------------

def _broadcastable(a: TensorType, b: TensorType) -> TensorType:
    if a.shape != b.shape:
        raise IRTypeError(f"elementwise shape mismatch {a} vs {b}")
    if a.dtype != b.dtype:
        raise IRTypeError(f"elementwise dtype mismatch {a} vs {b}")
    return a


def _conv_out(n, h, w, c, kh, kw, ko, strides, padding):
    sh, sw = strides
    if padding == "SAME":
        oh = -(-h // sh)
        ow = -(-w // sw)
    elif padding == "VALID":
        oh = -(-(h - kh + 1) // sh)
        ow = -(-(w - kw + 1) // sw)
    else:
        raise IRTypeError(f"bad padding {padding!r}")
    if oh <= 0 or ow <= 0:
        raise IRTypeError("conv output collapsed to zero size")
    return (n, oh, ow, ko)


def infer_type(opcode: str, operand_types: list[TensorType],
               attrs: dict[str, Any]) -> TensorType:
    ts = operand_types
    if opcode in ELEMENTWISE_BINARY:
        if len(ts) != 2:
            raise IRTypeError(f"{opcode} expects 2 operands")
        return _broadcastable(ts[0], ts[1])
    if opcode in ELEMENTWISE_UNARY:
        if len(ts) != 1:
            raise IRTypeError(f"{opcode} expects 1 operand")
        return ts[0]
    if opcode == "constant":
        arr = attrs["value"]
        return TensorType(tuple(arr.shape), attrs.get("dtype", "f32"))
    if opcode == "dot":
        (lc, rc), (lb, rb) = attrs.get("dims", (((1,), (0,)), ((), ())))
        a, b = ts
        for i, j in zip(lc, rc):
            if a.shape[i] != b.shape[j]:
                raise IRTypeError(f"dot contracting mismatch {a} {b}")
        for i, j in zip(lb, rb):
            if a.shape[i] != b.shape[j]:
                raise IRTypeError(f"dot batch mismatch {a} {b}")
        batch = tuple(a.shape[i] for i in lb)
        afree = tuple(d for i, d in enumerate(a.shape) if i not in lc and i not in lb)
        bfree = tuple(d for i, d in enumerate(b.shape) if i not in rc and i not in rb)
        return TensorType(batch + afree + bfree, a.dtype)
    if opcode == "reshape":
        new = tuple(attrs["new_shape"])
        if int(np.prod(new)) != ts[0].size:
            raise IRTypeError(f"reshape size mismatch {ts[0].shape} -> {new}")
        return TensorType(new, ts[0].dtype)
    if opcode == "broadcast_in_dim":
        shape = tuple(attrs["shape"])
        bdims = tuple(attrs["broadcast_dimensions"])
        if len(bdims) != ts[0].rank:
            raise IRTypeError("broadcast_in_dim dims rank mismatch")
        for i, d in enumerate(bdims):
            if ts[0].shape[i] not in (1, shape[d]):
                raise IRTypeError("broadcast_in_dim incompatible")
        return TensorType(shape, ts[0].dtype)
    if opcode == "transpose":
        perm = tuple(attrs["permutation"])
        if sorted(perm) != list(range(ts[0].rank)):
            raise IRTypeError("bad permutation")
        return TensorType(tuple(ts[0].shape[p] for p in perm), ts[0].dtype)
    if opcode in ("reduce_sum", "reduce_max"):
        dims = tuple(attrs["dims"])
        if any(d < 0 or d >= ts[0].rank for d in dims):
            raise IRTypeError("reduce dims out of range")
        return TensorType(tuple(d for i, d in enumerate(ts[0].shape)
                                if i not in dims), ts[0].dtype)
    if opcode == "pad":
        low, high = tuple(attrs["low"]), tuple(attrs["high"])
        if len(low) != ts[0].rank or len(high) != ts[0].rank:
            raise IRTypeError("pad config rank mismatch")
        shape = tuple(d + l + h for d, l, h in zip(ts[0].shape, low, high))
        if any(d <= 0 for d in shape):
            raise IRTypeError("pad produced non-positive dim")
        return TensorType(shape, ts[0].dtype)
    if opcode == "slice":
        start = tuple(attrs["start"])
        limit = tuple(attrs["limit"])
        strides = tuple(attrs.get("strides", (1,) * ts[0].rank))
        if not (len(start) == len(limit) == len(strides) == ts[0].rank):
            raise IRTypeError("slice config rank mismatch")
        shape = []
        for s, l, st, d in zip(start, limit, strides, ts[0].shape):
            if not (0 <= s < l <= d) or st <= 0:
                raise IRTypeError(f"bad slice [{s}:{l}:{st}] on dim {d}")
            shape.append(-(-(l - s) // st))
        return TensorType(tuple(shape), ts[0].dtype)
    if opcode == "select":
        pred, a, b = ts
        if pred.shape != a.shape or a != b:
            raise IRTypeError("select operands mismatch")
        if pred.dtype != "bool":
            raise IRTypeError("select predicate must be bool")
        return a
    if opcode == "compare":
        a, b = ts
        if a.shape != b.shape:
            raise IRTypeError("compare shape mismatch")
        return TensorType(a.shape, "bool")
    if opcode == "convert":
        return TensorType(ts[0].shape, attrs["new_dtype"])
    if opcode == "conv":
        x, w = ts  # NHWC, HWIO
        if x.rank != 4 or w.rank != 4:
            raise IRTypeError("conv expects rank-4 NHWC x HWIO")
        n, h, wd, c = x.shape
        kh, kw, ci, ko = w.shape
        g = attrs.get("feature_group_count", 1)
        if ci * g != c:
            raise IRTypeError(f"conv channel mismatch c={c} ci={ci} groups={g}")
        if ko % g != 0:
            raise IRTypeError("conv output channels not divisible by groups")
        return TensorType(_conv_out(n, h, wd, c, kh, kw, ko,
                                    attrs.get("strides", (1, 1)),
                                    attrs.get("padding", "SAME")), x.dtype)
    if opcode in ("avg_pool", "max_pool"):
        x = ts[0]
        if x.rank != 4:
            raise IRTypeError("pool expects rank-4 NHWC")
        n, h, w, c = x.shape
        kh, kw = attrs["window"]
        return TensorType(_conv_out(n, h, w, c, kh, kw, c,
                                    attrs.get("strides", attrs["window"]),
                                    attrs.get("padding", "VALID")), x.dtype)
    raise IRTypeError(f"unknown opcode {opcode!r}")


# --------------------------------------------------------------------------
# Static cost model (per-op FLOPs / bytes) — used by the `static` fitness mode
# --------------------------------------------------------------------------

def op_flops(op: Operation, operand_types: list[TensorType]) -> int:
    if op.opcode == "dot":
        (lc, _), (lb, _) = op.attrs.get("dims", (((1,), (0,)), ((), ())))
        a = operand_types[0]
        contract = int(np.prod([a.shape[i] for i in lc])) if lc else 1
        return 2 * op.type.size * contract
    if op.opcode == "conv":
        x, w = operand_types
        kh, kw, ci, _ = w.shape
        return 2 * op.type.size * kh * kw * ci
    if op.opcode in ELEMENTWISE_BINARY + ELEMENTWISE_UNARY + ("select",):
        return op.type.size
    if op.opcode in ("reduce_sum", "reduce_max", "avg_pool", "max_pool"):
        return operand_types[0].size if operand_types else 0
    return 0


def op_bytes(op: Operation, operand_types: list[TensorType]) -> int:
    return sum(t.nbytes for t in operand_types) + op.type.nbytes


def program_cost(program: Program) -> tuple[int, int]:
    """Total (flops, bytes) of one program execution."""
    types = program.types()
    flops = bytes_ = 0
    for op in program.ops:
        ots = [types[o] for o in op.operands]
        flops += op_flops(op, ots)
        bytes_ += op_bytes(op, ots)
    return flops, bytes_
