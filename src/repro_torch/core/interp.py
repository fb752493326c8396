"""Eager PyTorch interpreter for the HLO-lite IR.

Plays the role the reference package gives XLA (and the paper IREE): it
executes (mutated) IR programs.  Each op becomes one or a few torch calls on
the device of the inputs.  ``jit_program`` puts the program's constants on
the device once and returns a callable that runs the op list eagerly.
:class:`ProgramGraph` runs it over static input buffers: on a GPU the op
list is captured once as a CUDA graph and replayed, which is what the
measured fitness times (the counterpart of the reference compiling each
variant into one XLA executable); there is no ``torch.compile``.

Results follow ``jnp``/``lax`` semantics, not torch's, so a variant computes
the same function as in the reference (up to rounding) and raises where the
reference raises — the execute-successfully gate shapes the search:

* dtypes promote on jnp's lattice ``bool < i32 < bf16 < f32`` (64-bit mode
  off); ``divide`` of integers is a true divide in f32; ``reduce_sum`` of
  bool is i32; ``exponential``/``log``/``tanh`` of integers are f32;
  ``subtract``, ``negate`` and ``sign`` of bool, ``rsqrt`` of integers,
  ``avg_pool`` of bool and a ``conv`` of two dtypes raise ``TypeError``;
* ``convert`` from a float to i32 saturates and sends NaN to 0, as XLA
  converts; an integer ``power`` is jnp's binary exponentiation over the
  exponent's low 6 bits; ``multiply`` of f32 by bool is XLA's select;
* ``conv`` and the pools take NHWC x HWIO and XLA's ``SAME`` padding, which
  is asymmetric at stride > 1 (the extra row or column goes high); padded
  cells of ``max_pool`` hold the lowest value of the dtype, those of
  ``avg_pool`` hold 0 and count in the divisor;
* ``dot`` is ``dot_general``: batch dims first, then lhs free dims, then rhs
  free dims; ``pad`` takes negative low/high (a crop);
* f32 ``dot`` and ``conv`` run at full f32 on the GPU: TF32 is off and cuDNN
  picks deterministic algorithms for the length of a call (:func:`full_f32`),
  so a variant's error is the program's and two runs are bit-identical.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import CudaGraph, resolve_device
from .ir import Program

TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
               "i32": torch.int32, "bool": torch.bool}
_FLOATS = (torch.float32, torch.bfloat16)
# jnp's type-promotion lattice over the IR's dtypes (64-bit mode off)
_RANK = {torch.bool: 0, torch.int32: 1, torch.bfloat16: 2, torch.float32: 3}
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


@contextlib.contextmanager
def full_f32():
    """Full-precision f32 matmuls and convolutions (no TF32) and cuDNN's
    deterministic algorithms while the block runs; the caller's settings
    come back after it."""
    cudnn = torch.backends.cudnn
    if hasattr(getattr(cudnn, "conv", None), "fp32_precision"):
        flags = [(cudnn.conv, "fp32_precision", "ieee"),
                 (torch.backends.cuda.matmul, "fp32_precision", "ieee")]
    else:  # PyTorch before 2.9
        flags = [(cudnn, "allow_tf32", False),
                 (torch.backends.cuda.matmul, "allow_tf32", False)]
    flags += [(cudnn, "deterministic", True), (cudnn, "benchmark", False)]
    saved = [getattr(obj, name) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(flags, saved):
            setattr(obj, name, value)


# --------------------------------------------------------------------------
# dtypes
# --------------------------------------------------------------------------

def _promote(*xs: torch.Tensor):
    """The operands cast to their jnp result dtype, and that dtype."""
    r = max((x.dtype for x in xs), key=_RANK.__getitem__)
    return [x.to(r) for x in xs], r


def _to_float(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype in _FLOATS else x.to(torch.float32)


def _float_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> s32: truncate, saturate, NaN -> 0."""
    x = x.to(torch.float32)
    hi, lo = x >= 2.0 ** 31, x <= -2.0 ** 31
    out = torch.where(hi | lo | torch.isnan(x), 0.0, x).to(torch.int32)
    out = torch.where(hi, _I32_MAX, out)
    return torch.where(lo, _I32_MIN, out)


def convert(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """``x.astype(dtype)`` with XLA's conversion rules."""
    t = TORCH_DTYPE[dtype]
    if x.dtype == t:
        return x
    if t == torch.int32 and x.dtype in _FLOATS:
        return _float_to_i32(x)
    return x.to(t)


def _fill_value(value, dtype: torch.dtype):
    """``jnp.asarray(value, dtype)`` of a Python scalar."""
    if dtype == torch.bool:
        return bool(value)
    if dtype == torch.int32:
        return int(value)
    return float(value)


def constant(value, dtype: str, device) -> torch.Tensor:
    """``jnp.asarray(value, dtype)`` on ``device``: float constants round
    through f32, as jnp does."""
    arr = np.asarray(value)
    np_dtype = {"i32": np.int32, "bool": np.bool_}.get(dtype, np.float32)
    arr = np.ascontiguousarray(arr.astype(np_dtype))
    return torch.from_numpy(arr).to(device=device, dtype=TORCH_DTYPE[dtype])


# --------------------------------------------------------------------------
# elementwise ops
# --------------------------------------------------------------------------

def _reject_bool(name: str, dtype: torch.dtype) -> None:
    if dtype == torch.bool:
        raise TypeError(f"{name} does not accept dtype bool")


def _add(a, b):
    (a, b), _ = _promote(a, b)
    return torch.add(a, b)


def _subtract(a, b):
    (a, b), r = _promote(a, b)
    _reject_bool("sub", r)
    return torch.sub(a, b)


def _multiply(a, b):
    (pa, pb), r = _promote(a, b)
    one_bool = (a.dtype == torch.bool) != (b.dtype == torch.bool)
    if r == torch.float32 and one_bool:
        # XLA rewrites f32 x * convert(pred) as select(pred, x, 0): an inf
        # or NaN times False is 0 in the reference
        pred, x = (a, pb) if a.dtype == torch.bool else (b, pa)
        return torch.where(pred, x, torch.zeros((), dtype=r, device=x.device))
    return torch.mul(pa, pb)


def _divide(a, b):
    (a, b), r = _promote(a, b)
    if r not in _FLOATS:
        a, b = a.to(torch.float32), b.to(torch.float32)
    return torch.div(a, b)


def _maximum(a, b):
    (a, b), _ = _promote(a, b)
    return torch.maximum(a, b)


def _minimum(a, b):
    (a, b), _ = _promote(a, b)
    return torch.minimum(a, b)


def _power(a, b):
    (a, b), r = _promote(a, b)
    if r in _FLOATS:
        return torch.pow(a, b)
    # jnp's integer power (bools included): binary exponentiation over the
    # low 6 bits of the exponent, shifted as unsigned, wrapping as s32
    x, e = a.to(torch.int32), b.to(torch.int64) & 0xFFFFFFFF
    acc = torch.where((x == 0) & (e != 0), 0, 1).to(torch.int32)
    for _ in range(6):
        acc = torch.where(e % 2 == 1, acc * x, acc)
        x = x * x
        e = e >> 1
    return acc


def _negate(x):
    _reject_bool("neg", x.dtype)
    return torch.neg(x)


def _rsqrt(x):
    if x.dtype not in _FLOATS:
        raise TypeError(f"rsqrt does not accept dtype {x.dtype}")
    return torch.rsqrt(x)


def _abs(x):
    return x if x.dtype == torch.bool else torch.abs(x)


def _sign(x):
    _reject_bool("sign", x.dtype)
    if x.dtype in _FLOATS:   # NaN and -0.0 are their own sign in lax
        return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))
    return torch.sign(x)


_BINARY = {"add": _add, "subtract": _subtract, "multiply": _multiply,
           "divide": _divide, "maximum": _maximum, "minimum": _minimum,
           "power": _power}
_UNARY = {
    "exponential": lambda x: torch.exp(_to_float(x)),
    "log": lambda x: torch.log(_to_float(x)),
    "tanh": lambda x: torch.tanh(_to_float(x)),
    "negate": _negate, "rsqrt": _rsqrt, "abs": _abs, "sign": _sign,
}
_COMPARE = {"EQ": torch.eq, "NE": torch.ne, "LT": torch.lt, "LE": torch.le,
            "GT": torch.gt, "GE": torch.ge}


# --------------------------------------------------------------------------
# structured ops
# --------------------------------------------------------------------------

def _dot_general(a, b, dims) -> torch.Tensor:
    """``lax.dot_general``: batch dims, then lhs free, then rhs free."""
    (lc, rc), (lb, rb) = dims
    (a, b), r = _promote(a, b)
    af = [i for i in range(a.ndim) if i not in lc and i not in lb]
    bf = [i for i in range(b.ndim) if i not in rc and i not in rb]
    batch = [a.shape[i] for i in lb]
    m = [a.shape[i] for i in af]
    n = [b.shape[i] for i in bf]
    k = math.prod(a.shape[i] for i in lc)
    a3 = a.permute(*lb, *af, *lc).reshape(math.prod(batch), math.prod(m), k)
    b3 = b.permute(*rb, *rc, *bf).reshape(math.prod(batch), k, math.prod(n))
    if r in _FLOATS:
        out = torch.matmul(a3, b3)
    else:  # integer and bool dots: exact, wrapping as s32 does
        prod = a3.to(torch.int64).unsqueeze(-1) * b3.to(torch.int64)[:, None]
        s = prod.sum(-2)
        out = s.to(torch.int32) if r == torch.int32 else s != 0
    return out.reshape(*batch, *m, *n)


def _broadcast_in_dim(x, shape, bdims) -> torch.Tensor:
    if any(a >= b for a, b in zip(bdims, bdims[1:])):
        raise TypeError("broadcast_in_dim broadcast_dimensions must be "
                        f"strictly increasing; got {tuple(bdims)}")
    view = [1] * len(shape)
    for d, size in zip(bdims, x.shape):
        view[d] = size
    return x.reshape(view).expand(*shape)


def _reduce_sum(x, dims):
    r = torch.int32 if x.dtype in (torch.bool, torch.int32) else x.dtype
    if not dims:      # torch reads an empty dim list as "every dim"
        return x.to(r)
    return torch.sum(x, dim=tuple(dims), dtype=r)


def _reduce_max(x, dims):
    return torch.amax(x, dim=tuple(dims)) if dims else x


def _pad(x, low, high, value) -> torch.Tensor:
    """``lax.pad`` without interior padding; negative low/high crop."""
    shape = [d + lo + hi for d, lo, hi in zip(x.shape, low, high)]
    out = torch.full(shape, _fill_value(value, x.dtype), dtype=x.dtype,
                     device=x.device)
    src, dst = [], []
    for d, lo, size in zip(x.shape, low, shape):
        s0, s1 = max(0, -lo), min(d, size - lo)
        if s1 <= s0:
            return out
        src.append(slice(s0, s1))
        dst.append(slice(s0 + lo, s1 + lo))
    out[tuple(dst)] = x[tuple(src)]
    return out


def _slice(x, start, limit, strides=None):
    strides = strides or (1,) * x.ndim
    return x[tuple(slice(s, lim, st)
                   for s, lim, st in zip(start, limit, strides))]


def _select(pred, a, b):
    if pred.dtype != torch.bool:
        pred = pred != 0
    (a, b), _ = _promote(a, b)
    return torch.where(pred, a, b)


def _window_pads(size: int, k: int, s: int, padding: str) -> tuple[int, int]:
    """XLA's (low, high) padding of one spatial dim."""
    if padding != "SAME":
        return 0, 0
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, strides=(1, 1), padding="SAME", groups=1) -> torch.Tensor:
    """``lax.conv_general_dilated`` over NHWC x HWIO -> NHWC.  Called
    outside the interpreter (pretraining), it takes the caller's precision
    flags: run it under :func:`full_f32` for full f32 on the GPU."""
    if x.dtype != w.dtype:
        raise TypeError("lax.conv_general_dilated requires arguments to have "
                        f"the same dtypes, got {x.dtype}, {w.dtype}")
    kh, kw = w.shape[0], w.shape[1]
    (hl, hh), (wl, wh) = (_window_pads(x.shape[1], kh, strides[0], padding),
                          _window_pads(x.shape[2], kw, strides[1], padding))
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    dtype = x.dtype
    if dtype not in _FLOATS:  # integer and bool convs: exact below 2**53
        xc, wc = xc.to(torch.float64), wc.to(torch.float64)
    if hl == hh and wl == wh:
        y = F.conv2d(xc, wc, stride=tuple(strides), padding=(hl, wl),
                     groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (wl, wh, hl, hh)), wc, stride=tuple(strides),
                     groups=groups)
    if dtype == torch.int32:
        y = y.round().to(torch.int64).to(torch.int32)
    elif dtype == torch.bool:
        y = y != 0
    return y.permute(0, 2, 3, 1)


def _pool(x, kind, window, strides=None, padding="VALID") -> torch.Tensor:
    """``max_pool`` / ``avg_pool`` as the reference's ``lax.reduce_window``."""
    kh, kw = window
    sh, sw = strides or window
    if kind == "max_pool":
        # lax takes the init -inf as max's identity: the dtype's lowest
        fill = {torch.bool: False, torch.int32: _I32_MIN}.get(x.dtype,
                                                              -math.inf)
    elif x.dtype == torch.bool:
        raise TypeError("operand to reduce_window_sum must have a number "
                        "dtype, got bool")
    else:
        fill = 0
    (hl, hh), (wl, wh) = (_window_pads(x.shape[1], kh, sh, padding),
                          _window_pads(x.shape[2], kw, sw, padding))
    if hl or hh or wl or wh:
        x = _pad(x, (0, hl, wl, 0), (0, hh, wh, 0), fill)
    win = x.unfold(1, kh, sh).unfold(2, kw, sw)    # (N, OH, OW, C, kh, kw)
    if kind == "max_pool":
        return win.amax(dim=(-2, -1))
    summed = win.sum(dim=(-2, -1), dtype=x.dtype)
    return summed / float(kh * kw)


# --------------------------------------------------------------------------
# the op table and the executor
# --------------------------------------------------------------------------

def _table() -> dict:
    ops = {name: lambda xs, a, f=f: f(*xs)
           for name, f in {**_BINARY, **_UNARY}.items()}
    ops.update({
        "dot": lambda xs, a: _dot_general(
            xs[0], xs[1], a.get("dims", (((1,), (0,)), ((), ())))),
        "reshape": lambda xs, a: xs[0].reshape(tuple(a["new_shape"])),
        "broadcast_in_dim": lambda xs, a: _broadcast_in_dim(
            xs[0], tuple(a["shape"]), tuple(a["broadcast_dimensions"])),
        "transpose": lambda xs, a: xs[0].permute(*a["permutation"]),
        "reduce_sum": lambda xs, a: _reduce_sum(xs[0], a["dims"]),
        "reduce_max": lambda xs, a: _reduce_max(xs[0], a["dims"]),
        "pad": lambda xs, a: _pad(xs[0], a["low"], a["high"],
                                 a.get("value", 0.0)),
        "slice": lambda xs, a: _slice(xs[0], a["start"], a["limit"],
                                      a.get("strides")),
        "select": lambda xs, a: _select(*xs),
        "compare": lambda xs, a: _COMPARE[a["direction"]](
            *_promote(xs[0], xs[1])[0]),
        "convert": lambda xs, a: convert(xs[0], a["new_dtype"]),
        "conv": lambda xs, a: conv(
            xs[0], xs[1], tuple(a.get("strides", (1, 1))),
            a.get("padding", "SAME"), a.get("feature_group_count", 1)),
        "avg_pool": lambda xs, a: _pool(xs[0], "avg_pool", a["window"],
                                       a.get("strides"),
                                       a.get("padding", "VALID")),
        "max_pool": lambda xs, a: _pool(xs[0], "max_pool", a["window"],
                                       a.get("strides"),
                                       a.get("padding", "VALID")),
    })
    return ops


_OPS = _table()


def _op_fn(opcode: str):
    fn = _OPS.get(opcode)
    if fn is None:
        def unknown(xs, attrs):
            raise NotImplementedError(opcode)
        return unknown
    return fn


def eval_op(opcode: str, operands: list[torch.Tensor],
            attrs: dict[str, Any]) -> torch.Tensor:
    """One op (any but ``constant``) on operand tensors, whatever their
    dtypes: variants can feed an op dtypes the IR's types do not name (an
    integer ``divide`` is f32), and the op then promotes as jnp does."""
    with full_f32():
        return _op_fn(opcode)(list(operands), attrs)


def _input(x, ttype, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = convert(t.to(device), ttype.dtype)
    if tuple(t.shape) != ttype.shape:
        raise ValueError(f"input shape {tuple(t.shape)} != {ttype.shape}")
    return t


def _lower(program: Program, dev):
    """The program's constants on ``dev`` (by value id) and its other ops
    as ``(result, fn, operands, attrs)`` steps."""
    env0: dict[int, torch.Tensor] = {}
    steps = []
    for op in program.ops:
        if op.opcode == "constant":
            env0[op.result] = constant(op.attrs["value"],
                                       op.attrs.get("dtype", "f32"), dev)
        else:
            steps.append((op.result, _op_fn(op.opcode), tuple(op.operands),
                          op.attrs))
    return env0, steps


def _execute(env: dict, steps) -> None:
    with full_f32():
        for result, fn, operands, attrs in steps:
            env[result] = fn([env[o] for o in operands], attrs)


def jit_program(program: Program, device=None):
    """The program as a callable ``(dict of named inputs) -> list of
    outputs`` on ``device`` (the GPU unless told otherwise).  The constants
    go to the device here, once; each call runs the op list eagerly under
    :func:`full_f32`.  Inputs may be numpy arrays or tensors on any device;
    each is cast to its declared dtype, as the reference casts it."""
    dev = resolve_device(device)
    env0, steps = _lower(program, dev)
    inputs_decl = tuple(program.inputs)
    outputs = tuple(program.outputs)

    def call(inputs: dict[str, Any]) -> list[torch.Tensor]:
        env = dict(env0)
        for name, vid, ttype in inputs_decl:
            if name not in inputs:
                raise KeyError(f"missing program input {name!r}")
            try:
                env[vid] = _input(inputs[name], ttype, dev)
            except ValueError as e:
                raise ValueError(f"input {name!r}: {e}") from None
        _execute(env, steps)
        return [env[o] for o in outputs]

    call.input_names = tuple(name for name, _, _ in inputs_decl)
    call.device = dev
    return call


class ProgramGraph:
    """The program over static input buffers on ``device`` (the GPU unless
    told otherwise): :meth:`load` copies named inputs in (cast to their
    declared dtypes, as :func:`jit_program` casts them), :meth:`run`
    computes the outputs of what is loaded into static output tensors.

    On the CPU every run executes the op list.  On a GPU the first run
    executes it eagerly, which is the validity gate: a variant raises there
    with the exception and message an eager call gives.  Only then is the
    op list captured as a CUDA graph (under :func:`full_f32`, constants
    kept outside it), and every run replays it.  An output that shares
    memory with an input buffer or a constant (torch returns views where
    XLA returns copies, e.g. a ``transpose`` of a weight) is copied inside
    the run, so writing outputs back into the input buffers (a training
    step's feedback) never reads what it overwrites.  :meth:`close` (or leaving a ``with`` block) frees the
    buffers, the graph and its memory pool."""

    def __init__(self, program: Program, device=None):
        self.device = resolve_device(device)
        self._program = program
        self._env0, self._steps = _lower(program, self.device)
        self._decl = {name: (vid, ttype) for name, vid, ttype in
                      program.inputs}
        self._outputs = tuple(program.outputs)
        self._buffers: dict[str, torch.Tensor] = {}
        self._graph = None
        self._static: list[torch.Tensor] | None = None

    def load(self, inputs: dict[str, Any]) -> None:
        for name, value in inputs.items():
            if name not in self._decl:
                raise KeyError(f"unknown program input {name!r}")
            ttype = self._decl[name][1]
            try:
                t = _input(value, ttype, self.device)
            except ValueError as e:
                raise ValueError(f"input {name!r}: {e}") from None
            buf = self._buffers.get(name)
            if buf is None:
                self._buffers[name] = t.clone(
                    memory_format=torch.contiguous_format)
            else:
                buf.copy_(t)

    def _outputs_of_run(self) -> list[torch.Tensor]:
        env = dict(self._env0)
        for name, (vid, _) in self._decl.items():
            if name not in self._buffers:
                raise KeyError(f"missing program input {name!r}")
            env[vid] = self._buffers[name]
        _execute(env, self._steps)
        held = {t.untyped_storage().data_ptr()
                for t in (*self._buffers.values(), *self._env0.values())}
        return [o.clone() if o.untyped_storage().data_ptr() in held else o
                for o in (env[v] for v in self._outputs)]

    def run(self) -> list[torch.Tensor]:
        if self.device.type != "cuda":
            return self._outputs_of_run()
        if self._graph is None:
            graph = CudaGraph(self.device)
            graph.eager(self._outputs_of_run)
            self._static = graph.capture(self._outputs_of_run)
            self._graph = graph
        self._graph.replay()
        return list(self._static)

    def twin(self) -> "ProgramGraph":
        """The same program on memory of its own: its constants lowered
        again and the inputs loaded here copied into buffers of its own;
        its first run captures a graph of its own."""
        twin = ProgramGraph(self._program, self.device)
        twin.load(self._buffers)
        return twin

    def close(self) -> None:
        graph, self._graph = self._graph, None
        self._static = None
        self._buffers.clear()
        self._env0.clear()
        if graph is not None:
            graph.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def evaluate(program: Program, inputs: dict[str, Any],
             device=None) -> list[torch.Tensor]:
    """Execute ``program`` on named inputs on ``device`` (the GPU unless
    told otherwise); returns the output list."""
    return jit_program(program, device)(inputs)
