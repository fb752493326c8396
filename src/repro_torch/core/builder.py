"""Convenience builder for HLO-lite programs.

Workload definitions (2fcNet, MobileNet) use this to emit the same op
sequences the paper's TensorFlow->HLO translation produces (Figure 1):
dense layers become dot+broadcast+add, softmax becomes the
reduce/subtract/exp/reduce/divide chain, etc.
"""

from __future__ import annotations

import numpy as np

from .ir import Program, TensorType


class Builder:
    def __init__(self, name: str = "program"):
        self.p = Program(name=name)

    # -- plumbing -----------------------------------------------------------
    def input(self, name: str, shape, dtype="f32") -> int:
        return self.p.add_input(name, TensorType(tuple(shape), dtype))

    def const(self, value, dtype="f32") -> int:
        return self.p.constant(np.asarray(value), dtype)

    def output(self, *values: int):
        self.p.outputs.extend(values)

    def done(self) -> Program:
        self.p.verify()
        return self.p

    def shape(self, v: int) -> tuple[int, ...]:
        return self.p.type_of(v).shape

    # -- raw ops --------------------------------------------------------------
    def op(self, opcode, operands, **attrs) -> int:
        return self.p.add_op(opcode, operands, attrs)

    def add(self, a, b): return self.op("add", [a, b])
    def sub(self, a, b): return self.op("subtract", [a, b])
    def mul(self, a, b): return self.op("multiply", [a, b])
    def div(self, a, b): return self.op("divide", [a, b])
    def maximum(self, a, b): return self.op("maximum", [a, b])
    def exp(self, a): return self.op("exponential", [a])
    def neg(self, a): return self.op("negate", [a])
    def rsqrt(self, a): return self.op("rsqrt", [a])

    def dot(self, a, b, dims=None) -> int:
        if dims is None:
            dims = (((len(self.shape(a)) - 1,), (0,)), ((), ()))
        return self.op("dot", [a, b], dims=dims)

    def reshape(self, a, new_shape) -> int:
        return self.op("reshape", [a], new_shape=tuple(new_shape))

    def transpose(self, a, perm) -> int:
        return self.op("transpose", [a], permutation=tuple(perm))

    def broadcast(self, a, shape, bdims) -> int:
        return self.op("broadcast_in_dim", [a], shape=tuple(shape),
                       broadcast_dimensions=tuple(bdims))

    def reduce_sum(self, a, dims) -> int:
        return self.op("reduce_sum", [a], dims=tuple(dims))

    def reduce_max(self, a, dims) -> int:
        return self.op("reduce_max", [a], dims=tuple(dims))

    # -- composite NN layers (emit the paper's HLO patterns) -------------------
    def scalar_like(self, v: int, value: float) -> int:
        """Broadcast a scalar constant to the shape of ``v``."""
        c = self.const(np.float32(value))
        shp = self.shape(v)
        return self.broadcast(c, shp, ()) if shp else c

    def bias_add(self, x, b) -> int:
        """x:(..., d) + b:(d,) via broadcast_in_dim, as HLO emits it."""
        shp = self.shape(x)
        bb = self.broadcast(b, shp, (len(shp) - 1,))
        return self.add(x, bb)

    def dense(self, x, w, b=None) -> int:
        y = self.dot(x, w)
        return self.bias_add(y, b) if b is not None else y

    def relu(self, x) -> int:
        return self.maximum(x, self.scalar_like(x, 0.0))

    def softmax(self, x) -> int:
        """The exact chain from Figure 1: reduce-max, subtract, exp,
        reduce-add, divide."""
        shp = self.shape(x)
        last = len(shp) - 1
        m = self.reduce_max(x, (last,))
        mb = self.broadcast(m, shp, tuple(range(last)))
        z = self.exp(self.sub(x, mb))
        s = self.reduce_sum(z, (last,))
        sb = self.broadcast(s, shp, tuple(range(last)))
        return self.div(z, sb)

    def conv2d(self, x, w, strides=(1, 1), padding="SAME", groups=1) -> int:
        return self.op("conv", [x, w], strides=tuple(strides), padding=padding,
                       feature_group_count=groups)

    def batch_norm_inference(self, x, gamma, beta, mean, var, eps=1e-3) -> int:
        """Per-channel (last dim) BN folded into elementwise IR ops.

        scale = gamma * rsqrt(var + eps); out = x*scale + (beta - mean*scale).
        Emitted unfused so GEVO mutations can splice individual BN params
        (the paper's key MobileNet mutation swaps one BN layer's gamma)."""
        shp = self.shape(x)
        cdim = len(shp) - 1
        veps = self.add(var, self.scalar_like(var, eps))
        scale = self.mul(gamma, self.rsqrt(veps))
        shift = self.sub(beta, self.mul(mean, scale))
        sb = self.broadcast(scale, shp, (cdim,))
        hb = self.broadcast(shift, shp, (cdim,))
        return self.add(self.mul(x, sb), hb)

    def avg_pool(self, x, window, strides=None, padding="VALID") -> int:
        return self.op("avg_pool", [x], window=tuple(window),
                       strides=tuple(strides or window), padding=padding)
