"""Gradient compression for cross-replica reduction: int8 quantization with
error feedback (the counterpart of ``src/repro/optim/grad_compress.py``,
with its arithmetic).

``compressed_psum`` quantizes a tensor to int8 with a per-tensor scale,
all-reduces the int8 payload (summed as int32: 8/32 of the bytes of an
f32 all-reduce in the reference's wire format; the scale rides along as
one f32), dequantizes, and keeps the quantization residual locally —
added back before the next step's compression so the error is
compensated, not lost.  Each rank's payload is summed under the mean of
the ranks' scales, as the reference does, so the result is not the exact
mean when the scales differ.  The axis is a bound mesh axis
(``models/common.py``); the train step runs these under ``no_grad``.
"""

from __future__ import annotations

import torch

from ..models.common import axis_size, psum

F32 = torch.float32


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    # a device tensor, not a host scalar: torch on the GPU divides by a
    # host scalar as a multiply by its rounded reciprocal
    return torch.tensor(value, dtype=F32, device=like.device)


def quantize_int8(x):
    """-> (q int8, scale f32).  Symmetric per-tensor quantization."""
    amax = torch.max(torch.abs(x)) + _f32(1e-12, x)
    scale = amax / _f32(127.0, x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(F32) * scale


def compressed_psum(x, axis_name, residual=None):
    """All-reduce ``x`` over ``axis_name`` with int8 wire format + error
    feedback.  Returns (mean-reduced x, new residual)."""
    if residual is not None:
        x = x + residual
    q, scale = quantize_int8(x)
    deq = dequantize_int8(q, scale)
    new_residual = x - deq                      # local quantization error
    # int8 payload reduced in int32 to avoid overflow across replicas
    summed = psum(q.to(torch.int32), axis_name)
    scale_sum = psum(scale, axis_name)          # scales are near-equal; mean
    n = _f32(float(axis_size(axis_name)), x)
    out = summed.to(F32) * (scale_sum / n) / n
    return out, new_residual


def compress_tree_psum(grads: dict, axis_name, residuals=None):
    """``compressed_psum`` leaf by leaf over a dict of gradients keyed by
    parameter name; returns (reduced, residuals), dicts of the same
    keys."""
    if residuals is None:
        residuals = {k: torch.zeros(g.shape, dtype=F32, device=g.device)
                     for k, g in grads.items()}
    out = {k: compressed_psum(g.to(F32), axis_name, residuals[k])
           for k, g in grads.items()}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()})
