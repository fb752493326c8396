"""Public wrappers for the mamba selective-scan kernel and its backward.

On CUDA tensors they launch the hand-written kernels (or raise); on CPU
tensors they run the kernels' plain PyTorch versions, which is how the
tests on hosts without a GPU reach them.  ``mamba_scan`` is
differentiable: when autograd records it, the forward also keeps the state
at the start of each tile of ``chunk`` steps and the gradient is
:func:`mamba_scan_bwd`, the backward kernel.  ``mamba_scan.launches`` and
``mamba_scan_bwd.launches`` count kernel launches.  On tensors that hold
no data (fake or meta tensors) they take the kernel's path up to the
launch and record its work instead (``kernels/trace.py``).
"""

from __future__ import annotations

import torch

from .. import trace
from ..build import DTYPE_CODES
from ..cpu import init_vector_math
from .mamba_scan import (bwd_scratch, mamba_scan_bwd_launch,
                         mamba_scan_bwd_plain, mamba_scan_launch,
                         mamba_scan_plain, smem_bytes)


def _check(what, dt, x, A, B, C) -> tuple[int, int, int, int]:
    Bt, L, D = x.shape
    N = A.shape[1] if A.dim() == 2 else -1
    if dt.shape != x.shape or A.shape != (D, N) \
            or B.shape != (Bt, L, N) or C.shape != (Bt, L, N):
        raise ValueError(f"{what}: shapes dt {tuple(dt.shape)}, "
                         f"x {tuple(x.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    return Bt, L, D, N


def _on_cpu(what: str, tensors, N: int) -> bool:
    """True for CPU tensors (the plain version); raise unless every tensor
    lies on one CUDA device in the types and layout the kernel takes.
    Tensors that hold no data take the kernel's checks on any device."""
    dt, x, A, B, C = tensors[:5]
    if not trace.shape_only(tensors):
        devices = {t.device for t in tensors}
        if devices == {torch.device("cpu")}:
            init_vector_math()
            return True
        if len(devices) != 1 or x.device.type != "cuda":
            raise ValueError(f"{what}: tensors on "
                             f"{sorted(map(str, devices))}; the kernel "
                             "takes one CUDA device")
    if not (dt.dtype == x.dtype == B.dtype == C.dtype) \
            or x.dtype not in DTYPE_CODES or A.dtype != torch.float32:
        raise ValueError(f"{what}: dt, x, B, C must share one dtype "
                         "(float32 or bfloat16) and A must be float32")
    if N > 32 or N & (N - 1):
        raise ValueError(f"{what}: state size {N} must be a power of two "
                         "up to 32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    return False


def _forward(dt, x, A, B, C, *, chunk: int, return_state: bool,
             return_chunks: bool):
    """y, then h_last with ``return_state``, then h_chunks with
    ``return_chunks``; y alone when neither."""
    Bt, L, D, N = _check("mamba_scan", dt, x, A, B, C)
    if _on_cpu("mamba_scan", (dt, x, A, B, C), N):
        return mamba_scan_plain(dt, x, A, B, C, chunk=chunk,
                                return_state=return_state,
                                return_chunks=return_chunks)
    f32 = {"dtype": torch.float32, "device": x.device}
    y = torch.empty_like(x)
    h = torch.empty((Bt, D, N), **f32) if return_state else None
    hc = (torch.empty((Bt, L // chunk, D, N), **f32) if return_chunks
          else None)
    if trace.shape_only((dt, x, A, B, C)):
        trace.record("mamba_scan", "fwd", {"Bt": Bt, "L": L, "D": D, "N": N},
                     x.dtype, state=return_state,
                     h_chunks=L // chunk if return_chunks else 0)
    else:
        mamba_scan_launch(dt, x, A, B, C, y, h, chunk=chunk,
                          smem=smem_bytes({"chunk": chunk},
                                          {"Bt": Bt, "L": L, "D": D, "N": N},
                                          x.dtype), h_chunks=hc)
        mamba_scan.launches += 1
    out = (y,) + ((h,) if return_state else ()) + \
        ((hc,) if return_chunks else ())
    return out if len(out) > 1 else y


def mamba_scan_bwd(dt, x, A, B, C, dy, h_chunks, dh_last=None, *,
                   chunk: int):
    """The gradient of :func:`mamba_scan` at ``chunk`` (the forward's):
    ``dy`` (Bt, L, D) and ``dh_last`` (the final state's, (Bt, D, N) f32,
    or None); ``h_chunks`` the forward's states at each tile's start.
    Returns (ddt, dx, dA, dB, dC)."""
    Bt, L, D, N = _check("mamba_scan_bwd", dt, x, A, B, C)
    if dy.shape != x.shape or dy.dtype != x.dtype \
            or h_chunks.shape != (Bt, L // chunk, D, N) or L % chunk \
            or (dh_last is not None and dh_last.shape != (Bt, D, N)):
        raise ValueError(f"mamba_scan_bwd: dy {tuple(dy.shape)} {dy.dtype}, "
                         f"h_chunks {tuple(h_chunks.shape)}, chunk {chunk}")
    rest = (dy, h_chunks) + (() if dh_last is None else (dh_last,))
    if _on_cpu("mamba_scan_bwd", (dt, x, A, B, C) + rest, N):
        return mamba_scan_bwd_plain(dt, x, A, B, C, dy, h_chunks, dh_last,
                                    chunk=chunk)
    if h_chunks.dtype != torch.float32 or (
            dh_last is not None and dh_last.dtype != torch.float32):
        raise ValueError("mamba_scan_bwd: h_chunks and dh_last must be "
                         "float32")
    ddt, dx, dB, dC = (torch.empty_like(t) for t in (dt, x, B, C))
    dA = torch.empty_like(A)
    if trace.shape_only((dt, x, A, B, C) + rest):
        bwd_scratch(x, N)
        trace.record("mamba_scan", "bwd", {"Bt": Bt, "L": L, "D": D, "N": N},
                     x.dtype, chunk=chunk, dh_last=dh_last is not None)
        return ddt, dx, dA, dB, dC
    mamba_scan_bwd_launch(dt, x, A, B, C, dy, dh_last, h_chunks, ddt, dx,
                          dA, dB, dC, chunk=chunk)
    mamba_scan_bwd.launches += 1
    return ddt, dx, dA, dB, dC


class _MambaScan(torch.autograd.Function):
    """The scan with the backward kernel as its gradient; saves the inputs
    and the states at each tile's start.  Outputs y and h_last."""

    @staticmethod
    def forward(ctx, dt, x, A, B, C, chunk):
        y, h, hc = _forward(dt, x, A, B, C, chunk=chunk, return_state=True,
                            return_chunks=True)
        ctx.save_for_backward(dt, x, A, B, C, hc)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, x, A, B, C, hc = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = mamba_scan_bwd(
            dt, x, A, B, C, dy, hc,
            None if dh_last is None else dh_last.contiguous(),
            chunk=ctx.chunk)
        return grads + (None,)


def mamba_scan(dt, x, A, B, C, *, chunk: int = 64,
               return_state: bool = False):
    """Selective scan: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t; y = C.h.
    dt, x: (Bt, L, D); A: (D, N) float32; B, C: (Bt, L, N).  Returns y, or
    ``(y, h_last)`` with ``return_state``: the (Bt, D, N) float32 state
    after the last step, bit-identical across ``chunk`` as y is.
    Differentiable in dt, x, A, B and C (through y and h_last)."""
    Bt, L, D, N = _check("mamba_scan", dt, x, A, B, C)
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"mamba_scan: chunk {chunk} does not divide L {L}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, x, A, B, C)):
        y, h = _MambaScan.apply(dt, x, A, B, C, chunk)
        return (y, h) if return_state else y
    return _forward(dt, x, A, B, C, chunk=chunk, return_state=return_state,
                    return_chunks=False)


mamba_scan.launches = 0
mamba_scan_bwd.launches = 0
