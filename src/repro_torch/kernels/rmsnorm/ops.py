"""Public wrappers for the fused RMSNorm kernel and its backward.

On CUDA tensors they launch the hand-written kernels (or raise); on CPU
tensors they run the kernels' plain PyTorch versions, which is how the
tests on hosts without a GPU reach them.  ``rmsnorm`` is differentiable:
when autograd records it, its gradient is :func:`rmsnorm_bwd`, the backward
kernel.  ``rmsnorm.launches`` and ``rmsnorm_bwd.launches`` count kernel
launches.  On tensors that hold no data (fake or meta tensors) they take
the kernel's path up to the launch and record its work instead
(``kernels/trace.py``).
"""

from __future__ import annotations

import torch

from .. import trace
from ..build import DTYPE_CODES
from ..cpu import init_vector_math
from .rmsnorm import (rmsnorm_bwd_geometry, rmsnorm_bwd_launch,
                      rmsnorm_bwd_plain, rmsnorm_launch, rmsnorm_plain,
                      smem_bytes)


def _check_device(what: str, tensors) -> bool:
    """True for CPU tensors (the plain version); raise unless every tensor
    lies on one CUDA device in a type the kernel takes, contiguous.
    Tensors that hold no data take the kernel's checks on any device."""
    if not trace.shape_only(tensors):
        devices = {t.device for t in tensors}
        if devices == {torch.device("cpu")}:
            init_vector_math()
            return True
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"{what}: tensors on "
                             f"{sorted(map(str, devices))}; the kernel "
                             "takes one CUDA device")
    if any(t.dtype not in DTYPE_CODES for t in tensors):
        raise ValueError(f"{what}: dtypes {[t.dtype for t in tensors]}; the "
                         "kernel takes float32 and bfloat16")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    return False


def _forward(x2: torch.Tensor, scale: torch.Tensor, eps: float,
             block_rows: int) -> torch.Tensor:
    rows, d = x2.shape
    if _check_device("rmsnorm", (x2, scale)):
        return rmsnorm_plain(x2, scale, eps=eps, block_rows=block_rows)
    y = torch.empty_like(x2)
    if trace.shape_only((x2, scale)):
        trace.record("rmsnorm", "fwd", {"rows": rows, "d": d}, x2.dtype,
                     scale_dtype=scale.dtype)
        return y
    rmsnorm_launch(x2, scale, y, eps=eps, block_rows=block_rows,
                   smem=smem_bytes({"block_rows": block_rows},
                                   {"rows": rows, "d": d}, x2.dtype))
    rmsnorm.launches += 1
    return y


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rmsnorm` for x, dy: (rows, d) and scale:
    (d,): (dx in x's dtype, dscale in scale's)."""
    rows, d = x.shape
    if dy.shape != x.shape or scale.shape != (d,) or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)} {x.dtype}, dy "
                         f"{tuple(dy.shape)} {dy.dtype}, scale "
                         f"{tuple(scale.shape)}")
    if _check_device("rmsnorm_bwd", (x, scale, dy)):
        return rmsnorm_bwd_plain(x, scale, dy, eps=eps)
    dx = torch.empty_like(x)
    # tensors without data: the caching allocator's blocks are aligned
    shape_only = trace.shape_only((x, scale, dy))
    geo = rmsnorm_bwd_geometry(rows, d, x.dtype, aligned=shape_only or all(
        t.data_ptr() % 16 == 0 for t in (x, dy, dx)))
    dscale = torch.empty_like(scale)
    partial = torch.empty((geo["blocks"], d), dtype=torch.float32,
                          device=x.device)
    if shape_only:
        trace.record("rmsnorm", "bwd", {"rows": rows, "d": d}, x.dtype,
                     scale_dtype=scale.dtype)
        return dx, dscale
    rmsnorm_bwd_launch(x, scale, dy, dx, dscale, partial, eps=eps,
                       geometry=geo)
    rmsnorm_bwd.launches += 1
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with the backward kernel as its gradient; saves x and
    scale."""

    @staticmethod
    def forward(ctx, x2, scale, eps, block_rows):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return _forward(x2, scale, eps, block_rows)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x2, scale, dy.contiguous(), eps=ctx.eps)
        return dx, dscale, None, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 128) -> torch.Tensor:
    """x: (..., d) -> fused rms-normalized x * scale, in x's dtype;
    differentiable in x and scale."""
    shape = x.shape
    d = shape[-1]
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    block_rows = min(block_rows, rows)
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != "
                         f"({d},)")
    if rows % block_rows != 0:
        raise ValueError(f"rmsnorm: block_rows {block_rows} does not divide "
                         f"rows {rows}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        y = _RMSNorm.apply(x2, scale, eps, block_rows)
    else:
        y = _forward(x2, scale, eps, block_rows)
    return y.reshape(shape)


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
