"""Fused RMSNorm: the hand-written CUDA kernel (``csrc/rmsnorm.cu``), its
shared-memory size, and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel of
``src/repro/kernels/rmsnorm/rmsnorm.py`` (``_rmsnorm_kernel``).  One pass
over the rows — mean of squares, rsqrt, scale — in f32, so the normalized
intermediate never round-trips to HBM; ``block_rows`` rows per CUDA block.
Its gradient is a kernel too (``rmsnorm_bwd`` in the same source): one warp
a row, dscale summed through per-block f32 partial rows in a fixed order.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float] + \
    [ctypes.c_int] * 5 + [ctypes.c_void_p]

# the backward's geometry: warps a block (each with an f32 row of dscale in
# shared memory, beside the staged scale), at most BWD_BLOCKS blocks
BWD_WARPS = 8
BWD_BLOCKS = 512
BWD_SMEM_CAP = 200 * 1024


def smem_bytes(knobs: dict, shape: dict, dtype: torch.dtype):
    """Dynamic shared memory of one block: the scale vector staged as f32.
    Pure arithmetic on the values, so the cost model evaluates it on arrays
    of genomes too."""
    return 4 * shape["d"]


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float,
                  block_rows: int) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: one block of ``block_rows``
    rows at a time, sum of squares and normalization in f32."""
    rows, d = x.shape
    y = torch.empty_like(x)
    s = scale.to(torch.float32)
    for r0 in range(0, rows, block_rows):
        xb = x[r0:r0 + block_rows].to(torch.float32)
        ms = (xb * xb).sum(-1, keepdim=True) / d
        y[r0:r0 + block_rows] = (xb * torch.rsqrt(ms + eps) * s).to(x.dtype)
    return y


def rmsnorm_launch(x: torch.Tensor, scale: torch.Tensor, y: torch.Tensor, *,
                   eps: float, block_rows: int, smem: int) -> None:
    """Launch the CUDA kernel on PyTorch's current stream.  The caller has
    checked the arguments (``ops.rmsnorm``)."""
    fn = build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    rows, d = x.shape
    err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
             block_rows, eps, build.DTYPE_CODES[x.dtype],
             build.DTYPE_CODES[scale.dtype], smem,
             build.stream_ptr(x.device))
    build.check("rmsnorm", err, "rmsnorm_fwd")


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      *, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in plain PyTorch, in f32: with
    ``r = rsqrt(mean(x^2) + eps)`` and ``g = dy * scale``, ``dx = r (g - x
    r^2 mean(g x))`` in x's dtype and ``dscale = sum_rows dy x r`` in
    scale's.  x, dy: (rows, d)."""
    d = x.shape[-1]
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    s32 = scale.to(torch.float32)
    r = torch.rsqrt((x32 * x32).sum(-1, keepdim=True) / d + eps)
    c = r * r * ((dy32 * s32 * x32).sum(-1, keepdim=True) / d)
    dx = r * (dy32 * s32 - x32 * c)
    dscale = (dy32 * x32 * r).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd_geometry(rows: int, d: int) -> dict:
    """Warps a block, blocks and dynamic shared memory of the backward
    kernel for (rows, d): as many warps (up to ``BWD_WARPS``) as leave the
    f32 rows of dscale and the scale within ``BWD_SMEM_CAP`` bytes, and
    enough blocks for every row, at most ``BWD_BLOCKS``."""
    warps = max(1, min(BWD_WARPS, BWD_SMEM_CAP // (4 * d) - 1))
    blocks = max(1, min(BWD_BLOCKS, -(-rows // warps)))
    return {"warps": warps, "blocks": blocks,
            "smem": (warps + 1) * d * 4}


def rmsnorm_bwd_launch(x, scale, dy, dx, dscale, partial, *, eps: float,
                       geometry: dict) -> None:
    """Launch the backward kernels on PyTorch's current stream: dx and
    dscale from x, scale and dy, ``partial`` ((blocks, d) f32) the
    per-block rows of dscale.  The caller has checked the arguments
    (``ops.rmsnorm_bwd``)."""
    fn = build.function("rmsnorm", "rmsnorm_bwd", _BWD_ARGTYPES)
    rows, d = x.shape
    err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
             dscale.data_ptr(), partial.data_ptr(), rows, d, eps,
             build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[scale.dtype],
             geometry["blocks"], geometry["warps"], geometry["smem"],
             build.stream_ptr(x.device))
    build.check("rmsnorm", err, "rmsnorm_bwd")
