"""Fused RMSNorm: the hand-written CUDA kernel (``csrc/rmsnorm.cu``), its
shared-memory size, and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel of
``src/repro/kernels/rmsnorm/rmsnorm.py`` (``_rmsnorm_kernel``).  One pass
over the rows — mean of squares, rsqrt, scale — in f32, so the normalized
intermediate never round-trips to HBM; ``block_rows`` rows per CUDA block.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
