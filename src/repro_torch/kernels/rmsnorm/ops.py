"""Public wrapper for the fused RMSNorm kernel.

On a CUDA tensor it launches the hand-written kernel (or raises); on a CPU
tensor it runs the kernel's plain PyTorch version, which is how the tests
on hosts without a GPU reach it.  ``rmsnorm.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from ..build import DTYPE_CODES
from ..cpu import init_vector_math
from .rmsnorm import rmsnorm_launch, rmsnorm_plain, smem_bytes


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 128) -> torch.Tensor:
    """x: (..., d) -> fused rms-normalized x * scale, in x's dtype."""
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
    if x.device.type == "cpu" and scale.device.type == "cpu":
        init_vector_math()
        return rmsnorm_plain(x2, scale, eps=eps,
                             block_rows=block_rows).reshape(shape)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: tensors on {x.device} and "
                         f"{scale.device}; the kernel takes one CUDA device")
    if x.dtype not in DTYPE_CODES or scale.dtype not in DTYPE_CODES:
        raise ValueError(f"rmsnorm: dtypes {x.dtype}, {scale.dtype}; the "
                         "kernel takes float32 and bfloat16")
    if not x2.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm: x and scale must be contiguous")
    y = torch.empty_like(x2)
    rmsnorm_launch(x2, scale, y, eps=eps, block_rows=block_rows,
                   smem=smem_bytes({"block_rows": block_rows},
                                   {"rows": rows, "d": d}, x.dtype))
    rmsnorm.launches += 1
    return y.reshape(shape)


rmsnorm.launches = 0
