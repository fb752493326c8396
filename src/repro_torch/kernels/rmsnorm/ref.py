"""Plain-PyTorch oracle for fused RMSNorm (the counterpart of
``src/repro/kernels/rmsnorm/ref.py``)."""

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)
