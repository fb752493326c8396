"""Plain-PyTorch oracle for the mamba1 selective scan (the counterpart of
``src/repro/kernels/mamba_scan/ref.py``)."""

from __future__ import annotations

import torch


def mamba_scan_ref(dt, x, A, B, C):
    """dt, x: (Bt, L, D); A: (D, N); B, C: (Bt, L, N) -> y (Bt, L, D)."""
    dt32 = dt.to(torch.float32)
    x32 = x.to(torch.float32)
    a = torch.exp(dt32[..., None] * A)                        # (Bt, L, D, N)
    b = (dt32 * x32)[..., None] * B.to(torch.float32)[:, :, None, :]
    c = C.to(torch.float32)
    Bt, L, D = x.shape
    h = torch.zeros((Bt, D, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(L):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.sum(h * c[:, t, None, :], dim=-1))
    return torch.stack(ys, dim=1).to(x.dtype)
