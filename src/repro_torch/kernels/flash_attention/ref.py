"""Plain-PyTorch oracle for flash attention (the counterpart of
``src/repro/kernels/flash_attention/ref.py``)."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: float | None = None):
    """q, k, v: (B, H, S, hd) -> (B, H, Sq, hd), fp32 softmax."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        Sq, Sk = s.shape[-2:]
        qi = torch.arange(Sq, device=q.device)[:, None]
        kj = torch.arange(Sk, device=q.device)[None, :]
        # a fill on the device, not a copy from the host: a CUDA graph
        # captures this function in the measured kernel search
        s = torch.where(kj <= qi, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
