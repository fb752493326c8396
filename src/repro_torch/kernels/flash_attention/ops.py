"""Public wrapper for the flash-attention kernel.

On CUDA tensors it launches the hand-written kernel (or raises); on CPU
tensors it runs the kernel's plain PyTorch version, which is how the tests
on hosts without a GPU reach it.  ``flash_attention.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from ..build import DTYPE_CODES
from ..cpu import init_vector_math
from .flash_attention import (BF16_BLOCK_K, MAX_BLOCK_Q,
                              flash_attention_launch, flash_attention_plain,
                              launch_head_dim, smem_bytes)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q, k, v: (B, H, S, hd) -> (B, H, Sq, hd); k/v length may differ
    from q's.  On the card a head dim the kernel is not built for runs
    padded to the next one it is (``launch_head_dim``)."""
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    if Sq % block_q or Sk % block_k:
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_k}) "
                         f"do not divide (Sq, Sk) = ({Sq}, {Sk})")
    scale = hd ** -0.5
    devices = {t.device for t in (q, k, v)}
    if devices == {torch.device("cpu")}:
        init_vector_math()
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on "
                         f"{sorted(map(str, devices))}; the kernel takes one "
                         "CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise ValueError("flash_attention: q, k, v must share one dtype, "
                         "float32 or bfloat16")
    hd_k = launch_head_dim(hd)
    if block_q % 8 or block_q > MAX_BLOCK_Q:
        raise ValueError(f"flash_attention: block_q {block_q} must be a "
                         f"multiple of 8 and at most {MAX_BLOCK_Q}")
    if q.dtype == torch.bfloat16 and block_k not in BF16_BLOCK_K:
        raise ValueError(f"flash_attention: bf16 block_k {block_k} not in "
                         f"{BF16_BLOCK_K}")
    if hd_k != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, hd_k - hd))
                   for t in (q, k, v))
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous and "
                         "16-byte aligned")
    o = torch.empty_like(q)
    flash_attention_launch(
        q, k, v, o, causal=causal, scale=scale, block_q=block_q,
        block_k=block_k,
        smem=smem_bytes({"block_q": block_q, "block_k": block_k},
                        {"B": B, "H": H, "S": Sq, "hd": hd_k}, q.dtype))
    flash_attention.launches += 1
    return o if hd_k == hd else o[..., :hd].contiguous()


flash_attention.launches = 0
