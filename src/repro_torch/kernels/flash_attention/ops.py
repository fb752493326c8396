"""Public wrappers for the flash-attention kernel and its backward.

On CUDA tensors they launch the hand-written kernels (or raise); on CPU
tensors they run the kernels' plain PyTorch versions, which is how the
tests on hosts without a GPU reach them.  ``flash_attention`` is
differentiable: when autograd records it, the forward also keeps each
row's log-sum-exp and the gradient is :func:`flash_attention_bwd`, the
backward kernel.  ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count kernel launches.  On tensors that
hold no data (fake or meta tensors) they take the kernel's path up to the
launch and record its work instead (``kernels/trace.py``).
"""

from __future__ import annotations

import torch

from .. import trace
from ..build import DTYPE_CODES
from ..cpu import init_vector_math
from .flash_attention import (BF16_BLOCK_K, HEAD_DIMS, MAX_BLOCK_Q,
                              bwd_scratch, flash_attention_bwd_launch,
                              flash_attention_bwd_plain,
                              flash_attention_launch, flash_attention_plain,
                              launch_head_dim, smem_bytes)


def _on_cpu(what: str, tensors) -> bool:
    """True for CPU tensors (the plain version); raise unless every tensor
    lies on one CUDA device and q, k, v share a type the kernel takes.
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
    if len({t.dtype for t in tensors[:3]}) != 1 \
            or tensors[0].dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: q, k, v must share one dtype, float32 or "
                         "bfloat16")
    return False


def _launch(q, k, v, *, causal, scale, block_q, block_k, want_lse):
    """The forward kernel on q, k, v already at a launch head dim; returns
    o, or (o, lse) with ``want_lse``."""
    shape_only = trace.shape_only((q, k, v))
    if not all(t.is_contiguous() and (shape_only or t.data_ptr() % 16 == 0)
               for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous and "
                         "16-byte aligned")
    B, H, Sq, hd = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if shape_only:
        trace.record("flash_attention", "fwd",
                     {"B": B, "H": H, "S": Sq, "hd": hd}, q.dtype,
                     Sk=k.shape[2], causal=causal, lse=want_lse)
        return (o, lse) if want_lse else o
    flash_attention_launch(
        q, k, v, o, causal=causal, scale=scale, block_q=block_q,
        block_k=block_k,
        smem=smem_bytes({"block_q": block_q, "block_k": block_k},
                        {"B": B, "H": H, "S": Sq, "hd": hd}, q.dtype),
        lse=lse)
    flash_attention.launches += 1
    return (o, lse) if want_lse else o


def check_bwd_launch(q, k, v, o, do, lse) -> None:
    """Raise unless the backward kernels take these tensors (of the shapes
    :func:`flash_attention_bwd` checks): a head dim they are built for, o
    and do in q's dtype, lse float32, all contiguous, and in bf16 every
    tensor the kernels read by TMA or vector loads 16-byte aligned."""
    hd = q.shape[3]
    if hd not in HEAD_DIMS or not (o.dtype == do.dtype == q.dtype) \
            or lse.dtype != torch.float32 or k.shape[2] < 1:
        raise ValueError(f"flash_attention_bwd: head dim {hd} not in "
                         f"{HEAD_DIMS}, or o/do not in q's dtype, or lse not "
                         "float32")
    if not all(t.is_contiguous() for t in (q, k, v, o, do, lse)):
        raise ValueError("flash_attention_bwd: tensors must be contiguous")
    if q.dtype == torch.bfloat16 and not trace.shape_only((q,)) and any(
            t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: bf16 q, k, v, o and do must "
                         "be 16-byte aligned")


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        scale: float | None = None):
    """The gradient of :func:`flash_attention`: q, o, do: (B, H, Sq, hd);
    k, v: (B, H, Sk, hd); lse: the forward's (B, H, Sq) f32 log-sum-exp.
    Returns (dq, dk, dv).  On the card hd must be one the kernel is built
    for (the forward's wrapper pads to it before the recorded call)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != hd \
            or o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}")
    if _on_cpu("flash_attention_bwd", (q, k, v, o, do, lse)):
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         scale=scale)
    check_bwd_launch(q, k, v, o, do, lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if trace.shape_only((q, k, v, o, do, lse)):
        bwd_scratch(q)
        trace.record("flash_attention", "bwd",
                     {"B": B, "H": H, "S": Sq, "hd": hd}, q.dtype, Sk=Sk,
                     causal=causal)
        return dq, dk, dv
    flash_attention_bwd_launch(q, k, v, o, do, lse, dq, dk, dv,
                               causal=causal, scale=scale)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention at a launch head dim with the backward kernel as its
    gradient; saves q, k, v, o and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        if q.device.type == "cpu" and not trace.shape_only((q, k, v)):
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           scale=scale, block_q=block_q,
                                           block_k=block_k, return_lse=True)
        else:
            o, lse = _launch(q, k, v, causal=causal, scale=scale,
                             block_q=block_q, block_k=block_k,
                             want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q, k, v: (B, H, S, hd) -> (B, H, Sq, hd); k/v length may differ
    from q's.  On the card a head dim the kernel is not built for runs
    padded to the next one it is (``launch_head_dim``): the pad and the
    slice back are autograd ops around the kernel, so the gradient of the
    padding columns is dropped.  Differentiable in q, k and v."""
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
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    args = (causal, scale, block_q, block_k)
    if _on_cpu("flash_attention", (q, k, v)):
        if grad:
            return _FlashAttention.apply(q, k, v, *args)
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
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
    if grad:
        o = _FlashAttention.apply(q, k, v, *args)
        return o if hd_k == hd else o[..., :hd]
    o = _launch(q, k, v, causal=causal, scale=scale, block_q=block_q,
                block_k=block_k, want_lse=False)
    return o if hd_k == hd else o[..., :hd].contiguous()


flash_attention.launches = 0
flash_attention_bwd.launches = 0
