"""Pieces the references share: matrix products in float32 or from fp8
operands, RMSNorm, a linear recurrence with its backward, AdamW."""

from __future__ import annotations

import torch

F32 = torch.float32
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def exact_f32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one scale for the tensor (its largest
    magnitude to the format's largest), back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(FP8).to(F32) * scale


class _Fp8Product(torch.autograd.Function):
    """a @ b from fp8 operands, and its gradients from fp8 operands."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).transpose(0, 1) @ \
            qg.reshape(-1, qg.shape[-1])
        return ga, gb.reshape(qb.shape)


def product(precision: str):
    """The matrix product ``(a (..., k), b (k, n)) -> (..., n)``."""
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Product.apply
    raise ValueError(f"unknown precision {precision!r}")


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


class Recurrence(torch.autograd.Function):
    """h_t = a_t h_{t-1} + u_t from h_{-1} = 0, over axis 1 of (B, L, ...)
    inputs; the backward walks time the other way:
    dh_t = g_t + a_{t+1} dh_{t+1}, du_t = dh_t, da_t = dh_t h_{t-1}."""

    @staticmethod
    def forward(ctx, a, u):
        a_t = a.transpose(0, 1).contiguous()
        u_t = u.transpose(0, 1).contiguous()
        h = torch.empty_like(u_t)
        h[0] = u_t[0]
        for t in range(1, h.shape[0]):
            torch.addcmul(u_t[t], a_t[t], h[t - 1], out=h[t])
        ctx.save_for_backward(a_t, h)
        return h.transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        a_t, h = ctx.saved_tensors
        g_t = g.transpose(0, 1).contiguous()
        dh = torch.empty_like(g_t)
        dh[-1] = g_t[-1]
        for t in range(dh.shape[0] - 2, -1, -1):
            torch.addcmul(g_t[t], a_t[t + 1], dh[t + 1], out=dh[t])
        da = torch.zeros_like(dh)
        da[1:] = dh[1:] * h[:-1]
        return da.transpose(0, 1), dh.transpose(0, 1)


def adamw(p32, g, m, v, t: int, hp: dict, dtype) -> torch.Tensor:
    """One AdamW step of the float32 value ``p32`` of a parameter stored
    in ``dtype``: m and v updated in place; the new value rounded to how
    it is stored, back in float32."""
    b1, b2 = hp["b1"], hp["b2"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    upd = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + hp["eps"])
    new = p32 - hp["lr"] * (upd + hp["weight_decay"] * p32)
    return new.to(dtype).to(F32)
