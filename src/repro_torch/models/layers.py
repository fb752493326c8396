"""Shared neural-net layers: norms, rotary embeddings, MLPs, initializers,
and the parameter container every block is made of.

The counterpart of ``src/repro/models/layers.py``.  ``rms_norm`` runs on the
fused RMSNorm kernel's wrapper (``kernels/rmsnorm/ops.py``): the hand-written
CUDA kernel on the card, its plain PyTorch version on CPU tensors; its
gradient is the backward kernel's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import trace
from ..kernels.rmsnorm.ops import rmsnorm
from .common import axis_index, pmax, tp_block, tp_enter, tp_exit

MAX_NORM_BLOCK_ROWS = 128


class Params(nn.Module):
    """A named group of parameters, read by key as the reference's parameter
    dicts are (``p["wq"]``, ``"bq" in p``).  Tensors become trainable
    ``nn.Parameter``s; modules nest."""

    def __init__(self, **members):
        super().__init__()
        for name, value in members.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def dense_init(shape, *, generator, device, in_axis: int = -2,
               dtype=torch.float32) -> torch.Tensor:
    """Normal weights at ``1/sqrt(fan_in)`` scale, as the reference's
    ``dense_init``, drawn from ``generator`` on ``device`` (a ``meta``
    device gives the empty tensor of the shape: the skeleton the weight
    converter fills)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, device=device)
    return (w / float(np.sqrt(fan_in))).to(dtype)


def norm_block_rows(rows: int) -> int:
    """The rmsnorm kernel's ``block_rows`` for ``rows`` rows: the largest
    divisor of ``rows`` at most 128 (the kernel's shipped schedule).  Token
    counts can be prime; one row a block runs as fast as 256 on the H100."""
    for b in range(min(MAX_NORM_BLOCK_ROWS, rows), 1, -1):
        if rows % b == 0:
            return b
    return 1


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in f32,
    cast back to x's dtype: one launch of the rmsnorm kernel over all rows."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    y = rmsnorm(x2, scale, eps=eps, block_rows=norm_block_rows(x2.shape[0]))
    return y.reshape(x.shape)


def split_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   d: int, axis_name: str) -> torch.Tensor:
    """:func:`rms_norm` of rows whose ``d`` entries are split over a bound
    model axis: ``x`` (..., d / m) and ``scale`` this rank's block (or the
    whole scale, whose block is taken); each row's sum of squares is one
    sum over the axis (forward, and of its gradient: each rank's
    cotangent is its block's), in f32 as the kernel's plain version
    computes it.  Torch ops: the kernel takes no outside row scale."""
    scale = tp_block(scale, axis_name, 0, d)
    x32 = x.to(torch.float32)
    ss = tp_enter(tp_exit((x32 * x32).sum(-1, keepdim=True), axis_name),
                  axis_name)
    y = x32 * torch.rsqrt(ss / d + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


def rope_freqs(hd: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, hd, 2) / hd))


def _freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The rotary frequencies, cached a (head dim, theta, device); a dry
    run's (fake) tensor is made anew and never cached."""
    if trace.fake_mode_active():
        return _make_freqs(hd, theta, device)
    return _cached_freqs(hd, theta, device)


def _make_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return torch.tensor(rope_freqs(hd, theta), dtype=torch.float32,
                        device=device)


_cached_freqs = functools.lru_cache(maxsize=64)(_make_freqs)


def _rotate(x, cos, sin):
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = _freqs(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, hd/2)
    return _rotate(x, torch.cos(ang)[..., None, :],
                   torch.sin(ang)[..., None, :])


def apply_mrope(x, positions3, theta: float = 1e4,
                sections=(0.25, 0.375, 0.375)):
    """M-RoPE (Qwen2-VL): rotary frequency channels split into temporal /
    height / width sections, each driven by its own position id.

    x: (B, S, H, hd); positions3: (B, S, 3)."""
    hd = x.shape[-1]
    half = hd // 2
    bounds = np.cumsum([int(half * s) for s in sections])
    bounds[-1] = half
    sec = np.zeros(half, np.int64)
    sec[bounds[0]:bounds[1]] = 1
    sec[bounds[1]:] = 2
    index = torch.as_tensor(sec, device=x.device).expand(
        positions3.shape[:2] + (half,))
    pos = torch.gather(positions3.to(torch.float32), -1, index)  # (B,S,half)
    ang = pos * _freqs(hd, float(theta), x.device)
    return _rotate(x, torch.cos(ang)[..., None, :],
                   torch.sin(ang)[..., None, :])


def swiglu(x, w_gate, w_up, w_down, axis_name: str | None = None,
           d_ff: int = 0):
    """SwiGLU MLP: down( silu(x@gate) * (x@up) ).  With ``axis_name`` (a
    bound model axis) the ``d_ff`` hidden units are split over it: ``x``
    enters the region whole, ``gate`` and ``up`` are this rank's columns
    and ``down`` its rows (each the block, or the whole weight, whose
    block is taken), and the row-parallel product ends in one sum over the
    axis."""
    if axis_name is None:
        return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
    x = tp_enter(x, axis_name)
    g = tp_block(w_gate, axis_name, 1, d_ff)
    u = tp_block(w_up, axis_name, 1, d_ff)
    d = tp_block(w_down, axis_name, 0, d_ff)
    return tp_exit((F.silu(x @ g) * (x @ u)) @ d, axis_name)


def softmax_cross_entropy(logits, labels, axis_name: str | None = None):
    """logits: (..., V) fp32-accumulated; labels: int (...,).  With
    ``axis_name`` (a bound model axis) ``logits`` are this rank's block of
    the vocabulary (rank r's ids r V_local .. (r + 1) V_local - 1): the
    vocabulary-parallel form, a maximum over the axis, one sum of the
    exponentials and one of the gold logit, which only the rank whose
    block holds the label contributes."""
    logits = logits.to(torch.float32)
    if axis_name is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return logz - gold
    v = logits.shape[-1]
    local = labels.long() - axis_index(axis_name) * v
    mine = (local >= 0) & (local < v)
    top = pmax(logits.amax(-1), axis_name)
    sumexp = tp_exit(torch.exp(logits - top[..., None]).sum(-1), axis_name)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = tp_exit(torch.where(mine, gold, torch.zeros_like(gold)),
                   axis_name)
    return torch.log(sumexp) + top - gold


def embed_lookup(table, ids, vocab: int, axis_name: str | None = None):
    """Rows ``ids`` of the (vocab, d) embedding ``table``; an id at or
    beyond ``vocab`` raises as indexing does.  With ``axis_name`` (a bound
    model axis) the vocabulary is split over it: ``table`` is this rank's
    block of rows (or the whole table, whose block is taken), each rank
    gathers the ids its block holds, zeros elsewhere, and one sum over the
    axis puts the rows together."""
    if axis_name is None:
        return table[ids]
    table = tp_block(table, axis_name, 0, vocab)
    v = table.shape[0]
    local = ids - axis_index(axis_name) * v
    mine = (local >= 0) & (local < v)
    # an id past the vocabulary keeps its index, out of the block's range
    index = torch.where(mine, local, torch.where(ids < vocab,
                                                 torch.zeros_like(ids), ids))
    rows = torch.where(mine[..., None], table[index],
                       torch.zeros((), dtype=table.dtype, device=ids.device))
    return tp_exit(rows, axis_name)
