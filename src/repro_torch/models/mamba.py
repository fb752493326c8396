"""Mamba selective-state-space blocks (mamba1: falcon-mamba; mamba2: zamba2).

The counterpart of ``src/repro/models/mamba.py``.  The mamba1 sequence
recurrence runs on the selective-scan kernel's wrapper
(``kernels/mamba_scan/ops.py``), which returns y and the final state; the
reference computes the same recurrence with a chunked associative scan
(``mamba1_seq``, "same blocking as the Pallas mamba_scan kernel").  The
mamba2 SSD and naive forms and both decode steps are torch ops.

Under the train step's tensor-parallel arithmetic (``Dist.tensor_parallel``,
a ``model`` axis of m > 1 ranks dividing ``d_inner``) ``mamba1_seq`` runs
on this rank's d_inner / m channels, as the reference's GSPMD partitions
mamba d_inner: the input enters the region whole; ``in_proj``'s local
columns (a contiguous block of [x | z]) are realigned by one all-to-all
so the rank holds its x channels and the z channels that gate them; the
conv, ``dt_proj``, ``dt_bias``, ``A_log``, ``D`` and the scan kernel run
on those channels; ``x_proj``'s row-parallel product is summed over the
axis (dt_low, B and C whole on every rank, their gradients summed back),
and so is ``out_proj``'s.  ``mamba2_seq`` and ``mamba2_seq_naive`` run on
the rank's H/m heads (its d_inner / m channels) the same way: ``in_proj``
realigned, ``conv_w``/``conv_b``/``D``/``norm_scale`` the rank's channels,
``dt_w``/``dt_bias``/``A_log`` its heads, ``bc_proj`` whole (B and C are
shared by the heads; its gradient summed over the axis).  The gated norm
reduces over the whole d_inner, so each row's sum of squares is summed
over the axis (``layers.split_rms_norm``: one all-reduce of (B, L)
floats, not a gather of y), in torch ops, since the kernel takes no
outside row scale; ``out_proj``'s product ends in one sum.  A server's
decode steps (``mamba1_decode``, ``mamba2_decode``) run the same way on
the rank's block of the conv and SSM states.

The depthwise causal conv is its four taps as shifted multiply-adds in f32
(the form the reference's decode step takes): no cuDNN, so no TF32 on the
card.  Decode keeps (conv_state, ssm_state) and is a single fused update
per token.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.mamba_scan.ops import mamba_scan
from .common import ModelConfig, axis_size, realign_pairs, tp_axis, \
    tp_block, tp_enter, tp_exit
from .layers import Params, dense_init, rms_norm, split_rms_norm

# timesteps the scan kernel stages at a time (kernels/workloads.py
# BASELINES); a sequence is padded at the end to a multiple of it
SCAN_CHUNK = 64


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_mamba(cfg: ModelConfig, dtype, *, generator, device) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, -(-d // 16))
    f32 = torch.float32

    def w(shape):
        return dense_init(shape, generator=generator, device=device,
                          dtype=dtype)

    def full(shape, fill, dt=f32):
        return torch.full(shape, fill, dtype=dt, device=device)

    p = {"in_proj": w((d, 2 * di)), "conv_w": w((cfg.ssm_conv, di)),
         "conv_b": full((di,), 0.0, dtype), "out_proj": w((di, d)),
         "D": full((di,), 1.0)}
    dt_bias = float(np.log(np.expm1(0.01)))
    if cfg.ssm_version == 1:
        a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=device))
        p.update(x_proj=w((di, dt_rank + 2 * n)), dt_proj=w((dt_rank, di)),
                 dt_bias=full((di,), dt_bias),
                 A_log=a_log.expand(di, n).contiguous())
    else:  # mamba2 (SSD): scalar decay per head; B,C shared across head dim
        H = cfg.ssm_heads or di // 64
        p.update(bc_proj=w((d, 2 * n)), dt_w=w((d, H)),
                 dt_bias=full((H,), dt_bias), A_log=full((H,), 0.0),
                 norm_scale=full((di,), 1.0, dtype))
    return Params(**p)


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------

def _causal_conv(x, w, b):
    """Depthwise causal conv over time.  x: (B, L, C), w: (K, C)."""
    K, L = w.shape[0], x.shape[1]
    pad = F.pad(x.to(torch.float32), (0, 0, K - 1, 0))
    w32 = w.to(torch.float32)
    acc = pad[:, 0:L] * w32[0]
    for j in range(1, K):
        acc = acc + pad[:, j:j + L] * w32[j]
    return (acc + b.to(torch.float32)).to(x.dtype)


def _conv_step(window, w, b):
    """The conv at the newest position of a (B, K, C) window."""
    w32 = w.to(torch.float32)
    acc = window[:, 0].to(torch.float32) * w32[0]
    for j in range(1, w.shape[0]):
        acc = acc + window[:, j].to(torch.float32) * w32[j]
    return (acc + b.to(torch.float32)).to(window.dtype)


def _in_proj(p, cfg: ModelConfig, x, name: str | None = None):
    """(silu(conv(x channels)), z, the conv's tail) of ``in_proj``'s
    product; with ``name`` (a bound model axis) ``in_proj`` is the rank's
    contiguous columns of [x | z], realigned so the rank holds its block
    of each half."""
    xz = x @ p["in_proj"]
    if name is not None:
        xz = realign_pairs(xz, name)
    xi, z = xz.chunk(2, dim=-1)
    conv_tail = xi[:, -(cfg.ssm_conv - 1):, :]
    xi = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    return xi, z, conv_tail


def _tp_name(cfg: ModelConfig, dist, groups: int) -> str | None:
    """The model axis a mamba layer splits over: ``tp_axis`` when it
    divides ``groups`` (mamba1's channels, mamba2's heads), else None
    (the one-device function)."""
    name = tp_axis(dist)
    return None if name is None or groups % axis_size(name) else name


# --------------------------------------------------------------------------
# mamba1 (falcon-mamba)
# --------------------------------------------------------------------------

def scan_padded(dt, x, A, B, C, chunk: int = SCAN_CHUNK):
    """The selective scan of (Bt, L, ...) inputs on the kernel, with L
    padded at the end to a multiple of the chunk by dt = x = B = C = 0: a
    padded step's decay is exp(0) = 1 and its drive 0, so y and the final
    state of the real steps do not change, bit for bit.  Returns
    (y (Bt, L, D), h_last (Bt, D, N))."""
    L = x.shape[1]
    chunk = min(chunk, L)
    Lp = -(-L // chunk) * chunk

    def prep(t):
        if Lp != L:
            t = F.pad(t, (0, 0, 0, Lp - L))
        return t.contiguous()

    y, h = mamba_scan(prep(dt), prep(x), A.contiguous(), prep(B), prep(C),
                      chunk=chunk, return_state=True)
    return y[:, :L], h


def mamba1_seq(p, cfg: ModelConfig, x, chunk: int = SCAN_CHUNK, dist=None):
    """Full-sequence mamba1 from a zero state (every caller's, as in the
    reference).  x: (B, L, d) -> (y, (conv_tail, h_final)).  ``chunk`` is
    the scan kernel's tile of timesteps; it does not change the result.
    Under tensor-parallel arithmetic (module docstring) y is the same on
    every rank and the caches hold the rank's channels."""
    name = _tp_name(cfg, dist, cfg.d_inner)
    n = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    if name is None:
        xi, z, conv_tail = _in_proj(p, cfg, x)
        proj = xi @ p["x_proj"]
    else:
        p = _channel_block(p, cfg, name)
        xi, z, conv_tail = _in_proj(p, cfg, tp_enter(x, name), name)
        proj = tp_enter(tp_exit(xi @ p["x_proj"], name), name)
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"]
                    + p["dt_bias"]).to(torch.float32)             # (B, L, di)
    Bv = proj[..., dt_rank:dt_rank + n].to(torch.float32)         # (B, L, n)
    Cv = proj[..., dt_rank + n:].to(torch.float32)                # (B, L, n)
    A = -torch.exp(p["A_log"])                                    # (di, n)
    xi32 = xi.to(torch.float32)
    y, h_final = scan_padded(dt, xi32, A, Bv, Cv, chunk)
    y = y + p["D"] * xi32
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return (y if name is None else tp_exit(y, name)), (conv_tail, h_final)


def _channel_block(p, cfg: ModelConfig, name: str) -> dict:
    """mamba1's weights for this rank's channels: each the rank's block
    along its d_inner dimension (taken here when the weight is whole)."""
    di = cfg.d_inner
    dims = {"in_proj": (1, 2 * di), "conv_w": (1, di), "conv_b": (0, di),
            "x_proj": (0, di), "dt_proj": (1, di), "dt_bias": (0, di),
            "A_log": (0, di), "D": (0, di), "out_proj": (0, di)}
    return {k: tp_block(p[k], name, *dims[k]) for k in dims}


def mamba1_decode(p, cfg: ModelConfig, x, conv_state, h, dist=None):
    """One-token decode.  x: (B, 1, d); conv_state: (B, K-1, di);
    h: (B, di, n).  Under tensor-parallel arithmetic (module docstring)
    on the rank's channels: ``conv_state`` and ``h`` hold them,
    ``in_proj``'s [x | z] block is realigned as :func:`mamba1_seq`
    realigns it, ``x_proj``'s row-parallel product is summed over the
    axis, and so is ``out_proj``'s."""
    name = _tp_name(cfg, dist, cfg.d_inner)
    if name is not None:
        p = _channel_block(p, cfg, name)
        x = tp_enter(x, name)
    n = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    xz = x @ p["in_proj"]
    if name is not None:
        xz = realign_pairs(xz, name)
    xi, z = xz.chunk(2, dim=-1)                                  # (B, 1, di)
    window = torch.cat([conv_state, xi], dim=1)                  # (B, K, di)
    new_conv = window[:, 1:]
    xi = F.silu(_conv_step(window, p["conv_w"], p["conv_b"]))[:, None]
    proj = xi @ p["x_proj"]
    if name is not None:
        proj = tp_exit(proj, name)
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"]
                    + p["dt_bias"])[:, 0].to(torch.float32)       # (B, di)
    Bv = proj[:, 0, dt_rank:dt_rank + n].to(torch.float32)
    Cv = proj[:, 0, dt_rank + n:].to(torch.float32)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)
    x32 = xi[:, 0].to(torch.float32)
    h = a * h + (dt * x32)[..., None] * Bv[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cv) + p["D"] * x32
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None] @ p["out_proj"]
    return (y if name is None else tp_exit(y, name)), (new_conv, h)


# --------------------------------------------------------------------------
# mamba2 (zamba2) — scalar-decay-per-head SSD
# --------------------------------------------------------------------------

def _heads(cfg: ModelConfig) -> int:
    return cfg.ssm_heads or cfg.d_inner // 64


def _head_block(p, cfg: ModelConfig, name: str) -> dict:
    """mamba2's weights for this rank's H/m heads (its d_inner / m
    channels): each the rank's block along its head or channel dimension
    (taken here when the weight is whole); ``bc_proj``, used whole on
    every rank, with its gradient summed over the axis."""
    di, H = cfg.d_inner, _heads(cfg)
    dims = {"in_proj": (1, 2 * di), "conv_w": (1, di), "conv_b": (0, di),
            "dt_w": (1, H), "dt_bias": (0, H), "A_log": (0, H), "D": (0, di),
            "norm_scale": (0, di), "out_proj": (0, di)}
    out = {k: tp_block(p[k], name, *dims[k]) for k in dims}
    out["bc_proj"] = tp_enter(p["bc_proj"], name)
    return out


def _mamba2_inputs(p, cfg: ModelConfig, x, name: str | None = None):
    """The SSD's inputs on the heads of ``p`` (all, or with ``name`` the
    rank's block: ``p`` from :func:`_head_block`, ``x`` entered)."""
    n = cfg.ssm_state
    H, di = p["dt_w"].shape[1], p["D"].shape[0]
    B, L, _ = x.shape
    xi, z, conv_tail = _in_proj(p, cfg, x, name)
    bc = (x @ p["bc_proj"]).to(torch.float32)
    dt = F.softplus(x @ p["dt_w"] + p["dt_bias"]).to(torch.float32)  # (B,L,H)
    A = -torch.exp(p["A_log"])                                       # (H,)
    xh = xi.reshape(B, L, H, di // H).to(torch.float32)
    return xi, z, conv_tail, bc[..., :n], bc[..., n:], dt, A, xh


def _mamba2_out(p, cfg: ModelConfig, x, y, xi, z, name: str | None = None):
    """The gated norm and ``out_proj``; with ``name`` on the rank's
    channels: the norm's sum of squares over the whole d_inner is one sum
    over the axis (:func:`split_rms_norm`), and ``out_proj``'s
    row-parallel product one more."""
    y = y.reshape(x.shape[0], x.shape[1], -1)
    y = y + p["D"] * xi.to(torch.float32)
    if name is None:
        y = rms_norm(y.to(x.dtype), p["norm_scale"], cfg.norm_eps)
        return (y * F.silu(z)) @ p["out_proj"]
    y = split_rms_norm(y.to(x.dtype), p["norm_scale"], cfg.norm_eps,
                       cfg.d_inner, name)
    return tp_exit((y * F.silu(z)) @ p["out_proj"], name)


def _mamba2_split(p, cfg: ModelConfig, x, dist):
    """(p, x, name): with tensor-parallel arithmetic over heads that
    divide, the rank's blocks, the entered input and the axis; else the
    whole layer."""
    name = _tp_name(cfg, dist, _heads(cfg))
    if name is None:
        return p, x, None
    return _head_block(p, cfg, name), tp_enter(x, name), name


def mamba2_seq_naive(p, cfg: ModelConfig, x, h0=None, dist=None):
    """Reference mamba2: the elementwise recurrence, one timestep after
    another over the (B, H, dh, n) state (the numerical oracle of
    :func:`mamba2_seq`).  Under tensor-parallel arithmetic (module
    docstring) on the rank's heads."""
    B, L, _ = x.shape
    p, x, name = _mamba2_split(p, cfg, x, dist)
    xi, z, conv_tail, Bv, Cv, dt, A, xh = _mamba2_inputs(p, cfg, x, name)
    a = torch.exp(dt * A)                                          # (B,L,H)
    h = (torch.zeros((B,) + xh.shape[2:] + (cfg.ssm_state,),
                     dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(L):
        bterm = (dt[:, t, :, None, None] * xh[:, t, ..., None]
                 * Bv[:, t, None, None, :])
        h = a[:, t, :, None, None] * h + bterm
        ys.append(torch.einsum("bhdn,bn->bhd", h, Cv[:, t]))
    y = torch.stack(ys, dim=1)
    return _mamba2_out(p, cfg, x, y, xi, z, name), (conv_tail, h)


def mamba2_seq(p, cfg: ModelConfig, x, h0=None, chunk: int = 128,
               dist=None):
    """Mamba2 in the SSD matmul form (Dao & Gu 2024).

    Per chunk of length Q the scalar-decay recurrence collapses to
      y_intra[t] = sum_{s<=t} exp(cum_t - cum_s) * (C_t . B_s) * dt_s * x_s
    — an attention-like (B, H, Q, Q) matmul — plus a carried-state term and
    a decay-weighted state update.  Equal to :func:`mamba2_seq_naive`.
    Under tensor-parallel arithmetic (module docstring) on the rank's
    heads."""
    B, L, _ = x.shape
    Q = min(chunk, L)
    while L % Q:
        Q -= 1
    p, x, name = _mamba2_split(p, cfg, x, dist)
    xi, z, conv_tail, Bv, Cv, dt, A, xh = _mamba2_inputs(p, cfg, x, name)
    loga = dt * A                                                  # <= 0
    h = (torch.zeros((B,) + xh.shape[2:] + (cfg.ssm_state,),
                     dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    ys = []
    for c0 in range(0, L, Q):
        loga_c, dt_c = loga[:, c0:c0 + Q], dt[:, c0:c0 + Q]
        x_c, B_c, C_c = xh[:, c0:c0 + Q], Bv[:, c0:c0 + Q], Cv[:, c0:c0 + Q]
        cum = torch.cumsum(loga_c, dim=1)                          # (B, Q, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]             # (B,Q,Q,H)
        decay = torch.where(causal, torch.exp(diff),
                            torch.zeros((), device=x.device))
        cb = torch.einsum("bqn,bsn->bqs", C_c, B_c)
        M = decay * (cb[..., None] * dt_c[:, None, :, :])
        y = torch.einsum("bqsh,bshd->bqhd", M, x_c)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bqn,bhdn->bqhd", C_c, h)
        tail = torch.exp(cum[:, -1:, :] - cum)                     # (B,Q,H)
        h = torch.exp(cum[:, -1])[..., None, None] * h + torch.einsum(
            "bqh,bqn,bqhd->bhdn", dt_c * tail, B_c, x_c)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return _mamba2_out(p, cfg, x, y, xi, z, name), (conv_tail, h)


def mamba2_decode(p, cfg: ModelConfig, x, conv_state, h, dist=None):
    """One-token decode.  x: (B, 1, d); conv_state: (B, K-1, di); h: (B, H,
    dh, n).  Under tensor-parallel arithmetic (module docstring) on the
    rank's H/m heads: ``conv_state`` holds their channels and ``h`` the
    heads, the gated norm's sum of squares is summed over the axis and so
    is ``out_proj``'s product."""
    B = x.shape[0]
    n = cfg.ssm_state
    p, x, name = _mamba2_split(p, cfg, x, dist)
    H, di = p["dt_w"].shape[1], p["D"].shape[0]
    xz = x @ p["in_proj"]
    if name is not None:
        xz = realign_pairs(xz, name)
    xi, z = xz.chunk(2, dim=-1)
    window = torch.cat([conv_state, xi], dim=1)
    new_conv = window[:, 1:]
    xi = F.silu(_conv_step(window, p["conv_w"], p["conv_b"]))      # (B, di)
    bc = (x[:, 0] @ p["bc_proj"]).to(torch.float32)
    Bv, Cv = bc[..., :n], bc[..., n:]
    dt = F.softplus(x[:, 0] @ p["dt_w"]
                    + p["dt_bias"]).to(torch.float32)              # (B, H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))                     # (B, H)
    xh = xi.reshape(B, H, di // H).to(torch.float32)
    h = (a[..., None, None] * h
         + dt[..., None, None] * xh[..., None] * Bv[:, None, None, :])
    y = torch.einsum("bhdn,bn->bhd", h, Cv).reshape(B, di)
    y = y + p["D"] * xi.to(torch.float32)
    if name is None:
        y = rms_norm(y.to(x.dtype), p["norm_scale"], cfg.norm_eps)
    else:
        y = split_rms_norm(y.to(x.dtype), p["norm_scale"], cfg.norm_eps,
                           cfg.d_inner, name)
    y = ((y * F.silu(z[:, 0]))[:, None]) @ p["out_proj"]
    return (y if name is None else tp_exit(y, name)), (new_conv, h)
