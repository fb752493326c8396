"""Mixture-of-Experts blocks (the counterpart of ``src/repro/models/moe.py``).

Three execution modes, as the reference's:

* ``moe_dense`` — every expert computes every token, combined with the
  top-k gate mask: full sequences without a mesh, and the oracle of the
  expert-parallel path;
* ``moe_gather`` — decode without a mesh: the k selected experts' weights
  gathered per token;
* ``moe_ep_a2a`` / ``moe_ep_a2a_decode`` — expert parallelism inside
  ``shard_map`` over the ``model`` axis (models/common.py): tokens go to
  their experts' ranks in capacity-C buffers through a pair of
  ``all_to_all`` exchanges and come back weighted by their gates.

Under the train step's tensor-parallel arithmetic (``Dist.tensor_parallel``,
a ``model`` axis of m > 1 ranks) ``moe_dense`` computes the rank's block of
E_pad / m experts over all of its batch block's tokens, as the reference's
GSPMD partitions the expert dimension, and the weighted combine is summed
over the axis; ``moe_gather`` (a server's decode) gathers only the picks
in the rank's block; the expert-parallel path receives the rank's expert
block as it is (models/transformer.py ``_moe_apply``).

Experts whose count does not divide the configured expert shards
(granite's 40 experts for 16 shards) are zero-padded to ``expert_pad``;
the router has no columns for them, so they are never selected.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import ModelConfig, all_to_all, axis_index, axis_size, psum, \
    tp_block, tp_enter, tp_exit
from .layers import Params, dense_init, swiglu

NEG_INF = -1e30


def expert_pad(cfg: ModelConfig, n_shards: int = 1) -> int:
    e = cfg.n_experts
    return int(-(-e // n_shards) * n_shards)


def init_moe(cfg: ModelConfig, dtype, *, generator, device,
             n_expert_shards: int = 1) -> Params:
    d, ff = cfg.d_model, cfg.moe_d_ff
    ep = expert_pad(cfg, n_expert_shards)

    def w(shape, in_axis=-2, dt=dtype):
        return dense_init(shape, generator=generator, device=device,
                          in_axis=in_axis, dtype=dt)

    p = {"router": w((d, cfg.n_experts), dt=torch.float32),
         "w_gate": w((ep, d, ff), in_axis=1),
         "w_up": w((ep, d, ff), in_axis=1),
         "w_down": w((ep, ff, d), in_axis=1)}
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        p.update(sh_gate=w((d, sff)), sh_up=w((d, sff)), sh_down=w((sff, d)))
    return Params(**p)


def _route(x2, router, top_k):
    """x2: (n, d) -> (weights (n,k), indices (n,k)) with normalized gates."""
    gates = torch.softmax(x2.to(torch.float32) @ router, dim=-1)
    w, idx = torch.topk(gates, top_k, dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return w.to(x2.dtype), idx


def _shared(p, x):
    if "sh_gate" not in p:
        return 0.0
    return swiglu(x, p["sh_gate"], p["sh_up"], p["sh_down"])


def moe_dense(p, cfg: ModelConfig, x, axis_name: str | None = None):
    """x: (B, S, d).  Computes all experts (full sequences on one device).
    With ``axis_name`` (a bound model axis dividing the padded experts)
    each rank computes its block of experts over every token and the
    weighted combine is summed over the axis (module docstring)."""
    if axis_name is not None and \
            expert_pad(cfg, cfg.expert_shards) % axis_size(axis_name) == 0:
        return _moe_dense_split(p, cfg, x, axis_name)
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    w, idx = _route(x2, p["router"], cfg.top_k)
    onehot = F.one_hot(idx, p["w_gate"].shape[0]).to(x.dtype)   # (n,k,E)
    combine = torch.einsum("nk,nke->ne", w, onehot)               # (n, E_pad)
    g = F.silu(torch.einsum("nd,edf->enf", x2, p["w_gate"]))
    u = torch.einsum("nd,edf->enf", x2, p["w_up"])
    ye = torch.einsum("enf,efd->end", g * u, p["w_down"])
    y = torch.einsum("end,ne->nd", ye, combine)
    y = y + _shared(p, x2)
    return y.reshape(B, S, d)


def _moe_dense_split(p, cfg: ModelConfig, x, name: str):
    """:func:`moe_dense` on this rank's E_pad / m experts: the input
    enters the region whole, the router is used whole (its gradient
    summed over the axis), ``w_gate``/``w_up``/``w_down`` are the rank's
    expert block and the combine the matching columns, so a padded expert
    (no router column) gets no weight; the shared experts split over
    their hidden units as SwiGLU does.  One sum over the axis ends both."""
    B, S, d = x.shape
    e_pad = expert_pad(cfg, cfg.expert_shards)
    m, r = axis_size(name), axis_index(name)
    el = e_pad // m
    x2 = tp_enter(x.reshape(-1, d), name)
    w, idx = _route(x2, tp_enter(p["router"], name), cfg.top_k)
    onehot = F.one_hot(idx, e_pad).to(x.dtype)                   # (n,k,E)
    combine = torch.einsum("nk,nke->ne", w, onehot)[:, r * el:(r + 1) * el]
    wg, wu, wd = (tp_block(p[k], name, 0, e_pad)
                  for k in ("w_gate", "w_up", "w_down"))
    g = F.silu(torch.einsum("nd,edf->enf", x2, wg))
    u = torch.einsum("nd,edf->enf", x2, wu)
    ye = torch.einsum("enf,efd->end", g * u, wd)
    y = torch.einsum("end,ne->nd", ye, combine)
    y, whole_shared = _shared_split(p, cfg, x, x2, y, name)
    y = tp_exit(y, name) + whole_shared
    return y.reshape(B, S, d)


def _shared_split(p, cfg: ModelConfig, x, x2, y, name: str):
    """(``y`` plus this rank's part of the shared experts, split over
    their hidden units as SwiGLU is; the shared experts computed whole on
    every rank, outside the region, where their units do not divide the
    axis, else 0): ``x`` (B, S, d) the layer's input, ``x2`` its rows
    entered into the region."""
    if "sh_gate" not in p:
        return y, 0.0
    sff = cfg.moe_d_ff * cfg.n_shared_experts
    if sff % axis_size(name):
        return y, _shared(p, x.reshape(-1, x.shape[-1]))
    sg, su = (tp_block(p[k], name, 1, sff) for k in ("sh_gate", "sh_up"))
    return y + (F.silu(x2 @ sg) * (x2 @ su)) @ tp_block(
        p["sh_down"], name, 0, sff), 0.0


def moe_gather(p, cfg: ModelConfig, x, axis_name: str | None = None):
    """Decode-path MoE: gather the k selected experts' weights per token.

    For small token counts (one decode step) this moves k*d*ff weight bytes
    per token instead of computing every expert.  x: (B, S, d), tiny B*S.
    With ``axis_name`` (a bound model axis dividing the padded experts)
    each rank gathers only the picks that lie in its block of experts (a
    pick outside it contributes zero), the shared experts split over their
    hidden units, and the combine is summed over the axis."""
    if axis_name is not None and \
            expert_pad(cfg, cfg.expert_shards) % axis_size(axis_name) == 0:
        return _moe_gather_split(p, cfg, x, axis_name)
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    w, idx = _route(x2, p["router"], cfg.top_k)
    wg, wu, wd = p["w_gate"][idx], p["w_up"][idx], p["w_down"][idx]
    g = F.silu(torch.einsum("nd,nkdf->nkf", x2, wg))
    u = torch.einsum("nd,nkdf->nkf", x2, wu)
    y = torch.einsum("nkf,nkfd->nd", (g * u) * w[..., None], wd)
    y = y + _shared(p, x2)
    return y.reshape(B, S, d)


def _moe_gather_split(p, cfg: ModelConfig, x, name: str):
    """:func:`moe_gather` on this rank's E_pad / m experts (the router
    whole, the picks outside the block weighted zero)."""
    B, S, d = x.shape
    e_pad = expert_pad(cfg, cfg.expert_shards)
    el = e_pad // axis_size(name)
    x2 = tp_enter(x.reshape(-1, d), name)
    w, idx = _route(x2, tp_enter(p["router"], name), cfg.top_k)
    local = idx - axis_index(name) * el
    mine = (local >= 0) & (local < el)
    local = local.clamp(0, el - 1)
    wg, wu, wd = (tp_block(p[k], name, 0, e_pad)[local]
                  for k in ("w_gate", "w_up", "w_down"))
    w = torch.where(mine, w, torch.zeros((), dtype=w.dtype, device=w.device))
    g = F.silu(torch.einsum("nd,nkdf->nkf", x2, wg))
    u = torch.einsum("nd,nkdf->nkf", x2, wu)
    y = torch.einsum("nkf,nkfd->nd", (g * u) * w[..., None], wd)
    y, whole_shared = _shared_split(p, cfg, x, x2, y, name)
    return (tp_exit(y, name) + whole_shared).reshape(B, S, d)


def moe_ep_a2a_decode(p, cfg: ModelConfig, x, *, expert_axis: str = "model",
                      capacity_factor: float = 2.0):
    """Decode-path expert parallelism, INSIDE ``shard_map`` where ``x``
    (n_loc, d) is the same on every rank of the expert axis.

    Each rank takes the token stripe ``j % m == rank``, dispatches it
    through the capacity-C ``all_to_all``, and a final ``psum`` over the
    expert axis puts the batch together."""
    n, d = x.shape
    m = axis_size(expert_axis)
    mine = torch.arange(n, device=x.device) % m == axis_index(expert_axis)
    y = moe_ep_a2a(p, cfg, x, expert_axis=expert_axis,
                   capacity_factor=capacity_factor, valid=mine)
    y = torch.where(mine[:, None], y, torch.zeros((), dtype=y.dtype,
                                                  device=y.device))
    return psum(y, expert_axis)


def _dispatch_local(x2, w, idx, e_pad: int, capacity: int, valid=None):
    """The (E_pad, C, d) dispatch buffer and the combine's metadata.  A
    (token, k) pair takes the next free slot of its expert in token-major
    order; pairs past the capacity (and invalid tokens) are dropped."""
    n, d = x2.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)                                    # (n*k,)
    flat_w = w.reshape(-1)
    tok = torch.arange(n, device=x2.device).repeat_interleave(k)
    onehot = F.one_hot(flat_e, e_pad).to(torch.int32)          # (n*k, E)
    if valid is not None:  # invalid tokens neither claim nor consume slots
        onehot = onehot * valid[tok].to(torch.int32)[:, None]
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos_in_e = pos.gather(1, flat_e[:, None])[:, 0]
    keep = pos_in_e < capacity
    if valid is not None:
        keep = keep & valid[tok]
    pos_in_e = torch.where(keep, pos_in_e, 0).long()
    src = torch.where(keep[:, None], x2[tok], 0.0).to(x2.dtype)
    buf = torch.zeros((e_pad, capacity, d), dtype=x2.dtype, device=x2.device)
    buf = buf.index_put((flat_e, pos_in_e), src, accumulate=True)
    return buf, (flat_e, pos_in_e, keep, flat_w, tok)


def _combine_local(buf, meta, n: int, d: int):
    """Each token's k expert outputs weighted by their gates and summed
    (a token's pairs are adjacent rows of the flattened (n, k))."""
    flat_e, pos_in_e, keep, flat_w, tok = meta
    gathered = buf[flat_e, pos_in_e]                            # (n*k, d)
    gathered = torch.where(keep[:, None], gathered, 0.0).to(buf.dtype) \
        * flat_w[:, None]
    return gathered.reshape(n, -1, d).sum(dim=1)


def moe_ep_a2a(p, cfg: ModelConfig, x, *, expert_axis: str = "model",
               capacity_factor: float = 1.25, valid=None):
    """Expert-parallel MoE INSIDE ``shard_map`` over ``expert_axis``.

    ``x``: (n_local, d) tokens of this rank.  Expert weights arrive as this
    rank's (E_pad/M, d, ff) blocks; the router and shared experts whole.
    The capacity is the reference's ``ceil(n k / E_pad * cf / 8) * 8``."""
    n, d = x.shape
    m = axis_size(expert_axis)
    e_pad = p["w_gate"].shape[0] * m
    k = cfg.top_k
    cap = int(math.ceil(n * k / e_pad * capacity_factor / 8.0) * 8)

    w, idx = _route(x, p["router"], k)
    buf, meta = _dispatch_local(x, w, idx, e_pad, cap, valid)   # (E_pad, C, d)
    # block j of the experts goes to rank j; the blocks received stack
    # along the token axis, so the reverse exchange is the exact inverse
    recv = all_to_all(buf, expert_axis, 0, 1, tiled=True)       # (E_loc, mC, d)
    g = F.silu(torch.einsum("ecd,edf->ecf", recv, p["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", recv, p["w_up"])
    ye = torch.einsum("ecf,efd->ecd", g * u, p["w_down"])       # (E_loc, mC, d)
    back = all_to_all(ye, expert_axis, 1, 0, tiled=True)        # (E_pad, C, d)
    return _combine_local(back, meta, n, d) + _shared(p, x)
