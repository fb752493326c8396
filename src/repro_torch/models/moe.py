"""Mixture-of-Experts blocks on one device.

The counterpart of ``src/repro/models/moe.py``, less its expert-parallel
``moe_ep_a2a`` and ``moe_ep_a2a_decode``, which need a mesh (they come with
the port's ``launch/mesh``, ROADMAP.md).  As the reference does without a
mesh, full sequences take ``moe_dense`` (every expert computes every token,
combined with the top-k gate mask) and decode takes ``moe_gather`` (the k
selected experts' weights gathered per token), whatever ``moe_mode``.

Experts whose count does not divide the configured expert shards
(granite's 40 experts for 16 shards) are zero-padded to ``expert_pad``;
the router has no columns for them, so they are never selected.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig
from .layers import Params, dense_init, swiglu


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


def moe_dense(p, cfg: ModelConfig, x):
    """x: (B, S, d).  Computes all experts (full sequences on one device)."""
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


def moe_gather(p, cfg: ModelConfig, x):
    """Decode-path MoE: gather the k selected experts' weights per token.

    For small token counts (one decode step) this moves k*d*ff weight bytes
    per token instead of computing every expert.  x: (B, S, d), tiny B*S."""
    B, S, d = x.shape
    x2 = x.reshape(-1, d)
    w, idx = _route(x2, p["router"], cfg.top_k)
    wg, wu, wd = p["w_gate"][idx], p["w_up"][idx], p["w_down"][idx]
    g = F.silu(torch.einsum("nd,nkdf->nkf", x2, wg))
    u = torch.einsum("nd,nkdf->nkf", x2, wu)
    y = torch.einsum("nkf,nkfd->nd", (g * u) * w[..., None], wd)
    y = y + _shared(p, x2)
    return y.reshape(B, S, d)
