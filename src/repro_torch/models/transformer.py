"""Top-level model: init / train_loss / prefill / decode_step for all
assigned architecture families, on one device.

The counterpart of ``src/repro/models/transformer.py``, with its names,
semantics and return structures: caches are keyed as the reference keys
them and stacked on a leading layer axis (``k``/``v``, ``ckv``/``krope``,
``conv``/``ssm``, ``shared_k``/``shared_v``).  Families:

  dense / vlm / encoder : attention + SwiGLU MLP
  moe / mla_moe         : attention (GQA or MLA) + MoE FFN
  ssm                   : mamba1 blocks (attention-free)
  hybrid                : mamba2 backbone + ONE weight-shared attention+MLP
                          block applied every ``attn_every`` layers (zamba2),
                          then the trailing mamba-only layers

The parameters are a :class:`Model`, an ``nn.Module`` of one block module a
layer (the reference stacks layers on a leading axis for ``lax.scan``;
here a Python loop drives them, and only ``models/weights.py`` knows the
stacked layout).  ``remat="full"`` checkpoints each layer's body on the
full-sequence paths (never when decoding), where the reference wraps its
scan body in ``jax.checkpoint``: an attention or mamba layer, and the
hybrid's group of ``attn_every`` mamba layers with the shared block (its
trailing mamba-only layers are not checkpointed).  The backward runs each
checkpointed body's forward again, so a training step launches each
forward kernel inside such a body twice: rmsnorm twice a layer's norms
plus once for the final norm, flash attention and the scan twice a
layer; the backward kernels' counts do not change.

Distribution is carried by :class:`Dist` (mesh + axis names), threaded as
the reference threads it.  One process drives each device: under an
active ``Dist`` the model runs on this rank's batch block (the batch axes
are manual, models/common.py).  With ``Dist.tensor_parallel`` (the train
step's and a meshed server's, for every family) the ``model`` axis is
manual too and each layer splits its arithmetic over it where its
dimension divides (Megatron's layout, models/common.py
``tp_enter``/``tp_exit``): GQA and MLA heads, the FFN's and the shared
experts' hidden units, the MoE's experts, mamba1's channels, mamba2's
heads (zamba2's shared block as a dense layer) and the vocabulary of the
embedding, the head and the loss, each on the rank's block of the
weights; activations between the layers are the same on every rank.  A
layer whose dimension does not divide runs whole, the same on every
rank.  A server's decode caches (``Dist.cache_len``) are the rank's
blocks under ``cache_specs`` (models/attention.py ``kv_layout``: its KV
heads, or its block of the positions where they do not divide, or the
whole), and so are its mamba states; each decode form runs on them
(``gqa_decode``, ``mla_decode``, the mamba decode steps, ``moe_gather``),
and the last position's logits are gathered over ``model``, the same on
every rank.  The MoE FFN with ``moe_mode="ep_a2a"`` takes the reference's
expert-parallel branches over ``model`` under any active ``Dist``.

``train_loss`` records autograd's graph (the kernel wrappers'
gradients are the backward kernels); ``prefill`` and ``decode_step`` run
under ``no_grad``, so serving records none.  ``decode_step`` takes one
cache index for the batch (an int) or one a lane (a (B,) tensor) and
writes the caches it is given in place, returning them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

import contextlib
from dataclasses import dataclass
from typing import Any

from ..device import resolve_device
from .attention import gqa_decode, gqa_forward, init_attn, mla_decode, \
    mla_forward
from .common import P, ModelConfig, axis_size, manual_axes, shard_map, \
    tp_axis, tp_block, tp_enter, tp_gather
from .layers import Params, dense_init, embed_lookup, rms_norm, \
    softmax_cross_entropy, swiglu
from .mamba import init_mamba, mamba1_decode, mamba1_seq, mamba2_decode, \
    mamba2_seq, mamba2_seq_naive
from .moe import (expert_pad, init_moe, moe_dense, moe_ep_a2a,
                  moe_ep_a2a_decode, moe_gather)


@dataclass(frozen=True)
class Dist:
    """Distribution context threaded through the model: a
    ``DeviceMesh`` with ``mesh_dim_names`` and the names of its batch and
    model axes.  ``capacity_factor`` is the expert-parallel MoE's (None:
    the reference's defaults, 1.25 for full sequences and 2.0 for
    decode).  ``tensor_parallel``: the layers split their arithmetic over
    the model axis (module docstring); the train step and a meshed
    server set it.  ``cache_len``: a server's decode-cache length (0 in
    the train step), whose layout over the model axis follows
    ``cache_specs`` (models/attention.py ``kv_layout``)."""
    mesh: Any = None
    batch_axes: tuple = ("data",)
    model_axis: str = "model"
    capacity_factor: float | None = None
    tensor_parallel: bool = False
    cache_len: int = 0

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def manual(self) -> tuple:
        """The mesh axes the model runs manual over: the batch axes, and
        the model axis under tensor-parallel arithmetic."""
        return tuple(self.batch_axes) + (
            (self.model_axis,) if self.tensor_parallel else ())


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


class AttnBlock(Params):
    """Pre-norm attention (GQA or MLA) + SwiGLU MLP or MoE: one layer of the
    attention families, and zamba2's weight-shared block."""

    def forward(self, cfg: ModelConfig, x, positions, dist=None):
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        fwd = mla_forward if cfg.mla else gqa_forward
        a, cache = fwd(self.attn, cfg, h, positions, dist)
        return self._ffn(cfg, x + a, False, dist), cache

    def decode(self, cfg: ModelConfig, x, positions, cache, index,
               dist=None):
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        dec = mla_decode if cfg.mla else gqa_decode
        a, cache = dec(self.attn, cfg, h, cache[0], cache[1], index,
                       positions, dist)
        return self._ffn(cfg, x + a, True, dist), cache

    def _ffn(self, cfg: ModelConfig, x, decoding: bool, dist):
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        if "moe" in self:
            return x + _moe_apply(self.moe, cfg, h, dist, decoding)
        m = self.mlp
        name = tp_axis(dist)
        if name is not None and cfg.d_ff % axis_size(name):
            name = None
        return x + swiglu(h, m.gate, m.up, m.down, name, cfg.d_ff)


def _moe_apply(p, cfg: ModelConfig, x, dist, decoding: bool):
    """The MoE FFN: the reference's expert-parallel ``shard_map`` over the
    model axis when ``moe_mode="ep_a2a"`` under an active ``dist``, else
    ``moe_gather`` (decode) or ``moe_dense`` (under tensor-parallel
    arithmetic on the rank's experts).  Under tensor-parallel arithmetic
    the expert-parallel branch takes the rank's expert block of ``w_*``
    as it is, the router and the shared experts whole (the reference's
    spec ``P()``, their gradients summed over the axis), and the rank's
    sequence block of the activations, which every rank holds whole."""
    name = tp_axis(dist)
    if not (cfg.moe_mode == "ep_a2a" and dist is not None and dist.active):
        return (moe_gather if decoding else moe_dense)(p, cfg, x, name)
    mdl, dp = dist.model_axis, dist.batch_axes
    names = ["router", "w_gate", "w_up", "w_down"]
    if "sh_gate" in p:
        names += ["sh_gate", "sh_up", "sh_down"]
    cf = {} if dist.capacity_factor is None \
        else {"capacity_factor": dist.capacity_factor}
    moe, spec = (moe_ep_a2a_decode, P(dp, None, None)) if decoding \
        else (moe_ep_a2a, P(dp, mdl, None))

    def local(xb, pp):  # xb: this rank's (B_loc, S_loc, d) block
        bl, sl, d = xb.shape
        y = moe(pp, cfg, xb.reshape(bl * sl, d), expert_axis=mdl, **cf)
        return y.reshape(bl, sl, d)

    if name is not None and not decoding:
        e_pad = expert_pad(cfg, cfg.expert_shards)
        pp = {n: tp_block(p[n], name, 0, e_pad) if n.startswith("w_")
              else tp_enter(p[n], name) for n in names}
        y = local(tp_block(x, name, 1, x.shape[1]), pp)
        return tp_gather(y, name, 1)
    pspec = {n: P(mdl) if n.startswith("w_") else P() for n in names}
    fn = shard_map(local, mesh=dist.mesh, in_specs=(spec, pspec),
                   out_specs=spec, check_vma=False)
    return fn(x, {n: p[n] for n in names})


class MambaBlock(Params):
    """Pre-norm mamba1 or mamba2 mixer with a residual."""

    def forward(self, cfg: ModelConfig, x, dist=None):
        h = rms_norm(x, self.ln, cfg.norm_eps)
        if cfg.ssm_version == 1:
            y, cache = mamba1_seq(self.mamba, cfg, h, dist=dist)
        else:
            seq = mamba2_seq if cfg.ssm_impl == "ssd" else mamba2_seq_naive
            y, cache = seq(self.mamba, cfg, h, dist=dist)
        return x + y, cache

    def decode(self, cfg: ModelConfig, x, cache, dist=None):
        dec = mamba1_decode if cfg.ssm_version == 1 else mamba2_decode
        y, cache = dec(self.mamba, cfg, rms_norm(x, self.ln, cfg.norm_eps),
                       cache[0], cache[1], dist)
        return x + y, cache


class Model(Params):
    """The parameters of one model: ``embed``, ``ln_f``, ``out``, the
    ``layers`` (an ``nn.ModuleList`` of blocks) and, for the hybrid, the
    ``shared`` attention block."""

    @property
    def device(self) -> torch.device:
        return self.embed.device


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_mlp(cfg, dtype, **rng):
    d, ff = cfg.d_model, cfg.d_ff
    return Params(gate=dense_init((d, ff), dtype=dtype, **rng),
                  up=dense_init((d, ff), dtype=dtype, **rng),
                  down=dense_init((ff, d), dtype=dtype, **rng))


def _init_layer(cfg: ModelConfig, dtype, **rng):
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=rng["device"])
    if cfg.family in ("ssm", "hybrid"):
        return MambaBlock(ln=ones, mamba=init_mamba(cfg, dtype, **rng))
    p = {"ln1": ones, "ln2": ones.clone(),
         "attn": init_attn(cfg, dtype, **rng)}
    if cfg.n_experts:
        p["moe"] = init_moe(cfg, dtype, n_expert_shards=cfg.expert_shards,
                            **rng)
    else:
        p["mlp"] = _init_mlp(cfg, dtype, **rng)
    return AttnBlock(**p)


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device=None, dtype=None) -> Model:
    """Random weights for ``cfg``, drawn on ``device`` (the GPU unless the
    caller names another) from ``generator`` (default: seed 0 on that
    device).  The reference draws from ``jax.random``, whose bits torch
    cannot reproduce: parity with it goes through
    :func:`~repro_torch.models.weights.params_from_reference`.  A ``meta``
    device gives the empty skeleton of the parameters."""
    device = (torch.device("meta") if str(device) == "meta"
              else resolve_device(device))
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = dtype or _dtype(cfg)
    rng = {"generator": generator, "device": device}
    members = {
        "embed": dense_init((cfg.vocab, cfg.d_model), in_axis=-1,
                            dtype=dtype, **rng),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "out": dense_init((cfg.d_model, cfg.vocab), dtype=dtype, **rng),
        "layers": nn.ModuleList(_init_layer(cfg, dtype, **rng)
                                for _ in range(cfg.n_layers)),
    }
    if cfg.family == "hybrid":  # one weight-shared attention + MLP block
        ones = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        members["shared"] = AttnBlock(
            ln1=ones, ln2=ones.clone(), attn=init_attn(cfg, dtype, **rng),
            mlp=_init_mlp(cfg, dtype, **rng))
    return Model(**members)


# --------------------------------------------------------------------------
# cache construction
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Per-layer decode caches, stacked with a leading layer dim."""
    dtype = dtype or _dtype(cfg)
    device = resolve_device(device)
    L = cfg.n_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.family in ("ssm", "hybrid"):
        di, n = cfg.d_inner, cfg.ssm_state
        if cfg.ssm_version == 1:
            h = zeros(L, batch, di, n, dt=torch.float32)
        else:
            H = cfg.ssm_heads or di // 64
            h = zeros(L, batch, H, di // H, n, dt=torch.float32)
        cache = {"conv": zeros(L, batch, cfg.ssm_conv - 1, di), "ssm": h}
        if cfg.family == "hybrid":
            G = cfg.n_layers // cfg.attn_every
            cache["shared_k"] = zeros(G, batch, max_len, cfg.n_kv_heads,
                                      cfg.hd)
            cache["shared_v"] = zeros(G, batch, max_len, cfg.n_kv_heads,
                                      cfg.hd)
        return cache
    if cfg.mla:
        return {"ckv": zeros(L, batch, max_len, cfg.kv_lora_rank),
                "krope": zeros(L, batch, max_len, cfg.qk_rope_dim)}
    return {"k": zeros(L, batch, max_len, cfg.n_kv_heads, cfg.hd),
            "v": zeros(L, batch, max_len, cfg.n_kv_heads, cfg.hd)}


# --------------------------------------------------------------------------
# full stack
# --------------------------------------------------------------------------


def _as_tensor(v, device, dtype=None):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype or v.dtype)
    return torch.as_tensor(np.array(v), device=device, dtype=dtype)


def _vocab_axis(cfg: ModelConfig, dist) -> str | None:
    """The model axis when the vocabulary is split over it."""
    name = tp_axis(dist)
    return None if name is None or cfg.vocab % axis_size(name) else name


def _embed(params: Model, cfg: ModelConfig, batch: dict, dist=None):
    dev = params.device
    if cfg.embedding_inputs:
        x = _as_tensor(batch["embeds"], dev, _dtype(cfg))
    else:
        x = embed_lookup(params.embed,
                         _as_tensor(batch["tokens"], dev, torch.long),
                         cfg.vocab, _vocab_axis(cfg, dist))
    B, S = x.shape[:2]
    if cfg.mrope:
        positions = _as_tensor(batch["positions3"], dev)        # (B, S, 3)
    elif "positions" in batch:
        positions = _as_tensor(batch["positions"], dev)
    else:
        positions = torch.arange(S, device=dev)[None].expand(B, S)
    return x, positions


def _remat(cfg: ModelConfig, dist, fn, decoding: bool):
    """``fn`` as a layer body: under ``remat="full"`` on a full-sequence
    path, ``torch.utils.checkpoint`` of it (non-reentrant: the recorded
    kernels' saved outputs, flash's log-sum-exp and the scan's tile-start
    states, are the recomputed ones).  The recomputation runs in the
    backward, outside ``_forward``'s binding of the manual axes, so the
    body binds them again; its collectives (tensor-parallel arithmetic)
    run again there, in the same order on every rank."""
    if cfg.remat != "full" or decoding:
        return fn

    def body(*args):
        with (manual_axes(dist.mesh, dist.manual)
              if dist is not None and dist.active
              else contextlib.nullcontext()):
            return fn(*args)

    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def _stack(per_layer: list) -> tuple:
    """[(a, b) a layer] -> (stacked a, stacked b) on a new leading axis."""
    return tuple(torch.stack(parts) for parts in zip(*per_layer))


def _stack_attn(params, cfg, x, positions, dist, decoding, caches, index):
    names = ("ckv", "krope") if cfg.mla else ("k", "v")
    if decoding:
        for i, layer in enumerate(params.layers):
            x, _ = layer.decode(cfg, x, positions,
                                (caches[names[0]][i], caches[names[1]][i]),
                                index, dist)
        return x, caches
    per_layer = []
    body = _remat(cfg, dist, lambda layer, h: layer(cfg, h, positions, dist),
                  False)
    for layer in params.layers:
        x, cache = body(layer, x)
        per_layer.append(cache)
    return x, dict(zip(names, _stack(per_layer)))


def _mamba_layers(layers, cfg, x, decoding, conv, ssm, out, dist=None):
    """Run mamba ``layers``; decoding writes their new states into the
    stacked ``conv``/``ssm`` slices in place, else appends them to
    ``out``."""
    for i, layer in enumerate(layers):
        if decoding:
            x, (nconv, nh) = layer.decode(cfg, x, (conv[i], ssm[i]), dist)
            conv[i].copy_(nconv)
            ssm[i].copy_(nh)
        else:
            x, cache = layer(cfg, x, dist)
            out.append(cache)
    return x


def _stack_ssm(params, cfg, x, decoding, caches, dist=None):
    if decoding:
        x = _mamba_layers(params.layers, cfg, x, True, caches["conv"],
                          caches["ssm"], None, dist)
        return x, caches
    per_layer = []
    body = _remat(cfg, dist, lambda layer, h: layer(cfg, h, dist), False)
    for layer in params.layers:
        x, cache = body(layer, x)
        per_layer.append(cache)
    return x, dict(zip(("conv", "ssm"), _stack(per_layer)))


def _stack_hybrid(params, cfg, x, positions, dist, decoding, caches,
                  index):
    """zamba2: groups of ``attn_every`` mamba layers + shared attn block.
    Leftover layers (n_layers % attn_every) run as trailing mamba-only
    layers with no shared-block invocation."""
    k = cfg.attn_every
    G = cfg.n_layers // k
    shared = params.shared
    mamba_caches, shared_caches = [], []
    conv = ssm = None
    if decoding:
        conv, ssm = caches["conv"], caches["ssm"]

    def group(h, lo, hi):
        out = []
        h = _mamba_layers(params.layers[lo:hi], cfg, h, False, None, None,
                          out, dist)
        h, cache = shared(cfg, h, positions, dist)
        return h, out, cache

    group = _remat(cfg, dist, group, decoding)
    for g in range(G + 1):
        lo, hi = g * k, min((g + 1) * k, cfg.n_layers)
        if g == G or decoding:
            x = _mamba_layers(params.layers[lo:hi], cfg, x, decoding,
                              None if conv is None else conv[lo:hi],
                              None if ssm is None else ssm[lo:hi],
                              mamba_caches, dist)
        if g == G:  # the trailing mamba-only layers
            break
        if decoding:
            x, _ = shared.decode(cfg, x, positions,
                                 (caches["shared_k"][g],
                                  caches["shared_v"][g]), index, dist)
        else:
            x, out, cache = group(x, lo, hi)
            mamba_caches += out
            shared_caches.append(cache)
    if decoding:
        return x, caches
    nconv, nssm = _stack(mamba_caches)
    nsk, nsv = _stack(shared_caches)
    return x, {"conv": nconv, "ssm": nssm, "shared_k": nsk, "shared_v": nsv}


def _forward(params: Model, cfg: ModelConfig, batch: dict, dist: Dist,
             decoding=False, caches=None, index=None):
    """Returns (final hidden states (B, S, d), new caches).  Under an
    active ``dist`` ``batch`` is this rank's block over the batch axes."""
    with (manual_axes(dist.mesh, dist.manual) if dist.active
          else contextlib.nullcontext()):
        x, positions = _embed(params, cfg, batch, dist)
        if cfg.family == "ssm":
            x, new_caches = _stack_ssm(params, cfg, x, decoding, caches,
                                       dist)
        elif cfg.family == "hybrid":
            x, new_caches = _stack_hybrid(params, cfg, x, positions, dist,
                                          decoding, caches, index)
        else:
            x, new_caches = _stack_attn(params, cfg, x, positions, dist,
                                        decoding, caches, index)
        return rms_norm(x, params.ln_f, cfg.norm_eps), new_caches


def _head(params: Model, h, cfg: ModelConfig | None = None,
          name: str | None = None):
    """The vocabulary head; with ``name`` (the model axis the vocabulary
    is split over) this rank's block of the logits."""
    if name is None:
        return h @ params.out
    return tp_enter(h, name) @ tp_block(params.out, name, 1, cfg.vocab)


def _last_logits(params: Model, h, cfg: ModelConfig, dist: Dist):
    """The last position's logits, the same on every rank: under
    tensor-parallel arithmetic over a vocabulary it divides, each rank's
    block of them gathered over the model axis."""
    with (manual_axes(dist.mesh, dist.manual) if dist.active
          else contextlib.nullcontext()):
        name = _vocab_axis(cfg, dist)
        logits = _head(params, h[:, -1], cfg, name)
        return logits if name is None else tp_gather(logits, name, -1)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def train_loss(params: Model, batch: dict, cfg: ModelConfig,
               dist: Dist = Dist()) -> torch.Tensor:
    """Mean next-token (or frame-label for encoders) cross-entropy.

    With ``cfg.loss_chunk`` the vocabulary head + xent run per sequence
    chunk, so the (B, S, V) logits tensor never materializes.  Under
    tensor-parallel arithmetic over a vocabulary it divides, each rank
    makes its block of the logits and the loss is the
    vocabulary-parallel cross entropy, the same on every rank."""
    h, _ = _forward(params, cfg, batch, dist)
    labels = _as_tensor(batch["labels"], h.device, torch.long)
    B, S, d = h.shape
    with (manual_axes(dist.mesh, dist.manual) if dist.active
          else contextlib.nullcontext()):
        name = _vocab_axis(cfg, dist)

        def xent(hc, lc):
            return softmax_cross_entropy(_head(params, hc, cfg, name), lc,
                                         name)

        if cfg.loss_chunk and S % cfg.loss_chunk == 0 \
                and S > cfg.loss_chunk:
            total = torch.zeros((), dtype=torch.float32, device=h.device)
            for c0 in range(0, S, cfg.loss_chunk):
                c1 = c0 + cfg.loss_chunk
                total = total + xent(h[:, c0:c1], labels[:, c0:c1]).sum()
            return total / (B * S)
        return xent(h, labels).mean()


@torch.no_grad()
def prefill(params: Model, batch: dict, cfg: ModelConfig,
            dist: Dist = Dist()):
    """Full-sequence forward; returns (last-position logits, caches of
    length S for continuation).  The vocab head runs on the LAST position
    only — serving never needs the (B, S, V) logits.  Under a server's
    tensor-parallel ``dist`` the caches are its layers' (the rank's KV
    heads where they split the axis, else every KV head; MLA's whole
    latent; the rank's mamba channels or heads), every position: the
    engine installs the rank's block of them
    (core/deploy/engine.py ``_write_lane``)."""
    h, caches = _forward(params, cfg, batch, dist)
    return _last_logits(params, h, cfg, dist), caches


@torch.no_grad()
def decode_step(params: Model, token_batch: dict, caches: dict, index,
                cfg: ModelConfig, dist: Dist = Dist()):
    """One decode step.  ``token_batch`` holds (B, 1) tokens (or (B,1,d)
    embeds) plus positions; ``index`` is the current cache length, an int
    or a (B,) tensor of one a lane.  ``caches`` is updated in place and
    returned: under a server's tensor-parallel ``dist``, this rank's
    blocks (module docstring)."""
    h, new_caches = _forward(params, cfg, token_batch, dist, decoding=True,
                             caches=caches, index=index)
    return _last_logits(params, h, cfg, dist), new_caches
