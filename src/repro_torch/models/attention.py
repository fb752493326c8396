"""Attention blocks: GQA (bias / qk-norm / RoPE / M-RoPE variants) and MLA
(DeepSeek multi-head latent attention, with compressed-cache absorbed decode).

The counterpart of ``src/repro/models/attention.py``.  Every full-sequence
GQA attention runs on the flash-attention kernel's wrapper
(``kernels/flash_attention/ops.py``), whichever ``attn_impl`` the config
names: the reference's naive einsum softmax and its blockwise form compute
the same function, and the two knobs only choose the kernel's tiles
(:func:`attention_tiles`).  Decode attention (one query against the cache)
and MLA are torch ops, as the reference computes them outside any kernel.

Which path a call takes is decided by shape and config before any launch:

* causal attention is padded at the end to the tile; a real query never
  sees a padded key (its masked score is -1e30, so its weight is 0), and
  the padded rows are sliced off;
* non-causal attention (the encoder, hubert) is not padded, since every
  query would see a padded key: its tile is the largest divisor of S at
  most the tile;
* on the card the kernel is built for head dims 32, 64 and 128; the
  wrapper pads a smaller one with zero columns to the next of them
  (the smoke configs' 16 and 18 to 32, hubert's 80 to 128,
  ``launch_head_dim``) and raises ``ValueError`` only above 128;
* MLA's q/k head dim (192) differs from its v head dim (128), which the
  kernel does not take: its attention is torch ops.

Under an active ``Dist`` (models/transformer.py) each rank runs the
attention of its own batch block.  In the train step's tensor-parallel
arithmetic (``Dist.tensor_parallel``, a ``model`` axis of m > 1 ranks and
H divisible by m) it runs on its H/m query heads, as the reference's
GSPMD partitions by its ``with_sharding_constraint`` on q, k and v
(``_shard`` here: each holds this rank's heads).  The input enters the
region whole; ``wq`` (and ``bq``) are the rank's heads.  KV heads split
over the axis (``wk`` placed on it) are the rank's own; when
``launch/shardings.py`` left ``wk`` and ``wv`` whole (K not divisible by
m), the rank projects the KV heads its query heads read (head h reads h //
(H/K)) from a slice of the whole weights, whose gradient is summed over
the axis.  The flash kernel runs on the local heads, and ``wo``'s
row-parallel product ends in one sum over the axis.  This holds for
every GQA family (M-RoPE and the biases on the local heads, the
encoder's non-causal attention) and for zamba2's shared block; MLA splits
the same way over ``wq_b``/``wkv_b``'s heads, with its low-rank
projections whole.  Otherwise (serving, H not divisible, one rank) the
attention is the one-device function and ``_shard`` places nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.flash_attention.ops import flash_attention
from .common import ModelConfig, axis_index, axis_size, tp_axis, tp_block, \
    tp_enter, tp_exit
from .layers import Params, apply_mrope, apply_rope, dense_init, rms_norm

NEG_INF = -1e30

# the kernel's shipped tile (kernels/workloads.py BASELINES), the tile
# attn_impl="naive" takes; the largest tile each dtype's kernel takes at
# every head dim it is built for (f32 stages one K and one V tile of
# block_k rows in shared memory, which 256 rows of head dim 128 overflow)
NAIVE_TILE = 128
MAX_TILE = {torch.bfloat16: 256, torch.float32: 128}
MIN_TILE = 16


def _shard(x, dist, *axes, heads: int = 0):
    """The reference's activation sharding constraint: under
    tensor-parallel arithmetic over ``heads`` (module docstring) each
    dimension ``axes`` names by the model axis holds this rank's block of
    them (taken here when ``x`` holds them all); a rank holds its batch
    block already, so the batch axes place nothing, and without ``heads``
    (attention that runs whole) nothing is placed."""
    name = tp_axis(dist)
    if name is None or not heads:
        return x
    for dim, entry in enumerate(axes):
        if entry == name:
            x = tp_block(x, name, dim, heads)
    return x


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_attn(cfg: ModelConfig, dtype, *, generator, device) -> Params:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def w(shape, in_axis=-2):
        return dense_init(shape, generator=generator, device=device,
                          in_axis=in_axis, dtype=dtype)

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=dtype, device=device)

    if cfg.mla:
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return Params(
            wq_a=w((d, r_q)), q_norm=const(1.0, r_q),
            wq_b=w((r_q, H, nope + rope)),
            wkv_a=w((d, r_kv + rope)), kv_norm=const(1.0, r_kv),
            wkv_b=w((r_kv, H, nope + vdim)),
            wo=w((H, vdim, d), in_axis=0))
    p = {"wq": w((d, H, hd), in_axis=0), "wk": w((d, K, hd), in_axis=0),
         "wv": w((d, K, hd), in_axis=0), "wo": w((H, hd, d), in_axis=0)}
    if cfg.qkv_bias:
        p.update(bq=const(0.0, H, hd), bk=const(0.0, K, hd),
                 bv=const(0.0, K, hd))
    if cfg.qk_norm:
        p.update(q_scale=const(1.0, hd), k_scale=const(1.0, hd))
    return Params(**p)


# --------------------------------------------------------------------------
# core attention math
# --------------------------------------------------------------------------

def _proj(x, w):
    """einsum("bsd,d...->bs...", x, w) as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + w.shape[1:])


def _out(o, wo):
    """einsum("bshk,hkd->bsd", o, wo) as one matmul."""
    return o.reshape(o.shape[:2] + (-1,)) @ wo.reshape(-1, wo.shape[-1])


def _sdpa(q, k, v, mask, scale):
    """q:(B,S,H,hd) k/v:(B,T,K,*) grouped-query attention with fp32 softmax;
    mask (B or 1, S, T), True where a query may attend."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    if G == 1:
        logits = torch.einsum("bshk,bthk->bhst", q, k).to(torch.float32)
        logits = (logits * scale).masked_fill(~mask[:, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthk->bshk", probs, v)
    q = q.reshape(B, S, K, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", q, k).to(torch.float32)
    logits = (logits * scale).masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, -1)


def causal_mask(S: int, T: int, device=None):
    """(1, S, T) True where query i may attend key j (j <= i)."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    return (kj <= qi)[None]


def attention_tiles(cfg: ModelConfig, S: int, dtype) -> tuple[int, int]:
    """The flash kernel's (tile, padded length) for a sequence of S, by one
    rule: ``attn_impl="blockwise"`` asks for ``attn_block`` rows a tile,
    ``"naive"`` for the kernel's shipped 128; the tile is the largest power
    of two at most that, at most the dtype's ``MAX_TILE`` and at least 16,
    halved while half of it still covers S.  ``block_q = block_k = tile``:
    every such tile is one the kernel is instantiated for (a multiple of 8
    up to 256; a bf16 ``block_k`` of its list).  Causal attention pads S up
    to a multiple of the tile; non-causal takes the largest divisor of S at
    most the tile, unpadded."""
    want = cfg.attn_block if cfg.attn_impl == "blockwise" else NAIVE_TILE
    cap = min(want, MAX_TILE.get(dtype, MAX_TILE[torch.float32]))
    tile = MIN_TILE
    while tile * 2 <= cap:
        tile *= 2
    while tile > MIN_TILE and tile // 2 >= S:
        tile //= 2
    if not cfg.causal:
        tile = next(t for t in range(min(tile, S), 0, -1) if S % t == 0)
        return tile, S
    return tile, -(-S // tile) * tile


def flash_sdpa(q, k, v, cfg: ModelConfig):
    """Full-sequence attention of (B, S, H, hd) q, k, v (KV heads already
    expanded) on the flash kernel: to (B, H, S, hd), padded at the end to
    the tile when causal, and back."""
    S = q.shape[1]
    tile, Sp = attention_tiles(cfg, S, q.dtype)

    def heads_first(t):
        t = t.transpose(1, 2)
        if Sp != S:
            t = torch.nn.functional.pad(t, (0, 0, 0, Sp - S))
        return t.contiguous()

    out = flash_attention(heads_first(q), heads_first(k), heads_first(v),
                          causal=cfg.causal, block_q=tile, block_k=tile)
    return out[:, :, :S].transpose(1, 2)


# --------------------------------------------------------------------------
# GQA forward (train / prefill / decode)
# --------------------------------------------------------------------------

def _project_qkv(p, cfg: ModelConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_scale"], cfg.norm_eps)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    elif cfg.causal:  # encoder-only hubert uses no rotary (conv pos emb stub)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, cfg: ModelConfig, x, positions, dist=None):
    """Full-sequence attention (training / prefill). Returns (y, (k, v)).

    KV heads are expanded to the full head count, as the reference does, so
    the kernel runs plain MHA.  Under tensor-parallel arithmetic (module
    docstring) y is the same on every rank and the caches hold the rank's
    KV heads."""
    name = tp_axis(dist)
    if name is not None and cfg.n_heads % axis_size(name) == 0:
        return _gqa_tensor_parallel(p, cfg, x, positions, dist, name)
    q, k, v = _project_qkv(p, cfg, x, positions)
    G = cfg.n_heads // cfg.n_kv_heads
    ke = k.repeat_interleave(G, dim=2) if G > 1 else k
    ve = v.repeat_interleave(G, dim=2) if G > 1 else v
    if dist is not None and dist.active:
        dp, mdl = dist.batch_axes, dist.model_axis
        q = _shard(q, dist, dp, None, mdl, None)
        ke = _shard(ke, dist, dp, None, mdl, None)
        ve = _shard(ve, dist, dp, None, mdl, None)
    out = flash_sdpa(q, ke, ve, cfg)
    return _out(out, p["wo"]), (k, v)


def _kv_slice(p, cfg: ModelConfig, name: str) -> tuple:
    """(KV weights for this rank, the KV head each local query head reads):
    the rank's own ``wk``/``wv`` heads when they are split over the axis;
    else the slice of the whole weights its query heads read, whose
    gradients are summed over the axis."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    m, r = axis_size(name), axis_index(name)
    Hl, G = H // m, H // K
    keys = [k for k in ("wk", "wv", "bk", "bv") if k in p]
    if K % m == 0:
        w = {k: tp_block(p[k], name, 1 if k[0] == "w" else 0, K)
             for k in keys}
        return w, [i // G for i in range(Hl)]
    lo, hi = (r * Hl) // G, ((r + 1) * Hl - 1) // G + 1
    w = {k: tp_enter(p[k], name).narrow(1 if k[0] == "w" else 0, lo, hi - lo)
         for k in keys}
    return w, [(r * Hl + i) // G - lo for i in range(Hl)]


def _gqa_tensor_parallel(p, cfg: ModelConfig, x, positions, dist, name):
    """:func:`gqa_forward` on this rank's query heads (module docstring)."""
    H = cfg.n_heads
    x = tp_enter(x, name)
    kv, heads = _kv_slice(p, cfg, name)
    q = _proj(x, tp_block(p["wq"], name, 1, H))
    k, v = _proj(x, kv["wk"]), _proj(x, kv["wv"])
    if cfg.qkv_bias:
        q = q + tp_block(p["bq"], name, 0, H)
        k, v = k + kv["bk"], v + kv["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, tp_enter(p["q_scale"], name), cfg.norm_eps)
        k = rms_norm(k, tp_enter(p["k_scale"], name), cfg.norm_eps)
    rope = apply_mrope if cfg.mrope else apply_rope if cfg.causal else None
    if rope is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    rep = len(heads) // k.shape[2]
    if heads == [i // rep for i in range(len(heads))]:
        ke = k.repeat_interleave(rep, dim=2) if rep > 1 else k
        ve = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    else:  # the rank's query heads start inside a KV head's group
        idx = torch.tensor(heads, device=k.device)
        ke, ve = k.index_select(2, idx), v.index_select(2, idx)
    dp = dist.batch_axes
    q = _shard(q, dist, dp, None, name, None, heads=H)
    ke = _shard(ke, dist, dp, None, name, None, heads=H)
    ve = _shard(ve, dist, dp, None, name, None, heads=H)
    out = flash_sdpa(q, ke, ve, cfg)
    y = _out(out, tp_block(p["wo"], name, 0, H))
    return tp_exit(y, name), (k, v)


def lane_index(index, batch: int, device) -> torch.Tensor | int:
    """A decode step's cache index: one for the whole batch (an int, as the
    reference's direct loop passes it) or one a lane (a (batch,) tensor:
    continuous batching)."""
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        if index.shape != (batch,):
            raise ValueError(f"decode index of shape {tuple(index.shape)} "
                             f"for a batch of {batch}")
        return index.to(device=device, dtype=torch.long)
    return int(index)


def _write_rows(cache, new, index):
    """Write ``new`` (B, ...) at sequence position ``index`` of ``cache``
    (B, T, ...) in place, per lane when ``index`` is a tensor."""
    if isinstance(index, int):
        cache[:, index] = new
    else:
        cache[torch.arange(cache.shape[0], device=cache.device),
              index] = new


def _decode_mask(index, T: int, device):
    kj = torch.arange(T, device=device)
    if isinstance(index, int):
        return (kj <= index)[None, None]                  # (1, 1, T)
    return (kj[None] <= index[:, None])[:, None]          # (B, 1, T)


def gqa_decode(p, cfg: ModelConfig, x, cache_k, cache_v, index, positions):
    """One-token decode against a (B, S_max, K, hd) KV cache.

    ``index`` is the current length: an int, or one a lane as a (B,)
    tensor; the new token's K/V are written at ``index`` (in place: the
    caches passed in are the ones returned) and attention spans positions
    <= index."""
    q, k, v = _project_qkv(p, cfg, x, positions)           # S == 1
    index = lane_index(index, x.shape[0], x.device)
    _write_rows(cache_k, k[:, 0], index)
    _write_rows(cache_v, v[:, 0], index)
    mask = _decode_mask(index, cache_k.shape[1], x.device)
    out = _sdpa(q, cache_k, cache_v, mask, 1.0 / np.sqrt(cfg.hd))
    return _out(out, p["wo"]), (cache_k, cache_v)


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# --------------------------------------------------------------------------

def _mla_query(p, cfg: ModelConfig, x, positions):
    nope = cfg.qk_nope_dim
    q = rms_norm(_proj(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = _proj(q, p["wq_b"])
    return q[..., :nope], apply_rope(q[..., nope:], positions,
                                     cfg.rope_theta)


def _mla_latent(p, cfg: ModelConfig, x, positions):
    kv = _proj(x, p["wkv_a"])
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def mla_forward(p, cfg: ModelConfig, x, positions, dist=None):
    """Full-sequence MLA. Returns (y, (c_kv, k_rope)) — the compressed
    cache.  Torch ops for either ``attn_impl``: the kernel takes no q/k
    head dim that differs from v's.  Under tensor-parallel arithmetic
    (module docstring) on this rank's heads: ``wq_b`` and ``wkv_b`` are
    its heads and ``wo`` its rows; the low-rank projections ``wq_a`` and
    ``wkv_a`` and their norms are used whole, their gradients summed over
    the axis; ``wo``'s row-parallel product ends in one sum."""
    name = tp_axis(dist)
    H = cfg.n_heads
    if name is not None and H % axis_size(name) == 0:
        x = tp_enter(x, name)
        p = {**{k: tp_enter(p[k], name)
                for k in ("wq_a", "q_norm", "wkv_a", "kv_norm")},
             "wq_b": tp_block(p["wq_b"], name, 1, H),
             "wkv_b": tp_block(p["wkv_b"], name, 1, H),
             "wo": tp_block(p["wo"], name, 0, H)}
    else:
        name = None
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    kvu = _proj(c_kv, p["wkv_b"])
    k_nope, v = kvu[..., :nope], kvu[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(k_nope.shape[:-1] + (rope,))], -1)
    qk = torch.cat([q_nope, q_rope], -1)
    if dist is not None and dist.active:
        dp, mdl = dist.batch_axes, dist.model_axis
        heads = H if name is not None else 0
        qk = _shard(qk, dist, dp, None, mdl, None, heads=heads)
        k = _shard(k, dist, dp, None, mdl, None, heads=heads)
        v = _shard(v, dist, dp, None, mdl, None, heads=heads)
    S = x.shape[1]
    out = _sdpa(qk, k, v, causal_mask(S, S, device=x.device),
                1.0 / np.sqrt(nope + rope))
    y = _out(out, p["wo"])
    return (y if name is None else tp_exit(y, name)), \
        (c_kv, k_rope[..., 0, :])


def mla_decode(p, cfg: ModelConfig, x, cache_ckv, cache_krope, index,
               positions):
    """Absorbed-weight MLA decode: attention runs in the compressed
    kv_lora space, so the cache is (B, S, r_kv) + (B, S, rope) only.
    ``index`` as for :func:`gqa_decode`; the caches are written in place."""
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    # absorb k_nope projection into the query:  q' = q_nope @ W_kv_b[:, :, :nope]^T
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wkv_b"][..., :nope])
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    index = lane_index(index, x.shape[0], x.device)
    _write_rows(cache_ckv, c_kv[:, 0], index)
    _write_rows(cache_krope, k_rope[:, 0, 0], index)
    logits = (torch.einsum("bshr,btr->bhst", q_abs, cache_ckv)
              + torch.einsum("bshk,btk->bhst", q_rope, cache_krope))
    logits = logits.to(torch.float32) / np.sqrt(nope + rope)
    mask = _decode_mask(index, cache_ckv.shape[1], x.device)   # (B|1,1,T)
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, -1).to(x.dtype)
    ctx = torch.einsum("bhst,btr->bshr", probs, cache_ckv)
    # un-absorb the value projection
    out = torch.einsum("bshr,rhk->bshk", ctx, p["wkv_b"][..., nope:])
    return _out(out, p["wo"]), (cache_ckv, cache_krope)
