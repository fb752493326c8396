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
projections whole.  A server (``Dist.cache_len``) keeps every KV head in
its prefill's caches when they do not split, and returns them as
``cache_specs`` lays them out (:func:`_cache_rows`: the rank's block of
the positions where the sequence splits).  Its decode runs on the
rank's block of the caches, as ``cache_specs`` lays them out
(:func:`kv_layout`): the rank's KV heads; or, where they do not divide
the axis, its block of the positions, the softmax combined over the axis
(the flash-decode form: a maximum, then one sum of the exponentials and
one of the weighted values) with the query heads gathered whole; or the
whole cache on every rank.  Otherwise (H not divisible in training, one
rank, no ``Dist``) the attention is the one-device function and
``_shard`` places nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.flash_attention.ops import flash_attention
from .common import ModelConfig, axis_index, axis_size, pmax, tp_axis, \
    tp_block, tp_enter, tp_exit, tp_gather
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


def _softmax(logits, name: str | None, dtype):
    """The softmax over the last axis of masked f32 ``logits``, cast to
    ``dtype``.  With ``name``, the positions are split over that model
    axis (the flash-decode form): one maximum over the axis and one sum of
    the exponentials; a product of the probabilities with the rank's values
    is then one more sum over the axis."""
    if name is None:
        return torch.softmax(logits, dim=-1).to(dtype)
    top = pmax(logits.amax(-1, keepdim=True), name)
    e = torch.exp(logits - top)
    return (e / tp_exit(e.sum(-1, keepdim=True), name)).to(dtype)


def _sdpa(q, k, v, mask, scale, name: str | None = None):
    """q:(B,S,H,hd) k/v:(B,T,K,*) grouped-query attention with fp32 softmax;
    mask (B or 1, S, T), True where a query may attend.  With ``name``,
    k/v hold this rank's block of the positions of a sequence split over
    that model axis: the softmax is combined over the axis
    (:func:`_softmax`) and the values' product summed over it."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    if G == 1:
        logits = torch.einsum("bshk,bthk->bhst", q, k).to(torch.float32)
        logits = (logits * scale).masked_fill(~mask[:, None], NEG_INF)
        probs = _softmax(logits, name, v.dtype)
        out = torch.einsum("bhst,bthk->bshk", probs, v)
    else:
        q = q.reshape(B, S, K, G, hd)
        logits = torch.einsum("bskgh,btkh->bkgst", q, k).to(torch.float32)
        logits = (logits * scale).masked_fill(~mask[:, None, None], NEG_INF)
        probs = _softmax(logits, name, v.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v).reshape(B, S, H, -1)
    return out if name is None else tp_exit(out, name)


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
    return _out(out, p["wo"]), _cache_rows(cfg, dist, k, v)


def _cache_rows(cfg: ModelConfig, dist, *caches) -> tuple:
    """A server's caches of a full sequence as ``cache_specs`` lays them
    out: where they split the sequence over the model axis
    (:func:`kv_layout` ``"seq"``), this rank's block of the positions,
    [r T/m, (r + 1) T/m) of the ``dist.cache_len`` positions T, those the
    sequence reaches (a copy, so the whole is freed); else as they are."""
    name = tp_axis(dist)
    if name is None or not dist.cache_len or \
            kv_layout(cfg, axis_size(name), dist.cache_len) != "seq":
        return caches
    T = dist.cache_len // axis_size(name)
    lo = axis_index(name) * T
    return tuple(c[:, lo:lo + T].clone() for c in caches)


def _kv_heads(cfg: ModelConfig, name: str, whole: bool = False) -> tuple:
    """(lo, hi, heads): the KV heads [lo, hi) this rank's H/m query heads
    read, and for each of those query heads the one it reads, counted from
    lo: the rank's own block when the KV heads divide the axis; else those
    its query heads read, or with ``whole`` all of them."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    m, r = axis_size(name), axis_index(name)
    Hl, G = H // m, H // K
    if K % m == 0:
        return r * K // m, (r + 1) * K // m, [i // G for i in range(Hl)]
    lo, hi = (0, K) if whole else \
        ((r * Hl) // G, ((r + 1) * Hl - 1) // G + 1)
    return lo, hi, [(r * Hl + i) // G - lo for i in range(Hl)]


def _kv_slice(p, cfg: ModelConfig, name: str, whole: bool = False) -> tuple:
    """(KV weights for this rank, the KV head each local query head reads)
    by :func:`_kv_heads`: the rank's own ``wk``/``wv`` heads when they are
    split over the axis; else the slice of the whole weights its query
    heads read (with ``whole``, the whole weights: a server keeps every KV
    head in its cache), whose gradients are summed over the axis."""
    lo, hi, heads = _kv_heads(cfg, name, whole)
    keys = [k for k in ("wk", "wv", "bk", "bv") if k in p]
    if cfg.n_kv_heads % axis_size(name) == 0:
        w = {k: tp_block(p[k], name, 1 if k[0] == "w" else 0,
                         cfg.n_kv_heads) for k in keys}
    else:
        w = {k: tp_enter(p[k], name).narrow(1 if k[0] == "w" else 0, lo,
                                            hi - lo) for k in keys}
    return w, heads


def _grouped(kv, heads: list):
    """(B, T, K', hd) keys or values as the query heads read them
    (``heads``: the one each reads): as they are where the query heads
    read them in equal groups in order (grouped attention), else one KV
    head a query head."""
    rep = len(heads) // kv.shape[2]
    if rep and heads == [i // rep for i in range(len(heads))]:
        return kv
    return kv.index_select(2, torch.tensor(heads, device=kv.device))


def _gqa_tensor_parallel(p, cfg: ModelConfig, x, positions, dist, name):
    """:func:`gqa_forward` on this rank's query heads (module docstring);
    for a server (``dist.cache_len``) whose KV heads do not split, the
    cache holds every KV head."""
    H = cfg.n_heads
    x = tp_enter(x, name)
    kv, heads = _kv_slice(p, cfg, name, whole=bool(dist.cache_len))
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
    ke, ve = _grouped(k, heads), _grouped(v, heads)
    rep = len(heads) // ke.shape[2]
    if rep > 1:
        ke, ve = ke.repeat_interleave(rep, 2), ve.repeat_interleave(rep, 2)
    dp = dist.batch_axes
    q = _shard(q, dist, dp, None, name, None, heads=H)
    ke = _shard(ke, dist, dp, None, name, None, heads=H)
    ve = _shard(ve, dist, dp, None, name, None, heads=H)
    out = flash_sdpa(q, ke, ve, cfg)
    y = _out(out, tp_block(p["wo"], name, 0, H))
    return tp_exit(y, name), _cache_rows(cfg, dist, k, v)


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


def _decode_mask(index, T: int, device, off: int = 0):
    """(B or 1, 1, T) True where a position off.. off + T - 1 is at or
    before the lane's ``index``."""
    kj = torch.arange(T, device=device)
    if off:
        kj = kj + off
    if isinstance(index, int):
        return (kj <= index)[None, None]                  # (1, 1, T)
    return (kj[None] <= index[:, None])[:, None]          # (B, 1, T)


def kv_layout(cfg: ModelConfig, m: int, cache_len: int) -> str:
    """Where a server's attention caches of ``cache_len`` positions lie on a
    model axis of ``m`` ranks, by ``launch/shardings.py`` ``cache_specs``'
    rule: ``"heads"`` (each rank its block of the GQA KV heads, which
    divide the axis), ``"seq"`` (each rank its block of the positions,
    every KV head or MLA's whole latent) or ``"whole"`` (every rank the
    whole cache)."""
    if not cfg.mla and cfg.n_kv_heads % m == 0:
        return "heads"
    return "seq" if cache_len % m == 0 else "whole"


def _write_block(cache, new, index, off: int):
    """:func:`_write_rows` into a (B, T_loc, ...) block that holds
    positions [off, off + T_loc) of the sequence: a lane whose ``index``
    lies outside the block leaves it as it was."""
    T = cache.shape[1]
    if isinstance(index, int):
        if off <= index < off + T:
            cache[:, index - off] = new
        return
    lanes = torch.arange(cache.shape[0], device=cache.device)
    mine = (index >= off) & (index < off + T)
    at = (index - off).clamp(0, T - 1)
    keep = cache[lanes, at]
    mine = mine.reshape((-1,) + (1,) * (new.dim() - 1))
    cache[lanes, at] = torch.where(mine, new, keep)


def gqa_decode(p, cfg: ModelConfig, x, cache_k, cache_v, index, positions,
               dist=None):
    """One-token decode against a (B, S_max, K, hd) KV cache.

    ``index`` is the current length: an int, or one a lane as a (B,)
    tensor; the new token's K/V are written at ``index`` (in place: the
    caches passed in are the ones returned) and attention spans positions
    <= index.  Under a server's tensor-parallel arithmetic
    (``dist.cache_len``; module docstring) on this rank's block of the
    caches (:func:`kv_layout`) and of the heads."""
    name = tp_axis(dist)
    if name is not None:
        return _gqa_decode_split(p, cfg, x, cache_k, cache_v, index,
                                 positions, dist, name)
    q, k, v = _project_qkv(p, cfg, x, positions)           # S == 1
    index = lane_index(index, x.shape[0], x.device)
    _write_rows(cache_k, k[:, 0], index)
    _write_rows(cache_v, v[:, 0], index)
    mask = _decode_mask(index, cache_k.shape[1], x.device)
    out = _sdpa(q, cache_k, cache_v, mask, 1.0 / np.sqrt(cfg.hd))
    return _out(out, p["wo"]), (cache_k, cache_v)


def _gqa_decode_split(p, cfg: ModelConfig, x, cache_k, cache_v, index,
                      positions, dist, name):
    """:func:`gqa_decode` on this rank's blocks.  The query heads are the
    rank's H/m when they divide the axis (``wo`` row-parallel, one sum),
    else all of them.  ``"heads"``: the rank's KV heads, projected and
    attended on its own.  ``"whole"``: every rank projects and writes every
    KV head and attends with its query heads to the KV heads they read.
    ``"seq"``: every rank projects every KV head, the rank holding
    position ``index`` writes it, the query heads are gathered whole, and
    each rank scores every head over its positions (:func:`_sdpa` over the
    axis), then keeps its heads' output."""
    H = cfg.n_heads
    m, r = axis_size(name), axis_index(name)
    layout = kv_layout(cfg, m, dist.cache_len)
    split = H % m == 0
    w, _ = _kv_slice(p, cfg, name, whole=True)
    w["wq"] = tp_block(p["wq"], name, 1, H) if split else p["wq"]
    if cfg.qkv_bias:
        w["bq"] = tp_block(p["bq"], name, 0, H) if split else p["bq"]
    if cfg.qk_norm:
        w.update(q_scale=p["q_scale"], k_scale=p["k_scale"])
    q, k, v = _project_qkv(w, cfg, x, positions)
    index = lane_index(index, x.shape[0], x.device)
    scale = 1.0 / np.sqrt(cfg.hd)
    if layout == "seq":
        T = cache_k.shape[1]
        _write_block(cache_k, k[:, 0], index, r * T)
        _write_block(cache_v, v[:, 0], index, r * T)
        out = _sdpa(tp_gather(q, name, 2) if split else q, cache_k, cache_v,
                    _decode_mask(index, T, x.device, r * T), scale, name)
        if split:
            out = out[:, :, r * (H // m):(r + 1) * (H // m)]
    else:
        _write_rows(cache_k, k[:, 0], index)
        _write_rows(cache_v, v[:, 0], index)
        ck, cv = cache_k, cache_v
        if layout == "whole" and split:  # the KV heads the rank's read
            lo, hi, heads = _kv_heads(cfg, name)
            ck, cv = (_grouped(c.narrow(2, lo, hi - lo), heads)
                      for c in (ck, cv))
        out = _sdpa(q, ck, cv,
                    _decode_mask(index, cache_k.shape[1], x.device), scale)
    y = _out(out, tp_block(p["wo"], name, 0, H) if split else p["wo"])
    return (tp_exit(y, name) if split else y), (cache_k, cache_v)


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
        _cache_rows(cfg, dist, c_kv, k_rope[..., 0, :])


def mla_decode(p, cfg: ModelConfig, x, cache_ckv, cache_krope, index,
               positions, dist=None):
    """Absorbed-weight MLA decode: attention runs in the compressed
    kv_lora space, so the cache is (B, S, r_kv) + (B, S, rope) only.
    ``index`` as for :func:`gqa_decode`; the caches are written in place.
    Under a server's tensor-parallel arithmetic (``dist.cache_len``) on
    this rank's heads of ``wq_b``/``wkv_b`` and rows of ``wo`` (when the
    heads divide the axis; ``wq_a``, ``wkv_a`` and their norms whole) and
    its block of the latent caches (:func:`kv_layout`): ``"seq"``, the
    rank holding position ``index`` writes it, the absorbed queries are
    gathered over the heads, each rank scores every head over its
    positions (:func:`_softmax` over the axis) and the context is summed
    over the axis before each rank un-absorbs its own heads; ``"whole"``,
    each rank writes the whole cache and attends with its own heads."""
    name = tp_axis(dist)
    H, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    m = 1 if name is None else axis_size(name)
    split = name is not None and H % m == 0
    if split:
        p = {**{k: p[k] for k in ("wq_a", "q_norm", "wkv_a", "kv_norm")},
             "wq_b": tp_block(p["wq_b"], name, 1, H),
             "wkv_b": tp_block(p["wkv_b"], name, 1, H),
             "wo": tp_block(p["wo"], name, 0, H)}
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    # absorb k_nope projection into the query:  q' = q_nope @ W_kv_b[:, :, :nope]^T
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wkv_b"][..., :nope])
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    index = lane_index(index, x.shape[0], x.device)
    seq = name is not None and kv_layout(cfg, m, dist.cache_len) == "seq"
    off = axis_index(name) * cache_ckv.shape[1] if seq else 0
    if seq:
        _write_block(cache_ckv, c_kv[:, 0], index, off)
        _write_block(cache_krope, k_rope[:, 0, 0], index, off)
        if split:
            q_abs, q_rope = tp_gather(q_abs, name, 2), tp_gather(q_rope,
                                                                name, 2)
    else:
        _write_rows(cache_ckv, c_kv[:, 0], index)
        _write_rows(cache_krope, k_rope[:, 0, 0], index)
    logits = (torch.einsum("bshr,btr->bhst", q_abs, cache_ckv)
              + torch.einsum("bshk,btk->bhst", q_rope, cache_krope))
    logits = logits.to(torch.float32) / np.sqrt(nope + rope)
    mask = _decode_mask(index, cache_ckv.shape[1], x.device, off)
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = _softmax(logits, name if seq else None, x.dtype)
    ctx = torch.einsum("bhst,btr->bshr", probs, cache_ckv)
    if seq:
        ctx = tp_exit(ctx, name)
        if split:
            r, hl = axis_index(name), H // m
            ctx = ctx[:, :, r * hl:(r + 1) * hl]
    # un-absorb the value projection
    out = torch.einsum("bshr,rhk->bshk", ctx, p["wkv_b"][..., nope:])
    y = _out(out, p["wo"])
    return (tp_exit(y, name) if split else y), (cache_ckv, cache_krope)
