"""Plain Qwen3 (dense): the logits of a causal forward pass, in float32
from the stored weights.

A layer: x + o(attn(q, k, v)), then x + down(silu(gate(h)) * up(h)) on
h = rmsnorm(x); q, k, v are projections of rmsnorm(x), q and k RMS-normed
over each head (``qk_norm``) and rotated (RoPE over the head's two halves,
``rope_theta``); grouped-query attention, query head j reading key head
j // (heads / key heads), scaled by head_dim ** -0.5, causal.  Then
rmsnorm and the head.  With ``tie_word_embeddings`` the head is the
embedding's transpose (``param_specs`` draws it so, and the port is handed
the same values for its own ``out``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import F32, exact_f32, product, rms_norm

QUERY_BLOCK = 1024


def sizes(c: dict) -> dict:
    return {"d": c["hidden_size"], "H": c["num_attention_heads"],
            "K": c["num_key_value_heads"], "hd": c["head_dim"],
            "ff": c["intermediate_size"], "V": c["vocab_size"],
            "L": c["num_hidden_layers"], "eps": c["rms_norm_eps"],
            "theta": float(c["rope_theta"])}


LAYER = ("ln1", "ln2", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
         "attn.q_scale", "attn.k_scale", "mlp.gate", "mlp.up", "mlp.down")


def param_specs(c: dict) -> list:
    s = sizes(c)
    d, H, K, hd, ff, V = s["d"], s["H"], s["K"], s["hd"], s["ff"], s["V"]
    bf = c["torch_dtype"]
    head = ("tied", "embed") if c["tie_word_embeddings"] else ("normal", d)
    specs = [("embed", (V, d), bf, ("normal", d)),
             ("ln_f", (d,), bf, ("const", 1.0)),
             ("out", (d, V), bf, head)]
    one = ("const", 1.0)
    layer = {"ln1": ((d,), bf, one), "ln2": ((d,), bf, one),
             "attn.wq": ((d, H, hd), bf, ("normal", d)),
             "attn.wk": ((d, K, hd), bf, ("normal", d)),
             "attn.wv": ((d, K, hd), bf, ("normal", d)),
             "attn.wo": ((H, hd, d), bf, ("normal", H * hd)),
             "attn.q_scale": ((hd,), bf, one),
             "attn.k_scale": ((hd,), bf, one),
             "mlp.gate": ((d, ff), bf, ("normal", d)),
             "mlp.up": ((d, ff), bf, ("normal", d)),
             "mlp.down": ((ff, d), bf, ("normal", ff))}
    for i in range(s["L"]):
        specs += [(f"layers.{i}.{k}",) + layer[k] for k in LAYER]
    return specs


def _rope(x, theta: float):
    """x (S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attention(q, k, v, mm, block: int = QUERY_BLOCK):
    """Causal grouped-query attention of q (S, H, hd), k, v (S, K, hd),
    a block of queries at a time."""
    S, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    kt = k.permute(1, 2, 0)                        # (K, hd, S)
    vt = v.permute(1, 0, 2)                        # (K, S, hd)
    out = torch.empty_like(q)
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        qb = q[q0:q1].reshape(q1 - q0, K, G, hd).permute(1, 2, 0, 3)
        logits = mm(qb.reshape(K, G * (q1 - q0), hd), kt[:, :, :q1])
        logits = logits.reshape(K, G, q1 - q0, q1) * hd ** -0.5
        mask = torch.arange(q1, device=q.device)[None] <= \
            torch.arange(q0, q1, device=q.device)[:, None]
        probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        o = mm(probs.reshape(K, -1, q1), vt[:, :q1])     # (K, G*Sb, hd)
        out[q0:q1] = o.reshape(K, G, q1 - q0, hd).permute(2, 0, 1, 3) \
            .reshape(q1 - q0, H, hd)
    return out


@torch.no_grad()
def logits_at(c: dict, weights: dict, tokens, rows,
              precision: str = "f32"):
    """(len(rows), vocab) logits at positions ``rows`` of the sequence
    ``tokens`` (a 1-D tensor of ids)."""
    exact_f32()
    s, mm = sizes(c), product(precision)
    d, H, K, hd, eps = s["d"], s["H"], s["K"], s["hd"], s["eps"]

    def w(name):
        return weights[name].to(F32)

    x = w("embed")[tokens]
    S = x.shape[0]
    for i in range(s["L"]):
        p = f"layers.{i}."
        h = rms_norm(x, w(p + "ln1"), eps)
        q = mm(h, w(p + "attn.wq").reshape(d, H * hd)).reshape(S, H, hd)
        k = mm(h, w(p + "attn.wk").reshape(d, K * hd)).reshape(S, K, hd)
        v = mm(h, w(p + "attn.wv").reshape(d, K * hd)).reshape(S, K, hd)
        q = _rope(rms_norm(q, w(p + "attn.q_scale"), eps), s["theta"])
        k = _rope(rms_norm(k, w(p + "attn.k_scale"), eps), s["theta"])
        o = _attention(q, k, v, mm).reshape(S, H * hd)
        x = x + mm(o, w(p + "attn.wo").reshape(H * hd, d))
        h = rms_norm(x, w(p + "ln2"), eps)
        x = x + mm(F.silu(mm(h, w(p + "mlp.gate"))) * mm(h, w(p + "mlp.up")),
                   w(p + "mlp.down"))
    h = rms_norm(x[torch.as_tensor(rows, device=x.device)], w("ln_f"), eps)
    return mm(h, w("out"))
