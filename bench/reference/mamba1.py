"""Plain Mamba-1 at FalconMamba's widths: its training loss, gradients and AdamW
steps, in float32 from the stored weights.

A layer: x + out_proj((scan(dt, x_c, A, B, C) + D x_c) * silu(z)), where
[x | z] = in_proj(rmsnorm(x)), x_c = silu(causal depthwise conv(x)),
[dt_low | B | C] = x_proj(x_c), dt = softplus(dt_proj(dt_low) + dt_bias),
A = -exp(A_log) and the scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
y_t = h_t C_t.  Then rmsnorm, the vocabulary head and the mean
cross-entropy of the next token.  As the port runs it, and unlike
FalconMamba, there are no RMS norms on dt, B and C inside the mixer (its
``mixer_rms_eps``; the configuration lists the key in ``reduced``).

Parameters are stored in the configuration's dtype (bfloat16; ``D``,
``dt_bias`` and ``A_log`` in float32, as mamba keeps them) and AdamW's
update of each is rounded to it, as a trainer without float32 master
weights stores them; the moments are float32.  Each layer's activations
are recomputed in the backward (``torch.utils.checkpoint``), so the
reference fits beside its float32 state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import F32, Recurrence, adamw, exact_f32, product, rms_norm


def sizes(c: dict) -> dict:
    return {"d": c["hidden_size"], "di": c["intermediate_size"],
            "n": c["state_size"], "K": c["conv_kernel"],
            "R": c["time_step_rank"], "V": c["vocab_size"],
            "L": c["num_hidden_layers"], "eps": c["layer_norm_epsilon"]}


LAYER = ("ln", "mamba.in_proj", "mamba.conv_w", "mamba.conv_b",
         "mamba.out_proj", "mamba.D", "mamba.x_proj", "mamba.dt_proj",
         "mamba.dt_bias", "mamba.A_log")


def param_specs(c: dict) -> list:
    s = sizes(c)
    d, di, n, K, R, V = s["d"], s["di"], s["n"], s["K"], s["R"], s["V"]
    bf, f32 = c["torch_dtype"], "float32"
    specs = [("embed", (V, d), bf, ("normal", d)),
             ("ln_f", (d,), bf, ("const", 1.0)),
             ("out", (d, V), bf, ("normal", d))]
    layer = {"ln": ((d,), bf, ("const", 1.0)),
             "mamba.in_proj": ((d, 2 * di), bf, ("normal", d)),
             "mamba.conv_w": ((K, di), bf, ("normal", K)),
             "mamba.conv_b": ((di,), bf, ("const", 0.0)),
             "mamba.out_proj": ((di, d), bf, ("normal", di)),
             "mamba.D": ((di,), f32, ("const", 1.0)),
             "mamba.x_proj": ((di, R + 2 * n), bf, ("normal", di)),
             "mamba.dt_proj": ((R, di), bf, ("normal", R)),
             "mamba.dt_bias": ((di,), f32,
                               ("const", math.log(math.expm1(0.01)))),
             "mamba.A_log": ((di, n), f32, ("log_arange", n))}
    for i in range(s["L"]):
        specs += [(f"layers.{i}.{k}",) + layer[k] for k in LAYER]
    return specs


def _conv(x, w, b):
    """Causal depthwise conv over time: x (B, L, C), w (K, C)."""
    K, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    return sum(pad[:, j:j + L] * w[j] for j in range(K)) + b


def _layer(x, ln, in_proj, conv_w, conv_b, out_proj, D, x_proj, dt_proj,
           dt_bias, A_log, *, s, mm):
    R, n = s["R"], s["n"]
    xi, z = mm(rms_norm(x, ln, s["eps"]), in_proj).chunk(2, dim=-1)
    xi = F.silu(_conv(xi, conv_w, conv_b))
    proj = mm(xi, x_proj)
    dt = F.softplus(mm(proj[..., :R], dt_proj) + dt_bias)
    Bm, Cm = proj[..., R:R + n], proj[..., R + n:]
    a = torch.exp(dt[..., None] * -torch.exp(A_log))
    u = (dt * xi)[..., None] * Bm[:, :, None, :]
    y = torch.einsum("bldn,bln->bld", Recurrence.apply(a, u), Cm) + D * xi
    return x + mm(y * F.silu(z), out_proj)


def loss(P: dict, tokens, labels, c: dict, precision: str = "f32"):
    """Mean next-token cross-entropy of (B, S) ``tokens``."""
    s, mm = sizes(c), product(precision)
    x = P["embed"][tokens]
    for i in range(s["L"]):
        w = [P[f"layers.{i}.{k}"] for k in LAYER]
        x = checkpoint(_layer, x, *w, s=s, mm=mm, use_reentrant=False)
    logits = mm(rms_norm(x, P["ln_f"], s["eps"]), P["out"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def train(c: dict, hp: dict, weights: dict, batches: list,
          precision: str = "f32") -> dict:
    """``len(batches)`` AdamW steps from ``weights`` (stored dtypes):
    each step's loss, each parameter's gradient norm at the first step,
    and each parameter's change after the last, as floats."""
    exact_f32()
    names = list(weights)
    P = {n: weights[n].to(F32).requires_grad_() for n in names}
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    out = {"loss": [], "grad": {}, "change": {}}
    for t, (tokens, labels) in enumerate(batches, 1):
        value = loss(P, tokens, labels, c, precision)
        grads = torch.autograd.grad(value, [P[n] for n in names])
        out["loss"].append(float(value.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                if t == 1:
                    out["grad"][n] = float(g.norm())
                P[n] = adamw(P[n].detach(), g, m[n], v[n], t, hp,
                             weights[n].dtype).requires_grad_()
        del grads, value
    with torch.no_grad():
        for n in names:
            out["change"][n] = float((P[n] - weights[n].to(F32)).norm())
    return out
