"""Learning-rate schedules, including the WSD (warmup-stable-decay)
schedule MiniCPM's recipe calls for (the counterpart of
``src/repro/optim/schedules.py``).  Each computes in f32, as the
reference's jnp does, and returns a host float."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.tensor(float(v), dtype=F32)


def wsd_schedule(peak: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.0):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395)."""

    def lr(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        dec_frac = (step - warmup - stable) / max(decay, 1)
        dec = peak * (1.0 - dec_frac) + floor * dec_frac
        out = torch.where(step < warmup, warm,
                          torch.where(step < warmup + stable, _f32(peak),
                                      torch.clamp(dec, min=floor)))
        return float(out)

    return lr


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_ratio: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor_ratio * peak + (1 - floor_ratio) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return float(torch.where(step < warmup, warm, cos))

    return lr
