"""Architecture registry: one module per assigned architecture.

Each module exposes ``CONFIG`` (the exact public configuration) and
``smoke()`` (a reduced same-family config for CPU tests).  ``get_config`` /
``smoke_config`` look them up by id; ``ARCHS`` lists all ids.
"""

from __future__ import annotations

import importlib

ARCHS = (
    "granite-moe-3b-a800m",
    "deepseek-v3-671b",
    "qwen2-vl-72b",
    "zamba2-1.2b",
    "minicpm-2b",
    "qwen1.5-4b",
    "qwen1.5-32b",
    "qwen3-0.6b",
    "falcon-mamba-7b",
    "hubert-xlarge",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}

# CLI-friendly aliases: ids are unambiguous with every separator flattened
# to "-" ("qwen3-0-6b", "qwen3_0_6b" -> "qwen3-0.6b")
_ALIASES = {a.replace(".", "-"): a for a in ARCHS}


def _load(arch: str):
    canon = _ALIASES.get(arch.lower().replace("_", "-").replace(".", "-"))
    if arch not in _MOD:
        if canon is None:
            raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
        arch = canon
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")


def get_config(arch: str):
    return _load(arch).CONFIG


def smoke_config(arch: str):
    return _load(arch).smoke()


# ---- input-shape cells (assignment) ---------------------------------------
# name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def runnable_cells():
    """All (arch, shape) cells after the assignment's skip rules:
    encoder-only archs skip decode shapes; long_500k only for sub-quadratic
    archs (ssm / hybrid)."""
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape, (_, _, kind) in SHAPES.items():
            if cfg.family == "encoder" and kind == "decode":
                continue  # encoder-only: no decode step
            if shape == "long_500k" and not cfg.sub_quadratic:
                continue  # needs sub-quadratic attention
            cells.append((arch, shape))
    return cells
