"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — WSD schedule (arch=llama-like).  [arXiv:2404.06395; hf]

The WSD (warmup-stable-decay) learning-rate schedule is a training-recipe
property; it is available in ``repro_torch.optim.schedules`` (``python -m
repro_torch.launch.train --schedule wsd``) and selected by this config's
training recipe, not an architecture change.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab=122753,
)

LR_SCHEDULE = "wsd"


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=72, n_heads=4, n_kv_heads=4,
                         head_dim=18, d_ff=144, vocab=512, dtype="float32")
