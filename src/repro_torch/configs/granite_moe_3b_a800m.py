"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Note: the assignment line reads "MoE 40e top-8 — 32 experts top-8"; we take
the primary spec (40 experts).  40 does not divide a 16-way EP axis, so the
expert dim is zero-padded to 48 at init (``expert_shards=16``); padded router
columns can never win top-k (see models/moe.py).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    n_experts=40,
    top_k=8,
    vocab=49155,
    moe_mode="ep_a2a",
    expert_shards=16,
)


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=96, moe_d_ff=96, n_experts=8,
                         top_k=2, vocab=512, dtype="float32",
                         moe_mode="dense", expert_shards=1)
