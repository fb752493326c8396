"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (shared attn, kv=32)
d_ff=8192 vocab=32000, ssm_state=64 — Mamba2 backbone + weight-shared
attention blocks.  [arXiv:2411.15242; hf]

The single shared attention+MLP block is applied every 6 mamba2 layers
(6 invocations over 38 layers; the trailing 2 layers are mamba-only).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_version=2,
    ssm_expand=2,
    ssm_heads=64,        # d_inner=4096, head dim 64
    ssm_conv=4,
    attn_every=6,
)


def smoke():
    return CONFIG.scaled(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=128, vocab=512, ssm_state=8,
                         ssm_heads=4, attn_every=2, dtype="float32")
