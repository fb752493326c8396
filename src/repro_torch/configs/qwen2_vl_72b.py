"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings; the LM backbone (with 3-section M-RoPE) is
modelled in full.  Text tokens are embedded normally; positions3 carries the
(temporal, height, width) rotary ids.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    mrope=True,
    qkv_bias=True,
    remat="full",
)


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab=512, dtype="float32",
                         remat="none")
