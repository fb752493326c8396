"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MLA.  [arXiv:2412.19437; hf]

MLA dims from the paper: q_lora_rank=1536, kv_lora_rank=512, qk_nope=128,
qk_rope=64, v_head=128.  MTP (multi-token prediction) is a training-recipe
head, not an architecture change; it is not modelled (noted in DESIGN.md).
DeepSeek's first 3 dense layers are simplified to MoE-everywhere (<0.5%
parameter delta).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,          # dense-layer ff (unused: all layers MoE here)
    moe_d_ff=2048,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    vocab=129280,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    moe_mode="ep_a2a",
    expert_shards=16,
    remat="full",
)


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=128, moe_d_ff=48, n_experts=8,
                         n_shared_experts=1, top_k=2, vocab=512,
                         q_lora_rank=48, kv_lora_rank=32, qk_rope_dim=8,
                         qk_nope_dim=16, v_head_dim=16, dtype="float32",
                         moe_mode="dense", expert_shards=1, remat="none")
