"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba1 architecture.  [arXiv:2410.05355; unverified]

d_inner = 2 * d_model = 8192, conv kernel 4, dt_rank = d_model/16 = 256.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm_state=16,
    ssm_version=1,
    ssm_expand=2,
    ssm_conv=4,
)


def smoke():
    return CONFIG.scaled(n_layers=3, d_model=64, vocab=512, ssm_state=8,
                         dtype="float32")
