"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
— encoder-only, wav2vec2-style backbone.  [arXiv:2106.07447; unverified]

The convolutional waveform frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, T, 1280).  The
model is bidirectional (causal=False) and has no decode step; the training
objective is masked-frame cluster prediction over the 504-unit codebook.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    embedding_inputs=True,
)


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=128, vocab=32, dtype="float32")
