"""The port's whole model stack (``models/transformer.py``) against the
reference, for the dense, vision-language and encoder families: the
reference's weights (``init_params(cfg, PRNGKey(0))``) carried across by
``params_from_reference``, seeded numpy batches, the reference jitted.

Per arch at its smoke config (float32): ``train_loss``; for decoders the
``prefill`` logits and caches, then three ``decode_step``s (logits and
caches), and a (lanes,) cache-index tensor against the scalar-index step
of each lane.  Tolerance: |port - ref| <= 1e-4 + 1e-4 |ref| (largest seen
~5e-6); lane against scalar 1e-5 + 1e-5 relative (matmuls over two lanes
round unlike over one: seen <= 2.4e-6).
"""

import pytest

from torch_model_oracle import check_lane_index, check_prefill_and_decode, \
    check_train_loss

ARCHS = ("qwen3-0.6b", "qwen1.5-4b", "qwen1.5-32b", "minicpm-2b",
         "qwen2-vl-72b", "hubert-xlarge")
DECODERS = ARCHS[:-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch):
    check_train_loss(arch)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(arch):
    check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", DECODERS)
def test_lane_index_decode_equals_scalar_index(arch):
    check_lane_index(arch)


def test_loss_chunk_matches_reference():
    check_train_loss("qwen3-0.6b", loss_chunk=4)


@pytest.mark.parametrize("impl,block", [("blockwise", 16),
                                        ("blockwise", 512)])
def test_attention_impls_match_reference(impl, block):
    check_prefill_and_decode("qwen3-0.6b", steps=1, attn_impl=impl,
                             attn_block=block)
