"""The port's whole model stack against the reference, for the MoE, MLA,
SSM and hybrid families (granite, deepseek-v3, falcon-mamba, zamba2):
as tests/test_torch_transformer.py, plus zamba2 under both ``ssm_impl``.
Tolerance: |port - ref| <= 1e-4 + 1e-4 |ref| (largest seen ~5e-6)."""

import pytest

from torch_model_oracle import check_lane_index, check_prefill_and_decode, \
    check_train_loss

ARCHS = ("granite-moe-3b-a800m", "deepseek-v3-671b", "falcon-mamba-7b",
         "zamba2-1.2b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch):
    check_train_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    check_prefill_and_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lane_index_decode_equals_scalar_index(arch):
    check_lane_index(arch)


def test_zamba2_naive_ssm_matches_reference():
    check_train_loss("zamba2-1.2b", ssm_impl="naive")
    check_prefill_and_decode("zamba2-1.2b", steps=1, ssm_impl="naive")
