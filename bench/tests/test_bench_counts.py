"""The frozen kernel counts and the model FLOPs against hand counts, and
the FLOPs against the dense products ``launch/hlo_analysis.py`` counts for
the same step.  (A test may import the port; the harness does not.)"""

import json

import pytest
import torch

from harness import costs, flops
from tiny import BENCH

FALCON = json.loads((BENCH / "configs" / "mamba1.falcon-mamba-7b-widths.l16.json")
                    .read_text())
QWEN = json.loads((BENCH / "configs" / "qwen3-0.6b.json").read_text())


def test_rmsnorm_counts():
    c = costs.rmsnorm_fwd_cost(rows=4096, d=4096, dtype="bfloat16",
                               scale_dtype="bfloat16")
    assert (c.operations, c.bytes) == (4 * 4096**2, 2 * 4096**2 * 2 + 8192)
    b = costs.rmsnorm_bwd_cost(rows=4096, d=4096, dtype="bfloat16",
                               scale_dtype="bfloat16")
    assert (b.operations, b.bytes) == (10 * 4096**2,
                                       3 * 4096**2 * 2 + 2 * 8192)
    # memory-bound: 67 MB at 3.35 TB/s
    assert c.least_s() == pytest.approx(2 * 4096**2 * 2 / 3.35e12, rel=1e-3)


def test_flash_counts():
    c = costs.flash_attention_fwd_cost(B=1, H=16, S=4, hd=128,
                                       dtype="bfloat16")
    # causal pairs of 4 queries: 1 + 2 + 3 + 4
    assert c.operations == 4 * 128 * 16 * 10
    assert c.bytes == 2 * 16 * 8 * 128 * 2
    assert c.matmul and c.least_s() == max(c.operations / 989e12,
                                           c.bytes / 3.35e12)
    b = costs.flash_attention_bwd_cost(B=1, H=16, S=4, hd=128,
                                       dtype="bfloat16")
    assert b.operations == 10 * 128 * 16 * 10
    assert b.bytes == 4 * 16 * 8 * 128 * 2 + 16 * 4 * 4


def test_scan_counts():
    f = costs.mamba_scan_fwd_cost(Bt=2, L=2048, D=8192, N=16,
                                  dtype="float32", state=True, h_chunks=32)
    assert f.operations == 6 * 2 * 2048 * 8192 * 16
    assert f.bytes == (3 * 2 * 2048 * 8192 * 4 + 8192 * 16 * 4
                       + 2 * 2 * 2048 * 16 * 4 + 33 * 2 * 8192 * 16 * 4)
    b = costs.mamba_scan_bwd_cost(Bt=2, L=2048, D=8192, N=16,
                                  dtype="float32", chunk=64, dh_last=True)
    assert b.operations == 13 * 2 * 2048 * 8192 * 16
    assert not f.matmul and f.least_s() >= f.operations / 67e12


def test_falcon_flops_a_token():
    # by hand: in_proj 4096 x 16384, x_proj 8192 x 288, dt_proj 256 x 8192,
    # out_proj 8192 x 4096 a layer; the head 4096 x 65024; three passes
    layer = 4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096
    assert flops.layer_weights(FALCON["port"]) == layer == 105_119_744
    per_token = 6 * (16 * layer + 4096 * 65024)
    assert flops.train_step(FALCON["port"], 2, 2048) == 2 * 2048 * per_token
    assert per_token / 1e9 == pytest.approx(11.69, abs=0.01)


def test_qwen_flops():
    p = QWEN["port"]
    layer = 1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024 + 3 * 1024 * 3072
    assert flops.layer_weights(p) == layer
    # a 3-token prompt: 3 tokens through the layers, 6 causal pairs, the
    # head on the last position
    assert flops.prefill(p, 3) == (2 * 28 * layer * 3
                                   + 28 * 4 * 128 * 16 * 6
                                   + 2 * 1024 * 151936)
    # decoding at cache length 5 attends to 6 positions
    assert flops.decode(p, 5) == (2 * 28 * layer + 28 * 4 * 128 * 16 * 6
                                  + 2 * 1024 * 151936)
    assert flops.served(p, 3, 2) == flops.prefill(p, 3) + flops.decode(p, 3)


SMALL = {
    "ssm": {"name": "f", "family": "ssm", "n_layers": 2, "d_model": 256,
            "n_heads": 0, "n_kv_heads": 0, "d_ff": 0, "vocab": 1024,
            "ssm_state": 16, "ssm_version": 1, "ssm_expand": 2,
            "ssm_conv": 4, "dtype": "bfloat16"},
    "dense": {"name": "q", "family": "dense", "n_layers": 2, "d_model": 256,
              "n_heads": 4, "n_kv_heads": 2, "head_dim": 64, "d_ff": 768,
              "vocab": 1024, "qk_norm": True, "dtype": "bfloat16"},
}


@pytest.mark.parametrize("family", sorted(SMALL))
def test_flops_against_the_dry_run_count(family):
    """The dry run's count of the same train step (meta tensors):
    its dense products (``aten_flops``) equal the model FLOPs but for
    attention, which the model counts as three forward passes of its two
    products; the flash kernels' own count adds FA2's recomputed product
    in the backward (10 hd a pair against 8), so the totals differ by
    that alone: under 2% here, where attention is a tenth of the work."""
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.models.common import ModelConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.train_step import TrainState, make_train_step
    port = SMALL[family]
    cfg, opt = ModelConfig(**port), adamw()
    B, S = 2, 256
    model = init_params(cfg, device="meta")
    state = TrainState(model, opt.init(dict(model.named_parameters())))
    tok = torch.zeros((B, S), dtype=torch.long, device="meta")
    c = analyze(make_train_step(cfg, opt),
                (state, {"tokens": tok, "labels": tok}))
    dense = sum(c.aten_flops.values())
    fwd = c.kernels.get("flash_attention/fwd", {"operations": 0})["operations"]
    bwd = c.kernels.get("flash_attention/bwd", {"operations": 0})["operations"]
    mine = flops.train_step(port, B, S)
    assert mine == dense + 3 * fwd
    total = dense + fwd + bwd
    assert abs(mine - total) / total < 0.02
