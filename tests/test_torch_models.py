"""The port's model modules that hold a kernel (``models/layers.py``
rms_norm, ``models/attention.py`` gqa_forward, ``models/mamba.py``
mamba1_seq), its configs, its initializer and its weight converter, against
the reference on the same numpy inputs and weights.

On CPU tensors the kernel wrappers run their plain PyTorch versions; the
reference's model functions are its ``jnp`` code.  Tolerance: |port - ref|
<= 1e-4 + 1e-4 |ref| (largest seen: ~3e-6 on attention outputs, ~1e-6 on
the scan's y and final state).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import mamba as RM
from repro.models import transformer as R
from repro_torch import configs
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as T
from repro_torch.models.layers import Params
from repro_torch.models.weights import params_from_reference, \
    reference_layout
from torch_model_oracle import assert_close, np32


def _params(tree) -> Params:
    """A reference parameter dict as the port's Params (numpy copies)."""
    return Params(**{k: _params(v) if isinstance(v, dict)
                     else torch.from_numpy(np.array(v))
                     for k, v in tree.items()})


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


# --------------------------------------------------------------------------
# rms_norm on the rmsnorm kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 13, 64), (7, 16), (1, 5, 4, 128),
                                   (256, 32)])
def test_rms_norm_matches_reference(shape):
    x, scale = _x(0, *shape), _x(1, shape[-1])
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    assert_close(got, RL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
                 f"rms_norm {shape}")


@pytest.mark.parametrize("rows,want", [(1, 1), (7, 7), (13, 13), (509, 1),
                                       (8144, 16), (256, 128), (384, 128),
                                       (130, 65)])
def test_norm_block_rows_is_largest_divisor_up_to_128(rows, want):
    assert TL.norm_block_rows(rows) == want


# --------------------------------------------------------------------------
# gqa_forward on the flash kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [5, 13, 20])
def test_gqa_forward_matches_reference(S, causal, impl):
    """Prompt lengths that need padding to the tile, causal and not, both
    attn_impl values (blockwise with 16-row tiles: several tiles)."""
    cfg = ref_configs.smoke_config("qwen3-0.6b").scaled(
        causal=causal, attn_impl=impl, attn_block=16)
    tcfg = configs.smoke_config("qwen3-0.6b").scaled(
        causal=causal, attn_impl=impl, attn_block=16)
    p = RA.init_attn(jax.random.PRNGKey(3), cfg, jnp.float32)
    x = _x(4, 2, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S))
    want, (wk, wv) = RA.gqa_forward(p, cfg, jnp.asarray(x), jnp.asarray(pos))
    got, (gk, gv) = TA.gqa_forward(_params(p), tcfg, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()))
    assert_close(got, want, "attention output")
    assert_close(gk, wk, "k")
    assert_close(gv, wv, "v")


@pytest.mark.parametrize("impl,block,S,dtype,want", [
    ("naive", 512, 509, torch.bfloat16, (128, 512)),
    ("naive", 512, 254, torch.bfloat16, (128, 256)),
    ("naive", 512, 5, torch.float32, (16, 16)),
    ("naive", 512, 20, torch.float32, (32, 32)),
    ("blockwise", 512, 509, torch.bfloat16, (256, 512)),
    ("blockwise", 512, 509, torch.float32, (128, 512)),
    ("blockwise", 2048, 4096, torch.bfloat16, (256, 4096)),
    ("blockwise", 256, 64, torch.bfloat16, (64, 64)),
    ("blockwise", 16, 20, torch.float32, (16, 32)),
])
def test_attention_tiles_rule(impl, block, S, dtype, want):
    cfg = configs.get_config("qwen3-0.6b").scaled(attn_impl=impl,
                                                  attn_block=block)
    assert TA.attention_tiles(cfg, S, dtype) == want


def test_attention_tiles_unpadded_when_not_causal():
    cfg = configs.get_config("hubert-xlarge")
    assert TA.attention_tiles(cfg, 20, torch.float32) == (20, 20)
    assert TA.attention_tiles(cfg, 13, torch.float32) == (13, 13)
    assert TA.attention_tiles(cfg, 1000, torch.float32) == (125, 1000)


# --------------------------------------------------------------------------
# mamba1_seq on the scan kernel, with its final state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("L", [7, 64 + 5, 128])
def test_mamba1_seq_y_and_final_state_match_reference(L):
    cfg = ref_configs.smoke_config("falcon-mamba-7b")
    tcfg = configs.smoke_config("falcon-mamba-7b")
    p = RM.init_mamba(jax.random.PRNGKey(5), cfg, jnp.float32)
    x = 0.5 * _x(6, 2, L, cfg.d_model)
    y_r, (tail_r, h_r) = RM.mamba1_seq(p, cfg, jnp.asarray(x))
    y_t, (tail_t, h_t) = TM.mamba1_seq(_params(p), tcfg, torch.from_numpy(x))
    assert h_t.shape == (2, cfg.d_inner, cfg.ssm_state)
    assert h_t.dtype == torch.float32
    assert_close(y_t, y_r, "y")
    assert_close(tail_t, tail_r, "conv tail")
    assert_close(h_t, h_r, "h_final")


def _scan_inputs(Bt, L, D, N, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, L, D)))).astype(np.float32)
    return [torch.from_numpy(a) for a in (
        dt, rng.standard_normal((Bt, L, D), dtype=np.float32),
        -np.exp(0.3 * rng.standard_normal((D, N))).astype(np.float32),
        rng.standard_normal((Bt, L, N), dtype=np.float32),
        rng.standard_normal((Bt, L, N), dtype=np.float32))]


def test_scan_state_is_the_recurrences_last_state():
    dt, x, A, B, C = _scan_inputs(2, 48, 24, 8)
    _, h = mamba_scan(dt, x, A, B, C, chunk=16, return_state=True)
    want = np.zeros((2, 24, 8))
    for t in range(48):
        want = (np.exp(np32(dt)[:, t, :, None] * np32(A)) * want
                + (np32(dt) * np32(x))[:, t, :, None] * np32(B)[:, t, None])
    assert_close(h, want, "h_last")


def test_scan_state_bit_identical_across_chunk():
    dt, x, A, B, C = _scan_inputs(1, 96, 40, 16, seed=1)
    outs = [mamba_scan(dt, x, A, B, C, chunk=c, return_state=True)
            for c in (8, 12, 32, 48, 96)]
    for y, h in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])


def test_scan_zero_dt_tail_pad_changes_nothing():
    """dt = x = B = C = 0 steps after the sequence keep y and the final
    state of the real steps bit for bit (the model's ragged-prompt pad)."""
    dt, x, A, B, C = _scan_inputs(1, 37, 16, 4, seed=2)
    y, h = mamba_scan(dt, x, A, B, C, chunk=37, return_state=True)
    yp, hp = TM.scan_padded(dt, x, A, B, C, chunk=16)
    assert torch.equal(yp, y) and torch.equal(hp, h)


# --------------------------------------------------------------------------
# mamba2: the SSD form against the naive recurrence, both against the ref
# --------------------------------------------------------------------------


@pytest.mark.parametrize("L,chunk", [(12, 4), (13, 128)])
def test_mamba2_forms_match_reference(L, chunk):
    cfg = ref_configs.smoke_config("zamba2-1.2b")
    tcfg = configs.smoke_config("zamba2-1.2b")
    p = RM.init_mamba(jax.random.PRNGKey(7), cfg, jnp.float32)
    x = _x(8, 2, L, cfg.d_model)
    want, (_, h_w) = RM.mamba2_seq(p, cfg, jnp.asarray(x), chunk=chunk)
    for name, got in (
            ("ssd", TM.mamba2_seq(_params(p), tcfg, torch.from_numpy(x),
                                  chunk=chunk)),
            ("naive", TM.mamba2_seq_naive(_params(p), tcfg,
                                          torch.from_numpy(x)))):
        assert_close(got[0], want, name)
        assert_close(got[1][1], h_w, name + " state")


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_equal_reference(arch):
    for getter in ("get_config", "smoke_config"):
        ref = getattr(ref_configs, getter)(arch)
        port = getattr(configs, getter)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert (port.d_inner, port.sub_quadratic) == \
            (ref.d_inner, ref.sub_quadratic)
        if ref.n_heads:
            assert port.hd == ref.hd


def test_registry_tables_equal_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.SHAPES == ref_configs.SHAPES
    assert configs.runnable_cells() == ref_configs.runnable_cells()
    assert configs.get_config("qwen3_0_6b") is configs.get_config("qwen3-0.6b")
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")


# --------------------------------------------------------------------------
# init_params and the weight converter
# --------------------------------------------------------------------------


def _ref_layout(cfg):
    shapes = jax.eval_shape(lambda: R.init_params(cfg,
                                                  jax.random.PRNGKey(0)))
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), shapes)


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_init_params_layout_equals_reference(arch):
    """The port's parameters stand for the reference's tree of shapes and
    dtypes: the smoke config on the CPU and the full config as a
    skeleton."""
    for getter in ("smoke_config", "get_config"):
        cfg = getattr(ref_configs, getter)(arch)
        tcfg = getattr(configs, getter)(arch)
        device = "cpu" if getter == "smoke_config" else "meta"
        assert reference_layout(T.init_params(tcfg, device=device)) == \
            _ref_layout(cfg)


def test_init_params_repeats_for_a_seed_and_draws_at_fan_in_scale():
    cfg = configs.smoke_config("qwen3-0.6b").scaled(d_model=256, d_ff=512)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return dict(T.init_params(cfg, generator=g,
                                  device="cpu").named_parameters())

    a, b, c = draw(1), draw(1), draw(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    fan_in = {"embed": 256, "out": 256, "layers.0.attn.wq": 256,
              "layers.0.attn.wk": 256, "layers.0.attn.wo": cfg.n_heads,
              "layers.1.mlp.gate": 256, "layers.1.mlp.down": 512}
    for name, n in fan_in.items():
        std = float(a[name].std())
        assert abs(std * np.sqrt(n) - 1.0) < 0.1, (name, std)
    assert torch.equal(a["layers.0.ln1"], torch.ones(256))
    assert torch.equal(a["layers.0.attn.q_scale"], torch.ones(16))


def test_init_params_mamba_constants():
    cfg = configs.smoke_config("falcon-mamba-7b")
    p = dict(T.init_params(cfg, device="cpu").named_parameters())
    want = np.log(np.arange(1, cfg.ssm_state + 1, dtype=np.float32))
    assert np.allclose(np32(p["layers.0.mamba.A_log"][5]), want, rtol=0,
                       atol=1e-6)
    assert torch.equal(p["layers.2.mamba.D"], torch.ones(cfg.d_inner))
    assert p["layers.0.mamba.in_proj"].shape == (64, 256)


def _ref_tree(arch):
    cfg = ref_configs.smoke_config(arch)
    return jax.tree.map(np.asarray, R.init_params(cfg, jax.random.PRNGKey(0)))


def test_params_from_reference_copies_every_leaf():
    arch = "zamba2-1.2b"
    tree, tcfg = _ref_tree(arch), configs.smoke_config(arch)
    params = params_from_reference(tree, tcfg, "cpu")
    got = dict(params.named_parameters())
    assert np.array_equal(np32(got["layers.3.mamba.in_proj"]),
                          tree["layers"]["mamba"]["in_proj"][3])
    assert np.array_equal(np32(got["shared.attn.wq"]),
                          tree["shared"]["attn"]["wq"])
    assert all(p.requires_grad for p in params.parameters())


@pytest.mark.parametrize("fault", ["shape", "dtype", "missing", "extra",
                                   "unstacked"])
def test_params_from_reference_rejects_a_wrong_tree(fault):
    tree, tcfg = _ref_tree("qwen3-0.6b"), configs.smoke_config("qwen3-0.6b")
    attn = tree["layers"]["attn"]
    if fault == "shape":
        attn["wq"] = attn["wq"][:, :-1]
    elif fault == "dtype":
        attn["wq"] = attn["wq"].astype(np.float16)
    elif fault == "missing":
        del attn["k_scale"]
    elif fault == "extra":
        attn["bq"] = np.zeros((2, 4, 16), np.float32)
    else:
        tree["ln_f"] = np.stack([tree["ln_f"]] * 2)
    with pytest.raises(ValueError):
        params_from_reference(tree, tcfg, "cpu")


def test_params_from_reference_takes_bfloat16():
    cfg = ref_configs.smoke_config("qwen3-0.6b").scaled(dtype="bfloat16")
    tcfg = configs.smoke_config("qwen3-0.6b").scaled(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, R.init_params(cfg,
                                                  jax.random.PRNGKey(0)))
    params = params_from_reference(tree, tcfg, "cpu")
    assert params.embed.dtype == torch.bfloat16
    assert np.array_equal(np32(params.embed),
                          tree["embed"].astype(np.float32))
