"""Tensor-parallel arithmetic over the ``model`` axis, in one process.

Each layer's tensor-parallel form (models/common.py ``tp_enter`` /
``tp_exit`` / ``realign_pairs``, the vocabulary-parallel cross entropy and
lookup, SwiGLU, GQA attention with split and with whole KV heads, mamba1;
qwen2-vl's M-RoPE with q/k/v biases and hubert's non-causal attention,
MLA, ``moe_dense`` over padded experts and skewed routing with its shared
experts, mamba2's SSD and naive forms with the split gated norm) runs on
m ranks played by m threads of this process: a mesh stand-in gives
each thread its rank on a one-axis ``model`` mesh, and the collectives the
layers call (``all_reduce``, ``all_gather``, ``all_to_all_single``) are
exchanged between the threads.  Each is held against the one-device
function of the port on the same whole inputs (seeded numpy), outputs and
the gradients of every input and weight (each rank's gradient of a whole
weight is the whole gradient; of a block, its block).  Tolerance: 1e-5
relative and 1e-5 max(1, max |.|) absolute in f32 (the same products,
summed over the ranks' partial sums in another order); the lookup is
exact.  Each family's one-device layer is also held to the reference's
JAX function on the reference's weights (models/weights.py), at
tests/torch_model_oracle.py's tolerance.

Then the realignment plan of mamba1's ``in_proj`` (m = 2 and 4) alone,
and dry-run traces on a fake 4 x 4 mesh whose per-rank dot FLOPs equal a
count derived by hand from the config (qwen3, deepseek, zamba2 smoke).
The 4-rank gloo group of tests/test_torch_mesh.py runs the whole
tensor-parallel train step.

Serving over the model axis, on the same thread ranks at the same
tolerance, without gradients: each decode form on the rank's blocks of
the weights and of the caches in each layout ``cache_specs`` gives
(``kv_layout``: KV heads split, sequence split, whole) against the
one-device decode (GQA with M-RoPE and biases, a KV group straddling
two ranks and query heads that do not divide the axis; MLA on a split
and a whole latent cache; mamba1 and mamba2; ``moe_gather`` over padded
experts and its shared experts; the expert-parallel decode on the rank's
expert block), the new token written by the rank that holds its
position; then each family's ``prefill`` and three ``decode_step``s
under the serving ``Dist``, the prefill's rows installed by the engine's
``_write_lane``, against the one-device model: the logits, the same on
every rank bit for bit, and the ranks' cache blocks put together.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as torch_dist

from repro_torch.configs import smoke_config
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import layers as LY
from repro_torch.models import mamba as MB
from repro_torch.models.transformer import init_params

TOL = 1e-5


class _Axis:
    """The ranks of one axis, played by threads: each collective is an
    exchange of every rank's contribution."""

    def __init__(self, m: int):
        self.m = m
        self.barrier = threading.Barrier(m)
        self.slots = [None] * m

    def exchange(self, rank: int, value) -> list:
        self.slots[rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _Group(SimpleNamespace):
    pass


class _Mesh:
    """A one-axis ``model`` mesh as ``mesh_axis`` reads it."""
    mesh_dim_names = ("model",)

    def __init__(self, axis: _Axis, rank: int):
        self.group = _Group(axis=axis, rank=rank)

    def get_group(self, dim):
        return self.group

    def size(self, dim=None):
        return self.group.axis.m

    def get_local_rank(self, dim=None):
        return self.group.rank


def _all_reduce(t, op=torch_dist.ReduceOp.SUM, group=None):
    vals = group.axis.exchange(group.rank, t.clone())
    if op == torch_dist.ReduceOp.MAX:
        t.copy_(torch.stack(vals).amax(0))
    else:
        t.copy_(sum(vals[1:], vals[0]))


def _all_gather(parts, t, group=None):
    for p, v in zip(parts, group.axis.exchange(group.rank, t.clone())):
        p.copy_(v)


def _all_to_all_single(out, inp, out_splits=None, in_splits=None,
                       group=None):
    m = group.axis.m
    parts = inp.chunk(m) if in_splits is None else inp.split(list(in_splits))
    sent = group.axis.exchange(group.rank, list(parts))
    got = [sent[j][group.rank] for j in range(m)]
    if out_splits is not None:
        assert [g.shape[0] for g in got] == list(out_splits)
    out.copy_(torch.cat(got))


@pytest.fixture
def threads(monkeypatch):
    """``run(m, fn)``: ``fn(rank)`` on m threads, each with its rank of a
    bound ``model`` axis of m; returns the ranks' results."""
    monkeypatch.setattr(C, "torch_dist", SimpleNamespace(
        all_reduce=_all_reduce, all_gather=_all_gather,
        all_to_all_single=_all_to_all_single, ReduceOp=torch_dist.ReduceOp))

    def run(m: int, fn):
        axis = _Axis(m)

        def one(rank):
            torch.set_num_threads(1)
            with C.manual_axes(_Mesh(axis, rank), ("model",)):
                return fn(rank)

        with ThreadPoolExecutor(m) as pool:
            return list(pool.map(one, range(m)))

    return run


DIST = SimpleNamespace(tensor_parallel=True, model_axis="model",
                       batch_axes=(), active=True, cache_len=0)


def _close(got, want, what: str, tol: float = TOL) -> None:
    got = got.detach().double()
    want = want.detach().double()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * want.abs() + tol * max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    assert bool((err <= bound).all()), f"{what}: {float(err.max()):.3e}"


def _grads(out, cot, inputs: dict) -> dict:
    names = list(inputs)
    gs = torch.autograd.grad((out * cot).sum(), [inputs[n] for n in names],
                             allow_unused=True)
    return {n: torch.zeros_like(inputs[n]) if g is None else g
            for n, g in zip(names, gs)}


def _leaves(arrays: dict) -> dict:
    return {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}


def _block(x: torch.Tensor, m: int, r: int, dim: int) -> torch.Tensor:
    return x.chunk(m, dim)[r]


# --------------------------------------------------------------------------
# the vocabulary-parallel cross entropy and lookup
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", (2, 4))
def test_vocab_parallel_cross_entropy_matches_whole(threads, m):
    rng = np.random.default_rng(m)
    V = 32
    logits = rng.standard_normal((3, 5, V)).astype(np.float32) * 4
    v = V // m
    # labels on every block's edges, and inside
    labels = np.array([[0, v - 1, v, 2 * v - 1, V - 1]] * 3, np.int64)
    labels[1] = rng.integers(0, V, 5)
    cot = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    whole = torch.tensor(logits, requires_grad=True)
    want = LY.softmax_cross_entropy(whole, torch.from_numpy(labels))
    gwant = torch.autograd.grad((want * cot).sum(), whole)[0]

    def rank(r):
        local = torch.tensor(logits[..., r * v:(r + 1) * v],
                             requires_grad=True)
        y = LY.softmax_cross_entropy(local, torch.from_numpy(labels),
                                     "model")
        return y, torch.autograd.grad((y * cot).sum(), local)[0]

    for r, (y, g) in enumerate(threads(m, rank)):
        _close(y, want, f"loss r{r}")
        _close(g, gwant[..., r * v:(r + 1) * v], f"dlogits r{r}")


@pytest.mark.parametrize("m", (2, 4))
def test_vocab_parallel_lookup_matches_whole(threads, m):
    rng = np.random.default_rng(10 + m)
    V, d = 24, 6
    table = rng.standard_normal((V, d)).astype(np.float32)
    v = V // m
    ids = torch.tensor([[0, v - 1, v, V - 1, V - v, 1]])
    cot = torch.from_numpy(rng.standard_normal((1, 6, d)).astype(np.float32))
    whole = torch.tensor(table, requires_grad=True)
    want = LY.embed_lookup(whole, ids, V)
    gwant = torch.autograd.grad((want * cot).sum(), whole)[0]

    def rank(r):
        local = torch.tensor(table[r * v:(r + 1) * v], requires_grad=True)
        y = LY.embed_lookup(local, ids, V, "model")
        return y, torch.autograd.grad((y * cot).sum(), local)[0]

    for r, (y, g) in enumerate(threads(m, rank)):
        assert torch.equal(y, want)
        assert torch.equal(g, gwant[r * v:(r + 1) * v])


def test_vocab_parallel_lookup_raises_beyond_the_vocabulary(threads):
    table = np.ones((8, 2), np.float32)

    def rank(r):
        with pytest.raises(IndexError):
            LY.embed_lookup(torch.tensor(table[r * 4:(r + 1) * 4]),
                            torch.tensor([[1, 8]]), 8, "model")
        return True

    assert threads(2, rank) == [True, True]
    with pytest.raises(IndexError):
        LY.embed_lookup(torch.tensor(table), torch.tensor([[8]]), 8)


# --------------------------------------------------------------------------
# SwiGLU, attention, mamba1: the layer on each rank's block
# --------------------------------------------------------------------------

def _layer_check(threads, m, arrays, fn, dims, x_shape, seed):
    """``fn(weights, x, dist)`` on whole leaves against m ranks on their
    blocks (``dims``: leaf -> the dimension it is split on, or None for a
    leaf every rank holds whole); outputs and gradients."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    whole = _leaves(arrays)
    xw = torch.tensor(x, requires_grad=True)
    want = fn(whole, xw, None)
    cot = torch.from_numpy(
        rng.standard_normal(tuple(want.shape)).astype(np.float32))
    gwant = _grads(want, cot, {"x": xw, **whole})

    def rank(r):
        local = {k: torch.tensor(
            v if dims[k] is None else
            np.ascontiguousarray(np.split(v, m, dims[k])[r]),
            requires_grad=True) for k, v in arrays.items()}
        xl = torch.tensor(x, requires_grad=True)
        y = fn(local, xl, DIST)
        return y, _grads(y, cot, {"x": xl, **local})

    for r, (y, g) in enumerate(threads(m, rank)):
        _close(y, want, f"y r{r}")
        _close(g["x"], gwant["x"], f"dx r{r}")
        for k, d in dims.items():
            w = gwant[k] if d is None else _block(gwant[k], m, r, d)
            _close(g[k], w, f"d{k} r{r}")


@pytest.mark.parametrize("m", (2, 4))
def test_swiglu_tensor_parallel_matches_whole(threads, m):
    rng = np.random.default_rng(m)
    d, ff = 8, 16
    arrays = {k: rng.standard_normal(s).astype(np.float32) / 3
              for k, s in (("gate", (d, ff)), ("up", (d, ff)),
                           ("down", (ff, d)))}

    def fn(w, x, dist):
        name = C.tp_axis(dist)
        return LY.swiglu(x, w["gate"], w["up"], w["down"], name, ff)

    _layer_check(threads, m, arrays, fn, {"gate": 1, "up": 1, "down": 0},
                 (2, 5, d), seed=m)


def _attn_arrays(cfg, seed: int) -> dict:
    p = A.init_attn(cfg, torch.float32,
                    generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    out = {k: v.detach().numpy() for k, v in p.named_parameters()}
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv", "q_scale", "k_scale"):
        if k in out:  # not the init's constants: every gradient counts
            out[k] = out[k] + rng.standard_normal(out[k].shape).astype(
                np.float32) * 0.1
    return out


ATTN_CASES = {  # name: (config overrides, m)
    "split_kv_m2": ({}, 2),                     # 4 heads, 2 KV heads
    "whole_kv_m4": ({}, 4),                     # 2 KV heads on 4 ranks
    "bias_whole_kv_m4": ({"qk_norm": False, "qkv_bias": True,
                          "n_heads": 8, "n_kv_heads": 2}, 4),
    # rank 0 reads KV heads 0-1, rank 1 heads 1-2
    "kv_group_straddles_m2": ({"n_heads": 12, "n_kv_heads": 3}, 2),
    # 6 heads on 4 ranks: the attention runs whole on every rank
    "heads_not_divisible_m4": ({"n_heads": 6, "n_kv_heads": 2}, 4),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_gqa_tensor_parallel_matches_whole(threads, case):
    over, m = ATTN_CASES[case]
    cfg = smoke_config("qwen3-0.6b").scaled(**over)
    arrays = _attn_arrays(cfg, seed=len(case))
    kv = 1 if cfg.n_kv_heads % m == 0 else None
    dims = {"wq": 1, "wo": 0, "wk": kv, "wv": kv, "bq": 0,
            "bk": None if kv is None else 0, "bv": None if kv is None else 0,
            "q_scale": None, "k_scale": None}
    dims = {k: v if cfg.n_heads % m == 0 else None
            for k, v in dims.items() if k in arrays}
    S = 7
    pos = torch.arange(S)[None].expand(2, S)

    def fn(w, x, dist):
        return A.gqa_forward(w, cfg, x, pos, dist)[0]

    _layer_check(threads, m, arrays, fn, dims, (2, S, cfg.d_model),
                 seed=m)


@pytest.mark.parametrize("m", (2, 4))
def test_mamba1_tensor_parallel_matches_whole(threads, m):
    cfg = smoke_config("falcon-mamba-7b")
    p = init_params(cfg, generator=torch.Generator().manual_seed(m),
                    device="cpu").layers[0].mamba
    arrays = {k: v.detach().numpy() for k, v in p.named_parameters()}
    rng = np.random.default_rng(m)
    for k in ("conv_b", "D", "dt_bias"):
        arrays[k] = arrays[k] + rng.standard_normal(arrays[k].shape).astype(
            np.float32) * 0.1
    # in_proj: the rank's contiguous columns of [x | z], as stored
    dims = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "out_proj": 0,
            "D": 0, "x_proj": 0, "dt_proj": 1, "dt_bias": None,
            "A_log": None}

    def fn(w, x, dist):
        return MB.mamba1_seq(w, cfg, x, dist=dist)[0]

    _layer_check(threads, m, arrays, fn, dims, (2, 9, cfg.d_model), seed=7)


# --------------------------------------------------------------------------
# the families split in a later slice: GQA with M-RoPE and biases, the
# encoder's non-causal GQA, MLA, the MoE's experts and shared experts,
# mamba2 with its split norm
# --------------------------------------------------------------------------

def _perturbed(p, keys, seed: int) -> dict:
    """``p``'s leaves as numpy arrays, the init's constants among ``keys``
    moved off their fill so every gradient counts."""
    out = {k: v.detach().numpy().copy() for k, v in p.named_parameters()}
    rng = np.random.default_rng(seed)
    for k in keys:
        if k in out:
            out[k] = out[k] + rng.standard_normal(out[k].shape).astype(
                np.float32) * 0.1
    return out


def _positions(cfg, B: int, S: int) -> torch.Tensor:
    pos = torch.arange(S)[None].expand(B, S)
    return pos[..., None].expand(B, S, 3).contiguous() if cfg.mrope else pos


STUB_ATTN = [("qwen2-vl-72b", 2), ("qwen2-vl-72b", 4),   # KV split, whole
             ("hubert-xlarge", 2), ("hubert-xlarge", 4)]


@pytest.mark.parametrize("arch,m", STUB_ATTN)
def test_stub_gqa_tensor_parallel_matches_whole(threads, arch, m):
    """qwen2-vl's M-RoPE with q/k/v biases (its 2 KV heads split on 2
    ranks, read by each rank's query heads from the whole weights on 4)
    and hubert's non-causal attention, on each rank's heads."""
    cfg = smoke_config(arch)
    arrays = _attn_arrays(cfg, seed=m)
    kv = 1 if cfg.n_kv_heads % m == 0 else None
    dims = {"wq": 1, "wo": 0, "wk": kv, "wv": kv, "bq": 0,
            "bk": None if kv is None else 0, "bv": None if kv is None else 0}
    dims = {k: v for k, v in dims.items() if k in arrays}
    S = 7
    pos = _positions(cfg, 2, S)

    def fn(w, x, dist):
        return A.gqa_forward(w, cfg, x, pos, dist)[0]

    _layer_check(threads, m, arrays, fn, dims, (2, S, cfg.d_model), seed=m)


@pytest.mark.parametrize("m", (2, 4))
def test_mla_tensor_parallel_matches_whole(threads, m):
    """MLA on each rank's heads of ``wq_b``/``wkv_b`` and rows of ``wo``;
    ``wq_a``, ``wkv_a`` and their norms whole on every rank."""
    cfg = smoke_config("deepseek-v3-671b")
    p = A.init_attn(cfg, torch.float32,
                    generator=torch.Generator().manual_seed(m), device="cpu")
    arrays = _perturbed(p, ("q_norm", "kv_norm"), m)
    dims = {"wq_a": None, "q_norm": None, "wq_b": 1, "wkv_a": None,
            "kv_norm": None, "wkv_b": 1, "wo": 0}
    S = 6
    pos = _positions(cfg, 2, S)

    def fn(w, x, dist):
        return A.mla_forward(w, cfg, x, pos, dist)[0]

    _layer_check(threads, m, arrays, fn, dims, (2, S, cfg.d_model), seed=m)


MOE_CASES = {  # name: (arch, config overrides, m, input shift)
    # 6 experts padded to 8: rank 3 of 4 holds the two padded experts
    "padded_m2": ("granite-moe-3b-a800m", {"n_experts": 6,
                                           "expert_shards": 4}, 2, 0.0),
    "padded_m4": ("granite-moe-3b-a800m", {"n_experts": 6,
                                           "expert_shards": 4}, 4, 0.0),
    # the router's column 0 aligned with a shifted input: most tokens
    # route to expert 0, on rank 0
    "skewed_m4": ("granite-moe-3b-a800m", {}, 4, 0.5),
    # the shared expert split over its 48 hidden units
    "shared_m2": ("deepseek-v3-671b", {}, 2, 0.0),
    "shared_m4": ("deepseek-v3-671b", {}, 4, 0.0),
    # 42 shared hidden units on 4 ranks: the shared expert runs whole
    "shared_whole_m4": ("deepseek-v3-671b", {"moe_d_ff": 42}, 4, 0.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_dense_tensor_parallel_matches_whole(threads, case):
    """``moe_dense`` on each rank's block of the (padded) experts over
    all tokens, the router whole, the combine summed over the axis; the
    shared experts split over their hidden units where they divide."""
    from repro_torch.models import moe as MO
    arch, over, m, shift = MOE_CASES[case]
    cfg = smoke_config(arch).scaled(**over)
    p = MO.init_moe(cfg, torch.float32, n_expert_shards=cfg.expert_shards,
                    generator=torch.Generator().manual_seed(m), device="cpu")
    arrays = _perturbed(p, (), m)
    if shift:
        arrays["router"][:, 0] += shift
    sff = cfg.moe_d_ff * cfg.n_shared_experts
    sh = sff and sff % m == 0
    dims = {"router": None, "w_gate": 0, "w_up": 0, "w_down": 0,
            "sh_gate": 1 if sh else None, "sh_up": 1 if sh else None,
            "sh_down": 0 if sh else None}
    dims = {k: v for k, v in dims.items() if k in arrays}

    def fn(w, x, dist):
        return MO.moe_dense(w, cfg, x + shift, C.tp_axis(dist))

    _layer_check(threads, m, arrays, fn, dims, (2, 8, cfg.d_model), seed=m)
    if "padded" in case:  # the padded experts' weights get no gradient
        assert MO.expert_pad(cfg, cfg.expert_shards) > cfg.n_experts


@pytest.mark.parametrize("form", ("ssd", "naive"))
@pytest.mark.parametrize("m", (2, 4))
def test_mamba2_tensor_parallel_matches_whole(threads, m, form):
    """mamba2 on each rank's H/m heads, its gated norm's sum of squares
    summed over the axis; each rank's final state is its heads' block of
    the whole state."""
    cfg = smoke_config("zamba2-1.2b")
    p = init_params(cfg, generator=torch.Generator().manual_seed(m),
                    device="cpu").layers[0].mamba
    arrays = _perturbed(p, ("conv_b", "D", "dt_bias", "A_log",
                            "norm_scale"), m)
    dims = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "bc_proj": None,
            "dt_w": 1, "dt_bias": None, "A_log": None, "D": 0,
            "norm_scale": None, "out_proj": 0}
    seq = MB.mamba2_seq if form == "ssd" else MB.mamba2_seq_naive
    states = {}

    def fn(w, x, dist):
        y, (_, h) = seq(w, cfg, x, dist=dist,
                        **({"chunk": 4} if form == "ssd" else {}))
        states[None if dist is None else C.axis_index("model")] = h
        return y

    _layer_check(threads, m, arrays, fn, dims, (2, 9, cfg.d_model), seed=m)
    H = cfg.ssm_heads
    for r in range(m):
        _close(states[r], states[None][:, r * H // m:(r + 1) * H // m],
               f"state r{r}")


# one layer function of each family the later slice splits, on one device,
# against the reference's on the reference's weights (models/weights.py)
FAMILY_LAYERS = {
    "vlm": ("qwen2-vl-72b", "attn"), "encoder": ("hubert-xlarge", "attn"),
    "moe": ("granite-moe-3b-a800m", "moe"),
    "mla": ("deepseek-v3-671b", "attn"),
    "mla_moe_shared": ("deepseek-v3-671b", "moe"),
    "hybrid": ("zamba2-1.2b", "mamba"),
    "hybrid_shared_block": ("zamba2-1.2b", "shared")}


@pytest.mark.parametrize("family", sorted(FAMILY_LAYERS))
def test_one_device_layer_matches_reference(family):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as RA
    from repro.models import mamba as RMB
    from repro.models import moe as RMO
    from repro_torch.models import moe as MO
    from torch_model_oracle import assert_close, weights

    arch, part = FAMILY_LAYERS[family]
    rcfg, ref, tcfg, params = weights(arch)
    S = 7
    x = np.random.default_rng(5).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    pos = _positions(tcfg, 2, S)
    rpos = jnp.asarray(pos.numpy())
    layer0 = jax.tree.map(lambda a: a[0], ref["layers"])
    if part == "attn":
        fwd = (RA.mla_forward, A.mla_forward) if tcfg.mla \
            else (RA.gqa_forward, A.gqa_forward)
        want = fwd[0](layer0["attn"], rcfg, jnp.asarray(x), rpos)[0]
        got = fwd[1](params.layers[0].attn, tcfg, torch.from_numpy(x),
                     pos)[0]
    elif part == "moe":
        want = RMO.moe_dense(layer0["moe"], rcfg, jnp.asarray(x))
        got = MO.moe_dense(params.layers[0].moe, tcfg, torch.from_numpy(x))
    elif part == "mamba":
        want = RMB.mamba2_seq(layer0["mamba"], rcfg, jnp.asarray(x))[0]
        got = MB.mamba2_seq(params.layers[0].mamba, tcfg,
                            torch.from_numpy(x))[0]
    else:  # the hybrid's weight-shared attention + MLP block
        want = _ref_shared_block(ref["shared"], rcfg, jnp.asarray(x), rpos)
        got = params.shared(tcfg, torch.from_numpy(x), pos)[0]
    assert_close(got, want, family)


def _ref_shared_block(p, cfg, x, positions):
    """The reference's shared block as its hybrid stack applies it
    (src/repro/models/transformer.py, ``_stack_hybrid``): pre-norm GQA
    then a pre-norm SwiGLU MLP, each with its residual."""
    from repro.models import attention as RA
    from repro.models import layers as RL
    h = x + RA.gqa_forward(p["attn"], cfg, RL.rms_norm(x, p["ln1"],
                                                       cfg.norm_eps),
                           positions)[0]
    m = p["mlp"]
    return h + RL.swiglu(RL.rms_norm(h, p["ln2"], cfg.norm_eps),
                         m["gate"], m["up"], m["down"])


@pytest.mark.parametrize("m", (2, 4))
def test_adafactor_on_blocks_matches_whole(threads, monkeypatch, m):
    """Adafactor's update on each rank's blocks (``LeafSplit``: its row
    and column means and the clipping's summed over the ranks that split
    a leaf) against the update of the whole leaves: a stacked leaf split
    on its rows, one split on its columns, a vector split, and a leaf
    given whole; two steps, parameters and factors.  The sums over the
    ranks run in another order, so within TOL."""
    from repro_torch.optim.optimizers import LeafSplit, adafactor
    monkeypatch.setattr(torch_dist, "all_reduce", _all_reduce)
    rng = np.random.default_rng(m)
    shapes = {"layers.0.a": (8, 12), "layers.1.a": (8, 12), "b": (4, 16),
              "v": (16,), "w": (6, 5)}
    split_dim = {"layers.a": 1, "b": 1, "v": 0}   # of the stacked leaf
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    key = {k: k if not k.startswith("layers") else "layers.a"
           for k in shapes}

    def dim_of(k):  # the split dimension of the layer's tensor
        return split_dim[key[k]] - (key[k] == "layers.a")

    opt = adafactor(lr=0.1)
    whole = {k: torch.tensor(v) for k, v in params.items()}
    st = opt.init(whole)
    for g in grads:
        opt.update({k: torch.tensor(v) for k, v in g.items()}, st, whole,
                   torch.tensor(0))

    def rank(r):
        def blk(x, k):
            return torch.tensor(np.ascontiguousarray(
                np.split(x, m, dim_of(k))[r]) if key[k] in split_dim else x)
        local = {k: blk(v, k) for k, v in params.items()}
        ls = opt.init(local)
        group = _Group(axis=C._axis("model")[0].axis, rank=r)
        axes = {kk: [[group] if d == split_dim[kk] else []
                     for d in range(len(shapes[kk if kk != "layers.a"
                                                else "layers.0.a"])
                                    + (kk == "layers.a"))]
                for kk in split_dim}
        whole_shape = {"layers.a": (2, 8, 12), "b": (4, 16), "v": (16,)}
        sp = LeafSplit(axes, whole_shape)
        for g in grads:
            opt.update({k: blk(v, k) for k, v in g.items()}, ls, local,
                       torch.tensor(0), split=sp)
        return local, ls

    for r, (local, ls) in enumerate(threads(m, rank)):
        for k in shapes:
            want = whole[k] if key[k] not in split_dim else \
                whole[k].chunk(m, dim_of(k))[r]
            _close(local[k], want, f"{k} r{r}")
        # the row factor of the column-split leaf is whole on every rank
        _close(ls["f"]["b"]["r"], st["f"]["b"]["r"], f"b.r r{r}")
        _close(ls["f"]["b"]["c"], st["f"]["b"]["c"].chunk(m, -1)[r],
               f"b.c r{r}")


@pytest.mark.parametrize("m", (2, 4))
def test_in_proj_realignment_plan(m):
    """Each rank's contiguous columns of [x | z] (2 m blocks of w), sent
    by ``paired_blocks_plan``, leave rank t with x block t, then z block
    t."""
    w = 3
    cols = np.arange(2 * m * w)
    sent = {}
    for s in range(m):
        order, send, recv = C.paired_blocks_plan(m, s)
        local = cols[s * 2 * w:(s + 1) * 2 * w].reshape(2, w)[order]
        dests = [d for d in range(m) for _ in range(send[d])]
        for block, d in zip(local, dests):
            sent.setdefault(d, []).append((s, block))
        assert sum(send) == sum(recv) == 2
    for t in range(m):
        got = np.concatenate([b for _, b in sorted(sent[t],
                                                   key=lambda e: e[0])])
        xs = cols[t * w:(t + 1) * w]
        zs = cols[m * w + t * w:m * w + (t + 1) * w]
        np.testing.assert_array_equal(got, np.concatenate([xs, zs]))
        _, _, recv = C.paired_blocks_plan(m, t)
        assert [len([1 for s, _ in sent[t] if s == j])
                for j in range(m)] == recv


def test_one_rank_axis_is_the_one_device_function(threads):
    """On a model axis of one rank no layer enters a region: tp_axis is
    None and the results are the one-device ones bit for bit."""
    cfg = smoke_config("qwen3-0.6b")
    arrays = _attn_arrays(cfg, 3)
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(5)[None].expand(2, 5)
    want = A.gqa_forward({k: torch.tensor(v) for k, v in arrays.items()},
                         cfg, x, pos)[0]

    def rank(r):
        assert C.tp_axis(DIST) is None
        return A.gqa_forward({k: torch.tensor(v) for k, v in arrays.items()},
                             cfg, x, pos, DIST)[0]

    assert torch.equal(threads(1, rank)[0], want)


# --------------------------------------------------------------------------
# the dry run on a fake 4 x 4 mesh
# --------------------------------------------------------------------------

def _hand_dot_flops(cfg, batch: int, seq: int, data: int, m: int) -> float:
    """A rank's dot FLOPs of a tensor-parallel train step of the dense
    config, from its dimensions: each projection on the rank's share
    (query heads H / m; the KV heads its query heads read: K / m when they
    split, else the ones a group of H / m query heads spans; the FFN's
    d_ff / m; the head's vocab / m), forward once and backward twice (the
    input's and the weight's gradient)."""
    T = batch // data * seq
    d, hd = cfg.d_model, cfg.hd
    hl = cfg.n_heads // m
    G = cfg.n_heads // cfg.n_kv_heads
    kv = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else -(-hl // G)
    per_layer = (2 * T * d * hd * hl * 2        # q and o
                 + 2 * T * d * hd * kv * 2      # k and v
                 + 2 * T * d * (cfg.d_ff // m) * 3)
    head = 2 * T * d * (cfg.vocab // m)
    return 3.0 * (cfg.n_layers * per_layer + head)


@pytest.mark.parametrize("arch,over", [("qwen3-0.6b", {}),
                                       ("qwen3-0.6b", {"n_kv_heads": 4})])
def test_dry_run_4x4_dot_flops_are_the_hand_count(arch, over):
    from repro_torch.launch import dryrun
    cfg = smoke_config(arch).scaled(**over)
    batch, seq = 8, 16
    rec = dryrun.run_cell(arch, (seq, batch, "train"), False,
                          cfg_override=cfg, mesh=((4, 4), ("data", "model")))
    assert rec["status"] == "ok", rec.get("traceback")
    assert sum(rec["hlo"]["aten_flops"].values()) == \
        _hand_dot_flops(cfg, batch, seq, 4, 4)
    cb = rec["hlo"]["collective_bytes"]
    assert cb["all_reduce"] > 0


def _hand_dot_flops_mla_moe(cfg, batch: int, seq: int, data: int,
                            m: int) -> float:
    """A rank's dot FLOPs of a tensor-parallel train step of deepseek's
    smoke config (MLA, ``moe_dense`` with a shared expert): forward once
    and backward twice for every product whose inputs both take a
    gradient; the gate's combine einsum once more (the one-hot takes
    none).  MLA: ``wq_a`` and ``wkv_a`` whole, ``wq_b``/``wkv_b``/``wo``
    and the score and value products on the rank's H / m heads (torch
    ops, not the kernel); the MoE: the router whole, the E / m experts'
    three products, the combine over them, the shared expert's hidden
    units / m; the head's vocab / m."""
    Bl, T = batch // data, batch // data * seq
    d, hl = cfg.d_model, cfg.n_heads // m
    qk, v = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    attn = (2 * T * d * cfg.q_lora_rank + 2 * T * cfg.q_lora_rank * hl * qk
            + 2 * T * d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            + 2 * T * cfg.kv_lora_rank * hl * (cfg.qk_nope_dim + v)
            + 2 * Bl * hl * seq * seq * (qk + v) + 2 * T * hl * v * d)
    E, el = cfg.n_experts, cfg.n_experts // m
    sff = cfg.moe_d_ff * cfg.n_shared_experts // m
    moe = (3 * 2 * T * d * E                    # the router, f32
           + 2 * 2 * T * cfg.top_k * E          # gates x one-hot
           + 9 * 2 * el * T * d * cfg.moe_d_ff  # the rank's experts
           + 3 * 2 * T * d * el                 # their combine
           + 9 * 2 * T * d * sff)               # the shared expert
    return cfg.n_layers * (3.0 * attn + moe) + 3.0 * 2 * T * d * (
        cfg.vocab // m)


def _hand_dot_flops_hybrid(cfg, batch: int, seq: int, data: int,
                           m: int) -> float:
    """A rank's dot FLOPs of a tensor-parallel train step of zamba2's
    smoke config (one SSD chunk: seq at most its 128): each mamba2 layer
    on the rank's H / m heads (``in_proj``'s 2 d_inner / m columns,
    ``dt_w``'s heads, ``out_proj``'s rows; ``bc_proj`` whole; the chunk's
    C B^T and its products with x; C h0 and the final state, whose
    zero start and unused end take no gradient), the shared block's
    G = n_layers // attn_every invocations as a dense layer (q, k, v, o on
    H / m heads, the attention on the kernel, the MLP's d_ff / m), the
    head's vocab / m."""
    assert seq <= 128
    Bl, T = batch // data, batch // data * seq
    d, n = cfg.d_model, cfg.ssm_state
    hl, dh = cfg.ssm_heads // m, cfg.d_inner // cfg.ssm_heads
    mamba = (3 * 2 * T * d * (2 * cfg.d_inner // m)        # in_proj
             + 3 * 2 * T * d * 2 * n                      # bc_proj
             + 3 * 2 * T * d * hl                         # dt_w
             + 3 * 2 * Bl * seq * seq * n                 # C B^T
             + 3 * 2 * Bl * hl * seq * seq * dh           # M x
             + 2 * 2 * Bl * seq * hl * dh * n             # C h0
             + 2 * Bl * hl * dh * n * seq                 # the final state
             + 3 * 2 * T * (cfg.d_inner // m) * d)        # out_proj
    G = cfg.n_layers // cfg.attn_every
    shared = 3 * (4 * 2 * T * d * (cfg.n_heads // m) * cfg.hd
                  + 3 * 2 * T * d * (cfg.d_ff // m))
    return (cfg.n_layers * mamba + G * shared
            + 3.0 * 2 * T * d * (cfg.vocab // m))


@pytest.mark.parametrize("arch,hand", [
    ("deepseek-v3-671b", _hand_dot_flops_mla_moe),
    ("zamba2-1.2b", _hand_dot_flops_hybrid)])
def test_dry_run_4x4_dot_flops_are_the_hand_count_mla_moe_hybrid(arch,
                                                                 hand):
    """The same on a fake 4 x 4 mesh for MLA with the MoE (deepseek) and
    mamba2 with the shared block (zamba2), smoke configs."""
    from repro_torch.launch import dryrun
    cfg = smoke_config(arch)
    batch, seq = 8, 16
    rec = dryrun.run_cell(arch, (seq, batch, "train"), False,
                          cfg_override=cfg, mesh=((4, 4), ("data", "model")))
    assert rec["status"] == "ok", rec.get("traceback")
    assert sum(rec["hlo"]["aten_flops"].values()) == hand(cfg, batch, seq,
                                                          4, 4)
    assert rec["hlo"]["collective_bytes"]["all_reduce"] > 0


# --------------------------------------------------------------------------
# serving over the model axis: each decode form on the rank's blocks of
# the weights and of the caches (cache_specs' layouts: KV heads split,
# sequence split, whole), then each family's prefill and decode steps
# --------------------------------------------------------------------------

def _serve_dist(cache_len: int):
    """The tensor-parallel serving context of the bound thread rank."""
    from repro_torch.models.transformer import Dist
    mesh = C._BINDINGS.get()[-1][0]
    return Dist(mesh=mesh, batch_axes=(), model_axis="model",
                tensor_parallel=True, cache_len=cache_len)


def _blk(x, m: int, r: int, dim):
    """Rank r's block of ``x`` along ``dim`` (None: the whole)."""
    return x.clone() if dim is None else x.chunk(m, dim)[r].clone()


def _lane_index(B: int, T: int, seed: int) -> torch.Tensor:
    """One cache index a lane, spread over the sequence (each rank's block
    of a split sequence holds some)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.sort(rng.choice(T, B, replace=False)))


GQA_DECODE_CASES = {  # name: (arch, config overrides, m, cache length)
    "heads_m2": ("qwen3-0.6b", {}, 2, 8),          # 2 KV heads on 2
    "seq_m4": ("qwen3-0.6b", {}, 4, 8),            # 2 KV heads on 4
    "whole_m4": ("qwen3-0.6b", {}, 4, 7),          # neither divides
    "mrope_bias_heads_m2": ("qwen2-vl-72b", {}, 2, 8),
    "mrope_bias_seq_m4": ("qwen2-vl-72b", {}, 4, 8),
    "mrope_bias_whole_m4": ("qwen2-vl-72b", {}, 4, 6),
    # rank 0's query heads read KV heads 0-1, rank 1's heads 1-2
    "straddle_whole_m2": ("qwen3-0.6b", {"n_heads": 12, "n_kv_heads": 3},
                          2, 7),
    "straddle_seq_m2": ("qwen3-0.6b", {"n_heads": 12, "n_kv_heads": 3},
                        2, 8),
    # 6 query heads on 4 ranks: each rank scores all of them on its
    # positions, and wo runs whole
    "heads_not_divisible_seq_m4": ("qwen3-0.6b", {"n_heads": 6,
                                                  "n_kv_heads": 2}, 4, 8),
}


@pytest.mark.parametrize("lanes", ("lane_index", "int_index"))
@pytest.mark.parametrize("case", sorted(GQA_DECODE_CASES))
def test_gqa_decode_tensor_parallel_matches_whole(threads, case, lanes):
    """``gqa_decode`` on each rank's heads and its block of the KV cache
    (cache_specs' layout, ``kv_layout``) against the one-device decode on
    the whole weights and caches: the output, and each rank's cache block
    the block of the one-device cache (the new token written by the rank
    that holds its position)."""
    arch, over, m, T = GQA_DECODE_CASES[case]
    cfg = smoke_config(arch).scaled(**over)
    layout = A.kv_layout(cfg, m, T)
    assert layout == case.split("_m")[0].split("_")[-1]
    arrays = _attn_arrays(cfg, seed=m)
    B, K, hd = 3, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(len(case))
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model))
                         .astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((B, T, K, hd))
                          .astype(np.float32))
    cv = torch.from_numpy(rng.standard_normal((B, T, K, hd))
                          .astype(np.float32))
    index = _lane_index(B, T, m) if lanes == "lane_index" else T - 2
    pos = (index[:, None] if lanes == "lane_index"
           else torch.full((B, 1), index))
    if cfg.mrope:
        pos = pos[..., None].expand(B, 1, 3).contiguous()
    whole = {k: torch.tensor(v) for k, v in arrays.items()}
    wk, wv = ck.clone(), cv.clone()
    want, _ = A.gqa_decode(whole, cfg, x, wk, wv, index, pos)
    split = cfg.n_heads % m == 0
    kv = 1 if layout == "heads" else None
    dims = {"wq": 1 if split else None, "wo": 0 if split else None,
            "wk": kv, "wv": kv, "bq": 0 if split else None,
            "bk": kv and 0, "bv": kv and 0, "q_scale": None,
            "k_scale": None}
    cdim = {"heads": 2, "seq": 1, "whole": None}[layout]

    def rank(r):
        local = {k: _blk(whole[k], m, r, dims[k]) for k in whole}
        lk, lv = _blk(ck, m, r, cdim), _blk(cv, m, r, cdim)
        y, _ = A.gqa_decode(local, cfg, x, lk, lv, index, pos,
                            _serve_dist(T))
        return y, lk, lv

    for r, (y, lk, lv) in enumerate(threads(m, rank)):
        _close(y, want, f"y r{r}")
        _close(lk, _blk(wk, m, r, cdim), f"k r{r}")
        _close(lv, _blk(wv, m, r, cdim), f"v r{r}")


@pytest.mark.parametrize("T", (8, 7), ids=("seq", "whole"))
@pytest.mark.parametrize("m", (2, 4))
def test_mla_decode_tensor_parallel_matches_whole(threads, m, T):
    """Absorbed MLA decode on each rank's heads of ``wq_b``/``wkv_b`` and
    rows of ``wo``: against the latent cache split on the sequence (each
    rank scores every head over its positions, the context summed over
    the axis) and against the whole latent cache."""
    cfg = smoke_config("deepseek-v3-671b")
    p = A.init_attn(cfg, torch.float32,
                    generator=torch.Generator().manual_seed(m), device="cpu")
    whole = {k: torch.tensor(v) for k, v in
             _perturbed(p, ("q_norm", "kv_norm"), m).items()}
    B = 3
    rng = np.random.default_rng(T + m)
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model))
                         .astype(np.float32))
    ckv = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.kv_lora_rank)).astype(np.float32))
    kr = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.qk_rope_dim)).astype(np.float32))
    index = _lane_index(B, T, m)
    pos = index[:, None]
    wc, wr = ckv.clone(), kr.clone()
    want, _ = A.mla_decode(whole, cfg, x, wc, wr, index, pos)
    dims = {"wq_a": None, "q_norm": None, "wq_b": 1, "wkv_a": None,
            "kv_norm": None, "wkv_b": 1, "wo": 0}
    cdim = 1 if A.kv_layout(cfg, m, T) == "seq" else None
    assert (cdim == 1) == (T % m == 0)

    def rank(r):
        local = {k: _blk(whole[k], m, r, dims[k]) for k in whole}
        lc, lr = _blk(ckv, m, r, cdim), _blk(kr, m, r, cdim)
        y, _ = A.mla_decode(local, cfg, x, lc, lr, index, pos,
                            _serve_dist(T))
        return y, lc, lr

    for r, (y, lc, lr) in enumerate(threads(m, rank)):
        _close(y, want, f"y r{r}")
        _close(lc, _blk(wc, m, r, cdim), f"ckv r{r}")
        _close(lr, _blk(wr, m, r, cdim), f"krope r{r}")


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("version", (1, 2))
def test_mamba_decode_tensor_parallel_matches_whole(threads, version, m):
    """mamba1's decode step on each rank's channels (``in_proj``'s [x | z]
    block realigned, ``x_proj``'s product summed over the axis) and
    mamba2's on its heads (the gated norm's squares summed over the
    axis): the output and each rank's block of the conv and SSM states."""
    arch = "falcon-mamba-7b" if version == 1 else "zamba2-1.2b"
    cfg = smoke_config(arch)
    p = init_params(cfg, generator=torch.Generator().manual_seed(m),
                    device="cpu").layers[0].mamba
    whole = {k: torch.tensor(v) for k, v in _perturbed(
        p, ("conv_b", "D", "dt_bias", "A_log", "norm_scale"), m).items()}
    if version == 1:
        dims = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "out_proj": 0,
                "D": 0, "x_proj": 0, "dt_proj": 1, "dt_bias": None,
                "A_log": None}
        state = (2, cfg.d_inner, cfg.ssm_state)
        dec = MB.mamba1_decode
    else:
        dims = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "bc_proj": None,
                "dt_w": 1, "dt_bias": None, "A_log": None, "D": 0,
                "norm_scale": None, "out_proj": 0}
        H = cfg.ssm_heads
        state = (2, H, cfg.d_inner // H, cfg.ssm_state)
        dec = MB.mamba2_decode
    rng = np.random.default_rng(version * 10 + m)
    x = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model))
                         .astype(np.float32))
    conv = torch.from_numpy(rng.standard_normal(
        (2, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal(state).astype(np.float32))
    want, (wconv, wh) = dec(whole, cfg, x, conv, h)

    def rank(r):
        local = {k: _blk(whole[k], m, r, dims[k]) for k in whole}
        return dec(local, cfg, x, _blk(conv, m, r, 2), _blk(h, m, r, 1),
                   _serve_dist(8))

    for r, (y, (lconv, lh)) in enumerate(threads(m, rank)):
        _close(y, want, f"y r{r}")
        _close(lconv, _blk(wconv, m, r, 2), f"conv r{r}")
        _close(lh, _blk(wh, m, r, 1), f"ssm r{r}")


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_gather_tensor_parallel_matches_whole(threads, case):
    """``moe_gather`` on each rank's block of the (padded) experts: each
    rank gathers the picks in its block (one outside it weighs zero), the
    router whole, the shared experts split over their hidden units where
    they divide; the combine summed over the axis."""
    from repro_torch.models import moe as MO
    arch, over, m, shift = MOE_CASES[case]
    cfg = smoke_config(arch).scaled(**over)
    p = MO.init_moe(cfg, torch.float32, n_expert_shards=cfg.expert_shards,
                    generator=torch.Generator().manual_seed(m), device="cpu")
    whole = {k: torch.tensor(v) for k, v in _perturbed(p, (), m).items()}
    if shift:
        whole["router"][:, 0] += shift
    sff = cfg.moe_d_ff * cfg.n_shared_experts
    sh = sff and sff % m == 0
    dims = {"router": None, "w_gate": 0, "w_up": 0, "w_down": 0,
            "sh_gate": 1 if sh else None, "sh_up": 1 if sh else None,
            "sh_down": 0 if sh else None}
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)) + shift
    want = MO.moe_gather(whole, cfg, x)

    def rank(r):
        local = {k: _blk(whole[k], m, r, dims[k]) for k in whole}
        return MO.moe_gather(local, cfg, x, "model")

    for r, y in enumerate(threads(m, rank)):
        _close(y, want, f"y r{r}")


@pytest.mark.parametrize("m", (2, 4))
def test_ep_decode_takes_the_ranks_expert_block(threads, m):
    """Under ``moe_mode="ep_a2a"`` the serving ``Dist`` runs the
    expert-parallel decode on each rank's expert block as it is (the
    model axis is manual, so ``shard_map`` splits nothing again): equal to
    ``moe_gather`` on the whole weights at a capacity that drops
    nothing."""
    from repro_torch.models import moe as MO
    from repro_torch.models.transformer import _moe_apply
    cfg = smoke_config("granite-moe-3b-a800m").scaled(
        moe_mode="ep_a2a", expert_shards=4, n_experts=6)
    p = MO.init_moe(cfg, torch.float32, n_expert_shards=4,
                    generator=torch.Generator().manual_seed(m), device="cpu")
    whole = {k: torch.tensor(v) for k, v in _perturbed(p, (), m).items()}
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (5, 1, cfg.d_model)).astype(np.float32))
    want = MO.moe_gather(whole, cfg, x)

    def rank(r):
        local = {k: _blk(whole[k], m, r, 0 if k.startswith("w_") else None)
                 for k in whole}
        with C.manual_axes(C._BINDINGS.get()[-1][0], ("model",)):
            return _moe_apply(local, cfg, x, _serve_dist(8), True)

    for r, y in enumerate(threads(m, rank)):
        _close(y, want, f"y r{r}")


def _rank_model(cfg, params, m: int, r: int):
    """Rank r's model on a (1, m) mesh, as ``shardings.local_model`` makes
    it: a leaf ``param_specs`` places on its layer's split dimension
    (``tp_dims``) is the rank's block, any other leaf whole."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shardings import param_specs, tp_dims
    specs = param_specs(params, MeshShape((1, m)))
    dims = tp_dims(cfg)
    model = init_params(cfg, device="meta")
    for n, p in params.named_parameters():
        md = next((i for i, e in enumerate(specs[n]) if e == "model"), None)
        t = p.detach()
        if md is not None and md == dims.get(n.rpartition(".")[2], -1):
            t = t.chunk(m, md)[r].clone()
        mod, _, leaf = n.rpartition(".")
        model.get_submodule(mod).register_parameter(
            leaf, torch.nn.Parameter(t, requires_grad=False))
    return model


def _cache_dims(cfg, caches: dict, m: int) -> dict:
    """Each lane-cache leaf's dimension split over ``model`` under
    ``cache_specs`` on a (1, m) mesh (None: whole)."""
    from repro_torch.launch.shardings import cache_specs
    specs = cache_specs(cfg, caches, dp_axes=(), model_size=m)
    return {k: next((i for i, e in enumerate(specs[k]) if e == "model"),
                    None) for k in caches}


SERVE_FAMILIES = {  # name: (arch, config overrides, m, cache length)
    "qwen3_heads_m2": ("qwen3-0.6b", {}, 2, 10),
    "qwen3_seq_m4": ("qwen3-0.6b", {}, 4, 12),
    "qwen3_whole_m4": ("qwen3-0.6b", {}, 4, 10),
    "qwen2vl_seq_m4": ("qwen2-vl-72b", {}, 4, 12),   # M-RoPE, biases
    "falcon_m4": ("falcon-mamba-7b", {}, 4, 10),
    "granite_heads_m2": ("granite-moe-3b-a800m", {}, 2, 10),
    "deepseek_seq_m2": ("deepseek-v3-671b", {}, 2, 12),  # MLA's latent
    "deepseek_whole_m4": ("deepseek-v3-671b", {}, 4, 10),
    "zamba2_heads_m2": ("zamba2-1.2b", {}, 2, 10),   # the shared block's
    "zamba2_seq_m4": ("zamba2-1.2b", {"n_kv_heads": 2}, 4, 12),
}


@pytest.mark.parametrize("case", sorted(SERVE_FAMILIES))
def test_serving_prefill_and_decode_on_blocks_match_whole(threads, case):
    """``prefill`` then three ``decode_step``s of each family under the
    serving ``Dist`` on m thread ranks, each on its local weights
    (``_rank_model``) and lane-cache blocks (the prefill's rows, each
    leaf's block as its layer returned it, installed by the engine's
    ``_write_lane``),
    against the one-device model on the whole weights and caches: the
    logits within TOL and the same on every rank bit for bit, and the
    ranks' cache blocks put together the one-device caches within TOL."""
    from repro_torch.core.deploy.engine import _write_lane
    from repro_torch.models import transformer as T_
    arch, over, m, T = SERVE_FAMILIES[case]
    cfg = smoke_config(arch).scaled(**over)
    if cfg.n_heads:
        layout = A.kv_layout(cfg, m, T)
        assert layout in case or not {"heads", "seq", "whole"} & set(
            case.split("_")), (case, layout)
    params = init_params(cfg, generator=torch.Generator().manual_seed(m),
                         device="cpu")
    B, S = 2, 5
    rng = np.random.default_rng(T)
    toks = rng.integers(0, cfg.vocab, (B, S))
    steps = [rng.integers(0, cfg.vocab, (B, 1)) for _ in range(3)]

    def batch(tokens, start):
        pos = torch.arange(start, start + tokens.shape[1])[None].expand(
            B, tokens.shape[1])
        b = {"tokens": torch.from_numpy(tokens), "positions": pos}
        if cfg.mrope:
            b["positions3"] = pos[..., None].expand(pos.shape + (3,))
        return b

    def serve(model, dist, r=None):
        logits, pre = T_.prefill(model, batch(toks, 0), cfg, *dist)
        caches = T_.init_cache(cfg, B, T, device="cpu")
        if r is not None:  # rank r's blocks
            dims = _cache_dims(cfg, caches, m)
            caches = {k: t if dims[k] is None else
                      t.chunk(m, dims[k])[r].clone()
                      for k, t in caches.items()}
        for lane in range(B):
            _write_lane(caches, lane, pre, lane)
        out = [logits]
        for i, tk in enumerate(steps):
            index = torch.full((B,), S + i)
            logits, caches = T_.decode_step(model, batch(tk, S + i), caches,
                                            index, cfg, *dist)
            out.append(logits)
        return out, caches

    want, wcaches = serve(params, ())

    def rank(r):
        return serve(_rank_model(cfg, params, m, r), (_serve_dist(T),), r)

    ranks = threads(m, rank)
    for r, (got, _) in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"logits {i} r{r}")
            assert torch.equal(g, ranks[0][0][i]), f"logits {i} r{r}"
    dims = _cache_dims(cfg, wcaches, m)
    for k, w in wcaches.items():
        d = dims[k]
        got = ranks[0][1][k] if d is None else torch.cat(
            [c[k] for _, c in ranks], d)
        _close(got, w, f"cache {k}")


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "qwen2-vl-72b",
                                  "deepseek-v3-671b", "zamba2-1.2b",
                                  "minicpm-2b"))
def test_kv_layout_is_cache_specs_rule(arch):
    """``kv_layout`` reads the attention caches' placement over ``model``
    as ``cache_specs`` makes it, for axes of 2, 4 and 16 ranks and cache
    lengths that do and do not divide them (production widths)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shardings import cache_specs
    from repro_torch.models.transformer import init_cache
    cfg = get_config(arch)
    want = {None: "whole", 2: "seq", 3: "heads"}
    for m in (2, 4, 16):
        for T in (32, 33, 48, 4096):
            caches = init_cache(cfg, 2, T, device="meta")
            specs = cache_specs(cfg, caches, dp_axes=(), model_size=m)
            key = "ckv" if cfg.mla else "shared_k" if "shared_k" in caches \
                else "k"
            md = next((i for i, e in enumerate(specs[key])
                       if e == "model"), None)
            assert A.kv_layout(cfg, m, T) == want[md], (m, T)
