"""The mesh against the reference, on the CPU: sharding rules, the int8
compressed all-reduce, the expert-parallel MoE, the sharded and the
compressed train steps, elastic checkpoints and ``launch.train --mesh
smoke --device cpu``.

Single-process checks hold the port's rules (``_fit``, ``param_specs``,
``batch_specs``, ``cache_specs``, ``mesh_axes``) to the reference's on
fake mesh geometry, over the cases of tests/test_shardings.py and every
config's full-width parameter shapes (built on the meta device and by
``jax.eval_shape``; nothing is allocated): the specs are equal.

Multi-rank checks run in ONE group of four gloo ranks for the module
(``group``: tests/test_torch_mesh_ranks.py, started by ``launch_ranks`` with a
``file://`` rendezvous under the module's temporary directory, one thread
a rank, killed on failure or after ``GROUP_TIMEOUT`` seconds), which
writes its results to files that the parametrised cases read.  The
reference's collectives run under a named ``jax.vmap`` axis on one CPU
device (its own multi-device tests fork 8 host devices and are ``slow``).
Tolerances, each stated where it is used:

* int8 payloads and scales: equal; the reduced f32 values: 1e-6;
* expert-parallel outputs against the reference's ``moe_ep_a2a`` under
  ``vmap``: 1e-5 absolute in f32, drop masks equal; their gradients
  (sums over up to 256 tokens) 1e-5 of the largest, or 1e-5 absolute
  below 1;
* the sharded step against the reference's single-device step: loss and
  parameters within the reference's own 1e-4 (tests/test_distributed.py),
  every gradient within 1e-3 |ref| + 1e-4 max |ref| (probes: ~1e-7);
* the tensor-parallel step (qwen3-0.6b and falcon-mamba-7b smoke on
  (2, 2) and (1, 4); qwen2-vl-72b, hubert-xlarge, granite-moe-3b-a800m
  and zamba2-1.2b on (2, 2); granite's expert-parallel branch,
  deepseek-v3-671b and zamba2 checkpointed on (1, 4); f32, one AdamW
  step) against the port's unsharded step:
  loss, gradient norm and every parameter within 1e-5 relative and 1e-5
  max(1, max |.|) absolute; its loss against the reference's one-device
  loss within 1e-5 + 1e-5 |ref|; no covered leaf gathered over ``model``;
* the compressed step against the exact step: the loss within 1e-3, each
  parameter within 0.05 of its largest value (the reference's), the
  residual x - deq exactly;
* a checkpoint written from (2, 2) and restored onto (4, 1): bit for bit;
* the router's replicas on submeshes of (2, 2) and (4, 1), and one
  replica serving on its blocks over (1, 4) (qwen3-0.6b's caches split on
  the sequence, and whole; falcon-mamba-7b; deepseek-v3-671b) and (2, 2)
  (lanes over the data axis: qwen3-0.6b, granite-moe-3b-a800m,
  zamba2-1.2b): greedy f32 tokens equal, exactly, to the port's unmeshed
  router's (in the ranks) and to the reference's ``Router`` (computed here
  while the ranks run), with and without a failover; no parameter
  gathered over ``model`` while the router steps; each rank's block of
  every parameter exactly its block of the whole tensor, and of every
  lane cache after the replay, exactly where the submesh's model axis has
  one rank and within 1e-5 |ref| + 1e-5 max(1, max |ref|) where it has
  more (the split layers' sums run in another order).
"""

from __future__ import annotations

import functools
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.core.deploy import router as RR
from repro.core.liveloop.traces import synthesize as ref_synthesize
from repro.launch import shardings as RS
from repro.launch.mesh import make_smoke_mesh as ref_make_smoke_mesh
from repro.launch.mesh import mesh_axes as ref_mesh_axes
from repro.models import moe as RM
from repro.models import transformer as R
from repro.models.common import ModelConfig as RefConfig
from repro.optim import grad_compress as RG
from repro.optim.optimizers import adafactor as ref_adafactor
from repro.optim.optimizers import adamw as ref_adamw
from repro.optim.optimizers import sgd_momentum as ref_sgd
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.deploy import router as PR
from repro_torch.core.liveloop.traces import synthesize
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import (MeshShape, launch_ranks,
                                     make_smoke_mesh, mesh_axes,
                                     production_mesh_shape)
from repro_torch.models import transformer as T
from repro_torch.models.weights import reference_key
from repro_torch.optim import adafactor, adamw, quantize_int8
from torch_model_oracle import batch

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 300.0


# --------------------------------------------------------------------------
# rules on fake geometry (one process)
# --------------------------------------------------------------------------

class FakeMesh:
    """The reference's fake mesh geometry (tests/test_shardings.py)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


GEOMETRIES = {"16x16": ((16, 16), ("data", "model"), ("data",)),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"),
                          ("pod", "data")),
              "2x2": ((2, 2), ("data", "model"), ("data",))}

FIT_CASES = [  # tests/test_shardings.py's, and a relocation onto a layer
    (("fsdp", "model"), (4096, 8192), 16, 16, True),
    (("model", "fsdp", None), (61, 256, 7168, 2048), 16, 16, True),
    ((None, "model"), (2304, 36), 16, 16, True),
    (("fsdp", "model", None), (2304, 36, 64), 16, 16, False),
    (("fsdp", "model"), (64, 128), 16, 16, True),
    (("fsdp", "model"), (8192, 8192), 16, 16, True),
    (("model",), (32, 36), 4, 16, True),
]


@pytest.mark.parametrize("case", range(len(FIT_CASES)))
def test_fit_matches_reference(case):
    intent, shape, dp, mdl, relocate = FIT_CASES[case]
    args = (intent, shape, ("data",), "model", dp, mdl)
    want = RS._fit(*args, allow_relocate=relocate)
    got = S._fit(*args, allow_relocate=relocate)
    assert tuple(got) == tuple(want), (got, want)


def test_no_relocate_and_rules_are_the_reference():
    assert S._NO_RELOCATE == RS._NO_RELOCATE
    assert S._RULES == RS._RULES


def _flat_port(tree, prefix=""):
    """A spec tree's leaves under dotted keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _ref_specs_flat(tree):
    return {k: tuple(v) for k, v in _flat_port(tree).items()}


def _compare_specs(port: dict, ref: dict) -> set:
    """Every port spec against the reference's leaf spec (a layer's tensor
    against its stacked leaf, less the layer entry, which must be None);
    returns the reference leaves compared."""
    seen = set()
    for name, spec in _flat_port(port).items():
        parts = name.split(".")
        at = next((i + 1 for i in range(len(parts) - 1)
                   if parts[i] == "layers" and parts[i + 1].isdigit()), None)
        key = ".".join(parts[:at] + parts[at + 1:]) if at else name
        want = ref[key]
        if at and want:  # P() (no rule) is P() for a layer's tensor too
            assert want[0] is None, (name, want)
            want = want[1:]
        assert tuple(spec) == want, (name, spec, want)
        seen.add(key)
    return seen


@functools.lru_cache(maxsize=None)
def _full_width(arch: str):
    """The reference's full-width parameter and optimizer-state shapes
    (``jax.eval_shape``) and the port's (the meta device)."""
    ref = jax.eval_shape(lambda: R.init_params(ref_get_config(arch),
                                               jax.random.PRNGKey(0)))
    port = T.init_params(get_config(arch), device="meta")
    named = dict(port.named_parameters())
    return ref, port, [(jax.eval_shape(ref_opt().init, ref), opt().init(named))
                       for ref_opt, opt in ((ref_adafactor, adafactor),
                                            (ref_adamw, adamw))]


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_full_width_match_reference(arch, geometry):
    """Parameters, AdamW's moments and Adafactor's factored moments of the
    full-width config, from shapes alone."""
    shape, names, dp_axes = GEOMETRIES[geometry]
    fake, geo = FakeMesh(shape, names), MeshShape(shape, names)
    ref_params, port_params, states = _full_width(arch)
    for fsdp in (True, False):
        want = _ref_specs_flat(RS.param_specs(ref_params, fake, dp_axes,
                                              fsdp=fsdp))
        got = S.param_specs(port_params, geo, dp_axes, fsdp=fsdp)
        assert _compare_specs(got, want) == set(want)
    for ref_state, port_state in states:
        want = _ref_specs_flat(RS.param_specs(ref_state, fake, dp_axes))
        got = S.param_specs(port_state, geo, dp_axes)
        assert _compare_specs(got, want) == set(want)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("arch", ("qwen3-0.6b", "deepseek-v3-671b",
                                  "zamba2-1.2b", "falcon-mamba-7b",
                                  "granite-moe-3b-a800m"))
def test_batch_and_cache_specs_match_reference(arch, geometry):
    shape, names, dp_axes = GEOMETRIES[geometry]
    rcfg = ref_get_config(arch)
    dp = int(np.prod(shape[:-1]))
    caches = jax.eval_shape(lambda: R.init_cache(rcfg, 32, 1024))
    for b in (32, 3):
        shapes = {"tokens": jax.ShapeDtypeStruct((b, 128), jnp.int32),
                  "labels": jax.ShapeDtypeStruct((b, 128), jnp.int32)}
        want = RS.batch_specs(rcfg, shapes, dp_axes, dp_size=dp)
        got = S.batch_specs(get_config(arch), shapes, dp_axes, dp_size=dp)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    want = RS.cache_specs(rcfg, caches, dp_axes, dp_size=dp,
                          model_size=shape[-1])
    got = S.cache_specs(get_config(arch), caches, dp_axes, dp_size=dp,
                        model_size=shape[-1])
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_mesh_axes_and_production_shape(geometry):
    shape, names, dp_axes = GEOMETRIES[geometry]
    want = ref_mesh_axes(FakeMesh(shape, names))
    assert mesh_axes(MeshShape(shape, names)) == want == (dp_axes, "model")
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    geo = MeshShape((2, 2, 2), ("pod", "data", "model"))
    sh = S.to_shardings(geo, {"w": S.P(("pod", "data"), "model")})["w"]
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert S.NamedSharding(geo, S.P()).placements == (Replicate(),) * 3


def test_smoke_mesh_on_cuda_names_the_devices_it_needs():
    if torch.cuda.device_count() >= 4:
        pytest.skip("this host has the four GPUs")
    with pytest.raises(ValueError, match="needs 4 CUDA devices"):
        make_smoke_mesh(2, 2, device_type="cuda")


@pytest.mark.parametrize("seed", range(4))
def test_quantize_int8_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((7, 33)).astype(np.float32) * 10 ** (seed - 2)
    x[0, :3] = [0.5, -1.5, 2.5]  # ties round to even
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = RG.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.dtype == torch.float32 and float(s) == float(rs)


# --------------------------------------------------------------------------
# the group: inputs, the reference's results, one spawn
# --------------------------------------------------------------------------

EP_CFG = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab=64, n_experts=6, top_k=2,
              moe_d_ff=48, n_shared_experts=1)
EP_CASES = [  # name, n_experts, tokens, capacity factor, decode, skewed
    ("cf8", 6, 16, 8.0, False, False),
    ("skew", 6, 256, 1.25, False, True),
    ("decode", 8, 6, 8.0, True, False),
]
STEPS = [  # name, arch, overrides, mesh, optimizer, capacity factor
    ("qwen3_sgd_2x2", "qwen3-0.6b", {}, "2x2", "sgd", None),
    ("qwen3_adafactor_2x2", "qwen3-0.6b", {}, "2x2", "adafactor", None),
    # the gradients placed without FSDP, then brought to the parameters'
    ("qwen3_sgd_2x2_gradsh", "qwen3-0.6b", {}, "2x2", "sgd", None),
    ("granite_sgd_2x2", "granite-moe-3b-a800m",
     {"moe_mode": "ep_a2a", "expert_shards": 4}, "2x2", "sgd", 8.0),
    ("granite_sgd_1x4", "granite-moe-3b-a800m",
     {"moe_mode": "ep_a2a", "expert_shards": 4}, "1x4", "sgd", 8.0),
    # tensor-parallel arithmetic over "model": (2, 2) splits qwen3's 2 KV
    # heads, (1, 4) leaves them whole (each rank reads its query heads'
    # KV head); AdamW at lr 1e-4 (test_tp_step_matches_unsharded_step)
    *[(f"{arch.split('-')[0]}_adamw_{mesh}", arch, {}, mesh, "adamw4", None)
      for arch in ("qwen3-0.6b", "falcon-mamba-7b") for mesh in ("2x2", "1x4")],
    # the same with each layer checkpointed: its collectives run again in
    # the backward
    ("qwen3_adamw_remat_1x4", "qwen3-0.6b", {"remat": "full"}, "1x4",
     "adamw4", None),
    ("falcon_adamw_remat_2x2", "falcon-mamba-7b", {"remat": "full"}, "2x2",
     "adamw4", None),
    # every other family on its blocks: the vision and audio stubs (M-RoPE
    # with biases; non-causal attention on embeddings), the MoE's experts
    # (moe_dense; and the expert-parallel branch on the rank's expert
    # block, a capacity that drops nothing), MLA with the shared expert,
    # mamba2 with the hybrid's shared block (and each group checkpointed)
    ("qwen2vl_adamw_2x2", "qwen2-vl-72b", {}, "2x2", "adamw4", None),
    ("hubert_adamw_2x2", "hubert-xlarge", {}, "2x2", "adamw4", None),
    ("granite_adamw_2x2", "granite-moe-3b-a800m", {}, "2x2", "adamw4", None),
    ("granite_adamw_ep_1x4", "granite-moe-3b-a800m",
     {"moe_mode": "ep_a2a", "expert_shards": 4}, "1x4", "adamw4", 8.0),
    ("deepseek_adamw_1x4", "deepseek-v3-671b", {}, "1x4", "adamw4", None),
    ("zamba2_adamw_2x2", "zamba2-1.2b", {}, "2x2", "adamw4", None),
    ("zamba2_adamw_remat_1x4", "zamba2-1.2b", {"remat": "full"}, "1x4",
     "adamw4", None),
]
TP_STEPS = [s[0] for s in STEPS if s[4] == "adamw4"]
# the tensor-parallel runs' AdamW eps: AdamW's first update of an element
# is lr g / (|g| + eps), whose change with g is at most lr / eps, so at
# eps 1e-6 gradients that agree within 1e-7 (other orders of the same f32
# sums) give parameters within 1e-5 lr / 1e-4 = the bound; at the default
# 1e-8 an element whose gradient cancels to about eps takes noise of up
# to lr (zamba2's shared.attn.wk: 2.2e-9, the sum of two batch halves of
# +-0.01108, 3.4e-9 with the batch's rows permuted on one device).  A sign
# error still moves a parameter by 2 lr.
ADAMW_EPS = 1e-6
COMPRESSED = ("qwen3_compress_4x1", "qwen3-0.6b", "4x1")
CLI_ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "4", "--seq", "16", "--log-every", "1"]
REF_OPTS = {"sgd": lambda: ref_sgd(lr=0.1),
            "sgd05": lambda: ref_sgd(lr=0.05),
            "adafactor": lambda: ref_adafactor(),
            "adamw4": lambda: ref_adamw(lr=1e-4, eps=ADAMW_EPS)}
# the router's replicas on submeshes: (mesh, replicas) splits, and the
# cases (arch, mesh, replicas, the tick replica 0 is killed at or -1) over
# one trace and serving plan
ROUTER_GEOMETRY = (("2x2", 1), ("2x2", 2), ("4x1", 4))
ROUTER_TRACE = {"scenario": "bursty", "n_requests": 8, "max_prompt": 4,
                "gen": 4, "seed": 0}
ROUTER_GENOME = {"max_slots": 2, "prefill_chunk": 2}
ROUTER_KILL_AT = 3
ROUTER_CASES = [(f"{arch.split('-')[0]}_{mesh}_{'kill' if kill else 'live'}",
                 arch, mesh, replicas, ROUTER_KILL_AT if kill else -1)
                for arch in ("qwen3-0.6b", "falcon-mamba-7b")
                for mesh, replicas in (("2x2", 2), ("4x1", 4))
                for kill in (False, True)] + [
    # one replica over the whole mesh, serving on its blocks: on (1, 4)
    # qwen3's 2 KV heads do not divide the model axis, so its caches split
    # on the sequence (max_len 8) or stay whole (the trace's 6); on (2, 2)
    # the lanes split over the data axis and the KV heads over model; each
    # other family on its blocks (MLA's latent caches on the sequence)
    ("qwen3_1x4_seq", "qwen3-0.6b", "1x4", 1, -1),
    ("qwen3_1x4_whole", "qwen3-0.6b", "1x4", 1, -1),
    ("qwen3_2x2_lanes", "qwen3-0.6b", "2x2", 1, -1),
    ("falcon_1x4", "falcon-mamba-7b", "1x4", 1, -1),
    ("granite_2x2", "granite-moe-3b-a800m", "2x2", 1, -1),
    ("deepseek_1x4", "deepseek-v3-671b", "1x4", 1, -1),
    ("zamba2_2x2", "zamba2-1.2b", "2x2", 1, -1),
]
# a case's max_len where it is not the trace's own (6)
ROUTER_MAX_LEN = {"qwen3_1x4_seq": 8, "deepseek_1x4": 8}
# a fault that rank 1 alone hits mid-step (the second layer of the first
# decode step from tick ROUTER_KILL_AT on) in replica 0 of two on (2, 2)
# (its (1, 2) submesh: ranks 0 and 1), whose groups time out after
# ``timeout`` seconds (``router.FAULT_TIMEOUT``)
ROUTER_FAULT = {"arch": "qwen3-0.6b", "mesh": "2x2", "replicas": 2,
                "rank": 1, "at": ROUTER_KILL_AT, "timeout": 10.0,
                "like": "qwen3_2x2_live"}
ROUTER_CLI = ["--smoke", "--device", "cpu", "--replicas", "2", "--mesh",
              "2x2"]
SERVE_CLI = ROUTER_CLI + ["--requests", "8", "--prompt-len", "8", "--gen",
                          "4"]


def _flat(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _dotted(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _per_layer(flat: dict, name: str) -> np.ndarray:
    parts = name.split(".")
    if parts[0] == "layers":
        return flat["layers." + ".".join(parts[2:])][int(parts[1])]
    return flat[name]


def _ep_inputs(name, n_experts, tokens, cf, decode, skew):
    cfg = RefConfig(**dict(EP_CFG, n_experts=n_experts))
    p = RM.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32,
                    n_expert_shards=4)
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(len(name))
    if skew:  # expert 0 wins most tokens: its capacity drops many
        p["router"] = p["router"].copy()
        p["router"][:, 0] += 2.0 * np.sign(p["router"][:, 0] + 1e-3)
    x = rng.standard_normal((tokens, 32)).astype(np.float32)
    if skew:
        x[:, :] += 0.5 * np.sign(p["router"][:, 0])[None, :]
    cot = rng.standard_normal((tokens, 32)).astype(np.float32)
    return cfg, p, x, cot


def _ep_reference(cfg, p, x, cot, cf, decode):
    """The reference's ``moe_ep_a2a(_decode)`` over 4 ranks as a named
    ``vmap`` axis: outputs, gradients (of sum(y * cot)) and each rank's
    drop mask."""
    axes = {k: 0 if k.startswith("w_") else None for k in p}
    blocks = {k: v.reshape((4, -1) + v.shape[1:]) if k.startswith("w_")
              else v for k, v in p.items()}

    def run(xx, pp):
        if decode:
            f = jax.vmap(lambda pb: RM.moe_ep_a2a_decode(
                pb, cfg, xx, capacity_factor=cf), in_axes=(axes,),
                axis_name="model")
            return f(pp)[0]
        f = jax.vmap(lambda xb, pb: RM.moe_ep_a2a(
            pb, cfg, xb, capacity_factor=cf), in_axes=(0, axes),
            axis_name="model")
        return f(xx.reshape(4, -1, xx.shape[-1]), pp).reshape(xx.shape)

    @jax.jit
    def outputs(xx, pp, dense_p):
        y, vjp = jax.vjp(run, xx, pp)
        return y, vjp(jnp.asarray(cot)), RM.moe_dense(dense_p, cfg, xx[None])[0]

    y, (gx, gp), dense = outputs(jnp.asarray(x), blocks, p)
    gp = {k: np.asarray(v).reshape(p[k].shape) for k, v in gp.items()}
    keeps = []
    if not decode:
        e_pad = p["w_gate"].shape[0]
        for blk in x.reshape(4, -1, x.shape[-1]):
            n = blk.shape[0]
            cap = int(np.ceil(n * cfg.top_k / e_pad * cf / 8.0) * 8)
            w, idx = RM._route(jnp.asarray(blk), p["router"], cfg.n_experts,
                               cfg.top_k)
            keeps.append(np.asarray(RM._dispatch_local(
                jnp.asarray(blk), w, idx, e_pad, cap)[1][2]))
    return {"y": np.asarray(y), "gx": np.asarray(gx), "g": gp,
            "keep": keeps, "dense": np.asarray(dense)}


_REF: dict = {}


def _ref_weights(arch: str, overrides: dict):
    """(reference cfg, its weights as numpy, port cfg) for ``arch``'s
    smoke config with ``overrides``; the reference's ``init_params(cfg,
    PRNGKey(0))``, jitted."""
    key = ("w", arch, json.dumps(overrides, sort_keys=True))
    if key not in _REF:
        cfg = ref_smoke_config(arch).scaled(**overrides)
        tree = jax.jit(lambda: R.init_params(cfg, jax.random.PRNGKey(0)))()
        _REF[key] = (cfg, jax.tree.map(np.asarray, tree),
                     smoke_config(arch).scaled(**overrides))
    return _REF[key]


def _ref_step(arch, overrides, opt_name, b):
    """The reference's single-device step (its ``make_train_step``'s
    arithmetic: ``value_and_grad`` of ``train_loss``, the optimizer's
    update, the f32 gradient norm), each jitted: loss, gradient norm,
    every gradient and every parameter after it."""
    cfg, ref, _ = _ref_weights(arch, overrides)
    done = ("step", arch, json.dumps(overrides, sort_keys=True), opt_name)
    if done in _REF:  # the same reference step for another mesh
        return _REF[done]
    key = ("g", arch, json.dumps(overrides, sort_keys=True))
    if key not in _REF:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        _REF[key] = jax.jit(jax.value_and_grad(
            lambda p, x: R.train_loss(p, x, cfg)))(ref, jb)
    loss, grads = _REF[key]
    opt = REF_OPTS[opt_name]()
    params, _ = jax.jit(lambda g, p: opt.update(g, opt.init(p), p,
                                                jnp.asarray(0)))(grads, ref)
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                         for g in jax.tree.leaves(grads)))
    _REF[done] = {"loss": float(loss), "gnorm": float(gnorm),
                  "grads": _dotted(grads), "params": _dotted(params)}
    return _REF[done]


def _drive(router, trace, kill_at: int) -> int:
    """The router CLI's replay (the ranks' ``drive``)."""
    reqs = trace.requests()
    i = tick = accepted = 0
    while i < len(reqs) or router.busy:
        while i < len(reqs) and trace.items[i].at_tick <= tick:
            accepted += router.try_submit(reqs[i])
            i += 1
        if tick == kill_at and router.n_live > 1:
            router.kill_replica(0)
        router.step()
        tick += 1
    return accepted


@functools.lru_cache(maxsize=None)
def _router_weights(arch: str) -> dict:
    """The reference's tree (numpy, layers stacked) of the port's seeded
    smoke weights of ``arch`` (drawn by torch: quicker than the
    reference's jitted init)."""
    model = T.init_params(smoke_config(arch), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    flat: dict = {}
    for name, p in model.named_parameters():
        key, layer = reference_key(name)
        flat.setdefault(key, {})[layer] = p.detach().numpy()
    tree: dict = {}
    for key, parts in flat.items():
        *path, last = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = parts[None] if None in parts else \
            np.stack([parts[i] for i in range(len(parts))])
    return tree


def _ref_router(arch: str, replicas: int, kill_at: int, mesh=None,
                max_len: int | None = None) -> dict:
    """The reference's router on the case's trace and weights: tokens by
    request and its stats."""
    cfg, tree = ref_smoke_config(arch), _router_weights(arch)
    trace = ref_synthesize(vocab=cfg.vocab, **ROUTER_TRACE)
    router = RR.build_router(cfg, jax.tree.map(jnp.asarray, tree),
                             genome=dict(ROUTER_GENOME, replicas=replicas),
                             max_len=max_len or trace.max_len(), mesh=mesh)
    accepted = _drive(router, trace, kill_at)
    return {"tokens": {r.uid: [int(t) for t in r.tokens]
                       for r in router.completed},
            "stats": router.stats(), "accepted": accepted}


def _ref_routers() -> dict:
    """Each case's reference ``Router`` (no mesh), and one qwen3-0.6b
    replica placed by the reference's ``build_router(mesh=)`` on a (1, 1)
    mesh of the one CPU device."""
    out = {c[0]: _ref_router(c[1], c[3], c[4],
                             max_len=ROUTER_MAX_LEN.get(c[0]))
           for c in ROUTER_CASES}
    out["mesh_1x1"] = _ref_router("qwen3-0.6b", 1, -1,
                                  ref_make_smoke_mesh(1, 1))
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Start the 4-rank group once and return (each rank's results, the
    reference's results, the task directory).  The ranks need only the
    inputs, so the reference's results are computed while they run."""
    d = tmp_path_factory.mktemp("mesh_group")
    arrays, meta = {}, {"ep": {"cfg": EP_CFG, "cases": []}, "steps": [],
                        "cli": CLI_ARGS + ["--mesh", "smoke"],
                        "adamw_eps": ADAMW_EPS}
    ep_inputs, batches = {}, {}
    for name, ne, tokens, cf, decode, skew in EP_CASES:
        cfg, p, x, cot = ep_inputs[name] = _ep_inputs(name, ne, tokens, cf,
                                                      decode, skew)
        arrays.update(_flat(p, f"ep/{name}/p"))
        arrays.update({f"ep/{name}/x": x, f"ep/{name}/cot": cot})
        meta["ep"]["cases"].append({"name": name, "cf": cf,
                                    "decode": decode, "n_experts": ne})
    rng = np.random.default_rng(11)
    arrays["cp/x"] = rng.standard_normal((4, 4, 10)).astype(np.float32)
    arrays["cp/x2"] = rng.standard_normal((4, 4, 10)).astype(np.float32)
    runs = STEPS + [(COMPRESSED[0], COMPRESSED[1], {}, COMPRESSED[2],
                     "sgd05", None)]
    for name, arch, over, mesh, opt, cf in runs:
        wname = re.sub(r"\W", "_", f"{arch}:{json.dumps(over, sort_keys=True)}")
        _, ref_tree, tcfg = _ref_weights(arch, over)
        batches[name] = batch(tcfg, 8, 16, seed=3)
        arrays.update(_flat(ref_tree, f"w/{wname}"))
        arrays.update(_flat(batches[name], f"b/{wname}"))
        meta["steps"].append({"name": name, "arch": arch, "overrides": over,
                              "weights": wname, "batch": wname,
                              "mesh": mesh, "opt": opt, "cf": cf,
                              "grad_shardings": name.endswith("_gradsh"),
                              "tp": name in TP_STEPS,
                              "compress": name == COMPRESSED[0]})
    meta["router"] = {"geometry": ROUTER_GEOMETRY, "trace": ROUTER_TRACE,
                      "genome": ROUTER_GENOME, "cases": [],
                      "cli": {"router": ROUTER_CLI, "serve": SERVE_CLI}}
    for name, arch, mesh, replicas, kill_at in ROUTER_CASES:
        wname = re.sub(r"\W", "_", f"router:{arch}")
        arrays.update(_flat(_router_weights(arch), f"w/{wname}"))
        meta["router"]["cases"].append({
            "name": name, "arch": arch, "weights": wname, "mesh": mesh,
            "replicas": replicas, "kill_at": kill_at,
            "max_len": ROUTER_MAX_LEN.get(name)})
    meta["router"]["fault"] = dict(
        ROUTER_FAULT, weights=re.sub(r"\W", "_",
                                     f"router:{ROUTER_FAULT['arch']}"))
    # the checkpoint's weights and batch: qwen3's own
    q = next(s for s in meta["steps"] if s["arch"] == "qwen3-0.6b")
    for kind in ("w", "b"):
        head = f"{kind}/{q['weights']}/"
        for k in [k for k in arrays if k.startswith(head)]:
            arrays[f"{kind}/qwen3/{k[len(head):]}"] = arrays[k]
    np.savez(d / "task.npz", **arrays)
    (d / "task.json").write_text(json.dumps(meta))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(
            launch_ranks, [str(ROOT / "tests" / "test_torch_mesh_ranks.py"),
                           str(d)], 4, str(d / "init"),
            timeout=GROUP_TIMEOUT, env=env)
        ref = {"ep": {c[0]: _ep_reference(*ep_inputs[c[0]], c[3], c[4])
                      for c in EP_CASES},
               "steps": {r[0]: _ref_step(r[1], r[2], r[4], batches[r[0]])
                         for r in runs},
               "router": _ref_routers()}
        ranks_done.result()
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return ranks, ref, d


# --------------------------------------------------------------------------
# the group's cases
# --------------------------------------------------------------------------

def _close(got, want, tol, what=""):
    err = float(np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(want, np.float64)), initial=0.0))
    assert err <= tol, f"{what}: {err:.3e} > {tol}"
    return err


@pytest.mark.parametrize("mesh", ("2x2", "1x4", "4x1"))
def test_group_mesh_axes(group, mesh):
    ranks, _, _ = group
    shape = tuple(int(s) for s in mesh.split("x"))
    want = ref_mesh_axes(FakeMesh(shape, ("data", "model")))
    for r in ranks:
        batch_axes, model = json.loads(str(r[f"axes/{mesh}"]))
        assert (tuple(batch_axes), model) == want


@pytest.mark.parametrize("case", [c[0] for c in EP_CASES])
def test_ep_outputs_match_reference_under_vmap(group, case):
    ranks, ref, _ = group
    want = ref["ep"][case]
    for r in ranks:  # every rank holds the whole output
        _close(r[f"ep/{case}/y"], want["y"], 1e-5, f"{case} y")
    if case != "skew":  # nothing dropped: the dense oracle too
        _close(ranks[0][f"ep/{case}/y"], want["dense"], 1e-5,
               f"{case} dense")


@pytest.mark.parametrize("case", [c[0] for c in EP_CASES])
def test_ep_gradients_match_reference_under_vmap(group, case):
    ranks, ref, _ = group
    want = ref["ep"][case]
    for r in ranks:  # sums over up to 256 tokens: 1e-5 of the largest
        for k, g in [("x", want["gx"]), *want["g"].items()]:
            got = r[f"ep/{case}/gx"] if k == "x" else r[f"ep/{case}/g/{k}"]
            _close(got, g, 1e-5 * max(1.0, float(np.abs(g).max())),
                   f"{case} d{k}")


@pytest.mark.parametrize("case", [c[0] for c in EP_CASES if not c[4]])
def test_ep_drop_masks_match_reference(group, case):
    ranks, ref, _ = group
    keeps = ref["ep"][case]["keep"]
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r[f"ep/{case}/keep"], keeps[rank])
    dropped = sum(int((~k).sum()) for k in keeps)
    assert (dropped > 0) == (case == "skew"), dropped


def _ref_compressed(v, v2):
    o, r = RG.compressed_psum(v, "d")
    o2, r2 = RG.compressed_psum(v2, "d", r)
    return o, r, o2, r2


def test_compressed_psum_matches_reference_under_vmap(group):
    ranks, _, d = group
    task = np.load(d / "task.npz")
    x, x2 = task["cp/x"], task["cp/x2"]
    o, res, o2, res2 = jax.vmap(_ref_compressed, axis_name="d")(
        jnp.asarray(x), jnp.asarray(x2))
    q, s = jax.vmap(RG.quantize_int8)(jnp.asarray(x))
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["cp/q"], np.asarray(q[rank]))
        assert float(r["cp/scale"]) == float(s[rank])
        _close(r["cp/out"], o[rank], 1e-6, "out")
        _close(r["cp/res"], res[rank], 1e-6, "residual")
        _close(r["cp/out2"], o2[rank], 1e-6, "out after feedback")
        _close(r["cp/res2"], res2[rank], 1e-6, "residual after feedback")
        assert bool(r["cp/res_exact"])
    # not the exact mean: each payload is summed under the mean scale
    assert float(np.abs(np.asarray(o[0]) - x.mean(0)).max()) > 1e-3


def test_compress_tree_psum_matches_reference_under_vmap(group):
    ranks, _, d = group
    task = np.load(d / "task.npz")
    x, x2 = task["cp/x"], task["cp/x2"]
    out, res = jax.vmap(lambda a, b: RG.compress_tree_psum(
        {"a": a, "b": b * 3}, "d"), axis_name="d")(jnp.asarray(x),
                                                  jnp.asarray(x2))
    for rank, r in enumerate(ranks):
        _close(r["cp/tree_a"], out["a"][rank], 1e-6, "a")
        _close(r["cp/tree_b"], out["b"][rank], 1e-6, "b")
        _close(r["cp/tree_res_b"], res["b"][rank], 1e-6, "residual b")


@pytest.mark.parametrize("run", [s[0] for s in STEPS])
def test_sharded_step_matches_single_device(group, run):
    """Loss, gradient norm and every parameter after one step, on every
    rank, against the reference's single-device step."""
    ranks, ref, _ = group
    want = ref["steps"][run]
    for r in ranks:
        _close(r[f"step/{run}/loss"], want["loss"], 1e-4, "loss")
        _close(r[f"step/{run}/gnorm"], want["gnorm"],
               1e-4 * max(1.0, want["gnorm"]), "gnorm")
        names = [k[len(f"step/{run}/param/"):] for k in r
                 if k.startswith(f"step/{run}/param/")]
        assert names
        for n in names:
            _close(r[f"step/{run}/param/{n}"],
                   _per_layer(want["params"], n), 1e-4, n)


@pytest.mark.parametrize("run", [s[0] for s in STEPS])
def test_sharded_gradients_match_single_device(group, run):
    ranks, ref, _ = group
    want = ref["steps"][run]["grads"]
    for r in ranks:
        names = [k[len(f"step/{run}/grad/"):] for k in r
                 if k.startswith(f"step/{run}/grad/")]
        assert len(names) == len(set(names)) > 0
        for n in names:
            w = _per_layer(want, n)
            g = r[f"step/{run}/grad/{n}"]
            assert np.all(np.abs(g - w) <= 1e-3 * np.abs(w)
                          + 1e-4 * float(np.abs(w).max())), n


@pytest.mark.parametrize("run", [s[0] for s in STEPS])
def test_sharded_storage_is_each_ranks_block(group, run):
    """Each parameter's local block is its shape over the mesh axes its
    spec names."""
    ranks, _, _ = group
    name, arch, over, mesh, _, _ = next(s for s in STEPS if s[0] == run)
    shape = tuple(int(s) for s in mesh.split("x"))
    geo = MeshShape(shape)
    tcfg = smoke_config(arch).scaled(**over)
    model = T.init_params(tcfg, device="meta")
    specs = S.param_specs(model, geo, fsdp=tcfg.fsdp)
    sizes = dict(zip(geo.mesh_dim_names, shape))

    def ways(entry) -> int:
        names = (entry,) if isinstance(entry, str) else entry or ()
        return int(np.prod([sizes[a] for a in names]))

    sharded = 0
    for r in ranks:
        local = json.loads(str(r[f"step/{run}/local_shapes"]))
        for n, p in model.named_parameters():
            spec = list(specs[n]) + [None] * (p.dim() - len(specs[n]))
            want = [d // ways(e) for d, e in zip(p.shape, spec)]
            assert local[n] == want, (n, local[n], want)
            sharded += want != list(p.shape)
    assert sharded > 0


def _within(got, want, tol: float, what: str) -> None:
    """|got - want| <= tol |want| + tol max(1, max |want|), elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = tol * np.abs(want) + tol * max(1.0, float(np.abs(want).max(
        initial=0.0)))
    err = np.abs(got - want)
    assert np.all(err <= bound), f"{what}: {float(err.max()):.3e}"


@pytest.mark.parametrize("run", TP_STEPS)
def test_tp_step_matches_unsharded_step(group, run):
    """The tensor-parallel step against the port's unsharded step on the
    same weights and batch, f32: loss, gradient norm and every parameter
    after one AdamW step within 1e-5 relative and 1e-5 max(1, max |.|)
    absolute (other orders of the same sums, over the model axis's
    partial products and the data axis's batch blocks).  The step's lr is
    1e-4, so 1e-5 is a tenth of one step's lr, tests/test_torch_train.py's
    rule for parameters after AdamW steps: AdamW's first update g / (|g| +
    eps) is O(lr) even for an element whose gradient is about eps, so its
    eps is ``ADAMW_EPS`` (1e-6), where a difference of 1e-7 in a gradient
    moves the update by at most a hundredth of lr (at eps 1e-8 zamba2's
    noise-level element moved by 0.46 lr; probes at eps 1e-8: 1.2e-5 at
    lr 1e-3 on (1, 4)'s embed and out, 1.14e-5 at lr 3e-4 on
    falcon-mamba's x_proj)."""
    ranks, _, _ = group
    tag = f"step/{run}"
    for r in ranks:
        _within(r[f"{tag}/loss"], r[f"{tag}/plain/loss"], 1e-5, "loss")
        _within(r[f"{tag}/gnorm"], r[f"{tag}/plain/gnorm"], 1e-5, "gnorm")
        names = [k[len(f"{tag}/plain/param/"):] for k in r
                 if k.startswith(f"{tag}/plain/param/")]
        assert names
        for n in names:
            _within(r[f"{tag}/param/{n}"], r[f"{tag}/plain/param/{n}"], 1e-5,
                    n)


@pytest.mark.parametrize("run", TP_STEPS)
def test_tp_step_gathers_no_covered_leaf_over_model(group, run):
    """A spy on ``DTensor.full_tensor`` and ``redistribute`` over the
    tensor-parallel step: no leaf whose spec puts ``model`` on the
    dimension its layer splits (``TP_DIMS``) is gathered over ``model``
    (here no leaf at all: the smoke configs divide every such dimension),
    while the same spy over ``gather`` of the state sees every covered
    leaf gathered."""
    ranks, _, _ = group
    _, arch, over, mesh, _, _ = next(s for s in STEPS if s[0] == run)
    shape = tuple(int(x) for x in mesh.split("x"))
    model = T.init_params(smoke_config(arch).scaled(**over), device="meta")
    specs = S.param_specs(model, MeshShape(shape))
    covered = {n for n in specs if n.rpartition(".")[2] in S.TP_DIMS
               and S.TP_DIMS[n.rpartition(".")[2]] < len(specs[n])
               and specs[n][S.TP_DIMS[n.rpartition(".")[2]]] == "model"}
    assert covered
    for r in ranks:
        gathered = set(json.loads(str(r[f"step/{run}/gathered_over_model"])))
        assert not gathered & covered, sorted(gathered & covered)
        assert not gathered, sorted(gathered)
        seen = set(json.loads(str(r[f"step/{run}/gathered_by_gather"])))
        assert covered <= seen, sorted(covered - seen)


@pytest.mark.parametrize("run", TP_STEPS)
def test_tp_step_loss_matches_reference_one_device(group, run):
    """The tensor-parallel step's loss against the reference's
    one-device loss on the same weights (``models/weights.py``), at
    tests/test_torch_train.py's tolerance: 1e-5 + 1e-5 |ref|."""
    ranks, ref, _ = group
    want = ref["steps"][run]["loss"]
    for r in ranks:
        assert abs(float(r[f"step/{run}/loss"]) - want) <= 1e-5 + 1e-5 * abs(
            want)


@pytest.mark.parametrize("run", [s[0] for s in STEPS if s[4] == "adafactor"])
def test_adafactor_updates_every_leaf_on_its_blocks(group, run):
    """The sharded Adafactor step updates every group on the rank's
    blocks (its means summed over the mesh), gathering none whole; its
    result is held to the reference's by the tests above."""
    ranks, _, _ = group
    _, arch, over, _, _, _ = next(s for s in STEPS if s[0] == run)
    model = T.init_params(smoke_config(arch).scaled(**over), device="meta")
    groups = {reference_key(n)[0] for n, _ in model.named_parameters()}
    for r in ranks:
        split = set(json.loads(str(r[f"step/{run}/split_groups"])))
        assert split == groups, sorted(groups - split)


def test_compressed_step_close_to_exact(group):
    ranks, ref, _ = group
    run = COMPRESSED[0]
    want = ref["steps"][run]
    for r in ranks:
        _close(r[f"step/{run}/loss"], want["loss"], 1e-3, "loss")
        assert float(r[f"step/{run}/res_err"]) == 0.0
        for k in [k for k in r if k.startswith(f"step/{run}/param/")]:
            n = k[len(f"step/{run}/param/"):]
            w = _per_layer(want["params"], n)
            rel = float(np.abs(r[k] - w).max() / (np.abs(w).max() + 1e-9))
            assert rel < 0.05, (n, rel)


def test_checkpoint_from_2x2_restores_onto_4x1_bit_for_bit(group):
    ranks, _, d = group
    for r in ranks:
        assert bool(r["ckpt/bit_equal"]) and int(r["ckpt/step"]) == 6
    placements = json.loads(str(ranks[0]["ckpt/placements"]))
    assert any("Shard" in v for v in placements.values())
    # the file is the reference's: stacked leaves under its keys
    files = sorted((d / "ckpt").iterdir())
    assert [f.name for f in files] == ["ckpt_6.npz"]
    flat = np.load(files[0])
    assert "['params']['layers']['attn']['wq']" in flat.files
    assert flat["['params']['layers']['attn']['wq']"].shape[0] == 2
    want = ranks[0]["step/qwen3_sgd_2x2/param/embed"].shape
    assert flat["['params']['embed']"].shape == want


def test_train_cli_mesh_smoke_on_the_cpu(group):
    """``launch.train --mesh smoke --device cpu``'s main on each of the
    group's four ranks (the path of every rank the command starts) runs
    3 steps on the 2 x 2 mesh; rank 0 prints them, and every rank's losses
    are the one-device run's within 2e-4 (the data axis's sums in another
    order; probes: ~1e-7)."""
    from repro_torch.launch.train import main
    ranks, _, _ = group
    want = main(CLI_ARGS)["losses"]
    printed = str(ranks[0]["cli/printed"])
    assert "mesh={'data': 2, 'model': 2}" in printed
    assert [float(m) for m in re.findall(r"loss=([0-9.]+)", printed)] == \
        pytest.approx(want, abs=2e-4)
    for r in ranks:
        assert len(r["cli/losses"]) == 3
        assert np.allclose(r["cli/losses"], want, atol=2e-4)
    assert all(str(r["cli/printed"]) == "" for r in ranks[1:])


# --------------------------------------------------------------------------
# the router's replicas on submeshes
# --------------------------------------------------------------------------

def _ranks_json(ranks, key):
    return [json.loads(str(r[key])) for r in ranks]


@pytest.mark.parametrize("mesh,n", ROUTER_GEOMETRY)
def test_replica_meshes_are_the_reference_row_groups(group, monkeypatch,
                                                     mesh, n):
    """Every rank holds every submesh: each is the reference's reshape of
    the mesh's ranks into row groups (its ``Mesh`` stubbed to return the
    group of rank numbers), under the mesh's axis names, and only its own
    ranks have a coordinate in it."""
    ranks, _, _ = group
    shape = tuple(int(s) for s in mesh.split("x"))
    fake = FakeMesh(shape, ("data", "model"))
    fake.devices = np.arange(4).reshape(shape)
    monkeypatch.setattr(jax.sharding, "Mesh", lambda g, names: (g, names))
    want = RR.replica_meshes(fake, n)
    assert len(want) == n
    for rank, subs in enumerate(_ranks_json(ranks, f"router/geo/{mesh}/{n}")):
        assert len(subs) == n
        for (got, coord), (g, names) in zip(subs, want):
            assert names == ("data", "model")
            assert got == g.tolist()
            assert (coord is not None) == (rank in g)


def test_replica_meshes_refuses_a_split_as_the_reference(group):
    ranks, _, _ = group
    fake = FakeMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError) as want:
        RR.replica_meshes(fake, 3)
    assert {str(r["router/geo/error"]) for r in ranks} == {str(want.value)}


def _block_shape(shape, spec, sizes) -> list:
    """``shape`` over the mesh axes ``spec`` names at each dim."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    ways = [int(np.prod([sizes[a] for a in
                         ((e,) if isinstance(e, str) else e or ())]))
            for e in spec]
    return [d // w for d, w in zip(shape, ways)]


@pytest.mark.parametrize("case", [c[0] for c in ROUTER_CASES])
def test_router_storage_is_each_ranks_block(group, case):
    """Each rank holds, of its replica's parameters and lane caches,
    exactly its block under ``param_specs`` / ``cache_specs`` on the
    replica's submesh: the parameters' blocks of the whole weights, the
    caches allocated at build (zeros, the engine's plain tensors over the
    DTensors' memory) and, after the replay, the blocks of the unmeshed
    router's same replica's caches: bit for bit where the submesh's model
    axis has one rank; within 1e-5 |ref| + 1e-5 max(1, max |ref|) where it
    has more (the layers sum their ranks' partial products in another
    order)."""
    ranks, _, _ = group
    _, arch, _, replicas, _ = next(c for c in ROUTER_CASES if c[0] == case)
    tcfg = smoke_config(arch)
    model = T.init_params(tcfg, device="meta")
    max_len = ROUTER_MAX_LEN.get(case) or synthesize(
        vocab=tcfg.vocab, **ROUTER_TRACE).max_len()
    sharded = 0
    for r in ranks:
        own, members, sub_shape = json.loads(str(r[f"router/{case}/submesh"]))
        geo = MeshShape(tuple(sub_shape))
        sizes = dict(zip(geo.mesh_dim_names, geo.shape))
        specs = S.param_specs(model, geo)
        params = json.loads(str(r[f"router/{case}/params"]))
        assert set(params) == {n for n, _ in model.named_parameters()}
        for n, p in model.named_parameters():
            local, equal = params[n]
            want = _block_shape(p.shape, specs[n], sizes)
            assert local == want and equal, (n, local, want)
            sharded += want != list(p.shape)
        caches = T.init_cache(tcfg, ROUTER_GENOME["max_slots"], max_len,
                              device="cpu")
        dp = int(np.prod([sizes[a] for a in ("data",)]))
        cspecs = S.cache_specs(tcfg, caches, dp_size=dp,
                               model_size=sizes["model"])
        at_build = json.loads(str(r[f"router/{case}/caches_at_build"]))
        after = json.loads(str(r[f"router/{case}/caches_after"]))
        assert set(at_build) == set(after) == set(caches)
        for k, t in caches.items():
            local, zeros, shared = at_build[k]
            assert local == _block_shape(t.shape, cspecs[k], sizes) and zeros
            assert shared, k
            exact, within = after[k]
            assert within, k
            assert exact or sizes["model"] > 1, k
        assert len(members) * len(members[0]) * replicas == 4
    assert (sharded > 0) == (replicas < 4)  # a (1, 1) submesh shards none


@pytest.mark.parametrize("case", [c[0] for c in ROUTER_CASES])
def test_router_step_gathers_no_weight_over_model(group, case):
    """While the meshed router replays its trace, no parameter of the
    rank's replica is gathered over ``model`` (a spy on DTensor's
    ``full_tensor`` and ``redistribute``): each tick runs on the local
    blocks made when the router was built."""
    ranks, _, _ = group
    for r in ranks:
        assert json.loads(str(r[f"router/{case}/gathered_over_model"])) == []


def _counts(stats: dict) -> list:
    """Each replica's stats row less its failure's wording."""
    return [{k: v for k, v in row.items() if k != "fail_reason"}
            for row in stats["per_replica"]]


@pytest.mark.parametrize("case", [c[0] for c in ROUTER_CASES])
def test_router_tokens_match_unmeshed_and_reference(group, case):
    """Greedy f32 tokens of the meshed router equal the port's unmeshed
    router's on the same weights and the reference ``Router``'s, through
    a failover where the case kills replica 0; every accepted request
    completes, and ``stats()`` is the same on every rank, its counts the
    unmeshed router's and the reference's."""
    ranks, ref, _ = group
    _, arch, _, replicas, kill_at = next(c for c in ROUTER_CASES
                                         if c[0] == case)
    want = ref["router"][case]
    stats = _ranks_json(ranks, f"router/{case}/stats")
    assert all(s == stats[0] for s in stats)
    for r, st in zip(ranks, stats):
        got = json.loads(str(r[f"router/{case}/tokens"]))
        assert got == json.loads(str(r[f"router/{case}/tokens_plain"]))
        assert got == want["tokens"]
        if arch == "qwen3-0.6b":  # the reference's replica placed on (1, 1)
            assert got == ref["router"]["mesh_1x1"]["tokens"]
        assert (st["n_completed"] == int(r[f"router/{case}/accepted"])
                == want["accepted"] == ROUTER_TRACE["n_requests"])
        plain = json.loads(str(r[f"router/{case}/stats_plain"]))
        for s in (plain, want["stats"]):
            for k in ("n_completed", "n_rejected", "n_requeued",
                      "n_replicas", "n_live", "ticks", "gen_tokens"):
                assert st[k] == s[k], k
            assert _counts(st) == _counts(s)
    assert stats[0]["n_replicas"] == replicas
    if kill_at >= 0:
        assert stats[0]["n_live"] == replicas - 1
        assert stats[0]["n_requeued"] > 0
    else:
        assert all(row["n_completed"] > 0 for row in stats[0]["per_replica"])


def test_router_fails_over_a_fault_on_one_rank_of_a_replica(group):
    """One rank of a replica raises mid-step, between two of the layer's
    collectives, while its peer waits in the second: the replica's groups
    time out (``router.FAULT_TIMEOUT``), the replica fails on
    every rank, its requests are requeued, and the other replica serves
    every accepted request with the greedy tokens of the reference
    ``Router`` that lost no replica; ``stats()`` is the same on every
    rank."""
    ranks, ref, _ = group
    f = ROUTER_FAULT
    raised = [json.loads(str(r["router/fault/raised"])) for r in ranks]
    assert [bool(x) for x in raised] == [i == f["rank"] for i in range(4)]
    assert raised[f["rank"]][0] >= f["at"]
    stats = _ranks_json(ranks, "router/fault/stats")
    assert all(s == stats[0] for s in stats)
    st = stats[0]
    assert st["n_replicas"] == f["replicas"] and st["n_live"] == 1
    assert [row["alive"] for row in st["per_replica"]] == [False, True]
    assert "begin_step" in st["per_replica"][0]["fail_reason"]
    assert st["n_requeued"] > 0, (st, raised)
    for r in ranks:
        assert json.loads(str(r["router/fault/tokens"])) == \
            ref["router"][f["like"]]["tokens"]
        assert (st["n_completed"] == int(r["router/fault/accepted"])
                == ROUTER_TRACE["n_requests"])
        # the peer's wait ended at the groups' timeout, not the default's
        assert f["timeout"] <= float(r["router/fault/seconds"]) \
            < 10 * f["timeout"]


@pytest.mark.parametrize("cli", ("router", "serve"))
def test_serving_clis_mesh_on_the_cpu(group, cli):
    """The router's and ``launch.serve``'s main with ``--mesh 2x2 --device
    cpu`` on each of the group's ranks (the path of every rank the command
    starts): each exits 0, only rank 0 prints, and every accepted request
    completed."""
    ranks, _, _ = group
    assert [int(r[f"cli/{cli}/rc"]) for r in ranks] == [0] * 4
    printed = str(ranks[0][f"cli/{cli}/printed"])
    assert all(str(r[f"cli/{cli}/printed"]) == "" for r in ranks[1:])
    if cli == "router":
        stats = json.loads(printed)
        assert stats["n_completed"] == 8 and stats["n_rejected"] == 0
        assert stats["n_replicas"] == 2 and stats["n_live"] == 2
    else:
        assert "requests=8" in printed and "replicas=2/2" in printed
        assert "mesh={'data': 2, 'model': 2}" in printed


@pytest.mark.parametrize("cli", ("router", "serve"))
def test_serving_clis_refuse_a_split_as_the_reference(cli):
    """In process, with no group: ``--replicas 2 --mesh 1x1`` raises the
    reference's ``ValueError`` before any rank or group starts."""
    from repro_torch.launch.serve import main as serve_main
    with pytest.raises(ValueError) as want:
        RR.replica_meshes(ref_make_smoke_mesh(1, 1), 2)
    main = PR.main if cli == "router" else serve_main
    with pytest.raises(ValueError) as got:
        main(["--smoke", "--device", "cpu", "--replicas", "2", "--mesh",
              "1x1"])
    assert str(got.value) == str(want.value)
    assert not torch.distributed.is_initialized()


def test_router_cli_starts_its_ranks_and_relays_rank_0(monkeypatch, capsys):
    """On the CPU the router CLI starts one rank a device of its mesh
    (here ``launch_ranks`` stands in, so no process starts), prints rank
    0's output and exits 0; a rank that fails makes it exit 1."""
    calls = []

    def ranks(argv, world, init_file, *, timeout, **kw):
        calls.append((argv, world, timeout))
        return ["rank 0 says\n", "", "", ""]
    monkeypatch.delenv("MESH_RANK", raising=False)
    monkeypatch.setattr(M, "launch_ranks", ranks)
    argv = ["--smoke", "--device", "cpu", "--replicas", "2", "--mesh", "2x2"]
    assert PR.main(argv) == 0
    assert calls == [(["-m", "repro_torch.core.deploy.router", *argv], 4,
                      M.MESH_TIMEOUT)]
    assert capsys.readouterr().out == "rank 0 says\n"

    def failing(*a, **kw):
        raise M.RankFailure("rank 2 exited 1")
    monkeypatch.setattr(M, "launch_ranks", failing)
    assert PR.main(argv) == 1
    assert "rank 2 exited 1" in capsys.readouterr().err
