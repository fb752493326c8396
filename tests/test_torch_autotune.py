"""GEVO-Shard (``core/autotune.py``) and ``remat`` in the port, against
the reference.

* The genome machinery: the reference's ``tests/test_autotune.py`` cases,
  run on both packages.
* The search: both packages' ``dryrun.run_cell`` replaced by one
  deterministic fake (a ``hashlib`` digest of the plan, never ``hash()``,
  which varies between processes); a seeded run must give the
  reference's front, best step, trace count and records exactly.
* ``remat="full"``: the loss and every gradient bit for bit against
  ``remat="none"`` on the CPU (the recomputed forward is the same
  arithmetic), and against the reference's ``jax.checkpoint``-ed loss at
  ``tests/test_torch_train.py``'s tolerance: |port - ref| <= 1e-3 |ref| +
  1e-4 max |ref| a leaf.
"""

from __future__ import annotations

import hashlib
import json

import jax
import numpy as np
import pytest

import repro.core.autotune as ref_autotune
import repro.launch.dryrun as ref_dryrun
from repro.configs import get_config as ref_get_config
from repro.models import transformer as R
import repro_torch.core.autotune as port_autotune
import repro_torch.launch.dryrun as port_dryrun
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.deploy.front import ParetoFront
from repro_torch.train.train_step import loss_and_grads
from torch_model_oracle import batch, jnp_batch, weights

PACKAGES = {"reference": (ref_autotune, ref_get_config),
            "port": (port_autotune, get_config)}


# --------------------------------------------------------------------------
# the genome machinery, on both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_default_genome_matches_config(pkg):
    at, get = PACKAGES[pkg]
    cfg = get("qwen2-vl-72b")
    g = at.default_genome(cfg, "train")
    assert g["remat"] == cfg.remat
    assert g["attn_impl"] == cfg.attn_impl
    assert set(g) == set(at.genome_keys("train"))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_inference_genome_drops_train_knobs(pkg):
    at, _ = PACKAGES[pkg]
    keys = at.genome_keys("prefill")
    assert "microbatches" not in keys and "loss_chunk" not in keys
    assert "attn_impl" in keys


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_apply_genome_roundtrip(pkg):
    at, get = PACKAGES[pkg]
    cfg = get("qwen3-0.6b")
    g = at.default_genome(cfg, "train")
    g["attn_impl"] = "blockwise"
    g["microbatches"] = 4
    cfg2, micro = at.apply_genome(cfg, g)
    assert cfg2.attn_impl == "blockwise" and micro == 4
    assert cfg2.d_model == cfg.d_model  # arch untouched


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_genome_space_values_all_applicable(pkg):
    at, get = PACKAGES[pkg]
    cfg = get("minicpm-2b")
    rng = np.random.default_rng(0)
    for _ in range(30):
        g = {k: v[rng.integers(len(v))] for k, v in at.GENOME_SPACE.items()}
        cfg2, micro = at.apply_genome(cfg, g)
        assert cfg2.attn_block in at.GENOME_SPACE["attn_block"]
        assert micro in at.GENOME_SPACE["microbatches"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_mutation_changes_exactly_one_gene(pkg):
    at, get = PACKAGES[pkg]
    s = at.GevoShard.__new__(at.GevoShard)
    s.keys = at.genome_keys("train")
    s.rng = np.random.default_rng(1)
    g = at.default_genome(get("qwen3-0.6b"), "train")
    for _ in range(20):
        m = at.GevoShard._mutate(s, g)
        assert len([k for k in s.keys if m[k] != g[k]]) == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_crossover_genes_come_from_parents(pkg):
    at, get = PACKAGES[pkg]
    s = at.GevoShard.__new__(at.GevoShard)
    s.keys = at.genome_keys("train")
    s.rng = np.random.default_rng(2)
    a = at.default_genome(get("qwen3-0.6b"), "train")
    b = dict(a, remat="full", attn_impl="blockwise", microbatches=2)
    for _ in range(10):
        c = at.GevoShard._crossover(s, a, b)
        for k in s.keys:
            assert c[k] in (a[k], b[k])


def test_genome_machinery_equal_across_packages():
    assert port_autotune.GENOME_SPACE == ref_autotune.GENOME_SPACE
    for kind in ("train", "prefill", "decode"):
        assert port_autotune.genome_keys(kind) == \
            ref_autotune.genome_keys(kind)
    for arch in ARCHS:
        for kind in ("train", "decode"):
            assert port_autotune.default_genome(get_config(arch), kind) == \
                ref_autotune.default_genome(ref_get_config(arch), kind)


# --------------------------------------------------------------------------
# the search, on one deterministic fake dry run
# --------------------------------------------------------------------------

def _fake_run_cell(arch, shape, multi_pod, cfg_override=None,
                   microbatches=1, calls=None):
    bits = (cfg_override.remat, cfg_override.attn_impl,
            cfg_override.attn_block, cfg_override.loss_chunk,
            cfg_override.fsdp, microbatches)
    h = int(hashlib.sha256(repr(bits).encode()).hexdigest()[:8], 16)
    h = (h % 997) / 997
    if calls is not None:
        calls.append(bits)
    if cfg_override.attn_block == 256 and microbatches == 4:
        return {"status": "FAIL", "error": "fake trace failure"}
    return {"status": "ok", "roofline": {"step_s": 1.0 + h},
            "memory": {"temp_size_in_bytes": int((1 - h) * 1e10)},
            "compile_s": 0.0}


def _search(pkg, monkeypatch, seed, islands, tmp_path):
    at, _ = PACKAGES[pkg]
    dr = ref_dryrun if pkg == "reference" else port_dryrun
    calls = []
    monkeypatch.setattr(dr, "run_cell",
                        lambda *a, **k: _fake_run_cell(*a, **k, calls=calls))
    s = at.GevoShard("qwen3-0.6b", "train_4k", pop_size=4, seed=seed,
                     verbose=False, islands=islands,
                     islands_dir=str(tmp_path / pkg) if islands else None)
    return s, s.run(2), calls


@pytest.mark.parametrize("islands", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_search_equals_reference(monkeypatch, tmp_path, seed,
                                        islands):
    ref_s, ref_res, ref_calls = _search("reference", monkeypatch, seed,
                                        islands, tmp_path)
    s, res, calls = _search("port", monkeypatch, seed, islands, tmp_path)
    for key in ("pareto", "best_step", "n_compiles", "baseline"):
        assert res[key] == ref_res[key], key
    assert s.records == ref_s.records
    assert calls == ref_calls
    if not islands:
        assert res["operators"] == ref_res["operators"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_genome_memo_one_trace_per_plan(monkeypatch, tmp_path, pkg):
    s, res, calls = _search(pkg, monkeypatch, 1, 0, tmp_path)
    assert len(calls) == len(set(calls)) == len(s._genome_fits) \
        == res["n_compiles"]


def test_cli_out_is_a_front_deploy_select_loads(monkeypatch, tmp_path,
                                                capsys):
    from repro_torch.core.deploy.__main__ import main as deploy_main
    monkeypatch.setattr(port_dryrun, "run_cell", _fake_run_cell)
    out = tmp_path / "shard.json"
    port_autotune.main(["--arch", "qwen3-0.6b", "--generations", "2",
                        "--pop", "4", "--out", str(out)])
    res = json.loads(out.read_text())
    assert res["pareto"] and res["records"]
    front = ParetoFront.load(str(out))
    assert len(front.members) == len(res["pareto"])
    capsys.readouterr()
    deploy_main(["select", "--front", str(out)])
    assert capsys.readouterr().out.strip()


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_is_bit_for_bit(arch):
    cfg, _, tcfg, params = weights(arch)
    b = batch(cfg, 2, 13 if not cfg.loss_chunk else 4 * cfg.loss_chunk)
    loss0, g0 = loss_and_grads(tcfg, params, b)
    loss1, g1 = loss_and_grads(tcfg.scaled(remat="full"), params, b)
    assert loss0.equal(loss1)
    assert sorted(g0) == sorted(g1)
    for name in g0:
        assert g0[name].equal(g1[name]), name


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _per_layer(flat: dict, name: str) -> np.ndarray:
    parts = name.split(".")
    if parts[0] == "layers":
        return flat["layers." + ".".join(parts[2:])][int(parts[1])]
    return flat[name]


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "granite-moe-3b-a800m"))
def test_remat_full_against_reference(arch):
    cfg, ref, tcfg, params = weights(arch)
    rcfg, tcfg = cfg.scaled(remat="full"), tcfg.scaled(remat="full")
    b = batch(cfg, 2, 13 if not cfg.loss_chunk else 4 * cfg.loss_chunk)
    want = _flat(jax.jit(jax.grad(lambda p, x: R.train_loss(p, x, rcfg)))(
        ref, jnp_batch(b)))
    _, grads = loss_and_grads(tcfg, params, b)
    for name, g in grads.items():
        w = _per_layer(want, name)
        got = g.detach().float().numpy()
        bound = 1e-3 * np.abs(w) + 1e-4 * float(np.abs(w).max())
        assert got.shape == w.shape, name
        assert np.all(np.abs(got - w) <= bound), name
