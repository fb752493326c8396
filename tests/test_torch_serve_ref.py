"""The port's serving path against the reference's: the port's ServeEngine
against the reference's ServeEngine on the same weights and trace, the KV
plan's numpy functions bit for bit, the traces byte for byte, the measured
cache error, the serving schedule as a GEVO workload, and the
``python -m repro_torch.launch.serve`` CLI, all on the CPU.

Greedy tokens must agree exactly (float32 smoke configs; the models agree
to ~5e-6 on logits).  The measured cache error of the port's prefill is
held to the reference's within 2% relative (the two prefills' caches
differ by ~1e-6, which moves a value across an int8 rounding boundary only
rarely)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.deploy import ServeEngine as RefEngine
from repro.core.deploy import kvplan as RK
from repro.core.liveloop import traces as RT
from repro_torch.core.deploy import (ServeEngine, build_serve_workload,
                                     engine_schedule_from, serve_plan_from)
from repro_torch.core.deploy import kvplan as TK
from repro_torch.core.deploy.registry import Artifact
from repro_torch.core.liveloop import traces as TT
from repro_torch.core.search import GevoML
from torch_model_oracle import weights

ROOT = Path(__file__).resolve().parent.parent


# --------------------------------------------------------------------------
# the engine against the reference engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "granite-moe-3b-a800m"])
def test_engine_matches_reference_engine(arch):
    """Same weights, same staggered mixed-length trace, same schedule: the
    same greedy tokens for every request."""
    cfg, ref, tcfg, params = weights(arch)
    trace = dict(n_requests=5, prompt_len=10, gen=4, seed=2)
    kw = dict(max_len=14, max_slots=3, prefill_chunk=2)
    want = {r.uid: r.tokens for r in RefEngine(cfg, ref, **kw).run(
        RT.demo_requests(cfg, **trace), stagger=2)}
    got = {r.uid: r.tokens for r in ServeEngine(tcfg, params, **kw).run(
        TT.demo_requests(tcfg, **trace), stagger=2)}
    assert got == want


# --------------------------------------------------------------------------
# the KV plan: numpy, bit for bit
# --------------------------------------------------------------------------


def _cache_like(seed, shape=(37, 3, 8)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(0.1, 4, shape[0])[
        :, None, None]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("page", [4, 8, 16, 32])
def test_kv_codec_equals_reference(dtype, page):
    a = _cache_like(page)
    assert np.array_equal(TK.quantize_pages(a, page, dtype),
                          RK.quantize_pages(a, page, dtype))
    assert TK.cache_error(a, page, dtype) == RK.cache_error(a, page, dtype)
    assert TK.roundtrip_error(a, page, dtype) == \
        RK.roundtrip_error(a, page, dtype)
    assert np.array_equal(TK.page_scales(a, page), RK.page_scales(a, page))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_paged_store_equals_reference(dtype):
    rows = _cache_like(5, (40, 3, 8)).reshape(40, -1)
    stores = [m.PagedKVCache(n_pages=5, page_size=8, dim=rows.shape[1],
                             dtype=dtype) for m in (TK, RK)]
    for s in stores:
        s.allocate("a")
        for i, r in enumerate(rows):
            assert s.append("a", r)
            if i == 36:   # a partial trailing page reads as the codec does
                assert np.array_equal(s.read("a"), RK.quantize_pages(
                    rows[:37], 8, dtype))
    assert np.array_equal(stores[0].read("a"), stores[1].read("a"))
    assert stores[0].n_free_pages == stores[1].n_free_pages == 0
    for s in stores:
        assert not s.append("a", rows[0])      # pool exhausted
        s.free("a")
    assert stores[0].n_free_pages == stores[1].n_free_pages == 5


def test_kv_plan_tables_and_slots_equal_reference():
    assert TK.KV_SPACE == RK.KV_SPACE
    assert TK.DEFAULT_KV_PLAN == RK.DEFAULT_KV_PLAN
    assert TK.KV_ERROR_GATE == RK.KV_ERROR_GATE
    for page in TK.KV_SPACE["kv_page_size"]:
        for dt in TK.KV_SPACE["kv_dtype"]:
            g = {"kv_page_size": page, "kv_dtype": dt, "replicas": 2}
            a, b = TK.KVPlan.from_genome(g), RK.KVPlan.from_genome(g)
            assert a.to_genome() == b.to_genome()
            for slots in (1, 2, 4, 8):
                for max_len in (16, 24, 100):
                    assert a.effective_slots(slots, max_len) == \
                        b.effective_slots(slots, max_len)
                    assert a.slot_bytes(max_len) == b.slot_bytes(max_len)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_measured_cache_error_matches_reference(dtype):
    cfg, ref, tcfg, params = weights("qwen3-0.6b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (2, 16)).astype(np.int32)
    plan = (TK.KVPlan(page_size=8, dtype=dtype),
            RK.KVPlan(page_size=8, dtype=dtype))
    got = TK.measure_cache_error(tcfg, params, plan[0], prompts)
    want = RK.measure_cache_error(cfg, ref, plan[1], prompts)
    assert got["n_leaves"] == want["n_leaves"]
    for k in ("measured", "bound"):
        assert got[k] == pytest.approx(want[k], rel=2e-2, abs=0.0)
    assert got["measured"] <= got["bound"] <= TK.KV_ERROR_GATE


# --------------------------------------------------------------------------
# traces: byte for byte
# --------------------------------------------------------------------------


def test_demo_requests_equal_reference():
    cfg = weights("qwen3-0.6b")[0]
    for n, plen, gen, seed in ((8, 509, 32, 0), (5, 10, 4, 2), (3, 1, 1, 7)):
        a = TT.demo_requests(cfg, n_requests=n, prompt_len=plen, gen=gen,
                             seed=seed)
        b = RT.demo_requests(cfg, n_requests=n, prompt_len=plen, gen=gen,
                             seed=seed)
        assert [(r.uid, r.max_new_tokens, r.tokens.tobytes()) for r in a] \
            == [(r.uid, r.max_new_tokens, r.tokens.tobytes()) for r in b]


@pytest.mark.parametrize("scenario", RT.SCENARIOS)
def test_synthesized_traces_equal_reference(scenario):
    a = TT.synthesize(scenario, vocab=512, n_requests=12, max_prompt=20,
                      gen=5, seed=3)
    b = RT.synthesize(scenario, vocab=512, n_requests=12, max_prompt=20,
                      gen=5, seed=3)
    assert a.to_doc() == b.to_doc()
    assert a.fingerprint() == b.fingerprint()
    assert [r.tokens.tobytes() for r in a.requests()] == \
        [r.tokens.tobytes() for r in b.requests()]
    assert TT.trace_from_spec(b.spec()).fingerprint() == b.fingerprint()


def test_replay_through_the_port_engine():
    _, _, tcfg, params = weights("qwen3-0.6b")
    trace = TT.synthesize("bursty", vocab=tcfg.vocab, n_requests=6,
                          max_prompt=8, gen=3, seed=1)
    eng = ServeEngine(tcfg, params, max_len=trace.max_len(), max_slots=2)
    report = TT.replay(eng, trace)
    assert len(report.results) == 6 and report.n_rejected == 0


# --------------------------------------------------------------------------
# plans, the search workload, the CLI
# --------------------------------------------------------------------------


def test_plan_helpers_equal_reference():
    from repro.core.deploy import engine as RE
    from repro_torch.core.deploy import engine as TE
    genome = {"max_slots": 8, "kv_dtype": "int8", "attn_impl": "blockwise",
              "attn_block": 1024}
    assert serve_plan_from(Artifact(kind="serve", name="m", shape="s",
                                    genome=genome)) == \
        RE.serve_plan_from(RE.Artifact(kind="serve", name="m", shape="s",
                                       genome=genome))
    assert engine_schedule_from(None) == RE.engine_schedule_from(None)
    assert (TE.SERVE_SPACE, TE.SERVE_PLAN_KEYS) == \
        (RE.SERVE_SPACE, RE.SERVE_PLAN_KEYS)
    cfg = weights("qwen3-0.6b")[2]
    plan = Artifact(kind="plan", name="m", shape="s", genome=genome)
    evolved = TE.apply_plan_artifact(cfg, plan)
    assert (evolved.attn_impl, evolved.attn_block) == ("blockwise", 1024)


def test_serve_workload_drives_gevo():
    """build_serve_workload on the CPU, searched by a two-generation
    GevoML: every genome measured by replaying the trace."""
    wl = build_serve_workload("qwen3-0.6b", smoke=True, n_requests=4,
                              prompt_len=8, gen=3, device="cpu")
    assert wl.kind == "serve" and wl.time_mode == "measured"
    res = GevoML(wl, pop_size=4, n_elite=2, seed=0, mutation_rate=1.0,
                 operators={"attr_tweak": 1.0}).run(generations=2)
    assert len(res.history) == 2 and res.pareto
    for ind in res.pareto:
        t_tok, lat = ind.fitness
        assert t_tok > 0 and lat > 0


def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_cli_serves_on_the_cpu(tmp_path):
    cache = tmp_path / "c.jsonl"
    out = _cli("--smoke", "--device", "cpu", "--requests", "4",
               "--prompt-len", "8", "--gen", "3", "--cache", str(cache))
    assert out.returncode == 0, out.stderr
    assert "requests=4" in out.stdout and "device=cpu" in out.stdout
    assert "published 1 serve-tagged" in out.stdout
    one = _cli("--smoke", "--device", "cpu", "--oneshot", "--requests", "2",
               "--prompt-len", "6", "--gen", "3",
               "--arch", "falcon-mamba-7b")
    assert one.returncode == 0, one.stderr
    assert "oneshot batch=2" in one.stdout


def test_cli_without_gpu_or_device_exits_with_an_error():
    out = _cli("--smoke", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
