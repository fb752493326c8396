"""The port's continuous-batching ServeEngine (``core/deploy/engine.py``)
against the port's direct prefill/decode loop and its one-shot path,
registry-routed variants, and the serve-tagged latency feedback into the
port's FitnessCache: the reference's tests/test_serve.py on the port, on
the CPU, with the reference's smoke weights carried across.  Greedy tokens
must agree exactly (float32 on the CPU)."""

import json

import numpy as np
import pytest
import torch

from repro_torch.core.deploy import (Artifact, ArtifactRegistry, ServeEngine,
                                     ServeRequest, oneshot_generate,
                                     serve_schedule_space)
from repro_torch.core.evaluator import FitnessCache
from repro_torch.core.liveloop.traces import demo_requests
from torch_model_oracle import direct_generate, weights


@pytest.fixture(scope="module")
def qwen():
    _, _, cfg, params = weights("qwen3-0.6b")
    return cfg, params


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def _direct_generate(cfg, params, prompt: np.ndarray, gen: int
                     ) -> list[int]:
    """Engine-independent oracle: the port's direct models.transformer
    prefill + lockstep decode_step loop, B=1, greedy.  Shares NO code with
    core.deploy.engine."""
    return direct_generate(cfg, params, prompt, gen)


class TestEngineCorrectness:
    def test_engine_matches_direct_model_loop(self, qwen):
        """The engine (continuous batching, lane caches, vmapped decode)
        must be bit-identical to the direct models.transformer
        prefill/decode loop — an oracle that shares no serving code."""
        cfg, params = qwen
        prompts = _prompts(cfg, (8, 4, 8), seed=9)
        gen = 5
        refs = [_direct_generate(cfg, params, p, gen) for p in prompts]
        eng = ServeEngine(cfg, params, max_len=16, max_slots=2,
                          prefill_chunk=1)
        reqs = [ServeRequest(uid=f"r{i}", tokens=p, max_new_tokens=gen)
                for i, p in enumerate(prompts)]
        res = {r.uid: r for r in eng.run(reqs, stagger=1)}
        for i, ref in enumerate(refs):
            assert res[f"r{i}"].tokens == ref, \
                f"request {i} diverged from the direct model loop"

    def test_continuous_matches_unbatched(self, qwen):
        """Staggered arrivals, mixed prompt lengths, shared lanes — every
        request's greedy continuation must be bit-identical to running it
        alone through the unbatched (B=1 one-shot) path."""
        cfg, params = qwen
        prompts = _prompts(cfg, (8, 4, 8, 4, 8))
        gen = 5
        refs = [oneshot_generate(cfg, params, p[None, :], gen)[0].tolist()
                for p in prompts]
        eng = ServeEngine(cfg, params, max_len=16, max_slots=3,
                          prefill_chunk=2)
        reqs = [ServeRequest(uid=f"r{i}", tokens=p, max_new_tokens=gen)
                for i, p in enumerate(prompts)]
        res = {r.uid: r for r in eng.run(reqs, stagger=2)}
        for i, ref in enumerate(refs):
            assert res[f"r{i}"].tokens == ref, f"request {i} diverged"

    def test_prefill_micro_batching_matches(self, qwen):
        """All-upfront admission (prefill batches of several prompts) gives
        the same tokens as one-at-a-time admission."""
        cfg, params = qwen
        prompts = _prompts(cfg, (6, 6, 6, 6), seed=1)
        gen = 4

        def run(chunk, slots):
            eng = ServeEngine(cfg, params, max_len=10, max_slots=slots,
                              prefill_chunk=chunk)
            reqs = [ServeRequest(uid=f"r{i}", tokens=p, max_new_tokens=gen)
                    for i, p in enumerate(prompts)]
            return {r.uid: r.tokens for r in eng.run(reqs)}

        assert run(4, 4) == run(1, 1)

    def test_decode_interleaves_prefill(self, qwen):
        """With more requests than slots, later requests are admitted while
        earlier ones are mid-decode — and still match the oracle."""
        cfg, params = qwen
        prompts = _prompts(cfg, (8, 8, 8, 8, 8, 8), seed=2)
        gen = 6
        eng = ServeEngine(cfg, params, max_len=16, max_slots=2,
                          prefill_chunk=1)
        reqs = [ServeRequest(uid=f"r{i}", tokens=p, max_new_tokens=gen)
                for i, p in enumerate(prompts)]
        out = eng.run(reqs)
        assert len(out) == len(prompts)
        ref = oneshot_generate(cfg, params, prompts[-1][None, :], gen)[0]
        last = next(r for r in out if r.uid == f"r{len(prompts) - 1}")
        assert last.tokens == ref.tolist()
        # interleaving really happened: decode dispatches < requests * gen
        assert eng.stats()["decode_batches"] < len(prompts) * gen

    def test_eos_stops_early(self, qwen):
        cfg, params = qwen
        (p,) = _prompts(cfg, (8,), seed=3)
        ref = oneshot_generate(cfg, params, p[None, :], 6)[0].tolist()
        eos = ref[2]
        eng = ServeEngine(cfg, params, max_len=16, max_slots=1,
                          prefill_chunk=1)
        out = eng.run([ServeRequest(uid="r", tokens=p, max_new_tokens=6,
                                    eos_id=eos)])
        # stops at eos's FIRST occurrence (which may precede index 2)
        assert out[0].tokens == ref[:ref.index(eos) + 1]

    def test_submit_validates(self, qwen):
        cfg, params = qwen
        eng = ServeEngine(cfg, params, max_len=8)
        with pytest.raises(ValueError, match="exceeds max_len"):
            eng.submit(ServeRequest(uid="big", tokens=np.zeros(6, np.int32),
                                    max_new_tokens=4))
        with pytest.raises(ValueError, match="unknown variant"):
            eng.submit(ServeRequest(uid="v", tokens=np.zeros(2, np.int32),
                                    max_new_tokens=2, variant="evolved"))


class TestVariantRouting:
    def test_ab_routes_both_variants(self, qwen):
        cfg, params = qwen
        evolved = cfg.scaled(attn_impl="blockwise", attn_block=8)
        eng = ServeEngine(cfg, params, max_len=12, max_slots=4,
                          prefill_chunk=2, evolved_cfg=evolved,
                          ab_fraction=0.5, seed=7)
        reqs = [ServeRequest(uid=f"r{i}", tokens=p, max_new_tokens=3)
                for i, p in enumerate(_prompts(cfg, (8,) * 8, seed=4))]
        out = eng.run(reqs, stagger=3)
        variants = {r.variant for r in out}
        assert variants == {"default", "evolved"}
        per = eng.stats()["per_variant"]
        assert per["default"]["n"] + per["evolved"]["n"] == 8

    def test_pinned_variant_wins_over_fraction(self, qwen):
        cfg, params = qwen
        evolved = cfg.scaled(attn_impl="blockwise", attn_block=8)
        eng = ServeEngine(cfg, params, max_len=12, max_slots=2,
                          prefill_chunk=2, evolved_cfg=evolved,
                          ab_fraction=1.0)
        (p,) = _prompts(cfg, (8,), seed=5)
        out = eng.run([ServeRequest(uid="pin", tokens=p, max_new_tokens=2,
                                    variant="default")])
        assert out[0].variant == "default"


class TestServeFeedback:
    def test_latency_records_serve_tagged(self, qwen, tmp_path):
        """Engine stats land in a shared FitnessCache as writer='serve'
        records, countable as cross-writer hits by other readers."""
        cfg, params = qwen
        eng = ServeEngine(cfg, params, max_len=12, max_slots=2,
                          prefill_chunk=1)
        eng.run(demo_requests(cfg, n_requests=3, prompt_len=8, gen=3),
                stagger=1)
        path = str(tmp_path / "cache.jsonl")
        cache = FitnessCache(path, writer="serve")
        keys = eng.publish_stats(cache, name=cfg.name,
                                 shape={"prompt_len": 8, "gen": 3},
                                 run="unit")
        cache.close()
        assert keys and all(k.startswith("serve:") for k in keys)
        recs = [json.loads(line) for line in open(path)]
        assert len(recs) == len(keys)
        for rec in recs:
            assert rec["writer"] == "serve"
            t_tok, lat = rec["fitness"]
            assert t_tok > 0 and lat > 0
        # another engine-stack component reading the shared store sees the
        # serving fleet's record as a cross-writer hit
        reader = FitnessCache(path, writer="search")
        assert reader.get(keys[0]) is not None
        assert reader.cross_hits == 1
        reader.close()

    def test_publish_dedupes_and_keys_on_schedule(self, qwen, tmp_path):
        cfg, params = qwen
        eng = ServeEngine(cfg, params, max_len=12)
        eng.run(demo_requests(cfg, n_requests=2, prompt_len=6, gen=2))
        path = str(tmp_path / "cache.jsonl")
        cache = FitnessCache(path, writer="serve")
        k1 = eng.publish_stats(cache, name=cfg.name, shape="s", run="r1")
        # same configuration again: already recorded, nothing published
        k2 = eng.publish_stats(cache, name=cfg.name, shape="s", run="r1")
        # a distinct run tag records a fresh measurement
        k3 = eng.publish_stats(cache, name=cfg.name, shape="s", run="r2")
        # a different engine schedule must never collide with k1's key
        eng2 = ServeEngine(cfg, params, max_len=12, max_slots=8,
                           prefill_chunk=4)
        eng2.run(demo_requests(cfg, n_requests=2, prompt_len=6, gen=2))
        k4 = eng2.publish_stats(cache, name=cfg.name, shape="s", run="r1")
        cache.close()
        assert k1 and k2 == [] and k3 and k4
        assert not (set(k1) & set(k3)) and not (set(k1) & set(k4))
        assert len(open(path).readlines()) == len(k1) + len(k3) + len(k4)


class TestServeSearchSurface:
    def test_schedule_space_contains_default(self):
        from repro_torch.core.deploy.engine import (DEFAULT_SERVE_PLAN,
                                                    ENGINE_SPACE)
        from repro_torch.core.deploy.kvplan import KV_SPACE
        space = serve_schedule_space("qwen3-0.6b")
        assert space.contains(DEFAULT_SERVE_PLAN)
        # engine schedule (4*3) x KV plan (4 pages * 3 dtypes * 3 layouts)
        assert space.size() == 432
        assert set(space.names()) == set(ENGINE_SPACE) | set(KV_SPACE)

    def test_registry_routed_engine(self, qwen, tmp_path):
        """A serve artifact resolved from the registry configures the
        engine (the deployment round trip at smoke scale)."""
        from repro_torch.core.deploy import engine_schedule_from
        cfg, params = qwen
        reg = ArtifactRegistry(str(tmp_path / "arts"))
        reg.export(Artifact(kind="serve", name=cfg.name, shape="smoke",
                            genome={"max_slots": 4, "prefill_chunk": 2}))
        art = reg.resolve(cfg.name, "smoke", kind="serve")
        sched = engine_schedule_from(art)
        eng = ServeEngine(cfg, params, max_len=12,
                          max_slots=sched["max_slots"],
                          prefill_chunk=sched["prefill_chunk"])
        out = eng.run(demo_requests(cfg, n_requests=4, prompt_len=8, gen=3),
                      stagger=2)
        assert len(out) == 4
        assert eng.max_slots == 4


class TestStatsHardening:
    """stats()/publish_stats() on the degenerate paths the live loop hits:
    fresh engines, mid-run reads, all-rejected admissions, zero-completion
    variants."""

    def test_fresh_engine_stats_are_zeros(self, qwen):
        cfg, params = qwen
        eng = ServeEngine(cfg, params, max_len=12)
        s = eng.stats()
        assert s["wall_s"] == 0.0 and s["throughput_tok_s"] == 0.0
        assert s["n_completed"] == 0 and s["n_rejected"] == 0
        assert s["per_variant"]["default"]["n"] == 0

    def test_midrun_stats_never_negative(self, qwen):
        """Regression: a stats() read after the first tick but before any
        completion used to compute wall from _t_last=0.0, going negative."""
        cfg, params = qwen
        eng = ServeEngine(cfg, params, max_len=12, max_slots=2,
                          prefill_chunk=1)
        for r in demo_requests(cfg, n_requests=2, prompt_len=6, gen=4):
            eng.submit(r)
        eng.step()          # admission happened, nothing completed yet
        s = eng.stats()
        assert s["wall_s"] >= 0.0
        assert s["throughput_tok_s"] == 0.0 and s["n_completed"] == 0

    def test_try_submit_counts_rejections(self, qwen):
        cfg, params = qwen
        eng = ServeEngine(cfg, params, max_len=8)
        ok = eng.try_submit(ServeRequest(
            uid="ok", tokens=np.zeros(2, np.int32), max_new_tokens=2))
        big = eng.try_submit(ServeRequest(
            uid="big", tokens=np.zeros(8, np.int32), max_new_tokens=4))
        bad_v = eng.try_submit(ServeRequest(
            uid="v", tokens=np.zeros(2, np.int32), max_new_tokens=2,
            variant="evolved"))
        assert ok and not big and not bad_v
        assert eng.n_rejected == 2
        assert eng.stats()["n_rejected"] == 2

    def test_publish_skips_empty_variants(self, qwen, tmp_path):
        """A variant that completed nothing is a zeroed stats row, not a
        published 'measurement' of zero latency."""
        cfg, params = qwen
        evolved = cfg.scaled(attn_impl="blockwise", attn_block=8)
        eng = ServeEngine(cfg, params, max_len=12, evolved_cfg=evolved,
                          ab_fraction=0.0)     # all traffic -> default
        eng.run(demo_requests(cfg, n_requests=2, prompt_len=6, gen=2))
        assert eng.stats()["per_variant"]["evolved"]["n"] == 0
        cache = FitnessCache(str(tmp_path / "c.jsonl"), writer="serve")
        keys = eng.publish_stats(cache, name=cfg.name, shape="s")
        cache.close()
        assert len(keys) == 1

    def test_publish_nothing_when_idle(self, qwen, tmp_path):
        cfg, params = qwen
        eng = ServeEngine(cfg, params, max_len=12)
        cache = FitnessCache(str(tmp_path / "c.jsonl"), writer="serve")
        assert eng.publish_stats(cache, name=cfg.name, shape="s") == []
        cache.close()

    def test_publish_features_and_meta_round_trip(self, qwen, tmp_path):
        """features make serve records surrogate training rows; meta (the
        trace spec) must survive the write and a fresh reload."""
        cfg, params = qwen
        eng = ServeEngine(cfg, params, max_len=12)
        eng.run(demo_requests(cfg, n_requests=2, prompt_len=6, gen=2))
        path = str(tmp_path / "c.jsonl")
        cache = FitnessCache(path, writer="serve")
        spec = {"scenario": "demo", "seed": 0}
        keys = eng.publish_stats(cache, name=cfg.name, shape="s",
                                 features=[2.0, 1.0], meta={"trace": spec})
        cache.close()
        assert keys
        reader = FitnessCache(path, writer="search")
        assert reader.meta_of(keys[0]) == {"trace": spec}
        reader.close()
        rec = json.loads(open(path).readline())
        assert rec["features"] == [2.0, 1.0]
        assert rec["meta"] == {"trace": spec}


class TestAdmissionAging:
    """Regression for prompt-length-grouping starvation: grouped admission
    prefers the queue's most common prompt length, which starved an
    odd-length prompt behind a steady stream of same-length ones until the
    age-based bound (admit_max_wait) forces strict FIFO."""

    def _run(self, cfg, params, reqs, admit_max_wait):
        eng = ServeEngine(cfg, params, max_len=16, max_slots=1,
                          prefill_chunk=1, admit_max_wait=admit_max_wait)
        out = eng.run(reqs)
        return [r.uid for r in out], {r.uid: r.tokens for r in out}

    def test_aging_bound_prevents_starvation(self, qwen):
        cfg, params = qwen
        gen = 3
        long_p = _prompts(cfg, (12,), seed=11)[0]
        shorts = _prompts(cfg, (4,) * 6, seed=12)

        def reqs():
            return [ServeRequest(uid="long", tokens=long_p,
                                 max_new_tokens=gen)] + \
                [ServeRequest(uid=f"s{i}", tokens=p, max_new_tokens=gen)
                 for i, p in enumerate(shorts)]

        order_unbounded, toks_unbounded = self._run(cfg, params, reqs(),
                                                    10 ** 6)
        order_bounded, toks_bounded = self._run(cfg, params, reqs(), 4)
        # without the bound, grouping starves the lone 12-token prompt
        # (submitted FIRST) until the short stream is nearly dry — it
        # overtakes only at the final count tie, which breaks by age
        assert order_unbounded.index("long") >= len(shorts) - 1
        # with the bound, the aged request jumps the grouping well before
        # the shorts run dry
        assert order_bounded.index("long") < order_unbounded.index("long")
        assert order_bounded.index("long") <= 2
        # admission order is a scheduling choice — tokens stay bit-exact
        assert toks_bounded == toks_unbounded
        ref = oneshot_generate(cfg, params, long_p[None, :], gen)[0]
        assert toks_bounded["long"] == ref.tolist()

    def test_admission_policy_never_changes_tokens(self, qwen):
        """Replaying the long_tail scenario (the starvation-shaped arrival
        mix) under an aggressive aging bound and under the default must
        produce identical tokens per request."""
        from repro_torch.core.liveloop.traces import replay, synthesize
        cfg, params = qwen
        trace = synthesize("long_tail", vocab=cfg.vocab, n_requests=8,
                           max_prompt=10, gen=3, seed=5)

        def run(wait):
            eng = ServeEngine(cfg, params, max_len=trace.max_len(),
                              max_slots=2, prefill_chunk=1,
                              admit_max_wait=wait)
            report = replay(eng, trace)
            return {r.uid: r.tokens for r in report.results}

        a, b = run(2), run(32)
        assert a and a == b

    def test_bad_admit_max_wait_rejected(self, qwen):
        cfg, params = qwen
        with pytest.raises(ValueError, match="admit_max_wait"):
            ServeEngine(cfg, params, max_len=12, admit_max_wait=0)


class TestDemoTraceShim:
    def test_deprecated_shim_matches_demo_requests(self, qwen):
        """demo_trace is a deprecation shim: it must warn, and return
        exactly what liveloop's demo_requests returns."""
        from repro_torch.core.deploy import demo_trace
        cfg, _ = qwen
        with pytest.warns(DeprecationWarning, match="demo_requests"):
            old = demo_trace(cfg, n_requests=3, prompt_len=8, gen=3)
        new = demo_requests(cfg, n_requests=3, prompt_len=8, gen=3)
        assert [r.uid for r in old] == [r.uid for r in new]
        for a, b in zip(old, new):
            assert np.array_equal(a.tokens, b.tokens)
            assert a.max_new_tokens == b.max_new_tokens


class TestPortDevice:
    """The port's device rules: the GPU unless the caller names another."""

    def test_engine_without_gpu_or_device_raises(self, qwen, monkeypatch):
        cfg, _ = qwen
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg)

    def test_engine_runs_where_its_params_live(self, qwen):
        cfg, params = qwen
        assert ServeEngine(cfg, params).device == torch.device("cpu")
        assert ServeEngine(cfg, device="cpu").device == torch.device("cpu")
        with pytest.raises(ValueError, match="params live on"):
            ServeEngine(cfg, params, device="meta")

    def test_sampling_repeats_for_a_seed(self, qwen):
        """temperature > 0 draws from the engine's own torch.Generator:
        the same seed gives the same tokens, another seed others."""
        cfg, params = qwen
        prompts = _prompts(cfg, (6, 6, 6), seed=13)

        def run(seed):
            eng = ServeEngine(cfg, params, max_len=14, max_slots=3,
                              prefill_chunk=3, temperature=1.0, seed=seed)
            reqs = [ServeRequest(uid=f"r{i}", tokens=p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            return {r.uid: r.tokens for r in eng.run(reqs)}

        assert run(3) == run(3)
        assert run(3) != run(4)

    def test_stats_keys_equal_reference(self, qwen):
        import jax

        from repro.configs import smoke_config
        from repro.core.deploy import ServeEngine as RefEngine
        from repro.models.transformer import init_params
        cfg, params = qwen
        ref_cfg = smoke_config("qwen3-0.6b")
        ref = RefEngine(ref_cfg, init_params(ref_cfg, jax.random.PRNGKey(0)),
                        max_len=8)
        port = ServeEngine(cfg, params, max_len=8)
        for eng in (ref, port):
            eng.run(demo_requests(cfg, n_requests=1, prompt_len=4, gen=2))
        a, b = ref.stats(), port.stats()
        assert sorted(a) == sorted(b)
        assert sorted(a["per_variant"]["default"]) == \
            sorted(b["per_variant"]["default"])
