"""The port's multi-replica router against the reference's, on the CPU:
tokens through a router over 2 replicas equal the port's one-shot oracle
and the reference Router's on the same (converted) weights, exactly in
float32; the fault paths (a replica killed mid-replay, a crashing step, a
heartbeat lapse, a total outage) with the reference's assertions; a device
fault that propagates out of ``Router.step`` instead of failing a replica;
``publish_stats`` keys and a fresh router's ``stats()`` equal to the
reference's; and the ``python -m repro_torch.core.deploy.router`` contract.
"""

import json

import numpy as np
import pytest
import torch

from repro.core.deploy import Router as RefRouter
from repro.core.deploy import ServeEngine as RefEngine
from repro.core.deploy.engine import ServeRequest as RefRequest
from repro.core.evaluator import FitnessCache as RefCache
from repro.train import fault as ref_fault
from repro_torch.core.deploy import (Router, ServeEngine, build_router,
                                     oneshot_generate)
from repro_torch.core.deploy.engine import DEFAULT_SERVE_PLAN, ServeRequest
from repro_torch.core.deploy.router import main as router_main
from repro_torch.core.evaluator import FitnessCache
from repro_torch.core.fitness import DEVICE_FAULTS
from repro_torch.core.liveloop.traces import replay, synthesize
from repro_torch.device import DeviceFault
from repro_torch.train import fault
from torch_model_oracle import weights


@pytest.fixture(scope="module")
def qwen():
    _, _, tcfg, params = weights("qwen3-0.6b")
    return tcfg, params


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def _reqs(prompts, gen, cls=ServeRequest):
    return [cls(uid=f"r{i}", tokens=p, max_new_tokens=gen)
            for i, p in enumerate(prompts)]


def _two_replica_router(cfg, params, *, max_len, max_slots=2,
                        prefill_chunk=1, engine=ServeEngine, router=Router,
                        **kw):
    return router([engine(cfg, params, max_len=max_len, max_slots=max_slots,
                          prefill_chunk=prefill_chunk, seed=i)
                   for i in range(2)], **kw)


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


# --------------------------------------------------------------------------
# the differential oracle, and the reference router
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("qwen3-0.6b",            # dense
                                  "granite-moe-3b-a800m",  # MoE
                                  "falcon-mamba-7b"))      # SSM
def test_router_matches_oneshot_and_reference_router(arch):
    """Every request through the port's router over 2 replicas gets the
    tokens the port's unbatched one-shot path gives it, and the tokens the
    reference Router gives it on the same weights."""
    cfg, ref, tcfg, params = weights(arch)
    prompts = _prompts(tcfg, (8, 4, 8, 4, 6), seed=3)
    gen = 4
    oracle = {f"r{i}": oneshot_generate(tcfg, params, p[None, :],
                                        gen)[0].tolist()
              for i, p in enumerate(prompts)}
    router = _two_replica_router(tcfg, params, max_len=12)
    got = _tokens(router.run(_reqs(prompts, gen), stagger=2))
    want = _tokens(_two_replica_router(
        cfg, ref, max_len=12, engine=RefEngine, router=RefRouter).run(
        _reqs(prompts, gen, RefRequest), stagger=2))
    assert got == oracle == want
    # traffic really fanned out: both replicas completed work
    assert all(row["n_completed"] > 0
               for row in router.stats()["per_replica"])


def test_build_router_resolves_plan(qwen):
    """build_router turns a serve-plan genome into replicas on the device
    of the weights, with the plan's clamped slot count, and stays exact."""
    cfg, params = qwen
    genome = dict(DEFAULT_SERVE_PLAN, replicas=2, max_slots=4,
                  kv_dtype="int8")
    router = build_router(cfg, params, genome=genome, max_len=12)
    assert router.n_live == 2 and router.plan.dtype == "int8"
    assert all(r.engine.max_slots == router.plan.effective_slots(4, 12)
               and r.engine.device == torch.device("cpu")
               and r.engine.params is params for r in router.replicas)
    prompts = _prompts(cfg, (8, 8, 4), seed=5)
    refs = {f"r{i}": oneshot_generate(cfg, params, p[None, :], 3)[0].tolist()
            for i, p in enumerate(prompts)}
    assert _tokens(router.run(_reqs(prompts, 3), stagger=1)) == refs


def test_build_router_draws_weights_on_the_named_device(qwen):
    """Without params, one set of seeded weights is made on ``device`` and
    shared by every replica."""
    cfg, _ = qwen
    router = build_router(cfg, genome={"replicas": 4}, max_len=8,
                          device="cpu")
    engines = [r.engine for r in router.replicas]
    assert len(engines) == 4
    assert all(e.params is engines[0].params for e in engines)
    assert engines[0].params.device == torch.device("cpu")


def test_build_router_without_a_gpu_or_device_raises(qwen, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_router(qwen[0], genome={"replicas": 2}, max_len=8)


def test_replay_drives_router_like_an_engine(qwen):
    cfg, params = qwen
    trace = synthesize("bursty", vocab=cfg.vocab, n_requests=6,
                       max_prompt=8, gen=3, seed=1)
    router = _two_replica_router(cfg, params, max_len=trace.max_len())
    report = replay(router, trace)
    assert len(report.results) == len(trace)
    assert report.n_rejected == 0
    assert report.stats["n_replicas"] == 2


# --------------------------------------------------------------------------
# faults
# --------------------------------------------------------------------------


def test_kill_replica_mid_replay_stays_exact(qwen):
    """Killed mid-flight, a replica's queued and in-flight requests drain to
    the survivor, and every result still equals the oracle's."""
    cfg, params = qwen
    prompts = _prompts(cfg, (8, 4, 8, 4, 6, 8), seed=7)
    gen = 4
    refs = {f"r{i}": oneshot_generate(cfg, params, p[None, :],
                                      gen)[0].tolist()
            for i, p in enumerate(prompts)}
    router = _two_replica_router(cfg, params, max_len=12)
    router.submit_many(_reqs(prompts, gen))
    router.step()
    router.step()                  # replica 0 now has work in flight
    router.kill_replica(0)
    assert router.n_requeued > 0
    router.drain()
    assert _tokens(router.completed) == refs
    s = router.stats()
    assert s["n_live"] == 1 and s["n_rejected"] == 0
    dead = s["per_replica"][0]
    assert not dead["alive"] and dead["fail_reason"] == "killed"
    assert s["n_requeued"] == router.n_requeued


def _crash_from_tick_1(engine, method, exc):
    """Make ``engine.<method>`` raise ``exc`` from the engine's second tick
    on; returns the list of raises."""
    raised = []
    orig = getattr(engine, method)

    def crashing(*args):
        if engine.n_ticks >= (1 if method == "begin_step" else 2):
            raised.append(exc)
            raise exc
        return orig(*args)
    setattr(engine, method, crashing)
    return raised


@pytest.mark.parametrize("method", ("begin_step", "finish_step"))
def test_crashing_step_fails_replica_not_router(qwen, method):
    """A replica whose step raises is failed and drained; the router
    finishes the backlog on the survivor."""
    cfg, params = qwen
    prompts = _prompts(cfg, (6, 6, 6, 6), seed=2)
    router = _two_replica_router(cfg, params, max_len=10)
    raised = _crash_from_tick_1(router.replicas[1].engine, method,
                                RuntimeError("device lost"))
    out = router.run(_reqs(prompts, 3), stagger=1)
    assert len(raised) == 1         # failed once, never stepped again
    assert len(out) == len(prompts)
    s = router.stats()
    assert s["n_live"] == 1
    assert s["per_replica"][1]["fail_reason"] == \
        f"{method}: RuntimeError: device lost"


@pytest.mark.parametrize("method", ("begin_step", "finish_step"))
@pytest.mark.parametrize("exc", DEVICE_FAULTS)
def test_device_fault_propagates_out_of_the_router(qwen, method, exc):
    """A fault of the device (a kernel build or launch, torch's
    AcceleratorError) is not one replica dying: it leaves Router.step with
    every replica still alive and nothing requeued."""
    cfg, params = qwen
    router = _two_replica_router(cfg, params, max_len=10)
    fault_ = exc("launch refused")
    _crash_from_tick_1(router.replicas[1].engine, method, fault_)
    router.submit_many(_reqs(_prompts(cfg, (6, 6, 6, 6), seed=2), 3))
    with pytest.raises(exc) as info:
        router.drain()
    assert info.value is fault_
    assert router.n_live == 2 and router.n_requeued == 0
    assert all(r.fail_reason == "" for r in router.replicas)


def test_heartbeat_lapse_fails_silent_replica(qwen):
    """A replica whose heartbeats stop (the host silent, its step never
    raising) is failed after the timeout, counted in router ticks."""
    cfg, params = qwen
    prompts = _prompts(cfg, (6, 6, 6), seed=4)
    router = _two_replica_router(cfg, params, max_len=10,
                                 heartbeat_timeout=2.0)
    orig_hb = router.monitor.heartbeat

    def dropping(host, now, step_latency=None):
        if host != 1:               # replica 1's beats never arrive
            orig_hb(host, now, step_latency=step_latency)
    router.monitor.heartbeat = dropping
    router.submit_many(_reqs(prompts, 3))
    for _ in range(3):              # silence outlasts the timeout
        router.step()
    assert not router.replicas[1].alive
    assert router.replicas[1].fail_reason == "heartbeat timeout"
    router.drain()
    assert len(router.completed) == len(prompts)


def test_total_outage_rejects_backlog_and_never_hangs(qwen):
    cfg, params = qwen
    prompts = _prompts(cfg, (6, 6, 6, 6), seed=6)
    router = _two_replica_router(cfg, params, max_len=10)
    router.submit_many(_reqs(prompts, 3))
    router.step()
    router.kill_replica(0, reason="power")
    router.kill_replica(1, reason="power")
    router.drain()                  # must return, not spin
    assert not router.busy
    s = router.stats()
    assert s["n_live"] == 0
    assert s["n_completed"] + s["n_rejected"] == len(prompts)
    assert s["n_rejected"] > 0
    assert set(router.rejected_uids) <= {f"r{i}"
                                         for i in range(len(prompts))}
    assert s["wall_s"] >= 0.0 and s["throughput_tok_s"] >= 0.0


def test_constructor_and_submission_validation(qwen):
    cfg, params = qwen
    with pytest.raises(ValueError, match="at least one replica"):
        Router([])
    with pytest.raises(ValueError, match="share max_len"):
        Router([ServeEngine(cfg, params, max_len=10),
                ServeEngine(cfg, params, max_len=12)])
    router = _two_replica_router(cfg, params, max_len=8)
    assert not router.try_submit(ServeRequest(
        uid="big", tokens=np.zeros(8, np.int32), max_new_tokens=4))
    assert not router.try_submit(ServeRequest(
        uid="v", tokens=np.zeros(2, np.int32), max_new_tokens=2,
        variant="evolved"))
    assert router.n_rejected == 2
    assert router.rejected_uids == ["big", "v"]


def test_fault_module_is_the_reference(qwen):
    """``train/fault.py`` is carried verbatim: the same failures,
    stragglers, shard assignments and control ticks."""
    mons = [m.HeartbeatMonitor(n_hosts=5, timeout=3.0) for m in
            (fault, ref_fault)]
    rng = np.random.default_rng(0)
    for t in range(8):
        for h in range(5):
            if rng.random() < 0.6:
                lat = float(rng.uniform(0.5, 3.0))
                for m in mons:
                    m.heartbeat(h, now=float(t), step_latency=lat)
        assert mons[0].failed(t) == mons[1].failed(t)
        assert mons[0].stragglers(t) == mons[1].stragglers(t)
        a = fault.control_tick(mons[0], float(t), 37, checkpoint_step=t)
        b = ref_fault.control_tick(mons[1], float(t), 37, checkpoint_step=t)
        assert (a.alive, a.assignments, a.restarted_from_step) == \
            (b.alive, b.assignments, b.restarted_from_step)


# --------------------------------------------------------------------------
# stats and feedback against the reference
# --------------------------------------------------------------------------


def test_publish_keys_equal_reference_and_key_on_full_plan(qwen, tmp_path):
    """The router's serve records carry the reference's keys for the same
    plan and measurement (replicas included, so they never collide with a
    single engine's); first write wins."""
    cfg, ref, _, _ = weights("qwen3-0.6b")
    tcfg, params = qwen
    genome = dict(DEFAULT_SERVE_PLAN, replicas=2)
    prompts = _prompts(tcfg, (6, 6, 6), seed=8)
    router = build_router(tcfg, params, genome=genome, max_len=12)
    router.run(_reqs(prompts, 3), stagger=1)
    import repro.core.deploy as RD
    ref_router = RD.build_router(cfg, ref, genome=genome, max_len=12)
    ref_router.run(_reqs(prompts, 3, RefRequest), stagger=1)
    single = ServeEngine(tcfg, params, max_len=12,
                         max_slots=DEFAULT_SERVE_PLAN["max_slots"],
                         prefill_chunk=DEFAULT_SERVE_PLAN["prefill_chunk"])
    single.run(_reqs(prompts, 3), stagger=1)
    cache = FitnessCache(str(tmp_path / "c.jsonl"), writer="serve")
    ref_cache = RefCache(str(tmp_path / "r.jsonl"), writer="serve")
    kw = dict(name=tcfg.name, shape="s", run="unit")
    k_router = router.publish_stats(cache, **kw)
    k_ref = ref_router.publish_stats(ref_cache, **kw)
    k_single = single.publish_stats(cache, **kw)
    k_again = router.publish_stats(cache, **kw)
    cache.close()
    ref_cache.close()
    assert k_router and k_router == k_ref
    assert k_single and not (set(k_router) & set(k_single))
    assert k_again == []


def test_fresh_router_stats_equal_reference(qwen):
    """Before the first tick every number is a well-defined zero, and the
    whole document is the reference's."""
    cfg, ref, _, _ = weights("qwen3-0.6b")
    tcfg, params = qwen
    s = _two_replica_router(tcfg, params, max_len=12).stats()
    assert s["n_completed"] == 0 and s["wall_s"] == 0.0
    assert s["throughput_tok_s"] == 0.0
    assert s["per_variant"]["default"]["n"] == 0
    assert len(s["per_replica"]) == 2
    assert s == _two_replica_router(cfg, ref, max_len=12, engine=RefEngine,
                                    router=RefRouter).stats()


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


CLI = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--replicas",
       "2", "--requests", "5", "--max-prompt", "8", "--gen", "3",
       "--max-slots", "2", "--prefill-chunk", "1"]


def test_cli_smoke_contract(capsys):
    """Replay a synthesized trace over 2 replicas; exit 0 only when every
    accepted request completed."""
    assert router_main(CLI) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["n_completed"] == 5
    assert stats["n_replicas"] == 2 and stats["n_live"] == 2
    assert stats["plan"]["replicas"] == 2


def test_cli_kill_at_demonstrates_failover(capsys, tmp_path):
    cache = str(tmp_path / "c.jsonl")
    assert router_main(CLI + ["--kill-at", "2", "--cache", cache]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["n_completed"] == 5 and stats["n_live"] == 1
    assert stats["per_replica"][0]["alive"] is False
    recs = [json.loads(line) for line in open(cache)]
    assert recs and all(r["writer"] == "serve" for r in recs)


def test_cli_without_gpu_or_device_exits_with_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="router: no CUDA device"):
        router_main(CLI[:3])
