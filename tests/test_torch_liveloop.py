"""The port's live loop against the reference's, on the CPU: the canary's
pure functions and the modeled engine equal the reference's; a modeled
``LiveLoopController`` writes the reference's journals, registry and cache
rows byte for byte (its checkpoints too, but for the wall-clock
``history[].wall_s`` the search stamps on each generation), and a killed
loop resumes to the same bytes; the real backend on the CPU routes a
multi-replica plan through the router, rolls back a plan whose replicas
die and lets a device fault through; the live-loop and deploy CLIs print
the reference's output; ``launch.serve`` serves through the router and the
loop's promoted schedule."""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from repro.core import liveloop as R
from repro.core.liveloop.__main__ import main as ref_liveloop_main
from repro_torch.core import liveloop as T
from repro_torch.core.deploy import Router, ServeEngine
from repro_torch.core.deploy.__main__ import main as deploy_main
from repro_torch.core.deploy.engine import DEFAULT_SERVE_PLAN, SERVE_SPACE
from repro_torch.core.liveloop.__main__ import main as liveloop_main
from repro_torch.device import DeviceFault

TRACE = dict(vocab=64, n_requests=12, max_prompt=12, gen=6, seed=0)


def _trace(pkg, scenario="bursty", **kw):
    return pkg.synthesize(scenario, **dict(TRACE, **kw))


def _fault(genome, metrics):
    """The CLI's regression drill: every canary measurement 3x slower."""
    m = dict(metrics)
    m["throughput_tok_s"] = round(m["throughput_tok_s"] / 3.0, 6)
    m["mean_ttft_s"] = round(m["mean_ttft_s"] * 3.0, 6)
    return m


def _mk(pkg, root, **kw):
    tr = kw.pop("trace", None) or _trace(pkg)
    kw.setdefault("gens_per_tick", 2)
    kw.setdefault("pop", 8)
    kw.setdefault("fraction", 0.5)
    kw.setdefault("guardrails", pkg.Guardrails(windows=2))
    return pkg.LiveLoopController(str(root), trace=tr, mode="modeled", **kw)


def _tree_bytes(root, checkpoints=False,
                names=("canary.json", "state.json", "cache.jsonl",
                       "trace.json")):
    """The journals, the cache and every registry file, byte for byte; with
    ``checkpoints``, the search's checkpoints without their wall-clock
    ``history[].wall_s``."""
    out = {}
    for name in names:
        out[name] = open(os.path.join(root, name), "rb").read()
    sub = ("registry", "checkpoints") if checkpoints else ("registry",)
    for d in sub:
        for dirpath, _, files in os.walk(os.path.join(root, d)):
            for f in sorted(files):
                p = os.path.join(dirpath, f)
                blob = open(p, "rb").read()
                if d == "checkpoints":
                    doc = json.loads(blob)
                    for h in doc.get("history", []):
                        h.pop("wall_s")
                    blob = json.dumps(doc, sort_keys=True).encode()
                out[os.path.relpath(p, root)] = blob
    return out


# --------------------------------------------------------------------------
# the pure pieces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.25, 0.5, 0.9, 1.0])
def test_split_indices_equal_reference(fraction):
    for n, salt in ((0, "s"), (1, "a"), (20, "s"), (97, "trace:3")):
        assert T.split_indices(n, fraction, salt) == \
            R.split_indices(n, fraction, salt)
    with pytest.raises(ValueError):
        T.split_indices(3, 1.5, "s")


def _windows(rng, n):
    def side():
        return {"throughput_tok_s": float(rng.choice([0.0, rng.uniform(
                    1, 100)])),
                "mean_ttft_s": float(rng.choice([0.0, rng.uniform(0, 2)])),
                "reject_rate": float(rng.choice([0.0, rng.uniform(0, 1)]))}
    return [{"tick": t, "baseline": side(), "canary": side()}
            for t in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_verdict_of_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        kw = dict(min_throughput_ratio=float(rng.uniform(0.5, 1.2)),
                  max_ttft_ratio=float(rng.uniform(0.5, 3)),
                  max_reject_rate_delta=float(rng.choice([0.0, 0.1])),
                  windows=int(rng.integers(1, 4)))
        windows = _windows(rng, int(rng.integers(0, 5)))
        assert T.verdict_of(windows, T.Guardrails(**kw)) == \
            R.verdict_of(windows, R.Guardrails(**kw))


def _genomes(rng, n):
    keys = sorted(SERVE_SPACE)
    for _ in range(n):
        g = {k: SERVE_SPACE[k][rng.integers(len(SERVE_SPACE[k]))]
             for k in keys}
        if rng.random() < 0.3:      # an engine-only genome
            g = {k: g[k] for k in ("max_slots", "prefill_chunk")}
        yield g


@pytest.mark.parametrize("scenario", R.SCENARIOS)
def test_simulate_equals_reference(scenario):
    rng = np.random.default_rng(len(scenario))
    for seed in range(2):
        a = _trace(T, scenario, seed=seed)
        b = _trace(R, scenario, seed=seed)
        for g in _genomes(rng, 12):
            slow = float(rng.choice([1.0, 3.0]))
            assert T.simulate(a, g, slow=slow) == R.simulate(b, g, slow=slow)
            assert T.genome_fingerprint(g) == R.genome_fingerprint(g)


def test_canary_book_equals_reference(tmp_path):
    """The same transitions write the same journal bytes."""
    for pkg, name in ((T, "t.json"), (R, "r.json")):
        book = pkg.CanaryBook(str(tmp_path / name),
                              guardrails=pkg.Guardrails(windows=2))
        g = {"max_slots": 4, "prefill_chunk": 2}
        fp = pkg.genome_fingerprint(g)
        m = {"throughput_tok_s": 1.0, "mean_ttft_s": 1.0, "reject_rate": 0.0}
        assert book.propose(fp, g, tick=0)
        book.observe(tick=0, baseline=m, canary=m)
        book.observe(tick=0, baseline=m, canary=m)       # no-op
        assert book.decide(tick=0) is None
        book.observe(tick=1, baseline=m, canary=m)
        assert book.decide(tick=1) == pkg.PROMOTED
        assert book.force_rollback(tick=2) == pkg.ROLLED_BACK
        assert not book.propose(fp, g, tick=3)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()


# --------------------------------------------------------------------------
# the modeled controller against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("drill", ["promote", "rollback"])
def test_modeled_loop_writes_reference_bytes(tmp_path, drill):
    """Several ticks of the modeled loop: journals, registry, cache rows
    and checkpoints (less their clock) equal the reference's; so do the
    tick summaries and the status."""
    kw = {"fault_hook": _fault} if drill == "rollback" else {}
    got = _mk(T, tmp_path / "t", **kw)
    want = _mk(R, tmp_path / "r", **kw)
    a, b = got.run(5), want.run(5)
    assert a == b
    outcomes = [s["outcome"] for s in a]
    assert (R.PROMOTED if drill == "promote" else R.ROLLED_BACK) in outcomes
    assert _tree_bytes(str(tmp_path / "t"), checkpoints=True) == \
        _tree_bytes(str(tmp_path / "r"), checkpoints=True)
    assert got.status() == want.status()


def test_kill_and_resume_replays_reference_bytes(tmp_path):
    """Run 4 ticks; resume copies whose journals are rolled back to every
    earlier tick boundary: the journals and the registry of each converge
    to the unbroken run's bytes, which are the reference's."""
    ref_root = str(tmp_path / "ref")
    tr = _trace(T)
    loop = _mk(T, ref_root, trace=tr)
    journals = ("canary.json", "state.json")
    snapshots = []
    for _ in range(4):
        loop.tick()
        snapshots.append(_tree_bytes(ref_root, names=journals))
    want = _tree_bytes(ref_root, names=journals)
    _mk(R, tmp_path / "jax").run(4)
    assert _tree_bytes(str(tmp_path / "jax")) == _tree_bytes(ref_root)
    for kill_at in range(3):
        root = str(tmp_path / f"kill{kill_at}")
        shutil.copytree(ref_root, root)
        for name, blob in snapshots[kill_at].items():
            open(os.path.join(root, name), "wb").write(blob)
        resumed = _mk(T, root, trace=tr)
        assert resumed.state["tick"] == kill_at + 1
        resumed.run(4 - (kill_at + 1))
        assert _tree_bytes(root, names=journals) == want, \
            f"resume from tick {kill_at} diverged"


def test_replayed_tick_is_idempotent(tmp_path):
    """Re-measuring and re-observing a committed tick rewrites nothing."""
    root = str(tmp_path / "loop")
    _mk(T, root).run(3)
    before = _tree_bytes(root)
    again = _mk(T, root)
    t = again.state["tick"] - 1
    window = again._window_slice(t)
    inc = again.book.promoted
    if again.book.active is not None:
        g = again.book.active["genome"]
        again.book.observe(tick=t, baseline=T.simulate(
            window, inc["genome"] if inc else dict(DEFAULT_SERVE_PLAN)),
            canary=T.simulate(window, g))
    again._sync_promoted()
    assert _tree_bytes(root) == before


def test_resume_binds_trace_mode_and_journaled_wiring(tmp_path):
    root = tmp_path / "loop"
    _mk(T, root).run(1)
    with pytest.raises(ValueError, match="trace"):
        T.LiveLoopController(str(root), trace=_trace(T, "steady", seed=9))
    back = T.LiveLoopController(str(root), mode="real")
    assert back.mode == "modeled" and back.measure == back._measure_modeled
    assert back.workload.time_mode == "static"
    real = str(tmp_path / "real")
    T.LiveLoopController(real, trace=_trace(T), mode="real",
                         arch="minicpm-2b")
    back = T.LiveLoopController(real)
    assert back.mode == "real" and back.arch == "minicpm-2b"
    assert back.measure == back._measure_real
    assert back.book.rails.min_throughput_ratio == pytest.approx(0.95)
    assert back._cfg is None        # no model and no device until a replay


# --------------------------------------------------------------------------
# the real backend on the CPU
# --------------------------------------------------------------------------


def _real(root, **kw):
    tr = T.synthesize("bursty", vocab=64, n_requests=6, max_prompt=8,
                      gen=3, seed=0)
    return T.LiveLoopController(
        str(root), trace=tr, mode="real", pop=4, repeats=1, surrogate=False,
        device="cpu",
        guardrails=T.Guardrails(windows=1, min_throughput_ratio=0.0,
                                max_ttft_ratio=1e9), **kw)


def test_real_canary_routes_a_multi_replica_plan(tmp_path, monkeypatch):
    """A replicas=2 plan replays through the router, a single-engine plan
    through one engine; both answer every request on the CPU."""
    ctl = _real(tmp_path / "loop")
    routers = []
    orig = Router.__init__

    def spy(self, engines, **kw):
        routers.append(len(engines))
        orig(self, engines, **kw)
    monkeypatch.setattr(Router, "__init__", spy)
    base_m, can_m = ctl.measure(dict(DEFAULT_SERVE_PLAN),
                                dict(DEFAULT_SERVE_PLAN, replicas=2), 0)
    assert routers and set(routers) == {2}     # warm-up and measured replay
    assert ctl._params.device.type == "cpu"
    n = len(ctl._window_slice(0).items)
    for m in (base_m, can_m):
        assert m["n"] == n and m["reject_rate"] == 0.0
        assert m["throughput_tok_s"] > 0


def test_real_plan_whose_replicas_die_rolls_back(tmp_path, monkeypatch):
    """A canaried replicas=2 plan whose replicas all die mid-measurement
    trips the reject-rate guardrail: rolled back, blocked, no hang, every
    cache row intact."""
    ctl = _real(tmp_path / "loop")
    genome = dict(DEFAULT_SERVE_PLAN, replicas=2)
    fp = T.genome_fingerprint(genome)
    assert ctl.book.propose(fp, genome, tick=0)
    orig_step = Router.step

    def dying_step(self):
        if self.n_ticks >= 1:
            for r in self.replicas:
                if r.alive:
                    self.kill_replica(r.index, reason="injected crash")
        orig_step(self)
    monkeypatch.setattr(Router, "step", dying_step)
    base_g = dict(DEFAULT_SERVE_PLAN)
    base_m, can_m = ctl.measure(base_g, genome, 0)
    assert base_m["reject_rate"] == 0.0
    assert can_m["reject_rate"] > 0.0
    ctl._publish_window(base_g, base_m, role="baseline", tick=0)
    ctl._publish_window(genome, can_m, role="canary", tick=0)
    ctl.book.observe(tick=0, baseline=base_m, canary=can_m)
    assert ctl.book.decide(tick=0) == T.ROLLED_BACK
    ctl._sync_promoted()
    assert ctl.book.active is None and ctl.book.promoted is None
    assert fp in ctl.book.status()["blocked"]
    assert not ctl.book.propose(fp, genome, tick=1)
    for line in open(tmp_path / "loop" / "cache.jsonl"):
        rec = json.loads(line)
        assert "fitness" in rec and "writer" in rec


@pytest.mark.parametrize("replicas", [1, 2])
def test_real_measurement_lets_a_device_fault_through(tmp_path, monkeypatch,
                                                      replicas):
    """A device fault in a replay (through the router for replicas=2)
    leaves the canary measurement, and the tick, as an exception: no window
    is journaled, nothing is rolled back or blocked."""
    ctl = _real(tmp_path / "loop")
    genome = dict(DEFAULT_SERVE_PLAN, replicas=replicas, max_slots=4)
    assert ctl.book.propose(T.genome_fingerprint(genome), genome, tick=0)
    before = (tmp_path / "loop" / "canary.json").read_bytes()

    def faulting(self):
        raise DeviceFault("rmsnorm: launch refused")
    monkeypatch.setattr(ServeEngine, "begin_step", faulting)
    with pytest.raises(DeviceFault, match="launch refused"):
        ctl.measure(genome, genome, 0)
    with pytest.raises(DeviceFault, match="launch refused"):
        ctl.tick()
    assert (tmp_path / "loop" / "canary.json").read_bytes() == before
    assert ctl.book.status()["blocked"] == []
    assert ctl.state["tick"] == 0


def test_real_tick_on_the_cpu(tmp_path):
    """One whole real-mode tick: a measured generation of the serve plan
    search, a candidate, a measured canary window."""
    ctl = _real(tmp_path / "loop", gens_per_tick=1)
    s = ctl.tick()
    assert s["tick"] == 0 and len(s["best_fitness"]) == 2
    assert all(f > 0 for f in s["best_fitness"])
    assert ctl.state["tick"] == 1


def test_real_loop_refuses_a_trace_beyond_the_vocab(tmp_path):
    """A real loop's trace must fit the smoke config's vocab (the CLI's
    ``synth`` defaults to 1024): it is refused before anything is
    journaled or replayed.  A modeled loop runs no model and takes it."""
    tr = T.synthesize("bursty", vocab=1024, n_requests=6, max_prompt=8,
                      gen=3, seed=0)
    root = tmp_path / "real"
    with pytest.raises(ValueError, match="synth --vocab 512"):
        T.LiveLoopController(str(root), trace=tr, mode="real", device="cpu")
    assert not (root / "state.json").exists()
    T.LiveLoopController(str(tmp_path / "modeled"), trace=tr,
                         mode="modeled")


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


def _both(tmp_path, capsys, monkeypatch, argv):
    """Run the live-loop CLI of each package with ``argv`` from its own
    directory (paths in ``argv`` relative); returns the two (rc, stdout,
    stderr)."""
    out = []
    for name, main in (("t", liveloop_main), ("r", ref_liveloop_main)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        rc = main(argv)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_liveloop_cli_equals_reference(tmp_path, capsys, monkeypatch):
    """synth, run, status, promote and rollback print what the reference
    prints and leave the same journals."""
    steps = [["synth", "--scenario", "bursty", "--n-requests", "8",
              "--vocab", "64", "--out", "trace.json"],
             ["run", "--root", "loop", "--trace", "trace.json", "--ticks",
              "2", "--pop", "6", "--windows", "10"],
             ["status", "--root", "loop"],
             ["promote", "--root", "loop"],
             ["rollback", "--root", "loop"],
             ["rollback", "--root", "loop"],
             ["run", "--root", "loop", "--ticks", "1", "--pop", "6",
              "--inject-regression"],
             ["status", "--root", "nope"]]
    for argv in steps:
        got, want = _both(tmp_path, capsys, monkeypatch, argv)
        assert got == want, argv
    assert got[0] == 1
    for name in ("canary.json", "state.json", "cache.jsonl"):
        assert (tmp_path / "t" / "loop" / name).read_bytes() == \
            (tmp_path / "r" / "loop" / name).read_bytes()


def _deploy_both(tmp_path, capsys, monkeypatch, argv):
    from repro.core.deploy.__main__ import main as ref_deploy_main
    out = []
    for name in ("t", "r"):
        monkeypatch.chdir(tmp_path / name)
        try:
            if name == "t":
                deploy_main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["deploy", *argv])
                ref_deploy_main()
            rc = 0
        except SystemExit as e:
            rc = e.code
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_deploy_cli_equals_reference(tmp_path, capsys, monkeypatch):
    """select, export and list over a recorded front (genomes) and a
    GevoML checkpoint (patches) print the reference's bytes and export the
    reference's artifacts."""
    rng = np.random.default_rng(0)
    pareto = [{"genome": g, "fitness": [float(rng.uniform(1, 2)),
                                        float(rng.uniform(0, 0.1))]}
              for g in _genomes(rng, 8)]
    for name in ("t", "r"):
        d = tmp_path / name
        d.mkdir()
        (d / "front.json").write_text(json.dumps(
            {"arch": "qwen3-0.6b", "shape": "s", "pareto": pareto}))
    _mk(T, tmp_path / "loop").run(1)
    ckpt = str(tmp_path / "loop" / "checkpoints" / "latest.json")
    steps = [["list", "--artifacts", "arts"],
             ["select", "--front", "front.json", "--within", "0.02"],
             ["select", "--front", "front.json", "--minimize", "error",
              "--on", "time", "--limit", "1.5"],
             ["export", "--front", "front.json", "--within", "0.5",
              "--relative", "--artifacts", "arts", "--kind", "serve",
              "--name", "qwen3-0.6b", "--shape", "smoke"],
             ["list", "--artifacts", "arts"],
             ["select", "--front", ckpt],
             ["export", "--front", ckpt, "--artifacts", "arts", "--kind",
              "plan", "--name", "m", "--shape", "s"]]
    for argv in steps:
        got, want = _deploy_both(tmp_path, capsys, monkeypatch, argv)
        assert got == want, argv
    assert got[0][0] != 0           # a patch does not export
    assert _tree_bytes_dir(tmp_path / "t" / "arts") == \
        _tree_bytes_dir(tmp_path / "r" / "arts")


def _tree_bytes_dir(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


# --------------------------------------------------------------------------
# launch.serve: the router and the live loop
# --------------------------------------------------------------------------


SERVE = ["--smoke", "--device", "cpu", "--requests", "4", "--prompt-len",
         "8", "--gen", "3"]


def test_serve_cli_through_the_router(capsys):
    from repro_torch.launch.serve import main
    main(SERVE + ["--replicas", "2"])
    out = capsys.readouterr().out
    assert "requests=4" in out and "replicas=2/2" in out
    assert "'replicas': 2" in out and "later work" not in out


def test_serve_cli_with_the_liveloop(tmp_path, capsys):
    """--liveloop advances a modeled loop until it promotes, then serves
    its promoted schedule; before any promotion, the default one."""
    from repro_torch.launch.serve import main
    root = tmp_path / "loop"
    _mk(T, root)
    main(SERVE + ["--liveloop", str(root)])
    assert "nothing promoted yet" in capsys.readouterr().out
    main(SERVE + ["--liveloop", str(root), "--liveloop-ticks", "3"])
    out = capsys.readouterr().out
    live = T.LiveLoopController(str(root)).book.promoted
    assert live is not None
    assert f"fingerprint {live['fingerprint'][:12]}" in out
    assert f"'max_slots': {live['genome']['max_slots']}" in out
    assert "requests=4" in out
