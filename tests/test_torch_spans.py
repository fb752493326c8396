"""The port's own spans (``repro_torch.spans``) in the serving engine and
the train step, on the CPU with smoke configs: the no-op when nothing
records, the span tree of an engine run and of a microbatched step, the
counters against what the engine holds, results bit for bit with and
without a recording, the spans' clock against torch.profiler's, the
bound on what a profiled process keeps, and the port's readers of device
events leaving the spans' annotations out.  The one ``cuda`` test times a
step's parts on the card.

    PYTHONPATH=src python -m pytest -q tests/test_torch_spans.py
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.deploy import ServeEngine, ServeRequest
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainState, make_train_step

SERVE_TREE = {"serve.tick": None, "serve.admit": "serve.tick",
              "serve.select": "serve.admit", "serve.prefill": "serve.admit",
              "serve.prefill.batch": "serve.prefill",
              "serve.prefill.sample": "serve.admit",
              "serve.install": "serve.admit",
              "serve.decode.dispatch": "serve.tick",
              "serve.decode.sample": "serve.tick"}
TRAIN_TREE = {"train.step": None, "train.forward": "train.step",
              "train.backward": "train.step", "train.optimizer": "train.step"}
PROMPTS = (8, 5, 8, 3, 8, 6)


@pytest.fixture(scope="module")
def qwen():
    cfg = smoke_config("qwen3-0.6b")
    return cfg, init_params(cfg, device="cpu")


def _requests(cfg, lens=PROMPTS, gen=4):
    rng = np.random.default_rng(3)
    return [ServeRequest(f"r{i}", rng.integers(0, cfg.vocab, n).astype(
        np.int32), gen) for i, n in enumerate(lens)]


def _serve(cfg, params, **kw):
    eng = ServeEngine(cfg, params, max_len=16, max_slots=3,
                      prefill_chunk=2, device="cpu", **kw)
    return eng, {r.uid: r.tokens for r in eng.run(_requests(cfg),
                                                  stagger=2)}


def _train(cfg, params, steps=2, microbatches=2):
    opt = adamw(lr=1e-3)
    state = TrainState(params, opt.init(dict(params.named_parameters())))
    step = make_train_step(cfg, opt, microbatches=microbatches)
    rng = np.random.default_rng(5)
    for _ in range(steps):
        t = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 9)))
        state, _ = step(state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
    return state


def _tree_holds(recs, tree):
    assert {s.name for s in recs} == set(tree)
    for s in recs:
        want = tree[s.name]
        assert (s.parent.name if s.parent else None) == want, s.name
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns <= \
                s.parent.end_ns, s.name


def test_without_a_recording_a_span_is_the_shared_noop(qwen, monkeypatch):
    cfg, params = qwen

    def forbidden(*a, **k):
        raise AssertionError("made with no recording")
    monkeypatch.setattr(spans._profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(spans, "Span", forbidden)
    assert spans.span("x") is spans._OFF
    assert spans.span("y", device=True) is spans._OFF
    with spans.span("z") as s:
        assert not s
        s.set(lanes=1)
    # the call sites compute their counters only for a recorded span
    monkeypatch.setattr(spans._Off, "set", forbidden)
    _serve(cfg, params)
    _train(cfg, copy.deepcopy(params), steps=1)
    assert spans.take_profiled() == []


def test_engine_spans_form_the_tree_and_count_the_work(qwen):
    cfg, params = qwen
    eng = ServeEngine(cfg, params, max_len=16, max_slots=3, prefill_chunk=2,
                      device="cpu")
    want = []   # (lanes, summed index, capacity) at each dispatch
    dispatch = eng._decode_dispatch

    def counted():
        active = eng.batches["default"].active()
        want.append((len(active), sum(l.index for _, l in active),
                     3 * eng.max_len))
        return dispatch()
    eng._decode_dispatch = counted
    reqs = _requests(cfg)
    with spans.recording() as recs:
        eng.run(reqs, stagger=2)
    _tree_holds(recs, SERVE_TREE)
    by = {n: [s for s in recs if s.name == n] for n in SERVE_TREE}
    assert len(by["serve.tick"]) == eng.n_ticks
    pre = by["serve.prefill"]
    assert len(pre) == eng.n_prefill_batches == len(by["serve.prefill.batch"])
    assert sum(s.attrs["rows"] for s in pre) == len(PROMPTS)
    assert sum(s.attrs["tokens"] for s in pre) == sum(PROMPTS)
    # a group is one prompt length: its tokens are its rows times one
    assert all(s.attrs["tokens"] // s.attrs["rows"] in PROMPTS and
               s.attrs["tokens"] % s.attrs["rows"] == 0 for s in pre)
    assert len(by["serve.install"]) == len(pre)
    got = [(s.attrs["lanes"], s.attrs["kv_positions"],
            s.attrs["kv_capacity"]) for s in by["serve.decode.dispatch"]]
    assert got == want and len(got) == eng.n_decode_batches
    assert len(by["serve.decode.sample"]) == eng.n_decode_batches
    assert all(s.device_ms is None for s in recs)     # no CUDA here
    # the counters the benchmark reads, and no other
    assert {k for s in recs for k in s.attrs} == {
        "rows", "tokens", "lanes", "kv_positions", "kv_capacity"}


def test_train_spans_form_the_tree(qwen):
    cfg, params = qwen
    with spans.recording() as recs:
        _train(cfg, copy.deepcopy(params), steps=2, microbatches=2)
    _tree_holds(recs, TRAIN_TREE)
    for st in (s for s in recs if s.name == "train.step"):
        kids = [s.name for s in recs if s.parent is st]
        assert kids == ["train.forward", "train.backward"] * 2 + [
            "train.optimizer"]
    assert all(s.attrs == {} for s in recs)


def test_recording_leaves_tokens_and_state_bit_identical(qwen):
    cfg, params = qwen
    _, off = _serve(cfg, params)
    with spans.recording():
        _, on = _serve(cfg, params)
    assert on == off
    s_off = _train(cfg, copy.deepcopy(params))
    with spans.recording():
        s_on = _train(cfg, copy.deepcopy(params))
    for (n, a), (_, b) in zip(s_off["params"].named_parameters(),
                              s_on["params"].named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n, a in s_off["opt_state"][k].items():
            assert torch.equal(a, s_on["opt_state"][k][n]), (k, n)


def test_spans_follow_the_profiler_on_its_clock(qwen):
    """Under torch.profiler, with no recording entered, the spans go to
    the profile's recording, handed over once; each lies inside the
    ``record_function`` range the profile reports for it."""
    cfg, params = qwen
    assert spans.take_profiled() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cfg, params)
    recs = spans.take_profiled()
    assert spans.take_profiled() == []
    _tree_holds(recs, SERVE_TREE)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() in SERVE_TREE)
    for name in SERVE_TREE:
        mine = [s for s in recs if s.name == name]
        theirs = [(a, b) for a, b, n in ranges if n == name]
        assert len(mine) == len(theirs), name
        for s, (a, b) in zip(mine, theirs):
            assert a <= s.start_ns <= s.end_ns <= b, name


def test_the_profiler_s_recording_keeps_the_newest_spans(qwen,
                                                        monkeypatch):
    """A process that profiles and never takes the spans holds at most
    ``PROFILED_MAX`` of them: the newest, in order."""
    cfg, params = qwen
    assert spans.take_profiled() == []
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(cfg, params)
    every = spans.take_profiled()
    monkeypatch.setattr(spans, "PROFILED_MAX", 7)
    for _ in range(2):      # two profiles, nothing taken between them
        with profile(activities=[ProfilerActivity.CPU]):
            _serve(cfg, params)
    kept = spans.take_profiled()
    assert len(every) > 7
    assert [s.name for s in kept] == [s.name for s in every[-7:]]
    assert kept[0].start_ns > every[-1].end_ns


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_spans", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_device_event_readers_leave_out_the_spans_annotations():
    """A span's ``record_function`` range shows on the device's timeline
    as a user annotation; the port's readers of a profile's device events
    (``chip_smoke.device_spans``, the live loop's ``busy_seconds``) count
    kernels and copies only."""
    from types import SimpleNamespace as NS

    from repro_torch.core.liveloop.controller import busy_seconds
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # (name, device type, user annotation, start us, end us)
    events = [("serve.tick", cuda, True, 0, 100),
              ("gemm", cuda, False, 10, 30),
              ("copy", cuda, False, 50, 55),
              ("spin_kernel", cuda, False, 0, 5),
              ("serve.tick", cpu, False, 0, 100)]
    prof = NS(
        events=lambda: [NS(name=n, device_type=d, is_user_annotation=u,
                           time_range=NS(start=a, end=b))
                        for n, d, u, a, b in events],
        profiler=NS(kineto_results=NS(events=lambda: [
            NS(name=lambda n=n: n, device_type=lambda d=d: d,
               is_user_annotation=lambda u=u: u,
               duration_ns=lambda a=a, b=b: 1000 * (b - a))
            for n, d, u, a, b in events])))
    assert _chip_smoke().device_spans(torch, prof) == [
        (10, 30, "gemm"), (50, 55, "copy")]
    assert busy_seconds(prof) == (pytest.approx(25e-6), 2)


@pytest.mark.cuda
def test_step_parts_sum_to_the_step_on_the_card():
    """The device times of a step's forward, backward and optimizer spans
    sum to its ``train.step`` span's within 3%: at this size the host runs
    ahead of the device, so nothing of the step's device time falls
    between its parts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = get_config("qwen3-0.6b").scaled(n_layers=4)
    params = init_params(cfg, device="cuda")
    opt = adamw(lr=1e-4)
    state = TrainState(params, opt.init(dict(params.named_parameters())))
    step = make_train_step(cfg, opt)
    t = torch.randint(0, cfg.vocab, (2, 2049), device="cuda")
    b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    state, _ = step(state, b)     # builds the kernels
    torch.cuda.synchronize()
    with spans.recording() as recs:
        for _ in range(3):
            state, _ = step(state, b)
        torch.cuda.synchronize()
    for st in (s for s in recs if s.name == "train.step"):
        parts = sum(s.device_ms for s in recs if s.parent is st)
        assert st.device_ms > 0
        assert abs(parts - st.device_ms) <= 0.03 * st.device_ms, \
            (parts, st.device_ms)
