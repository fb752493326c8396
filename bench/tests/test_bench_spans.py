"""The readers of the port's own spans (``harness/program_spans.py``:
``span_ms``, ``span_attr``, ``idle_under``) on hand-made records, and on
the spans a tiny traced run records."""

import sys
from types import SimpleNamespace

import pytest

import run as bench_run
from harness.program import Run
from harness.trace import Trace
from tiny import SERVE, TRAIN, run_cell

MS = 1_000_000


def _span(name, start, end, parent=None, device_ms=None, **attrs):
    return SimpleNamespace(name=name, parent=parent,
                           start_ns=int(start * MS), end_ns=int(end * MS),
                           thread=1, attrs=attrs,
                           device_ms=device_ms)


def _train_records():
    out = []
    for k, t in enumerate((0, 40)):
        step = _span("train.step", t, t + 30, device_ms=30.0)
        out += [step,
                _span("train.forward", t, t + 5, step, 4.0 + k),
                _span("train.backward", t + 5, t + 15, step, 9.0),
                _span("train.forward", t + 15, t + 20, step, 4.0 + k),
                _span("train.backward", t + 20, t + 28, step, 9.0),
                _span("train.optimizer", t + 28, t + 30, step, 3.0 + 2 * k)]
    return out


def _serve_records():
    # a span begins after the span around it, as the port's do
    tick = _span("serve.tick", 0, 90)
    admit = _span("serve.admit", 0.25, 50, tick)
    prefill = _span("serve.prefill", 2, 30, admit, 20.0, rows=2, tokens=200)
    return [tick, admit,
            _span("serve.select", 0.5, 2, admit),
            prefill,
            _span("serve.prefill.batch", 2.5, 6, prefill),
            _span("serve.prefill.sample", 30, 35, admit),
            _span("serve.install", 35, 50, admit),
            _span("serve.prefill", 50, 60, tick, 6.0, rows=1, tokens=100),
            _span("serve.decode.dispatch", 60, 70, tick, lanes=3,
                  kv_positions=300, kv_capacity=1200),
            _span("serve.decode.dispatch", 70, 75, tick, lanes=4,
                  kv_positions=500, kv_capacity=1200),
            _span("serve.decode.sample", 75, 90, tick)]


def _trace(recs, device=()):
    t = Trace(0, 100 * MS, [(s * MS, e * MS, "k") for s, e in device], [],
              [])
    t.program = recs
    return t


def _read(name, run, **params):
    return bench_run.reader(name).read(run, **params)


def test_span_ms_per_step_and_per_token():
    run = Run({}, trace=_trace(_train_records()))
    assert _read("span_ms", run, span="train.forward",
                 per="train.step") == pytest.approx(9.0)   # 8 and 10
    assert _read("span_ms", run, span="train.backward",
                 per="train.step") == pytest.approx(18.0)
    assert _read("span_ms", run, span="train.optimizer",
                 per="train.step") == pytest.approx(4.0)
    run = Run({}, trace=_trace(_serve_records()))
    assert _read("span_ms", run, span="serve.prefill", over="tokens") == \
        pytest.approx(1e3 * 26.0 / 300)
    assert _read("span_ms", run, span="serve.decode.dispatch",
                 over="tokens") is None       # not timed on the device


def test_span_attr_mean_and_share():
    run = Run({}, trace=_trace(_serve_records()))
    assert _read("span_attr", run, span="serve.prefill",
                 attr="rows") == pytest.approx(1.5)
    assert _read("span_attr", run, span="serve.decode.dispatch",
                 attr="lanes") == pytest.approx(3.5)
    assert _read("span_attr", run, span="serve.decode.dispatch",
                 attr="kv_positions", over="kv_capacity",
                 scale=100.0) == pytest.approx(100 * 800 / 2400)


def test_idle_under_sums_to_idle_share():
    device = [(1, 3), (5, 7), (31, 34), (52, 58), (61, 62), (76, 77),
              (95, 99)]
    run = Run({}, trace=_trace(_serve_records(), device))
    share = _read("idle_share", run)
    names = {s.name for s in _serve_records()}
    parts = {n: _read("idle_under", run, spans=[n]) for n in names}
    t = run.trace
    outside = 100.0 * sum(e - s for s, e in t.gaps()
                          if (s + e) // 2 >= 90 * MS) / (100 * MS)
    assert outside > 0
    assert sum(parts.values()) + outside == pytest.approx(share)
    # gaps (0, 1) select's middle 0.5, (3, 5) the prefill's batch, (7, 31) prefill,
    # (34, 52) install's middle 43, (58, 61) prefill's middle 59,
    # (62, 76) dispatch's middle 69, (77, 95) sample's middle 86,
    # (99, 100) outside
    assert parts["serve.select"] == pytest.approx(1.0)
    assert parts["serve.prefill.batch"] == pytest.approx(2.0)
    assert parts["serve.prefill"] == pytest.approx(24.0 + 3.0)
    assert parts["serve.install"] == pytest.approx(18.0)
    assert parts["serve.decode.dispatch"] == pytest.approx(14.0)
    assert _read("idle_under", run, spans=[
        "serve.admit", "serve.select", "serve.install"]) == \
        pytest.approx(19.0)


@pytest.mark.parametrize("reader,params", [
    ("span_ms", {"span": "train.forward", "per": "train.step"}),
    ("span_ms", {"span": "serve.prefill", "over": "tokens"}),
    ("span_attr", {"span": "serve.prefill", "attr": "rows"}),
    ("idle_under", {"spans": ["serve.admit"]})])
def test_readers_without_program_spans_return_nothing(reader, params,
                                                      monkeypatch):
    assert _read(reader, Run({}), **params) is None
    assert _read(reader, Run({}, trace=_trace([], [(1, 2)])),
                 **params) is None
    # a port without the spans module, as the parent commit's
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    t = _trace([], [(1, 2)])
    t.program = None
    assert _read(reader, Run({}, trace=t), **params) is None


def test_a_tiny_traced_run_reads_the_port_s_spans(tiny_root):
    """On the CPU the counters read and the device times do not (no
    CUDA): the spans that began in the window, none after it."""
    from harness import cells
    cell = cells.cell(SERVE, root=tiny_root)
    run = run_cell(tiny_root, SERVE, seconds=0.5, trace=True)
    got = bench_run.per_layer(cell, run, tiny_root)
    for name in ("prefill_rows.serve", "lanes_per_tick.serve",
                 "live_kv_share.serve"):
        assert got[name]["value"] > 0, name
    assert "prefill_us_per_token.serve" not in got
    t = run.trace
    assert t.program and all(t.t0_ns <= s.start_ns < t.t1_ns
                             for s in t.program)
    assert {s.name for s in t.program} >= {"serve.tick", "serve.prefill",
                                           "serve.decode.dispatch"}
    cell = cells.cell(TRAIN, root=tiny_root)
    run = run_cell(tiny_root, TRAIN, seconds=0.5, trace=True)
    assert "forward_ms.train" not in bench_run.per_layer(cell, run,
                                                         tiny_root)
    steps = [s for s in run.trace.program if s.name == "train.step"]
    assert len(steps) == run.units
