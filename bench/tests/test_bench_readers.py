"""The per-layer readers on a made-up traced window: what each reads, and
that a reader with nothing to read returns nothing."""

import pytest

import run as bench_run
from harness.costs import cost
from harness.program import Run
from harness.trace import Trace, call_shape

CONFIG = {"kernel_calls": {"train_step": {"rmsnorm": 2, "mamba_scan": 1}}}


def _trace(calls=()):
    ms = 1_000_000
    device = [(0, 10 * ms, "void rmsnorm_row_kernel<float, float>()"),
              (5 * ms, 20 * ms, "void scan_kernel<float, 16>()"),
              (30 * ms, 40 * ms, "void rmsnorm_bwd_sum_kernel<float>()"),
              (42 * ms, 44 * ms, "Memcpy DtoD (Device -> Device)")]
    host = [(0, 50 * ms, "bench.train_step"),
            (21 * ms, 29 * ms, "bench.grad_norm")]
    blocking = [(44 * ms, 49 * ms, "aten::item")]
    return Trace(0, 50 * ms, device, host, blocking, list(calls))


def _read(name, run, **params):
    return bench_run.reader(name).read(run, **params)


def test_idle_share_and_breakdown():
    t = _trace()
    assert t.busy_ns() == 32_000_000 and t.window_s == 0.05
    assert _read("idle_share", Run(CONFIG, trace=t)) == \
        pytest.approx(36.0)
    b = t.breakdown()
    assert b["device_ops"][0] == ["void scan_kernel<float, 16>()", 0.015]
    assert b["idle_gaps"] == [["bench.grad_norm", 0.01],
                              ["aten::item", 0.006],
                              ["bench.train_step", 0.002]]
    assert _read("idle_share", Run(CONFIG)) is None


def test_roofline_checks_the_calls():
    norm = {"rows": 4096, "d": 4096, "dtype": "bfloat16",
            "scale_dtype": "bfloat16"}
    calls = [("rmsnorm", "fwd", norm)] * 2 + [("rmsnorm", "bwd", norm)] * 2
    t = _trace(calls)
    t.device += [(45_000_000, 45_000_000, "rmsnorm_row_kernel")] * 2
    run = Run(CONFIG, trace=t, units=1)
    params = {"kernel": "rmsnorm", "directions": ["fwd", "bwd"],
              "device_pattern": r"\brmsnorm_\w*kernel\b", "per": "train_step"}
    least = 2 * (cost("rmsnorm", "fwd", norm).least_s()
                 + cost("rmsnorm", "bwd", norm).least_s())
    assert _read("roofline", run, **params) == pytest.approx(
        100 * least / 0.02)
    run.units = 2          # the configuration implies 4 calls a direction
    assert _read("roofline", run, **params) is None
    run = Run(CONFIG, trace=_trace(), units=1)
    params.update(kernel="mamba_scan", directions=["fwd"])
    assert _read("roofline", run, **params) is None


def test_launches_counts_kernels_not_copies():
    run = Run(CONFIG, trace=_trace(), units=3)
    assert _read("launches", run) == 1.0


def test_mfu_and_server_readers():
    run = Run(CONFIG, trace=_trace(), model_flops=989e12 * 0.5,
              work_s=2.0, step_ms={"decode": [30.0, 10.0, 20.0]},
              queue_wait_s=[0.1 * i for i in range(1, 11)])
    assert _read("mfu", run) == pytest.approx(25.0)
    assert _read("decode_tick", run) == 20.0
    assert _read("queue_wait", run, percentile=90) == pytest.approx(0.9)
    empty = Run(CONFIG)
    assert _read("mfu", empty) is None and _read("decode_tick", empty) \
        is None and _read("queue_wait", empty, percentile=90) is None


def test_call_shapes():
    import torch
    x = torch.zeros(6, 8, dtype=torch.bfloat16)
    assert call_shape("rmsnorm", "fwd", (x, torch.ones(8)), {}) == {
        "rows": 6, "d": 8, "dtype": "bfloat16", "scale_dtype": "float32"}
    q = torch.zeros(1, 2, 16, 32)
    got = call_shape("flash_attention", "fwd", (q, q, q, q),
                     {"causal": True, "lse": None})
    assert got == {"B": 1, "H": 2, "S": 16, "hd": 32, "dtype": "float32",
                   "Sk": 16, "causal": True, "lse": False}
    dt = torch.zeros(2, 64, 8)
    A = torch.zeros(8, 4)
    got = call_shape("mamba_scan", "bwd", (dt, dt, A, 0, 0, 0, None),
                     {"chunk": 32})
    assert got == {"Bt": 2, "L": 64, "D": 8, "N": 4, "dtype": "float32",
                   "chunk": 32, "dh_last": False}
