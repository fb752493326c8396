"""The real live loop's canary windows on the card, held on the CPU.

On the GPU a real window replays its slice ``CARD_WINDOW_REPEATS`` times
under each plan, the two plans' replays in turns, each replay's
throughput taken over device time (``_device_timed``), and keeps each
plan's median-throughput replay; elsewhere it keeps the controller's own
measurement (``_replay_real`` of one plan, then of the other), so the
real-backend tests on the CPU keep their window settings.  The replays
here are stand-ins that record their order, and the device timing a
stand-in that marks what it timed; the device is named, not used.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from repro_torch.core.liveloop import controller as C
from repro_torch.core.liveloop.traces import synthesize


@pytest.fixture
def ctl(tmp_path):
    return C.LiveLoopController(str(tmp_path / "loop"), mode="real",
                                trace=synthesize(vocab=512, n_requests=8),
                                device="cpu")


def _stand_in(order: list, speeds: dict):
    def replayer(trace, genome):
        runs = iter(speeds[genome["plan"]])

        def one() -> dict:
            order.append(genome["plan"])
            return {"throughput_tok_s": next(runs)}
        return one
    return replayer


def test_card_windows_take_turns_and_keep_each_median(ctl, monkeypatch):
    n = C.CARD_WINDOW_REPEATS
    speeds = {"a": [float(i) for i in range(n)],
              "b": [float(100 - i) for i in range(n)]}
    order: list = []
    monkeypatch.setattr(ctl, "_replayer", _stand_in(order, speeds))
    monkeypatch.setattr(ctl, "_model", lambda: (
        None, SimpleNamespace(device=torch.device("cuda", 0))))
    monkeypatch.setattr(C, "_device_timed",
                        lambda one: lambda: dict(one(), device_timed=True))
    base, cand = ctl.measure({"plan": "a"}, {"plan": "b"}, 3)
    assert order == ["a", "b"] * n
    assert base["throughput_tok_s"] == sorted(speeds["a"])[n // 2]
    assert cand["throughput_tok_s"] == sorted(speeds["b"])[n // 2]
    assert base["device_timed"] and cand["device_timed"]


def test_cpu_windows_keep_the_controllers_measurement(ctl, monkeypatch):
    seen: list = []

    def replay_real(trace, genome):
        seen.append((len(trace), genome["plan"]))
        return {"throughput_tok_s": 1.0}
    monkeypatch.setattr(ctl, "_replay_real", replay_real)
    monkeypatch.setattr(ctl, "_model", lambda: (
        None, SimpleNamespace(device=torch.device("cpu"))))
    ctl.measure({"plan": "a"}, {"plan": "b"}, 3)
    n = len(ctl._window_slice(3))
    assert seen == [(n, "a"), (n, "b")]
