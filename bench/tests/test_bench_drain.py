"""What a serving run does with the requests still unanswered at the
window's close, by its mix's ``drain``: ``all`` answers every request due
in the window; ``admitted`` drops those still waiting for a slot and
answers the rest, and ``serve_tokens_per_s`` counts only what finished
inside the window."""

import pytest

from harness import cells, serve
from harness.trace import Tracer
from harness.traffic import open_loop
from tiny import SERVE


def _run(root, **traffic):
    cell = cells.cell(SERVE, root=root)
    cell.traffic.update(traffic)
    return cell, serve.run(cell, seed=3, seconds=0.5, tracer=Tracer(False),
                           device="cpu", clock=lambda: 0.0)


def test_drain_all_answers_every_request(tiny_root):
    cell, run = _run(tiny_root, rate=80.0, drain="all")
    due = len(open_loop(cell.traffic, 512, 3, 0.5))
    assert run.correct and run.attempted == due == 40 and run.failed == 0
    assert run.e2e["serve_tokens_per_s"] > 0


def test_drain_admitted_drops_the_backlog(tiny_root):
    cell, run = _run(tiny_root, rate=2000.0, drain="admitted")
    due = len(open_loop(cell.traffic, 512, 3, 0.5))
    assert run.correct and run.failed == 0
    assert 0 < run.attempted < due == 1000
    assert run.extra["done_in_window"] <= run.attempted
    assert run.e2e["serve_tokens_per_s"] > 0


def test_unknown_drain_raises(tiny_root):
    with pytest.raises(ValueError, match="unknown drain 'some'"):
        _run(tiny_root, drain="some")
