"""``correct`` comes out false when the timed path is broken underneath:
a step that returns its state unchanged, half of each batch left out, a
served token altered where it is produced; and the fp8 control reads far
above the program.  Tiny cells on the CPU, past the look for a card; the
control at the cells' own sizes is the ``cuda`` test below."""

import pytest

import control
from harness import cells, serve, train
from harness.trace import Tracer
from tiny import SERVE, TRAIN, run_cell


def test_sound_runs_are_correct(tiny_root):
    assert run_cell(tiny_root, TRAIN, seconds=0.3).correct
    assert run_cell(tiny_root, SERVE, seconds=0.5).correct


def test_state_left_unchanged(tiny_root, monkeypatch):
    from repro_torch.train import train_step
    monkeypatch.setattr(train_step, "_update", lambda *a, **k: None)
    run = run_cell(tiny_root, TRAIN, seconds=0.3)
    assert not run.correct
    assert dict((n, v) for n, v, _ in run.checks)["change_gap"] == 1.0


def test_half_of_the_batch(tiny_root):
    run = run_cell(tiny_root, TRAIN, seconds=0.3, fault=control.half_batch)
    assert not run.correct


def test_token_altered_where_produced(tiny_root):
    def alter(engine):
        sample = engine._sample

        def altered(logits):
            out = sample(logits)
            out[0] = (out[0] + 1) % logits.shape[-1]
            return out
        engine._sample = altered
    run = run_cell(tiny_root, SERVE, seconds=0.5, fault=alter)
    assert not run.correct
    assert run.checks[0][1] > run.checks[0][2]


def test_gaps_by_worst_and_median_leaf():
    """Each leaf's gap of norms over the larger of its own and the median
    leaf's reference norm; a leaf the reference barely moves is left out
    of the change."""
    ref = {"loss": [2.0], "grad": {"a": 1.0, "b": 2.0, "c": 3.0, "d": 1e-6},
           "change": {"a": 1.0, "b": 1.0, "c": 1.0, "d": 0.0}}
    prog = {"loss": [2.2], "grad": {"a": 1.1, "b": 2.0, "c": 3.3, "d": 0.0},
            "change": {"a": 1.0, "b": 1.5, "c": 1.0, "d": 5.0}}
    g = train._gaps(prog, ref)
    assert g["loss_gap"] == pytest.approx(0.1)
    assert (g["grad_gap"], g["grad_leaf"]) == (pytest.approx(0.1), "c")
    assert g["grad_gap_median"] == pytest.approx((0.1 / 1.5 + 1e-6 / 1.5) / 2)
    assert (g["change_gap"], g["change_leaf"]) == (0.5, "b")
    assert g["change_gap_median"] == 0.0 and g["left_out"] == ["d"]


def test_control_reads_far_above_the_program(tiny_root):
    cell = cells.cell(TRAIN, root=tiny_root)
    _, _, _, got = train.program_steps(cell, 5, "cpu")
    ref = train.reference_steps(cell, 5, "cpu")
    low = train.reference_steps(cell, 5, "cpu", "fp8")
    sound, ctl = train._gaps(got, ref), train._gaps(low, ref)
    assert any(ctl[k] >= 3 * sound[k] for k in (
        "loss_gap", "grad_gap", "change_gap", "grad_gap_median"))
    cell = cells.cell(SERVE, root=tiny_root)
    run = serve.run(cell, seed=5, seconds=0.5, tracer=Tracer(False),
                    device="cpu", clock=lambda: 0.0, control="fp8")
    assert run.extra["control_gap"] > 3 * run.checks[0][1]


@pytest.mark.cuda
def test_control_fails_the_limits_at_full_size():
    """On the card, at the cells' own sizes, three seeds: the program
    passes every limit and the fp8 control fails one; so does each fault
    of the training cell."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import run as bench_run
    bench_run._environment()
    for name in (TRAIN, SERVE):
        cell = cells.cell(name)
        lim = cell.limits
        for seed in (101, 202, 303):
            row = (control.train_seed(cell, seed) if cell.runner == "train"
                   else control.serve_seed(cell, seed, 8.0))
            assert all(row["program"][k] <= v for k, v in lim.items())
            assert any(row["control"][k] > v for k, v in lim.items())
            if "half_batch" in row:
                assert any(row["half_batch"][k] > v
                           for k, v in lim.items())
