"""The plumbing of the measured fitness's graph path, on the CPU: static
input buffers, outputs copied where torch would return a view of an input
or a constant, and the training feedback through them.  The capture and
replay themselves run only on a GPU (``tests/test_torch_cuda.py``); here
every run executes the op list, through the same copy-in, copy-out and
feedback code.

Each check is exact: the port against the reference (which copies every
output, as XLA does), or the graph path against the eager interpreter.
"""

import functools

import numpy as np
import pytest
import torch

import repro.core.fitness as ref_fitness
import repro_torch.core.fitness as fitness
from repro.core.builder import Builder as RefBuilder
from repro_torch.core.builder import Builder
from repro_torch.core.interp import ProgramGraph, jit_program
from repro_torch.kernels import workloads

STEPS = 6


def _transposing_step(builder_cls):
    """One "training step" whose first weight output is the transpose of
    its own square input — a view of the input buffer in torch — and whose
    second is computed from that input too: w' = w^T, v' = v + w."""
    b = builder_cls("transpose-step")
    w = b.input("w", (4, 4))
    v = b.input("v", (4, 4))
    b.input("x", (2, 4))
    b.input("y_onehot", (2, 3))
    b.output(b.transpose(w, (1, 0)), b.add(v, w))
    return b.done()


def _workload(module, builder_cls, **kw):
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((4, 4), dtype=np.float32),
            "v": rng.standard_normal((4, 4), dtype=np.float32)}
    x = rng.standard_normal((8, 4), dtype=np.float32)
    y = rng.integers(0, 3, 8)
    final = {}

    def eval_fn(weights):
        final.update({k: np.asarray(v) for k, v in weights.items()})
        return 0.5
    w = module.TrainingWorkload(
        name="transpose-step", program=_transposing_step(builder_cls),
        weight_names=("w", "v"), init_weights=init, train_x=x, train_y=y,
        eval_fn=eval_fn, batch=2, steps=STEPS, num_classes=3, **kw)
    return w, final


def test_training_through_a_view_of_its_own_weight(monkeypatch):
    """The transposed weight flips every step and the other weight reads
    the right one: the final weights equal the reference's, bit for bit."""
    monkeypatch.setattr(fitness, "static_time", functools.partial(
        fitness.static_time, peak_flops=ref_fitness.PEAK_FLOPS,
        hbm_bw=ref_fitness.HBM_BW))
    w, got = _workload(fitness, Builder, device="cpu")
    ref_w, want = _workload(ref_fitness, RefBuilder)
    assert w.evaluate(w.program) == ref_w.evaluate(ref_w.program)
    assert got.keys() == want.keys() == {"w", "v"}
    for k in got:
        assert got[k].tobytes() == want[k].tobytes(), k
    w0 = w.init_weights["w"]
    assert np.array_equal(got["w"], w0 if STEPS % 2 == 0 else w0.T)


def test_outputs_never_share_memory_with_inputs_or_constants():
    b = Builder("aliases")
    x = b.input("x", (3, 3))
    c = b.const(np.arange(9, dtype=np.float32).reshape(3, 3))
    b.output(b.transpose(x, (1, 0)), b.reshape(c, (9,)), x,
             b.add(x, c))
    prog = b.done()
    inp = {"x": np.random.default_rng(1).standard_normal(
        (3, 3), dtype=np.float32)}
    with ProgramGraph(prog, "cpu") as g:
        g.load(inp)
        outs = g.run()
        held = {t.untyped_storage().data_ptr()
                for t in (*g._buffers.values(), *g._env0.values())}
        assert not {o.untyped_storage().data_ptr() for o in outs} & held
        for a, e in zip(outs, jit_program(prog, "cpu")(inp)):
            assert torch.equal(a, e)


def test_loads_cast_check_and_persist():
    """Inputs are cast to their declared dtypes as the eager interpreter
    casts them, checked for shape, kept between runs, and required."""
    b = Builder("cast")
    x = b.input("x", (2,), "i32")
    y = b.input("y", (2,))
    b.output(b.add(b.op("convert", [x], new_dtype="f32"), y))
    prog = b.done()
    with ProgramGraph(prog, "cpu") as g:
        with pytest.raises(KeyError, match="missing program input 'y'"):
            g.load({"x": np.array([1.7, -2.9], np.float32)})
            g.run()
        g.load({"y": np.ones(2, np.float32)})
        first = g.run()[0].clone()
        assert torch.equal(first, torch.tensor([2.0, -1.0]))
        g.load({"y": np.zeros(2, np.float32)})
        assert torch.equal(g.run()[0], torch.tensor([1.0, -2.0]))
        with pytest.raises(ValueError, match="input 'y'"):
            g.load({"y": np.zeros(3, np.float32)})
        with pytest.raises(KeyError, match="unknown program input"):
            g.load({"z": np.zeros(2, np.float32)})


def test_measured_time_on_the_host_clock():
    calls = []
    t = fitness.measured_time(lambda: calls.append(1), "cpu", repeats=3,
                              warmup=2)
    assert t >= 0.0 and len(calls) == 5
    w = workloads.build_kernel_workload("rmsnorm", time_mode="measured",
                                        device="cpu")
    t, err = w.evaluate(w.program)
    assert t > 0 and err <= 2e-5
