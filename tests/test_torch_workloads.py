"""The port's IR workloads against the reference's, on the CPU: datasets
and programs byte for byte, pretraining step for step, each workload's
fitness under the reference's cost constants, a seeded GEVO run, the CLI,
parallel evaluation and the device rule; and the kernel-artifact helpers
of ``kernels/workloads.py`` (``kernel_artifact``,
``resolve_kernel_schedule``, ``scheduled_kernel_fn``) against the
reference's uses of them.

Sizes stay small: no dataset at its default size, no pretraining beyond a
few steps.  Tolerances, stated per check:

* datasets, programs (``serialize`` fingerprints), static times: equal;
* prediction error: equal, or within 1/n where an argmax tie can flip;
* 2fcNet weights after 20 SGD steps: absolute 1e-4;
* pretraining in float64 (the reference with 64-bit mode on): relative
  1e-9 of each tensor's largest value; in float32, the first step's loss
  to relative 1e-5 (the reference's f32 gradients of deep BN stacks are
  off by up to a few percent from its own f64 ones, the port's by about
  1e-6, so f32 weights are not compared);
* artifact manifests: byte for byte; a scheduled kernel against the
  kernel's f32 tolerance of tests/test_kernels.py.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

import repro.core.fitness as ref_fitness
import repro.core.interp as ref_interp
import repro.kernels.workloads as ref_kernel_wl
import repro.core.search as ref_search
import repro.core.serialize as ref_serialize
import repro.workloads.datasets as ref_datasets
import repro.workloads.mobilenet as ref_mobilenet
import repro.workloads.tinyformer as ref_tinyformer
import repro.workloads.twofc as ref_twofc
import repro_torch.core.fitness as fitness
import repro_torch.core.interp as interp
import repro_torch.core.serialize as serialize
import repro_torch.kernels.workloads as kernel_wl
import repro_torch.workloads.datasets as datasets
import repro_torch.workloads.mobilenet as mobilenet
import repro_torch.workloads.tinyformer as tinyformer
import repro_torch.workloads.twofc as twofc
from repro.core.deploy import ArtifactRegistry as RefRegistry
from repro_torch.core.analysis.__main__ import main as analysis_cli
from repro_torch.core.analysis.lint import lint_artifact, lint_path
from repro_torch.core.deploy import ArtifactRegistry
from repro_torch.core.evaluator import ParallelEvaluator
from repro_torch.core.search import GevoML
from repro_torch.workloads import __main__ as cli
from repro_torch.workloads.weights import from_reference

TINY_2FC = dict(batch=32, hidden=16, steps=20, n_train=256, n_test=256)


@pytest.fixture(autouse=True)
def _global_state():
    """Every global flag a test here may touch comes back as it was."""
    cudnn = torch.backends.cudnn
    saved = (jax.config.jax_enable_x64, torch.get_num_threads(),
             torch.get_default_dtype(), cudnn.conv.fp32_precision,
             torch.backends.cuda.matmul.fp32_precision, cudnn.deterministic,
             cudnn.benchmark, np.random.get_state())
    yield
    jax.config.update("jax_enable_x64", saved[0])
    torch.set_num_threads(saved[1])
    torch.set_default_dtype(saved[2])
    cudnn.conv.fp32_precision = saved[3]
    torch.backends.cuda.matmul.fp32_precision = saved[4]
    cudnn.deterministic, cudnn.benchmark = saved[5], saved[6]
    np.random.set_state(saved[7])


@pytest.fixture
def ref_constants(monkeypatch):
    """The port's static time under the reference's TPU-v5e constants, so
    static fitness must agree exactly."""
    monkeypatch.setattr(fitness, "static_time", functools.partial(
        fitness.static_time, peak_flops=ref_fitness.PEAK_FLOPS,
        hbm_bw=ref_fitness.HBM_BW))


def _flat(params, prefix=""):
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# --------------------------------------------------------------------------
# datasets and programs, byte for byte
# --------------------------------------------------------------------------

def test_datasets_are_byte_identical():
    for got, want in ((datasets.synthetic_mnist(256, 64),
                       ref_datasets.synthetic_mnist(256, 64)),
                      (datasets.synthetic_cifar10(48, 16),
                       ref_datasets.synthetic_cifar10(48, 16))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    x, y = datasets.cifar10_train_head(20, n_train=48, n_test=16)
    want_x, want_y, _, _ = ref_datasets.synthetic_cifar10(48, 16)
    assert x.tobytes() == want_x[:20].tobytes()
    assert y.tobytes() == want_y[:20].tobytes()
    with pytest.raises(ValueError):
        datasets.cifar10_train_head(49, n_train=48, n_test=16)
    xs, ys = tinyformer.make_sequence_dataset(64)
    want_xs, want_ys = ref_tinyformer.make_sequence_dataset(64)
    assert xs.tobytes() == want_xs.tobytes()
    assert ys.tobytes() == want_ys.tobytes()


def _programs():
    mob = ref_mobilenet.init_mobilenet(alpha=0.25, seed=0)
    tf = ref_tinyformer.init_tinyformer()
    return {
        "twofc": (twofc.build_twofc_step(), ref_twofc.build_twofc_step()),
        "mobilenet": (mobilenet.mobilenet_to_ir(from_reference(mob), 4),
                      ref_mobilenet.mobilenet_to_ir(mob, 4)),
        "tinyformer": (tinyformer.tinyformer_to_ir(from_reference(tf), 8, 16,
                                                   16),
                       ref_tinyformer.tinyformer_to_ir(tf, 8, 16, 16)),
    }


@pytest.mark.parametrize("name", ["twofc", "mobilenet", "tinyformer"])
def test_programs_are_byte_identical(name):
    """One parameter dict gives one program in both packages: only the
    executor differs.  The initial weights agree too."""
    prog, ref_prog = _programs()[name]
    assert serialize.program_fingerprint(prog) == \
        ref_serialize.program_fingerprint(ref_prog)
    got = {"twofc": twofc.init_twofc_weights(),
           "mobilenet": mobilenet.init_mobilenet(alpha=0.25),
           "tinyformer": tinyformer.init_tinyformer()}[name]
    want = {"twofc": ref_twofc.init_twofc_weights(),
            "mobilenet": ref_mobilenet.init_mobilenet(alpha=0.25),
            "tinyformer": ref_tinyformer.init_tinyformer()}[name]
    assert [k for k, _ in _flat(got)] == [k for k, _ in _flat(want)]
    for (_, g), (_, w) in zip(_flat(got), _flat(want)):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_mobilenet_alpha_one_has_published_widths():
    """alpha=1.0 is MobileNetV1's widths: 32 to 1024 channels, 442 ops a
    forward pass (the program is built, not run)."""
    params = mobilenet.init_mobilenet(alpha=1.0)
    n = sum(np.asarray(v).size for _, v in _flat(params))
    assert params["stem_w"].shape == (3, 3, 3, 32)
    assert params["pw9_w"].shape == (1, 1, 1024, 1024)
    assert 2.4e6 < n < 3.3e6
    assert len(mobilenet.mobilenet_to_ir(params, 2).ops) == 442


def test_from_reference_checks_and_copies():
    ref = ref_tinyformer.init_tinyformer()
    got = from_reference(ref)
    assert got["heads"] == ref["heads"] and got["emb"] is not ref["emb"]
    nested = from_reference({"bn": {"gamma": jax.numpy.ones(3)}})
    assert isinstance(nested["bn"]["gamma"], np.ndarray)
    with pytest.raises(TypeError, match="float32"):
        from_reference({"w": np.zeros(2, np.float64)})


# --------------------------------------------------------------------------
# pretraining, step for step
# --------------------------------------------------------------------------

def _to64(params):
    return {k: _to64(v) if isinstance(v, dict)
            else (v.astype(np.float64) if isinstance(v, np.ndarray) else v)
            for k, v in params.items()}


def test_mobilenet_pretrain_matches_reference():
    """Two SGD-momentum steps with BN statistics: in float64 (the
    reference with 64-bit mode on, restored by the fixture) the weights
    agree to 1e-9 relative; in float32 the first forward's loss agrees."""
    x, y, _, _ = ref_datasets.synthetic_cifar10(64, 8)
    params = ref_mobilenet.init_mobilenet(alpha=0.125)
    jax.config.update("jax_enable_x64", True)
    want = ref_mobilenet.pretrain(_to64(params), x[:64].astype(np.float64),
                                  y[:64], epochs=1, batch=32)
    jax.config.update("jax_enable_x64", False)
    got = mobilenet.pretrain(_to64(params), x[:64].astype(np.float64),
                             y[:64], epochs=1, batch=32, device="cpu")
    assert [k for k, _ in _flat(got)] == [k for k, _ in _flat(want)]
    for (k, g), (_, w) in zip(_flat(got), _flat(want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.float64, k
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-9 * np.abs(w).max(), err_msg=k)
    logits, _ = ref_mobilenet.forward(params, x[:32], train=True)
    ref_loss = -np.mean(jax.nn.log_softmax(logits)[np.arange(32), y[:32]])
    tp = mobilenet.params_to(params, "cpu")
    logits, _ = mobilenet.forward(tp, torch.as_tensor(x[:32]), train=True)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.as_tensor(y[:32]).long())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


def test_tinyformer_pretrain_matches_reference():
    """Five plain-SGD steps on the same sampled batches, float32:
    absolute 1e-4."""
    x, y = ref_tinyformer.make_sequence_dataset(128)
    p = ref_tinyformer.init_tinyformer()
    want = ref_tinyformer.pretrain(p, x, y, steps=5)
    got = tinyformer.pretrain(from_reference(p), x, y, steps=5, device="cpu")
    assert got["heads"] == want["heads"]
    for k in want:
        if k != "heads":
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


# --------------------------------------------------------------------------
# fitness under the reference's constants
# --------------------------------------------------------------------------

def test_twofc_training_matches_reference(ref_constants):
    """20 SGD steps of the step program: the weights within 1e-4, equal
    static time, error within 1/n_test."""
    w = twofc.build_twofc_training_workload(device="cpu", **TINY_2FC)
    ref_w = ref_twofc.build_twofc_training_workload(**TINY_2FC)
    fn = interp.jit_program(w.program, "cpu")
    ref_fn = ref_interp.jit_program(ref_w.program)
    weights = dict(w.init_weights)
    ref_weights = dict(ref_w.init_weights)
    for step in range(20):
        j = step * 32 % 256
        x = w.train_x[j:j + 32]
        y1h = np.eye(10, dtype=np.float32)[w.train_y[j:j + 32]]
        outs = fn({**weights, "x": x, "y_onehot": y1h})
        ref_outs = ref_fn({**ref_weights, "x": x, "y_onehot": y1h})
        weights = dict(zip(twofc.WEIGHT_NAMES, (o.numpy() for o in outs)))
        ref_weights = dict(zip(twofc.WEIGHT_NAMES, ref_outs))
    for k in twofc.WEIGHT_NAMES:
        np.testing.assert_allclose(weights[k], np.asarray(ref_weights[k]),
                                   atol=1e-4, err_msg=k)
    t, e = w.evaluate(w.program)
    ref_t, ref_e = ref_w.evaluate(ref_w.program)
    assert t == ref_t
    assert abs(e - ref_e) <= 1 / 256 + 1e-12


def _prediction_pair(name):
    """One baked program (initial weights, small batch) and one eval set,
    as a workload of each package."""
    prog, ref_prog = _programs()[name]
    if name == "mobilenet":
        x, y, _, _ = ref_datasets.synthetic_cifar10(64, 8)
        batch = 4
    else:
        xs, y = ref_tinyformer.make_sequence_dataset(64)
        x, batch = np.eye(16, dtype=np.float32)[xs], 8
    return (fitness.PredictionWorkload(name, prog, x, y, batch=batch,
                                       device="cpu"),
            ref_fitness.PredictionWorkload(name, ref_prog, x, y,
                                           batch=batch))


@pytest.mark.parametrize("name", ["mobilenet", "tinyformer"])
def test_prediction_fitness_matches_reference(name, ref_constants):
    w, ref_w = _prediction_pair(name)
    t, e = w.evaluate(w.program)
    ref_t, ref_e = ref_w.evaluate(ref_w.program)
    assert t == ref_t
    assert abs(e - ref_e) <= 1 / len(w.images) + 1e-12


def test_invalid_variants_and_measured_time(ref_constants):
    """A variant that breaks the logits shape is invalid in both; measured
    mode times on the host clock here."""
    w, ref_w = _prediction_pair("tinyformer")
    prog = w.program.clone()
    prog.outputs[0] = prog.ops[-3].result        # a (batch,) reduce
    with pytest.raises(fitness.InvalidVariant, match="bad logits shape"):
        w.evaluate(prog)
    with pytest.raises(ref_fitness.InvalidVariant, match="bad logits shape"):
        ref_w.evaluate(prog)
    w.time_mode = "measured"
    t, _ = w.evaluate(w.program)
    assert t > 0


# --------------------------------------------------------------------------
# the search
# --------------------------------------------------------------------------

def test_seeded_search_matches_reference(ref_constants):
    """A quickstart-sized GEVO run (pop 6, 2 generations, static time) walks
    the same generations in both packages: the same patches and cache keys,
    the same fitness, the same fronts."""
    kw = dict(pop_size=6, n_elite=3, seed=0, operators="all")
    w = twofc.build_twofc_training_workload(device="cpu", **TINY_2FC)
    ref_w = ref_twofc.build_twofc_training_workload(**TINY_2FC)
    res = GevoML(w, **kw).run(generations=2)
    ref_res = ref_search.GevoML(ref_w, **kw).run(generations=2)
    fp = "shared-fingerprint"
    assert [serialize.patch_key(fp, i.patch) for i in res.population] == \
        [ref_serialize.patch_key(fp, i.patch) for i in ref_res.population]
    assert [i.fitness for i in res.population] == \
        [i.fitness for i in ref_res.population]
    assert [i.fitness for i in res.pareto] == \
        [i.fitness for i in ref_res.pareto]
    drop = ("wall_s",)
    assert [{k: v for k, v in h.items() if k not in drop}
            for h in res.history] == \
        [{k: v for k, v in h.items() if k not in drop}
         for h in ref_res.history]


def test_parallel_equals_serial_and_resume(tmp_path):
    """Spawned workers rebuild the 2fcNet workload from its WorkloadSpec
    (its eval_fn does not pickle); in static mode the search equals the
    serial one, and a checkpointed run resumes to the same result."""
    w = twofc.build_twofc_training_workload(device="cpu", **TINY_2FC)
    assert dict(w.spec.kwargs)["device"] == "cpu"
    kw = dict(pop_size=4, n_elite=2, seed=1, operators="all")
    serial = GevoML(w, **kw).run(generations=2)
    with ParallelEvaluator(w, n_workers=2) as ev:
        par = GevoML(w, evaluator=ev, **kw).run(generations=2)
    assert [i.fitness for i in par.population] == \
        [i.fitness for i in serial.population]
    ck = str(tmp_path / "ck")
    GevoML(w, checkpoint_dir=ck, **kw).run(generations=1)
    resumed = GevoML(w, checkpoint_dir=ck, **kw).run(generations=2,
                                                     resume=True)
    assert [serialize.patch_key("f", i.patch) for i in resumed.population] \
        == [serialize.patch_key("f", i.patch) for i in serial.population]


def test_cli_runs_on_the_host(tmp_path, capsys):
    cache = str(tmp_path / "fit.jsonl")
    args = ["--workload", "twofc", "--device", "cpu", "--generations", "1",
            "--pop", "4", "--cache", cache, "--minimize"]
    cli.main(args)
    out = capsys.readouterr().out
    assert "Pareto front" in out and "minimized best-by-time patch" in out
    with open(cache) as f:
        assert all("key" in json.loads(line) for line in f)
    cli.main(args)
    out = capsys.readouterr().out
    assert "(0 fitness evaluations," in out and "cache hit rate 100%" in out


def test_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builders = (
        lambda **d: twofc.build_twofc_training_workload(**TINY_2FC, **d),
        lambda **d: twofc.make_eval_fn(np.zeros((4, 784), np.float32),
                                       np.zeros(4, np.int32), **d),
        lambda **d: mobilenet.pretrain(mobilenet.init_mobilenet(alpha=0.125),
                                       np.zeros((2, 32, 32, 3), np.float32),
                                       np.zeros(2, np.int32), batch=2,
                                       epochs=0, **d),
        lambda **d: tinyformer.pretrain(tinyformer.init_tinyformer(),
                                        np.zeros((2, 16), np.int32),
                                        np.zeros(2, np.int32), steps=0, **d),
    )
    for build in builders:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        build(device="cpu")
    w, _ = _prediction_pair("tinyformer")
    w.device = None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w.evaluate(w.program)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--workload", "twofc", "--generations", "1"])
    import repro_torch.kernels.workloads as kernel_workloads
    from repro_torch.device import resolve_device
    assert kernel_workloads.resolve_device is resolve_device


# --------------------------------------------------------------------------
# the kernel-artifact helpers (kernels/workloads.py) against the reference's
# uses (tests/test_deploy.py TestKernelArtifacts, tests/test_analysis.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", kernel_wl.KERNELS)
def test_kernel_artifact_is_the_references(kernel, tmp_path):
    """The same manifest, byte for byte, and each package resolves the
    other's registry."""
    genome = dict(kernel_wl.BASELINES[kernel])
    port = kernel_wl.kernel_artifact(kernel, genome, fitness=(1e-6, 0.0),
                                     meta={"source": "test"})
    ref = ref_kernel_wl.kernel_artifact(kernel, genome, fitness=(1e-6, 0.0),
                                        meta={"source": "test"})
    assert port.key() == ref.key() and port.body() == ref.body()
    a = ArtifactRegistry(str(tmp_path / "port")).export(port)
    b = RefRegistry(str(tmp_path / "ref")).export(ref)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert kernel_wl.resolve_kernel_schedule(
        ArtifactRegistry(str(tmp_path / "ref")), kernel) == genome
    assert ref_kernel_wl.resolve_kernel_schedule(
        RefRegistry(str(tmp_path / "port")), kernel) == genome
    assert not any(d.is_error for d in lint_artifact(port))


@pytest.mark.parametrize("kernel", kernel_wl.KERNELS)
def test_resolve_falls_back_to_baseline(kernel, tmp_path):
    reg = ArtifactRegistry(str(tmp_path / "arts"))
    for r in (reg, None):
        got = kernel_wl.resolve_kernel_schedule(r, kernel)
        assert got == kernel_wl.BASELINES[kernel] == \
            ref_kernel_wl.resolve_kernel_schedule(None, kernel)
        assert got is not kernel_wl.BASELINES[kernel]  # a copy


WINNERS = {"rmsnorm": {"impl": "pallas", "block_rows": 512,
                       "epilogue": "unfused"},
           "flash_attention": {"impl": "pallas", "block_q": 64,
                               "block_k": 32},
           "mamba_scan": {"impl": "pallas", "chunk": 16}}


@pytest.mark.parametrize("kernel", kernel_wl.KERNELS)
def test_registered_winner_resolves_and_runs(kernel, tmp_path):
    """A winner in the registry is the schedule ``scheduled_kernel_fn``
    runs: the same output as that genome's variant (its plain version on
    the CPU), within the kernel's f32 tolerance of the default's, and of
    the reference's scheduled function on the same inputs."""
    reg = ArtifactRegistry(str(tmp_path / "arts"))
    winner = WINNERS[kernel]
    reg.export(kernel_wl.kernel_artifact(kernel, winner, fitness=(1e-6, 0.0)))
    assert kernel_wl.resolve_kernel_schedule(reg, kernel) == winner
    arrays = kernel_wl.numpy_inputs(kernel, 0)
    inputs = kernel_wl.inputs_from_numpy(kernel, arrays, "cpu")
    got = kernel_wl.scheduled_kernel_fn(kernel, reg)(inputs)
    assert torch.equal(got, kernel_wl._variant_fn(kernel, winner)(inputs))
    tol = {"rmsnorm": 1e-5, "flash_attention": 2e-5, "mamba_scan": 1e-4}
    base = kernel_wl.scheduled_kernel_fn(kernel)(inputs)
    assert float((got - base).abs().max()) <= tol[kernel]
    ref_reg = RefRegistry(str(tmp_path / "ref"))
    ref_reg.export(ref_kernel_wl.kernel_artifact(kernel, winner))
    if kernel == "rmsnorm":  # the reference's Pallas kernel in interpret mode
        want = ref_kernel_wl.scheduled_kernel_fn(kernel, ref_reg)(arrays)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
            <= tol[kernel]


def test_out_of_space_winner_ignored_and_linted(tmp_path, capsys):
    reg = ArtifactRegistry(str(tmp_path))
    reg.export(kernel_wl.kernel_artifact("rmsnorm", {
        "impl": "pallas", "block_rows": 7, "epilogue": "fused"}))
    assert kernel_wl.resolve_kernel_schedule(reg, "rmsnorm") == \
        kernel_wl.BASELINES["rmsnorm"]
    results = lint_path(str(tmp_path))
    assert len(results) == 1
    assert analysis_cli(["lint", str(tmp_path), "--strict"]) == 1
    assert "not among the declared choices" in capsys.readouterr().out
