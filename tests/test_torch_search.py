"""The port's kernel-schedule search on the CPU: workloads built from the
same numpy inputs as the reference, GEVO's generations against the
reference engine, checkpoints, parallel evaluation, and the entry points'
device rule.  The CUDA launches themselves are exercised by chip_smoke.py.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.search as ref_search
import repro.core.serialize as ref_serialize
import repro.kernels.costs as ref_costs
import repro.kernels.workloads as ref_workloads
import repro_torch.core.serialize as serialize
import repro_torch.kernels.workloads as workloads
from repro.core.fitness import HBM_BW, PEAK_FLOPS
from repro.core.fitness import KernelWorkload as RefKernelWorkload
from repro_torch.core.edits import Patch
from repro_torch.core.evaluator import (FitnessCache, ParallelEvaluator,
                                        SerialEvaluator)
from repro_torch.core.fitness import KernelWorkload
from repro_torch.core.search import GevoML
from repro_torch.kernels import __main__ as cli
from repro_torch.kernels.costs import DeviceModel, schedule_time
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.rmsnorm.ops import rmsnorm

TWEAK = {"attr_tweak": 1.0}

# the reference's TPU-v5e constants as a DeviceModel (see test_torch_core)
REF_DEVICE = DeviceModel(
    name="reference constants", peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW,
    vector_flops=ref_costs.VPU_FLOPS, grid_step_s=ref_costs.GRID_STEP_S,
    seq_step_s=ref_costs.SEQ_STEP_S, smem_per_block=ref_costs.VMEM_BYTES,
    tile_m=8, tile_n=128)


def test_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workloads.build_kernel_workload("rmsnorm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workloads.build_joint_kernel_workload()
    w = workloads.build_kernel_workload("rmsnorm", device="cpu")
    assert dict(w.spec.kwargs)["device"] == "cpu"


@pytest.mark.parametrize("kernel", workloads.KERNELS)
def test_variants_match_reference_on_shared_inputs(kernel):
    """The same numpy inputs through the reference's scheduled variant
    (Pallas in interpret mode) and the port's (the plain version on the
    CPU), for the default schedule and the oracle."""
    arrays = workloads.numpy_inputs(kernel, seed=3)
    inputs = workloads.inputs_from_numpy(kernel, arrays, "cpu")
    ref_inputs = {k: jnp.asarray(v) for k, v in arrays.items()}
    for genome in (workloads.BASELINES[kernel],
                   dict(workloads.BASELINES[kernel], impl="ref")):
        got = workloads._variant_fn(kernel, genome)(inputs)
        want = ref_workloads._variant_fn(kernel, genome)(ref_inputs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="takes inputs"):
        workloads.inputs_from_numpy(kernel, {"z": arrays[next(iter(arrays))]},
                                    "cpu")


@pytest.mark.parametrize("kernel", workloads.KERNELS)
def test_default_schedule_parity_and_launchability(kernel):
    """The shipped default executes within tolerance of the oracle; the
    oracle is exact; sampled genomes all execute."""
    w = workloads.build_kernel_workload(kernel, device="cpu")
    t, err = w.evaluate(w.program)
    assert t > 0 and err <= 2e-5
    ref = w.space.encode(dict(workloads.BASELINES[kernel], impl="ref"))
    t_ref, err_ref = w.evaluate(ref)
    assert err_ref == 0.0 and t_ref > t
    rng = np.random.default_rng(0)
    for _ in range(4):
        t, err = w.runner(w.space.random(rng))
        assert np.isfinite(t) and np.isfinite(err)


def _ref_timed(kernel, ref_impl):
    """A kernel workload of either package whose fitness is the reference's
    static time (and a knob-derived error): both engines then see the same
    fitness, so a seeded search must take the same path in both."""
    space_mod = workloads if not ref_impl else ref_workloads
    space = space_mod.kernel_space(kernel)
    shape = workloads.SHAPES[kernel]

    if ref_impl:
        def runner(g):
            return ref_costs.schedule_time(kernel, g, **shape), \
                float(g["impl"] == "ref")
        return RefKernelWorkload(
            name=f"kernel/{kernel}", program=space.encode(
                ref_workloads.BASELINES[kernel]), space=space, runner=runner)

    def runner(g):
        return schedule_time(kernel, g, device=REF_DEVICE, **shape), \
            float(g["impl"] == "ref")
    return KernelWorkload(name=f"kernel/{kernel}", program=space.encode(
        workloads.BASELINES[kernel]), space=space, runner=runner)


@pytest.mark.parametrize("kernel", workloads.KERNELS)
def test_seeded_search_matches_reference_engine(kernel):
    """Under the reference's constants the port's cost model scores every
    genome identically, so a seeded GevoML walks the same generations in
    both packages: identical patch keys, fitness and history."""
    kw = dict(pop_size=6, n_elite=3, seed=4, init_mutations=2,
              mutation_rate=0.9, operators=TWEAK)
    res = GevoML(_ref_timed(kernel, False), **kw).run(generations=2)
    ref_res = ref_search.GevoML(_ref_timed(kernel, True), **kw).run(
        generations=2)
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


def test_reference_checkpoint_loads_in_port(tmp_path):
    """A reference checkpoint's population and RNG state load in the port:
    the same patches (by key) and the same next draws."""
    ck = tmp_path / "ck"
    ref_search.GevoML(_ref_timed("mamba_scan", True), pop_size=4, n_elite=2,
                      seed=1, operators=TWEAK, checkpoint_dir=str(ck)
                      ).run(generations=2)
    doc = json.loads((ck / "latest.json").read_text())
    fp = doc["program_fingerprint"]
    for member in doc["population"]:
        p = serialize.patch_from_doc(member["edits"])
        assert serialize.patch_key(fp, p) == ref_serialize.patch_key(
            fp, ref_serialize.patch_from_doc(member["edits"]))
    a = serialize.rng_from_state(doc["rng_state"])
    b = ref_serialize.rng_from_state(doc["rng_state"])
    assert a.random(4).tolist() == b.random(4).tolist()


def test_port_checkpoint_resume_is_bit_exact(tmp_path):
    w = workloads.build_kernel_workload("flash_attention", device="cpu")
    kw = dict(pop_size=4, n_elite=2, seed=2, operators=TWEAK)
    full = GevoML(w, **kw).run(generations=3)
    ck = str(tmp_path / "ck")
    GevoML(w, checkpoint_dir=ck, **kw).run(generations=2)
    resumed = GevoML(w, checkpoint_dir=ck, **kw).run(generations=3,
                                                     resume=True)
    assert [i.fitness for i in resumed.population] == \
        [i.fitness for i in full.population]
    assert [serialize.patch_key("f", i.patch) for i in resumed.population] \
        == [serialize.patch_key("f", i.patch) for i in full.population]
    assert [h["best_time"] for h in resumed.history] == \
        [h["best_time"] for h in full.history]


def test_parallel_equals_serial(tmp_path):
    """Spawned workers rebuild the workload from its WorkloadSpec; in static
    mode the search is bit-identical to the serial one."""
    w = workloads.build_kernel_workload("mamba_scan", device="cpu")
    kw = dict(pop_size=4, n_elite=2, seed=0, operators=TWEAK)
    serial = GevoML(w, **kw).run(generations=2)
    with ParallelEvaluator(w, n_workers=2) as ev:
        par = GevoML(w, evaluator=ev, **kw).run(generations=2)
        assert ev.n_evals == serial.history[-1]["evals"]
    assert [i.fitness for i in par.population] == \
        [i.fitness for i in serial.population]
    assert [serialize.patch_key("f", i.patch) for i in par.population] == \
        [serialize.patch_key("f", i.patch) for i in serial.population]


def test_evolve_joint_workload_with_persistent_cache(tmp_path):
    """The joint workload's invalid genomes fail the gates, not the search;
    a rerun on the same cache executes nothing."""
    w = workloads.build_joint_kernel_workload(device="cpu")
    path = str(tmp_path / "fit.jsonl")
    with SerialEvaluator(w, cache=FitnessCache(path)) as ev:
        search, res, best, ok = workloads.evolve_kernel_schedule(
            w, generations=2, pop_size=6, evaluator=ev)
        first = ev.n_evals
    assert first > 0 and res.pareto and ok
    with SerialEvaluator(w, cache=FitnessCache(path)) as ev:
        workloads.evolve_kernel_schedule(w, generations=2, pop_size=6,
                                         evaluator=ev)
        assert ev.n_evals == 0


def test_cli_runs_on_the_host(capsys):
    launches = (rmsnorm.launches, flash_attention.launches,
                mamba_scan.launches)
    cli.main(["--kernel", "flash_attention", "--device", "cpu",
              "--generations", "1", "--pop", "4", "--minimize"])
    out = capsys.readouterr().out
    assert "Pareto front" in out and "minimized best-by-time patch" in out
    assert (rmsnorm.launches, flash_attention.launches,
            mamba_scan.launches) == launches


def test_later_slices_raise_not_implemented():
    w = workloads.build_kernel_workload("rmsnorm", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1"):
        GevoML(w, engine="tensor")
    res = GevoML(w, pop_size=2, n_elite=1, operators=TWEAK).run(
        generations=1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1"):
        res.to_front()


def _tweaks(w, n, seed=0):
    from repro_torch.core.edits import OperatorWeights, sample_edit
    rng = np.random.default_rng(seed)
    weights = OperatorWeights.parse("attr_tweak=1")
    return Patch(tuple(sample_edit(w.program, rng, weights)
                       for _ in range(n)))


def test_describe_patch_matches_reference():
    """``describe_patch`` (the reference's pre-Patch helper) describes a
    patch, an edit list or an empty list as the reference does."""
    from repro.core.search import describe_patch as ref_describe_patch
    from repro_torch.core import describe_patch
    w = workloads.build_kernel_workload("rmsnorm", device="cpu")
    patch = _tweaks(w, 3)
    ref_patch = ref_serialize.patch_from_doc(serialize.patch_doc(patch))
    assert describe_patch(patch) == ref_describe_patch(ref_patch)
    assert describe_patch(list(patch.edits)) == patch.describe()
    assert describe_patch([]) == ref_describe_patch([]) == "<original>"


def test_core_exports_apply_patch():
    """``repro_torch.core`` re-exports ``apply_patch`` as the reference's
    core does; it applies an edit list as ``Patch.apply`` does."""
    import repro_torch.core as core
    from repro_torch.core.edits import apply_patch
    assert core.apply_patch is apply_patch
    assert {"apply_patch", "describe_patch"} <= set(core.__all__)
    w = workloads.build_kernel_workload("rmsnorm", device="cpu")
    patch = _tweaks(w, 2, seed=1)
    assert serialize.program_fingerprint(
        core.apply_patch(w.program, list(patch.edits))) == \
        serialize.program_fingerprint(patch.apply(w.program))


def test_device_faults_stop_evaluation_but_bad_schedules_are_invalid():
    """A fault of the build or the device is not a property of the variant:
    it propagates.  A schedule the wrapper refuses is an invalid variant."""
    from repro_torch.core.fitness import DeviceFault
    from repro_torch.kernels.build import KernelLaunchError
    space = workloads.kernel_space("rmsnorm")

    def faulty(g):
        raise KernelLaunchError("rmsnorm_fwd: CUDA error 1 (invalid argument)")

    def refused(g):
        raise ValueError("rmsnorm: block_rows 48 does not divide rows 512")

    for runner, raises in ((faulty, True), (refused, False)):
        w = KernelWorkload(name="kernel/rmsnorm", program=space.encode(),
                           space=space, runner=runner)
        with SerialEvaluator(w) as ev:
            if raises:
                with pytest.raises(DeviceFault):
                    ev.evaluate_one(Patch())
            else:
                out = ev.evaluate_one(Patch())
                assert not out.ok and "does not divide" in out.error
