"""The port's framework-free core against the reference package: programs,
patches, fingerprints, cache records, NSGA-II, crossover, the launch gates
and the static cost model.

Both packages are imported; they exchange only numpy arrays and files.
"""

import itertools
import json

import numpy as np
import pytest

import repro.core.crossover as ref_crossover
import repro.core.edits as ref_edits
import repro.core.evaluator as ref_evaluator
import repro.core.nsga2 as ref_nsga2
import repro.core.serialize as ref_serialize
import repro.kernels.costs as ref_costs
import repro.kernels.workloads as ref_workloads
import repro_torch.core.crossover as crossover
import repro_torch.core.edits as edits
import repro_torch.core.evaluator as evaluator
import repro_torch.core.nsga2 as nsga2
import repro_torch.core.serialize as serialize
import repro_torch.kernels.costs as costs
import repro_torch.kernels.workloads as workloads
from repro.core.fitness import HBM_BW, PEAK_FLOPS
from repro.workloads.twofc import build_twofc_step
from repro_torch.core.fitness import InvalidVariant

# The reference's TPU-v5e constants as a DeviceModel: under it the port's
# cost model must reproduce the reference's times bit for bit.
REF_DEVICE = costs.DeviceModel(
    name="reference constants", peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW,
    vector_flops=ref_costs.VPU_FLOPS, grid_step_s=ref_costs.GRID_STEP_S,
    seq_step_s=ref_costs.SEQ_STEP_S, smem_per_block=ref_costs.VMEM_BYTES,
    tile_m=8, tile_n=128)


def _genomes(space):
    names = space.names()
    for values in itertools.product(*(space.choices(n) for n in names)):
        yield dict(zip(names, values))


def _spaces():
    out = [(k, workloads.kernel_space(k), ref_workloads.kernel_space(k))
           for k in workloads.KERNELS]
    out.append(("joint", workloads.joint_space(), ref_workloads.joint_space()))
    return out


@pytest.mark.parametrize("name,space,ref_space", _spaces(),
                         ids=[s[0] for s in _spaces()])
def test_schedule_spaces_match_reference(name, space, ref_space):
    """Same knobs, choices and baselines, so the workloads' programs — and
    every cache key derived from them — are byte-identical."""
    assert space.names() == ref_space.names()
    for knob in space.names():
        assert space.choices(knob) == ref_space.choices(knob)
    if name == "joint":
        prog = workloads.build_joint_kernel_workload(device="cpu").program
        ref_prog = ref_workloads.build_joint_kernel_workload().program
    else:
        assert workloads.BASELINES[name] == ref_workloads.BASELINES[name]
        assert workloads.ERROR_KNOBS[name] == ref_workloads.ERROR_KNOBS[name]
        assert workloads.SHAPES[name] == ref_workloads.SHAPES[name]
        prog = workloads.build_kernel_workload(name, device="cpu").program
        ref_prog = ref_workloads.build_kernel_workload(name).program
    assert serialize.program_fingerprint(prog) == \
        ref_serialize.program_fingerprint(ref_prog)
    assert serialize.program_doc(prog)[0] == ref_serialize.program_doc(
        ref_prog)[0]
    assert workloads.BLOCK_DIMS == ref_workloads.BLOCK_DIMS


@pytest.mark.parametrize("name,space,ref_space", _spaces(),
                         ids=[s[0] for s in _spaces()])
def test_seeded_attr_tweak_stream_matches_reference(name, space, ref_space):
    """The same seeded Generator drives the same attr_tweak edits in both
    registries: identical patch docs, patch keys and variant
    fingerprints."""
    tweak = edits.OperatorWeights.of(attr_tweak=1.0)
    ref_tweak = ref_edits.OperatorWeights.of(attr_tweak=1.0)
    prog, ref_prog = space.encode(), ref_space.encode()
    rng, ref_rng = np.random.default_rng(7), np.random.default_rng(7)
    patch, ref_patch = edits.Patch(), ref_edits.Patch()
    fp = serialize.program_fingerprint(prog)
    for _ in range(12):
        e = edits.sample_edit(patch.apply(prog), rng, tweak)
        ref_e = ref_edits.sample_edit(ref_patch.apply(ref_prog), ref_rng,
                                      ref_tweak)
        patch, ref_patch = patch.append(e), ref_patch.append(ref_e)
        assert serialize.patch_doc(patch) == ref_serialize.patch_doc(
            ref_patch)
        assert serialize.patch_key(fp, patch) == \
            ref_serialize.patch_key(fp, ref_patch)
        assert serialize.program_fingerprint(patch.apply(prog)) == \
            ref_serialize.program_fingerprint(ref_patch.apply(ref_prog))
    assert space.decode(patch.apply(prog)) == \
        ref_space.decode(ref_patch.apply(ref_prog))


def test_reference_saved_program_loads_and_edits_identically(tmp_path):
    """A program the reference saves loads in the port with the same
    fingerprint, goes back the other way unchanged, and a seeded stream of
    edits from every registered operator rewrites it identically."""
    ref_prog = build_twofc_step(batch=4, in_dim=16, hidden=8, classes=4)
    ref_serialize.save_program(ref_prog, str(tmp_path / "ref"))
    prog = serialize.load_program(str(tmp_path / "ref"))
    fp = ref_serialize.program_fingerprint(ref_prog)
    assert serialize.program_fingerprint(prog) == fp
    serialize.save_program(prog, str(tmp_path / "port"))
    assert ref_serialize.program_fingerprint(
        ref_serialize.load_program(str(tmp_path / "port"))) == fp

    assert edits.registered_ops() == ref_edits.registered_ops()
    rng, ref_rng = np.random.default_rng(3), np.random.default_rng(3)
    patch, ref_patch = edits.Patch(), ref_edits.Patch()
    applied = 0
    for _ in range(30):
        try:
            e = edits.sample_edit(patch.apply(prog), rng)
            new = patch.append(e)
            new.apply(prog)
        except edits.EditError as err:
            with pytest.raises(ref_edits.EditError, match=str(err)[:20]):
                ref_e = ref_edits.sample_edit(ref_patch.apply(ref_prog),
                                              ref_rng)
                ref_patch.append(ref_e).apply(ref_prog)
            continue
        ref_e = ref_edits.sample_edit(ref_patch.apply(ref_prog), ref_rng)
        ref_new = ref_patch.append(ref_e)
        patch, ref_patch = new, ref_new
        applied += 1
        assert serialize.patch_key(fp, patch) == \
            ref_serialize.patch_key(fp, ref_patch)
        assert serialize.program_fingerprint(patch.apply(prog)) == \
            ref_serialize.program_fingerprint(ref_patch.apply(ref_prog))
    assert applied >= 10
    assert patch.describe() == ref_patch.describe()


def test_patch_files_and_rng_state_cross_load(tmp_path):
    space = workloads.kernel_space("flash_attention")
    rng = np.random.default_rng(11)
    patch = edits.Patch()
    for _ in range(5):
        patch = patch.append(edits.sample_edit(
            patch.apply(space.encode()), rng,
            edits.OperatorWeights.of(attr_tweak=1.0)))
    ref_patch = ref_serialize.patch_from_doc(serialize.patch_doc(patch))
    ref_serialize.save_patches([ref_patch], str(tmp_path / "p.json"))
    loaded = serialize.load_patches(str(tmp_path / "p.json"))
    assert serialize.patch_doc(loaded[0]) == ref_serialize.patch_doc(
        ref_patch)
    state = json.loads(json.dumps(ref_serialize.rng_state_doc(rng)))
    a, b = serialize.rng_from_state(state), ref_serialize.rng_from_state(
        state)
    assert a.integers(1 << 30, size=8).tolist() == \
        b.integers(1 << 30, size=8).tolist()


def test_reference_fitness_cache_records_load_in_port(tmp_path):
    path = str(tmp_path / "fit.jsonl")
    ref_cache = ref_evaluator.FitnessCache(path, writer="ref")
    ref_cache.put("k1", ref_evaluator.EvalOutcome(fitness=(1.5e-6, 2e-7)))
    ref_cache.put("k2", ref_evaluator.EvalOutcome(fitness=None,
                                                  error="bad block"))
    ref_cache.close()
    cache = evaluator.FitnessCache(path, writer="port")
    assert len(cache) == 2
    assert cache.get("k1").fitness == (1.5e-6, 2e-7)
    assert cache.get("k2").error == "bad block" and not cache.get("k2").ok
    assert cache.cross_hits == 2
    cache.put("k3", evaluator.EvalOutcome(fitness=(3.0, 0.0)))
    cache.close()
    again = ref_evaluator.FitnessCache(path)
    assert again.get("k3").fitness == (3.0, 0.0)
    again.close()


def test_nsga2_and_crossover_match_reference():
    rng = np.random.default_rng(5)
    objs = rng.random((24, 2))
    objs[3] = objs[4]                       # a tie
    r1, c1, e1 = nsga2.rank_select(objs, 10)
    r2, c2, e2 = ref_nsga2.rank_select(objs, 10)
    assert e1 == e2
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)
    assert nsga2.pareto_front(objs) == ref_nsga2.pareto_front(objs)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    assert [nsga2.tournament(ra, r1, c1) for _ in range(20)] == \
        [ref_nsga2.tournament(rb, r2, c2) for _ in range(20)]

    space = workloads.kernel_space("rmsnorm")
    tweak = edits.OperatorWeights.of(attr_tweak=1.0)
    g = np.random.default_rng(1)
    pa, pb = edits.Patch(), edits.Patch()
    for _ in range(3):
        pa = pa.append(edits.sample_edit(pa.apply(space.encode()), g, tweak))
        pb = pb.append(edits.sample_edit(pb.apply(space.encode()), g, tweak))
    ref_pa = ref_serialize.patch_from_doc(serialize.patch_doc(pa))
    ref_pb = ref_serialize.patch_from_doc(serialize.patch_doc(pb))
    xa, xb = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(5):
        got = crossover.messy_crossover(pa, pb, xa)
        want = ref_crossover.messy_crossover(ref_pa, ref_pb, xb)
        assert [serialize.patch_doc(p) for p in got] == \
            [ref_serialize.patch_doc(p) for p in want]


def _cost_cases():
    for kernel in workloads.KERNELS:
        for g in _genomes(ref_workloads.kernel_space(kernel)):
            yield kernel, g, ref_workloads.SHAPES[kernel]
    spaces = ref_workloads._JOINT_SPACES
    for kernel in workloads.KERNELS:
        for g in _genomes(ref_workloads.ScheduleSpace.of("j", spaces[kernel])):
            yield kernel, g, ref_workloads.SHAPES[kernel]
    # shapes where the capacity gates bite
    for br in (256, 1024, 4096):
        yield "rmsnorm", {"impl": "pallas", "block_rows": br,
                          "epilogue": "fused"}, {"rows": 4096, "d": 4096}
    for bk in (128, 256, 512):
        yield "flash_attention", {"impl": "pallas", "block_q": 128,
                                  "block_k": bk}, {"B": 1, "H": 1, "S": 1024,
                                                   "hd": 128}


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # InvalidVariant of either package
        return None, str(e)


def test_cost_model_bit_identical_under_reference_constants():
    """Under a DeviceModel built from the reference's constants, every
    genome both packages' gates admit costs the same float, bit for bit,
    and the block-divisibility messages are byte-identical."""
    compared = blocks = 0
    for kernel, g, shape in _cost_cases():
        t_ref, e_ref = _outcome(lambda: ref_costs.schedule_time(
            kernel, g, **shape))
        t, e = _outcome(lambda: costs.schedule_time(
            kernel, g, device=REF_DEVICE, **shape))
        if t_ref is not None and t is not None:
            assert t == t_ref, (kernel, g, shape)
            compared += 1
        for msg in (e, e_ref):
            if msg is not None and "does not divide" in msg:
                assert e == e_ref, (kernel, g)
                blocks += 1
    assert compared > 100 and blocks > 20


def test_batched_terms_match_scalar_path():
    """schedule_terms over a column of genomes is bit-exact with the scalar
    schedule_time, and its gate messages are the scalar messages."""
    for kernel in workloads.KERNELS:
        space = ref_workloads.ScheduleSpace.of(
            "j", ref_workloads._JOINT_SPACES[kernel])
        gs = list(_genomes(space))
        cols = {c: np.array([costs.schedule_cols(kernel, g)[c] for g in gs])
                for c, _, _ in costs.COL_SPECS[kernel]}
        shape = workloads.SHAPES[kernel]
        time, valid, gates = costs.schedule_terms(np, kernel, cols, **shape)
        for lane, g in enumerate(gs):
            t, e = _outcome(lambda: costs.schedule_time(kernel, g, **shape))
            assert bool(valid[lane]) == (e is None)
            if e is None:
                assert float(time[lane]) == t
            elif g["impl"] != "ref":
                assert costs.gate_message(gates, lane) == e


def test_every_search_genome_passes_the_shared_memory_gate():
    """The capacity gate is each kernel's own smem_bytes against the H100's
    232,448 bytes a block; every genome of the per-kernel spaces passes it
    (and the divisibility gates) at the evaluation shapes."""
    assert costs.H100.smem_per_block == 232448
    for kernel in workloads.KERNELS:
        for g in _genomes(workloads.kernel_space(kernel)):
            t = costs.schedule_time(kernel, g, **workloads.SHAPES[kernel])
            assert np.isfinite(t) and t > 0
            if g["impl"] != "ref":
                assert costs.schedule_features(
                    kernel, g, **workloads.SHAPES[kernel])["smem_frac"] <= 1


def test_shared_memory_gate_raises_with_the_one_message():
    g = {"impl": "pallas", "block_q": 128, "block_k": 512}
    shape = {"B": 1, "H": 1, "S": 1024, "hd": 128}
    with pytest.raises(InvalidVariant, match="shared memory per block") as e:
        costs.schedule_time("flash_attention", g, **shape)
    used = 2 * 512 * 128 * 4
    assert str(e.value) == costs.smem_capacity(
        "flash_attention", used, costs.H100.smem_per_block).message
    assert "VMEM" not in str(e.value)
    with pytest.raises(InvalidVariant, match="does not divide"):
        costs.schedule_time("rmsnorm", {"impl": "pallas", "block_rows": 96,
                                        "epilogue": "fused"}, rows=256, d=64)
    gates = costs.schedule_gates("flash_attention", g, **shape)
    assert [kind for kind, *_ in gates] == ["block", "block", "smem"]
    assert costs.schedule_gates("flash_attention", dict(g, impl="ref"),
                                **shape) == ()


@pytest.mark.parametrize("chunk,N,dtype,want", [
    (64, 16, "bfloat16", 57_344),    # Falcon-Mamba-7B's default schedule
    (128, 32, "float32", 229_376),   # the largest genome of the spaces
    (8, 1, "float32", 8_384),        # the smallest chunk and state size
])
def test_scan_smem_bytes_counts_each_region(chunk, N, dtype, want):
    """The scan's shared memory is two stages of raw dt, x, B and C, the
    tile converted to f32 ((dt, dt x) pairs, B, C) and two y tiles, each
    region rounded up to 16 bytes."""
    import torch
    from repro_torch.kernels.mamba_scan.mamba_scan import CHANNELS, smem_bytes
    dt = getattr(torch, dtype)
    esize = dt.itemsize
    up = lambda n: -(-n // 16) * 16  # noqa: E731
    rows, bc = up(chunk * CHANNELS * esize), up(chunk * N * esize)
    regions = {"stages": 2 * (2 * rows + 2 * bc),
               "pairs": chunk * CHANNELS * 8, "bc_f32": 2 * up(chunk * N * 4),
               "y": 2 * rows}
    assert sum(regions.values()) == want
    assert smem_bytes({"chunk": chunk}, {"N": N}, dt) == want


@pytest.mark.parametrize("N", [1, 2, 4, 8, 16, 32])
def test_scan_geometry_covers_every_channel_and_fits(N):
    """The scan's launch geometry gives every channel a block and every
    state a lane, and its shared memory (both stages) fits a block's
    232,448 bytes, for every chunk of both spaces that passes the
    divisibility gate at the search shape, and at Falcon-Mamba-7B's width,
    in f32 and bf16; the capacity gate reads the same smem_bytes."""
    import torch
    from repro_torch.kernels.mamba_scan.mamba_scan import geometry, smem_bytes
    chunks = set(workloads.kernel_space("mamba_scan").choices("chunk")) | \
        set(workloads.joint_space().choices("mamba_scan.chunk"))
    for shape in (dict(workloads.SHAPES["mamba_scan"], N=N),
                  {"Bt": 1, "L": 4096, "D": 8192, "N": N},
                  {"Bt": 2, "L": 384, "D": 40, "N": N}):
        geo = geometry(shape)
        assert geo["lanes"] * geo["states"] == N
        assert geo["threads"] == geo["channels"] * geo["lanes"]
        assert geo["threads"] % 32 == 0 and geo["threads"] <= 1024
        blocks, batch = geo["grid"]
        assert batch == shape["Bt"]
        assert (blocks - 1) * geo["channels"] < shape["D"] \
            <= blocks * geo["channels"]
        for chunk in sorted(chunks):
            if shape["L"] % chunk:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                used = smem_bytes({"chunk": chunk}, shape, dtype)
                assert used % 16 == 0 and \
                    used <= costs.H100.smem_per_block, (shape, chunk, dtype)
            g = {"impl": "pallas", "chunk": chunk}
            assert costs.schedule_features("mamba_scan", g, **shape)[
                "smem_frac"] == smem_bytes({"chunk": chunk}, shape,
                                           torch.float32) \
                / costs.H100.smem_per_block
