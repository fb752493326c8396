"""The port's static analysis against the reference's, on the CPU: the
dataflow passes on random mutants, the patch screen's labels and
``invalid`` messages, screened searches, the schedule linter, the deploy
layer's front and registry documents, and the analysis CLI.

Mutants are drawn with one seed in each package and are the same program
(``serialize`` fingerprints checked).  Every check is exact, with two
deliberate differences, each stated where it is tested:

* ``fold_constants`` keeps a folded 0-d value 0-d; the reference makes it
  shape (1,) (``np.ascontiguousarray``), and its folded program then fails
  ``Program.verify`` (seeds 1149, 1529 and 1847 of the MLP below);
* the linter's capacity check holds a kernel module's ``smem_bytes``
  against the 232,448 bytes of shared memory a block may use on the H100,
  where the reference holds its working set against a TPU core's VMEM.
"""

import functools
import itertools
import json

import numpy as np
import pytest
import torch

import repro.core.analysis as ref_analysis
import repro.core.analysis.classify as ref_classify
import repro.core.deploy as ref_deploy
import repro.core.edits as ref_edits
import repro.core.fitness as ref_fitness
import repro.core.search as ref_search
import repro.core.serialize as ref_serialize
import repro.kernels.costs as ref_costs
import repro.workloads.mobilenet as ref_mobilenet
import repro.workloads.twofc as ref_twofc
import repro_torch.core.analysis as analysis
import repro_torch.core.analysis.classify as classify
import repro_torch.core.deploy as deploy
import repro_torch.core.edits as edits
import repro_torch.core.fitness as fitness
import repro_torch.core.serialize as serialize
import repro_torch.kernels.workloads as workloads
import repro_torch.workloads.mobilenet as mobilenet
import repro_torch.workloads.twofc as twofc
from repro.core.analysis.lint import lint_genome as ref_lint_genome
from repro.core.builder import Builder as RefBuilder
from repro.core.evaluator import EvalOutcome as RefEvalOutcome
from repro.core.fitness import HBM_BW, PEAK_FLOPS
from repro.core.fitness import KernelWorkload as RefKernelWorkload
from repro.core.schedule import ScheduleSpace as RefScheduleSpace
from repro_torch.core.analysis.__main__ import main as analysis_cli
from repro_torch.core.analysis.diagnostics import smem_capacity
from repro_torch.core.analysis.lint import lint_genome, lint_path
from repro_torch.core.builder import Builder
from repro_torch.core.evaluator import FitnessCache, SerialEvaluator
from repro_torch.core.fitness import KernelWorkload
from repro_torch.core.interp import evaluate
from repro_torch.core.search import GevoML
from repro_torch.kernels.costs import H100, DeviceModel, schedule_time
from repro_torch.kernels.flash_attention.flash_attention import smem_bytes
from repro_torch.workloads.weights import from_reference

TINY_2FC = dict(batch=32, hidden=16, steps=5, n_train=256, n_test=256)
ARTIFACT = "experiments/artifacts/kernel__rmsnorm__d-512_rows-512.json"

# the reference's TPU-v5e constants as a DeviceModel (see test_torch_core)
REF_DEVICE = DeviceModel(
    name="reference constants", peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW,
    vector_flops=ref_costs.VPU_FLOPS, grid_step_s=ref_costs.GRID_STEP_S,
    seq_step_s=ref_costs.SEQ_STEP_S, smem_per_block=ref_costs.VMEM_BYTES,
    tile_m=8, tile_n=128)


@pytest.fixture
def ref_constants(monkeypatch):
    """The port's static time under the reference's TPU-v5e constants, in
    every module that computes it, so static fitness must agree exactly."""
    ref_static = functools.partial(fitness.static_time,
                                   peak_flops=ref_fitness.PEAK_FLOPS,
                                   hbm_bw=ref_fitness.HBM_BW)
    monkeypatch.setattr(fitness, "static_time", ref_static)
    monkeypatch.setattr(classify, "static_time", ref_static)


def _mlp(builder_cls):
    b = builder_cls("mlp")
    x = b.input("x", (4, 8))
    w1 = b.const(np.random.RandomState(0).randn(8, 16).astype(np.float32))
    h = b.relu(b.dot(x, w1))
    w2 = b.const(np.random.RandomState(1).randn(16, 6).astype(np.float32))
    b.output(b.softmax(b.dot(h, w2)))
    return b.done()


@functools.cache
def _bases():
    """(port, reference) base programs: the MLP of the reference's property
    tests, the 2fcNet SGD step and a narrow MobileNet (alpha 0.25)."""
    mob = ref_mobilenet.init_mobilenet(alpha=0.25, seed=0)
    return {
        "mlp": (_mlp(Builder), _mlp(RefBuilder)),
        "twofc": (twofc.build_twofc_step(batch=8, hidden=16),
                  ref_twofc.build_twofc_step(batch=8, hidden=16)),
        "mobilenet": (mobilenet.mobilenet_to_ir(from_reference(mob), 4),
                      ref_mobilenet.mobilenet_to_ir(mob, 4)),
    }


def _mutant(program, seed, edits_mod, max_edits=4):
    rng = np.random.default_rng(seed)
    p = program
    for _ in range(int(rng.integers(0, max_edits + 1))):
        try:
            e = edits_mod.sample_edit(p, rng)
            p = edits_mod.Patch((e,)).apply(p)
        except edits_mod.EditError:
            continue
    return p


def _pair(name, seed):
    prog, ref_prog = _bases()[name]
    p, q = _mutant(prog, seed, edits), _mutant(ref_prog, seed, ref_edits)
    assert serialize.program_fingerprint(p) == \
        ref_serialize.program_fingerprint(q)
    return p, q


def _zero_d_folds_only(port, ref) -> bool:
    """Whether two folded programs differ only where a 0-d value was folded:
    a constant the port keeps at shape () and the reference stores as (1,),
    with the same bytes."""
    differ = False
    for a, b in zip(port.ops, ref.ops, strict=True):
        if a.opcode == b.opcode == "constant":
            va, vb = np.asarray(a.attrs["value"]), np.asarray(b.attrs["value"])
            if va.shape != vb.shape:
                if not (va.shape == () and vb.shape == (1,)
                        and va.tobytes() == vb.tobytes()):
                    return False
                differ = True
    return differ


# --------------------------------------------------------------------------
# dataflow
# --------------------------------------------------------------------------

SEEDS = {"mlp": list(range(24)) + [1149, 1529, 1847],
         "twofc": list(range(16)), "mobilenet": list(range(8))}


@pytest.mark.parametrize("name,seed", [(n, s) for n, seeds in SEEDS.items()
                                       for s in seeds])
def test_dataflow_matches_reference(name, seed):
    """def-use chains, dead ops, normalize and the canonical fingerprint
    equal the reference's on a random mutant; fold_constants too, except
    where the reference mistypes a 0-d fold (then its folded program fails
    verify and the port's verifies and computes what the mutant does)."""
    p, q = _pair(name, seed)
    assert analysis.def_use_chains(p) == ref_analysis.def_use_chains(q)
    assert [(op.opcode, op.result) for op in analysis.dead_ops(p)] == \
        [(op.opcode, op.result) for op in ref_analysis.dead_ops(q)]
    assert serialize.program_fingerprint(analysis.eliminate_dead(p)) == \
        ref_serialize.program_fingerprint(ref_analysis.eliminate_dead(q))
    folded, ref_folded = analysis.fold_constants(p), \
        ref_analysis.fold_constants(q)
    folded.verify()
    if serialize.program_fingerprint(folded) != \
            ref_serialize.program_fingerprint(ref_folded):
        assert _zero_d_folds_only(folded, ref_folded)
        with pytest.raises(Exception):
            ref_folded.verify()
        x = np.random.default_rng(seed).standard_normal((4, 8)).astype(
            np.float32)
        for a, b in zip(evaluate(p, {"x": x}, "cpu"),
                        evaluate(folded, {"x": x}, "cpu")):
            assert torch.equal(a, b)
        return
    norm, ref_norm = analysis.normalize(p), ref_analysis.normalize(q)
    assert serialize.program_fingerprint(norm) == \
        ref_serialize.program_fingerprint(ref_norm)
    assert analysis.canonical_fingerprint(norm) == \
        ref_analysis.canonical_fingerprint(ref_norm)


def test_zero_d_seeds_are_the_ones_that_differ():
    """The reference's 0-d fold bug shows on the MLP seeds the ROADMAP
    lists, and the port's fold keeps those constants 0-d."""
    for seed in (1149, 1529, 1847):
        p, q = _pair("mlp", seed)
        assert _zero_d_folds_only(analysis.fold_constants(p),
                                  ref_analysis.fold_constants(q))


# --------------------------------------------------------------------------
# the patch screen
# --------------------------------------------------------------------------

def _patches(program, edits_mod, n, seed):
    """``n`` patches of 1 to 3 sampled edits, one seed for both packages;
    a patch whose edits do not apply is kept (the screen must say so)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        es = []
        for _ in range(int(rng.integers(1, 4))):
            try:
                es.append(edits_mod.sample_edit(program, rng))
            except edits_mod.EditError:
                pass
        out.append(edits_mod.Patch(tuple(es)))
    return out


def _kernel_pair(kernel):
    """A kernel workload of each package scored by the reference's cost
    constants (error: 1 for the oracle, else 0), with the static probe the
    screen runs."""
    space = workloads.kernel_space(kernel) if kernel != "joint" else \
        workloads.joint_space()
    ref_space = RefScheduleSpace.of(space.name, {
        n: space.choices(n) for n in space.names()})

    def split(g):
        return [(k, {kn: g[f"{k}.{kn}"] for kn in workloads._JOINT_SPACES[k]})
                for k in workloads.KERNELS] if kernel == "joint" else \
            [(kernel, g)]

    def probe(g, ref):
        t = 0.0
        for k, sub in split(g):
            t += (ref_costs.schedule_time(k, sub, **workloads.SHAPES[k])
                  if ref else schedule_time(k, sub, device=REF_DEVICE,
                                            **workloads.SHAPES[k]))
        return t

    def runner(g, ref):
        return probe(g, ref), float(any(s["impl"] == "ref"
                                        for _, s in split(g)))

    base = space.encode(
        workloads.BASELINES[kernel] if kernel != "joint" else
        {f"{k}.{kn}": workloads.BASELINES[k][kn] for k in workloads.KERNELS
         for kn in workloads._JOINT_SPACES[k]})
    port = KernelWorkload(name=f"kernel/{kernel}", program=base, space=space,
                          runner=lambda g: runner(g, False),
                          static_probe=lambda g: probe(g, False))
    ref_base = ref_space.encode(space.decode(base))
    ref = RefKernelWorkload(name=f"kernel/{kernel}", program=ref_base,
                            space=ref_space,
                            runner=lambda g: runner(g, True),
                            static_probe=lambda g: probe(g, True))
    return port, ref


def _ir_pair(name):
    if name == "twofc":
        return (twofc.build_twofc_training_workload(device="cpu", **TINY_2FC),
                ref_twofc.build_twofc_training_workload(**TINY_2FC))
    prog, ref_prog = _bases()["mobilenet"]
    x = np.zeros((8, 32, 32, 3), np.float32)
    y = np.zeros(8, np.int32)
    return (fitness.PredictionWorkload("mobilenet", prog, x, y, batch=4,
                                       device="cpu"),
            ref_fitness.PredictionWorkload("mobilenet", ref_prog, x, y,
                                           batch=4))


@pytest.mark.parametrize("name", ["twofc", "mobilenet", "rmsnorm",
                                  "flash_attention", "mamba_scan", "joint"])
def test_screen_labels_and_messages_match_reference(name, ref_constants):
    """Each sampled patch gets the reference's label, canonical key and
    ``invalid`` message, and the message is the one the port's own
    evaluation raises, byte for byte."""
    kernel = name not in ("twofc", "mobilenet")
    w, ref_w = _kernel_pair(name) if kernel else _ir_pair(name)
    screen, ref_screen = classify.make_screen(w), ref_classify.make_screen(
        ref_w)
    n = 24 if name != "mobilenet" else 12
    ops = "attr_tweak=1" if kernel else "all"
    weights = edits.OperatorWeights.parse(ops)
    ref_weights = ref_edits.OperatorWeights.parse(ops)
    rng, ref_rng = np.random.default_rng(7), np.random.default_rng(7)
    labels = set()
    for _ in range(n):
        k = int(rng.integers(1, 4))
        assert int(ref_rng.integers(1, 4)) == k
        try:
            patch = edits.Patch(tuple(edits.sample_edit(w.program, rng,
                                                        weights)
                                      for _ in range(k)))
        except edits.EditError:
            with pytest.raises(ref_edits.EditError):
                ref_edits.Patch(tuple(ref_edits.sample_edit(
                    ref_w.program, ref_rng, ref_weights) for _ in range(k)))
            continue
        ref_patch = ref_edits.Patch(tuple(
            ref_edits.sample_edit(ref_w.program, ref_rng, ref_weights)
            for _ in range(k)))
        assert serialize.patch_key("f", patch) == \
            ref_serialize.patch_key("f", ref_patch)
        res, ref_res = screen.classify(patch), ref_screen.classify(ref_patch)
        labels.add(res.label)
        assert (res.label, res.canon) == (ref_res.label, ref_res.canon)
        if res.label == "invalid":
            assert res.outcome.error == ref_res.outcome.error
            with pytest.raises((edits.EditError, fitness.InvalidVariant)) \
                    as raised:
                w.evaluate(patch.apply(w.program))
            assert str(raised.value) == res.outcome.error
        elif res.canon is not None:
            out = SerialEvaluator(w).evaluate_one(patch)
            screen.observe(res, out)
            ref_screen.observe(ref_res, RefEvalOutcome(
                fitness=out.fitness, error=out.error))
    assert labels


def _screened_run(search_cls, w, **kw):
    s = search_cls(w, screen=True, **kw)
    res = s.run(generations=3)
    return res, s.evaluator.n_screened, dict(s.evaluator.screened_by)


@pytest.mark.parametrize("name", ["twofc", "joint"])
def test_screened_static_search_matches_reference(name, ref_constants):
    """GevoML(screen=True) in static mode walks the reference's
    generations: the same population fitness, front, history and screen
    counters."""
    if name == "twofc":
        w, ref_w = _ir_pair("twofc")
        kw = dict(pop_size=8, n_elite=4, seed=5, operators="all")
    else:
        w, ref_w = _kernel_pair("joint")
        kw = dict(pop_size=8, n_elite=4, seed=5, init_mutations=2,
                  mutation_rate=0.9, operators={"attr_tweak": 1.0})
    res, n, by = _screened_run(GevoML, w, **kw)
    ref_res, ref_n, ref_by = _screened_run(ref_search.GevoML, ref_w, **kw)
    assert [i.fitness for i in res.population] == \
        [i.fitness for i in ref_res.population]
    assert [i.fitness for i in res.pareto] == \
        [i.fitness for i in ref_res.pareto]
    assert (n, by) == (ref_n, ref_by) and n > 0
    drop = ("wall_s",)
    assert [{k: v for k, v in h.items() if k not in drop}
            for h in res.history] == \
        [{k: v for k, v in h.items() if k not in drop}
         for h in ref_res.history]


def test_screened_verdicts_cached_with_analysis_writer(tmp_path):
    """A statically invalid variant never runs; its record carries the
    ``analysis:<writer>`` tag and its verdict, and reading one's own record
    back is not a cross-writer hit."""
    w, _ = _kernel_pair("joint")
    patch = next(p for p in _patches(w.program, edits, 64, 3)
                 if classify.make_screen(w).classify(p).label == "invalid")
    path = str(tmp_path / "cache.jsonl")
    ev = SerialEvaluator(w, cache=FitnessCache(path, writer="me"))
    ev.screen = classify.make_screen(w)
    out = ev.evaluate_one(patch)
    assert out.verdict == "invalid" and ev.n_screened == 1 \
        and ev.n_evals == 0
    rec = json.loads(open(path).readline())
    assert rec["writer"] == "analysis:me" and rec["verdict"] == "invalid"
    ev2 = SerialEvaluator(w, cache=FitnessCache(path, writer="me"))
    assert ev2.evaluate_one(patch).cached and ev2.cache.cross_hits == 0
    ev.close(), ev2.close()


def test_make_evaluator_attaches_screen_and_featurizer():
    from repro_torch.core.evaluator import make_evaluator
    w = workloads.build_kernel_workload("rmsnorm", device="cpu")
    with make_evaluator(w, screen=True, features=True) as ev:
        assert isinstance(ev.screen, analysis.KernelScreen)
        assert ev.featurizer is not None
        out = ev.evaluate_one(edits.Patch())
        assert out.ok and ev.cache.features_of(ev.key(edits.Patch()))


# --------------------------------------------------------------------------
# the linter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", workloads.KERNELS)
def test_lint_codes_match_reference(kernel):
    """Every genome of the joint space's choices gets the reference's
    diagnostics at the search shapes (none of them reaches either capacity
    gate there)."""
    choices = workloads._JOINT_SPACES[kernel]
    names = list(choices)
    for values in itertools.product(*choices.values()):
        g = dict(zip(names, values))
        got = lint_genome(kernel, g, choices=choices)
        want = ref_lint_genome(kernel, g, choices=choices)
        assert [d.to_doc() for d in got] == [d.to_doc() for d in want], g


def test_lint_capacity_is_shared_memory_not_vmem():
    """Deliberate difference: at head dim 128, f32 flash with block_k 256
    needs 256 KB of shared memory a block, over the H100's 227 KB; the
    reference's TPU VMEM holds it."""
    g = {"impl": "pallas", "block_q": 128, "block_k": 256}
    shape = {"hd": 128}
    got = lint_genome("flash_attention", g, shape=shape)
    full = dict(workloads.SHAPES["flash_attention"], **shape)
    used = smem_bytes(g, full, torch.float32)
    assert used > H100.smem_per_block
    cap = [d for d in got if d.code == "smem-capacity"]
    assert len(cap) == 1 and cap[0].message == smem_capacity(
        "flash_attention", used, H100.smem_per_block).message
    assert "block_k" in cap[0].knob and "block_k choices" in cap[0].hint
    with pytest.raises(fitness.InvalidVariant) as raised:
        schedule_time("flash_attention", g, **full)
    assert str(raised.value) == cap[0].message
    assert not any(d.is_error for d in
                   ref_lint_genome("flash_attention", g, shape=shape))


# --------------------------------------------------------------------------
# the deploy layer's front and registry
# --------------------------------------------------------------------------

def test_registry_documents_round_trip_both_ways(tmp_path):
    """The committed rmsnorm artifact reads, verifies and re-exports byte
    for byte in the port, and a manifest either package exports resolves
    in the other."""
    doc = json.load(open(ARTIFACT))
    a = deploy.Artifact.from_doc(doc)
    assert a.to_doc() == ref_deploy.Artifact.from_doc(doc).to_doc() == doc
    port_reg = deploy.ArtifactRegistry(str(tmp_path / "port"))
    ref_reg = ref_deploy.ArtifactRegistry(str(tmp_path / "ref"))
    path = port_reg.export(a)
    ref_path = ref_reg.export(ref_deploy.Artifact.from_doc(doc))
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    assert ref_deploy.ArtifactRegistry(str(tmp_path / "port")).resolve(
        "rmsnorm", a.shape, kind="kernel").to_doc() == doc
    assert deploy.ArtifactRegistry(str(tmp_path / "ref")).resolve(
        "rmsnorm", workloads.SHAPES["rmsnorm"], kind="kernel").to_doc() == doc
    tampered = dict(doc, genome=dict(doc["genome"], block_rows=256))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        deploy.Artifact.from_doc(tampered)


def test_front_documents_round_trip_both_ways(tmp_path):
    """A front exported by one package loads in the other with the same
    members and the same constrained selection; a port checkpoint loads as
    a front in both."""
    w = workloads.build_kernel_workload("rmsnorm", device="cpu")
    ck = tmp_path / "ck"
    res = GevoML(w, pop_size=6, n_elite=3, seed=0, init_mutations=2,
                 mutation_rate=0.9, operators={"attr_tweak": 1.0},
                 checkpoint_dir=str(ck)).run(generations=2)
    members = [deploy.FrontMember(fitness=i.fitness,
                                  patch=tuple(serialize.patch_doc(i.patch)),
                                  source="test") for i in res.pareto]
    front = deploy.ParetoFront.from_members(members, origin="test")
    path = str(tmp_path / "front.json")
    front.export(path)
    ref_front = ref_deploy.ParetoFront.load(path)
    assert ref_front.to_doc() == front.to_doc()
    ref_path = str(tmp_path / "ref_front.json")
    ref_front.export(ref_path)
    assert open(ref_path, "rb").read() == open(path, "rb").read()
    assert deploy.ParetoFront.load(ref_path).to_doc() == front.to_doc()
    assert front.select(within=0.0).to_doc() == \
        ref_front.select(within=0.0).to_doc()
    latest = str(ck / "latest.json")
    assert deploy.ParetoFront.load(latest).to_doc() == \
        ref_deploy.ParetoFront.load(latest).to_doc()


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_lint_and_explain_artifacts(tmp_path, capsys):
    assert analysis_cli(["lint", ARTIFACT, "--strict"]) == 0
    assert "ok" in capsys.readouterr().out
    reg = deploy.ArtifactRegistry(str(tmp_path))
    reg.export(deploy.Artifact(
        kind="kernel", name="rmsnorm", shape=workloads.SHAPES["rmsnorm"],
        genome=dict(workloads.BASELINES["rmsnorm"], block_rows=256)))
    assert analysis_cli(["explain", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "(baseline: 128)" in out and "impl = 'pallas'  (baseline)" in out
    reg.export(deploy.Artifact(
        kind="kernel", name="flash_attention",
        shape=workloads.SHAPES["flash_attention"],
        genome=dict(workloads.BASELINES["flash_attention"], block_q=48)))
    assert analysis_cli(["lint", str(tmp_path), "--strict"]) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "not among the declared choices" in out
    assert len(lint_path(str(tmp_path))) == 2


def test_cli_explain_and_diff_on_a_checkpoint(tmp_path, capsys):
    """``explain`` and ``diff`` read a port checkpoint and classify its IR
    patches against a workload built on the CPU (``--device cpu``)."""
    w = twofc.build_twofc_training_workload(device="cpu", **TINY_2FC)
    GevoML(w, seed=5, pop_size=6, n_elite=3, operators="all",
           checkpoint_dir=str(tmp_path)).run(generations=1)
    ck = str(tmp_path / "latest.json")
    assert analysis_cli(["explain", ck, "--member", "0"]) == 0
    assert "pass --workload" in capsys.readouterr().out
    assert analysis_cli(["explain", ck, "--member", "0", "--workload",
                         "twofc", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fingerprint mismatch" in out and "verdict:" in out
    assert analysis_cli(["diff", ck, ck, "--member-a", "0", "--member-b",
                         "0", "--workload", "twofc", "--device",
                         "cpu"]) == 0
    assert "EQUIVALENT" in capsys.readouterr().out
