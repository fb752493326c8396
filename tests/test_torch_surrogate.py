"""The port's surrogate layer against the reference's, on the CPU: feature
vectors, the ridge fit on the committed cache, the pre-rank order,
surrogate-guided static searches (with and without the screen), the
checkpointed counters and the CLI.

Tolerances: features, pre-rank orders, fronts and counters are equal; the
ridge fit's parameters and predictions agree to 1e-9 relative (the same
numpy solve in both packages; the bound leaves room for a BLAS that sums in
another order).  The port's static time and its kernels' feature probe use
H100 rates (``kernels.costs.H100``), so the program featurizer is held to
the reference under the reference's rates, and the schedule featurizer is
fed the reference's probe.
"""

import functools
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import repro.core.edits as ref_edits
import repro.core.fitness as ref_fitness
import repro.core.search as ref_search
import repro.core.serialize as ref_serialize
import repro.core.surrogate as ref_surrogate
import repro.core.surrogate.features as ref_features
import repro.kernels.costs as ref_costs
import repro.workloads.twofc as ref_twofc
import repro_torch.core.analysis.classify as classify
import repro_torch.core.edits as edits
import repro_torch.core.fitness as fitness
import repro_torch.core.serialize as serialize
import repro_torch.core.surrogate as surrogate
import repro_torch.core.surrogate.features as features
import repro_torch.kernels.workloads as workloads
import repro_torch.workloads.twofc as twofc
from repro.core.fitness import HBM_BW, PEAK_FLOPS
from repro.core.fitness import KernelWorkload as RefKernelWorkload
from repro.core.schedule import ScheduleSpace as RefScheduleSpace
from repro.core.surrogate.__main__ import main as ref_cli
from repro_torch.core.fitness import KernelWorkload
from repro_torch.core.search import GevoML
from repro_torch.core.surrogate.__main__ import main as cli
from repro_torch.kernels.costs import DeviceModel, schedule_time

MINI_CACHE = os.path.join(os.path.dirname(__file__), "..", "experiments",
                          "caches", "rmsnorm_mini.jsonl")
TINY_2FC = dict(batch=32, hidden=16, steps=5, n_train=256, n_test=256)
RTOL = 1e-9

REF_DEVICE = DeviceModel(
    name="reference constants", peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW,
    vector_flops=ref_costs.VPU_FLOPS, grid_step_s=ref_costs.GRID_STEP_S,
    seq_step_s=ref_costs.SEQ_STEP_S, smem_per_block=ref_costs.VMEM_BYTES,
    tile_m=8, tile_n=128)


@pytest.fixture
def ref_constants(monkeypatch):
    """The port's static time under the reference's constants in every
    module that computes it."""
    ref_static = functools.partial(fitness.static_time,
                                   peak_flops=ref_fitness.PEAK_FLOPS,
                                   hbm_bw=ref_fitness.HBM_BW)
    for mod in (fitness, classify, features):
        monkeypatch.setattr(mod, "static_time", ref_static)


def _kernel_pair(kernel):
    """A kernel workload of each package: cost model under the reference's
    constants, error 1 for the oracle and 0 otherwise, and the reference's
    feature probe in both."""
    space = workloads.kernel_space(kernel)
    ref_space = RefScheduleSpace.of(space.name, {
        n: space.choices(n) for n in space.names()})
    shape = workloads.SHAPES[kernel]

    def probe(g):
        return ref_costs.schedule_features(kernel, g, **shape)

    def port_time(g):
        return schedule_time(kernel, g, device=REF_DEVICE, **shape)

    def ref_time(g):
        return ref_costs.schedule_time(kernel, g, **shape)

    base = space.encode(workloads.BASELINES[kernel])
    port = KernelWorkload(
        name=f"kernel/{kernel}", program=base, space=space,
        runner=lambda g: (port_time(g), float(g["impl"] == "ref")),
        static_probe=port_time, feature_probe=probe)
    ref = RefKernelWorkload(
        name=f"kernel/{kernel}", program=ref_space.encode(
            workloads.BASELINES[kernel]), space=ref_space,
        runner=lambda g: (ref_time(g), float(g["impl"] == "ref")),
        static_probe=ref_time, feature_probe=probe)
    return port, ref


def _twofc_pair():
    return (twofc.build_twofc_training_workload(device="cpu", **TINY_2FC),
            ref_twofc.build_twofc_training_workload(**TINY_2FC))


def _patch_pairs(w, ref_w, ops, n, seed):
    """``n`` patches of 1 to 3 sampled edits, drawn with one seed in each
    package (the same patches: their keys are checked)."""
    weights = edits.OperatorWeights.parse(ops)
    ref_weights = ref_edits.OperatorWeights.parse(ops)
    rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    out = []
    while len(out) < n:
        k = int(rng.integers(1, 4))
        ref_rng.integers(1, 4)
        try:
            p = edits.Patch(tuple(edits.sample_edit(w.program, rng, weights)
                                  for _ in range(k)))
        except edits.EditError:
            with pytest.raises(ref_edits.EditError):
                ref_edits.Patch(tuple(ref_edits.sample_edit(
                    ref_w.program, ref_rng, ref_weights) for _ in range(k)))
            continue
        q = ref_edits.Patch(tuple(ref_edits.sample_edit(
            ref_w.program, ref_rng, ref_weights) for _ in range(k)))
        assert serialize.patch_key("f", p) == ref_serialize.patch_key("f", q)
        out.append((p, q))
    return out


def _close(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", workloads.KERNELS)
def test_schedule_features_identical(kernel):
    w, ref_w = _kernel_pair(kernel)
    f, ref_f = surrogate.make_featurizer(w), ref_surrogate.make_featurizer(
        ref_w)
    assert isinstance(f, surrogate.ScheduleFeaturizer)
    assert f.feature_names == ref_f.feature_names
    for p, q in _patch_pairs(w, ref_w, "attr_tweak=1", 16, 2):
        assert f(p) == ref_f(q)


def test_port_schedule_probe_names_shared_memory():
    """The port's own probe is the H100 cost model: its capacity counter
    is ``smem_frac`` (the reference's is ``vmem_frac``)."""
    w = workloads.build_kernel_workload("flash_attention", device="cpu")
    names = surrogate.make_featurizer(w).feature_names
    assert "smem_frac" in names and "vmem_frac" not in names


def test_program_features_identical(ref_constants):
    w, ref_w = _twofc_pair()
    f, ref_f = surrogate.make_featurizer(w), ref_surrogate.make_featurizer(
        ref_w)
    assert isinstance(f, surrogate.ProgramFeaturizer)
    assert f.feature_names == ref_f.feature_names
    for p, q in _patch_pairs(w, ref_w, "all", 16, 3):
        assert f(p) == ref_f(q)


# --------------------------------------------------------------------------
# the model on the committed cache
# --------------------------------------------------------------------------

def test_ridge_fit_matches_reference_on_committed_cache():
    keys, X, Y = surrogate.dataset_from_jsonl(MINI_CACHE)
    ref_keys, ref_X, ref_Y = ref_surrogate.dataset_from_jsonl(MINI_CACHE)
    assert keys == ref_keys and len(keys) > 8
    assert np.array_equal(X, ref_X) and np.array_equal(Y, ref_Y)
    m = surrogate.SurrogateModel(l2=1e-3).fit(X, Y)
    ref_m = ref_surrogate.SurrogateModel(l2=1e-3).fit(ref_X, ref_Y)
    doc, ref_doc = m.to_doc(), ref_m.to_doc()
    for k in ("mu", "sigma", "w"):
        _close(doc[k], ref_doc[k])
    _close(m.predict(X), ref_m.predict(ref_X))
    got, want = m.metrics(X, Y), ref_m.metrics(ref_X, ref_Y)
    assert got.keys() == want.keys()
    _close([got[k] for k in sorted(got)], [want[k] for k in sorted(want)])
    # a model either package saved loads in the other
    _close(ref_surrogate.SurrogateModel.from_doc(doc).predict(X),
           m.predict(X))


@pytest.mark.parametrize("seed", range(6))
def test_prerank_order_identical(seed):
    """NSGA-II order over predicted objectives (ties, duplicates and
    dominated rows included) and the guide's kept slice."""
    rng = np.random.default_rng(seed)
    objs = rng.integers(0, 6, size=(24, 2)).astype(float)
    assert surrogate.pareto_order(objs) == ref_surrogate.pareto_order(objs)
    keys, X, Y = surrogate.dataset_from_jsonl(MINI_CACHE)
    m = surrogate.SurrogateModel().fit(X, Y)
    ref_m = ref_surrogate.SurrogateModel().fit(X, Y)
    assert surrogate.pareto_order(m.predict(X)) == \
        ref_surrogate.pareto_order(ref_m.predict(X))
    w, ref_w = _kernel_pair("rmsnorm")
    g = surrogate.SurrogateGuide(w, keep=0.5, min_fit=4)
    ref_g = ref_surrogate.SurrogateGuide(ref_w, keep=0.5, min_fit=4)
    g.model, ref_g.model = m, ref_m
    room = int(rng.integers(1, len(X)))
    assert g.select(X.tolist(), room) == ref_g.select(X.tolist(), room)
    assert g.stats() == ref_g.stats()


# --------------------------------------------------------------------------
# guided searches
# --------------------------------------------------------------------------

def _guided(search_cls, w, **kw):
    s = search_cls(w, surrogate=True, surrogate_keep=0.5, **kw)
    res = s.run(generations=4)
    return res, s


@pytest.mark.parametrize("name,screen", [("rmsnorm", False),
                                         ("flash_attention", True),
                                         ("twofc", True)])
def test_guided_static_search_matches_reference(name, screen, ref_constants):
    """A surrogate-guided static GevoML (screened too where marked) walks
    the reference's generations: the same fitness, front, history, guide
    stats and screen counters."""
    if name == "twofc":
        w, ref_w = _twofc_pair()
        kw = dict(pop_size=8, n_elite=4, seed=2, operators="all")
    else:
        w, ref_w = _kernel_pair(name)
        kw = dict(pop_size=8, n_elite=4, seed=2, init_mutations=2,
                  mutation_rate=0.9, operators={"attr_tweak": 1.0})
    res, s = _guided(GevoML, w, screen=screen, surrogate_live=screen, **kw)
    ref_res, ref_s = _guided(ref_search.GevoML, ref_w, screen=screen,
                             surrogate_live=screen, **kw)
    assert [i.fitness for i in res.population] == \
        [i.fitness for i in ref_res.population]
    assert [i.fitness for i in res.pareto] == \
        [i.fitness for i in ref_res.pareto]
    assert s.guide.stats() == ref_s.guide.stats()
    assert s.guide.stats()["refits"] > 0
    assert (s.evaluator.n_screened, s.evaluator.screened_by) == \
        (ref_s.evaluator.n_screened, ref_s.evaluator.screened_by)
    drop = ("wall_s",)
    assert [{k: v for k, v in h.items() if k not in drop}
            for h in res.history] == \
        [{k: v for k, v in h.items() if k not in drop}
         for h in ref_res.history]
    assert s.evaluator.featurizer is s.guide.featurizer


def test_guided_checkpoint_resume_restores_counters(tmp_path):
    w = workloads.build_kernel_workload("rmsnorm", device="cpu")
    kw = dict(pop_size=6, seed=0, operators={"attr_tweak": 1.0},
              surrogate=True, checkpoint_dir=str(tmp_path))
    s1 = GevoML(w, **kw)
    s1.run(generations=3)
    before = s1.guide.stats()
    ck = json.load(open(tmp_path / "latest.json"))
    assert ck["counters"]["surrogate"] == before
    s2 = GevoML(w, **kw)
    s2.run(generations=3, resume=True)   # replays nothing: restores counters
    assert s2.guide.stats()["ranked"] == before["ranked"]
    assert s2.guide.stats()["refits"] == before["refits"]


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_cli_matches_reference_on_committed_cache(tmp_path):
    """train, eval and rank print what the reference's CLI prints on the
    committed cache, and write the same model document."""
    model, ref_model = str(tmp_path / "m.json"), str(tmp_path / "r.json")
    got = _stdout(cli, ["train", "--cache", MINI_CACHE, "--out", model])
    want = _stdout(ref_cli, ["train", "--cache", MINI_CACHE, "--out",
                             ref_model])
    assert got == want.replace(ref_model, model)
    doc, ref_doc = json.load(open(model)), json.load(open(ref_model))
    for k in ("mu", "sigma", "w"):
        _close(doc[k], ref_doc[k])
    for cmd in (["eval", "--model", model, "--cache", MINI_CACHE],
                ["rank", "--model", model, "--cache", MINI_CACHE,
                 "--top", "5"]):
        assert _stdout(cli, cmd) == _stdout(ref_cli, cmd)
