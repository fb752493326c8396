"""The port's tensorized engine (``repro_torch.core.tensor_evo``) on the
CPU, against the reference's numpy paths and against itself.

The reference's device path (``xp=jax.numpy``: ``TensorGevoML``, the mesh
fleet) needs ``jax.experimental.enable_x64``, which the installed jax no
longer has, so parity is held against its numpy twin paths and
``repro.core.nsga2``:

* ``GenomeEncoding`` rows <-> patches <-> ``patch_key``: equal to the
  reference's, bit for bit.
* ``rank_crowd``, ``selection_order``, ``rank_select``, ``pareto_front``,
  on the port's numpy path AND its torch path (``TorchXP``): equal to the
  reference's numpy path and to ``repro.core.nsga2`` on the reference's
  property sweep (200 seeded populations with ties, duplicates, inf and
  NaN lanes, masked lanes, the all-masked and singleton cases) and a
  bounded hypothesis layer.  Ranks and selection orders exactly; crowding
  distances exactly, NaN where NaN.
* ``torch_terms_fn`` on the CPU equals ``terms(numpy, ...)`` bit for bit,
  time and validity, on random rows of every kernel space and the joint
  space; ``torch_error_fn`` equals the numpy errors.

And the port against itself: the batched fitness equals ``SerialEvaluator``
(invalid lanes and messages included); ``GevoML(engine="tensor")`` is a
seeded twin of ``engine="python"``; ``TensorGevoML`` and the fleet resume
bit-exactly and refuse another program's checkpoint; ``backend="mesh"``
delegates to the fleet; mesh writer tags are unique in a shared cache;
island 0 of a 3-island fleet without migrants follows a 1-island fleet.
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.nsga2 as ref_pynsga
import repro.core.serialize as ref_serialize
import repro.core.tensor_evo.encoding as ref_encoding
import repro.core.tensor_evo.nsga2 as ref_tnsga
import repro.kernels.workloads as ref_workloads
from repro_torch.core import GevoML, IslandOrchestrator
from repro_torch.core.evaluator import ParallelEvaluator, SerialEvaluator
from repro_torch.core.serialize import patch_doc, patch_key
from repro_torch.core.tensor_evo import (GenomeEncoding, TensorEvaluator,
                                         TensorGevoML, TensorIslandFleet,
                                         TensorNSGA2, TorchXP,
                                         make_tensor_evaluator,
                                         mesh_writer_tag, tensorizable)
from repro_torch.core.tensor_evo.nsga2 import (rank_crowd, rank_select,
                                               selection_order)
from repro_torch.kernels.workloads import (KERNELS,
                                           build_joint_kernel_workload,
                                           build_kernel_workload, joint_space,
                                           kernel_space)

# nan objectives make the numpy paths warn; the results are what is checked
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

XP = TorchXP("cpu")



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch CPU thread a test, as it was after: these tests run small
    ops, which a worker's full thread pool beside other workers' only
    slows down.  Every comparison here is within one setting."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

def _random_rows(encoding, n, seed):
    rng = np.random.default_rng(seed)
    nc = encoding.n_choices()
    return np.stack([rng.integers(0, nc) for _ in range(n)])


@pytest.fixture(scope="module")
def joint():
    return build_joint_kernel_workload(device="cpu")


@pytest.fixture(scope="module")
def kernel_workloads():
    return {k: build_kernel_workload(k, device="cpu") for k in KERNELS}


# ---- encoding: the reference's, bit for bit ---------------------------------

@pytest.mark.parametrize("space_name", KERNELS + ("joint",))
def test_encoding_matches_reference(space_name):
    if space_name == "joint":
        space, ref_space = joint_space(), ref_workloads.joint_space()
        base = {f"{k}.{knob}": ref_workloads.BASELINES[k][knob]
                for k in KERNELS for knob in ref_workloads._JOINT_SPACES[k]}
    else:
        space = kernel_space(space_name)
        ref_space = ref_workloads.kernel_space(space_name)
        base = ref_workloads.BASELINES[space_name]
    program, ref_program = space.encode(base), ref_space.encode(base)
    enc = GenomeEncoding.of(space, program)
    ref_enc = ref_encoding.GenomeEncoding.of(ref_space, ref_program)
    assert (enc.knob_uids, enc.base_idx) == (ref_enc.knob_uids,
                                             ref_enc.base_idx)
    assert np.array_equal(enc.n_choices(), ref_enc.n_choices())
    fp = "f" * 64
    rows = _random_rows(enc, 40, seed=len(space_name))
    keys = set()
    for row in rows:
        patch, ref_patch = enc.to_patch(row), ref_enc.to_patch(row)
        assert patch_doc(patch) == ref_serialize.patch_doc(ref_patch)
        assert patch_key(fp, patch) == ref_serialize.patch_key(fp, ref_patch)
        assert np.array_equal(enc.from_patch(patch, program), row)
        assert np.array_equal(ref_enc.from_patch(ref_patch, ref_program),
                              enc.from_patch(patch, program))
        assert enc.genome_of(row) == ref_enc.genome_of(row)
        keys.add(patch_key(fp, patch))
    assert len(keys) == len({tuple(int(v) for v in r) for r in rows})
    assert len(enc.to_patch(enc.baseline_row()).edits) == 0
    bad = enc.baseline_row().copy()
    bad[0] = enc.n_choices()[0]
    with pytest.raises(ValueError):
        enc.to_patch(bad)


# ---- NSGA-II: numpy and torch paths against the reference -------------------

_PALETTE = np.array([0.0, 1.0, 2.0, 0.5, -1.25, 3.0,
                     np.inf, -np.inf, np.nan])


def _random_objs(rng):
    n = int(rng.integers(1, 20))
    m = int(rng.integers(1, 4))
    if rng.random() < 0.5:
        objs = rng.choice(_PALETTE, size=(n, m))
    else:
        objs = rng.integers(-4, 5, size=(n, m)) / 4.0
    if n > 1 and rng.random() < 0.5:
        objs[int(rng.integers(n))] = objs[int(rng.integers(n))]
    return np.asarray(objs, dtype=np.float64)


def _same(a, b) -> bool:
    """Equal values, NaN where NaN, and the same sign on every zero."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))
                and np.array_equal(a[~nan], b[~nan])
                and np.array_equal(np.signbit(a[~nan]), np.signbit(b[~nan])))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_against_reference(objs, valid, n_elite):
    """Port numpy and torch paths == the reference's numpy path; unmasked,
    also == ``repro.core.nsga2``."""
    rank_r, crowd_r = ref_tnsga.rank_crowd(objs, valid)
    order_r = ref_tnsga.selection_order(rank_r, crowd_r)
    _, _, elite_r = ref_tnsga.rank_select(objs, n_elite, valid)
    for xp in (np, XP):
        rank, crowd = rank_crowd(objs, valid, xp=xp)
        order = selection_order(rank, crowd, xp=xp)
        _, _, elite = rank_select(objs, n_elite, valid, xp=xp)
        assert np.array_equal(_np(rank), rank_r)
        assert _same(_np(crowd), crowd_r)
        assert np.array_equal(_np(order), order_r)
        assert [int(i) for i in _np(elite)] == list(elite_r)
    if valid is None:
        rank_p, crowd_p = ref_pynsga.rank_population(objs)
        assert np.array_equal(rank_r, rank_p)
        assert _same(crowd_r, crowd_p)
        assert elite_r == ref_pynsga.rank_select(objs, n_elite)[2]
        assert (TensorNSGA2.pareto_front(objs)
                == sorted(ref_pynsga.pareto_front(objs)))


def test_nsga2_seeded_sweep_200_populations():
    rng = np.random.default_rng(0)
    for _ in range(200):
        objs = _random_objs(rng)
        n_elite = int(rng.integers(0, len(objs) + 2))
        check_against_reference(objs, None, n_elite)
        check_against_reference(objs, rng.random(len(objs)) < 0.7, n_elite)


def test_nsga2_all_masked_singleton_and_identical():
    objs = np.array([[1.0, 2.0], [3.0, 0.5]])
    check_against_reference(objs, np.array([False, False]), 2)
    rank, crowd = rank_crowd(objs, np.array([False, False]), xp=XP)
    assert rank.tolist() == [2, 2] and crowd.tolist() == [0.0, 0.0]
    assert selection_order(rank, crowd, xp=XP).tolist() == [0, 1]
    check_against_reference(np.array([[1.0, 2.0]]), None, 1)
    check_against_reference(np.full((6, 2), 3.5), None, 4)
    check_against_reference(np.array([[np.nan, 1.0], [np.inf, -np.inf],
                                      [np.nan, np.nan], [0.0, -0.0]]),
                            None, 3)


def test_torch_lexsort_orders_nan_last_and_zeros_equal():
    keys = (np.array([3, 1, 2, 0, 5, 4]),
            np.array([np.nan, -0.0, 0.0, -np.inf, np.inf, -np.nan]),
            np.array([1, 1, 1, 1, 1, 1]))
    got = XP.lexsort(tuple(torch.as_tensor(k) for k in keys))
    assert got.tolist() == np.lexsort(keys).tolist()


_vals = st.sampled_from([float(v) for v in _PALETTE[:-1]] + [float("nan")])


@st.composite
def _objs_strategy(draw):
    n = draw(st.integers(1, 16))
    m = draw(st.integers(1, 3))
    rows = draw(st.lists(st.lists(_vals, min_size=m, max_size=m),
                         min_size=n, max_size=n))
    return np.asarray(rows, dtype=np.float64)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(objs=_objs_strategy(), n_elite=st.integers(0, 20), data=st.data())
def test_nsga2_hypothesis_parity(objs, n_elite, data):
    check_against_reference(objs, None, n_elite)
    valid = np.asarray(data.draw(st.lists(st.booleans(), min_size=len(objs),
                                          max_size=len(objs))))
    check_against_reference(objs, valid, n_elite)


# ---- the torch fitness against the numpy path -------------------------------

@pytest.mark.parametrize("space_name", KERNELS + ("joint",))
def test_torch_terms_equal_numpy_bit_for_bit(space_name, joint,
                                             kernel_workloads):
    w = joint if space_name == "joint" else kernel_workloads[space_name]
    te = TensorEvaluator(w)
    rows = _random_rows(te.encoding, 400, seed=3)
    time_np, valid_np, _ = te.batched.terms(np, rows)
    time_np = np.asarray(time_np, np.float64)
    time_t, valid_t = te.batched.torch_terms_fn("cpu")(torch.as_tensor(rows))
    assert time_t.dtype == torch.float64
    assert np.array_equal(time_t.numpy().view(np.int64),
                          time_np.view(np.int64))
    assert np.array_equal(valid_t.numpy(), np.asarray(valid_np, bool))
    if space_name == "joint":
        assert 0 < valid_np.sum() < len(rows)   # both kinds of lane
    err_t = te.batched.torch_error_fn("cpu")(torch.as_tensor(rows)).numpy()
    err_np = te.batched.errors_np(rows, valid_np)
    assert np.array_equal(err_t[valid_np], err_np[valid_np])
    te.close()


# ---- batched fitness == SerialEvaluator -------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_batched_matches_serial_per_kernel(kernel, kernel_workloads):
    w = kernel_workloads[kernel]
    te = TensorEvaluator(w)
    rows = _random_rows(te.encoding, 16, seed=len(kernel))
    patches = [te.encoding.to_patch(r) for r in rows]
    with SerialEvaluator(w) as se:
        serial = se.evaluate_batch(patches)
    tensor = te._evaluate_misses(patches)
    for s, t in zip(serial, tensor):
        assert t.fitness == s.fitness
        assert t.error == s.error
    assert te.n_batched == len(rows)
    te.close()


def test_joint_batched_matches_serial_with_invalid_lanes(joint):
    te = TensorEvaluator(joint)
    rows = _random_rows(te.encoding, 24, seed=5)
    patches = [te.encoding.to_patch(r) for r in rows]
    with SerialEvaluator(joint) as se:
        serial = se.evaluate_batch(patches)
    tensor = te._evaluate_misses(patches)
    assert sum(1 for s in serial if not s.ok) >= 1
    for s, t in zip(serial, tensor):
        assert t.fitness == s.fitness
        assert t.error == s.error
    te.close()


def test_make_tensor_evaluator_falls_back(kernel_workloads):
    w = build_kernel_workload("rmsnorm", device="cpu")
    assert tensorizable(w)
    ev = make_tensor_evaluator(w)
    assert isinstance(ev, TensorEvaluator)
    ev.close()
    w.time_mode = "measured"
    assert not tensorizable(w)
    ev = make_tensor_evaluator(w)
    assert isinstance(ev, ParallelEvaluator)
    ev.close()
    with pytest.raises(ValueError, match="tensorizable"):
        TensorEvaluator(w)


# ---- GevoML(engine="tensor") is a seeded twin -------------------------------

def test_tensor_engine_flag_is_a_seeded_twin(kernel_workloads):
    w = kernel_workloads["flash_attention"]

    def run(engine):
        return GevoML(w, pop_size=10, n_elite=4, seed=7, engine=engine,
                      operators={"attr_tweak": 1.0}).run(generations=3)

    rp, rt = run("python"), run("tensor")
    assert ([(i.patch, i.fitness) for i in rp.population]
            == [(i.patch, i.fitness) for i in rt.population])
    assert [i.fitness for i in rp.pareto] == [i.fitness for i in rt.pareto]
    with pytest.raises(ValueError, match="engine"):
        GevoML(w, engine="cuda")


# ---- TensorGevoML -----------------------------------------------------------

class _Kill(Exception):
    pass


def _engine(w, root, **kw):
    return TensorGevoML(w, pop_size=32, n_elite=4, seed=3, device="cpu",
                        checkpoint_dir=str(root), **kw)


def test_engine_step_scores_as_the_numpy_path(joint):
    with TensorGevoML(joint, pop_size=64, n_elite=8, seed=1,
                      device="cpu") as eng:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(1)
        idx = eng.init_pop(gen)
        assert idx[0].tolist() == eng.encoding.baseline_row().tolist()
        idx, metrics = eng.step_fn()(idx, gen, 0.8, 0.5)
        assert idx.shape == (64, eng.encoding.n_knobs)
        objs, valid = eng.objectives_fn()(idx)
        time, ok, err, _ = eng.batched.evaluate_np(idx.numpy())
        fin = ok & np.isfinite(time) & np.isfinite(err)
        assert np.array_equal(valid.numpy(), fin)
        want = np.stack([np.where(fin, time, np.inf),
                         np.where(fin, err, np.inf)], axis=1)
        assert np.array_equal(objs.numpy(), want)
        rank, crowd = rank_crowd(objs, xp=eng.xp)
        rank_np, crowd_np = rank_crowd(want)
        assert np.array_equal(rank.numpy(), rank_np)
        assert np.array_equal(selection_order(rank, crowd, xp=eng.xp)
                              .numpy(), selection_order(rank_np, crowd_np))


def test_engine_resume_bit_exact(tmp_path, kernel_workloads):
    w = kernel_workloads["mamba_scan"]
    with _engine(w, tmp_path / "a") as full:
        r_full = full.run(generations=6)

    def bomb(gen, row):
        if gen == 3:
            raise _Kill

    with _engine(w, tmp_path / "b") as eng:
        with pytest.raises(_Kill):
            eng.run(generations=6, on_generation=bomb)
    with _engine(w, tmp_path / "b") as eng:
        r_res = eng.run(generations=6, resume=True)
    assert ([(i.patch, i.fitness) for i in r_full.population]
            == [(i.patch, i.fitness) for i in r_res.population])
    assert np.array_equal(
        np.load(tmp_path / "a" / "state_latest.npz")["idx"],
        np.load(tmp_path / "b" / "state_latest.npz")["idx"])
    assert r_full.history[-1]["evals"] == r_res.history[-1]["evals"]
    # extending a finished run continues from its generator
    with _engine(w, tmp_path / "b") as eng:
        assert len(eng.run(generations=8, resume=True).history) == 8


def test_engine_refuses_another_programs_checkpoint(tmp_path,
                                                    kernel_workloads):
    with _engine(kernel_workloads["rmsnorm"], tmp_path) as eng:
        eng.run(generations=1)
    with _engine(kernel_workloads["flash_attention"], tmp_path) as eng:
        with pytest.raises(ValueError, match="fingerprint"):
            eng.run(generations=2, resume=True)


def test_engine_surrogate_path_runs(kernel_workloads):
    with TensorGevoML(kernel_workloads["flash_attention"], pop_size=16,
                      n_elite=4, seed=0, device="cpu", surrogate=True,
                      surrogate_keep=0.5) as eng:
        res = eng.run(generations=3)
    assert len(res.population) >= 1
    assert res.history[-1]["surrogate"]["refits"] >= 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a GPU")
def test_engine_needs_a_card_unless_told_otherwise(kernel_workloads,
                                                   tmp_path):
    w = kernel_workloads["rmsnorm"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorGevoML(w)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorIslandFleet(w, root_dir=str(tmp_path))


# ---- the fleet --------------------------------------------------------------

def _fleet(w, root, **kw):
    kw = {"n_islands": 2, "pop_size": 8, "n_elite": 2, "migrate_every": 2,
          "n_migrants": 2, "seed": 1, **kw}
    return TensorIslandFleet(w, root_dir=str(root), device="cpu", **kw)


def test_fleet_runs_and_resumes_bit_exactly(tmp_path, kernel_workloads):
    w = kernel_workloads["rmsnorm"]
    with _fleet(w, tmp_path / "a") as fleet:
        r_full = fleet.run(5)
    assert r_full.cache_stats["writer_tags"] == ["tensor:0", "tensor:1"]
    assert len(r_full.migration_log) == 2
    manifest = json.load(open(tmp_path / "a" / "manifest.json"))
    assert manifest["backend"] == "mesh" and manifest["gen"] == 4
    with _fleet(w, tmp_path / "b") as fleet:
        fleet.run(3)
    with _fleet(w, tmp_path / "b") as fleet:
        r_res = fleet.run(5, resume=True)
    assert np.array_equal(np.load(tmp_path / "a" / "mesh_state.npz")["idx"],
                          np.load(tmp_path / "b" / "mesh_state.npz")["idx"])
    assert r_res.migration_log == r_full.migration_log
    assert ([(i.patch, i.fitness) for i in r_res.pareto]
            == [(i.patch, i.fitness) for i in r_full.pareto])
    with _fleet(w, tmp_path / "b", migrate_every=3) as fleet:
        with pytest.raises(ValueError, match="migrate_every"):
            fleet.run(6, resume=True)


def test_island_zero_follows_a_one_island_fleet(tmp_path, joint):
    with _fleet(joint, tmp_path / "one", n_islands=1,
                n_migrants=0, pop_size=16) as fleet:
        one = fleet.run(4)
    with _fleet(joint, tmp_path / "three", n_islands=3,
                n_migrants=0, pop_size=16) as fleet:
        three = fleet.run(4)
    idx_one = np.load(tmp_path / "one" / "mesh_state.npz")["idx"]
    idx_three = np.load(tmp_path / "three" / "mesh_state.npz")["idx"]
    assert np.array_equal(idx_one[0], idx_three[0])
    assert not np.array_equal(idx_three[0], idx_three[1])
    assert ([(i.patch, i.fitness) for i in one.islands[0].population]
            == [(i.patch, i.fitness) for i in three.islands[0].population])


def test_mesh_writer_tags_unique_in_a_shared_cache(tmp_path,
                                                   kernel_workloads):
    assert [mesh_writer_tag(i) for i in range(8)] == [f"tensor:{i}"
                                                      for i in range(8)]
    with _fleet(kernel_workloads["rmsnorm"], tmp_path, seed=0) as fleet:
        res = fleet.run(2)
    assert res.cache_stats["writer_tags"] == ["tensor:0", "tensor:1"]
    writers = {json.loads(line)["writer"]
               for line in open(tmp_path / "cache.jsonl")}
    assert writers == {"tensor:0", "tensor:1"}


def test_orchestrator_mesh_backend_delegates(tmp_path, kernel_workloads):
    w = kernel_workloads["rmsnorm"]
    orch = IslandOrchestrator(w, root_dir=str(tmp_path / "m"), n_islands=2,
                              pop_size=8, n_elite=2, backend="mesh",
                              device="cpu")
    res = orch.run(2)
    assert len(res.islands) == 2
    assert sorted(res.cache_stats["per_island"]) == res.names
    with _fleet(w, tmp_path / "f", seed=0, n_migrants=2,
                specs=orch.specs) as fleet:
        direct = fleet.run(2)
    assert ([(i.patch, i.fitness) for i in res.pareto]
            == [(i.patch, i.fitness) for i in direct.pareto])
    with pytest.raises(ValueError, match="on_generation"):
        orch.run(2, on_generation=lambda *a: None)
    with pytest.raises(ValueError, match="surrogate"):
        IslandOrchestrator(w, root_dir=str(tmp_path), backend="mesh",
                           surrogate=True, device="cpu").run(2)
    with pytest.raises(ValueError, match="backend"):
        IslandOrchestrator(w, root_dir=str(tmp_path), backend="gpu",
                           device="cpu")


def test_cli_tensor_engine(tmp_path, capsys):
    from repro_torch.core.islands import __main__ as cli
    res = cli.main(["--workload", "rmsnorm", "--engine", "tensor",
                    "--islands", "2", "--pop", "16", "--generations", "3",
                    "--root", str(tmp_path), "--device", "cpu"])
    assert "engine: tensor" in capsys.readouterr().out
    assert res.cache_stats["writer_tags"] == ["tensor:0", "tensor:1"]
    assert json.load(open(tmp_path / "manifest.json"))["backend"] == "mesh"
