"""The port's island model (``repro_torch.core.islands``) on the CPU,
against the reference's ``repro.core.islands`` and against itself.

* Topologies, migrant selection, migration rounds, island specs and
  ``plan()`` without cards: equal to the reference's on the same inputs.
* A whole island run on a test-local workload whose fitness is one numpy
  function of the program (the program built once by each package's
  builder): the same manifest, migrants, round log, island populations
  and merged front as the reference's, ``(edits, fitness)`` bit for bit.
* The reference's own island contracts, on the port's 2fcNet at a tiny
  size: one island is a plain ``GevoML``; resume at a round boundary and
  mid-epoch is bit-exact; config drift and another workload are refused;
  spawned islands equal in-process ones (the one spawned test of this
  file, 2 islands); the kill-anywhere-then-resume property (hypothesis,
  bounded examples, no example database).
* ``plan()`` on cards: measured islands stay in one process; the CUDA
  contexts a plan opens are capped by the cards' memory.
* The deployment handoff: ``ParetoFront.load`` reads a search's export and
  an island run directory and gives the members ``to_front`` gives.
* The device rule and the CLI.
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core as ref_core
import repro.core.islands as ref_islands
import repro.core.islands.migration as ref_migration
import repro.workloads.twofc as ref_twofc
import repro_torch.core.islands as islands
import repro_torch.core.islands.migration as migration
import repro_torch.workloads.twofc as twofc
from repro_torch.core import GevoML, IslandOrchestrator
from repro_torch.core.deploy import ParetoFront
from repro_torch.core.fitness import DeviceFault, InvalidVariant
from repro_torch.core.islands import (CONTEXT_RESERVE_BYTES, IslandSpec,
                                      default_island_specs, plan)
from repro_torch.core.islands import __main__ as cli
from repro_torch.core.islands.worker import island_payload, run_island_epoch
from repro_torch.core.serialize import patch_doc

_TINY = dict(batch=16, hidden=8, steps=3, n_train=128, n_test=128)
TOPOLOGIES = ("ring", "full", "broadcast_best")


@pytest.fixture(scope="module")
def tiny_workload():
    return twofc.build_twofc_training_workload(**_TINY, device="cpu")



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch CPU thread a test, as it was after: these tests run small
    ops, which a worker's full thread pool beside other workers' only
    slows down.  Every comparison here is within one setting."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

def _key_pop(res):
    return [(i.edits, i.fitness) for i in res.population]


def _key_pareto(res):
    return [(i.edits, i.fitness) for i in res.pareto]


def _docs(res):
    """An island result as plain docs, comparable across packages."""
    return {"pareto": [(patch_doc(i.patch), i.fitness) for i in res.pareto],
            "sources": res.pareto_sources,
            "populations": [[(patch_doc(i.patch), i.fitness)
                             for i in isl.population]
                            for isl in res.islands],
            "migration_log": res.migration_log,
            "original": res.original_fitness}


# -- topology, migrants, specs, plan: the reference's on the same inputs ----

@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_migration_edges_match_reference(topology):
    for n in range(0, 7):
        assert (islands.migration_edges(topology, n)
                == ref_islands.migration_edges(topology, n))
    with pytest.raises(ValueError, match="unknown topology"):
        islands.migration_edges("hypercube", 4)


def _population_docs(rng, n, island):
    """Seeded population docs with ties, duplicates and inf objectives."""
    palette = np.array([0.0, 0.25, 0.5, 1.0, 2.0, np.inf])
    return [{"edits": [{"kind": "attr_tweak", "target_uid": island,
                        "seed": int(j)}],
             "fitness": [float(v) for v in rng.choice(palette, 2)]}
            for j in range(n)]


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_select_and_compute_migration_match_reference(topology):
    rng = np.random.default_rng(7)
    for case in range(30):
        n_islands = int(rng.integers(1, 5))
        pops = [_population_docs(rng, int(rng.integers(0, 9)), i)
                for i in range(n_islands)]
        for k in (0, 1, 2, 5):
            for pop in pops:
                assert (migration.select_migrants(pop, k)
                        == ref_migration.select_migrants(pop, k)), case
            assert (migration.compute_migration(topology, pops, k)
                    == ref_migration.compute_migration(topology, pops, k)
                    ), case


def test_island_specs_and_docs_match_reference():
    for n in (1, 4, 6):
        for kw in ({}, {"operators": {"attr_tweak": 1.0}},
                   {"base_seed": 11, "mutation_rate": 0.25},
                   {"operators": "legacy", "base_seed": 3}):
            port = default_island_specs(n, **kw)
            ref = ref_islands.default_island_specs(n, **kw)
            assert [s.to_doc() for s in port] == [s.to_doc() for s in ref]
            for s in port:
                assert IslandSpec.from_doc(s.to_doc()).to_doc() == s.to_doc()
                assert (ref_islands.IslandSpec.from_doc(s.to_doc()).to_doc()
                        == s.to_doc())
    spec = IslandSpec(name="x", seed=5, operators="copy=1,delete=2",
                      pop_size=6, n_elite=3)
    assert (spec.to_doc()
            == ref_islands.IslandSpec(**spec.to_doc()).to_doc())


def test_plan_without_cards_matches_reference():
    for n in range(1, 9):
        for cores in (1, 2, 3, 4, 8, 16, 17, 33, 64):
            for reserve in (0, 1, 2):
                port = plan(n, cores=cores, reserve=reserve, cards=0)
                ref = ref_islands.plan(n, cores=cores, reserve=reserve)
                assert (port.n_islands, port.processes, port.eval_workers,
                        port.cores) == (ref.n_islands, ref.processes,
                                        ref.eval_workers, ref.cores)
                assert port.describe() == ref.describe()
                assert port.cards == 0 and port.max_contexts is None
    for time_mode in ("static", "measured"):
        assert (plan(4, cores=17, cards=0, time_mode=time_mode).eval_workers
                == ref_islands.plan(4, cores=17).eval_workers == 3)
    if not torch.cuda.is_available():   # no card seen: the same plan
        assert plan(4, cores=8) == plan(4, cores=8, cards=0)
    with pytest.raises(ValueError):
        plan(0, cards=0)
    with pytest.raises(ValueError, match="time_mode"):
        plan(2, cards=0, time_mode="wall")


def test_plan_counts_cards_and_contexts():
    card = dict(cards=1, card_memory=80 * 2**30)
    # measured time on a card: one process, one after the other
    p = plan(4, cores=64, time_mode="measured", **card)
    assert not p.processes and p.eval_workers == 0 and p.contexts == 1
    # static: the core arithmetic, within the contexts the card holds
    p = plan(4, cores=8, **card)
    assert p.processes and p.eval_workers == 0 and p.contexts == 4
    assert p.max_contexts == 80 * 2**30 // CONTEXT_RESERVE_BYTES
    assert "1 card, 4 CUDA contexts of at most 80" in p.describe()
    # a card that holds 5 contexts: evaluator workers shrink first
    small = dict(card, card_memory=5 * CONTEXT_RESERVE_BYTES)
    p = plan(2, cores=17, **small)
    assert p.processes and p.eval_workers == 2 and p.contexts == 4
    assert plan(2, cores=17, cards=0).eval_workers == 7
    # then the islands leave their processes
    p = plan(6, cores=64, **small)
    assert not p.processes and p.eval_workers == 0
    # two cards hold twice the contexts
    p = plan(6, cores=64, **dict(small, cards=2))
    assert p.processes and p.max_contexts == 10 and p.contexts == 6
    assert "2 cards" in p.describe()
    with pytest.raises(ValueError, match="card_memory"):
        plan(2, cores=8, cards=1)


# -- a whole island run against the reference ---------------------------------

class NumpyFitnessWorkload:
    """A workload whose fitness is one numpy function of the program: the
    log-size of every op's result as time, and the constants' sum folded
    into [0, 1) as error.  ``invalid`` is the package's InvalidVariant."""

    def __init__(self, program, invalid):
        self.name = "numpy-fitness"
        self.program = program
        self.time_mode = "static"
        self._invalid = invalid

    def evaluate(self, program):
        try:
            program.verify()
        except Exception as e:
            raise self._invalid(str(e)) from e
        t = 1e-6 * sum(np.log1p(float(np.prod(op.type.shape)))
                       for op in program.ops) + 1e-9 * len(program.ops)
        consts = [float(np.sum(np.asarray(op.attrs["value"], np.float64)))
                  for op in program.ops if op.opcode == "constant"]
        return float(t), float(np.abs(np.sum(consts)) % 1.0)


@pytest.fixture(scope="module")
def numpy_workloads():
    kw = dict(batch=4, in_dim=6, hidden=5, classes=3)
    port = NumpyFitnessWorkload(twofc.build_twofc_step(**kw),
                                InvalidVariant)
    ref = NumpyFitnessWorkload(ref_twofc.build_twofc_step(**kw),
                               ref_core.fitness.InvalidVariant)
    return port, ref


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_island_run_matches_reference(numpy_workloads, tmp_path, topology):
    port_w, ref_w = numpy_workloads
    kw = dict(n_islands=3, pop_size=6, migrate_every=2, n_migrants=2,
              topology=topology)
    res = IslandOrchestrator(port_w, root_dir=str(tmp_path / "port"),
                             device="cpu", **kw).run(generations=5)
    ref = ref_core.IslandOrchestrator(ref_w, root_dir=str(tmp_path / "ref"),
                                      **kw).run(generations=5)
    manifest = json.load(open(tmp_path / "port" / "manifest.json"))
    ref_manifest = json.load(open(tmp_path / "ref" / "manifest.json"))
    assert manifest == ref_manifest
    assert len(manifest["rounds"]) == 2
    assert _docs(res) == _docs(ref)
    assert res.cross_island_hits == ref.cross_island_hits
    front = res.to_front(origin="o").to_doc()
    assert front == ref.to_front(origin="o").to_doc()


# -- the port against itself --------------------------------------------------

@pytest.fixture(scope="module")
def island_run(tiny_workload, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("islands"))
    orch = IslandOrchestrator(tiny_workload, root_dir=root, n_islands=3,
                              pop_size=6, migrate_every=2, n_migrants=2,
                              topology="ring", device="cpu")
    return root, orch, orch.run(generations=4)


def test_island_search_state_and_shared_cache(island_run):
    root, orch, res = island_run
    assert len(res.islands) == 3 and len(res.pareto) >= 1
    objs = np.array([i.fitness for i in res.pareto])
    for i in range(len(objs)):          # mutual non-domination
        for j in range(len(objs)):
            if i != j:
                assert not (np.all(objs[i] <= objs[j])
                            and np.any(objs[i] < objs[j]))
    assert set(res.pareto_sources) <= set(res.names)
    assert all(len(r.history) == 4 for r in res.islands)
    manifest = json.load(open(f"{root}/manifest.json"))
    assert manifest["workload_fingerprint"] == orch.fingerprint
    assert [r["round"] for r in manifest["rounds"]] == [1]
    assert manifest["rounds"][0]["start_gen"] == 2
    assert all(len(v) == 2 for v in manifest["rounds"][0]["migrants"]
               .values())
    assert res.cross_island_hits >= 1 and res.cache_stats["entries"] > 0


def test_single_island_equals_plain_gevoml(tiny_workload, tmp_path):
    spec = IslandSpec(name="solo", seed=3, operators="all",
                      mutation_rate=0.5, init_mutations=2)
    res = IslandOrchestrator(tiny_workload, root_dir=str(tmp_path),
                             specs=[spec], pop_size=4, n_elite=2,
                             device="cpu").run(generations=2)
    plain = GevoML(tiny_workload, pop_size=4, n_elite=2, seed=3,
                   init_mutations=2, operators="all").run(generations=2)
    assert _key_pareto(res.islands[0]) == _key_pareto(plain)
    assert _key_pop(res.islands[0]) == _key_pop(plain)
    assert res.migration_log == []


def test_resume_at_round_boundary_bit_exact(tiny_workload, tmp_path):
    kw = dict(n_islands=2, pop_size=4, migrate_every=2, n_migrants=1,
              topology="full", device="cpu")
    r_full = IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "a"),
                                **kw).run(generations=4)
    IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "b"),
                       **kw).run(generations=2)
    r_res = IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "b"),
                               **kw).run(generations=4, resume=True)
    assert _key_pareto(r_res) == _key_pareto(r_full)
    assert r_res.migration_log == r_full.migration_log
    for a, b in zip(r_full.islands, r_res.islands):
        assert _key_pop(a) == _key_pop(b)


class _Kill(Exception):
    pass


def test_resume_mid_epoch_bit_exact(tiny_workload, tmp_path):
    kw = dict(n_islands=2, pop_size=4, migrate_every=2, n_migrants=1,
              topology="ring", device="cpu")
    r_full = IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "a"),
                                **kw).run(generations=5)

    def bomb(name, gen, row):
        if name == "island-0" and gen == 2:   # first gen of epoch 1
            raise _Kill

    with pytest.raises(_Kill):
        IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "k"),
                           **kw).run(generations=5, on_generation=bomb)
    r_res = IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "k"),
                               **kw).run(generations=5, resume=True)
    assert _key_pareto(r_res) == _key_pareto(r_full)
    assert r_res.migration_log == r_full.migration_log


def test_resume_refuses_drift_and_other_workloads(tiny_workload, tmp_path):
    kw = dict(n_islands=2, pop_size=4, n_migrants=1, device="cpu")
    IslandOrchestrator(tiny_workload, root_dir=str(tmp_path), migrate_every=2,
                       **kw).run(generations=2)
    with pytest.raises(ValueError, match="migrate_every"):
        IslandOrchestrator(tiny_workload, root_dir=str(tmp_path),
                           migrate_every=3, **kw).run(generations=4,
                                                      resume=True)
    other = twofc.build_twofc_training_workload(**{**_TINY, "steps": 7},
                                                device="cpu")
    with pytest.raises(ValueError, match="different workload"):
        IslandOrchestrator(other, root_dir=str(tmp_path), migrate_every=2,
                           **kw).run(generations=4, resume=True)
    with pytest.raises(FileNotFoundError):
        IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "none"),
                           **kw).run(generations=2, resume=True)


def test_process_mode_identical_to_in_process(tiny_workload, tmp_path):
    """The one spawned test: 2 island processes rebuild the workload from
    its WorkloadSpec on the CPU and reach the in-process result."""
    kw = dict(n_islands=2, pop_size=6, migrate_every=2, n_migrants=1,
              topology="full", device="cpu")
    r_in = IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "in"),
                              **kw).run(generations=4)
    r_pr = IslandOrchestrator(tiny_workload, root_dir=str(tmp_path / "pr"),
                              processes=True, **kw).run(generations=4)
    assert _key_pareto(r_in) == _key_pareto(r_pr)
    assert r_in.migration_log == r_pr.migration_log
    for a, b in zip(r_in.islands, r_pr.islands):
        assert _key_pop(a) == _key_pop(b)
    assert (json.load(open(tmp_path / "in" / "manifest.json"))
            == json.load(open(tmp_path / "pr" / "manifest.json")))


_W = None


def _workload():
    # one tiny workload for every example (hypothesis re-enters the body,
    # not the fixture machinery)
    global _W
    if _W is None:
        _W = twofc.build_twofc_training_workload(**_TINY, device="cpu")
    return _W


def _key(res):
    return (_key_pareto(res), [_key_pop(isl) for isl in res.islands],
            res.migration_log)


@settings(max_examples=5, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large,
                                 HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_kill_anywhere_then_resume_is_bit_exact(tmp_path_factory, data):
    n_islands = data.draw(st.integers(2, 3), label="n_islands")
    migrate_every = data.draw(st.integers(1, 2), label="migrate_every")
    topology = data.draw(st.sampled_from(TOPOLOGIES), label="topology")
    generations = data.draw(st.integers(2, 4), label="generations")
    kill_island = data.draw(st.integers(0, n_islands - 1), label="island")
    kill_gen = data.draw(st.integers(0, generations - 1), label="gen")
    w = _workload()
    kw = dict(n_islands=n_islands, pop_size=4, n_elite=2,
              migrate_every=migrate_every, n_migrants=1, topology=topology,
              device="cpu")
    r_full = IslandOrchestrator(
        w, root_dir=str(tmp_path_factory.mktemp("full")),
        **kw).run(generations=generations)

    def bomb(name, gen, row):
        if name == f"island-{kill_island}" and gen == kill_gen:
            raise _Kill

    kill_root = str(tmp_path_factory.mktemp("kill"))
    with pytest.raises(_Kill):
        IslandOrchestrator(w, root_dir=kill_root, **kw).run(
            generations=generations, on_generation=bomb)
    r_res = IslandOrchestrator(w, root_dir=kill_root, **kw).run(
        generations=generations, resume=True)
    assert _key(r_res) == _key(r_full)


# -- the deployment handoff ---------------------------------------------------

def test_pareto_front_load_reads_search_exports_and_island_dirs(
        island_run, tiny_workload, tmp_path):
    root, _, res = island_run

    def members(front):
        return [(m.fitness, m.patch, m.source) for m in front.members]

    loaded = ParetoFront.load(root)
    assert members(loaded) == members(res.to_front())
    assert loaded.meta["n_islands"] == 3
    res.export_front(str(tmp_path / "islands.json"), origin=root)
    assert (members(ParetoFront.load(str(tmp_path / "islands.json")))
            == members(res.to_front()))
    search = GevoML(tiny_workload, pop_size=4, n_elite=2, seed=1)
    sres = search.run(generations=2)
    sres.export_front(str(tmp_path / "search.json"))
    front = ParetoFront.load(str(tmp_path / "search.json"))
    assert members(front) == members(sres.to_front())
    assert [m.fitness for m in front.members] == [i.fitness
                                                  for i in sres.pareto]
    assert front.meta == {"original_fitness": list(sres.original_fitness),
                          "generations": 2}


# -- the device rule and the CLI ----------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a GPU")
def test_islands_need_a_card_unless_told_otherwise(tiny_workload, tmp_path,
                                                   numpy_workloads):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IslandOrchestrator(tiny_workload, root_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IslandOrchestrator(tiny_workload, root_dir=str(tmp_path),
                           backend="mesh")
    # a spawned island that cannot reach its card raises a DeviceFault
    payload = island_payload(
        tiny_workload, default_island_specs(1)[0],
        checkpoint_dir=str(tmp_path / "i"), cache_path=None, generations=1,
        resume=False, migrants=[], pop_size=4, n_elite=2, max_tries=4,
        inline=False, device="cuda")
    with pytest.raises(DeviceFault, match="cannot reach cuda"):
        run_island_epoch(payload)
    # a workload built for another kind of device is refused
    w = NumpyFitnessWorkload(numpy_workloads[0].program, InvalidVariant)
    w.device = "cuda:0"
    with pytest.raises(ValueError, match="runs on cuda:0"):
        IslandOrchestrator(w, root_dir=str(tmp_path), device="cpu")


def test_cli_runs_exports_and_resumes(tmp_path, capsys):
    root = str(tmp_path / "run")
    args = ["--workload", "rmsnorm", "--islands", "2", "--generations",
            "2", "--pop", "4", "--root", root, "--device", "cpu",
            "--export-front",
            str(tmp_path / "front.json")]
    res = cli.main(args)
    assert "exported merged front" in capsys.readouterr().out
    front = ParetoFront.load(str(tmp_path / "front.json"))
    assert [m.fitness for m in front.members] == [i.fitness
                                                  for i in res.pareto]
    again = cli.main(args[:5] + ["4"] + args[6:] + ["--resume"])
    assert len(again.islands[0].history) == 4
    with pytest.raises(SystemExit):
        cli.main(["--workload", "twofc", "--engine", "tensor",
                  "--device", "cpu"])
