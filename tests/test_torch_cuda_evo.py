"""The island model and the tensorized engine on the GPU: the device step's
fitness and selection against the numpy path, bit for bit; the engine's
launches and resume; spawned islands on the card against in-process ones;
``plan()`` with the card counted.

Every test here is marked ``cuda`` and skips on hosts without a GPU.  It
imports nothing of the reference package, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_evo.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import IslandOrchestrator
from repro_torch.core.islands import plan
from repro_torch.core.tensor_evo import TensorEvaluator, TensorGevoML, TorchXP
from repro_torch.core.tensor_evo.nsga2 import rank_crowd, selection_order
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.workloads import (KERNELS,
                                           build_joint_kernel_workload,
                                           build_kernel_workload)
from repro_torch.workloads.twofc import build_twofc_training_workload

pytestmark = pytest.mark.cuda

COUNTERS = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "mamba_scan": mamba_scan}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _random_rows(encoding, n, seed):
    rng = np.random.default_rng(seed)
    nc = encoding.n_choices()
    return np.stack([rng.integers(0, nc) for _ in range(n)])


@pytest.mark.parametrize("space_name", KERNELS + ("joint",))
def test_device_terms_equal_numpy_bit_for_bit(cuda, space_name):
    w = (build_joint_kernel_workload() if space_name == "joint"
         else build_kernel_workload(space_name))
    te = TensorEvaluator(w)
    rows = _random_rows(te.encoding, 4096, seed=1)
    time_np, valid_np, _ = te.batched.terms(np, rows)
    time_np = np.asarray(time_np, np.float64) * np.ones(len(rows))
    time_d, valid_d = te.batched.torch_terms_fn(cuda)(
        torch.as_tensor(rows, device=cuda))
    assert np.array_equal(time_d.cpu().numpy().view(np.int64),
                          time_np.view(np.int64))
    assert np.array_equal(valid_d.cpu().numpy(), np.asarray(valid_np, bool))
    err_d = te.batched.torch_error_fn(cuda)(
        torch.as_tensor(rows, device=cuda)).cpu().numpy()
    err_np = te.batched.errors_np(rows, valid_np)
    assert np.array_equal(err_d[valid_np], err_np[valid_np])
    te.close()


def test_device_selection_equals_numpy(cuda):
    palette = np.array([0.0, 1.0, 2.0, 0.5, -1.25, 3.0, np.inf, -np.inf,
                        np.nan])
    rng = np.random.default_rng(0)
    xp = TorchXP(cuda)
    for n in list(range(1, 40)) + [257, 1024]:
        for _ in range(4):
            m = int(rng.integers(1, 4))
            objs = (rng.choice(palette, size=(n, m)) if rng.random() < 0.5
                    else rng.integers(-4, 5, size=(n, m)) / 4.0)
            valid = rng.random(n) < 0.8
            with np.errstate(all="ignore"):
                rank_np, crowd_np = rank_crowd(objs, valid)
                order_np = selection_order(rank_np, crowd_np)
            rank, crowd = rank_crowd(objs, valid, xp=xp)
            order = selection_order(rank, crowd, xp=xp)
            crowd = crowd.cpu().numpy()
            assert np.array_equal(rank.cpu().numpy(), rank_np)
            assert np.array_equal(np.isnan(crowd), np.isnan(crowd_np))
            assert np.array_equal(crowd[~np.isnan(crowd)],
                                  crowd_np[~np.isnan(crowd_np)])
            assert np.array_equal(order.cpu().numpy(), order_np)


def test_engine_launches_each_class_once_and_resumes(cuda, tmp_path):
    w = build_joint_kernel_workload()
    for c in COUNTERS.values():
        c.launches = 0

    def engine(name):
        return TensorGevoML(w, pop_size=256, n_elite=8, seed=2,
                            checkpoint_dir=str(tmp_path / name))

    with engine("a") as eng:
        full = eng.run(generations=4)
    launches = {k: c.launches for k, c in COUNTERS.items()}
    # the launchable classes of the joint space's (impl, error knob) pairs
    assert launches == {"rmsnorm": 2, "flash_attention": 5,
                        "mamba_scan": 5}
    with engine("b") as eng:
        eng.run(generations=2)
    with engine("b") as eng:
        res = eng.run(generations=4, resume=True)
    assert ([(i.patch, i.fitness) for i in res.population]
            == [(i.patch, i.fitness) for i in full.population])


def test_spawned_islands_on_the_card_equal_in_process(cuda, tmp_path):
    w = build_twofc_training_workload(batch=16, hidden=8, steps=3,
                                      n_train=128, n_test=128)
    kw = dict(n_islands=2, pop_size=4, migrate_every=2, n_migrants=1)
    r_in = IslandOrchestrator(w, root_dir=str(tmp_path / "in"),
                              **kw).run(generations=4)
    r_pr = IslandOrchestrator(w, root_dir=str(tmp_path / "pr"),
                              processes=True, **kw).run(generations=4)
    assert ([(i.edits, i.fitness) for i in r_in.pareto]
            == [(i.edits, i.fitness) for i in r_pr.pareto])
    assert r_in.migration_log == r_pr.migration_log


def test_plan_counts_the_card(cuda):
    p = plan(4, cores=8)
    assert p.cards == torch.cuda.device_count()
    assert torch.cuda.get_device_name(0) in p.describe()
    assert not plan(4, cores=64, time_mode="measured").processes
