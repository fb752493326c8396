"""The port's data pipeline, checkpoints and training CLI against the
reference, and serving that records no autograd graph.

* ``TokenPipeline`` (a verbatim copy) gives the reference's batches byte
  for byte.
* ``repro_torch.train.checkpoint`` mirrors tests/test_checkpoint.py, and a
  checkpoint crosses the packages both ways: the reference's
  ``restore_like`` reads a port checkpoint of a training state, the port's
  reads the reference's, leaf for leaf (the file holds the same keys and
  stacked arrays).
* ``python -m repro_torch.launch.train --smoke --device cpu``, stopped and
  resumed from its checkpoint, ends with an uninterrupted run's losses and
  parameters: within 1e-5 relative and 1e-5 absolute (1% of one step of lr
  1e-3), not bit for bit, since the CPU's MKL GEMM may round otherwise
  when its operands lie at other addresses (seen: 5e-7 on a loss of a run
  resumed in a process that had done other work first).  On the card the
  same is bit for bit (tests/test_torch_cuda_train.py, chip_smoke.py).
* The engine, the router and a real live-loop tick run with a hook that
  fails if any tensor is saved for a backward pass, and the serving entry
  points' outputs do not require grad.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.data.tokens import TokenPipeline as RefPipeline
from repro.models import transformer as R
from repro.optim.optimizers import adafactor as ref_adafactor
from repro.optim.optimizers import adamw as ref_adamw
from repro.train import checkpoint as ref_ckpt
from repro.train.train_step import TrainState as RefState
from repro.train.train_step import make_train_step as ref_make_step
from repro_torch.core import liveloop as L
from repro_torch.core.deploy import ServeEngine, build_router
from repro_torch.core.liveloop.traces import demo_requests
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.train import main as train_main
from repro_torch.models import transformer as T
from repro_torch.models.weights import params_from_reference
from repro_torch.optim import adafactor, adamw, sgd_momentum
from repro_torch.train.checkpoint import (latest_step, load_latest,
                                          restore_like, save_checkpoint)
from repro_torch.train.train_step import TrainState, make_train_step
from torch_model_oracle import weights


# --------------------------------------------------------------------------
# the data pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,hosts,step", [
    (100, 16, 8, 1, 3), (64, 8, 16, 4, 0), (151936, 32, 4, 2, 7),
    (32, 256, 4, 1, 11)])
def test_token_pipeline_batches_are_byte_identical(vocab, seq, batch, hosts,
                                                   step):
    for host in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch,
                  n_hosts=hosts, host_id=host)
        got, want = TokenPipeline(**kw).batch_at(step), \
            RefPipeline(**kw).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


# --------------------------------------------------------------------------
# the reference's checkpoint tests (tests/test_checkpoint.py), on tensors
# --------------------------------------------------------------------------

def _state(step=0):
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4)},
            "opt_state": {"m": {"w": torch.zeros((3, 4)),
                                "b": torch.zeros(4)}},
            "step": torch.tensor(step, dtype=torch.int32)}


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    s = _state(7)
    save_checkpoint(d, s, 7)
    step, flat = load_latest(d)
    assert step == 7
    restored = restore_like(_state(0), flat)
    assert torch.equal(restored["params"]["w"], s["params"]["w"])
    assert int(restored["step"]) == 7


def test_retention_prunes_old(tmp_path):
    d = str(tmp_path)
    for step in range(6):
        save_checkpoint(d, _state(step), step, keep=3)
    steps = sorted(int(f.split("_")[1].split(".")[0])
                   for f in os.listdir(d) if f.startswith("ckpt_"))
    assert steps == [3, 4, 5]


def test_latest_step_empty(tmp_path):
    assert latest_step(str(tmp_path)) is None
    assert load_latest(str(tmp_path)) is None


def test_async_save_completes(tmp_path):
    d = str(tmp_path)
    t = save_checkpoint(d, _state(1), 1, async_save=True)
    t.join(timeout=30)
    assert latest_step(d) == 1


def test_no_partial_files_visible(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, _state(3), 3)
    assert all(not f.endswith(".tmp") for f in os.listdir(d))


def test_restore_rejects_shape_mismatch(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, _state(1), 1)
    _, flat = load_latest(d)
    bad = _state(0)
    bad["params"]["w"] = torch.zeros((5, 5))
    with pytest.raises(ValueError):
        restore_like(bad, flat)
    del flat["['step']"]
    with pytest.raises(KeyError):
        restore_like(_state(0), flat)


def test_resume_training_from_checkpoint(tmp_path):
    """Save -> crash -> resume: the resumed run continues at the
    checkpointed step with the uninterrupted run's losses."""
    _, ref, tcfg, _ = weights("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, ref)
    pipe = TokenPipeline(vocab=tcfg.vocab, seq_len=8, global_batch=4)
    opt = sgd_momentum(lr=0.1)
    step_fn = make_train_step(tcfg, opt)

    def fresh():
        p = params_from_reference(tree, tcfg, "cpu")
        return TrainState(p, opt.init(dict(p.named_parameters())))

    state = fresh()
    losses_a = []
    for s in range(4):
        state, m = step_fn(state, pipe.batch_at(s))
        losses_a.append(float(m["loss"]))
        if s == 1:
            save_checkpoint(str(tmp_path), state, 2)
    step, flat = load_latest(str(tmp_path))
    state_b = restore_like(fresh(), flat)
    assert step == 2
    losses_b = []
    for s in range(step, 4):
        state_b, m = step_fn(state_b, pipe.batch_at(s))
        losses_b.append(float(m["loss"]))
    np.testing.assert_allclose(losses_b, losses_a[2:], rtol=1e-5)


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------

def _both_states(arch, optimizer="adamw"):
    """The reference's and the port's training states of ``arch``'s smoke
    config after two steps of each (AdamW, or Adafactor), from the same
    weights."""
    cfg, ref, tcfg, _ = weights(arch)
    ref_opt, opt = (ref_adamw(lr=1e-3), adamw(lr=1e-3)) \
        if optimizer == "adamw" else (ref_adafactor(lr=1e-3),
                                      adafactor(lr=1e-3))
    ref_state = RefState(ref, ref_opt.init(ref))
    ref_step = jax.jit(ref_make_step(cfg, ref_opt))
    params = params_from_reference(jax.tree.map(np.asarray, ref), tcfg,
                                   "cpu")
    state = TrainState(params, opt.init(dict(params.named_parameters())))
    step_fn = make_train_step(tcfg, opt)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=8, global_batch=2)
    for s in range(2):
        ref_state, _ = ref_step(ref_state, pipe.batch_at(s))
        state, _ = step_fn(state, pipe.batch_at(s))
    return cfg, ref_state, tcfg, state, ref_opt, opt


def _fresh_port(tcfg, opt, ref):
    p = params_from_reference(jax.tree.map(np.asarray, ref), tcfg, "cpu")
    return TrainState(p, opt.init(dict(p.named_parameters())))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, arch):
    cfg, _, tcfg, state, ref_opt, _ = _both_states(arch)
    save_checkpoint(str(tmp_path), state, 2)
    step, flat = ref_ckpt.load_latest(str(tmp_path))
    ref = R.init_params(cfg, jax.random.PRNGKey(1))
    restored = ref_ckpt.restore_like(RefState(ref, ref_opt.init(ref)), flat)
    assert step == 2 and int(restored["step"]) == 2
    assert int(restored["opt_state"]["count"]) == 2
    ours = ref_ckpt._flatten(restored)
    assert sorted(ours) == sorted(flat)
    for k, v in ours.items():
        assert np.array_equal(np.asarray(v), flat[k]), k


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, arch):
    _, ref_state, tcfg, _, _, opt = _both_states(arch)
    ref_ckpt.save_checkpoint(str(tmp_path), ref_state, 2)
    step, flat = load_latest(str(tmp_path))
    cfg, ref, _, _ = weights(arch)
    state = restore_like(_fresh_port(tcfg, opt, ref), flat)
    assert step == 2 and int(state["step"]) == 2
    assert int(state["opt_state"]["count"]) == 2
    save_checkpoint(str(tmp_path / "again"), state, 2)
    _, again = load_latest(str(tmp_path / "again"))
    assert sorted(again) == sorted(flat)
    for k, v in flat.items():
        assert np.array_equal(again[k], v), k


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_adafactor_checkpoint_crosses_the_packages(tmp_path, arch):
    """An Adafactor checkpoint holds the reference's leaves: the factored
    moments under the reference's keys and stacked shapes (a layer's (d,)
    norm scale is an (n_layers, d) leaf with r and c), and it restores
    into the other package both ways, bit for bit."""
    cfg, ref_state, tcfg, state, ref_opt, opt = _both_states(arch,
                                                             "adafactor")
    save_checkpoint(str(tmp_path / "port"), state, 2)
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), ref_state, 2)
    _, port_flat = ref_ckpt.load_latest(str(tmp_path / "port"))
    _, ref_flat = load_latest(str(tmp_path / "ref"))
    assert sorted(port_flat) == sorted(ref_flat)
    for k, v in ref_flat.items():
        assert port_flat[k].shape == v.shape, k
    n_layers = len(state["params"].layers)
    scales = 0
    for name, p in state["params"].named_parameters():
        parts = name.split(".")
        if parts[0] == "layers" and p.dim() == 1 and parts[1] == "0":
            key = "".join(f"['{x}']" for x in ["opt_state", "f", "layers"]
                          + parts[2:])
            assert port_flat[key + "['r']"].shape == (n_layers,)
            assert port_flat[key + "['c']"].shape == tuple(p.shape)
            assert key + "['v']" not in port_flat
            scales += 1
    assert scales
    # port -> reference
    ref = R.init_params(cfg, jax.random.PRNGKey(1))
    restored = ref_ckpt.restore_like(RefState(ref, ref_opt.init(ref)),
                                     port_flat)
    assert int(restored["opt_state"]["count"]) == 2
    for k, v in ref_ckpt._flatten(restored).items():
        assert np.array_equal(np.asarray(v), port_flat[k]), k
    # reference -> port, and out again
    _, ref0, _, _ = weights(arch)
    back = restore_like(_fresh_port(tcfg, opt, ref0), ref_flat)
    assert int(back["opt_state"]["count"]) == 2
    save_checkpoint(str(tmp_path / "again"), back, 2)
    _, again = load_latest(str(tmp_path / "again"))
    assert sorted(again) == sorted(ref_flat)
    for k, v in ref_flat.items():
        assert np.array_equal(again[k], v), k


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(ckpt, steps, arch="qwen3-0.6b"):
    return train_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", str(steps), "--batch", "2", "--seq", "12",
                       "--ckpt", str(ckpt), "--ckpt-every", "2",
                       "--log-every", "100", "--lr", "1e-3"])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_train_cli_resumes_equal_to_an_uninterrupted_run(tmp_path, arch,
                                                         capsys):
    straight = _cli(tmp_path / "a", 4, arch)
    _cli(tmp_path / "b", 2, arch)
    resumed = _cli(tmp_path / "b", 4, arch)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["start"] == 2
    np.testing.assert_allclose(resumed["losses"], straight["losses"][2:],
                               rtol=1e-5)
    a = dict(straight["state"]["params"].named_parameters())
    for name, p in resumed["state"]["params"].named_parameters():
        diff = float((p - a[name]).abs().max())
        assert diff <= 1e-5, f"{name}: {diff:.3e}"
    assert latest_step(str(tmp_path / "b")) == 4


def test_train_cli_refuses_the_mesh_and_a_missing_gpu():
    """Without a GPU and without ``--device`` the CLI exits, with or
    without ``--mesh smoke``: the mesh does not move to gloo on the CPU
    unless asked (tests/test_torch_mesh.py runs ``--mesh smoke --device
    cpu``)."""
    if not torch.cuda.is_available():
        for mesh in ([], ["--mesh", "smoke"]):
            with pytest.raises(SystemExit, match="no CUDA device"):
                train_main(["--smoke", "--steps", "1", *mesh])


# --------------------------------------------------------------------------
# serving records no graph
# --------------------------------------------------------------------------

def _no_saved_tensors():
    def pack(t):
        raise AssertionError("a tensor was saved for a backward pass")
    return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)


def test_serving_allocates_no_autograd_graph(tmp_path):
    """With weights that require grad, the engine, the router and one real
    live-loop tick save no tensor for a backward pass, and prefill's and
    decode_step's outputs do not require grad."""
    _, _, tcfg, params = weights("qwen3-0.6b")
    assert all(p.requires_grad for p in params.parameters())
    reqs = demo_requests(tcfg, n_requests=4, prompt_len=10, gen=4)
    with _no_saved_tensors():
        logits, caches = T.prefill(params, {"tokens": reqs[0].tokens[None]},
                                   tcfg)
        full = T.init_cache(tcfg, 1, 16, device="cpu")
        logits2, _ = T.decode_step(
            params, {"tokens": torch.tensor([[1]]),
                     "positions": torch.tensor([[10]])}, full, 10, tcfg)
        assert not logits.requires_grad and not logits2.requires_grad
        assert not any(c.requires_grad for c in caches.values())
        served = ServeEngine(tcfg, params, max_len=16, max_slots=2).run(reqs)
        assert len(served) == 4
        router = build_router(tcfg, params, genome={"replicas": 2},
                              max_len=16, device="cpu")
        assert len(router.run(reqs)) == 4
        tr = L.synthesize("bursty", vocab=64, n_requests=4, max_prompt=6,
                          gen=2, seed=0)
        ctl = L.LiveLoopController(
            str(tmp_path / "loop"), trace=tr, mode="real", pop=2,
            repeats=1, surrogate=False, device="cpu",
            guardrails=L.Guardrails(windows=1, min_throughput_ratio=0.0,
                                    max_ttft_ratio=1e9))
        assert ctl.tick()["tick"] == 0
