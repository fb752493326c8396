"""Training in the port against the reference: the gradients of
``train_loss`` for every arch, and the train step's trajectory.

The reference's weights (``init_params(cfg, PRNGKey(0))``) go into the
port through ``params_from_reference``; batches are seeded numpy arrays
(and the reference's ``TokenPipeline``).  On the CPU every kernel wrapper
runs its plain version, forward and backward (the backward's plain
versions are held to ``jax.vjp`` in tests/test_torch_kernels_bwd.py).

Tolerances, each per leaf:
* gradients: |port - ref| <= 1e-3 |ref| + 1e-4 max |ref|.  Both are f32
  sums of the same products in other orders, over the batch, the sequence
  and a dozen layers' chains (seen in a probe: at most 4e-6 of the leaf's
  max); a missing term or a wrong mask moves a gradient by O(max).
* the train step, 3 AdamW steps at lr 1e-3: losses within 1e-5 + 1e-5
  |ref|, gradient norms within 1e-4 relative, parameters within 1e-4
  absolute, a tenth of one step's lr: an element's normalized update
  m / sqrt(v) is at most about 1, so a wrong gradient or update moves it
  by O(lr) a step.  The same for 6 Adafactor steps at lr 1e-3 on every
  arch (its update is clipped to an RMS of 1 over the reference's stacked
  leaf), and its factored moments under the reference's leaf names within
  1e-3 relative (squares of gradients that agree to ~1e-5 of their max).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from repro.data.tokens import TokenPipeline as RefPipeline
from repro.models import transformer as R
from repro.optim.optimizers import adafactor as ref_adafactor
from repro.optim.optimizers import adamw as ref_adamw
from repro.train.train_step import TrainState as RefState
from repro.train.train_step import make_train_step as ref_make_step
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import transformer as T
from repro_torch.models.weights import params_from_reference
from repro_torch.optim import adafactor, adamw
from repro_torch.train.train_step import (TrainState, loss_and_grads,
                                          make_train_step)
from torch_model_oracle import batch, jnp_batch, weights

ARCHS = ("qwen3-0.6b", "qwen1.5-4b", "qwen1.5-32b", "minicpm-2b",
         "qwen2-vl-72b", "hubert-xlarge", "granite-moe-3b-a800m",
         "deepseek-v3-671b", "falcon-mamba-7b", "zamba2-1.2b")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _per_layer(flat: dict, name: str) -> np.ndarray:
    """The reference's leaf for the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return flat["layers." + ".".join(parts[2:])][int(parts[1])]
    return flat[name]


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_gradients_match_jax_grad(arch):
    cfg, ref, tcfg, params = weights(arch)
    b = batch(cfg, 2, 13 if not cfg.loss_chunk else 4 * cfg.loss_chunk)
    want = _flat(jax.jit(jax.grad(lambda p, x: R.train_loss(p, x, cfg)))(
        ref, jnp_batch(b)))
    loss, grads = loss_and_grads(tcfg, params, b)
    assert sorted(grads) == sorted(n for n, _ in params.named_parameters())
    for name, g in grads.items():
        w = _per_layer(want, name)
        got = _np(g)
        bound = 1e-3 * np.abs(w) + 1e-4 * float(np.abs(w).max())
        assert got.shape == w.shape, name
        assert np.all(np.abs(got - w) <= bound), \
            f"{name}: max |diff| {float(np.abs(got - w).max()):.3e}"


def _trajectory(arch, microbatches, steps=3, optimizer="adamw"):
    cfg, ref, tcfg, _ = weights(arch)
    ref_opt, opt = (ref_adamw(lr=1e-3), adamw(lr=1e-3)) \
        if optimizer == "adamw" else (ref_adafactor(lr=1e-3),
                                      adafactor(lr=1e-3))
    ref_step = jax.jit(ref_make_step(cfg, ref_opt,
                                     microbatches=microbatches))
    ref_state = RefState(ref, ref_opt.init(ref))
    params = params_from_reference(jax.tree.map(np.asarray, ref), tcfg,
                                   "cpu")
    state = TrainState(params, opt.init(dict(params.named_parameters())))
    step_fn = make_train_step(tcfg, opt, microbatches=microbatches)
    ref_pipe = RefPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4)
    for s in range(steps):
        if optimizer == "adamw":
            ref_b, b = ref_pipe.batch_at(s), pipe.batch_at(s)
        else:  # every arch: embeddings and M-RoPE positions where it needs
            ref_b = b = batch(cfg, 4, 16, seed=s)
        ref_state, rm = ref_step(ref_state, ref_b)
        state, m = step_fn(state, b)
        want = float(rm["loss"])
        assert abs(float(m["loss"]) - want) <= 1e-5 + 1e-5 * abs(want)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
    assert int(state["step"]) == int(ref_state["step"]) == steps
    want = _flat(jax.tree.map(np.asarray, ref_state["params"]))
    for name, p in params.named_parameters():
        w = _per_layer(want, name)
        assert np.all(np.abs(_np(p) - w) <= 1e-4), \
            f"{name}: max |diff| {float(np.abs(_np(p) - w).max()):.3e}"
    return ref_state, state


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_adamw_train_steps_match_reference(arch):
    _trajectory(arch, microbatches=1)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_microbatched_train_steps_match_reference(arch):
    _trajectory(arch, microbatches=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_train_steps_match_reference(arch):
    ref_state, state = _trajectory(arch, microbatches=1, steps=6,
                                   optimizer="adafactor")
    want = _flat(jax.tree.map(np.asarray, ref_state["opt_state"]["f"]))
    got = {f"{k}.{m}": t.numpy() for k, f in state["opt_state"]["f"].items()
           for m, t in f.items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.all(np.abs(got[k] - w) <= 1e-3 * np.abs(w)
                      + 1e-6 * float(np.abs(w).max())), k


def test_mesh_options_raise_naming_the_roadmap():
    """The mesh's options are ported (ROADMAP.md, queue 1): none raises,
    and without an active mesh each leaves the one-device step as it is,
    as the reference's do (tests/test_torch_mesh.py holds them on a
    mesh)."""
    _, _, tcfg, shared = weights("qwen3-0.6b")
    b = batch(tcfg, 2, 8)
    runs = []
    for kw in ({}, {"compress_grads": True}, {"dist": T.Dist()},
               {"grad_shardings": {}}):
        params = copy.deepcopy(shared)
        state = TrainState(params, adamw().init(
            dict(params.named_parameters())))
        state, m = make_train_step(tcfg, adamw(), **kw)(state, b)
        runs.append((float(m["loss"]), [
            p.detach().clone() for p in state["params"].parameters()]))
    for loss, ps in runs[1:]:
        assert loss == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(ps, runs[0][1]))


def test_train_loss_records_a_graph_serving_does_not():
    """train_loss is differentiable; prefill and decode_step record no
    graph (their outputs do not require grad)."""
    _, _, tcfg, params = weights("qwen3-0.6b")
    b = batch(tcfg, 1, 8)
    assert T.train_loss(params, b, tcfg).requires_grad
    b.pop("labels")
    logits, caches = T.prefill(params, b, tcfg)
    assert not logits.requires_grad
    assert not any(c.requires_grad for c in caches.values())
