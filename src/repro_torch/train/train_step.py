"""The train step factory (the counterpart of
``src/repro/train/train_step.py``).

``make_train_step`` builds ``step(state, batch) -> (state, metrics)`` for
any arch config on one device: the loss, its gradients by autograd (the
kernels' gradients are the backward kernels), microbatch accumulation (a
Python loop in the reference's order: ``loss += loss_i / k``, ``g += g_i /
k`` in f32, from zeros), the optimizer's in-place update, and the gradient
norm.  The reference's int8-compressed data-parallel all-reduce and its
distribution context need a mesh, which waits (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from ..models.transformer import Model, train_loss
from ..optim.optimizers import Optimizer

MESH_ITEM = ("the mesh (launch/mesh, launch/shardings, optim/grad_compress) "
             "is not ported yet: ROADMAP.md, queue 1, item 9")


def TrainState(params: Model, opt_state, step=0, residuals=None) -> dict:
    """The training state: the model, the optimizer's state and the step
    (a host int32 tensor, as the reference keeps a jnp int32)."""
    if residuals is not None:
        raise NotImplementedError(f"gradient-compression residuals: "
                                  f"{MESH_ITEM}")
    return {"params": params, "opt_state": opt_state,
            "step": torch.tensor(step, dtype=torch.int32)}


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    """Microbatch i holds rows [i b/k, (i + 1) b/k) of every entry, as the
    reference's reshape to (k, b/k, ...) orders them."""
    out = [{} for _ in range(k)]
    for name, x in batch.items():
        b = x.shape[0]
        assert b % k == 0, f"batch {b} not divisible by {k} microbatches"
        for i in range(k):
            out[i][name] = x[i * (b // k):(i + 1) * (b // k)]
    return out


def loss_and_grads(cfg, params: Model, batch: dict):
    """The loss of ``batch`` and its gradient for every parameter (zeros
    for one the loss does not reach), keyed by name."""
    names, tensors = zip(*params.named_parameters())
    loss = train_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for n, p, g in zip(names, tensors, grads)}


def _accum_grads(cfg, params: Model, batch: dict, k: int):
    """Mean loss and f32 gradients over k microbatches."""
    loss = torch.zeros((), dtype=torch.float32, device=params.device)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    for mb in _split_microbatches(batch, k):
        l_i, g_i = loss_and_grads(cfg, params, mb)
        loss = loss + l_i / k
        for n, g in g_i.items():
            grads[n] = grads[n] + g / k
    return loss, grads


def grad_norm(cfg, grads: dict) -> torch.Tensor:
    """The global gradient norm in f32; ``cfg.gnorm_vdot`` takes the
    reference's A/B baseline form (a dot product of each flattened
    gradient with itself)."""
    if cfg.gnorm_vdot:
        return torch.sqrt(sum(torch.dot(g.flatten(), g.flatten())
                              for g in grads.values()).to(torch.float32))
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))


def make_train_step(cfg, optimizer: Optimizer, dist=None,
                    microbatches: int = 1, compress_grads: bool = False,
                    grad_shardings=None):
    """Returns ``step(state, batch) -> (state, metrics)``; ``metrics``
    holds the loss and the gradient norm as 0-d device tensors.  The state's
    parameters and moments are updated in place, and the same dict comes
    back with its step advanced."""
    if dist is not None or compress_grads or grad_shardings is not None:
        raise NotImplementedError(f"dist, compress_grads, grad_shardings: "
                                  f"{MESH_ITEM}")

    def step(state, batch):
        params = state["params"]
        if microbatches > 1:
            loss, grads = _accum_grads(cfg, params, batch, microbatches)
        else:
            loss, grads = loss_and_grads(cfg, params, batch)
        named = dict(params.named_parameters())
        optimizer.update(grads, state["opt_state"], named, state["step"])
        gnorm = grad_norm(cfg, grads)
        state["step"] = state["step"] + 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return step
