"""The train step factory (the counterpart of
``src/repro/train/train_step.py``).

``make_train_step`` builds ``step(state, batch) -> (state, metrics)`` for
any arch config: the loss, its gradients by autograd (the kernels'
gradients are the backward kernels), microbatch accumulation (a Python
loop in the reference's order: ``loss += loss_i / k``, ``g += g_i / k`` in
f32, from zeros), the optimizer's in-place update, and the gradient norm.

Under an active ``Dist`` (one process a rank, launch/mesh.py):

* **The sharded step.**  Parameters and optimizer state may be DTensors
  placed by ``launch/shardings.py`` (``distribute``).  Each rank gathers
  the whole parameters, runs the one-device model on its block of the
  (global) batch under ``batch_specs`` — the kernels stay on local tensors,
  which DTensor could not see into — and the mean of the loss and of the
  gradients over the batch axes is all-reduced.  The MoE FFN with
  ``moe_mode="ep_a2a"`` takes the expert-parallel path over the ``model``
  axis; everything else is the same on every rank of ``model``, so that
  axis shards storage, not arithmetic.  The update then acts on each
  rank's shard: an elementwise optimizer (SGD, AdamW) on the local blocks
  of the parameter, gradient and state; Adafactor, whose factored moments
  and clipping reduce over whole leaves, on the gathered leaves, keeping
  each rank's block.  With the same batch the step is the one-device step:
  bit for bit on a ``(1, 1)`` mesh, and up to the order of the data
  axes' sums otherwise.
* **The compressed step** (``compress_grads=True``): the reference's
  replicated-parameter data parallelism — local gradients on the batch
  block, ``compress_tree_psum`` over ``"data"`` with the residuals carried
  in the state (one a rank), the loss ``pmean``-ed.
* ``grad_shardings`` places the gradients under the given shardings
  before the update.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..launch.shardings import (NamedSharding, batch_specs, gather,
                                local_block, place)
from ..models.common import P, manual_axes, pmean
from ..models.transformer import Dist, Model, init_params, train_loss
from ..optim.grad_compress import compress_tree_psum
from ..optim.optimizers import Optimizer


def TrainState(params: Model, opt_state, step=0, residuals=None) -> dict:
    """The training state: the model, the optimizer's state, the step (a
    host int32 tensor, as the reference keeps a jnp int32) and, for the
    compressed step, this rank's quantization residuals."""
    s = {"params": params, "opt_state": opt_state,
         "step": torch.tensor(step, dtype=torch.int32)}
    if residuals is not None:
        s["residuals"] = residuals
    return s


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


def loss_and_grads(cfg, params: Model, batch: dict, dist: Dist = Dist()):
    """The loss of ``batch`` and its gradient for every parameter (zeros
    for one the loss does not reach), keyed by name."""
    names, tensors = zip(*params.named_parameters())
    loss = train_loss(params, batch, cfg, dist)
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for n, p, g in zip(names, tensors, grads)}


def _accum_grads(cfg, params: Model, batches: list, dist: Dist = Dist()):
    """Mean loss and f32 gradients over the microbatches."""
    k = len(batches)
    loss = torch.zeros((), dtype=torch.float32, device=params.device)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    for mb in batches:
        l_i, g_i = loss_and_grads(cfg, params, mb, dist)
        loss = loss + l_i / k
        for n, g in g_i.items():
            grads[n] = grads[n] + g / k
    return loss, grads


def _grads(cfg, params: Model, batches: list, dist: Dist = Dist()):
    if len(batches) == 1:
        return loss_and_grads(cfg, params, batches[0], dist)
    return _accum_grads(cfg, params, batches, dist)


def grad_norm(cfg, grads: dict) -> torch.Tensor:
    """The global gradient norm in f32; ``cfg.gnorm_vdot`` takes the
    reference's A/B baseline form (a dot product of each flattened
    gradient with itself)."""
    if cfg.gnorm_vdot:
        return torch.sqrt(sum(torch.dot(g.flatten(), g.flatten())
                              for g in grads.values()).to(torch.float32))
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _whole_model(cfg, params: Model) -> Model:
    """``params`` as a model of whole plain tensors: itself, or, when any
    parameter is a DTensor, a new model of the gathered tensors."""
    if not any(_is_dtensor(p) for p in params.parameters()):
        return params
    model = init_params(cfg, device="meta")
    model.load_state_dict(gather(params), strict=True, assign=True)
    return model


def _as_tensors(batch: dict) -> dict:
    return {n: v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)) for n, v in batch.items()}


def _blocks(batch: dict, mesh, specs: dict) -> dict:
    """This rank's block of each entry of the global ``batch``."""
    return {n: local_block(v, mesh, NamedSharding(mesh, specs[n]).placements)
            for n, v in batch.items()}


def _sharded_grads(cfg, dist: Dist, params: Model, batch: dict, k: int):
    """The mean loss and whole gradients over the batch axes: each
    microbatch of the global ``batch`` blocked under ``batch_specs``."""
    mesh = dist.mesh
    dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                   for a in dist.batch_axes)
    mbs = [_blocks(mb, mesh, batch_specs(cfg, mb, dist.batch_axes,
                                         dist.model_axis, dp))
           for mb in _split_microbatches(_as_tensors(batch), k)]
    loss, grads = _grads(cfg, _whole_model(cfg, params), mbs, dist)
    with manual_axes(mesh, mesh.mesh_dim_names):
        loss = pmean(loss, dist.batch_axes)
        grads = {n: pmean(g, dist.batch_axes) for n, g in grads.items()}
    return loss, grads


def _compressed_grads(cfg, dist: Dist, params: Model, batch: dict,
                      residuals):
    """Replicated-parameter data parallelism: this rank's gradients, then
    the int8-compressed mean over ``"data"``."""
    mesh = dist.mesh
    batch = _as_tensors(batch)
    blocks = _blocks(batch, mesh, {n: P(dist.batch_axes) for n in batch})
    loss, grads = loss_and_grads(cfg, _whole_model(cfg, params), blocks)
    with manual_axes(mesh, mesh.mesh_dim_names), torch.no_grad():
        grads, res = compress_tree_psum(grads, "data", residuals)
        loss = pmean(loss, "data")
    return loss, grads, res


def _local(t):
    return t.to_local() if _is_dtensor(t) else t


def _block(g, like):
    """``like``'s own block of ``g``: a whole tensor, or a DTensor under
    other placements (a gradient under ``grad_shardings``)."""
    if _is_dtensor(g):
        if not _is_dtensor(like):
            return g.full_tensor()
        return g.redistribute(like.device_mesh, like.placements).to_local()
    if _is_dtensor(like):
        return local_block(g, like.device_mesh, like.placements)
    return g


def _local_tree(tree):
    return {k: _local_tree(v) if isinstance(v, dict) else _local(v)
            for k, v in tree.items()}


def _store(tree: dict, new: dict, whole: bool) -> None:
    """Write the values of ``new`` (each leaf whole, or the local block)
    into ``tree``'s leaves: a DTensor's local block in place, a plain leaf
    replaced."""
    for k, v in new.items():
        t = tree[k]
        if isinstance(v, dict):
            _store(t, v, whole)
        elif _is_dtensor(t):
            t.to_local().copy_(_block(v, t) if whole else v)
        elif v is not t:
            tree[k] = v


@torch.no_grad()
def _update(optimizer: Optimizer, grads: dict, state: dict) -> None:
    """The optimizer's update of the state's parameters by ``grads``, on
    each rank's shard (see the module docstring)."""
    named = dict(state["params"].named_parameters())
    if optimizer.elementwise or not any(_is_dtensor(p)
                                        for p in named.values()):
        opt = _local_tree(state["opt_state"])
        optimizer.update({n: _block(g, named[n]) for n, g in grads.items()},
                         opt, {n: _local(p) for n, p in named.items()},
                         state["step"])
        _store(state["opt_state"], opt, whole=False)
        return
    whole = gather(named)
    opt = gather(state["opt_state"])
    optimizer.update(gather(grads), opt, whole, state["step"])
    _store(named, whole, whole=True)
    _store(state["opt_state"], opt, whole=True)


def make_train_step(cfg, optimizer: Optimizer, dist: Dist = Dist(),
                    microbatches: int = 1, compress_grads: bool = False,
                    grad_shardings=None):
    """Returns ``step(state, batch) -> (state, metrics)``; ``metrics``
    holds the loss and the gradient norm as 0-d device tensors.  The
    state's parameters and moments are updated in place, and the same dict
    comes back with its step advanced.  Under an active ``dist`` every rank
    calls the step with the same global batch.  ``grad_shardings``: a dict
    of :class:`~repro_torch.launch.shardings.NamedSharding` keyed by
    parameter name (a name it lacks keeps its gradient as it is), placed on
    the gradients before the update."""

    def step(state, batch):
        params = state["params"]
        res = None
        if compress_grads and dist.active:
            loss, grads, res = _compressed_grads(cfg, dist, params, batch,
                                                 state.get("residuals"))
        elif dist.active:
            loss, grads = _sharded_grads(cfg, dist, params, batch,
                                         microbatches)
        else:
            loss, grads = _grads(cfg, params,
                                 _split_microbatches(batch, microbatches))
        gnorm = grad_norm(cfg, grads)
        if grad_shardings is not None:
            grads = {n: place(g, grad_shardings[n])
                     if n in grad_shardings else g for n, g in grads.items()}
        _update(optimizer, grads, state)
        state["step"] = state["step"] + 1
        if res is not None:
            state["residuals"] = res
        return state, {"loss": loss, "grad_norm": gnorm}

    return step
