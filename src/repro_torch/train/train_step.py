"""The train step factory (the counterpart of
``src/repro/train/train_step.py``).

``make_train_step`` builds ``step(state, batch) -> (state, metrics)`` for
any arch config: the loss, its gradients by autograd (the kernels'
gradients are the backward kernels), microbatch accumulation (a Python
loop in the reference's order: ``loss += loss_i / k``, ``g += g_i / k`` in
f32, from zeros), the optimizer's in-place update, and the gradient norm.

Under an active ``Dist`` (one process a rank, launch/mesh.py):

* **The sharded step.**  Parameters and optimizer state may be DTensors
  placed by ``launch/shardings.py`` (``distribute``).  Each rank runs the
  model on its block of the (global) batch under ``batch_specs``, and the
  mean of the loss and of the gradients over the batch axes is
  all-reduced.  The step runs under ``Dist.tensor_parallel``, as the
  reference's GSPMD partitions its step by the parameters' specs: a leaf
  whose ``model`` placement sits on the dimension its layer splits
  (``shardings.tp_dims``) is gathered over the batch axes only and used
  as the rank's block; a leaf ``_fit`` left whole on ``model`` (a KV
  projection of too few heads, MLA's low-rank projections, the router,
  ``bc_proj``, ``dt_bias``, ``A_log``, the norms) comes whole and the
  layer takes what its block reads; any other leaf (one ``_fit``
  relocated, and the shared experts under ``moe_mode="ep_a2a"``) is
  gathered whole and its layer computes whole.  The layers' collectives
  over ``model`` (Megatron's: a sum after each row-parallel product, a
  summed gradient for each replicated input) make each block's gradient
  the rank's block of the whole gradient, so no parameter is gathered
  over ``model``.  The MoE FFN with ``moe_mode="ep_a2a"`` takes the
  expert-parallel path over ``model``.  The kernels run on local
  tensors.  The update then acts on
  each rank's shard: an elementwise optimizer (SGD, AdamW) on the local
  blocks of the parameter, gradient and state; Adafactor, whose factored
  moments and clipping reduce over whole leaves, on the rank's blocks
  too, each of those means a sum over the mesh axes that split the leaf
  (``optimizers.LeafSplit``), where its state is placed as the
  parameter's block implies, and on the gathered leaf otherwise, keeping
  each rank's block.  The gradient norm sums each split leaf's
  squares over ``model`` once, and each replicated leaf's once.  On a
  ``model`` axis of one rank the step makes no collective over it and
  runs the one-device operations: bit for bit on a ``(1, 1)`` mesh; up
  to the order of sums otherwise.
* **The compressed step** (``compress_grads=True``): the reference's
  replicated-parameter data parallelism — local gradients on the batch
  block, ``compress_tree_psum`` over ``"data"`` with the residuals carried
  in the state (one a rank), the loss ``pmean``-ed.
* ``grad_shardings`` places the gradients under the given shardings
  before the update.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from ..launch.shardings import (NamedSharding, batch_placements,
                                batch_specs, gather, local_block,
                                local_model, place)
from ..models.common import P, manual_axes, pmean, psum
from ..models.transformer import Dist, Model, train_loss
from ..optim.grad_compress import compress_tree_psum
from ..optim.optimizers import LeafSplit, Optimizer, _stack_key


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


# elements of a gradient squared in f32 at a time: a larger leaf (a
# full-width expert stack, 3.8e9 elements) is summed a chunk at a time, so
# its f32 square never takes the card's memory twice over
SQUARES_CHUNK = 1 << 28


def _squares(cfg, g) -> torch.Tensor:
    if cfg.gnorm_vdot:
        return torch.dot(g.flatten(), g.flatten())
    if g.numel() <= SQUARES_CHUNK:
        return torch.sum(torch.square(g.to(torch.float32)))
    return sum(torch.sum(torch.square(c.to(torch.float32)))
               for c in g.reshape(-1).split(SQUARES_CHUNK))


def grad_norm(cfg, grads: dict) -> torch.Tensor:
    """The global gradient norm in f32; ``cfg.gnorm_vdot`` takes the
    reference's A/B baseline form (a dot product of each flattened
    gradient with itself).  A gradient that is a DTensor (the rank's
    block over the model axis of a split leaf) adds its local squares,
    summed over that axis once for all such leaves."""
    split = [g for g in grads.values() if _is_dtensor(g)]
    if not split:
        total = sum(_squares(cfg, g) for g in grads.values())
        return torch.sqrt(total.to(torch.float32))
    mesh = split[0].device_mesh
    names = {mesh.mesh_dim_names[i] for g in split
             for i, pl in enumerate(g.placements) if pl.is_shard()}
    local = sum(_squares(cfg, g.to_local()) for g in split)
    with manual_axes(mesh, mesh.mesh_dim_names):
        local = psum(local, tuple(sorted(names)))
    rest = [_squares(cfg, g) for g in grads.values() if not _is_dtensor(g)]
    return torch.sqrt((local + sum(rest)).to(torch.float32))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _whole_model(cfg, params: Model) -> Model:
    """``params`` as a model of whole plain tensors: itself, or, when any
    parameter is a DTensor, a new model of the gathered tensors."""
    return local_model(cfg, params, Dist())[0]


def _as_tensors(batch: dict) -> dict:
    return {n: v if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)) for n, v in batch.items()}


def _blocks(batch: dict, mesh, specs: dict) -> dict:
    """This rank's block of each entry of the global ``batch``."""
    return {n: local_block(v, mesh, NamedSharding(mesh, specs[n]).placements)
            for n, v in batch.items()}


def _sharded_grads(cfg, dist: Dist, params: Model, batch: dict, k: int):
    """The mean loss and the gradients over the batch axes: each
    microbatch of the global ``batch`` blocked under ``batch_specs``.  A
    gradient is whole, or, under tensor-parallel arithmetic over a model
    axis of more than one rank, a DTensor of the rank's block over it for
    each leaf used as its block."""
    mesh = dist.mesh
    dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                   for a in dist.batch_axes)
    mbs = [_blocks(mb, mesh, batch_specs(cfg, mb, dist.batch_axes,
                                         dist.model_axis, dp))
           for mb in _split_microbatches(_as_tensors(batch), k)]
    dist = replace(dist, tensor_parallel=True)
    model, kept = local_model(cfg, params, dist)
    loss, grads = _grads(cfg, model, mbs, dist)
    with manual_axes(mesh, mesh.mesh_dim_names):
        loss = pmean(loss, dist.batch_axes)
        grads = {n: pmean(g, dist.batch_axes) for n, g in grads.items()}
    if mesh.size(mesh.mesh_dim_names.index(dist.model_axis)) > 1:
        from torch.distributed.tensor import DTensor
        named = dict(params.named_parameters())
        for n in kept:
            grads[n] = DTensor.from_local(
                grads[n], mesh, batch_placements(named[n], dist.model_axis),
                run_check=False)
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
    """A DTensor's local tensor itself (no autograd: the update's), a
    plain tensor as it is."""
    return t._local_tensor if _is_dtensor(t) else t


def _block(g, like):
    """``like``'s own block of ``g``: a whole tensor, or a DTensor under
    other placements (a gradient under ``grad_shardings``, or a split
    leaf's block over the model axis)."""
    if _is_dtensor(g):
        if not _is_dtensor(like):
            return g.full_tensor()
        if tuple(g.placements) != tuple(like.placements):
            g = g.redistribute(like.device_mesh, like.placements)
        return g.to_local()
    if _is_dtensor(like):
        mesh = like.device_mesh
        if all(mesh.size(i) == 1 or not pl.is_shard()
               for i, pl in enumerate(like.placements)):
            return g  # the whole gradient is the block: no copy
        return local_block(g, mesh, like.placements)
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
            if v is not t._local_tensor:  # updated in place already
                t._local_tensor.copy_(_block(v, t) if whole else v)
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
    split = _leaf_split(named, state["opt_state"])
    mine = {n for n in named if _stack_key(n) in split.axes}
    params = {n: _local(p) if n in mine else gather(p)
              for n, p in named.items()}
    g = {n: _block(v, named[n]) if n in mine else gather(v)
         for n, v in grads.items()}
    opt = {k: gather(v) for k, v in state["opt_state"].items() if k != "f"}
    if "f" in state["opt_state"]:
        opt["f"] = {k: _local_tree(v) if k in split.axes else gather(v)
                    for k, v in state["opt_state"]["f"].items()}
    optimizer.update(g, opt, params, state["step"], split=split)
    _store(named, {n: v for n, v in params.items() if n not in mine},
           whole=True)
    _store(state["opt_state"], {k: v for k, v in opt.items() if k != "f"},
           whole=True)
    if "f" in opt:
        f = state["opt_state"]["f"]
        _store(f, {k: v for k, v in opt["f"].items() if k in split.axes},
               whole=False)
        _store(f, {k: v for k, v in opt["f"].items()
                   if k not in split.axes}, whole=True)


def _leaf_split(named: dict, opt_state: dict) -> LeafSplit:
    """The factored optimizer's groups it may update on the rank's blocks
    (``LeafSplit``): those whose layers are DTensors under one placement
    and whose state (Adafactor's row and column factors, or its
    unfactored moment) is placed as the rank's block of the parameter
    implies; any other group is updated whole.  A row factor drops the
    last dimension and is whole over the axes that split it, a column
    factor the second to last; a mesh axis of one rank splits nothing."""
    from torch.distributed.tensor import Replicate, Shard
    groups: dict = {}
    for n in named:
        groups.setdefault(_stack_key(n), []).append(n)
    axes, shapes = {}, {}
    for key, names in groups.items():
        ps = [named[n] for n in names]
        f = opt_state.get("f", {}).get(key)
        if f is None or not all(_is_dtensor(p) for p in ps) or len(
                {tuple(p.placements) for p in ps}) > 1:
            continue
        p = ps[0]
        mesh, nd = p.device_mesh, p.dim()
        lead = int(key.split(".")[0] == "layers")
        dims = [[] for _ in range(nd + lead)]
        want = {k: [] for k in f}
        for i, pl in enumerate(p.placements):
            if mesh.size(i) == 1 or not pl.is_shard():
                for k in want:
                    want[k].append(None if mesh.size(i) == 1
                                   else Replicate())
                continue
            d = pl.dim
            dims[d + lead].append(mesh.get_group(i))
            drop = {"r": nd - 1, "c": nd - 2, "v": None}
            for k in want:
                if d == drop[k]:
                    want[k].append(Replicate())
                else:
                    dd = d - 1 if k == "c" and d == nd - 1 else d
                    want[k].append(Shard(dd + lead))
        if all(_is_dtensor(f[k]) and all(
                w is None or f[k].placements[i] == w
                for i, w in enumerate(want[k])) for k in f):
            axes[key] = dims
            shapes[key] = (len(names),) * lead + tuple(p.shape)
    return LeafSplit(axes, shapes)


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
