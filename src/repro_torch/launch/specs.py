"""Abstract stand-ins for every model input — the dry run never allocates
real data (the counterpart of ``src/repro/launch/specs.py``).
``make_cell`` assembles everything one (arch x shape) cell needs: the step
function, its arguments, and their shardings.

An abstract argument is a ``meta`` tensor (:func:`sds`, the reference's
``ShapeDtypeStruct``); a cell's arguments are ``FakeTensor``s made in the
cell's own ``FakeTensorMode`` (``Cell.mode``), which the step runs under:
the model's ops compute shapes only, and the kernel wrappers take their
shape-only path (``kernels/trace.py``).  There is no ``jit`` or
``lower``: ``Cell.fn`` is a plain callable over ``Cell.args``.

The mesh is a ``DeviceMesh`` (the dry run's, over a fake process group:
``launch/mesh.py``).  A :class:`~repro_torch.launch.mesh.MeshShape` gives
the cell's shardings without its processes: its ``fn`` is None and its
arguments are unplaced.

What each kind's function is, as the port runs it:

* **train**: ``make_train_step`` under ``Dist`` on the mesh, the
  parameters and optimizer state placed by ``param_specs`` (DTensors), the
  global batch given to every rank; the step gathers each leaf over the
  batch axes and keeps its block over ``model`` where its layer splits
  (``train/train_step.py``).  The optimizer's 0-d step count is
  host state on every device: a real host tensor, not a placed one.
* **prefill** and **decode**: a meshed server's step
  (core/deploy/router.py): ``prefill``/``decode_step`` under the
  tensor-parallel ``Dist`` (``cache_len`` the shape's sequence) on this
  rank's block of the batch over the batch axes, of the caches under
  ``cache_specs`` over the batch and model axes, and of the parameters:
  placed under ``param_specs``, then made the rank's local tensors as the
  server makes them once at build (``shardings.local_model``: a leaf on
  its layer's split dimension its block over ``model``, gathered over the
  data axes; any other whole), which are the step's arguments.

``make_cell(..., device=...)`` makes the same cell on real tensors of a
device (random weights from seed 0, random tokens), the step the dry run's
count is held against.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch

from ..configs import get_config
from ..models.common import P, ModelConfig
from ..models.transformer import (Dist, decode_step, init_cache, init_params,
                                  prefill)
from ..optim.optimizers import adafactor, adamw
from ..train.train_step import TrainState, make_train_step
from .mesh import MeshShape, mesh_axes
from .roofline import shape_of
from .shardings import (NamedSharding, batch_specs, cache_specs, distribute,
                        local_block, local_model, param_specs, to_shardings)

_BF16 = torch.bfloat16
_I32 = torch.int32


def sds(shape, dtype) -> torch.Tensor:
    """An abstract argument of ``shape`` and ``dtype``: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def pick_optimizer(cfg: ModelConfig):
    """Adafactor for >20B models (factored state is what fits HBM), AdamW
    otherwise — see DESIGN.md memory math."""
    if cfg.param_count() > 20e9:
        return adafactor(lr=1e-2)
    return adamw(lr=3e-4)


def batch_struct(cfg: ModelConfig, batch: int, seq: int, *,
                 labels: bool) -> dict:
    out: dict[str, Any] = {}
    if cfg.embedding_inputs:
        out["embeds"] = sds((batch, seq, cfg.d_model), _BF16)
    else:
        out["tokens"] = sds((batch, seq), _I32)
    if labels:
        out["labels"] = sds((batch, seq), _I32)
    if cfg.mrope:
        out["positions3"] = sds((batch, seq, 3), _I32)
    return out


def decode_batch_struct(cfg: ModelConfig, batch: int) -> dict:
    out: dict[str, Any] = {}
    if cfg.embedding_inputs:
        out["embeds"] = sds((batch, 1, cfg.d_model), _BF16)
    else:
        out["tokens"] = sds((batch, 1), _I32)
    out["positions"] = sds((batch, 1), _I32)
    if cfg.mrope:
        out["positions3"] = sds((batch, 1, 3), _I32)
    return out


def input_specs(arch: str, shape_name, cfg: ModelConfig | None = None) -> dict:
    """Abstract inputs for one cell (no mesh dependence).  ``shape_name``
    is a ``SHAPES`` name or a ``(seq_len, global_batch, kind)`` triple."""
    cfg = cfg or get_config(arch)
    seq, batch, kind = shape_of(shape_name)
    if kind == "train":
        return {"kind": kind, "cfg": cfg,
                "batch": batch_struct(cfg, batch, seq, labels=True)}
    if kind == "prefill":
        return {"kind": kind, "cfg": cfg,
                "batch": batch_struct(cfg, batch, seq, labels=False)}
    # decode: one new token against a seq-length cache
    caches = init_cache(cfg, batch, seq, device="meta")
    return {"kind": kind, "cfg": cfg,
            "batch": decode_batch_struct(cfg, batch),
            "caches": caches, "index": sds((), _I32)}


@dataclass
class Cell:
    arch: str
    shape: Any
    kind: str
    cfg: ModelConfig
    fn: Callable | None   # call fn(*args) under ``mode``
    args: tuple           # FakeTensors (or a device's tensors)
    in_shardings: tuple
    mode: Any = None      # the FakeTensorMode of ``args``; None: real


def _host_zero(dtype) -> torch.Tensor:
    """A 0-d host tensor even inside a fake mode: the optimizer's step
    count, whose value the host reads."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return torch.zeros((), dtype=dtype)


def _place_opt_state(opt_state: dict, shardings: dict, placed: bool) -> dict:
    """The optimizer state placed under ``shardings`` (when ``placed``),
    its 0-d leaves as host tensors."""
    out = {}
    for k, v in opt_state.items():
        if isinstance(v, dict):
            out[k] = _place_opt_state(v, shardings[k], placed)
        elif v.dim() == 0:
            out[k] = _host_zero(v.dtype)
        else:
            out[k] = distribute({k: v}, {k: shardings[k]})[k] if placed else v
    return out


def _materialize(tree, device, generator, cfg: ModelConfig):
    """Tensors of ``tree``'s (meta) shapes on ``device``: empty inside a
    fake mode; on a real device random token ids below the vocabulary,
    positions 0.. in order, and small normal embeddings."""
    if isinstance(tree, dict):
        return {k: _materialize_leaf(k, v, device, generator, cfg)
                if not isinstance(v, dict)
                else _materialize(v, device, generator, cfg)
                for k, v in tree.items()}
    return _materialize_leaf("", tree, device, generator, cfg)


def _materialize_leaf(name, t, device, generator, cfg):
    if generator is None:
        return torch.empty(t.shape, dtype=t.dtype, device=device)
    if name in ("tokens", "labels"):
        return torch.randint(0, cfg.vocab, t.shape, generator=generator,
                             device=device, dtype=t.dtype)
    if name.startswith("positions"):
        S = t.shape[1]
        pos = torch.arange(S, device=device, dtype=t.dtype)
        return pos.reshape((1, S) + (1,) * (t.dim() - 2)).expand(
            t.shape).contiguous()
    if t.dtype.is_floating_point:
        return (torch.randn(t.shape, generator=generator, device=device)
                * 0.02).to(t.dtype)
    return torch.zeros(t.shape, dtype=t.dtype, device=device)


def _batch_size(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def _batch_block(tree: dict, specs: dict, mesh, dp_axes) -> dict:
    """This rank's block of each entry over the batch axes alone (the
    other mesh axes hold the whole of it)."""
    out = {}
    for k, v in tree.items():
        spec = P(*(e if e == tuple(dp_axes) or e in dp_axes else None
                   for e in specs[k]))
        out[k] = local_block(v, mesh, NamedSharding(mesh, spec).placements)
    return out


def make_cell(arch: str, shape_name, mesh, *,
              cfg_override: ModelConfig | None = None,
              microbatches: int = 1, device=None) -> Cell:
    """Assemble the traceable (fn, abstract args, shardings) for a cell;
    with ``device``, the same cell on that device's real tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    spec = input_specs(arch, shape_name, cfg=cfg_override)
    cfg: ModelConfig = spec["cfg"]
    dp_axes, model_axis = mesh_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp_size = int(np.prod([sizes[a] for a in dp_axes]))
    model_size = sizes[model_axis]
    placed = not isinstance(mesh, MeshShape)
    dist = Dist(mesh=mesh, batch_axes=dp_axes, model_axis=model_axis)
    mode = FakeTensorMode(allow_non_fake_inputs=True) if device is None \
        else None
    dev = torch.device("cpu" if device is None else device)
    gen = None if device is None else torch.Generator(
        device=dev).manual_seed(0)

    with mode or contextlib.nullcontext():
        params = init_params(cfg, device=dev, generator=gen)
        p_specs = param_specs(params, mesh, dp_axes, model_axis,
                              fsdp=cfg.fsdp)
        b_specs = batch_specs(cfg, spec["batch"], dp_axes, model_axis,
                              dp_size)
        batch = _materialize(spec["batch"], dev, gen, cfg)
        if spec["kind"] == "train":
            opt = pick_optimizer(cfg)
            opt_state = opt.init(dict(params.named_parameters()))
            o_specs = param_specs(opt_state, mesh, dp_axes, model_axis,
                                  fsdp=cfg.fsdp)
            if placed:
                params = distribute(params, to_shardings(mesh, p_specs))
            opt_state = _place_opt_state(opt_state,
                                         to_shardings(mesh, o_specs), placed)
            state_specs = {"params": p_specs, "opt_state": o_specs,
                           "step": P()}
            step = make_train_step(cfg, opt, dist, microbatches=microbatches,
                                   grad_shardings=to_shardings(mesh, p_specs))
            args = (TrainState(params, opt_state), batch)
            in_sh = (to_shardings(mesh, state_specs),
                     to_shardings(mesh, b_specs))
            fn = step
        else:  # a server's prefill or decode step, on the rank's blocks
            seq = shape_of(shape_name)[0]
            serve = replace(dist, tensor_parallel=True, cache_len=seq)
            if placed:
                params = local_model(cfg, distribute(
                    params, to_shardings(mesh, p_specs)), serve)[0]
                batch = _batch_block(batch, b_specs, mesh, dp_axes)
            in_sh = (to_shardings(mesh, p_specs), to_shardings(mesh, b_specs))
        if spec["kind"] == "prefill":
            args = (params, batch)
            fn = lambda p, b: prefill(p, b, cfg, serve)  # noqa: E731
        elif spec["kind"] == "decode":
            c_specs = cache_specs(cfg, spec["caches"], dp_axes, model_axis,
                                  dp_size, model_size)
            caches = init_cache(cfg, _batch_size(spec["batch"]), seq,
                                device=dev)
            if placed:
                caches = {k: local_block(v, mesh, NamedSharding(
                    mesh, c_specs[k]).placements) for k, v in caches.items()}
            index = _host_zero(_I32) + (seq - 1)
            args = (params, batch, caches, index)
            in_sh += (to_shardings(mesh, c_specs), NamedSharding(mesh, P()))
            fn = lambda p, b, c, i: decode_step(p, b, c, i, cfg,  # noqa: E731
                                                serve)
    return Cell(arch=arch, shape=shape_name, kind=spec["kind"], cfg=cfg,
                fn=fn if placed else None, args=args, in_shardings=in_sh,
                mode=mode)
