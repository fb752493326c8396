"""Sharding policy: partition specs for params, optimizer state, batches
and decode caches, for any (config x mesh), and their placements on a
``DeviceMesh`` (the counterpart of ``src/repro/launch/shardings.py``, whose
rules and fallbacks are kept verbatim).

Strategy (the paper-faithful *baseline* — GEVO-Shard hillclimbs from here):

* TP over ``model``: attention heads, FFN hidden, expert dim (EP), mamba
  d_inner, vocab of the embedding tables.
* DP/FSDP over ``data`` (+``pod``): batch dim of activations; the non-model
  dim of every large weight is additionally sharded over the DP axes
  (ZeRO-3 style).
* Divisibility fallback: if a rule's axis does not divide the dim (e.g.
  minicpm's 36 heads on a 16-way axis), the axis moves to the largest
  remaining divisible dim; if none fits, it is dropped (replicated).

Optimizer-state leaves inherit the spec of the param they track (adafactor's
factored r/c drop the reduced dim's axis).

The port's trees are dicts keyed by parameter name (a model's
``named_parameters``: ``layers.3.attn.wq``, one tensor a layer) or by the
reference's leaf (Adafactor's moments, stacked already).  A spec is
computed on the reference's leaf: a layer's tensor takes the spec of the
stacked (n_layers, ...) leaf it belongs to, less the leading layer entry
(no config's leaf gets an axis there; were the relocation fallback to put
one there, the layer's tensor would be replicated over it).  :func:`to_shardings` turns a spec into
DTensor placements over the mesh (``Shard(i)`` on every mesh dim named at
tensor dim ``i``, else ``Replicate()``), and :func:`distribute` /
:func:`gather` move a tree between whole tensors and DTensors.

In the train step (train/train_step.py) and a meshed server
(core/deploy/router.py) a leaf whose ``model`` placement sits on the
dimension the tensor-parallel arithmetic of every family splits
(``TP_DIMS``, :func:`tp_dims`, :func:`model_dim`) is gathered over the
batch axes only (:func:`gather_batch`) and used as the rank's block;
every other leaf (one ``_fit`` relocated, or replicated over ``model``)
is gathered whole (:func:`gather`): :func:`local_model`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from ..models.common import P, ModelConfig

# rules: leaf-name -> intent over TRAILING dims ("fsdp" -> DP axes tuple,
# "model" -> model axis).  A leading stacked-layer dim is auto-None.
_RULES: dict[str, tuple] = {
    "embed": ("model", None),
    "out": ("fsdp", "model"),
    "wq": ("fsdp", "model", None),
    "wk": ("fsdp", "model", None),
    "wv": ("fsdp", "model", None),
    "wo": ("model", None, "fsdp"),
    "bq": ("model", None), "bk": ("model", None), "bv": ("model", None),
    "wq_a": ("fsdp", None),
    "wq_b": (None, "model", None),
    "wkv_a": ("fsdp", None),
    "wkv_b": (None, "model", None),
    "gate": ("fsdp", "model"),
    "up": ("fsdp", "model"),
    "down": ("model", "fsdp"),
    "router": (None, None),
    "w_gate": ("model", "fsdp", None),
    "w_up": ("model", "fsdp", None),
    "w_down": ("model", None, "fsdp"),
    "sh_gate": ("fsdp", "model"),
    "sh_up": ("fsdp", "model"),
    "sh_down": ("model", "fsdp"),
    "in_proj": ("fsdp", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "out_proj": ("model", "fsdp"),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "dt_w": ("fsdp", "model"),
    "bc_proj": ("fsdp", None),
    "D": ("model",),
}

_STACKED = "layers"


def _leaf_name(path) -> str:
    for key in reversed(path):
        if key in ("r", "c", "v", "m", "f", "mom"):
            continue
        if key is not None:
            return str(key)
    return ""


def _axis_sizes(mesh, dp_axes, model_axis):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp = int(np.prod([sizes[a] for a in dp_axes])) if dp_axes else 1
    return dp, sizes[model_axis]


# attention projections must keep q/k/v head shardings aligned: relocating
# the model axis onto head_dim for one of them desynchronizes the pair.
# These fall back to replicated instead.
_NO_RELOCATE = {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "wq_b", "wkv_b"}


def _fit(intent: tuple, shape: tuple, dp_axes, model_axis, dp_size,
         model_size, min_fsdp_elems: int = 1 << 18,
         allow_relocate: bool = True) -> P:
    """Turn a trailing-dim intent into a valid spec for ``shape``.

    Applies divisibility checks and the fallback relocation of the model
    axis described in the module docstring."""
    nd = len(shape)
    intent = tuple(intent)
    if len(intent) < nd:                       # leading stacked-layer dims
        intent = (None,) * (nd - len(intent)) + intent
    elif len(intent) > nd:                     # e.g. adafactor r/c leaves
        intent = intent[-nd:] if nd else ()
    spec: list = [None] * nd
    small = int(np.prod(shape)) < min_fsdp_elems
    model_placed = False
    for i, want in enumerate(intent):
        if want == "model" and shape[i] % model_size == 0:
            spec[i] = model_axis
            model_placed = True
        elif want == "fsdp" and not small and shape[i] % dp_size == 0:
            spec[i] = tuple(dp_axes)
    if "model" in intent and not model_placed and allow_relocate:
        # relocate: largest free dim divisible by the model axis
        for i in sorted(range(nd), key=lambda j: -shape[j]):
            if spec[i] is None and shape[i] % model_size == 0 and shape[i] > 1:
                spec[i] = model_axis
                break
    return P(*spec)


def _paths(tree, prefix=()) -> list:
    """(path, leaf) of every leaf of a dict tree (a model: its named
    parameters), a dotted key split into its parts."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    out = []
    for key, v in tree.items():
        path = prefix + tuple(str(key).split("."))
        if isinstance(v, (dict, nn.Module)):
            out += _paths(v, path)
        else:
            out.append((path, v))
    return out


def _layer_at(path) -> int | None:
    """Where a layer index sits in ``path`` (``layers.<i>....``), if
    anywhere."""
    for i, key in enumerate(path[:-1]):
        if key == _STACKED and path[i + 1].isdigit():
            return i + 1
    return None


def param_specs(params_or_shapes: Any, mesh, dp_axes=("data",),
                model_axis: str = "model", fsdp: bool = True):
    """Spec tree for a params (or opt-state) tree: a dict tree whose leaves
    have a ``shape`` (tensors, meta or DTensors), or a model (a dict keyed
    by parameter name comes back).  ``mesh`` is a ``DeviceMesh`` or a
    :class:`~repro_torch.launch.mesh.MeshShape`."""
    dp_size, model_size = _axis_sizes(mesh, dp_axes if fsdp else (), model_axis)
    leaves = _paths(params_or_shapes)
    layers: dict = {}
    for path, _ in leaves:
        at = _layer_at(path)
        if at is not None:
            key = path[:at] + path[at + 1:]
            layers[key] = layers.get(key, 0) + 1
    specs = {}
    for path, leaf in leaves:
        name = _leaf_name(path)
        intent = _RULES.get(name)
        shape = tuple(leaf.shape)
        at = _layer_at(path)
        if at is not None:
            shape = (layers[path[:at] + path[at + 1:]],) + shape
        if intent is None or not shape:
            specs[path] = P()
            continue
        # factored adafactor leaves: r drops the last dim, c the 2nd-last
        if path[-1] == "r":
            intent = intent[:-1]
        elif path[-1] == "c":
            intent = intent[:-2] + intent[-1:]
        spec = _fit(intent, shape, dp_axes if fsdp else (), model_axis,
                    dp_size, model_size,
                    allow_relocate=name not in _NO_RELOCATE)
        specs[path] = P(*spec[1:]) if at is not None else spec
    return _rebuild(params_or_shapes, specs)


def _rebuild(tree, specs: dict, prefix=()):
    """``tree``'s structure with each leaf's spec in its place."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    out = {}
    for key, v in tree.items():
        path = prefix + tuple(str(key).split("."))
        out[key] = _rebuild(v, specs, path) \
            if isinstance(v, (dict, nn.Module)) else specs[path]
    return out


def batch_specs(cfg: ModelConfig, batch_shapes: dict, dp_axes=("data",),
                model_axis: str = "model", dp_size: int = 1):
    """Specs for a train/prefill batch dict: batch dim over DP axes (when
    divisible)."""
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape)
        b_ax = tuple(dp_axes) if shape[0] % dp_size == 0 else None
        spec = [b_ax] + [None] * (len(shape) - 1)
        out[k] = P(*spec)
    return out


def cache_specs(cfg: ModelConfig, cache_shapes: dict, dp_axes=("data",),
                model_axis: str = "model", dp_size: int = 1,
                model_size: int = 1):
    """Decode-cache specs: batch over DP; KV heads over model when they
    divide, otherwise the sequence dim over model (flash-decode style); a
    mamba layer's states over the channels its decode splits on
    (models/mamba.py ``_tp_name``: mamba1's d_inner, mamba2's heads, the
    ``ssm`` state's dim 2), the ``conv`` window's d_inner with them."""
    out = {}
    for k, v in cache_shapes.items():
        shape = tuple(v.shape)          # leading L (or G) stacked dim
        spec = [None] * len(shape)
        if shape[1] % dp_size == 0 and shape[1] > 1:
            spec[1] = tuple(dp_axes)
        if k in ("k", "v", "shared_k", "shared_v"):
            if shape[3] % model_size == 0:          # KV heads
                spec[3] = model_axis
            elif shape[2] % model_size == 0:        # sequence
                spec[2] = model_axis
        elif k in ("ckv", "krope"):
            if shape[2] % model_size == 0:          # sequence (MLA latent)
                spec[2] = model_axis
        elif k in ("conv", "ssm"):
            # ssm: mamba1 (L, B, d_inner, n) -> d_inner; mamba2 (L, B, H,
            # dh, n) -> H; conv (L, B, K-1, d_inner) -> d_inner with them
            if cache_shapes["ssm"].shape[2] % model_size == 0:
                spec[2 if k == "ssm" else -1] = model_axis
        out[k] = P(*spec)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: its DTensor ``placements``, one a mesh
    dim (``Shard(i)`` where the spec names that mesh dim at tensor dim
    ``i``, else ``Replicate()``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [i for i, e in enumerate(self.spec)
                    if name == e or isinstance(e, tuple) and name in e]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def to_shardings(mesh, spec_tree):
    """The tree of :class:`NamedSharding` of a spec tree on ``mesh``."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    return {k: to_shardings(mesh, v) for k, v in spec_tree.items()}


def local_block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``placements``
    (mesh dims in order, the first the major one), in memory of its own."""
    from torch.distributed.tensor import Shard
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            x = x.chunk(mesh.size(mesh_dim), pl.dim)[
                mesh.get_local_rank(mesh_dim)]
    return x.clone(memory_format=torch.contiguous_format)


def place(x: torch.Tensor, sharding: NamedSharding):
    """The DTensor under ``sharding`` of ``x``, a whole tensor the same on
    every rank (each rank keeps its block) or a DTensor on the mesh."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):  # e.g. zeros_like of a DTensor parameter
        return x.redistribute(sharding.mesh, sharding.placements)
    return DTensor.from_local(
        local_block(x.detach(), sharding.mesh, sharding.placements),
        sharding.mesh, sharding.placements, run_check=False)


def distribute(tree, shardings):
    """``tree`` (a model, or a dict tree of whole tensors, the same on
    every rank) placed under ``shardings`` (the tree of
    :func:`to_shardings`): a model's parameters become DTensor parameters
    in place (the model is returned), a dict's tensors DTensors (a new
    dict).  The counterpart of the reference's ``jax.device_put``."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            owner = tree.get_submodule(mod) if mod else tree
            owner.register_parameter(leaf, nn.Parameter(
                place(p, shardings[name]), requires_grad=p.requires_grad))
        return tree
    return {k: distribute(v, shardings[k]) if isinstance(v, dict)
            else place(v, shardings[k]) for k, v in tree.items()}


# leaf name -> the dimension of the layer's tensor that its
# tensor-parallel arithmetic splits over the model axis
# (models/attention.py, models/layers.py, models/mamba.py, models/moe.py):
# attention heads (GQA and MLA), the FFN's and the shared experts' hidden
# units, the experts, mamba's d_inner (mamba2's heads), the vocabulary
TP_DIMS = {"embed": 0, "out": 1, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
           "bq": 0, "bk": 0, "bv": 0, "gate": 1, "up": 1, "down": 0,
           "wq_b": 1, "wkv_b": 1,
           "w_gate": 0, "w_up": 0, "w_down": 0,
           "sh_gate": 1, "sh_up": 1, "sh_down": 0,
           "in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
           "dt_proj": 1, "dt_w": 1, "D": 0, "out_proj": 0}


def tp_dims(cfg: ModelConfig) -> dict:
    """``TP_DIMS`` for ``cfg``'s layers: under ``moe_mode="ep_a2a"`` the
    expert-parallel branch uses the shared experts whole (the reference's
    ``shard_map`` spec ``P()``), so they are not split there."""
    if cfg.moe_mode != "ep_a2a":
        return TP_DIMS
    return {k: v for k, v in TP_DIMS.items() if not k.startswith("sh_")}


def model_dim(x, model_axis: str = "model") -> int | None:
    """The tensor dimension a DTensor's placement shards over the mesh
    axis ``model_axis``; None for a plain tensor or one replicated over
    it."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return None
    pl = x.placements[x.device_mesh.mesh_dim_names.index(model_axis)]
    return pl.dim if isinstance(pl, Shard) else None


def batch_placements(x, model_axis: str = "model") -> tuple:
    """A DTensor's placements with every mesh axis but ``model_axis``
    replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(pl if name == model_axis else Replicate() for name, pl in
                 zip(x.device_mesh.mesh_dim_names, x.placements))


def _same_data(x, placements) -> bool:
    """Whether a DTensor's local tensor is already its block under
    ``placements``: they differ only on mesh axes of one rank."""
    mesh = x.device_mesh
    return all(a == b or mesh.size(i) == 1
               for i, (a, b) in enumerate(zip(x.placements, placements)))


def gather_batch(x, model_axis: str = "model") -> torch.Tensor:
    """This rank's block over ``model_axis`` of a DTensor, whole over every
    other mesh axis: gathered over the batch (fsdp) axes only, minor axis
    first, by an all-gather of the local block along its dimension (a
    DTensor redistribute of a leaf whose model axis splits an earlier
    dimension than a batch axis gathers it whole first, and its block is a
    view that keeps the whole storage)."""
    import torch.distributed as torch_dist
    mesh, names = x.device_mesh, x.device_mesh.mesh_dim_names
    model = x.placements[names.index(model_axis)]
    out = x._local_tensor.detach()
    for i in reversed(range(mesh.ndim)):
        pl = x.placements[i]
        if names[i] == model_axis or not pl.is_shard() or mesh.size(i) == 1:
            continue
        if model.is_shard() and model.dim == pl.dim:
            return x.redistribute(mesh, batch_placements(
                x, model_axis))._local_tensor.detach()
        parts = [torch.empty_like(out) for _ in range(mesh.size(i))]
        torch_dist.all_gather(parts, out.contiguous(),
                              group=mesh.get_group(i))
        out = torch.cat(parts, dim=pl.dim)
    return out


def gather(x):
    """The whole tensor of a DTensor (a plain tensor as it is); a dict
    tree or a model (keyed by parameter name) mapped leaf by leaf.  A
    DTensor sharded only over mesh axes of one rank is its local tensor,
    with no collective."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, nn.Module):
        x = dict(x.named_parameters())
    if isinstance(x, dict):
        return {k: gather(v) for k, v in x.items()}
    if x.dim() == 0 and not isinstance(x, DTensor):
        return x  # host state (a step count): its value stays readable
    if not isinstance(x, DTensor):
        return x.detach()
    if _same_data(x, (Replicate(),) * x.device_mesh.ndim):
        return x._local_tensor.detach()
    return x.detach().full_tensor()


def local_model(cfg: ModelConfig, params, dist) -> tuple:
    """``params`` (a model whose parameters may be DTensors) as a model of
    plain tensors for this rank's arithmetic under ``dist`` (a
    ``models.transformer.Dist``; see the module docstring), and the names
    of the leaves it holds as the rank's block over the model axis:
    itself, and no names, when no parameter is a DTensor."""
    from torch.distributed.tensor import DTensor

    from ..models.transformer import init_params
    named = dict(params.named_parameters())
    if not any(isinstance(p, DTensor) for p in named.values()):
        return params, set()
    model = init_params(cfg, device="meta")
    kept = set()
    dims = tp_dims(cfg)
    for n, p in named.items():
        if dist.tensor_parallel and model_dim(p, dist.model_axis) \
                == dims.get(n.rpartition(".")[2], -1):
            t = gather_batch(p, dist.model_axis)
            kept.add(n)
        else:
            t = gather(p)
        mod, _, leaf = n.rpartition(".")
        model.get_submodule(mod).register_parameter(
            leaf, nn.Parameter(t, requires_grad=p.requires_grad))
    return model, kept
