"""The reference's parameter trees, carried into the port's :class:`Model`.

The reference (``src/repro/models/transformer.py`` ``init_params``) keeps
its parameters as a nested dict with every layer stacked on a leading
axis: ``tree["layers"]["attn"]["wq"]`` is (n_layers, d, H, hd).  The port
holds one block module a layer, whose parameters keep the reference's leaf
names (``layers.3.attn.wq``).  This module is the one place that knows the
stacked layout: :func:`params_from_reference` carries a tree of numpy
arrays across (checking every leaf's shape and dtype), and
:func:`reference_layout` gives the (shape, dtype) tree a model's
parameters stand for.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .common import ModelConfig
from .transformer import Model, init_params

STACKED = "layers"


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = v
    return out


def reference_key(name: str) -> tuple[str, int | None]:
    """A parameter's path in the reference tree and its layer, if stacked:
    ``layers.3.attn.wq`` -> (``layers.attn.wq``, 3)."""
    parts = name.split(".")
    if parts[0] == STACKED:
        return ".".join([STACKED] + parts[2:]), int(parts[1])
    return name, None


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy dtype in torch
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def reference_layout(params: Model) -> dict:
    """The reference's tree of ``(shape, dtype name)`` that ``params``
    stands for: stacked layers with their leading n_layers axis."""
    n_layers = len(params.layers)
    flat = {}
    for name, p in params.named_parameters():
        key, layer = reference_key(name)
        if layer is None:
            flat[key] = (tuple(p.shape), _dtype_name(p.dtype))
        elif layer == 0:
            flat[key] = ((n_layers,) + tuple(p.shape), _dtype_name(p.dtype))
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def params_from_reference(tree: dict, cfg: ModelConfig, device=None
                          ) -> Model:
    """The port's parameters from the reference's tree for ``cfg`` (numpy
    arrays, or anything ``np.asarray`` takes, layers stacked), on
    ``device`` (the GPU unless the caller names another).  A missing or
    extra leaf, or one of another shape or dtype, raises ``ValueError``."""
    device = resolve_device(device)
    model = init_params(cfg, device="meta")
    flat = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    state, used = {}, set()
    for name, p in model.named_parameters():
        key, layer = reference_key(name)
        if key not in flat:
            raise ValueError(f"reference tree has no {key!r}")
        a = flat[key]
        want = tuple(p.shape) if layer is None \
            else (cfg.n_layers,) + tuple(p.shape)
        if a.shape != want or a.dtype.name != _dtype_name(p.dtype):
            raise ValueError(f"{key}: {a.dtype.name}{list(a.shape)} where "
                             f"the model takes {_dtype_name(p.dtype)}"
                             f"{list(want)}")
        state[name] = _to_tensor(a if layer is None else a[layer], device)
        used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"reference tree has leaves the model lacks: "
                         f"{extra}")
    model.load_state_dict(state, strict=True, assign=True)
    return model
