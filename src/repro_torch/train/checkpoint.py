"""Checkpointing with atomic writes, async save and retention (the
counterpart of ``src/repro/train/checkpoint.py``).

A checkpoint is the reference's file: ``ckpt_<step>.npz``, one array per
leaf of the reference's training state, under the reference's key
(``jax.tree_util.keystr`` of its path, ``"['params']['layers']['attn']
['wq']"``), with the layers stacked on a leading axis as the reference
stacks them (``models/weights.py``).  So the reference's ``restore_like``
reads a port checkpoint of the same state, and this module's reads the
reference's.  A state here is a dict whose leaves are tensors, the
:class:`~repro_torch.models.transformer.Model`, and the optimizer's dicts
keyed by parameter name (each layer's tensor, stacked here) or by the
reference's leaf name (Adafactor's moments, stacked already).  bfloat16
arrays are written as the reference's numpy writes them (2-byte void),
and read back by their bits.

Sharded states (DTensors, launch/shardings.py) are gathered whole on
every rank, and only rank 0 of a started process group writes the file;
so the file is the same whatever mesh wrote it, and ``restore_like`` fills
each rank's block of a template placed on any other mesh (elastic
restore).
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as torch_dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..launch.shardings import gather, local_block
from ..models.weights import reference_key

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _leaves(state, names: frozenset, path=()) -> dict:
    """Every leaf of ``state`` under its reference key: a list of (tensor,
    layer) pairs, one per layer for a leaf of a dict keyed by parameter
    name that the reference stacks (layer None for an unstacked one, and
    for a dict keyed by reference leaf, whose tensors are stacked
    already)."""
    if isinstance(state, nn.Module):
        state = dict(state.named_parameters())
    if isinstance(state, torch.Tensor):
        return {_keystr(path): [(state, None)]}
    if not isinstance(state, dict):
        raise TypeError(f"checkpoint: {_keystr(path)} is a "
                        f"{type(state).__name__}")
    out: dict = {}
    if state and not set(state) <= names \
            and set(state) <= {reference_key(n)[0] for n in names}:
        # keyed by reference leaf and stacked already (Adafactor's moments)
        for key, leaf in state.items():
            out.update(_leaves(leaf, names, path + tuple(key.split("."))))
        return out
    if state and set(state) <= names:  # keyed by parameter name
        for name, leaf in state.items():
            key, layer = reference_key(name)
            sub = leaf if isinstance(leaf, dict) else {None: leaf}
            for k, t in sub.items():
                full = path + tuple(key.split(".")) + ((k,) if k else ())
                out.setdefault(_keystr(full), []).append((t, layer))
        for parts in out.values():
            parts.sort(key=lambda tl: -1 if tl[1] is None else tl[1])
        return out
    for k, v in state.items():
        out.update(_leaves(v, names, path + (k,)))
    return out


def _param_names(state) -> frozenset:
    params = state.get("params") if isinstance(state, dict) else None
    if isinstance(params, nn.Module):
        return frozenset(n for n, _ in params.named_parameters())
    return frozenset()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = gather(t).to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(state) -> dict[str, np.ndarray]:
    flat = {}
    for key, parts in _leaves(state, _param_names(state)).items():
        arrays = [_to_numpy(t) for t, _ in parts]
        flat[key] = arrays[0] if parts[0][1] is None else np.stack(arrays)
    return flat


def save_checkpoint(ckpt_dir: str, state: Any, step: int, *, keep: int = 3,
                    async_save: bool = False) -> str | threading.Thread:
    """Write ``ckpt_<step>.npz`` atomically (tmp + rename); prune old ones.
    With ``async_save`` the host-to-disk copy happens on a worker thread
    after the device-to-host fetch (the fetch is synchronous, so the
    arrays are step-consistent).  Under a started process group every
    rank gathers, rank 0 writes (and returns the path or the thread; the
    others None), and a synchronous save returns on every rank once the
    file is there."""
    grouped = torch_dist.is_initialized()
    flat = _flatten(state)  # device->host fetch happens here, synchronously
    if grouped and torch_dist.get_rank() != 0:
        if not async_save:
            torch_dist.barrier()
        return None
    os.makedirs(ckpt_dir, exist_ok=True)

    def write():
        fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        final = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
        os.replace(tmp, final)   # atomic: readers never see partial files
        _prune(ckpt_dir, keep)
        return final

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    path = write()
    if grouped:
        torch_dist.barrier()
    return path


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                   if (m := _CKPT_RE.search(f)))
    for s in steps[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f"ckpt_{s}.npz"))
        except FileNotFoundError:
            pass


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := _CKPT_RE.search(f))]
    return max(steps) if steps else None


def load_latest(ckpt_dir: str) -> tuple[int, dict[str, np.ndarray]] | None:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    data = np.load(os.path.join(ckpt_dir, f"ckpt_{step}.npz"))
    return step, {k: data[k] for k in data.files}


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    raw_bf16 = like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
        and arr.dtype.kind in "Vu"
    if raw_bf16 or arr.dtype.name == "bfloat16":  # bits of bfloat16
        bits = np.array(arr).view(np.int16)  # a copy, 0-d kept 0-d
        return torch.from_numpy(bits).view(torch.bfloat16).to(like.dtype)
    return torch.from_numpy(np.array(arr)).to(like.dtype)


@torch.no_grad()
def restore_like(template: Any, flat: dict[str, np.ndarray]) -> Any:
    """Fill the tensors of ``template`` (a state of the same structure)
    from flattened arrays, in place, on the template's devices (a DTensor:
    this rank's block), and return it.  A missing leaf raises
    ``KeyError``, one of another shape ``ValueError``."""
    for key, parts in _leaves(template, _param_names(template)).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        t0, layer0 = parts[0]
        want = tuple(t0.shape) if layer0 is None \
            else (len(parts),) + tuple(t0.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"template {want}")
        for t, layer in parts:
            src = _to_tensor(arr if layer is None else arr[layer], t)
            if isinstance(t, DTensor):  # this rank's block
                t.to_local().copy_(local_block(src, t.device_mesh,
                                               t.placements))
            else:
                t.copy_(src)
    return template
