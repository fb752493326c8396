"""Functional optimizers: SGD-momentum, AdamW, and Adafactor with factored
second moments (the counterpart of ``src/repro/optim/optimizers.py``, with
its arithmetic).

Interface:  opt = adamw(lr=...);  state = opt.init(params);
            params, state = opt.update(grads, state, params, step)
``params`` and ``grads`` are dicts of tensors keyed by parameter name (a
model's ``dict(named_parameters())``), the state nests dicts of the same
keys (Adafactor's: of the reference's leaf names, below).  ``lr`` may be
a float or a schedule fn(step) -> float.

Unlike the reference, whose JAX arrays are immutable, ``update`` writes
the new values into the parameter tensors in place (under ``no_grad``) and
returns the same dict, so a model's parameters step without a second copy
of the weights; the moments are updated in place too.  Adafactor does the
reference's arithmetic on the reference's leaves: the reference stacks a
model's layers on a leading axis, so one of its leaves holds a parameter
of every layer.  Here the parameters of one leaf (``layers.<i>.attn.wq``
for every i) form a group, and Adafactor's moments, their factoring and
its update clipping are those of the stacked group; its state is keyed by
the reference's leaf name (``layers.attn.wq``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

F32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]
    state_bytes_per_param: float  # for memory-planning math
    # an element's update reads only that element of the parameter, its
    # gradient and its state: the update of a shard is the shard of the
    # update (the sharded train step relies on it); an update that is not
    # elementwise takes ``split=``, a :class:`LeafSplit` of the groups
    # given as the rank's blocks, whose reductions over the whole leaf it
    # completes by sums over the mesh
    elementwise: bool = True


class LeafSplit:
    """How the rank's blocks of an optimizer's leaves lie in the whole
    leaf: ``axes[key]`` holds, for each dimension of the group's (stacked)
    leaf, the process groups of the mesh axes (of more than one rank)
    that split it, and ``shape[key]`` the whole leaf's shape.  A group it
    does not name is given whole."""

    def __init__(self, axes: dict, shape: dict):
        self.axes, self.shape = axes, shape

    def sharded(self, key: str, dims) -> bool:
        return key in self.axes and any(self.axes[key][d] for d in dims)

    def mean(self, x: torch.Tensor, key: str, xdims, leafdims,
             keepdim: bool = False) -> torch.Tensor:
        """The mean over the whole leaf's ``leafdims`` of ``x``, whose
        dimensions ``xdims`` are those of the rank's block: its sum there,
        summed over the axes that split them, over the whole count."""
        import torch.distributed as torch_dist
        out = x.sum(dim=xdims, keepdim=keepdim)
        for d in leafdims:
            for group in self.axes[key][d]:
                torch_dist.all_reduce(out, group=group)
        n = 1
        for d in leafdims:
            n *= self.shape[key][d]
        return out / n


def _lr_at(lr, step) -> float:
    return float(lr(step)) if callable(lr) else lr


def _count_pow(base: float, count: torch.Tensor) -> float:
    """``base ** count`` in f32, as the reference forms its bias
    corrections, as a host float."""
    return float(torch.tensor(base, dtype=F32) ** count.to(F32))


def sgd_momentum(lr=1e-2, momentum=0.9, weight_decay=0.0) -> Optimizer:
    def init(params):
        return {"mom": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        for k, p in params.items():
            m = state["mom"][k]
            m.copy_(momentum * m + grads[k])
            p.copy_(p - lr_t * (m + weight_decay * p))
        return params, state

    return Optimizer(init, update, 4.0)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        def f32(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": {k: f32(p) for k, p in params.items()},
                "v": {k: f32(p) for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step)
        count = state["count"] + 1
        c1 = 1 - _count_pow(b1, count)
        c2 = 1 - _count_pow(b2, count)
        for k, p in params.items():
            g = grads[k].to(F32)
            m, v = state["m"][k], state["v"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            p32 = p.to(F32)
            p.copy_((p32 - lr_t * (upd + weight_decay * p32)).to(p.dtype))
        state["count"] = count
        return params, state

    return Optimizer(init, update, 8.0)


_STACKED = "layers"


def _stack_key(name: str) -> str:
    """The reference leaf that parameter ``name`` belongs to: the name
    without its layer index (``layers.3.attn.wq`` -> ``layers.attn.wq``),
    the rule of ``models/weights.py`` ``reference_key``; any other name is
    a leaf of its own."""
    parts = name.split(".")
    if parts[0] == _STACKED:
        return ".".join([_STACKED] + parts[2:])
    return name


def _groups(params) -> dict[str, list[str]]:
    """Parameter names by reference leaf, a stacked leaf's in layer
    order."""
    out: dict[str, list[str]] = {}
    for name in params:
        out.setdefault(_stack_key(name), []).append(name)
    for key, names in out.items():
        if key.split(".")[0] == _STACKED:
            names.sort(key=lambda n: int(n.split(".")[1]))
    return out


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern): rank-2+ tensors store row/col second-
    moment factors instead of the full moment — O(n+m) not O(nm) state.

    Each reference leaf is one group (:func:`_groups`): a stacked leaf's
    f32 gradients are stacked on a leading layer axis (one f32 copy of the
    group's gradients, and the update of the same size, live at a time),
    so a layer's (d,) norm scale is factored as the (n_layers, d) leaf it
    is in the reference, and the clipping RMS spans every layer.  Each
    layer's parameter is then updated in place with its row of the
    update."""

    def init(params):
        f = {}
        for key, names in _groups(params).items():
            p = params[names[0]]
            shape = tuple(p.shape)
            if key.split(".")[0] == _STACKED:
                shape = (len(names),) + shape
            z = {"dtype": F32, "device": p.device}
            if len(shape) >= 2:
                f[key] = {"r": torch.zeros(shape[:-1], **z),
                          "c": torch.zeros(shape[:-2] + shape[-1:], **z)}
            else:
                f[key] = {"v": torch.zeros(shape, **z)}
        return {"f": f, "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, step, split: LeafSplit | None = None):
        """``split``: the groups given as the rank's blocks (each row and
        column mean, and the clipping's, over the whole leaf by sums over
        the mesh where a block splits it); every other group whole."""
        lr_t = _lr_at(lr, step)
        count = state["count"] + 1
        beta = 1.0 - float(count.to(F32) ** (-decay))

        def mean(x, key, xdim, leafdims, keepdim=False):
            # the mean over x's dimension ``xdim``, the leaf's ``leafdims``
            # (all of them: ``xdim`` None), by torch.mean where no block
            # splits them (so an unsplit leaf's arithmetic is unchanged)
            if split is None or not split.sharded(key, leafdims):
                return torch.mean(x) if xdim is None else \
                    torch.mean(x, dim=xdim, keepdim=keepdim)
            dims = tuple(range(x.dim())) if xdim is None else xdim
            return split.mean(x, key, dims, leafdims, keepdim=keepdim)

        for key, names in _groups(params).items():
            f = state["f"][key]
            stacked = key.split(".")[0] == _STACKED
            g32 = torch.stack([grads[n].to(F32) for n in names]) \
                if stacked else grads[names[0]].to(F32)
            g2 = torch.square(g32) + eps
            nd = g32.dim()
            if nd >= 2:
                r = beta * f["r"] + (1 - beta) * mean(g2, key, -1, [nd - 1])
                c = beta * f["c"] + (1 - beta) * mean(g2, key, -2, [nd - 2])
                rmean = mean(r, key, -1, [nd - 2], keepdim=True)
                vhat = (r[..., None] / (rmean[..., None] + eps)) \
                    * c[..., None, :]
                upd = g32 / (torch.sqrt(vhat) + eps)
                f["r"].copy_(r)
                f["c"].copy_(c)
            else:
                v = beta * f["v"] + (1 - beta) * g2
                upd = g32 / (torch.sqrt(v) + eps)
                f["v"].copy_(v)
            del g32, g2
            # update clipping (RMS), over the whole leaf
            ms = mean(torch.square(upd), key, None, range(nd))
            rms = torch.sqrt(ms + eps)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            for i, n in enumerate(names):
                p = params[n]
                p32 = p.to(F32)
                u = upd[i] if stacked else upd
                p.copy_((p32 - lr_t * (u + weight_decay * p32)).to(p.dtype))
        state["count"] = count
        return params, state

    return Optimizer(init, update, 0.1, elementwise=False)


OPTIMIZERS = {"sgd": sgd_momentum, "adamw": adamw, "adafactor": adafactor}
