"""Model configuration shared by all assigned architectures, and the
named mesh axes the model's hand-written collectives run over.

The counterpart of ``src/repro/models/common.py``: ``ModelConfig`` field for
field, and ``shard_map`` and ``axis_size`` with the named-axis collectives
the reference calls inside ``shard_map`` (``psum``, ``pmean``,
``axis_index``, ``all_to_all``).

The reference runs one controller over every device and names an axis
inside ``shard_map``; here one process drives each device, so a mesh axis
is a process group (``DeviceMesh.get_group``).  ``shard_map(f, mesh=...,
in_specs=..., out_specs=...)`` binds the mesh's axis names to its groups
while ``f`` runs, gives ``f`` this rank's block of each input and puts the
blocks of each output back together.  An input is what this rank holds:
the same tensor on every rank of an axis its spec names is split over it,
unless that axis is already manual, that is, bound by an enclosing
:func:`manual_axes` (the model runs each data-parallel rank on its own
batch block, so the batch axes are manual there and only the ``model``
axis is split).

Autograd.  A value outside ``f`` is the same on every rank of an axis that
is not manual (the model's compute is replicated there), and so is its
gradient: each rank holds the whole of it.  So the collectives' backwards
are those of replicated cotangents, not of ``torch.distributed.nn``'s
partial ones: the block taken of a replicated input gathers its gradient
back, an input ``f`` uses whole sums its gradient over the axes (each rank
used it on its own block), a gathered output hands each rank its block of
the cotangent, and ``psum``'s backward is the identity.  An
``all_gather`` whose backward sums the ranks' cotangents (as
``torch.distributed.nn``'s does) would count the replicated gradient once
a rank.  ``all_to_all`` moves blocks from rank to rank, and its backward
is the same exchange of the gradient's blocks.

Tensor-parallel regions (the train step's arithmetic over the model axis,
models/transformer.py ``Dist.tensor_parallel``) are Megatron's: an
activation every rank holds whole enters a region through ``tp_enter``
(the identity; its gradient summed over the axis) and a row-parallel
product leaves it through ``tp_exit`` (one sum; the identity backward);
``tp_block`` takes the rank's block of a weight left whole (or of an
activation, which ``tp_gather`` puts back together), and
``realign_pairs`` moves a product's columns so a rank holds its block of
each of two halves.  On an axis of one rank each is the identity and
makes no collective.

The distribution knobs of the config (``remat``, ``fsdp``, ``moe_mode``,
``expert_shards``) read as the reference's; ``moe_mode="ep_a2a"`` takes
the expert-parallel path under an active ``Dist`` (models/transformer.py),
``fsdp`` chooses whether parameters are sharded over the data axes
(launch/shardings.py), ``expert_shards`` pads the expert axis, and
``remat="full"`` checkpoints each layer's body (models/transformer.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import weakref

from dataclasses import dataclass, replace

import torch
import torch.distributed as torch_dist

# (mesh, names of its manual axes) of each enclosing binding, innermost last
_BINDINGS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "mesh_axes", default=())


def _names(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@contextlib.contextmanager
def manual_axes(mesh, axes):
    """Bind ``axes`` of ``mesh`` as manual while the block runs: each rank
    holds its own block over them, and named collectives may run over
    them."""
    token = _BINDINGS.set(_BINDINGS.get() + ((mesh, frozenset(_names(axes))),))
    try:
        yield
    finally:
        _BINDINGS.reset(token)


def _manual(mesh) -> frozenset:
    """The manual axes of ``mesh`` in the current binding."""
    out = frozenset()
    for m, names in _BINDINGS.get():
        if m is mesh:
            out |= names
    return out


# (a weak reference to the mesh, its axis's (group, size, index)) by the
# mesh's identity and the axis name: the layers ask at every call, and a
# DeviceMesh answers its rank through the process group each time
_AXES: dict = {}


def mesh_axis(mesh, name: str):
    """(process group, size, this rank's index) of ``mesh``'s axis
    ``name``."""
    key = (id(mesh), name)
    hit = _AXES.get(key)
    if hit is not None and hit[0]() is mesh:
        return hit[1]
    dim = mesh.mesh_dim_names.index(name)
    out = mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim)
    _AXES[key] = (weakref.ref(mesh), out)
    return out


def _axis(name: str):
    """(process group, size, this rank's index) of a bound axis."""
    for mesh, names in reversed(_BINDINGS.get()):
        if name in names:
            return mesh_axis(mesh, name)
    raise NameError(f"unbound axis name: {name}")


def axis_size(axis_name) -> int:
    """The size of a bound mesh axis (the product over a tuple of axes)."""
    return math.prod(_axis(a)[1] for a in _names(axis_name))


def axis_index(axis_name) -> int:
    """This rank's index along a bound axis (row-major over a tuple)."""
    idx = 0
    for a in _names(axis_name):
        _, size, i = _axis(a)
        idx = idx * size + i
    return idx


def _all_gather(x, group, size: int, dim: int):
    parts = [torch.empty_like(x) for _ in range(size)]
    torch_dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Psum(torch.autograd.Function):
    """Sum over an axis; the cotangent of the replicated sum is every
    summand's."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        torch_dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    """The identity on an input every rank of the axis uses whole on its
    own block: the input's gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch_dist.all_reduce(g, group=ctx.group)
        return g, None


class _Split(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor the axis holds whole;
    the gradient of the whole gathers every rank's block."""

    @staticmethod
    def forward(ctx, x, group, size: int, index: int, dim: int):
        ctx.args = (group, size, dim)
        return x.chunk(size, dim)[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        group, size, dim = ctx.args
        return _all_gather(g, group, size, dim), None, None, None, None


class _Gather(torch.autograd.Function):
    """The blocks of the axis's ranks put together along ``dim``; each
    rank's gradient is its block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group, size: int, index: int, dim: int):
        ctx.args = (size, index, dim)
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        size, index, dim = ctx.args
        return g.chunk(size, dim)[index].contiguous(), None, None, None, None


def psum(x, axis_name):
    """The sum of ``x`` over a bound axis (or tuple of axes); an axis of
    one rank adds nothing and makes no collective."""
    for a in _names(axis_name):
        group, size, _ = _axis(a)
        if size > 1:
            x = _Psum.apply(x, group)
    return x


def pmean(x, axis_name):
    """The mean of ``x`` over a bound axis: its ``psum`` over the size;
    ``x`` itself over axes of one rank (no collective, and no divisor
    made on the device, which waits for it)."""
    if axis_size(axis_name) == 1:
        return x
    n = torch.tensor(float(axis_size(axis_name)), dtype=torch.float32,
                     device=x.device)
    return psum(x, axis_name) / n.to(x.dtype)


class _AllToAll(torch.autograd.Function):
    """Block i of dim 0 to rank i; the gradient goes back the same way."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        recv = torch.empty_like(send)
        torch_dist.all_to_all_single(recv, send.contiguous(), group=group)
        return recv

    @staticmethod
    def backward(ctx, g):
        back = torch.empty_like(g)
        torch_dist.all_to_all_single(back, g.contiguous(), group=ctx.group)
        return back, None


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, *,
               tiled: bool = True):
    """The reference's tiled ``all_to_all``: ``x`` split along
    ``split_axis`` into one block a rank, block j sent to rank j, and the
    blocks received put together along ``concat_axis`` in rank order."""
    if not tiled:
        raise NotImplementedError("all_to_all: only the tiled form")
    group, size, _ = _axis(axis_name)
    recv = _AllToAll.apply(torch.stack(x.chunk(size, split_axis)), group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


# --------------------------------------------------------------------------
# tensor-parallel regions over the model axis (Megatron's layout)
# --------------------------------------------------------------------------


def tp_axis(dist) -> str | None:
    """The model axis of ``dist`` when the arithmetic is split over it:
    the train step's ``Dist`` with ``tensor_parallel`` set, its model axis
    bound (models/transformer.py ``_forward``) and of more than one rank.
    None otherwise, and then every layer runs its one-device operations."""
    if dist is None or not getattr(dist, "tensor_parallel", False):
        return None
    name = dist.model_axis
    if not any(name in names for _, names in _BINDINGS.get()):
        return None
    return name if axis_size(name) > 1 else None


def tp_enter(x, axis_name: str):
    """Enter a tensor-parallel region: ``x``, which every rank of the axis
    holds whole and uses on its own block of the weights, as it is; its
    gradient is the sum of the ranks' (Megatron's ``f``)."""
    group, size, _ = _axis(axis_name)
    return x if size == 1 else _SumGrad.apply(x, group)


def tp_exit(x, axis_name: str):
    """Leave a tensor-parallel region: the sum over the axis of each
    rank's partial result (a row-parallel product), the same on every
    rank; each summand's gradient is the sum's (Megatron's ``g``)."""
    group, size, _ = _axis(axis_name)
    return x if size == 1 else _Psum.apply(x, group)


def tp_block(x, axis_name: str, dim: int, whole: int):
    """This rank's block along ``dim`` of ``x``: ``x`` as it is when it
    holds the block already (``whole`` / size entries there), else the
    block of the whole ``x`` every rank holds, whose gradient gathers the
    ranks' blocks (each rank's the whole gradient)."""
    group, size, index = _axis(axis_name)
    n = x.shape[dim]
    if size == 1 or n * size == whole:
        return x
    if n != whole:
        raise ValueError(f"{n} entries along dim {dim} are neither the "
                         f"whole {whole} nor a block of {size}")
    return _Split.apply(x, group, size, index, dim)


def tp_gather(x, axis_name: str, dim: int):
    """The ranks' blocks of ``x`` along ``dim`` put together, the same
    on every rank of the axis; each rank's gradient is its block of the
    (replicated) cotangent: the way back from :func:`tp_block` of a
    replicated activation."""
    group, size, index = _axis(axis_name)
    return x if size == 1 else _Gather.apply(x, group, size, index, dim)


def pmax(x, axis_name: str) -> torch.Tensor:
    """The elementwise maximum over a bound axis, outside autograd (a
    constant shift, as a softmax's maximum)."""
    group, size, _ = _axis(axis_name)
    out = x.detach().clone()
    if size > 1:
        torch_dist.all_reduce(out, op=torch_dist.ReduceOp.MAX, group=group)
    return out


class _Exchange(torch.autograd.Function):
    """Rows of dim 0 to the ranks in order, ``send[j]`` of them to rank j,
    ``recv[j]`` received from rank j; the gradient goes back the same
    way."""

    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.args = (group, send, recv)
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        torch_dist.all_to_all_single(out, x.contiguous(), list(recv),
                                     list(send), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        group, send, recv = ctx.args
        back = g.new_empty((sum(send),) + tuple(g.shape[1:]))
        torch_dist.all_to_all_single(back, g.contiguous(), list(send),
                                     list(recv), group=group)
        return back, None, None, None


def paired_blocks_plan(size: int, index: int) -> tuple:
    """Where rank ``index`` sends its two column blocks of a product whose
    2n columns hold two n-column halves (mamba1's x then z), each rank
    holding 2n / size contiguous columns, so that rank t ends with its
    block t of each half; returns (the order this rank's two blocks are
    sent in, blocks sent to each rank, blocks received from each rank).
    Block b of the 2 size blocks sits on rank b // 2 and belongs to rank
    b mod size; rank t receives block t (of the first half) from rank
    t // 2 before block size + t (of the second) from rank
    (size + t) // 2."""
    dests = [(2 * index) % size, (2 * index + 1) % size]
    order = sorted(range(2), key=lambda i: dests[i])
    send, recv = [0] * size, [0] * size
    for d in dests:
        send[d] += 1
    recv[index // 2] += 1
    recv[(size + index) // 2] += 1
    return order, send, recv


def realign_pairs(x, axis_name: str):
    """``x`` (..., 2w), this rank's contiguous columns of a product whose
    columns are two halves, as (..., 2w) holding this rank's block of the
    first half and then its block of the second: one all-to-all over the
    axis (uneven: each rank sends its two blocks to at most two ranks,
    since the tiled, even form cannot put contiguous blocks of both
    halves on one rank beyond two ranks)."""
    group, size, index = _axis(axis_name)
    if size == 1:
        return x
    order, send, recv = paired_blocks_plan(size, index)
    w = x.shape[-1] // 2
    parts = x.movedim(-1, 0).split(w)
    rows = torch.cat([parts[i] for i in order])
    out = _Exchange.apply(rows, group, [w * n for n in send],
                          [w * n for n in recv])
    return out.movedim(0, -1)


class P(tuple):
    """A partition spec: one entry a tensor dimension, each ``None``
    (replicated), an axis name, or a tuple of axis names (the first the
    major one).  A tuple, so ``tuple(spec)`` reads as the reference's
    ``PartitionSpec``, which also writes a tuple of one axis as the axis
    and an empty one as ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _enter(x, spec, mesh, manual):
    """This rank's block of ``x`` under ``spec`` (see the module
    docstring)."""
    if isinstance(spec, dict):
        return {k: _enter(x[k], s, mesh, manual) for k, s in spec.items()}
    named = set()
    for dim, entry in enumerate(spec):
        for a in _names(entry):
            named.add(a)
            if a not in manual:
                x = _Split.apply(x, *mesh_axis(mesh, a), dim)
    for a in mesh.mesh_dim_names:
        if a not in named and a not in manual:
            x = _SumGrad.apply(x, mesh_axis(mesh, a)[0])
    return x


def _exit(y, spec, mesh, manual):
    """The whole of ``y`` from the ranks' blocks under ``spec``: gathered
    along every dimension over the axes not manual that ``spec`` names,
    minor axis first, so the first named axis is the major one."""
    if not isinstance(spec, P):
        return type(spec)(_exit(v, s, mesh, manual) for v, s in zip(y, spec))
    for dim in reversed(range(len(spec))):
        for a in reversed(_names(spec[dim])):
            if a not in manual:
                y = _Gather.apply(y, *mesh_axis(mesh, a), dim)
    return y


def shard_map(f, *, mesh, in_specs, out_specs, check_vma: bool = False):
    """``f`` over this rank's blocks (see the module docstring): the
    returned function takes what this rank holds, gives ``f`` the block of
    each input under ``in_specs`` (a spec, or a dict of specs for a dict
    input) with every axis of ``mesh`` bound, and puts the output back
    together under ``out_specs`` (a spec, or a tuple of specs).
    ``check_vma`` is accepted for the reference's signature; nothing here
    checks replication."""
    del check_vma

    def run(*args):
        manual = _manual(mesh)
        local = [_enter(x, s, mesh, manual) for x, s in zip(args, in_specs)]
        with manual_axes(mesh, mesh.mesh_dim_names):
            out = f(*local)
        return _exit(out, out_specs, mesh, manual)

    return run


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | mla_moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0

    # MLA (DeepSeek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # SSM (Mamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1       # 1 = mamba1 (falcon-mamba), 2 = mamba2 (zamba2)
    ssm_heads: int = 0         # mamba2 heads (d_inner // head dim of 64)

    # hybrid (zamba2): one weight-shared attention block applied every k layers
    attn_every: int = 0

    # flags
    qkv_bias: bool = False
    qk_norm: bool = False
    mrope: bool = False        # M-RoPE (qwen2-vl): 3-section rotary
    causal: bool = True        # False -> encoder-only (hubert)
    embedding_inputs: bool = False  # modality stub: inputs are embeddings
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # distribution / perf knobs (overridable per run / by GEVO-Shard)
    remat: str = "none"        # none | full  — activation checkpoint per layer
    moe_mode: str = "dense"    # dense | ep_a2a  (decode always uses gather)
    expert_shards: int = 1     # pad expert dim so it divides this (EP width)
    attn_impl: str = "naive"   # naive | blockwise (flash-style, O(S) memory)
    attn_block: int = 512      # q/kv block for blockwise attention
    loss_chunk: int = 0        # seq-chunked xent head (0 = full logits)
    fsdp: bool = True          # ZeRO-3 weight sharding over the DP axes
    ssm_impl: str = "ssd"      # ssd | naive — mamba2 scan formulation
    gnorm_vdot: bool = False   # True reproduces the vdot grad-norm bug (A/B)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers), for 6ND math."""
        d, v = self.d_model, self.vocab
        emb = v * d * 2  # in + out embedding (untied)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encoder", "mla_moe"):
            if self.mla:
                q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.qk_rope_dim)
                kv = d * (self.kv_lora_rank + self.qk_rope_dim) + \
                    self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                o = self.n_heads * self.v_head_dim * d
                attn = q + kv + o
            else:
                attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * self.hd * d
            if self.n_experts:
                ff = 3 * d * self.moe_d_ff * (self.n_experts
                                              + self.n_shared_experts) \
                    + d * self.n_experts
            else:
                ff = 3 * d * self.d_ff
            per_layer = attn + ff
        elif self.family in ("ssm", "hybrid"):
            di, n = self.d_inner, self.ssm_state
            # in_proj (x,z), conv, dt/B/C projections, out_proj
            per_layer = d * di * 2 + di * self.ssm_conv + di * (2 * n + 2) \
                + di * d
        n_param = emb + self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            # ONE weight-shared attention + MLP block
            shared = 4 * d * self.n_heads * self.hd + 3 * d * self.d_ff
            n_param += shared
        return int(n_param)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_expert = 3 * d * self.moe_d_ff * self.n_experts * self.n_layers
        active_expert = 3 * d * self.moe_d_ff * self.top_k * self.n_layers
        return int(full - all_expert + active_expert)
