"""The cost count of one traced step (the counterpart of
``src/repro/launch/hlo_analysis.py``).

The reference reads its three roofline terms from compiled HLO text.
Torch runs eagerly and produces no HLO, so this module does the same job
over a dispatch trace: :func:`analyze` runs a step's function once under
a ``TorchDispatchMode`` (:class:`CostCounter`), on tensors that hold no
data (``FakeTensor``s, ``launch/specs.py``), and sums

* dot FLOPs by dtype: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and the
  convolutions, by ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` applies, so the card's ``FlopCounterMode`` over the
  real step must give the same count) under ``aten_flops``;
* bytes: every op's tensor operands plus its results.  Eager torch fuses
  nothing, so each op is one trip to device memory; views, allocations
  without a write (``empty``) and scalar reads move nothing;
* the hand-written kernels' work: each wrapper, on such tensors, records
  its operations and bytes (``kernels/trace.py``, ``kernels/costs.py``);
  the attention's products join the dot FLOPs of their dtype, the norm's
  and the scan's arithmetic is ``vector_ops`` (f32, CUDA cores);
* collective wire bytes, with the reference's ring factors from the
  group's size g: all-reduce 2(g-1)/g, all-gather, reduce-scatter and
  all-to-all (g-1)/g, permute 1, of the result's bytes (of the output
  buffer for an op that writes into its first argument, as
  ``all_to_all_single`` does; the payload is also a trip to memory, as
  the reference counts it);
* memory: the live storage of the tensors the step makes (a meta
  tensor holds none), from the
  dispatch of each op's results (a storage counted once, while any
  tensor holds it, rounded up to the caching allocator's 512 bytes); its
  peak is ``temp_size_in_bytes``.  Storages that exist before the step
  (the arguments) are not counted.

Every number is per rank (one device) per step.  ``parse_hlo`` and
``_trip_count`` have no counterpart: there is no HLO text (so no ``Op``
or ``Computation`` either), and a Python loop is traced once a trip, so
no loop multiplier is needed.  Nor has ``VMEM_BUDGET``: the reference
models a TPU that keeps small loop-body temporaries in VMEM; the card
runs each eager op through device memory.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import trace

# collective op (its overload packet) -> the reference's kind
COLLECTIVES = {
    "c10d.allreduce_": "all_reduce",
    "c10d.allreduce_coalesced_": "all_reduce",
    "_c10d_functional.all_reduce": "all_reduce",
    "_c10d_functional.all_reduce_": "all_reduce",
    "_c10d_functional.all_reduce_coalesced": "all_reduce",
    "c10d.allgather_": "all_gather",
    "c10d._allgather_base_": "all_gather",
    "c10d.allgather_into_tensor_coalesced_": "all_gather",
    "_c10d_functional.all_gather_into_tensor": "all_gather",
    "_c10d_functional.all_gather_into_tensor_out": "all_gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all_gather",
    "c10d.reduce_scatter_": "reduce_scatter",
    "c10d._reduce_scatter_base_": "reduce_scatter",
    "_c10d_functional.reduce_scatter_tensor": "reduce_scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce_scatter",
    "c10d.alltoall_": "all_to_all",
    "c10d.alltoall_base_": "all_to_all",
    "_c10d_functional.all_to_all_single": "all_to_all",
    "c10d.send": "collective_permute",
}

# allocation cells of the CUDA caching allocator
ALLOC_ROUND = 512

# ops that move no data besides views: allocations, reading a scalar or
# a device, waiting
_NO_TRAFFIC = {
    "aten.empty", "aten.empty_like", "aten.empty_strided",
    "aten._local_scalar_dense", "prim.device", "_c10d_functional.wait_tensor",
}


def wire_bytes(kind: str, payload: float, g: int) -> float:
    """Bytes a rank puts on the wire for a collective of ``payload`` result
    bytes over a group of ``g`` ranks (ring algorithms)."""
    if kind == "all_reduce":
        return 2.0 * (g - 1) / g * payload
    if kind == "collective_permute":
        return payload
    return (g - 1) / g * payload


@dataclass
class HloCosts:
    flops_bf16: float = 0.0
    flops_f32: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    n_collective_ops: int = 0
    # the port's own: the kernels' elementwise operations (f32, CUDA
    # cores), aten's dot FLOPs alone by dtype, each kernel and direction's
    # events, operations and bytes, the memory of the step, the op log
    vector_ops: float = 0.0
    aten_flops: dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    kernels: dict[str, dict] = field(default_factory=dict)
    memory: dict[str, int] = field(default_factory=dict)
    text: str | None = None

    @property
    def flops(self) -> float:
        return self.flops_bf16 + self.flops_f32

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _bf16_class(dtype: torch.dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _group_size(args, kwargs) -> int:
    """The size of the group a collective runs over: its ``group_size``, a
    ``ProcessGroup`` among its arguments, or its group's name."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    if "group_size" in kwargs:
        return int(kwargs["group_size"])
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(
                a._type()):
            return dist.ProcessGroup.unbox(a).size()
    for a in (*args, *kwargs.values()):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError("a collective without a group")


def storage_bytes(t: torch.Tensor) -> int:
    """The bytes the caching allocator gives ``t``'s storage."""
    n = t.untyped_storage().nbytes()
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


class CostCounter(TorchDispatchMode):
    """Counts one traced run (see the module docstring).  ``known``:
    tensors that exist before the run, whose storage is not counted."""

    def __init__(self, known=(), keep_text: bool = False):
        super().__init__()
        self.costs = HloCosts()
        self.events: list = []
        self.lines: list | None = [] if keep_text else None
        self._live = 0
        self._peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in known:
            self._seen[t.untyped_storage()] = 0
        self._fake = None
        self._recording = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake = active_fake_mode()
        self._recording = trace.recording(self.events)
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._recording.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        # DTensor runs first and lowers itself to ops on local tensors,
        # which come back here
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default \
                and trace.fake_mode_active():
            return args[0]  # nothing to wait for, nothing allocated
        out = func(*args, **kwargs)
        # DTensor's shape propagation runs under a fake mode of its own
        if active_fake_mode() is self._fake:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        c = self.costs
        name = str(func._overloadpacket)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func._overloadpacket in flop_registry:
            f = flop_registry[func._overloadpacket](*args, **kwargs,
                                                    out_val=out)
            dt = ins[0].dtype
            c.aten_flops[str(dt).removeprefix("torch.")] += f
            if _bf16_class(dt):
                c.flops_bf16 += f
            else:
                c.flops_f32 += f
        if name in COLLECTIVES:
            # an op that writes into its first argument returns no tensor
            # (``alltoall_base_``): the payload is that buffer
            payload = sum(_nbytes(t) for t in outs or ins[:1])
            kind = COLLECTIVES[name]
            c.collective_bytes[kind] += wire_bytes(
                kind, payload, _group_size(args, kwargs))
            c.n_collective_ops += 1
            c.hbm_bytes += payload
        elif not func.is_view and name not in _NO_TRAFFIC:
            c.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        if self.lines is not None:
            self.lines.append(f"{func} " + " ".join(
                f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
                for t in outs))

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return  # no memory (a model's skeleton, shardings.local_model)
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = storage_bytes(t)
        self._seen[st] = n
        self._live += n
        self._peak = max(self._peak, self._live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    def finish(self, output_bytes: int) -> HloCosts:
        """The counts, with the kernels' events folded in; the step's
        results held ``output_bytes`` of the storage it made."""
        c = self.costs
        for e in self.events:
            key = f"{e['kernel']}/{e['direction']}"
            k = c.kernels.setdefault(key, {"events": 0, "operations": 0,
                                           "bytes": 0})
            k["events"] += 1
            k["operations"] += e["operations"]
            k["bytes"] += e["bytes"]
            c.hbm_bytes += e["bytes"]
            if not e["matmul"]:
                c.vector_ops += e["operations"]
            elif e["dtype"] in ("bfloat16", "float16"):
                c.flops_bf16 += e["operations"]
            else:
                c.flops_f32 += e["operations"]
        c.memory = {"temp_size_in_bytes": self._peak,
                    "output_size_in_bytes": output_bytes}
        if self.lines is not None:
            c.text = "\n".join(self.lines)
        return c


def analyze(fn, args, *, known=(), keep_text: bool = False) -> HloCosts:
    """Run ``fn(*args)`` once under a :class:`CostCounter` and return its
    counts per rank (each collective reads its own group's size).
    ``known`` tensors' storage (the arguments) is not counted as the
    step's."""
    counter = CostCounter(known, keep_text)
    with counter:
        result = fn(*args)
    output_bytes = counter._live
    del result
    return counter.finish(output_bytes)
