"""The kernel wrappers' shape-only path, and the sink it records into.

A dry run (``launch/dryrun.py``) traces a step on tensors that hold no
data: ``FakeTensor``s, or ``meta`` tensors.  A fake CUDA tensor says
``device.type == "cuda"``, and a ctypes launch would read its fake data
pointer, so every wrapper asks :func:`shape_only` before anything else.
On such tensors the wrapper takes the kernel's path as far as the launch:
the same checks, the same outputs and scratch (allocated as the mode
allocates them), and in place of the launch one event for each active
:func:`recording`: the kernel, its direction, shape and dtype, and its
operations and bytes from ``kernels/costs.py``.  It bumps no launch
counter.  Real CPU and CUDA tensors never take this path.

This module imports nothing of the package, so the wrappers can import it
while the package is still importing.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch._subclasses.fake_tensor import FakeTensor

_SINKS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "kernel_sinks", default=())


def shape_only(tensors) -> bool:
    """True when any of ``tensors`` holds no data (a ``FakeTensor`` or a
    ``meta`` tensor)."""
    return any(isinstance(t, FakeTensor) or t.is_meta for t in tensors)


def fake_mode_active() -> bool:
    """True inside a ``FakeTensorMode``: a tensor made now holds no data,
    and a cache that kept it would hand it to a real run later."""
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None


@contextlib.contextmanager
def recording(sink: list):
    """Append every shape-only kernel call made while the block runs to
    ``sink``, one event a call."""
    token = _SINKS.set(_SINKS.get() + (sink,))
    try:
        yield sink
    finally:
        _SINKS.reset(token)


def record(kernel: str, direction: str, shape: dict, dtype: torch.dtype,
           **work) -> None:
    """One shape-only call of ``kernel``'s ``direction`` ("fwd" or
    "bwd"): its operations and bytes from the count of
    ``kernels.costs.<kernel>_<direction>_cost(**shape, dtype=dtype,
    **work)``."""
    sinks = _SINKS.get()
    if not sinks:
        return
    from . import costs  # late: costs imports the core package
    cost = getattr(costs, f"{kernel}_{direction}_cost")(
        **shape, dtype=dtype, **work)
    event = {"kernel": kernel, "direction": direction, "shape": dict(shape),
             "dtype": str(dtype).removeprefix("torch."),
             "operations": cost.operations, "bytes": cost.bytes,
             "matmul": cost.matmul}
    for sink in sinks:
        sink.append(event)
