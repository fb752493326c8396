"""The traced run: torch.profiler over the measured window, spans the
harness records around its calls into the port's layers, and the shapes of
every kernel call.

Nothing here changes the port: in a traced run (``--trace 1``) the harness
wraps the port's six kernel launch functions where their wrappers call them
(``kernels/*/ops.py``), to record each call's shapes, and the calls it makes
into a layer in ``torch.profiler.record_function`` spans named ``bench.*``.
The device's spans are reduced in memory; no trace file is written.

The union of device spans (``busy_ns``) and the filter of device events are
copied from ``chip_smoke.py`` (``device_spans``, ``busy_us``) as of commit
11d5fcd.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

# (ops module, launch function, kernel, direction) of each hand-written
# kernel the port launches
LAUNCHES = (
    ("repro_torch.kernels.rmsnorm.ops", "rmsnorm_launch", "rmsnorm", "fwd"),
    ("repro_torch.kernels.rmsnorm.ops", "rmsnorm_bwd_launch", "rmsnorm",
     "bwd"),
    ("repro_torch.kernels.flash_attention.ops", "flash_attention_launch",
     "flash_attention", "fwd"),
    ("repro_torch.kernels.flash_attention.ops", "flash_attention_bwd_launch",
     "flash_attention", "bwd"),
    ("repro_torch.kernels.mamba_scan.ops", "mamba_scan_launch", "mamba_scan",
     "fwd"),
    ("repro_torch.kernels.mamba_scan.ops", "mamba_scan_bwd_launch",
     "mamba_scan", "bwd"),
)

# host operations at least this long may explain an idle gap of the device
BLOCKING_OP_NS = 100_000


def _dt(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def call_shape(kernel: str, direction: str, args, kwargs) -> dict:
    """The arguments of ``harness/costs.py``'s count for one launch."""
    if kernel == "rmsnorm":
        x, scale = args[0], args[1]
        return {"rows": x.shape[0], "d": x.shape[1], "dtype": _dt(x),
                "scale_dtype": _dt(scale)}
    if kernel == "flash_attention":
        q, k = args[0], args[1]
        B, H, S, hd = q.shape
        shape = {"B": B, "H": H, "S": S, "hd": hd, "dtype": _dt(q),
                 "Sk": k.shape[2], "causal": kwargs["causal"]}
        if direction == "fwd":
            shape["lse"] = kwargs.get("lse") is not None
        return shape
    dt, x, A = args[0], args[1], args[2]
    Bt, L, D = x.shape
    shape = {"Bt": Bt, "L": L, "D": D, "N": A.shape[1], "dtype": _dt(x)}
    if direction == "fwd":
        hc = kwargs.get("h_chunks")
        shape.update(state=args[6] is not None,
                     h_chunks=0 if hc is None else hc.shape[1])
    else:
        shape.update(chunk=kwargs["chunk"], dh_last=args[6] is not None)
    return shape


@dataclass
class Trace:
    """What a traced window left: its bounds (ns on the profiler's clock,
    the host's wall clock), the device's kernels in it, the host's
    ``bench.*`` spans and long operations, and the kernel calls."""
    t0_ns: int
    t1_ns: int
    device: list           # (start_ns, end_ns, name), sorted
    host: list             # (start_ns, end_ns, name): bench.* spans
    blocking: list         # (start_ns, end_ns, name): long host ops
    calls: list = field(default_factory=list)   # (kernel, direction, shape)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_ns(self) -> int:
        """Nanoseconds in which at least one device span ran."""
        total, cur = 0, None
        for start, end, _ in self.device:
            if cur is None or start > cur[1]:
                total += 0 if cur is None else cur[1] - cur[0]
                cur = [start, end]
            else:
                cur[1] = max(cur[1], end)
        return total + (0 if cur is None else cur[1] - cur[0])

    def gaps(self) -> list:
        """(start_ns, end_ns) of each interval of the window in which no
        device span ran."""
        out, t = [], self.t0_ns
        for start, end, _ in self.device:
            if start > t:
                out.append((t, start))
            t = max(t, end)
        if self.t1_ns > t:
            out.append((t, self.t1_ns))
        return out

    def device_s(self, pattern) -> tuple[float, int]:
        """(seconds, count) of the device spans whose name matches the
        compiled regex ``pattern``."""
        spans = [(s, e) for s, e, n in self.device if pattern.search(n)]
        return sum(e - s for s, e in spans) / 1e9, len(spans)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing at each gap's middle: the
        innermost ``bench.*`` span or long host operation around it."""
        ops: dict = {}
        for s, e, n in self.device:
            ops[n] = ops.get(n, 0) + e - s
        # one sweep: marks nest within a thread, so those around a point
        # form a stack, the innermost on top
        marks = sorted(self.host + self.blocking)
        idle: dict = {}
        stack, i = [], 0
        for s, e in self.gaps():
            mid = (s + e) // 2
            while i < len(marks) and marks[i][0] <= mid:
                while stack and stack[-1][1] < marks[i][0]:
                    stack.pop()
                stack.append(marks[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else "outside bench spans"
            idle[label] = idle.get(label, 0) + e - s

        def rank(d):
            return [[n, v / 1e9] for n, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


class Tracer:
    """``enabled``: profile the window and record spans and kernel calls;
    otherwise every method is a no-op (the untraced run)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.calls: list = []
        self._undo: list = []
        self._prof = None
        self._t0 = self._t1 = 0

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Put every call of ``owner.attr`` in the span ``name`` (traced
        runs only), until :meth:`close`."""
        if not self.enabled:
            return
        fn = getattr(owner, attr)

        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        setattr(owner, attr, spanned)
        self._undo.append((owner, attr, fn))

    def _record_launches(self) -> None:
        import importlib
        for mod_name, attr, kernel, direction in LAUNCHES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def recorded(*args, _fn=fn, _k=kernel, _d=direction, **kwargs):
                if not self._t1:   # a call of the window
                    self.calls.append((_k, _d, call_shape(_k, _d, args,
                                                          kwargs)))
                return _fn(*args, **kwargs)
            setattr(mod, attr, recorded)
            self._undo.append((mod, attr, fn))

    def start(self) -> None:
        """Begin the traced window: the caller has synchronized."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        self._record_launches()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.calls.clear()
        self._t0, self._t1 = time.time_ns(), 0

    def end_window(self) -> None:
        """Mark the traced window's end (the caller has synchronized); the
        profiler keeps running, unread, until :meth:`stop`, so a run's work
        after the window does not wait for it."""
        if self.enabled and not self._t1:
            self._t1 = time.time_ns()

    def stop(self) -> None:
        """End the profile; its events after the window are dropped."""
        if not self.enabled:
            return
        self.end_window()
        self._prof.__exit__(None, None, None)
        self.close()

    def close(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def result(self) -> Trace | None:
        if self._prof is None:
            return None
        import torch
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        device, host, blocking = [], [], []
        t0, t1 = self._t0, self._t1
        for e in self._prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if s + d < t0 or s > t1:
                continue
            kind = e.device_type()
            if kind == cuda:
                # the device's own record of a host span is no kernel
                name = e.name()
                if "spin_kernel" not in name and not name.startswith(
                        "bench.") and not e.is_user_annotation():
                    device.append((max(s, t0), min(s + d, t1), name))
            elif kind == cpu:
                name = e.name()
                if name.startswith("bench."):
                    host.append((s, s + d, name))
                elif d >= BLOCKING_OP_NS and not name.startswith(
                        ("ProfilerStep", "##")):
                    blocking.append((s, s + d, name))
        self._prof = None
        device.sort()
        return Trace(t0, t1, device, host, blocking, list(self.calls))
