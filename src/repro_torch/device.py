"""Where the port's entry points run: the GPU unless the caller names
another device.  Also the one CUDA-graph helper the measured fitness times
variants with, and :class:`DeviceFault`, the error of the device itself."""

from __future__ import annotations

import torch

from .kernels.cpu import init_vector_math


class DeviceFault(RuntimeError):
    """A kernel failed to build, the device refused or faulted a launch
    that passed every gate, or a variant that ran could not be captured as
    a CUDA graph.  That says nothing about the variant, so it is never
    folded into an invalid variant: it stops the evaluation."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another.  With no GPU and no ``device``, this raises rather than
    quietly running on the host.  A host device gets PyTorch's CPU vector
    math prepared first (:func:`~repro_torch.kernels.cpu.init_vector_math`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cpu":
        init_vector_math()
    return dev


class CudaGraph:
    """Some device work captured once as a CUDA graph and replayed.

    :meth:`eager` runs a function on the capture stream (the warm-up:
    library handles and workspaces that torch creates lazily for a stream
    are made there, outside the graph; its exceptions are the caller's);
    :meth:`capture` records one call of a function and returns what that
    call returned, whose tensors every :meth:`replay` rewrites in place.
    A capture that fails raises :class:`DeviceFault`: whatever ran eagerly
    must capture, so the failure is the device path's, not the work's.
    :meth:`release` frees the graph and its private memory pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        # torch's own side stream for captures (one per process): a fresh
        # stream per graph would give each its own cuBLAS workspace
        self._ctx = torch.cuda.graph(self.graph)
        self.stream = self._ctx.capture_stream

    def eager(self, fn):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, fn):
        try:
            with self._ctx:
                out = fn()
        except Exception as e:
            raise DeviceFault(f"CUDA graph capture failed: "
                              f"{type(e).__name__}: {e}") from e
        return out

    def replay(self) -> None:
        self.graph.replay()

    def release(self) -> None:
        self.graph.reset()
        torch.cuda.empty_cache()
