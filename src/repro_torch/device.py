"""Where the port's entry points run: the GPU unless the caller names
another device."""

from __future__ import annotations

import torch

from .kernels.cpu import init_vector_math


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
