"""The host side of the kernels: on CPU tensors each wrapper runs its
kernel's plain PyTorch version, and the search's oracle runs on the CPU."""

from __future__ import annotations

import functools

import torch


@functools.cache
def init_vector_math() -> None:
    """Run PyTorch's CPU vector math once on one thread, before any
    multithreaded use.  With the MKL-backed CPU build of PyTorch the tests
    run on, the first multithreaded ``torch.exp`` of a process returned
    values off by ~1e-4 in about 5% of fresh processes (several threads
    initialising MKL's vector math at once); with a single-threaded first
    call, none of 300 fresh processes did."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        torch.exp(torch.zeros(1 << 16))
    finally:
        torch.set_num_threads(threads)
