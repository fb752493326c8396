"""Mamba-1 selective scan: the hand-written CUDA kernel
(``csrc/mamba_scan.cu``), its shared-memory size, and its plain PyTorch
version.

The kernel replaces the Pallas TPU kernel of
``src/repro/kernels/mamba_scan/mamba_scan.py`` (``_scan_kernel``).  It
computes ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t . h_t``
with the (D, N) state in f32, forming the decay and drive in registers so
the (Bt, L, D, N) tensors never reach HBM.  One CUDA block carries the
state of 128 / N channels through the whole sequence, staging ``chunk``
timesteps of dt/x/B/C in shared memory at a time.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

THREADS = 128   # threads a block, one per (channel, state) pair

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def smem_bytes(knobs: dict, shape: dict, dtype: torch.dtype):
    """Dynamic shared memory of one block: ``chunk`` timesteps of dt, x and
    y for the block's channels and of B and C, all as f32.  Pure arithmetic
    on the values, so the cost model evaluates it on arrays of genomes
    too."""
    n = shape["N"]
    return 4 * knobs["chunk"] * (3 * (THREADS // n) + 2 * n)


def mamba_scan_plain(dt, x, A, B, C, *, chunk: int) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: ``chunk`` timesteps staged
    as f32 at a time, then scanned one step after another with the (D, N)
    state in f32."""
    Bt, L, D = x.shape
    y = torch.empty_like(x)
    A32 = A.to(torch.float32)
    h = torch.zeros((Bt, D, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    for t0 in range(0, L, chunk):
        dts = dt[:, t0:t0 + chunk].to(torch.float32)
        xs = x[:, t0:t0 + chunk].to(torch.float32)
        Bs = B[:, t0:t0 + chunk].to(torch.float32)
        Cs = C[:, t0:t0 + chunk].to(torch.float32)
        ys = torch.empty((Bt, chunk, D), dtype=torch.float32,
                         device=x.device)
        for t in range(chunk):
            decay = torch.exp(dts[:, t, :, None] * A32)
            drive = (dts[:, t] * xs[:, t])[:, :, None] * Bs[:, t, None, :]
            h = decay * h + drive
            ys[:, t] = (h * Cs[:, t, None, :]).sum(-1)
        y[:, t0:t0 + chunk] = ys.to(x.dtype)
    return y


def mamba_scan_launch(dt, x, A, B, C, y, *, chunk: int, smem: int) -> None:
    """Launch the CUDA kernel on PyTorch's current stream.  The caller has
    checked the arguments (``ops.mamba_scan``)."""
    fn = build.function("mamba_scan", "mamba_scan_fwd", _ARGTYPES)
    Bt, L, D = x.shape
    err = fn(dt.data_ptr(), x.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), Bt, L, D, A.shape[1], chunk,
             build.DTYPE_CODES[x.dtype], smem, build.stream_ptr(x.device))
    build.check("mamba_scan", err, "mamba_scan_fwd")
