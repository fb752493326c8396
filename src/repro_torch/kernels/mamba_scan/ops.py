"""Public wrapper for the mamba selective-scan kernel.

On CUDA tensors it launches the hand-written kernel (or raises); on CPU
tensors it runs the kernel's plain PyTorch version, which is how the tests
on hosts without a GPU reach it.  ``mamba_scan.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from ..build import DTYPE_CODES
from ..cpu import init_vector_math
from .mamba_scan import mamba_scan_launch, mamba_scan_plain, smem_bytes


def mamba_scan(dt, x, A, B, C, *, chunk: int = 64,
               return_state: bool = False):
    """Selective scan: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t; y = C.h.
    dt, x: (Bt, L, D); A: (D, N) float32; B, C: (Bt, L, N).  Returns y, or
    ``(y, h_last)`` with ``return_state``: the (Bt, D, N) float32 state
    after the last step, bit-identical across ``chunk`` as y is."""
    Bt, L, D = x.shape
    N = A.shape[1] if A.dim() == 2 else -1
    if dt.shape != x.shape or A.shape != (D, N) \
            or B.shape != (Bt, L, N) or C.shape != (Bt, L, N):
        raise ValueError(f"mamba_scan: shapes dt {tuple(dt.shape)}, "
                         f"x {tuple(x.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"mamba_scan: chunk {chunk} does not divide L {L}")
    tensors = (dt, x, A, B, C)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        init_vector_math()
        return mamba_scan_plain(dt, x, A, B, C, chunk=chunk,
                                return_state=return_state)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"mamba_scan: tensors on "
                         f"{sorted(map(str, devices))}; the kernel takes one "
                         "CUDA device")
    if not (dt.dtype == x.dtype == B.dtype == C.dtype) \
            or x.dtype not in DTYPE_CODES or A.dtype != torch.float32:
        raise ValueError("mamba_scan: dt, x, B, C must share one dtype "
                         "(float32 or bfloat16) and A must be float32")
    if N > 32 or N & (N - 1):
        raise ValueError(f"mamba_scan: state size {N} must be a power of two "
                         "up to 32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mamba_scan: inputs must be contiguous")
    y = torch.empty_like(x)
    h = (torch.empty((Bt, D, N), dtype=torch.float32, device=x.device)
         if return_state else None)
    mamba_scan_launch(dt, x, A, B, C, y, h, chunk=chunk,
                      smem=smem_bytes({"chunk": chunk},
                                      {"Bt": Bt, "L": L, "D": D, "N": N},
                                      x.dtype))
    mamba_scan.launches += 1
    return (y, h) if return_state else y


mamba_scan.launches = 0
