"""Fused RMSNorm: the hand-written CUDA kernel (``csrc/rmsnorm.cu``), its
shared-memory size, and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel of
``src/repro/kernels/rmsnorm/rmsnorm.py`` (``_rmsnorm_kernel``).  One pass
over the rows — mean of squares, rsqrt, scale — in f32, so the normalized
intermediate never round-trips to HBM; ``block_rows`` rows per CUDA block.
Its gradient is a kernel too (``rmsnorm_bwd`` in the same source): rows up
to 4096 wide are held in registers by a group of lanes sized to the width,
each lane keeping its columns' part of dscale in registers; dscale is
summed through per-block f32 partial rows in a fixed order
(``rmsnorm_bwd_geometry``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float] + \
    [ctypes.c_int] * 5 + [ctypes.c_void_p]

# the backward's geometry (kBwd* in csrc/rmsnorm.cu): the row path's
# threads a block, widest row, the vectors a row is padded up to and a
# lane's vectors from 128 vectors up (half as many below); the generic
# path's warps a block (each with an f32 row of dscale in shared memory,
# beside the staged scale); at most BWD_BLOCKS blocks, so as many partial
# rows of dscale
BWD_THREADS = 256
BWD_ROW_MAX = 4096
BWD_MIN_VECS = 8
BWD_LANE_VECS = 4
BWD_WARPS = 8
BWD_BLOCKS = 256
BWD_SMEM_CAP = 200 * 1024
_OCC_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]


def smem_bytes(knobs: dict, shape: dict, dtype: torch.dtype):
    """Dynamic shared memory of one block: the scale vector staged as f32.
    Pure arithmetic on the values, so the cost model evaluates it on arrays
    of genomes too."""
    return 4 * shape["d"]


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float,
                  block_rows: int) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: one block of ``block_rows``
    rows at a time, sum of squares and normalization in f32."""
    rows, d = x.shape
    y = torch.empty_like(x)
    s = scale.to(torch.float32)
    for r0 in range(0, rows, block_rows):
        xb = x[r0:r0 + block_rows].to(torch.float32)
        ms = (xb * xb).sum(-1, keepdim=True) / d
        y[r0:r0 + block_rows] = (xb * torch.rsqrt(ms + eps) * s).to(x.dtype)
    return y


def rmsnorm_launch(x: torch.Tensor, scale: torch.Tensor, y: torch.Tensor, *,
                   eps: float, block_rows: int, smem: int) -> None:
    """Launch the CUDA kernel on PyTorch's current stream.  The caller has
    checked the arguments (``ops.rmsnorm``)."""
    fn = build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    rows, d = x.shape
    err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
             block_rows, eps, build.DTYPE_CODES[x.dtype],
             build.DTYPE_CODES[scale.dtype], smem,
             build.stream_ptr(x.device))
    build.check("rmsnorm", err, "rmsnorm_fwd")


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      *, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in plain PyTorch, in f32: with
    ``r = rsqrt(mean(x^2) + eps)`` and ``g = dy * scale``, ``dx = r (g - x
    r^2 mean(g x))`` in x's dtype and ``dscale = sum_rows dy x r`` in
    scale's.  x, dy: (rows, d)."""
    d = x.shape[-1]
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    s32 = scale.to(torch.float32)
    r = torch.rsqrt((x32 * x32).sum(-1, keepdim=True) / d + eps)
    c = r * r * ((dy32 * s32 * x32).sum(-1, keepdim=True) / d)
    dx = r * (dy32 * s32 - x32 * c)
    dscale = (dy32 * x32 * r).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd_row_lanes(d: int, dtype: torch.dtype) -> int:
    """Lanes the row path gives a row of ``d`` elements of ``dtype``: its
    16-byte vectors padded up to a power of two (at least
    ``BWD_MIN_VECS``), ``BWD_LANE_VECS`` of them a lane from 128 vectors
    up, half as many below."""
    nv = d // (16 // dtype.itemsize)
    nvmax = BWD_MIN_VECS
    while nvmax < nv:
        nvmax *= 2
    return nvmax // (BWD_LANE_VECS if nvmax >= 128 else BWD_LANE_VECS // 2)


def rmsnorm_bwd_geometry(rows: int, d: int, dtype: torch.dtype,
                         aligned: bool = True) -> dict:
    """The backward kernel's path, threads a block, blocks and dynamic
    shared memory for (rows, d) in ``dtype``, as ``csrc/rmsnorm.cu``
    checks them.  Rows of at most ``BWD_ROW_MAX`` elements, a multiple of
    the 16-byte vector, with x, dy and dx 16-byte ``aligned``, take the row
    path: ``BWD_THREADS`` threads, row groups of ``lanes`` threads, each
    group's f32 row of dscale in shared memory and, for a row over several
    warps, the warps' two sums of two rows.  Others take the generic path:
    as many warps (up to ``BWD_WARPS``) as leave the f32 rows of dscale and
    the scale within ``BWD_SMEM_CAP`` bytes.  Either way enough blocks for
    every row, at most ``BWD_BLOCKS``."""
    if aligned and d % (16 // dtype.itemsize) == 0 and d <= BWD_ROW_MAX:
        lanes = rmsnorm_bwd_row_lanes(d, dtype)
        groups = BWD_THREADS // lanes
        smem = groups * d * 4 + (2 * groups * (lanes // 32) * 8
                                 if lanes > 32 else 0)
        return {"path": "row", "threads": BWD_THREADS, "lanes": lanes,
                "groups": groups, "smem": smem,
                "blocks": max(1, min(BWD_BLOCKS, -(-rows // groups)))}
    warps = max(1, min(BWD_WARPS, BWD_SMEM_CAP // (4 * d) - 1))
    return {"path": "generic", "threads": 32 * warps, "warps": warps,
            "smem": (warps + 1) * d * 4,
            "blocks": max(1, min(BWD_BLOCKS, -(-rows // warps)))}


def rmsnorm_bwd_launch(x, scale, dy, dx, dscale, partial, *, eps: float,
                       geometry: dict) -> None:
    """Launch the backward kernels on PyTorch's current stream: dx and
    dscale from x, scale and dy, ``partial`` ((blocks, d) f32) the
    per-block rows of dscale.  The caller has checked the arguments
    (``ops.rmsnorm_bwd``)."""
    fn = build.function("rmsnorm", "rmsnorm_bwd", _BWD_ARGTYPES)
    rows, d = x.shape
    err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
             dscale.data_ptr(), partial.data_ptr(), rows, d, eps,
             build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[scale.dtype],
             geometry["blocks"], geometry["threads"], geometry["smem"],
             build.stream_ptr(x.device))
    build.check("rmsnorm", err, "rmsnorm_bwd")


def rmsnorm_bwd_occupancy(d: int, dtype: torch.dtype,
                          scale_dtype: torch.dtype) -> int:
    """On the card: blocks of the row path's kernel for rows of ``d``
    elements that fit one SM at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = build.function("rmsnorm", "rmsnorm_bwd_occupancy", _OCC_ARGTYPES)
    out = (ctypes.c_int * 1)()
    build.check("rmsnorm", fn(d, build.DTYPE_CODES[dtype],
                              build.DTYPE_CODES[scale_dtype], out),
                "rmsnorm_bwd_occupancy")
    return out[0]
