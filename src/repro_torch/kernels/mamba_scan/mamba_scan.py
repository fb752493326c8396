"""Mamba-1 selective scan: the hand-written CUDA kernel
(``csrc/mamba_scan.cu``), its launch geometry and shared-memory size, and
its plain PyTorch version.

The kernel replaces the Pallas TPU kernel of
``src/repro/kernels/mamba_scan/mamba_scan.py`` (``_scan_kernel``).  It
computes ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t . h_t``
with the (D, N) state in f32, forming the decay and drive in registers so
the (Bt, L, D, N) tensors never reach HBM; on request it also writes the
state after the last step (``h_last``, (Bt, D, N) f32), which a model's
prefill hands to its decode cache.  A block carries 32 channels
through the whole sequence, each channel's states split over ``min(N, 4)``
lanes; ``chunk`` timesteps of dt/x/B/C are staged in shared memory at a
time, in two stages so the next tile loads while this one is scanned.  On
request it also writes the state at the start of every such tile
(``h_chunks``), from which the backward kernel (``mamba_scan_bwd`` in the
same source) recomputes each tile's states as it walks time backward: a
sub-tile at a time, its inputs staged by ``cp.async`` in a ring, its
states recomputed once into registers, its dB and dC summed over a block's
channels once and over a cluster of ``BWD_CLUSTER`` blocks through
distributed shared memory (``mamba_scan_bwd_geometry``,
``mamba_scan_bwd_smem``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

CHANNELS = 32   # channels a block
MAX_LANES = 4   # lanes a channel
# the backward kernel's kBwdCluster, kBwdRingBytes, kBwdRingMax, kBwdSeg
# (csrc/mamba_scan.cu)
BWD_CLUSTER = 2          # blocks a cluster, whose dB and dC rows are summed
BWD_RING_BYTES = 40960   # the cp.async ring's bytes, at most,
BWD_RING_MAX = 10        # and its stages, 3 to BWD_RING_MAX of them
BWD_SEG = 8              # sub-tiles a segment (its start states kept: 7)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [
    ctypes.c_void_p]
_OCC_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def geometry(shape: dict) -> dict:
    """The kernel's launch geometry for ``shape`` (Bt, L, D, N): lanes a
    channel and states a lane (together N), channels and threads a block,
    and the grid (blocks over D, then Bt).  ``csrc/mamba_scan.cu`` refuses
    a launch whose lanes or channels differ from its own rule."""
    n = shape["N"]
    lanes = min(n, MAX_LANES)
    return {"lanes": lanes, "states": n // lanes, "channels": CHANNELS,
            "threads": CHANNELS * lanes,
            "grid": (-(-shape["D"] // CHANNELS), shape["Bt"])}


def _round16(nbytes):
    return -(-nbytes // 16) * 16


def smem_bytes(knobs: dict, shape: dict, dtype: torch.dtype):
    """Dynamic shared memory of one block: two stages of ``chunk``
    timesteps of dt and x for the block's channels and of B and C, in the
    inputs' dtype; the tile converted to f32 ((dt, dt x) pairs, B, C); and
    two tiles of y in the output dtype.  Each region is rounded up to 16
    bytes.  Pure arithmetic on the values, so the cost model evaluates it on
    arrays of genomes too."""
    chunk, n, esize = knobs["chunk"], shape["N"], dtype.itemsize
    rows = _round16(chunk * CHANNELS * esize)
    bc = _round16(chunk * n * esize)
    return (2 * (2 * rows + 2 * bc) + 8 * chunk * CHANNELS
            + 2 * _round16(4 * chunk * n) + 2 * rows)


def mamba_scan_bwd_geometry(shape: dict, dtype: torch.dtype) -> dict:
    """The backward kernel's geometry for ``shape`` (Bt, L, D, N): the
    forward's lanes, states and threads; ``sub`` steps a sub-tile (32 /
    states, so a thread's sub-tile of states and decays is 2 x 32
    registers); blocks along D (every channel covered, whole clusters of
    ``BWD_CLUSTER``), the clusters (one f32 partial row of dB and dC each)
    and the dynamic shared memory.  ``csrc/mamba_scan.cu`` refuses a launch
    whose blocks or shared memory differ from its own."""
    geo = geometry(shape)
    blocks = -(-geo["grid"][0] // BWD_CLUSTER) * BWD_CLUSTER
    return {**geo, "sub": 32 // geo["states"], "blocks": blocks,
            "clusters": blocks // BWD_CLUSTER,
            "ring": mamba_scan_bwd_ring(shape["N"], dtype),
            "smem": mamba_scan_bwd_smem(shape["N"], dtype)}


def mamba_scan_bwd_ring(n: int, dtype: torch.dtype) -> int:
    """Stages of the backward's ring for state size ``n``: as many
    stages (six row regions of a sub-tile for the block's channels and
    four of its B or C rows, each rounded up to 16 bytes: dt, x, dy, B, C
    of two sub-tiles walked back, or dt, x, B of three sub-tiles of the
    pass from a tile's start) as fit ``BWD_RING_BYTES``, 3 to
    ``BWD_RING_MAX``."""
    sub = 32 // (n // min(n, MAX_LANES))
    slot = (6 * _round16(sub * CHANNELS * dtype.itemsize)
            + 4 * _round16(sub * n * dtype.itemsize))
    return min(max(BWD_RING_BYTES // slot, 3), BWD_RING_MAX)


def mamba_scan_bwd_smem(n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one backward block for state size ``n``,
    as ``BwdSmem`` in ``csrc/mamba_scan.cu`` lays it out: the ring's
    stages of one sub-tile (``mamba_scan_bwd_ring``); the sub-tile's
    per-thread dB and dC contributions and (g, ga A) pairs, f32; the
    block's channel sums of dB and dC for two sub-tiles; the segment's
    sub-tile start states."""
    lanes = min(n, MAX_LANES)
    sub = 32 // (n // lanes)
    esize = dtype.itemsize
    rows = _round16(sub * CHANNELS * esize)
    bc = _round16(sub * n * esize)
    return (mamba_scan_bwd_ring(n, dtype) * (6 * rows + 4 * bc)
            + sub * CHANNELS * 2 * n * 4
            + sub * CHANNELS * lanes * 8 + 2 * sub * 2 * n * 4
            + (BWD_SEG - 1) * CHANNELS * n * 4)


def mamba_scan_plain(dt, x, A, B, C, *, chunk: int,
                     return_state: bool = False,
                     return_chunks: bool = False):
    """The kernel's algorithm in plain PyTorch: ``chunk`` timesteps staged
    as f32 at a time, then scanned one step after another with the (D, N)
    state in f32; the decay is ``exp2(dt * (A log2 e))``, as the kernel
    forms it.  With ``return_state``, also the state after the last step;
    with ``return_chunks`` (after it), the (Bt, L / chunk, D, N) states at
    the start of each tile."""
    Bt, L, D = x.shape
    y = torch.empty_like(x)
    A2 = A.to(torch.float32) * 1.4426950408889634
    h = torch.zeros((Bt, D, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    starts = []
    for t0 in range(0, L, chunk):
        starts.append(h)
        dts = dt[:, t0:t0 + chunk].to(torch.float32)
        dtx = dts * x[:, t0:t0 + chunk].to(torch.float32)
        Bs = B[:, t0:t0 + chunk].to(torch.float32)
        Cs = C[:, t0:t0 + chunk].to(torch.float32)
        ys = torch.empty((Bt, chunk, D), dtype=torch.float32,
                         device=x.device)
        for t in range(chunk):
            decay = torch.exp2(dts[:, t, :, None] * A2)
            h = decay * h + dtx[:, t, :, None] * Bs[:, t, None, :]
            ys[:, t] = (h * Cs[:, t, None, :]).sum(-1)
        y[:, t0:t0 + chunk] = ys.to(x.dtype)
    out = (y, h) if return_state else (y,)
    if return_chunks:
        out += (torch.stack(starts, 1),)
    return out if len(out) > 1 else y


def mamba_scan_bwd_plain(dt, x, A, B, C, dy, h_chunks, dh_last=None, *,
                         chunk: int):
    """The backward kernel's arithmetic in plain PyTorch, in f32: for each
    tile of ``chunk`` steps, last first, its states are recomputed from
    ``h_chunks`` as the forward forms them, then time is walked backward
    carrying dh (``dh_last``, or 0, after the last step):
    dh += dy_t C_t; dC_t = sum_d dy_t h_t; dB_t = sum_d dh dt_t x_t;
    g = sum_n dh B_t; ga = dh h_{t-1} a_t; ddt_t = g x_t + sum_n ga A;
    dx_t = g dt_t; dA += sum_b ga dt_t; dh = a_t dh.  Returns (ddt, dx,
    dA, dB, dC): ddt, dx, dB, dC in the inputs' dtype, dA f32."""
    Bt, L, D = x.shape
    f32 = torch.float32
    A32 = A.to(f32)
    A2 = A32 * 1.4426950408889634
    dh = (torch.zeros((Bt, D, A.shape[1]), dtype=f32, device=x.device)
          if dh_last is None else dh_last.to(f32).clone())
    ddt, dx = (torch.empty((Bt, L, D), dtype=f32, device=x.device)
               for _ in range(2))
    dB, dC = (torch.empty((Bt, L, A.shape[1]), dtype=f32, device=x.device)
              for _ in range(2))
    dA = torch.zeros_like(A32)
    for k in reversed(range(L // chunk)):
        t0 = k * chunk
        dts = dt[:, t0:t0 + chunk].to(f32)
        xs = x[:, t0:t0 + chunk].to(f32)
        dtx = dts * xs
        Bs = B[:, t0:t0 + chunk].to(f32)
        Cs = C[:, t0:t0 + chunk].to(f32)
        dys = dy[:, t0:t0 + chunk].to(f32)
        hs, decays = [h_chunks[:, k]], []
        for t in range(chunk):
            decays.append(torch.exp2(dts[:, t, :, None] * A2))
            hs.append(decays[-1] * hs[-1]
                      + dtx[:, t, :, None] * Bs[:, t, None, :])
        for t in reversed(range(chunk)):
            dC[:, t0 + t] = (dys[:, t, :, None] * hs[t + 1]).sum(1)
            dh = dh + dys[:, t, :, None] * Cs[:, t, None, :]
            dB[:, t0 + t] = (dh * dtx[:, t, :, None]).sum(1)
            g = (dh * Bs[:, t, None, :]).sum(-1)
            ga = dh * hs[t] * decays[t]
            ddt[:, t0 + t] = g * xs[:, t] + (ga * A32).sum(-1)
            dx[:, t0 + t] = g * dts[:, t]
            dA += (ga * dts[:, t, :, None]).sum(0)
            dh = dh * decays[t]
    return (ddt.to(dt.dtype), dx.to(x.dtype), dA, dB.to(B.dtype),
            dC.to(C.dtype))


def mamba_scan_launch(dt, x, A, B, C, y, h_last, *, chunk: int,
                      smem: int, h_chunks=None) -> None:
    """Launch the CUDA kernel on PyTorch's current stream; ``h_last`` (a
    (Bt, D, N) f32 tensor, or None) receives the final state, ``h_chunks``
    (a (Bt, L / chunk, D, N) f32 tensor, or None) the state at each tile's
    start.  The caller has checked the arguments (``ops.mamba_scan``)."""
    fn = build.function("mamba_scan", "mamba_scan_fwd", _ARGTYPES)
    Bt, L, D = x.shape
    N = A.shape[1]
    geo = geometry({"Bt": Bt, "L": L, "D": D, "N": N})
    err = fn(dt.data_ptr(), x.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(),
             None if h_last is None else h_last.data_ptr(),
             None if h_chunks is None else h_chunks.data_ptr(), Bt, L, D, N,
             chunk, build.DTYPE_CODES[x.dtype], geo["lanes"],
             geo["channels"], smem, build.stream_ptr(x.device))
    build.check("mamba_scan", err, "mamba_scan_fwd")


def bwd_scratch(x, N: int) -> tuple:
    """The f32 scratch a backward call on ``x`` (Bt, L, D) with state size
    ``N`` allocates: dA a batch row, dB and dC a cluster of blocks."""
    Bt, L, D = x.shape
    geo = mamba_scan_bwd_geometry({"Bt": Bt, "L": L, "D": D, "N": N},
                                  x.dtype)
    f32 = {"dtype": torch.float32, "device": x.device}
    dB_part = torch.empty((Bt, geo["clusters"], L, N), **f32)
    return (torch.empty((Bt, D, N), **f32), dB_part,
            torch.empty_like(dB_part))


def mamba_scan_bwd_launch(dt, x, A, B, C, dy, dh_last, h_chunks, ddt, dx,
                          dA, dB, dC, *, chunk: int) -> None:
    """Launch the backward kernels on PyTorch's current stream, with their
    f32 scratch (dA a batch row, dB and dC a cluster of blocks).  The
    caller has checked the arguments (``ops.mamba_scan_bwd``)."""
    fn = build.function("mamba_scan", "mamba_scan_bwd", _BWD_ARGTYPES)
    Bt, L, D = x.shape
    N = A.shape[1]
    geo = mamba_scan_bwd_geometry({"Bt": Bt, "L": L, "D": D, "N": N},
                                  x.dtype)
    dA_part, dB_part, dC_part = bwd_scratch(x, N)
    err = fn(dt.data_ptr(), x.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), dy.data_ptr(),
             None if dh_last is None else dh_last.data_ptr(),
             h_chunks.data_ptr(), ddt.data_ptr(), dx.data_ptr(),
             dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA_part.data_ptr(),
             dB_part.data_ptr(), dC_part.data_ptr(), Bt, L, D, N, chunk,
             build.DTYPE_CODES[x.dtype], geo["lanes"], geo["channels"],
             geo["blocks"], geo["smem"], build.stream_ptr(x.device))
    build.check("mamba_scan", err, "mamba_scan_bwd")


def mamba_scan_bwd_occupancy(n: int, dtype: torch.dtype) -> dict:
    """On the card: backward blocks for state size ``n`` that fit one SM
    at once, and clusters of ``BWD_CLUSTER`` that fit the card at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    ``cudaOccupancyMaxActiveClusters``)."""
    fn = build.function("mamba_scan", "mamba_scan_bwd_occupancy",
                        _OCC_ARGTYPES)
    out = (ctypes.c_int * 2)()
    build.check("mamba_scan", fn(n, build.DTYPE_CODES[dtype], out),
                "mamba_scan_bwd_occupancy")
    return {"blocks_per_sm": out[0], "clusters": out[1]}
