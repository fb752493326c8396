"""Schedule-aware roofline cost model for the hand-written CUDA kernels.

``static`` fitness mode needs a deterministic time estimate that *moves*
with the schedule genome.  The formulas are the reference package's
(``src/repro/kernels/costs.py``), unchanged; every constant they use is a
field of one frozen :class:`DeviceModel` record that is passed in, and the
package ships one record, :data:`H100`.  The terms:

* **HBM traffic under the blocking** — flash attention re-fetches the K/V
  tiles once per *query block*, so ``block_q`` divides the dominant traffic
  term; the fused rmsnorm saves the normalized intermediate's round-trip,
  and an ``unfused`` epilogue puts one back.
* **Per-block overhead** (``grid_step_s``) and **per-timestep latency of an
  in-kernel scan** (``seq_step_s``).
* **Tile padding** of the matrix products (``tile_m`` x ``tile_n``) and a
  separate rate for elementwise work (``vector_flops``).

Re-deriving these terms for the Hopper kernels (blocks run in parallel, not
in sequence; the flash kernel skips masked causal tiles) is ROADMAP work.

The capacity gate asks each kernel module's ``smem_bytes`` — the same
function its wrapper sizes the launch's dynamic shared memory with — and
compares it with the device's shared memory per block, so the gate and the
launch cannot disagree.  Configurations that fail a gate raise
:class:`~repro_torch.core.fitness.InvalidVariant` — the paper's
execute-successfully gate, not an objective.

Array-native core
-----------------
Each model is written ONCE against an explicit ``xp`` module using only
elementwise ops: the scalar API (``schedule_time``) runs it on 0-d numpy
values and raises on gate failures; ``schedule_terms(numpy, ...)`` runs it
on per-lane columns, bit-exact with the scalar API by construction.  Gate
failures surface as a boolean ``valid`` lane mask plus structured ``gates``
that reconstruct the scalar path's messages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.analysis.diagnostics import block_divisibility, smem_capacity
from ..core.fitness import HBM_BW, PEAK_FLOPS, InvalidVariant
from .flash_attention.flash_attention import smem_bytes as _flash_smem
from .mamba_scan.mamba_scan import smem_bytes as _scan_smem
from .rmsnorm.rmsnorm import smem_bytes as _rmsnorm_smem

# the dtype of the search's evaluation inputs (kernels.workloads)
EVAL_DTYPE = torch.float32


@dataclass(frozen=True)
class DeviceModel:
    """Every constant of the cost model, for one device."""

    name: str
    peak_flops: float      # FLOP/s of the matrix products
    hbm_bw: float          # device-memory bytes/s
    vector_flops: float    # FLOP/s of elementwise work
    grid_step_s: float     # seconds a block adds
    seq_step_s: float      # seconds a timestep of an in-kernel scan adds
    smem_per_block: int    # shared-memory bytes one block may use
    tile_m: int            # row padding of a matrix-product tile
    tile_n: int            # column padding of a matrix-product tile
    # the dry run's roofline (launch/roofline.py): bf16 (and fp16)
    # products on the tensor cores, and the bytes/s of one link direction
    # to another card
    tensor_flops: float = PEAK_FLOPS
    link_bw: float = 450e9


# NVIDIA H100 SXM5 80 GB (data sheet; dense rates, no sparsity) — the part
# nvidia-smi reports as "NVIDIA H100 80GB HBM3".  The kernels this model
# ranks run at EVAL_DTYPE, f32, where they compute on the CUDA cores (only
# bf16 flash attention uses the tensor cores), so both rates are the f32
# ones: 67 TFLOP/s counts an FMA as two operations; elementwise
# work issues one operation a lane a cycle, half of that.  HBM3 at
# 3.35 TB/s (``core.fitness.HBM_BW``).  Shared memory: 227 KB (232,448 bytes) a block.  A flash
# block's warp covers 8 query rows, and its products are not padded along
# the keys (tile 8 x 1).  The dry run's rates are data-sheet values too:
# bf16 on the tensor cores 989 TFLOP/s (``core.fitness.PEAK_FLOPS``), f32
# ``peak_flops``, HBM ``hbm_bw``, and NVLink 4 at 900 GB/s a card, 450e9
# bytes/s each way (``link_bw``, where the reference prices its TPU's ICI).
#
# grid_step_s and seq_step_s were measured by the ``overheads`` phase of
# chip_smoke.py on an NVIDIA H100 80GB HBM3 with a 700 W power limit: one
# more block at equal work (rmsnorm, 65536 vs 256 blocks) and one more step
# of the sequential scan (one block, L 4096 vs 256).  Blocks run in
# parallel on the card, so a block costs next to nothing; PERF.md names
# the run of each.
H100 = DeviceModel(
    name="NVIDIA H100 80GB HBM3",
    peak_flops=67e12,
    hbm_bw=HBM_BW,
    vector_flops=33.5e12,
    grid_step_s=1.2990195126108388e-10,
    seq_step_s=4.2166665662080046e-08,
    smem_per_block=232448,
    tile_m=8,
    tile_n=1,
)


def _pad(x, m):
    return -(-x // m) * m


# -- gate bookkeeping ---------------------------------------------------------
# A gate is ("block"|"smem", ok, *message args, knobs) where ``knobs`` names
# the schedule knob(s) the gate constrains.  The scalar wrappers raise on the
# first failed gate; the batched path ANDs the ok lanes into `valid` and
# reconstructs per-lane messages with `gate_message`.  Message text comes
# from ``core.analysis.diagnostics`` — ONE source.

def _block_msg(name, dim, block) -> str:
    return block_divisibility(name, dim, block).message


def _smem_msg(name, used, device: DeviceModel) -> str:
    return smem_capacity(name, used, device.smem_per_block).message


def _block_gate(name, dim, block, knob):
    return ("block", (dim % block) == 0, name, dim, block, (knob,))


def _smem_gate(name, used, knobs, device: DeviceModel):
    return ("smem", used <= device.smem_per_block, name, used, tuple(knobs))


def _raise_failed_gate(gates, device: DeviceModel) -> None:
    """Scalar path: raise InvalidVariant for the first failed gate."""
    for kind, ok, *args in gates:
        if not bool(ok):
            msg = _block_msg(args[0], int(args[1]), int(args[2])) \
                if kind == "block" else _smem_msg(args[0], int(args[1]),
                                                  device)
            raise InvalidVariant(msg)


def gate_message(gates, lane: int, device: DeviceModel = None) -> str | None:
    """The scalar-path InvalidVariant message for one lane of a batched
    gate evaluation, or None when every gate passes there."""
    device = device or H100
    for kind, ok, *args in gates:
        if not bool(np.asarray(ok).reshape(-1)[lane]
                    if np.ndim(ok) else ok):
            if kind == "block":
                name, dim, block = args[:3]
                b = np.asarray(block).reshape(-1)
                return _block_msg(name, int(dim),
                                  int(b[lane] if b.size > 1 else b[0]))
            name, used = args[:2]
            u = np.asarray(used).reshape(-1)
            return _smem_msg(name, int(u[lane] if u.size > 1 else u[0]),
                             device)
    return None


def gates_ok(xp, gates):
    v = True
    for _, ok, *_ in gates:
        v = v & ok if v is not True else ok
    return v


# -- rmsnorm ------------------------------------------------------------------

def _rmsnorm_ref(xp, dev: DeviceModel, *, rows: int, d: int):
    traffic = 4 * (3 * rows * d + 2 * rows + 2 * d)
    return xp.maximum(4 * rows * d / dev.vector_flops, traffic / dev.hbm_bw)


def _rmsnorm_kernel(xp, dev: DeviceModel, block_rows, is_unfused, *,
                    rows: int, d: int):
    block = xp.minimum(block_rows, rows)
    shape = {"rows": rows, "d": d}
    gates = (_block_gate("rmsnorm", rows, block, "block_rows"),
             _smem_gate("rmsnorm",
                        _rmsnorm_smem({"block_rows": block}, shape,
                                      EVAL_DTYPE),
                        ("block_rows",), dev))
    traffic = (4 * (2 * rows * d + d)
               + xp.where(is_unfused, 4 * (2 * rows * d + d), 0))
    steps = rows // block
    t = (xp.maximum(4 * rows * d / dev.vector_flops, traffic / dev.hbm_bw)
         + steps * dev.grid_step_s)
    return t, gates


def rmsnorm_time(genome: dict, *, rows: int, d: int,
                 device: DeviceModel = None) -> float:
    """(rows, d) f32 rows normalized; ``ref`` pays the unfused intermediate
    round-trips, the kernel streams each row block once."""
    dev = device or H100
    if genome["impl"] == "ref":
        return float(_rmsnorm_ref(np, dev, rows=rows, d=d))
    t, gates = _rmsnorm_kernel(np, dev, genome["block_rows"],
                               genome["epilogue"] == "unfused",
                               rows=rows, d=d)
    _raise_failed_gate(gates, dev)
    return float(t)


def rmsnorm_terms(xp, cols: dict, *, rows: int, d: int,
                  device: DeviceModel = None):
    dev = device or H100
    t, gates = _rmsnorm_kernel(xp, dev, cols["block_rows"],
                               cols["is_unfused"], rows=rows, d=d)
    time = xp.where(cols["is_ref"], _rmsnorm_ref(xp, dev, rows=rows, d=d), t)
    valid = cols["is_ref"] | gates_ok(xp, gates)
    return time, valid, gates


# -- flash attention ----------------------------------------------------------

def _flash_ref(xp, dev: DeviceModel, *, B: int, H: int, S: int, hd: int):
    flops = B * H * (4 * S * S * hd + 5 * S * S)
    traffic = 4 * B * H * (4 * S * hd + 4 * S * S)
    return xp.maximum(flops / dev.peak_flops, traffic / dev.hbm_bw)


def _flash_kernel(xp, dev: DeviceModel, block_q, block_k, *, B: int, H: int,
                  S: int, hd: int):
    bq = xp.minimum(block_q, S)
    bk = xp.minimum(block_k, S)
    shape = {"B": B, "H": H, "S": S, "hd": hd}
    gates = (_block_gate("flash_attention q", S, bq, "block_q"),
             _block_gate("flash_attention k", S, bk, "block_k"),
             _smem_gate("flash_attention",
                        _flash_smem({"block_q": bq, "block_k": bk}, shape,
                                    EVAL_DTYPE),
                        ("block_q", "block_k"), dev))
    n_q, n_k = S // bq, S // bk
    pairs = B * H * n_q * n_k
    # each product pads to (tile_m, tile_n) output tiles; contraction unpadded
    mxu = pairs * 2 * _pad(bq, dev.tile_m) * (_pad(bk, dev.tile_n) * hd
                                              + _pad(hd, dev.tile_n) * bk)
    vpu = pairs * 5 * bq * bk                           # softmax bookkeeping
    traffic = 4 * (B * H * 2 * S * hd                   # q in, out
                   + pairs * 2 * bk * hd)               # k/v per (q, k) pair
    t = (xp.maximum(xp.maximum(mxu / dev.peak_flops, vpu / dev.vector_flops),
                    traffic / dev.hbm_bw)
         + pairs * dev.grid_step_s)
    return t, gates


def flash_attention_time(genome: dict, *, B: int, H: int, S: int, hd: int,
                         device: DeviceModel = None) -> float:
    """(B, H, S, hd) f32 self-attention.  ``ref`` materializes the S x S
    scores in HBM; the kernel streams K/V tiles, re-fetching them once per
    query block."""
    dev = device or H100
    if genome["impl"] == "ref":
        return float(_flash_ref(np, dev, B=B, H=H, S=S, hd=hd))
    t, gates = _flash_kernel(np, dev, genome["block_q"], genome["block_k"],
                             B=B, H=H, S=S, hd=hd)
    _raise_failed_gate(gates, dev)
    return float(t)


def flash_attention_terms(xp, cols: dict, *, B: int, H: int, S: int,
                          hd: int, device: DeviceModel = None):
    dev = device or H100
    t, gates = _flash_kernel(xp, dev, cols["block_q"], cols["block_k"],
                             B=B, H=H, S=S, hd=hd)
    time = xp.where(cols["is_ref"], _flash_ref(xp, dev, B=B, H=H, S=S,
                                               hd=hd), t)
    valid = cols["is_ref"] | gates_ok(xp, gates)
    return time, valid, gates


# -- mamba scan ---------------------------------------------------------------

def _mamba_ref(xp, dev: DeviceModel, *, Bt: int, L: int, D: int, N: int):
    elems = Bt * L * D * N
    traffic = 4 * (4 * elems + 3 * Bt * L * D + 2 * Bt * L * N + D * N)
    return (xp.maximum(6 * elems / dev.vector_flops, traffic / dev.hbm_bw)
            + L * dev.seq_step_s)


def _mamba_kernel(xp, dev: DeviceModel, chunk_in, *, Bt: int, L: int,
                  D: int, N: int):
    """The kernel of ``csrc/mamba_scan.cu``: each block walks all L steps
    for its 32 channels with the state in registers (``seq_step_s`` a
    step), staging ``chunk`` timesteps at a time in two shared-memory
    stages (``grid_step_s`` a stage).  The capacity gate is the kernel's own
    ``smem_bytes``: both stages, the f32 tile and two y tiles."""
    elems = Bt * L * D * N
    chunk = xp.minimum(chunk_in, L)
    shape = {"Bt": Bt, "L": L, "D": D, "N": N}
    gates = (_block_gate("mamba_scan", L, chunk, "chunk"),
             _smem_gate("mamba_scan",
                        _scan_smem({"chunk": chunk}, shape, EVAL_DTYPE),
                        ("chunk",), dev))
    traffic = 4 * (3 * Bt * L * D + 2 * Bt * L * N + D * N)
    steps = Bt * (L // chunk)
    t = (xp.maximum(6 * elems / dev.vector_flops, traffic / dev.hbm_bw)
         + steps * dev.grid_step_s + L * dev.seq_step_s)
    return t, gates


def mamba_scan_time(genome: dict, *, Bt: int, L: int, D: int, N: int,
                    device: DeviceModel = None) -> float:
    """(Bt, L, D) selective scan with state (D, N).  ``ref`` materializes
    the (Bt, L, D, N) decay/drive tensors in HBM; the kernel keeps the state
    in registers for the whole sequence and stages ``chunk`` timesteps of
    its inputs at a time."""
    dev = device or H100
    if genome["impl"] == "ref":
        return float(_mamba_ref(np, dev, Bt=Bt, L=L, D=D, N=N))
    t, gates = _mamba_kernel(np, dev, genome["chunk"], Bt=Bt, L=L, D=D, N=N)
    _raise_failed_gate(gates, dev)
    return float(t)


def mamba_scan_terms(xp, cols: dict, *, Bt: int, L: int, D: int, N: int,
                     device: DeviceModel = None):
    dev = device or H100
    t, gates = _mamba_kernel(xp, dev, cols["chunk"], Bt=Bt, L=L, D=D, N=N)
    time = xp.where(cols["is_ref"], _mamba_ref(xp, dev, Bt=Bt, L=L, D=D,
                                               N=N), t)
    valid = cols["is_ref"] | gates_ok(xp, gates)
    return time, valid, gates


_MODELS = {
    "rmsnorm": rmsnorm_time,
    "flash_attention": flash_attention_time,
    "mamba_scan": mamba_scan_time,
}

_TERMS = {
    "rmsnorm": rmsnorm_terms,
    "flash_attention": flash_attention_terms,
    "mamba_scan": mamba_scan_terms,
}

# How a kernel's schedule knobs map onto the cost columns the array models
# consume: (column, knob, flag).  ``flag=None`` passes the knob's numeric
# choice value through; otherwise the column is the boolean ``value == flag``
# (so string knobs never reach the array path as strings).
COL_SPECS: dict[str, tuple[tuple[str, str, object], ...]] = {
    "rmsnorm": (("is_ref", "impl", "ref"),
                ("block_rows", "block_rows", None),
                ("is_unfused", "epilogue", "unfused")),
    "flash_attention": (("is_ref", "impl", "ref"),
                        ("block_q", "block_q", None),
                        ("block_k", "block_k", None)),
    "mamba_scan": (("is_ref", "impl", "ref"),
                   ("chunk", "chunk", None)),
}


def schedule_time(kernel: str, genome: dict, *, device: DeviceModel = None,
                  **shape) -> float:
    """Deterministic roofline-lite time of ``kernel`` under ``genome`` on the
    given shape; raises :class:`InvalidVariant` for un-launchable configs."""
    return _MODELS[kernel](genome, device=device, **shape)


def schedule_terms(xp, kernel: str, cols: dict, *,
                   device: DeviceModel = None, **shape):
    """Batched roofline: ``(time, valid, gates)`` over per-lane cost columns
    (see :data:`COL_SPECS`); with ``xp=numpy`` bit-exact with
    :func:`schedule_time`."""
    return _TERMS[kernel](xp, cols, device=device, **shape)


def schedule_cols(kernel: str, genome: dict) -> dict:
    """The cost columns of one scalar genome, per :data:`COL_SPECS`."""
    return {col: (genome[knob] == flag) if flag is not None else genome[knob]
            for col, knob, flag in COL_SPECS[kernel]}


def schedule_features(kernel: str, genome: dict, *,
                      device: DeviceModel = None, **shape) -> dict:
    """Numeric features of one genome on one shape — the roofline and
    shared-memory counters the launch gates already compute, as a flat
    ``{name: float}`` dict.  Never raises: un-launchable configs report
    ``launchable=0`` instead of :class:`InvalidVariant`."""
    dev = device or H100
    cols = schedule_cols(kernel, genome)
    time, valid, gates = _TERMS[kernel](np, cols, device=dev, **shape)
    used = max((float(np.asarray(a[1]))
                for kind, _, *a in gates if kind == "smem"), default=0.0)
    return {
        "log_static_time": float(np.log(max(float(time), 1e-30))),
        "launchable": float(bool(np.asarray(valid))),
        "is_ref": float(bool(cols.get("is_ref", False))),
        "smem_frac": used / dev.smem_per_block,
    }


def schedule_gates(kernel: str, genome: dict, *,
                   device: DeviceModel = None, **shape):
    """The launch-gate tuples one scalar genome faces on the given shape —
    empty for ``ref`` impls (nothing to launch); same gates, same check
    order, same message args as the scalar :func:`schedule_time` path."""
    if genome.get("impl") == "ref":
        return ()
    _, _, gates = _TERMS[kernel](np, schedule_cols(kernel, genome),
                                 device=device, **shape)
    return gates


# --------------------------------------------------------------------------
# the work of one call of each kernel, forward and backward
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelCost:
    """One call's work: ``operations`` (products of the attention's
    matrices when ``matmul``, else f32 arithmetic on the CUDA cores) and
    ``bytes``, each input read once and each output written once."""
    operations: int
    bytes: int
    matmul: bool


def _es(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs of causal attention, query i seeing keys j <= i."""
    full = min(Sq, Sk)
    return full * (full + 1) // 2 + (Sq - full) * Sk


def rmsnorm_fwd_cost(*, rows: int, d: int, dtype: torch.dtype,
                     scale_dtype: torch.dtype = torch.float32) -> KernelCost:
    """x read, y written, scale read; ~4 operations an element."""
    n = rows * d
    return KernelCost(4 * n, 2 * n * _es(dtype) + d * _es(scale_dtype),
                      False)


def rmsnorm_bwd_cost(*, rows: int, d: int, dtype: torch.dtype,
                     scale_dtype: torch.dtype = torch.float32) -> KernelCost:
    """x and dy read, dx written, scale read and dscale written; ~10
    operations an element."""
    n = rows * d
    return KernelCost(10 * n, 3 * n * _es(dtype) + 2 * d * _es(scale_dtype),
                      False)


def flash_attention_fwd_cost(*, B: int, H: int, S: int, hd: int,
                             dtype: torch.dtype, Sk: int | None = None,
                             causal: bool = True,
                             lse: bool = False) -> KernelCost:
    """q, k, v read, o (and each row's f32 log-sum-exp with ``lse``)
    written; two products of hd a (query, key) pair, over the pairs the
    data needs (the causal half)."""
    Sk = S if Sk is None else Sk
    pairs = B * H * (_causal_pairs(S, Sk) if causal else S * Sk)
    nbytes = 2 * B * H * (S + Sk) * hd * _es(dtype)
    if lse:
        nbytes += B * H * S * 4
    return KernelCost(4 * hd * pairs, nbytes, True)


def flash_attention_bwd_cost(*, B: int, H: int, S: int, hd: int,
                             dtype: torch.dtype, Sk: int | None = None,
                             causal: bool = True) -> KernelCost:
    """q, k, v, o, do and lse read, dq, dk, dv written; the five products
    of FA2's backward, 10 hd a pair."""
    Sk = S if Sk is None else Sk
    pairs = B * H * (_causal_pairs(S, Sk) if causal else S * Sk)
    return KernelCost(10 * hd * pairs,
                      4 * B * H * (S + Sk) * hd * _es(dtype) + B * H * S * 4,
                      True)


def mamba_scan_fwd_cost(*, Bt: int, L: int, D: int, N: int,
                        dtype: torch.dtype, state: bool = False,
                        h_chunks: int = 0) -> KernelCost:
    """dt, x, B, C and A (f32) read, y written, and the f32 states: the
    last one with ``state``, ``h_chunks`` tile starts; ~6 operations an
    element of the state."""
    es = _es(dtype)
    nbytes = 3 * Bt * L * D * es + D * N * 4 + 2 * Bt * L * N * es
    nbytes += (int(state) + h_chunks) * Bt * D * N * 4
    return KernelCost(6 * Bt * L * D * N, nbytes, False)


def mamba_scan_bwd_cost(*, Bt: int, L: int, D: int, N: int,
                        dtype: torch.dtype, chunk: int,
                        dh_last: bool = True) -> KernelCost:
    """dt, x, dy, B, C, A and the tile-start states (and the last state's
    gradient with ``dh_last``) read, ddt, dx, dB, dC and dA written; ~13
    operations an element of the state."""
    es = _es(dtype)
    nbytes = (5 * Bt * L * D * es + 4 * Bt * L * N * es + 2 * D * N * 4
              + Bt * (L // chunk + int(dh_last)) * D * N * 4)
    return KernelCost(13 * Bt * L * D * N, nbytes, False)

