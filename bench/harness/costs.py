"""The yardstick of the kernels' rooflines: one call's operations and
bytes, and the card's published peaks.

Frozen copy of the counts of ``src/repro_torch/kernels/costs.py``
(``KernelCost``, ``_causal_pairs`` and the six ``*_fwd_cost`` /
``*_bwd_cost`` functions, as of commit 11d5fcd), so that a later change
to the port's counts cannot move the benchmark's.  Each input is read once
and each output written once; attention counts the (query, key) pairs the
data needs, the causal half.  The peaks are NVIDIA's data sheet for the
H100 SXM5 80 GB (dense rates, no sparsity; ``kernels/costs.py`` ``H100``
and ``core/fitness.py`` ``PEAK_FLOPS``/``HBM_BW``), at its 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM5 80 GB, data sheet
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 / fp16, dense
PEAK_F32_FLOPS = 67e12       # CUDA cores, an FMA as two operations
HBM_BYTES_PER_S = 3.35e12

_SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclass(frozen=True)
class KernelCost:
    """One call's work: ``operations`` (products of the attention's
    matrices when ``matmul``, else f32 arithmetic on the CUDA cores) and
    ``bytes``."""
    operations: int
    bytes: int
    matmul: bool
    dtype: str = "float32"

    def least_s(self) -> float:
        """The least time the card could take: the larger of the
        operations at their peak and the bytes at the memory's."""
        rate = PEAK_BF16_FLOPS if self.matmul and self.dtype in (
            "bfloat16", "float16") else PEAK_F32_FLOPS
        return max(self.operations / rate, self.bytes / HBM_BYTES_PER_S)


def _causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs of causal attention, query i seeing keys j <= i."""
    full = min(Sq, Sk)
    return full * (full + 1) // 2 + (Sq - full) * Sk


def rmsnorm_fwd_cost(*, rows: int, d: int, dtype: str,
                     scale_dtype: str = "float32") -> KernelCost:
    """x read, y written, scale read; ~4 operations an element."""
    n = rows * d
    return KernelCost(4 * n, 2 * n * _SIZE[dtype] + d * _SIZE[scale_dtype],
                      False, dtype)


def rmsnorm_bwd_cost(*, rows: int, d: int, dtype: str,
                     scale_dtype: str = "float32") -> KernelCost:
    """x and dy read, dx written, scale read and dscale written; ~10
    operations an element."""
    n = rows * d
    return KernelCost(10 * n, 3 * n * _SIZE[dtype]
                      + 2 * d * _SIZE[scale_dtype], False, dtype)


def flash_attention_fwd_cost(*, B: int, H: int, S: int, hd: int, dtype: str,
                             Sk: int | None = None, causal: bool = True,
                             lse: bool = False) -> KernelCost:
    """q, k, v read, o (and each row's f32 log-sum-exp with ``lse``)
    written; two products of hd a (query, key) pair, over the pairs the
    data needs."""
    Sk = S if Sk is None else Sk
    pairs = B * H * (_causal_pairs(S, Sk) if causal else S * Sk)
    nbytes = 2 * B * H * (S + Sk) * hd * _SIZE[dtype]
    if lse:
        nbytes += B * H * S * 4
    return KernelCost(4 * hd * pairs, nbytes, True, dtype)


def flash_attention_bwd_cost(*, B: int, H: int, S: int, hd: int, dtype: str,
                             Sk: int | None = None,
                             causal: bool = True) -> KernelCost:
    """q, k, v, o, do and lse read, dq, dk, dv written; the five products
    of FA2's backward, 10 hd a pair."""
    Sk = S if Sk is None else Sk
    pairs = B * H * (_causal_pairs(S, Sk) if causal else S * Sk)
    return KernelCost(10 * hd * pairs,
                      4 * B * H * (S + Sk) * hd * _SIZE[dtype] + B * H * S * 4,
                      True, dtype)


def mamba_scan_fwd_cost(*, Bt: int, L: int, D: int, N: int, dtype: str,
                        state: bool = False,
                        h_chunks: int = 0) -> KernelCost:
    """dt, x, B, C and A (f32) read, y written, and the f32 states: the
    last one with ``state``, ``h_chunks`` tile starts; ~6 operations an
    element of the state."""
    es = _SIZE[dtype]
    nbytes = 3 * Bt * L * D * es + D * N * 4 + 2 * Bt * L * N * es
    nbytes += (int(state) + h_chunks) * Bt * D * N * 4
    return KernelCost(6 * Bt * L * D * N, nbytes, False, dtype)


def mamba_scan_bwd_cost(*, Bt: int, L: int, D: int, N: int, dtype: str,
                        chunk: int, dh_last: bool = True) -> KernelCost:
    """dt, x, dy, B, C, A and the tile-start states (and the last state's
    gradient with ``dh_last``) read, ddt, dx, dB, dC and dA written; ~13
    operations an element of the state."""
    es = _SIZE[dtype]
    nbytes = (5 * Bt * L * D * es + 4 * Bt * L * N * es + 2 * D * N * 4
              + Bt * (L // chunk + int(dh_last)) * D * N * 4)
    return KernelCost(13 * Bt * L * D * N, nbytes, False, dtype)


COSTS = {("rmsnorm", "fwd"): rmsnorm_fwd_cost,
         ("rmsnorm", "bwd"): rmsnorm_bwd_cost,
         ("flash_attention", "fwd"): flash_attention_fwd_cost,
         ("flash_attention", "bwd"): flash_attention_bwd_cost,
         ("mamba_scan", "fwd"): mamba_scan_fwd_cost,
         ("mamba_scan", "bwd"): mamba_scan_bwd_cost}


def cost(kernel: str, direction: str, shape: dict) -> KernelCost:
    return COSTS[(kernel, direction)](**shape)
