"""Forward flash attention: the hand-written CUDA kernel
(``csrc/flash_attention.cu``), its shared-memory size, and its plain
PyTorch version.

The kernel replaces the Pallas TPU kernel of
``src/repro/kernels/flash_attention/flash_attention.py``
(``_flash_kernel``): blockwise online softmax, so the (S x S) score matrix
is never materialized in HBM.  A CUDA block owns ``block_q`` query rows of
one (batch, head) and sweeps the keys in ``block_k`` tiles staged in shared
memory; the running max, denominator and accumulator are f32.  In bf16 the
products run on the tensor cores (``wgmma``) with K/V tiles brought by TMA
into a ring of stages, and P is rounded to bf16 before P V; in f32 they run
on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # the head dims the kernel is instantiated for
MAX_BLOCK_Q = 256           # f32: 4 threads a row; bf16: 4 slabs of 64 rows
# the block_k the bf16 kernel is instantiated for (an N of wgmma each)
BF16_BLOCK_K = (16, 32, 48, 64, 128, 192, 256)

# The bf16 kernel's shared memory (csrc/flash_attention.cu holds the same
# numbers): 1024 bytes of slack to align the swizzled buffers, 128 for the
# mbarriers, the Q slabs of 64 rows, and as many K/V stages as fit a
# block's shared memory on the H100 (232,448 bytes, kernels.costs.H100),
# at least one and at most MAX_STAGES.
SMEM_PER_BLOCK = 232448
ALIGN_SLACK = 1024
BARRIER_BYTES = 128
MAX_STAGES = 4

def launch_head_dim(hd: int) -> int:
    """The head dim the kernel runs a head dim of ``hd`` at: the smallest
    of ``HEAD_DIMS`` at least ``hd``.  Zero columns appended to q, k and v
    add nothing to q.k and give zero output columns, so the wrapper pads
    to it, keeps the scale of ``hd`` and drops the padding of the output.
    Above the largest it raises."""
    for d in HEAD_DIMS:
        if d >= hd:
            return d
    raise ValueError(f"flash_attention: head dim {hd} above {HEAD_DIMS[-1]}")


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def smem_bytes(knobs: dict, shape: dict, dtype: torch.dtype):
    """Dynamic shared memory of one block.  f32: one K and one V tile of
    ``block_k`` rows -- pure arithmetic on the values, so the cost model
    (which gates at f32) evaluates it on arrays of genomes too.  bf16: the
    slack, the barriers, ``ceil(block_q / 64)`` Q slabs of 64 rows and the
    stages of one K and one V tile each (scalar knobs)."""
    hd = shape["hd"]
    if dtype != torch.bfloat16:
        return 2 * knobs["block_k"] * hd * dtype.itemsize
    q_bytes = -(-knobs["block_q"] // 64) * 64 * hd * 2
    stage = 2 * knobs["block_k"] * hd * 2
    fixed = ALIGN_SLACK + BARRIER_BYTES + q_bytes
    stages = min(MAX_STAGES, max(1, (SMEM_PER_BLOCK - fixed) // stage))
    return fixed + stages * stage


def flash_attention_plain(q, k, v, *, causal: bool, scale: float,
                          block_q: int, block_k: int) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: for each block of
    ``block_q`` query rows, an online softmax over ``block_k`` key tiles in
    f32, skipping the causal tiles that lie wholly above the diagonal.  For
    bf16 inputs P is rounded to bf16 before P V, as the tensor cores take
    it (its row sum stays f32)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    round_p = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    for q0 in range(0, Sq, block_q):
        qb = q[:, :, q0:q0 + block_q].to(torch.float32)
        qpos = torch.arange(q0, q0 + block_q, device=q.device)
        m = torch.full((B, H, block_q), NEG_INF, device=q.device)
        l = torch.zeros((B, H, block_q), device=q.device)
        acc = torch.zeros((B, H, block_q, hd), device=q.device)
        n_tiles = Sk // block_k
        if causal:
            n_tiles = min(n_tiles, (q0 + block_q - 1) // block_k + 1)
        for t in range(n_tiles):
            k0 = t * block_k
            s = (qb @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + block_k, device=q.device)
                s = torch.where(kpos[None, :] <= qpos[:, None], s,
                                torch.tensor(NEG_INF, device=q.device))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = alpha * l + p.sum(-1)
            if round_p:
                p = p.to(torch.bfloat16).to(torch.float32)
            acc = acc * alpha[..., None] + p @ vf[:, :, k0:k0 + block_k]
            m = m_new
        denom = torch.clamp(l, min=1e-30)
        out[:, :, q0:q0 + block_q] = (acc / denom[..., None]).to(q.dtype)
    return out


def flash_attention_launch(q, k, v, o, *, causal: bool, scale: float,
                           block_q: int, block_k: int, smem: int) -> None:
    """Launch the CUDA kernel on PyTorch's current stream.  The caller has
    checked the arguments (``ops.flash_attention``)."""
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    B, H, Sq, hd = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H,
             Sq, k.shape[2], hd, block_q, block_k, scale, int(causal),
             build.DTYPE_CODES[q.dtype], smem, build.stream_ptr(q.device))
    build.check("flash_attention", err, "flash_attention_fwd")
