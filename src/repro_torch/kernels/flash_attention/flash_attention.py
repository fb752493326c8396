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
on the CUDA cores.  On request the forward also writes each row's
log-sum-exp of its scaled scores, from which the backward kernels
(``flash_attention_bwd`` in the same source) recompute the probabilities:
in bf16 two passes on the tensor cores (dK/dV, then dQ), in f32 the CUDA
cores.
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


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
# The backward kernels' tiles (csrc/flash_attention.cu holds the same
# numbers).  f32: 64-row query and key tiles.  bf16: a block owns BWD_BLOCK
# rows (keys in the dK/dV pass, query rows in the dQ pass), one consumer
# warpgroup per 64, and walks the other side in BWD_TILE-row tiles through
# a ring of BWD_STAGES stages.
BWD_TILE = 64
BWD_BLOCK = 128
BWD_STAGES = 3


def bwd_smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a backward block (``bwd_bf16_smem_bytes``
    and ``bwd_f32_smem_bytes`` in ``csrc/flash_attention.cu``).  bf16: the
    alignment slack, the barriers, the block's own four 64-row bf16 slabs
    (K and V, or Q and dO), and BWD_STAGES stages of two slabs with their
    rows' lse and D.  f32: Q, dO, K and V tiles of 64 rows as f32 rows of
    hd + 1, P and dS (64 x 65 f32), and the tile's lse and D."""
    t = BWD_TILE
    if dtype == torch.bfloat16:
        slab = t * hd * 2
        return (ALIGN_SLACK + BARRIER_BYTES + 4 * slab
                + BWD_STAGES * (2 * slab + 2 * t * 4))
    return (4 * t * (hd + 1) + 2 * t * (t + 1) + 2 * t) * 4


def bwd_scratch_floats(bh: int, Sq: int, dtype: torch.dtype) -> int:
    """f32 scratch of a backward call: D of every row (f32); bf16: lse *
    log2(e) and D of every row, each (bh, Sq rounded up to BWD_BLOCK)."""
    if dtype == torch.bfloat16:
        return 2 * bh * (-(-Sq // BWD_BLOCK) * BWD_BLOCK)
    return bh * Sq


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
                          block_q: int, block_k: int,
                          return_lse: bool = False):
    """The kernel's algorithm in plain PyTorch: for each block of
    ``block_q`` query rows, an online softmax over ``block_k`` key tiles in
    f32, skipping the causal tiles that lie wholly above the diagonal.  For
    bf16 inputs P is rounded to bf16 before P V, as the tensor cores take
    it (its row sum stays f32).  With ``return_lse``, also each row's
    log-sum-exp of its scaled scores, (B, H, Sq) f32."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    round_p = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
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
        lse[:, :, q0:q0 + block_q] = m + torch.log(l)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool,
                              scale: float):
    """The backward kernels' arithmetic in plain PyTorch, in f32: D =
    rowsum(dO o O); for each 64-row query tile against every key, P =
    exp(scale Q K^T - lse) (0 where masked), dS = P (dO V^T - D), then
    dQ = scale dS K, dK += scale dS^T Q, dV += P^T dO.  Returns (dq, dk,
    dv) in q's dtype.  The bf16 kernels round P and dS to bf16 before the
    products that take them, as the tensor cores do; this version keeps
    them in f32, the reference the kernels are held to."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    f32 = torch.float32
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    delta = (dof * o.to(f32)).sum(-1)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    kpos = torch.arange(Sk, device=q.device)
    for q0 in range(0, Sq, BWD_TILE):
        q1 = min(q0 + BWD_TILE, Sq)
        s = qf[:, :, q0:q1] @ kf.transpose(-1, -2)
        p = torch.exp(s * scale - lse[:, :, q0:q1, None])
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)
            p = torch.where(kpos[None, :] <= qpos[:, None], p,
                            torch.zeros((), device=q.device))
        dp = dof[:, :, q0:q1] @ vf.transpose(-1, -2)
        ds = p * (dp - delta[:, :, q0:q1, None])
        dq[:, :, q0:q1] = (ds @ kf) * scale
        dk += (ds.transpose(-1, -2) @ qf[:, :, q0:q1]) * scale
        dv += p.transpose(-1, -2) @ dof[:, :, q0:q1]
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def bwd_scratch(q) -> torch.Tensor:
    """The f32 scratch a backward call on ``q``'s shape allocates."""
    B, H, Sq, _ = q.shape
    return torch.empty(bwd_scratch_floats(B * H, Sq, q.dtype),
                       dtype=torch.float32, device=q.device)


def flash_attention_launch(q, k, v, o, *, causal: bool, scale: float,
                           block_q: int, block_k: int, smem: int,
                           lse=None) -> None:
    """Launch the CUDA kernel on PyTorch's current stream; ``lse`` (a (B,
    H, Sq) f32 tensor, or None) receives each row's log-sum-exp.  The
    caller has checked the arguments (``ops.flash_attention``)."""
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    B, H, Sq, hd = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(), B * H, Sq, k.shape[2],
             hd, block_q, block_k, scale, int(causal),
             build.DTYPE_CODES[q.dtype], smem, build.stream_ptr(q.device))
    build.check("flash_attention", err, "flash_attention_fwd")


def flash_attention_bwd_launch(q, k, v, o, do, lse, dq, dk, dv, *,
                               causal: bool, scale: float) -> None:
    """Launch the backward kernels on PyTorch's current stream (the rows'
    D, and in bf16 their lse in base 2, into a scratch tensor, then the
    dK/dV pass and the dQ pass).  The caller has checked the
    arguments (``ops.flash_attention_bwd``)."""
    fn = build.function("flash_attention", "flash_attention_bwd",
                        _BWD_ARGTYPES)
    B, H, Sq, hd = q.shape
    scratch = bwd_scratch(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, Sq,
             k.shape[2], hd, scale, int(causal), build.DTYPE_CODES[q.dtype],
             bwd_smem_bytes(hd, q.dtype), build.stream_ptr(q.device))
    build.check("flash_attention", err, "flash_attention_bwd")
