"""The port's kernels against the reference's Pallas kernels (interpret mode
on the CPU) on the same numpy inputs.

On CPU tensors the port's wrappers run each CUDA kernel's plain PyTorch
version, so these tests hold that version — same blocking, same f32
accumulators — against the JAX package.  Shapes, dtypes and tolerances are
those of tests/test_kernels.py, cut to a few cases.  The CUDA kernels
themselves are held against the plain versions on the GPU by
``chip_smoke.py`` and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.mamba_scan.ops import mamba_scan as jax_scan
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_scan_ref
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

F32, BF16 = "float32", "bfloat16"
TORCH = {F32: torch.float32, BF16: torch.bfloat16}


def _rand(seed, shape, dtype=F32):
    """Seeded normal values, rounded to ``dtype`` (numpy, so both packages
    see the same bits)."""
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return a.astype(ml_dtypes.bfloat16).astype(np.float32) \
        if dtype == BF16 else a


def _t(a, dtype=F32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TORCH[dtype])


def _j(a, dtype=F32):
    return jnp.asarray(a, jnp.bfloat16 if dtype == BF16 else jnp.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,S,hd,dtype,causal", [
    (1, 1, 128, 64, F32, True),
    (2, 4, 256, 64, BF16, True),
    (2, 1, 128, 32, F32, False),
])
def test_flash_attention_matches_pallas(B, H, S, hd, dtype, causal):
    q, k, v = (_rand(i, (B, H, S, hd), dtype) for i in range(3))
    got = flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                          causal=causal, block_q=64, block_k=64)
    want = jax_flash(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                     causal=causal, block_q=64, block_k=64)
    assert got.dtype == TORCH[dtype] and got.shape == (B, H, S, hd)
    tol = 2e-2 if dtype == BF16 else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_cross_length(causal):
    """Sk != Sq, with the causal mask on absolute positions (no offset)."""
    q = _rand(0, (1, 2, 64, 64))
    k = _rand(1, (1, 2, 256, 64))
    v = _rand(2, (1, 2, 256, 64))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, block_q=64,
                          block_k=64)
    want = jax_attention(_j(q), _j(k), _j(v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("block_q,block_k", [(32, 128), (128, 32), (256, 256)])
def test_flash_attention_blocks_agree_with_oracles(block_q, block_k):
    """Every blocking gives the oracle's answer; the port's oracle is the
    reference's."""
    q, k, v = (_rand(i, (1, 2, 256, 64)) for i in range(3))
    got = flash_attention(_t(q), _t(k), _t(v), block_q=block_q,
                          block_k=block_k)
    ref = attention_ref(_t(q), _t(k), _t(v), causal=True)
    want = jax_attention(_j(q), _j(k), _j(v), causal=True)
    np.testing.assert_allclose(_np(ref), _np(want), atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


def _scan_inputs(Bt, L, D, N, dtype):
    dt = np.logaddexp(np.float32(0), _rand(0, (Bt, L, D)))
    if dtype == BF16:
        dt = dt.astype(ml_dtypes.bfloat16).astype(np.float32)
    return (dt, _rand(1, (Bt, L, D), dtype),
            -np.exp(_rand(2, (D, N)) * np.float32(0.3)),
            _rand(3, (Bt, L, N), dtype), _rand(4, (Bt, L, N), dtype))


@pytest.mark.parametrize("Bt,L,D,N,chunk,dtype", [
    (1, 64, 8, 4, 16, F32),
    (2, 128, 16, 8, 32, BF16),
    (2, 96, 4, 16, 32, F32),
    (1, 64, 40, 32, 16, F32),
    (2, 96, 40, 32, 48, BF16),
])
def test_mamba_scan_matches_pallas(Bt, L, D, N, chunk, dtype):
    dt, x, A, B, C = _scan_inputs(Bt, L, D, N, dtype)
    got = mamba_scan(_t(dt, dtype), _t(x, dtype), _t(A), _t(B, dtype),
                     _t(C, dtype), chunk=chunk)
    want = jax_scan(_j(dt, dtype), _j(x, dtype), _j(A), _j(B, dtype),
                    _j(C, dtype), chunk=chunk)
    assert got.dtype == TORCH[dtype] and got.shape == (Bt, L, D)
    tol = 5e-2 if dtype == BF16 else 1e-4
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


def test_mamba_scan_oracle_matches_reference_oracle():
    dt, x, A, B, C = _scan_inputs(2, 48, 8, 4, F32)
    got = mamba_scan_ref(*(_t(a) for a in (dt, x, A, B, C)))
    want = jax_scan_ref(*(_j(a) for a in (dt, x, A, B, C)))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


def test_mamba_scan_state_carries_across_chunks():
    """A constant decay ~1 accumulates across chunk boundaries; a version
    that reset state per chunk would diverge from the oracle."""
    Bt, L, D, N = 1, 128, 4, 2
    dt = torch.full((Bt, L, D), 0.05)
    x = torch.ones((Bt, L, D))
    A = -torch.full((D, N), 0.01)
    B = torch.ones((Bt, L, N))
    C = torch.ones((Bt, L, N))
    out = mamba_scan(dt, x, A, B, C, chunk=16)
    ref = mamba_scan_ref(dt, x, A, B, C)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4)
    assert float(out[0, -1, 0]) > float(out[0, 15, 0])


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_mamba_scan_plain_version_bit_identical_across_chunk(dtype):
    """``chunk`` only sets how many timesteps a stage holds: the plain
    version's output is the same, bit for bit, at every chunk that divides
    L, as the kernel's is (D 40 is not a multiple of a block's 32
    channels)."""
    L = 48
    args = [_t(a, dt) for a, dt in zip(_scan_inputs(2, L, 40, 16, dtype),
                                         (dtype, dtype, F32, dtype, dtype))]
    outs = {c: mamba_scan(*args, chunk=c) for c in range(1, L + 1)
            if L % c == 0}
    first = outs[L]
    for c, out in outs.items():
        assert torch.equal(out, first), c


@pytest.mark.parametrize("rows,d,dtype", [(128, 64, F32), (256, 512, BF16),
                                          (64, 1024, F32)])
def test_rmsnorm_matches_pallas(rows, d, dtype):
    x = _rand(0, (rows, d), dtype)
    scale = _rand(1, (d,))
    got = rmsnorm(_t(x, dtype), _t(scale), block_rows=64)
    want = jax_rmsnorm(_j(x, dtype), _j(scale), block_rows=64)
    assert got.dtype == TORCH[dtype]
    tol = 3e-2 if dtype == BF16 else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    np.testing.assert_allclose(
        _np(rmsnorm_ref(_t(x, dtype), _t(scale))),
        _np(jax_rmsnorm_ref(_j(x, dtype), _j(scale))), atol=tol)


def test_rmsnorm_flattens_leading_dims():
    x = _t(_rand(0, (2, 32, 64)))
    scale = _t(_rand(1, (64,)))
    out = rmsnorm(x, scale, block_rows=16)
    assert out.shape == x.shape
    np.testing.assert_allclose(_np(out), _np(rmsnorm_ref(x, scale)),
                               atol=1e-5)


def test_cpu_path_counts_no_launch():
    """A launch count rises only where a kernel launches; on the CPU the
    wrappers run the plain versions."""
    before = (rmsnorm.launches, flash_attention.launches,
              mamba_scan.launches)
    rmsnorm(torch.ones(8, 16), torch.ones(16), block_rows=8)
    q = torch.ones(1, 1, 8, 32)
    flash_attention(q, q, q, block_q=8, block_k=8)
    s = torch.ones(1, 8, 4)
    mamba_scan(s, s, -torch.ones(4, 2), torch.ones(1, 8, 2),
               torch.ones(1, 8, 2), chunk=4)
    assert (rmsnorm.launches, flash_attention.launches,
            mamba_scan.launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Tensors without data (meta or fake) take the kernel's path up to
    the launch, so what the kernels do not take is refused there on any
    device (here a dtype); on the CPU, blocks that do not divide their
    dimension are refused."""
    f64 = {"device": "meta", "dtype": torch.float64}
    meta = torch.empty(64, 32, **f64)
    with pytest.raises(ValueError, match="float32"):
        rmsnorm(meta, torch.empty(32, **f64), block_rows=32)
    q = torch.empty(1, 1, 64, 32, **f64)
    with pytest.raises(ValueError, match="float32"):
        flash_attention(q, q, q, block_q=32, block_k=32)
    s = torch.empty(1, 16, 4, **f64)
    with pytest.raises(ValueError, match="float32"):
        mamba_scan(s, s, torch.empty(4, 2, **f64),
                   torch.empty(1, 16, 2, **f64),
                   torch.empty(1, 16, 2, **f64), chunk=8)
    with pytest.raises(ValueError, match="does not divide"):
        rmsnorm(torch.ones(96, 8), torch.ones(8), block_rows=64)
    with pytest.raises(ValueError, match="do not divide"):
        x = torch.ones(1, 1, 96, 32)
        flash_attention(x, x, x, block_q=64, block_k=32)
    with pytest.raises(ValueError, match="does not divide"):
        s = torch.ones(1, 24, 4)
        mamba_scan(s, s, -torch.ones(4, 2), torch.ones(1, 24, 2),
                   torch.ones(1, 24, 2), chunk=16)


@pytest.mark.parametrize("hd,causal", [(8, True), (16, True), (18, False),
                                       (48, True), (80, False)])
def test_flash_padded_head_dim_matches_pallas(hd, causal):
    """On the card a head dim the kernel is not built for runs padded with
    zero columns to the next one it is, at the scale of its own: the plain
    version on such padded inputs, cut back to ``hd``, gives the
    reference's attention at ``hd``."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        HEAD_DIMS, flash_attention_plain, launch_head_dim)
    hd_k = launch_head_dim(hd)
    assert hd_k in HEAD_DIMS and hd_k >= hd
    assert all(d < hd for d in HEAD_DIMS if d < hd_k)
    q, k, v = (_rand(i, (1, 2, 64, hd)) for i in range(3))
    padded = (torch.nn.functional.pad(_t(a), (0, hd_k - hd))
              for a in (q, k, v))
    got = flash_attention_plain(*padded, causal=causal, scale=hd ** -0.5,
                                block_q=32, block_k=32)
    assert not got[..., hd:].any()
    want = jax_attention(_j(q), _j(k), _j(v), causal=causal)
    np.testing.assert_allclose(_np(got[..., :hd]), _np(want), atol=2e-5)
    with pytest.raises(ValueError, match="head dim 129"):
        launch_head_dim(129)


def test_flash_attention_bf16_hd128_block_k_48_matches_pallas():
    """A shape the wgmma path has to handle: head dim 128 (two swizzle
    panels) and block_k 48 (an N of 48 for QK^T, 3 k-steps for PV).  The
    plain version rounds P to bf16 before P V; the Pallas kernel keeps P in
    f32; both within the bf16 tolerance of tests/test_kernels.py."""
    q, k, v = (_rand(i, (1, 2, 192, 128), BF16) for i in range(3))
    got = flash_attention(_t(q, BF16), _t(k, BF16), _t(v, BF16), causal=True,
                          block_q=64, block_k=48)
    want = jax_flash(_j(q, BF16), _j(k, BF16), _j(v, BF16), causal=True,
                     block_q=64, block_k=48)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_bf16_bit_identical_across_block_q(causal):
    """The plain version, like the bf16 kernel, gives one output per
    block_k whatever block_q: a row's arithmetic does not see the block."""
    q, k, v = (_t(_rand(i, (1, 2, 192, 64), BF16), BF16) for i in range(3))
    for block_k in (16, 48, 64):
        outs = [flash_attention(q, k, v, causal=causal, block_q=bq,
                                block_k=block_k)
                for bq in (16, 32, 48, 64, 96, 192)]
        for out in outs[1:]:
            assert torch.equal(outs[0], out), block_k


def test_flash_plain_rounds_p_to_bf16():
    """In bf16 the plain version feeds P V with P rounded to bf16, as the
    tensor cores take it; in f32 P stays f32."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_plain
    q, k, v = (_t(_rand(i, (1, 1, 64, 32), BF16), BF16) for i in range(3))
    got = flash_attention_plain(q, k, v, causal=False, scale=32 ** -0.5,
                                block_q=64, block_k=64)
    s = (q.float() @ k.float().transpose(-1, -2)) * 32 ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    rounded = (p.to(torch.bfloat16).float() @ v.float()) / p.sum(-1)[..., None]
    assert torch.equal(got, rounded.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rmsnorm_plain_bit_identical_across_block_rows(dtype):
    x = _t(_rand(0, (192, 96), dtype), dtype)
    scale = _t(_rand(1, (96,)))
    outs = [rmsnorm(x, scale, block_rows=b) for b in (16, 32, 48, 64, 192)]
    for out in outs[1:]:
        assert torch.equal(outs[0], out)


def test_flash_bf16_shared_memory():
    """The bf16 kernel's footprint (slack, barriers, Q slabs, as many
    stages as fit, at least one) fits a block's shared memory for every
    genome of the joint space at every head dim; the f32 value, which the
    cost model's gate reads, is the two f32 tiles it always was."""
    import importlib
    from repro_torch.kernels import costs
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    assert fa.SMEM_PER_BLOCK == costs.H100.smem_per_block
    from repro_torch.kernels.workloads import joint_space
    space = joint_space()
    for hd in fa.HEAD_DIMS:
        shape = {"B": 1, "H": 1, "S": 768, "hd": hd}
        for bq in space.choices("flash_attention.block_q"):
            for bk in space.choices("flash_attention.block_k"):
                knobs = {"block_q": bq, "block_k": bk}
                used = fa.smem_bytes(knobs, shape, torch.bfloat16)
                q_bytes = -(-bq // 64) * 64 * hd * 2
                stage = 4 * bk * hd
                stages = (used - fa.ALIGN_SLACK - fa.BARRIER_BYTES
                          - q_bytes) / stage
                assert used <= costs.H100.smem_per_block, knobs
                assert stages == int(stages) and \
                    1 <= stages <= fa.MAX_STAGES, knobs
                assert used + stage > costs.H100.smem_per_block or \
                    stages == fa.MAX_STAGES, knobs
                assert fa.smem_bytes(knobs, shape, torch.float32) == \
                    2 * bk * hd * 4


def test_flash_bwd_shared_memory_and_tiles():
    """The backward's footprint, as the C++ side computes it
    (``bwd_bf16_smem_bytes``, ``bwd_f32_smem_bytes``, from the same
    constants): bf16 the slack, the barriers, a block's four own 64-row
    slabs and BWD_STAGES stages of two slabs with their rows' lse and D;
    f32 four f32 tiles of 64 rows of hd + 1, P, dS, lse and D.  Each fits
    a block at every head dim, and the bf16 scratch holds lse and D of
    every row rounded up to a block's rows."""
    import importlib
    import re
    from repro_torch.kernels import build
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    src = (build.CSRC / "flash_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert fa.BWD_TILE == const("kBwdTile") == 64
    assert fa.BWD_STAGES == const("kBwdStages")
    assert fa.BWD_BLOCK == const("kBwdWG") * fa.BWD_TILE == 128
    assert (fa.ALIGN_SLACK, fa.BARRIER_BYTES) == (const("kAlignSlack"),
                                                  const("kBarrierBytes"))
    for hd in fa.HEAD_DIMS:
        slab = 64 * hd * 2
        bf16 = fa.bwd_smem_bytes(hd, torch.bfloat16)
        assert bf16 == 1024 + 128 + 4 * slab \
            + fa.BWD_STAGES * (2 * slab + 2 * 64 * 4)
        f32 = fa.bwd_smem_bytes(hd, torch.float32)
        assert f32 == (4 * 64 * (hd + 1) + 2 * 64 * 65 + 2 * 64) * 4
        assert max(bf16, f32) <= fa.SMEM_PER_BLOCK
    assert fa.bwd_scratch_floats(6, 100, torch.bfloat16) == 2 * 6 * 128
    assert fa.bwd_scratch_floats(6, 256, torch.bfloat16) == 2 * 6 * 256
    assert fa.bwd_scratch_floats(6, 100, torch.float32) == 6 * 100


def _cu_const(source: str, name: str) -> int:
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_geometry_and_shared_memory(n, dtype):
    """The scan backward's geometry and footprint as ``csrc/mamba_scan.cu``
    checks them (``BwdSmem``, ``bwd_blocks``, from the same constants):
    sub-tiles of 32 / states steps, so a thread's states and decays of a
    sub-tile are 2 x 32 registers; a ring of as many stages (six row
    regions and four of B or C, each rounded to 16 bytes) as fit
    BWD_RING_BYTES, 3 to BWD_RING_MAX of them; the f32 dB/dC contributions
    and (g, ga A) pairs of a sub-tile, two sub-tiles of the block's sums,
    BWD_SEG - 1 start states; 2 blocks an SM at the main path's N 16;
    blocks along D in whole clusters."""
    import importlib
    from repro_torch.kernels import costs
    ms = importlib.import_module("repro_torch.kernels.mamba_scan.mamba_scan")
    assert ms.CHANNELS == _cu_const("mamba_scan", "kChannels")
    assert ms.BWD_CLUSTER == _cu_const("mamba_scan", "kBwdCluster")
    assert ms.BWD_RING_BYTES == _cu_const("mamba_scan", "kBwdRingBytes")
    assert ms.BWD_RING_MAX == _cu_const("mamba_scan", "kBwdRingMax")
    assert ms.BWD_SEG == _cu_const("mamba_scan", "kBwdSeg")
    lanes = min(n, 4)
    states = n // lanes
    sub = 32 // states
    es = dtype.itemsize

    def r16(b):
        return -(-b // 16) * 16

    slot = 6 * r16(sub * 32 * es) + 4 * r16(sub * n * es)
    ring = min(max(ms.BWD_RING_BYTES // slot, 3), ms.BWD_RING_MAX)
    want = (ring * slot + sub * 32 * lanes * 2 * states * 4
            + sub * 32 * lanes * 8 + 2 * sub * 2 * n * 4
            + (ms.BWD_SEG - 1) * 32 * lanes * states * 4)
    assert ms.mamba_scan_bwd_ring(n, dtype) == ring >= 3
    assert ms.mamba_scan_bwd_smem(n, dtype) == want
    assert want <= costs.H100.smem_per_block
    if n == 16:
        assert ring == (5 if es == 4 else ms.BWD_RING_MAX)
        assert 2 * (want + 1024) <= 228 * 1024
    for D in (1, 32, 33, 255, 256, 257, 8192):
        geo = ms.mamba_scan_bwd_geometry({"Bt": 2, "L": 64, "D": D, "N": n},
                                         dtype)
        assert geo["sub"] == sub and geo["threads"] == 32 * lanes
        assert geo["blocks"] % ms.BWD_CLUSTER == 0
        assert 0 <= geo["blocks"] * 32 - D < 32 * ms.BWD_CLUSTER
        assert geo["clusters"] == geo["blocks"] // ms.BWD_CLUSTER
        assert geo["smem"] == want and geo["ring"] == ring


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 10, 48, 64, 128, 1000, 1024, 2048, 4096,
                               4100, 5000])
def test_rmsnorm_bwd_geometry_matches_the_kernel(dtype, d):
    """The rmsnorm backward's path, lanes and footprint as
    ``csrc/rmsnorm.cu`` checks them (``row_path``, ``bwd_row_lanes``,
    ``bwd_row_smem``, from the same constants): rows up to BWD_ROW_MAX, a
    multiple of the 16-byte vector and aligned take the row path, whose
    lanes hold every vector of a row at 2 or 4 vectors a lane, so a
    thread's row, scale and dscale stay in registers; groups over a warp
    need a named barrier each (ids 1-15); the rest take the generic path
    within the shared-memory cap."""
    import importlib
    from repro_torch.kernels import costs
    rm = importlib.import_module("repro_torch.kernels.rmsnorm.rmsnorm")
    assert rm.BWD_THREADS == _cu_const("rmsnorm", "kBwdThreads")
    assert rm.BWD_ROW_MAX == _cu_const("rmsnorm", "kBwdRowMax")
    assert rm.BWD_MIN_VECS == _cu_const("rmsnorm", "kBwdMinVecs")
    assert rm.BWD_LANE_VECS == _cu_const("rmsnorm", "kBwdLaneVecs")
    assert rm.BWD_WARPS == _cu_const("rmsnorm", "kBwdMaxWarps")
    vec = 16 // dtype.itemsize
    for aligned in (True, False):
        geo = rm.rmsnorm_bwd_geometry(1000, d, dtype, aligned=aligned)
        assert 1 <= geo["blocks"] <= rm.BWD_BLOCKS
        assert geo["smem"] <= costs.H100.smem_per_block
        if not (aligned and d % vec == 0 and d <= 4096):
            assert geo["path"] == "generic"
            assert geo["threads"] == 32 * geo["warps"] <= 256
            assert geo["smem"] == (geo["warps"] + 1) * d * 4
            continue
        nv = d // vec
        nvmax = 8
        while nvmax < nv:
            nvmax *= 2
        per_lane = 4 if nvmax >= 128 else 2
        lanes = geo["lanes"]
        assert geo["path"] == "row" and geo["threads"] == 256
        assert lanes == nvmax // per_lane == rm.rmsnorm_bwd_row_lanes(d,
                                                                      dtype)
        assert lanes * per_lane * vec >= d and 256 % lanes == 0
        groups = 256 // lanes
        assert geo["groups"] == groups
        assert lanes <= 32 or groups <= 15
        assert geo["smem"] == groups * d * 4 + (
            2 * groups * (lanes // 32) * 8 if lanes > 32 else 0)
        assert geo["blocks"] == min(rm.BWD_BLOCKS, -(-1000 // groups))


def test_flash_bwd_refuses_what_the_kernels_do_not_take():
    """On the card the backward takes a head dim it is built for, o and
    do in q's dtype, an f32 lse, contiguous tensors and, in bf16, 16-byte
    aligned ones (TMA's rule); anything else raises before a launch."""
    from repro_torch.kernels.flash_attention.ops import check_bwd_launch

    def args(hd=64, dtype=torch.bfloat16, S=8):
        t = torch.zeros(1, 2, S, hd, dtype=dtype)
        return [t, t.clone(), t.clone(), t.clone(), t.clone(),
                torch.zeros(1, 2, S)]

    check_bwd_launch(*args())
    check_bwd_launch(*args(hd=32, dtype=torch.float32))
    for hd in (16, 48, 80, 256):
        with pytest.raises(ValueError, match="head dim"):
            check_bwd_launch(*args(hd=hd))
    a = args()
    a[5] = a[5].to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        check_bwd_launch(*a)
    a = args()
    a[4] = a[4].float()
    with pytest.raises(ValueError, match="dtype"):
        check_bwd_launch(*a)
    for i in range(6):
        a = args()
        a[i] = a[i].transpose(-1, -2).contiguous().transpose(-1, -2)
        with pytest.raises(ValueError, match="contiguous"):
            check_bwd_launch(*a)
    for i in range(5):
        a = args()
        flat = torch.zeros(a[i].numel() + 1, dtype=torch.bfloat16)
        a[i] = flat[1:].view(a[i].shape)
        with pytest.raises(ValueError, match="aligned"):
            check_bwd_launch(*a)


def test_library_path_follows_every_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every header under csrc/, so
    changing any header (the Hopper helpers included) rebuilds it rather
    than loading a stale one."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert before == {n: build.library_path(n) for n in build.SOURCES}
    for header in sorted(csrc.glob("*.cuh")):
        text = header.read_text()
        header.write_text(text + "\n// changed\n")
        after = {n: build.library_path(n) for n in build.SOURCES}
        assert all(after[n] != before[n] for n in build.SOURCES), header.name
        header.write_text(text)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(build.library_path(n) != before[n] for n in build.SOURCES)


def test_wgmma_header_is_generated():
    """csrc/wgmma_ops.cuh is what its generator renders, with one wrapper
    per block_k (QK^T) and per head dim (PV) the bf16 kernel takes."""
    from repro_torch.kernels import wgmma_gen
    from repro_torch.kernels.flash_attention.flash_attention import \
        BF16_BLOCK_K, HEAD_DIMS
    assert wgmma_gen.HEADER.read_text() == wgmma_gen.render()
    assert wgmma_gen.SS_SHAPES == BF16_BLOCK_K
    assert wgmma_gen.RS_SHAPES == HEAD_DIMS
    text = wgmma_gen.render()
    for n in BF16_BLOCK_K:
        assert f"m64n{n}k16" in text and f'"+f"(d[{n // 2 - 1}])' in text
