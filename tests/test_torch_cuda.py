"""The CUDA kernels on the card: each against its plain PyTorch version
over every genome of its schedule space (and bf16 flash over the joint
space's blocks at head dims 32, 64 and 128), outputs bit-identical across
the knobs that only partition rows, tensor-core instructions in the built
flash library, launch counting, and refused launches.  Marked ``cuda``;
they skip on hosts without a GPU.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
"""

import itertools

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import workloads as wl
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_plain
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_plain
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_plain

pytestmark = pytest.mark.cuda

# absolute f32 tolerances of tests/test_kernels.py
TOL = {"rmsnorm": 1e-5, "flash_attention": 2e-5, "mamba_scan": 1e-4}
# bf16: the plain version's tolerance, plus one rounding step of bf16
# (relative 2**-7), as chip_smoke.py holds it
BF16_ATOL, BF16_RTOL = 2e-2, 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _pairs(kernel, genome, i):
    """(kernel output, plain output) under one genome."""
    if kernel == "rmsnorm":
        br = genome["block_rows"]
        return (rmsnorm(i["x"], i["scale"], block_rows=br),
                rmsnorm_plain(i["x"], i["scale"], eps=1e-6, block_rows=br))
    if kernel == "flash_attention":
        bq, bk = genome["block_q"], genome["block_k"]
        return (flash_attention(i["q"], i["k"], i["v"], block_q=bq,
                                block_k=bk),
                flash_attention_plain(i["q"], i["k"], i["v"], causal=True,
                                      scale=i["q"].shape[-1] ** -0.5,
                                      block_q=bq, block_k=bk))
    args = (i["dt"], i["x"], i["A"], i["B"], i["C"])
    return (mamba_scan(*args, chunk=genome["chunk"]),
            mamba_scan_plain(*args, chunk=genome["chunk"]))


@pytest.mark.parametrize("kernel", wl.KERNELS)
def test_kernel_matches_plain_version_over_its_space(cuda, kernel):
    space = wl.kernel_space(kernel)
    inputs = wl.inputs_from_numpy(kernel, wl.numpy_inputs(kernel, 0), cuda)
    names = space.names()
    for values in itertools.product(*(space.choices(n) for n in names)):
        genome = dict(zip(names, values))
        if genome["impl"] != "pallas":
            continue
        got, want = _pairs(kernel, genome, inputs)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= TOL[kernel], genome


@pytest.mark.parametrize("block_q", (32, 64, 128, 256))
def test_flash_head_dim_128_matches_plain_version(cuda, block_q):
    """Head dim 128 (the search shapes have 64), f32, every block_k of the
    space whose K/V tiles fit a block's shared memory; block_q 256 is the
    kernel's 1024-thread instantiation."""
    from repro_torch.kernels.costs import H100
    from repro_torch.kernels.flash_attention.flash_attention import \
        smem_bytes
    shape = {"B": 1, "H": 2, "S": 512, "hd": 128}
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(tuple(shape.values()), generator=g, device=cuda)
               for _ in range(3))
    space = wl.kernel_space("flash_attention")
    assert block_q in space.choices("block_q")
    fits = [bk for bk in space.choices("block_k")
            if smem_bytes({"block_q": block_q, "block_k": bk}, shape,
                          torch.float32) <= H100.smem_per_block]
    assert fits
    for bk in fits:
        got, want = _pairs("flash_attention",
                           {"block_q": block_q, "block_k": bk},
                           {"q": q, "k": k, "v": v})
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= TOL["flash_attention"], bk


@pytest.mark.parametrize("d,dtype", [(30, torch.float32),
                                     (1026, torch.bfloat16)])
def test_rmsnorm_rows_not_a_multiple_of_four(cuda, d, dtype):
    """Widths that rule out the 4-wide loads take the kernel's scalar
    path; it computes the same function."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, d, generator=g, device=cuda).to(dtype)
    scale = torch.randn(d, generator=g, device=cuda)
    got = rmsnorm(x, scale, block_rows=16)
    want = rmsnorm_plain(x, scale, eps=1e-6, block_rows=16)
    torch.cuda.synchronize()
    # bf16: one rounding step of the output (2**-7 relative) besides atol
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               atol=3e-2 if bf16 else 1e-5,
                               rtol=2.0 ** -7 if bf16 else 0.0)


def test_launches_are_counted_on_the_card(cuda):
    x = torch.randn(64, 32, device=cuda)
    before = rmsnorm.launches
    rmsnorm(x, torch.ones(32, device=cuda), block_rows=16)
    assert rmsnorm.launches == before + 1


def test_refused_launch_raises(cuda):
    """More shared memory than a block may have: the runtime refuses the
    launch and the wrapper raises — it never falls back."""
    q = torch.randn(1, 1, 1024, 128, device=cuda)
    with pytest.raises(build.KernelLaunchError):
        flash_attention(q, q, q, block_q=128, block_k=512)


def test_refused_launch_leaves_the_next_one_unharmed(cuda):
    """The refusal is not reported again by the launch after it."""
    q = torch.randn(1, 1, 1024, 128, device=cuda)
    with pytest.raises(build.KernelLaunchError):
        flash_attention(q, q, q, block_q=128, block_k=512)
    qb = q.to(torch.bfloat16)
    got = flash_attention(qb, qb, qb, block_q=128, block_k=128)
    want = flash_attention_plain(qb, qb, qb, causal=True, scale=128 ** -0.5,
                                 block_q=128, block_k=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=BF16_RTOL)


@pytest.mark.parametrize("S,hd", [(256, 64), (512, 128), (384, 32), (384, 64),
                                  (384, 128)])
def test_flash_bf16_over_the_joint_blocks(cuda, S, hd):
    """bf16 flash (the wgmma kernel) over every block_q x block_k of the
    joint space that divides S: each genome within the bf16 tolerance of
    its plain version, and one output per block_k, bit for bit, whatever
    block_q.  S = 384 is where block_k 48 and 192 divide."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 2, S, hd, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    space = wl.joint_space()
    bqs = [b for b in space.choices("flash_attention.block_q") if S % b == 0]
    bks = [b for b in space.choices("flash_attention.block_k") if S % b == 0]
    for bk in bks:
        outs = []
        for bq in bqs:
            got, want = _pairs("flash_attention",
                               {"block_q": bq, "block_k": bk},
                               {"q": q, "k": k, "v": v})
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=BF16_ATOL, rtol=BF16_RTOL,
                                       msg=f"block_q {bq}, block_k {bk}")
            outs.append(got)
        for bq, out in zip(bqs[1:], outs[1:]):
            assert torch.equal(outs[0], out), (bq, bk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bit_identical_across_block_rows(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    for rows, d in ((512, 512), (2048, 1024), (256, 30)):
        x = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
        scale = torch.randn(d, generator=g, device=cuda)
        brs = [b for b in wl.joint_space().choices("rmsnorm.block_rows")
               if rows % b == 0]
        outs = [rmsnorm(x, scale, block_rows=b) for b in brs]
        torch.cuda.synchronize()
        for b, out in zip(brs[1:], outs[1:]):
            assert torch.equal(outs[0], out), (rows, d, b)


def test_flash_library_runs_on_the_tensor_cores(cuda):
    """The built flash library holds HGMMA (wgmma) instructions."""
    import re
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    build.build(("flash_attention",))
    sass = subprocess.run([tool, "-sass",
                           str(build.library_path("flash_attention"))],
                          check=True, capture_output=True, text=True).stdout
    assert re.search(r"\bHGMMA\.", sass)


def _scan_inputs(device, Bt, L, D, N, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    seq = (Bt, L, D)
    dt = torch.nn.functional.softplus(
        torch.randn(seq, generator=g, device=device))
    return (dt.to(dtype), torch.randn(seq, generator=g, device=device)
            .to(dtype),
            -torch.exp(0.3 * torch.randn((D, N), generator=g, device=device)),
            torch.randn((Bt, L, N), generator=g, device=device).to(dtype),
            torch.randn((Bt, L, N), generator=g, device=device).to(dtype))


def _assert_scan_close(got, want, dtype):
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= TOL["mamba_scan"]
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                                   rtol=BF16_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("D", [40, 30])
def test_scan_ragged_channels_and_state_sizes(cuda, D, N, dtype):
    """Every state size the kernel takes, Bt 2, D not a multiple of a
    block's 32 channels (40: the 16-byte copies with a zero-filled edge;
    30: rows that rule 16-byte copies out), chunk 12 (a remainder after
    the unrolled steps; at N 1 in bf16 B and C tiles that rule 16-byte
    copies out), against the plain version."""
    args = _scan_inputs(cuda, 2, 96, D, N, dtype)
    _assert_scan_close(mamba_scan(*args, chunk=12),
                       mamba_scan_plain(*args, chunk=12), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_state_carried_through_64_tiles(cuda, dtype):
    args = _scan_inputs(cuda, 1, 4096, 64, 16, dtype)
    _assert_scan_close(mamba_scan(*args, chunk=64),
                       mamba_scan_plain(*args, chunk=64), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bit_identical_across_chunk(cuda, dtype):
    """Every chunk of the joint space that divides L gives one output, bit
    for bit, and two calls give the same bits."""
    args = _scan_inputs(cuda, 2, 384, 40, 16, dtype)
    chunks = [c for c in wl.joint_space().choices("mamba_scan.chunk")
              if 384 % c == 0]
    assert 12 in chunks and 48 in chunks
    outs = [mamba_scan(*args, chunk=c) for c in chunks]
    again = mamba_scan(*args, chunk=chunks[0])
    torch.cuda.synchronize()
    for c, out in zip(chunks[1:], outs[1:]):
        assert torch.equal(outs[0], out), c
    assert torch.equal(outs[0], again)


def test_scan_unaligned_inputs(cuda):
    """Contiguous views that start 4 bytes past an aligned address take
    the plain load-and-store path and give the aligned inputs' output."""
    args = _scan_inputs(cuda, 1, 64, 64, 16, torch.float32)
    shifted = []
    for a in args:
        buf = torch.empty(a.numel() + 1, device=cuda)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        shifted.append(view)
    assert shifted[1].data_ptr() % 16 != 0
    got = mamba_scan(*shifted, chunk=16)
    want = mamba_scan(*args, chunk=16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
