"""The CUDA kernels on the card: each against its plain PyTorch version
over every genome of its schedule space (and bf16 flash over the joint
space's blocks at head dims 32, 64 and 128), outputs bit-identical across
the knobs that only partition rows, tensor-core instructions in the built
flash library, launch counting, and refused launches.  The IR interpreter
on the card: every opcode and SAME padding against the interpreter on the
CPU, full f32 (no TF32), bit-identical repeats, pretraining that repeats,
and one unmutated evaluation of each IR workload.  The measured fitness's
CUDA graphs: every opcode's replay against its eager call, IR programs and
mutants through ``ProgramGraph``, a kernel variant's measured time against
its profiler time, and a capture failure as a ``DeviceFault``.  Marked
``cuda``; they skip on hosts without a GPU.  On a machine with one:

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


@pytest.mark.parametrize("hd,dtype", [(16, torch.float32),
                                      (18, torch.bfloat16),
                                      (80, torch.float32)])
def test_flash_padded_head_dim_matches_plain_version(cuda, hd, dtype):
    """A head dim the kernel is not built for (the smoke configs' 16 and
    18, hubert's 80) runs padded to the next one it is: one launch, the
    plain version's answer at ``hd``."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, 4, 64, hd), generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, block_q=32, block_k=32)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=True, scale=hd ** -0.5,
                                 block_q=32, block_k=32)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.is_contiguous()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= TOL["flash_attention"]
    else:
        excess = ((got.float() - want.float()).abs()
                  - BF16_RTOL * want.float().abs()).max().item()
        assert excess <= BF16_ATOL


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


# --------------------------------------------------------------------------
# the IR interpreter on the card
# --------------------------------------------------------------------------

_IR_DTYPES = ("f32", "bf16", "i32", "bool")
# two operands per dtype, special values included (bool and bf16 are
# converted from the float rows on the CPU)
_IR_FLOATS = ([1.5, -2.0, 0.0, -0.0, float("nan"), float("inf"), 3.0e10,
               0.375], [0.5, 2.0, 0.0, 3.0, 1.0, float("-inf"), -7.0, 2.5],
              [4.0, -1.0, 0.5, 2.0, -3.0, 1.0, 0.0, -0.25])
_IR_INTS = ([3, -2, 0, 7, -2 ** 31, 2 ** 31 - 1, 16842753, 1],
            [2, -3, 0, -1, 1, 2, 3, 5], [1, 0, -4, 9, 2, -7, 0, 3])
# ops whose float result must equal the CPU's bit for bit; the others
# (transcendentals, reductions, dot, conv, avg_pool) are held to relative
# 1e-5 in f32 and one bf16 step (2**-7) in bf16
_IR_EXACT = {"add", "subtract", "multiply", "divide", "maximum", "minimum",
             "negate", "abs", "sign", "select", "compare", "convert",
             "reshape", "transpose", "broadcast_in_dim", "pad", "slice",
             "reduce_max", "max_pool"}


def _ir_operand(slot, dtype):
    from repro_torch.core.interp import convert
    if dtype == "i32":
        return torch.tensor(_IR_INTS[slot], dtype=torch.int32)
    return convert(torch.tensor(_IR_FLOATS[slot]), dtype)


def _ir_cases():
    pairs = list(itertools.product(_IR_DTYPES, _IR_DTYPES))
    for op in ("add", "subtract", "multiply", "divide", "maximum", "minimum",
               "power"):
        for a, b in pairs:
            yield op, (a, b), {}
    for op in ("exponential", "log", "negate", "tanh", "rsqrt", "abs",
               "sign"):
        for a in _IR_DTYPES:
            yield op, (a,), {}
    for a, b in pairs:
        yield "compare", (a, b), {"direction": "LT"}
        yield "convert", (a,), {"new_dtype": b}
    for a in _IR_DTYPES:
        yield "select", ("bool", a, a), {}
        for dims in ((0,), ()):
            yield "reduce_sum", (a,), {"dims": dims}
            yield "reduce_max", (a,), {"dims": dims}
        yield "pad", (a,), {"low": (-1,), "high": (3,), "value": 1.5}


def _ir_operands(opcode, dtypes, device):
    xs = [_ir_operand(i, d).to(device) for i, d in enumerate(dtypes)]
    if opcode in ("reduce_sum", "reduce_max"):
        return [x.reshape(2, 4) for x in xs]
    return xs


def _ir_check(got, want, exact):
    assert got.dtype == want.dtype and got.shape == want.shape
    got = got.cpu()
    if exact or got.dtype in (torch.int32, torch.bool):
        assert torch.equal(torch.isnan(got.float()),
                           torch.isnan(want.float()))
        ok = ~torch.isnan(want.float())
        assert torch.equal(got[ok], want[ok])
    else:
        rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=0.0, equal_nan=True)


@pytest.mark.parametrize("opcode,dtypes,attrs", list(_ir_cases()),
                         ids=[f"{o}-{'-'.join(d)}-{i}" for i, (o, d, _)
                              in enumerate(_ir_cases())])
def test_interp_op_on_the_card_matches_the_cpu(cuda, opcode, dtypes, attrs):
    """Every opcode over the IR's dtypes and the mixed ones variants make:
    the same verdict, dtype and result as the interpreter on the CPU."""
    from repro_torch.core.interp import eval_op
    try:
        want = eval_op(opcode, _ir_operands(opcode, dtypes, "cpu"), attrs)
    except Exception:
        with pytest.raises(Exception):
            eval_op(opcode, _ir_operands(opcode, dtypes, cuda), attrs)
        return
    got = eval_op(opcode, _ir_operands(opcode, dtypes, cuda), attrs)
    torch.cuda.synchronize()
    _ir_check(got, want, opcode in _IR_EXACT)


@pytest.mark.parametrize("dtype", _IR_DTYPES)
def test_interp_structured_ops_on_the_card(cuda, dtype):
    """dot_general, conv (grouped), the pools and the data movers."""
    from repro_torch.core.interp import TORCH_DTYPE, eval_op
    g = torch.Generator().manual_seed(0)
    t = TORCH_DTYPE[dtype]

    def ints(*shape):
        return torch.randint(-2, 3, shape, generator=g).to(t)

    cases = [
        ("dot", [ints(2, 3, 4, 5), ints(5, 2, 6, 3)],
         {"dims": (((3, 1), (0, 3)), ((0,), (1,)))}),
        ("conv", [ints(2, 7, 8, 4), ints(3, 3, 2, 4)],
         {"strides": (2, 1), "padding": "SAME", "feature_group_count": 2}),
        ("max_pool", [ints(2, 7, 8, 4)],
         {"window": (3, 2), "strides": (2, 2), "padding": "SAME"}),
        ("avg_pool", [ints(2, 7, 8, 4)],
         {"window": (3, 2), "strides": (2, 2), "padding": "SAME"}),
        ("slice", [ints(4, 6)],
         {"start": (1, 0), "limit": (4, 6), "strides": (2, 4)}),
        ("transpose", [ints(2, 3, 4)], {"permutation": (2, 0, 1)}),
        ("broadcast_in_dim", [ints(3, 1)],
         {"shape": (2, 3, 4), "broadcast_dimensions": (1, 2)}),
    ]
    for opcode, xs, attrs in cases:
        try:
            want = eval_op(opcode, xs, attrs)
        except TypeError:       # avg_pool of bool, as the reference
            with pytest.raises(TypeError):
                eval_op(opcode, [x.to(cuda) for x in xs], attrs)
            continue
        got = eval_op(opcode, [x.to(cuda) for x in xs], attrs)
        torch.cuda.synchronize()
        _ir_check(got, want, opcode not in ("dot", "conv", "avg_pool"))


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_interp_same_padding_on_the_card(cuda, size, stride):
    """XLA's SAME padding, asymmetric at stride 2, for full and depthwise
    convs and both pools: the card against the CPU, relative 1e-5."""
    from repro_torch.core.interp import eval_op
    g = torch.Generator().manual_seed(size * stride)
    x = torch.randn(2, size, size, 8, generator=g)
    for w, groups in ((torch.randn(3, 3, 8, 8, generator=g), 1),
                      (torch.randn(3, 3, 1, 8, generator=g), 8)):
        attrs = {"strides": (stride, stride), "padding": "SAME",
                 "feature_group_count": groups}
        want = eval_op("conv", [x, w], attrs)
        got = eval_op("conv", [x.to(cuda), w.to(cuda)], attrs)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for kind in ("max_pool", "avg_pool"):
        attrs = {"window": (3, 3), "strides": (stride, stride),
                 "padding": "SAME"}
        want = eval_op(kind, [x], attrs)
        got = eval_op(kind, [x.to(cuda)], attrs)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def test_interp_runs_f32_without_tf32(cuda):
    """A 1024-deep dot and a 3x3x256 conv in f32 on the card stay within
    1e-5 (relative to the largest output) of float64: TF32 would be off
    by about 1e-3.  The caller's TF32 settings come back after the call."""
    from repro_torch.core.interp import conv, eval_op, full_f32
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(256, 1024, generator=g), torch.randn(1024, 256,
                                                            generator=g)
    x, w = torch.randn(4, 16, 16, 256, generator=g), \
        torch.randn(3, 3, 256, 64, generator=g)
    cudnn = torch.backends.cudnn
    saved = cudnn.conv.fp32_precision
    try:
        cudnn.conv.fp32_precision = "tf32"
        got = eval_op("dot", [a.to(cuda), b.to(cuda)],
                      {"dims": (((1,), (0,)), ((), ()))}).cpu().double()
        want = a.double() @ b.double()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        with full_f32():
            want = conv(x.double(), w.double(), (1, 1), "SAME", 1)
        got = eval_op("conv", [x.to(cuda), w.to(cuda)], {}).cpu().double()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        assert cudnn.conv.fp32_precision == "tf32"
    finally:
        cudnn.conv.fp32_precision = saved


def _ir_workloads(device):
    from repro_torch.workloads.mobilenet import \
        build_mobilenet_prediction_workload
    from repro_torch.workloads.tinyformer import \
        build_tinyformer_prediction_workload
    from repro_torch.workloads.twofc import build_twofc_training_workload
    return {
        "twofc": build_twofc_training_workload(
            hidden=64, steps=80, n_train=2048, n_test=1024, device=device),
        "mobilenet": build_mobilenet_prediction_workload(n_eval=512,
                                                         device=device),
        "tinyformer": build_tinyformer_prediction_workload(
            n_eval=512, n_pretrain=2048, steps=400, device=device),
    }


def test_ir_programs_repeat_bit_for_bit_on_the_card(cuda):
    """Two runs of each workload's program on the card give the same bits
    (the fitness cache and --resume rely on it), and agree with the CPU
    within relative 1e-4."""
    from repro_torch.core.interp import jit_program
    import numpy as np
    ws = _ir_workloads(cuda)
    tw = ws["twofc"]
    inputs = {"twofc": {**tw.init_weights, "x": tw.train_x[:32],
                        "y_onehot": np.eye(10, dtype=np.float32)[
                            tw.train_y[:32]]},
              "mobilenet": {"images": ws["mobilenet"].images[:64]},
              "tinyformer": {"images": ws["tinyformer"].images[:64]}}
    for name, w in ws.items():
        fn = jit_program(w.program, cuda)
        first, second = fn(inputs[name]), fn(inputs[name])
        cpu = jit_program(w.program, "cpu")(inputs[name])
        torch.cuda.synchronize()
        for a, b, c in zip(first, second, cpu):
            assert torch.equal(a, b), name
            torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-5)


def test_pretraining_repeats_on_the_card(cuda):
    """MobileNet pretraining on the card gives the same weights twice, so
    a rebuilt workload (a resumed search, a spawned worker) bakes the same
    program."""
    from repro_torch.workloads import mobilenet
    from repro_torch.workloads.datasets import cifar10_train_head
    x, y = cifar10_train_head(256)
    params = mobilenet.init_mobilenet(alpha=0.25)
    a = mobilenet.pretrain(params, x, y, epochs=1, batch=64, device=cuda)
    b = mobilenet.pretrain(params, x, y, epochs=1, batch=64, device=cuda)
    for k in a:
        if isinstance(a[k], dict):
            for kk in a[k]:
                assert (a[k][kk] == b[k][kk]).all(), (k, kk)
        else:
            assert (a[k] == b[k]).all(), k


def test_one_unmutated_evaluation_of_each_ir_workload(cuda):
    """Each IR workload evaluates its own program on the card (static and
    measured time), with an error well under chance (0.9, 0.9 and 0.75;
    on the CPU these sizes give about 0.65, 0.03-0.07 and 0.63), and, for
    the prediction workloads, the same static time as on the CPU and an
    error within 1/n of it for the same program."""
    from repro_torch.core.fitness import PredictionWorkload
    ws = _ir_workloads(cuda)
    bound = {"twofc": 0.8, "mobilenet": 0.5, "tinyformer": 0.72}
    for name, w in ws.items():
        t, e = w.evaluate(w.program)
        assert t > 0 and 0.0 <= e < bound[name], (name, t, e)
        w.time_mode = "measured"
        tm, em = w.evaluate(w.program)
        assert 0 < tm and em == e, (name, tm, em)
        if isinstance(w, PredictionWorkload):
            host = PredictionWorkload(w.name, w.program, w.images, w.labels,
                                      batch=w.batch, device="cpu")
            th, eh = host.evaluate(host.program)
            assert th == t and abs(eh - e) <= 1 / len(w.images) + 1e-12


def test_ir_search_in_spawned_workers_on_the_card(cuda):
    """Two spawned workers, each with its own CUDA context, rebuild the
    2fcNet workload from its WorkloadSpec; in static mode the search equals
    the serial one."""
    from repro_torch.core.evaluator import ParallelEvaluator
    from repro_torch.core.search import GevoML
    from repro_torch.workloads.twofc import build_twofc_training_workload
    w = build_twofc_training_workload(hidden=64, steps=40, n_train=1024,
                                      n_test=512)
    assert dict(w.spec.kwargs)["device"] == "cuda"
    kw = dict(pop_size=4, n_elite=2, seed=0, operators="all")
    serial = GevoML(w, **kw).run(generations=2)
    with ParallelEvaluator(w, n_workers=2) as ev:
        par = GevoML(w, evaluator=ev, **kw).run(generations=2)
    assert [i.fitness for i in par.population] == \
        [i.fitness for i in serial.population]


def test_ir_cli_runs_on_the_card(cuda, capsys):
    from repro_torch.workloads import __main__ as cli
    cli.main(["--workload", "twofc", "--time-mode", "measured",
              "--generations", "1", "--pop", "4"])
    out = capsys.readouterr().out
    assert "on cuda" in out and "Pareto front" in out


# --------------------------------------------------------------------------
# the measured fitness's CUDA graphs
# --------------------------------------------------------------------------

def _bits(t):
    """``t``'s bits, so NaNs compare equal to themselves."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.view(view[t.dtype]) if t.dtype in view else t


@pytest.mark.parametrize("opcode,dtypes,attrs", list(_ir_cases()),
                         ids=[f"{o}-{'-'.join(d)}-{i}" for i, (o, d, _)
                              in enumerate(_ir_cases())])
def test_interp_op_graph_replay_equals_eager(cuda, opcode, dtypes, attrs):
    """Every opcode over the IR's dtypes captures as a CUDA graph, and a
    replay gives the eager call's bits; an op that raises eagerly raises
    at the graph's eager run, before any capture."""
    from repro_torch.core.interp import eval_op
    from repro_torch.device import CudaGraph
    xs = _ir_operands(opcode, dtypes, cuda)
    graph = CudaGraph(cuda)
    try:
        try:
            want = eval_op(opcode, xs, attrs)
        except Exception as e:
            with pytest.raises(type(e)):
                graph.eager(lambda: eval_op(opcode, xs, attrs))
            return
        graph.eager(lambda: eval_op(opcode, xs, attrs))
        got = graph.capture(lambda: eval_op(opcode, xs, attrs))
        graph.replay()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))
    finally:
        graph.release()


def test_ir_programs_graph_replay_equals_eager(cuda):
    """Each IR workload's program and seeded mutants of it, run through
    ProgramGraph on the card: the same verdict as the eager interpreter and,
    replay after replay, the eager outputs bit for bit."""
    import numpy as np
    from repro_torch.core.edits import (EditError, OperatorWeights, Patch,
                                        sample_edit)
    from repro_torch.core.interp import ProgramGraph, jit_program
    ws = _ir_workloads(cuda)
    tw = ws["twofc"]
    inputs = {"twofc": {**tw.init_weights, "x": tw.train_x[:32],
                        "y_onehot": np.eye(10, dtype=np.float32)[
                            tw.train_y[:32]]},
              "mobilenet": {"images": ws["mobilenet"].images[:64]},
              "tinyformer": {"images": ws["tinyformer"].images[:64]}}
    rng = np.random.default_rng(0)
    weights = OperatorWeights.parse("all")
    for name, w in ws.items():
        progs = [w.program]
        while len(progs) < 9:
            try:
                progs.append(Patch((sample_edit(w.program, rng, weights),))
                             .apply(w.program))
            except EditError:
                continue
        for prog in progs:
            try:
                want = jit_program(prog, cuda)(inputs[name])
            except Exception as e:
                with pytest.raises(type(e)):
                    with ProgramGraph(prog, cuda) as g:
                        g.load(inputs[name])
                        g.run()
                continue
            with ProgramGraph(prog, cuda) as g:
                g.load(inputs[name])
                for _ in range(2):
                    got = g.run()
                    torch.cuda.synchronize()
                    for a, b in zip(got, want, strict=True):
                        assert torch.equal(_bits(a), _bits(b)), name


# The measured time of a kernel variant is GRAPH_CALLS calls in one graph,
# divided by GRAPH_CALLS: the kernel's own time plus the gap between
# consecutive kernel nodes of a graph.  The profiler reads the kernel alone.
KERNEL_NAMES = {"rmsnorm": "rmsnorm_", "flash_attention": "flash_",
                "mamba_scan": "scan_kernel"}
GRAPH_TIME_TOL = 0.5


@pytest.mark.parametrize("kernel", wl.KERNELS)
def test_measured_kernel_time_is_its_graphs_device_time(cuda, kernel):
    """The measured fitness of a kernel's default schedule at the search
    shapes is within GRAPH_TIME_TOL (relative) of the kernel's device time
    per call that torch.profiler reads over the same evaluation, and every
    replay adds its launches to the wrapper's count."""
    from torch.profiler import ProfilerActivity, profile
    counter = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
               "mamba_scan": mamba_scan}[kernel]
    w = wl.build_kernel_workload(kernel, time_mode="measured")
    w.evaluate(w.program)            # builds and loads the library
    before = counter.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t, _ = w.evaluate(w.program)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and KERNEL_NAMES[kernel] in e.name]
    # one eager call for the error, then for each of the
    # MEASURED_CAPTURES graphs GRAPH_CALLS eager calls before its capture,
    # 2 warm-up and 5 timed replays of GRAPH_CALLS calls (the profiler may
    # drop the first event of a window)
    calls = wl.GRAPH_CALLS * 8 * wl.MEASURED_CAPTURES
    assert counter.launches - before == 1 + calls
    assert calls <= len(spans) <= 1 + calls
    kernel_s = sorted(spans)[len(spans) // 2] * 1e-6
    assert abs(t - kernel_s) <= GRAPH_TIME_TOL * kernel_s, (t, kernel_s)


def test_capture_failure_is_a_device_fault(cuda, monkeypatch):
    """An op that runs eagerly but cannot be captured (here: one that reads
    a value back to the host) stops the evaluation as a DeviceFault; it is
    never an invalid variant.  The card works afterwards."""
    import numpy as np
    from repro_torch.core import interp
    from repro_torch.core.builder import Builder
    from repro_torch.core.edits import Patch
    from repro_torch.core.evaluator import SerialEvaluator
    from repro_torch.core.fitness import DeviceFault, PredictionWorkload
    monkeypatch.setitem(interp._OPS, "negate",
                        lambda xs, a: -xs[0] * float(xs[0].abs().max() > -1))
    b = Builder("syncs")
    b.output(b.op("negate", [b.input("images", (4, 3))]))
    rng = np.random.default_rng(0)
    w = PredictionWorkload("syncs", b.done(),
                           rng.standard_normal((8, 3), dtype=np.float32),
                           np.zeros(8, np.int64), batch=4,
                           time_mode="measured", device="cuda")
    with pytest.raises(DeviceFault, match="capture"):
        w.evaluate(w.program)
    with SerialEvaluator(w) as ev:
        with pytest.raises(DeviceFault):
            ev.evaluate_one(Patch())
        assert ev.n_invalid == 0
    x = torch.ones(4, device=cuda)
    assert float((x + x).sum()) == 8.0
