"""Training on the GPU: the three backward kernels against their plain
versions, their determinism, the forwards' extra outputs leaving the
forwards' bits alone, and the train step on the card against the CPU.

Every test here is marked ``cuda`` and skips on hosts without a GPU.  It
imports nothing of the reference package, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Tolerances, |card - plain| <= RTOL |plain| + ATOL max(1, max |plain|): in
f32 RTOL 1e-5, ATOL 1e-4 (both sum the same f32 products in other orders,
over up to a few hundred terms); in bf16 RTOL 2**-7 (one rounding step of
the output) and ATOL 1e-2 (the forward's bf16 scale).  The train step on
the card against the CPU (smoke configs at head dim 32, f32, TF32 off, 2
AdamW steps): losses within 1e-5 relative, parameters within 1e-4
absolute (a tenth of lr 1e-3: a wrong gradient moves an element by
O(lr)).
"""

import copy

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.interp import full_f32
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_bwd_plain, flash_attention_plain
from repro_torch.kernels.flash_attention.ops import (_launch,
                                                     flash_attention_bwd)
from repro_torch.kernels.mamba_scan.mamba_scan import (mamba_scan_bwd_plain,
                                                       mamba_scan_plain)
from repro_torch.kernels.mamba_scan.ops import _forward as scan_forward
from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_bwd
from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd_plain
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import (load_latest, restore_like,
                                          save_checkpoint)
from repro_torch.train.train_step import TrainState, make_train_step

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def close(got, want, dtype, what=""):
    rtol, atol = TOL[dtype]
    torch.cuda.synchronize()
    g, w = got.float().cpu(), want.float().cpu()
    assert g.shape == w.shape, what
    assert bool(torch.isfinite(g).all()), what
    bound = rtol * w.abs() + atol * max(1.0, float(w.abs().max()))
    assert bool(((g - w).abs() <= bound).all()), \
        f"{what}: max |diff| {float((g - w).abs().max()):.3e}"


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,scale_dtype", [
    (7, 48, torch.float32), (130, 1024, torch.float32),
    (33, 128, torch.bfloat16), (5, 10, torch.float32)])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, rows, d, scale_dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dy = (_randn(gen, (rows, d), dtype, cuda) for _ in range(2))
    s = _randn(gen, (d,), scale_dtype, cuda)
    before = rmsnorm_bwd.launches
    dx, ds = rmsnorm_bwd(x, s, dy)
    assert rmsnorm_bwd.launches == before + 1
    pdx, pds = rmsnorm_bwd_plain(x, s, dy, eps=1e-6)
    close(dx, pdx, dtype, "dx")
    close(ds, pds, scale_dtype, "dscale")
    dx2, ds2 = rmsnorm_bwd(x, s, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [
    (37, 10, 0), (37, 48, 0), (131, 128, 0), (67, 1024, 0), (19, 4096, 0),
    (5, 5000, 0), (37, 128, 1), (9, 1024, 3)])
def test_rmsnorm_bwd_row_and_generic_paths(cuda, dtype, rows, d, offset):
    """Every width class of the backward: the row path at 48 (a row under
    a group's vectors), 128 (several rows a warp), 1024 (a warp a row) and
    4096 (a row over several warps), rows no multiple of a block's row
    groups; the generic path at 10 and 5000 and for x, dy ``offset``
    elements off a 16-byte boundary.  Against the plain version, two calls
    the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(4)

    def off(t):
        flat = torch.empty(t.numel() + offset, dtype=dtype, device=cuda)
        flat[offset:] = t.flatten()
        return flat[offset:].view(t.shape)

    x, dy = (off(_randn(gen, (rows, d), dtype, cuda)) for _ in range(2))
    s = _randn(gen, (d,), torch.float32, cuda)
    before = rmsnorm_bwd.launches
    got = rmsnorm_bwd(x, s, dy)
    assert rmsnorm_bwd.launches == before + 1
    want = rmsnorm_bwd_plain(x, s, dy, eps=1e-6)
    close(got[0], want[0], dtype, "dx")
    close(got[1], want[1], torch.float32, "dscale")
    again = rmsnorm_bwd(x, s, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _flash_bwd_case(cuda, dtype, causal, B, H, S, hd, block):
    """The backward kernel against its plain version on the forward
    kernel's o and lse (the forward run on inputs padded at the end to its
    tile, which leaves causal rows alone, and cut back), and a second call
    the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (_randn(gen, (B, H, S, hd), dtype, cuda) for _ in range(4))
    scale = hd ** -0.5
    Sp = -(-S // block) * block
    assert causal or Sp == S

    def pad(t):
        return torch.nn.functional.pad(t, (0, 0, 0, Sp - S)).contiguous()

    kw = dict(causal=causal, scale=scale, block_q=block, block_k=block)
    o, lse = _launch(pad(q), pad(k), pad(v), **kw, want_lse=True)
    o_alone = _launch(pad(q), pad(k), pad(v), **kw, want_lse=False)
    assert torch.equal(o, o_alone), "o changed with lse requested"
    o, lse = o[:, :, :S].contiguous(), lse[:, :, :S].contiguous()
    blk = block if S % block == 0 else S
    _, lse_plain = flash_attention_plain(
        q, k, v, causal=causal, scale=scale, block_q=blk, block_k=blk,
        return_lse=True)
    close(lse, lse_plain, torch.float32, "lse")
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                              scale=scale)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                     scale=scale)
    for g, w, name in zip(got, want, "qkv"):
        close(g, w, dtype, f"d{name}")
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,hd,block", [(128, 64, 64), (96, 32, 32),
                                        (256, 128, 128)])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, causal, S, hd, block):
    _flash_bwd_case(cuda, dtype, causal, 2, 2, S, hd, block)


@pytest.mark.parametrize("B,H,S,hd,causal,block", [
    (1, 2, 100, 32, True, 64), (1, 2, 100, 64, True, 64),
    (1, 2, 100, 128, True, 64), (1, 2, 200, 32, True, 64),
    (1, 2, 200, 64, True, 64), (1, 2, 200, 128, True, 128),
    (2, 1, 96, 32, False, 32), (2, 1, 96, 64, False, 32),
    (2, 1, 96, 128, False, 32), (8, 16, 1024, 128, True, 128)])
def test_flash_bwd_bf16_ragged_and_training_shapes(cuda, B, H, S, hd,
                                                   causal, block):
    """The bf16 tensor-core backward at lengths no multiple of its tiles
    (rows past the end zero-filled and masked), at each head dim, and at a
    qwen3-0.6b training step's attention."""
    _flash_bwd_case(cuda, torch.bfloat16, causal, B, H, S, hd, block)


def _scan_bwd_case(cuda, dtype, Bt, L, D, N, chunk, with_dh):
    """The backward kernel against its plain version on the forward
    kernel's tile-start states (themselves held to the plain forward's,
    with y and h_last the same bits with and without them), and a second
    call the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    dt = torch.nn.functional.softplus(
        torch.randn((Bt, L, D), generator=gen, device=cuda)).to(dtype)
    x, dy = (_randn(gen, (Bt, L, D), dtype, cuda) for _ in range(2))
    A = -torch.exp(0.3 * torch.randn((D, N), generator=gen, device=cuda))
    B, C = (_randn(gen, (Bt, L, N), dtype, cuda) for _ in range(2))
    dh = (torch.randn((Bt, D, N), generator=gen, device=cuda) if with_dh
          else None)
    y, h, hc = scan_forward(dt, x, A, B, C, chunk=chunk, return_state=True,
                            return_chunks=True)
    y0, h0 = scan_forward(dt, x, A, B, C, chunk=chunk, return_state=True,
                          return_chunks=False)
    assert torch.equal(y, y0) and torch.equal(h, h0), \
        "y or h_last changed with the chunk states requested"
    _, _, hc_plain = mamba_scan_plain(dt, x, A, B, C, chunk=chunk,
                                      return_state=True, return_chunks=True)
    close(hc, hc_plain, torch.float32, "h_chunks")
    before = mamba_scan_bwd.launches
    got = mamba_scan_bwd(dt, x, A, B, C, dy, hc, dh, chunk=chunk)
    assert mamba_scan_bwd.launches == before + 1
    want = mamba_scan_bwd_plain(dt, x, A, B, C, dy, hc, dh, chunk=chunk)
    for g, w, name in zip(got, want, ("dt", "x", "A", "B", "C")):
        close(g, w, torch.float32 if name == "A" else dtype, f"d{name}")
    again = mamba_scan_bwd(dt, x, A, B, C, dy, hc, dh, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,L,D,N,chunk,with_dh", [
    (2, 24, 40, 4, 8, True), (1, 64, 64, 16, 64, False),
    (1, 18, 33, 1, 6, True), (2, 32, 32, 32, 16, True)])
def test_scan_bwd_kernel_matches_plain(cuda, dtype, Bt, L, D, N, chunk,
                                       with_dh):
    _scan_bwd_case(cuda, dtype, Bt, L, D, N, chunk, with_dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bt,L,D,N,chunk,with_dh", [
    (1, 36, 33, 16, 12, True), (2, 40, 40, 1, 20, False),
    (1, 48, 40, 32, 24, True), (1, 30, 35, 8, 10, True),
    (1, 64, 33, 2, 64, False), (1, 144, 40, 16, 72, True),
    (2, 256, 300, 16, 128, False)])
def test_scan_bwd_ragged_sub_tiles_and_segments(cuda, dtype, Bt, L, D, N,
                                                chunk, with_dh):
    """The backward's tiling at its edges: tiles no multiple of the
    sub-tile (32 / states steps: 8 at N 16, 32 at N 1 and 2, 4 at N 32, 16
    at N 8), D 33, 35 and 40 (channels past D in a block, and rows that
    rule out 16-byte copies in bf16), a tile of 9 sub-tiles (a second
    segment of one), two full segments over several blocks and two
    clusters (D 300)."""
    _scan_bwd_case(cuda, dtype, Bt, L, D, N, chunk, with_dh)


def test_autograd_reaches_the_backward_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    dt = torch.rand((1, 16, 32), generator=gen, device=cuda)
    x = torch.randn((1, 16, 32), generator=gen, device=cuda)
    A = -torch.rand((32, 4), generator=gen, device=cuda) - 0.5
    B, C = (torch.randn((1, 16, 4), generator=gen, device=cuda)
            for _ in range(2))
    ins = [t.requires_grad_() for t in (dt, x, A, B, C)]
    before = mamba_scan_bwd.launches
    mamba_scan(*ins, chunk=8).sum().backward()
    assert mamba_scan_bwd.launches == before + 1
    assert all(t.grad is not None for t in ins)


def _cfg(arch):
    cfg = smoke_config(arch).scaled(dtype="float32")
    return cfg.scaled(head_dim=32) if cfg.n_heads else cfg


def _steps(cfg, params, steps=2, start=0, state=None):
    opt = adamw(lr=1e-3)
    state = state or TrainState(params, opt.init(dict(
        params.named_parameters())))
    step_fn = make_train_step(cfg, opt)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=24, global_batch=2)
    losses = []
    for s in range(start, start + steps):
        b = {k: torch.as_tensor(v, device=params.device)
             for k, v in pipe.batch_at(s).items()}
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "zamba2-1.2b"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    cfg = _cfg(arch)
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    _, want = _steps(cfg, cpu)
    with full_f32():
        _, got = _steps(cfg, card)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w)
    ref = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        diff = float((p.detach().cpu() - ref[name].detach()).abs().max())
        assert diff <= 1e-4, f"{name}: {diff:.3e}"


def test_resume_on_the_card_is_bit_exact(cuda, tmp_path):
    cfg = smoke_config("qwen3-0.6b").scaled(head_dim=32, dtype="bfloat16")

    def fresh():
        return T.init_params(cfg, generator=torch.Generator(
            device=cuda).manual_seed(0), device=cuda)
    straight, _ = _steps(cfg, fresh(), steps=4)
    half, _ = _steps(cfg, fresh(), steps=2)
    save_checkpoint(str(tmp_path), half, 2)
    params = fresh()
    opt = adamw(lr=1e-3)
    state = restore_like(TrainState(params, opt.init(dict(
        params.named_parameters()))), load_latest(str(tmp_path))[1])
    resumed, _ = _steps(cfg, params, steps=2, start=2, state=state)
    want = dict(straight["params"].named_parameters())
    for name, p in resumed["params"].named_parameters():
        assert torch.equal(p, want[name]), name


# --------------------------------------------------------------------------
# the (1, 1) mesh on the card: a NCCL group of one rank
# --------------------------------------------------------------------------

@pytest.fixture
def card_mesh(cuda, tmp_path):
    """The card's (1, 1) mesh over a NCCL group of one rank, destroyed
    after the test."""
    import torch.distributed as torch_dist

    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
    init_process_group("cuda", 0, 1, str(tmp_path / "init"))
    try:
        assert torch_dist.get_backend() == "nccl"
        yield make_smoke_mesh(1, 1, device_type="cuda")
    finally:
        torch_dist.destroy_process_group()


def _sharded(cfg, params, mesh, opt):
    from repro_torch.launch.shardings import (distribute, param_specs,
                                              to_shardings)
    params = distribute(params, to_shardings(mesh, param_specs(params, mesh)))
    ost = opt.init(dict(params.named_parameters()))
    return TrainState(params, distribute(ost, to_shardings(
        mesh, param_specs(ost, mesh))))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_mesh_1x1_step_is_the_unsharded_step_bit_for_bit(card_mesh, arch,
                                                         optimizer):
    """Two steps on the (1, 1) mesh against two without: losses, gradient
    norms and every parameter bit for bit (bf16 weights)."""
    from repro_torch.launch.shardings import gather
    from repro_torch.optim import adafactor
    cfg = _cfg(arch).scaled(dtype="bfloat16")
    make = {"adamw": lambda: adamw(lr=1e-3), "adafactor": adafactor}[optimizer]

    def fresh():
        return T.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=24, global_batch=2)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in pipe.batch_at(s).items()} for s in range(2)]
    runs = []
    for mesh in (None, card_mesh):
        opt = make()
        params = fresh()
        state = TrainState(params, opt.init(dict(params.named_parameters()))) \
            if mesh is None else _sharded(cfg, params, mesh, opt)
        step = make_train_step(cfg, opt, T.Dist(mesh=mesh))
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append((m["loss"].cpu(), m["grad_norm"].cpu()))
        runs.append((metrics, gather(state["params"])))
    (m0, p0), (m1, p1) = runs
    for (l0, g0), (l1, g1) in zip(m0, m1):
        assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert p0.keys() == p1.keys()
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name


def test_mesh_ep_prefill_matches_moe_dense_on_the_card(card_mesh):
    """granite's prefill through the expert-parallel path (a capacity
    factor that drops nothing) against moe_dense, f32, TF32 off, within
    1e-5 of the logits' largest value; rmsnorm and flash launched."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    cfg = _cfg("granite-moe-3b-a800m").scaled(moe_mode="ep_a2a",
                                              expert_shards=4)
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 40), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(1))
    with full_f32():
        want, _ = T.prefill(params, {"tokens": tokens}, cfg)
        rmsnorm.launches = flash_attention.launches = 0
        got, _ = T.prefill(params, {"tokens": tokens}, cfg, T.Dist(
            mesh=card_mesh, capacity_factor=8 / cfg.top_k))
    assert rmsnorm.launches == 2 * cfg.n_layers + 1
    assert flash_attention.launches == cfg.n_layers
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


def test_mesh_2x2_on_one_card_names_the_devices_it_needs(cuda):
    from repro_torch.launch.mesh import make_smoke_mesh
    if torch.cuda.device_count() >= 4:
        pytest.skip("this host has four GPUs")
    with pytest.raises(ValueError, match="needs 4 CUDA devices"):
        make_smoke_mesh(2, 2, device_type="cuda")


def test_train_cli_mesh_smoke_on_the_card(cuda):
    """``launch.train --mesh smoke`` on one card runs the (1, 1) mesh and
    gives the unmeshed run's losses bit for bit."""
    from repro_torch.launch.train import main
    args = ["--arch", "qwen3-0.6b", "--smoke", "--scale",
            "head_dim=32,dtype=bfloat16", "--steps", "3", "--batch", "2",
            "--seq", "32", "--log-every", "100"]
    meshed = main(args + ["--mesh", "smoke"])
    assert meshed["dist"].active
    assert meshed["losses"] == main(args)["losses"]


# --------------------------------------------------------------------------
# the dry run against the real step, and remat, on the card
# --------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    return {"rmsnorm/fwd": rmsnorm, "rmsnorm/bwd": rmsnorm_bwd,
            "flash_attention/fwd": flash_attention,
            "flash_attention/bwd": flash_attention_bwd,
            "mamba_scan/fwd": mamba_scan, "mamba_scan/bwd": mamba_scan_bwd}


def _real_step(cfg, arch, shape, tmp_path):
    """The cell's sharded step on a NCCL group of one rank: launches,
    FlopCounterMode's count and the footprint (peak less the memory
    before the cell was made)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
    from repro_torch.launch.specs import make_cell
    init_process_group("cuda", 0, 1, str(tmp_path / "init"))
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        cell = make_cell(arch, shape, make_smoke_mesh(1, 1, "cuda"),
                         cfg_override=cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        with FlopCounterMode(display=False) as fc:
            cell.fn(*cell.args)
            torch.cuda.synchronize()
        out = {"launches": {k: fn.launches for k, fn in counters.items()},
               "flops": fc.get_total_flops(),
               "footprint": torch.cuda.max_memory_allocated() - before}
        del cell
        return out
    finally:
        dist.destroy_process_group()


def _dry(cfg, arch, shape):
    from repro_torch.launch.dryrun import run_cell
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rec = run_cell(arch, shape, False, cfg_override=cfg,
                   mesh=((1, 1), ("data", "model")))
    assert rec["status"] == "ok", rec.get("traceback")
    assert torch.cuda.memory_allocated() == before
    return rec


@pytest.mark.parametrize("arch,remat", [("qwen3-0.6b", "none"),
                                        ("qwen3-0.6b", "full"),
                                        ("falcon-mamba-7b", "none")])
def test_dry_run_counts_the_real_step(cuda, tmp_path, arch, remat):
    """Full width at 2 layers, bf16: each kernel's events equal its
    launches, the dot FLOPs equal FlopCounterMode's exactly, and argument
    + temp is within 10% of the step's footprint."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).scaled(n_layers=2, remat=remat)
    shape = (512, 2, "train")
    real = _real_step(cfg, arch, shape, tmp_path)
    rec = _dry(cfg, arch, shape)
    events = {k: v["events"] for k, v in rec["hlo"]["kernels"].items()}
    assert {k: v for k, v in real["launches"].items() if v} == events
    assert sum(rec["hlo"]["aten_flops"].values()) == real["flops"]
    mem = rec["memory"]
    est = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert abs(est / real["footprint"] - 1) <= 0.10, (est, real)


def test_remat_on_the_card_is_bit_for_bit(cuda):
    """qwen3-0.6b at full width, 2 layers, bf16: the loss and every
    gradient with remat="full" equal remat="none"'s, and the forward
    kernels launch twice in each checkpointed layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.specs import make_cell
    from repro_torch.train.train_step import loss_and_grads
    cfg = get_config("qwen3-0.6b").scaled(n_layers=2)
    cell = make_cell("qwen3-0.6b", (512, 2, "train"), MeshShape((1, 1)),
                     cfg_override=cfg, device="cuda")
    params, b = cell.args[0]["params"], cell.args[1]
    loss0, g0 = loss_and_grads(cfg, params, b)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    loss1, g1 = loss_and_grads(cfg.scaled(remat="full"), params, b)
    torch.cuda.synchronize()
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    launches = {k: fn.launches for k, fn in counters.items()}
    assert launches == {"rmsnorm/fwd": 2 * 8 + 1, "rmsnorm/bwd": 9,
                        "flash_attention/fwd": 4,
                        "flash_attention/bwd": 2, "mamba_scan/fwd": 0,
                        "mamba_scan/bwd": 0}
