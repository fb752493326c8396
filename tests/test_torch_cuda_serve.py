"""The model stack and the server on the GPU: each decoder's smoke config
on the card against the CPU (prefill, then three decode steps), the
kernels' launches a model call makes, the engine against the direct loop
on the card, and the scan's final state against its plain version.

The flash kernel is built for head dims 32, 64 and 128, so the smoke
configs run here with ``head_dim=32`` (their own is 16 or 18).  Card
against CPU in float32 with TF32 off: |card - cpu| <= 1e-3 |cpu| + 1e-4
max(1, max |cpu|) (both sum in other orders; a fault moves logits by
O(1)).

Every test here is marked ``cuda`` and skips on hosts without a GPU.  It
imports nothing of the reference package, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_serve.py
"""

import copy

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.deploy import ServeEngine
from repro_torch.core.interp import full_f32
from repro_torch.core.liveloop.traces import demo_requests
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan_plain
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda

DECODERS = ("granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-vl-72b",
            "zamba2-1.2b", "minicpm-2b", "qwen1.5-4b", "qwen1.5-32b",
            "qwen3-0.6b", "falcon-mamba-7b")
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cfg(arch):
    cfg = smoke_config(arch)
    return cfg.scaled(head_dim=32) if cfg.n_heads else cfg


def _models(arch):
    cfg = _cfg(arch)
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to("cuda")


def _close(got, want, what):
    g, w = got.float().cpu(), want.float().cpu()
    bound = RTOL * w.abs() + ATOL * max(1.0, float(w.abs().max()))
    assert bool(((g - w).abs() <= bound).all()), \
        f"{what}: max |diff| {float((g - w).abs().max()):.3e}"


def _batch(cfg, tokens, positions):
    b = {"tokens": tokens, "positions": positions}
    if cfg.mrope:
        b["positions3"] = positions[..., None].expand(positions.shape + (3,))
    return b


def _run(cfg, params, prompt, steps, toks):
    """prefill then ``steps`` decode steps fed ``toks``: every step's
    logits and the final caches."""
    dev = params.device
    B, P = prompt.shape
    pos = torch.arange(P, device=dev)[None].expand(B, P)
    logits, pre = T.prefill(params, _batch(cfg, prompt.to(dev), pos), cfg)
    caches = T.init_cache(cfg, B, P + steps, device=dev)
    for k, f in caches.items():
        p = pre[k]
        if p.shape == f.shape:
            f.copy_(p)
        elif p.dim() == f.dim() and p.shape[2] == P:
            f[:, :, :P] = p
    out = [logits]
    for t in range(steps):
        tb = _batch(cfg, toks[:, t:t + 1].to(dev),
                    torch.full((B, 1), P + t, device=dev))
        logits, caches = T.decode_step(params, tb, caches, P + t, cfg)
        out.append(logits)
    return out, caches


@pytest.mark.parametrize("arch", DECODERS)
def test_smoke_stack_on_the_card_matches_cpu(cuda, arch):
    cfg, cpu, card = _models(arch)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (2, 13), generator=g)
    toks = torch.randint(0, cfg.vocab, (2, 3), generator=g)
    want, want_c = _run(cfg, cpu, prompt, 3, toks)
    with full_f32():
        got, got_c = _run(cfg, card, prompt, 3, toks)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"{arch} logits {i}")
    for k in want_c:
        _close(got_c[k], want_c[k], f"{arch} cache {k}")


@pytest.mark.parametrize("arch,per_layer,per_model", [
    ("qwen3-0.6b", {"rmsnorm": 4, "flash_attention": 1}, {"rmsnorm": 1}),
    ("falcon-mamba-7b", {"rmsnorm": 1, "mamba_scan": 1}, {"rmsnorm": 1}),
    ("zamba2-1.2b", {"rmsnorm": 2}, {"rmsnorm": 1}),
])
def test_prefill_launches_the_kernels(cuda, arch, per_layer, per_model):
    """A prefill launches rmsnorm for every norm, flash for every GQA
    attention and the scan for every mamba1 layer, and nothing else."""
    cfg = _cfg(arch)
    params = T.init_params(cfg, device="cuda")
    counters = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "mamba_scan": mamba_scan}
    for fn in counters.values():
        fn.launches = 0
    T.prefill(params, {"tokens": torch.zeros((1, 21), dtype=torch.long,
                                             device="cuda")}, cfg)
    want = {k: per_layer.get(k, 0) * cfg.n_layers + per_model.get(k, 0)
            for k in counters}
    if cfg.family == "hybrid":   # the shared block: 2 norms, 1 attention
        G = cfg.n_layers // cfg.attn_every
        want["rmsnorm"] += 2 * G
        want["flash_attention"] += G
    assert {k: fn.launches for k, fn in counters.items()} == want


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_engine_matches_direct_loop_on_the_card(cuda, arch):
    cfg, _, card = _models(arch)
    reqs = demo_requests(cfg, n_requests=5, prompt_len=11, gen=4, seed=3)
    with full_f32():
        eng = ServeEngine(cfg, card, max_len=15, max_slots=3,
                          prefill_chunk=2)
        got = {r.uid: r.tokens for r in eng.run(reqs, stagger=2)}
        for r in reqs:
            prompt = torch.as_tensor(r.tokens[None])
            out, toks = [], torch.zeros((1, 3), dtype=torch.long)
            logits, _ = _run(cfg, card, prompt, 0, toks)
            tok = int(logits[0].argmax(-1))
            direct = [tok]
            for t in range(3):
                toks[0, t] = direct[-1]
                logits, _ = _run(cfg, card, prompt, t + 1, toks)
                direct.append(int(logits[-1].argmax(-1)))
            assert got[r.uid] == direct, r.uid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_state_on_the_card(cuda, dtype):
    """The kernel's final state against the plain version's, and
    bit-identical across chunk, as y is."""
    g = torch.Generator(device="cuda").manual_seed(4)
    Bt, L, D, N = 2, 96, 80, 16
    dt = torch.nn.functional.softplus(
        torch.randn((Bt, L, D), generator=g, device="cuda")).to(dtype)
    x = torch.randn((Bt, L, D), generator=g, device="cuda").to(dtype)
    A = -torch.exp(0.3 * torch.randn((D, N), generator=g, device="cuda"))
    B = torch.randn((Bt, L, N), generator=g, device="cuda").to(dtype)
    C = torch.randn((Bt, L, N), generator=g, device="cuda").to(dtype)
    outs = [mamba_scan(dt, x, A, B, C, chunk=c, return_state=True)
            for c in (8, 12, 32, 48, 96)]
    for y, h in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])
    _, hp = mamba_scan_plain(dt, x, A, B, C, chunk=32, return_state=True)
    assert outs[0][1].dtype == torch.float32
    assert float((outs[0][1] - hp).abs().max()) <= 1e-4 * max(
        1.0, float(hp.abs().max()))
