"""The router and the live loop on the GPU: a router over two replicas
with one killed mid-replay against the direct prefill/decode loop, token
for token in float32 with TF32 off; a kernel launch the C entry refuses in
one replica's step, which must leave ``Router.step`` as a device fault and
not fail the replica; and one real-mode live-loop tick on the card.

Every test here is marked ``cuda`` and skips on hosts without a GPU.  It imports nothing of
the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_router.py
"""

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.deploy import Router, ServeEngine
from repro_torch.core.interp import full_f32
from repro_torch.core.liveloop import Guardrails, LiveLoopController
from repro_torch.core.liveloop.traces import demo_requests, synthesize
from repro_torch.device import DeviceFault
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _model(arch):
    cfg = smoke_config(arch)
    return cfg, T.init_params(cfg, device="cuda")


def _direct(cfg, params, prompt, gen):
    """Prefill one prompt, then greedy decode steps: its ``gen`` tokens."""
    dev = params.device
    P = len(prompt)
    logits, pre = T.prefill(params, {"tokens": torch.as_tensor(
        prompt[None], device=dev)}, cfg)
    caches = T.init_cache(cfg, 1, P + gen, device=dev)
    for k, f in caches.items():
        p = pre[k]
        if p.shape == f.shape:
            f.copy_(p)
        elif p.dim() == f.dim() and p.shape[2] == P:
            f[:, :, :P] = p
    out = [int(logits.argmax(-1)[0])]
    for t in range(gen - 1):
        tb = {"tokens": torch.tensor([[out[-1]]], device=dev),
              "positions": torch.tensor([[P + t]], device=dev)}
        logits, caches = T.decode_step(params, tb, caches, P + t, cfg)
        out.append(int(logits.argmax(-1)[0]))
    return out


def _router(cfg, params, max_len):
    return Router([ServeEngine(cfg, params, max_len=max_len, max_slots=2,
                               prefill_chunk=2, seed=i) for i in range(2)])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_failover_matches_direct_loop_on_the_card(cuda, arch):
    """Replica 0 killed at tick 3: every request completes on the survivor,
    restarted ones from the prompt, with the direct loop's tokens."""
    cfg, params = _model(arch)
    reqs = demo_requests(cfg, n_requests=6, prompt_len=11, gen=5, seed=3)
    with full_f32():
        router = _router(cfg, params, max_len=16)
        for r in reqs:
            router.submit(r)
        for _ in range(3):
            router.step()
        router.kill_replica(0)
        router.drain()
        got = {r.uid: r.tokens for r in router.completed}
        want = {r.uid: _direct(cfg, params, r.tokens, 5) for r in reqs}
    assert router.n_requeued > 0 and router.n_live == 1
    assert got == want


def test_refused_launch_propagates_out_of_the_router(cuda, monkeypatch):
    """rmsnorm's C entry refuses a launch with too little shared memory
    (before launching anything, so the context stays sound): in replica 1's
    step that is a DeviceFault out of Router.step, no replica failed."""
    cfg, params = _model("qwen3-0.6b")
    router = _router(cfg, params, max_len=16)
    victim = router.replicas[1].engine
    begin = victim.begin_step

    def refused():
        with monkeypatch.context() as m:
            m.setattr(rmsnorm_ops, "smem_bytes", lambda *a: 0)
            return begin()
    victim.begin_step = refused
    for r in demo_requests(cfg, n_requests=4, prompt_len=11, gen=3):
        router.submit(r)
    before = rmsnorm_ops.rmsnorm.launches
    with pytest.raises(DeviceFault, match="rmsnorm_fwd: CUDA error"):
        router.step()
    assert router.n_live == 2 and router.n_requeued == 0
    assert rmsnorm_ops.rmsnorm.launches > before   # replica 0 launched
    torch.cuda.synchronize()                       # the context is sound


def test_real_liveloop_tick_on_the_card(cuda, tmp_path):
    """One real-mode tick: a measured generation of the serve-plan search
    and a canary window, every replay on the card."""
    tr = synthesize("bursty", vocab=smoke_config("qwen3-0.6b").vocab,
                    n_requests=6, max_prompt=8, gen=3, seed=0)
    ctl = LiveLoopController(str(tmp_path / "loop"), trace=tr, mode="real",
                             pop=4, gens_per_tick=1, repeats=1,
                             surrogate=False,
                             guardrails=Guardrails(windows=1))
    s = ctl.tick()
    assert ctl._params.device.type == "cuda"
    assert s["tick"] == 0 and all(f > 0 for f in s["best_fitness"])
    assert ctl.state["tick"] == 1
