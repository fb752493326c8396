#!/usr/bin/env python3
"""Tensor-parallel arithmetic on one card: two ranks share the GPU.

    python3 tools/tp_one_card.py [--arch ARCH|all]

Starts two processes (``launch/mesh.py`` ``launch_ranks``), each a rank
of a gloo group over CUDA tensors on the one card, with a ``(1, 2)``
mesh: the ``model`` axis has two ranks, so the train step splits its
arithmetic over them (attention heads, the FFN hidden units, mamba1's
channels, the vocabulary; zamba2's mamba2 heads with their split norm
and its shared block; deepseek's MLA heads, experts and shared expert)
and the hand kernels run on each rank's local blocks.  Each rank runs one
AdamW step of the model (qwen3-0.6b and falcon-mamba-7b at full width, 2
layers; zamba2-1.2b and deepseek-v3-671b at their smoke configs; f32
with TF32 off) sharded and unsharded from the same seeded weights and
batch, and holds the loss, the gradient norm and every parameter to the
card-against-CPU tolerance, |tp - one| <= 1e-3 |one| + 1e-4 max(1, max
|one|).  The serve part serves the same models the same way: a router
with one replica on the ``(1, 2)`` mesh, its engine on each rank's
blocks of the weights and caches (``build_router(mesh=)``), against the
router without a mesh on the same weights, over one seeded trace
(requests of several prompt lengths, continuous batching in two lanes);
every prefill's and decode step's logits (the ones each engine samples
from) are held to the same tolerance, and the share of greedy tokens
that agree is reported with each side's s/token.  The kernels are built
once, before the ranks start.  First each collective the step calls
(all-reduce, all-gather, all-to-all) is tried alone on CUDA tensors by a
pair of ranks of its own, then each model's step and then each model's
router, each by a pair of its own, so a rank that dies (a segmentation
fault, reported with its Python stack) takes one line with it.  The
card's name and power limit come first, then
one JSON line a collective and a model's part (errors, s/step of each
step or s/token of each router, launches of each kernel in the sharded
step or the meshed router); the process exits 1 if a model failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "falcon-mamba-7b", "zamba2-1.2b",
         "deepseek-v3-671b")
# run at their smoke configs (realign_pairs' uneven all-to-all of mamba2's
# in_proj, the split norm's all-reduce, the MoE's collectives)
SMOKE = ("zamba2-1.2b", "deepseek-v3-671b")
RTOL, ATOL = 1e-3, 1e-4
COLLECTIVES = ("all_reduce", "all_gather", "all_to_all")
BATCH, SEQ, LAYERS = 2, 256, 2
# the serve part's trace: prompts of these lengths, GEN new tokens each,
# in SLOTS lanes admitting two a tick
PROMPTS, GEN, SLOTS = (96, 96, 64, 128), 8, 2


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def err_of(torch, got, want) -> float:
    """The largest |got - want| over the bound's scale (<= 1 passes)."""
    got, want = got.detach().double(), want.detach().double()
    bound = RTOL * want.abs() + ATOL * max(1.0, float(want.abs().max()))
    return float(((got - want).abs() / bound).max())


def whole(p):
    """A parameter's whole tensor from the ranks' blocks, by
    ``torch.distributed``'s own all-gather: DTensor's ``full_tensor``
    (functional collectives) over gloo with CUDA tensors ended the process
    with a segmentation fault on the card, after the step."""
    import torch
    import torch.distributed as dist
    local = p.to_local().detach().contiguous()
    pl = p.placements[p.device_mesh.mesh_dim_names.index("model")]
    if not pl.is_shard():
        return local
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.cat(parts, pl.dim)


def rank_main(arch: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.interp import full_f32
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_bwd)
    from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_bwd
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
    from repro_torch.launch.shardings import (distribute, param_specs,
                                              to_shardings)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainState, make_train_step
    counters = {f.__name__: f for f in (rmsnorm, flash_attention, mamba_scan,
                                        rmsnorm_bwd, flash_attention_bwd,
                                        mamba_scan_bwd)}
    cfg = model_config(arch)
    gen = torch.Generator().manual_seed(0)
    b = {"tokens": torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=gen),
         "labels": torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=gen)}
    b = {k: v.to(torch.int32).cuda() for k, v in b.items()}

    def fresh():
        return T.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")

    def timed(step, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        return state, m, time.perf_counter() - t0

    opt = adamw(lr=1e-4)
    with full_f32():
        p = fresh()
        st = TrainState(p, opt.init(dict(p.named_parameters())))
        st, want, one_s = timed(make_train_step(cfg, opt), st)
        want_p = {n: q.detach().clone() for n, q in
                  st["params"].named_parameters()}
        del st, p
        mesh = DeviceMesh("cuda", [[0, 1]], mesh_dim_names=("data", "model"))
        p = fresh()
        p = distribute(p, to_shardings(mesh, param_specs(p, mesh)))
        ost = opt.init(dict(p.named_parameters()))
        ost = distribute(ost, to_shardings(mesh, param_specs(ost, mesh)))
        for f in counters.values():
            f.launches = 0
        st, got, tp_s = timed(make_train_step(cfg, opt, T.Dist(mesh=mesh)),
                              TrainState(p, ost))
        launches = {k: f.launches for k, f in counters.items()}
        got_p = {n: whole(q) for n, q in st["params"].named_parameters()}
    errs = {"loss": err_of(torch, got["loss"], want["loss"]),
            "grad_norm": err_of(torch, got["grad_norm"], want["grad_norm"])}
    worst = max(((err_of(torch, got_p[n], want_p[n]), n) for n in want_p))
    local = {n: list(q.to_local().shape) for n, q in
             list(st["params"].named_parameters())[:6]}
    dist.barrier()
    return {"arch": arch, "part": "train",
            "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "dtype": cfg.dtype},
            "tokens": [BATCH, SEQ], "loss": float(want["loss"]),
            "err_over_bound": {**errs, "worst_param": worst[0],
                               "worst_param_name": worst[1]},
            "ok": max(errs.values()) <= 1 and worst[0] <= 1,
            "step_s": {"unsharded": one_s, "tensor_parallel": tp_s},
            "launches_tensor_parallel": launches, "local_shapes": local}


def model_config(arch: str):
    from repro_torch.configs import get_config, smoke_config
    return smoke_config(arch) if arch in SMOKE else \
        get_config(arch).scaled(n_layers=LAYERS, dtype="float32")


def rank_serve(arch: str) -> dict:
    """The serve part of ``arch`` on this rank (module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.deploy import ServeRequest, build_router
    from repro_torch.core.interp import full_f32
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.models import transformer as T
    counters = {f.__name__: f for f in (rmsnorm, flash_attention,
                                        mamba_scan)}
    cfg = model_config(arch)
    rng = np.random.default_rng(0)
    max_len = max(PROMPTS) + GEN
    genome = {"max_slots": SLOTS, "prefill_chunk": 2, "replicas": 1}

    def requests():
        return [ServeRequest(uid=f"r{i}", max_new_tokens=GEN,
                             tokens=rng_tokens[i])
                for i in range(len(PROMPTS))]

    rng_tokens = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                  for n in PROMPTS]
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    mesh = DeviceMesh("cuda", [[0, 1]], mesh_dim_names=("data", "model"))
    out = {}
    with full_f32():
        for turn in ("plain", "mesh"):
            router = build_router(cfg, params, genome=genome,
                                  max_len=max_len,
                                  mesh=mesh if turn == "mesh" else None)
            engine = router.replicas[0].engine
            engine = getattr(engine, "real", None) or engine
            seen = []
            sample = engine._sample

            def recorded(logits, sample=sample, seen=seen):
                seen.append(logits.detach().clone())
                return sample(logits)

            engine._sample = recorded
            for f in counters.values():
                f.launches = 0
            torch.cuda.synchronize()
            router.run(requests(), stagger=1)
            torch.cuda.synchronize()
            out[turn] = {"logits": seen, "stats": router.stats(),
                         "tokens": {r.uid: r.tokens
                                    for r in router.completed},
                         "launches": {k: f.launches
                                      for k, f in counters.items()}}
            del router, engine
    plain, meshed = out["plain"], out["mesh"]
    n = min(len(plain["logits"]), len(meshed["logits"]))
    worst = max(err_of(torch, g, w) for g, w in
                zip(meshed["logits"][:n], plain["logits"][:n]))
    pairs = [(a, b) for uid, toks in plain["tokens"].items()
             for a, b in zip(toks, meshed["tokens"].get(uid, []))]
    agree = sum(a == b for a, b in pairs) / max(len(pairs), 1)
    dist.barrier()
    return {"arch": arch, "part": "serve",
            "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "dtype": cfg.dtype},
            "prompts": list(PROMPTS), "gen": GEN, "slots": SLOTS,
            "sample_calls": [len(plain["logits"]), len(meshed["logits"])],
            "err_over_bound": worst, "tokens_agree": agree,
            "ok": worst <= 1 and len(plain["logits"]) == len(
                meshed["logits"]) and len(pairs) == len(PROMPTS) * GEN,
            "s_per_token": {t: out[t]["stats"]["per_variant"]["default"]
                            ["s_per_token"] for t in out},
            "launches_mesh": meshed["launches"]}


def collective(kind: str) -> dict:
    """One collective of ``kind`` on CUDA tensors over the gloo group."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    x = torch.full((4, 3), float(rank + 1), device="cuda")
    if kind == "all_reduce":
        dist.all_reduce(x)
        want = torch.full((4, 3), 3.0, device="cuda")
    elif kind == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        x, want = torch.cat(parts), torch.cat(
            [torch.full((4, 3), float(r + 1), device="cuda")
             for r in range(2)])
    else:  # uneven, as mamba1's realignment sends: rank 0 keeps 1 row
        splits = [1, 3] if rank == 0 else [3, 1]
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, splits, splits)
        x = out
        want = torch.tensor([1.0, 2, 2, 2] if rank == 0 else [1.0, 1, 1, 2],
                            device="cuda")[:, None].expand(4, 3)
    torch.cuda.synchronize()
    return {"collective": kind, "ok": bool(torch.equal(x, want))}


def ranks(what: str, arch: str) -> int:
    """This rank's run of ``what``: a collective's name, or ``train`` or
    ``serve`` of ``arch``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import _forget_meshes, rank_env
    rank, world, init_file = rank_env()
    torch.cuda.set_device(0)
    _forget_meshes()
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        try:
            doc = rank_main(arch) if what == "train" else \
                rank_serve(arch) if what == "serve" else collective(what)
        except Exception as e:  # the probe records how it fell
            doc = {"item": what if what in COLLECTIVES else arch,
                   "ok": False, "error": f"{type(e).__name__}: {e}"[:2000]}
        if rank == 0:
            print(json.dumps(doc), flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if doc["ok"] else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", choices=(*ARCHS, "all"))
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src")]
    if args.rank:
        return ranks(args.rank, args.arch)
    import torch
    if not torch.cuda.is_available():
        print("tp_one_card.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import RankFailure, launch_ranks
    print(smi(), flush=True)
    build.build()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    failed = 0
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    runs = [(k, archs[0]) for k in COLLECTIVES] + \
        [(part, a) for part in ("train", "serve") for a in archs]
    for i, (what, arch) in enumerate(runs):
        argv = ["-X", "faulthandler", __file__, "--rank", what,
                "--arch", arch]
        with tempfile.TemporaryDirectory() as d:
            try:
                out = launch_ranks(argv, 2, str(Path(d) / f"init{i}"),
                                   timeout=900, threads=4, env=env)[0]
            except RankFailure as e:
                out = json.dumps({what: arch, "ok": False,
                                  "error": str(e)[-3000:]}) + "\n"
        print(out, end="", flush=True)
        failed += what not in COLLECTIVES and '"ok": true' not in out
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
