"""Training launcher: any assigned arch (reduced or full config), with
checkpoint/resume, async saves and the synthetic sharded data pipeline (the
counterpart of ``src/repro/launch/train.py``).  It runs on the GPU unless
``--device`` names another; without a GPU and without ``--device`` it
exits with an error.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --smoke --device cpu --steps 50 --batch 8 --seq 128 \
      --ckpt /tmp/ckpt --ckpt-every 20

  # the full config, on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --steps 30 --batch 8 --seq 1024

  # the reference's smoke mesh: on the CPU, 2 x 2 over four gloo ranks
  # that this command starts itself (one thread each; only rank 0 prints,
  # and this process relays its output); on the GPU, the card's (1, 1)
  # over NCCL in this process
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --smoke --mesh smoke --device cpu --steps 3 --batch 4 --seq 32

Weights are drawn from a ``torch.Generator`` seeded 0 on the device; the
embedding-input and M-RoPE stubs of the reference take their noise from a
generator seeded by the step, so a resumed run sees the batches an
uninterrupted one does.  Under ``--mesh smoke`` every rank draws the same
weights and batches, places the parameters and optimizer state under
``launch/shardings.py``'s specs, and runs the sharded step
(train/train_step.py); a checkpoint is gathered whole and written by rank
0, and restored onto whatever mesh the run has.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .mesh import RankFailure, on_mesh


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--scale", default=None,
                    help="comma k=v config overrides, e.g. "
                         "d_model=640,n_layers=10")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="none",
                    choices=["none", "wsd", "cosine"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="none", choices=["none", "smoke"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the GPU; "
                         "without one, pass --device cpu)")
    return ap


def device_batch(cfg, pipe, step: int, device) -> dict:
    """The pipeline's batch for ``step`` on ``device``, with the
    reference's modality stubs: frame embeddings drawn from a generator
    seeded by the step for an embedding-input arch, and M-RoPE positions
    (every section the token position)."""
    batch = pipe.batch_at(step)
    B, S = batch["tokens"].shape
    out = {"tokens": torch.as_tensor(batch["tokens"], device=device),
           "labels": torch.as_tensor(batch["labels"], device=device)}
    if cfg.embedding_inputs:  # modality stub: tokens -> frame embeddings
        gen = torch.Generator(device=device).manual_seed(step)
        out = {"embeds": torch.randn((B, S, cfg.d_model), generator=gen,
                                     device=device) * 0.02,
               "labels": out["labels"] % cfg.vocab}
    if cfg.mrope:
        pos = np.arange(S, dtype=np.int32)
        out["positions3"] = torch.as_tensor(
            np.ascontiguousarray(np.broadcast_to(pos[None, :, None],
                                                 (B, S, 3))), device=device)
    return out


def main(argv=None, on_step=None) -> dict:
    """Train as the arguments say; ``on_step(step, metrics)``, if given,
    is called after every step.  Returns the final state, the step
    function, a function giving the device batch of a step, and the losses
    and gradient norms of the steps run (host floats).  Under ``--mesh
    smoke`` the process group is torn down before it returns; on the CPU
    this process starts the ranks and returns their outputs
    (``printed``)."""
    args = build_parser().parse_args(argv)
    from ..device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"train: {e}") from None
    if args.mesh == "none":
        return _train(args, device, None, on_step)
    # the card's (1, 1) over a NCCL group of one rank, or the CPU's 2 x 2
    # over four gloo ranks, which this command starts
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        res = on_mesh("repro_torch.launch.train", argv, device,
                      (1, 1) if device.type == "cuda" else (2, 2),
                      lambda mesh: _train(args, device, mesh, on_step))
    except RankFailure as e:    # a rank failed, or outlived MESH_TIMEOUT
        raise SystemExit(f"train: --mesh smoke: {e}") from None
    # the ranks' outputs where this command started them
    return {"printed": res} if isinstance(res, list) else res


def _train(args, device, mesh, on_step) -> dict:
    from ..configs import get_config, smoke_config
    from ..data.tokens import TokenPipeline
    from ..models.transformer import Dist, init_params
    from ..optim.optimizers import OPTIMIZERS
    from ..optim.schedules import cosine_schedule, wsd_schedule
    from ..train.checkpoint import load_latest, restore_like, save_checkpoint
    from ..train.train_step import TrainState, make_train_step
    from .shardings import distribute, param_specs, to_shardings

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.scale:
        kv = dict(s.split("=") for s in args.scale.split(","))
        cfg = cfg.scaled(**{k: (int(v) if v.isdigit() else v)
                            for k, v in kv.items()})
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family} device={device}"
          + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
             if mesh is not None else ""))

    lr = args.lr
    if args.schedule == "wsd":
        lr = wsd_schedule(args.lr, args.steps // 10, args.steps * 7 // 10,
                          args.steps // 5)
    elif args.schedule == "cosine":
        lr = cosine_schedule(args.lr, args.steps // 10, args.steps)
    opt = OPTIMIZERS[args.optimizer](lr=lr)

    params = init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    dist = Dist() if mesh is None else Dist(mesh=mesh)
    if mesh is not None:
        params = distribute(params, to_shardings(
            mesh, param_specs(params, mesh, fsdp=cfg.fsdp)))
    opt_state = opt.init(dict(params.named_parameters()))
    if mesh is not None:
        opt_state = distribute(opt_state, to_shardings(
            mesh, param_specs(opt_state, mesh, fsdp=cfg.fsdp)))
    state = TrainState(params, opt_state)
    start = 0
    if args.ckpt:
        found = load_latest(args.ckpt)
        if found:
            start, flat = found
            state = restore_like(state, flat)
            print(f"resumed from step {start}")

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, n_hosts=args.hosts,
                         host_id=args.host_id)
    step_fn = make_train_step(cfg, opt, dist,
                              microbatches=args.microbatches)

    t0 = time.time()
    pending_save = None
    losses, gnorms = [], []
    for step in range(start, args.steps):
        state, metrics = step_fn(state, device_batch(cfg, pipe, step,
                                                     device))
        losses.append(metrics["loss"])
        gnorms.append(metrics["grad_norm"])
        if on_step is not None:
            on_step(step, metrics)
        if (step + 1) % args.log_every == 0 or step == start:
            print(f"step {step+1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(step-start+1):.2f}s/step)",
                  flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = save_checkpoint(args.ckpt, state, step + 1,
                                           async_save=True)
    if pending_save is not None:
        pending_save.join()
    if args.ckpt:
        save_checkpoint(args.ckpt, state, args.steps)
    print(f"done: {args.steps - start} steps in {time.time()-t0:.1f}s")
    return {"state": state, "step_fn": step_fn, "cfg": cfg, "dist": dist,
            "batch": lambda s: device_batch(cfg, pipe, s, device),
            "losses": [float(x) for x in losses],
            "grad_norms": [float(x) for x in gnorms], "start": start}


if __name__ == "__main__":
    main()
