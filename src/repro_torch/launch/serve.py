"""Serving launcher: the continuous-batching :class:`ServeEngine` as a CLI.

The counterpart of ``src/repro/launch/serve.py`` on one device.  Replays a
deterministic mixed-length request trace (staggered arrivals) through the
engine for any decoder arch, optionally routing between the default model
configuration and an evolved artifact resolved from an
:class:`~repro_torch.core.deploy.ArtifactRegistry`, and optionally
publishing the measured per-variant latency into a shared fitness cache
under the ``serve`` writer tag.  It runs on the GPU unless ``--device``
names another; without a GPU and without ``--device`` it exits with an
error.  ``--replicas N`` serves through the deploy router (N engines
sharing the weights on the device), ``--mesh DATAxMODEL`` through the
router with its replicas on submeshes of that launch mesh, one process a
rank (on the CPU this command starts the ranks; a GPU takes one NCCL
rank), and ``--liveloop ROOT`` with the live loop's promoted schedule.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --device cpu --requests 8 --prompt-len 24 --gen 8

  # the full config, on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b

  # engine schedule + evolved route resolved from the artifact registry
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --device cpu --artifacts experiments/artifacts --variant ab

  # the pre-engine one-shot behavior (correctness oracle)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --device cpu --oneshot --requests 4 --prompt-len 32 --gen 16

  # two replicas behind the deploy router (see also
  # `python -m repro_torch.core.deploy.router`)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --device cpu --replicas 2 --requests 8 --prompt-len 16 --gen 6

  # the same two replicas, each on a row of a 2 x 2 mesh of gloo ranks
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --device cpu --replicas 2 --mesh 2x2 --requests 8 \
      --prompt-len 16 --gen 6

  # the live loop's promoted schedule (see `python -m
  # repro_torch.core.liveloop`), after two more ticks of the loop
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --device cpu --liveloop /tmp/loop --liveloop-ticks 2
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the GPU; "
                         "without one, pass --device cpu)")
    ap.add_argument("--requests", type=int, default=8,
                    help="trace length (mixed prompt lengths)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--stagger", type=int, default=2,
                    help="requests arriving per engine tick (0 = all "
                         "upfront)")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="in-flight sequences (default: registry serve "
                         "artifact, else 2)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admissions micro-batched per tick")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--replicas", type=int, default=None,
                    help="engine replicas behind the deploy router "
                         "(default: the resolved serve plan's replicas "
                         "knob, usually 1)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL smoke mesh for the replicas, e.g. 2x2, "
                         "one rank a device (on the CPU this command starts "
                         "that many gloo ranks; a GPU takes one NCCL rank)")
    ap.add_argument("--artifacts", default=None,
                    help="ArtifactRegistry directory (serve-schedule and "
                         "plan artifacts)")
    ap.add_argument("--variant", default="default",
                    choices=("default", "evolved", "ab"),
                    help="route requests to the default config, an evolved "
                         "plan artifact, or an A/B mix")
    ap.add_argument("--ab-fraction", type=float, default=0.5)
    ap.add_argument("--plan-shape", default="decode_32k",
                    help="shape key for resolving the plan artifact")
    ap.add_argument("--cache", default=None,
                    help="publish per-variant latency records into this "
                         "FitnessCache (JSONL) under writer tag 'serve'")
    ap.add_argument("--oneshot", action="store_true",
                    help="pre-engine one-shot path: batch prefill + "
                         "lockstep decode of --requests equal prompts")
    ap.add_argument("--liveloop", default=None,
                    help="live-loop root directory (see `python -m "
                         "repro_torch.core.liveloop`): serve with the "
                         "loop's promoted schedule, optionally advancing "
                         "the loop first")
    ap.add_argument("--liveloop-ticks", type=int, default=0,
                    help="control-loop ticks to run before serving")
    args = ap.parse_args(argv)

    import numpy as np

    from ..configs import get_config, smoke_config
    from ..core.deploy import (ArtifactRegistry, apply_plan_artifact,
                               oneshot_generate, serve_plan_from)
    from ..device import resolve_device

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"serve: {e}") from None

    if args.oneshot:
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab,
                               (args.requests, args.prompt_len)
                               ).astype(np.int32)
        gen = oneshot_generate(cfg, None, prompts, args.gen,
                               temperature=args.temperature, device=device)
        print(f"arch={cfg.name} device={device} oneshot "
              f"batch={args.requests} prompt={args.prompt_len} "
              f"generated={gen.shape[1]}")
        for b in range(min(args.requests, 2)):
            print(f"  seq{b}: {gen[b][:12].tolist()}...")
        return

    registry = ArtifactRegistry(args.artifacts) if args.artifacts else None
    serve_art = plan_art = None
    if registry is not None:
        serve_art = registry.resolve(cfg.name, "smoke" if args.smoke
                                     else "full", kind="serve")
        plan_art = registry.resolve(cfg.name, args.plan_shape, kind="plan")
    schedule = serve_plan_from(serve_art)
    if args.liveloop:
        # the loop's promoted schedule wins over the static registry: this
        # is the serving end of evolve->serve->measure->promote
        from ..core.liveloop import LiveLoopController
        ctl = LiveLoopController(args.liveloop, device=device)
        if args.liveloop_ticks:
            ctl.run(args.liveloop_ticks)
        live = ctl.registry.resolve(ctl.arch, "live", kind="serve")
        if live is not None:
            schedule.update({k: live.genome[k] for k in schedule
                             if k in live.genome})
            print(f"liveloop: serving promoted schedule {schedule} "
                  f"(fingerprint {live.meta['genome_fingerprint'][:12]})")
        else:
            print("liveloop: nothing promoted yet; serving the default "
                  "schedule")
    if args.max_slots is not None:
        schedule["max_slots"] = args.max_slots
    if args.prefill_chunk is not None:
        schedule["prefill_chunk"] = args.prefill_chunk
    if args.replicas is not None:
        schedule["replicas"] = args.replicas

    evolved_cfg, ab = None, 0.0
    if args.variant in ("evolved", "ab"):
        if plan_art is None:
            raise SystemExit(
                f"--variant {args.variant} needs a plan artifact for "
                f"({cfg.name}, {args.plan_shape}); none registered under "
                f"{args.artifacts or '--artifacts (not given)'}")
        evolved_cfg = apply_plan_artifact(cfg, plan_art)
        ab = 1.0 if args.variant == "evolved" else args.ab_fraction

    serve = dict(args=args, cfg=cfg, schedule=schedule, device=device,
                 evolved_cfg=evolved_cfg, ab=ab)
    if not args.mesh:
        _serve(mesh=None, **serve)
        return
    import sys

    from ..core.deploy.router import _check_split
    from .mesh import RankFailure, on_mesh, parse_mesh
    if args.liveloop_ticks:
        raise SystemExit("serve: --liveloop-ticks advances the loop on "
                         "every rank; advance it without --mesh first")
    shape = parse_mesh(args.mesh)
    _check_split(shape[0], int(schedule["replicas"]))
    try:
        on_mesh("repro_torch.launch.serve",
                sys.argv[1:] if argv is None else list(argv), device, shape,
                lambda mesh: _serve(mesh=mesh, **serve))
    except RankFailure as e:
        raise SystemExit(f"serve: --mesh {args.mesh}: {e}") from None


def _serve(args, cfg, schedule, device, evolved_cfg, ab, mesh) -> None:
    """Replay the demo trace through an engine, or through the router
    (over ``mesh``, where given), and print what it measured."""
    from ..core.deploy import ServeEngine, build_router
    from ..core.evaluator import FitnessCache
    from ..core.liveloop.traces import demo_requests
    if int(schedule.get("replicas", 1)) > 1 or mesh is not None:
        engine = build_router(cfg, genome=schedule,
                              max_len=args.prompt_len + args.gen,
                              mesh=mesh, device=device,
                              evolved_cfg=evolved_cfg, ab_fraction=ab,
                              temperature=args.temperature)
    else:
        engine = ServeEngine(cfg, max_len=args.prompt_len + args.gen,
                             max_slots=schedule["max_slots"],
                             prefill_chunk=schedule["prefill_chunk"],
                             evolved_cfg=evolved_cfg, ab_fraction=ab,
                             temperature=args.temperature, device=device)
    trace = demo_requests(cfg, n_requests=args.requests,
                          prompt_len=args.prompt_len, gen=args.gen)
    results = engine.run(trace, stagger=args.stagger or None)

    s = engine.stats()
    replica_note = (f" replicas={s['n_live']}/{s['n_replicas']}"
                    if "n_replicas" in s else "")
    mesh_note = (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else "")
    print(f"arch={cfg.name} device={device} requests={len(results)} "
          f"schedule={schedule}{replica_note}{mesh_note} ticks={s['ticks']}")
    print(f"wall={s['wall_s']:.2f}s throughput={s['throughput_tok_s']:.1f} "
          f"tok/s")
    for variant, rec in s["per_variant"].items():
        if rec["n"] == 0:
            continue
        print(f"  [{variant}] n={rec['n']} "
              f"ttft={rec['mean_ttft_s'] * 1e3:.1f}ms "
              f"latency={rec['mean_latency_s'] * 1e3:.1f}ms "
              f"(p95 {rec['p95_latency_s'] * 1e3:.1f}ms) "
              f"s/token={rec['s_per_token'] * 1e3:.1f}ms")
    for r in results[:2]:
        print(f"  {r.uid} [{r.variant}]: {r.tokens[:12]}...")

    if args.cache and (mesh is None or mesh.get_rank() == 0):
        cache = FitnessCache(args.cache, writer="serve")
        keys = engine.publish_stats(
            cache, name=cfg.name,
            shape={"prompt_len": args.prompt_len, "gen": args.gen,
                   "smoke": args.smoke})
        cache.close()
        print(f"published {len(keys)} serve-tagged latency records to "
              f"{args.cache}")


if __name__ == "__main__":
    main()
