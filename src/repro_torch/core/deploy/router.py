"""Multi-replica serving: a request router fanning traffic over N engines.

The counterpart of ``src/repro/core/deploy/router.py`` on one device (the
GPU unless the caller names another).  One
:class:`~repro_torch.core.deploy.engine.ServeEngine` is a single decode
loop; a :class:`Router` puts N of them — data-parallel replicas sharing one
set of weights on the device — behind one queue, and:

* **routes** queued requests to the least-loaded live replica each tick;
* **interleaves** replica steps in two phases (every replica's decode is
  *dispatched* before any replica's result is awaited —
  ``ServeEngine.begin_step`` / ``finish_step``), so device work of one
  replica overlaps the host work for its siblings;
* **survives replica death**: a replica whose step raises (or whose
  heartbeat goes silent — the :class:`~repro_torch.train.fault.
  HeartbeatMonitor` watches every replica, its clock the router's ticks)
  is failed, its completed results are kept, and its queued + in-flight
  requests are re-routed to the survivors.  In-flight sequences restart
  from the prompt; greedy decode makes the retried tokens identical to the
  originals.  If *every* replica dies the backlog is counted rejected and
  the router drains — it never hangs.  A fault of the device itself
  (:data:`~repro_torch.core.fitness.DEVICE_FAULTS`: a kernel that did not
  build, a launch the device refused) is not one replica dying: the
  replicas share one CUDA context, whose errors are sticky, so it
  propagates out of :meth:`Router.step`;
* **reports** aggregate + per-replica stats and publishes serve-tagged
  fitness records keyed by the full serving plan, so the live loop's
  guardrails and the search see multi-replica measurements in the same
  store as everything else.

:func:`build_router` resolves a serve-plan genome (engine schedule + KV
plan, see :mod:`~repro_torch.core.deploy.kvplan`) into concrete replicas,
slot counts clamped by the plan's paged byte budget.  The reference's
placement of replicas on submeshes of a launch mesh (``replica_meshes``,
``shard_replica_params``, ``shard_engine_caches``, ``build_router(mesh=)``
and ``--mesh``) is the port's last module still to come (ROADMAP.md,
queue 1, item 1): the reference's ``Router`` is one controller over
every replica, and with one process a rank every rank would have to run
the same deterministic router, step only its own replica and broadcast
that replica's tokens, which is a design of its own.  ``python -m repro_torch.core.deploy.router`` is
the CLI smoke: build a router, replay a synthesized trace, print the stats
JSON (optionally killing a replica mid-replay to show the failover path).
"""

from __future__ import annotations

import hashlib
import json
import time as _time
from collections import deque
from dataclasses import dataclass

import numpy as np

from ...device import resolve_device
from ...train.fault import HeartbeatMonitor
from ..evaluator import EvalOutcome, FitnessCache
from ..fitness import DEVICE_FAULTS
from .engine import DEFAULT_SERVE_PLAN, ServeEngine, ServeRequest
from .kvplan import KVPlan
from .registry import shape_tag


@dataclass
class _Replica:
    """One engine replica and its liveness bookkeeping."""
    index: int
    engine: ServeEngine
    alive: bool = True
    fail_reason: str = ""
    harvested: int = 0          # engine.completed rows already collected


class Router:
    """Fan requests over N :class:`ServeEngine` replicas (see module doc).

    Duck-types the engine's driving protocol (``try_submit`` / ``step`` /
    ``busy`` / ``completed`` / ``stats``), so
    :func:`~repro_torch.core.liveloop.traces.replay` and the live loop
    drive a router exactly like a single engine."""

    def __init__(self, engines: list[ServeEngine], *,
                 plan: KVPlan | None = None, genome: dict | None = None,
                 heartbeat_timeout: float = 8.0):
        if not engines:
            raise ValueError("router needs at least one replica")
        if len({e.max_len for e in engines}) != 1:
            raise ValueError("replicas must share max_len")
        self.replicas = [_Replica(index=i, engine=e)
                         for i, e in enumerate(engines)]
        self.plan = plan or KVPlan.from_genome(genome or {})
        self.genome = dict(DEFAULT_SERVE_PLAN, **(genome or {}))
        self.max_len = engines[0].max_len
        self.monitor = HeartbeatMonitor(n_hosts=len(engines),
                                        timeout=heartbeat_timeout)
        for r in self.replicas:
            self.monitor.heartbeat(r.index, now=0.0)
        self.queue: deque[ServeRequest] = deque()
        self.completed: list = []
        self.n_rejected = 0
        self.n_requeued = 0
        self.rejected_uids: list[str] = []
        self.n_ticks = 0
        self._t0: float | None = None

    # -- liveness ----------------------------------------------------------
    def _live(self) -> list[_Replica]:
        return [r for r in self.replicas if r.alive]

    @property
    def n_live(self) -> int:
        return len(self._live())

    def kill_replica(self, index: int, reason: str = "killed") -> None:
        """Fault injection: fail replica ``index`` as if its step crashed —
        results kept, queued + in-flight work re-routed."""
        self._fail(self.replicas[index], reason)

    def _fail(self, r: _Replica, reason: str) -> None:
        if not r.alive:
            return
        self._harvest(r)                    # keep what it already finished
        r.alive = False
        r.fail_reason = reason
        eng = r.engine
        requeue = list(eng.queue)
        eng.queue.clear()
        for batch in eng.batches.values():
            for i, lane in batch.active():
                requeue.append(lane.req)    # restart from the prompt
                batch.lanes[i] = None
        self.n_requeued += len(requeue)
        for req in reversed(requeue):       # preserve FIFO at the front
            self.queue.appendleft(req)

    # -- submission --------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        tokens = np.asarray(req.tokens, np.int32).reshape(-1)
        if len(tokens) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(tokens)} + "
                f"{req.max_new_tokens} new tokens exceeds max_len "
                f"{self.max_len}")
        variants = self.replicas[0].engine.cfgs
        if req.variant is not None and req.variant not in variants:
            raise ValueError(f"request {req.uid}: unknown variant "
                             f"{req.variant!r} (have {list(variants)})")
        req.tokens = tokens
        self.queue.append(req)

    def try_submit(self, req: ServeRequest) -> bool:
        try:
            self.submit(req)
        except ValueError:
            self.n_rejected += 1
            self.rejected_uids.append(req.uid)
            return False
        return True

    def submit_many(self, reqs) -> None:
        for r in reqs:
            self.submit(r)

    def _dispatch(self) -> None:
        """Route every queued request to the least-loaded live replica."""
        live = self._live()
        if not live:
            return
        while self.queue:
            req = self.queue.popleft()
            r = min(live, key=lambda x: (len(x.engine.queue)
                                         + x.engine._n_in_flight(),
                                         x.index))
            r.engine.submit(req)

    # -- the loop ----------------------------------------------------------
    def step(self) -> None:
        """One router tick: route the backlog, then step every live replica
        in two phases — all dispatches before any completion — failing and
        draining replicas whose step raises or whose heartbeat lapses.  A
        device fault propagates instead (see the module doc)."""
        if self._t0 is None:
            self._t0 = _time.perf_counter()
        self.n_ticks += 1
        self._dispatch()
        pending = []
        for r in self._live():
            try:
                pending.append((r, r.engine.begin_step()))
            except DEVICE_FAULTS:
                raise
            except Exception as e:          # noqa: BLE001 — replica fault
                self._fail(r, f"begin_step: {type(e).__name__}: {e}")
        for r, p in pending:
            if not r.alive:
                continue
            try:
                r.engine.finish_step(p)
            except DEVICE_FAULTS:
                raise
            except Exception as e:          # noqa: BLE001 — replica fault
                self._fail(r, f"finish_step: {type(e).__name__}: {e}")
                continue
            self.monitor.heartbeat(r.index, now=float(self.n_ticks))
        for idx in self.monitor.failed(now=float(self.n_ticks)):
            self._fail(self.replicas[idx], "heartbeat timeout")
        for r in self.replicas:
            self._harvest(r)
        if not self._live() and self.queue:
            # total outage: reject the backlog instead of hanging
            for req in self.queue:
                self.n_rejected += 1
                self.rejected_uids.append(req.uid)
            self.queue.clear()

    def _harvest(self, r: _Replica) -> None:
        new = r.engine.completed[r.harvested:]
        if new:
            self.completed.extend(new)
            r.harvested = len(r.engine.completed)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r.engine.busy for r in self._live())

    def run(self, requests=None, *, stagger: int | None = None) -> list:
        """Drive to completion (see :meth:`ServeEngine.run`); returns this
        call's results in completion order."""
        pending = deque(requests or [])
        if stagger is None:
            self.submit_many(pending)
            pending.clear()
        n_before = len(self.completed)
        while pending or self.busy:
            for _ in range(min(stagger or 0, len(pending))):
                self.submit(pending.popleft())
            self.step()
        return self.completed[n_before:]

    def drain(self) -> None:
        """Tick until nothing is queued or in flight (never hangs: a total
        outage converts the backlog into rejections)."""
        while self.busy:
            self.step()

    # -- stats + feedback --------------------------------------------------
    def stats(self) -> dict:
        """Aggregate + per-replica serving stats.  Same zero-safe contract
        as :meth:`ServeEngine.stats`: well-defined before the first tick,
        mid-run, and after faults."""
        t_last = max((r.engine._t_last for r in self.replicas), default=0.0)
        wall = max(t_last - self._t0, 0.0) if self._t0 is not None else 0.0
        engine_rejects = sum(r.engine.n_rejected for r in self.replicas)
        out = {"n_completed": len(self.completed),
               "n_rejected": self.n_rejected + engine_rejects,
               "n_requeued": self.n_requeued,
               "n_replicas": len(self.replicas),
               "n_live": self.n_live,
               "wall_s": round(wall, 6),
               "ticks": self.n_ticks,
               "gen_tokens": sum(len(res.tokens) for res in self.completed),
               "plan": self.plan.to_genome(),
               "per_replica": [], "per_variant": {}}
        out["throughput_tok_s"] = round(
            out["gen_tokens"] / wall, 3) if wall > 0 else 0.0
        for r in self.replicas:
            s = r.engine.stats()
            out["per_replica"].append({
                "replica": r.index, "alive": r.alive,
                "fail_reason": r.fail_reason,
                "n_completed": s["n_completed"],
                "gen_tokens": s["gen_tokens"],
                "ticks": s["ticks"],
                "prefill_batches": s["prefill_batches"],
                "decode_batches": s["decode_batches"]})
        for variant in self.replicas[0].engine.cfgs:
            rs = [res for res in self.completed if res.variant == variant]
            if not rs:
                out["per_variant"][variant] = {
                    "n": 0, "gen_tokens": 0, "mean_latency_s": 0.0,
                    "p95_latency_s": 0.0, "mean_ttft_s": 0.0,
                    "s_per_token": 0.0}
                continue
            lat = np.array([res.latency for res in rs])
            toks = sum(len(res.tokens) for res in rs)
            out["per_variant"][variant] = {
                "n": len(rs),
                "gen_tokens": toks,
                "mean_latency_s": round(float(lat.mean()), 6),
                "p95_latency_s": round(float(np.percentile(lat, 95)), 6),
                "mean_ttft_s": round(
                    float(np.mean([res.ttft for res in rs])), 6),
                "s_per_token": round(float(lat.sum() / max(toks, 1)), 6),
            }
        return out

    def publish_stats(self, cache: FitnessCache, *, name: str, shape,
                      run: str = "", features=None,
                      meta: dict | None = None) -> list[str]:
        """Per-variant serve-tagged fitness records for the router's
        measurement, keyed by the FULL serving plan (engine schedule + KV
        plan + replica layout) so single-engine and multi-replica
        measurements of the same arch never collide.  First write wins,
        like every cache record."""
        if cache.writer is None:
            cache.writer = "serve"
        added = []
        for variant, rec in self.stats()["per_variant"].items():
            if rec["n"] == 0:
                continue
            body = {"kind": "serve_latency", "name": name,
                    "shape": shape_tag(shape), "variant": variant,
                    "schedule": dict(self.genome),
                    "n_replicas": len(self.replicas),
                    "run": run}
            key = "serve:" + hashlib.sha256(
                json.dumps(body, sort_keys=True).encode()).hexdigest()
            if key in cache:
                continue
            cache.put(key, EvalOutcome(
                fitness=(rec["s_per_token"], rec["mean_latency_s"])),
                features=features, meta=meta)
            added.append(key)
        return added


# --------------------------------------------------------------------------
# Building a router
# --------------------------------------------------------------------------


def build_router(cfg, params=None, *, genome: dict | None = None,
                 max_len: int = 128, device=None, evolved_cfg=None,
                 ab_fraction: float = 0.0, temperature: float = 0.0,
                 seed: int = 0, admit_max_wait: int = 32,
                 heartbeat_timeout: float = 8.0) -> Router:
    """Resolve a serve-plan genome into a running multi-replica router.

    The genome's ``replicas`` knob picks the fan-out; its KV plan clamps
    each replica's ``max_slots`` to what the plan's pages fit
    (:meth:`KVPlan.effective_slots`).  Every replica runs on ``device``
    (the GPU unless the caller names another; given ``params``, where they
    live) over the one set of weights: ``params``, or random ones from
    :func:`~repro_torch.models.transformer.init_params` (seed 0) made
    there."""
    g = dict(DEFAULT_SERVE_PLAN, **(genome or {}))
    plan = KVPlan.from_genome(g)
    if params is None:
        from ...models.transformer import init_params
        params = init_params(cfg, device=resolve_device(device))
        device = None               # the replicas run where the weights live
    slots = plan.effective_slots(int(g["max_slots"]), max_len)
    engines = [ServeEngine(cfg, params, max_len=max_len, max_slots=slots,
                           prefill_chunk=int(g["prefill_chunk"]),
                           evolved_cfg=evolved_cfg, ab_fraction=ab_fraction,
                           temperature=temperature, seed=seed + i,
                           admit_max_wait=admit_max_wait, device=device)
               for i in range(plan.replicas)]
    return Router(engines, plan=plan, genome=g,
                  heartbeat_timeout=heartbeat_timeout)


# --------------------------------------------------------------------------
# CLI smoke
# --------------------------------------------------------------------------


def main(argv=None) -> int:
    """``python -m repro_torch.core.deploy.router`` — build a router,
    replay a synthesized trace, print the stats JSON.  Exits nonzero if any
    accepted request fails to complete (the CI smoke contract)."""
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--arch", default="qwen3-0.6b")
    parser.add_argument("--smoke", action="store_true",
                        help="shrink the config to smoke size")
    parser.add_argument("--device", default=None,
                        help="torch device to serve on (default: the GPU; "
                             "without one, pass --device cpu)")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--scenario", default="bursty")
    parser.add_argument("--max-prompt", type=int, default=12)
    parser.add_argument("--gen", type=int, default=6)
    parser.add_argument("--max-slots", type=int, default=4)
    parser.add_argument("--prefill-chunk", type=int, default=2)
    parser.add_argument("--page-size", type=int, default=16)
    parser.add_argument("--kv-dtype", default="f32",
                        choices=("f32", "bf16", "int8"))
    parser.add_argument("--kill-at", type=int, default=-1,
                        help="kill replica 0 at this tick (failover demo)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cache", default="",
                        help="publish serve-tagged fitness records here")
    args = parser.parse_args(argv)

    from ...configs import get_config, smoke_config
    from ..liveloop.traces import synthesize
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"router: {e}") from None
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    trace = synthesize(args.scenario, vocab=cfg.vocab,
                       n_requests=args.requests,
                       max_prompt=args.max_prompt, gen=args.gen,
                       seed=args.seed)
    genome = {"max_slots": args.max_slots,
              "prefill_chunk": args.prefill_chunk,
              "kv_page_size": args.page_size, "kv_dtype": args.kv_dtype,
              "replicas": args.replicas}
    router = build_router(cfg, genome=genome, max_len=trace.max_len(),
                          device=device, seed=args.seed)
    reqs = trace.requests()
    i, tick = 0, 0
    accepted = 0
    while i < len(reqs) or router.busy:
        while i < len(reqs) and trace.items[i].at_tick <= tick:
            accepted += router.try_submit(reqs[i])
            i += 1
        if tick == args.kill_at and router.n_live > 1:
            router.kill_replica(0)
        router.step()
        tick += 1
    stats = router.stats()
    if args.cache:
        cache = FitnessCache(args.cache, writer="serve")
        router.publish_stats(cache, name=f"serve/{args.arch}",
                             shape=(args.requests, args.max_prompt,
                                    args.gen),
                             run=f"router-cli-seed{args.seed}")
        cache.close()
    print(json.dumps(stats, indent=1))
    return 0 if stats["n_completed"] == accepted else 1


if __name__ == "__main__":
    raise SystemExit(main())
