"""Multi-replica serving: a request router fanning traffic over N engines.

The counterpart of ``src/repro/core/deploy/router.py``.  One
:class:`~repro_torch.core.deploy.engine.ServeEngine` is a single decode
loop; a :class:`Router` puts N of them — data-parallel replicas — behind
one queue, and:

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
  build, a launch the device refused) is not one replica dying: replicas
  on one device share one CUDA context, whose errors are sticky, so it
  propagates out of :meth:`Router.step`;
* **reports** aggregate + per-replica stats and publishes serve-tagged
  fitness records keyed by the full serving plan, so the live loop's
  guardrails and the search see multi-replica measurements in the same
  store as everything else.

:func:`build_router` resolves a serve-plan genome (engine schedule + KV
plan, see :mod:`~repro_torch.core.deploy.kvplan`) into concrete replicas,
slot counts clamped by the plan's paged byte budget.  Without a mesh,
every replica runs on one device (the GPU unless the caller names
another) over one set of weights.  With a launch mesh (one process a
rank, ``launch/mesh.py``), the reference's one controller over every
device becomes one :class:`MeshRouter` on every rank:

* :func:`replica_meshes` splits the mesh's data rows into the replicas'
  submeshes, the reference's reshape;
* :func:`shard_replica_params` and :func:`shard_engine_caches` place a
  replica's weights and lane caches on its submesh under ``param_specs``
  and ``cache_specs`` (DTensors, each rank its block: the record of the
  placement);
* the replica's engine serves under a tensor-parallel ``Dist`` over the
  submesh, as the reference's GSPMD partitions its jitted prefill and
  decode by those placements: its weights are each rank's local tensors,
  made once at build (``shardings.local_model``: a leaf placed on its
  layer's split dimension kept as the rank's block over ``model``,
  gathered over the data axes only; any other gathered whole), and its
  lane caches each rank's blocks, plain tensors (``engine.CacheBlock``);
  each layer computes on its blocks (models/transformer.py), the logits
  are gathered over ``model`` and over the lanes' data axes, and no tick
  gathers a weight or a cache;
* every rank routes, fails and drains the same way, steps only its own
  replica, and after each tick hears every replica's outcome from its
  first rank in one ``all_gather_object`` over a gloo group of its own;
* a replica fails when any of its ranks failed.  A fault that only one
  rank hits leaves its peers waiting in a layer's collective: the
  replica's process groups time out after ``FAULT_TIMEOUT`` seconds,
  which fails the step on those ranks too (gloo raises; on NCCL the
  watchdog ends the process at the timeout instead, so there such a
  fault ends the replica's ranks rather than failing the replica over).

``python -m repro_torch.core.deploy.router`` is the CLI smoke: build a
router (``--mesh DATAxMODEL``: over that many ranks, which it starts on
the CPU), replay a synthesized trace, print the stats JSON (optionally
killing a replica mid-replay to show the failover path).
"""

from __future__ import annotations

import copy
import hashlib
import json
import time as _time
from collections import deque
from dataclasses import astuple, dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _set_pg_timeout

from ...device import DeviceFault, resolve_device
from ...launch.mesh import mesh_axes
from ...launch.shardings import (cache_specs, distribute, local_model,
                                 param_specs, to_shardings)
from ...train.fault import HeartbeatMonitor
from ..evaluator import EvalOutcome, FitnessCache
from ..fitness import DEVICE_FAULTS
from .engine import (DEFAULT_SERVE_PLAN, ServeEngine, ServeRequest,
                     ServeResult, _Lane, _LaneBatch)
from .kvplan import KVPlan
from .registry import shape_tag


# seconds a rank of a meshed replica waits in one of its replica's
# collectives before its step fails (the module doc): longer than any
# wait for a peer in a step, a kernel build included
FAULT_TIMEOUT = 300.0

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
        self._end_tick()

    def _end_tick(self) -> None:
        """Fail the replicas whose heartbeat lapsed, collect every
        replica's results, and on a total outage reject the backlog."""
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
# Replicas on submeshes of a launch mesh
# --------------------------------------------------------------------------


class _MirrorEngine:
    """One replica's engine as every rank of a meshed router sees it: the
    bookkeeping of a :class:`ServeEngine` (its queue, the requests in its
    lanes, its results and counts) without its model, set after each tick
    from the replica's first rank (:meth:`snapshot` there, :meth:`restore`
    on every rank).  The router routes to, reads and fails a replica
    through its mirror alone, so every rank's router holds the same state.
    On the replica's own ranks the mirror also holds the engine
    (``real``), to which it passes each submission."""

    stats = ServeEngine.stats
    busy = ServeEngine.busy
    _n_in_flight = ServeEngine._n_in_flight

    def __init__(self, cfgs: dict, max_len: int, max_slots: int,
                 real: ServeEngine | None = None):
        self.cfgs, self.max_len, self.max_slots = cfgs, max_len, max_slots
        self.real = real
        self.queue: deque[ServeRequest] = deque()
        self.batches = {v: _LaneBatch(max_slots) for v in cfgs}
        self.completed: list[ServeResult] = []
        self.n_rejected = 0
        self._t0: float | None = None
        self._t_last = 0.0
        self.n_ticks = self.n_prefill_batches = self.n_decode_batches = 0
        self._requests: list[ServeRequest] = []     # by submission key
        self._key: dict[int, int] = {}              # id(request) -> key
        self._sent = 0          # real.completed rows already snapshotted

    def submit(self, req: ServeRequest) -> None:
        if self.real is not None:
            self.real.submit(req)
        self._key[id(req)] = len(self._requests)
        self._requests.append(req)
        self.queue.append(req)

    def snapshot(self) -> dict:
        """The engine's bookkeeping after a tick: its requests by
        submission key, the results completed since the last snapshot."""
        e, key = self.real, self._key
        new = e.completed[self._sent:]
        self._sent = len(e.completed)
        return {"queue": [key[id(r)] for r in e.queue],
                "lanes": {v: [None if lane is None else key[id(lane.req)]
                              for lane in b.lanes]
                          for v, b in e.batches.items()},
                "completed": [astuple(r) for r in new],
                "counts": (e.n_ticks, e.n_prefill_batches,
                           e.n_decode_batches, e.n_rejected, e._t0,
                           e._t_last)}

    def restore(self, snap: dict) -> None:
        reqs = self._requests
        self.queue = deque(reqs[k] for k in snap["queue"])
        for v, keys in snap["lanes"].items():
            self.batches[v].lanes = [
                None if k is None else _Lane(req=reqs[k], index=0,
                                             tokens=[], last=0, res=None)
                for k in keys]
        self.completed += [ServeResult(*row) for row in snap["completed"]]
        (self.n_ticks, self.n_prefill_batches, self.n_decode_batches,
         self.n_rejected, self._t0, self._t_last) = snap["counts"]


class MeshRouter(Router):
    """A :class:`Router` whose replicas live on submeshes of a launch
    mesh, one process a rank (see the module doc).  Every rank holds this
    router over every replica (as :class:`_MirrorEngine`\\ s) and steps
    the replica whose ``submesh`` holds it (``replica``); one
    ``all_gather_object`` a tick over ``group`` (gloo, none of the
    replicas' own) then hands every rank each replica's outcome, from its
    first rank; a fault on one rank mid-step fails its peers' step when
    the replica's groups time out (:data:`FAULT_TIMEOUT`, the module
    doc).  ``placed`` is the rank's replica's model of DTensor
    parameters (:func:`shard_replica_params`), the record its engine's
    local weights were made from.  A
    :data:`~repro_torch.core.fitness.DEVICE_FAULTS` fault on
    any rank leaves :meth:`step` on every rank.  ``stats()`` is the same on
    every rank: its times are those of each replica's first rank, its
    start rank 0's.  Only rank 0 writes :meth:`publish_stats`' records."""

    def __init__(self, engines: list[_MirrorEngine], *, replica: int,
                 submesh, group=None, placed=None, **kw):
        super().__init__(engines, **kw)
        self.replica = replica
        self.submesh = submesh
        self.placed = placed        # this rank's replica's DTensor weights
        self._group = group
        self._speaker = int(submesh.mesh.flatten()[0]) == dist.get_rank()
        self._fault: BaseException | None = None

    def _step_own(self, engine: ServeEngine) -> tuple | None:
        """Step this rank's replica on its blocks; its fault as (phase,
        reason), if any (a device fault is kept, to be raised once every
        rank has heard of it)."""
        phase = "begin"
        try:
            pending = engine.begin_step()
            phase = "finish"
            engine.finish_step(pending)
        except DEVICE_FAULTS as e:
            self._fault = e
            return ("device", f"{type(e).__name__}: {e}")
        except Exception as e:              # noqa: BLE001 — replica fault
            return (phase, f"{phase}_step: {type(e).__name__}: {e}")
        return None

    def step(self) -> None:
        """One tick on every rank: route the backlog (the same on every
        rank), step this rank's replica, hear every rank's outcome, then
        fail, heartbeat and harvest as :meth:`Router.step` does: faults of
        ``begin_step`` first, then of ``finish_step``, each in replica
        order.  A replica fails when any of its ranks failed; its requests
        are requeued from its first rank's state."""
        if self._t0 is None:
            self._t0 = _time.perf_counter()
        self.n_ticks += 1
        self._dispatch()
        mine = self.replicas[self.replica]
        fault = self._step_own(mine.engine.real) if mine.alive else None
        records = self._hear({
            "replica": self.replica, "fault": fault, "t0": self._t0,
            "state": (mine.engine.snapshot()
                      if self._speaker and mine.alive else None)})
        self._t0 = records[0]["t0"]
        for rank, rec in enumerate(records):
            if rec["fault"] is not None and rec["fault"][0] == "device":
                if self._fault is not None:
                    err, self._fault = self._fault, None
                    raise err
                raise DeviceFault(f"replica {rec['replica']} (rank {rank}): "
                                  f"{rec['fault'][1]}")
        faults: dict[int, tuple] = {}
        for rec in records:
            if rec["state"] is not None:
                self.replicas[rec["replica"]].engine.restore(rec["state"])
            if rec["fault"] is not None:
                faults.setdefault(rec["replica"], rec["fault"])
        for phase in ("begin", "finish"):
            for r in self._live():
                if faults.get(r.index, ("",))[0] == phase:
                    self._fail(r, faults[r.index][1])
        for r in self._live():
            self.monitor.heartbeat(r.index, now=float(self.n_ticks))
        self._end_tick()

    def _hear(self, record: dict) -> list:
        """Every rank's ``record`` of this tick, by rank."""
        records: list = [None] * dist.get_world_size(self._group)
        dist.all_gather_object(records, record, group=self._group)
        return records

    def publish_stats(self, cache: FitnessCache, **kw) -> list[str]:
        if dist.get_rank() != 0:
            return []
        return super().publish_stats(cache, **kw)


def _check_split(rows: int, n_replicas: int) -> None:
    if n_replicas < 1 or rows % n_replicas:
        raise ValueError(f"cannot split {rows} data rows into "
                         f"{n_replicas} replicas")


def replica_meshes(mesh, n_replicas: int) -> list:
    """Split a ``(data, model)`` mesh into ``n_replicas`` row-group
    submeshes — each replica owns ``data_rows / n_replicas`` rows with the
    full model axis — as ``DeviceMesh``\\ es under the mesh's axis names.
    A submesh's process groups are made by every rank of the mesh, so
    every rank calls this with the same arguments, in the same order as
    its other collectives; a rank outside a submesh holds it with no
    coordinate (``get_coordinate()`` is None)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh
    rows = ranks.shape[0]
    _check_split(rows, n_replicas)
    groups = ranks.reshape(n_replicas, rows // n_replicas, *ranks.shape[1:])
    return [DeviceMesh(mesh.device_type, g,
                       mesh_dim_names=tuple(mesh.mesh_dim_names))
            for g in groups]


def _mesh_sizes(mesh) -> tuple[tuple[str, ...], str, int, int]:
    dp_axes, model_axis = mesh_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp_size = int(np.prod([sizes[a] for a in dp_axes])) if dp_axes else 1
    return dp_axes, model_axis, dp_size, int(sizes[model_axis])


def shard_replica_params(params, submesh):
    """Place one replica's parameters on its submesh per ``param_specs``:
    a model of DTensor parameters, each rank holding its block (the
    counterpart of the reference's ``jax.device_put``).  The caller's
    ``params`` are left as they are."""
    dp_axes, model_axis, _, _ = _mesh_sizes(submesh)
    placed = copy.deepcopy(params, {id(p): p for p in params.parameters()})
    specs = param_specs(placed, submesh, dp_axes=dp_axes,
                        model_axis=model_axis)
    return distribute(placed, to_shardings(submesh, specs))


def shard_engine_caches(engine: ServeEngine, submesh) -> None:
    """Pre-allocate every variant's stacked lane caches sharded over the
    replica's submesh per ``cache_specs`` (the lane axis is the cache's
    batch dim), so decode runs on placed caches from the first tick; the
    engine's allocation at the first admission then leaves them as they
    are.  The engine steps on each rank's blocks, plain tensors
    (``caches``, where each lies in ``blocks``); the DTensors over the same
    memory stay as the record (``placed``)."""
    from ...models.transformer import init_cache
    from .engine import CacheBlock
    dp_axes, model_axis, dp_size, model_size = _mesh_sizes(submesh)
    for variant, cfg in engine.cfgs.items():
        batch = engine.batches[variant]
        stacked = init_cache(cfg, batch.n_lanes, engine.max_len,
                             device=engine.device)
        specs = cache_specs(cfg, stacked, dp_axes=dp_axes,
                            model_axis=model_axis, dp_size=dp_size,
                            model_size=model_size)
        batch.placed = distribute(stacked, to_shardings(submesh, specs))
        batch.caches = {k: t._local_tensor for k, t in batch.placed.items()}
        batch.blocks = {k: CacheBlock.of(t, model_axis)
                        for k, t in batch.placed.items()}


def _mesh_device(mesh, device) -> torch.device:
    """The device of this rank of ``mesh``: its GPU, or the CPU."""
    own = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    if device is not None and resolve_device(device).type != own.type:
        raise ValueError(f"device {device} is not the mesh's "
                         f"({mesh.device_type})")
    return own


def build_router(cfg, params=None, *, genome: dict | None = None,
                 max_len: int = 128, mesh=None, device=None, evolved_cfg=None,
                 ab_fraction: float = 0.0, temperature: float = 0.0,
                 seed: int = 0, admit_max_wait: int = 32,
                 heartbeat_timeout: float = 8.0) -> Router:
    """Resolve a serve-plan genome into a running multi-replica router.

    The genome's ``replicas`` knob picks the fan-out; its KV plan clamps
    each replica's ``max_slots`` to what the plan's pages fit
    (:meth:`KVPlan.effective_slots`).  Without ``mesh``, every replica
    runs on ``device`` (the GPU unless the caller names another; given
    ``params``, where they live) over the one set of weights: ``params``,
    or random ones from :func:`~repro_torch.models.transformer.init_params`
    (seed 0) made there.

    With ``mesh`` (e.g. ``make_smoke_mesh()``; every rank calls this with
    the same arguments and weights), the mesh's data rows are split
    across replicas (:func:`replica_meshes`); each rank places its
    replica's parameters and decode caches on the replica's submesh
    (:func:`shard_replica_params`, :func:`shard_engine_caches`), gives
    its engine the rank's local weights and a tensor-parallel ``Dist``
    over the submesh (its data axes the lanes' batch axes, its caches
    ``max_len`` long), and returns a :class:`MeshRouter` on its rank's
    device.  The replica's process groups time out after
    ``FAULT_TIMEOUT`` seconds, so that a fault on one of its ranks fails
    the step on the others too (the module doc)."""
    g = dict(DEFAULT_SERVE_PLAN, **(genome or {}))
    plan = KVPlan.from_genome(g)
    if mesh is not None:
        device = _mesh_device(mesh, device)
    if params is None:
        from ...models.transformer import init_params
        params = init_params(cfg, device=resolve_device(device))
        device = None               # the replicas run where the weights live
    slots = plan.effective_slots(int(g["max_slots"]), max_len)
    kw = dict(max_len=max_len, max_slots=slots,
              prefill_chunk=int(g["prefill_chunk"]), evolved_cfg=evolved_cfg,
              ab_fraction=ab_fraction, temperature=temperature,
              admit_max_wait=admit_max_wait)
    if mesh is None:
        engines = [ServeEngine(cfg, params, seed=seed + i, device=device,
                               **kw) for i in range(plan.replicas)]
        return Router(engines, plan=plan, genome=g,
                      heartbeat_timeout=heartbeat_timeout)
    if params.device.type != mesh.device_type:
        raise ValueError(f"params live on {params.device}, the mesh is over "
                         f"{mesh.device_type} devices")
    submeshes = replica_meshes(mesh, plan.replicas)
    own = next(i for i, sm in enumerate(submeshes)
               if sm.get_coordinate() is not None)
    from ...models.transformer import Dist
    dp_axes, model_axis, _, _ = _mesh_sizes(submeshes[own])
    serve = Dist(mesh=submeshes[own], batch_axes=dp_axes,
                 model_axis=model_axis, tensor_parallel=True,
                 cache_len=max_len)
    for i in range(submeshes[own].ndim):
        _set_pg_timeout(timedelta(seconds=FAULT_TIMEOUT),
                        submeshes[own].get_group(i))
    placed = shard_replica_params(params, submeshes[own])
    engine = ServeEngine(cfg, local_model(cfg, placed, serve)[0],
                         dist=serve, seed=seed + own, **kw)
    shard_engine_caches(engine, submeshes[own])
    mirrors = [_MirrorEngine(engine.cfgs, max_len, engine.max_slots,
                             real=engine if i == own else None)
               for i in range(plan.replicas)]
    group = dist.new_group(backend="gloo")
    return MeshRouter(mirrors, replica=own, submesh=submeshes[own],
                      group=group, placed=placed, plan=plan, genome=g,
                      heartbeat_timeout=heartbeat_timeout)


# --------------------------------------------------------------------------
# CLI smoke
# --------------------------------------------------------------------------


def main(argv=None) -> int:
    """``python -m repro_torch.core.deploy.router`` — build a router,
    replay a synthesized trace, print the stats JSON.  Exits nonzero if any
    accepted request fails to complete (the CI smoke contract)."""
    import argparse
    import sys

    from ...launch.mesh import RankFailure, on_mesh, parse_mesh

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--arch", default="qwen3-0.6b")
    parser.add_argument("--smoke", action="store_true",
                        help="shrink the config to smoke size")
    parser.add_argument("--device", default=None,
                        help="torch device to serve on (default: the GPU; "
                             "without one, pass --device cpu)")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--mesh", default="",
                        help="DATAxMODEL smoke mesh, e.g. 2x2, one rank a "
                             "device (on the CPU this command starts that "
                             "many gloo ranks; a GPU takes one NCCL rank); "
                             "empty = no mesh")
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
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"router: {e}") from None
    if not args.mesh:
        return _serve_trace(args, device, None)
    shape = parse_mesh(args.mesh)
    _check_split(shape[0], args.replicas)   # before any rank starts
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        rc = on_mesh("repro_torch.core.deploy.router", argv, device, shape,
                     lambda mesh: _serve_trace(args, device, mesh))
    except RankFailure as e:    # a rank exited nonzero, or was killed
        print(f"router: --mesh {args.mesh}: {e}", file=sys.stderr)
        return 1
    return 0 if isinstance(rc, list) else rc    # the ranks all exited 0


def _serve_trace(args, device, mesh) -> int:
    """The CLI's replay on ``device``, or on this rank of ``mesh``."""
    from ...configs import get_config, smoke_config
    from ..liveloop.traces import synthesize
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
                          mesh=mesh, device=device, seed=args.seed)
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
    if args.cache and (mesh is None or dist.get_rank() == 0):
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
