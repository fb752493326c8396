"""The continuous-batching serving loop: evolved genomes under live traffic.

The counterpart of ``src/repro/core/deploy/engine.py`` on one device (the
GPU unless the caller names another).  The reference vmaps one decode
dispatch over its lanes; here the lanes are the batch of one
``decode_step`` with a (lanes,) tensor of cache indices, and the caches
are written in place.  The model's kernels (rmsnorm, flash attention in
prefill, the selective scan in mamba1's prefill) run inside the model
functions.

The previous ``launch/serve.py`` was a one-shot demo — fix a batch of B
prompts, prefill them together, decode them in lockstep, exit.  Production
serving is a *queue*: requests arrive over time with different prompt and
generation lengths, and throughput comes from keeping the decode batch full
while new arrivals prefill.  :class:`ServeEngine` is that loop, sized for
this repo's smoke configs but shaped like the real thing:

* a **request queue** with slot admission — up to ``max_slots`` sequences
  in flight, ``prefill_chunk`` new admissions micro-batched per tick;
* **prefill/decode interleaving** — each tick admits + prefills new
  requests (grouped by prompt length, so prefill batches are pad-free) and
  advances every in-flight sequence one token (grouped by cache position,
  so grouped decode is numerically identical to lockstep decode);
* **per-variant routing** — requests route to the ``default`` model
  configuration or to an ``evolved`` one (a distribution-plan artifact's
  serve-relevant knobs applied via ``cfg.scaled``), with an A/B fraction,
  so an evolved winner can take traffic gradually;
* **measured latency feedback** — per-request TTFT / latency / tokens, and
  :meth:`publish_stats` writes per-variant (s/token, mean latency) records
  into the shared :class:`~repro_torch.core.evaluator.FitnessCache` under a
  ``serve`` writer tag — the serving fleet reports fitness into the same
  store the search reads.

The engine's *own* schedule (``max_slots``, ``prefill_chunk``) — joined
with the KV memory plan from :mod:`~repro_torch.core.deploy.kvplan` (page
size, cache dtype, replica layout) — is a searchable genome:
:func:`serve_schedule_space` declares the merged plan as a
:class:`~repro_torch.core.schedule.ScheduleSpace` and
:func:`build_serve_workload` wraps a replayed request trace as a
measured-fitness :class:`~repro_torch.core.fitness.KernelWorkload`, so
``GevoML`` evolves the serving plan with the same engine that evolves
kernels — and the winner ships through the
:class:`~repro_torch.core.deploy.registry.ArtifactRegistry`.

Model functions are imported lazily from ``repro_torch.models`` (this
module is the bridge between the core search stack and the model stack).
Several engines behind one queue are the router's
(:mod:`~repro_torch.core.deploy.router`), on one device or each on a
submesh of a launch mesh.  There an engine serves under the router's
tensor-parallel ``Dist`` (``dist``): its weights and lane caches are this
rank's blocks, plain tensors, every prefill and decode step runs on them,
each rank decodes its block of the lanes (the lane axis split over the
data axes where ``cache_specs`` puts it) and the logits of every lane are
gathered before sampling, so every rank samples the same tokens (at a
temperature, from identical generators).  Without a mesh ``dist`` is the
empty ``Dist()`` and nothing of this runs.
"""

from __future__ import annotations

import hashlib
import json
import time as _time
import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ...device import resolve_device
from ..evaluator import EvalOutcome, FitnessCache
from ..schedule import ScheduleSpace
from .kvplan import DEFAULT_KV_PLAN, KV_SPACE, KVPlan
from .registry import Artifact, shape_tag

# Model-config knobs a serving path may safely take from a distribution-plan
# artifact (training-only knobs like remat/loss_chunk are ignored).
SERVE_PLAN_KEYS = ("attn_impl", "attn_block")

# The engine's own searchable schedule + the shipped default (the old
# one-shot launcher behaved like a conservative 2-slot engine).
ENGINE_SPACE: dict[str, tuple] = {"max_slots": (1, 2, 4, 8),
                                  "prefill_chunk": (1, 2, 4)}
DEFAULT_ENGINE_SCHEDULE: dict = {"max_slots": 2, "prefill_chunk": 1}

# The full serving plan: the engine schedule joined with the KV memory /
# parallelism plan (``kvplan.KV_SPACE``) — slots × prefill chunk × page
# size × cache dtype × replica layout as ONE genome space, so the search
# trades memory residency against decode error against replica throughput
# in a single Pareto front.
SERVE_SPACE: dict[str, tuple] = {**ENGINE_SPACE, **KV_SPACE}
DEFAULT_SERVE_PLAN: dict = {**DEFAULT_ENGINE_SCHEDULE, **DEFAULT_KV_PLAN}


def serve_schedule_space(arch: str) -> ScheduleSpace:
    """The full serving plan (engine schedule + KV memory plan) as a
    searchable genome space."""
    return ScheduleSpace.of(f"serve/{arch}", SERVE_SPACE)


def apply_plan_artifact(cfg, artifact: Artifact | None):
    """The evolved model configuration for serving: the artifact's
    serve-relevant knobs applied over ``cfg`` (weights stay compatible —
    these knobs change the computation schedule, not the parameters)."""
    if artifact is None:
        return cfg
    fields = {k: artifact.genome[k] for k in SERVE_PLAN_KEYS
              if k in artifact.genome}
    return cfg.scaled(**fields) if fields else cfg


def engine_schedule_from(artifact: Artifact | None) -> dict:
    """The engine schedule an artifact prescribes (defaults filled in;
    KV-plan knobs are resolved separately — :func:`serve_plan_from`)."""
    g = dict(DEFAULT_ENGINE_SCHEDULE)
    if artifact is not None:
        g.update({k: artifact.genome[k] for k in ENGINE_SPACE
                  if k in artifact.genome})
    return g


def serve_plan_from(artifact: Artifact | None) -> dict:
    """The FULL serving plan an artifact prescribes: engine schedule plus
    KV-plan knobs, every missing knob at its shipped default — the genome
    the router and the live loop hand to
    :meth:`~repro_torch.core.deploy.kvplan.KVPlan.from_genome`."""
    g = dict(DEFAULT_SERVE_PLAN)
    if artifact is not None:
        g.update({k: artifact.genome[k] for k in SERVE_SPACE
                  if k in artifact.genome})
    return g


# --------------------------------------------------------------------------
# Requests and results
# --------------------------------------------------------------------------


@dataclass
class ServeRequest:
    """One generation request: a prompt (1-D int token array) and a token
    budget.  ``variant`` pins the route (``"default"``/``"evolved"``);
    ``None`` lets the engine's A/B fraction decide."""

    uid: str
    tokens: np.ndarray
    max_new_tokens: int = 16
    eos_id: int | None = None
    variant: str | None = None


@dataclass
class ServeResult:
    """A completed request: generated tokens, the route it took, and its
    measured timeline (submit -> admit -> first token -> done)."""

    uid: str
    variant: str
    tokens: list[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit


@dataclass
class _Lane:
    """One resident sequence in a variant's lane batch."""
    req: ServeRequest
    index: int                      # current cache length (next write pos)
    tokens: list[int]
    last: int
    res: ServeResult


class _LaneBatch:
    """A variant's fixed-width continuous batch: ``n_lanes`` resident
    sequences sharing ONE stacked cache (lane axis 1, the batch axis of the
    model's caches), advanced by a single decode step per tick with a
    per-lane cache index.  Lane shapes never change; a finished lane's
    cache is simply overwritten at the next admission.  On a replica's
    submesh ``caches`` are this rank's blocks (``blocks`` says where each
    lies, ``placed`` keeps them as DTensors over the same memory, the
    record of the placement)."""

    def __init__(self, n_lanes: int):
        self.n_lanes = n_lanes
        self.lanes: list[_Lane | None] = [None] * n_lanes
        self.caches = None           # allocated lazily at first admission
        self.blocks: dict | None = None
        self.placed: dict | None = None

    def lane_block(self) -> tuple[int, int]:
        """(first lane, lanes) of the rank's block: every lane unplaced."""
        if not self.blocks:
            return 0, self.n_lanes
        b = next(iter(self.blocks.values()))
        return b.lane0, b.lanes

    def free_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self.lanes) if l is None]

    def active(self) -> list[tuple[int, _Lane]]:
        return [(i, l) for i, l in enumerate(self.lanes) if l is not None]

    def n_active(self) -> int:
        return sum(1 for l in self.lanes if l is not None)


# --------------------------------------------------------------------------
# Lane caches
# --------------------------------------------------------------------------


# the cache leaves indexed by token position (models/transformer.py
# ``init_cache``); the others are recurrent states
TOKEN_LEAVES = ("k", "v", "ckv", "krope", "shared_k", "shared_v")


@dataclass(frozen=True)
class CacheBlock:
    """Where this rank's block of a stacked lane-cache leaf lies on a
    replica's submesh: its first lane and lane count (the lane axis over
    the data axes)."""
    lane0: int
    lanes: int

    @classmethod
    def of(cls, t, model_axis: str) -> "CacheBlock":
        """The block of the DTensor ``t`` (a (L, lanes, ...) leaf)."""
        mesh = t.device_mesh
        lane0, lanes = 0, t.shape[1]
        for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names,
                                           t.placements)):
            if pl.is_shard() and name != model_axis:
                # the lanes, over the batch axes, the first the major
                size = mesh.size(i)
                lanes //= size
                lane0 += mesh.get_local_rank(i) * lanes
        return cls(lane0, lanes)


def _write_lane(stacked: dict, lane: int, pre: dict, row: int,
                blocks: dict | None = None) -> None:
    """Install row ``row`` of a prefill's caches into lane ``lane`` of the
    stacked lane caches, in place: the lane's token-indexed leaves take
    the prefill's positions and zeros after them, its recurrent state
    leaves the prefill's states (the only per-admission cache traffic —
    decode itself never restacks).  With
    ``blocks`` (:class:`CacheBlock` a leaf) ``stacked`` holds this rank's
    blocks, and the prefill returned each leaf's block as its layer
    computed it (models/attention.py ``_cache_rows`` for a sequence split
    over the model axis): a lane outside the rank's lanes is left alone."""
    for name, full in stacked.items():
        b = blocks[name] if blocks else CacheBlock(0, full.shape[1])
        if not b.lane0 <= lane < b.lane0 + b.lanes:
            continue
        dst, src = full[:, lane - b.lane0], pre[name][:, row]
        if name in TOKEN_LEAVES:
            n = min(src.shape[1], dst.shape[1])
            dst.zero_()
            dst[:, :n].copy_(src[:, :n])
        elif src.shape == dst.shape:
            dst.copy_(src)
        else:  # a conv tail shorter than the conv (prompt < taps - 1)
            dst.zero_()


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------


class ServeEngine:
    """Continuous-batching serving over one model's parameters.

    ``cfg`` is the default-route :class:`~repro_torch.models.common.
    ModelConfig`; ``evolved_cfg`` (optional, same parameter shapes) is the
    evolved route, taking ``ab_fraction`` of unpinned requests.
    ``params=None`` initializes random weights (seed 0; the smoke/demo
    path) on ``device``, the GPU unless the caller names another; given
    ``params``, the engine runs where they live.  ``max_len`` bounds
    ``prompt + generation`` per request; every slot cache is allocated at
    ``max_len`` so any group of slots can decode together.

    ``admit_max_wait`` bounds admission reordering: the prompt-length
    grouping below prefers same-length prefill batches, but any request
    queued longer than this many ticks forces strict oldest-first
    admission, so an odd-length prompt can never be starved behind a
    steady stream of grouping-friendly ones."""

    def __init__(self, cfg, params=None, *, max_len: int = 128,
                 max_slots: int = 4, prefill_chunk: int = 2,
                 evolved_cfg=None, ab_fraction: float = 0.0,
                 temperature: float = 0.0, seed: int = 0,
                 admit_max_wait: int = 32, device=None, dist=None):
        from ...models.transformer import Dist
        if cfg.family == "encoder":
            raise ValueError("encoder-only arch has no decode step")
        if max_slots < 1 or prefill_chunk < 1:
            raise ValueError("max_slots and prefill_chunk must be >= 1")
        if admit_max_wait < 1:
            raise ValueError("admit_max_wait must be >= 1")
        self.admit_max_wait = admit_max_wait
        self.cfgs = {"default": cfg}
        if evolved_cfg is not None:
            self.cfgs["evolved"] = evolved_cfg
        self.ab_fraction = ab_fraction
        self.max_len = max_len
        self.max_slots = max_slots
        self.prefill_chunk = prefill_chunk
        self.temperature = temperature
        self._route_rng = np.random.default_rng(seed)
        if device is None and params is not None:
            device = params.device
        self.device = resolve_device(device)
        if params is None:
            from ...models.transformer import init_params
            params = init_params(cfg, device=self.device)
        elif params.device != self.device:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"runs on {self.device}")
        self._sample_gen = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self.params = params
        self.dist = Dist() if dist is None else dist
        self.queue: deque[ServeRequest] = deque()
        self.batches = {v: _LaneBatch(max_slots) for v in self.cfgs}
        self.completed: list[ServeResult] = []
        self.n_rejected = 0
        self._t0: float | None = None
        self._t_last: float = 0.0
        self.n_ticks = 0
        self.n_prefill_batches = 0
        self.n_decode_batches = 0

    # -- submission ----------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        tokens = np.asarray(req.tokens, np.int32).reshape(-1)
        if len(tokens) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(tokens)} + "
                f"{req.max_new_tokens} new tokens exceeds max_len "
                f"{self.max_len}")
        if req.variant is not None and req.variant not in self.cfgs:
            raise ValueError(f"request {req.uid}: unknown variant "
                             f"{req.variant!r} (have {list(self.cfgs)})")
        req.tokens = tokens
        req._t_submit = _time.perf_counter()
        req._enq_tick = self.n_ticks
        self.queue.append(req)

    def try_submit(self, req: ServeRequest) -> bool:
        """Admission-or-reject: like :meth:`submit` but malformed requests
        (over-budget prompt, unknown variant) are *counted*, not raised — a
        live replay loop must survive bad traffic.  Returns whether the
        request was accepted."""
        try:
            self.submit(req)
        except ValueError:
            self.n_rejected += 1
            return False
        return True

    def submit_many(self, reqs) -> None:
        for r in reqs:
            self.submit(r)

    # -- routing -------------------------------------------------------------
    def _route(self, req: ServeRequest) -> str:
        if req.variant is not None:
            return req.variant
        if "evolved" in self.cfgs and \
                self._route_rng.random() < self.ab_fraction:
            return "evolved"
        return "default"

    # -- prefill (admission) -------------------------------------------------
    def _token_batch(self, cfg, tokens_2d, positions_2d):
        pos = torch.as_tensor(np.array(positions_2d), device=self.device)
        b = {"tokens": torch.as_tensor(np.asarray(tokens_2d),
                                       device=self.device),
             "positions": pos}
        if cfg.mrope:
            b["positions3"] = pos[..., None].expand(pos.shape + (3,))
        return b

    def _n_in_flight(self) -> int:
        return sum(b.n_active() for b in self.batches.values())

    def _select_admissions(self, n_take: int) -> list[ServeRequest]:
        """Pick ``n_take`` queued requests for this tick's prefill.

        Preference: the queue's most common prompt length (ties broken
        toward the earliest arrival), so a full chunk usually prefills as
        ONE pad-free batch; remaining seats fill oldest-first.  Bound: if
        the oldest queued request has waited ``admit_max_wait`` ticks, the
        whole pick is strict FIFO — grouping must never starve an
        odd-length prompt behind a steady stream of same-length ones."""
        q = self.queue
        if self.n_ticks - getattr(q[0], "_enq_tick", self.n_ticks) \
                >= self.admit_max_wait:
            return [q.popleft() for _ in range(n_take)]
        counts: dict[int, int] = {}
        first_at: dict[int, int] = {}
        for i, r in enumerate(q):
            plen = len(r.tokens)
            counts[plen] = counts.get(plen, 0) + 1
            first_at.setdefault(plen, i)
        best = max(counts, key=lambda p: (counts[p], -first_at[p]))
        take: list[ServeRequest] = []
        rest: list[ServeRequest] = []
        for r in q:
            if len(r.tokens) == best and len(take) < n_take:
                take.append(r)
            else:
                rest.append(r)
        while len(take) < n_take:
            take.append(rest.pop(0))
        self.queue = deque(rest)
        return take

    def _admit(self) -> None:
        from ...models.transformer import init_cache, prefill
        n_free = self.max_slots - self._n_in_flight()
        n_take = min(n_free, self.prefill_chunk, len(self.queue))
        if n_take <= 0:
            return
        admitted = self._select_admissions(n_take)
        t_admit = _time.perf_counter()
        groups: dict[tuple, list[ServeRequest]] = {}
        for req in admitted:
            groups.setdefault((self._route(req), len(req.tokens)),
                              []).append(req)
        for (variant, plen), reqs in groups.items():
            cfg = self.cfgs[variant]
            batch = self.batches[variant]
            G = len(reqs)
            toks = np.stack([r.tokens for r in reqs])
            pos = np.broadcast_to(np.arange(plen, dtype=np.int32)[None],
                                  (G, plen))
            logits, pre_caches = prefill(
                self.params, self._token_batch(cfg, toks, pos), cfg,
                self.dist)
            self.n_prefill_batches += 1
            first = self._sample(logits)
            t_first = _time.perf_counter()
            if batch.caches is None:
                batch.caches = init_cache(cfg, batch.n_lanes, self.max_len,
                                          device=self.device)
            free = batch.free_lanes()
            for i, req in enumerate(reqs):
                tok = int(first[i])
                res = ServeResult(
                    uid=req.uid, variant=variant,
                    t_submit=getattr(req, "_t_submit", t_admit),
                    t_admit=t_admit, t_first=t_first)
                lane = _Lane(req=req, index=plen, tokens=[tok], last=tok,
                             res=res)
                if not self._maybe_finish(lane, t_first):
                    li = free.pop(0)
                    batch.lanes[li] = lane
                    _write_lane(batch.caches, li, pre_caches, i,
                                batch.blocks)

    # -- decode --------------------------------------------------------------
    def _sample(self, logits):
        """Next tokens from (B, V) logits, greedy unless ``temperature`` >
        0 (then drawn from the engine's own ``torch.Generator``).  Copying
        them to the host waits for the device: this is where a tick blocks,
        as the reference blocks on its result."""
        if self.temperature > 0:
            probs = torch.softmax(
                logits.to(torch.float32) / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1,
                                    generator=self._sample_gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.cpu().numpy().astype(np.int32)

    def _decode_dispatch(self) -> list[tuple]:
        """Phase 1 of a decode tick: launch ONE batched decode step per
        active variant over all of its lanes and return the in-flight
        ``(variant, active, logits)`` work items *without* blocking on the
        results (the device runs them while the host goes on)."""
        from ...models.transformer import decode_step
        pending = []
        for variant in sorted(self.batches):
            batch = self.batches[variant]
            active = batch.active()
            if not active:
                continue
            cfg = self.cfgs[variant]
            # ONE fixed-shape decode step over every lane of this variant
            # (idle lanes run at index 0 and are ignored; their cache is
            # rewritten wholesale at the next admission)
            N = batch.n_lanes
            toks = np.zeros((N, 1), np.int64)
            pos = np.zeros((N, 1), np.int64)
            for i, lane in active:
                toks[i, 0] = lane.last
                pos[i, 0] = lane.index
            lo, n = batch.lane_block()
            tb = self._token_batch(cfg, toks[lo:lo + n], pos[lo:lo + n])
            logits, batch.caches = decode_step(
                self.params, tb, batch.caches, tb["positions"][:, 0], cfg,
                self.dist)
            if n < N:
                logits = self._all_lanes(logits)
            self.n_decode_batches += 1
            pending.append((variant, active, logits))
        return pending

    def _all_lanes(self, logits):
        """Every lane's logits from the ranks' lane blocks: gathered over
        the batch axes, minor first (the blocks' order), so every rank
        samples the same tokens."""
        from ...models.common import manual_axes, tp_gather
        axes = self.dist.batch_axes
        with manual_axes(self.dist.mesh, axes):
            for a in reversed(axes):
                logits = tp_gather(logits, a, 0)
        return logits

    def _decode_complete(self, pending: list[tuple]) -> None:
        """Phase 2 of a decode tick: sample next tokens (this is where the
        host blocks on device results) and advance lane bookkeeping."""
        for variant, active, logits in pending:
            batch = self.batches[variant]
            nxt = self._sample(logits)
            t_now = _time.perf_counter()
            for i, lane in active:
                lane.index += 1
                tok = int(nxt[i])
                lane.tokens.append(tok)
                lane.last = tok
                if self._maybe_finish(lane, t_now):
                    batch.lanes[i] = None

    def _decode_tick(self) -> None:
        self._decode_complete(self._decode_dispatch())

    def _maybe_finish(self, lane: _Lane, t_now: float) -> bool:
        req = lane.req
        done = (len(lane.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and lane.last == req.eos_id))
        if done:
            lane.res.tokens = list(lane.tokens)
            lane.res.t_done = t_now
            self.completed.append(lane.res)
            self._t_last = t_now
        return done

    # -- the loop ------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return bool(self.queue) or self._n_in_flight() > 0

    def begin_step(self) -> list[tuple]:
        """The first half of a tick: admit + micro-batch prefill new
        requests, then *dispatch* (without blocking) the decode batch."""
        if self._t0 is None:
            self._t0 = _time.perf_counter()
        self.n_ticks += 1
        self._admit()
        return self._decode_dispatch()

    def finish_step(self, pending: list[tuple]) -> None:
        """The second half of a tick: block on the dispatched decode,
        sample, and retire finished lanes."""
        self._decode_complete(pending)

    def step(self) -> None:
        """One engine tick: admit + micro-batch prefill new requests, then
        advance every in-flight sequence one decode step."""
        self.finish_step(self.begin_step())

    def run(self, requests=None, *, stagger: int | None = None
            ) -> list[ServeResult]:
        """Drive to completion: optionally submit ``requests`` (all upfront,
        or ``stagger`` per tick — arrivals mid-stream are what continuous
        batching exists for), then tick until queue and slots drain.
        Returns results in completion order."""
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

    # -- stats + feedback ----------------------------------------------------
    def stats(self) -> dict:
        """Aggregate measured serving stats, overall and per variant.
        Total on every path the live loop hits: before the first tick,
        mid-run before any completion, and after all-rejected admissions
        the numbers are well-defined zeros, never negative and never a
        raise.  Variants that completed nothing still get a zeroed row (so
        canary guardrails can read ``per_variant["evolved"]["n"] == 0``
        instead of catching ``KeyError``)."""
        # _t_last stays 0.0 until the first completion, so a mid-run read
        # would see a negative span; clamp to "no completed work yet".
        wall = max(self._t_last - self._t0, 0.0) \
            if self._t0 is not None else 0.0
        out = {"n_completed": len(self.completed),
               "n_rejected": self.n_rejected,
               "wall_s": round(wall, 6),
               "ticks": self.n_ticks,
               "prefill_batches": self.n_prefill_batches,
               "decode_batches": self.n_decode_batches,
               "gen_tokens": sum(len(r.tokens) for r in self.completed),
               "per_variant": {}}
        out["throughput_tok_s"] = round(
            out["gen_tokens"] / wall, 3) if wall > 0 else 0.0
        for variant in self.cfgs:
            rs = [r for r in self.completed if r.variant == variant]
            if not rs:
                out["per_variant"][variant] = {
                    "n": 0, "gen_tokens": 0, "mean_latency_s": 0.0,
                    "p95_latency_s": 0.0, "mean_ttft_s": 0.0,
                    "s_per_token": 0.0}
                continue
            lat = np.array([r.latency for r in rs])
            toks = sum(len(r.tokens) for r in rs)
            out["per_variant"][variant] = {
                "n": len(rs),
                "gen_tokens": toks,
                "mean_latency_s": round(float(lat.mean()), 6),
                "p95_latency_s": round(float(np.percentile(lat, 95)), 6),
                "mean_ttft_s": round(
                    float(np.mean([r.ttft for r in rs])), 6),
                "s_per_token": round(float(lat.sum() / max(toks, 1)), 6),
            }
        return out

    def publish_stats(self, cache: FitnessCache, *, name: str, shape,
                      run: str = "", features=None,
                      meta: dict | None = None) -> list[str]:
        """Feed measured per-variant serving fitness back into a shared
        :class:`FitnessCache` as ``serve``-tagged records (fitness =
        ``(s_per_token, mean_latency_s)``).  The key is a content hash of
        the measurement configuration — arch, shape, variant, AND the
        engine schedule — so measurements under different schedules never
        collide; like every cache record, a key already present is left
        untouched (first measurement wins), so pass a distinct ``run`` tag
        to record repeated measurements of the same configuration.
        Returns the keys of records actually added (empty if everything
        was already recorded).  Searches warm-starting from the same store
        see what deployment measured.

        ``features`` (a numeric vector, e.g. ``ScheduleFeaturizer.
        of_genome(schedule)``) makes the records *surrogate training
        rows*; ``meta`` (e.g. a :meth:`~repro_torch.core.liveloop.traces.Trace.
        spec`) rides along on the record so live traffic can later be
        re-synthesized from the store.  Variants that completed nothing
        are skipped — a zero measurement is not a measurement."""
        if cache.writer is None:
            cache.writer = "serve"
        added = []
        for variant, rec in self.stats()["per_variant"].items():
            if rec["n"] == 0:
                continue
            body = {"kind": "serve_latency", "name": name,
                    "shape": shape_tag(shape), "variant": variant,
                    "schedule": {"max_slots": self.max_slots,
                                 "prefill_chunk": self.prefill_chunk},
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
# Reference paths + the serving-schedule search workload
# --------------------------------------------------------------------------


def oneshot_generate(cfg, params, prompts: np.ndarray, gen: int,
                     max_len: int | None = None,
                     temperature: float = 0.0, device=None) -> np.ndarray:
    """The pre-engine one-shot behavior (batch prefill + lockstep decode of
    equal-length prompts) for ``--oneshot`` demos and convenience tests.
    Returns the ``(B, gen)`` continuation of ``prompts`` (greedy unless
    ``temperature`` > 0).  Note this runs through :class:`ServeEngine`
    itself — the engine-independent correctness oracle is the direct
    ``models.transformer`` prefill/decode loop (see
    ``tests/test_torch_serve.py``).  ``device`` as for the engine."""
    engine = ServeEngine(cfg, params, device=device,
                         max_len=max_len or (prompts.shape[1] + gen),
                         max_slots=len(prompts),
                         prefill_chunk=len(prompts),
                         temperature=temperature)
    reqs = [ServeRequest(uid=f"r{i}", tokens=p, max_new_tokens=gen)
            for i, p in enumerate(prompts)]
    results = {r.uid: r for r in engine.run(reqs)}
    return np.array([results[f"r{i}"].tokens for i in range(len(prompts))],
                    np.int32)


def demo_trace(cfg, *, n_requests: int, prompt_len: int, gen: int,
               seed: int = 0) -> list[ServeRequest]:
    """Deprecated: trace synthesis moved to ``repro_torch.core.liveloop.
    traces`` (:func:`~repro_torch.core.liveloop.traces.demo_requests` is
    this function; :func:`~repro_torch.core.liveloop.traces.synthesize`
    builds the richer scenario shapes).  This shim emits the same request
    list byte-for-byte and will be removed."""
    warnings.warn(
        "repro_torch.core.deploy.demo_trace is deprecated; use "
        "repro_torch.core.liveloop.traces.demo_requests (or synthesize) "
        "instead",
        DeprecationWarning, stacklevel=2)
    from ..liveloop.traces import demo_requests
    return demo_requests(cfg, n_requests=n_requests, prompt_len=prompt_len,
                         gen=gen, seed=seed)


def build_serve_workload(arch: str = "qwen3-0.6b", *, smoke: bool = True,
                         n_requests: int = 8, prompt_len: int = 16,
                         gen: int = 8, stagger: int = 2, seed: int = 0,
                         device=None):
    """The serving schedule as a GEVO scenario: genome = engine schedule
    (``max_slots``, ``prefill_chunk``), fitness = measured
    ``(s_per_token, mean_request_latency)`` from replaying a fixed request
    trace through a fresh :class:`ServeEngine`.  The weights (seed 0) are
    made once on ``device`` (the GPU unless the caller names another) and
    shared by every genome's engine, so the search measures the
    *schedule*."""
    from ...configs import get_config, smoke_config
    from ...models.transformer import init_params
    from ..fitness import KernelWorkload
    cfg = smoke_config(arch) if smoke else get_config(arch)
    params = init_params(cfg, device=resolve_device(device))
    space = serve_schedule_space(arch)
    max_len = prompt_len + gen

    def runner(genome: dict) -> tuple[float, float]:
        from ..liveloop.traces import demo_requests
        # the KV plan clamps residency: slots the plan's pages cannot fit
        # in the modeled byte budget are not granted
        plan = KVPlan.from_genome(genome)
        engine = ServeEngine(cfg, params, max_len=max_len,
                             max_slots=plan.effective_slots(
                                 genome["max_slots"], max_len),
                             prefill_chunk=genome["prefill_chunk"])
        engine.run(demo_requests(cfg, n_requests=n_requests,
                                 prompt_len=prompt_len, gen=gen, seed=seed),
                   stagger=stagger)
        s = engine.stats()
        per = s["per_variant"]["default"]
        return (s["wall_s"] / max(s["gen_tokens"], 1),
                per["mean_latency_s"])

    return KernelWorkload(
        name=f"serve/{arch}",
        program=space.encode(DEFAULT_SERVE_PLAN),
        space=space,
        runner=runner,
        time_mode="measured",
        kind="serve")
