"""The live loop: background evolution under replayed traffic, with canary
promotion.

The counterpart of ``src/repro/core/liveloop/controller.py``.  Its modeled
backend and everything it journals are the reference's, byte for byte;
its real backend replays traces through the port's engines on one device
(the GPU unless the caller names another).

:class:`LiveLoopController` closes the loop the ROADMAP left half-open:
serve latency already lands in the FitnessCache and the serve schedule is
already a ScheduleSpace genome, but nothing evolved *while serving*.  One
controller **tick** is one full turn of the crank:

1. **evolve** — advance a background :class:`~repro_torch.core.search.GevoML`
   island a few generations over the serve schedule space, fitness
   measured by replaying the controller's trace.  The search runs with the
   live surrogate (``surrogate_live=True``): every refit first reloads the
   shared cache, folding in the serve-tagged rows step 3 publishes — the
   online-refit extension of the PR-8 surrogate;
2. **select + export** — take the front's best-time genome, fingerprint
   it, and export it as a candidate artifact through the
   :class:`~repro_torch.core.deploy.registry.ArtifactRegistry` (idempotent:
   identical candidates write identical bytes);
3. **canary** — if no canary is in flight and the candidate is neither
   blocked nor already the incumbent, propose it to the
   :class:`~repro_torch.core.liveloop.canary.CanaryBook`; then measure one
   window — a canary-fraction slice of the trace, picked
   deterministically by :func:`~repro_torch.core.liveloop.canary.split_indices`
   and replayed under *both* genomes (shadow replay, so the ratios
   compare identical arrivals) — publish both measurements as
   feature-bearing serve records into the shared cache, journal the
   window, and let the guardrails decide;
4. **reconcile** — make the registry's ``live`` pointer match the
   journal's promoted entry (reconciliation, not an event reaction, so a
   crash between the journal commit and the export heals on the next
   tick).

Every piece of this is either idempotent or a pure function of journaled
state, so killing the process at an arbitrary point inside a tick and
resuming replays the journal and registry bit-exactly (the acceptance
test for the whole subsystem).

Two measurement backends share the controller logic: ``mode="modeled"``
uses :func:`simulate`, a deterministic discrete-event cost model of the
continuous-batching engine (fast, model-free — CI smokes and the
bit-exactness tests run here); ``mode="real"`` replays traces through
actual :class:`~repro_torch.core.deploy.ServeEngine` instances (the perf suite
runs here).  Regression injection for drills is a pure control-plane hook
(``fault_hook``), in the style of ``train/fault.py``: it perturbs the
canary's *measurements*, never the engine.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
from collections import deque

from ..deploy.engine import DEFAULT_SERVE_PLAN, serve_schedule_space
from ..deploy.kvplan import KV_SPACE, KVPlan
from ..deploy.registry import Artifact, ArtifactRegistry
from ..evaluator import EvalOutcome, FitnessCache, SerialEvaluator
from ..fitness import KernelWorkload
from ..search import GevoML
from ..serialize import atomic_write_json
from ..surrogate.features import ScheduleFeaturizer
from .canary import CanaryBook, Guardrails, split_indices
from .traces import Trace

STATE_VERSION = 1
# A real canary window on the GPU replays its slice this many times under
# each plan, the base's and the candidate's replays taken in turns: the
# replays are host-bound and the host's speed drifts over seconds, so
# three replays of one plan after three of the other rolled back a plan
# measured against itself (ROADMAP.md, section 3).  A plan is a kernel
# schedule, so it changes only device time: each replay's throughput is
# its generated tokens over the device's busy time (``_device_timed``):
# CUDA events around a replay hold the host's pauses, since the engine
# reads its tokens back every tick (on an H100 they put A/A windows under
# the 0.95 floor where busy time put none: ROADMAP.md, fault 3).
CARD_WINDOW_REPEATS = 15
# cycles the stream spins before a timed replay (at least the H100's top
# SM clock, 1.98 GHz: about 1 ms)
CARD_WINDOW_SPIN = 2_000_000
# a card replay's throughputs, by the device's busy time (the canary's)
# and by CUDA events around the replay (reported beside it)
CLOCK_KEYS = {"busy": "throughput_busy_tok_s",
              "events": "throughput_event_tok_s"}

METRIC_KEYS = ("throughput_tok_s", "mean_ttft_s", "reject_rate")


def genome_fingerprint(genome: dict) -> str:
    """The canary identity of a genome: a content hash of the knob dict
    alone (not its fitness, which varies run to run).  "Never re-promote
    the same fingerprint" means never re-promote the same knobs."""
    return hashlib.sha256(
        json.dumps(genome, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()


# --------------------------------------------------------------------------
# Modeled serving: a deterministic discrete-event model of the engine
# --------------------------------------------------------------------------


def simulate(trace: Trace, genome: dict, *, slow: float = 1.0) -> dict:
    """A pure-Python cost model of
    :class:`~repro_torch.core.deploy.ServeEngine` replaying ``trace``
    under serve genome ``genome``: slot admission (``max_slots``),
    micro-batched pad-free prefill (``prefill_chunk``,
    one batch per distinct prompt length), and one decode dispatch per
    tick advancing every lane.  Tick cost = base + prefill batches +
    decode dispatch, in modeled seconds; ``slow`` scales it (the fault
    hook's lever).  Deterministic in all inputs, no torch — the landscape
    the modeled evolution searches, and the modeled canary measurement.

    KV-plan knobs (any :data:`~repro_torch.core.deploy.kvplan.KV_SPACE` key
    present) extend the model: the plan's paged byte budget clamps
    ``max_slots`` (:meth:`KVPlan.effective_slots`) and ``replicas`` fans
    the trace round-robin over N concurrent engine models whose modeled
    wall is the slowest replica's — the data-parallel hardware model.
    Engine-only genomes behave exactly as before.

    Returns the same metric vocabulary the real engine's ``stats()``
    speaks: throughput_tok_s, mean_ttft_s, mean_latency_s, reject_rate,
    gen_tokens, wall_s, s_per_token."""
    m, c = int(genome["max_slots"]), int(genome["prefill_chunk"])
    if m < 1 or c < 1:
        raise ValueError("max_slots and prefill_chunk must be >= 1")
    replicas = 1
    if any(k in genome for k in KV_SPACE):
        plan = KVPlan.from_genome(genome)
        m = plan.effective_slots(m, trace.max_len())
        replicas = plan.replicas
    last_arrival = trace.n_ticks()
    if replicas <= 1:
        return _simulate_items(trace.items, last_arrival, m, c, slow)
    shards = [trace.items[i::replicas] for i in range(replicas)]
    runs = [_simulate_items(s, last_arrival, m, c, slow) for s in shards]
    # data-parallel replicas run concurrently: wall = slowest replica
    wall = max(r["wall_s"] for r in runs)
    gen_tokens = sum(r["gen_tokens"] for r in runs)
    n_done = sum(r["n"] for r in runs)

    def _wmean(key: str) -> float:
        tot = sum(r[key] * r["n"] for r in runs)
        return round(tot / n_done, 6) if n_done else 0.0
    return {"throughput_tok_s": round(gen_tokens / wall, 6) if wall
            else 0.0,
            "mean_ttft_s": _wmean("mean_ttft_s"),
            "mean_latency_s": _wmean("mean_latency_s"),
            "reject_rate": 0.0,
            "gen_tokens": gen_tokens,
            "wall_s": round(wall, 6),
            "s_per_token": round(wall / gen_tokens, 6) if gen_tokens
            else 0.0,
            "n": n_done}


def _simulate_items(items, last_arrival: int, m: int, c: int,
                    slow: float) -> dict:
    """One modeled engine replica over ``items`` (see :func:`simulate`)."""
    by_tick: dict[int, list] = {}
    for it in items:
        by_tick.setdefault(it.at_tick, []).append(it)
    queue: deque = deque()
    lanes: list[list] = []          # [item, tokens_remaining]
    submit_t: dict[int, float] = {}
    ttfts: list[float] = []
    lats: list[float] = []
    gen_tokens = 0
    t_now = 0.0
    tick = 0
    while queue or lanes or tick < last_arrival:
        for it in by_tick.get(tick, ()):
            queue.append(it)
            submit_t[it.index] = t_now
        n_take = min(m - len(lanes), c, len(queue))
        admitted = [queue.popleft() for _ in range(n_take)]
        # pad-free prefill: one batch per distinct prompt length
        n_groups = len({it.prompt_len for it in admitted})
        cost = 0.05 + 0.6 * n_groups \
            + 0.002 * sum(it.prompt_len for it in admitted)
        if lanes or admitted:
            cost += 1.0             # the single vmapped decode dispatch
        t_now += cost * slow
        for it in admitted:         # first token lands this tick
            ttfts.append(t_now - submit_t[it.index])
            gen_tokens += 1
            if it.max_new_tokens <= 1:
                lats.append(t_now - submit_t[it.index])
            else:
                lanes.append([it, it.max_new_tokens - 1])
        nxt = []
        for lane in lanes:          # one decode token per active lane
            if lane[0] in admitted:
                nxt.append(lane)    # admitted this tick; decodes next tick
                continue
            lane[1] -= 1
            gen_tokens += 1
            if lane[1] <= 0:
                lats.append(t_now - submit_t[lane[0].index])
            else:
                nxt.append(lane)
        lanes = nxt
        tick += 1
    wall = t_now
    n_done = len(lats)
    return {"throughput_tok_s": round(gen_tokens / wall, 6) if wall else 0.0,
            "mean_ttft_s": round(sum(ttfts) / n_done, 6) if n_done else 0.0,
            "mean_latency_s": round(sum(lats) / n_done, 6) if n_done else 0.0,
            "reject_rate": 0.0,
            "gen_tokens": gen_tokens,
            "wall_s": round(wall, 6),
            "s_per_token": round(wall / gen_tokens, 6) if gen_tokens
            else 0.0,
            "n": n_done}


def _median_run(runs: list) -> dict:
    """The metrics of the median-throughput run; where every run carries
    a throughput by each clock (``CLOCK_KEYS``), ``median_by_clock`` holds
    the median of each over the runs."""
    by_clock = {c: statistics.median(r[k] for r in runs)
                for c, k in CLOCK_KEYS.items() if all(k in r for r in runs)}
    runs = sorted(runs, key=lambda m: m["throughput_tok_s"])
    mid = runs[len(runs) // 2]
    return dict(mid, median_by_clock=by_clock) if by_clock else mid


def busy_seconds(prof) -> tuple[float, int]:
    """(seconds, count) of the device's kernels and copies in a
    torch.profiler profile, summed, but for the spin a stream is held
    with (``torch.cuda._sleep``'s ``spin_kernel``)."""
    from torch.autograd import DeviceType
    total, n = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA \
                and "spin_kernel" not in e.name():
            total += e.duration_ns()
            n += 1
    return total * 1e-9, n


def _device_timed(one):
    """``one`` (a replay returning its metrics) with its throughput taken
    over the device's busy time: the replay runs under torch.profiler with
    CUDA activity, and ``busy_s`` is the sum of its kernel and copy
    durations.  Beside it, CUDA events bracket the replay after the stream
    spun ``CARD_WINDOW_SPIN`` cycles, as ``measured_time`` brackets a
    timed call: ``device_s`` and ``throughput_event_tok_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def timed() -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(CARD_WINDOW_SPIN)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = one()
            end.record()
            end.synchronize()
        secs = start.elapsed_time(end) * 1e-3
        busy, kernels = busy_seconds(prof)
        if kernels == 0:
            raise RuntimeError("the profiler saw no device work in a canary "
                               "replay")
        return dict(m, device_s=secs, busy_s=busy, device_events=kernels,
                    throughput_event_tok_s=m["gen_tokens"] / secs,
                    throughput_busy_tok_s=m["gen_tokens"] / busy,
                    throughput_tok_s=m["gen_tokens"] / busy)

    return timed


def _engine_metrics(stats: dict, n_rejected: int, variant: str = "default"
                    ) -> dict:
    """The canary metric vocabulary extracted from a real engine's
    ``stats()``."""
    per = stats["per_variant"][variant]
    total = stats["n_completed"] + n_rejected
    return {"throughput_tok_s": stats["throughput_tok_s"],
            "mean_ttft_s": per["mean_ttft_s"],
            "mean_latency_s": per["mean_latency_s"],
            "reject_rate": round(n_rejected / total, 6) if total else 0.0,
            "gen_tokens": stats["gen_tokens"],
            "wall_s": stats["wall_s"],
            "s_per_token": per["s_per_token"],
            "n": per["n"]}


# --------------------------------------------------------------------------
# The controller
# --------------------------------------------------------------------------


def _check_trace_vocab(trace: Trace, arch: str) -> None:
    """A real loop replays ``trace`` through ``arch``'s smoke config, whose
    embedding an out-of-vocab token id would index past (on the card a
    device-side assert that poisons the shared context; on the CPU an
    IndexError that fails replicas and rolls the canary back)."""
    from ...configs import smoke_config
    vocab = smoke_config(arch).vocab
    if trace.vocab > vocab:
        raise ValueError(f"trace vocab {trace.vocab} exceeds {arch}'s smoke "
                         f"vocab {vocab}: synthesize the real loop's trace "
                         f"with `synth --vocab {vocab}`")


class LiveLoopController:
    """One live-loop instance rooted at a directory.

    Layout under ``root``: ``trace.json`` (the replayed workload),
    ``cache.jsonl`` (the shared fitness store — evolution reads and
    writes, serve measurements land here too), ``checkpoints/`` (the
    background island's resume state), ``canary.json`` (the promotion
    journal), ``registry/`` (exported artifacts), ``state.json`` (the
    controller's own tick journal).

    Construct with a ``trace`` to start a loop, or without one to resume
    whatever the root already holds.  ``measure`` overrides the
    measurement backend (tests inject deterministic ones); ``fault_hook``
    perturbs canary-side measurements for regression drills."""

    def __init__(self, root: str, *, trace: Trace | None = None,
                 arch: str = "qwen3-0.6b", mode: str = "modeled",
                 gens_per_tick: int = 2, pop: int = 8, seed: int = 0,
                 fraction: float = 0.5,
                 guardrails: Guardrails | None = None,
                 measure=None, fault_hook=None, surrogate: bool = True,
                 repeats: int = 3, verbose: bool = False, device=None):
        if mode not in ("modeled", "real"):
            raise ValueError(f"mode must be 'modeled' or 'real', got {mode!r}")
        self.root = root
        self.arch = arch
        self.mode = mode
        self.gens_per_tick = int(gens_per_tick)
        self.fraction = float(fraction)
        self.fault_hook = fault_hook
        self.repeats = max(int(repeats), 1)
        self.verbose = verbose
        self.device = device         # resolved when a real replay needs it
        self._warmed: set[tuple] = set()
        os.makedirs(root, exist_ok=True)

        trace_path = os.path.join(root, "trace.json")
        if trace is None:
            if not os.path.exists(trace_path):
                raise ValueError(f"no trace given and {trace_path} does not "
                                 "exist — synthesize one first")
            trace = Trace.load(trace_path)
        elif not os.path.exists(trace_path):
            trace.save(trace_path)
        self.trace = trace

        state_path = os.path.join(root, "state.json")
        self.state_path = state_path
        if os.path.exists(state_path):
            self.state = json.load(open(state_path))
            if self.state.get("version") != STATE_VERSION:
                raise ValueError(f"state journal {state_path} has version "
                                 f"{self.state.get('version')}")
            if self.state["trace"] != trace.fingerprint():
                raise ValueError("resume trace does not match the journaled "
                                 "one — a loop is bound to its trace")
            # a loop is bound to its arch and measurement backend too: the
            # journaled values win over constructor defaults on resume
            self.arch = self.state["arch"]
            self.mode = self.state["mode"]
        else:
            self.state = {"version": STATE_VERSION, "tick": 0,
                          "gens_done": 0, "arch": arch, "mode": mode,
                          "trace": trace.fingerprint()}
        if self.mode == "real":
            _check_trace_vocab(trace, self.arch)
        if not os.path.exists(state_path):
            # journal the binding immediately: a loop is bound to its
            # trace/arch/mode from creation, not from its first tick
            atomic_write_json(state_path, self.state, sort_keys=True,
                              indent=1)

        # guardrail defaults are mode-aware: the modeled backend is
        # deterministic so an identical candidate measures identically and
        # a strict 1.0 throughput floor is safe; real replays are noisy
        # run to run, so the default leaves the same headroom perf_ab uses
        if guardrails is None and self.mode == "real":
            guardrails = Guardrails(min_throughput_ratio=0.95)
        self.book = CanaryBook(os.path.join(root, "canary.json"),
                               fraction=self.fraction,
                               guardrails=guardrails)
        # the journal wins on resume here too: the book restores its
        # journaled fraction and guardrails, and the controller's traffic
        # split must follow the book or a resumed loop would slice the
        # trace differently than the one that wrote the journal
        self.fraction = self.book.fraction
        self.registry = ArtifactRegistry(os.path.join(root, "registry"))
        self.space = serve_schedule_space(self.arch)
        self.cache = FitnessCache(os.path.join(root, "cache.jsonl"),
                                  writer="liveloop")
        self.workload = self._build_workload()
        self.featurizer = ScheduleFeaturizer(self.workload)
        evaluator = SerialEvaluator(self.workload, cache=self.cache)
        self.search = GevoML(self.workload, pop_size=pop,
                             n_elite=max(pop // 2, 1),
                             operators={"attr_tweak": 1.0},
                             evaluator=evaluator,
                             checkpoint_dir=os.path.join(root,
                                                         "checkpoints"),
                             seed=seed, surrogate=surrogate,
                             surrogate_live=surrogate)
        self.measure = measure or (self._measure_modeled
                                   if self.mode == "modeled"
                                   else self._measure_real)
        self._cfg = None
        self._params = None

    # -- workload -----------------------------------------------------------
    def _build_workload(self) -> KernelWorkload:
        if self.mode == "modeled":
            def runner(genome: dict) -> tuple[float, float]:
                mtr = simulate(self.trace, genome)
                return (mtr["s_per_token"], mtr["mean_latency_s"])
            time_mode = "static"
        else:
            def runner(genome: dict) -> tuple[float, float]:
                mtr = self._replay_real(self.trace, genome)
                return (mtr["s_per_token"], mtr["mean_latency_s"])
            time_mode = "measured"
        return KernelWorkload(
            name=f"liveloop/{self.arch}",
            program=self.space.encode(DEFAULT_SERVE_PLAN),
            space=self.space,
            runner=runner,
            time_mode=time_mode,
            kind="serve")

    # -- real-engine backend ------------------------------------------------
    def _model(self):
        """The real backend's model: ``arch`` at its smoke config, random
        weights (seed 0) made on the controller's device."""
        if self._cfg is None:
            from ...configs import smoke_config
            from ...device import resolve_device
            from ...models.transformer import init_params
            device = resolve_device(self.device)
            self._cfg = smoke_config(self.arch)
            self._params = init_params(self._cfg, device=device)
        return self._cfg, self._params

    def _replay_real(self, trace: Trace, genome: dict) -> dict:
        """Replay ``trace`` through a real engine under ``genome``,
        ``repeats`` times, and return the median-throughput replay's
        metrics.  A genome whose plan fans out (``replicas`` > 1) replays
        through a multi-replica
        :class:`~repro_torch.core.deploy.router.Router`;
        either way the KV plan clamps slots, so the canary measures the
        plan it would promote.  The first replay of a (plan, trace) pair
        in this process is an unmeasured warmup — a fresh schedule's first
        kernel loads and library handles must not land inside its first
        timed window, or every canary would lose its opening guardrail
        check to the warm incumbent.  A device fault propagates: the
        router lets it through, so it never becomes a reject rate that
        rolls a candidate back."""
        one = self._replayer(trace, genome)
        return _median_run([one() for _ in range(self.repeats)])

    def _replayer(self, trace: Trace, genome: dict):
        """A function replaying ``trace`` once under ``genome`` (see
        :meth:`_replay_real`), the pair's warmup done."""
        from ..deploy.engine import ServeEngine
        from ..deploy.router import Router
        from .traces import replay
        cfg, params = self._model()
        plan = KVPlan.from_genome(genome)
        slots = plan.effective_slots(int(genome["max_slots"]),
                                     trace.max_len())
        chunk = int(genome["prefill_chunk"])

        def one() -> dict:
            if plan.replicas > 1:
                engines = [ServeEngine(cfg, params,
                                       max_len=trace.max_len(),
                                       max_slots=slots,
                                       prefill_chunk=chunk, seed=i)
                           for i in range(plan.replicas)]
                target = Router(engines, plan=plan, genome=dict(genome))
            else:
                target = ServeEngine(cfg, params, max_len=trace.max_len(),
                                     max_slots=slots, prefill_chunk=chunk)
            replay(target, trace)
            return _engine_metrics(target.stats(), target.n_rejected)

        warm_key = (slots, chunk, plan.page_size, plan.dtype,
                    plan.replicas, trace.fingerprint())
        if warm_key not in self._warmed:
            one()
            self._warmed.add(warm_key)
        return one

    # -- measurement backends ----------------------------------------------
    def _window_slice(self, tick: int) -> Trace:
        """The window's measurement slice: the canary-fraction subset of
        the controller trace, derived deterministically from the trace
        fingerprint and the tick — no RNG state, so a resumed process
        slices identically.  Both genomes replay this *same* slice
        (shadow replay), so the guardrail ratios compare identical
        arrivals: a candidate identical to the incumbent measures
        identically under the modeled backend and cannot be rolled back
        by slice-composition noise.  Falls back to the full trace when
        the fraction selects nothing."""
        idx = split_indices(len(self.trace), self.fraction,
                            salt=f"{self.trace.fingerprint()}:{tick}")
        items = [it for it in self.trace.items if it.index in idx]
        if not items:
            return self.trace
        return Trace(scenario=self.trace.scenario, seed=self.trace.seed,
                     vocab=self.trace.vocab, items=items,
                     knobs=dict(self.trace.knobs))

    def _measure_modeled(self, base_genome: dict, cand_genome: dict,
                         tick: int) -> tuple[dict, dict]:
        tr = self._window_slice(tick)
        return simulate(tr, base_genome), simulate(tr, cand_genome)

    def _measure_real(self, base_genome: dict, cand_genome: dict,
                      tick: int) -> tuple[dict, dict]:
        """Both plans' metrics on the window's slice: ``_replay_real``'s,
        one plan after the other, on the CPU; on the GPU the median replay
        of ``CARD_WINDOW_REPEATS`` each, the two plans' replays in turns,
        each replay's throughput by the device's busy time
        (``_device_timed``)."""
        tr = self._window_slice(tick)
        if self._model()[1].device.type != "cuda":
            return (self._replay_real(tr, base_genome),
                    self._replay_real(tr, cand_genome))
        ones = (_device_timed(self._replayer(tr, base_genome)),
                _device_timed(self._replayer(tr, cand_genome)))
        runs: tuple[list, list] = ([], [])
        for _ in range(CARD_WINDOW_REPEATS):
            for one, out in zip(ones, runs):
                out.append(one())
        return _median_run(runs[0]), _median_run(runs[1])

    # -- serve-record publishing (the surrogate's live training signal) -----
    def _publish_window(self, genome: dict, metrics: dict, *, role: str,
                        tick: int) -> None:
        """One canary-window measurement as a feature-bearing serve record
        in the shared cache: fitness the search's vocabulary, features
        straight off the genome, the trace spec in meta so the traffic is
        re-synthesizable from the store.  First measurement wins per key —
        re-publishing a replayed tick is a no-op."""
        if metrics["n"] == 0:
            return
        body = {"kind": "serve_latency", "name": self.workload.name,
                "trace": self.trace.fingerprint(), "role": role,
                "schedule": dict(genome), "tick": tick}
        key = "serve:" + hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()).hexdigest()
        if key in self.cache:
            return
        self.cache.put(
            key,
            EvalOutcome(fitness=(metrics["s_per_token"],
                                 metrics["mean_latency_s"])),
            writer="serve",
            features=self.featurizer.of_genome(genome),
            meta={"trace": self.trace.spec(), "role": role, "tick": tick})

    # -- artifacts ----------------------------------------------------------
    def _export_candidate(self, genome: dict, fitness, fp: str) -> str:
        art = Artifact(kind="serve", name=self.arch,
                       shape=f"cand-{fp[:12]}", genome=dict(genome),
                       fitness=tuple(fitness),
                       meta={"source": "liveloop",
                             "trace": self.trace.fingerprint(),
                             "genome_fingerprint": fp})
        return self.registry.export(art)

    def _sync_promoted(self) -> None:
        """Reconcile the registry's ``live`` pointer with the journal's
        promoted entry.  Reconciliation (not an event reaction): a crash
        between the journal commit and the export heals here on the next
        tick, and re-running a completed tick rewrites identical bytes."""
        inc = self.book.promoted
        have = self.registry.resolve(self.arch, "live", kind="serve")
        if inc is None:
            return
        fp = inc["fingerprint"]
        if have is not None and \
                have.meta.get("genome_fingerprint") == fp:
            return
        self.registry.export(Artifact(
            kind="serve", name=self.arch, shape="live",
            genome=dict(inc["genome"]),
            meta={"source": "liveloop",
                  "trace": self.trace.fingerprint(),
                  "genome_fingerprint": fp,
                  "promoted_at_tick": inc["at_tick"]}))

    # -- the tick -----------------------------------------------------------
    def tick(self) -> dict:
        """One turn of the loop (see the module docstring).  Returns a
        summary of what happened.  Safe to kill anywhere inside and
        re-run: every step is idempotent or journal-pure."""
        t = self.state["tick"]
        target = self.state["gens_done"] + self.gens_per_tick

        # 1. evolve (resume picks up the checkpoint; a replayed tick whose
        #    checkpoint already reached `target` runs zero new generations)
        result = self.search.run(generations=target, resume=True)
        best = result.best_by_time()
        genome = self.space.decode(best.patch.apply(self.workload.program))
        fp = genome_fingerprint(genome)
        self._export_candidate(genome, best.fitness, fp)

        # 2. canary admission
        proposed = False
        incumbent = self.book.promoted
        if not (incumbent and incumbent["fingerprint"] == fp):
            proposed = self.book.propose(fp, genome, tick=t)

        # 3. one measurement window + verdict
        outcome = None
        if self.book.active is not None:
            base_genome = (incumbent["genome"] if incumbent
                           else dict(DEFAULT_SERVE_PLAN))
            cand_genome = self.book.active["genome"]
            base_m, can_m = self.measure(base_genome, cand_genome, t)
            if self.fault_hook is not None:
                can_m = self.fault_hook(cand_genome, can_m)
            self._publish_window(base_genome, base_m, role="baseline",
                                 tick=t)
            self._publish_window(cand_genome, can_m, role="canary", tick=t)
            self.book.observe(tick=t, baseline=base_m, canary=can_m)
            outcome = self.book.decide(tick=t)

        # 4. reconcile registry with journal, then commit the tick
        self._sync_promoted()
        self.state["tick"] = t + 1
        self.state["gens_done"] = target
        atomic_write_json(self.state_path, self.state, sort_keys=True,
                          indent=1)

        summary = {"tick": t, "generations": target,
                   "candidate": genome, "fingerprint": fp[:12],
                   "proposed": proposed, "outcome": outcome,
                   "best_fitness": list(best.fitness)}
        if self.verbose:
            print(f"[liveloop tick {t}] gens={target} "
                  f"cand={genome} fp={fp[:12]} "
                  f"outcome={outcome or 'pending'}", flush=True)
        return summary

    def run(self, ticks: int) -> list[dict]:
        return [self.tick() for _ in range(ticks)]

    # -- inspection ---------------------------------------------------------
    def status(self) -> dict:
        live = self.registry.resolve(self.arch, "live", kind="serve")
        return {"tick": self.state["tick"],
                "generations": self.state["gens_done"],
                "mode": self.mode,
                "trace": self.trace.summary(),
                "canary": self.book.status(),
                "live_artifact": live.genome if live else None,
                "cache_entries": len(self.cache),
                "surrogate": (self.search.guide.stats()
                              if self.search.guide else None)}
