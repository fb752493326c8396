"""Trace synthesis and replay: reproducible workload scenarios for the loop.

The counterpart of ``src/repro/core/liveloop/traces.py``, line for line:
its requests are the reference's, byte for byte.

A live evolution loop is only as trustworthy as the traffic it evolves
against.  This module makes traffic a first-class, *content-addressed*
artifact: a :class:`Trace` is a seeded, deterministic arrival schedule of
generation requests (which tick each request arrives on, how long its
prompt is, how many tokens it wants), and :func:`synthesize` builds one
from a named scenario:

* ``steady`` — one arrival per tick, fixed prompt length (the control);
* ``bursty`` — Poisson arrivals whose rate alternates between a quiet base
  and burst windows (queue pressure comes in clumps, like real traffic);
* ``long_tail`` — steady arrivals, geometric prompt lengths with a clipped
  long-context tail (a few requests dominate prefill cost);
* ``mixed`` — short/medium/long prompt-length buckets in fixed proportion
  (the pad-free prefill grouping's worst friend);
* ``ramp`` — arrival rate grows linearly from idle to peak (warm-up into
  saturation);
* ``spike`` — quiet baseline with one concentrated mid-trace spike (the
  admission queue's stress test).

Determinism contract: a trace is fully determined by its **spec** — the
``(scenario, seed, knobs)`` tuple — so the spec alone replays it anywhere.
Request *tokens* are derived per-request from ``(seed, index)`` streams,
never from shared RNG state, so materializing requests twice (or on another
host) is bit-identical.  :meth:`Trace.fingerprint` hashes the full item
list; :func:`trace_from_records` re-synthesizes a trace from the compact
spec that serve-tagged :class:`~repro.core.evaluator.FitnessCache` records
carry (see ``ServeEngine.publish_stats(meta=...)``) and verifies the
fingerprint — replayed production traffic, reconstructed from the fitness
store serving already feeds.

:func:`replay` drives a trace through a :class:`~repro.core.deploy.
ServeEngine` tick by tick (arrivals land on their recorded tick, not
up-front), returning completed results plus the requests the engine
*rejected* at admission — the error signal the canary guardrails consume.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

from ..serialize import atomic_write_json

SCENARIOS = ("steady", "bursty", "long_tail", "mixed", "ramp", "spike")

TRACE_VERSION = 1


@dataclass(frozen=True)
class TimedRequest:
    """One scheduled arrival: tick it lands on + the request's shape.
    Tokens are not stored — they derive deterministically from
    ``(trace seed, index)`` at materialization time."""

    at_tick: int
    index: int
    prompt_len: int
    max_new_tokens: int

    @property
    def uid(self) -> str:
        return f"t{self.index:04d}"


@dataclass
class Trace:
    """A seeded arrival schedule.  ``spec()`` is the compact replay recipe
    (scenario + knobs + seed); ``fingerprint()`` content-hashes the full
    item list so any reconstruction can be verified byte-for-byte."""

    scenario: str
    seed: int
    vocab: int
    items: list[TimedRequest] = field(default_factory=list)
    knobs: dict = field(default_factory=dict)

    # -- identity -----------------------------------------------------------
    def spec(self) -> dict:
        """The compact synthesis recipe: enough to rebuild this trace
        bit-exactly via :func:`trace_from_spec`, plus the fingerprint to
        prove the rebuild matches."""
        return {"version": TRACE_VERSION, "scenario": self.scenario,
                "seed": self.seed, "vocab": self.vocab,
                "knobs": dict(self.knobs),
                "fingerprint": self.fingerprint()}

    def to_doc(self) -> dict:
        doc = self.spec()
        doc["items"] = [[it.at_tick, it.index, it.prompt_len,
                         it.max_new_tokens] for it in self.items]
        return doc

    @staticmethod
    def from_doc(doc: dict) -> "Trace":
        t = Trace(scenario=doc["scenario"], seed=int(doc["seed"]),
                  vocab=int(doc["vocab"]), knobs=dict(doc.get("knobs", {})),
                  items=[TimedRequest(*map(int, row))
                         for row in doc["items"]])
        want = doc.get("fingerprint")
        if want is not None and t.fingerprint() != want:
            raise ValueError(
                f"trace fingerprint mismatch ({want[:12]}… recorded, "
                f"{t.fingerprint()[:12]}… recomputed) — trace doc is "
                f"corrupt or was hand-edited")
        return t

    def fingerprint(self) -> str:
        body = {"version": TRACE_VERSION, "scenario": self.scenario,
                "seed": self.seed, "vocab": self.vocab,
                "items": [[it.at_tick, it.index, it.prompt_len,
                           it.max_new_tokens] for it in self.items]}
        return hashlib.sha256(
            json.dumps(body, sort_keys=True,
                       separators=(",", ":")).encode()).hexdigest()

    def save(self, path: str) -> None:
        atomic_write_json(path, self.to_doc(), sort_keys=True, indent=1)

    @staticmethod
    def load(path: str) -> "Trace":
        return Trace.from_doc(json.load(open(path)))

    # -- shape --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.items)

    def max_len(self) -> int:
        """The engine ``max_len`` this trace requires (longest
        prompt + generation budget)."""
        return max((it.prompt_len + it.max_new_tokens
                    for it in self.items), default=0)

    def n_ticks(self) -> int:
        return max((it.at_tick for it in self.items), default=-1) + 1

    # -- materialization ----------------------------------------------------
    def tokens_for(self, item: TimedRequest) -> np.ndarray:
        """The request's prompt tokens, derived from ``(seed, index)`` —
        independent of materialization order or count."""
        rng = np.random.default_rng([self.seed, item.index])
        return rng.integers(0, self.vocab,
                            item.prompt_len).astype(np.int32)

    def requests(self) -> list:
        """All items as :class:`~repro.core.deploy.ServeRequest`, in arrival
        order."""
        from ..deploy.engine import ServeRequest
        return [ServeRequest(uid=it.uid, tokens=self.tokens_for(it),
                             max_new_tokens=it.max_new_tokens)
                for it in self.items]

    def summary(self) -> dict:
        lens = [it.prompt_len for it in self.items] or [0]
        return {"scenario": self.scenario, "n_requests": len(self.items),
                "n_ticks": self.n_ticks(), "max_len": self.max_len(),
                "prompt_min": int(min(lens)), "prompt_max": int(max(lens)),
                "prompt_mean": round(float(np.mean(lens)), 2),
                "fingerprint": self.fingerprint()}


# --------------------------------------------------------------------------
# Scenario synthesis
# --------------------------------------------------------------------------


def _prompt_lens(scenario: str, rng: np.random.Generator, n: int,
                 max_prompt: int) -> list[int]:
    """Per-scenario prompt-length distribution (each length in
    ``[1, max_prompt]``)."""
    base = max(max_prompt // 2, 1)
    if scenario == "long_tail":
        # mostly short with a geometric long-context tail
        short = np.minimum(rng.geometric(0.5, n) + 1, base)
        tail = rng.random(n) < 0.2
        long_ = rng.integers(max(max_prompt * 3 // 4, 1), max_prompt + 1, n)
        return list(np.where(tail, long_, short).astype(int))
    if scenario == "mixed":
        # short / medium / long buckets in fixed proportion
        buckets = (max(max_prompt // 4, 1), base, max_prompt)
        return [buckets[i] for i in rng.choice(3, n, p=(0.5, 0.3, 0.2))]
    if scenario in ("bursty", "spike"):
        return list(rng.integers(max(max_prompt // 4, 1), base + 1, n))
    # steady / ramp: a fixed, predictable length
    return [base] * n


def _arrival_counts(scenario: str, rng: np.random.Generator, n: int
                    ) -> list[int]:
    """Requests arriving per tick until ``n`` have been scheduled."""
    counts: list[int] = []
    scheduled = 0
    tick = 0
    while scheduled < n:
        if scenario == "bursty":
            # Poisson arrivals: quiet base rate with 3-tick burst windows
            lam = 3.0 if (tick // 3) % 2 else 0.5
            c = int(rng.poisson(lam))
        elif scenario == "ramp":
            # rate grows linearly from idle toward a peak of ~3/tick
            c = int(rng.poisson(min(3.0, 0.3 * (tick + 1))))
        elif scenario == "spike":
            # quiet baseline, one concentrated spike around tick 4
            c = n // 2 if tick == 4 else int(rng.poisson(0.4))
        else:  # steady / long_tail / mixed: one per tick
            c = 1
        c = min(c, n - scheduled)
        counts.append(c)
        scheduled += c
        tick += 1
    return counts


def synthesize(scenario: str = "bursty", *, vocab: int, n_requests: int = 16,
               max_prompt: int = 16, gen: int = 8, seed: int = 0) -> Trace:
    """Build a named-scenario :class:`Trace`: ``n_requests`` arrivals with
    scenario-shaped ticks and prompt lengths, generation budget ``gen``
    each.  Deterministic in all arguments."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"choose from {SCENARIOS}")
    if n_requests < 1 or max_prompt < 1 or gen < 1:
        raise ValueError("n_requests, max_prompt and gen must be >= 1")
    # builtin hash() is salted per process (PYTHONHASHSEED) — a stable
    # digest keeps "deterministic in all arguments" true across processes
    scen_tag = int.from_bytes(
        hashlib.sha256(scenario.encode()).digest()[:4], "big")
    rng = np.random.default_rng([seed, scen_tag])
    lens = _prompt_lens(scenario, rng, n_requests, max_prompt)
    counts = _arrival_counts(scenario, rng, n_requests)
    items, i = [], 0
    for tick, c in enumerate(counts):
        for _ in range(c):
            items.append(TimedRequest(at_tick=tick, index=i,
                                      prompt_len=int(lens[i]),
                                      max_new_tokens=gen))
            i += 1
    return Trace(scenario=scenario, seed=seed, vocab=vocab, items=items,
                 knobs={"n_requests": n_requests, "max_prompt": max_prompt,
                        "gen": gen})


def trace_from_spec(spec: dict) -> Trace:
    """Re-synthesize a trace from its compact spec (see
    :meth:`Trace.spec`), verifying the recorded fingerprint."""
    t = synthesize(spec["scenario"], vocab=int(spec["vocab"]),
                   seed=int(spec["seed"]),
                   **{k: int(v) for k, v in spec.get("knobs", {}).items()})
    want = spec.get("fingerprint")
    if want is not None and t.fingerprint() != want:
        raise ValueError(
            f"re-synthesized trace fingerprint {t.fingerprint()[:12]}… "
            f"does not match the recorded {want[:12]}… — the spec was "
            f"written by an incompatible synthesizer")
    return t


def trace_from_records(cache_path: str) -> dict[str, Trace]:
    """Replayed production traffic out of the fitness store: every distinct
    trace spec found in serve-tagged cache records (``ServeEngine.
    publish_stats`` attaches the spec under ``meta["trace"]``),
    re-synthesized and fingerprint-verified, keyed by fingerprint."""
    out: dict[str, Trace] = {}
    with open(cache_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (ValueError, TypeError):
                continue  # torn tail of a crashed writer
            spec = (rec.get("meta") or {}).get("trace") \
                if isinstance(rec, dict) else None
            fp = spec.get("fingerprint") if isinstance(spec, dict) else None
            # a spec without a fingerprint cannot be verified — skip it
            # rather than let a corrupt spec pass unchecked under key None
            if not fp or fp in out:
                continue
            out[fp] = trace_from_spec(spec)
    return out


# --------------------------------------------------------------------------
# The demo trace (ported from core/deploy/engine.py, which now shims here)
# --------------------------------------------------------------------------


def demo_requests(cfg, *, n_requests: int, prompt_len: int, gen: int,
                  seed: int = 0) -> list:
    """A deterministic mixed-length request list (prompt lengths alternate
    ``prompt_len`` and ``prompt_len // 2``) — the CLI demo / serving-A/B
    trace, byte-compatible with the deprecated
    ``repro.core.deploy.demo_trace``."""
    from ..deploy.engine import ServeRequest
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        plen = prompt_len if i % 2 == 0 else max(prompt_len // 2, 1)
        reqs.append(ServeRequest(
            uid=f"req{i:03d}",
            tokens=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=gen))
    return reqs


# --------------------------------------------------------------------------
# Replay
# --------------------------------------------------------------------------


@dataclass
class ReplayReport:
    """What replaying a trace produced: completed results, the engine's
    aggregate stats, and the requests rejected at admission (the canary
    guardrails' error signal)."""

    results: list
    stats: dict
    rejected: list[str] = field(default_factory=list)

    @property
    def n_rejected(self) -> int:
        return len(self.rejected)

    @property
    def reject_rate(self) -> float:
        total = len(self.results) + len(self.rejected)
        return len(self.rejected) / total if total else 0.0


def replay(engine, trace: Trace, *, requests=None) -> ReplayReport:
    """Drive ``trace`` through ``engine`` honoring arrival ticks: each
    engine tick submits exactly the requests scheduled for it, then steps.
    Requests the engine rejects (prompt + budget over ``max_len``, unknown
    variant) are collected, not raised — a live loop must survive
    malformed traffic.  ``requests`` overrides the materialized request
    list (callers that pre-routed or pre-filtered the trace)."""
    reqs = trace.requests() if requests is None else list(requests)
    if len(reqs) != len(trace.items):
        raise ValueError(f"got {len(reqs)} requests for a "
                         f"{len(trace.items)}-item trace")
    n_before = len(engine.completed)
    rejected: list[str] = []
    i, tick = 0, 0
    while i < len(reqs) or engine.busy:
        while i < len(reqs) and trace.items[i].at_tick <= tick:
            if not engine.try_submit(reqs[i]):
                rejected.append(reqs[i].uid)
            i += 1
        engine.step()
        tick += 1
    return ReplayReport(results=engine.completed[n_before:],
                        stats=engine.stats(), rejected=rejected)
