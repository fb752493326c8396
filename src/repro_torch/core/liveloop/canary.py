"""Canary promotion: the state machine between "evolution found a genome"
and "traffic runs on it".

The counterpart of ``src/repro/core/liveloop/canary.py``, pure Python.

GEVO's methodology re-validates evolved winners *in the target
application* before trusting them; in a serving fleet that re-validation
is a **canary**: a configurable fraction of the traffic is sliced off
(:func:`split_indices`) and replayed under both the incumbent and the
candidate — shadow replay, so both sides are measured under identical
arrivals — and an explicit guardrail verdict — computed from the
recorded measurements only, never from ambient state — either promotes
the candidate or rolls it back.

The lifecycle is ``candidate → canary → promoted | rolled_back``:

* :meth:`CanaryBook.propose` admits a candidate (refusing fingerprints
  that were ever rolled back — a regression is remembered forever, the
  same genome is never re-canaried);
* :meth:`CanaryBook.observe` records one measurement window (baseline and
  canary shadow-replayed over the same slice).  Windows are keyed by tick and
  idempotent: re-observing a journaled tick is a no-op, which is what
  makes kill-and-resume replay bit-exact;
* :meth:`CanaryBook.decide` applies :class:`Guardrails` — throughput
  ratio, TTFT ratio, reject-rate delta — once enough windows are in.  The
  verdict is a pure function of the journaled windows
  (:func:`verdict_of`), so replaying the journal reproduces it exactly.

**Durability contract.**  Every transition is journaled with
``atomic_write_json(sort_keys=True)`` *before* its effects are acted on,
and every mutation is idempotent, so a process killed at an arbitrary
tick resumes from the journal without re-canarying: the same inputs
rewrite the same bytes.  (The registry export that follows a promotion is
idempotent for the same reason — fingerprinted artifact, first write
wins.)
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass

from ..serialize import atomic_write_json

# Lifecycle states
CANDIDATE = "candidate"
CANARY = "canary"
PROMOTED = "promoted"
ROLLED_BACK = "rolled_back"

JOURNAL_VERSION = 1


@dataclass(frozen=True)
class Guardrails:
    """Promotion thresholds, applied to per-window canary/baseline ratios
    (window-mean).  Defaults are deliberately strict on throughput (a
    canary must not be slower) and tolerant on TTFT jitter.  The strict
    1.0 throughput floor assumes deterministic measurement (both sides
    shadow-replay the same slice, so an identical candidate scores
    exactly 1.0 under the modeled backend); for noisy real-engine
    replays, leave headroom — the controller defaults ``mode="real"``
    loops to 0.95, the same margin ``perf_ab`` uses."""

    min_throughput_ratio: float = 1.0   # canary tok/s ÷ baseline tok/s
    max_ttft_ratio: float = 2.0         # canary mean TTFT ÷ baseline
    max_reject_rate_delta: float = 0.0  # canary − baseline reject rate
    windows: int = 2                    # measurement windows per verdict

    def to_doc(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_doc(doc: dict) -> "Guardrails":
        return Guardrails(**doc)


def split_indices(n: int, fraction: float, salt: str) -> set[int]:
    """The deterministic canary traffic split: which of ``n`` arrival
    indices route to the canary.  Hash-derived per index from ``salt`` (no
    RNG state), so replaying the same trace under the same salt splits
    identically — on any host, after any restart."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction must be in [0, 1], got {fraction}")
    out = set()
    for i in range(n):
        h = hashlib.sha256(f"{salt}:{i}".encode()).digest()
        if int.from_bytes(h[:8], "big") / 2**64 < fraction:
            out.add(i)
    return out


def _ratio(num: float, den: float) -> float:
    """num/den with zero-safe semantics: 0/0 is a neutral 1.0 (no traffic
    on either side says nothing), x/0 is +inf-ish 'infinitely worse' only
    when x is a cost."""
    if den > 0:
        return num / den
    return 1.0 if num == 0 else float("inf")


def verdict_of(windows: list[dict], rails: Guardrails) -> dict:
    """The promotion verdict as a pure function of the journaled
    measurement windows — replaying the journal reproduces it bit-exactly.
    Returns ``{decided, promote, checks, ratios}``; ``decided`` is False
    until ``rails.windows`` windows are recorded."""
    if len(windows) < rails.windows:
        return {"decided": False, "promote": False, "checks": {},
                "ratios": {}}
    thr_c = sum(w["canary"]["throughput_tok_s"] for w in windows)
    thr_b = sum(w["baseline"]["throughput_tok_s"] for w in windows)
    ttft_c = sum(w["canary"]["mean_ttft_s"] for w in windows)
    ttft_b = sum(w["baseline"]["mean_ttft_s"] for w in windows)
    rej_c = sum(w["canary"]["reject_rate"] for w in windows) / len(windows)
    rej_b = sum(w["baseline"]["reject_rate"] for w in windows) / len(windows)
    ratios = {"throughput": round(_ratio(thr_c, thr_b), 6),
              "ttft": round(_ratio(ttft_c, ttft_b), 6),
              "reject_delta": round(rej_c - rej_b, 6)}
    checks = {
        "throughput": ratios["throughput"] >= rails.min_throughput_ratio,
        "ttft": ratios["ttft"] <= rails.max_ttft_ratio,
        "rejects": ratios["reject_delta"] <= rails.max_reject_rate_delta,
    }
    return {"decided": True, "promote": all(checks.values()),
            "checks": checks, "ratios": ratios}


class CanaryBook:
    """The journaled promotion ledger: one active canary at a time, a
    promoted incumbent, and a permanent blocklist of rolled-back
    fingerprints.  All state lives in one JSON document written atomically
    before any caller acts on a transition."""

    def __init__(self, journal_path: str, *, fraction: float = 0.25,
                 guardrails: Guardrails | None = None):
        self.path = journal_path
        self.fraction = fraction
        self.rails = guardrails or Guardrails()
        self.doc: dict = {"version": JOURNAL_VERSION,
                          "guardrails": self.rails.to_doc(),
                          "fraction": fraction,
                          "active": None,       # the in-flight canary
                          "promoted": None,     # the current incumbent
                          "blocked": [],        # rolled-back fingerprints
                          "history": []}        # ordered transition log
        if os.path.exists(journal_path):
            self.doc = json.load(open(journal_path))
            if self.doc.get("version") != JOURNAL_VERSION:
                raise ValueError(
                    f"canary journal {journal_path} has version "
                    f"{self.doc.get('version')}, expected {JOURNAL_VERSION}")
            self.rails = Guardrails.from_doc(self.doc["guardrails"])
            self.fraction = float(self.doc["fraction"])

    # -- persistence ---------------------------------------------------------
    def _commit(self) -> None:
        atomic_write_json(self.path, self.doc, sort_keys=True, indent=1)

    def _log(self, event: str, **fields) -> None:
        self.doc["history"].append({"event": event, **fields})

    # -- queries -------------------------------------------------------------
    @property
    def active(self) -> dict | None:
        return self.doc["active"]

    @property
    def promoted(self) -> dict | None:
        return self.doc["promoted"]

    def is_blocked(self, fingerprint: str) -> bool:
        return fingerprint in self.doc["blocked"]

    def state_of(self, fingerprint: str) -> str | None:
        """Where a fingerprint currently stands in the lifecycle."""
        if self.is_blocked(fingerprint):
            return ROLLED_BACK
        if self.promoted and self.promoted["fingerprint"] == fingerprint:
            return PROMOTED
        if self.active and self.active["fingerprint"] == fingerprint:
            return self.active["state"]
        return None

    def status(self) -> dict:
        act = self.active
        return {
            "active": {"fingerprint": act["fingerprint"],
                       "state": act["state"],
                       "windows": len(act["windows"]),
                       "needed": self.rails.windows} if act else None,
            "promoted": self.promoted,
            "blocked": list(self.doc["blocked"]),
            "events": len(self.doc["history"]),
            "fraction": self.fraction,
        }

    # -- transitions ---------------------------------------------------------
    def propose(self, fingerprint: str, genome: dict, *, tick: int) -> bool:
        """Admit a candidate into the canary lane.  Refused (returns
        False) when a canary is already active, the fingerprint was ever
        rolled back, or it is already the incumbent.  Idempotent: proposing
        the active fingerprint again is a no-op success."""
        if self.is_blocked(fingerprint):
            return False
        if self.promoted and self.promoted["fingerprint"] == fingerprint:
            return False
        if self.active is not None:
            return self.active["fingerprint"] == fingerprint
        self.doc["active"] = {"fingerprint": fingerprint,
                              "genome": dict(genome),
                              "state": CANARY,
                              "since_tick": tick,
                              "windows": []}
        self._log("propose", fingerprint=fingerprint, tick=tick)
        self._commit()
        return True

    def observe(self, *, tick: int, baseline: dict, canary: dict) -> bool:
        """Record one measurement window for the active canary.  Each side
        is ``{throughput_tok_s, mean_ttft_s, reject_rate}``.  Keyed by
        tick and idempotent — re-observing a journaled tick after a crash
        changes nothing, so resume never double-counts."""
        act = self.active
        if act is None or act["state"] != CANARY:
            return False
        if any(w["tick"] == tick for w in act["windows"]):
            return False
        act["windows"].append({
            "tick": tick,
            "baseline": {k: round(float(baseline[k]), 6)
                         for k in ("throughput_tok_s", "mean_ttft_s",
                                   "reject_rate")},
            "canary": {k: round(float(canary[k]), 6)
                       for k in ("throughput_tok_s", "mean_ttft_s",
                                 "reject_rate")}})
        self._commit()
        return True

    def decide(self, *, tick: int) -> str | None:
        """Apply the guardrails to the journaled windows.  Returns the
        resulting state (``promoted`` / ``rolled_back``) once enough
        windows are in, else None.  The verdict itself is
        :func:`verdict_of` — pure, so a resumed process reaches the same
        decision from the same journal."""
        act = self.active
        if act is None or act["state"] != CANARY:
            return None
        v = verdict_of(act["windows"], self.rails)
        if not v["decided"]:
            return None
        if v["promote"]:
            return self._promote(act, v, tick)
        return self._rollback(act, v, tick, reason="guardrails")

    def _promote(self, act: dict, v: dict, tick: int) -> str:
        self.doc["promoted"] = {"fingerprint": act["fingerprint"],
                                "genome": act["genome"],
                                "at_tick": tick,
                                "ratios": v["ratios"]}
        self.doc["active"] = None
        self._log("promote", fingerprint=act["fingerprint"], tick=tick,
                  ratios=v["ratios"])
        self._commit()
        return PROMOTED

    def _rollback(self, act: dict, v: dict | None, tick: int, *,
                  reason: str) -> str:
        if act["fingerprint"] not in self.doc["blocked"]:
            self.doc["blocked"].append(act["fingerprint"])
        self.doc["active"] = None
        self._log("rollback", fingerprint=act["fingerprint"], tick=tick,
                  reason=reason, ratios=(v or {}).get("ratios", {}))
        self._commit()
        return ROLLED_BACK

    # -- manual overrides (CLI) ---------------------------------------------
    def force_promote(self, *, tick: int) -> str | None:
        """Operator override: promote the active canary regardless of
        guardrail state (journaled as a distinct event)."""
        act = self.active
        if act is None:
            return None
        self.doc["promoted"] = {"fingerprint": act["fingerprint"],
                                "genome": act["genome"],
                                "at_tick": tick, "ratios": {},
                                "forced": True}
        self.doc["active"] = None
        self._log("force_promote", fingerprint=act["fingerprint"],
                  tick=tick)
        self._commit()
        return PROMOTED

    def force_rollback(self, *, tick: int) -> str | None:
        """Operator override: roll back the active canary (or demote the
        incumbent if no canary is active), blocking its fingerprint."""
        act = self.active
        if act is not None:
            return self._rollback(act, None, tick, reason="forced")
        inc = self.promoted
        if inc is None:
            return None
        if inc["fingerprint"] not in self.doc["blocked"]:
            self.doc["blocked"].append(inc["fingerprint"])
        self.doc["promoted"] = None
        self._log("rollback", fingerprint=inc["fingerprint"], tick=tick,
                  reason="forced_demote", ratios={})
        self._commit()
        return ROLLED_BACK
