"""Per-operator search statistics: proposed / valid / elite-survival.

The GEVO papers analyze *which* mutations matter (Sec. 6 mutation analysis);
these counters make that analysis a free by-product of every run.  The
search loop increments them and snapshots them into each
``SearchResult.history`` row and each checkpoint:

* ``proposed`` — edits of this kind sampled by the mutation step (whether or
  not they later applied cleanly);
* ``applied``  — proposals that applied cleanly to their candidate patch
  (``applied / proposed`` is the operator's apply-validity rate);
* ``valid``    — edits of this kind contained in individuals that evaluated
  successfully;
* ``elite``    — edits of this kind contained in elite individuals, summed
  over generations (survival: an edit kept across generations re-counts);
* ``invalid`` / ``noop`` / ``equivalent`` — edits of this kind contained in
  candidates the static patch screen (:mod:`repro_torch.core.analysis`) resolved
  without execution, by verdict — the paper's per-operator attribution of
  where wasted evaluations come from.  All zero when screening is off.
* ``ranked`` / ``kept`` — edits of this kind contained in candidates the
  surrogate pre-rank stage (:mod:`repro_torch.core.surrogate`) scored, and in the
  predicted-Pareto slice it let through (``kept / ranked`` is the operator's
  surrogate-survival rate).  All zero when the surrogate is off.
"""

from __future__ import annotations

from typing import Iterable

from .base import registered_ops

_FIELDS = ("proposed", "applied", "valid", "elite",
           "invalid", "noop", "equivalent", "ranked", "kept")
SCREEN_FIELDS = ("invalid", "noop", "equivalent")
SURROGATE_FIELDS = ("ranked", "kept")


class OperatorStats:
    """Per-operator ``proposed`` / ``applied`` / ``valid`` / ``elite``
    counters for one search run — the paper's Sec. 6 mutation analysis as
    live counters.  The search loop increments them as candidates are
    sampled, applied, evaluated, and selected; ``snapshot()`` rows land in
    every ``SearchResult.history`` entry, and ``to_doc``/``from_doc``
    round-trip them through checkpoints so resumed runs continue the
    series.  Unseen operator kinds (late-registered customs) get rows on
    first touch."""

    def __init__(self, names: Iterable[str] | None = None):
        names = registered_ops() if names is None else names
        self._c: dict[str, dict[str, int]] = {
            n: dict.fromkeys(_FIELDS, 0) for n in names}

    def _row(self, kind: str) -> dict[str, int]:
        # unseen kinds (late-registered operators) get rows on first touch
        return self._c.setdefault(kind, dict.fromkeys(_FIELDS, 0))

    def count_proposed(self, kind: str) -> None:
        self._row(kind)["proposed"] += 1

    def count_applied(self, kind: str) -> None:
        self._row(kind)["applied"] += 1

    def count_valid(self, kinds: Iterable[str]) -> None:
        for k in kinds:
            self._row(k)["valid"] += 1

    def count_elite(self, kinds: Iterable[str]) -> None:
        for k in kinds:
            self._row(k)["elite"] += 1

    def count_screened(self, kinds: Iterable[str], verdict: str) -> None:
        """Attribute one statically screened candidate to its edit kinds."""
        if verdict not in SCREEN_FIELDS:
            return   # "novel" (and anything future) executes; nothing to count
        for k in kinds:
            self._row(k)[verdict] += 1

    def count_ranked(self, kinds: Iterable[str], *, kept: bool) -> None:
        """Attribute one surrogate-ranked candidate to its edit kinds;
        ``kept`` marks it surviving into the executed slice."""
        for k in kinds:
            self._row(k)["ranked"] += 1
            if kept:
                self._row(k)["kept"] += 1

    def snapshot(self) -> dict[str, dict[str, int]]:
        """Sorted deep copy, safe to embed in history rows / checkpoints."""
        return {n: dict(row) for n, row in sorted(self._c.items())}

    to_doc = snapshot

    @staticmethod
    def from_doc(doc: dict | None) -> "OperatorStats":
        # restore exactly the checkpointed operator set, so a resumed run's
        # history rows match an uninterrupted run under pinned weights
        s = OperatorStats(names=())
        for n, row in (doc or {}).items():
            r = s._row(n)
            for f in _FIELDS:
                r[f] = int(row.get(f, 0))
        return s
