"""Operator-weighted edit sampling.

KernelFoundry-style searches show the operator mix matters for search
quality: :class:`OperatorWeights` is an immutable mapping operator-name →
sampling weight, consumed by :func:`sample_edit` (and therefore by the
search loop's mutation step).  ``OperatorWeights.legacy()`` pins the paper's
original 50/50 copy/delete mix; ``OperatorWeights.all_registered()`` spreads
uniformly over every registered operator; ``OperatorWeights.parse`` accepts
the CLI ``--operators`` syntax.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ir import Program
from .base import Edit, EditError, get_edit_op, registered_ops


@dataclass(frozen=True)
class OperatorWeights:
    """Sampling mix over registered edit operators (name, weight > 0)."""

    items: tuple[tuple[str, float], ...]

    def __post_init__(self):
        if not self.items:
            raise ValueError("OperatorWeights needs at least one operator")
        seen = set()
        for name, w in self.items:
            if name in seen:
                raise ValueError(f"duplicate operator {name!r}")
            seen.add(name)
            if not (w > 0):
                raise ValueError(f"weight for {name!r} must be > 0, got {w}")
        # sample() runs once per mutation attempt (thousands per search):
        # precompute the probability vector; registry validation is deferred
        # (operators may register after construction) but runs only once
        w = np.array([x for _, x in self.items], dtype=float)
        object.__setattr__(self, "_probs", w / w.sum())
        object.__setattr__(self, "_validated", False)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def of(**weights: float) -> "OperatorWeights":
        return OperatorWeights(tuple(sorted(weights.items())))

    @staticmethod
    def from_mapping(d) -> "OperatorWeights":
        return OperatorWeights(tuple(sorted(d.items())))

    @staticmethod
    def legacy() -> "OperatorWeights":
        """The paper's original operator set: 50/50 copy/delete."""
        return OperatorWeights.of(copy=1.0, delete=1.0)

    @staticmethod
    def all_registered() -> "OperatorWeights":
        """Uniform over every *universal* registered operator (the search
        default).  Representation-specific operators (``EditOp.universal =
        False``, e.g. ``attr_tweak``) are excluded — name them explicitly
        to search the representation they target."""
        return OperatorWeights(tuple((n, 1.0) for n in registered_ops()
                                     if get_edit_op(n).universal))

    @staticmethod
    def parse(spec: str) -> "OperatorWeights":
        """CLI syntax: ``"all"`` | ``"legacy"`` | ``"name,name,..."``
        (uniform) | ``"name=w,name=w,..."`` (explicit weights)."""
        spec = spec.strip()
        if spec in ("", "all"):
            return OperatorWeights.all_registered()
        if spec == "legacy":
            return OperatorWeights.legacy()
        weights = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition("=")
            weights[name.strip()] = float(w) if w else 1.0
        return OperatorWeights.from_mapping(weights)

    @staticmethod
    def coerce(v) -> "OperatorWeights":
        if v is None:
            return OperatorWeights.all_registered()
        if isinstance(v, OperatorWeights):
            return v
        if isinstance(v, str):
            return OperatorWeights.parse(v)
        return OperatorWeights.from_mapping(v)

    # -- queries ------------------------------------------------------------
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.items)

    def probs(self) -> np.ndarray:
        return self._probs

    def validate(self) -> "OperatorWeights":
        """Check every name against the registry (raises EditError on a
        typo'd --operators).  Called by GevoML at construction — a bad name
        must fail fast, not be silently resampled by the mutation retry
        loop."""
        if not self._validated:
            for name, _ in self.items:
                get_edit_op(name)
            object.__setattr__(self, "_validated", True)
        return self

    def sample(self, rng: np.random.Generator) -> str:
        """Draw one operator name (deterministic given the rng state)."""
        self.validate()
        names = self.names()
        return names[int(rng.choice(len(names), p=self._probs))]


def sample_edit(prog: Program, rng: np.random.Generator,
                weights: OperatorWeights | None = None) -> Edit:
    """Sample one edit against the current program's uids: draw an operator
    from ``weights`` (default: uniform over all registered), then ask it to
    propose.  Raises :class:`EditError` when the drawn operator has nothing
    to target (callers retry)."""
    if weights is None:
        weights = OperatorWeights.all_registered()
    return get_edit_op(weights.sample(rng)).propose(prog, rng)
