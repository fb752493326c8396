"""The pre-rank stage: over-generate, predict, keep the predicted-Pareto
slice.

:class:`SurrogateGuide` is the piece the search engines embed.  It owns the
workload's featurizer and a :class:`~repro_torch.core.surrogate.model.SurrogateModel`
refit from the evaluator's FitnessCache as measurements accumulate; per
generation the engine asks it which of the freshly generated candidates
deserve real evaluation (``select``), and everything else is discarded
unmeasured.  Ordering is NSGA-II over *predicted* objectives
(:func:`~repro_torch.core.surrogate.model.pareto_order`), so the keep criterion is
the same preference the real selection applies one generation later.

The guide composes with the static screen by construction: the engines
run the screen (and the cache lookup) first, and only novel,
statically-unresolved candidates are ranked here — the surrogate never
overrides an exact verdict, it only prioritizes among the unknowns.
"""

from __future__ import annotations

import math

from .dataset import dataset_from_cache
from .features import make_featurizer
from .model import SurrogateModel, pareto_order


class SurrogateGuide:
    """Per-search surrogate state: featurizer + model + survival counters.

    ``keep`` is the fraction of generated candidates that reach the
    evaluator once the model is trained (at least 1); ``min_fit`` is the
    smallest cache row count worth fitting on — below it the guide stays
    untrained and every candidate passes."""

    def __init__(self, workload, *, keep: float = 0.5, l2: float = 1e-3,
                 min_fit: int = 8, live: bool = False):
        if not 0.0 < keep <= 1.0:
            raise ValueError(f"surrogate keep must be in (0, 1], got {keep}")
        self.live = bool(live)
        self.featurizer = make_featurizer(workload)
        if self.featurizer is None:
            raise ValueError(
                f"workload {getattr(workload, 'name', workload)!r} has no "
                "featurizable genome (no schedule space, no program)")
        self.keep = float(keep)
        self.min_fit = int(min_fit)
        self.model = SurrogateModel(
            feature_names=getattr(self.featurizer, "feature_names", None),
            l2=l2)
        self.n_ranked = 0   # candidates that went through a trained rank
        self.n_kept = 0     # ... and survived it
        self.n_refits = 0

    def refit(self, cache) -> bool:
        """Refit from the cache's measured rows; False (and keep the previous
        fit, if any) when there is too little data.  A ``live`` guide first
        absorbs records other writers appended since the last read — the
        live-loop serving fleet publishes feature-bearing latency rows into
        the same store, and ``reload()`` is what folds them into the next
        fit (the online-refit half of the evolve→serve→measure loop)."""
        if self.live and hasattr(cache, "reload"):
            cache.reload()
        _, X, Y = dataset_from_cache(cache)
        if len(X) < self.min_fit:
            return False
        self.model.fit(X, Y)
        self.n_refits += 1
        return True

    def keep_of(self, n: int) -> int:
        """The evaluation budget a batch of n generated candidates gets."""
        return max(1, math.ceil(self.keep * n))

    def select(self, feats: list[list[float]], room: int) -> set[int]:
        """Indices (into ``feats``) of the predicted-Pareto slice of size
        ``room``; counts every ranked candidate toward the survival stats."""
        if not feats:
            return set()
        order = pareto_order(self.model.predict(feats))
        kept = set(order[:max(0, room)])
        self.n_ranked += len(feats)
        self.n_kept += len(kept)
        return kept

    def stats(self) -> dict:
        return {"ranked": self.n_ranked, "kept": self.n_kept,
                "refits": self.n_refits, "trained": self.model.trained,
                "keep": self.keep}

    def restore(self, doc: dict | None) -> None:
        """Checkpoint-resume: restore the survival counters (the model
        itself is refit from the cache on the next generation)."""
        if not doc:
            return
        self.n_ranked = int(doc.get("ranked", 0))
        self.n_kept = int(doc.get("kept", 0))
        self.n_refits = int(doc.get("refits", 0))
