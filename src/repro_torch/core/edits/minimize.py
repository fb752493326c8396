"""Patch minimization: greedy ddmin over the edit list.

GEVO's mutation analysis isolates *key* mutations by post-hoc patch
minimization: drop every edit whose removal does not change fitness.  Since
all evaluation flows through the evaluator's content-addressed
:class:`~repro_torch.core.evaluator.FitnessCache`, sub-patches that appeared during
the search (every prefix did, and many crossover fragments) are cache hits —
minimization after a search is nearly free, re-measuring only sub-patches the
search never saw.
"""

from __future__ import annotations

from .patch import Patch


def minimize_patch(patch, evaluator, *, expect_fitness=None
                   ) -> tuple[Patch, tuple[float, float]]:
    """Greedily drop edits that do not affect fitness.

    Repeatedly tries removing each single edit; a removal is kept when the
    shortened patch still evaluates OK with *exactly* the baseline fitness
    (deterministic in ``static`` fitness mode).  Restarts after every
    accepted drop until a fixed point, so the result is 1-minimal: no single
    remaining edit can be removed without changing fitness.

    Returns ``(minimized_patch, fitness)`` with ``len(minimized) <=
    len(patch)`` and identical fitness.  ``expect_fitness`` (e.g. the
    fitness recorded on a search Individual) is cross-checked against the
    re-evaluated baseline when given.
    """
    patch = Patch.coerce(patch)
    base = evaluator.evaluate_one(patch)
    if not base.ok:
        raise ValueError(f"cannot minimize an invalid patch: {base.error}")
    target = base.fitness
    if expect_fitness is not None and tuple(expect_fitness) != target:
        raise ValueError(f"patch re-evaluated to {target}, caller expected "
                         f"{tuple(expect_fitness)} (stale workload?)")
    # With workers, a round's single-drop candidates go out as one batch so
    # fresh measurements overlap; serially, probe lazily and stop at the
    # first accepted drop (a batch would execute candidates the early-break
    # never looks at).  Acceptance order (lowest passing index) is the same
    # either way, so both modes minimize to the identical patch.
    batch_probes = getattr(evaluator, "n_workers", 1) > 1
    changed = True
    while changed and len(patch):
        changed = False
        cands = [patch.without(i) for i in range(len(patch))]
        if batch_probes:
            probes = zip(cands, evaluator.evaluate_batch(cands))
        else:
            probes = ((c, evaluator.evaluate_one(c)) for c in cands)
        for cand, out in probes:
            if out.ok and out.fitness == target:
                patch = cand
                changed = True
                break
    return patch, target
