"""One-point messy crossover over the patch representation (Section 4.2).

Concatenate two parents' edits, shuffle, cut at a random point, and return
both halves as :class:`~repro_torch.core.edits.Patch`es to reapply against the
original program.  ~80% of recombinations were valid in the paper; invalid
ones are retried by the caller.  The degenerate case — both parents are the
unmodified original — yields two empty patches (callers fall back to
mutation).
"""

from __future__ import annotations

import numpy as np

from .edits import Patch


def messy_crossover(patch_a, patch_b, rng: np.random.Generator
                    ) -> tuple[Patch, Patch]:
    pool = Patch.coerce(patch_a).edits + Patch.coerce(patch_b).edits
    if not pool:
        return Patch(), Patch()
    order = rng.permutation(len(pool))
    shuffled = [pool[i] for i in order]
    cut = int(rng.integers(0, len(shuffled) + 1))
    return Patch(tuple(shuffled[:cut])), Patch(tuple(shuffled[cut:]))
