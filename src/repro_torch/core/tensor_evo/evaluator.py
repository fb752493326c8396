"""TensorEvaluator: the batched fitness path behind the standard
``Evaluator`` interface.

``GevoML(engine="tensor")`` swaps this in for ``SerialEvaluator``: cache
keys, dedupe, and outcome bookkeeping are inherited unchanged from
:class:`~repro_torch.core.evaluator.Evaluator`; only ``_evaluate_misses``
differs — patches are decoded to index rows, stacked, and pushed through
``BatchedFitness.evaluate_np`` in one call.  The numpy batched path is
bit-exact with ``SerialEvaluator`` (times from the same array core the
scalar API wraps, errors from the same kernel executions), and the
*messages* of invalid outcomes are reproduced verbatim (decode errors where
decode fails, the first failing launch gate otherwise, ``"non-finite
objective"`` for executions that return nan/inf) — asserted by
``tests/test_tensor_evo.py``.

Workloads that don't carry a :class:`TensorFitnessSpec` (``tensor_spec``
attribute), or that measure wall-clock time, can't be vectorized;
:func:`make_tensor_evaluator` falls back to ``ParallelEvaluator`` for those.
"""

from __future__ import annotations

import numpy as np

from ..edits import EditError
from ..evaluator import (Evaluator, EvalOutcome, FitnessCache,
                         ParallelEvaluator)
from .encoding import GenomeEncoding
from .fitness import BatchedFitness, TensorFitnessSpec


def tensorizable(workload) -> bool:
    """True when the workload can take the batched path: it declares a
    tensor fitness spec and its time objective is the static roofline (a
    measured-time objective is a real wall clock — not vectorizable)."""
    return (isinstance(getattr(workload, "tensor_spec", None),
                       TensorFitnessSpec)
            and getattr(workload, "time_mode", None) == "static")


class TensorEvaluator(Evaluator):
    """Batched evaluation of schedule-genome patches.

    Each cache-missing patch decodes to one lane of an index matrix; the
    whole matrix is evaluated in one batched call.  Patches that fail to
    decode (bad edit, bad schedule constant) become invalid outcomes with
    the serial path's exact message and never reach the batch."""

    def __init__(self, workload, cache: FitnessCache | None = None):
        if not tensorizable(workload):
            raise ValueError(
                f"workload {getattr(workload, 'name', '?')!r} is not "
                "tensorizable (needs tensor_spec + static time_mode); use "
                "make_tensor_evaluator for automatic fallback")
        super().__init__(workload, cache)
        self.encoding = GenomeEncoding.of(workload.space, workload.program)
        self.batched = BatchedFitness(workload.tensor_spec, self.encoding)
        self.n_batched = 0    # lanes evaluated through the batched call
        self.n_decode_fail = 0

    def _evaluate_misses(self, patches) -> list[EvalOutcome]:
        outcomes: list[EvalOutcome | None] = [None] * len(patches)
        rows, lanes = [], []
        for i, patch in enumerate(patches):
            try:
                rows.append(self.encoding.from_patch(
                    patch, self.workload.program))
                lanes.append(i)
            except EditError as e:
                outcomes[i] = EvalOutcome(fitness=None, error=str(e))
                self.n_decode_fail += 1
            except Exception as e:  # ScheduleError etc. — serial wraps str(e)
                outcomes[i] = EvalOutcome(fitness=None, error=str(e))
                self.n_decode_fail += 1
        if rows:
            outs = self.evaluate_rows(np.stack(rows))
            for i, out in zip(lanes, outs):
                outcomes[i] = out
        return outcomes  # type: ignore[return-value]

    def evaluate_rows(self, idx) -> list[EvalOutcome]:
        """Outcomes for an (n, n_knobs) index matrix, bypassing the Patch
        layer (the tensor engine reports results through this)."""
        idx = np.asarray(idx)
        time, valid, err, reasons = self.batched.evaluate_np(idx)
        self.n_batched += len(idx)
        outs = []
        for j in range(len(idx)):
            if not valid[j]:
                outs.append(EvalOutcome(fitness=None, error=reasons[j]))
            elif not (np.isfinite(time[j]) and np.isfinite(err[j])):
                outs.append(EvalOutcome(fitness=None,
                                        error="non-finite objective"))
            else:
                outs.append(EvalOutcome(
                    fitness=(float(time[j]), float(err[j]))))
        return outs

    def stats(self) -> dict:
        s = super().stats()
        s.update({"n_batched": self.n_batched,
                  "n_decode_fail": self.n_decode_fail})
        return s


def make_tensor_evaluator(workload, *, cache: FitnessCache | None = None,
                          n_workers: int = 2,
                          screen: bool = False) -> Evaluator:
    """TensorEvaluator when the workload vectorizes, else the process-pool
    fallback (``ParallelEvaluator`` with static short-circuiting) — the
    engine never refuses a workload, it just loses the batching win.
    ``screen=True`` attaches the static patch screen (``core.analysis``):
    the inherited ``evaluate_batch`` resolves invalid / noop / equivalent
    mutants before they reach the batched (or pooled) dispatch."""
    if tensorizable(workload):
        ev: Evaluator = TensorEvaluator(workload, cache=cache)
    else:
        ev = ParallelEvaluator(workload, n_workers=n_workers, cache=cache,
                               inline_static=True)
    if screen:
        from ..analysis import make_screen
        ev.screen = make_screen(workload)
    return ev
