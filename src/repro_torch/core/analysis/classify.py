"""The patch-effect classifier: static verdicts for proposed mutants.

GEVO-ML's own Sec. 6 analysis shows most proposed mutations are invalid or
semantically inert — and until now the evaluator discovered that by
*executing* them.  A :class:`PatchScreen` decides statically, labeling each
patch against its baseline program:

* ``invalid``    — the patch fails to apply, or the variant statically
  violates the workload's execution contract (lost/reshaped weight outputs,
  bad logits shape, mangled schedule genome, failed launch gate).  The
  verdict carries the **byte-identical** error message evaluation would have
  produced, so screened and unscreened runs agree on every outcome.
* ``noop``       — the variant's canonical form equals the baseline's: every
  edit landed in dead code or normalized away.
* ``equivalent`` — the canonical form collides with an already-observed
  variant's.
* ``novel``      — none of the above; the variant must be executed.

``noop``/``equivalent`` mutants inherit their canonical representative's
*error* objective and recompute the static *time* objective for their own op
list (dead code still occupies the roofline — ``static_time`` sums every
op), which reproduces exactly the fitness execution would have measured in
``static`` time mode.  In ``measured`` mode only ``invalid`` screening is
sound (measured times are not inheritable) and the screens degrade to that
automatically.

:func:`make_screen` builds the right screen for any workload kind; the
evaluator layer (:mod:`repro_torch.core.evaluator`) consults it before dispatching
cache misses and tags screened verdicts in the shared fitness cache under an
``analysis:`` writer.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace

from ..edits import EditError, Patch
from ..evaluator import EvalOutcome
from ..fitness import InvalidVariant, static_time
from ..ir import Program
from .dataflow import canonical_fingerprint, normalize

VERDICTS = ("invalid", "noop", "equivalent", "novel")


@dataclass(frozen=True)
class ScreenResult:
    """One classification: the ``label``, a resolved ``outcome`` when the
    verdict needed no execution, the canonical ``canon`` key (None for
    invalid patches), and the applied variant ``program`` (IR screens) or
    decoded ``genome`` (kernel screens) for downstream bookkeeping."""

    label: str
    outcome: EvalOutcome | None = None
    canon: str | None = None
    program: Program | None = None
    genome: dict | None = None

    @property
    def resolved(self) -> bool:
        return self.outcome is not None


class PatchScreen:
    """Base screen: apply → static contract check → canonicalize → compare.

    Subclasses define the canonical key, the static invalidity check, and
    how an equivalent variant inherits its representative's fitness.  The
    screen *observes* executed outcomes (``observe``) to grow its seen-set,
    so the first variant of each equivalence class executes and every later
    one inherits — across generations, and across islands via the shared
    cache."""

    def __init__(self, workload):
        self.w = workload
        self.inherit_ok = getattr(workload, "time_mode", None) == "static"
        self.seen: dict[str, EvalOutcome] = {}
        self.baseline_canon = self._canon_of(workload.program)

    # -- subclass surface ---------------------------------------------------
    def _canon_of(self, program: Program) -> str | None:
        raise NotImplementedError

    def _static_invalid(self, program: Program) -> str | None:
        """The exact evaluation-time error message, when one is statically
        certain; None when the variant might execute."""
        return None

    def _inherit_fitness(self, rep: EvalOutcome, res: ScreenResult
                         ) -> tuple[float, float]:
        raise NotImplementedError

    # -- protocol -----------------------------------------------------------
    def classify(self, patch) -> ScreenResult:
        patch = Patch.coerce(patch)
        try:
            program = patch.apply(self.w.program)
        except (EditError, InvalidVariant) as e:
            return ScreenResult(
                "invalid", outcome=EvalOutcome(fitness=None, error=str(e)))
        err = self._static_invalid(program)
        if err is not None:
            return ScreenResult(
                "invalid", outcome=EvalOutcome(fitness=None, error=err),
                program=program)
        canon = self._canon_of(program)
        if canon is None or not self.inherit_ok:
            return ScreenResult("novel", canon=None, program=program)
        return self._resolve(canon, program=program)

    def _resolve(self, canon: str, *, program=None, genome=None
                 ) -> ScreenResult:
        """Fold a canonical key against the seen-set: resolve when a
        representative exists, else mark for execution (an unseen ``noop``
        keeps its label but still executes — its representative IS the
        baseline, which the search evaluates first; an unseen class is
        simply ``novel``)."""
        label = self.label_for(canon)
        res = ScreenResult(label, canon=canon, program=program,
                           genome=genome)
        rep = self.seen.get(canon)
        if rep is not None:
            return replace(res, outcome=self.inherit(res, rep))
        return replace(res, label="novel") if label == "equivalent" else res

    def label_for(self, canon: str) -> str:
        return "noop" if canon == self.baseline_canon else "equivalent"

    def inherit(self, res: ScreenResult, rep: EvalOutcome) -> EvalOutcome:
        """The outcome a screened mutant inherits from its canonical
        representative: the representative's invalidity verbatim, or its
        error objective with this variant's own static time."""
        if not rep.ok:
            return EvalOutcome(fitness=None, error=rep.error)
        return EvalOutcome(fitness=self._inherit_fitness(rep, res))

    def observe(self, res: ScreenResult, outcome: EvalOutcome) -> None:
        """Record an executed outcome as its class's representative."""
        if res.canon is not None and res.canon not in self.seen:
            self.seen[res.canon] = replace(outcome, cached=False,
                                           verdict=None)


class ProgramScreen(PatchScreen):
    """Screen for IR workloads (training / prediction): canonical key is the
    normalized program's fingerprint; static contract checks replicate the
    workload's shape-interface errors byte-for-byte."""

    def _canon_of(self, program: Program) -> str:
        return canonical_fingerprint(normalize(program))

    def _static_invalid(self, program: Program) -> str | None:
        kind = getattr(self.w, "kind", None)
        if kind == "training":
            if len(program.outputs) != len(self.w.weight_names):
                return "variant lost weight outputs"
            for k, vid in zip(self.w.weight_names, program.outputs):
                shape = program.type_of(vid).shape
                if shape != tuple(self.w.init_weights[k].shape):
                    return f"weight {k} shape drifted to {shape}"
        elif kind == "prediction" and program.outputs:
            t = program.type_of(program.outputs[0])
            if t.rank != 2 or t.shape[0] != self.w.batch:
                return f"bad logits shape {t.shape}"
        return None

    def _inherit_fitness(self, rep, res) -> tuple[float, float]:
        kind = getattr(self.w, "kind", None)
        if kind == "training":
            t = static_time(res.program) * self.w.steps
        else:   # prediction: whole-eval-set roofline, as the workload does
            n = (len(self.w.images) // self.w.batch) * self.w.batch
            t = static_time(res.program) * (n // self.w.batch)
        return (t, rep.fitness[1])


class KernelScreen(PatchScreen):
    """Screen for schedule-genome workloads: canonical key is the decoded
    genome (two edit lists landing on the same knob values are the same
    schedule), and the workload's ``static_probe`` — the same roofline call
    its runner makes first — surfaces launch-gate failures with the exact
    scalar-path message before any kernel executes."""

    def _canon_of(self, program: Program) -> str | None:
        try:
            genome = self.w.space.decode(program)
        except Exception:
            return None
        return json.dumps(sorted(genome.items()), separators=(",", ":"))

    def classify(self, patch) -> ScreenResult:
        patch = Patch.coerce(patch)
        try:
            program = patch.apply(self.w.program)
        except (EditError, InvalidVariant) as e:
            return ScreenResult(
                "invalid", outcome=EvalOutcome(fitness=None, error=str(e)))
        try:
            genome = self.w.space.decode(program)
        except Exception as e:   # ScheduleError — serial path wraps str(e)
            return ScreenResult(
                "invalid", outcome=EvalOutcome(fitness=None, error=str(e)),
                program=program)
        probe = getattr(self.w, "static_probe", None)
        if probe is not None:
            try:
                probe(genome)
            except InvalidVariant as e:   # failed launch gate, exact message
                return ScreenResult(
                    "invalid", outcome=EvalOutcome(fitness=None,
                                                   error=str(e)),
                    program=program, genome=genome)
        if not self.inherit_ok:
            return ScreenResult("novel", program=program, genome=genome)
        canon = json.dumps(sorted(genome.items()), separators=(",", ":"))
        return self._resolve(canon, program=program, genome=genome)

    def _inherit_fitness(self, rep, res) -> tuple[float, float]:
        # the runner sees only the decoded genome: identical genome,
        # identical (time, error)
        return rep.fitness


def make_screen(workload) -> PatchScreen | None:
    """The right screen for a workload — or None for workload kinds the
    analyzer has no static model of (callers treat None as 'no screen')."""
    kind = getattr(workload, "kind", None)
    if kind == "kernel":
        return KernelScreen(workload)
    if kind in ("training", "prediction"):
        return ProgramScreen(workload)
    return None
