"""Static analysis over the HLO-lite IR: dataflow facts, a patch-effect
classifier, and a schedule linter.

GEVO-ML (Sec. 6) reports that most proposed mutations are invalid or
semantically inert; this package decides that *statically* so the evaluators
can skip the execution entirely (see ``Evaluator.screen`` in
``core/evaluator.py``).  Submodules:

* :mod:`.dataflow` — def-use chains, liveness / dead-code elimination,
  conservative constant folding, the canonical normal form and its
  fingerprint;
* :mod:`.classify` — the patch-effect classifier
  (``invalid`` / ``noop`` / ``equivalent`` / ``novel``);
* :mod:`.diagnostics` — the structured :class:`Diagnostic` type shared with
  the ``kernels/costs.py`` launch gates (one source for the gate text);
* :mod:`.lint` — the schedule linter: per-knob diagnostics with fix hints
  (imported lazily by the CLI; kept out of this namespace so importing
  ``kernels.costs`` → ``diagnostics`` never cycles back into ``kernels``).

CLI: ``python -m repro_torch.core.analysis {lint,explain,diff} PATH`` works
on any checkpoint, front export, or registry artifact.
"""

from .classify import (VERDICTS, KernelScreen, PatchScreen, ProgramScreen,
                       ScreenResult, make_screen)
from .dataflow import (canonical_fingerprint, dead_ops, def_use_chains,
                       eliminate_dead, fold_constants, live_values, normalize)
from .diagnostics import Diagnostic, block_divisibility, smem_capacity

__all__ = [
    "VERDICTS", "KernelScreen", "PatchScreen", "ProgramScreen",
    "ScreenResult", "make_screen",
    "canonical_fingerprint", "dead_ops", "def_use_chains", "eliminate_dead",
    "fold_constants", "live_values", "normalize",
    "Diagnostic", "block_divisibility", "smem_capacity",
]
