"""Structured diagnostics — one message type for gates and the linter.

The cost model's gate raisers (``kernels/costs.py``) and the schedule
linter (:mod:`.lint`) build their text through the constructors below, so
the message a failed config raises at evaluation time is byte-identical to
the one ``python -m repro_torch.core.analysis lint`` prints next to its
fix hint.  The block-divisibility text is byte-identical to the reference
package's; the capacity gate names the GPU's shared memory per block, which
is what bounds a CUDA kernel's launch.
"""

from __future__ import annotations

from dataclasses import dataclass

SEVERITIES = ("error", "warning", "info")

# diagnostic codes used by the launch gates and the linter
BLOCK_DIVISIBILITY = "block-divisibility"
SMEM_CAPACITY = "smem-capacity"
SCHEDULE_DECODE = "schedule-decode"
SCHEDULE_OK = "schedule-ok"
KNOB_INERT = "knob-inert"


@dataclass(frozen=True)
class Diagnostic:
    """One structured finding about a schedule (or program) configuration.

    ``message`` is the human line — for gate diagnostics it is exactly the
    :class:`~repro_torch.core.fitness.InvalidVariant` text the evaluator would
    raise.
    ``knob`` names the schedule knob at fault (when one is), and ``hint``
    carries an actionable fix ("choose a block from ...")."""

    code: str
    severity: str
    subject: str
    message: str
    knob: str | None = None
    hint: str | None = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"choose from {SEVERITIES}")

    @property
    def is_error(self) -> bool:
        return self.severity == "error"

    def format(self) -> str:
        """The CLI line: ``severity[code] message  (hint: ...)``."""
        out = f"{self.severity}[{self.code}] {self.message}"
        if self.hint:
            out += f"  (hint: {self.hint})"
        return out

    def to_doc(self) -> dict:
        return {"code": self.code, "severity": self.severity,
                "subject": self.subject, "message": self.message,
                "knob": self.knob, "hint": self.hint}

    @staticmethod
    def from_doc(d: dict) -> "Diagnostic":
        return Diagnostic(code=d["code"], severity=d["severity"],
                          subject=d["subject"], message=d["message"],
                          knob=d.get("knob"), hint=d.get("hint"))


# -- gate-message constructors (the single source of the gate text) ----------

def block_divisibility(subject: str, dim: int, block: int, *,
                       knob: str | None = None,
                       hint: str | None = None) -> Diagnostic:
    """A block size that does not divide its grid dimension.  The message is
    the reference package's text, byte for byte."""
    return Diagnostic(
        code=BLOCK_DIVISIBILITY, severity="error", subject=subject,
        message=f"{subject}: block {block} does not divide dim {dim}",
        knob=knob, hint=hint)


def smem_capacity(subject: str, used: int, smem_bytes: int, *,
                  knob: str | None = None,
                  hint: str | None = None) -> Diagnostic:
    """A kernel whose dynamic shared memory exceeds what one block may use
    on the device."""
    return Diagnostic(
        code=SMEM_CAPACITY, severity="error", subject=subject,
        message=(f"{subject}: shared memory per block {used / 2**10:.1f} KB "
                 f"exceeds {smem_bytes / 2**10:.0f} KB — config would not "
                 "launch"),
        knob=knob, hint=hint)
