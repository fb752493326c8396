"""Static analysis.  This slice of the port carries only the structured
:class:`Diagnostic` type that the launch gates of ``kernels/costs.py``
build their messages from; the patch screen and the schedule linter of
:mod:`repro.core.analysis` are later work (see ROADMAP.md)."""

from .diagnostics import Diagnostic, block_divisibility, smem_capacity

__all__ = ["Diagnostic", "block_divisibility", "smem_capacity"]
