"""The edit layer: pluggable operators + first-class Patch algebra.

Public surface (re-exported from :mod:`repro_torch.core`):

* :class:`Edit`, :class:`EditError` — the edit record and its failure mode;
* :class:`EditOp`, :func:`register_edit`, :func:`get_edit_op`,
  :func:`registered_ops` — the operator protocol and registry;
* :class:`Patch` — immutable edit sequence with apply / describe / doc
  round-trip / canonical hashing; :func:`apply_patch`, :func:`apply_edit`;
* :class:`OperatorWeights`, :func:`sample_edit` — configurable sampling mix;
* :func:`minimize_patch` — greedy ddmin key-mutation isolation;
* :class:`OperatorStats` — per-operator proposed/valid/elite counters;
* :func:`resize_value` — the paper's tensor-resize repair (shared by all
  operators; useful to custom ones too).

Importing this package registers the six built-in operators:
``delete``, ``copy``, ``swap``, ``insert``, ``const_perturb``, and
``attr_tweak`` (the schedule-knob operator backing kernel-schedule search;
inert on programs without knob constants).
"""

from .base import (Edit, EditError, EditOp, describe_edit, edit_from_doc,
                   edit_to_doc, get_edit_op, operator_modules, register_edit,
                   registered_ops)
from .minimize import minimize_patch
from .patch import Patch, apply_edit, apply_patch
from .repair import pick_donor, rebind_use, resize_value, retype
from .sampling import OperatorWeights, sample_edit
from .stats import OperatorStats

from . import ops as _builtin_ops  # noqa: F401  (registers the built-ins)
from . import schedule_ops as _schedule_ops  # noqa: F401  (attr_tweak)

__all__ = [
    "Edit", "EditError", "EditOp", "Patch",
    "register_edit", "get_edit_op", "registered_ops", "operator_modules",
    "describe_edit", "edit_to_doc", "edit_from_doc",
    "apply_edit", "apply_patch",
    "OperatorWeights", "sample_edit", "OperatorStats",
    "minimize_patch",
    "resize_value", "pick_donor", "rebind_use", "retype",
]
