"""GEVO-ML core on PyTorch: the IR, its builder and interpreter, the edit
registry and Patch algebra, schedule genomes, NSGA-II search, and the cached
evaluation engine.

Modules of later slices (islands, the tensorized engine, static analysis,
surrogates, deployment) are listed in ROADMAP.md.
"""

from .edits import (Edit, EditError, EditOp, OperatorStats, OperatorWeights,
                    Patch, apply_patch, minimize_patch, register_edit,
                    registered_ops, sample_edit)
from .evaluator import (EvalOutcome, FitnessCache, ParallelEvaluator,
                        SerialEvaluator, WorkloadSpec, make_evaluator)
from .fitness import (DeviceFault, InvalidVariant, KernelWorkload,
                      PredictionWorkload, TrainingWorkload)
from .schedule import ScheduleError, ScheduleSpace
from .search import GevoML, Individual, SearchResult, describe_patch

__all__ = [
    "Edit", "EditError", "EditOp", "OperatorStats", "OperatorWeights",
    "Patch", "apply_patch", "minimize_patch", "register_edit",
    "registered_ops", "sample_edit",
    "EvalOutcome", "FitnessCache", "ParallelEvaluator", "SerialEvaluator",
    "WorkloadSpec", "make_evaluator",
    "DeviceFault", "InvalidVariant", "KernelWorkload",
    "PredictionWorkload", "TrainingWorkload",
    "ScheduleError", "ScheduleSpace",
    "GevoML", "Individual", "SearchResult", "describe_patch",
]
