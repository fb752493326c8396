"""GEVO-ML core on PyTorch: the IR, its builder and interpreter, the edit
registry and Patch algebra, schedule genomes, NSGA-II search, the cached
evaluation engine, the island-model orchestrator (multi-population search
with migration over a shared cache), the tensorized engine (whole
populations as index tensors on the device), the deployment layer
(Pareto-front queries, the artifact registry, the continuous-batching
serving engine and its KV plan), the live loop's traces, and the surrogate
layer.  ``core.autotune`` is GEVO-Shard, the search over a model's
distribution plan (``python -m repro_torch.core.autotune``), imported
from its module.
"""

from .deploy import (Artifact, ArtifactRegistry, FrontMember, ParetoFront,
                     ServeEngine, ServeRequest, ServeResult)
from .edits import (Edit, EditError, EditOp, OperatorStats, OperatorWeights,
                    Patch, apply_patch, minimize_patch, register_edit,
                    registered_ops, sample_edit)
from .evaluator import (EvalOutcome, FitnessCache, ParallelEvaluator,
                        SerialEvaluator, WorkloadSpec, make_evaluator)
from .fitness import (DeviceFault, InvalidVariant, KernelWorkload,
                      PredictionWorkload, TrainingWorkload)
from .islands import (IslandOrchestrator, IslandResult, IslandSpec,
                      default_island_specs)
from .islands import plan as plan_islands
from .schedule import ScheduleError, ScheduleSpace
from .search import GevoML, Individual, SearchResult, describe_patch
from .surrogate import SurrogateGuide, SurrogateModel, make_featurizer
from .tensor_evo import (GenomeEncoding, TensorEvaluator, TensorGevoML,
                         TensorIslandFleet, TensorNSGA2,
                         make_tensor_evaluator)

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
    "IslandOrchestrator", "IslandResult", "IslandSpec",
    "default_island_specs", "plan_islands",
    "ParetoFront", "FrontMember", "Artifact", "ArtifactRegistry",
    "ServeEngine", "ServeRequest", "ServeResult",
    "GenomeEncoding", "TensorNSGA2", "TensorEvaluator",
    "make_tensor_evaluator", "TensorGevoML", "TensorIslandFleet",
    "SurrogateGuide", "SurrogateModel", "make_featurizer",
]
