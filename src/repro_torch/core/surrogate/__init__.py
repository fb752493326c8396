"""Surrogate-guided search: learn a cost model from the FitnessCache and
pre-rank candidates before they reach the evaluator.

The FitnessCache records every measured ``(patch, fitness)`` the searches,
islands, screens, and serving paths have ever produced; with a featurizing
evaluator it also records the candidate's feature vector.  This package
turns that log into a model (Meliora's move, on GEVO's cache) and the model
into a pre-rank stage: each generation over-generates, the surrogate keeps
the predicted-Pareto slice, and only that slice is executed — after the
static screen has already resolved what it can exactly.

Layers:

* :mod:`~repro_torch.core.surrogate.features` — patch/genome -> feature vector
  (one-hot schedule knobs + ``kernels.costs`` roofline/shared-memory
  counters, or
  normal-form program structure).
* :mod:`~repro_torch.core.surrogate.model` — plain-numpy ridge on log-domain
  targets, with :func:`~repro_torch.core.surrogate.model.pareto_order` to rank
  predictions the way NSGA-II would.
* :mod:`~repro_torch.core.surrogate.dataset` — ``(keys, X, Y)`` out of a live
  cache or a raw cache JSONL.
* :mod:`~repro_torch.core.surrogate.prerank` — the
  :class:`~repro_torch.core.surrogate.prerank.SurrogateGuide` the engines embed.

CLI:  PYTHONPATH=src python -m repro_torch.core.surrogate train|eval|rank ...
"""

from .dataset import dataset_from_cache, dataset_from_jsonl, load_dataset
from .features import (ProgramFeaturizer, ScheduleFeaturizer,
                       feature_matrix, make_featurizer)
from .model import SurrogateModel, pareto_order, spearman
from .prerank import SurrogateGuide

__all__ = [
    "ProgramFeaturizer", "ScheduleFeaturizer", "SurrogateGuide",
    "SurrogateModel", "dataset_from_cache", "dataset_from_jsonl",
    "feature_matrix", "load_dataset", "make_featurizer", "pareto_order",
    "spearman",
]
