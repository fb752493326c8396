"""Tensorized evolution on the device (the EvoX-style engine).

The Python engine treats individuals as patch objects and evaluates them
one at a time; this package keeps a whole population as a fixed-shape
``(pop, n_knobs)`` index tensor and expresses every stage of the
generation — fitness, non-dominated sort, crowding, tournament, crossover,
mutation — as array programs, run as torch ops on the device:

* :mod:`.encoding` — index rows <-> genomes <-> canonical patches;
* :mod:`.xp` — ``TorchXP``, the torch namespace with numpy's semantics
  that the shared array code runs on;
* :mod:`.nsga2` — ``TensorNSGA2``, the array-native selection kernel
  (bit-exact twin of ``core/nsga2.py`` on the numpy backend and on torch);
* :mod:`.fitness` — batched roofline + gates + error-class tables;
* :mod:`.evaluator` — the batched path behind the ``Evaluator`` interface
  (what ``GevoML(engine="tensor")`` swaps in), with ``ParallelEvaluator``
  fallback for workloads that can't vectorize;
* :mod:`.engine` — ``TensorGevoML``, the generation loop on the device;
* :mod:`.islands` — ``TensorIslandFleet``, N islands along the leading
  axis of one device tensor (the ``backend="mesh"`` of
  ``IslandOrchestrator``).
"""

from .encoding import CANONICAL_SEED, GenomeEncoding
from .engine import TensorGevoML
from .evaluator import TensorEvaluator, make_tensor_evaluator, tensorizable
from .fitness import BatchedFitness, KernelBlock, TensorFitnessSpec
from .islands import TensorIslandFleet, mesh_writer_tag
from .nsga2 import (TensorNSGA2, pareto_front, rank_crowd, rank_select,
                    selection_order)
from .xp import TorchXP

__all__ = [
    "CANONICAL_SEED", "GenomeEncoding",
    "TensorNSGA2", "rank_crowd", "rank_select", "selection_order",
    "pareto_front", "TorchXP",
    "TensorFitnessSpec", "KernelBlock", "BatchedFitness",
    "TensorEvaluator", "make_tensor_evaluator", "tensorizable",
    "TensorGevoML", "TensorIslandFleet", "mesh_writer_tag",
]
