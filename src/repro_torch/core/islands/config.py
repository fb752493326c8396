"""Island configurations and the planner that maps islands onto the machine.

An :class:`IslandSpec` is everything that makes one island's search differ
from its neighbours': RNG seed, operator mix, mutation/crossover rates, and
(optionally) its own population size.  ``default_island_specs`` builds the
heterogeneous palette the GEVO follow-up work motivates — different operator
mixes maintain different kinds of diversity, and migration lets the mixes
trade discoveries — while :func:`plan` maps islands (and each island's
evaluator workers) onto the machine's cores and cards.

On a GPU every spawned island and every evaluator worker opens its own CUDA
context on the card and loads the kernel libraries there, so :func:`plan`
counts the cards as well as the cores: the contexts a plan opens are capped
by :data:`CONTEXT_RESERVE_BYTES` of the card's memory each, and in
``measured`` time no two processes time variants on one card at once.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..edits import OperatorWeights

# (operators, mutation_rate, init_mutations): one entry per default island.
# Cycled when more islands than entries are requested.  The palette spans
# the registry along different emphases — the full mix, a delete-heavy
# "time reducer", a const_perturb-heavy "learning-rate tuner", and a
# structural swap/insert mix — while every island keeps at least one
# error-driving operator (a pure {copy, delete} island measurably drags the
# fleet; pin ``operators="legacy"`` in an explicit IslandSpec to study it).
_PALETTE: tuple[tuple[str, float, int], ...] = (
    ("all", 0.5, 3),
    ("delete=2,copy=1,const_perturb=1", 0.7, 3),
    ("copy=1,delete=1,const_perturb=3", 0.7, 2),
    ("swap=2,insert=2,delete=1,const_perturb=1", 0.9, 2),
)

# rate/init variations used when every island shares one operator mix
# (schedule searches: the only legal operator is attr_tweak)
_RATE_PALETTE: tuple[tuple[float, int], ...] = (
    (0.5, 3), (0.9, 2), (0.3, 3), (0.7, 1),
)

# Device memory one process's CUDA context takes on the card with the
# kernel libraries loaded and a workload built and evaluated: the larger of
# the 2fcNet (886,636,544 bytes) and flash-attention (723,058,688 bytes)
# workloads, measured by chip_smoke.py's ``islands`` phase
# (``context_bytes``) on an NVIDIA H100 80GB HBM3 at 700.00 W, rounded up
# to whole GiB.  A plan opens no more contexts than the cards' memory holds
# at this size each.
CONTEXT_RESERVE_BYTES = 2**30


@dataclass(frozen=True)
class IslandSpec:
    """One island's search configuration.  ``operators`` takes anything
    ``OperatorWeights.coerce`` does (spec string, mapping, None for the
    default mix); ``pop_size``/``n_elite`` of ``None`` inherit the
    orchestrator-level defaults."""

    name: str
    seed: int = 0
    operators: object = None
    mutation_rate: float = 0.5
    crossover_rate: float = 0.8
    init_mutations: int = 3
    pop_size: int | None = None
    n_elite: int | None = None

    def to_doc(self) -> dict:
        ops = self.operators
        if ops is not None:
            # normalize to a plain mapping so docs compare across sessions
            ops = dict(OperatorWeights.coerce(ops).items)
        return {"name": self.name, "seed": self.seed, "operators": ops,
                "mutation_rate": self.mutation_rate,
                "crossover_rate": self.crossover_rate,
                "init_mutations": self.init_mutations,
                "pop_size": self.pop_size, "n_elite": self.n_elite}

    @staticmethod
    def from_doc(d: dict) -> "IslandSpec":
        return IslandSpec(**d)


def default_island_specs(n: int, *, operators=None, base_seed: int = 0,
                         mutation_rate: float | None = None
                         ) -> list[IslandSpec]:
    """``n`` heterogeneous island configs.  With ``operators=None`` each
    island draws a different mix from the built-in palette; with an explicit
    mix (e.g. ``{"attr_tweak": 1.0}`` for schedule searches) all islands
    share it and differ in rates and seeds instead."""
    specs = []
    for i in range(n):
        if operators is None:
            ops, mut, init = _PALETTE[i % len(_PALETTE)]
        else:
            mut, init = _RATE_PALETTE[i % len(_RATE_PALETTE)]
            ops = operators
        if mutation_rate is not None:
            mut = mutation_rate
        specs.append(IslandSpec(
            name=f"island-{i}", seed=base_seed + 7919 * i, operators=ops,
            mutation_rate=mut, init_mutations=init))
    return specs


@dataclass(frozen=True)
class CorePlan:
    """How islands map onto the machine: whether islands run as processes,
    how many evaluator worker processes each island gets on top of its own,
    and, on a GPU, the cards and the CUDA contexts the plan opens."""

    n_islands: int
    processes: bool
    eval_workers: int   # per island; 0/1 = in-process SerialEvaluator
    cores: int
    cards: int = 0
    card_name: str | None = None
    max_contexts: int | None = None   # what the cards' memory holds

    @property
    def contexts(self) -> int:
        """CUDA contexts the islands open: one a process (an island, or
        each of its evaluator workers), or the caller's own in-process."""
        if not self.processes:
            return 1
        return self.n_islands * max(1, self.eval_workers)

    def describe(self) -> str:
        mode = "process" if self.processes else "in-process"
        ev = (f"{self.eval_workers} evaluator workers each"
              if self.eval_workers > 1 else "serial evaluation")
        seen = f"{self.cores} cores seen"
        if self.cards:
            card = "card" if self.cards == 1 else "cards"
            name = f" ({self.card_name})" if self.card_name else ""
            seen += (f", {self.cards} {card}{name}, {self.contexts} CUDA "
                     f"contexts of at most {self.max_contexts}")
        return f"{self.n_islands} {mode} islands, {ev} ({seen})"


def _visible_cards() -> tuple[int, str | None, int | None]:
    """(count, name, memory in bytes) of the CUDA cards this process sees."""
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        return 0, None, None
    props = torch.cuda.get_device_properties(0)
    return n, props.name, props.total_memory


def plan(n_islands: int, *, cores: int | None = None,
         cards: int | None = None, time_mode: str = "static",
         reserve: int = 1, card_memory: int | None = None) -> CorePlan:
    """Map ``n_islands`` onto the machine: one core per island loop, the
    remainder split into per-island evaluator workers, ``reserve`` cores
    left for the orchestrator/OS.  Falls back to in-process islands when the
    machine is smaller than the fleet (oversubscribing spawned contexts is
    slower than just alternating).

    ``cards`` (default: the CUDA devices visible) adds two rules.  In
    ``measured`` time, islands run in-process, one after the other, with
    no evaluator workers: two processes timing variants on one card would
    time each other's work.  And the CUDA contexts the plan opens are
    capped by ``card_memory // CONTEXT_RESERVE_BYTES`` a card: evaluator
    workers go first, then island processes.  With no cards the plan is
    the core arithmetic alone."""
    if n_islands < 1:
        raise ValueError("n_islands must be >= 1")
    if time_mode not in ("static", "measured"):
        raise ValueError(f"unknown time_mode {time_mode!r}")
    cores = cores if cores is not None else (os.cpu_count() or 1)
    card_name = None
    if cards is None:
        cards, card_name, seen_memory = _visible_cards()
        card_memory = card_memory or seen_memory
    if cards and card_memory is None:
        raise ValueError("plan() needs card_memory when cards are given "
                         "and none is visible")
    max_contexts = (cards * (card_memory // CONTEXT_RESERVE_BYTES)
                    if cards else None)

    def made(processes: bool, workers: int) -> CorePlan:
        return CorePlan(n_islands, processes, workers, cores, cards,
                        card_name, max_contexts)

    usable = max(1, cores - reserve)
    if n_islands < 2 or usable < n_islands:
        return made(False, 0)
    if cards and time_mode == "measured":
        return made(False, 0)
    per_island = usable // n_islands
    # one core of each island's share runs its loop; the rest become
    # evaluator workers (a lone worker is pure overhead vs inline eval)
    workers = per_island - 1
    workers = workers if workers >= 2 else 0
    if cards:
        if n_islands > max_contexts:
            return made(False, 0)
        if n_islands * max(1, workers) > max_contexts:
            workers = max_contexts // n_islands
            workers = workers if workers >= 2 else 0
    return made(True, workers)
