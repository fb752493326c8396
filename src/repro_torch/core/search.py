"""The GEVO-ML search loop (Section 4): NSGA-II over IR patches.

Generation structure per the paper:
  * initial population: copies of the original program with 3 random
    mutations each;
  * every generation: rank by (time, error), copy the top-16 elites
    unchanged, fill the rest with offspring produced by one-point messy
    crossover of tournament-selected parents followed by mutation;
  * invalid variants (failed execution / un-applicable patches) are
    resampled until a valid individual is found.

Individuals carry a first-class :class:`~repro_torch.core.edits.Patch`; mutation
samples edits through the operator registry with a configurable
:class:`~repro_torch.core.edits.OperatorWeights` mix (``operators=``), and
per-operator proposed / applied / valid / elite-survival counters
(:class:`~repro_torch.core.edits.OperatorStats`) are snapshotted into every
``SearchResult.history`` row and checkpoint — the paper's Sec. 6 mutation
analysis as a free by-product.

Evaluation goes through the :mod:`repro_torch.core.evaluator` engine: candidates
for a generation are drawn speculatively in batches and handed to the
evaluator as a unit, so a ``ParallelEvaluator`` overlaps variant executions
across worker processes while the (cheap, RNG-driven) candidate generation
stays in the parent — serial and parallel runs consume the RNG identically
and are therefore bit-identical in ``static`` fitness mode.  Fitness values
are cached by canonical patch hash — patches are deterministic (each edit
carries its own seed), so identical patches are identical programs; with a
persistent cache, repeated or resumed runs never re-measure a known variant.

Long searches checkpoint each generation (population + RNG state + cache
stats + operator stats, via :mod:`repro_torch.core.serialize`) and
``run(resume=True)`` continues a checkpointed search to the same result as
an uninterrupted one.  Checkpoint documents have the reference package's
layout, so either package reads the other's patches and RNG state.
"""

from __future__ import annotations

import json
import os
import time as _time
from dataclasses import dataclass, field

import numpy as np

from .crossover import messy_crossover
from .edits import (Edit, EditError, OperatorStats, OperatorWeights, Patch,
                    sample_edit)
from .evaluator import (Evaluator, EvalOutcome, FitnessCache,
                        SerialEvaluator)
from .fitness import InvalidVariant
from .nsga2 import pareto_front, rank_select, tournament
from .serialize import (atomic_write_json, patch_doc, patch_from_doc,
                        rng_from_state, rng_state_doc)


@dataclass(frozen=True)
class Individual:
    """One population member: an immutable :class:`Patch` (the genome —
    the edit list that, applied to the workload's original program,
    produces this variant) paired with its evaluated ``(time, error)``
    fitness, both objectives minimized.  Hashable, so populations can be
    de-duplicated by identity or by fitness."""

    patch: Patch
    fitness: tuple[float, float]  # (time, error) — minimized

    @property
    def edits(self) -> tuple[Edit, ...]:
        return self.patch.edits


@dataclass
class SearchResult:
    """What a finished (or resumed) :class:`GevoML` run hands back: the
    original program's fitness, the final population, its de-duplicated
    Pareto front, and one history row per generation (best objectives,
    evaluation/cache counters, per-operator stats, wall time)."""

    original_fitness: tuple[float, float]
    population: list[Individual]
    pareto: list[Individual]
    history: list[dict] = field(default_factory=list)

    def best_by_time(self) -> Individual:
        return min(self.pareto, key=lambda i: i.fitness[0])

    def best_by_error(self) -> Individual:
        return min(self.pareto, key=lambda i: i.fitness[1])

    def operator_stats(self) -> dict:
        """Final per-operator proposed/valid/elite counters."""
        return self.history[-1]["operators"] if self.history else {}

    def to_front(self, origin: str = "search"):
        """This result's Pareto front as a deployable
        :class:`~repro_torch.core.deploy.ParetoFront` (members carry
        canonical patch docs, so the deployment layer can re-apply winners
        without the workload)."""
        from .deploy.front import FrontMember, ParetoFront
        return ParetoFront.from_members(
            (FrontMember(fitness=i.fitness, patch=tuple(patch_doc(i.patch)),
                         source=origin) for i in self.pareto),
            origin=origin,
            meta={"original_fitness": list(self.original_fitness),
                  "generations": len(self.history)})

    def export_front(self, path: str, origin: str = "search") -> None:
        """Write the front doc ``ParetoFront.load`` consumes — the handoff
        from a finished search to deployment."""
        self.to_front(origin).export(path)


class GevoML:
    """NSGA-II search over registered-operator patches of one workload's
    program.

    ``operators`` selects the mutation sampling mix: an
    :class:`OperatorWeights`, a ``{name: weight}`` mapping, a CLI spec string
    (``"legacy"``, ``"all"``, ``"copy=1,delete=1,const_perturb=0.5"``), or
    ``None`` for uniform over every registered operator.

    ``evaluator`` defaults to an in-process :class:`SerialEvaluator`; pass a
    :class:`~repro_torch.core.evaluator.ParallelEvaluator` (or use
    ``cache_path`` for a persistent fitness store) to scale evaluation.
    ``checkpoint_dir`` enables per-generation snapshots and
    ``run(resume=True)``.

    ``screen=True`` adds the static patch screen
    (:mod:`repro_torch.core.analysis`): invalid, noop and equivalent
    mutants resolve without execution, with the fitness execution would
    give (in measured time mode only invalid ones).

    ``surrogate=True`` adds the cache-trained pre-rank stage
    (:mod:`repro_torch.core.surrogate`): offspring are generated at the
    normal rate but only the predicted-Pareto slice — ``surrogate_keep`` of
    the fill, at least 1 — is executed each generation, after the cache
    lookup and the static screen have resolved what they can exactly.
    Guided runs trade bit-exact replay for executed-evaluation savings:
    resuming one reproduces counters, not RNG-identical populations, unless
    the cache is persistent.

    ``engine`` selects the evaluation/selection machinery: ``"python"`` is
    the per-genome path above; ``"tensor"`` swaps in the batched evaluator
    (:func:`~repro_torch.core.tensor_evo.make_tensor_evaluator` — one
    vectorized fitness call per generation batch, with automatic fallback
    for non-tensorizable workloads) and the array-native NSGA-II
    (:class:`~repro_torch.core.tensor_evo.TensorNSGA2`), both on their
    numpy paths.  Both are bit-exact twins of the Python path and the RNG
    is consumed identically, so a seeded run produces the same
    populations, elites, and Pareto front under either engine.  For the
    generation loop on the device, see
    :class:`~repro_torch.core.tensor_evo.TensorGevoML`.
    """

    ENGINES = ("python", "tensor")

    def __init__(self, workload, *, pop_size: int = 32, n_elite: int = 16,
                 init_mutations: int = 3, crossover_rate: float = 0.8,
                 mutation_rate: float = 0.5, max_tries: int = 40,
                 seed: int = 0, verbose: bool = False,
                 operators: OperatorWeights | dict | str | None = None,
                 evaluator: Evaluator | None = None,
                 cache_path: str | None = None,
                 checkpoint_dir: str | None = None,
                 engine: str = "python", screen: bool = False,
                 surrogate: bool = False, surrogate_keep: float = 0.5,
                 surrogate_live: bool = False):
        if engine not in self.ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"choose from {self.ENGINES}")
        self.engine = engine
        self.w = workload
        self.pop_size = pop_size
        self.n_elite = min(n_elite, pop_size)
        self.init_mutations = init_mutations
        self.crossover_rate = crossover_rate
        self.mutation_rate = mutation_rate
        self.max_tries = max_tries
        self.rng = np.random.default_rng(seed)
        self.verbose = verbose
        self.operators = OperatorWeights.coerce(operators).validate()
        self.stats = OperatorStats(self.operators.names())
        self._owns_evaluator = evaluator is None
        if evaluator is None:
            cache = FitnessCache(cache_path)
            if engine == "tensor":
                from .tensor_evo.evaluator import make_tensor_evaluator
                evaluator = make_tensor_evaluator(workload, cache=cache)
            else:
                evaluator = SerialEvaluator(workload, cache=cache)
        elif cache_path is not None:
            raise ValueError("pass cache_path OR a pre-built evaluator "
                             "(give its FitnessCache the path), not both")
        self.evaluator = evaluator
        if screen and getattr(self.evaluator, "screen", None) is None:
            # static pre-execution triage (invalid/noop/equivalent mutants
            # skip evaluation; fitness outcomes are unchanged bit-for-bit)
            from .analysis import make_screen
            self.evaluator.screen = make_screen(workload)
        self.guide = None
        if surrogate:
            # surrogate pre-rank: offspring are over-generated, the cache-
            # trained cost model keeps the predicted-Pareto slice, and only
            # that slice is executed.  Runs AFTER the cache lookup and the
            # static screen — the model prioritizes among unknowns, it never
            # overrides an exact verdict.
            # surrogate_live makes the guide reload the cache before every
            # refit, folding in rows other writers (the live-loop serving
            # fleet) appended since the last read
            from .surrogate import SurrogateGuide
            self.guide = SurrogateGuide(workload, keep=surrogate_keep,
                                        live=surrogate_live)
            if getattr(self.evaluator, "featurizer", None) is None:
                # record features on every measured outcome so the cache
                # this search writes is itself surrogate training data
                self.evaluator.featurizer = self.guide.featurizer
        if engine == "tensor":
            from .tensor_evo import nsga2 as _tnsga
            self._rank_select = _tnsga.rank_select
            self._pareto_front = _tnsga.pareto_front
        else:
            self._rank_select = rank_select
            self._pareto_front = pareto_front
        self.checkpoint_dir = checkpoint_dir
        self._n_invalid_outcomes = 0

    # -- counters (cache-aware; executions live on the evaluator) ----------
    @property
    def n_evals(self) -> int:
        return self.evaluator.n_evals

    @property
    def n_invalid(self) -> int:
        return self._n_invalid_outcomes

    @property
    def cache(self) -> FitnessCache:
        return self.evaluator.cache

    def close(self) -> None:
        """Release the evaluator (worker pool, cache file handle) — only if
        this GevoML constructed it; a caller-provided evaluator is the
        caller's to close."""
        if self._owns_evaluator:
            self.evaluator.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- candidate generation (parent process; consumes self.rng) ----------
    def _mutate(self, patch: Patch) -> Patch | None:
        """Append one fresh edit (sampled per the operator weights against
        the patched program, so uids of earlier clones are addressable)."""
        try:
            prog = patch.apply(self.w.program)
        except EditError:
            return None
        for _ in range(4):
            try:
                e = sample_edit(prog, self.rng, self.operators)
            except EditError:
                continue
            self.stats.count_proposed(e.kind)
            try:
                new = patch.append(e)
                new.apply(self.w.program)
            except EditError:
                continue
            self.stats.count_applied(e.kind)
            return new
        return None

    def _initial_candidate(self) -> Patch | None:
        patch = Patch()
        for _ in range(self.init_mutations):
            nxt = self._mutate(patch)
            if nxt is None:
                return None
            patch = nxt
        return patch

    def _offspring_candidate(self, pop: list[Individual], rank, crowd
                             ) -> Patch | None:
        a = pop[tournament(self.rng, rank, crowd)]
        b = pop[tournament(self.rng, rank, crowd)]
        if self.rng.random() < self.crossover_rate:
            child, alt = messy_crossover(a.patch, b.patch, self.rng)
            if not child and alt:
                child = alt
        else:
            child = a.patch
        if self.rng.random() < self.mutation_rate or not child:
            mutated = self._mutate(child)
            if mutated is None:
                return None
            child = mutated
        return child

    # -- batched fill: speculate candidates, evaluate as one dispatch ------
    def _fill(self, n: int, candidate_fn, what: str) -> list[Individual]:
        filled: list[Individual] = []
        counted: dict[int, EvalOutcome] = {}  # freshly screened, by identity
        for _ in range(self.max_tries):
            if len(filled) >= n:
                break
            batch: list[Patch] = []
            for _ in range(n - len(filled)):
                c = candidate_fn()
                if c is not None:
                    batch.append(c)
            if not batch:
                continue
            for patch, out in zip(batch, self.evaluator.evaluate_batch(batch)):
                if (out.verdict is not None and not out.cached
                        and id(out) not in counted):
                    # freshly screened this call: per-operator attribution.
                    # Duplicate patches in a batch share one outcome object,
                    # so identity dedupes them (the dict holds the reference,
                    # keeping ids stable for the loop's lifetime).
                    counted[id(out)] = out
                    self.stats.count_screened(patch.kinds(), out.verdict)
                if out.ok:
                    filled.append(Individual(patch, out.fitness))
                    self.stats.count_valid(patch.kinds())
                else:
                    self._n_invalid_outcomes += 1
        if len(filled) < n:
            raise RuntimeError(f"could not build {n} valid {what} "
                               f"in {self.max_tries} rounds")
        return filled

    # -- surrogate pre-rank: over-generate, keep the predicted slice --------
    def _prerank(self, batch: list[Patch], room: int
                 ) -> tuple[list[Patch], int]:
        """The slice of a candidate batch that reaches the evaluator, plus
        how many of them are novel (cache-missing) executions.  Cached
        patches always pass (re-looking them up costs nothing); novel ones
        are ranked by the trained model and cut to ``room``.  Candidates the
        featurizer cannot see pass through unranked — the surrogate only
        prioritizes what it can predict."""
        cached, novel = [], []
        for p in batch:
            (cached if self.evaluator.key(p) in self.cache
             else novel).append(p)
        if not self.guide.model.trained or len(novel) <= room:
            return cached + novel, len(novel)
        feats, rankable, passthrough = [], [], []
        for p in novel:
            try:
                feats.append(self.guide.featurizer(p))
                rankable.append(p)
            except Exception:
                passthrough.append(p)
        kept_ix = self.guide.select(feats, max(0, room - len(passthrough)))
        keep = []
        for i, p in enumerate(rankable):
            self.stats.count_ranked(p.kinds(), kept=i in kept_ix)
            if i in kept_ix:
                keep.append(p)
        return cached + passthrough + keep, len(passthrough) + len(keep)

    def _fill_guided(self, n: int, candidate_fn, what: str
                     ) -> list[Individual]:
        """The surrogate-guided fill: generate candidates at the unguided
        rate, but spend at most ``keep_of(n)`` novel executions on them.
        May return fewer than ``n`` individuals — that is the point (the
        budget, not the population slot count, is the binding constraint);
        at least one is guaranteed (falling back to an unguided fill when
        the model starved the generation entirely)."""
        guide = self.guide
        guide.refit(self.cache)
        budget = guide.keep_of(n)
        spent = 0
        filled: list[Individual] = []
        counted: dict[int, EvalOutcome] = {}  # freshly screened, by identity
        for _ in range(self.max_tries):
            if len(filled) >= n or (spent >= budget and filled):
                break
            batch: list[Patch] = []
            for _ in range(n - len(filled)):
                c = candidate_fn()
                if c is not None:
                    batch.append(c)
            if not batch:
                continue
            keep, n_novel = self._prerank(batch, budget - spent)
            spent += n_novel
            for patch, out in zip(keep, self.evaluator.evaluate_batch(keep)):
                if (out.verdict is not None and not out.cached
                        and id(out) not in counted):
                    counted[id(out)] = out
                    self.stats.count_screened(patch.kinds(), out.verdict)
                if out.ok:
                    filled.append(Individual(patch, out.fitness))
                    self.stats.count_valid(patch.kinds())
                else:
                    self._n_invalid_outcomes += 1
        if not filled:
            return self._fill(1, candidate_fn, what)
        return filled[:n]

    # -- checkpoint/resume --------------------------------------------------
    def _checkpoint_path(self, name: str) -> str:
        return os.path.join(self.checkpoint_dir, name)

    def _save_checkpoint(self, gen: int, original, pop: list[Individual],
                         history: list[dict]) -> None:
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        doc = {
            "gen": gen,
            "program_fingerprint": self.evaluator.fingerprint,
            "original_fitness": list(original),
            "population": [{"edits": patch_doc(i.patch),
                            "fitness": list(i.fitness)} for i in pop],
            "rng_state": rng_state_doc(self.rng),
            "history": history,
            "operator_stats": self.stats.to_doc(),
            "counters": {"n_invalid": self._n_invalid_outcomes,
                         "evaluator": self.evaluator.stats()},
        }
        if self.guide is not None:
            doc["counters"]["surrogate"] = self.guide.stats()
        atomic_write_json(self._checkpoint_path(f"gen_{gen:04d}.json"), doc)
        atomic_write_json(self._checkpoint_path("latest.json"), doc)

    def _load_checkpoint(self) -> dict | None:
        path = self._checkpoint_path("latest.json")
        if not os.path.exists(path):
            return None
        doc = json.load(open(path))
        if doc["program_fingerprint"] != self.evaluator.fingerprint:
            raise ValueError(
                "checkpoint was written for a different program "
                f"(fingerprint {doc['program_fingerprint'][:12]}… != "
                f"{self.evaluator.fingerprint[:12]}…)")
        return doc

    # -- migrant injection (island model) -----------------------------------
    def _inject_migrants(self, pop: list[Individual], migrants
                         ) -> list[Individual]:
        """Evaluate foreign elite patches (cache hits when islands share a
        fitness store) and replace the worst residents by NSGA-II
        (rank, crowding).  Consumes no RNG and is a deterministic function of
        (pop, migrants), so a resumed run replays it bit-exactly."""
        seen = {i.patch for i in pop}
        patches = []
        for m in migrants:
            p = Patch.coerce(m)
            if p not in seen:
                seen.add(p)
                patches.append(p)
        # preserve island identity: at most half the population is replaced
        patches = patches[:max(1, self.pop_size // 2)]
        incoming = []
        for patch, out in zip(patches, self.evaluator.evaluate_batch(patches)):
            if out.ok:
                incoming.append(Individual(patch, out.fitness))
            else:
                self._n_invalid_outcomes += 1
        if not incoming:
            return pop
        objs = np.array([i.fitness for i in pop])
        rank, crowd, _ = rank_select(objs, len(pop))
        order = sorted(range(len(pop)), key=lambda i: (rank[i], -crowd[i]))
        keep = [pop[i] for i in sorted(order[:len(pop) - len(incoming)])]
        return keep + incoming

    # -- main loop ------------------------------------------------------------
    def run(self, generations: int = 10, *, resume: bool = False,
            migrants=None, on_generation=None) -> SearchResult:
        """Run (or continue) the search.

        ``migrants`` is the island-model injection hook: an iterable of
        patches (from other islands' elites) folded into the population
        before the first generation of this call runs.  ``on_generation`` is
        called as ``on_generation(gen, history_row)`` after each generation's
        checkpoint is written — orchestrators use it for progress and tests
        use it to simulate crashes at an exact generation."""
        state = (self._load_checkpoint()
                 if resume and self.checkpoint_dir else None)
        if state is not None:
            original = tuple(state["original_fitness"])
            pop = [Individual(patch_from_doc(p["edits"]), tuple(p["fitness"]))
                   for p in state["population"]]
            history = list(state["history"])
            self.rng = rng_from_state(state["rng_state"])
            self._n_invalid_outcomes = state["counters"]["n_invalid"]
            self.stats = OperatorStats.from_doc(state.get("operator_stats"))
            # restore cumulative counters to their snapshot values so
            # post-resume history rows continue the uninterrupted series
            # (assignment, not +=: the same instance may be resuming)
            ev_stats = state["counters"]["evaluator"]
            self.evaluator.n_evals = ev_stats["n_evals"]
            self.evaluator.n_invalid = ev_stats["n_invalid"]
            self.evaluator.n_screened = ev_stats.get("n_screened", 0)
            self.evaluator.screened_by = dict(ev_stats.get("screened_by", {}))
            self.evaluator.cache.hits = ev_stats["hits"]
            self.evaluator.cache.misses = ev_stats["misses"]
            self.evaluator.cache.cross_hits = ev_stats.get("cross_hits", 0)
            if self.guide is not None:
                self.guide.restore(state["counters"].get("surrogate"))
            start_gen = state["gen"] + 1
            t0 = _time.perf_counter() - (history[-1]["wall_s"]
                                         if history else 0.0)
        else:
            t0 = _time.perf_counter()
            first = self.evaluator.evaluate_one(Patch())
            if not first.ok:
                raise InvalidVariant(
                    f"original program failed evaluation: {first.error}")
            original = first.fitness
            pop = self._fill(self.pop_size, self._initial_candidate,
                             "initial individuals")
            history = []
            start_gen = 0

        if migrants:
            pop = self._inject_migrants(pop, migrants)

        for gen in range(start_gen, generations):
            objs = np.array([i.fitness for i in pop])
            rank, crowd, elite_idx = self._rank_select(objs, self.n_elite)
            elites = [pop[i] for i in elite_idx]
            for ind in elites:
                self.stats.count_elite(ind.patch.kinds())
            fill = self._fill if self.guide is None else self._fill_guided
            offspring = fill(
                self.pop_size - len(elites),
                lambda: self._offspring_candidate(pop, rank, crowd),
                "offspring")
            pop = elites + offspring
            objs = np.array([i.fitness for i in pop])
            pf = self._pareto_front(objs)
            history.append({
                "gen": gen,
                "best_time": float(objs[:, 0].min()),
                "best_error": float(objs[:, 1].min()),
                "pareto_size": len(pf),
                "evals": self.n_evals,
                "invalid": self.n_invalid,
                "screened": self.evaluator.n_screened,
                "cache_hits": self.cache.hits,
                "cache_hit_rate": round(self.cache.hit_rate, 4),
                "operators": self.stats.snapshot(),
                "wall_s": _time.perf_counter() - t0,
            })
            if self.guide is not None:
                # only present on guided runs, so unguided history rows
                # are unchanged
                history[-1]["surrogate"] = self.guide.stats()
            if self.verbose:
                h = history[-1]
                print(f"[gen {gen:3d}] time={h['best_time']:.3e} "
                      f"err={h['best_error']:.4f} pareto={h['pareto_size']} "
                      f"evals={h['evals']} invalid={h['invalid']} "
                      f"cache_hit={h['cache_hit_rate']:.0%}")
            if self.checkpoint_dir:
                self._save_checkpoint(gen, original, pop, history)
            if on_generation is not None:
                on_generation(gen, history[-1])
        objs = np.array([i.fitness for i in pop])
        pf = [pop[i] for i in self._pareto_front(objs)]
        # de-duplicate pareto members by fitness
        seen, pareto = set(), []
        for ind in sorted(pf, key=lambda i: i.fitness):
            if ind.fitness not in seen:
                seen.add(ind.fitness)
                pareto.append(ind)
        return SearchResult(original_fitness=original, population=pop,
                            pareto=pareto, history=history)


def describe_patch(edits) -> str:
    """Deprecated: use ``Patch.describe()``.  Kept for pre-Patch callers."""
    return Patch.coerce(edits).describe()
