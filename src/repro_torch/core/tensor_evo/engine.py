"""TensorGevoML: the whole generation loop as array programs on the device.

The Python engine (:class:`~repro_torch.core.search.GevoML`) interleaves
RNG-driven candidate generation with per-patch evaluation; its cost is
Python-loop bound.  This engine keeps the population as a ``(pop,
n_knobs)`` index tensor on the device and runs each generation as torch
ops there: fitness (the cost model's terms on gathered cost columns, the
launch gates, error-table gathers), NSGA-II selection (:mod:`.nsga2` on
:class:`~.xp.TorchXP`), tournament, uniform crossover and point mutation.
The tables it gathers from are built once; the three hand kernels run only
while the error tables are filled, once per error class.

Contract differences from the Python engine:

* offspring are not resampled until valid — invalid lanes carry
  ``(inf, inf)`` objectives and die in selection instead;
* crossover is uniform over knobs (the natural fixed-shape operator), not
  messy edit-list splicing;
* the RNG is an explicit ``torch.Generator`` on the device — runs are
  deterministic per seed and device, but not RNG-compatible with
  ``GevoML``, nor with the reference package's ``jax.random`` keys, nor
  between the CPU and the GPU (different generators);
* front peeling reads one flag back to the host per front (:mod:`.xp`);
* ``surrogate=True`` swaps in an over-generating step (``ceil(1/keep)`` x
  the offspring lanes) whose children are cut back to ``P - E`` by the
  host-side cost model (:mod:`repro_torch.core.surrogate`) before
  re-entering the device loop — the default step is untouched.

Everything *reported* — final population fitness, Pareto front, cache
records — is recomputed through the bit-exact NumPy path
(:class:`~.evaluator.TensorEvaluator`), so results re-enter the Patch/doc
world (deployment, caches) with serial-identical values.

Checkpoints are one ``.npz`` (population matrix + the generator's state)
plus a JSON sidecar per generation; ``run(resume=True)`` continues
bit-exactly (the step is a deterministic function of the restored
population and generator).
"""

from __future__ import annotations

import json
import math
import os
import time as _time

import numpy as np
import torch

from ...device import check_device, resolve_device
from ..evaluator import FitnessCache
from ..fitness import InvalidVariant
from ..search import Individual, SearchResult
from ..serialize import atomic_write_json
from . import nsga2 as tnsga
from .evaluator import TensorEvaluator
from .xp import TorchXP


def seeded_generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


class TensorGevoML:
    """Fixed-shape NSGA-II search over one tensorizable workload, stepped
    on ``device`` (the GPU unless the caller names another).

    ``step_fn()`` maps ``(idx, generator, cx_rate, mut_rate) -> (idx',
    metrics)``; the rates are arguments so the island fleet steps every
    island with one engine under its own rates and generator."""

    def __init__(self, workload, *, pop_size: int = 1024, n_elite: int = 16,
                 crossover_rate: float = 0.8, mutation_rate: float = 0.5,
                 seed: int = 0, verbose: bool = False,
                 cache: FitnessCache | None = None,
                 cache_path: str | None = None,
                 checkpoint_dir: str | None = None,
                 surrogate: bool = False, surrogate_keep: float = 0.5,
                 device=None):
        if cache is not None and cache_path is not None:
            raise ValueError("pass cache OR cache_path, not both")
        self.device = resolve_device(device)
        check_device(workload, self.device)
        if cache is None:
            cache = FitnessCache(cache_path)
        self.w = workload
        self.pop_size = pop_size
        self.n_elite = min(n_elite, pop_size)
        self.crossover_rate = crossover_rate
        self.mutation_rate = mutation_rate
        self.seed = seed
        self.verbose = verbose
        self.checkpoint_dir = checkpoint_dir
        self.xp = TorchXP(self.device)
        # the numpy-exact side: encoding, batched fitness, cache, reporting
        self.evaluator = TensorEvaluator(workload, cache=cache)
        self.encoding = self.evaluator.encoding
        self.batched = self.evaluator.batched
        self._objectives = None
        self._step = None
        self._over_step = None
        # surrogate pre-rank: the over-generating step produces
        # ceil(1/keep) x the offspring lanes; the cost model (trained each
        # generation on the current population's objectives) keeps the
        # predicted-Pareto slice, so the evaluated population stays
        # ``pop_size`` while candidate generation widens.  Off by default.
        self.guide = None
        if surrogate:
            from ..surrogate import SurrogateGuide
            self.guide = SurrogateGuide(workload, keep=surrogate_keep)
            self._overgen = math.ceil(1.0 / surrogate_keep)

    @property
    def cache(self) -> FitnessCache:
        return self.evaluator.cache

    def close(self) -> None:
        self.evaluator.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- the device step ------------------------------------------------------
    def objectives_fn(self):
        """``idx -> (objs, valid)`` on the device: the (time, error) of
        every lane, ``(inf, inf)`` where a gate fails or a value is not
        finite.  Built once: its first call fills the error tables."""
        if self._objectives is None:
            terms = self.batched.torch_terms_fn(self.device)
            error_of = self.batched.torch_error_fn(self.device)
            inf = float("inf")

            def objectives(idx):
                time, valid = terms(idx)
                err = error_of(idx)
                valid = valid & torch.isfinite(time) & torch.isfinite(err)
                return (torch.stack([torch.where(valid, time, inf),
                                     torch.where(valid, err, inf)], dim=1),
                        valid)

            self._objectives = objectives
        return self._objectives

    def _make_step(self, n_children: int, concat: bool):
        """One generation step producing ``n_children`` offspring lanes.
        ``concat=True`` is the classic step (returns the next ``(P, knobs)``
        population); ``concat=False`` returns ``(elites, children, objs,
        metrics)`` so a host-side stage can pick which children survive."""
        objectives = self.objectives_fn()
        dev, xp = self.device, self.xp
        n_choices = torch.as_tensor(self.encoding.n_choices(),
                                    dtype=torch.int64, device=dev)
        mutable = np.flatnonzero(self.encoding.n_choices() > 1)
        if len(mutable) == 0:
            raise InvalidVariant("space has no mutable knobs")
        mutable = torch.as_tensor(mutable, dtype=torch.int64, device=dev)
        P, E = self.pop_size, self.n_elite
        n_off = n_children
        lanes = torch.arange(n_off, device=dev)

        def draw(gen, *shape):
            return torch.rand(shape, generator=gen, dtype=torch.float64,
                              device=dev)

        def step(idx, gen, cx_rate, mut_rate, objs=None):
            if objs is None:
                objs, valid = objectives(idx)
            else:
                objs, valid = objs
            rank, crowd = tnsga.rank_crowd(objs, xp=xp)
            order = tnsga.selection_order(rank, crowd, xp=xp)
            elites = idx[order[:E]]
            # binary crowded tournament, two parents per offspring lane:
            # second candidate wins only if strictly crowded-better.
            cand = torch.randint(0, P, (2, 2, n_off), generator=gen,
                                 device=dev)

            def better(i, j):
                return (rank[i] < rank[j]) | ((rank[i] == rank[j])
                                              & (crowd[i] > crowd[j]))

            pa = torch.where(better(cand[0, 1], cand[0, 0]),
                             cand[0, 1], cand[0, 0])
            pb = torch.where(better(cand[1, 1], cand[1, 0]),
                             cand[1, 1], cand[1, 0])
            do_cx = draw(gen, n_off) < cx_rate
            mix = draw(gen, n_off, idx.shape[1]) < 0.5
            child = torch.where(do_cx[:, None] & mix, idx[pb], idx[pa])
            # point mutation: pick a mutable knob, draw a *different* index
            do_mut = draw(gen, n_off) < mut_rate
            kpos = mutable[torch.randint(0, len(mutable), (n_off,),
                                         generator=gen, device=dev)]
            cur = child[lanes, kpos]
            span = torch.clamp(n_choices[kpos] - 1, min=1)
            r = torch.minimum((draw(gen, n_off) * span).long(), span - 1)
            new = r + (r >= cur).long()
            child[lanes, kpos] = torch.where(do_mut, new, cur)
            metrics = {
                "best_time": objs[:, 0].min(),
                "best_error": objs[:, 1].min(),
                "pareto_size": (rank == 0).sum(),
                "n_valid": valid.sum(),
            }
            if concat:
                return torch.cat([elites, child], dim=0), metrics
            return elites, child, objs, metrics

        return step

    def step_fn(self):
        """The generation step (built once)."""
        if self._step is None:
            self._step = self._make_step(self.pop_size - self.n_elite,
                                         concat=True)
        return self._step

    def over_step_fn(self):
        """The surrogate path's over-generating step: ``ceil(1/keep)`` x the
        offspring lanes, returned unconcatenated for host-side pre-rank."""
        if self._over_step is None:
            n_off = self.pop_size - self.n_elite
            self._over_step = self._make_step(self._overgen * n_off,
                                              concat=False)
        return self._over_step

    # -- surrogate pre-rank (host side; numpy featurizer + ridge model) ------
    def _row_features(self, row) -> list[float]:
        return self.guide.featurizer.of_genome(self.encoding.genome_of(row))

    def _guided_refit(self, idx_np, objs_np) -> bool:
        """Train on the generation's own (rows, objectives) — finite lanes
        only; the tensor path needs no cache round-trip for training data."""
        mask = np.isfinite(objs_np).all(axis=1)
        if int(mask.sum()) < self.guide.min_fit:
            return False
        X = [self._row_features(r) for r in idx_np[mask]]
        self.guide.model.fit(X, objs_np[mask])
        self.guide.n_refits += 1
        return True

    def _guided_select(self, child_np):
        """The predicted-Pareto ``P - E`` slice of the over-generated
        children (pass-through before the first fit)."""
        n_off = self.pop_size - self.n_elite
        if not self.guide.model.trained:
            return child_np[:n_off]
        feats = [self._row_features(r) for r in child_np]
        kept = sorted(self.guide.select(feats, n_off))
        return child_np[kept]

    def init_pop(self, gen) -> torch.Tensor:
        """Lane 0 = baseline schedule, the rest uniform over the space."""
        nc = torch.as_tensor(self.encoding.n_choices(), dtype=torch.int64,
                             device=self.device)
        u = torch.rand((self.pop_size, self.encoding.n_knobs), generator=gen,
                       dtype=torch.float64, device=self.device)
        rows = torch.minimum((u * nc).long(), nc - 1)
        rows[0] = torch.as_tensor(self.encoding.baseline_row(),
                                  dtype=torch.int64, device=self.device)
        return rows

    # -- checkpoint/resume ----------------------------------------------------
    def _save_checkpoint(self, gen, idx, generator, original,
                         history) -> None:
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        npz = os.path.join(self.checkpoint_dir, "state_latest.npz")
        tmp = npz + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, idx=idx.cpu().numpy(),
                     rng=generator.get_state().numpy())
        os.replace(tmp, npz)
        doc = {
            "engine": "tensor", "gen": gen, "seed": self.seed,
            "device": self.device.type,
            "program_fingerprint": self.evaluator.fingerprint,
            "original_fitness": list(original), "history": history,
        }
        if self.guide is not None:
            doc["surrogate"] = self.guide.stats()
        atomic_write_json(os.path.join(self.checkpoint_dir, "latest.json"),
                          doc)

    def _load_checkpoint(self):
        path = os.path.join(self.checkpoint_dir, "latest.json")
        if not os.path.exists(path):
            return None
        doc = json.load(open(path))
        if doc["program_fingerprint"] != self.evaluator.fingerprint:
            raise ValueError(
                "checkpoint was written for a different program "
                f"(fingerprint {doc['program_fingerprint'][:12]}… != "
                f"{self.evaluator.fingerprint[:12]}…)")
        if doc.get("device") != self.device.type:
            raise ValueError(
                f"checkpoint was written on {doc.get('device')}, not "
                f"{self.device.type}: its generator state does not carry "
                "over")
        state = np.load(os.path.join(self.checkpoint_dir, "state_latest.npz"))
        return doc, state["idx"], state["rng"]

    # -- main loop ------------------------------------------------------------
    def run(self, generations: int = 10, *, resume: bool = False,
            record_cache: bool = True,
            on_generation=None) -> SearchResult:
        """Run to ``generations`` total generations (continuing a
        checkpoint with ``resume=True``).  ``on_generation(gen, row)`` fires
        after each generation's checkpoint lands."""
        state = (self._load_checkpoint()
                 if resume and self.checkpoint_dir else None)
        generator = torch.Generator(device=self.device)
        if state is not None:
            doc, idx_np, rng_np = state
            original = tuple(doc["original_fitness"])
            history = list(doc["history"])
            start_gen = doc["gen"] + 1
            idx = torch.as_tensor(idx_np, dtype=torch.int64,
                                  device=self.device)
            generator.set_state(torch.as_tensor(rng_np))
            if self.guide is not None:
                self.guide.restore(doc.get("surrogate"))
            t0 = _time.perf_counter() - (history[-1]["wall_s"]
                                         if history else 0.0)
        else:
            t0 = _time.perf_counter()
            base = self.encoding.baseline_row()[None, :]
            first = self.evaluator.evaluate_rows(base)[0]
            if not first.ok:
                raise InvalidVariant(
                    f"original program failed evaluation: {first.error}")
            original = first.fitness
            generator.manual_seed(int(self.seed))
            idx = self.init_pop(generator)
            history = []
            start_gen = 0

        step = (self.step_fn() if self.guide is None
                else self.over_step_fn())
        for gen in range(start_gen, generations):
            if self.guide is None:
                idx, metrics = step(idx, generator, self.crossover_rate,
                                    self.mutation_rate)
            else:
                elites, children, objs, metrics = step(
                    idx, generator, self.crossover_rate, self.mutation_rate)
                self._guided_refit(idx.cpu().numpy(), objs.cpu().numpy())
                child_sel = self._guided_select(children.cpu().numpy())
                idx = torch.cat([elites, torch.as_tensor(
                    child_sel, dtype=elites.dtype, device=self.device)])
            history.append({
                "gen": gen,
                "best_time": float(metrics["best_time"]),
                "best_error": float(metrics["best_error"]),
                "pareto_size": int(metrics["pareto_size"]),
                "n_valid": int(metrics["n_valid"]),
                "evals": self.pop_size * (gen + 1),
                "wall_s": _time.perf_counter() - t0,
            })
            if self.guide is not None:
                history[-1]["surrogate"] = self.guide.stats()
            if self.verbose:
                h = history[-1]
                print(f"[gen {gen:3d}] time={h['best_time']:.3e} "
                      f"err={h['best_error']:.4f} "
                      f"pareto={h['pareto_size']} "
                      f"valid={h['n_valid']}/{self.pop_size}")
            if self.checkpoint_dir:
                self._save_checkpoint(gen, idx, generator, original,
                                      history)
            if on_generation is not None:
                on_generation(gen, history[-1])
        return self._finalize(idx.cpu().numpy(), original, history,
                              record_cache=record_cache)

    def _finalize(self, idx_np, original, history, *,
                  record_cache: bool) -> SearchResult:
        """Re-score the final population through the bit-exact NumPy path
        and hand back a standard :class:`SearchResult` (canonical patches,
        serial-identical fitness), recording outcomes into the cache."""
        patches = [self.encoding.to_patch(row) for row in idx_np]
        if record_cache:
            outs = self.evaluator.evaluate_batch(patches)
        else:
            outs = self.evaluator.evaluate_rows(idx_np)
        pop = [Individual(p, o.fitness)
               for p, o in zip(patches, outs) if o.ok]
        if not pop:
            raise InvalidVariant("tensor search ended with no valid lane")
        objs = np.array([i.fitness for i in pop])
        pf = [pop[i] for i in tnsga.pareto_front(objs)]
        seen, pareto = set(), []
        for ind in sorted(pf, key=lambda i: i.fitness):
            if ind.fitness not in seen:
                seen.add(ind.fitness)
                pareto.append(ind)
        return SearchResult(original_fitness=original, population=pop,
                            pareto=pareto, history=history)
