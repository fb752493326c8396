"""The GEVO-ML evaluation engine: cached, batched, optionally parallel.

Search cost is dominated by fitness evaluation — every variant in every
generation must be executed.  This module factors evaluation out of the
search loop into three composable pieces:

* :class:`FitnessCache` — a content-addressed fitness store.  Keys are
  ``serialize.patch_key(workload_fingerprint, edits)``: the fingerprint
  covers the program *and* the evaluation protocol around it (builder,
  kwargs, time_mode, device), and a patch applied to a program fully
  determines the variant (edits carry their own repair seeds) — so a
  fitness measured once is valid forever.  With a ``path`` the cache is
  **persistent**: an append-only JSONL file, in the same record format as
  the reference package's, that warm-starts repeated and resumed runs.

* :class:`SerialEvaluator` — in-process evaluation; the paper's behavior.

* :class:`ParallelEvaluator` — a multiprocess worker pool.  Each worker owns
  its **own CUDA context** (workers are spawned, not forked, as CUDA
  requires) and receives a contiguous *batch* of variants per dispatch.
  Workloads travel to workers by pickle when possible, else are rebuilt from
  a :class:`WorkloadSpec` factory (the kernel runners are closures and do
  not pickle).  In ``static`` time mode fitness is deterministic, so
  parallel results are bit-identical to serial; ``inline_static=True``
  additionally short-circuits static-mode evaluation in the parent process.

Evaluators consume whole batches (``evaluate_batch``) so the search loop can
speculatively generate a generation's worth of candidates and amortize
dispatch; duplicate patches within a batch are evaluated once.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import multiprocessing as mp
import os
import pickle
import traceback
from dataclasses import dataclass, replace

from .edits import EditError, Patch
from .fitness import DEVICE_FAULTS, DeviceFault, InvalidVariant
from .serialize import patch_key, program_fingerprint

# --------------------------------------------------------------------------
# Outcomes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class EvalOutcome:
    """Result of evaluating one patch: a fitness tuple or an invalidity
    reason.  ``cached`` marks outcomes served from the cache; ``verdict``
    names the static-screen label (``invalid``/``noop``/``equivalent``) when
    the outcome was resolved without execution (None for executed ones).
    ``transient`` marks failures that say nothing about the variant itself
    (a worker crash, an OOM, a backend error): they are remembered for the
    current run only and never written to a persistent cache, so the next
    run re-evaluates instead of trusting a poisoned verdict."""

    fitness: tuple[float, float] | None
    error: str | None = None
    cached: bool = False
    verdict: str | None = None
    transient: bool = False

    @property
    def ok(self) -> bool:
        return self.fitness is not None

    def to_doc(self) -> dict:
        doc = {"fitness": list(self.fitness) if self.fitness else None,
               "error": self.error}
        if self.verdict is not None:
            doc["verdict"] = self.verdict
        return doc

    @staticmethod
    def from_doc(d: dict) -> "EvalOutcome":
        fit = tuple(d["fitness"]) if d.get("fitness") else None
        return EvalOutcome(fitness=fit, error=d.get("error"),
                           verdict=d.get("verdict"))


# --------------------------------------------------------------------------
# Persistent content-addressed fitness cache
# --------------------------------------------------------------------------


class FitnessCache:
    """Fitness store keyed by canonical patch hash.

    In-memory always; append-only JSONL on disk when ``path`` is given.
    Invalid outcomes are cached too — a variant known to fail is never
    re-executed.  The JSONL format is crash-safe (a torn final line is
    dropped on load) and mergeable (concatenate files from several runs).

    **Concurrent writers are safe**: records are appended with a single
    ``os.write`` on an ``O_APPEND`` descriptor under an advisory ``flock``,
    so two processes flushing simultaneously can never interleave partial
    lines (island searches share one cache file this way).  ``reload()``
    picks up records other writers appended since the last read, and
    ``writer`` tags each record with its author so cross-writer hits —
    fitness one island measured and another consumed — are countable
    (``cross_hits``).

    Caveat: the fitness layer folds *any* execution failure into
    invalidity, so a transient crash (OOM, backend error) would be
    remembered forever; outcomes flagged ``transient`` (worker-crash
    containment in :class:`ParallelEvaluator`) are therefore kept
    in-memory only and never appended to disk, and
    ``persist_invalid=False`` extends the same treatment to *all* invalid
    outcomes when sharing a cache across heterogeneous machines (costs
    re-evaluating invalid variants on each fresh run).

    Records may carry a ``features`` vector (the surrogate layer's
    training signal — see :mod:`repro_torch.core.surrogate`): feature-bearing
    outcomes turn the cache into a ready-made regression dataset of
    ``(features, fitness)`` pairs, loadable from any cache JSONL."""

    def __init__(self, path: str | None = None, *,
                 persist_invalid: bool = True, writer: str | None = None):
        self.path = path
        self.persist_invalid = persist_invalid
        self.writer = writer
        self._mem: dict[str, EvalOutcome] = {}
        self._writers: dict[str, str] = {}   # key -> author tag (if tagged)
        self._features: dict[str, list[float]] = {}  # key -> feature vector
        self._meta: dict[str, dict] = {}   # key -> free-form metadata doc
        self.hits = 0
        self.misses = 0
        self.cross_hits = 0   # distinct entries another writer authored
        self._cross_seen: set[str] = set()   # keys already counted above
        self._fd = None
        self._read_offset = 0
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                               0o644)
            self.reload()

    def reload(self) -> int:
        """Read records appended since the last load (other writers' flushes
        included).  Returns the number of new keys absorbed."""
        if self.path is None or not os.path.exists(self.path):
            return 0
        added = 0
        with open(self.path, "rb") as f:
            f.seek(self._read_offset)
            for raw in f:
                if not raw.endswith(b"\n"):
                    break  # torn tail from a crashed writer: drop, re-read later
                self._read_offset += len(raw)
                line = raw.decode(errors="replace").strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # corrupt line (pre-hardening writer): skip past
                key = rec["key"]
                if key not in self._mem:
                    self._mem[key] = EvalOutcome.from_doc(rec)
                    if rec.get("writer") is not None:
                        self._writers[key] = rec["writer"]
                    if rec.get("features") is not None:
                        self._features[key] = [float(x)
                                               for x in rec["features"]]
                    if isinstance(rec.get("meta"), dict):
                        self._meta[key] = rec["meta"]
                    added += 1
        return added

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    def get(self, key: str) -> EvalOutcome | None:
        out = self._mem.get(key)
        if out is None:
            return None
        author = self._writers.get(key)
        if author is not None and key not in self._cross_seen:
            # "analysis:<writer>" records are authored by <writer>'s screen;
            # a bare "analysis" tag (anonymous cache) names nobody.  Each
            # entry counts at most once: repeated gets of the same key
            # (in-batch duplicates, re-queries across generations) are not
            # additional sharing.
            base = author[len("analysis:"):] \
                if author.startswith("analysis:") else author
            if base != "analysis" and base != self.writer:
                self.cross_hits += 1
                self._cross_seen.add(key)
        return replace(out, cached=True)

    def put(self, key: str, outcome: EvalOutcome, *,
            writer: str | None = None,
            features: list[float] | None = None,
            meta: dict | None = None) -> None:
        """Record an outcome.  ``writer`` overrides this cache's author tag
        for the one record (the evaluator tags statically screened verdicts
        ``analysis:<writer>`` so cache files show what was never executed).
        ``features`` attaches the patch's surrogate feature vector to the
        record; ``meta`` attaches a free-form JSON doc (e.g. the trace spec
        a serve measurement was taken under — see
        the reference's live loop).  ``transient`` outcomes stay
        in-memory only — this run will not retry them, but no future run
        inherits the failure."""
        if key in self._mem:
            return
        author = writer if writer is not None else self.writer
        outcome = replace(outcome, cached=False)
        self._mem[key] = outcome
        if author is not None:
            self._writers[key] = author
        if features is not None:
            self._features[key] = [float(x) for x in features]
        if meta is not None:
            self._meta[key] = dict(meta)
        if self._fd is not None and not outcome.transient \
                and (outcome.ok or self.persist_invalid):
            rec = {"key": key}
            rec.update(outcome.to_doc())
            if author is not None:
                rec["writer"] = author
            if features is not None:
                rec["features"] = [float(x) for x in features]
            if meta is not None:
                rec["meta"] = dict(meta)
            self._append_line(json.dumps(rec) + "\n")

    def features_of(self, key: str) -> list[float] | None:
        return self._features.get(key)

    def meta_of(self, key: str) -> dict | None:
        return self._meta.get(key)

    def training_rows(self) -> list[tuple[str, list[float], EvalOutcome]]:
        """Every feature-bearing record as a ``(key, features, outcome)``
        triple — the surrogate layer's training set (invalid outcomes
        included; the trainer decides what to regress on)."""
        return [(k, list(f), self._mem[k])
                for k, f in self._features.items() if k in self._mem]

    def _append_line(self, line: str) -> None:
        """Crash- and concurrency-safe append: one whole line per syscall on
        an O_APPEND descriptor, under an advisory lock, so concurrent
        writers' records never interleave mid-line."""
        data = line.encode()
        _flock(self._fd)
        try:
            os.write(self._fd, data)
        finally:
            _funlock(self._fd)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"entries": len(self._mem), "hits": self.hits,
                "misses": self.misses, "hit_rate": self.hit_rate,
                "cross_hits": self.cross_hits,
                "persistent": self.path is not None}

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


try:
    import fcntl as _fcntl

    def _flock(fd: int) -> None:
        _fcntl.flock(fd, _fcntl.LOCK_EX)

    def _funlock(fd: int) -> None:
        _fcntl.flock(fd, _fcntl.LOCK_UN)
except ImportError:  # non-POSIX: O_APPEND single-write is the only guard

    def _flock(fd: int) -> None:
        pass

    def _funlock(fd: int) -> None:
        pass


# --------------------------------------------------------------------------
# Workload transport for worker processes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkloadSpec:
    """Recipe for rebuilding a workload inside a worker process:
    ``factory`` is a ``"module.path:callable"`` reference and ``kwargs`` its
    keyword arguments.  The factory must be **deterministic** (same kwargs →
    same program, data, and eval function) or parallel evaluation would
    diverge from serial; the builders in ``repro_torch.kernels.workloads``
    are."""

    factory: str
    kwargs: tuple[tuple[str, object], ...]

    @staticmethod
    def make(factory: str, **kwargs) -> "WorkloadSpec":
        return WorkloadSpec(factory=factory, kwargs=tuple(sorted(kwargs.items())))

    def build(self):
        mod_name, _, attr = self.factory.partition(":")
        fn = getattr(importlib.import_module(mod_name), attr)
        return fn(**dict(self.kwargs))


def workload_fingerprint(workload) -> str:
    """Content hash of everything that determines a fitness value: the
    program AND the evaluation protocol around it (steps, data sizes,
    time_mode, ... — fitness is e.g. ``static_time(program) * steps``).
    The protocol part comes from the builder's WorkloadSpec kwargs when
    present, else from the workload's scalar dataclass-ish fields."""
    spec = getattr(workload, "spec", None)
    if spec is not None:
        proto = {"factory": spec.factory,
                 "kwargs": [[k, repr(v)] for k, v in spec.kwargs]}
    else:
        proto = {k: repr(v) for k, v in sorted(vars(workload).items())
                 if isinstance(v, (int, float, str, bool, type(None)))}
    h = hashlib.sha256()
    h.update(program_fingerprint(workload.program).encode())
    h.update(json.dumps(proto, sort_keys=True).encode())
    return h.hexdigest()


_WORKER_WORKLOAD = None


def _worker_init(payload: dict) -> None:
    """Pool initializer: materialize the workload once per worker.  Runs in a
    freshly spawned interpreter, so this worker owns its CUDA context."""
    global _WORKER_WORKLOAD
    for mod in payload.get("edit_modules", ()):
        importlib.import_module(mod)  # re-register custom edit operators
    if payload.get("pickled") is not None:
        _WORKER_WORKLOAD = pickle.loads(payload["pickled"])
    else:
        _WORKER_WORKLOAD = payload["spec"].build()


def _worker_eval(patch: Patch):
    try:
        program = patch.apply(_WORKER_WORKLOAD.program)
        return ("ok", _WORKER_WORKLOAD.evaluate(program))
    except (EditError, InvalidVariant) as e:
        return ("invalid", str(e))
    except DEVICE_FAULTS:
        # a kernel that did not build or a launch the device refused: the
        # parent raises it, as the serial path does
        return ("fault", traceback.format_exc())
    except Exception:
        # Anything else (OOM, pickling trouble) says nothing about the
        # variant — containing it here keeps one bad dispatch from
        # propagating through pool.map and killing the whole search.  The
        # parent marks these outcomes transient, so they are never
        # persisted and a future run re-evaluates.
        return ("error", traceback.format_exc())


# --------------------------------------------------------------------------
# Evaluators
# --------------------------------------------------------------------------


class Evaluator:
    """Batch fitness evaluation against one workload, through the cache.

    ``evaluate_batch`` preserves input order, dedupes identical patches
    within the batch, serves cache hits without dispatch, and records every
    fresh outcome (valid or invalid) back into the cache.

    Attaching a patch ``screen`` (see
    :func:`repro_torch.core.analysis.make_screen`) adds a static
    pre-execution triage on cache misses: patches the screen resolves —
    ``invalid`` / ``noop`` / ``equivalent`` — skip execution, carry their
    verdict on the outcome, and are cached under an ``analysis:`` writer
    tag; only ``novel`` patches dispatch.  Screening is fitness-transparent:
    resolved outcomes are exactly what execution would have produced (the
    screens only resolve when that is statically certain)."""

    def __init__(self, workload, cache: FitnessCache | None = None):
        self.workload = workload
        self.cache = cache if cache is not None else FitnessCache()
        self.screen = None  # optional static patch screen (core.analysis)
        self.featurizer = None  # optional patch featurizer (core.surrogate)
        self.fingerprint = workload_fingerprint(workload)
        self.n_evals = 0    # actual executions (cache misses evaluated)
        self.n_invalid = 0  # executions that came back invalid
        self.n_screened = 0  # misses resolved statically, no execution
        self.screened_by: dict[str, int] = {}  # verdict -> count

    def key(self, patch) -> str:
        return patch_key(self.fingerprint, patch)

    def _screen_writer(self) -> str:
        w = self.cache.writer
        return f"analysis:{w}" if w is not None else "analysis"

    def evaluate_batch(self, patches) -> list[EvalOutcome]:
        patches = [Patch.coerce(p) for p in patches]
        outcomes: list[EvalOutcome | None] = [None] * len(patches)
        fresh: dict[str, list[int]] = {}   # key -> positions, insertion order
        for i, p in enumerate(patches):
            k = self.key(p)
            hit = self.cache.get(k)
            if hit is not None:
                self.cache.hits += 1
                outcomes[i] = hit
            else:
                if k not in fresh:
                    self.cache.misses += 1
                fresh.setdefault(k, []).append(i)
        if fresh:
            screened, executed = self._triage(
                {k: patches[ixs[0]] for k, ixs in fresh.items()})
            for k, ixs in fresh.items():
                feats = self._features_of(patches[ixs[0]])
                if k in screened:
                    out = screened[k]
                    self.n_screened += 1
                    self.screened_by[out.verdict] = \
                        self.screened_by.get(out.verdict, 0) + 1
                    self.cache.put(k, out, writer=self._screen_writer(),
                                   features=feats)
                else:
                    out = executed[k]
                    self.cache.put(k, out, features=feats)
                    self.n_evals += 1
                    if not out.ok:
                        self.n_invalid += 1
                for i in ixs:
                    outcomes[i] = out
        return outcomes  # type: ignore[return-value]

    def evaluate_one(self, patch) -> EvalOutcome:
        return self.evaluate_batch([patch])[0]

    def _features_of(self, patch) -> list[float] | None:
        """The patch's surrogate feature vector, or None (no featurizer
        attached, or the patch does not featurize — e.g. fails to apply)."""
        if self.featurizer is None:
            return None
        try:
            return self.featurizer(patch)
        except Exception:
            return None

    def _triage(self, fresh: dict[str, Patch]
                ) -> tuple[dict[str, EvalOutcome], dict[str, EvalOutcome]]:
        """Split cache-missing patches into statically resolved outcomes and
        executed ones.  Without a screen every patch executes."""
        if self.screen is None:
            results = self._evaluate_misses(list(fresh.values()))
            return {}, dict(zip(fresh.keys(), results))
        screened: dict[str, EvalOutcome] = {}
        deferred: list[tuple[str, object]] = []  # inherit from this batch
        pending: set[str] = set()  # canonical classes executing in-batch
        todo_keys: list[str] = []
        todo_res: list[object] = []
        for k, patch in fresh.items():
            res = self.screen.classify(patch)
            if res.resolved:
                screened[k] = replace(res.outcome, verdict=res.label)
            elif res.canon is not None and res.canon in pending:
                deferred.append((k, res))
            else:
                if res.canon is not None:
                    pending.add(res.canon)
                todo_keys.append(k)
                todo_res.append(res)
        executed = dict(zip(
            todo_keys,
            self._evaluate_misses([fresh[k] for k in todo_keys])
            if todo_keys else []))   # fully screened batch: no dispatch
        for k, res in zip(todo_keys, todo_res):
            self.screen.observe(res, executed[k])
        for k, res in deferred:
            rep = self.screen.seen[res.canon]
            screened[k] = replace(self.screen.inherit(res, rep),
                                  verdict=self.screen.label_for(res.canon))
        return screened, executed

    def _evaluate_misses(self, patches) -> list[EvalOutcome]:
        raise NotImplementedError

    def _evaluate_inline(self, patches) -> list[EvalOutcome]:
        out = []
        for patch in patches:
            try:
                program = patch.apply(self.workload.program)
                out.append(EvalOutcome(fitness=self.workload.evaluate(program)))
            except (EditError, InvalidVariant) as e:
                out.append(EvalOutcome(fitness=None, error=str(e)))
        return out

    def stats(self) -> dict:
        # ``misses`` (cache-level) counts every unique key that missed the
        # cache, whether it then executed or was resolved statically; the
        # split below is what execution-cost reporting should quote —
        # ``executed_misses`` dispatched, ``screened`` never ran.
        s = self.cache.stats()
        s.update({"n_evals": self.n_evals, "n_invalid": self.n_invalid,
                  "n_screened": self.n_screened,
                  "screened_by": dict(self.screened_by),
                  "executed_misses": self.n_evals,
                  "screened": self.n_screened})
        return s

    def close(self) -> None:
        self.cache.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SerialEvaluator(Evaluator):
    """In-process evaluation — the paper's (and the previous search loop's)
    behavior, now with batch dedupe and the persistent cache."""

    _evaluate_misses = Evaluator._evaluate_inline


class ParallelEvaluator(Evaluator):
    """Multiprocess evaluation: ``n_workers`` spawned workers, each with its
    own CUDA context, each receiving a contiguous batch per dispatch.

    The pool is created lazily on the first cache-missing batch, so a fully
    warm cache never pays worker startup.  With ``inline_static=True`` and a
    ``static``-time-mode workload, evaluation short-circuits to the parent
    process (static fitness is deterministic roofline arithmetic + one
    deterministic execution — worker processes buy nothing there)."""

    def __init__(self, workload, *, n_workers: int = 2,
                 cache: FitnessCache | None = None,
                 spec: WorkloadSpec | None = None,
                 inline_static: bool = False,
                 chunk_size: int | None = None,
                 start_method: str = "spawn"):
        super().__init__(workload, cache)
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = n_workers
        self.spec = spec if spec is not None else getattr(workload, "spec", None)
        self.inline_static = inline_static
        self.chunk_size = chunk_size
        self.start_method = start_method
        self._pool = None

    # -- pool management ----------------------------------------------------
    def _payload(self) -> dict:
        from .edits import operator_modules

        mods = operator_modules()
        if "__main__" in mods:
            raise ValueError(
                "a custom edit operator is registered in __main__, which "
                "spawned workers cannot re-import; move the "
                "@register_edit class into an importable module to use it "
                "with ParallelEvaluator")
        payload = {"edit_modules": mods}
        try:
            payload["pickled"] = pickle.dumps(self.workload)
        except Exception:
            if self.spec is None:
                raise ValueError(
                    f"workload {getattr(self.workload, 'name', '?')!r} is not "
                    "picklable and has no WorkloadSpec; pass spec= or use a "
                    "workload builder that attaches one")
            payload["pickled"] = None
            payload["spec"] = self.spec
        return payload

    def _ensure_pool(self):
        if self._pool is None:
            ctx = mp.get_context(self.start_method)
            self._pool = ctx.Pool(self.n_workers, initializer=_worker_init,
                                  initargs=(self._payload(),))
        return self._pool

    # -- dispatch -----------------------------------------------------------
    def _evaluate_misses(self, patches) -> list[EvalOutcome]:
        if (self.inline_static
                and getattr(self.workload, "time_mode", None) == "static"):
            return self._evaluate_inline(patches)
        pool = self._ensure_pool()
        chunk = self.chunk_size or max(
            1, (len(patches) + self.n_workers - 1) // self.n_workers)
        raw = pool.map(_worker_eval, patches, chunksize=chunk)
        out = []
        for tag, payload in raw:
            if tag == "ok":
                out.append(EvalOutcome(fitness=payload))
            elif tag == "invalid":
                out.append(EvalOutcome(fitness=None, error=payload))
            elif tag == "fault":
                raise DeviceFault(f"in an evaluation worker:\n{payload}")
            else:  # contained worker crash: invalid for this run only
                out.append(EvalOutcome(fitness=None, error=payload,
                                       transient=True))
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None
        super().close()


def make_evaluator(workload, *, parallel: int = 0,
                   cache_path: str | None = None,
                   inline_static: bool = False,
                   screen: bool = False,
                   features: bool = False) -> Evaluator:
    """Convenience constructor used by the CLI surfaces: ``parallel`` <= 1
    gives a SerialEvaluator.  ``screen=True`` attaches the static patch
    screen (``core.analysis``) so invalid / noop / equivalent mutants
    resolve without execution.  ``features=True`` attaches the surrogate
    featurizer (``core.surrogate``) so every fresh outcome lands in the
    cache with its feature vector — the cache then doubles as surrogate
    training data."""
    cache = FitnessCache(cache_path)
    if parallel and parallel > 1:
        ev: Evaluator = ParallelEvaluator(
            workload, n_workers=parallel, cache=cache,
            inline_static=inline_static)
    else:
        ev = SerialEvaluator(workload, cache=cache)
    if screen:
        from .analysis import make_screen   # local: analysis imports us
        ev.screen = make_screen(workload)
    if features:
        from .surrogate import make_featurizer   # local: surrogate imports us
        ev.featurizer = make_featurizer(workload)
    return ev
