"""TensorNSGA2: non-dominated sort + crowding as fixed-shape array programs.

The EvoX/TensorNSGA-III observation (PAPERS.md): NSGA-II's selection is
expressible as dense array ops — an ``(n, n)`` dominance matrix, iterative
front peeling, and crowding computed in one sorted pass — which makes the
whole selection jittable and batchable.  This module implements it ONCE
against an explicit ``xp`` backend:

* ``xp=numpy`` — the **parity path**: bit-exact with ``core/nsga2.py``
  (same IEEE arithmetic, same stable tie-breaking), used by
  ``GevoML(engine="tensor")`` so the engine flag is provably
  behavior-preserving;
* ``xp=TorchXP(device)`` (:mod:`.xp`) — the **device path**: the same
  source on torch tensors (inside the tensorized engine's generation
  step).  Each op is the IEEE operation numpy does, and ``lexsort`` is
  chained stable sorts with numpy's NaN and signed-zero order, so ranks,
  crowding and the selection order match the numpy path bit for bit
  (differentially tested).  Front peeling is a host loop that reads one
  flag back per front.

Determinism contract (mirrors the canonicalized ``core/nsga2.py``):

* fronts are discovered by peeling; within a front, order is ascending
  index (``core/nsga2.py`` sorts each front);
* crowding sorts each objective by ``(front, value, index)`` — the stable
  argsort of the Python path — and accumulates contributions in objective
  order, reproducing its inf/nan propagation exactly;
* selection order is ``lexsort(index, -crowding, rank)`` — rank ascending,
  crowding descending, index-stable — identical to ``rank_select``.

**Masked padding lanes**: pass ``valid`` to exclude lanes from dominance
entirely; they come back with ``rank == n`` (worse than any real front) and
``crowd == 0``, so fixed-shape populations can carry dead lanes.
"""

from __future__ import annotations

import numpy as np

_UNSET = object()


def _prims(xp):
    """Backend primitives the shared implementation can't spell portably."""
    if xp is not np:
        return xp.lexsort, xp.cummax, xp.put, xp.while_loop

    def put(arr, idx, vals):
        out = arr.copy()
        out[idx] = vals
        return out

    def while_loop(cond, body, state):
        while cond(state):
            state = body(state)
        return state

    return np.lexsort, np.maximum.accumulate, put, while_loop


def _rank_fronts(xp, objs, valid):
    """Front index per lane via dominance-count peeling; invalid lanes are
    excluded from every comparison and end at rank ``n``."""
    _, _, _, while_loop = _prims(xp)
    n = objs.shape[0]
    le = xp.all(objs[:, None, :] <= objs[None, :, :], axis=-1)
    lt = xp.any(objs[:, None, :] < objs[None, :, :], axis=-1)
    dom = le & lt & valid[:, None] & valid[None, :]   # dom[p, q]: p dom q
    counts = xp.where(valid, dom.sum(axis=0), -1)
    rank = xp.full((n,), n, dtype=counts.dtype)

    def cond(state):
        rank, counts, _ = state
        return xp.any((counts == 0) & (rank == n))

    def body(state):
        rank, counts, r = state
        cur = (counts == 0) & (rank == n)
        rank = xp.where(cur, r, rank)
        removed = (dom & cur[:, None]).sum(axis=0)
        counts = xp.where(cur, -1, counts - removed)
        return rank, counts, r + 1

    rank, _, _ = while_loop(cond, body,
                            (rank, counts, xp.asarray(0, dtype=counts.dtype)))
    return rank


def _crowding(xp, objs, rank, valid):
    """Crowding distance for every lane at once, all fronts in one sorted
    pass per objective — value-exact with ``core/nsga2.py``'s per-front
    loop (same contribution order, same boundary/inf/nan semantics)."""
    lexsort, cummax, put, _ = _prims(xp)
    n = objs.shape[0]
    idx = xp.arange(n)
    one_true = xp.ones(1, dtype=bool)
    crowd = xp.zeros(n, dtype=objs.dtype)
    # inf objectives legitimately produce inf-inf/inf-over-inf lanes whose
    # nan results are masked below; keep numpy from warning about them
    # (no-op for torch)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        crowd = _crowding_passes(xp, objs, rank, crowd, idx, one_true, n)
    return xp.where(valid, crowd, 0.0)


def _crowding_passes(xp, objs, rank, crowd, idx, one_true, n):
    lexsort, cummax, put, _ = _prims(xp)
    for k in range(objs.shape[1]):
        val = objs[:, k]
        order = lexsort((idx, val, rank))     # (front, value, index)
        srank = rank[order]
        sval = val[order]
        brk = srank[1:] != srank[:-1]
        is_start = xp.concatenate([one_true, brk])
        is_end = xp.concatenate([brk, one_true])
        start_pos = cummax(xp.where(is_start, idx, 0))
        end_pos = (n - 1) - xp.flip(
            cummax(xp.where(xp.flip(is_end), idx, 0)))
        span = sval[end_pos] - sval[start_pos]     # front min..max, per pos
        prev_val = xp.concatenate([sval[:1], sval[:-1]])
        next_val = xp.concatenate([sval[1:], sval[-1:]])
        boundary = is_start | is_end
        # python: boundary lanes := inf, then `if span <= 0: continue`;
        # interior lanes add (next - prev) / span (nan span adds nan).
        add = ~boundary & ~(span <= 0)
        contrib = (next_val - prev_val) / xp.where(span == 0, 1.0, span)
        cur = crowd[order]
        newc = xp.where(boundary, xp.inf,
                        xp.where(add, cur + contrib, cur))
        crowd = put(crowd, order, newc)
    return crowd


def rank_crowd(objs, valid=None, *, xp=np):
    """``(rank, crowd)`` for a fixed-shape population.  With ``xp=numpy``
    and all-valid lanes this matches ``core.nsga2.rank_population``
    bit-exactly; invalid lanes return ``(n, 0.0)``."""
    objs = xp.asarray(objs, dtype=xp.float64)
    n = objs.shape[0]
    if valid is None:
        valid = xp.ones(n, dtype=bool)
    else:
        valid = xp.asarray(valid, dtype=bool)
    rank = _rank_fronts(xp, objs, valid)
    crowd = _crowding(xp, objs, rank, valid)
    return rank, crowd


def selection_order(rank, crowd, *, xp=np):
    """Environmental-selection order: rank asc, crowding desc, index asc —
    the ``core.nsga2.rank_select`` order (nan crowding sorts last within
    its rank)."""
    lexsort, _, _, _ = _prims(xp)
    return lexsort((xp.arange(rank.shape[0]), -crowd, rank))


def rank_select(objs, n_elite, valid=None, *, xp=np):
    """Drop-in twin of ``core.nsga2.rank_select`` (plus padding support):
    returns ``(rank, crowd, elite_indices)``."""
    rank, crowd = rank_crowd(objs, valid, xp=xp)
    order = selection_order(rank, crowd, xp=xp)
    if xp is np:
        return rank, crowd, [int(i) for i in order[:n_elite]]
    return rank, crowd, order[:n_elite]


def pareto_front(objs, valid=None) -> list[int]:
    """Indices of the non-dominated set, ascending — twin of
    ``core.nsga2.pareto_front`` (numpy only)."""
    rank, _ = rank_crowd(objs, valid, xp=np)
    return [int(i) for i in np.flatnonzero(rank == 0)]


class TensorNSGA2:
    """Namespace handle for the tensorized selection kernel — the functions
    above bound as staticmethods, so call sites can pass the machinery
    around as one object (``GevoML`` and the tensor engine both use it)."""

    rank_crowd = staticmethod(rank_crowd)
    selection_order = staticmethod(selection_order)
    rank_select = staticmethod(rank_select)
    pareto_front = staticmethod(pareto_front)
