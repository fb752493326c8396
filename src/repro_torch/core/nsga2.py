"""NSGA-II selection machinery (Deb et al. 2002), as used by GEVO-ML.

Minimization on all objectives.  Provides fast non-dominated sorting,
crowding distance, the crowded-comparison tournament, and the environmental
selection used each generation (top-16 elites copied unchanged + tournament
for the rest, per Section 4.4).
"""

from __future__ import annotations

import numpy as np


def dominates(a, b) -> bool:
    """a dominates b iff a <= b on all objectives and < on at least one."""
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all(a <= b) and np.any(a < b))


def fast_non_dominated_sort(objs: np.ndarray) -> list[list[int]]:
    """Return fronts (lists of indices), best front first."""
    n = len(objs)
    S = [[] for _ in range(n)]
    counts = np.zeros(n, dtype=int)
    fronts: list[list[int]] = [[]]
    for p in range(n):
        for q in range(n):
            if p == q:
                continue
            if dominates(objs[p], objs[q]):
                S[p].append(q)
            elif dominates(objs[q], objs[p]):
                counts[p] += 1
        if counts[p] == 0:
            fronts[0].append(p)
    i = 0
    while fronts[i]:
        nxt = []
        for p in fronts[i]:
            for q in S[p]:
                counts[q] -= 1
                if counts[q] == 0:
                    nxt.append(q)
        i += 1
        # Canonical order: each front ascending by index, so downstream
        # tie-breaking (crowding sort, elite order) is deterministic and
        # reproducible by the tensorized engine.
        fronts.append(sorted(nxt))
    return [f for f in fronts if f]


def crowding_distance(objs: np.ndarray, front: list[int]) -> np.ndarray:
    """Crowding distance for the members of one front."""
    m = len(front)
    dist = np.zeros(m)
    if m <= 2:
        return np.full(m, np.inf)
    sub = objs[front]
    for k in range(sub.shape[1]):
        order = np.argsort(sub[:, k], kind="stable")
        dist[order[0]] = dist[order[-1]] = np.inf
        span = sub[order[-1], k] - sub[order[0], k]
        if span <= 0:
            continue
        for j in range(1, m - 1):
            dist[order[j]] += (sub[order[j + 1], k] - sub[order[j - 1], k]) / span
    return dist


def rank_population(objs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Returns (rank, crowding) arrays; lower rank better, higher crowding
    better within a rank."""
    fronts = fast_non_dominated_sort(objs)
    rank = np.zeros(len(objs), dtype=int)
    crowd = np.zeros(len(objs))
    for r, front in enumerate(fronts):
        rank[front] = r
        crowd[front] = crowding_distance(objs, front)
    return rank, crowd


def crowded_better(i: int, j: int, rank: np.ndarray, crowd: np.ndarray) -> bool:
    if rank[i] != rank[j]:
        return rank[i] < rank[j]
    return crowd[i] > crowd[j]


def tournament(rng: np.random.Generator, rank: np.ndarray,
               crowd: np.ndarray, k: int = 2) -> int:
    """k-way crowded tournament; returns the winning index."""
    n = len(rank)
    best = int(rng.integers(n))
    for _ in range(k - 1):
        cand = int(rng.integers(n))
        if crowded_better(cand, best, rank, crowd):
            best = cand
    return best


def rank_select(objs: np.ndarray, n_elite: int
                ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """One-pass environmental selection: returns (rank, crowding,
    elite_indices).  The search loop needs all three every generation —
    computing them together avoids ranking the population twice."""
    rank, crowd = rank_population(objs)
    # lexsort: primary rank asc, then crowding desc, then index asc.  Unlike
    # sorted(key=...) this is well-defined even for nan crowding (nan sorts
    # last within its rank) — the determinism contract the tensor engine
    # (core.tensor_evo.nsga2) reproduces lane-exactly.
    order = np.lexsort((np.arange(len(objs)), -crowd, rank))
    return rank, crowd, [int(i) for i in order[:n_elite]]


def select_elites(objs: np.ndarray, n_elite: int) -> list[int]:
    """Indices of the n_elite best individuals by (rank, crowding)."""
    return rank_select(objs, n_elite)[2]


def pareto_front(objs: np.ndarray) -> list[int]:
    return fast_non_dominated_sort(objs)[0]


def hypervolume_2d(front, ref: tuple[float, float]) -> float:
    """Dominated hypervolume of a 2-objective (minimization) front w.r.t.
    reference point ``ref``.  Points not dominating ``ref`` contribute
    nothing.  Used by the operator-mix A/B to compare Pareto fronts with a
    single scalar."""
    pts = sorted(tuple(p) for p in front
                 if p[0] <= ref[0] and p[1] <= ref[1])
    hv, prev_e = 0.0, ref[1]
    for t, e in pts:
        if e < prev_e:
            hv += (ref[0] - t) * (prev_e - e)
            prev_e = e
    return hv
