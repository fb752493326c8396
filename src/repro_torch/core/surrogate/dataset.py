"""Training sets out of FitnessCaches — live handles or raw JSONL files.

A cache populated by a featurizing evaluator carries ``features`` on its
records, which makes any recorded cache a ``(features, fitness)`` regression
dataset for free.  Both readers return ``(keys, X, Y)`` with ``X`` a
``(n, d)`` float matrix and ``Y`` the ``(n, 2)`` measured ``(time, error)``
objectives; only ok (measured) records train — invalid records have no
objectives to regress on.  Rows whose feature length disagrees with the
first kept row are skipped (a cache written across a feature-schema change),
counted in the returned ``skipped`` of :func:`load_dataset`'s verbose form.
"""

from __future__ import annotations

import json

import numpy as np


def _collect(rows):
    """rows: iterable of (key, features, fitness) with fitness a 2-seq."""
    keys, X, Y = [], [], []
    skipped = 0
    width = None
    for key, feats, fit in rows:
        if feats is None or fit is None:
            continue
        feats = [float(v) for v in feats]
        if width is None:
            width = len(feats)
        if len(feats) != width:
            skipped += 1
            continue
        keys.append(key)
        X.append(feats)
        Y.append([float(fit[0]), float(fit[1])])
    return (keys, np.asarray(X, float).reshape(len(keys), width or 0),
            np.asarray(Y, float).reshape(len(keys), 2), skipped)


def dataset_from_cache(cache):
    """``(keys, X, Y)`` from a live FitnessCache's feature-bearing ok
    records."""
    keys, X, Y, _ = _collect(
        (key, feats, out.fitness)
        for key, feats, out in cache.training_rows() if out.ok)
    return keys, X, Y


def dataset_from_jsonl(path: str):
    """``(keys, X, Y)`` straight from a cache JSONL on disk — no FitnessCache
    handle, no workload.  Mirrors ``FitnessCache.reload()``'s robustness:
    torn/corrupt lines are skipped, last write per key wins."""
    recs: dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (ValueError, TypeError):
                continue  # torn tail of a crashed writer
            if isinstance(rec, dict) and rec.get("key"):
                recs[rec["key"]] = rec
    keys, X, Y, _ = _collect(
        (k, r.get("features"), r.get("fitness")) for k, r in recs.items())
    return keys, X, Y


def load_dataset(source):
    """Dispatch: a path string loads JSONL, anything with ``training_rows``
    is treated as a live cache."""
    if isinstance(source, str):
        return dataset_from_jsonl(source)
    return dataset_from_cache(source)
