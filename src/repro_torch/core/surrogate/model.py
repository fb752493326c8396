"""The cost model: a plain-numpy ridge regression over patch features.

Two targets, both log-domain so the model ranks across orders of magnitude
instead of being dominated by the slowest outlier:

* ``log(time)`` — schedule times span 1e-6..1e-2 s;
* ``log1p(error)`` — numerical error spans exact-0 (ref impls) to O(1).

Features are standardized per-column at fit time (one-hots and byte counts
coexist in the same vector) with an unpenalized bias, and the normal
equations are solved directly — deterministic, dependency-free, and exact
for the few-hundred-row datasets a FitnessCache accumulates.  Everything
round-trips through JSON (``save``/``load``), so a model trained by
``python -m repro_torch.core.surrogate train`` is a committable artifact.

:func:`pareto_order` turns predictions back into the search's own currency:
NSGA-II rank + crowding over *predicted* objectives, so "keep the top k" is
exactly "keep the predicted-Pareto slice".
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..nsga2 import rank_select

_TIME_FLOOR = 1e-30


def _transform(Y: np.ndarray) -> np.ndarray:
    Y = np.asarray(Y, float)
    return np.stack([np.log(np.maximum(Y[:, 0], _TIME_FLOOR)),
                     np.log1p(np.maximum(Y[:, 1], 0.0))], axis=1)


def _back_transform(T: np.ndarray) -> np.ndarray:
    return np.stack([np.exp(T[:, 0]), np.expm1(T[:, 1])], axis=1)


def _avg_ranks(x: np.ndarray) -> np.ndarray:
    """Average-rank transform (ties share their mean rank) — the Spearman
    prerequisite, hand-rolled so CI needs no scipy."""
    x = np.asarray(x, float)
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x))
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j)
        i = j + 1
    return ranks


def spearman(a, b) -> float:
    """Spearman rank correlation; 0.0 when either side is constant (the
    correlation is undefined there, and "no ranking signal" is the honest
    report for a surrogate)."""
    ra, rb = _avg_ranks(a), _avg_ranks(b)
    if ra.std() == 0 or rb.std() == 0:
        return 0.0
    return float(np.corrcoef(ra, rb)[0, 1])


def pareto_order(objs) -> list[int]:
    """Indices sorted by NSGA-II preference (rank, then crowding, then
    index for determinism) over a ``(n, 2)`` minimize-both objective array —
    ``order[:k]`` is the predicted-Pareto slice of size k."""
    objs = np.asarray(objs, float)
    rank, crowd, _ = rank_select(objs, len(objs))
    return sorted(range(len(objs)),
                  key=lambda i: (rank[i], -crowd[i], i))


class SurrogateModel:
    """Ridge regression ``features -> (time, error)`` (see module doc)."""

    def __init__(self, feature_names=None, l2: float = 1e-3):
        self.feature_names = (tuple(feature_names)
                              if feature_names is not None else None)
        self.l2 = float(l2)
        self._w: np.ndarray | None = None       # (d+1, 2) on standardized X
        self._mu: np.ndarray | None = None
        self._sigma: np.ndarray | None = None
        self.n_fit = 0

    @property
    def trained(self) -> bool:
        return self._w is not None

    def fit(self, X, Y) -> "SurrogateModel":
        X = np.atleast_2d(np.asarray(X, float))
        T = _transform(Y)
        if len(X) != len(T) or len(X) == 0:
            raise ValueError(f"bad dataset: {len(X)} rows, {len(T)} targets")
        self._mu = X.mean(axis=0)
        sigma = X.std(axis=0)
        sigma[sigma == 0] = 1.0   # constant columns pass through as zeros
        self._sigma = sigma
        Z = np.concatenate([np.ones((len(X), 1)),
                            (X - self._mu) / sigma], axis=1)
        A = Z.T @ Z + self.l2 * np.eye(Z.shape[1])
        A[0, 0] -= self.l2        # the bias is not shrunk
        self._w = np.linalg.solve(A, Z.T @ T)
        self.n_fit = len(X)
        return self

    def _predict_transformed(self, X) -> np.ndarray:
        if not self.trained:
            raise RuntimeError("predict() before fit()")
        X = np.atleast_2d(np.asarray(X, float))
        Z = np.concatenate([np.ones((len(X), 1)),
                            (X - self._mu) / self._sigma], axis=1)
        return Z @ self._w

    def predict(self, X) -> np.ndarray:
        """Predicted ``(time, error)`` rows, back in natural units."""
        return _back_transform(self._predict_transformed(X))

    def metrics(self, X, Y) -> dict:
        """R^2 (on the transformed scale the model fits) and Spearman rank
        correlation per objective — the rank numbers are what matter for a
        pre-rank stage."""
        T = _transform(Y)
        P = self._predict_transformed(X)
        out = {"n": len(T)}
        for j, name in enumerate(("time", "error")):
            ss_res = float(np.sum((T[:, j] - P[:, j]) ** 2))
            ss_tot = float(np.sum((T[:, j] - T[:, j].mean()) ** 2))
            out[f"r2_{name}"] = (1.0 - ss_res / ss_tot if ss_tot > 0
                                 else (1.0 if ss_res == 0 else 0.0))
            out[f"spearman_{name}"] = spearman(P[:, j], T[:, j])
        return out

    # -- JSON round-trip ----------------------------------------------------
    def to_doc(self) -> dict:
        if not self.trained:
            raise RuntimeError("to_doc() before fit()")
        return {"kind": "surrogate-ridge", "l2": self.l2,
                "n_fit": self.n_fit,
                "feature_names": (list(self.feature_names)
                                  if self.feature_names else None),
                "mu": self._mu.tolist(), "sigma": self._sigma.tolist(),
                "w": self._w.tolist()}

    @classmethod
    def from_doc(cls, doc: dict) -> "SurrogateModel":
        if doc.get("kind") != "surrogate-ridge":
            raise ValueError(f"not a surrogate model doc: {doc.get('kind')}")
        m = cls(feature_names=doc.get("feature_names"), l2=doc["l2"])
        m._mu = np.asarray(doc["mu"], float)
        m._sigma = np.asarray(doc["sigma"], float)
        m._w = np.asarray(doc["w"], float)
        m.n_fit = int(doc.get("n_fit", 0))
        return m

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "SurrogateModel":
        with open(path) as f:
            return cls.from_doc(json.load(f))
