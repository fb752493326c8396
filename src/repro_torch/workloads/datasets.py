"""Deterministic synthetic stand-ins for MNIST and CIFAR-10.

The paper's datasets are replaced by generated datasets with identical
shapes and split sizes; the arrays are byte-identical to the reference
package's (``src/repro/workloads/datasets.py``).  Construction: per-class
smooth prototype patterns + per-sample affine jitter + pixel noise, tuned so
a 2-layer MLP lands in the paper's accuracy regime (high-80s/low-90s with
headroom) rather than saturating at 100%.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def _smooth_noise(rng: np.random.Generator, shape, passes: int = 2) -> np.ndarray:
    x = rng.standard_normal(shape).astype(np.float32)
    for _ in range(passes):  # cheap separable blur -> smooth blobs
        x = (x + np.roll(x, 1, 0) + np.roll(x, -1, 0)
             + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 5.0
    return x


def _make_classification(rng, n, h, w, c, num_classes, noise, jitter,
                         keep=None):
    """``n`` samples, or the first ``keep`` of them: sample i draws from the
    generator after every label and every sample before it, so the first
    ``keep`` come out the same either way."""
    protos = np.stack([_smooth_noise(rng, (h, w, c), passes=3)
                       for _ in range(num_classes)])
    protos /= np.abs(protos).max(axis=(1, 2, 3), keepdims=True) + 1e-6
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    labels = labels[:n if keep is None else keep]
    xs = np.empty((len(labels), h, w, c), np.float32)
    for i, y in enumerate(labels):
        p = protos[y]
        # per-sample spatial jitter: random roll
        dy, dx = rng.integers(-jitter, jitter + 1, size=2)
        p = np.roll(np.roll(p, dy, 0), dx, 1)
        scale = 1.0 + 0.2 * rng.standard_normal()
        xs[i] = scale * p + noise * rng.standard_normal((h, w, c))
    return xs.astype(np.float32), labels


@lru_cache(maxsize=4)
def synthetic_mnist(n_train: int = 60_000, n_test: int = 10_000,
                    noise: float = 0.9, seed: int = 0):
    """(train_x, train_y, test_x, test_y); x is flattened (N, 784) in [~]."""
    # train and test share the class prototypes: generate jointly, then split
    rng = np.random.default_rng(seed)
    x, y = _make_classification(rng, n_train + n_test, 28, 28, 1, 10,
                                noise, 2)
    xtr, ytr = x[:n_train], y[:n_train]
    xte, yte = x[n_train:], y[n_train:]
    return (xtr.reshape(len(xtr), -1), ytr,
            xte.reshape(len(xte), -1), yte)


@lru_cache(maxsize=4)
def synthetic_cifar10(n_train: int = 50_000, n_test: int = 10_000,
                      noise: float = 0.7, seed: int = 1):
    """(train_x, train_y, test_x, test_y); x is (N, 32, 32, 3)."""
    rng = np.random.default_rng(seed)
    x, y = _make_classification(rng, n_train + n_test, 32, 32, 3, 10,
                                noise, 3)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def cifar10_train_head(n: int, n_train: int = 50_000, n_test: int = 10_000,
                       noise: float = 0.7, seed: int = 1):
    """``(x[:n], y[:n])`` of the training split of
    ``synthetic_cifar10(n_train, n_test, noise, seed)``, byte for byte,
    without making the rest (60,000 images at the defaults: 737 MB)."""
    if not 0 <= n <= n_train:
        raise ValueError(f"n={n} outside the {n_train} training images")
    rng = np.random.default_rng(seed)
    return _make_classification(rng, n_train + n_test, 32, 32, 3, 10, noise,
                                3, keep=n)
