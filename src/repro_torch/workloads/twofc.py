"""2fcNet — the paper's training workload (Section 5, Figure 5).

A two-layer fully-connected network trained with mini-batch SGD on (synthetic)
MNIST.  The IR program is ONE full training step: forward pass, softmax
cross-entropy gradient, manual backprop, and the SGD weight update — exactly
the HLO program of Figure 5, including the infamous ``multiply by 0.03125``
(1/batch) constant that the paper's winning mutation replaced.

GEVO-ML mutates this whole step; the fitness evaluator chains it over the
training set on the device and scores the resulting weights with the
reference forward pass, in plain PyTorch.  The weights and the step program
are the reference package's, byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.builder import Builder
from ..core.evaluator import WorkloadSpec
from ..core.fitness import TrainingWorkload
from ..core.interp import full_f32
from ..core.ir import Program
from ..device import resolve_device
from .datasets import synthetic_mnist

WEIGHT_NAMES = ("w1", "b1", "w2", "b2")


def init_twofc_weights(in_dim: int = 784, hidden: int = 128,
                       classes: int = 10, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    s1 = float(np.sqrt(2.0 / in_dim))
    s2 = float(np.sqrt(2.0 / hidden))
    return {
        "w1": (rng.standard_normal((in_dim, hidden)) * s1).astype(np.float32),
        "b1": np.zeros(hidden, np.float32),
        "w2": (rng.standard_normal((hidden, classes)) * s2).astype(np.float32),
        "b2": np.zeros(classes, np.float32),
    }


def build_twofc_step(batch: int = 32, in_dim: int = 784, hidden: int = 128,
                     classes: int = 10, lr: float = 0.01) -> Program:
    """One SGD training step as an IR program (Figure 5 layout)."""
    b = Builder("twofc_sgd_step")
    w1 = b.input("w1", (in_dim, hidden))
    b1 = b.input("b1", (hidden,))
    w2 = b.input("w2", (hidden, classes))
    b2 = b.input("b2", (classes,))
    x = b.input("x", (batch, in_dim))
    y = b.input("y_onehot", (batch, classes))

    # ---- forward pass (Figure 1 chain) ----
    h_pre = b.dense(x, w1, b1)
    h = b.relu(h_pre)
    logits = b.dense(h, w2, b2)
    probs = b.softmax(logits)

    # ---- gradient of softmax cross entropy ----
    dlogits = b.sub(probs, y)                      # Fig 5 line 6
    inv_batch = b.scalar_like(dlogits, 1.0 / batch)
    dlogits = b.mul(dlogits, inv_batch)            # Fig 5 line 10: * 0.03125

    # ---- backprop ----
    # dw2 = h^T @ dlogits ; db2 = reduce_sum(dlogits, 0)  (Fig 5 lines 11-14)
    dw2 = b.dot(h, dlogits, dims=(((0,), (0,)), ((), ())))
    db2 = b.reduce_sum(dlogits, (0,))
    dh = b.dot(dlogits, w2, dims=(((1,), (1,)), ((), ())))
    zero = b.scalar_like(h_pre, 0.0)
    mask = b.op("compare", [h_pre, zero], direction="GT")
    dh = b.op("select", [mask, dh, zero])
    dw1 = b.dot(x, dh, dims=(((0,), (0,)), ((), ())))
    db1 = b.reduce_sum(dh, (0,))

    # ---- SGD update (Fig 5 lines 15-18: broadcast lr, multiply, subtract) --
    def sgd(wv, gv):
        lrb = b.scalar_like(gv, lr)
        return b.sub(wv, b.mul(lrb, gv))

    b.output(sgd(w1, dw1), sgd(b1, db1), sgd(w2, dw2), sgd(b2, db2))
    return b.done()


def make_eval_fn(test_x: np.ndarray, test_y: np.ndarray, batch: int = 1000,
                 device=None):
    """Reference forward pass (plain PyTorch on ``device``, the GPU unless
    told otherwise) -> classification error."""
    dev = resolve_device(device)
    batch = min(batch, len(test_x))
    xs = torch.as_tensor(test_x).to(dev)
    ys = torch.as_tensor(test_y).to(dev)

    def eval_fn(weights: dict[str, np.ndarray]) -> float:
        w1, b1, w2, b2 = (torch.as_tensor(weights[k]).to(dev)
                          for k in WEIGHT_NAMES)
        n = (len(test_x) // batch) * batch
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        with full_f32():
            for i in range(0, n, batch):
                h = torch.relu(xs[i:i + batch] @ w1 + b1)
                logits = h @ w2 + b2
                correct += (logits.argmax(-1) == ys[i:i + batch]).sum()
        return 1.0 - int(correct) / max(n, 1)

    return eval_fn


def build_twofc_training_workload(*, batch: int = 32, hidden: int = 128,
                                  steps: int = 200, lr: float = 0.01,
                                  n_train: int = 4096, n_test: int = 2000,
                                  time_mode: str = "static", seed: int = 0,
                                  device=None) -> TrainingWorkload:
    """The 2fcNet training task on ``device`` (the GPU unless told
    otherwise).  Deterministic given its kwargs (required by
    WorkloadSpec)."""
    dev = resolve_device(device)
    xtr, ytr, xte, yte = synthetic_mnist(n_train, n_test)
    program = build_twofc_step(batch=batch, hidden=hidden, lr=lr)
    return TrainingWorkload(
        name="2fcNet-training",
        program=program,
        weight_names=WEIGHT_NAMES,
        init_weights=init_twofc_weights(hidden=hidden, seed=seed),
        train_x=xtr, train_y=ytr,
        eval_fn=make_eval_fn(xte, yte, device=dev),
        batch=batch, steps=steps, time_mode=time_mode, device=str(dev),
        # eval_fn is a closure and cannot pickle; parallel workers rebuild
        # the (deterministic) workload from this recipe
        spec=WorkloadSpec.make(
            "repro_torch.workloads.twofc:build_twofc_training_workload",
            batch=batch, hidden=hidden, steps=steps, lr=lr,
            n_train=n_train, n_test=n_test, time_mode=time_mode, seed=seed,
            device=str(dev)))
