"""Third GEVO workload: a small transformer classifier in the IR.

The paper demonstrates GEVO-ML on conv (MobileNet) and MLP (2fcNet)
families; this extends the demonstration to the attention family — the full
forward pass (embedding lookup via one-hot matmul, causal self-attention
with the Figure-1 softmax chain, a ReLU MLP, mean pooling) expressed in
HLO-lite ops, with trained weights baked as constants.

Task: classify which of C latent Markov rulesets generated a token sequence
(learnable by one attention layer; synthetic like the others).  The dataset,
the initial weights and the IR are the reference package's, byte for byte;
the pretraining runs with PyTorch autograd on the workload's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.builder import Builder
from ..core.evaluator import WorkloadSpec
from ..core.fitness import PredictionWorkload
from ..core.interp import full_f32
from ..core.ir import Program
from ..device import resolve_device


def _relu(x):
    """``jnp.maximum(x, 0.0)``, whose gradient at 0 is one half (the
    reference's pretraining passes half a gradient through a dead unit;
    ``torch.relu`` passes none)."""
    return torch.maximum(x, x.new_zeros(()))


def make_sequence_dataset(n: int, seq: int = 16, vocab: int = 16,
                          classes: int = 4, seed: int = 0):
    """Sequences generated by class-specific permutation rules + noise."""
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(vocab) for _ in range(classes)]
    y = rng.integers(0, classes, n).astype(np.int32)
    x = np.empty((n, seq), np.int32)
    x[:, 0] = rng.integers(0, vocab, n)
    for t in range(1, seq):
        nxt = np.stack([perms[c][x[i, t - 1]] for i, c in enumerate(y)])
        jump = rng.random(n) < 0.15
        x[:, t] = np.where(jump, rng.integers(0, vocab, n), nxt)
    return x, y


# --------------------------------------------------------------------------
# plain-PyTorch reference model (for pretraining)
# --------------------------------------------------------------------------

def init_tinyformer(vocab=16, d=32, heads=2, classes=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[0]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"emb": w(vocab, d), "pos": w(seq, d, scale=0.02),
            "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
            "m1": w(d, 2 * d), "b1": np.zeros(2 * d, np.float32),
            "m2": w(2 * d, d), "b2": np.zeros(d, np.float32),
            "head": w(d, classes), "heads": heads}


def forward_ref(p, toks):
    """Logits of token ids ``toks`` (B, T); ``p`` holds tensors on the
    device of ``toks`` (and the int ``heads``)."""
    B, T = toks.shape
    d = p["emb"].shape[1]
    H = p["heads"]
    hd = d // H
    x = p["emb"][toks] + p["pos"][None, :T]
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, H, hd)
    v = (x @ p["wv"]).reshape(B, T, H, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.tril(torch.ones((T, T), device=toks.device))
    s = s + (1.0 - mask) * -1e9
    a = torch.softmax(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, d)
    x = x + o @ p["wo"]
    h = _relu(x @ p["m1"] + p["b1"])
    x = x + h @ p["m2"] + p["b2"]
    return x.mean(dim=1) @ p["head"]


def pretrain(p, x, y, steps=2000, lr=0.05, batch=64, device=None):
    """Plain SGD with PyTorch autograd on ``device`` (the GPU unless told
    otherwise): the reference's ``pretrain``, step for step."""
    dev = resolve_device(device)
    keys = [k for k in p if k != "heads"]
    tp = {k: torch.as_tensor(p[k]).to(dev).clone().requires_grad_()
          for k in keys}
    xs = torch.as_tensor(x).to(dev).long()
    ys = torch.as_tensor(y).to(dev).long()
    rng = np.random.default_rng(0)
    with full_f32():
        for _ in range(steps):
            idx = torch.as_tensor(rng.integers(0, len(x), batch)).to(dev)
            logits = forward_ref({**tp, "heads": p["heads"]}, xs[idx])
            loss = F.cross_entropy(logits, ys[idx])
            grads = torch.autograd.grad(loss, [tp[k] for k in keys])
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    tp[k] -= lr * g
    out = {k: v.detach().cpu().numpy() for k, v in tp.items()}
    out["heads"] = p["heads"]
    return out


# --------------------------------------------------------------------------
# IR construction
# --------------------------------------------------------------------------

def tinyformer_to_ir(p, batch: int, seq: int, vocab: int) -> Program:
    b = Builder("tinyformer_fwd")
    d = p["emb"].shape[1]
    H = p["heads"]
    hd = d // H
    onehot = b.input("images", (batch, seq, vocab))   # one-hot tokens
    x = b.dot(onehot, b.const(p["emb"]))               # (B, T, d)
    pos = b.const(p["pos"][:seq])
    x = b.add(x, b.broadcast(pos, (batch, seq, d), (1, 2)))

    def proj(v, w):  # (B,T,d)@(d,d) -> (B,T,H,hd)
        y = b.dot(v, b.const(w))
        return b.reshape(y, (batch, seq, H, hd))

    q, k, vv = proj(x, p["wq"]), proj(x, p["wk"]), proj(x, p["wv"])
    qt = b.transpose(q, (0, 2, 1, 3))                  # (B,H,T,hd)
    kt = b.transpose(k, (0, 2, 3, 1))                  # (B,H,hd,T)
    s = b.op("dot", [qt, kt], dims=(((3,), (2,)), ((0, 1), (0, 1))))
    s = b.mul(s, b.scalar_like(s, 1.0 / np.sqrt(hd)))
    mask = np.triu(np.ones((seq, seq), np.float32), 1) * -1e9
    s = b.add(s, b.broadcast(b.const(mask), (batch, H, seq, seq), (2, 3)))
    # softmax over last dim (Figure-1 chain via builder)
    a = b.softmax(s)
    vt = b.transpose(vv, (0, 2, 1, 3))                 # (B,H,T,hd)
    o = b.op("dot", [a, vt], dims=(((3,), (2,)), ((0, 1), (0, 1))))
    o = b.transpose(o, (0, 2, 1, 3))                   # (B,T,H,hd)
    o = b.reshape(o, (batch, seq, d))
    x = b.add(x, b.dot(o, b.const(p["wo"])))
    h = b.relu(b.bias_add(b.dot(x, b.const(p["m1"])), b.const(p["b1"])))
    x = b.add(x, b.bias_add(b.dot(h, b.const(p["m2"])), b.const(p["b2"])))
    pooled = b.reduce_sum(x, (1,))
    pooled = b.mul(pooled, b.scalar_like(pooled, 1.0 / seq))
    logits = b.dot(pooled, b.const(p["head"]))
    b.output(b.softmax(logits))
    return b.done()


def build_tinyformer_prediction_workload(*, batch=64, seq=16, vocab=16,
                                         classes=4, n_eval=1024,
                                         n_pretrain=4096, steps=2000,
                                         time_mode="static", seed=0,
                                         device=None) -> PredictionWorkload:
    """The tinyformer prediction task on ``device`` (the GPU unless told
    otherwise), pretrained there."""
    dev = resolve_device(device)
    x, y = make_sequence_dataset(n_pretrain + n_eval, seq, vocab, classes,
                                 seed)
    p = init_tinyformer(vocab=vocab, classes=classes, seq=seq, seed=seed)
    p = pretrain(p, x[:n_pretrain], y[:n_pretrain], steps=steps, device=dev)
    prog = tinyformer_to_ir(p, batch, seq, vocab)
    eye = np.eye(vocab, dtype=np.float32)
    xe = eye[x[n_pretrain:n_pretrain + n_eval]]        # one-hot eval set
    return PredictionWorkload(
        name="tinyformer-prediction", program=prog, images=xe,
        labels=y[n_pretrain:n_pretrain + n_eval], batch=batch,
        time_mode=time_mode, device=str(dev),
        spec=WorkloadSpec.make(
            "repro_torch.workloads.tinyformer:"
            "build_tinyformer_prediction_workload",
            batch=batch, seq=seq, vocab=vocab, classes=classes,
            n_eval=n_eval, n_pretrain=n_pretrain, steps=steps,
            time_mode=time_mode, seed=seed, device=str(dev)))
