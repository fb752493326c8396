"""MobileNet — the paper's prediction workload (Section 5, Table 1).

MobileNetV1 adapted to 32x32 CIFAR inputs (strides reduced, width multiplier
``alpha``; ``alpha=1.0`` is MobileNetV1's published widths, 32 to 1024
channels), matching the paper's layer census: depthwise + standard (point-
wise) convolutions, batch-norm after every conv, one average pool, and two
fully-connected layers.

The network is (pre)trained here with PyTorch autograd on the workload's
device (the paper used pretrained TF weights), then **baked into an IR
program with weights as constants** — the representation GEVO-ML mutates.
BN is emitted in unfused inference form so mutations can splice individual
gamma/beta tensors (the paper's key MobileNet mutation swapped one BN
layer's gamma).  ``init_mobilenet`` and ``mobilenet_to_ir`` are the
reference package's, so one parameter dict gives one program, byte for
byte, in either package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.builder import Builder
from ..core.evaluator import WorkloadSpec
from ..core.fitness import PredictionWorkload
from ..core.interp import conv, full_f32
from ..core.ir import Program
from ..device import resolve_device
from .datasets import cifar10_train_head

def _relu(x):
    """``jnp.maximum(x, 0.0)``, whose gradient at 0 is one half (the
    reference's pretraining passes half a gradient through a dead unit;
    ``torch.relu`` passes none)."""
    return torch.maximum(x, x.new_zeros(()))


# (stride, out_channels) for each depthwise-separable block; strides reduced
# for 32x32 inputs (ImageNet MobileNet assumes 224x224).
_BLOCKS = [(1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
           (2, 512), (1, 512), (1, 512), (2, 1024), (1, 1024)]


def _ch(c: int, alpha: float) -> int:
    return max(8, int(c * alpha))


def init_mobilenet(alpha: float = 0.25, classes: int = 10, hidden: int = 128,
                   seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def conv_w(kh, kw, ci, co):
        s = np.sqrt(2.0 / (kh * kw * ci))
        return (rng.standard_normal((kh, kw, ci, co)) * s).astype(np.float32)

    def bn(c):
        return {"gamma": np.ones(c, np.float32), "beta": np.zeros(c, np.float32),
                "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}

    c0 = _ch(32, alpha)
    params = {"stem_w": conv_w(3, 3, 3, c0), "stem_bn": bn(c0)}
    ci = c0
    for i, (s, co) in enumerate(_BLOCKS):
        co = _ch(co, alpha)
        params[f"dw{i}_w"] = conv_w(3, 3, 1, ci)
        params[f"dw{i}_bn"] = bn(ci)
        params[f"pw{i}_w"] = conv_w(1, 1, ci, co)
        params[f"pw{i}_bn"] = bn(co)
        ci = co
    sf = np.sqrt(2.0 / ci)
    params["fc1_w"] = (rng.standard_normal((ci, hidden)) * sf).astype(np.float32)
    params["fc1_b"] = np.zeros(hidden, np.float32)
    params["fc2_w"] = (rng.standard_normal((hidden, classes))
                       * np.sqrt(2.0 / hidden)).astype(np.float32)
    params["fc2_b"] = np.zeros(classes, np.float32)
    return params


def _bn_apply(x, bn, train: bool, momentum=0.9):
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
        new = {"gamma": bn["gamma"], "beta": bn["beta"],
               "mean": momentum * bn["mean"] + (1 - momentum) * mean.detach(),
               "var": momentum * bn["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var, new = bn["mean"], bn["var"], bn
    y = (x - mean) * torch.rsqrt(var + 1e-3) * bn["gamma"] + bn["beta"]
    return y, new


def forward(params: dict, x, train: bool = False):
    """Returns (logits, updated_params_with_bn_stats); ``params`` and ``x``
    are tensors on one device, NHWC."""
    p = dict(params)
    h = conv(x, p["stem_w"], (1, 1))
    h, p["stem_bn"] = _bn_apply(h, p["stem_bn"], train)
    h = _relu(h)
    for i, (s, _) in enumerate(_BLOCKS):
        c = h.shape[-1]
        h = conv(h, p[f"dw{i}_w"], (s, s), groups=c)
        h, p[f"dw{i}_bn"] = _bn_apply(h, p[f"dw{i}_bn"], train)
        h = _relu(h)
        h = conv(h, p[f"pw{i}_w"], (1, 1))
        h, p[f"pw{i}_bn"] = _bn_apply(h, p[f"pw{i}_bn"], train)
        h = _relu(h)
    h = h.mean(dim=(1, 2))
    h = _relu(h @ p["fc1_w"] + p["fc1_b"])
    return h @ p["fc2_w"] + p["fc2_b"], p


def params_to(params: dict, device) -> dict:
    """A (nested) numpy parameter dict as tensors on ``device``."""
    return {k: params_to(v, device) if isinstance(v, dict)
            else torch.as_tensor(v).to(device) for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}


def pretrain(params: dict, x: np.ndarray, y: np.ndarray, *, epochs: int = 3,
             batch: int = 64, lr: float = 0.05, seed: int = 0,
             verbose: bool = False, device=None) -> dict:
    """SGD-momentum pretraining with PyTorch autograd on ``device`` (the GPU
    unless told otherwise), in full f32 with cuDNN's deterministic
    algorithms: the reference's ``pretrain``, step for step (the same
    batches, the same update, BN statistics as ``_bn_apply``)."""
    dev = resolve_device(device)
    trainable = [k for k in params if not k.endswith("_bn")]
    tp = {k: torch.as_tensor(params[k]).to(dev).clone().requires_grad_()
          for k in trainable}
    momenta = {k: torch.zeros_like(tp[k]) for k in trainable}
    bn_p = params_to({k: v for k, v in params.items() if k.endswith("_bn")},
                     dev)
    xs = torch.as_tensor(x).to(dev)
    ys = torch.as_tensor(y).to(dev).long()
    rng = np.random.default_rng(seed)
    n = (len(x) // batch) * batch
    with full_f32():
        for ep in range(epochs):
            order = rng.permutation(len(x))[:n]
            for i in range(0, n, batch):
                idx = torch.as_tensor(order[i:i + batch]).to(dev)
                logits, new_p = forward({**bn_p, **tp}, xs[idx], train=True)
                loss = F.cross_entropy(logits, ys[idx])
                grads = torch.autograd.grad(loss, [tp[k] for k in trainable])
                with torch.no_grad():
                    for k, g in zip(trainable, grads):
                        momenta[k] = 0.9 * momenta[k] + g
                        tp[k] -= lr * momenta[k]
                bn_p = {k: new_p[k] for k in bn_p}
            if verbose:
                print(f"  pretrain epoch {ep}: loss={loss.item():.3f}")
    return params_to_numpy({**tp, **bn_p})


def mobilenet_to_ir(params: dict, batch: int, img: int = 32) -> Program:
    """Bake trained weights into an inference IR program (Figure 1 style)."""
    b = Builder("mobilenet_fwd")
    x = b.input("images", (batch, img, img, 3))

    def bn_ir(h, bn):
        return b.batch_norm_inference(
            h, b.const(bn["gamma"]), b.const(bn["beta"]),
            b.const(bn["mean"]), b.const(bn["var"]))

    h = b.conv2d(x, b.const(params["stem_w"]), strides=(1, 1))
    h = b.relu(bn_ir(h, params["stem_bn"]))
    for i, (s, _) in enumerate(_BLOCKS):
        c = b.shape(h)[-1]
        h = b.conv2d(h, b.const(params[f"dw{i}_w"]), strides=(s, s), groups=c)
        h = b.relu(bn_ir(h, params[f"dw{i}_bn"]))
        h = b.conv2d(h, b.const(params[f"pw{i}_w"]), strides=(1, 1))
        h = b.relu(bn_ir(h, params[f"pw{i}_bn"]))
    hh, hw = b.shape(h)[1], b.shape(h)[2]
    h = b.avg_pool(h, (hh, hw))                       # global average pool
    h = b.reshape(h, (batch, b.shape(h)[-1]))          # flatten
    h = b.relu(b.dense(h, b.const(params["fc1_w"]), b.const(params["fc1_b"])))
    logits = b.dense(h, b.const(params["fc2_w"]), b.const(params["fc2_b"]))
    b.output(b.softmax(logits))
    return b.done()


def build_mobilenet_prediction_workload(*, alpha: float = 0.25,
                                        batch: int = 64,
                                        n_eval: int = 2048,
                                        n_pretrain: int = 6000,
                                        pretrain_epochs: int = 3,
                                        time_mode: str = "static",
                                        seed: int = 0,
                                        verbose: bool = False,
                                        device=None) -> PredictionWorkload:
    """MobileNet prediction on ``device`` (the GPU unless told otherwise):
    pretrained there on the first ``n_pretrain`` images of the reference's
    synthetic CIFAR-10 training split, scored on its first ``n_eval``."""
    dev = resolve_device(device)
    xtr, ytr = cifar10_train_head(max(n_pretrain, n_eval))
    params = init_mobilenet(alpha=alpha, seed=seed)
    params = pretrain(params, xtr[:n_pretrain], ytr[:n_pretrain],
                      epochs=pretrain_epochs, seed=seed, verbose=verbose,
                      device=dev)
    program = mobilenet_to_ir(params, batch)
    return PredictionWorkload(
        name="MobileNet-prediction",
        program=program,
        images=xtr[:n_eval], labels=ytr[:n_eval],
        batch=batch, time_mode=time_mode, device=str(dev),
        # this workload pickles whole (weights are baked-in constants), so
        # workers normally receive it directly; the spec is a fallback that
        # re-pretrains
        spec=WorkloadSpec.make(
            "repro_torch.workloads.mobilenet:"
            "build_mobilenet_prediction_workload",
            alpha=alpha, batch=batch, n_eval=n_eval, n_pretrain=n_pretrain,
            pretrain_epochs=pretrain_epochs, time_mode=time_mode, seed=seed,
            device=str(dev)))
