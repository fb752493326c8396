"""Shared fixtures of the model-stack parity tests (tests/test_torch_*.py):
the reference's weights carried into the port, seeded numpy batches, and
the reference's model functions jitted once per config (eagerly they run
op by op, several seconds a call).  Not a test module itself."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as R
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.weights import params_from_reference

# logits, losses and caches: |port - ref| <= ATOL + RTOL |ref|
ATOL, RTOL = 1e-4, 1e-4
DECODERS = ("granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-vl-72b",
            "zamba2-1.2b", "minicpm-2b", "qwen1.5-4b", "qwen1.5-32b",
            "qwen3-0.6b", "falcon-mamba-7b")


@functools.lru_cache(maxsize=None)
def weights(arch: str, **overrides):
    """(reference cfg, reference params, port cfg, port params on the CPU)
    for ``arch``'s smoke config with ``overrides``, from
    ``init_params(cfg, PRNGKey(0))``."""
    cfg = ref_smoke_config(arch).scaled(**overrides)
    tcfg = smoke_config(arch).scaled(**overrides)
    ref = R.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, ref)
    return cfg, ref, tcfg, params_from_reference(tree, tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def ref_fns(cfg):
    """The reference's (train_loss, prefill, decode_step), jitted with the
    config static."""
    return (jax.jit(lambda p, b: R.train_loss(p, b, cfg)),
            jax.jit(lambda p, b: R.prefill(p, b, cfg)),
            jax.jit(lambda p, b, c, i: R.decode_step(p, b, c, i, cfg)))


def batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    """A seeded numpy batch: tokens (or embeddings), labels, and M-RoPE
    positions where the config uses them."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        b = {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                           dtype=np.float32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.mrope:
        b["positions3"] = positions3(B, np.arange(S))
    return b


def positions3(B: int, pos) -> np.ndarray:
    p = np.asarray(pos, np.int32)
    return np.ascontiguousarray(
        np.broadcast_to(p[None, :, None], (B, len(p), 3)))


def token_batch(cfg, tokens: np.ndarray, index: int) -> dict:
    B = tokens.shape[0]
    tb = {"tokens": tokens.reshape(B, 1).astype(np.int32),
          "positions": np.full((B, 1), index, np.int32)}
    if cfg.mrope:
        tb["positions3"] = positions3(B, [index])
    return tb


def jnp_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def np32(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().to("cpu").float().numpy()
    return np.asarray(x, np.float32)


def max_excess(got, want) -> float:
    """The largest ``|got - want| - RTOL |want|``, over ATOL when they
    disagree beyond the tolerance."""
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w) - RTOL * np.abs(w), initial=0.0))


def assert_close(got, want, what: str = "") -> float:
    """Hold ``got`` to ``want`` within ATOL + RTOL |want|; returns the
    largest absolute difference."""
    excess = max_excess(got, want)
    err = float(np.max(np.abs(np32(got) - np32(want)), initial=0.0))
    assert excess <= ATOL, f"{what}: max |diff| {err:.3e} beyond tolerance"
    return err


def ref_splice(full: dict, pre: dict, P: int, T_: int) -> dict:
    """The reference's prefill caches spliced into its decode caches of
    length ``T_`` (as tests/test_serve.py's direct loop does)."""
    def splice(f, p):
        if f.ndim >= 3 and p.ndim == f.ndim and p.shape[2] == P \
                and f.shape[2] == T_:
            return f.at[:, :, :P].set(p)
        return p if p.shape == f.shape else f
    return jax.tree.map(splice, full, pre)


def port_splice(full: dict, pre: dict, P: int, T_: int) -> dict:
    """The port's prefill caches spliced into its decode caches."""
    out = {}
    for k, f in full.items():
        p = pre[k]
        if f.dim() >= 3 and p.dim() == f.dim() and p.shape[2] == P \
                and f.shape[2] == T_:
            f[:, :, :P] = p
            out[k] = f
        else:
            out[k] = p.clone() if p.shape == f.shape else f
    return out


def direct_generate(tcfg, params, prompt: np.ndarray, gen: int) -> list:
    """The port's engine-independent oracle: the direct prefill + lockstep
    decode_step loop, B=1, greedy, an int cache index."""
    P = len(prompt)
    logits, pre = T.prefill(params, {"tokens": prompt[None]}, tcfg)
    caches = port_splice(T.init_cache(tcfg, 1, P + gen, device="cpu"), pre,
                         P, P + gen)
    tok = int(logits.argmax(-1)[0])
    out = [tok]
    for t in range(gen - 1):
        logits, caches = T.decode_step(
            params, token_batch(tcfg, np.array([tok]), P + t), caches, P + t,
            tcfg)
        tok = int(logits.argmax(-1)[0])
        out.append(tok)
    return out


# --------------------------------------------------------------------------
# whole-stack checks, shared by the per-family test files
# --------------------------------------------------------------------------

B, S, STEPS = 2, 13, 3


def check_train_loss(arch: str, **overrides) -> float:
    cfg, ref, tcfg, params = weights(arch, **overrides)
    b = batch(cfg, B, S if not cfg.loss_chunk else 4 * cfg.loss_chunk)
    want = ref_fns(cfg)[0](ref, jnp_batch(b))
    return assert_close(T.train_loss(params, b, tcfg), want, "train_loss")


def check_prefill_and_decode(arch: str, steps: int = STEPS,
                             **overrides) -> float:
    """prefill logits and caches, then ``steps`` decode_steps (logits and
    every cache leaf) against the reference; returns the largest error."""
    cfg, ref, tcfg, params = weights(arch, **overrides)
    _, pre_fn, dec_fn = ref_fns(cfg)
    b = batch(cfg, B, S)
    b.pop("labels")
    want, rcaches = pre_fn(ref, jnp_batch(b))
    got, tcaches = T.prefill(params, b, tcfg)
    errs = [assert_close(got, want, "prefill logits")]
    assert sorted(tcaches) == sorted(rcaches)
    for k in rcaches:
        errs.append(assert_close(tcaches[k], rcaches[k], f"prefill {k}"))
    T_ = S + steps
    rcaches = ref_splice(R.init_cache(cfg, B, T_), rcaches, S, T_)
    tcaches = port_splice(T.init_cache(tcfg, B, T_, device="cpu"), tcaches,
                          S, T_)
    tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    for t in range(steps):
        tb = token_batch(cfg, tok, S + t)
        want, rcaches = dec_fn(ref, jnp_batch(tb), rcaches, jnp.int32(S + t))
        got, tcaches = T.decode_step(params, tb, tcaches, S + t, tcfg)
        errs.append(assert_close(got, want, f"decode {t} logits"))
        for k in rcaches:
            errs.append(assert_close(tcaches[k], rcaches[k],
                                     f"decode {t} {k}"))
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    return max(errs)


def check_lane_index(arch: str) -> None:
    """decode_step with a (lanes,) index tensor equals, lane by lane, the
    scalar-index step of each lane alone, within 1e-5 + 1e-5 relative: a
    matmul over two lanes rounds unlike one over one (seen: <= 2.4e-6 on
    logits, 1.7e-6 on caches); a wrong cache position would be O(1)."""
    import torch
    _, _, tcfg, params = weights(arch)
    T_, lens = 24, (5, 11)
    lanes = T.init_cache(tcfg, 2, T_, device="cpu")
    rng = np.random.default_rng(1)
    for i, P in enumerate(lens):
        prompt = rng.integers(0, tcfg.vocab, (1, P)).astype(np.int32)
        pb = {"tokens": prompt}
        if tcfg.mrope:
            pb["positions3"] = positions3(1, np.arange(P))
        _, pre = T.prefill(params, pb, tcfg)
        one = port_splice(T.init_cache(tcfg, 1, T_, device="cpu"), pre, P,
                          T_)
        for k in lanes:
            lanes[k][:, i] = one[k][:, 0]
    alone = [{k: v[:, i:i + 1].clone() for k, v in lanes.items()}
             for i in range(2)]
    toks = np.array([7, 9], np.int32)
    tb = {"tokens": toks[:, None], "positions": np.array(lens)[:, None]}
    if tcfg.mrope:
        tb["positions3"] = np.stack([positions3(1, [p])[0] for p in lens])
    got, lanes = T.decode_step(params, tb, lanes,
                               torch.tensor(lens), tcfg)
    for i, P in enumerate(lens):
        want, alone[i] = T.decode_step(
            params, token_batch(tcfg, toks[i:i + 1], P), alone[i], P, tcfg)
        assert torch.allclose(got[i:i + 1], want, rtol=1e-5, atol=1e-5)
        for k in lanes:
            assert torch.allclose(lanes[k][:, i:i + 1], alone[i][k],
                                  rtol=1e-5, atol=1e-5), k
