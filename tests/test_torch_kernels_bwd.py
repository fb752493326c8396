"""The backward kernels' plain versions against the reference, on the CPU.

The reference has no backward kernel: XLA differentiates its oracles
(``src/repro/kernels/*/ref.py``).  The port's forwards are kernels, so each
has a backward kernel whose arithmetic its plain PyTorch version
(``*_bwd_plain``) repeats; on CPU tensors the wrappers' autograd Functions
run it.  Each is held here, in float32 on seeded numpy inputs, against
``jax.vjp`` of the reference's oracle and against ``torch.autograd`` of the
port's plain forward, and the Functions against the plain versions.  The
CUDA kernels are held against these plain versions on the GPU by
``chip_smoke.py`` (``train`` phase) and tests/test_torch_cuda_train.py.

Tolerances, |got - want| <= ATOL + RTOL |want| with RTOL 1e-5, and ATOL
the forward's of tests/test_kernels.py: rmsnorm 1e-5, flash attention
2e-5, the scan 1e-4.  Both sides are f32 sums of the same products in
other orders (over d, over the keys, over up to 40 steps of a recurrence
whose decay the port forms as exp2(dt A log2 e) and the reference as
exp(dt A)), about 1e-6 relative; a wrong term or mask is O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_scan
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba_scan.mamba_scan import (mamba_scan_bwd_plain,
                                                       mamba_scan_plain)
from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_bwd
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.rmsnorm.rmsnorm import (rmsnorm_bwd_plain,
                                                 rmsnorm_plain)
from repro_torch.models.attention import flash_sdpa
from repro_torch.models.mamba import scan_padded

RTOL = 1e-5
ATOL = {"rmsnorm": 1e-5, "flash": 2e-5, "scan": 1e-4}


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(got, want, kind, what=""):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    excess = float(np.max(np.abs(g - w) - RTOL * np.abs(w), initial=0.0))
    assert excess <= ATOL[kind], f"{what}: excess {excess:.3e}"


# --------------------------------------------------------------------------
# rmsnorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(8, 64), (5, 48), (3, 7)])
def test_rmsnorm_bwd_plain_matches_jax_vjp(rows, d):
    x, s, dy = _rand(0, (rows, d)), _rand(1, (d,)), _rand(2, (rows, d))
    _, vjp = jax.vjp(jax_rmsnorm, jnp.asarray(x), jnp.asarray(s))
    want_dx, want_ds = vjp(jnp.asarray(dy))
    dx, ds = rmsnorm_bwd_plain(_t(x), _t(s), _t(dy), eps=1e-6)
    _close(dx, want_dx, "rmsnorm", "dx")
    _close(ds, want_ds, "rmsnorm", "dscale")


@pytest.mark.parametrize("rows,d,block_rows", [(8, 64, 4), (6, 10, 3)])
def test_rmsnorm_bwd_plain_matches_autograd_of_plain(rows, d, block_rows):
    x, s = _t(_rand(3, (rows, d)), True), _t(_rand(4, (d,)), True)
    dy = _t(_rand(5, (rows, d)))
    y = rmsnorm_plain(x, s, eps=1e-6, block_rows=block_rows)
    want_dx, want_ds = torch.autograd.grad(y, (x, s), dy)
    dx, ds = rmsnorm_bwd_plain(x.detach(), s.detach(), dy, eps=1e-6)
    _close(dx, want_dx.numpy(), "rmsnorm", "dx")
    _close(ds, want_ds.numpy(), "rmsnorm", "dscale")


def test_rmsnorm_function_gradient_is_the_backward():
    """rmsnorm records its autograd Function: the gradient autograd gives
    is rmsnorm_bwd's (its plain version here), and without grad no graph
    is recorded."""
    x, s = _t(_rand(6, (2, 3, 16)), True), _t(_rand(7, (16,)), True)
    dy = _rand(8, (2, 3, 16))
    y = rmsnorm(x, s, block_rows=2)
    dx, ds = torch.autograd.grad(y, (x, s), _t(dy))
    want_dx, want_ds = rmsnorm_bwd(x.detach().reshape(6, 16), s.detach(),
                                   _t(dy).reshape(6, 16))
    assert torch.equal(dx.reshape(6, 16), want_dx)
    assert torch.equal(ds, want_ds)
    with torch.no_grad():
        assert not rmsnorm(x, s).requires_grad
    assert torch.equal(rmsnorm(x.detach(), s.detach(), block_rows=2),
                       y.detach())


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

def _qkv(seed, B, H, S, hd):
    return [_rand(seed + i, (B, H, S, hd)) for i in range(3)]


def _flash_bwd(q, k, v, do, *, causal, scale, block):
    o, lse = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                   scale=scale, block_q=block,
                                   block_k=block, return_lse=True)
    return flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, _t(do), lse,
                                     causal=causal, scale=scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,S,hd,block", [(1, 2, 32, 16, 16),
                                            (2, 1, 48, 8, 16)])
def test_flash_bwd_plain_matches_jax_vjp(causal, B, H, S, hd, block):
    q, k, v = _qkv(10, B, H, S, hd)
    do = _rand(20, (B, H, S, hd))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _flash_bwd(q, k, v, do, causal=causal, scale=hd ** -0.5,
                     block=block)
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, "flash", f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_autograd_of_plain(causal):
    q, k, v = (_t(a, True) for a in _qkv(30, 1, 2, 32, 16))
    do = _t(_rand(40, (1, 2, 32, 16)))
    o = flash_attention_plain(q, k, v, causal=causal, scale=0.25,
                              block_q=16, block_k=8)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = _flash_bwd(*(t.detach().numpy() for t in (q, k, v)),
                     do.numpy(), causal=causal, scale=0.25, block=16)
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w.numpy(), "flash", f"d{name}")


def test_flash_bwd_plain_padded_head_dim():
    """A head dim the kernel is not built for runs with zero columns
    appended at the scale of its own: the real columns' gradients are those
    of the unpadded attention, the padding's of dq and dk zero."""
    hd, hd_k = 12, 16
    q, k, v = _qkv(50, 1, 2, 32, hd)
    do = _rand(60, (1, 2, 32, hd))

    def pad(a):
        return np.pad(a, ((0, 0), (0, 0), (0, 0), (0, hd_k - hd)))
    got = _flash_bwd(pad(q), pad(k), pad(v), pad(do), causal=True,
                     scale=hd ** -0.5, block=16)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, causal=True),
                     *map(jnp.asarray, (q, k, v)))
    for g, w, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        _close(g[..., :hd], w, "flash", f"d{name}")
        assert not torch.any(g[..., hd:]), f"d{name} of the padding"


def test_flash_sdpa_ragged_causal_pad_gradient():
    """A causal sequence of 13 runs padded to the 16-row tile: the
    gradient through the pad, the Function and the slice equals the
    reference's vjp at 13, and the kernel's gradient of the padded K/V rows
    is zero (only padded query rows, whose output is cut, see them)."""
    cfg = smoke_config("qwen3-0.6b")
    B, S, H, hd = 2, 13, 2, 16
    q, k, v = (_rand(70 + i, (B, S, H, hd)) for i in range(3))
    do = _rand(80, (B, S, H, hd))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    out = flash_sdpa(tq, tk, tv, cfg)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))

    def ref(a, b, c):
        o = jax_attention(*(x.transpose(0, 2, 1, 3) for x in (a, b, c)),
                          causal=True)
        return o.transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    for g, w, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        _close(g, w, "flash", f"d{name}")
    # the padded call as flash_sdpa makes it, rows 13..15 of dk and dv
    heads = [np.pad(a.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, 3),
                                              (0, 0))) for a in (q, k, v)]
    dpad = np.pad(do.transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, 3), (0, 0)))
    _, dk, dv = _flash_bwd(*heads, dpad, causal=True, scale=hd ** -0.5,
                           block=16)
    assert not torch.any(dk[:, :, S:]) and not torch.any(dv[:, :, S:])


def test_flash_function_gradient_is_the_backward():
    q, k, v = (_t(a, True) for a in _qkv(90, 1, 2, 32, 16))
    do = _t(_rand(95, (1, 2, 32, 16)))
    o = flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = _flash_bwd(*(t.detach().numpy() for t in (q, k, v)), do.numpy(),
                      causal=True, scale=0.25, block=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(o.detach(), flash_attention(
        q.detach(), k.detach(), v.detach(), block_q=16, block_k=16))


# --------------------------------------------------------------------------
# the mamba scan
# --------------------------------------------------------------------------

def _scan_inputs(seed, Bt, L, D, N):
    r = np.random.default_rng(seed)
    dt = np.log1p(np.exp(r.standard_normal((Bt, L, D)))).astype(np.float32)
    return [dt, r.standard_normal((Bt, L, D), dtype=np.float32),
            -np.exp(0.3 * r.standard_normal((D, N))).astype(np.float32),
            r.standard_normal((Bt, L, N), dtype=np.float32),
            r.standard_normal((Bt, L, N), dtype=np.float32)]


def _scan_bwd(inputs, dy, dh_last=None, *, chunk):
    t = [_t(a) for a in inputs]
    _, _, hc = mamba_scan_plain(*t, chunk=chunk, return_state=True,
                                return_chunks=True)
    return mamba_scan_bwd_plain(*t, _t(dy), hc,
                                None if dh_last is None else _t(dh_last),
                                chunk=chunk)


@pytest.mark.parametrize("Bt,L,D,N,chunk", [(2, 24, 8, 4, 8),
                                            (1, 40, 6, 16, 40),
                                            (1, 12, 5, 1, 3)])
def test_scan_bwd_plain_matches_jax_vjp(Bt, L, D, N, chunk):
    inputs = _scan_inputs(1, Bt, L, D, N)
    dy = _rand(2, (Bt, L, D))
    _, vjp = jax.vjp(jax_scan, *map(jnp.asarray, inputs))
    want = vjp(jnp.asarray(dy))
    got = _scan_bwd(inputs, dy, chunk=chunk)
    # (ddt, dx, dA, dB, dC) against the oracle's (dt, x, A, B, C)
    for g, w, name in zip(got, want, ("dt", "x", "A", "B", "C")):
        _close(g, w, "scan", f"d{name}")


def test_scan_bwd_plain_h_last_gradient():
    """With a gradient of the final state, against torch.autograd of the
    plain forward (which returns it; the reference's oracle does not)."""
    inputs = _scan_inputs(3, 2, 16, 8, 4)
    dy, dh = _rand(4, (2, 16, 8)), _rand(5, (2, 8, 4))
    t = [_t(a, True) for a in inputs]
    y, h = mamba_scan_plain(*t, chunk=8, return_state=True)
    want = torch.autograd.grad((y, h), t, (_t(dy), _t(dh)))
    got = _scan_bwd(inputs, dy, dh, chunk=8)
    for g, w, name in zip(got, want, ("dt", "x", "A", "B", "C")):
        _close(g, w.numpy(), "scan", f"d{name}")


def test_scan_padded_gradient_equals_unpadded():
    """scan_padded pads L = 13 to the chunk with dt = x = B = C = 0: the
    gradients of the real steps are the reference's at 13."""
    inputs = _scan_inputs(6, 2, 13, 8, 4)
    dy = _rand(7, (2, 13, 8))
    t = [_t(a, True) for a in inputs]
    y, _ = scan_padded(*t, chunk=8)
    got = torch.autograd.grad(y, t, _t(dy))
    _, vjp = jax.vjp(jax_scan, *map(jnp.asarray, inputs))
    for g, w, name in zip(got, vjp(jnp.asarray(dy)),
                          ("dt", "x", "A", "B", "C")):
        _close(g, w, "scan", f"d{name}")


def test_scan_function_gradient_is_the_backward():
    inputs = _scan_inputs(8, 1, 16, 8, 4)
    t = [_t(a, True) for a in inputs]
    dy, dh = _t(_rand(9, (1, 16, 8))), _t(_rand(10, (1, 8, 4)))
    y, h = mamba_scan(*t, chunk=8, return_state=True)
    got = torch.autograd.grad((y, h), t, (dy, dh))
    d = [a.detach() for a in t]
    _, _, hc = mamba_scan_plain(*d, chunk=8, return_state=True,
                                return_chunks=True)
    want = mamba_scan_bwd(*d, dy, hc, dh, chunk=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(y.detach(), mamba_scan(*d, chunk=8))
