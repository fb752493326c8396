"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's (``repro.optim``): the same numpy parameters and gradients
through several steps, and the reference's own cases of tests/test_optim.py
that need no mesh (the gradient-compression ones wait with it).  Adafactor
also on every arch's smoke-config parameters, which the reference stacks
on a layer axis and the port keeps one tensor a layer.

Tolerance: parameters and moments within 1e-6 + 1e-6 |ref| after 6 steps
(f32 elementwise arithmetic; the port's bias corrections are the
reference's f32 values, its divisions may round a last bit otherwise);
schedules within 5e-7 relative: f32 on both sides, but XLA's f32 cosine
and torch's differ by up to 2 ulp (seen: 1.5e-7 relative at one step of
the cosine schedule; 1e-7 was the first choice and failed on it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as R
from repro.optim.schedules import cosine_schedule as ref_cosine
from repro.optim.schedules import wsd_schedule as ref_wsd
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.weights import reference_key, reference_layout
from repro_torch.optim import OPTIMIZERS, adafactor, adamw, sgd_momentum
from repro_torch.optim.optimizers import _stack_key
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule

ARCHS = ("qwen3-0.6b", "qwen1.5-4b", "qwen1.5-32b", "minicpm-2b",
         "qwen2-vl-72b", "hubert-xlarge", "granite-moe-3b-a800m",
         "deepseek-v3-671b", "falcon-mamba-7b", "zamba2-1.2b")

SHAPES = {"w": (3, 4), "b": (4,), "k": (2, 3, 5)}
CASES = {
    "sgd": dict(lr=0.1, momentum=0.9, weight_decay=0.01),
    "adamw": dict(lr=0.05, weight_decay=0.1),
    "adafactor": dict(lr=0.3, weight_decay=0.01),
}


def _np_tree(seed):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal(s, dtype=np.float32)
            for k, s in SHAPES.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _close(got, want, tol=1e-6):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape
    assert np.all(np.abs(g - w) <= tol + tol * np.abs(w)), \
        float(np.max(np.abs(g - w)))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("schedule", [None, "wsd", "cosine"])
def test_optimizer_trajectory_equals_reference(name, schedule):
    kw = dict(CASES[name])
    if schedule == "wsd":
        ref_lr, lr = (f(kw["lr"], 2, 2, 2, floor=0.01)
                      for f in (ref_wsd, wsd_schedule))
    elif schedule == "cosine":
        ref_lr, lr = (f(kw["lr"], 2, 6) for f in (ref_cosine, cosine_schedule))
    else:
        ref_lr = lr = kw["lr"]
    ref_opt = getattr(R, R.OPTIMIZERS[name].__name__)(**{**kw, "lr": ref_lr})
    opt = OPTIMIZERS[name](**{**kw, "lr": lr})
    p0 = _np_tree(0)
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_s = ref_opt.init(ref_p)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = opt.init(params)
    for step in range(6):
        g = _np_tree(100 + step)
        ref_p, ref_s = ref_opt.update({k: jnp.asarray(v)
                                       for k, v in g.items()},
                                      ref_s, ref_p, step)
        out, state = opt.update({k: torch.from_numpy(v)
                                 for k, v in g.items()}, state, params, step)
        assert out is params
    for k in SHAPES:
        _close(params[k], ref_p[k])
    ref_flat = _flat(jax.tree.map(np.asarray, ref_s))
    got_flat = _flat({k: (v if isinstance(v, dict) else v.numpy())
                      for k, v in state.items()})
    got_flat = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in got_flat.items()}
    assert sorted(got_flat) == sorted(ref_flat)
    for k in ref_flat:
        _close(got_flat[k], ref_flat[k])
    assert opt.state_bytes_per_param == ref_opt.state_bytes_per_param


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_moments_are_f32_and_params_keep_dtype(dtype):
    p = {"w": torch.ones((4, 3), dtype=dtype)}
    opt = adamw(lr=0.1)
    state = opt.init(p)
    assert state["m"]["w"].dtype == state["v"]["w"].dtype == torch.float32
    w = p["w"]
    opt.update({"w": torch.full((4, 3), 0.5, dtype=dtype)}, state, p, 0)
    assert p["w"] is w and w.dtype == dtype and int(state["count"]) == 1
    assert torch.all(w < 1)


def test_schedules_equal_reference():
    pairs = [(wsd_schedule(1.0, 10, 20, 10, floor=0.1),
              ref_wsd(1.0, 10, 20, 10, floor=0.1)),
             (wsd_schedule(3e-4, 0, 5, 0), ref_wsd(3e-4, 0, 5, 0)),
             (cosine_schedule(1.0, 5, 50), ref_cosine(1.0, 5, 50)),
             (cosine_schedule(3e-4, 0, 1), ref_cosine(3e-4, 0, 1))]
    for ours, ref in pairs:
        for step in range(0, 61):
            want = float(ref(step))
            assert ours(step) == pytest.approx(want, rel=5e-7, abs=0.0)


# --------------------------------------------------------------------------
# the reference's cases (tests/test_optim.py) that need no mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opt_fn", [
    lambda: sgd_momentum(lr=0.1),
    lambda: adamw(lr=0.05, weight_decay=0.0),
    lambda: adafactor(lr=0.3),
])
def test_optimizer_minimizes_quadratic(opt_fn):
    opt = opt_fn()
    params = {"w": torch.tensor([3.0, -2.0, 1.5]),
              "b": torch.tensor([[1.0, -1.0]])}

    def loss_fn(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    state = opt.init(params)
    l0 = float(loss_fn(params))
    for step in range(60):
        w = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = dict(zip(w, torch.autograd.grad(loss_fn(w), list(w.values()))))
        params, state = opt.update(g, state, params, step)
    assert float(loss_fn(params)) < l0 * 0.05


def test_adafactor_state_is_factored():
    opt = adafactor()
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros((32,))}
    state = opt.init(params)
    assert state["f"]["w"]["r"].shape == (64,)
    assert state["f"]["w"]["c"].shape == (32,)
    assert state["f"]["b"]["v"].shape == (32,)


def _smoke_layout(arch):
    """(parameter names, the reference's stacked shape of each leaf) of
    ``arch``'s smoke model."""
    model = T.init_params(smoke_config(arch),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    names = [n for n, _ in model.named_parameters()]
    shapes = {k: v[0] for k, v in _flat_shapes(reference_layout(model))}
    return names, shapes


def _flat_shapes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_shapes(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _per_name(flat: dict, names) -> dict:
    """The port's tensors (one a layer) of the reference's stacked arrays."""
    out = {}
    for n in names:
        key, layer = reference_key(n)
        out[n] = torch.from_numpy(np.array(
            flat[key] if layer is None else flat[key][layer]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_stacked_trajectory_equals_reference(arch):
    """Six Adafactor steps on the parameters of a whole smoke model: the
    reference on its stacked tree, the port on one tensor a layer; the
    parameters, and the factored moments under the reference's leaf names
    with the reference's stacked shapes (a layer's (d,) norm scale is an
    (n_layers, d) leaf there, so it has r and c), agree.  At Adafactor's
    default lr 1e-2: the two packages take the means of r, c and the RMS
    in other orders (their last bits differ), so an update element of
    ~20 differs in its last bit (~2e-6); at lr 0.3 that moved a few of
    10^5 parameters past the 1e-6 floor over six steps."""
    names, shapes = _smoke_layout(arch)
    r = np.random.default_rng(0)

    def draw():
        return {k: r.standard_normal(s, dtype=np.float32)
                for k, s in shapes.items()}

    kw = dict(CASES["adafactor"], lr=1e-2)
    ref_opt, opt = R.adafactor(**kw), adafactor(**kw)
    p0 = draw()
    ref_p = _nest({k: jnp.asarray(v) for k, v in p0.items()})
    ref_s = ref_opt.init(ref_p)
    params = _per_name(p0, names)
    state = opt.init(params)
    for step in range(6):
        g = draw()
        ref_p, ref_s = ref_opt.update(
            _nest({k: jnp.asarray(v) for k, v in g.items()}), ref_s, ref_p,
            step)
        opt.update(_per_name(g, names), state, params, step)
    want = _flat(jax.tree.map(np.asarray, ref_p))
    for n in names:
        key, layer = reference_key(n)
        _close(params[n], want[key] if layer is None else want[key][layer])
    ref_f = _flat(jax.tree.map(np.asarray, ref_s["f"]))
    got_f = {f"{k}.{m}": t.numpy() for k, f in state["f"].items()
             for m, t in f.items()}
    assert sorted(got_f) == sorted(ref_f)
    for k in ref_f:
        _close(got_f[k], ref_f[k])
    assert int(state["count"]) == int(ref_s["count"]) == 6


def test_stack_key_agrees_with_reference_key():
    """Adafactor's private grouping rule is ``models/weights.py``'s
    ``reference_key`` on every parameter of every smoke model and on flat
    names."""
    names = {"w", "b", "k", "embed", "final_norm.scale"}
    for arch in ARCHS:
        names |= set(_smoke_layout(arch)[0])
    for n in sorted(names):
        assert _stack_key(n) == reference_key(n)[0], n


def test_adafactor_groups_a_model_by_reference_leaf():
    """A stacked leaf's (d,) per-layer scale is factored as (n_layers, d),
    and its state keyed by the reference's leaf name: its column moment
    averages over the layers, so a layer's update is not the sign of its
    gradient that a lone (d,) leaf's first step gives."""
    opt = adafactor(lr=1.0)
    params = {"layers.0.norm": torch.zeros(4), "layers.1.norm": torch.zeros(4),
              "layers.0.w": torch.zeros(4, 3), "layers.1.w": torch.zeros(4, 3),
              "embed": torch.zeros(5, 4)}
    state = opt.init(params)
    assert sorted(state["f"]) == ["embed", "layers.norm", "layers.w"]
    assert state["f"]["layers.norm"]["r"].shape == (2,)
    assert state["f"]["layers.norm"]["c"].shape == (4,)
    assert state["f"]["layers.w"]["r"].shape == (2, 4)
    assert state["f"]["layers.w"]["c"].shape == (2, 3)
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    grads["layers.0.norm"] = torch.tensor([1.0, 2.0, 3.0, 4.0])
    grads["layers.1.norm"] = torch.tensor([4.0, 3.0, 2.0, 1.0])
    opt.update(grads, state, params, 0)
    alone = adafactor(lr=1.0)
    p1 = {"norm": torch.zeros(4)}
    alone.update({"norm": grads["layers.0.norm"]}, alone.init(p1), p1, 0)
    assert torch.equal(p1["norm"], torch.full((4,), -1.0))
    assert not torch.allclose(params["layers.0.norm"], p1["norm"])
    g2 = torch.stack([grads["layers.0.norm"], grads["layers.1.norm"]]) ** 2
    # the first step's moments are the means themselves (beta = 0)
    assert torch.allclose(state["f"]["layers.norm"]["c"], g2.mean(0))


def test_wsd_schedule_phases():
    lr = wsd_schedule(peak=1.0, warmup=10, stable=20, decay=10, floor=0.1)
    assert float(lr(0)) == 0.0
    assert float(lr(5)) == pytest.approx(0.5)
    assert float(lr(15)) == pytest.approx(1.0)
    assert float(lr(29)) == pytest.approx(1.0)
    assert 0.1 <= float(lr(35)) < 1.0
    assert float(lr(100)) == pytest.approx(0.1)


def test_cosine_schedule_monotone_decay():
    lr = cosine_schedule(peak=1.0, warmup=5, total=50)
    vals = [float(lr(s)) for s in range(5, 50, 5)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
