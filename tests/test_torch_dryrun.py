"""The dry run of the port (``launch/specs.py``, ``hlo_analysis.py``,
``roofline.py``, ``dryrun.py``) against the reference's, the kernel
wrappers' shape-only path, and the fake process group that stands in for
the production mesh.

* Abstract inputs, model FLOPs and the cell's shardings: equal to the
  reference's, exactly.
* The calibrations of ``tests/test_distributed.py``: exact.
* Smoke cells on a one-device mesh against the reference's ``analyze`` of
  the same cell: the dot FLOPs are equal once attention's products are
  counted the same way on both sides.  The reference's CPU HLO computes
  attention as two full einsums, 2 S^2 hd a head and product, four in its
  backward; the port runs the flash kernel, which counts the causal half
  at the kernel's launch head dim (a smoke config's 16 padded to 32).  So
  the port's aten dot FLOPs plus ``_ref_attention_flops`` must equal the
  reference's total.  The arguments' bytes agree within 1%: the port
  rounds each storage up to the caching allocator's 512 bytes.  Bytes
  moved and temporaries are not compared: the reference models a TPU that
  keeps loop-body temporaries in VMEM, the port an eager step.
* Every test leaves no process group behind (``_no_group_left``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import repro.configs as ref_configs
from repro.configs import runnable_cells as ref_runnable_cells
from repro.launch import shardings as RS
from repro.launch import specs as ref_specs
from repro.launch.hlo_analysis import analyze as ref_analyze
from repro.launch.roofline import model_flops as ref_model_flops
from repro_torch.configs import get_config, runnable_cells, smoke_config
from repro_torch.kernels import costs, trace
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.mamba_scan.mamba_scan import (mamba_scan_bwd_plain,
                                                       mamba_scan_plain)
from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_bwd
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.hlo_analysis import (COLLECTIVES, HloCosts, analyze,
                                             wire_bytes)
from repro_torch.launch.mesh import MeshShape, fake_process_group
from repro_torch.launch.specs import input_specs, make_cell
from repro_torch.models.common import P, psum, shard_map

SMOKE_SHAPES = {"train": (64, 4, "train"), "prefill": (64, 4, "prefill"),
                "decode": (64, 4, "decode")}


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized(), "a process group was left running"


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


# --------------------------------------------------------------------------
# the fake process group
# --------------------------------------------------------------------------

def test_fake_process_group_starts_reuses_refuses_and_ends():
    with fake_process_group(8):
        assert dist.get_world_size() == 8 and dist.get_rank() == 0
        with fake_process_group(8):  # the same group, used as it is
            assert dist.get_world_size() == 8
        assert dist.is_initialized()
        with pytest.raises(RuntimeError, match="cannot start beside it"):
            with fake_process_group(4):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with fake_process_group(2):
            1 / 0
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# specs, model FLOPs and shardings against the reference
# --------------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).rsplit(".", 1)[-1])


@pytest.mark.parametrize("arch,shape", ref_runnable_cells())
def test_input_specs_match_reference(arch, shape):
    """Batch, caches (``jax.eval_shape`` of ``init_cache``) and the decode
    index: shapes and dtypes for every runnable cell."""
    want = ref_specs.input_specs(arch, shape)
    got = input_specs(arch, shape)
    assert got["kind"] == want["kind"]
    for key in ("batch", "caches", "index"):
        if key in want:
            assert _shapes(got[key]) == _shapes(want[key]), key


def test_runnable_cells_match_reference():
    assert runnable_cells() == ref_runnable_cells()


@pytest.mark.parametrize("arch,shape", ref_runnable_cells())
def test_model_flops_match_reference(arch, shape):
    assert roofline.model_flops(get_config(arch), shape) == \
        ref_model_flops(ref_configs.get_config(arch), shape)


class FakeMesh:
    """The reference's mesh geometry without devices."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(getattr(v, "spec", v))
    return out


def _layer_key(name):
    parts = name.split(".")
    at = next((i + 1 for i in range(len(parts) - 1)
               if parts[i] == "layers" and parts[i + 1].isdigit()), None)
    return (".".join(parts[:at] + parts[at + 1:]), True) if at \
        else (name, False)


def _compare(port: dict, ref: dict) -> set:
    """The port's specs (a layer's tensor against the reference's stacked
    leaf, less its layer entry) against the reference's; returns the
    reference leaves compared."""
    seen = set()
    for name, spec in _flat(port).items():
        key, layer = _layer_key(name)
        want = ref[key]
        if layer and want:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert spec == want, (name, spec, want)
        seen.add(key)
    return seen


SPEC_CELLS = [("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
              ("qwen3-0.6b", "decode_32k"), ("deepseek-v3-671b", "train_4k"),
              ("zamba2-1.2b", "decode_32k"),
              ("falcon-mamba-7b", "long_500k")]


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", SPEC_CELLS)
def test_cell_shardings_match_reference_on_geometry(arch, shape, multi):
    """``make_cell`` on a ``MeshShape``: each argument's spec against the
    reference's ``make_cell`` assembly of its rules on the same geometry
    (parameters, optimizer state, step, batch, caches, index)."""
    if multi:
        geo, names, dp = (2, 16, 16), ("pod", "data", "model"), \
            ("pod", "data")
    else:
        geo, names, dp = (16, 16), ("data", "model"), ("data",)
    cell = make_cell(arch, shape, MeshShape(geo, names))
    assert cell.fn is None and cell.kind == ref_configs.SHAPES[shape][2]
    fake = FakeMesh(geo, names)
    cfg = ref_configs.get_config(arch)
    spec = ref_specs.input_specs(arch, shape)
    dp_size = int(np.prod(geo[:-1]))
    params_s = jax.eval_shape(lambda: ref_specs.init_params(
        cfg, jax.random.PRNGKey(0)))
    p_specs = _flat(RS.param_specs(params_s, fake, dp, "model",
                                   fsdp=cfg.fsdp))
    b_specs = _flat(RS.batch_specs(cfg, spec["batch"], dp, "model", dp_size))
    got = cell.in_shardings
    if cell.kind == "train":
        opt = ref_specs.pick_optimizer(cfg)
        o_specs = _flat(RS.param_specs(jax.eval_shape(opt.init, params_s),
                                       fake, dp, "model", fsdp=cfg.fsdp))
        assert _compare(got[0]["params"], p_specs) == set(p_specs)
        assert _compare(got[0]["opt_state"], o_specs) == set(o_specs)
        assert tuple(got[0]["step"].spec) == ()
    else:
        assert _compare(got[0], p_specs) == set(p_specs)
    assert _flat(got[1]) == b_specs
    if cell.kind == "decode":
        c_specs = _flat(RS.cache_specs(cfg, spec["caches"], dp, "model",
                                       dp_size, geo[-1]))
        assert _flat(got[2]) == c_specs
        assert tuple(got[3].spec) == ()


# --------------------------------------------------------------------------
# the cost count
# --------------------------------------------------------------------------

def test_calibration_matmul_flops_exact():
    with _fake():
        a, b = torch.empty(256, 512), torch.empty(512, 128)
        c = analyze(lambda x, y: x @ y, (a, b))
    assert c.flops == 2 * 256 * 512 * 128 == c.flops_f32


def test_calibration_chained_products_count_each():
    def g(x, ws):
        for w in ws:
            x = x @ w
        return x
    with _fake():
        x = torch.empty(64, 64)
        ws = [torch.empty(64, 64) for _ in range(10)]
        c = analyze(g, (x, ws))
    assert c.flops == 10 * 2 * 64 ** 3


def test_calibration_psum_wire_bytes_ring_factor():
    """A psum of a (1, 1024) f32 block over 8 fake ranks: 2 (7/8) 4096
    all-reduce bytes, one collective."""
    from torch.distributed.device_mesh import init_device_mesh
    with fake_process_group(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("d",))
        f = shard_map(lambda v: psum(v, "d"), mesh=mesh, in_specs=P("d"),
                      out_specs=P())
        with _fake():
            xs = torch.empty(8, 1024)
            c = analyze(f, (xs,))
    assert c.n_collective_ops == 1
    assert abs(c.collective_bytes["all_reduce"] - 2 * (7 / 8) * 4096) < 1


@pytest.mark.parametrize("kind,g,want", [
    ("all_reduce", 8, 2 * 7 / 8 * 800), ("all_gather", 16, 15 / 16 * 800),
    ("reduce_scatter", 4, 3 / 4 * 800), ("all_to_all", 2, 400.0),
    ("collective_permute", 8, 800.0)])
def test_wire_bytes_ring_factors(kind, g, want):
    assert wire_bytes(kind, 800, g) == want
    assert kind in set(COLLECTIVES.values())


def test_memory_counts_live_storage_peak():
    """Two (256, 128) f32 tensors live at the peak plus a 0-d result
    rounded to 512 bytes; arguments are not the step's."""
    def f(a, b):
        x = a @ b
        y = x * 2
        del x
        z = y + 1
        return z.sum()
    with _fake():
        a, b = torch.empty(256, 512), torch.empty(512, 128)
        c = analyze(f, (a, b), known=(a, b))
    assert c.memory == {"temp_size_in_bytes": 2 * 131072 + 512,
                        "output_size_in_bytes": 512}


@pytest.mark.parametrize("case", ["compute", "memory", "collective"])
def test_roofline_arithmetic(case):
    """Each dtype at its own H100 rate; the reference's fields and
    roofline fraction."""
    terms = {"compute": (4e15, 1e12, 0.0, 0.0),
             "memory": (1e12, 0.0, 1e13, 1e9),
             "collective": (1e12, 0.0, 1e9, 1e12)}[case]
    bf16, f32, hbm, wire = terms
    c = HloCosts(flops_bf16=bf16, flops_f32=f32, hbm_bytes=hbm,
                 vector_ops=2e11)
    c.collective_bytes["all_reduce"] = wire
    cfg = get_config("qwen3-0.6b")
    rl = roofline.roofline(c, cfg, "train_4k", 256)
    compute = bf16 / 989e12 + (f32 + 2e11) / 67e12
    assert rl.compute_s == compute
    assert rl.memory_s == hbm / 3.35e12
    assert rl.collective_s == wire / 450e9
    assert rl.dominant == case
    step = max(compute, hbm / 3.35e12, wire / 450e9)
    mf = roofline.model_flops(cfg, "train_4k") / 256
    assert rl.step_s == step and rl.model_flops_per_dev == mf
    assert rl.useful_ratio == mf / (bf16 + f32)
    assert rl.roofline_fraction == (mf / 989e12) / step


# --------------------------------------------------------------------------
# the wrappers' shape-only path
# --------------------------------------------------------------------------

def _real_and_fake(shapes: dict, seed: int = 0):
    rng = np.random.default_rng(seed)
    real = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
            .to(dt) for k, (s, dt) in shapes.items()}
    return real


KERNEL_CASES = {
    "rmsnorm": {"x": ((64, 48), torch.bfloat16),
                "scale": ((48,), torch.bfloat16)},
    "flash_attention": {"q": ((1, 2, 64, 32), torch.bfloat16),
                        "k": ((1, 2, 64, 32), torch.bfloat16),
                        "v": ((1, 2, 64, 32), torch.bfloat16)},
    "mamba_scan": {"dt": ((2, 32, 16), torch.float32),
                   "x": ((2, 32, 16), torch.float32),
                   "A": ((16, 4), torch.float32),
                   "B": ((2, 32, 4), torch.float32),
                   "C": ((2, 32, 4), torch.float32)},
}


def _calls(kernel, t, direction):
    """(outputs, the count's keyword arguments) of one call."""
    if kernel == "rmsnorm":
        if direction == "fwd":
            return (rmsnorm(t["x"], t["scale"], block_rows=32),), dict(
                rows=64, d=48, dtype=t["x"].dtype,
                scale_dtype=t["scale"].dtype)
        return rmsnorm_bwd(t["x"], t["scale"], t["x"]), dict(
            rows=64, d=48, dtype=t["x"].dtype, scale_dtype=t["scale"].dtype)
    if kernel == "flash_attention":
        q, k, v = t["q"], t["k"], t["v"]
        shape = dict(B=1, H=2, S=64, hd=32, dtype=q.dtype)
        if direction == "fwd":
            return (flash_attention(q, k, v, block_q=32, block_k=32),), \
                dict(shape, lse=False)
        lse = torch.zeros((1, 2, 64), dtype=torch.float32,
                          device=q.device)
        return flash_attention_bwd(q, k, v, q, q, lse), shape
    args = (t["dt"], t["x"], -t["A"].abs(), t["B"], t["C"])
    shape = dict(Bt=2, L=32, D=16, N=4, dtype=torch.float32)
    if direction == "fwd":
        return mamba_scan(*args, chunk=8, return_state=True), dict(
            shape, state=True)
    hc = torch.zeros((2, 4, 16, 4), device=t["x"].device)
    return mamba_scan_bwd(*args, t["x"], hc, chunk=8), dict(
        shape, chunk=8, dh_last=False)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("kernel", sorted(KERNEL_CASES))
def test_wrapper_shape_only_path(kernel, direction):
    """On fake (and meta) tensors a wrapper gives outputs of the plain
    version's shapes and dtypes, records one event of ``kernels.costs``'
    count, and moves no launch counter; real CPU tensors record none."""
    from repro_torch.kernels import flash_attention as _fa  # noqa: F401
    counters = {"rmsnorm": (rmsnorm, rmsnorm_bwd),
                "flash_attention": (flash_attention, flash_attention_bwd),
                "mamba_scan": (mamba_scan, mamba_scan_bwd)}[kernel]
    before = [c.launches for c in counters]
    real = _real_and_fake(KERNEL_CASES[kernel])
    sink = []
    with trace.recording(sink):
        want, _ = _calls(kernel, real, direction)
    assert sink == []
    for device in ("fake", "meta"):
        if device == "fake":
            with _fake() as mode, trace.recording(sink):
                fake = {k: mode.from_tensor(v) for k, v in real.items()}
                got, work = _calls(kernel, fake, direction)
        else:
            meta = {k: v.to("meta") for k, v in real.items()}
            with trace.recording(sink):
                got, work = _calls(kernel, meta, direction)
        assert [(tuple(g.shape), g.dtype) for g in got] == \
            [(tuple(w.shape), w.dtype) for w in want]
        event = sink.pop()
        assert sink == []
        cost = getattr(costs, f"{kernel}_{direction}_cost")(**work)
        assert (event["kernel"], event["direction"]) == (kernel, direction)
        assert (event["operations"], event["bytes"], event["matmul"]) == \
            (cost.operations, cost.bytes, cost.matmul)
    assert [c.launches for c in counters] == before


def test_plain_versions_are_what_cpu_tensors_take():
    """The shape-only path is never taken for a real CPU tensor: the
    wrappers' outputs are the plain versions'."""
    real = _real_and_fake(KERNEL_CASES["flash_attention"])
    q, k, v = (real[n].float() for n in "qkv")
    got = flash_attention(q, k, v, block_q=32, block_k=32)
    want = flash_attention_plain(q, k, v, causal=True, scale=32 ** -0.5,
                                 block_q=32, block_k=32)
    assert torch.equal(got, want)
    s = _real_and_fake(KERNEL_CASES["mamba_scan"])
    args = (s["dt"], s["x"], -s["A"].abs(), s["B"], s["C"])
    assert torch.equal(mamba_scan(*args, chunk=8),
                       mamba_scan_plain(*args, chunk=8))
    hc = torch.zeros((2, 4, 16, 4))
    for g, w in zip(mamba_scan_bwd(*args, s["x"], hc, chunk=8),
                    mamba_scan_bwd_plain(*args, s["x"], hc, None, chunk=8)):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------
# smoke cells against the reference's analyze
# --------------------------------------------------------------------------

def _ref_attention_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """The reference's count of full-sequence attention: QK^T and PV of
    2 S^2 hd a head (no causal half), four such products in the
    backward."""
    if kind == "decode":
        return 0.0
    per = 2 * 2 * batch * cfg.n_heads * seq * seq * cfg.hd
    return cfg.n_layers * per * (3 if kind == "train" else 1)


def _ref_cell(arch, shape, cfg):
    ref_configs.SHAPES["_smoke"] = shape
    try:
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        cell = ref_specs.make_cell(arch, "_smoke", mesh, cfg_override=cfg)
        compiled = cell.fn.lower(*cell.args).compile()
        return ref_analyze(compiled.as_text(), 1), compiled.memory_analysis()
    finally:
        del ref_configs.SHAPES["_smoke"]


@pytest.mark.parametrize("kind", sorted(SMOKE_SHAPES))
def test_smoke_cell_against_reference_analyze(kind):
    arch = "qwen3-0.6b"
    shape = SMOKE_SHAPES[kind]
    ref_costs, ref_mem = _ref_cell(arch, shape,
                                   ref_configs.smoke_config(arch))
    rec = dryrun.run_cell(arch, shape, False, cfg_override=smoke_config(arch),
                          mesh=((1, 1), ("data", "model")))
    assert rec["status"] == "ok", rec.get("traceback")
    h = rec["hlo"]
    seq, batch, _ = shape
    aten = sum(h["aten_flops"].values())
    assert aten + _ref_attention_flops(smoke_config(arch), seq, batch,
                                       kind) == ref_costs.flops
    arg = rec["memory"]["argument_size_in_bytes"]
    assert abs(arg - ref_mem.argument_size_in_bytes) \
        <= 0.01 * ref_mem.argument_size_in_bytes
    cfg = smoke_config(arch)
    norms = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    want = {"rmsnorm/fwd": norms if kind != "decode"
            else cfg.n_layers * 4 + 1}
    if kind != "decode":
        want["flash_attention/fwd"] = cfg.n_layers
    if kind == "train":
        want["rmsnorm/bwd"] = norms
        want["flash_attention/bwd"] = cfg.n_layers
    assert {k: v["events"] for k, v in h["kernels"].items()} == want


# --------------------------------------------------------------------------
# the production mesh
# --------------------------------------------------------------------------

def test_full_width_qwen3_train_on_16x16():
    """qwen3-0.6b train_4k on the 16x16 fake mesh: traced, each rank's 16
    sequences through every kernel, each parameter's gather over the data
    axis, each gradient's mean and the tensor-parallel sums counted, and
    the step, which splits heads, FFN units and the vocabulary over the
    16-way model axis, reported to fit a card (the step that gathered
    whole weights needed 312.1 GB a rank)."""
    rec = dryrun.run_cell("qwen3-0.6b", "train_4k", False)
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_config("qwen3-0.6b")
    k = rec["hlo"]["kernels"]
    assert k["rmsnorm/fwd"]["events"] == k["rmsnorm/bwd"]["events"] \
        == cfg.n_layers * 4 + 1
    assert k["flash_attention/fwd"]["events"] == cfg.n_layers
    cb = rec["hlo"]["collective_bytes"]
    assert cb["all_gather"] > 0 and cb["all_reduce"] > 0
    assert rec["memory"]["fits_80gb"] is True
    assert rec["roofline"]["step_s"] > 0


def test_untraceable_cell_is_a_fail_record_and_the_cli_exits_1(
        monkeypatch, tmp_path, capsys):
    """A cell whose step reads a value from the device is a FAIL record
    naming the op, and ``main`` exits 1."""
    import repro_torch.launch.specs as specs_mod
    real = specs_mod.make_train_step

    def reads_a_value(*a, **k):
        step = real(*a, **k)

        def wrapped(state, batch):
            state, m = step(state, batch)
            float(m["loss"])  # a device value the host waits for
            return state, m
        return wrapped

    monkeypatch.setattr(specs_mod, "make_train_step", reads_a_value)
    rec = dryrun.run_cell("qwen3-0.6b", (64, 4, "train"), False,
                          cfg_override=smoke_config("qwen3-0.6b"),
                          mesh=((1, 1), ("data", "model")))
    assert rec["status"] == "FAIL"
    assert "_local_scalar_dense" in rec["error"]
    monkeypatch.setattr(dryrun, "runnable_cells",
                        lambda: [("qwen3-0.6b", "train_4k")])
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, **k: dict(rec, arch=a[0]))
    assert dryrun.main(["--mesh", "single", "--out", str(tmp_path)]) == 1
    assert "[FAIL]" in capsys.readouterr().out
