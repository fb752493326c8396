"""The port's IR interpreter against the reference's, on the CPU: every
opcode over the IR's dtypes (and the mixed dtypes a variant can produce at
run time), XLA's SAME padding for conv and the pools, random programs and
their mutants, and the interpreter's device rule and global flags.

The same numpy inputs go through ``repro.core.interp`` (JAX on the CPU,
jitted as the reference's workloads run it) and ``repro_torch.core.interp``
(PyTorch on the CPU).  Tolerances, stated per check:

* integer and bool results, and float results of exact IEEE ops (add,
  subtract, multiply, divide, maximum, minimum, negate, abs, sign, select,
  compare, convert, the data movers, reduce_max, max_pool): equal;
* transcendental ops, reductions, dot, conv, avg_pool: relative 1e-5 in
  f32, one bf16 rounding step (relative 2**-7) in bf16;
* whole programs and mutants: relative 1e-4 (f32 dot and conv chains sum
  in another order), absolute 1e-6 of the output's largest finite value;
* raises: a case that raises in the reference raises in the port, and the
  other way round.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.edits as ref_edits
import repro.core.interp as ref_interp
import repro.core.serialize as ref_serialize
import repro_torch.core.edits as edits
import repro_torch.core.interp as interp
import repro_torch.core.serialize as serialize
from repro.core.builder import Builder as RefBuilder
from repro.core.ir import Operation, TensorType
from repro.workloads.twofc import build_twofc_step
from repro_torch.core.builder import Builder

DTYPES = ("f32", "bf16", "i32", "bool")
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i32": jnp.int32,
       "bool": jnp.bool_}
NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
         torch.int32: "int32", torch.bool: "bool"}
EXACT = {"add", "subtract", "multiply", "divide", "maximum", "minimum",
         "negate", "abs", "sign", "select", "compare", "convert", "reshape",
         "transpose", "broadcast_in_dim", "pad", "slice", "reduce_max",
         "max_pool"}
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}

# Eight values per dtype, special ones included; the bf16 ones are exact
# in bf16, so both packages start from the same bits.
_LHS = {
    "f32": np.array([1.5, -2.0, 0.0, -0.0, np.nan, np.inf, 3.0e10, 0.3],
                    np.float32),
    "bf16": np.array([1.5, -2.0, 0.0, -0.0, np.nan, np.inf, 2.0 ** 34,
                      0.375], np.float32),
    "i32": np.array([3, -2, 0, 7, -2 ** 31, 2 ** 31 - 1, 16842753, 1],
                    np.int32),
    "bool": np.array([1, 0, 1, 0, 1, 1, 0, 1], bool),
}
_RHS = {
    "f32": np.array([0.5, 2.0, 0.0, 3.0, 1.0, -np.inf, -7.0, 2.5],
                    np.float32),
    "bf16": np.array([0.5, 2.0, 0.0, 3.0, 1.0, -np.inf, -7.0, 2.5],
                     np.float32),
    "i32": np.array([2, -3, 0, -1, 1, 2, 3, 5], np.int32),
    "bool": np.array([1, 1, 0, 0, 1, 0, 1, 0], bool),
}


@pytest.fixture(autouse=True)
def _global_state():
    """Every global flag a test here may touch comes back as it was."""
    cudnn = torch.backends.cudnn
    saved = (jax.config.jax_enable_x64, torch.get_num_threads(),
             torch.get_default_dtype(), cudnn.conv.fp32_precision,
             torch.backends.cuda.matmul.fp32_precision, cudnn.deterministic,
             cudnn.benchmark, np.random.get_state())
    yield
    jax.config.update("jax_enable_x64", saved[0])
    torch.set_num_threads(saved[1])
    torch.set_default_dtype(saved[2])
    cudnn.conv.fp32_precision = saved[3]
    torch.backends.cuda.matmul.fp32_precision = saved[4]
    cudnn.deterministic, cudnn.benchmark = saved[5], saved[6]
    np.random.set_state(saved[7])


def _ref_run(opcode, arrays, dtypes, attrs):
    """The reference's op, jitted, on arrays cast to ``dtypes``."""
    n = len(arrays)
    op = Operation(opcode=opcode, operands=list(range(n)), attrs=attrs,
                   result=n, type=TensorType((1,)), uid=0)

    def run(*xs):
        return ref_interp._eval_op(op, dict(enumerate(xs)))

    return jax.jit(run)(*[jnp.asarray(a, dtype=JNP[d])
                          for a, d in zip(arrays, dtypes)])


def _port_run(opcode, arrays, dtypes, attrs):
    xs = [torch.from_numpy(np.ascontiguousarray(a)).to(
        interp.TORCH_DTYPE[d]) for a, d in zip(arrays, dtypes)]
    return interp.eval_op(opcode, xs, attrs)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _check_op(opcode, arrays, dtypes, attrs=None, exact=None):
    attrs = attrs or {}
    try:
        want = _ref_run(opcode, arrays, dtypes, attrs)
    except Exception as e:  # the reference refuses: so must the port
        with pytest.raises(Exception):
            _port_run(opcode, arrays, dtypes, attrs)
        return type(e)
    got = _port_run(opcode, arrays, dtypes, attrs)
    assert NAMES[got.dtype] == str(want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    g, w = _numpy(got), _numpy(want)
    exact = opcode in EXACT if exact is None else exact
    if exact or str(want.dtype) in ("int32", "bool"):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL[str(want.dtype)], atol=0,
                                   equal_nan=True)
    return None


PAIRS = list(itertools.product(DTYPES, DTYPES))


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
@pytest.mark.parametrize("opcode", ["add", "subtract", "multiply", "divide",
                                    "maximum", "minimum", "power"])
def test_binary_op_matches_reference(opcode, a, b):
    """Same dtypes as the IR writes them, and the mixed pairs a variant can
    produce at run time (jnp promotes: bool < i32 < bf16 < f32)."""
    _check_op(opcode, [_LHS[a], _RHS[b]], [a, b])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("opcode", ["exponential", "log", "negate", "tanh",
                                    "rsqrt", "abs", "sign"])
def test_unary_op_matches_reference(opcode, dtype):
    _check_op(opcode, [_LHS[dtype]], [dtype])


def test_known_raises_and_promotions():
    """The cases the interpreter's docstring names, pinned down."""
    assert _check_op("rsqrt", [_LHS["i32"]], ["i32"]) is TypeError
    assert _check_op("subtract", [_LHS["bool"], _RHS["bool"]],
                     ["bool", "bool"]) is TypeError
    assert _check_op("divide", [_LHS["i32"], _RHS["i32"]],
                     ["i32", "i32"]) is None
    got = _port_run("divide", [_LHS["i32"], _RHS["i32"]], ["i32", "i32"], {})
    assert got.dtype == torch.float32
    got = _port_run("add", [_LHS["bf16"], _RHS["f32"]], ["bf16", "f32"], {})
    assert got.dtype == torch.float32
    got = _port_run("power", [_LHS["i32"], _RHS["i32"]], ["i32", "i32"], {})
    assert got[1].item() == 0      # (-2) ** -3 in integers


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_compare_matches_reference_over_dtypes(a, b):
    _check_op("compare", [_LHS[a], _RHS[b]], [a, b], {"direction": "LT"})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ["EQ", "NE", "LT", "LE", "GT", "GE"])
def test_compare_directions_match_reference(direction, dtype):
    _check_op("compare", [_LHS[dtype], _RHS[dtype]], [dtype, dtype],
              {"direction": direction})


_SELECT = [(p, "f32", "f32") for p in DTYPES] + \
    [("bool", a, b) for a, b in PAIRS if (a, b) != ("f32", "f32")]


@pytest.mark.parametrize("pred,a,b", _SELECT,
                         ids=["-".join(c) for c in _SELECT])
def test_select_matches_reference(pred, a, b):
    _check_op("select", [_LHS[pred], _LHS[a], _RHS[b]], [pred, a, b])


_CONVERT_SRC = {
    "f32": np.array([np.nan, 3e10, -3e10, 2.7, -2.7, 2147483520.0, -0.0,
                     1.00390625], np.float32),
    "bf16": np.array([np.nan, 2.0 ** 34, -(2.0 ** 34), 2.75, -2.75, np.inf,
                      -0.0, 1.0078125], np.float32),
    "i32": np.array([16842753, 16777217, 2 ** 31 - 1, -2 ** 31, -16842755,
                     0, 1, -7], np.int32),
    "bool": _LHS["bool"],
}


@pytest.mark.parametrize("src,dst", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_convert_matches_reference(src, dst):
    """XLA's conversions: float -> i32 saturates and sends NaN to 0.  From
    i32 to bf16 above 2**24, XLA's CPU loop rounds through f32 (16842753 ->
    16777216) in its vector body and once in its scalar tail (-> 16908288),
    so the reference's own bits depend on the length; the port rounds
    through f32, and is held there to one bf16 step (relative 2**-7)."""
    _check_op("convert", [_CONVERT_SRC[src]], [src], {"new_dtype": dst},
              exact=(src, dst) != ("i32", "bf16"))


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_dot_general_matches_reference(a, b):
    """Batch dims first, then lhs free, then rhs free, over dtype pairs."""
    rng = np.random.default_rng(1)

    def arr(dtype, shape):
        x = rng.integers(-3, 4, size=shape)
        return x.astype({"f32": np.float32, "bf16": np.float32,
                         "i32": np.int32, "bool": bool}[dtype])

    lhs, rhs = arr(a, (2, 3, 4, 5)), arr(b, (5, 2, 6, 3))
    dims = (((3, 1), (0, 3)), ((0,), (1,)))    # contract 5 and 3, batch 2
    _check_op("dot", [lhs, rhs], [a, b], {"dims": dims}, exact=False)


_REDUCE_DIMS = [(0,), (1,), (0, 1), ()]


@pytest.mark.parametrize("dims", _REDUCE_DIMS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("opcode", ["reduce_sum", "reduce_max"])
def test_reductions_match_reference(opcode, dtype, dims):
    """bool sums to i32; an empty dim list reduces nothing."""
    x = np.concatenate([_LHS[dtype][[0, 1, 2, 3, 6, 7]],
                        _RHS[dtype][:6]]).reshape(3, 4)
    _check_op(opcode, [x], [dtype], {"dims": dims})


_PADS = [((1, 2), (0, 1)), ((-1, 2), (1, -2)), ((-3, 0), (6, 1))]


@pytest.mark.parametrize("low,high", _PADS, ids=["grow", "crop", "overcrop"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pad_matches_reference(dtype, low, high):
    """Negative low/high crop; a crop past the edge leaves only padding."""
    x = _LHS[dtype].reshape(2, 4)
    _check_op("pad", [x], [dtype], {"low": low, "high": high, "value": 1.5})


@pytest.mark.parametrize("dtype", DTYPES)
def test_data_movers_match_reference(dtype):
    x = np.concatenate([_LHS[dtype], _RHS[dtype],
                        _LHS[dtype][::-1]]).reshape(2, 3, 4)
    _check_op("slice", [x], [dtype],
              {"start": (0, 1, 0), "limit": (2, 3, 4), "strides": (1, 1, 3)})
    _check_op("transpose", [x], [dtype], {"permutation": (2, 0, 1)})
    _check_op("reshape", [x], [dtype], {"new_shape": (4, 6)})
    _check_op("broadcast_in_dim", [x[:, :1, :]], [dtype],
              {"shape": (2, 4, 5, 3), "broadcast_dimensions": (0, 2, 3)})
    assert _check_op("broadcast_in_dim", [x[:, :1, :]], [dtype],
                     {"shape": (4, 2, 5, 3), "broadcast_dimensions": (1, 3, 0)}
                     ) is TypeError
    _check_op("broadcast_in_dim", [x[0, 0, :1].reshape(())], [dtype],
              {"shape": (2, 3), "broadcast_dimensions": ()})


_CONV_DTYPES = [(d, d) for d in DTYPES] + [("f32", "bf16"), ("i32", "f32")]


@pytest.mark.parametrize("x_dtype,w_dtype", _CONV_DTYPES,
                         ids=[f"{a}-{b}" for a, b in _CONV_DTYPES])
def test_conv_dtypes_match_reference(x_dtype, w_dtype):
    """Each dtype convolves to itself; two dtypes raise."""
    rng = np.random.default_rng(2)
    x = rng.integers(-2, 3, size=(2, 5, 5, 4))
    w = rng.integers(-2, 3, size=(3, 3, 2, 4))
    cast = {"f32": np.float32, "bf16": np.float32, "i32": np.int32,
            "bool": bool}
    _check_op("conv", [x.astype(cast[x_dtype]), w.astype(cast[w_dtype])],
              [x_dtype, w_dtype],
              {"strides": (2, 1), "padding": "SAME",
               "feature_group_count": 2}, exact=False)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("opcode", ["max_pool", "avg_pool"])
def test_pool_dtypes_match_reference(opcode, dtype, padding):
    """Padded max_pool cells hold the dtype's lowest value (True for bool);
    avg_pool of bool raises and of i32 is f32."""
    x = np.concatenate([_LHS[dtype], _RHS[dtype]] * 3)[:45]
    x = np.where(np.isnan(x), 0, x).astype(x.dtype) \
        if x.dtype == np.float32 else x
    _check_op(opcode, [x.reshape(1, 5, 3, 3)], [dtype],
              {"window": (2, 2), "strides": (2, 1), "padding": padding})


def _same_padding_program(builder_cls, size, stride, k, depthwise, kind):
    b = builder_cls("same")
    c = 4
    x = b.input("x", (2, size, size, c))
    if kind == "conv":
        w = b.const(np.random.default_rng(3).standard_normal(
            (k, k, 1 if depthwise else c, c)).astype(np.float32))
        y = b.conv2d(x, w, strides=(stride, stride), padding="SAME",
                     groups=c if depthwise else 1)
    else:
        y = b.op(kind, [x], window=(k, k), strides=(stride, stride),
                 padding="SAME")
    b.output(y)
    return b.done()


_SAME = list(itertools.product((7, 8), (1, 2), (1, 2, 3), (False, True)))


@pytest.mark.parametrize("size,stride,k,depthwise", _SAME,
                         ids=[f"n{n}-s{s}-k{k}-{'dw' if d else 'full'}"
                              for n, s, k, d in _SAME])
def test_conv_same_padding_matches_reference(size, stride, k, depthwise):
    """XLA pads SAME asymmetrically at stride 2 (the extra cell high),
    odd and even sizes, full and depthwise: relative 1e-5."""
    x = np.random.default_rng(4).standard_normal(
        (2, size, size, 4)).astype(np.float32)
    want = ref_interp.jit_program(_same_padding_program(
        RefBuilder, size, stride, k, depthwise, "conv"))({"x": x})[0]
    got = interp.evaluate(_same_padding_program(
        Builder, size, stride, k, depthwise, "conv"), {"x": x}, "cpu")[0]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


_POOL_SAME = list(itertools.product(("max_pool", "avg_pool"), (7, 8),
                                    (1, 2), (2, 3)))


@pytest.mark.parametrize("kind,size,stride,k", _POOL_SAME,
                         ids=[f"{p}-n{n}-s{s}-k{k}"
                              for p, n, s, k in _POOL_SAME])
def test_pool_same_padding_matches_reference(kind, size, stride, k):
    """SAME pools: max over -inf padding, average over the full window."""
    x = np.random.default_rng(5).standard_normal(
        (2, size, size, 4)).astype(np.float32) - 2.0
    want = ref_interp.jit_program(_same_padding_program(
        RefBuilder, size, stride, k, False, kind))({"x": x})[0]
    got = interp.evaluate(_same_padding_program(
        Builder, size, stride, k, False, kind), {"x": x}, "cpu")[0]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_constants_match_reference(dtype):
    """Constants as the builder stores them, and a float64 array: jnp
    rounds it through f32 (1.0039062500001 -> 1.0 in bf16), and so does
    the port."""
    value = np.array([1.0000001, 1.00390625, 1.0039062500001, -2.5, 3.0e38,
                      0.0], np.float64)
    for v in (value, value.astype(np.float32)):
        op = {"value": v, "dtype": dtype}
        want = jax.jit(lambda: jnp.asarray(v, dtype=JNP[dtype]))()
        got = interp.constant(op["value"], dtype, "cpu")
        assert NAMES[got.dtype] == str(want.dtype)
        np.testing.assert_array_equal(_numpy(got), _numpy(want))


# --------------------------------------------------------------------------
# random programs and mutants (strategies of tests/test_analysis_props.py)
# --------------------------------------------------------------------------

def _base_program(builder_cls):
    b = builder_cls("mlp")
    x = b.input("x", (4, 8))
    w1 = b.const(np.random.RandomState(0).randn(8, 16).astype(np.float32))
    h = b.relu(b.dot(x, w1))
    w2 = b.const(np.random.RandomState(1).randn(16, 6).astype(np.float32))
    b.output(b.softmax(b.dot(h, w2)))
    return b.done()


def _random_mutant(program, seed, edits_mod, max_edits=4):
    rng = np.random.default_rng(seed)
    p = program
    for _ in range(int(rng.integers(0, max_edits + 1))):
        try:
            e = edits_mod.sample_edit(p, rng)
            p = edits_mod.Patch((e,)).apply(p)
        except edits_mod.EditError:
            continue
    return p


def _check_programs(ref_prog, prog, inputs):
    """Both interpreters on one program: same raise or no-raise, same
    dtypes and shapes, outputs within relative 1e-4."""
    assert serialize.program_fingerprint(prog) == \
        ref_serialize.program_fingerprint(ref_prog)
    try:
        want = ref_interp.jit_program(ref_prog)(inputs)
    except Exception:
        with pytest.raises(Exception):
            interp.evaluate(prog, inputs, "cpu")
        return
    got = interp.evaluate(prog, inputs, "cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert NAMES[g.dtype] == str(w.dtype)
        g, w = _numpy(g), _numpy(w)
        assert g.shape == w.shape
        finite = np.abs(w[np.isfinite(w)]) if w.dtype != bool else w
        scale = float(finite.max()) if finite.size else 1.0
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * max(scale, 1),
                                   equal_nan=True)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 10_000))
def test_random_mlp_mutants_match_reference(seed):
    ref_prog = _random_mutant(_base_program(RefBuilder), seed, ref_edits)
    prog = _random_mutant(_base_program(Builder), seed, edits)
    x = np.random.default_rng(seed).standard_normal((4, 8)).astype(
        np.float32)
    _check_programs(ref_prog, prog, {"x": x})


_STEP = dict(batch=8, hidden=16)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 10_000))
def test_random_training_step_mutants_match_reference(seed):
    """Mutants of the 2fcNet SGD step (compare/select, bool masks, the
    backward dots): the validity gate and the new weights agree."""
    from repro_torch.workloads.twofc import build_twofc_step as port_step
    ref_prog = _random_mutant(build_twofc_step(**_STEP), seed, ref_edits)
    prog = _random_mutant(port_step(**_STEP), seed, edits)
    rng = np.random.default_rng(seed)
    inputs = {"w1": rng.standard_normal((784, 16), dtype=np.float32) * 0.05,
              "b1": rng.standard_normal(16, dtype=np.float32),
              "w2": rng.standard_normal((16, 10), dtype=np.float32) * 0.3,
              "b2": rng.standard_normal(10, dtype=np.float32),
              "x": rng.standard_normal((8, 784), dtype=np.float32),
              "y_onehot": np.eye(10, dtype=np.float32)[
                  rng.integers(0, 10, 8)]}
    _check_programs(ref_prog, prog, inputs)


# --------------------------------------------------------------------------
# the executor: device rule, flags, input checks
# --------------------------------------------------------------------------

def test_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    prog = _base_program(Builder)
    x = np.zeros((4, 8), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interp.evaluate(prog, {"x": x})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interp.jit_program(prog)
    fn = interp.jit_program(prog, "cpu")
    assert fn.device == torch.device("cpu") and fn.input_names == ("x",)
    assert fn({"x": x})[0].shape == (4, 6)


def test_cpu_path_prepares_vector_math(monkeypatch):
    import repro_torch.device as device
    calls = []
    monkeypatch.setattr(device, "init_vector_math", lambda: calls.append(1))
    interp.jit_program(_base_program(Builder), "cpu")
    assert calls == [1]


def test_calls_restore_the_callers_flags():
    """A call runs with TF32 off and cuDNN deterministic, and leaves the
    caller's settings as they were."""
    cudnn = torch.backends.cudnn
    cudnn.conv.fp32_precision = "tf32"
    cudnn.deterministic, cudnn.benchmark = False, True
    seen = []
    with interp.full_f32():
        seen.append((cudnn.conv.fp32_precision,
                     torch.backends.cuda.matmul.fp32_precision,
                     cudnn.deterministic, cudnn.benchmark))
    interp.evaluate(_base_program(Builder), {"x": np.ones((4, 8),
                                                          np.float32)}, "cpu")
    assert seen == [("ieee", "ieee", True, False)]
    assert (cudnn.conv.fp32_precision, cudnn.deterministic,
            cudnn.benchmark) == ("tf32", False, True)


def test_inputs_are_checked_and_cast():
    prog = _base_program(Builder)
    fn = interp.jit_program(prog, "cpu")
    with pytest.raises(KeyError, match="missing program input"):
        fn({})
    with pytest.raises(ValueError, match="shape"):
        fn({"x": np.zeros((4, 9), np.float32)})
    # a float64 or integer input is cast to the declared f32, as jnp does
    out64 = fn({"x": np.ones((4, 8))})[0]
    out32 = fn({"x": torch.ones((4, 8), dtype=torch.int32)})[0]
    assert out64.dtype == out32.dtype == torch.float32
    assert torch.equal(out64, out32)
