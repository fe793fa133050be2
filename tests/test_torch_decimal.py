"""DECIMAL128 in the PyTorch port: the limb math, the five Spark-exact ops,
the `DecimalUtils` facade and the entry step, against Python integers, the
JAX package and the reference's golden vectors.

Every comparison is bit-exact (no tolerance): the limbs of every row, null
rows included, the overflow flags and the validity. On these CPU tensors
the ops run their plain version (`decimal_utils.*_plain` over
`decimal256`); the decimal kernel's own tests need the card
(`tests/test_torch_cuda.py`).
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import decimal
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from spark_rapids_tpu import api as japi
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.ops import decimal_utils as jdu

from spark_rapids_tpu_torch import api, dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column, Table
from spark_rapids_tpu_torch.entry import decimal_limbs, entry
from spark_rapids_tpu_torch.ops import copying, decimal_cuda
from spark_rapids_tpu_torch.ops import decimal256 as d256
from spark_rapids_tpu_torch.ops import decimal_utils as du
from spark_rapids_tpu_torch.ops import gather, hash as thash, join, sort
from spark_rapids_tpu_torch.plan import stats as torch_stats


@pytest.fixture(autouse=True, scope="module")
def _no_torch_stats_store():
    """No stats store for the port's runs: the static engine, as the
    reference's runs are with its store off (a shared store would make
    attempts, caps and optimizer decisions depend on the file order)."""
    with torch_stats.scoped_store(None):
        yield

M256 = (1 << 256) - 1
EDGE = [0, 1, -1, 10**38 - 1, -(10**38 - 1), 10**38, -(10**38), 2**127,
        -(2**127), (1 << 255) - 1, -((1 << 255) - 1)]


def signed256(u):
    u &= M256
    return u - (1 << 256) if u >= (1 << 255) else u


def _pairs(seed, n=120):
    """Random 256-bit pairs, then every edge value against every other."""
    rng = random.Random(seed)
    a = [rng.randrange(-(1 << 255), 1 << 255) for _ in range(n)]
    b = [rng.randrange(-(1 << 255), 1 << 255) for _ in range(n)]
    a += [x for x in EDGE for _ in EDGE]
    b += EDGE * len(EDGE)
    return a, b


# ---- the limb primitives against Python ints --------------------------------

@pytest.mark.parametrize("name", ["add", "sub", "multiply", "negate",
                                  "abs", "lt", "shift"])
def test_limb_primitive_equals_python_ints(name):
    a, b = _pairs(1)
    A, B = d256.from_int(a, device="cpu"), d256.from_int(b, device="cpu")
    assert d256.to_int(A) == a and d256.to_int(B) == b
    if name == "add":
        assert d256.to_int(d256.add(A, B)) == [signed256(x + y)
                                               for x, y in zip(a, b)]
    elif name == "sub":
        assert d256.to_int(d256.sub_unsigned(A, B)) == [
            signed256(x - y) for x, y in zip(a, b)]
    elif name == "multiply":
        assert d256.to_int(d256.multiply(A, B)) == [signed256(x * y)
                                                    for x, y in zip(a, b)]
    elif name == "negate":
        assert d256.to_int(d256.negate(A)) == [signed256(-x) for x in a]
    elif name == "abs":
        mag, neg = d256.abs_(A)
        assert d256.to_int(mag) == [signed256(abs(x)) for x in a]
        assert neg.tolist() == [x < 0 for x in a]
    elif name == "lt":
        assert d256.lt_unsigned(A, B).tolist() == [
            (x & M256) < (y & M256) for x, y in zip(a, b)]
        assert d256.gte_unsigned(A, B).tolist() == [
            (x & M256) >= (y & M256) for x, y in zip(a, b)]
    else:
        assert d256.to_int(d256.shift_left1(A)) == [signed256(x << 1)
                                                    for x in a]


def test_i128_limbs_sign_extend_and_truncate():
    vals = [0, 1, -1, 10**38 - 1, -(10**38 - 1), 2**127 - 1, -(2**127)]
    c = Column.from_pylist(vals, tdt.decimal(38, 0), device="cpu")
    wide = d256.from_i128_limbs(c.data)
    assert d256.to_int(wide) == vals
    assert torch.equal(d256.to_i128_limbs(wide), c.data)


def test_precision10_and_overflow_check():
    vals = [0, 1, 9, 10, 11, 99, 100, 101, 10**38 - 1, 10**38, 10**38 + 1,
            -(10**38), 10**75, 10**76, 10**76 + 1, (1 << 255) - 1,
            -(1 << 255), 2**127, -(2**127)]
    got = d256.precision10(d256.from_int(vals, device="cpu")).tolist()
    # first i in [0, 76] with 10^i >= |v|, 77 if none (reference definition)
    want = [next((i for i in range(77) if 10**i >= abs(v)), 77)
            for v in vals]
    assert got == want
    assert d256.is_greater_than_decimal_38(
        d256.from_int(vals, device="cpu")).tolist() == \
        [abs(v) >= 10**38 for v in vals]


@pytest.mark.parametrize("seed", [9, 10])
def test_divide_equals_python_ints(seed):
    """Truncating division: the quotient toward zero, the remainder with the
    dividend's sign; HALF_UP and DOWN from it."""
    rng = random.Random(seed)
    cases = [(rng.randrange(-(10**60), 10**60),
              rng.randrange(1, 10**30) * rng.choice([1, -1]))
             for _ in range(60)]
    cases += [(7, 2), (-7, 2), (7, -2), (-7, -2), (0, 5), (10**70, 3),
              ((1 << 255) - 1, 10**38), (-((1 << 255) - 1), -(10**38 - 1)),
              (2**127, -1), (10**38, 10**38 - 1)]
    N = d256.from_int([c[0] for c in cases], device="cpu")
    D = d256.from_int([c[1] for c in cases], device="cpu")
    q, r = d256.divide(N, D)
    qi, ri = d256.to_int(q), d256.to_int(r)
    rounded = d256.to_int(d256.divide_and_round(N, D))
    down = d256.to_int(d256.integer_divide(N, D))
    for i, (n, d) in enumerate(cases):
        sign = 1 if (n < 0) == (d < 0) else -1
        want_q = abs(n) // abs(d) * sign
        want_r = abs(n) % abs(d) * (1 if n >= 0 else -1)
        assert (qi[i], ri[i]) == (want_q, want_r), (n, d)
        assert down[i] == want_q
        up = 1 if 2 * (abs(n) % abs(d)) >= abs(d) else 0
        assert rounded[i] == (abs(n) // abs(d) + up) * sign, (n, d)


def test_divide_by_zero_steps_as_the_reference():
    q, r = d256.divide_unsigned(d256.from_int([12345], device="cpu"),
                                d256.from_int([0], device="cpu"))
    assert d256.to_int(q) == [-1] and d256.to_int(r) == [12345]


# ---- the five ops against the JAX package -----------------------------------

_EDGE128 = [0, 1, -1, 5, -5, 10**38 - 1, -(10**38 - 1), 10**38, -(10**38),
            2**127 - 1, -(2**127), 10**19, -(10**19)]


def _values(rng, n):
    """38-digit, 19-digit and small values, and 128-bit edge values."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.15:
            out.append(_EDGE128[rng.integers(len(_EDGE128))])
        elif r < 0.45:
            out.append(int(rng.integers(-(10**18), 10**18)) * 10**20
                       + int(rng.integers(0, 10**18)))
        elif r < 0.7:
            out.append(int(rng.integers(-(10**18), 10**18)) * 10
                       + int(rng.integers(0, 10)))
        else:
            out.append(int(rng.integers(-(10**6), 10**6)))
    return out


def _columns(seed, sa, sb, n=40):
    """The same seeded limbs as a JAX and a port column pair: nulls on the
    left, every seventh divisor zero."""
    rng = np.random.default_rng(seed)
    av, bv = _values(rng, n), _values(rng, n)
    bv[::7] = [0] * len(bv[::7])
    A, B = (Column.from_pylist(v, tdt.decimal(38, 0), device="cpu")
            .data.numpy() for v in (av, bv))
    valid = rng.random(n) > 0.15
    ja = JColumn(dtype=jdt.DType(jdt.Kind.DECIMAL128, 38, sa), length=n,
                 data=jnp.asarray(A), validity=jnp.asarray(valid))
    jb = JColumn(dtype=jdt.DType(jdt.Kind.DECIMAL128, 38, sb), length=n,
                 data=jnp.asarray(B))
    ta = Column.from_numpy(A, tdt.DType(tdt.Kind.DECIMAL128, 38, sa), valid,
                           device="cpu")
    tb = Column.from_numpy(B, tdt.DType(tdt.Kind.DECIMAL128, 38, sb),
                           device="cpu")
    return (ja, jb), (ta, tb)


def _same(jcols, tcols):
    """Two (overflow, result) pairs equal bit for bit: data of every row,
    dtype, validity."""
    for j, t in zip(jcols, tcols):
        assert t.dtype.kind.value == j.dtype.kind.value
        assert (t.dtype.precision, t.dtype.scale) == (j.dtype.precision,
                                                      j.dtype.scale)
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        if j.validity is None:
            assert t.validity is None
        else:
            np.testing.assert_array_equal(t.validity.numpy(),
                                          np.asarray(j.validity))


# (op, a scale, b scale, output scale, flag); the comment names the branch
OP_CASES = [
    ("add", 2, 2, 2, False),          # no rescale
    ("add", 2, 5, 5, False),          # a multiplied up to the finer scale
    ("add", 10, 3, 6, False),         # the sum divided down, HALF_UP
    ("add", 0, 38, 38, False),        # a 38-digit shift
    ("sub", 2, 5, 3, True),           # subtract, then rounded
    ("multiply", 2, 2, 4, True),      # exponent 0 (the entry's)
    ("multiply", 10, 10, 6, True),    # SPARK-40129 interim rounding
    ("multiply", 10, 10, 6, False),   # no interim cast
    ("multiply", 0, 0, 2, True),      # exponent < 0: scaled up, 38 checked
    ("multiply", -1, 0, 1, True),     # a negative input scale
    ("divide", 10, 2, 2, False),      # n_shift_exp > 0: divide twice
    ("divide", 0, 38, 6, False),      # n_shift_exp < -38: base 10^38
    ("divide", 10, 10, 6, False),     # -38 <= n_shift_exp < 0
    ("divide", 2, 2, 0, False),       # n_shift_exp == 0
    ("divide", 2, 2, 0, True),        # integer divide, INT64 low bits
    ("divide", 4, 1, 0, True),        # integer divide, n_shift_exp > 0
    ("divide", 0, 38, 6, True),       # integer divide, n_shift_exp < -38
    ("remainder", 2, 5, 3, False),    # d_shift_exp > 0: divisor rounded
    ("remainder", 2, 1, 3, False),    # d_shift_exp < 0, n_shift_exp > 0
    ("remainder", 1, 1, 1, False),    # both shifts 0
    ("remainder", 0, 5, 3, False),    # d_shift_exp > 0, n_shift_exp < 0
]


def _jax_run(op, a, b, scale, flag):
    """The JAX package's op as `decimal_utils.decimal128_op` names it."""
    if op in ("add", "sub"):
        return jdu.add_decimal128(a, b, scale, is_sub=op == "sub")
    if op == "multiply":
        return jdu.multiply_decimal128(a, b, scale, cast_interim_result=flag)
    if op == "divide":
        return jdu.divide_decimal128(a, b, scale, is_int_div=flag)
    return jdu.remainder_decimal128(a, b, scale)


@pytest.mark.parametrize("op,sa,sb,so,flag", OP_CASES)
def test_op_equals_the_jax_package(op, sa, sb, so, flag):
    (ja, jb), (ta, tb) = _columns(OP_CASES.index((op, sa, sb, so, flag)),
                                  sa, sb)
    decimal_cuda.reset_counters()
    got = du.decimal128_op(op, ta, tb, so, flag)
    _same(_jax_run(op, ja, jb, so, flag), got)
    key = "divide" if op == "divide" else op
    assert du.PLAIN_CALLS[key] == 1 and sum(du.LAUNCHES.values()) == 0
    # the overflow and division-by-zero paths were reached
    assert bool(got[0].data.any())


def test_nulls_combine_and_stay_computed():
    a = Column.from_pylist([10, None, 7], tdt.decimal(38, 1), device="cpu")
    b = Column.from_pylist([None, 20, 2], tdt.decimal(38, 1), device="cpu")
    o, r = du.add_decimal128(a, b, 1)
    assert r.to_pylist() == [None, None, 9] and o.to_pylist() == [None,
                                                                  None,
                                                                  False]
    # a null row's data is computed as the reference computes it (0 + 20)
    assert r.data[1].tolist() == [20, 0, 0, 0]
    clean = Column.from_pylist([1, 2, 3], tdt.decimal(38, 1), device="cpu")
    o, r = du.multiply_decimal128(clean, clean, 2)
    assert o.validity is None and r.validity is None


# ---- the kernel's own row arithmetic, compiled for the host -----------------

_HOST_HARNESS = r"""
#include "decimal128.cu"
extern "C" void host_op(int op, const uint64_t* a, const uint64_t* b,
                        long long n, int sa, int sb, int so, int flag,
                        uint64_t* out, unsigned char* ovf) {
  const Params p = {sa, sb, so, flag};
  for (long long i = 0; i < n; ++i) {
    uint64_t lo, hi;
    bool o;
    const uint64_t *x = a + 2 * i, *y = b + 2 * i;
#define ROW(K) row_op<K>(x[0], x[1], y[0], y[1], p, lo, hi, o)
    if (op == OP_ADD) ROW(OP_ADD);
    else if (op == OP_MUL) ROW(OP_MUL);
    else if (op == OP_DIV) ROW(OP_DIV);
    else ROW(OP_REM);
    out[2 * i] = lo;
    out[2 * i + 1] = hi;
    ovf[i] = o;
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/decimal128.cu's row functions built with the host's C++
    compiler (the source compiles without nvcc, minus the launch)."""
    import ctypes
    import pathlib
    import shutil
    import subprocess
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "arithmetic")
    csrc = pathlib.Path(decimal_cuda.__file__).parent / "csrc"
    d = tmp_path_factory.mktemp("decimal_host")
    (d / "harness.cpp").write_text(_HOST_HARNESS)
    lib = d / "libdecimal_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{csrc}", "-x", "c++",
                    str(d / "harness.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    h = ctypes.CDLL(str(lib))
    h.host_op.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong] + [ctypes.c_int] * 4
                          + [ctypes.c_void_p, ctypes.c_void_p])
    return h


@pytest.mark.parametrize("op,sa,sb,so,flag", OP_CASES)
def test_kernel_row_arithmetic_equals_plain_version(host_kernel, op, sa, sb,
                                                    so, flag):
    """The kernel's source, every op and branch, against the plain version
    on the same rows, bit for bit: result limbs (or INT64) and overflow."""
    _, (ta, tb) = _columns(100 + OP_CASES.index((op, sa, sb, so, flag)),
                           sa, sb, n=300)
    x = np.ascontiguousarray(ta.data.numpy())
    y = np.ascontiguousarray(tb.data.numpy())
    n = ta.length
    out = np.zeros((n, 2), np.uint64)
    ovf = np.zeros(n, np.uint8)
    host_kernel.host_op(decimal_cuda._OPS[op], x.ctypes.data, y.ctypes.data,
                        n, sa, sb, so, int(flag), out.ctypes.data,
                        ovf.ctypes.data)
    want_ovf, want = du.decimal128_op(op, ta, tb, so, flag)
    np.testing.assert_array_equal(ovf.astype(bool), want_ovf.data.numpy())
    if op == "divide" and flag:
        np.testing.assert_array_equal(out[:, 0].view(np.int64),
                                      want.data.numpy())
    else:
        np.testing.assert_array_equal(out.view(np.uint32).reshape(n, 4),
                                      want.data.numpy())


# ---- golden vectors (DecimalUtilsTest.java, as tests/test_decimal.py has them

def dcol(strs):
    """A decimal(38, s) port column from decimal strings of one scale."""
    scales, unscaled = set(), []
    for s in strs:
        sign, digits, exp = decimal.Decimal(s).as_tuple()
        unscaled.append(int("".join(map(str, digits))) * (-1 if sign else 1))
        scales.add(-exp)
    assert len(scales) == 1, f"mixed scales {scales}"
    return Column.from_pylist(unscaled, tdt.DType(tdt.Kind.DECIMAL128, 38,
                                                  scales.pop()),
                              device="cpu")


def unscaled(s):
    sign, digits, exp = decimal.Decimal(s).as_tuple()
    return int("".join(map(str, digits))) * (-1 if sign else 1), -exp


GOLDEN = [
    ("multiply", ["1.0", "10.0", "1000000000000000000000000000000000000.0"],
     ["1", "1", "1"], 1, True,
     ["1.0", "10.0", "1000000000000000000000000000000000000.0"], [False] * 3),
    ("multiply", ["1.0", "3.7"], ["1.0", "1.5"], 1, True, ["1.0", "5.6"],
     [False, False]),
    ("multiply", ["1"], ["1e1"], 1, True, ["10.0"], [False]),
    ("multiply", ["-8533444864753048107770677711.1312637916"],
     ["-12.0000000000"], 6, False,
     ["102401338377036577293248132533.575165"], [False]),
    ("multiply", ["577694940161436285811555447.3103121126"],
     ["100.0000000000"], 6, True,
     ["57769494016143628581155544731.031211"], [False]),
    ("multiply", ["577694938495380589068894346.7625198736"],
     ["-1258508260891400005608241690.1564700995"], 6, True, None, [True]),
    ("multiply", ["3358377338823096511784947656.4650294583",
                  "7161021785186010157110137546.5940777916",
                  "9173594185998001607642838421.5479932913"],
     ["-12.0000000000"] * 3, 6, True,
     ["-40300528065877158141419371877.580354",
      "-85932261422232121885321650559.128933",
      "-110083130231976019291714061058.575920"], [False] * 3),
    ("divide", ["1.0", "10.0", "1.0",
                "1000000000000000000000000000000000000.0"],
     ["1", "2", "0", "5"], 1, False,
     ["1.0", "5.0", "0", "200000000000000000000000000000000000.0"],
     [False, False, True, False]),
    ("divide", ["1.0", "-3.7", "-99.9"], ["-1.0", "1.5", "-4.5"], 1, False,
     ["-1.0", "-2.5", "22.2"], [False] * 3),
    ("divide", ["100000000000000000000000000000000"],
     ["3.0000000000000000000000000000000000000"], 6, False,
     ["33333333333333333333333333333333.333333"], [False]),
    ("divide", ["1454.48287885760884146", "3655.54438423288356646"],
     ["100.00000000000000000", "100.00000000000000000"], 17, False,
     ["14.54482878857608841", "36.55544384232883566"], [False] * 2),
    ("divide", ["60250054953505368.439892586764888491018",
                "91910085134512953.335347579448489062875",
                "51312633107598808.869351260608653423886"],
     ["97982875273794447.385070145919990343867",
      "94478503341597285.814104936062234698349",
      "92266075543848323.800466593082956765923"], 6, False,
     ["0.614904", "0.972815", "0.556138"], [False] * 3),
    ("add", ["9191008513307131620269245301.1615457290",
             "-9191008513307131620269245301.1615457290"],
     ["9447850332473678680446404122.5624623187",
      "-9447850332473678680446404122.5624623187"], 10, False, None,
     [True, True]),
    ("add", ["1.5", "-2.5"], ["2.5", "0.5"], 1, False, ["4.0", "-2.0"],
     [False, False]),
    ("add", ["1.50"], ["2.5555"], 4, False, ["4.0555"], [False]),
    ("sub", ["5.0"], ["7.5"], 1, True, ["-2.5"], [False]),
    ("remainder", ["2775750723350045263458396405825339066"] * 2
     + ["-2775750723350045263458396405825339066"] * 2,
     ["-4890990637589340307512622401149178814.1",
      "4890990637589340307512622401149178814.1"] * 2, 1, False,
     ["2775750723350045263458396405825339066.0"] * 2
     + ["-2775750723350045263458396405825339066.0"] * 2, [False] * 4),
    ("remainder", ["7.0", "-7.0", "7.0", "-7.0"],
     ["2.0", "2.0", "-2.0", "-2.0"], 1, False,
     ["1.0", "-1.0", "1.0", "-1.0"], [False] * 4),
]


@pytest.mark.parametrize("op,a,b,scale,flag,want,want_ovf", GOLDEN)
def test_golden_vectors(op, a, b, scale, flag, want, want_ovf):
    o, r = du.decimal128_op(op, dcol(a), dcol(b), scale, flag)
    assert o.to_pylist() == want_ovf
    if want is not None:
        got = r.to_pylist()
        for i, s in enumerate(want):
            if not want_ovf[i]:
                assert (got[i], r.dtype.scale) == unscaled(s), (i, s)


@pytest.mark.parametrize("a,b,want,want_ovf", [
    (["3396191716868766147341919609.06", "-6893798181986328848375556144.67"],
     ["7317548469.64", "98565515088.44"],
     [464116053478747633, -69941278912819784], [False, False]),
    # the overflow is judged on the 128-bit value, not the long
    (["451635271134476686911387864.48", "5313675970270560086329837153.18"],
     ["-961.110", "181.958"],
     [2284624887606872042, -2928582767902049472], [False, False]),
    (["-999999999999999999999999999999999999.99",
      "999999999999999999999999999999999999.99"], ["0", "0"], None,
     [True, True]),
])
def test_golden_integer_divide(a, b, want, want_ovf):
    o, r = du.divide_decimal128(dcol(a), dcol(b), 0, is_int_div=True)
    assert o.to_pylist() == want_ovf and r.dtype == tdt.INT64
    if want is not None:
        assert r.to_pylist() == want


# ---- the facade, the entry step ---------------------------------------------

@pytest.mark.parametrize("method,args", [
    ("multiply128", (6,)), ("multiply128", (6, False)), ("divide128", (6,)),
    ("integerDivide128", ()), ("remainder128", (3,)), ("add128", (4,)),
    ("subtract128", (4,))])
def test_decimal_utils_facade_equals_the_jax_facade(method, args):
    (ja, jb), (ta, tb) = _columns(len(method) + len(args), 4, 2, n=24)
    _same(getattr(japi.DecimalUtils, method)(ja, jb, *args),
          getattr(api.DecimalUtils, method)(ta, tb, *args))


def test_entry_step_equals_the_jax_entry():
    """The port's `entry()` step and `jax.jit` of the JAX entry's step on
    the same arrays: h32, h64, product limbs and overflow all equal."""
    step, (keys, vals) = entry(device="cpu")
    jstep, (jkeys, jvals) = __graft_entry__.entry()
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    got = step(keys, vals)
    want = jax.jit(jstep)(jkeys, jvals)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    v = vals.numpy()
    assert [int(x) for x in v[:64]] == \
        Column(tdt.decimal(38, 2), 64, decimal_limbs(vals[:64])).to_pylist()


# ---- the substrate around the limbs -----------------------------------------

def test_decimal_columns_gather_and_keys_raise_by_item():
    vals = [10**38 - 1, None, -(10**38 - 1), 0, 12345]
    c = Column.from_pylist(vals, tdt.decimal(38, 2), device="cpu")
    assert c.dtype.kind == tdt.Kind.DECIMAL128 and c.data.shape == (5, 4)
    assert c.nbytes() == 5 * 16 + 5
    idx = torch.tensor([4, -1, 0, 2], dtype=torch.int64)
    assert gather.take(c, idx).to_pylist() == [12345, None, 10**38 - 1,
                                                -(10**38 - 1)]
    t = Table([c], ["d"])
    # a DECIMAL128 key sorts and joins as the JAX package's (queue A item 3)
    from spark_rapids_tpu.ops import join as jjoin
    from spark_rapids_tpu.ops import sort as jsort
    jc = JColumn.from_pylist(vals, jdt.decimal(38, 2))
    for asc in (True, False):
        np.testing.assert_array_equal(
            sort.sorted_order(t, asc).data.numpy(),
            np.asarray(jsort.sorted_order([jc], asc).data))
    for got, want in zip(join.inner_join(t, t), jjoin.inner_join([jc], [jc])):
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(want.data))
    # hashed as Java BigDecimal bytes, a null row passing the seed through
    got = thash.murmur_hash3_32([c], 42).to_pylist()
    assert got[1] == 42 and got[3] == thash.murmur_hash3_32(
        [Column.from_pylist([0], tdt.decimal(38, 2), device="cpu")],
        42).to_pylist()[0]
    assert copying.concat_columns([c, c]).to_pylist() == vals + vals
    with pytest.raises(ValueError, match="does not match"):
        Column(tdt.decimal(38, 2), 5, c.data[:, :2].contiguous())
    with pytest.raises(TypeError):
        du.add_decimal128(Column.from_pylist([1], tdt.INT64, device="cpu"),
                          c, 2)
    assert tdt.decimal(19, 2).kind == tdt.Kind.DECIMAL128
    assert tdt.decimal(18, 2).kind == tdt.Kind.DECIMAL64
    with pytest.raises(ValueError):
        tdt.decimal(39, 0)


def test_the_kernel_binding_takes_only_cuda_tensors():
    c = Column.from_pylist([1, 2], tdt.decimal(38, 2), device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        decimal_cuda.launch("multiply", c, c, 4, True)


@pytest.mark.parametrize("mode", ["eager", "capped"])
@pytest.mark.parametrize("optimize", [False, True])
def test_decimal_payload_through_filter_join_and_sort(mode, optimize):
    """A DECIMAL128 column rides through a Filter (FusedSelect when
    optimized), a HashJoin and a Sort as a payload; the capped tier's
    `compact()` gathers its limbs too."""
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col, lit
    n = 50
    rng = np.random.default_rng(0)
    vals = [int(x) * 10**20 + 7 if i % 5 else None
            for i, x in enumerate(rng.integers(-(10**17), 10**17, n))]
    vals[1], vals[2] = 10**38 - 1, -(10**38 - 1)
    fact = Table([
        Column.from_numpy(np.arange(n, dtype=np.int64) % 7, tdt.INT64,
                          device="cpu"),
        Column.from_numpy(np.arange(n, dtype=np.int64), tdt.INT64,
                          device="cpu"),
        Column.from_pylist(vals, tdt.decimal(38, 2), device="cpu")],
        ["k", "x", "amt"])
    dim = Table([Column.from_numpy(np.arange(0, 7, 2, dtype=np.int64),
                                   tdt.INT64, device="cpu")], ["dk"])
    b = PlanBuilder()
    plan = (b.scan("f", ["k", "x", "amt"]).filter(col("x") > lit(0))
            .join(b.scan("d", ["dk"]), "k", "dk").sort(["x"]).build())
    res = PlanExecutor(device="cpu", mode=mode, optimize=optimize).execute(
        plan, {"f": fact, "d": dim})
    got = res.table if mode == "eager" else res.compact()
    assert got["amt"].dtype == tdt.decimal(38, 2)
    assert got["amt"].to_pylist() == [vals[x] for x in range(1, n)
                                      if (x % 7) % 2 == 0]
