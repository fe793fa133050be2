"""The port's row hashes over strings, DECIMAL128, STRUCT and LIST columns
(spark_rapids_tpu_torch/ops/hash.py, hash_cuda.py) against the JAX package
on the CPU, on the same values, bit for bit: murmur3_32 and xxhash64 of
each kind alone, nested with nulls at every level, and chained in mixed
tables; Spark's golden vectors (tests/test_hash.py, from real Spark runs);
the reference's rejections; and the kernel's own row arithmetic
(csrc/row_hash.cu `hash_row`) built with the host's C++ compiler and held
against the plain version. Hashes are integers: the tolerance is exact."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import ctypes
import pathlib
import random
import shutil
import struct
import subprocess

import numpy as np
import numpy.testing as npt
import pytest
import torch

import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.ops import murmur_hash3_32 as j_murmur
from spark_rapids_tpu.ops import xxhash64 as j_xxhash

import spark_hash_oracle as oracle
from test_torch_strings import nested_pair
from spark_rapids_tpu_torch import api, ops
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column
from spark_rapids_tpu_torch.ops import hash as thash
from spark_rapids_tpu_torch.ops import hash_cuda

SEEDS = (0, 42, -7)
F32, F64 = np.finfo(np.float32), np.finfo(np.float64)
I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)

# tests/test_hash.py's Spark vectors: the fifth string holds the unpaired
# UTF-16 surrogates U+D720 U+D721 as Spark stores them (3 bytes each)
PUNCT = ("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~").encode() + \
    "휠휡".encode("utf-8", "surrogatepass")
STRINGS5 = [b"", b"The quick brown fox", b"jumps over the lazy dog.",
            b"All work and no play makes Jack a dull boy", PUNCT]
DEC128_VALS = [
    0, 100, -1,
    int.from_bytes(struct.pack(">QQ", 0xFFFFFFFFFCC4D1C3,
                               0x602F7FC318000001), "big", signed=True),
    int.from_bytes(struct.pack(">QQ", 0x0785EE10D5DA46D9,
                               0x00F4369FFFFFFFFF), "big", signed=True),
]
V8 = [True] * 5 + [False] + [True] * 2    # xxhash64 vectors: row 5 null


def pair(vals, name):
    """The same column from Python values in both packages."""
    jd = {"string": jdt.STRING, "dec": jdt.decimal(38, 11),
          "int32": jdt.INT32, "int64": jdt.INT64, "float32": jdt.FLOAT32,
          "float64": jdt.FLOAT64}[name]
    td = {"string": tdt.STRING, "dec": tdt.decimal(38, 11),
          "int32": tdt.INT32, "int64": tdt.INT64, "float32": tdt.FLOAT32,
          "float64": tdt.FLOAT64}[name]
    return (JColumn.from_pylist(vals, jd),
            Column.from_pylist(vals, td, device="cpu"))


def same(jres, tres):
    npt.assert_array_equal(tres.data.numpy(), np.asarray(jres.data))


def random_bytes(rng, n, max_len=70, null_p=0.15):
    return [None if rng.random() < null_p else
            bytes(rng.randrange(256) for _ in range(rng.randrange(max_len)))
            for _ in range(n)]


EDGE_LENGTHS = (0, 1, 2, 3, 4, 5, 7, 8, 15, 16, 31, 32, 33, 63, 64, 65)


# ---- each kind against the JAX package ---------------------------------------

def test_strings_match_jax():
    rng = random.Random(11)
    vals = random_bytes(rng, 150) + [bytes(range(n)) for n in EDGE_LENGTHS]
    j, t = pair(vals, "string")
    for seed in SEEDS:
        same(j_murmur([j], seed), ops.murmur_hash3_32([t], seed))
        same(j_xxhash([j], seed), ops.xxhash64([t], seed))
        same(j_murmur([j], seed), api.Hash.murmurHash32([t], seed))
        same(j_xxhash([j], seed), api.Hash.xxhash64([t], seed))


def test_decimal128_matches_jax():
    rng = random.Random(12)
    vals = [rng.randrange(-(1 << 127), 1 << 127) for _ in range(80)] + [
        0, 1, -1, 127, 128, -128, -129, 255, 256, -256, -257, None,
        -(1 << 127), (1 << 127) - 1, 10**38 - 1, -(10**38 - 1)] + [
        s * (1 << b) + d for b in range(0, 127, 8) for s in (1, -1)
        for d in (-1, 0)]
    j, t = pair(vals, "dec")
    for seed in SEEDS:
        same(j_murmur([j], seed), ops.murmur_hash3_32([t], seed))
        same(j_xxhash([j], seed), ops.xxhash64([t], seed))
    be, length = thash.java_bigdecimal_bytes(t.data)
    for v, row, k in zip(vals, be.numpy(), length.numpy()):
        assert bytes(row[:k].astype(np.uint8)) == \
            oracle.encode_decimal128(v or 0)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_nested_columns_match_jax(which):
    """STRUCT<LIST<STRING>, STRUCT<INT64, STRING>>, LIST<LIST<INT32>> and
    LIST<STRUCT> (rejected), nulls at every level."""
    jcols, tcols = nested_pair(seed=21, n=60)
    j, t = jcols[which], tcols[which]
    if which == 2:
        for fn in (lambda: j_murmur([j], 42), lambda: j_xxhash([j], 42)):
            with pytest.raises(TypeError):
                fn()
        with pytest.raises(TypeError, match="LIST of STRUCT"):
            ops.murmur_hash3_32([t], 42)
        with pytest.raises(TypeError, match="nested"):
            ops.xxhash64([t], 42)
        return
    for seed in SEEDS:
        same(j_murmur([j], seed), ops.murmur_hash3_32([t], seed))
    with pytest.raises(TypeError, match="nested"):
        ops.xxhash64([t])


def test_lists_of_every_leaf_match_jax():
    rng = np.random.default_rng(13)
    prng = random.Random(13)
    n = 40
    offs = np.concatenate([[0], np.cumsum(rng.integers(0, 5, n))]).astype(
        np.int32)
    m = int(offs[-1])
    lv = rng.random(n) > 0.2
    leaves = {
        "string": random_bytes(prng, m, max_len=40),
        "dec": [None if prng.random() < 0.2 else
                prng.randrange(-(1 << 100), 1 << 100) for _ in range(m)],
        "int32": [None if prng.random() < 0.2 else
                  prng.randrange(-2**31, 2**31) for _ in range(m)],
        "float64": [None if prng.random() < 0.2 else
                    prng.choice([0.0, -0.0, float("nan"), 1.5, -2.25])
                    for _ in range(m)],
    }
    for name, vals in leaves.items():
        jl, tl = pair(vals, name)
        j = JColumn.make_list(offs, jl, validity=lv)
        t = Column.make_list(torch.tensor(offs), tl, torch.tensor(lv))
        for seed in SEEDS:
            same(j_murmur([j], seed), ops.murmur_hash3_32([t], seed))


def test_mixed_chained_tables_match_jax():
    """Fixed-width, string, DECIMAL128 and nested columns in one chain,
    with nulls, through every entry point (the kernel's launches of more
    leaves than one takes: `test_kernel_row_arithmetic_equals_plain_version`
    "wide")."""
    rng = random.Random(14)
    n = 50
    strs = random_bytes(rng, n, max_len=40)
    decs = [None if rng.random() < 0.2 else rng.randrange(-(1 << 120),
                                                          1 << 120)
            for _ in range(n)]
    ints = [None if rng.random() < 0.2 else rng.randrange(-2**62, 2**62)
            for _ in range(n)]
    jcols, tcols = nested_pair(seed=15, n=n)
    js, ts = pair(strs, "string")
    jd, td = pair(decs, "dec")
    ji, ti = pair(ints, "int64")
    jtab = [js, jcols[0], jd, ji, jcols[1], js]
    ttab = [ts, tcols[0], td, ti, tcols[1], ts]
    for seed in (0, -7):
        same(j_murmur(jtab, seed), ops.murmur_hash3_32(ttab, seed))
    flat_j, flat_t = [js, jd, ji, js], [ts, td, ti, ts]
    same(j_xxhash(flat_j, -7), ops.xxhash64(flat_t, -7))
    m, x = ops.fused_row_hash(flat_t, mm_seed=42)
    same(j_murmur(flat_j, 42), m)
    same(j_xxhash(flat_j, 42), x)


def test_nulls_pass_the_running_hash_through_at_every_level():
    s = Column.from_pylist([None, "ab", None], tdt.STRING, device="cpu")
    d = Column.from_pylist([None, None, 5], tdt.decimal(38, 0),
                           device="cpu")
    got = ops.murmur_hash3_32([s, d], 42).to_pylist()
    assert got[0] == 42
    assert got[1] == oracle.murmur32_bytes(b"ab", 42)
    assert got[2] == oracle.murmur32_bytes(oracle.encode_decimal128(5), 42)
    x = ops.xxhash64([s, d], 42).to_pylist()
    assert x[0] == 42 and x[1] == oracle.xxhash64_bytes(b"ab", 42)
    # a null struct nulls its fields; a null list element is skipped
    st = Column.make_struct(torch.tensor([False, True, True]), a=s, b=d)
    got = ops.murmur_hash3_32([st], 42).to_pylist()
    assert got[0] == 42 and got[1] == oracle.murmur32_bytes(b"ab", 42)
    lst = Column.from_pylist([[None, 7], None, []], tdt.list_(tdt.INT32),
                             device="cpu")
    got = ops.murmur_hash3_32([lst], 42).to_pylist()
    assert got == [oracle.murmur32_bytes(oracle.encode_int4(7), 42), 42, 42]


def test_long_strings_match_the_spark_oracle():
    vals = [bytes(range(i % 256)) * 3 for i in range(0, 50)] + \
        [b"x" * n for n in (31, 32, 33, 63, 64, 65, 127, 128, 255)]
    t = Column.from_pylist(vals, tdt.STRING, device="cpu")
    assert ops.xxhash64([t], 42).to_pylist() == [
        oracle.xxhash64_bytes(v, 42) for v in vals]
    assert ops.murmur_hash3_32([t], 42).to_pylist() == [
        oracle.murmur32_bytes(v, 42) for v in vals]


# ---- Spark's golden vectors ---------------------------------------------------

def _col(vals, dt):
    return Column.from_pylist(vals, dt, device="cpu")


def _colv(vals, dt):
    return _col([v if V8[i] else None for i, v in enumerate(vals)], dt)


def _struct_golden():
    return Column.make_struct(
        a=_col([0, 100, -100, 0x12345678, -0x76543210], tdt.INT32),
        b=_col(["a", "bc", "def", "ghij", "klmno"], tdt.STRING),
        c=Column.make_struct(
            x=_col([0., 100., -100., np.inf, -np.inf], tdt.FLOAT32),
            y=_col([0, 100, -100, 0x0123456789ABCDEF, -0x0123456789ABCDEF],
                   tdt.INT64)))


def _murmur_combined():
    return [
        _struct_golden(),
        _col(STRINGS5, tdt.STRING),
        _col([0., -0., -np.nan, F64.min, F64.max], tdt.FLOAT64),
        _col([0, 100, -100, -(I64.min // -1000000), I64.max // 1000000],
             tdt.TIMESTAMP_US),
        _col([0, 100, -100, -999999999999999999, 999999999999999999],
             tdt.decimal(18, 7)),
        _col([0, 100, -100, I64.min, I64.max], tdt.INT64),
        _col([0., -0., -np.nan, F32.min, F32.max], tdt.FLOAT32),
        _col([0, 100, -100, -((2**31) // 100), (2**31 - 1) // 100],
             tdt.DATE32),
        _col([0, 100, -100, -999999999, 999999999], tdt.decimal(9, 3)),
        _col([0, 100, -100, I32.min, I32.max], tdt.INT32),
        _col([0, 100, -100, -32768, 32767], tdt.INT16),
        _col([0, 100, -100, -128, 127], tdt.INT8),
        _col([False, True, True, True, False], tdt.BOOL),
        _col(DEC128_VALS, tdt.decimal(38, 11)),
    ]


def _xx_combined():
    return [
        _colv(STRINGS5 + [b"", b"abcdefgh", b"abcdefghi"], tdt.STRING),
        _colv([0., -0., -np.nan, F64.min, F64.max, 0., 100., 200.],
              tdt.FLOAT64),
        _colv([0, 100, -100, -(I64.min // -1000000), I64.max // 1000000, 0,
               200, 300], tdt.TIMESTAMP_US),
        _colv([0, 100, -100, -999999999999999999, 999999999999999999, 0,
               123, 432], tdt.decimal(18, 7)),
        _colv([0, 100, -100, I64.min, I64.max, 0, 0x123456789ABCDEF,
               -0x123456789ABCDEF], tdt.INT64),
        _colv([0., -0., -np.nan, F32.min, F32.max, 0., np.inf, -np.inf],
              tdt.FLOAT32),
        _colv([0, 100, -100, -((2**31) // 100), (2**31 - 1) // 100, 0, -200,
               -300], tdt.DATE32),
        _colv([0, 100, -100, -999999999, 999999999, 0, -200, -300],
              tdt.decimal(9, 3)),
        _colv([0, 100, -100, I32.min, I32.max, 0, -200, -300], tdt.INT32),
        _colv([0, 100, -100, -32768, 32767, 0, -200, -300], tdt.INT16),
        _colv([0, 100, -100, -128, 127, 0, -90, -80], tdt.INT8),
        _colv([False, True, True, True, False, False, False, False],
              tdt.BOOL),
        _colv([0, 100, -1, DEC128_VALS[3], DEC128_VALS[4], 0, DEC128_VALS[3],
               DEC128_VALS[4]], tdt.decimal(38, 11)),
    ]


# (name, columns, seed, Spark's murmur3_32 or None, Spark's xxhash64 or None)
GOLDEN = [
    ("strings", lambda: [_col(STRINGS5, tdt.STRING)], 42,
     [142593372, 1217302703, -715697185, -2061143941, -111635966], None),
    ("strings seed 314", lambda: [_col(STRINGS5, tdt.STRING)], 314,
     [1467149710, 723257560, -1620282500, -2001858707, 1588473657], None),
    ("decimal128", lambda: [_col(DEC128_VALS, tdt.decimal(38, 11))], 42,
     [-783713497, -295670906, 1398487324, -52622807, -1359749815], None),
    ("structs", lambda: [_struct_golden()], 42,
     [-105406170, 90479889, -678041645, 1667387937, 301478567], None),
    ("combined chained", _murmur_combined, 42,
     [401603227, 588162166, 552160517, 1132537411, -326043017], None),
    ("xx strings", lambda: [_colv(STRINGS5 + [b"", b"abcdefgh",
                                              b"abcdefghi"], tdt.STRING)],
     42, None,
     [-7444071767201028348, -3617261401988713833, 8198945020833482635,
      -5346617152005100141, 6614298085531227868, 42, 2470326616177429180,
      -7093207067522615973]),
    ("xx decimal128", lambda: [_colv(
        [0, 100, -1, DEC128_VALS[3], DEC128_VALS[4], 0, DEC128_VALS[3],
         DEC128_VALS[4]], tdt.decimal(38, 11))], 42, None,
     [-8959994473701255385, 4409375254388155230, -4006032525457443936,
      -5423362182451591024, 7041733194569950081, 42, -5423362182451591024,
      7041733194569950081]),
    ("xx combined", _xx_combined, 42, None,
     [541735645035655239, 9011982951766246298, 3834379147931449211,
      -5406325166887725795, 7797509897614041972, 42, -9032872913521304524,
      -604070008711895908]),
]


@pytest.mark.parametrize("case", GOLDEN, ids=[g[0] for g in GOLDEN])
def test_golden_spark_vectors(case):
    _, cols, seed, mm, xx = case
    if mm is not None:
        assert ops.murmur_hash3_32(cols(), seed).to_pylist() == mm
    if xx is not None:
        assert ops.xxhash64(cols(), seed).to_pylist() == xx


def test_lists_chain_their_elements_as_spark_does():
    """tests/test_hash.py's list vectors: a list hashes as the chain of
    its elements; an empty list leaves the seed."""
    lst = Column.make_list(torch.tensor([0, 2, 2, 6], dtype=torch.int32),
                           _col([1, 2, 3, 4, 5, 6], tdt.INT32))
    want = []
    for vals in ([1, 2], [], [3, 4, 5, 6]):
        h = 42
        for v in vals:
            h = oracle.murmur32_bytes(oracle.encode_int4(v), h & oracle.M32)
        want.append(h)
    assert ops.murmur_hash3_32([lst], 42).to_pylist() == want
    strs = Column.make_list(torch.tensor([0, 2, 3], dtype=torch.int32),
                            _col(["ab", "cde", "f"], tdt.STRING))
    h0 = oracle.murmur32_bytes(b"cde", oracle.murmur32_bytes(b"ab", 7)
                               & oracle.M32)
    assert ops.murmur_hash3_32([strs], 7).to_pylist() == [
        h0, oracle.murmur32_bytes(b"f", 7)]


def test_rejections_match_the_reference():
    for fn in (lambda: ops.murmur_hash3_32([]), lambda: ops.xxhash64([]),
               lambda: hash_cuda.murmur_hash3_32_cuda([])):
        with pytest.raises(ValueError, match="at least 1 column"):
            fn()
    for fn in (lambda: j_murmur([]), lambda: j_xxhash([])):
        with pytest.raises(ValueError):
            fn()
    st = _col([{"v": 1}], tdt.struct(v=tdt.INT32))
    with pytest.raises(TypeError, match="nested"):
        ops.xxhash64([st])
    with pytest.raises(TypeError, match="nested"):
        ops.fused_row_hash([st])
    jst = JColumn.make_struct(v=JColumn.from_pylist([1], jdt.INT32))
    with pytest.raises(TypeError):
        j_xxhash([jst])
    ts = Column.from_numpy(np.arange(2, dtype=np.int64),
                           tdt.DType(tdt.Kind.TIMESTAMP_S), device="cpu")
    with pytest.raises(TypeError):
        ops.murmur_hash3_32([_col([1, 2], tdt.INT32), ts])
    lts = Column.make_list(torch.tensor([0, 2], dtype=torch.int32), ts)
    assert not hash_cuda.supports([lts])
    with pytest.raises(TypeError):
        ops.murmur_hash3_32([lts])


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    t = _col(["a", "bb", None], tdt.STRING)
    hash_cuda.reset_counters()
    ops.murmur_hash3_32([t])
    ops.xxhash64([t])
    ops.fused_row_hash([t])
    assert hash_cuda.PLAIN_CALLS == {"murmur": 1, "xxhash": 1, "fused": 1}
    assert hash_cuda.LAUNCHES == {"murmur": 0, "xxhash": 0, "fused": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_cuda.murmur_hash3_32_cuda([t])


# ---- the kernel's row arithmetic, compiled for the host ----------------------

_HOST_HARNESS = r"""
#include "row_hash.cu"
// one launch's work: nc <= MAX_COLS leaf columns, from the seeds or (cont)
// from the hashes in the outputs
extern "C" int host_hash(const void* const* data, const void* const* valid,
                         const int* width, const int* enc,
                         const void* const* offsets,
                         const void* const* span_start,
                         const void* const* span_end,
                         const void* const* elem_valid, int nc, long long n,
                         unsigned int mm_seed, unsigned long long xx_seed,
                         int cont, int* mm_out, long long* xx_out) {
  Cols cs;
  ByteCols bs;
  if (make_cols(data, valid, width, enc, offsets, span_start, span_end,
                elem_valid, nc, xx_out != nullptr, cs, bs))
    return 1;
  for (long long i = 0; i < n; ++i) {
    uint32_t mh = mm_out ? (cont ? static_cast<uint32_t>(mm_out[i])
                                 : mm_seed) : 0u;
    uint64_t xh = xx_out ? (cont ? static_cast<uint64_t>(xx_out[i])
                                 : xx_seed) : 0ull;
    // the kernel rh_hash would launch: the byte path or a fixed-width form
    if (needs_bytes(cs, bs))
      hash_row<true>(cs, &bs, i, mm_out != nullptr, xx_out != nullptr, mh,
                     xh);
    else
      hash_row<false>(cs, nullptr, i, mm_out != nullptr, xx_out != nullptr,
                      mh, xh);
    if (mm_out) mm_out[i] = static_cast<int>(mh);
    if (xx_out) xx_out[i] = static_cast<long long>(xh);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/row_hash.cu's `hash_row` built with the host's C++ compiler
    (the source compiles without nvcc, minus the launch)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "arithmetic")
    csrc = pathlib.Path(hash_cuda.__file__).parent / "csrc"
    d = tmp_path_factory.mktemp("row_hash_host")
    (d / "harness.cpp").write_text(_HOST_HARNESS)
    lib = d / "librow_hash_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{csrc}", "-x", "c++", str(d / "harness.cpp"), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    h = ctypes.CDLL(str(lib))
    h.host_hash.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    h.host_hash.restype = ctypes.c_int
    return h


def _host_run(host, cols, mm_seed, xx_seed):
    """The wrapper's launches, MAX_COLS leaves each, on the host."""
    lv = hash_cuda.leaves(cols)
    n = cols[0].length
    mm = None if mm_seed is None else np.zeros(n, np.int32)
    xx = None if xx_seed is None else np.zeros(n, np.int64)
    for start in range(0, len(lv), hash_cuda.MAX_COLS):
        chunk = lv[start:start + hash_cuda.MAX_COLS]
        rc = host.host_hash(*hash_cuda.descriptors(chunk), len(chunk), n,
                            (mm_seed or 0) & 0xFFFFFFFF,
                            (xx_seed or 0) & (2**64 - 1), int(start > 0),
                            None if mm is None else mm.ctypes.data,
                            None if xx is None else xx.ctypes.data)
        assert rc == 0, "make_cols refused the wrapper's columns"
    return mm, xx


def _host_cases():
    rng = random.Random(16)
    edge = [b"\x80\xff\x7f"[:k % 4] + bytes(rng.randrange(256)
                                            for _ in range(n))
            for k, n in enumerate(EDGE_LENGTHS)]
    strs = random_bytes(rng, 60, max_len=80) + edge
    n = len(strs)
    decs = [None if rng.random() < 0.2 else rng.randrange(-(1 << 127),
                                                          1 << 127)
            for _ in range(n)]
    floats = [rng.choice([0.0, -0.0, float("nan"), float("inf"), 2.5, None])
              for _ in range(n)]
    ints = [None if rng.random() < 0.2 else rng.randrange(-2**15, 2**15)
            for _ in range(n)]
    s = _col(strs, tdt.STRING)
    d = _col(decs, tdt.decimal(38, 3))
    f = _col(floats, tdt.FLOAT64)
    i16 = _col(ints, tdt.INT16)
    _, nested = nested_pair(seed=17, n=n)
    all_null = _col([None] * n, tdt.STRING)
    empty = _col([""] * n, tdt.STRING)
    return {"strings": [s], "decimal128": [d], "all null, empty": [all_null,
                                                                   empty],
            "mixed": [s, d, f, i16, s], "struct": [nested[0], d],
            "list of list": [nested[1], s], "fixed": [f, i16, i16],
            "wide": [s, d, i16, nested[0]] * 9}


@pytest.mark.parametrize("case", ["strings", "decimal128", "all null, empty",
                                  "mixed", "struct", "list of list", "fixed",
                                  "wide"])
def test_kernel_row_arithmetic_equals_plain_version(host_kernel, case):
    cols = _host_cases()[case]
    nested = any(c.dtype.is_nested for c in cols)
    floats = any(c.dtype.is_floating for c in cols)
    for seed in (0, 42):
        mm, _ = _host_run(host_kernel, cols, seed, None)
        npt.assert_array_equal(mm, thash.murmur_hash3_32(cols, seed).data)
        if nested:
            continue
        _, xx = _host_run(host_kernel, cols, None, seed)
        npt.assert_array_equal(xx, thash.xxhash64(cols, seed).data)
        if not floats:
            mm, xx = _host_run(host_kernel, cols, seed, 42)
            npt.assert_array_equal(mm,
                                   thash.murmur_hash3_32(cols, seed).data)
            npt.assert_array_equal(xx, thash.xxhash64(cols, 42).data)
