"""The port's row hashes (spark_rapids_tpu_torch/ops/hash.py, hash_cuda.py,
api.py) against the JAX package on the CPU, on the same numpy inputs.

On CPU tensors the entry points run their plain PyTorch versions, so these
tests hold the plain murmur3_32/xxhash64/fused row hash to the reference:
`ops.murmur_hash3_32`/`xxhash64` and `hash_pallas`'s three entry points in
Pallas interpret mode, and to Spark's own golden values and the pure-Python
Spark oracle (`tests/spark_hash_oracle.py`). Hashes are integers: the
tolerance is exact.

One input class is left out of the JAX comparison: float64 subnormals. The
reference computes double bits arithmetically and XLA flushes f64
subnormals to zero, so it hashes them as +/-0.0; the port reads the bits
and hashes them as Spark does (`test_f64_subnormals_follow_spark`, ROADMAP
queue C).
"""
import types

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.ops import murmur_hash3_32 as j_murmur
from spark_rapids_tpu.ops import xxhash64 as j_xxhash
from spark_rapids_tpu.ops import hash_pallas

import spark_hash_oracle as oracle
from spark_rapids_tpu_torch import api, ops
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TColumn
from spark_rapids_tpu_torch.columnar import Table as TTable
from spark_rapids_tpu_torch.ops import hash as thash
from spark_rapids_tpu_torch.ops import hash_cuda, join_cuda

BLOCK = 1024      # Pallas block rows: small tables still tile
SEEDS = (0, 42, -7, 2 ** 40 + 3)

# (kind name, numpy storage, port dtype, JAX dtype)
KINDS = [
    ("bool", np.bool_, tdt.BOOL, jdt.BOOL),
    ("int8", np.int8, tdt.INT8, jdt.INT8),
    ("int16", np.int16, tdt.INT16, jdt.INT16),
    ("int32", np.int32, tdt.INT32, jdt.INT32),
    ("date32", np.int32, tdt.DATE32, jdt.DATE32),
    ("int64", np.int64, tdt.INT64, jdt.INT64),
    ("timestamp_us", np.int64, tdt.TIMESTAMP_US, jdt.TIMESTAMP_US),
    ("decimal32", np.int32, tdt.decimal(9, 2), jdt.decimal(9, 2)),
    ("decimal64", np.int64, tdt.decimal(18, 2), jdt.decimal(18, 2)),
    ("float32", np.float32, tdt.FLOAT32, jdt.FLOAT32),
    ("float64", np.float64, tdt.FLOAT64, jdt.FLOAT64),
]
_BY_NAME = {k[0]: k for k in KINDS}
INT_KINDS = [k[0] for k in KINDS if not k[0].startswith("float")]


def _values(rng, name, n):
    _, npt_, _, _ = _BY_NAME[name]
    if npt_ is np.bool_:
        return rng.integers(0, 2, n).astype(bool)
    if np.issubdtype(npt_, np.floating):
        a = (rng.standard_normal(n) * 1e3).astype(npt_)
        # NaN with another payload, both zeros, both infinities, extremes
        odd_nan = np.frombuffer(
            (np.uint32(0x7FA00001) if npt_ is np.float32
             else np.uint64(0xFFF0000000000F01)).tobytes(), npt_)[0]
        fi = np.finfo(npt_)
        special = np.array([np.nan, -np.nan, odd_nan, 0.0, -0.0, np.inf,
                            -np.inf, fi.max, fi.min, fi.tiny], npt_)
        a[:min(n, len(special))] = special[:n]
        return a
    ii = np.iinfo(npt_)
    a = rng.integers(ii.min, ii.max, n, dtype=npt_, endpoint=True)
    a[:min(n, 3)] = [0, ii.min, ii.max][:n]
    return a


def _pair(rng, name, n, null_p=0.0):
    """The same column in both packages."""
    _, _, tdtype, jdtype = _BY_NAME[name]
    a = _values(rng, name, n)
    v = (rng.random(n) > null_p) if null_p else None
    j = JColumn(dtype=jdtype, length=n, data=jnp.asarray(a),
                validity=None if v is None else jnp.asarray(v))
    return j, TColumn.from_numpy(a, tdtype, v, device="cpu")


def _eq(jcol, tcol):
    npt.assert_array_equal(np.asarray(jcol.data), tcol.data.numpy())
    assert tcol.data.dtype == {"int32": torch.int32,
                               "int64": torch.int64}[jcol.dtype.kind.value]


# ---- each kind against the JAX package ---------------------------------------

@pytest.mark.parametrize("null_p", [0.0, 0.3])
@pytest.mark.parametrize("name", [k[0] for k in KINDS])
def test_plain_hashes_match_jax(name, null_p):
    rng = np.random.default_rng([k[0] for k in KINDS].index(name))
    j, t = _pair(rng, name, 1000, null_p)
    for seed in SEEDS:
        _eq(j_murmur([j], seed), ops.murmur_hash3_32([t], seed))
        _eq(j_xxhash([j], seed), ops.xxhash64([t], seed))
        _eq(j_murmur([j], seed), api.Hash.murmurHash32([t], seed))
        _eq(j_xxhash([j], seed), api.Hash.xxhash64([t], seed))
    _eq(hash_pallas.murmur_hash3_32_pallas([j], 42, block_rows=BLOCK),
        ops.murmur_hash3_32([t], 42))
    _eq(hash_pallas.xxhash64_pallas([j], block_rows=BLOCK),
        ops.xxhash64([t]))
    assert api.Hash.DEFAULT_XXHASH64_SEED == 42 == ops.DEFAULT_XXHASH64_SEED
    assert hash_cuda.supports([t]) == hash_pallas.supports([j]) is True


@pytest.mark.parametrize("n", [0, 1, 7, 333])
def test_wide_table_and_lengths_match_pallas(n):
    """Every integer kind in one table, nulls in half the columns, against
    the jnp hashes; three of those columns through the single-hash and
    fused entry points against `hash_pallas` (interpret mode). Lengths are
    empty, one row and not a block multiple. (A Pallas xxhash64 over all
    nine kinds takes minutes to run in interpret mode.)"""
    rng = np.random.default_rng(n)
    pairs = [_pair(rng, name, n, 0.25 * (i % 2))
             for i, name in enumerate(INT_KINDS)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    tt = TTable(ts)
    _eq(j_murmur(js, 42), ops.murmur_hash3_32(tt, seed=42))
    _eq(j_xxhash(js), ops.xxhash64(tt))
    tm, tx = ops.fused_row_hash(ts, mm_seed=-3, xx_seed=2 ** 63 + 5)
    _eq(j_murmur(js, -3), tm)
    _eq(j_xxhash(js, 2 ** 63 + 5), tx)
    pick = [INT_KINDS.index(k) for k in ("int64", "int32", "decimal64")]
    js, ts = [js[i] for i in pick], TTable([ts[i] for i in pick])
    _eq(hash_pallas.murmur_hash3_32_pallas(js, 42, block_rows=BLOCK),
        ops.murmur_hash3_32(ts, seed=42))
    _eq(hash_pallas.xxhash64_pallas(js, block_rows=BLOCK), ops.xxhash64(ts))
    jm, jx = hash_pallas.fused_row_hash(js, mm_seed=42, block_rows=BLOCK)
    tm, tx = ops.fused_row_hash(ts, mm_seed=42)
    _eq(jm, tm)
    _eq(jx, tx)


def test_chain_over_more_columns_than_one_launch_takes():
    """A table wider than the kernel's 32 columns hashes as one chain."""
    rng = np.random.default_rng(40)
    names = [KINDS[i % len(KINDS)][0] for i in range(hash_cuda.MAX_COLS + 8)]
    pairs = [_pair(rng, name, 300, 0.2) for name in names]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    _eq(j_murmur(js, 42), ops.murmur_hash3_32(ts, 42))
    _eq(j_xxhash(js, 42), ops.xxhash64(ts, 42))


# ---- Spark's own values -------------------------------------------------------

F32, F64 = np.finfo(np.float32), np.finfo(np.float64)
I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)
# Spark output, seed 42 (the reference's tests/hash.cpp, as in test_hash.py)
GOLDEN_MURMUR = {
    "float64": ([0., -0., -np.nan, F64.min, F64.max],
                [-1670924195, -853646085, -1281358385, 1897734433,
                 -508695674]),
    "float32": ([0., -0., -np.nan, F32.min, F32.max],
                [933211791, 723455942, -349261430, -1225560532, -338752985]),
    "int64": ([0, 100, -100, I64.min, I64.max],
              [-1670924195, 1114849490, 904948192, -853646085, -1604625029]),
    "int32": ([0, 100, -100, I32.min, I32.max],
              [933211791, 751823303, -1080202046, 723455942, 133916647]),
    "int16": ([0, 100, -100, -32768, 32767],
              [933211791, 751823303, -1080202046, -1871935946, 1249274084]),
    "int8": ([0, 100, -100, -128, 127],
             [933211791, 751823303, -1080202046, 1110053733, 1135925485]),
    "bool": ([False, True, True, True, False],
             [933211791, -559580957, -559580957, -559580957, 933211791]),
    "timestamp_us": ([0, 100, -100, -(I64.min // -1000000),
                      I64.max // 1000000],
                     [-1670924195, 1114849490, 904948192, -1832979433,
                      1752430209]),
    "date32": ([0, 100, -100, -((2 ** 31) // 100), (2 ** 31 - 1) // 100],
               [933211791, 751823303, -1080202046, -1906567553,
                -1503850410]),
    "decimal32": ([0, 100, -100, -999999999, 999999999],
                  [-1670924195, 1114849490, 904948192, -1454351396,
                   -193774131]),
    "decimal64": ([0, 100, -100, -999999999999999999, 999999999999999999],
                  [-1670924195, 1114849490, 904948192, 1962370902,
                   -1795328666]),
}
# Spark output, seed 42; row 5 is null and hashes as the seed
GOLDEN_XXHASH = {
    "float64": ([0., -0., -np.nan, F64.min, F64.max, 0., 100., 200.],
                [-5252525462095825812, -5252525462095825812,
                 -3127944061524951246, 9065082843545458248,
                 -4222314252576420879, 42, -7996023612001835843,
                 -8838535416664833914]),
    "float32": ([0., -0., -np.nan, F32.min, F32.max, 0., np.inf, -np.inf],
                [3614696996920510707, 3614696996920510707,
                 2692338816207849720, -8545425418825163117,
                 -1065250890878313112, 42, -5940311692336719973,
                 -7580553461823983095]),
    "int64": ([0, 100, -100, I64.min, I64.max, 0, 0x123456789ABCDEF,
               -0x123456789ABCDEF],
              [-5252525462095825812, 8713583529807266080, 5675770457807661948,
               -8619748838626508300, -3246596055638297850, 42,
               1941233597257011502, -1318946533059658749]),
    "int32": ([0, 100, -100, I32.min, I32.max, 0, -200, -300],
              [3614696996920510707, -7987742665087449293, 8990748234399402673,
               2073849959933241805, 1508894993788531228, 42,
               -953008374380745918, 2895908635257747121]),
    "int16": ([0, 100, -100, -32768, 32767, 0, -200, -300],
              [3614696996920510707, -7987742665087449293, 8990748234399402673,
               -904511417458573795, 8952525448871805501, 42,
               -953008374380745918, 2895908635257747121]),
    "int8": ([0, 100, -100, -128, 127, 0, -90, -80],
             [3614696996920510707, -7987742665087449293, 8990748234399402673,
              4160238337661960656, 8632298611707923906, 42,
              -4008061843281999337, 6690883199412647955]),
    "bool": ([False, True, True, True, False, False, False, False],
             [3614696996920510707, -6698625589789238999,
              -6698625589789238999, -6698625589789238999,
              3614696996920510707, 42, 3614696996920510707,
              3614696996920510707]),
    "date32": ([0, 100, -100, -((2 ** 31) // 100), (2 ** 31 - 1) // 100, 0,
                -200, -300],
               [3614696996920510707, -7987742665087449293,
                8990748234399402673, -8442426365007754391,
                -1447590449373190349, 42, -953008374380745918,
                2895908635257747121]),
    "decimal32": ([0, 100, -100, -999999999, 999999999, 0, -200, -300],
                  [-5252525462095825812, 8713583529807266080,
                   5675770457807661948, 8670643431269007867,
                   6810183316718625826, 42, 7277994511003214036,
                   6264187449999859617]),
    "decimal64": ([0, 100, -100, -999999999999999999, 999999999999999999, 0,
                   123, 432],
                  [-5252525462095825812, 8713583529807266080,
                   5675770457807661948, 4265531446127695490,
                   2162198894918931945, 42, -3178482946328430151,
                   4788666723486520022]),
    "timestamp_us": ([0, 100, -100, -(I64.min // -1000000),
                      I64.max // 1000000, 0, 200, 300],
                     [-5252525462095825812, 8713583529807266080,
                      5675770457807661948, 7123048472642709644,
                      -5141505295506489983, 42, -1244884446866925109,
                      1772389229253425430]),
}


def _golden_col(name, vals, null_row=None):
    _, npt_, tdtype, _ = _BY_NAME[name]
    v = None
    if null_row is not None:
        v = np.ones(len(vals), bool)
        v[null_row] = False
    return TColumn.from_numpy(np.array(vals, dtype=npt_), tdtype, v,
                              device="cpu")


@pytest.mark.parametrize("name", sorted(GOLDEN_MURMUR))
def test_golden_spark_values(name):
    vals, want = GOLDEN_MURMUR[name]
    got = ops.murmur_hash3_32([_golden_col(name, vals)], 42)
    npt.assert_array_equal(got.data.numpy(), want)
    vals, want = GOLDEN_XXHASH[name]
    got = ops.xxhash64([_golden_col(name, vals, null_row=5)], 42)
    npt.assert_array_equal(got.data.numpy(), want)


def _u2s(x, bits):
    return x - (1 << bits) if x >= 1 << (bits - 1) else x


@pytest.mark.parametrize("name", ["int64", "int32", "int16", "decimal32",
                                  "float32", "float64"])
def test_random_values_match_the_spark_oracle(name):
    rng = np.random.default_rng(99)
    a = _values(rng, name, 400)
    c = _golden_col(name, a)
    for seed in (0, 42, -7):
        mm = ops.murmur_hash3_32([c], seed).data.numpy()
        xx = ops.xxhash64([c], seed).data.numpy()
        for i, v in enumerate(a.tolist()):
            if name == "float32":
                bm, bx = (oracle.encode_float(v, False),
                          oracle.encode_float(v, True))
            elif name == "float64":
                bm, bx = (oracle.encode_double(v, False),
                          oracle.encode_double(v, True))
            elif name in ("int64", "decimal32"):
                bm = bx = oracle.encode_int8(int(v))
            else:
                bm = bx = oracle.encode_int4(int(v))
            assert mm[i] == oracle.murmur32_bytes(bm, seed)
            assert xx[i] == _u2s(oracle.xxhash64_bytes(bx, seed), 64)


def test_f64_subnormals_follow_spark():
    """The one deviation from the reference: it hashes f64 subnormals as
    +/-0.0 (XLA flushes them); the port hashes their bits, as Spark does."""
    vals = np.array([5e-324, -5e-324, 1e-310, -2.2e-308], np.float64)
    c = _golden_col("float64", vals)
    mm = ops.murmur_hash3_32([c], 42).data.numpy()
    xx = ops.xxhash64([c], 42).data.numpy()
    for i, v in enumerate(vals.tolist()):
        assert mm[i] == oracle.murmur32_bytes(oracle.encode_double(v, False),
                                              42)
        assert xx[i] == _u2s(oracle.xxhash64_bytes(
            oracle.encode_double(v, True), 42), 64)
    j = JColumn(dtype=jdt.FLOAT64, length=4, data=jnp.asarray(vals))
    zeros = JColumn(dtype=jdt.FLOAT64, length=4,
                    data=jnp.asarray(np.array([0.0, -0.0, 0.0, -0.0])))
    npt.assert_array_equal(np.asarray(j_murmur([j], 42).data),
                           np.asarray(j_murmur([zeros], 42).data))
    assert not np.array_equal(np.asarray(j_murmur([j], 42).data), mm)


def test_nulls_pass_the_running_hash_through():
    c1 = TColumn.from_numpy(np.array([1, 0, 3], np.int32), tdt.INT32,
                            np.array([True, False, True]), device="cpu")
    c2 = TColumn.from_numpy(np.array([0, 0, 7], np.int64), tdt.INT64,
                            np.array([False, False, True]), device="cpu")
    got = ops.murmur_hash3_32([c1, c2], 42).data.numpy()
    h0 = oracle.murmur32_bytes(oracle.encode_int4(1), 42)
    h2 = oracle.murmur32_bytes(oracle.encode_int4(3), 42)
    h2 = oracle.murmur32_bytes(oracle.encode_int8(7), h2 & oracle.M32)
    npt.assert_array_equal(got, [h0, 42, h2])
    assert ops.xxhash64([c1, c2], 42).data.numpy()[1] == 42


# ---- errors, in both packages alike -------------------------------------------

def _errors_of(fn):
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e)
    return None


def test_errors_match_the_reference():
    rng = np.random.default_rng(2)
    ja, ta = _pair(rng, "int64", 10)
    jb, tb = _pair(rng, "int32", 12)
    jf, tf = _pair(rng, "float64", 10)
    cases = [
        (lambda: j_murmur([]), lambda: ops.murmur_hash3_32([])),
        (lambda: j_xxhash([]), lambda: ops.xxhash64([])),
        (lambda: hash_pallas.murmur_hash3_32_pallas([]),
         lambda: hash_cuda.murmur_hash3_32([])),
        (lambda: hash_pallas.xxhash64_pallas([]),
         lambda: api.Hash.xxhash64([])),
        (lambda: hash_pallas.murmur_hash3_32_pallas([ja, jb],
                                                    block_rows=BLOCK),
         lambda: ops.murmur_hash3_32([ta, tb])),
        (lambda: hash_pallas.xxhash64_pallas([ja, jb], block_rows=BLOCK),
         lambda: ops.xxhash64([ta, tb])),
        (lambda: hash_pallas.fused_row_hash([ja, jf], block_rows=BLOCK),
         lambda: ops.fused_row_hash([ta, tf])),
    ]
    for ref, port in cases:
        want = _errors_of(ref)
        assert want is not None
        assert _errors_of(port) is want
    # the reference fails on an empty fused call with IndexError; the port
    # says what is wrong
    with pytest.raises(ValueError, match="at least 1 column"):
        ops.fused_row_hash([])


def test_kinds_the_hash_does_not_take():
    ts_s = TColumn.from_numpy(np.arange(3, dtype=np.int64),
                              tdt.DType(tdt.Kind.TIMESTAMP_S), device="cpu")
    j = JColumn(dtype=jdt.DType(jdt.Kind.TIMESTAMP_S), length=3,
                data=jnp.arange(3, dtype=jnp.int64))
    with pytest.raises(TypeError):
        j_murmur([j])
    with pytest.raises(TypeError):
        ops.murmur_hash3_32([ts_s])
    with pytest.raises(TypeError):
        ops.xxhash64([ts_s])
    assert not hash_cuda.supports([ts_s])
    # strings exist in the reference but not yet in the port's Column
    s = types.SimpleNamespace(dtype=tdt.DType(tdt.Kind.STRING), length=3,
                              validity=None, device=torch.device("cpu"))
    with pytest.raises(TypeError, match="queue A item 1"):
        thash.murmur_hash3_32([s])
    with pytest.raises(TypeError, match="queue A item 1"):
        thash.xxhash64([s])


# ---- the plain versions' arithmetic and the wrappers ---------------------------

def test_int64_multiply_and_add_wrap_mod_2_64():
    """The plain xxhash64 relies on int64 `*` and `+` wrapping mod 2^64."""
    rng = np.random.default_rng(5)
    a = rng.integers(I64.min, I64.max, 5000, dtype=np.int64)
    t = torch.from_numpy(a)
    for c in (thash._P1, thash._P2, thash._P5, -1, 2 ** 62 + 1):
        want = np.array([_u2s((int(x) * c) % 2 ** 64, 64) for x in a])
        npt.assert_array_equal((t * c).numpy(), want)
        want = np.array([_u2s((int(x) + c) % 2 ** 64, 64) for x in a])
        npt.assert_array_equal((t + c).numpy(), want)
    for r in (1, 23, 31, 33, 63):
        want = np.array([(int(x) % 2 ** 64) >> r for x in a])
        npt.assert_array_equal(thash._lsr64(t, r).numpy(), want)


def test_join_and_row_hash_share_one_murmur():
    """The hash join's bucket hash is the row hash's murmur3 with seed 42."""
    rng = np.random.default_rng(8)
    cols = [_pair(rng, name, 500)[1] for name in ("int64", "int16",
                                                  "decimal32", "bool")]
    npt.assert_array_equal(join_cuda.row_hash(cols).numpy(),
                           thash.murmur_u32(cols, 42).numpy())


def test_wrappers_count_plain_runs_and_kernels_refuse_cpu_tensors():
    rng = np.random.default_rng(9)
    _, t = _pair(rng, "int64", 20)
    hash_cuda.reset_counters()
    ops.murmur_hash3_32([t])
    ops.xxhash64([t])
    ops.fused_row_hash([t])
    api.Hash.murmurHash32([t])
    assert hash_cuda.PLAIN_CALLS == {"murmur": 2, "xxhash": 1, "fused": 1}
    assert hash_cuda.LAUNCHES == {"murmur": 0, "xxhash": 0, "fused": 0}
    for fn in (hash_cuda.murmur_hash3_32_cuda, hash_cuda.xxhash64_cuda,
               hash_cuda.fused_row_hash_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn([t])
    assert hash_cuda.LAUNCHES == {"murmur": 0, "xxhash": 0, "fused": 0}

