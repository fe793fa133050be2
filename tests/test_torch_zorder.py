"""The port's Z-order helpers (`spark_rapids_tpu_torch/ops/zorder.py`)
against the JAX package's, bit for bit: `interleave_bits` over every
fixed-width type the JAX tests and the reference take, one and four
columns, with nulls, NaN and -0.0; `hilbert_index` over every (bits,
columns) pair of the JAX tests and more, `num_bits * ncols = 64`
included, with nulls; the oracles (scalar bit loops and Skilling's
algorithm); the errors; the zero-row deviation (ROADMAP queue C,
deviation 11); the kernels' row code (csrc/zorder.cu) built with the
host's C++ compiler against the plain versions; and `api.ZOrder` with its
zero-column corner cases.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import ctypes
import functools

import numpy as np
import pytest
import torch

from spark_rapids_tpu import api as japi
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JCol
from spark_rapids_tpu.ops import zorder as jz
from spark_rapids_tpu_torch import api
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import zorder as tz
from torch_cast_inputs import build_host
from torch_cast_jax import assert_same_column
from torch_datetime_inputs import (HILBERT_2D, HILBERT_SHAPES, ZORDER_TYPES,
                                   oracle_hilbert, oracle_interleave,
                                   unsigned_bits, zorder_columns)

N = 300
TYPES = dict(ZORDER_TYPES)


@functools.lru_cache(None)
def columns(kind, ncols, seed=0, n=N):
    """(JAX columns, port CPU columns, [(values, validity)])."""
    cols = zorder_columns(seed, TYPES[kind], ncols, n)
    jt, tt = jdt.DType(jdt.Kind[kind]), tdt.DType(tdt.Kind[kind])
    return ([JCol.from_numpy(v, jt, validity=ok) for v, ok in cols],
            [TCol.from_numpy(v, tt, ok, device="cpu") for v, ok in cols],
            cols)


@pytest.mark.parametrize("ncols", [1, 4])
@pytest.mark.parametrize("kind", TYPES)
def test_interleave_equals_jax_and_the_oracle(kind, ncols):
    jc, tc, cols = columns(kind, ncols)
    got = tz.interleave_bits(tc)
    assert_same_column(got, jz.interleave_bits(jc))
    if ncols == 4:
        nbits = tc[0].dtype.itemsize() * 8
        vals = [unsigned_bits(v, ok, nbits) for v, ok in cols]
        assert got.to_pylist() == oracle_interleave(list(zip(*vals)), nbits)


def test_interleave_oracle_cases():
    a = TCol.from_pylist([0x01020304, -1], tdt.INT32, device="cpu")
    assert tz.interleave_bits([a]).to_pylist() == [[1, 2, 3, 4],
                                                   [255, 255, 255, 255]]
    a = TCol.from_pylist([1, None], tdt.INT32, device="cpu")
    b = TCol.from_pylist([None, 2], tdt.INT32, device="cpu")
    assert tz.interleave_bits([a, b]).to_pylist() == oracle_interleave(
        [(1, 0), (0, 2)], 32)


def test_interleave_zero_rows_is_an_empty_list():
    """Deviation 11: zero rows give a 0-row LIST<UINT8> (offsets [0]),
    where the JAX package raises ZeroDivisionError from its reshape."""
    a = np.zeros(0, np.int32)
    with pytest.raises(ZeroDivisionError):
        jz.interleave_bits([JCol.from_numpy(a, jdt.INT32)] * 2)
    got = tz.interleave_bits([TCol.from_numpy(a, tdt.INT32,
                                              device="cpu")] * 2)
    assert got.length == 0 and got.offsets.tolist() == [0]
    assert got.children[0].length == 0
    assert got.children[0].dtype == tdt.UINT8


def test_interleave_errors_equal_jax():
    cases = [
        (ValueError, [], []),
        (TypeError, [JCol.from_pylist([1], jdt.INT32),
                     JCol.from_pylist([1], jdt.INT64)],
         [TCol.from_pylist([1], tdt.INT32, device="cpu"),
          TCol.from_pylist([1], tdt.INT64, device="cpu")]),
        (TypeError, [JCol.from_pylist(["a"], jdt.STRING)],
         [TCol.from_pylist(["a"], tdt.STRING, device="cpu")]),
        (KeyError, [JCol.from_pylist([1], jdt.decimal(38, 0))],
         [TCol.from_pylist([1], tdt.decimal(38, 0), device="cpu")])]
    for kind, j, t in cases:
        with pytest.raises(kind) as want:
            jz.interleave_bits(j)
        with pytest.raises(kind) as got:
            tz.interleave_bits(t)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bits,ncols", HILBERT_SHAPES)
def test_hilbert_equals_jax_and_the_oracle(bits, ncols):
    jc, tc, cols = columns("INT32", ncols, seed=bits)
    got = tz.hilbert_index(bits, tc)
    assert_same_column(got, jz.hilbert_index(bits, jc))
    vals = [unsigned_bits(v, ok, 32) for v, ok in cols]
    assert got.to_pylist()[:64] == [oracle_hilbert(list(p), bits)
                                    for p in list(zip(*vals))[:64]]


def test_hilbert_known_2d_order_and_errors_equal_jax():
    xs, ys = (TCol.from_pylist(v, tdt.INT32, device="cpu")
              for v in HILBERT_2D)
    assert sorted(tz.hilbert_index(1, [xs, ys]).to_pylist()) == [0, 1, 2, 3]
    a = [JCol.from_pylist([None, 3], jdt.INT32),
         JCol.from_pylist([1, 1], jdt.INT32)]
    b = [TCol.from_pylist([None, 3], tdt.INT32, device="cpu"),
         TCol.from_pylist([1, 1], tdt.INT32, device="cpu")]
    cases = [(ValueError, 33, a[:1], b[:1]), (ValueError, 0, a, b),
             (ValueError, 33, a, b), (ValueError, 32, a * 3, b * 3),
             (ValueError, 4, [], []),
             (TypeError, 4, [JCol.from_pylist([1], jdt.INT64)],
              [TCol.from_pylist([1], tdt.INT64, device="cpu")])]
    for kind, bits, j, t in cases:
        with pytest.raises(kind) as want:
            jz.hilbert_index(bits, j)
        with pytest.raises(kind) as got:
            tz.hilbert_index(bits, t)
        assert str(got.value) == str(want.value)


def test_facade_equals_jax_with_the_zero_column_corners():
    jc, tc, _ = columns("INT32", 2)
    assert_same_column(api.ZOrder.interleaveBits(N, *tc),
                       japi.ZOrder.interleaveBits(N, *jc))
    assert_same_column(api.ZOrder.hilbertIndex(16, N, *tc),
                       japi.ZOrder.hilbertIndex(16, N, *jc))
    assert_same_column(api.ZOrder.interleaveBits(3, device="cpu"),
                       japi.ZOrder.interleaveBits(3))
    assert_same_column(api.ZOrder.hilbertIndex(4, 3, device="cpu"),
                       japi.ZOrder.hilbertIndex(4, 3))


# ---- the kernels' row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("zorder", tmp_path_factory.mktemp("zorder_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernels' row "
                    "code")
    P, I, N_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_interleave.argtypes = [P, I, I, N_, P]
    lib.host_hilbert.argtypes = [P, I, I, N_, P]
    return lib


def _table(cols):
    """The kernels' address array, on the host."""
    return torch.tensor([c.data.data_ptr() for c in cols] + [
        0 if c.validity is None else c.validity.data_ptr() for c in cols],
        dtype=torch.int64)


@pytest.mark.parametrize("kind", TYPES)
def test_interleave_rows_equal_plain(host_lib, kind):
    for ncols in (1, 2, 5):
        _, tc, _ = columns(kind, ncols, seed=1)
        size = tc[0].dtype.itemsize()
        out = torch.empty((N, ncols * size), dtype=torch.uint8)
        assert host_lib.host_interleave(_table(tc).data_ptr(), ncols, size,
                                        N, out.data_ptr()) == 0
        assert torch.equal(out, tz.interleave_plain(tc))


def test_hilbert_rows_equal_plain(host_lib):
    for bits, ncols in HILBERT_SHAPES:
        _, tc, _ = columns("INT32", ncols, seed=bits)
        out = torch.empty(N, dtype=torch.int64)
        assert host_lib.host_hilbert(_table(tc).data_ptr(), ncols, bits, N,
                                     out.data_ptr()) == 0
        assert torch.equal(out, tz.hilbert_plain(bits, tc))
