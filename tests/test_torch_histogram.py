"""The port's histograms (`spark_rapids_tpu_torch/ops/histogram.py`)
against the JAX package's, bit for bit: `create_histogram_if_valid` in
both output forms, with and without zero frequencies and null values, and
its errors; `percentile_from_histogram` over every value type it takes,
both output forms, nulls, NaN and -0.0 values, histograms longer than a
warp, empty and all-null histograms, the negative-count case, its errors;
the scalar oracle of the JAX tests; the kernel's CPU mirror
(`histogram_cuda.percentile_mirror`) and its row code (csrc/histogram.cu,
built with the host's C++ compiler) against the plain version;
`api.Histogram`; and the admitted-op factors of this slice's nine names.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import api as japi
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu import ops as jops
from spark_rapids_tpu.columnar import Column as JCol
from spark_rapids_tpu.ops import histogram as jh
from spark_rapids_tpu_torch import api
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import ops as tops
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import histogram as th
from spark_rapids_tpu_torch.ops import histogram_cuda
from torch_cast_inputs import build_host
from torch_cast_jax import assert_same_column
from torch_datetime_inputs import (NEGATIVE_COUNT, ORACLE_HISTOGRAMS,
                                   PERCENTAGES, percentile_oracle,
                                   random_histograms)

PCTS = [0.0, 0.1, 0.25, 0.33, 0.5, 0.75, 0.9, 0.99, 1.0]
VALUE_KINDS = {"FLOAT64": np.float64, "FLOAT32": np.float32,
               "INT64": np.int64, "INT32": np.int32, "INT16": np.int16,
               "INT8": np.int8, "UINT8": np.uint8, "BOOL": np.bool_}


def histogram_columns(values, valid, counts, offsets, kind):
    """(JAX LIST<STRUCT<value, freq>>, the port's on the CPU)."""
    jt, tt = jdt.DType(jdt.Kind[kind]), tdt.DType(tdt.Kind[kind])
    js = JCol.make_struct(value=JCol.from_numpy(values, jt, validity=valid),
                          freq=JCol.from_numpy(counts, jdt.INT64))
    ts = TCol.make_struct(value=TCol.from_numpy(values, tt, valid,
                                                device="cpu"),
                          freq=TCol.from_numpy(counts, tdt.INT64,
                                               device="cpu"))
    return (JCol.make_list(jnp.asarray(offsets), js),
            TCol.make_list(torch.tensor(offsets), ts))


@functools.lru_cache(None)
def data(kind, negative=False, max_len=40, seed=0):
    """Histograms of 0-max_len elements (longer than a warp), 10% null
    values, counts 0-9 (-3..9 with `negative`)."""
    values, valid, counts, offsets = random_histograms(
        seed, 200, max_len, null_p=0.1, max_count=9,
        value_kind=VALUE_KINDS[kind])
    if kind.startswith("FLOAT"):
        values[::13] = np.nan
        values[5::17] = -0.0
    if negative:
        counts = counts - np.random.default_rng(seed).integers(
            0, 4, counts.shape[0])
    return values, valid, counts, offsets


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("kind", VALUE_KINDS)
def test_percentile_equals_jax(kind, negative):
    jl, tl = histogram_columns(*data(kind, negative), kind)
    for as_list in (True, False):
        assert_same_column(th.percentile_from_histogram(tl, PCTS, as_list),
                           jh.percentile_from_histogram(jl, PCTS, as_list))


@pytest.mark.parametrize("pcts", PERCENTAGES[1:])
def test_percentile_oracle_histograms(pcts):
    """The JAX tests' histograms (an all-null one and an empty one among
    them) against the JAX package bit for bit and Spark's scalar
    evaluation, whose two roundings the fused interpolation may differ
    from in the last bits."""
    values, valid, counts, offsets = [], [], [], [0]
    for h in ORACLE_HISTOGRAMS:
        for v, f in h:
            values.append(0 if v is None else v)
            valid.append(v is not None)
            counts.append(f)
        offsets.append(len(values))
    cols = (np.array(values, np.int32), np.array(valid),
            np.array(counts, np.int64), np.array(offsets, np.int32))
    jl, tl = histogram_columns(*cols, "INT32")
    got = th.percentile_from_histogram(tl, pcts, True)
    assert_same_column(got, jh.percentile_from_histogram(jl, pcts, True))
    for g, h in zip(got.to_pylist(), ORACLE_HISTOGRAMS):
        want = percentile_oracle(h, pcts)
        assert (g is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(g, want, rtol=1e-14, atol=1e-12)


def test_negative_count_counts_as_the_jax_package():
    """Counts 3, -1, 2, 1: the running sums fall, and the element index is
    the count of sums below the target, not a binary search."""
    values, counts, pcts, want = NEGATIVE_COUNT
    cols = (np.array(values), np.ones(4, bool), np.array(counts, np.int64),
            np.array([0, 4], np.int32))
    jl, tl = histogram_columns(*cols, "FLOAT64")
    got = th.percentile_from_histogram(tl, pcts, False)
    assert got.to_pylist() == want
    assert_same_column(got, jh.percentile_from_histogram(jl, pcts, False))
    at = th.percentile_from_histogram(tl, [0.3], False).to_pylist()
    assert at == [1.2]


def test_interpolation_fuses_as_xla_does():
    """-20 and -19, a count each, at 0.1: XLA on the CPU fuses the first
    product into the sum (-19.900000000000002), where Spark's two
    roundings give -19.9; the port gives the JAX package's bits."""
    cols = (np.array([-20, -19], np.int32), np.ones(2, bool),
            np.ones(2, np.int64), np.array([0, 2], np.int32))
    jl, tl = histogram_columns(*cols, "INT32")
    got = th.percentile_from_histogram(tl, [0.1], False)
    assert got.to_pylist() == [-19.900000000000002]
    assert (0.9 - 0.0) * -20 + (0.1 - 0.0) * -19 == -19.9
    assert_same_column(got, jh.percentile_from_histogram(jl, [0.1], False))


def test_empty_batches_equal_jax():
    for offsets in ([0, 0, 0], [0]):
        cols = (np.zeros(0, np.float64), np.zeros(0, bool),
                np.zeros(0, np.int64), np.array(offsets, np.int32))
        jl, tl = histogram_columns(*cols, "FLOAT64")
        for as_list in (True, False):
            assert_same_column(
                th.percentile_from_histogram(tl, [0.5], as_list),
                jh.percentile_from_histogram(jl, [0.5], as_list))


def test_percentile_errors_equal_jax():
    cases = [(TypeError, JCol.from_pylist([1], jdt.INT32),
              TCol.from_pylist([1], tdt.INT32, device="cpu"))]
    s = ([0, 1], [True, True], [1, 1], [0, 2])
    jl, tl = histogram_columns(np.array(s[0], np.int32), np.array(s[1]),
                               np.array(s[2], np.int64),
                               np.array(s[3], np.int32), "INT32")
    jnull = JCol.make_list(jl.offsets, JCol.make_struct(
        value=JCol.from_pylist([1, 2], jdt.INT32),
        freq=JCol.from_pylist([1, None], jdt.INT64)))
    tnull = TCol.make_list(tl.offsets, TCol.make_struct(
        value=TCol.from_pylist([1, 2], tdt.INT32, device="cpu"),
        freq=TCol.from_pylist([1, None], tdt.INT64, device="cpu")))
    cases.append((ValueError, jnull, tnull))
    jstr = JCol.make_list(jl.offsets, JCol.make_struct(
        value=JCol.from_pylist(["a", "b"], jdt.STRING),
        freq=JCol.from_pylist([1, 1], jdt.INT64)))
    tstr = TCol.make_list(tl.offsets, TCol.make_struct(
        value=TCol.from_pylist(["a", "b"], tdt.STRING, device="cpu"),
        freq=TCol.from_pylist([1, 1], tdt.INT64, device="cpu")))
    cases.append((TypeError, jstr, tstr))
    for kind, j, t in cases:
        with pytest.raises(kind) as want:
            jh.percentile_from_histogram(j, [0.5], False)
        with pytest.raises(kind) as got:
            th.percentile_from_histogram(t, [0.5], False)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("as_lists", [True, False])
@pytest.mark.parametrize("kind", ["INT32", "FLOAT64"])
def test_create_histogram_equals_jax(kind, as_lists):
    """With zero frequencies and null values, without zeros (the input
    passes through), and zero rows."""
    rng = np.random.default_rng(4)
    n = 500
    values = rng.integers(-50, 50, n).astype(VALUE_KINDS[kind])
    valid = rng.random(n) > 0.2
    jt, tt = jdt.DType(jdt.Kind[kind]), tdt.DType(tdt.Kind[kind])
    for freqs, ok in ((rng.integers(0, 5, n), valid),
                      (rng.integers(1, 5, n), valid),
                      (rng.integers(0, 5, n), None),
                      (np.zeros(0, np.int64), None)):
        v = values[:len(freqs)]
        ok = None if ok is None else ok[:len(freqs)]
        want = jh.create_histogram_if_valid(
            JCol.from_numpy(v, jt, validity=ok),
            JCol.from_numpy(freqs.astype(np.int64), jdt.INT64), as_lists)
        got = th.create_histogram_if_valid(
            TCol.from_numpy(v, tt, ok, device="cpu"),
            TCol.from_numpy(freqs.astype(np.int64), tdt.INT64,
                            device="cpu"), as_lists)
        assert_same_column(got, want)


def test_create_histogram_errors_equal_jax():
    jv = JCol.from_pylist([1], jdt.INT32)
    tv = TCol.from_pylist([1], tdt.INT32, device="cpu")
    cases = [(TypeError, [1], jdt.INT32, tdt.INT32),
             (ValueError, [-1], jdt.INT64, tdt.INT64),
             (ValueError, [None], jdt.INT64, tdt.INT64),
             (ValueError, [1, 2], jdt.INT64, tdt.INT64)]
    for kind, freqs, jt, tt in cases:
        with pytest.raises(kind) as want:
            jh.create_histogram_if_valid(jv, JCol.from_pylist(freqs, jt),
                                         False)
        with pytest.raises(kind) as got:
            th.create_histogram_if_valid(
                tv, TCol.from_pylist(freqs, tt, device="cpu"), False)
        assert str(got.value) == str(want.value)


def test_facade_equals_jax():
    """`api.Histogram` over the inputs of the tests above (the JAX package's
    programs for those shapes are compiled already)."""
    rng = np.random.default_rng(4)
    values = rng.integers(-50, 50, 500).astype(np.float64)
    valid = rng.random(500) > 0.2
    freqs = rng.integers(0, 5, 500).astype(np.int64)
    jh_ = japi.Histogram.createHistogramIfValid(
        JCol.from_numpy(values, jdt.FLOAT64, validity=valid),
        JCol.from_numpy(freqs, jdt.INT64), True)
    th_ = api.Histogram.createHistogramIfValid(
        TCol.from_numpy(values, tdt.FLOAT64, valid, device="cpu"),
        TCol.from_numpy(freqs, tdt.INT64, device="cpu"), True)
    assert_same_column(th_, jh_)
    jl, tl = histogram_columns(*data("FLOAT64"), "FLOAT64")
    for as_list in (True, False):
        assert_same_column(
            api.Histogram.percentileFromHistogram(tl, tuple(PCTS), as_list),
            japi.Histogram.percentileFromHistogram(jl, tuple(PCTS), as_list))


def test_admitted_factors_equal_jax():
    names = ["from_timestamp_to_utc_timestamp",
             "from_utc_timestamp_to_timestamp", "rebase_gregorian_to_julian",
             "rebase_julian_to_gregorian", "interleave_bits",
             "hilbert_index", "create_histogram_if_valid",
             "percentile_from_histogram"]
    assert {k: tops._ADMITTED_FACTORS[k] for k in names} == \
        {k: jops._ADMITTED_FACTORS[k] for k in names}
    assert "is_supported_time_zone" not in tops._ADMITTED_FACTORS
    assert "is_supported_time_zone" not in jops._ADMITTED_FACTORS
    assert callable(tops.is_supported_time_zone) and tops.TimeZoneDB


# ---- the kernel's CPU mirror and row code -------------------------------------

def _inputs(kind, negative):
    _, tl = histogram_columns(*data(kind, negative), kind)
    value_col, count_col = tl.children[0].children
    return (value_col.data.to(torch.float64), value_col.null_mask,
            count_col.data, tl.offsets,
            torch.tensor(PCTS, dtype=torch.float64))


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("kind", ["FLOAT64", "INT32"])
def test_mirror_equals_plain(kind, negative):
    want = th.percentile_plain(*_inputs(kind, negative))
    got = histogram_cuda.percentile_mirror(*_inputs(kind, negative))
    assert torch.equal(got[0].view(torch.int64), want[0].view(torch.int64))
    assert torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("histogram", tmp_path_factory.mktemp("histogram_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "code")
    P, I, N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_percentile.argtypes = [P, P, P, P, N, N, P, I, P, P, P]
    return lib


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("kind", VALUE_KINDS)
def test_kernel_rows_equal_plain(host_lib, kind, negative):
    values, valid, counts, offsets, pct = _inputs(kind, negative)
    want = th.percentile_plain(values, valid, counts, offsets, pct)
    s_vals, s_valid, s_counts = histogram_cuda.sorted_inputs(
        values, valid, counts, offsets)
    n_hist, m = offsets.numel() - 1, values.numel()
    out = torch.empty((n_hist, pct.numel()), dtype=torch.float64)
    out_valid = torch.empty(n_hist, dtype=torch.bool)
    acc = torch.empty(m, dtype=torch.int64)
    assert host_lib.host_percentile(
        s_vals.data_ptr(), s_valid.contiguous().data_ptr(),
        s_counts.data_ptr(), offsets.data_ptr(), n_hist, m, pct.data_ptr(),
        pct.numel(), acc.data_ptr(), out.data_ptr(),
        out_valid.data_ptr()) == 0
    assert torch.equal(out.view(torch.int64), want[0].view(torch.int64))
    assert torch.equal(out_valid, want[1])


def test_emulated_fma_rounds_once():
    """The plain version's fused multiply-add against exact rationals."""
    from fractions import Fraction
    rng = np.random.default_rng(8)
    a = rng.standard_normal(4000) * 2.0 ** rng.integers(-40, 40, 4000)
    b = rng.standard_normal(4000) * 2.0 ** rng.integers(-40, 40, 4000)
    c = -(a * b) * (1 + rng.integers(-3, 3, 4000) * 2.0 ** -52)
    c[::2] = rng.standard_normal(2000)
    got = th.fma(*(torch.tensor(x) for x in (a, b, c))).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a.tolist(), b.tolist(), c.tolist())]
    np.testing.assert_array_equal(got, np.array(want))
