"""The port's from_json (`spark_rapids_tpu_torch/ops/map_utils.py`) against
the JAX package's on the same JSON rows, bit for bit (list offsets, key
and value strings, validity) and error for error; the JSON kernels' row
code (csrc/map_utils.cu) built with the host's C++ compiler against the
plain version; and `api.MapUtils`.

Each JAX call compiles its padded program, so the corpus goes through the
JAX package once, cached for the module.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JCol
from spark_rapids_tpu.ops import map_utils as jmu
from spark_rapids_tpu_torch import api
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import map_utils as tmu
from spark_rapids_tpu_torch.ops import map_utils_cuda
from torch_cast_inputs import build_host
from torch_cast_jax import assert_same_strings, string_columns
from torch_uri_json_inputs import (host_json_pairs, host_json_rows,
                                   json_corpus, json_objects)


def assert_same_maps(got, want):
    """Two LIST<STRUCT<key, value>> columns equal: list offsets, validity
    (None on both or equal), key and value strings."""
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets))
    assert (got.validity is None) == (want.validity is None)
    np.testing.assert_array_equal(got.null_mask.numpy(),
                                  np.asarray(want.null_mask))
    for g, w in zip(got.children[0].children, want.children[0].children):
        assert_same_strings(g, w)


@functools.lru_cache(None)
def columns():
    """(JAX column, port CPU column): the JSON goldens, edge rows (nesting
    8 deep, '\\"' in values, '{}', '[]', duplicate keys, NUL and bytes
    from 0x80, \\t \\r \\n, rows past 256 bytes) and 600 random objects."""
    return string_columns(json_corpus())


@functools.lru_cache(None)
def jax_map():
    return jmu.from_json(columns()[0])


def test_from_json_equals_jax():
    assert_same_maps(tmu.from_json(columns()[1]), jax_map())


def test_nulls_and_no_pairs_equal_jax():
    """Zero rows, every row null, only empty and non-object rows (no pair),
    and a column whose rows are all valid (no list validity)."""
    for rows in ([], [None, None], ["", "  ", "[1]", None, "{}"],
                 ['{"a": 1}', "{}"]):
        jc, tc = string_columns(rows)
        assert_same_maps(tmu.from_json(tc), jmu.from_json(jc))


@pytest.mark.parametrize("rows", [
    ['{"a": 1}', '{"a": 1', '{"a" 1}'],          # broken, then pair_broken
    ['{"a" 1}', None, '{"a": "x}'],             # pair_broken before broken
    ['{"a": 1}}'],                              # depth below 0
    ['{a: 1}', '{"a" 1}'],                      # unquoted, pair_broken
    ['{"k": 1}', '{k: 2}'],                     # unquoted key
    ['{"a": 1} {"b": 2}'],                      # a second top-level object
    ['{"a": 1} 5 {}'],                          # a trailing value
    ['{"a": "\xe9\x00"', "x"],                  # the message's string
])
def test_errors_equal_jax(rows):
    """The JAX package's order over the whole column, its rows and texts."""
    jc, tc = string_columns(rows)
    with pytest.raises(ValueError) as want:
        jmu.from_json(jc)
    with pytest.raises(ValueError) as got:
        tmu.from_json(tc)
    assert str(got.value) == str(want.value)


def test_null_rows_raise_nothing():
    """A broken row under a null raises nothing, in both packages."""
    jc, tc = string_columns(['{"a": 1', '{"b": 2}'])
    valid = np.array([False, True])
    jc = jc.with_validity(jnp.asarray(valid))
    tc = TCol(tc.dtype, tc.length, tc.data, torch.from_numpy(valid),
              tc.offsets)
    assert_same_maps(tmu.from_json(tc), jmu.from_json(jc))


def test_type_error_and_counters():
    with pytest.raises(TypeError) as want:
        jmu.from_json(JCol.from_pylist([1], jdt.INT32))
    with pytest.raises(TypeError) as got:
        tmu.from_json(TCol.from_pylist([1], tdt.INT32, device="cpu"))
    assert str(got.value) == str(want.value)
    col = TCol.from_pylist(['{"a": 1}'], tdt.STRING, device="cpu")
    tmu.reset_counters()
    tmu.from_json(col)
    assert map_utils_cuda.PLAIN_CALLS == {"from_json": 1}
    assert map_utils_cuda.LAUNCHES == {"from_json": 0}
    with pytest.raises(ValueError, match="CUDA"):
        map_utils_cuda.from_json(col)


def test_api_map_utils():
    col = TCol.from_pylist(['{"a": {"b": 1}, "c": "d"}', None, "[1]"],
                           tdt.STRING, device="cpu")
    assert api.MapUtils.extractRawMapFromJsonString(col).to_pylist() == [
        [{"key": "a", "value": '{"b": 1}'}, {"key": "c", "value": "d"}],
        None, None]


# ---- the kernels' row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("map_utils", tmp_path_factory.mktemp("map_utils_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernels' row "
                    "code")
    return lib


@functools.lru_cache(None)
def kernel_rows():
    """The corpus, 3,000 more random objects and nulls."""
    rows = json_corpus() + [None if i % 13 == 0 else r for i, r in
                            enumerate(json_objects(23, 3000))]
    return TCol.from_pylist(rows, tdt.STRING, device="cpu")


def test_kernel_rows_equal_plain(host_lib):
    """The first pass's validity and pair counts, then the second pass's
    keys and values, against the plain version."""
    col = kernel_rows()
    want = tmu.from_json_plain(col)
    err, valid_out, pairs, key_bytes, value_bytes = host_json_rows(host_lib,
                                                                    col)
    assert not err.any()
    assert torch.equal(valid_out, want.null_mask)
    assert torch.equal(torch.cumsum(pairs, 0, dtype=torch.int32),
                       want.offsets[1:])
    keys, values = host_json_pairs(host_lib, col, pairs, key_bytes,
                                   value_bytes)
    for (offsets, chars), w in zip((keys, values),
                                   want.children[0].children):
        assert torch.equal(offsets, w.offsets)
        assert torch.equal(chars, w.data)


def test_kernel_shape_flags_equal_plain(host_lib):
    """The first pass's error kinds against the plain version's shape
    planes, row by row, on broken, malformed and unquoted rows among good
    ones, and null rows (which raise nothing)."""
    from spark_rapids_tpu_torch.ops.cast_string import padded_chars
    rows = (json_corpus()[:40]
            + ['{"a": 1', '{"a" 1}', '{"a": 1}}', '{a: 1}', '{"a": "x}',
               '{"a": 1} {"b": 2}', '{"a": 1} x', "}", "{", '"', "[{]}",
               '{"a":1,}', '{,"a":1}', '{"a":1,"b"}', '{"a"::1}'])
    col = TCol.from_pylist(rows, tdt.STRING, device="cpu")
    col = TCol(col.dtype, col.length, col.data,
               torch.arange(col.length) % 7 != 3, col.offsets)
    s = tmu.structure_planes(*padded_chars(col))
    valid = col.null_mask
    err = host_json_rows(host_lib, col)[0].to(torch.int64)
    assert torch.equal(err == 1, s["broken"] & valid)
    assert torch.equal(err == 2, s["pair_broken"] & valid & ~s["broken"])
    clean = valid & s["is_object"] & ~s["broken"] & ~s["pair_broken"]
    prow, pcol = torch.nonzero(s["colon1"] & clean[:, None], as_tuple=True)
    *_, quoted = tmu.pair_spans(s, prow, pcol.to(torch.int32))
    unquoted = torch.zeros(col.length, dtype=torch.bool)
    unquoted[prow[~quoted]] = True
    assert torch.equal(err == 3, unquoted)
