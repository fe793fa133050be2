"""The port's parse_uri (`spark_rapids_tpu_torch/ops/parse_uri.py`)
against the JAX package's on the same URIs, bit for bit (offsets, chars
and validity); the URI parse kernel's row code (csrc/parse_uri.cu) built
with the host's C++ compiler against the plain version; and `api.ParseURI`.

The JAX functions run at one width (`pad_to`), each result cached for the
module: every call compiles its padded program.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import pytest

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JCol
from spark_rapids_tpu.ops import parse_uri as jpu
from spark_rapids_tpu_torch import api
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import parse_uri as tpu
from spark_rapids_tpu_torch.ops import parse_uri_cuda
from java_uri_oracle import java_uri
from torch_cast_inputs import build_host
from torch_cast_jax import assert_same_strings, string_columns
from torch_uri_json_inputs import host_parse, uri_corpus, uri_params

PAD = 512
PARTS = ["protocol", "host", "query"]
LITERALS = ["query", "a", "", "a=b"]


@functools.lru_cache(None)
def columns():
    """(JAX column, port CPU column) of the corpus: the JAX tests' suites,
    edge rows and fuzzed rows (NUL, bytes from 0x80, control chars, rows
    past 256 bytes)."""
    return string_columns(uri_corpus())


@functools.lru_cache(None)
def param_columns():
    return string_columns(uri_params(3, columns()[1].length))


@functools.lru_cache(None)
def jax_part(part, literal=None):
    jc = columns()[0]
    if part == "query_literal":
        return jpu.parse_uri_to_query_literal(jc, literal, pad_to=PAD)
    if part == "query_column":
        return jpu.parse_uri_to_query_column(jc, param_columns()[0],
                                             pad_to=PAD, param_pad_to=8)
    return getattr(jpu, f"parse_uri_to_{part}")(jc, pad_to=PAD)


@pytest.mark.parametrize("part", PARTS)
def test_parts_equal_jax(part):
    got = getattr(tpu, f"parse_uri_to_{part}")(columns()[1], pad_to=PAD)
    assert_same_strings(got, jax_part(part))


@pytest.mark.parametrize("param", LITERALS)
def test_query_literal_equals_jax(param):
    got = tpu.parse_uri_to_query_literal(columns()[1], param, pad_to=PAD)
    assert_same_strings(got, jax_part("query_literal", param))


def test_query_column_equals_jax():
    """A null parameter row is a null row; its chars stay as the JAX
    package leaves them."""
    got = tpu.parse_uri_to_query_column(columns()[1], param_columns()[1],
                                        pad_to=PAD, param_pad_to=8)
    assert_same_strings(got, jax_part("query_column"))


def test_corpus_equals_the_java_oracle_where_jax_does():
    """The corpus's JAX results agree with tests/java_uri_oracle.py on the
    reference's suites, so the parity above is parity with java.net.URI
    there."""
    from torch_uri_json_inputs import uri_suites
    suites = uri_suites()
    got = [tpu.parse_uri_to_protocol(columns()[1]).to_pylist()[:len(suites)],
           tpu.parse_uri_to_host(columns()[1]).to_pylist()[:len(suites)],
           tpu.parse_uri_to_query(columns()[1]).to_pylist()[:len(suites)]]
    for i, s in enumerate(suites):
        assert (got[0][i], got[1][i], got[2][i]) == java_uri(s), s


def test_errors_equal_jax():
    """`out_pad_to` below the longest span and `pad_to` below the longest
    string raise ValueError, a non-string column TypeError, with the JAX
    package's text."""
    jc, tc = string_columns(["http://a.com/?q=1234567890", "x"])
    for fn, bound in (("parse_uri_to_protocol", 2),
                      ("parse_uri_to_query", 8)):
        with pytest.raises(ValueError) as want:
            getattr(jpu, fn)(jc, out_pad_to=bound)
        with pytest.raises(ValueError) as got:
            getattr(tpu, fn)(tc, out_pad_to=bound)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jpu.parse_uri_to_host(jc, pad_to=8)
    with pytest.raises(ValueError) as got:
        tpu.parse_uri_to_host(tc, pad_to=8)
    assert str(got.value) == str(want.value)
    ji, ti = (JCol.from_pylist([1], jdt.INT32),
              TCol.from_pylist([1], tdt.INT32, device="cpu"))
    for fn, args in (("parse_uri_to_host", ()),
                     ("parse_uri_to_query_literal", ("a",))):
        with pytest.raises(TypeError) as want:
            getattr(jpu, fn)(ji, *args)
        with pytest.raises(TypeError) as got:
            getattr(tpu, fn)(ti, *args)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError) as want:
        jpu.parse_uri_to_query_column(jc, ji)
    with pytest.raises(TypeError) as got:
        tpu.parse_uri_to_query_column(tc, ti)
    assert str(got.value) == str(want.value)


def test_param_pad_to_error_equals_jax():
    """`param_pad_to` below the longest parameter raises the JAX package's
    ValueError, before `pad_to` is checked."""
    jc, tc = string_columns(["http://a.com/?q=1", "x"])
    jp, tp = string_columns(["q", "longer"])
    with pytest.raises(ValueError) as want:
        jpu.parse_uri_to_query_column(jc, jp, pad_to=4, param_pad_to=2)
    with pytest.raises(ValueError) as got:
        tpu.parse_uri_to_query_column(tc, tp, pad_to=4, param_pad_to=2)
    assert str(got.value) == str(want.value) and "pad_to=2" in str(got.value)


def test_ipv4_host_ending_a_row_as_long_as_the_width():
    """The JAX package finds no end for an IPv4 host's last number when the
    host ends a row that fills the padded width; the port reads the host
    at any width, as java.net.URI (ROADMAP queue C, the reference's
    deviation 8)."""
    uri = "http://10.2.3.45"
    jc, tc = string_columns([uri])
    assert jpu.parse_uri_to_host(jc, pad_to=16).to_pylist() == [None]
    assert java_uri(uri)[1] == "10.2.3.45"
    for pad in (16, 32, None):
        assert tpu.parse_uri_to_host(tc, pad_to=pad).to_pylist() == [
            "10.2.3.45"]


def test_empty_and_sliced_columns():
    """No rows, every row null, and offsets that start past 0."""
    empty = TCol.from_pylist([], tdt.STRING, device="cpu")
    assert tpu.parse_uri_to_host(empty).length == 0
    nulls = TCol.from_pylist([None, None], tdt.STRING, device="cpu")
    assert tpu.parse_uri_to_query(nulls).to_pylist() == [None, None]
    full = columns()[1]
    sliced = TCol(tdt.STRING, full.length - 5, full.data, full.validity[5:],
                  full.offsets[5:])
    want = tpu.parse_uri_to_host(full).to_pylist()[5:]
    assert tpu.parse_uri_to_host(sliced).to_pylist() == want


def test_entry_points_count_plain_runs_and_wrappers_take_cuda_only():
    col = TCol.from_pylist(["http://a.com/?x=1"], tdt.STRING, device="cpu")
    tpu.reset_counters()
    tpu.parse_uri_to_protocol(col)
    tpu.parse_uri_to_query_literal(col, "x")
    tpu.parse_uri_to_query_column(col, col)
    assert parse_uri_cuda.PLAIN_CALLS == {
        "protocol": 1, "host": 0, "query": 0, "query_literal": 1,
        "query_column": 1}
    assert sum(parse_uri_cuda.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        parse_uri_cuda.parse(col, "host")


def test_api_parse_uri():
    col = TCol.from_pylist(["https://u@www.a.com:8080/p?q=1&r=2#f", None,
                            "not a uri"], tdt.STRING, device="cpu")
    P = api.ParseURI
    assert P.parseURIProtocol(col).to_pylist() == ["https", None, None]
    assert P.parseURIHost(col).to_pylist() == ["www.a.com", None, None]
    assert P.parseURIQuery(col).to_pylist() == ["q=1&r=2", None, None]
    assert P.parseURIQueryWithLiteral(col, "r").to_pylist() == ["2", None,
                                                                 None]
    params = TCol.from_pylist(["q", "q", None], tdt.STRING, device="cpu")
    assert P.parseURIQueryWithColumn(col, params).to_pylist() == [
        "1", None, None]


# ---- the kernel's row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("parse_uri", tmp_path_factory.mktemp("parse_uri_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernel's row "
                    "code")
    return lib


@functools.lru_cache(None)
def kernel_rows():
    """The corpus and 2,000 more fuzzed rows, with nulls."""
    from torch_uri_json_inputs import fuzz_uris
    rows = uri_corpus() + [None if i % 17 == 0 else u
                           for i, u in enumerate(fuzz_uris(21, 2000))]
    return TCol.from_pylist(rows, tdt.STRING, device="cpu")


@pytest.mark.parametrize("part", PARTS)
def test_kernel_rows_equal_plain(host_lib, part):
    col = kernel_rows()
    got = host_parse(host_lib, col, part)
    assert_same_strings(got, getattr(tpu, f"parse_uri_to_{part}_plain")(col))


@pytest.mark.parametrize("param", LITERALS + ["=", "\x00"])
def test_kernel_literal_rows_equal_plain(host_lib, param):
    col = kernel_rows()
    got = host_parse(host_lib, col, "query_literal", literal=param)
    assert_same_strings(got, tpu.parse_uri_to_query_literal_plain(col, param))


def test_kernel_column_rows_equal_plain(host_lib):
    col = kernel_rows()
    params = TCol.from_pylist(uri_params(5, col.length), tdt.STRING,
                              device="cpu")
    got = host_parse(host_lib, col, "query_column", params=params)
    assert_same_strings(got, tpu.parse_uri_to_query_column_plain(col, params))
