"""The port's bloom filter (`spark_rapids_tpu_torch/ops/bloom_filter.py`)
against the JAX package's, bit for bit: the filter after `put`, `probe`,
`merge`, and Spark's wire bytes in both directions (a filter serialized by
one package, deserialized and probed by the other); the errors' texts; the
bloom kernels' row code (csrc/bloom_filter.cu) built with the host's C++
compiler against the plain version; and `api.BloomFilter`.

Each JAX call compiles per filter size, so the filters are made once for
the module.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JCol
from spark_rapids_tpu.ops import bloom_filter as jbf
from spark_rapids_tpu_torch import api
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import Column as TCol
from spark_rapids_tpu_torch.ops import bloom_filter as tbf
from spark_rapids_tpu_torch.ops import bloom_filter_cuda
from torch_cast_inputs import build_host
from torch_uri_json_inputs import host_bloom, int64_values

SIZES = [1, 3, 64]           # num_longs
NUM_HASHES = {1: 2, 3: 3, 64: 5}


@functools.lru_cache(None)
def columns(seed, n):
    """(JAX column, port CPU column) of INT64 values with nulls."""
    v, valid = int64_values(seed, n)
    return (JCol.from_numpy(v, jdt.INT64, validity=valid),
            TCol.from_numpy(v, tdt.INT64, valid, device="cpu"))


@functools.lru_cache(None)
def filters(num_longs):
    """(JAX filter, port filter) after putting 2,000 values."""
    k = NUM_HASHES[num_longs]
    jc, tc = columns(1, 2000)
    return (jbf.bloom_filter_put(jbf.bloom_filter_create(k, num_longs), jc),
            tbf.bloom_filter_put(tbf.bloom_filter_create(k, num_longs, "cpu"),
                                 tc))


def wire(buf) -> bytes:
    return bytes(np.asarray(buf.cpu() if isinstance(buf, torch.Tensor)
                            else buf, dtype=np.uint8))


@pytest.mark.parametrize("num_longs", SIZES)
def test_put_equals_jax(num_longs):
    """The same bits after put: the serialized bytes (Spark's layout) and
    the JAX package's unpacked bits against the packed words."""
    jf, tf = filters(num_longs)
    assert wire(tbf.bloom_filter_serialize(tf)) == wire(
        jbf.bloom_filter_serialize(jf))
    bits = np.asarray(jf.bits).reshape(num_longs, 64).astype(np.uint64)
    words = (bits << np.arange(64, dtype=np.uint64)).sum(1).view(np.int64)
    np.testing.assert_array_equal(tf.words.numpy(), words)


@pytest.mark.parametrize("num_longs", SIZES)
def test_probe_equals_jax(num_longs):
    """Probed with the put values and new ones: data and validity (null
    rows probed too, as the JAX package does)."""
    jf, tf = filters(num_longs)
    jc, tc = columns(1, 2000)
    jp, tp = columns(2, 1000)
    for j, t in ((jc, tc), (jp, tp)):
        want = jbf.bloom_filter_probe(j, jf)
        got = tbf.bloom_filter_probe(t, tf)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.validity.numpy(),
                                      np.asarray(want.validity))


def test_partly_filled_filter_equals_jax():
    """A filter with about half its bits clear (1,024 rows, 3 hashes, 64
    longs): the same words, and the same probe of new values, some of which
    it misses."""
    jc, tc = columns(3, 1024)
    jf = jbf.bloom_filter_put(jbf.bloom_filter_create(3, 64), jc)
    tf = tbf.bloom_filter_put(tbf.bloom_filter_create(3, 64, "cpu"), tc)
    assert wire(tbf.bloom_filter_serialize(tf)) == wire(
        jbf.bloom_filter_serialize(jf))
    assert bool((tf.words != -1).any())
    jp, tp = columns(2, 1000)
    got = tbf.bloom_filter_probe(tp, tf)
    np.testing.assert_array_equal(
        got.data.numpy(), np.asarray(jbf.bloom_filter_probe(jp, jf).data))
    assert 0 < int(got.data[tp.validity].sum()) < int(tp.validity.sum())


def test_wire_bytes_cross_both_ways():
    """JAX serialize -> port deserialize -> probe, and port serialize ->
    JAX deserialize -> probe: the state carried across."""
    jf, tf = filters(64)
    jp, tp = columns(2, 1000)
    from_jax = tbf.bloom_filter_deserialize(
        np.asarray(jbf.bloom_filter_serialize(jf)), device="cpu")
    assert (from_jax.num_hashes, from_jax.num_longs) == (5, 64)
    assert torch.equal(from_jax.words, tf.words)
    assert torch.equal(tbf.bloom_filter_probe(tp, from_jax).data,
                       tbf.bloom_filter_probe(tp, tf).data)
    from_port = jbf.bloom_filter_deserialize(
        tbf.bloom_filter_serialize(tf).numpy())
    np.testing.assert_array_equal(np.asarray(from_port.bits),
                                  np.asarray(jf.bits))
    np.testing.assert_array_equal(
        np.asarray(jbf.bloom_filter_probe(jp, from_port).data),
        tbf.bloom_filter_probe(tp, tf).data.numpy())


def test_merge_equals_jax():
    k = 3
    parts = [columns(s, 300) for s in (3, 4, 5)]
    jfs = [jbf.bloom_filter_put(jbf.bloom_filter_create(k, 3), j)
           for j, _ in parts]
    tfs = [tbf.bloom_filter_put(tbf.bloom_filter_create(k, 3, "cpu"), t)
           for _, t in parts]
    assert wire(tbf.bloom_filter_serialize(tbf.bloom_filter_merge(tfs))) == \
        wire(jbf.bloom_filter_serialize(jbf.bloom_filter_merge(jfs)))
    # merging the parts equals putting them all
    tall = tfs[0]
    for _, t in parts:
        tall = tbf.bloom_filter_put(tall, t)
    assert torch.equal(tbf.bloom_filter_merge(tfs).words, tall.words)


def _same_error(kind, jax_call, port_call):
    with pytest.raises(kind) as want:
        jax_call()
    with pytest.raises(kind) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_errors_equal_jax():
    jf, tf = filters(3)
    _same_error(ValueError, lambda: jbf.bloom_filter_create(0, 3),
                lambda: tbf.bloom_filter_create(0, 3, "cpu"))
    _same_error(ValueError, lambda: jbf.bloom_filter_create(3, 0),
                lambda: tbf.bloom_filter_create(3, 0, "cpu"))
    _same_error(ValueError, lambda: jbf.bloom_filter_merge([]),
                lambda: tbf.bloom_filter_merge([]))
    _same_error(ValueError,
                lambda: jbf.bloom_filter_merge([jf, jbf.bloom_filter_create(
                    2, 3)]),
                lambda: tbf.bloom_filter_merge([tf, tbf.bloom_filter_create(
                    2, 3, "cpu")]))
    ji = JCol.from_pylist([1], jdt.INT32)
    ti = TCol.from_pylist([1], tdt.INT32, device="cpu")
    _same_error(TypeError, lambda: jbf.bloom_filter_put(jf, ji),
                lambda: tbf.bloom_filter_put(tf, ti))
    _same_error(TypeError, lambda: jbf.bloom_filter_probe(ji, jf),
                lambda: tbf.bloom_filter_probe(ti, tf))
    good = wire(tbf.bloom_filter_serialize(tf))
    header = (1).to_bytes(4, "big") + (3).to_bytes(4, "big")
    for buf in (good[:4], (9).to_bytes(4, "big") + good[4:],
                header + (0).to_bytes(4, "big"), good[:-1]):
        arr = np.frombuffer(buf, np.uint8)
        _same_error(ValueError, lambda: jbf.bloom_filter_deserialize(arr),
                    lambda: tbf.bloom_filter_deserialize(arr, "cpu"))


def test_put_is_functional_and_sort_indices_changes_nothing():
    _, tf = filters(64)
    before = tf.words.clone()
    _, tc = columns(6, 500)
    a = tbf.bloom_filter_put(tf, tc)
    b = tbf.bloom_filter_put(tf, tc, sort_indices=True)
    assert torch.equal(tf.words, before)
    assert torch.equal(a.words, b.words)


def test_counters_and_wrappers_take_cuda_only():
    _, tf = filters(3)
    _, tc = columns(1, 2000)
    tbf.reset_counters()
    tbf.bloom_filter_put(tf, tc)
    tbf.bloom_filter_probe(tc, tf)
    assert bloom_filter_cuda.PLAIN_CALLS == {"put": 1, "probe": 1}
    assert bloom_filter_cuda.LAUNCHES == {"put": 0, "probe": 0}
    with pytest.raises(ValueError, match="CUDA"):
        bloom_filter_cuda.put(tf.words, 3, tc)


def test_api_bloom_filter():
    B = api.BloomFilter
    bf = B.create(3, 100, device="cpu")          # 100 bits -> 2 longs
    assert (bf.num_hashes, bf.num_longs, bf.num_bits) == (3, 2, 128)
    vals = TCol.from_pylist([1, 2, None, 4], tdt.INT64, device="cpu")
    bf = B.put(bf, vals)
    assert B.probe(bf, vals).to_pylist() == [True, True, None, True]
    ser = tbf.bloom_filter_serialize(bf)
    assert B.probe(ser, vals).to_pylist() == [True, True, None, True]
    other = B.put(B.create(3, 100, device="cpu"),
                  TCol.from_pylist([7], tdt.INT64, device="cpu"))
    merged = B.merge([ser.numpy(), other])
    assert merged.device.type == "cpu"
    assert torch.equal(merged.words, bf.words | other.words)


# ---- the kernels' row code, built with the host's C++ compiler -------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host("bloom_filter",
                     tmp_path_factory.mktemp("bloom_filter_host"))
    if lib is None:
        pytest.skip("needs a host C++ compiler to build the kernels' row "
                    "code")
    return lib


@pytest.mark.parametrize("num_longs", SIZES + [1000])
def test_kernel_rows_equal_plain(host_lib, num_longs):
    """The bit indexes, the words after put and the probe, against the
    plain version, on 20,000 rows with nulls."""
    k = NUM_HASHES.get(num_longs, 3)
    _, tc = columns(7, 20000)
    data = tc.data.contiguous()
    got = host_bloom(host_lib, "indexes", data, k, num_longs)
    assert torch.equal(got, tbf.bit_indexes(data, k, num_longs * 64))
    empty = tbf.bloom_filter_create(k, num_longs, "cpu")
    words = host_bloom(host_lib, "put", data, tc.validity, k,
                       empty.words.clone())
    want = tbf.bloom_filter_put_plain(empty, tc)
    assert torch.equal(words, want.words)
    _, probe = columns(8, 5000)
    found = host_bloom(host_lib, "probe", probe.data.contiguous(), k, words)
    assert torch.equal(found, tbf.bloom_filter_probe_plain(probe, want).data)
    if num_longs == 1000:          # about half the bits clear: some misses
        assert bool((words != -1).any()) and not bool(found.all())
