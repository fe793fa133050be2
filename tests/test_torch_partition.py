"""The port's shuffle partitioning (spark_rapids_tpu_torch/parallel/) against
the JAX package on the CPU, on the same numpy inputs.

On CPU tensors the histogram runs its plain PyTorch version, so these tests
hold `partition_ids`, `build_partition_map`, `partition_histogram`,
`partition_ranks` and `build_partition_map_scan` to `parallel/shuffle.py`,
`parallel/partition.py` and `histogram_pallas` (Pallas interpret mode),
including ids outside [0, P) and P above the 128 buckets that
`histogram_pallas` takes (the port's kernel takes any P). Counts, ranks and
maps are integers: the tolerance is exact.
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import Column as JColumn
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.ops import murmur_hash3_32 as j_murmur
from spark_rapids_tpu.parallel import partition as jpart
from spark_rapids_tpu.parallel import shuffle as jshuffle
from spark_rapids_tpu.parallel.partition_pallas import histogram_pallas

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch import ops, parallel
from spark_rapids_tpu_torch.columnar import Column as TColumn
from spark_rapids_tpu_torch.parallel import partition_cuda


def _ids(rng, n, P, outside=0.0):
    """Partition ids in [0, P), a share `outside` of them out of range."""
    part = rng.integers(0, P, n).astype(np.int32)
    if outside:
        bad = rng.random(n) < outside
        part[bad] = rng.choice(np.array([-7, -1, P, P + 3, 2 ** 31 - 1,
                                         -2 ** 31], np.int64),
                               int(bad.sum())).astype(np.int32)
    return part


@pytest.mark.parametrize("P", [1, 3, 8, 64, 200])
def test_partition_ids_match_jax(P):
    rng = np.random.default_rng(P)
    h32 = rng.integers(-2 ** 31, 2 ** 31, 4096, dtype=np.int64)
    h32[:4] = [-2 ** 31, 2 ** 31 - 1, 0, -1]
    h32 = h32.astype(np.int32)
    h64 = rng.integers(-2 ** 62, 2 ** 62, 512, dtype=np.int64)
    for h in (h32, h64):
        want = np.asarray(jshuffle.partition_ids(jnp.asarray(h), P))
        got = parallel.partition_ids(torch.from_numpy(h), P)
        assert got.dtype == torch.int32
        npt.assert_array_equal(got.numpy(), want)
        assert want.min() >= 0 and want.max() < P


@pytest.mark.parametrize("n,P,outside", [(0, 4, 0.0), (1, 1, 0.0),
                                         (257, 4, 0.2), (4096, 8, 0.1),
                                         (4096, 64, 0.0), (3000, 128, 0.05),
                                         (2000, 200, 0.05)])
def test_histograms_match_jax(n, P, outside):
    rng = np.random.default_rng(n + P)
    part = _ids(rng, n, P, outside)
    want = np.asarray(jpart.partition_histogram(jnp.asarray(part), P))
    tp = torch.from_numpy(part)
    got = parallel.partition_histogram(tp, P)
    assert got.dtype == torch.int32
    npt.assert_array_equal(got.numpy(), want)
    npt.assert_array_equal(partition_cuda.histogram_plain(tp, P,
                                                          block_rows=512),
                           want)
    if P <= 128:
        npt.assert_array_equal(
            np.asarray(histogram_pallas(jnp.asarray(part), P)), want)
    else:
        with pytest.raises(ValueError):
            histogram_pallas(jnp.asarray(part), P)


@pytest.mark.parametrize("n,P,outside", [(0, 4, 0.0), (3000, 5, 0.0),
                                         (4096, 16, 0.1)])
def test_ranks_match_jax(n, P, outside):
    rng = np.random.default_rng(n)
    part = _ids(rng, n, P, outside)
    wr, wc = jpart.partition_ranks(jnp.asarray(part), P)
    gr, gc = parallel.partition_ranks(torch.from_numpy(part), P)
    npt.assert_array_equal(gr.numpy(), np.asarray(wr))
    npt.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert gr.dtype == torch.int64 and gc.dtype == torch.int32


@pytest.mark.parametrize("cap_factor", [2.0, 0.5])
@pytest.mark.parametrize("outside", [0.0, 0.1])
def test_sort_partition_map_matches_jax(cap_factor, outside):
    rng = np.random.default_rng(3)
    n, P = 4096, 16
    cap = int(n / P * cap_factor)
    part = _ids(rng, n, P, outside)
    want = jshuffle.build_partition_map(jnp.asarray(part), P, cap)
    got = parallel.build_partition_map(torch.from_numpy(part), P, cap)
    for w, g, dt in zip(want, got, (torch.int32, torch.bool, torch.int32)):
        assert g.dtype == dt
        npt.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cap_factor", [2.0, 0.5])
def test_scan_partition_map_matches_jax_and_the_sort_map(cap_factor):
    rng = np.random.default_rng(4)
    n, P = 4096, 16
    cap = int(n / P * cap_factor)
    part = _ids(rng, n, P)
    want = jpart.build_partition_map_scan(jnp.asarray(part), P, cap)
    tp = torch.from_numpy(part)
    got = parallel.build_partition_map_scan(tp, P, cap)
    for w, g in zip(want, got):
        npt.assert_array_equal(g.numpy(), np.asarray(w))
    g1, v1, c1 = parallel.build_partition_map(tp, P, cap)
    g2, v2, c2 = got
    assert torch.equal(c1, c2) and torch.equal(v1, v2)
    assert torch.equal(g1[v1], g2[v2]) and not bool(g2[~v2].any())
    assert bool((c2 > cap).any()) == (cap_factor < 1)


def test_empty_maps():
    """No rows: every slot invalid. The reference's scan map agrees; its
    sort map fails on the empty gather (ROADMAP queue C)."""
    e = np.zeros(0, np.int32)
    want = jpart.build_partition_map_scan(jnp.asarray(e), 4, 3)
    for got in (parallel.build_partition_map_scan(torch.from_numpy(e), 4, 3),
                parallel.build_partition_map(torch.from_numpy(e), 4, 3)):
        for w, g in zip(want, got):
            npt.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(TypeError):
        jshuffle.build_partition_map(jnp.asarray(e), 4, 3)


@pytest.mark.parametrize("P", [8, 64])
def test_shuffle_chain_matches_jax(P):
    """murmur3 (seed 42) of a key column -> pmod -> counts and maps, as a
    hash shuffle computes them on each executor."""
    rng = np.random.default_rng(P)
    n = 4096
    keys = rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    jh = j_murmur([JColumn(dtype=jdt.INT64, length=n,
                           data=jnp.asarray(keys))], 42)
    th = ops.murmur_hash3_32([TColumn.from_numpy(keys, tdt.INT64,
                                                 device="cpu")], 42)
    jp = jshuffle.partition_ids(jh.data, P)
    tp = parallel.partition_ids(th.data, P)
    npt.assert_array_equal(tp.numpy(), np.asarray(jp))
    cap = (n // P) * 2
    npt.assert_array_equal(parallel.partition_histogram(tp, P).numpy(),
                           np.asarray(histogram_pallas(jp, P)))
    for w, g in zip(jshuffle.build_partition_map(jp, P, cap),
                    parallel.build_partition_map(tp, P, cap)):
        npt.assert_array_equal(g.numpy(), np.asarray(w))
    for w, g in zip(jpart.build_partition_map_scan(jp, P, cap),
                    parallel.build_partition_map_scan(tp, P, cap)):
        npt.assert_array_equal(g.numpy(), np.asarray(w))


def test_histogram_counters_and_the_kernel_refuses_cpu_tensors():
    part = torch.from_numpy(_ids(np.random.default_rng(1), 100, 8))
    partition_cuda.reset_counters()
    parallel.partition_histogram(part, 8)
    parallel.partition_histogram(part, 300)
    # on the CPU the plain version runs, counted; the kernel runs on the card
    assert partition_cuda.PLAIN_CALLS == {"histogram": 2, "exchange_map": 0}
    assert partition_cuda.LAUNCHES == {"histogram": 0, "exchange_map": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        partition_cuda.histogram_cuda(part, 8)
    with pytest.raises(ValueError, match="buckets"):
        partition_cuda.histogram_cuda(part, -1)
