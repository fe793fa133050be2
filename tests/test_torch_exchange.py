"""The port's mesh and exchange (`parallel/shuffle.py`) and the exchange
map (`parallel/partition_cuda.py`, `px_exchange_map`) on the CPU.

- `make_mesh`: the reference's error when too few devices are visible
  (no card here), explicit logical peers on one device, peers on several
  devices refused;
- `exchange` and `repartition_table` against the JAX package's on its
  2- and 4-device CPU meshes, element for element: the padded payloads
  (zero in dead slots), the received valid mask, the per-source counts
  and the sent counts, overflowing capacities and ids outside [0, P)
  included;
- the kernel's PyTorch mirror (its blocks, scan over blocks and in-warp
  ranks) against the plain version (the reference's sort-based map) over
  the corpus: P of 1, 2, 8, 64 and the kernel's largest; shards of 0, 1,
  31, 32, 33 and 2,000 rows; every id in one bucket, zipf ids, ids out of
  range, and caps that overflow; at the kernel's own block size and at
  small blocks that cross many blocks and rounds;
- `dryrun_multichip(2)` on the CPU prints the numbers of the reference's
  `__graft_entry__.dryrun_multichip(2)`, whose steps are run here through
  the JAX package's functions, jit-compiled (its entry runs them eagerly
  under `shard_map`, which takes minutes on the CPU).

Tolerance: exact (integers).
"""
import torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spark_rapids_tpu  # noqa: F401
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import Column as JColumn
from spark_rapids_tpu.columnar import Table as JTable
from spark_rapids_tpu import parallel as jpar
from spark_rapids_tpu.ops import murmur_hash3_32 as j_murmur
from spark_rapids_tpu.ops import xxhash64 as j_xxhash

from spark_rapids_tpu_torch import parallel as tpar
from spark_rapids_tpu_torch.entry import dryrun_multichip
from spark_rapids_tpu_torch.parallel import partition_cuda as pc
from spark_rapids_tpu_torch.parallel.shuffle import Mesh


def _meshes(P):
    return jpar.make_mesh(P), tpar.make_mesh(P, devices=["cpu"] * P)


def _np(xs):
    return [np.asarray(x) for x in xs]


def _t(xs):
    return [x.numpy() for x in xs]


# ---- the mesh -------------------------------------------------------------------

def test_make_mesh_errors_and_shared_devices():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested a 2-device mesh but "
                                             "only 0 devices are visible"):
            tpar.make_mesh(2)
    m = tpar.make_mesh(4, devices=["cpu"] * 4)
    assert m.shape["data"] == 4 and m.device == torch.device("cpu")
    assert tpar.make_mesh(3, axis="x", devices=["cpu"] * 3).shape == {"x": 3}
    with pytest.raises(ValueError, match="3 devices were given"):
        tpar.make_mesh(2, devices=["cpu"] * 3)
    with pytest.raises(NotImplementedError, match="item 13"):
        Mesh(["cpu", "meta"])


# ---- exchange and repartition_table against JAX ---------------------------------

def _exchange_case(P, n_per, cap, seed):
    rng = np.random.default_rng(seed)
    n = P * n_per
    part = rng.integers(0, P, n).astype(np.int32)
    part[rng.random(n) < 0.05] = P          # out of range: no bucket
    keys = rng.integers(-2 ** 40, 2 ** 40, n)
    vals = rng.integers(-9, 9, (n, 3)).astype(np.int32)   # a 2-D payload
    return part, keys, vals, cap


@pytest.mark.parametrize("P,n_per,cap", [(2, 40, 30), (2, 40, 4),
                                         (4, 24, 12), (4, 24, 2)])
def test_exchange_equals_jax(P, n_per, cap):
    part, keys, vals, cap = _exchange_case(P, n_per, cap, seed=P * cap)
    jm, tm = _meshes(P)
    fn = jax.jit(lambda p, k, v: jpar.exchange(jm, p, [k, v], cap))
    (jk, jv), jvalid, jcounts, jsent = fn(jnp.asarray(part),
                                          jnp.asarray(keys),
                                          jnp.asarray(vals))
    (tk, tv), tvalid, tcounts, tsent = tpar.exchange(
        tm, torch.from_numpy(part), [torch.from_numpy(keys),
                                     torch.from_numpy(vals)], cap)
    for j, t in zip(_np([jk, jv, jvalid, jcounts, jsent]),
                    _t([tk, tv, tvalid, tcounts, tsent])):
        assert j.shape == t.shape and j.dtype == t.dtype
        np.testing.assert_array_equal(j, t)
    assert (np.asarray(jcounts) > cap).any() == (cap < n_per // 2)


@pytest.mark.parametrize("P,slack", [(2, 2.0), (4, 0.5)])
def test_repartition_table_equals_jax(P, slack):
    rng = np.random.default_rng(P)
    n = 64 * P
    h = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    cols = {"a": rng.integers(0, 100, n), "b": rng.random(n) < 0.5}
    jm, tm = _meshes(P)
    fn = jax.jit(lambda hh, a, b: jpar.repartition_table(
        jm, hh, {"a": a, "b": b}, slack=slack)[:3])
    jcols, jvalid, jcounts = fn(jnp.asarray(h), jnp.asarray(cols["a"]),
                                jnp.asarray(cols["b"]))
    tcols, tvalid, tcounts, cap = tpar.repartition_table(
        tm, torch.from_numpy(h), {k: torch.from_numpy(v)
                                  for k, v in cols.items()}, slack=slack)
    assert cap == max(1, int(np.ceil(n / P / P * slack)))
    for k in cols:
        np.testing.assert_array_equal(np.asarray(jcols[k]), tcols[k].numpy())
    np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())
    np.testing.assert_array_equal(np.asarray(jcounts), tcounts.numpy())


def test_exchange_runs_the_plain_map_on_the_cpu():
    pc.reset_counters()
    _, tm = _meshes(2)
    tpar.exchange(tm, torch.tensor([0, 1, 1, 0], dtype=torch.int32),
                  [torch.arange(4)], 4)
    assert pc.PLAIN_CALLS["exchange_map"] == 1
    assert pc.LAUNCHES["exchange_map"] == 0


# ---- the kernel's mirror against the plain version ----------------------------

def _ids(rng, P, s, dist):
    if dist == "one":
        return np.full((P, s), P - 1, np.int32)
    if dist == "zipf":
        return ((rng.zipf(1.3, (P, s)) - 1) % P).astype(np.int32)
    ids = rng.integers(-1, P + 1, (P, s)).astype(np.int32)   # some outside
    return ids


_CORPUS = [(P, s, dist) for P in (1, 2, 8, 64)
           for s in (0, 1, 31, 32, 33, 2000) for dist in ("uniform",)]
_CORPUS += [(P, s, dist) for P in (2, 8, 64) for s in (33, 2000)
            for dist in ("one", "zipf")]
_CORPUS += [(pc.MAX_PARTITIONS, 33, "zipf")]


@pytest.mark.parametrize("P,s,dist", _CORPUS)
def test_exchange_map_mirror_equals_plain(P, s, dist):
    rng = np.random.default_rng(P * 7919 + s)
    part = torch.from_numpy(_ids(rng, P, s, dist))
    live = int(((part >= 0) & (part < P)).sum())
    fits = max(1, -(-live // (P * P)) * 2)
    small = max(1, fits // 4)
    # uniform ids at a cap that fits, skewed ones at one that overflows
    for cap in ([fits] if dist == "uniform" else [small]):
        want = pc.exchange_map_plain(part, cap)
        blocks = [(64, 32)] if P > 64 else [(64, 32), (pc.BLOCK_ROWS,
                                                       pc.THREADS)]
        for block_rows, threads in blocks:
            got = pc.exchange_map_mirror(part, cap, block_rows, threads)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        if s > 1 and P > 1 and dist == "one":
            assert int(want[1].max()) > cap      # the small cap overflows


def test_exchange_map_declines_past_its_peers():
    assert pc.MAX_PARTITIONS == 48 * 1024 // (4 * 9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pc.exchange_map_cuda(torch.zeros((2, 3), dtype=torch.int32), 1)


# ---- dryrun_multichip(2) ---------------------------------------------------------

def _reference_dryrun_lines(P):
    """The reference's `dryrun_multichip(P)` lines, its steps through the
    JAX package's functions under jax.jit."""
    from __graft_entry__ import _example_arrays
    mesh = jpar.make_mesh(P)
    n = 16 * P
    keys, vals = _example_arrays(n=n, seed=1)

    def step(keys, vals):
        t = JTable([JColumn(dtype=jdt.INT64, length=n, data=keys)])
        part = jpar.partition_ids(j_murmur(t, seed=42).data, P)
        (k2, v2), valid, counts, _ = jpar.exchange(mesh, part, [keys, vals],
                                                   64)
        t2 = JTable([JColumn(dtype=jdt.INT64, length=k2.shape[0], data=k2),
                     JColumn(dtype=jdt.INT64, length=v2.shape[0], data=v2)])
        live = jnp.where(valid, j_xxhash(t2).data, jnp.int64(0))
        return jnp.sum(live), jnp.sum(counts)

    out = jax.jit(step)(keys, vals)
    lines = [f"dryrun_multichip({P}): checksum={int(out[0])} "
             f"rows={int(out[1])}"]
    small = jnp.asarray(np.arange(n, dtype=np.int64) % 7)
    gk, (gsum, gcnt), gvalid, _ = jax.jit(
        lambda k, v: jpar.distributed_groupby(mesh, k, v, ["sum", "count"],
                                              key_cap=16))(small, vals)
    lines.append(f"dryrun_multichip({P}): distributed groupby "
                 f"{int(jnp.sum(gvalid))} groups over "
                 f"{int(jnp.sum(jnp.where(gvalid, gcnt, 0)))} rows OK")
    rk = jnp.asarray(np.arange(0, n, 2, dtype=np.int64))
    rv = jnp.asarray(np.arange(n // 2, dtype=np.int64))
    ivalid = jax.jit(lambda a, b, c, d: jpar.distributed_inner_join(
        mesh, a, b, c, d, row_cap=n, slack=float(P))[3])(small, vals, rk, rv)
    lines.append(f"dryrun_multichip({P}): distributed inner join "
                 f"{int(jnp.sum(ivalid))} rows OK")
    vocab = ["apple", "banana", "", None, "cherry", "fig", "date", "kiwi"]
    scol = JColumn.from_pylist([vocab[i % len(vocab)] for i in range(n)],
                               jdt.STRING)
    dcol = JColumn.from_pylist(
        [(10 ** 20 + (i % 3)) if i % 5 else None for i in range(n)],
        jdt.decimal(38, 4))
    lw, specs = jpar.encode_key_columns([scol, dcol], max_bytes=[8, None])
    rw = [w[::2] for w in lw]
    lv = jnp.arange(n, dtype=jnp.int64)
    rv2 = jnp.arange(n // 2, dtype=jnp.int64)
    s = float(P)
    lj = jax.jit(lambda a, b: jpar.distributed_left_join_keyed(
        mesh, a, [lv], b, [rv2], specs, row_cap=2 * n, slack=s)[4])(lw, rw)
    sv = jax.jit(lambda a, b: jpar.distributed_left_semi_join_keyed(
        mesh, a, [lv], b, specs, slack=s)[2])(lw, rw)
    av = jax.jit(lambda a, b: jpar.distributed_left_anti_join_keyed(
        mesh, a, [lv], b, specs, slack=s)[2])(lw, rw)
    bv = jax.jit(lambda a, b: jpar.distributed_broadcast_join_keyed(
        mesh, a, [lv], b, [rv2], specs, row_cap=2 * n)[3])(lw, rw)
    lines.append(f"dryrun_multichip({P}): typed tier OK "
                 f"(string+decimal128 keys: left join {int(jnp.sum(lj))} "
                 f"rows, semi {int(jnp.sum(sv))} / anti {int(jnp.sum(av))}, "
                 f"broadcast {int(jnp.sum(bv))} rows, global sort {n} rows)")
    return lines


def test_dryrun_multichip_prints_the_reference_numbers():
    pc.reset_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(2, device="cpu")
    got = buf.getvalue().splitlines()
    assert got == _reference_dryrun_lines(2)
    assert pc.PLAIN_CALLS["exchange_map"] > 0
