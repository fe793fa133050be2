"""The repo's entry step on the port: Spark-exact row hashing and a DECIMAL128
multiply over one columnar batch.

Counterpart of `__graft_entry__.entry()` (its lines 25-50), the JAX
package's entry step: the ops a Spark plan leans on hardest, hash
partitioning and join keys, and decimal arithmetic. `entry()` returns
`(step, (keys, vals))`; `step(keys, vals)` builds the two-INT64 table,
hashes it with murmur3_32 (seed 42) and xxhash64 (seed 42), sign-extends
`vals` to decimal(38, 2) limbs and multiplies them by themselves at scale 4
with the interim cast, and returns `(h32, h64, product limbs (n, 4),
overflow)`, as the reference's step does. On the card that is two launches
of the row-hash kernel and one of the decimal kernel.

    python3 -c "from spark_rapids_tpu_torch.entry import entry; \\
        step, args = entry(); print(step(*args))"

`dryrun_multichip(n_peers, device=None)` is the counterpart of
`__graft_entry__.dryrun_multichip` (its lines 52-175): the distributed
tier end to end on a mesh of `n_peers` logical peers on one device (the
card, or `device="cpu"`), printing the reference's lines with the same
numbers: murmur pmod -> exchange -> xxhash64 checksum; a distributed
groupby (7 groups); a distributed inner join; and the typed tier (STRING
and DECIMAL(38,4) keys through the word codec, the left, semi and anti
joins, the broadcast join and the keyed sort).

    python3 -c "from spark_rapids_tpu_torch.entry import \\
        dryrun_multichip; dryrun_multichip(8)"
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from . import device as _device
from . import dtypes
from .columnar import Column, Table
from .ops import multiply_decimal128, murmur_hash3_32, xxhash64

_Arrays = Tuple[torch.Tensor, torch.Tensor]


def example_arrays(n: int = 4096, seed: int = 0,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> _Arrays:
    """(keys, vals) int64 tensors as the reference's `_example_arrays`
    draws them from `np.random.default_rng(seed)`; `device=None` means the
    card."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(2**62), 2**62, size=n, dtype=np.int64)
    vals = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64)
    return torch.tensor(keys, device=dev), torch.tensor(vals, device=dev)


def decimal_limbs(vals: torch.Tensor) -> torch.Tensor:
    """An (n,) int64 tensor as (n, 4) uint32 DECIMAL128 limbs, sign-extended:
    bit views only, no value conversion."""
    halves = vals.contiguous().view(torch.int32).reshape(-1, 2)
    ext = (vals >> 63).to(torch.int32).unsqueeze(1)
    return torch.cat([halves, ext, ext], dim=1).view(torch.uint32)


def step(keys: torch.Tensor, vals: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (murmur3_32 int32 (n,), xxhash64 int64 (n,), vals * vals as
    decimal(38, 4) limbs (n, 4) uint32, overflow bool (n,))."""
    n = int(keys.shape[0])
    t = Table([Column(dtypes.INT64, n, keys), Column(dtypes.INT64, n, vals)])
    h32 = murmur_hash3_32(t, seed=42)
    h64 = xxhash64(t)
    dec = Column(dtypes.decimal(38, 2), n, decimal_limbs(vals))
    overflow, product = multiply_decimal128(dec, dec, 4)
    return h32.data, h64.data, product.data, overflow.data


def entry(n: int = 4096, device: Optional[Union[str, torch.device]] = None,
          seed: int = 0) -> Tuple[Callable, _Arrays]:
    """(step, (keys, vals)) over n rows; `device=None` means the card."""
    return step, example_arrays(n, seed, device)


def dryrun_multichip(n_peers: int,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> None:
    """The distributed tier on `n_peers` logical peers of one device
    (`device=None`: the card); raises on any overflow or wrong count."""
    from .parallel import (distributed_broadcast_join_keyed,
                           distributed_groupby, distributed_inner_join,
                           distributed_left_anti_join_keyed,
                           distributed_left_join_keyed,
                           distributed_left_semi_join_keyed,
                           distributed_sort_keyed, encode_key_columns,
                           exchange, make_mesh, partition_ids)
    dev = _device.resolve(device)
    mesh = make_mesh(n_peers, devices=[dev] * n_peers)
    P = n_peers
    n = 16 * P
    keys, vals = example_arrays(n, seed=1, device=dev)
    capacity = 4 * 16      # generous: no overflow on these shapes

    # 1. Spark murmur3 pmod partitioning (GpuHashPartitioning)
    h = murmur_hash3_32(Table([Column(dtypes.INT64, n, keys)]), seed=42)
    part = partition_ids(h.data, P)
    # 2. the exchange of (keys, vals)
    (k2, v2), valid, counts, _ = exchange(mesh, part, [keys, vals],
                                          capacity)
    # 3. after the shuffle: xxhash64 of the received rows
    m = int(k2.shape[0])
    h2 = xxhash64(Table([Column(dtypes.INT64, m, k2),
                         Column(dtypes.INT64, m, v2)]))
    checksum = int(torch.where(valid, h2.data, 0).sum())
    rows = int(counts.sum())
    print(f"dryrun_multichip({P}): checksum={checksum} rows={rows}")

    # the whole relational step: partial aggregate -> exchange by key
    # hash -> final aggregate
    small_keys = torch.arange(n, dtype=torch.int64, device=dev) % 7
    gk, (gsum, gcnt), gvalid, overflow = distributed_groupby(
        mesh, small_keys, vals, ["sum", "count"], key_cap=16)
    if bool(overflow.any()):
        raise AssertionError("distributed groupby overflowed")
    groups = int(gvalid.sum())
    total = int(torch.where(gvalid, gcnt, 0).sum())
    if (groups, total) != (7, n):
        raise AssertionError((groups, total))
    print(f"dryrun_multichip({P}): distributed groupby "
          f"{groups} groups over {total} rows OK")

    rk = torch.arange(0, n, 2, dtype=torch.int64, device=dev)
    rv = torch.arange(n // 2, dtype=torch.int64, device=dev)
    _, _, _, ivalid, ioverflow = distributed_inner_join(
        mesh, small_keys, vals, rk, rv, row_cap=n, slack=float(P))
    if bool(ioverflow.any()):
        raise AssertionError("distributed inner join overflowed")
    print(f"dryrun_multichip({P}): distributed inner join "
          f"{int(ivalid.sum())} rows OK")

    # the typed tier: STRING and DECIMAL128 keys through the word codec
    vocab = ["apple", "banana", "", None, "cherry", "fig", "date", "kiwi"]
    scol = Column.from_pylist([vocab[i % len(vocab)] for i in range(n)],
                              dtypes.STRING, device=dev)
    dcol = Column.from_pylist(
        [(10 ** 20 + (i % 3)) if i % 5 else None for i in range(n)],
        dtypes.decimal(38, 4), device=dev)
    l_words, specs = encode_key_columns([scol, dcol], max_bytes=[8, None])
    r_words = [w[::2].contiguous() for w in l_words]
    lv = torch.arange(n, dtype=torch.int64, device=dev)
    rv = torch.arange(n // 2, dtype=torch.int64, device=dev)
    _, _, _, _, ljvalid, ljover = distributed_left_join_keyed(
        mesh, l_words, [lv], r_words, [rv], specs, row_cap=2 * n,
        slack=float(P))
    _, _, svalid, sover = distributed_left_semi_join_keyed(
        mesh, l_words, [lv], r_words, specs, slack=float(P))
    _, _, avalid, aover = distributed_left_anti_join_keyed(
        mesh, l_words, [lv], r_words, specs, slack=float(P))
    _, _, sovalid, soover = distributed_sort_keyed(
        mesh, l_words, specs, lv, slack=float(P))
    _, _, _, bvalid, bover = distributed_broadcast_join_keyed(
        mesh, l_words, [lv], r_words, [rv], specs, row_cap=2 * n)
    if any(bool(f.any()) for f in (ljover, sover, aover, soover, bover)):
        raise AssertionError("typed tier overflowed")
    n_live = int(svalid.sum()) + int(avalid.sum())
    if n_live != n or int(sovalid.sum()) != n:
        raise AssertionError((n_live, int(sovalid.sum()), n))
    print(f"dryrun_multichip({P}): typed tier OK "
          f"(string+decimal128 keys: left join {int(ljvalid.sum())} rows, "
          f"semi {int(svalid.sum())} / anti {int(avalid.sum())}, "
          f"broadcast {int(bvalid.sum())} rows, global sort {n} rows)")
