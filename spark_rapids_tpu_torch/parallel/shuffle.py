"""The shuffle: Spark's partitioner, the bucketing of rows by partition,
the mesh and the all-to-all exchange.

Counterpart of `spark_rapids_tpu/parallel/shuffle.py`: `partition_ids`
(`pmod(hash, P)`), `build_partition_map` (one stable sort plus two
searchsorteds, `sort_by_partition`, which `partition.py` shares),
`make_mesh`, `exchange` and `repartition_table`.

The mesh is single-controller, as the reference's: one process drives all
P peers. The reference runs its per-peer body under `shard_map` over P
devices; here a mesh's P peers all live on one device (`Mesh.device`,
the card, or the CPU in tests), as the reference's tests put their
virtual devices on one host. A sharded array is one tensor with the peer
axis leading: peer i owns rows [i*s, (i+1)*s), the layout of the
reference's `NamedSharding(mesh, P("data"))`. The reference's tiled
all_to_all, from the (P_src, P_dst, cap) layout to (P_dst, P_src, cap), is
then a relabelling of buckets: `partition.exchange_map` writes each
receiver's gather map in one pass (the `px_exchange_map` kernel on the
card), and the payload moves by one gather through it. Peers on several
devices, and a process per peer, are ROADMAP queue A item 13's rest.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


class Mesh:
    """A 1-D mesh of P peers on one device: `devices` (P torch.devices, all
    equal), `axis` and `shape` ({axis: P}), so that `mesh.shape[axis]`
    reads as the reference's."""

    def __init__(self, devices: Sequence, axis: str = "data"):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one peer")
        first = _normal(devs[0])
        if any(_normal(d) != first for d in devs[1:]):
            raise NotImplementedError(
                "a mesh's peers must share one device: peers on several "
                "devices are ROADMAP queue A item 13's multi-card half")
        self.devices = devs
        self.axis = axis
        self.shape = {axis: len(devs)}

    @property
    def device(self) -> torch.device:
        return _normal(self.devices[0])

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.size} peers on {self.device}, "
                f"axis={self.axis!r})")


def _normal(d: torch.device) -> torch.device:
    """A device with its index filled in ("cuda" is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh. With `devices` its peers are those (n logical peers on
    one card: `[torch.device("cuda:0")] * n`; tests pass `["cpu"] * n`);
    without, the first `n_devices` CUDA devices, raising ValueError when
    fewer are visible. The reference's `cpu_fallback`, which quietly
    substitutes CPU devices, is not carried."""
    if devices is not None:
        devs = list(devices)
        if n_devices is not None and len(devs) != n_devices:
            raise ValueError(f"requested a {n_devices}-device mesh but "
                             f"{len(devs)} devices were given")
        return Mesh(devs, axis)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is None:
        n_devices = visible
    if visible < n_devices or n_devices < 1:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {visible} "
            f"devices are visible")
    return Mesh([torch.device("cuda", i) for i in range(n_devices)], axis)


def partition_ids(hashes: torch.Tensor, num_partitions: int
                  ) -> torch.Tensor:
    """Spark's `pmod(hash, numPartitions)` partitioner (non-negative mod):
    (n,) int32 in [0, P). `torch.fmod` truncates toward zero like
    `lax.rem`, so a negative remainder is lifted by P; `torch.remainder`
    would follow the divisor's sign instead."""
    h = hashes.to(torch.int32)
    r = torch.fmod(h, num_partitions)
    return torch.where(r < 0, r + num_partitions, r).to(torch.int32)


def sort_by_partition(part: torch.Tensor, num_partitions: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The stable radix-partition step: (order, sorted ids, starts,
    counts), where the rows of bucket b are order[starts[b] : starts[b] +
    counts[b]] in their original order and counts are (P,) int32. Ids
    outside [0, P) sort to either end and fall in no bucket."""
    order = torch.argsort(part, stable=True)
    sorted_part = part[order].contiguous()
    buckets = torch.arange(num_partitions, dtype=part.dtype,
                           device=part.device)
    starts = torch.searchsorted(sorted_part, buckets)
    ends = torch.searchsorted(sorted_part, buckets, right=True)
    return order, sorted_part, starts, (ends - starts).to(torch.int32)


def build_partition_map(part: torch.Tensor, num_partitions: int,
                        capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket rows by partition id into fixed-capacity slots.

    Returns (gather_idx (P, capacity) int32 row indices, valid (P, capacity)
    bool, counts (P,) int32), as the reference does. Rows past `capacity`
    in a bucket are dropped (counts > capacity reports it); ids outside
    [0, P) are never placed. With no rows every slot is invalid (the
    reference's gather fails on an empty shard)."""
    n = part.shape[0]
    dev = part.device
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)[None, :]
    if n == 0:
        counts = torch.zeros(num_partitions, dtype=torch.int32, device=dev)
        gather_idx = torch.zeros((num_partitions, capacity),
                                 dtype=torch.int32, device=dev)
        return gather_idx, slot < counts[:, None], counts
    order, _, starts, counts = sort_by_partition(part, num_partitions)
    src = (starts[:, None] + slot).clamp(0, n - 1)
    valid = slot < counts[:, None]
    return order[src].to(torch.int32), valid, counts


def shards(x: torch.Tensor, n_peers: int) -> torch.Tensor:
    """The (P, s, ...) view of a sharded array; its length must divide
    by the peers, as `shard_map` requires."""
    if x.shape[0] % n_peers:
        raise ValueError(f"a sharded array's {x.shape[0]} rows do not "
                         f"divide over {n_peers} peers")
    return x.view((n_peers, x.shape[0] // n_peers) + tuple(x.shape[1:]))


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the rows for any dtype (unsigned 16/32/64-bit planes
    through their signed bit views: torch on the CPU has no gather for
    them)."""
    signed = _SIGNED.get(x.dtype)
    if signed is None:
        return x.index_select(0, idx)
    return x.view(signed).index_select(0, idx).view(x.dtype)


def where_zero(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where `mask`, zero elsewhere, for any dtype."""
    signed = _SIGNED.get(x.dtype)
    src = x.view(signed) if signed is not None else x
    out = torch.where(mask, src, torch.zeros((), dtype=src.dtype,
                                             device=src.device))
    return out.view(x.dtype) if signed is not None else out


def take_fill(x: torch.Tensor, idx: torch.Tensor, live: torch.Tensor,
              fill) -> torch.Tensor:
    """x[idx] where `live`, `fill` elsewhere, for any dtype: the unsigned
    16/32/64-bit planes move as their signed bit views, since torch on
    the CPU has no gather or select for them."""
    signed = _SIGNED.get(x.dtype)
    src = x.view(signed) if signed is not None else x
    got = src.index_select(0, idx.reshape(-1).to(torch.int64))
    mask = live.reshape((-1,) + (1,) * (got.dim() - 1))
    if signed is not None:
        fill = int(fill)
        if fill >= 2 ** (8 * x.element_size() - 1):
            fill -= 2 ** (8 * x.element_size())
    out = torch.where(mask, got, torch.tensor(fill, dtype=src.dtype,
                                              device=src.device))
    return out.view(x.dtype) if signed is not None else out


def widen_unsigned(x: torch.Tensor) -> torch.Tensor:
    """An unsigned 8/16/32-bit plane (or any signed one) as int64 values:
    through the signed bit view and a mask, since torch on the CPU has no
    uint16/uint32 arithmetic."""
    if x.dtype in (torch.uint16, torch.uint32):
        bits = 8 * x.element_size()
        return x.view(_SIGNED[x.dtype]).to(torch.int64) & ((1 << bits) - 1)
    return x.to(torch.int64)


def narrow_unsigned(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values as an unsigned 8/16/32-bit plane, keeping the low bits
    (a wrap, as a narrowing conversion wraps)."""
    if dtype in (torch.uint16, torch.uint32):
        return x.to(_SIGNED[dtype]).view(dtype)
    return x.to(dtype)


def exchange_parts(part: torch.Tensor, n_peers: int, capacity: int):
    """The map of one exchange: (gidx (P_dst, P_src, cap), counts (P_src,
    P_dst) int32, received valid (P_dst * P_src * cap,) bool) for sharded
    partition ids. The receiver's mask is rebuilt from the sent counts, as
    the reference rebuilds it from the exchanged (P,) counts."""
    from .partition import exchange_map
    gidx, counts = exchange_map(shards(part.to(torch.int32), n_peers),
                                capacity)
    sent = counts.clamp(max=capacity)
    slot = torch.arange(capacity, dtype=torch.int32, device=part.device)
    valid = slot < sent.t()[:, :, None]
    return gidx, counts, valid.reshape(-1)


def exchange(mesh: Mesh, part: torch.Tensor,
             payloads: Sequence[torch.Tensor], capacity: int,
             axis: str = "data"):
    """All-to-all repartition: rows of `payloads` move to the peer given by
    `part` (ids in [0, P)); every array is sharded on its first axis.

    Returns (payloads_out, valid, counts, sent) as the reference does:
    payloads_out (P * P * cap, ...) with peer d's rows at [d*P*cap,
    (d+1)*P*cap), source-major (bucket d of source 0, then of source
    1, ...) and zero in dead slots; valid (P * P * cap,) bool; counts
    (P * P,) int32, source s's bucket histogram at [s*P, (s+1)*P) for
    overflow detection; sent = min(counts, capacity)."""
    P = mesh.shape[axis]
    gidx, counts, valid = exchange_parts(part, P, capacity)
    outs = tuple(take_fill(p, gidx, valid, 0) for p in payloads)
    counts = counts.reshape(-1)
    return outs, valid, counts, counts.clamp(max=capacity)


def repartition_table(mesh: Mesh, hashes: torch.Tensor,
                      columns: Dict[str, torch.Tensor],
                      slack: float = 2.0, axis: str = "data"):
    """Hash-repartition named fixed-width columns across the mesh: the
    capacity from the rows and `slack` (max(1, ceil(n / P / P * slack)),
    in Python floats as the reference computes it), Spark pmod ids from
    `hashes`, then `exchange`. Returns (columns_out, valid, counts,
    capacity); counts > capacity means rows were dropped."""
    n = hashes.shape[0]
    p = mesh.shape[axis]
    capacity = max(1, math.ceil(n / p / p * slack))
    part = partition_ids(hashes, p)
    names = list(columns)
    outs, valid, counts, _ = exchange(mesh, part,
                                      [columns[k] for k in names],
                                      capacity, axis)
    return {k: v for k, v in zip(names, outs)}, valid, counts, capacity
