"""The shuffle bucket histogram and the exchange map: CUDA kernels and
their plain versions.

Counterpart of `spark_rapids_tpu/parallel/partition_pallas.py`. The kernel
lives in `ops/csrc/partition_hist.cu` (its header says what it computes and
what bounds it on the card); this module binds it through ctypes.

- `histogram_plain`: the reference's blocked compare-and-reduce
  (`partition.partition_histogram`) in plain PyTorch;
- `histogram_cuda`: the kernel, on CUDA tensors only, for any number of
  buckets (the reference's `histogram_pallas` stops at 128).

`partition.partition_histogram` dispatches between them by the tensor's
device. Both return (P,) int32 counts and never count an id outside
[0, P).

The exchange map (`px_exchange_map` in the same source) is the receiver
side of the all-to-all of P peers on one card: for ids (P, s) and a
capacity, the (P_src, P_dst) counts and the (P_dst, P_src, cap) int32
gather map into the global rows, 0 past each bucket's live slots.

- `exchange_map_plain`: the reference's per-peer map (a stable sort of
  the ids and two searchsorteds, `shuffle.build_partition_map`) moved
  into the received layout; runs on the CPU only;
- `exchange_map_mirror`: the kernel's blocks, scan over blocks and
  in-warp ranks in PyTorch, so that tier-1 holds the kernel's design to
  the plain version;
- `exchange_map_cuda`: the kernel, on CUDA tensors only; P up to
  `MAX_PARTITIONS` (its shared-memory counters), any rows.

`partition.exchange_map` dispatches by device. `LAUNCHES` counts kernel
launches and `PLAIN_CALLS` the plain versions' runs in the dispatchers,
under "histogram" and "exchange_map".
"""
from __future__ import annotations

import ctypes

import torch

_BLOCK = 65536           # rows per compare-and-reduce block
_MAX_BUCKETS = 2 ** 31 - 1   # the kernel's bucket count is a C int

LAUNCHES = {"histogram": 0, "exchange_map": 0}
PLAIN_CALLS = {"histogram": 0, "exchange_map": 0}

# csrc/partition_hist.cu: XM_BLOCK_ROWS, THREADS, and XM_MAX_P = 48 KB of
# shared memory over (WARPS + 1) int32 counters a bucket
BLOCK_ROWS = 8192
THREADS = 256
MAX_PARTITIONS = 48 * 1024 // (4 * (THREADS // 32 + 1))


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def histogram_plain(part: torch.Tensor, num_partitions: int,
                    block_rows: int = _BLOCK) -> torch.Tensor:
    """(P,) int32 bucket counts: per block of rows, compare every id with
    every bucket and sum the matches."""
    buckets = torch.arange(num_partitions, dtype=torch.int32,
                           device=part.device)
    counts = torch.zeros(num_partitions, dtype=torch.int32,
                         device=part.device)
    p32 = part.to(torch.int32)
    for start in range(0, p32.shape[0], block_rows):
        blk = p32[start:start + block_rows]
        counts += (blk[:, None] == buckets[None, :]).sum(0,
                                                         dtype=torch.int32)
    return counts


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..ops.cuda_build import load
        lib = load("partition_hist")
        lib.ph_histogram.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
        lib.ph_histogram.restype = ctypes.c_int
        lib.px_exchange_map.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.px_exchange_map.restype = ctypes.c_int
        for fn in (lib.px_max_partitions, lib.px_block_rows):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if (lib.px_max_partitions() != MAX_PARTITIONS
                or lib.px_block_rows() != BLOCK_ROWS):
            raise RuntimeError("partition_hist.cu's exchange-map limits "
                               "differ from partition_cuda's")
        _LIB = lib
    return _LIB


def histogram_cuda(part: torch.Tensor, num_partitions: int) -> torch.Tensor:
    if not 0 <= num_partitions <= _MAX_BUCKETS:
        raise ValueError(f"the histogram kernel takes 0 to {_MAX_BUCKETS} "
                         f"buckets, got {num_partitions}")
    if part.device.type != "cuda":
        raise ValueError(f"the histogram kernel runs on CUDA tensors, got "
                         f"{part.device}")
    if part.dtype != torch.int32 or part.dim() != 1 or \
            not part.is_contiguous():
        raise TypeError("the histogram kernel takes a contiguous (n,) int32 "
                        "tensor of partition ids")
    counts = torch.zeros(num_partitions, dtype=torch.int32,
                         device=part.device)
    if part.shape[0] == 0 or num_partitions == 0:
        return counts
    rc = _lib().ph_histogram(part.data_ptr(), part.shape[0], num_partitions,
                             counts.data_ptr(),
                             torch.cuda.current_stream(part.device)
                             .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel: CUDA error {rc}")
    LAUNCHES["histogram"] += 1
    return counts


# ---- the exchange map ----------------------------------------------------------

def _check_map_args(part: torch.Tensor, capacity: int) -> None:
    if part.dim() != 2:
        raise ValueError("the exchange map takes (P, s) partition ids, one "
                         "row of the peer axis per source peer")
    if capacity < 1:
        raise ValueError(f"capacity must be at least 1, got {capacity}")
    if part.shape[0] * part.shape[1] > 2 ** 31 - 1:
        raise ValueError("the exchange map's row ids are int32: at most "
                         "2^31 - 1 rows over all peers")


def exchange_map_plain(part: torch.Tensor, capacity: int):
    """(gidx (P, P, cap) int32, counts (P, P) int32): the reference's map of
    each source peer (`shuffle.build_partition_map`) written into the
    receiver's layout, gidx[dst, src, slot] = src * s + row, 0 in dead
    slots."""
    from .shuffle import build_partition_map
    _check_map_args(part, capacity)
    P, s = part.shape
    dev = part.device
    gidx = torch.zeros((P, P, capacity), dtype=torch.int32, device=dev)
    counts = torch.zeros((P, P), dtype=torch.int32, device=dev)
    for src in range(P):
        gi, valid, c = build_partition_map(part[src].to(torch.int32), P,
                                           capacity)
        gidx[:, src] = torch.where(valid, gi + src * s, 0)
        counts[src] = c
    return gidx, counts


def exchange_map_mirror(part: torch.Tensor, capacity: int,
                        block_rows: int = BLOCK_ROWS,
                        threads: int = THREADS):
    """The kernel's computation in PyTorch, step for step: per block of
    `block_rows` rows of a source, its bucket counts (`xm_count`), their
    exclusive scan over the blocks (`xm_scan`), and each row's rank as
    the block's prefix + the earlier rounds of `threads` rows + the same
    id in the round's earlier warps + the same id in the earlier lanes of
    its warp (`xm_rank`). Tests pass small blocks to cross them."""
    _check_map_args(part, capacity)
    if block_rows % threads or threads % 32:
        raise ValueError("block_rows must be whole rounds of whole warps")
    P, s = part.shape
    dev = part.device
    gidx = torch.zeros((P, P, capacity), dtype=torch.int32, device=dev)
    if s == 0:
        return gidx, torch.zeros((P, P), dtype=torch.int32, device=dev)
    nb = -(-s // block_rows)
    rounds, warps = block_rows // threads, threads // 32
    counts = torch.zeros((P, P), dtype=torch.int32, device=dev)
    buckets = torch.arange(P, device=dev)
    for src in range(P):                           # blockIdx.y
        ids = torch.full((nb * block_rows,), -1, dtype=torch.int64,
                         device=dev)
        ids[:s] = part[src].to(torch.int64)
        ids = ids.view(nb, rounds, warps, 32)
        ok = (ids >= 0) & (ids < P)
        hot = ((ids[..., None] == buckets) & ok[..., None]).to(torch.int64)
        block = hot.sum((1, 2, 3))                 # xm_count: (nb, P)
        base = block.cumsum(0) - block             # xm_scan, exclusive
        counts[src] = block.sum(0).to(torch.int32)
        wc = hot.sum(3)                            # (nb, R, W, P)
        per_round = wc.sum(2)                      # (nb, R, P)
        running = base[:, None] + per_round.cumsum(1) - per_round
        earlier_warps = wc.cumsum(2) - wc
        in_warp = hot.cumsum(3) - hot
        rank_at = (running[:, :, None, None] + earlier_warps[..., None, :]
                   + in_warp)
        rank = (rank_at * hot).sum(-1).reshape(-1)[:s]
        keep = ok.reshape(-1)[:s] & (rank < capacity)
        rows = torch.arange(s, device=dev)[keep]
        dst = part[src].to(torch.int64)[keep]
        flat = (dst * P + src) * capacity + rank[keep]
        gidx.view(-1)[flat] = (src * s + rows).to(torch.int32)
    return gidx, counts


def exchange_map_cuda(part: torch.Tensor, capacity: int):
    """The kernel: (gidx (P, P, cap) int32, counts (P, P) int32) for a
    contiguous (P, s) int32 CUDA tensor of ids. Raises KernelDeclinedError
    for a P past `MAX_PARTITIONS`."""
    from ..ops.registry import KernelDeclinedError
    _check_map_args(part, capacity)
    if part.device.type != "cuda":
        raise ValueError(f"the exchange-map kernel runs on CUDA tensors, got "
                         f"{part.device}")
    P, s = part.shape
    if P > MAX_PARTITIONS:
        raise KernelDeclinedError(
            f"the exchange-map kernel takes at most {MAX_PARTITIONS} peers "
            f"(its per-warp counters in 48 KB of shared memory), got {P}")
    part = part.to(torch.int32).contiguous()
    dev = part.device
    gidx = torch.empty((P, P, capacity), dtype=torch.int32, device=dev)
    counts = torch.empty((P, P), dtype=torch.int32, device=dev)
    if s == 0:
        return gidx.zero_(), counts.zero_()
    nb = -(-s // BLOCK_ROWS)
    scratch = torch.empty((P, nb, P), dtype=torch.int32, device=dev)
    rc = _lib().px_exchange_map(
        part.data_ptr(), s, P, capacity, counts.data_ptr(),
        gidx.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exchange-map kernel: CUDA error {rc}")
    LAUNCHES["exchange_map"] += 1
    return gidx, counts
