"""TopK on the card: the CUDA kernel of `csrc/topk.cu` and its wrapper.

Counterpart of `topk_table` in `spark_rapids_tpu/ops/topk_pallas.py`.
`topk_table(table, keys, ascending, n)` gives the first min(n, rows) rows
of the stable sort, ties included, equal to `topk.topk_plain`. The wrapper
builds the order words (`topk.order_words`) with torch ops, runs
`tk_select` over them, then over its candidates until one block remains
(k up to half a tile) or `tk_merge` over its sorted runs until one run
remains (larger k), and gathers the rows at the row indices of the final
k tuples.

The wrapper runs the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises, it never falls back. `LAUNCHES` counts
kernel launches and `PLAIN_CALLS` (`topk.PLAIN_CALLS`) the plain
version's runs, wherever it is called from. Registered as
`topk`/"cuda" for backend "cuda", beside the plain fallback "torch".
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..columnar import Table
from .gather import take_table
from .topk import (MAX_WORDS, PLAIN_CALLS, make_signature, order_words,
                   supports, topk_plain)

__all__ = ["topk_table", "topk_table_cuda", "make_signature", "LAUNCHES",
           "PLAIN_CALLS", "reset_counters"]

LAUNCHES = {"select": 0, "merge": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("topk")
        lib.tk_select.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
        lib.tk_select.restype = ctypes.c_int
        lib.tk_merge.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p]
        lib.tk_merge.restype = ctypes.c_int
        lib.tk_tile_rows.argtypes = [ctypes.c_int]
        lib.tk_tile_rows.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def smallest_tuples(words: torch.Tensor, k: int) -> torch.Tensor:
    """(W, L) int64 with L >= min(k, m): the min(k, m) smallest tuples of
    the (W, m) word matrix first, in order, read as unsigned words, then
    all-ones sentinels or further tuples. Launches `tk_select` until one block remains, or,
    for k above half a tile, once and then `tk_merge` until one run
    remains."""
    lib = _lib()
    W, m = int(words.shape[0]), int(words.shape[1])
    T = lib.tk_tile_rows(W)
    if T == 0 or k < 1 or m == 0:
        raise ValueError(f"the topk kernels take k >= 1, 1..{MAX_WORDS} "
                         f"words and rows > 0; got k={k}, {W} words, {m} "
                         "rows")
    dev = words.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep = min(k, T)

    def select(cur: torch.Tensor, m: int) -> torch.Tensor:
        blocks = (m + T - 1) // T
        out = torch.empty((W, blocks * keep), dtype=torch.int64, device=dev)
        rc = lib.tk_select(cur.data_ptr(), m, W, keep, out.data_ptr(),
                           stream)
        if rc != 0:
            raise RuntimeError(f"topk select kernel: CUDA error {rc}")
        LAUNCHES["select"] += 1
        return out

    out, blocks = select(words.contiguous(), m), (m + T - 1) // T
    # up to half a tile, each pass shrinks the candidates at least twofold
    while blocks > 1 and 2 * k <= T:
        m = blocks * k
        out, blocks = select(out, m), (m + T - 1) // T
    runs, L = blocks, keep
    while runs > 1:
        L2 = min(2 * L, k)
        merged = torch.full((W, (runs + 1) // 2 * L2), -1, dtype=torch.int64,
                            device=dev)
        rc = lib.tk_merge(out.data_ptr(), runs * L, W, L, L2,
                          merged.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"topk merge kernel: CUDA error {rc}")
        LAUNCHES["merge"] += 1
        out, runs, L = merged, (runs + 1) // 2, L2
    return out


def topk_table_cuda(table: Table, keys: Sequence[str],
                    ascending: Sequence[bool], n: int) -> Table:
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the topk kernel runs on CUDA tensors, got {dev}")
    rows = table.num_rows
    m = min(n, rows)
    if m == 0:
        return take_table(table, torch.zeros(0, dtype=torch.int64,
                                             device=dev), _has_negative=False)
    if not supports(make_signature(table, keys, ascending, n, "eager")):
        raise ValueError(f"the topk kernel does not take this call: keys "
                         f"{list(keys)} (1..{MAX_WORDS} tuple words)")
    best = smallest_tuples(order_words(table, keys, ascending), m)
    # the row-index word: real rows precede the sentinels, so the first m
    # tuples are rows
    return take_table(table, best[-1, :m], _has_negative=False)


def topk_table(table: Table, keys: Sequence[str],
               ascending: Sequence[bool], n: int) -> Table:
    """The first min(n, rows) rows of the stable sort by `keys`: the kernel
    on a CUDA table, the plain version on a CPU one."""
    if table.device.type == "cpu":
        return topk_plain(table, keys, ascending, n)
    return topk_table_cuda(table, keys, ascending, n)


from .registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("topk", "torch", fallback=True)
_REGISTRY.register("topk", "cuda", fn=topk_table, backends=("cuda",),
                   supports=supports)
