"""TopK on the card: the CUDA kernels of `csrc/topk.cu` and their wrapper.

Counterpart of `topk_table` in `spark_rapids_tpu/ops/topk_pallas.py`.
`topk_table(table, keys, ascending, n)` gives the first min(n, rows) rows
of the stable sort, ties included, equal to `topk.topk_plain`. The wrapper
copies the keys' descriptor (`topk.describe_keys`: pointers, widths,
kinds, directions, validity) into the kernel's argument struct; the
kernels build the order words from the columns themselves. By
`topk.threshold_route` it launches either

- `tk_threshold` once: a persistent grid filtering rows against each
  block's threshold, the last block merging the blocks' runs and writing
  the row indices of the final k; or
- `tk_select_keys` over the rows, a sorted run of each tile's smallest,
  then `tk_merge` over the runs in pairs until one run remains;

and gathers the rows at those row indices.

`topk_capped(table, keys, ascending, n, alive)` is the counterpart of the
reference's `topk_capped` (`topk_pallas.py:179`), the capped tier's TopK:
the same kernels in their capped form, which read `alive` beside the keys
and make a dead row no candidate (the threshold walk drops it, the tile
sort makes it a sentinel), count the live rows in the same pass, and write
the row indices with 0 past n_live = min(k, live rows) and the (k,) alive
mask themselves (the threshold kernel's last block; on the tile route
`tk_capped_final` after the merges); then a gather of the k rows. Equal to
`topk.topk_capped_plain`; `topk.topk_capped_mirror` is its CPU mirror.

The wrapper runs the plain version only for CPU tensors; for CUDA tensors
it launches the kernels or raises, it never falls back. `LAUNCHES` counts
kernel launches, `STRING_LAUNCHES` those of calls with a STRING key, and
`PLAIN_CALLS` (`topk.PLAIN_CALLS`) the plain version's runs, wherever it
is called from. Registered as
`topk`/"cuda" for backend "cuda", beside the plain fallback "torch".
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..columnar import Table
from .gather import take_table
from .topk import (MAX_WORDS, PLAIN_CALLS, describe_keys, empty_capped,
                   key_words, make_signature, supports, threshold_grid,
                   threshold_route, topk_capped_mirror, topk_plain)

__all__ = ["topk_table", "topk_table_cuda", "topk_capped",
           "topk_capped_cuda", "make_signature", "LAUNCHES",
           "STRING_LAUNCHES", "PLAIN_CALLS",
           "reset_counters", "device_limits"]

# "final": the tile route's capped outputs (`tk_capped_final`)
LAUNCHES = {"threshold": 0, "select": 0, "merge": 0, "final": 0}
# the launches of calls with a STRING key among their keys
STRING_LAUNCHES = {"threshold": 0, "select": 0, "merge": 0, "final": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, STRING_LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


class _Key(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("offsets", ctypes.c_void_p),
                ("width", ctypes.c_ubyte), ("kind", ctypes.c_ubyte),
                ("desc", ctypes.c_ubyte), ("nulls_first", ctypes.c_ubyte),
                ("part", ctypes.c_ubyte), ("nw", ctypes.c_ubyte)]


class _Desc(ctypes.Structure):
    _fields_ = [("key", _Key * (MAX_WORDS - 1)),
                ("word_key", ctypes.c_ubyte * MAX_WORDS),
                ("word_rank", ctypes.c_ubyte * MAX_WORDS),
                ("word_part", ctypes.c_ubyte * MAX_WORDS),
                ("W", ctypes.c_int), ("alive", ctypes.c_void_p)]


_LIB = None
_LIMITS: Dict[int, Tuple[int, int]] = {}


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load
        lib = load("topk")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tk_threshold.argtypes = [ctypes.POINTER(_Desc), ll, ci, ci, vp,
                                     vp, vp, vp, vp]
        lib.tk_select_keys.argtypes = [ctypes.POINTER(_Desc), ll, ci, vp, vp,
                                       vp]
        lib.tk_merge.argtypes = [vp, ll, ci, ll, ll, vp, vp]
        lib.tk_capped_final.argtypes = [vp, ci, vp, vp, vp, vp]
        for f in (lib.tk_threshold, lib.tk_select_keys, lib.tk_merge,
                  lib.tk_capped_final):
            f.restype = ci
        lib.tk_tile_rows.argtypes = [ci]
        lib.tk_tile_rows.restype = ci
        lib.tk_threshold_smem.argtypes = [ci, ci]
        lib.tk_threshold_smem.restype = ll
        lib.tk_device_limits.argtypes = [ctypes.POINTER(ci)] * 2
        lib.tk_device_limits.restype = ci
        _LIB = lib
    return _LIB


def device_limits(dev: torch.device) -> Tuple[int, int]:
    """(SMs, opt-in shared bytes per block) of the card, read once."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _LIMITS:
        sms, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(i):
            rc = _lib().tk_device_limits(ctypes.byref(sms),
                                         ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"topk: cudaDeviceGetAttribute error {rc}")
        _LIMITS[i] = (sms.value, smem.value)
    return _LIMITS[i]


def _descriptor(table: Table, keys: Sequence[str],
                ascending: Sequence[bool],
                words: Optional[Sequence[int]] = None) -> _Desc:
    spec = describe_keys(table, keys, ascending, words)
    d = _Desc()
    for i, kd in enumerate(spec.keys):
        c = kd.column
        if c.device != table.device or not c.data.is_contiguous() or (
                c.validity is not None and not c.validity.is_contiguous()) \
                or (c.offsets is not None and not c.offsets.is_contiguous()):
            raise ValueError("topk: key columns must be contiguous and on "
                             f"{table.device}")
        e = d.key[i]
        e.data = c.data.data_ptr()
        e.valid = None if c.validity is None else c.validity.data_ptr()
        e.offsets = None if c.offsets is None else c.offsets.data_ptr()
        e.width, e.kind = kd.width, kd.kind
        e.desc, e.nulls_first = int(kd.desc), int(kd.nulls_first)
        e.nw = kd.nw
    for w, (key, rank, part) in enumerate(zip(spec.word_key, spec.word_rank,
                                              spec.word_part)):
        d.word_key[w], d.word_rank[w] = key, int(rank)
        d.word_part[w] = part
    d.W = spec.n_words
    return d


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"topk {what} kernel: CUDA error {rc}")


def _tile_sort(desc: _Desc, rows: int, k: int, dev: torch.device,
               stream: int, strings: bool = False,
               live: Optional[int] = None) -> torch.Tensor:
    """(W, L) int64 with L >= k: the k smallest tuples first, in order,
    read as unsigned words, then all-ones sentinels or further tuples.
    Launches `tk_select_keys` over the rows, then `tk_merge` until one run
    remains. `live`: the capped form's count of live rows (a pointer to
    one int64 on the device)."""
    lib = _lib()
    W = desc.W
    T = lib.tk_tile_rows(W)
    keep = min(k, T)
    blocks = (rows + T - 1) // T
    out = torch.empty((W, blocks * keep), dtype=torch.int64, device=dev)
    _check(lib.tk_select_keys(ctypes.byref(desc), rows, keep,
                              out.data_ptr(), live, stream), "select")
    LAUNCHES["select"] += 1
    STRING_LAUNCHES["select"] += strings
    runs, L = blocks, keep
    while runs > 1:
        L2 = min(2 * L, k)
        merged = torch.full((W, (runs + 1) // 2 * L2), -1, dtype=torch.int64,
                            device=dev)
        _check(lib.tk_merge(out.data_ptr(), runs * L, W, L, L2,
                            merged.data_ptr(), stream), "merge")
        LAUNCHES["merge"] += 1
        STRING_LAUNCHES["merge"] += strings
        out, runs, L = merged, (runs + 1) // 2, L2
    return out


def _topk_index(table: Table, keys: Sequence[str],
                ascending: Sequence[bool], k: int,
                words: Optional[Sequence[int]] = None,
                alive: Optional[torch.Tensor] = None):
    """(k,) int64 row indices of the k smallest tuples, in order, k >= 1.
    `words` are the keys' value words (`topk.key_words`), read here, once,
    when the caller has not. With `alive` (the capped form): only live
    rows are candidates, and the result is ((k,) row indices, 0 from
    n_live = min(k, live rows) on; (k,) bool, the slots below n_live)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the topk kernel runs on CUDA tensors, got {dev}")
    if words is None:
        words = key_words(table, keys)
    if not supports(make_signature(table, keys, ascending, k, "eager",
                                   words)):
        raise ValueError(f"the topk kernel does not take this call: keys "
                         f"{list(keys)} (1..{MAX_WORDS} tuple words)")
    rows = table.num_rows
    desc = _descriptor(table, keys, ascending, words)
    out_alive = None
    if alive is not None:
        if alive.dtype != torch.bool or tuple(alive.shape) != (rows,) or \
                alive.device != dev or not alive.is_contiguous():
            raise ValueError(f"topk: alive must be a contiguous ({rows},) "
                             f"bool tensor on {dev}")
        desc.alive = alive.data_ptr()
        out_alive = torch.empty(k, dtype=torch.bool, device=dev)
    strings = any(table[c].dtype.is_string for c in keys)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms, smem_optin = device_limits(dev)
    if threshold_route(k, desc.W, smem_optin):
        G = threshold_grid(rows, k, sms)
        idx = torch.empty(k, dtype=torch.int64, device=dev)
        # the blocks' runs, then the call's ticket and (capped) its count
        # of live rows (tk_threshold zeroes both)
        cand = (torch.empty(desc.W * G * k + 2, dtype=torch.int64,
                            device=dev) if G > 1 else None)
        cand_p = ticket_p = None
        if cand is not None:
            cand_p = cand.data_ptr()
            ticket_p = cand_p + 8 * desc.W * G * k
        _check(_lib().tk_threshold(
            ctypes.byref(desc), rows, k, G, cand_p, ticket_p, idx.data_ptr(),
            None if out_alive is None else out_alive.data_ptr(), stream),
            "threshold")
        LAUNCHES["threshold"] += 1
        STRING_LAUNCHES["threshold"] += strings
    elif alive is None:
        # the row-index word: real rows precede the sentinels
        idx = _tile_sort(desc, rows, k, dev, stream, strings)[-1, :k]
    else:
        live = torch.empty(1, dtype=torch.int64, device=dev)
        run = _tile_sort(desc, rows, k, dev, stream, strings,
                         live.data_ptr())
        idx = torch.empty(k, dtype=torch.int64, device=dev)
        _check(_lib().tk_capped_final(run[-1].data_ptr(), k,
                                      live.data_ptr(), idx.data_ptr(),
                                      out_alive.data_ptr(), stream),
               "capped final")
        LAUNCHES["final"] += 1
        STRING_LAUNCHES["final"] += strings
    return idx if alive is None else (idx, out_alive)


def topk_table_cuda(table: Table, keys: Sequence[str],
                    ascending: Sequence[bool], n: int,
                    words: Optional[Sequence[int]] = None) -> Table:
    k = min(n, table.num_rows)
    if k == 0:
        if table.device.type != "cuda":
            raise ValueError(f"the topk kernel runs on CUDA tensors, got "
                             f"{table.device}")
        return empty_capped(table)[0]
    return take_table(table, _topk_index(table, keys, ascending, k, words),
                      _has_negative=False)


def topk_capped_cuda(table: Table, keys: Sequence[str],
                     ascending: Sequence[bool], n: int, alive: torch.Tensor,
                     words: Optional[Sequence[int]] = None):
    k = min(n, table.num_rows)
    if table.device.type != "cuda" or alive.device != table.device:
        raise ValueError(f"the topk kernel runs on CUDA tensors, got "
                         f"{table.device} and {alive.device}")
    if k == 0:
        return empty_capped(table)
    idx, out_alive = _topk_index(table, keys, ascending, k, words,
                                 alive.contiguous())
    return take_table(table, idx, _has_negative=False), out_alive


def topk_capped(table: Table, keys: Sequence[str],
                ascending: Sequence[bool], n: int, alive: torch.Tensor,
                words: Optional[Sequence[int]] = None):
    """The capped tier's TopK: (table of min(n, rows) rows, their alive
    mask), the top rows of the stable sort with the dead rows sunk last;
    the kernels on a CUDA table, their CPU mirror on a CPU one. `words`:
    the keys' value words, when the caller has read them."""
    if table.device.type == "cpu":
        return topk_capped_mirror(table, keys, ascending, n, alive)
    return topk_capped_cuda(table, keys, ascending, n, alive, words)


def topk_table(table: Table, keys: Sequence[str],
               ascending: Sequence[bool], n: int,
               words: Optional[Sequence[int]] = None) -> Table:
    """The first min(n, rows) rows of the stable sort by `keys`: the kernel
    on a CUDA table, the plain version on a CPU one. `words`: the keys'
    value words, when the caller has read them."""
    if table.device.type == "cpu":
        return topk_plain(table, keys, ascending, n)
    return topk_table_cuda(table, keys, ascending, n, words)


from .registry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register("topk", "torch", fallback=True)
_REGISTRY.register("topk", "cuda", fn=topk_table, backends=("cuda",),
                   supports=supports)
