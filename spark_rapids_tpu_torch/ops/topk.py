"""TopK: the first n rows of a stable multi-key sort. The plain PyTorch
version, the order words the kernel compares, and the registry's
signature.

Counterpart of the wiring half of `spark_rapids_tpu/ops/topk_pallas.py`
(`_order_words`, `make_signature`, `_supports`); the CUDA kernel is in
`topk_cuda.py`. `topk_plain` is what the eager tier's TopK computes
without the kernel: `sort_table` then `slice_table(0, min(n, rows))`;
`PLAIN_CALLS` counts its runs.

The kernel takes any limit n >= 0 (the reference's Pallas kernel took
1..128, its lane width): up to half a tile it keeps n candidates per
block, above that it sorts whole tiles and merges them (csrc/topk.cu). It
declines another tier than eager or capped and key kinds that are neither
fixed-width integers nor floats (none exist in the port yet). Its own
limit is MAX_WORDS words per tuple: a block sorts a tile of tuples in
shared memory, so the tuple's width bounds the tile.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..columnar import Table
from ..dtypes import Kind
from .copying import slice_table
from .sort import _key_operands, sort_table

MAX_WORDS = 96    # 64-bit words per tuple (csrc/topk.cu TK_MAX_WORDS)

_SUPPORTED_KINDS = frozenset(k.value for k in (
    Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64, Kind.DATE32,
    Kind.TIMESTAMP_US, Kind.TIMESTAMP_S, Kind.TIMESTAMP_MS,
    Kind.DECIMAL32, Kind.DECIMAL64, Kind.FLOAT32, Kind.FLOAT64))

_SIGN = -(2 ** 63)

PLAIN_CALLS = {"topk": 0}


def topk_plain(table: Table, keys: Sequence[str],
               ascending: Sequence[bool], n: int) -> Table:
    """The first min(n, rows) rows of the stable sort by `keys`."""
    PLAIN_CALLS["topk"] += 1
    t = sort_table(table, key_names=list(keys), ascending=list(ascending))
    return slice_table(t, 0, min(n, t.num_rows))


def order_words(table: Table, keys: Sequence[str],
                ascending: Sequence[bool]) -> torch.Tensor:
    """(W, rows) int64 holding the candidate tuples, most significant word
    first: every `_key_operands` operand sign-extended to 64 bits with its
    sign bit flipped (unsigned order = signed order), then the row index.
    Read as unsigned words, the lexicographic order of the tuples is the
    stable sort's order."""
    n = table.num_rows
    words: List[torch.Tensor] = []
    for name, asc in zip(keys, ascending):
        for op in _key_operands(table[name], bool(asc), None):
            words.append(op.to(torch.int64) ^ _SIGN)
    words.append(torch.arange(n, dtype=torch.int64, device=table.device))
    return torch.stack(words)


def make_signature(table: Table, keys: Sequence[str],
                   ascending: Sequence[bool], n: int, tier: str):
    from .registry import Signature
    return Signature.of([table[k] for k in keys], limit=n, tier=tier)


def n_words(sig) -> int:
    """Words per tuple: a null rank per nullable key, one value word per
    key, and the row index."""
    return sum(2 if valid else 1 for _, valid in sig.columns) + 1


def supports(sig) -> bool:
    if (sig.extra("limit") or 0) < 0:
        return False
    if sig.extra("tier") not in ("eager", "capped"):
        return False
    return (all(k in _SUPPORTED_KINDS for k in sig.kinds)
            and n_words(sig) <= MAX_WORDS)
