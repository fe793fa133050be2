"""TopK: the first n rows of a stable multi-key sort. The plain PyTorch
version, the kernel's key descriptor and route rule, the CPU mirror of
the kernel's encoding, and the registry's signature.

Counterpart of the wiring half of `spark_rapids_tpu/ops/topk_pallas.py`
(`_order_words`, `make_signature`, `_supports`); the CUDA kernels are in
`topk_cuda.py`. `topk_plain` is what the eager tier's TopK computes
without the kernel: `sort_table` then `slice_table(0, min(n, rows))`;
`topk_capped_plain` the capped tier's (the reference's `topk_capped`):
the top n live rows, as `sort_table_capped` orders them;
`topk_capped_mirror` the capped kernels' CPU mirror, in their candidate
order (a dead row is an all-ones sentinel tuple). `PLAIN_CALLS` counts
the runs of all three.

The kernels compare tuples of 64-bit words (`order_words`): a null rank
per nullable key, one value word per key, the row index last. They build
the words from the key columns themselves, from the descriptor
`describe_keys` gives; `encode_words` is that encoding run with torch ops
on the CPU (no path on the card uses it), held equal to `order_words` by
the tests.

Which kernel takes a call is one rule, `threshold_route`: the threshold
kernel takes every limit k and tuple width W whose best set (twice k
tuples) and candidate buffer (BUFFER tuples) fit in the card's opt-in
shared memory per block (`threshold_smem`; with W = 4 up to k = 2,989 on
an H100's 227 KB). Larger calls take the tile sort and merge, also
kernels of csrc/topk.cu.

The kernels take any limit n >= 0 (the reference's Pallas kernel took
1..128, its lane width, and only fixed-width keys). They take every key
kind `sort._key_operands` orders but nested ones: a DECIMAL128 key is two
words (its top 64 bits signed, its low 64 bits unsigned), a STRING key
its bytes as big-endian 64-bit words, zero padded to the longest string
of the column, then its length, which orders the bytes as unsigned and
the shorter string first on a shared prefix; the kernels build both from
the limbs and from the chars through the offsets. The string word count
is a host read of the column's longest string (`make_signature`, as the
reference's `padded_chars` reads it). They decline another tier than
eager or capped, and their own limit is MAX_WORDS words per tuple: the
tile sort holds a tile of tuples in shared memory, so the tuple's width
bounds the tile, and a string key longer than 8 * (MAX_WORDS - 3) bytes
declines (on the card, a raise).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import Column, Table
from ..dtypes import Kind
from .copying import slice_table
from .gather import take_table
from .sort import (_key_operands, max_string_length, sort_table,
                   sorted_order)

MAX_WORDS = 96    # 64-bit words per tuple (csrc/topk.cu TK_MAX_WORDS)
TILE_ROWS = 2048  # rows a threshold block compares per step (TK_TILE)
BUFFER = 2 * TILE_ROWS   # candidate ids a threshold block holds (TK_BUF)
MIN_TILES_PER_BLOCK = 8
# a threshold block's copy of the descriptor: a key entry (32 bytes) and a
# rank flag a word (csrc/topk.cu sizeof(Words))
_WORDS_SMEM = 32 * (MAX_WORDS - 1) + MAX_WORDS


def threshold_smem(k: int, n_words: int) -> int:
    """Shared bytes of one threshold block (csrc/topk.cu
    tk_threshold_smem): the descriptor's copy; the ids of the best k and
    of the buffer, and one word of each; the threshold; the best k's
    tuples; the flush's reductions, histogram, scalars and element
    states; the final sort's permutation."""
    s = k + BUFFER
    return (_WORDS_SMEM + 8 * (2 * s + n_words + n_words * k + 16)
            + 4 * (256 + 8) + -(-s // 8) * 8 + 4 * k)


def threshold_route(k: int, n_words: int, smem_optin: int) -> bool:
    """The route rule: the threshold kernel takes the call when one block's
    shared memory fits the card's opt-in limit per block; the tile sort and
    merge take the rest."""
    return threshold_smem(k, n_words) <= smem_optin


def threshold_grid(rows: int, k: int, sms: int) -> int:
    """Blocks of the threshold kernel: at least MIN_TILES_PER_BLOCK tiles
    each, at most two per SM, and about sqrt(rows / k), which keeps the
    last block's walk over the blocks' k-tuple runs near one block's share
    of rows. An input of fewer than 32,768 rows runs in one block."""
    g = min(rows // (MIN_TILES_PER_BLOCK * TILE_ROWS), 2 * sms,
            math.isqrt(rows // max(k, 1)))
    return max(1, g)


_SUPPORTED_KINDS = frozenset(k.value for k in (
    Kind.BOOL, Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64, Kind.DATE32,
    Kind.TIMESTAMP_US, Kind.TIMESTAMP_S, Kind.TIMESTAMP_MS,
    Kind.DECIMAL32, Kind.DECIMAL64, Kind.FLOAT32, Kind.FLOAT64,
    Kind.DECIMAL128, Kind.STRING))

# key kinds of the descriptor (csrc/topk.cu KIND_*)
KIND_BOOL, KIND_INT, KIND_F32, KIND_F64, KIND_DEC, KIND_STR = range(6)

_SIGN = -(2 ** 63)

PLAIN_CALLS = {"topk": 0}


def topk_plain(table: Table, keys: Sequence[str],
               ascending: Sequence[bool], n: int) -> Table:
    """The first min(n, rows) rows of the stable sort by `keys`."""
    PLAIN_CALLS["topk"] += 1
    t = sort_table(table, key_names=list(keys), ascending=list(ascending))
    return slice_table(t, 0, min(n, t.num_rows))


def capped_outputs(table: Table, idx: torch.Tensor, alive: torch.Tensor):
    """The capped TopK's outputs from the row indices `idx` of the k
    smallest tuples, live rows first: (take(table, idx'), out_alive) with
    out_alive = arange(k) < min(k, live rows) and idx' = idx there, 0
    elsewhere. Computed on the device, with no host read."""
    k = idx.shape[0]
    n_live = torch.clamp(alive.sum(), max=k)
    out_alive = torch.arange(k, device=idx.device) < n_live
    idx = torch.where(out_alive, idx, torch.zeros_like(idx))
    return take_table(table, idx, _has_negative=False), out_alive


def empty_capped(table: Table):
    """The capped TopK of an empty table or of n = 0: no rows."""
    idx = torch.zeros(0, dtype=torch.int64, device=table.device)
    return (take_table(table, idx, _has_negative=False),
            torch.zeros(0, dtype=torch.bool, device=table.device))


def topk_capped_plain(table: Table, keys: Sequence[str],
                      ascending: Sequence[bool], n: int,
                      alive: torch.Tensor):
    """The capped tier's TopK: (table of k = min(n, rows) rows, (k,) bool
    alive), the top k rows of the stable sort by `keys` with the dead rows
    sunk to the end (`sort_table_capped`'s order), the slots past the live
    rows gathering row 0."""
    PLAIN_CALLS["topk"] += 1
    k = min(n, table.num_rows)
    if k == 0:
        return empty_capped(table)
    order = sorted_order([table[c] for c in keys], list(ascending),
                         alive=alive).data[:k].to(torch.int64)
    return capped_outputs(table, order, alive)


def topk_capped_mirror(table: Table, keys: Sequence[str],
                       ascending: Sequence[bool], n: int,
                       alive: torch.Tensor):
    """The capped kernels (csrc/topk.cu, capped form) on the CPU, in their
    candidate order: the tuples `encode_words` builds, a dead row's all
    ones (a sentinel, after every real tuple: no candidate), the k =
    min(n, rows) smallest in order, n_live = min(k, live rows) counted
    beside; slot i < n_live gathers its row, the others row 0, dead.
    Equal to `topk_capped_plain`."""
    PLAIN_CALLS["topk"] += 1
    k = min(n, table.num_rows)
    if k == 0:
        return empty_capped(table)
    words = torch.where(alive, encode_words(table, keys, ascending), -1)
    order = torch.arange(table.num_rows, dtype=torch.int64,
                         device=table.device)
    for w in reversed(range(words.shape[0])):  # unsigned order, word by word
        key = (words[w] ^ _SIGN).index_select(0, order)
        order = order.index_select(0, torch.argsort(key, stable=True))
    idx = words[-1].index_select(0, order[:k])
    n_live = torch.clamp(alive.sum(), max=k)
    out_alive = torch.arange(k, device=idx.device) < n_live
    idx = torch.where(out_alive, idx, 0)
    return take_table(table, idx, _has_negative=False), out_alive


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


def value_words(col: Column) -> int:
    """Value words of one key's tuple part: 2 for DECIMAL128, a STRING's
    chars words (8 bytes each, from its longest row: one host read) and
    its length word, 1 otherwise."""
    if col.dtype.kind == Kind.DECIMAL128:
        return 2
    if col.dtype.kind == Kind.STRING:
        return -(-max_string_length(col) // 8) + 1
    return 1


@dataclasses.dataclass(frozen=True)
class KeyDesc:
    """One key of the kernel's descriptor (csrc/topk.cu TkKey)."""
    column: Column
    kind: int            # KIND_*
    width: int           # storage bytes (DECIMAL128: 16, STRING: 1)
    desc: bool           # descending: bitwise NOT of the value
    nulls_first: bool    # the null rank's polarity (ascending: first)
    nw: int = 0          # STRING: chars words (its length word is part nw)


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """The keys, and per tuple word (the row index's excepted) the key it
    comes from, whether it is that key's null rank, and which of the key's
    value words it is (`word_part`: DECIMAL128 0-1, STRING 0..nw)."""
    keys: List[KeyDesc]
    word_key: List[int]
    word_rank: List[bool]
    word_part: List[int]

    @property
    def n_words(self) -> int:
        return len(self.word_key) + 1


def describe_keys(table: Table, keys: Sequence[str],
                  ascending: Sequence[bool],
                  words: Optional[Sequence[int]] = None) -> Descriptor:
    """The kernel's descriptor of `keys`: the operands of `_key_operands`
    with its default null order (NULLS_FIRST ascending, NULLS_LAST
    descending). `words` are the keys' value words (`key_words`), read
    here when not given."""
    if words is None:
        words = key_words(table, keys)
    out, word_key, word_rank, word_part = [], [], [], []
    for i, (name, asc) in enumerate(zip(keys, ascending)):
        col = table[name]
        k = col.dtype.kind
        if k.value not in _SUPPORTED_KINDS:
            raise TypeError(f"the TopK kernels do not take {col.dtype!r} "
                            "keys")
        kind = (KIND_BOOL if k == Kind.BOOL else
                KIND_F32 if k == Kind.FLOAT32 else
                KIND_F64 if k == Kind.FLOAT64 else
                KIND_DEC if k == Kind.DECIMAL128 else
                KIND_STR if k == Kind.STRING else KIND_INT)
        parts = words[i]
        width = (16 if kind == KIND_DEC else 1 if kind == KIND_STR
                 else col.data.element_size())
        out.append(KeyDesc(col, kind, width, not asc, bool(asc),
                           parts - 1 if kind == KIND_STR else 0))
        if col.validity is not None:
            word_key.append(i)
            word_rank.append(True)
            word_part.append(0)
        for part in range(parts):
            word_key.append(i)
            word_rank.append(False)
            word_part.append(part)
    return Descriptor(out, word_key, word_rank, word_part)


def _float_order(bits: torch.Tensor, mag_mask: int, inf: int,
                 nan: int) -> torch.Tensor:
    """`_float_total_order` on the bits, as the kernel computes it."""
    mag = bits & mag_mask
    bits = torch.where(mag == 0, torch.zeros_like(bits), bits)
    bits = torch.where(mag > inf, torch.full_like(bits, nan), bits)
    sign = torch.iinfo(bits.dtype).min
    return torch.where(bits < 0, ~bits ^ sign, bits).to(torch.int64)


def _string_word(col: Column, part: int, nw: int) -> torch.Tensor:
    """Word `part` of a STRING key as the kernel builds it: big-endian
    chars words (unsigned, sign bit flipped to int64 order), then the
    length."""
    lens = col.string_lengths().to(torch.int64)
    if part == nw:
        return lens
    w = torch.zeros(col.length, dtype=torch.int64, device=col.device)
    chars = col.data.to(torch.int64)
    start = col.offsets[:-1].to(torch.int64)
    for b in range(8):
        p = 8 * part + b
        byte = (chars[(start + p).clamp(0, max(chars.numel() - 1, 0))]
                if chars.numel() else torch.zeros_like(w))
        w = (w << 8) | torch.where(lens > p, byte, 0)
    return w ^ _SIGN


def _key_word(key: KeyDesc, rank: bool, part: int = 0) -> torch.Tensor:
    col = key.column
    valid = col.validity
    if rank:
        r = valid if key.nulls_first else ~valid
        return r.to(torch.int64) ^ _SIGN
    d = col.data
    if key.kind == KIND_STR:
        o = _string_word(col, part, key.nw)
    elif key.kind == KIND_DEC:
        w = d.contiguous().view(torch.int64)
        o = w[:, 1] if part == 0 else w[:, 0] ^ _SIGN
    elif key.kind == KIND_BOOL:
        o = (d.view(torch.uint8) != 0).to(torch.int64)
    elif key.kind == KIND_F32:
        o = _float_order(d.view(torch.int32), 0x7FFFFFFF, 0x7F800000,
                         0x7FC00000)
    elif key.kind == KIND_F64:
        o = _float_order(d.view(torch.int64), 0x7FFFFFFFFFFFFFFF,
                         0x7FF0000000000000, 0x7FF8000000000000)
    else:
        o = d.to(torch.int64)
    if key.desc:
        o = ~o
    if valid is not None:
        o = torch.where(valid, o, torch.zeros_like(o))
    return o ^ _SIGN


def encode_words(table: Table, keys: Sequence[str],
                 ascending: Sequence[bool]) -> torch.Tensor:
    """(W, rows) int64: the tuple words as csrc/topk.cu builds them from
    `describe_keys`' descriptor, word by word from the column bits. Equal
    to `order_words` bit for bit; a CPU mirror for the tests."""
    d = describe_keys(table, keys, ascending)
    words = [_key_word(d.keys[i], r, p)
             for i, r, p in zip(d.word_key, d.word_rank, d.word_part)]
    words.append(torch.arange(table.num_rows, dtype=torch.int64,
                              device=table.device))
    return torch.stack(words)


def key_words(table: Table, keys: Sequence[str]) -> Tuple[int, ...]:
    """Per key its value words (`value_words`: a STRING key's a host read
    of its longest row)."""
    return tuple(value_words(table[k]) for k in keys)


def make_signature(table: Table, keys: Sequence[str],
                   ascending: Sequence[bool], n: int, tier: str,
                   words: Optional[Sequence[int]] = None):
    """The keys' kinds and validity, the limit, the tier, and per key its
    value words (`key_words`, read here when not given)."""
    from .registry import Signature
    return Signature.of([table[k] for k in keys], limit=n, tier=tier,
                        words=tuple(words if words is not None
                                    else key_words(table, keys)))


def n_words(sig) -> int:
    """Words per tuple: a null rank per nullable key, its value words, and
    the row index (in either tier: the capped form reads `alive` beside
    the keys)."""
    words = sig.extra("words") or (1,) * len(sig.columns)
    return sum(w + valid for (_, valid), w in zip(sig.columns, words)) + 1


def supports(sig) -> bool:
    if (sig.extra("limit") or 0) < 0:
        return False
    if sig.extra("tier") not in ("eager", "capped"):
        return False
    return (all(k in _SUPPORTED_KINDS for k in sig.kinds)
            and n_words(sig) <= MAX_WORDS)
