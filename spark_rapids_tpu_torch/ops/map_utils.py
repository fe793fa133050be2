"""from_json: a column of JSON objects -> MAP (LIST<STRUCT<key: STRING,
value: STRING>>) of the raw key and value strings.

Counterpart of `spark_rapids_tpu/ops/map_utils.py` (the reference's
map_utils.cu, MapUtils.extractRawMapFromJsonString), with its rules:

- a null row is a null map; an empty or whitespace-only row a valid empty
  map; a valid row that is not an object (its first and last
  non-whitespace bytes not '{' and '}') a null map;
- a 3-state automaton (normal, in a string, after a backslash in a
  string) marks the bytes outside strings; '{' and '[' open a level and
  '}' and ']' close one there, of either kind (mismatched kinds are not
  an error);
- `ValueError`, in this order over the whole column, for the first valid
  row whose string or levels do not close or go below 0 ("invalid JSON"),
  then for the first object row whose top-level ':' and ',' do not pair
  up or that holds anything after its object ("malformed JSON object"),
  then for the first pair whose key is not quoted; each message holds the
  row and its string;
- a pair is a top-level ':' with the span back to the '{' or ',' before
  it (the key) and on to the ',' or closing '}' after it (the value), each
  trimmed of space, tab, newline and carriage return and stripped of its
  quotes when at least 2 bytes long with a '"' at each end; escapes stay
  raw, duplicate keys stay, nested values keep their text.

The entry point runs the JSON kernels (`map_utils_cuda`, csrc/map_utils.cu,
one thread a row) on a CUDA column, or raises; on a CPU column it runs the
plain version (`from_json_plain`): the JAX package's algebra over the
padded (n, L) char matrix in PyTorch, which the tests hold against the
JAX package and the kernels against. The JAX package runs the automaton as
an associative scan of its transition functions; the plain version steps
it along the L positions, every row at once.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import dtypes
from ..columnar import Column
from . import map_utils_cuda
from .cast_string import padded_chars, row_string
from .map_utils_cuda import LAUNCHES, PLAIN_CALLS, reset_counters
from .parse_uri import span_strings, suffix_min

__all__ = ["from_json", "from_json_plain", "LAUNCHES", "PLAIN_CALLS",
           "reset_counters"]

_WS = (ord(" "), ord("\t"), ord("\n"), ord("\r"))


def structure_planes(C: torch.Tensor, lens: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's `_structure_kernel` (map_utils.py:42-133) in
    PyTorch: the top-level colons, the delimiter and non-whitespace scans,
    and each row's shape facts."""
    n, L = C.shape
    dev = C.device
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    live = pos < lens[:, None]
    c = torch.where(live, C, 0)

    # the automaton: 0 normal, 1 in a string, 2 after a backslash in one
    is_quote, is_bslash = c == ord('"'), c == ord("\\")
    state_before = torch.empty((n, L), dtype=torch.int32, device=dev)
    state = torch.zeros(n, dtype=torch.int32, device=dev)
    for p in range(L):
        state_before[:, p] = state
        q = is_quote[:, p]
        state = torch.where(state == 0, q.to(torch.int32),
                            torch.where(state == 1,
                                        torch.where(q, 0, torch.where(
                                            is_bslash[:, p], 2, 1)), 1))
    state_after = torch.cat([state_before[:, 1:], state[:, None]], 1)

    outside = state_before == 0
    open_b = ((c == ord("{")) | (c == ord("["))) & outside
    close_b = ((c == ord("}")) | (c == ord("]"))) & outside
    delta = open_b.to(torch.int32) - close_b.to(torch.int32)
    depth_after = torch.cumsum(delta, 1, dtype=torch.int32)
    depth_before = depth_after - delta

    is_ws = torch.zeros_like(live)
    for w in _WS:
        is_ws |= c == w
    nonws = ~is_ws & live

    first_nw = torch.where(nonws, pos, L).min(1).values
    last_nw = torch.where(nonws, pos, -1).max(1).values
    fc = c.gather(1, first_nw.clamp(0, L - 1).to(torch.int64)[:, None])[:, 0]
    lc = c.gather(1, last_nw.clamp(0, L - 1).to(torch.int64)[:, None])[:, 0]
    empty_row = first_nw >= L
    is_object = ~empty_row & (fc == ord("{")) & (lc == ord("}"))

    last = (lens - 1).clamp(0, L - 1).to(torch.int64)[:, None]
    final_state = torch.where(lens > 0, state_after.gather(1, last)[:, 0], 0)
    final_depth = torch.where(lens > 0, depth_after.gather(1, last)[:, 0], 0)
    neg_depth = (live & (depth_after < 0)).any(1)
    broken = (final_state != 0) | (final_depth != 0) | neg_depth

    top = depth_before == 1
    colon1 = (c == ord(":")) & outside & top
    comma1 = (c == ord(",")) & outside & top
    open_obj = (c == ord("{")) & outside & (depth_before == 0)
    close_obj = (c == ord("}")) & outside & (depth_after == 0)

    nc, nm = colon1.sum(1), comma1.sum(1)
    has_content = (nonws & (depth_before >= 1) & (depth_after >= 1)).any(1)
    pair_broken = is_object & torch.where(has_content, nc != nm + 1,
                                          (nc != 0) | (nm != 0))
    top_junk = nonws & outside & (depth_before == 0) & (depth_after == 0)
    pair_broken |= is_object & ((open_obj.sum(1) != 1) | top_junk.any(1))

    prev_scan = torch.where(open_obj | comma1, pos, -1).cummax(1).values
    next_scan = suffix_min(torch.where(close_obj | comma1, pos, L))
    nnw = suffix_min(torch.where(nonws, pos, L))
    pnw = torch.where(nonws, pos, -1).cummax(1).values
    return dict(colon1=colon1, prev_scan=prev_scan, next_scan=next_scan,
                nnw=nnw, pnw=pnw, chars=c, broken=broken,
                pair_broken=pair_broken, is_object=is_object,
                n_pairs=nc.to(torch.int32), empty_row=empty_row)


def pair_spans(s: Dict[str, torch.Tensor], prow: torch.Tensor,
               pcol: torch.Tensor):
    """The JAX package's `_extract_pairs` spans (map_utils.py:199-221):
    each (row, colon)'s trimmed, quote-stripped key and value as (start,
    end) in the row, and whether the key was quoted."""
    chars = s["chars"]
    L = chars.shape[1]

    def at(plane, idx):
        return plane[prow, idx.clamp(0, L - 1).to(torch.int64)]

    def span(a, b):
        ts = torch.minimum(at(s["nnw"], a), b)
        te = torch.maximum(at(s["pnw"], b - 1) + 1, a)
        empty = ts >= te
        quoted = (~empty & (at(chars, ts) == ord('"'))
                  & (at(chars, te - 1) == ord('"')) & (te - ts >= 2))
        ts = torch.where(quoted, ts + 1, ts)
        te = torch.where(quoted, te - 1, te)
        return ts, torch.where(empty, ts, te), quoted

    prev_d = at(s["prev_scan"], pcol)
    next_d = at(s["next_scan"], pcol + 1)
    k_start, k_end, k_quoted = span(prev_d + 1, pcol)
    v_start, v_end, _ = span(pcol + 1, next_d)
    return k_start, k_end, v_start, v_end, k_quoted


def empty_map(offsets: torch.Tensor, validity, device) -> Column:
    """A LIST<STRUCT<key, value>> column of `offsets` with no pair."""
    struct = Column.make_struct(
        key=Column.from_pylist([], dtypes.STRING, device=device),
        value=Column.from_pylist([], dtypes.STRING, device=device))
    return Column.make_list(offsets, struct, validity)


def from_json_plain(column: Column) -> Column:
    n = column.length
    dev = column.device
    if n == 0:
        return empty_map(torch.zeros(1, dtype=torch.int32, device=dev), None,
                         dev)
    C, lens = padded_chars(column)
    s = structure_planes(C, lens)
    in_valid = column.null_mask
    for flag, what in (("broken", "invalid JSON in row {}"),
                       ("pair_broken", "malformed JSON object in row {}")):
        bad = torch.nonzero(s[flag] & in_valid)
        if bad.numel():
            row = int(bad[0, 0])
            raise ValueError(f"{what.format(row)}: "
                             f"{row_string(column, row)!r}")
    row_ok = in_valid & s["is_object"]
    n_pairs = torch.where(row_ok, s["n_pairs"], 0)
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    torch.cumsum(n_pairs, 0, out=offsets[1:])
    out_valid = in_valid & (row_ok | s["empty_row"])
    validity = None if bool(out_valid.all()) else out_valid
    if int(offsets[-1]) == 0:
        return empty_map(offsets, validity, dev)
    prow, pcol = torch.nonzero(s["colon1"] & row_ok[:, None], as_tuple=True)
    pcol = pcol.to(torch.int32)
    k_start, k_end, v_start, v_end, k_quoted = pair_spans(s, prow, pcol)
    unquoted = torch.nonzero(~k_quoted)
    if unquoted.numel():
        row = int(prow[unquoted[0, 0]])
        raise ValueError(f"JSON object key must be a quoted string (row "
                         f"{row}): {row_string(column, row)!r}")
    base = column.offsets[:-1].to(torch.int64).index_select(0, prow)
    chars = column.data

    def strings(start, end):
        return span_strings(chars, base + start, end - start, None)

    struct = Column.make_struct(key=strings(k_start, k_end),
                                value=strings(v_start, v_end))
    return Column.make_list(offsets, struct, validity)


def from_json(column: Column) -> Column:
    """String column of JSON objects -> LIST<STRUCT<key, value>> raw map
    (MapUtils.extractRawMapFromJsonString, map_utils.cu:649)."""
    if not column.dtype.is_string:
        raise TypeError("from_json expects a string column")
    if column.device.type == "cpu":
        PLAIN_CALLS["from_json"] += 1
        return from_json_plain(column)
    return map_utils_cuda.from_json(column)
