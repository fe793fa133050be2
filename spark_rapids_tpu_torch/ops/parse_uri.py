"""Spark-compatible URI parsing: protocol, host, query and query(param).

Counterpart of `spark_rapids_tpu/ops/parse_uri.py` (the reference's
parse_uri.cu and ParseURI.java:36-86), with its rules: java.net.URI's RFC
2396 grammar and its deviations, as the JAX package writes them:

- a row is invalid when its bytes are not UTF-8 (overlong forms,
  surrogates, leads 0xC0, 0xC1 and 0xF5-0xFF), hold ASCII below 0x21 or
  0x7F, U+0080-U+00A0, U+1680, U+2000-U+200A, U+2028, U+2029, U+202F,
  U+205F or U+3000, or a '%' without two hex digits inside the row;
- a scheme exists when a ':' precedes every '/', '?' and '#'; a ':' at
  position 0 and an empty scheme-specific part are invalid;
- an empty authority is legal only before a non-empty path or query;
- a server-based authority (user info, an IPv6 literal in brackets, an
  exact IPv4 or a hostname, a port) gives the host; otherwise a legal
  registry authority keeps the row valid with a null host; `getHost()`
  keeps an IPv6 literal's brackets;
- the query-parameter forms match the first '&'-separated pair whose raw
  bytes start with the parameter and an '=' (a parameter may hold '=');
  the literal form needs a non-empty parameter, the column form does not;
- an invalid row nulls every component; a present empty span is "".

Positions are byte positions. Each entry point runs the parse kernel
(`parse_uri_cuda`, csrc/parse_uri.cu, one thread a row over the offsets
and chars) on a CUDA column, or raises; on a CPU column it runs the plain
version (`*_plain`): the JAX package's algebra over the padded (n, L) char
matrix in PyTorch, which the tests hold against the JAX package and the
kernel against. The plain version keeps `pad_to` and `param_pad_to` (the
widths of its char matrices); the kernel reads the chars through the
offsets and needs no width, but takes both as bounds all the same. In both
forms a string longer than `pad_to` or a parameter longer than
`param_pad_to`, and a span longer than `out_pad_to`, raise the JAX
package's ValueError, in its order.

One rule the plain version does not take from the JAX package: there an
exact-IPv4 host that ends a row as long as the padded width has no end for
its last number and is not IPv4 (a null host for 'http://10.2.3.45' when
that row is a 16-byte column's longest), so the result depends on the
width. The plain version pads one byte past the width and the kernel has
no width: both read such a host as IPv4, as java.net.URI does (ROADMAP
queue C, the reference's deviation 8).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..columnar import Column, make_string_column
from . import parse_uri_cuda
from .cast_string import _round_bucket, char_at, padded_chars
from .parse_uri_cuda import LAUNCHES, PLAIN_CALLS, reset_counters

__all__ = ["parse_uri_to_protocol", "parse_uri_to_host", "parse_uri_to_query",
           "parse_uri_to_query_literal", "parse_uri_to_query_column",
           "LAUNCHES", "PLAIN_CALLS", "reset_counters"]

# ---- character classes (RFC 2396 and java.net.URI's deviations) -------------

_ALPHA = (set(range(ord("a"), ord("z") + 1))
          | set(range(ord("A"), ord("Z") + 1)))
_DIGIT = set(range(ord("0"), ord("9") + 1))
_ALNUM = _ALPHA | _DIGIT
_UNRESERVED = _ALNUM | set(map(ord, "-_.!~*'()"))
_RESERVED = set(map(ord, ";/?:@&=+$,[]"))      # java adds [] for IPv6


def _table(allowed, pct=True, other=True):
    """256 flags: the bytes legal in a component. `pct` admits '%' (its two
    hex digits are checked on their own), `other` the bytes from 0x80 (the
    UTF-8 check covers them)."""
    t = [c in allowed for c in range(256)]
    if pct:
        t[ord("%")] = True
    if other:
        t[128:] = [True] * 128
    return t


TABLES = {
    "scheme": _table(_ALNUM | set(map(ord, "+-.")), pct=False, other=False),
    "userinfo": _table(_UNRESERVED | set(map(ord, ";:&=+$,"))),
    "registry": _table(_UNRESERVED | set(map(ord, "$,;:@&=+"))),
    "path": _table(_UNRESERVED | set(map(ord, ":@&=+$,;/"))),
    "uric": _table(_UNRESERVED | _RESERVED),       # query, fragment, opaque
    "hostname": _table(_ALNUM | set(map(ord, "-.")), pct=False, other=False),
    "ipv6": _table(set(map(ord, "0123456789abcdefABCDEF:.")), pct=False,
                   other=False),
    "hex": _table(set(map(ord, "0123456789abcdefABCDEF")), pct=False,
                  other=False),
    "digits": _table(_DIGIT, pct=False, other=False),
    "alpha": _table(_ALPHA, pct=False, other=False),
}

BIG = 1 << 30          # "not found"


# ---- the plain version: the JAX package's algebra over (n, L) planes --------

class _Planes:
    """The padded chars of one column and the plane helpers over them."""

    def __init__(self, C: torch.Tensor, lens: torch.Tensor):
        self.C, self.lens = C, lens
        self.n, self.L = C.shape
        self.pos = torch.arange(self.L, dtype=torch.int32,
                                device=C.device)[None, :]
        self.live = self.pos < lens[:, None]
        self._tables: Dict[str, torch.Tensor] = {}

    def cls(self, name: str) -> torch.Tensor:
        """(n, L) bool: each padded char in the class."""
        if name not in self._tables:
            t = torch.tensor(TABLES[name], dtype=torch.bool,
                             device=self.C.device)
            self._tables[name] = t[self.C.to(torch.int64)]
        return self._tables[name]

    def is_ch(self, b: str) -> torch.Tensor:
        return (self.C == ord(b)) & self.live

    def first(self, mask: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
        """Per row the first True at or after `start`, else BIG."""
        cand = torch.where(mask & (self.pos >= start[:, None]), self.pos, BIG)
        return cand.min(1).values

    def in_range(self, start, end) -> torch.Tensor:
        return (self.pos >= start[:, None]) & (self.pos < end[:, None])

    def all_in(self, ok, start, end) -> torch.Tensor:
        return (ok | ~self.in_range(start, end)).all(1)

    def ch_at(self, idx: torch.Tensor) -> torch.Tensor:
        """chars[row, idx], 0 outside the row."""
        inside = (idx >= 0) & (idx < self.lens)
        return torch.where(inside, char_at(self.C, idx), 0)


def _next(x: torch.Tensor, k: int) -> torch.Tensor:
    """x shifted left by k columns (the value k positions on), zero-filled."""
    return torch.cat([x[:, k:], torch.zeros_like(x[:, :k])], 1)


def _prev(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:, :k]), x[:, :-k]], 1)


def suffix_min(x: torch.Tensor) -> torch.Tensor:
    """Per row, the least value at or after each column."""
    return x.flip(1).cummin(1).values.flip(1)


def _ipv4_ok(P: _Planes, start, end) -> torch.Tensor:
    """Exact dotted-quad IPv4 over [start, end): 4 numbers of 1-3 digits,
    each at most 255 (java's parseIPv4Address)."""
    C, pos = P.C, P.pos
    in_r = P.in_range(start, end)
    digit = P.cls("digits") & in_r
    dot = P.is_ch(".") & in_r
    chars_ok = (digit | dot | ~in_r).all(1)
    three_dots = dot.sum(1) == 3
    prev_dot = _prev(dot, 1)
    adj = (dot & prev_dot).any(1)
    at_start = pos == start[:, None]
    at_last = pos == end[:, None] - 1
    edge_dot = (dot & (at_start | at_last)).any(1)
    qstart = digit & (at_start | prev_dot)
    stop = torch.where(dot | (pos >= end[:, None]), pos, BIG)
    run_end = suffix_min(stop)
    qlen = torch.where(qstart, run_end - pos, 1)
    len_ok = (qlen <= 3).all(1)
    ch1, ch2 = _next(C, 1), _next(C, 2)
    two, five = ord("2"), ord("5")
    over255 = (C > two) | ((C == two) & ((ch1 > five)
                                          | ((ch1 == five) & (ch2 > five))))
    big_quad = (qstart & (qlen == 3) & over255).any(1)
    return (chars_ok & three_dots & ~adj & ~edge_dot & len_ok & ~big_quad
            & (end > start))


def _utf8_and_charset_valid(P: _Planes) -> torch.Tensor:
    """Per row: UTF-8, and no control or Unicode space code point."""
    c, live = P.C, P.live
    n1, n2, n3 = _next(c, 1), _next(c, 2), _next(c, 3)
    l1, l2, l3 = _next(live, 1), _next(live, 2), _next(live, 3)
    cont = lambda x: (x & 0xC0) == 0x80            # noqa: E731
    lead2 = (c >= 0xC2) & (c <= 0xDF)
    lead3 = (c >= 0xE0) & (c <= 0xEF)
    lead4 = (c >= 0xF0) & (c <= 0xF4)
    bad_lead = ((c == 0xC0) | (c == 0xC1) | (c >= 0xF5)) & live
    ok2 = lead2 & cont(n1) & l1
    ok3 = (lead3 & cont(n1) & cont(n2) & l2 & ((c != 0xE0) | (n1 >= 0xA0))
           & ((c != 0xED) | (n1 <= 0x9F)))
    ok4 = (lead4 & cont(n1) & cont(n2) & cont(n3) & l3
           & ((c != 0xF0) | (n1 >= 0x90)) & ((c != 0xF4) | (n1 <= 0x8F)))
    p1, p2, p3 = _prev(c, 1), _prev(c, 2), _prev(c, 3)
    claimed = (((p1 >= 0xC2) & (p1 <= 0xF4)) | ((p2 >= 0xE0) & (p2 <= 0xF4))
               | ((p3 >= 0xF0) & (p3 <= 0xF4)))
    seq_ok = torch.where(
        live, torch.where(c < 0x80, True,
                          torch.where(cont(c), claimed, ok2 | ok3 | ok4))
        & ~bad_lead, True)
    ascii_bad = ((c < 0x21) | (c == 0x7F)) & live
    c2_bad = (c == 0xC2) & (n1 >= 0x80) & (n1 <= 0xA0) & live
    u1680 = (c == 0xE1) & (n1 == 0x9A) & (n2 == 0x80) & live
    e280 = (c == 0xE2) & (n1 == 0x80) & live
    u2000 = e280 & (((n2 >= 0x80) & (n2 <= 0x8A)) | (n2 == 0xA8)
                    | (n2 == 0xA9) | (n2 == 0xAF))
    u205f = (c == 0xE2) & (n1 == 0x81) & (n2 == 0x9F) & live
    u3000 = (c == 0xE3) & (n1 == 0x80) & (n2 == 0x80) & live
    space_bad = c2_bad | u1680 | u2000 | u205f | u3000
    return (seq_ok & ~ascii_bad & ~space_bad).all(1)


def _escapes_valid(P: _Planes) -> torch.Tensor:
    """Every '%' is followed by two hex digits inside the row."""
    hexok = P.cls("hex")
    l2 = P.pos + 2 < P.lens[:, None]
    pct = P.is_ch("%")
    return (~pct | (_next(hexok, 1) & _next(hexok, 2) & l2)).all(1)


def parse_planes(C: torch.Tensor, lens: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The JAX package's `_parse_kernel` (parse_uri.py:215-440) in PyTorch:
    -> row_valid, and present/start/end of scheme, host and query."""
    P = _Planes(C, lens)
    n, pos, is_ch = P.n, P.pos, P.is_ch
    zero = torch.zeros(n, dtype=torch.int32, device=C.device)

    def first(b, start):
        return P.first(is_ch(b), start)

    invalid = ~_utf8_and_charset_valid(P) | ~_escapes_valid(P)

    # the scheme
    colon0 = first(":", zero)
    delim0 = torch.minimum(torch.minimum(first("/", zero), first("?", zero)),
                           torch.minimum(first("#", zero), lens))
    has_scheme = colon0 < delim0
    alpha = torch.tensor(TABLES["alpha"], device=C.device)
    scheme_ok = ((colon0 > 0) & alpha[P.ch_at(zero).to(torch.int64)]
                 & P.all_in(P.cls("scheme"), zero + 1, colon0))
    invalid |= has_scheme & ~scheme_ok
    invalid |= (colon0 == 0) & (colon0 < delim0)
    ssp_start = torch.where(has_scheme, colon0 + 1, 0)
    frag = first("#", ssp_start)
    body_end = torch.minimum(frag, lens)
    invalid |= has_scheme & (ssp_start >= body_end)

    # opaque or hierarchical
    c_ssp = P.ch_at(ssp_start)
    hier = ~has_scheme | (c_ssp == ord("/")) | (ssp_start >= body_end)
    uric = P.cls("uric")
    invalid |= ~hier & ~P.all_in(uric, ssp_start, body_end)

    # authority, path, query, fragment
    has_auth = (hier & (c_ssp == ord("/"))
                & (P.ch_at(ssp_start + 1) == ord("/")))
    auth_start = ssp_start + 2
    stop = is_ch("/") | is_ch("?") | is_ch("#")
    auth_end = torch.where(has_auth, torch.minimum(P.first(stop, auth_start),
                                                   lens), ssp_start)
    empty_auth = has_auth & (auth_end == auth_start)
    invalid |= empty_auth & (auth_start >= body_end)
    path_start = torch.where(has_auth, auth_end, ssp_start)
    qmark = first("?", path_start)
    path_end = torch.minimum(torch.minimum(qmark, frag), lens)
    invalid |= hier & ~P.all_in(P.cls("path"), path_start, path_end)
    has_query = hier & (qmark < body_end)
    query_start, query_end = qmark + 1, body_end
    invalid |= has_query & ~P.all_in(uric, query_start, query_end)
    invalid |= (frag < lens) & ~P.all_in(uric, frag + 1, lens)

    # the authority: server-based, with the registry fallback
    before_end = pos < auth_end[:, None]
    amp = P.first(is_ch("@") & before_end, auth_start)
    has_user = has_auth & (amp < auth_end)
    user_ok = P.all_in(P.cls("userinfo"), auth_start, amp)
    host_start = torch.where(has_user, amp + 1, auth_start)
    colon_mask = is_ch(":") & P.in_range(host_start, auth_end)
    last_colon = torch.where(colon_mask, pos, -1).max(1).values

    # an IPv6 literal (java's parseIPv6Reference)
    is_v6 = has_auth & (P.ch_at(host_start) == ord("["))
    rb = P.first(is_ch("]") & before_end, host_start)
    v6_close_ok = rb < auth_end
    a6 = host_start + 1
    v6_chars_ok = P.all_in(P.cls("ipv6"), a6, rb)
    in6 = P.in_range(a6, rb)
    colon6 = is_ch(":") & in6
    n_dc = (colon6 & _next(colon6, 1)).sum(1)
    has_dc = n_dc > 0
    lead_colon = (P.ch_at(a6) == ord(":")) & (P.ch_at(a6 + 1) != ord(":"))
    tail_colon = (P.ch_at(rb - 1) == ord(":")) & (P.ch_at(rb - 2) != ord(":"))
    non_colon6 = in6 & ~colon6
    gstart = non_colon6 & (~_prev(non_colon6, 1) | (pos == a6[:, None]))
    run_end = suffix_min(torch.where(colon6 | (pos >= rb[:, None]), pos, BIG))
    glen = torch.where(gstart, run_end - pos, 0)
    first_dot_from = suffix_min(torch.where(is_ch(".") & in6, pos, BIG))
    g_has_dot = gstart & (first_dot_from < run_end)
    v4_last_ok = (~g_has_dot | (run_end == rb[:, None])).all(1)
    n_v4 = g_has_dot.sum(1)
    hexg = gstart & ~g_has_dot
    hex_len_ok = (~hexg | ((glen >= 1) & (glen <= 4))).all(1)
    any_v4 = g_has_dot.any(1)
    v4_start = torch.where(
        any_v4, torch.where(g_has_dot, pos, -1).max(1).values, zero)
    v4_ok6 = _ipv4_ok(P, v4_start, rb)
    v6_bytes = 2 * hexg.sum(1) + 4 * n_v4
    count_ok = torch.where(has_dc, v6_bytes <= 14, v6_bytes == 16)
    v6_inner_ok = (v6_chars_ok & (n_dc <= 1) & ~lead_colon & ~tail_colon
                   & hex_len_ok & v4_last_ok & (n_v4 <= 1) & count_ok
                   & (~any_v4 | v4_ok6))
    sep = rb + 1
    v6_has_port = v6_close_ok & (sep < auth_end)
    v6_port_ok = ~v6_has_port | ((P.ch_at(sep) == ord(":"))
                                 & P.all_in(P.cls("digits"), sep + 1,
                                            auth_end))
    v6_ok = v6_close_ok & v6_inner_ok & v6_port_ok

    # host:port, the host a hostname or an exact IPv4
    has_port = ~is_v6 & (last_colon >= host_start)
    host_end = torch.where(has_port, last_colon, auth_end)
    port_ok = ~has_port | P.all_in(P.cls("digits"), last_colon + 1, auth_end)
    hn_chars_ok = P.all_in(P.cls("hostname"), host_start, host_end)
    in_host = P.in_range(host_start, host_end)
    is_dot = is_ch(".") & in_host
    is_dash = is_ch("-") & in_host
    nxt_dot, prv_dot = _next(is_dot, 1), _prev(is_dot, 1)
    at_start = pos == host_start[:, None]
    at_last = pos == host_end[:, None] - 1
    dash_bad = is_dash & (nxt_dot | prv_dot | at_start | at_last)
    dot_bad = is_dot & (prv_dot | at_start)
    label_ok = (hn_chars_ok & (host_end > host_start)
                & ~(dash_bad | dot_bad).any(1))
    eff_end = host_end - (P.ch_at(host_end - 1) == ord(".")).to(torch.int32)
    lastdot = torch.where(is_dot & (pos < eff_end[:, None]), pos,
                          -1).max(1).values
    last_label = torch.maximum(lastdot + 1, host_start)
    last_alpha = alpha[P.ch_at(last_label).to(torch.int64)]
    host_ok = (label_ok & last_alpha) | _ipv4_ok(P, host_start, host_end)

    server_ok = (has_auth & (~has_user | user_ok)
                 & torch.where(is_v6, v6_ok, host_ok & port_ok))
    registry_ok = P.all_in(P.cls("registry"), auth_start, auth_end)
    invalid |= has_auth & ~empty_auth & ~server_ok & ~registry_ok

    row_valid = ~invalid
    return dict(
        row_valid=row_valid,
        scheme_present=has_scheme & row_valid, scheme_start=zero,
        scheme_end=colon0,
        host_present=has_auth & ~empty_auth & server_ok & row_valid,
        host_start=host_start, host_end=torch.where(is_v6, rb + 1, host_end),
        query_present=has_query & row_valid, query_start=query_start,
        query_end=query_end)


def find_param_planes(C, param, plens, qstart, qend, qpresent,
                      require_nonempty_key: bool):
    """The JAX package's `_find_param_kernel` (parse_uri.py:509-550): the
    value span of the first query pair whose raw key bytes equal the row's
    param followed by '=' -> (found, vstart, vend)."""
    n, L = C.shape
    Lp = param.shape[1]
    pos = torch.arange(L, dtype=torch.int32, device=C.device)[None, :]
    in_q = (pos >= qstart[:, None]) & (pos < qend[:, None])
    is_amp = (C == ord("&")) & in_q
    pair_start = (pos == qstart[:, None]) | (_prev(is_amp, 1) & in_q)
    ext = torch.cat([C, torch.zeros((n, Lp), dtype=C.dtype, device=C.device)],
                    1)
    match = torch.ones((n, L), dtype=torch.bool, device=C.device)
    for i in range(Lp):
        live_i = i < plens[:, None]
        match &= ~live_i | (ext[:, i:i + L] == param[:, i:i + 1])
    eq_pos = pos + plens[:, None]
    eq_char = C.gather(1, eq_pos.clamp(0, L - 1).to(torch.int64))
    match &= (pair_start & in_q & (eq_char == ord("="))
              & (eq_pos < qend[:, None]))
    if require_nonempty_key:
        match &= plens[:, None] > 0
    first_match = torch.where(match, pos, BIG).min(1).values
    found = qpresent & (first_match < BIG)
    vstart = first_match + plens + 1
    after = torch.where(is_amp & (pos >= vstart[:, None]), pos, BIG)
    vend = torch.minimum(after.min(1).values, qend)
    return found, vstart, vend


def span_strings(chars: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, validity: Optional[torch.Tensor]
                 ) -> Column:
    """A STRING column of each row's span chars[starts, starts + lens)."""
    n = lens.shape[0]
    dev = lens.device
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens.to(torch.int64), 0, out=offsets[1:])
    total = int(offsets[-1])
    row = torch.repeat_interleave(torch.arange(n, device=dev),
                                  lens.to(torch.int64), output_size=total)
    src = (starts.to(torch.int64).index_select(0, row)
           + torch.arange(total, device=dev)
           - offsets[:-1].index_select(0, row))
    return make_string_column(chars.index_select(0, src), offsets, validity)


def check_out_pad(longest: int, out_pad_to: Optional[int]) -> None:
    if out_pad_to is not None and longest > out_pad_to:
        raise ValueError(f"out_pad_to={out_pad_to} is smaller than the "
                         f"longest extracted span ({longest})")


def _extract(col: Column, present, start, end, out_pad_to) -> Column:
    """The JAX `_extract` (parse_uri.py:443-472): each row's [start, end) as
    a string; validity present & the input's; a null row empty."""
    out_len = torch.where(present, end - start, 0)
    if col.length:
        check_out_pad(int(out_len.max()), out_pad_to)
    valid = present & col.null_mask
    if col.validity is not None:
        out_len = torch.where(col.validity, out_len, 0)
    starts = col.offsets[:-1].to(torch.int64) + torch.where(present, start, 0)
    chars = col.data if col.data.numel() else torch.zeros(
        1, dtype=torch.uint8, device=col.device)
    return span_strings(chars, starts, out_len, valid)


def _planes(col: Column, pad_to):
    """The padded chars one byte past the JAX width (see the docstring)."""
    if not col.dtype.is_string:
        raise TypeError("parse_uri expects a string column")
    C, lens = padded_chars(col, pad_to)
    C = torch.cat([C, torch.zeros_like(C[:, :1])], 1)
    return C, lens, parse_planes(C, lens)


def _part_plain(col: Column, part: str, pad_to=None, out_pad_to=None
                ) -> Column:
    _, _, p = _planes(col, pad_to)
    return _extract(col, p[part + "_present"], p[part + "_start"],
                    p[part + "_end"], out_pad_to)


def parse_uri_to_protocol_plain(col, pad_to=None, out_pad_to=None):
    return _part_plain(col, "scheme", pad_to, out_pad_to)


def parse_uri_to_host_plain(col, pad_to=None, out_pad_to=None):
    return _part_plain(col, "host", pad_to, out_pad_to)


def parse_uri_to_query_plain(col, pad_to=None, out_pad_to=None):
    return _part_plain(col, "query", pad_to, out_pad_to)


def _query_param_plain(col, ppad, plens, require_nonempty_key, pad_to,
                       out_pad_to) -> Column:
    C, _, p = _planes(col, pad_to)
    found, vstart, vend = find_param_planes(
        C, ppad, plens, p["query_start"], p["query_end"], p["query_present"],
        require_nonempty_key)
    return _extract(col, found, vstart, vend, out_pad_to)


def literal_param(param: str, n: int, device):
    """The literal's bytes as an (n, Lp) int32 matrix and (n,) lengths."""
    pb = list(param.encode())
    Lp = _round_bucket(max(1, len(pb)))
    pad = torch.zeros((n, Lp), dtype=torch.int32, device=device)
    pad[:, :len(pb)] = torch.tensor(pb, dtype=torch.int32, device=device)
    return pad, torch.full((n,), len(pb), dtype=torch.int32, device=device)


def parse_uri_to_query_literal_plain(col, param: str, pad_to=None,
                                     out_pad_to=None):
    ppad, plens = literal_param(param, col.length, col.device)
    return _query_param_plain(col, ppad, plens, True, pad_to, out_pad_to)


def parse_uri_to_query_column_plain(col, params: Column, pad_to=None,
                                    out_pad_to=None, param_pad_to=None):
    ppad, plens = padded_chars(params, param_pad_to)
    out = _query_param_plain(col, ppad, plens, False, pad_to, out_pad_to)
    if params.validity is not None:
        out = make_string_column(out.data, out.offsets,
                                 out.null_mask & params.validity)
    return out


# ---- the entry points -------------------------------------------------------

def _on_cpu(col: Column) -> bool:
    """True on a CPU column (the plain version runs); TypeError unless a
    STRING column."""
    if not col.dtype.is_string:
        raise TypeError("parse_uri expects a string column")
    return col.device.type == "cpu"


def parse_uri_to_protocol(column: Column, pad_to=None,
                          out_pad_to=None) -> Column:
    """getScheme() per row; null for invalid URIs (parse_uri.cu:877)."""
    if _on_cpu(column):
        PLAIN_CALLS["protocol"] += 1
        return parse_uri_to_protocol_plain(column, pad_to, out_pad_to)
    return parse_uri_cuda.parse(column, "protocol", pad_to=pad_to,
                                out_pad_to=out_pad_to)


def parse_uri_to_host(column: Column, pad_to=None, out_pad_to=None) -> Column:
    """getHost() per row: server-based authorities only (parse_uri.cu:905)."""
    if _on_cpu(column):
        PLAIN_CALLS["host"] += 1
        return parse_uri_to_host_plain(column, pad_to, out_pad_to)
    return parse_uri_cuda.parse(column, "host", pad_to=pad_to,
                                out_pad_to=out_pad_to)


def parse_uri_to_query(column: Column, pad_to=None, out_pad_to=None) -> Column:
    """getRawQuery() per row (parse_uri.cu:933)."""
    if _on_cpu(column):
        PLAIN_CALLS["query"] += 1
        return parse_uri_to_query_plain(column, pad_to, out_pad_to)
    return parse_uri_cuda.parse(column, "query", pad_to=pad_to,
                                out_pad_to=out_pad_to)


def parse_uri_to_query_literal(column: Column, param: str, pad_to=None,
                               out_pad_to=None) -> Column:
    """Value of `param` in each row's query (ParseURI.java:70). A match
    needs a non-empty key equal to `param`."""
    if _on_cpu(column):
        PLAIN_CALLS["query_literal"] += 1
        return parse_uri_to_query_literal_plain(column, param, pad_to,
                                                out_pad_to)
    return parse_uri_cuda.parse(column, "query_literal", literal=param,
                                pad_to=pad_to, out_pad_to=out_pad_to)


def parse_uri_to_query_column(column: Column, params: Column, pad_to=None,
                              out_pad_to=None, param_pad_to=None) -> Column:
    """Per-row parameter column variant (ParseURI.java:
    parseURIQueryWithColumn); a null parameter row gives a null row."""
    if not params.dtype.is_string:
        raise TypeError("params must be a string column")
    if _on_cpu(column):
        PLAIN_CALLS["query_column"] += 1
        return parse_uri_to_query_column_plain(column, params, pad_to,
                                               out_pad_to, param_pad_to)
    return parse_uri_cuda.parse(column, "query_column", params=params,
                                pad_to=pad_to, out_pad_to=out_pad_to,
                                param_pad_to=param_pad_to)
