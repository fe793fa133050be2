"""Exchange transport: the packed columnar wire form of the distributed
tier.

Counterpart of `spark_rapids_tpu/plan/transport.py`, with the same wire
planes and byte counts. Each exchange payload packs into dense typed
planes with cheap per-column encodings chosen by inspection, passing a
column through whenever an encoding would not pay:

- frame of reference (``for8/16/32``): an integer column whose live range
  fits a narrower unsigned width moves as ``value - lo`` in that width
  plus one reference; exact for every live value. Static shape, so it
  rides the exchanges themselves;
- bit-packed validity (``bitpack``): the bool planes of two or more
  nullable columns become one uint8 bit-word plane per 8 columns;
- dictionary (``dict8/16``) and run length (``rle``): dynamic sizes, so
  only where the payload is already materialized whole: the local build
  side of a broadcast join (`pack_host`).

Two counts ride every packed edge (`plan/metrics.py`):
`exchange_bytes_logical`, the unpacked payload (data itemsize plus one
validity byte per nullable column, live rows, each edge once), and
`exchange_bytes`, the packed wire form. Metadata (masks, bucket counts,
references, side tables small enough to ride along) counts in neither.
The certifier's per-edge bounds (analysis/footprint.py) hold for the wire
form.

The unsigned planes follow the port's rule for unsigned math: torch on
the CPU has no uint16/uint32 arithmetic, so the planes are written and
read through their signed bit views (`parallel.shuffle.narrow_unsigned`,
`widen_unsigned`).

Knobs (config.py): SPARK_RAPIDS_TORCH_EXCHANGE_PACK, _EXCHANGE_CODECS and
_EXCHANGE_ASYNC. Pack off restores the plain payload layout.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes
from ..columnar import Column
from ..parallel.shuffle import narrow_unsigned, widen_unsigned

ALL_CODECS = frozenset({"for", "dict", "rle", "bitpack"})

__all__ = ["ALL_CODECS", "DevicePack", "HostPacked", "WordPlan",
           "logical_col_bytes", "logical_row_bytes", "narrow_words",
           "widen_words", "pack_device", "unpack_device",
           "unpack_device_np", "pack_host", "unpack_host",
           "unpack_host_device", "pack_bits_device", "unpack_bits_np",
           "resolve_codecs"]

_I64_MAX = 2 ** 63 - 1
_I64_MIN = -2 ** 63


# ---- logical (unpacked) accounting --------------------------------------------

def logical_col_bytes(col: Column) -> int:
    """Unpacked bytes per row of one fixed-width column: the data itemsize
    and one byte when a validity plane rides along."""
    return col.dtype.itemsize() + (1 if col.validity is not None else 0)


def logical_row_bytes(cols: Sequence[Column]) -> int:
    return sum(logical_col_bytes(c) for c in cols)


# ---- device-side static-shape packing (exchange edges) ------------------------

@dataclasses.dataclass(frozen=True)
class _ColPlan:
    """How to rebuild one packed column."""
    name: str
    dtype: dtypes.DType
    codec: str                  # "raw" | "for8" | "for16" | "for32"
    ref: int                    # the frame of reference (exact Python int)
    plane: int                  # data plane index
    vplane: int                 # validity plane index (-1: not nullable)
    vbit: int                   # bit in a packed validity word (-1: raw)


@dataclasses.dataclass
class DevicePack:
    """One packed payload: `planes`, equal-length 1-D tensors that move in
    place of the columns, and `plans`, which rebuild them. Byte fields are
    per row."""
    plans: Tuple[_ColPlan, ...]
    planes: List
    n_planes: int
    wire_row_bytes: int
    logical_row_bytes: int
    codec_str: str


_FOR_TARGETS = ((8, torch.uint8), (16, torch.uint16), (32, torch.uint32))
_NP_FOR = {torch.uint8: np.uint8, torch.uint16: np.uint16,
           torch.uint32: np.uint32}


def _signed_kind(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and dtype != torch.bool


def _live_range(data: torch.Tensor, mask: torch.Tensor):
    """(lo, hi) of the live values as exact Python ints (two host reads),
    None when no row is live."""
    x = data if data.dtype in (torch.int64, torch.int32, torch.int16,
                               torch.int8, torch.uint8) \
        else widen_unsigned(data)
    big = torch.iinfo(x.dtype)
    lo = int(torch.where(mask, x, big.max).min())
    hi = int(torch.where(mask, x, big.min).max())
    return (lo, hi) if lo <= hi else None


def _for_probe(col: Column, live):
    """Frame-of-reference inspection: one masked min and max over the live
    non-null rows decides whether the column's range fits a narrower
    unsigned plane. Returns (plane, lo, codec) or None (pass-through)."""
    d = col.data
    if not _signed_kind(d.dtype) or d.element_size() < 2 or d.shape[0] == 0:
        return None
    mask = live if col.validity is None else (live & col.validity)
    rng = _live_range(d, mask)
    if rng is None:
        return None
    lo, hi = rng
    if lo < _I64_MIN or lo > _I64_MAX:
        return None
    span = hi - lo
    for bits, tgt in _FOR_TARGETS:
        if bits // 8 >= d.element_size():
            break
        if span < (1 << bits):
            plane = narrow_unsigned(widen_unsigned(d) - lo, tgt)
            return plane, lo, f"for{bits}"
    return None


def _bit_words(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bool planes -> one uint8 plane, mask j in bit j."""
    word = torch.zeros(masks[0].shape, dtype=torch.int32,
                       device=masks[0].device)
    for bit, v in enumerate(masks):
        word = word | (v.to(torch.int32) << bit)
    return word.to(torch.uint8)


def pack_device(cols: Sequence[Column], names: Sequence[str], live,
                codecs: frozenset) -> DevicePack:
    """Pack fixed-width 1-D columns into wire planes with the static-shape
    codecs (FOR narrowing, bit-packed validity). `live` is the relation's
    live mask, the FOR inspection's domain; the planes keep the input
    length (dead slots carry wrapped values that decode to values nobody
    reads). All-raw planes when `codecs` allows nothing."""
    planes: List = []
    plans: List[_ColPlan] = []
    notes: List[str] = []
    wire = 0
    logical = 0
    nullable: List[int] = []
    for name, c in zip(names, cols):
        logical += logical_col_bytes(c)
        plane, ref, codec = c.data, 0, "raw"
        if "for" in codecs:
            probe = _for_probe(c, live)
            if probe is not None:
                plane, ref, codec = probe
                notes.append(f"{name}:{codec}")
        idx = len(planes)
        planes.append(plane)
        wire += plane.element_size()
        plans.append(_ColPlan(name=name, dtype=c.dtype, codec=codec,
                              ref=ref, plane=idx, vplane=-1, vbit=-1))
        if c.validity is not None:
            nullable.append(len(plans) - 1)
    if nullable and "bitpack" in codecs and len(nullable) >= 2:
        for chunk0 in range(0, len(nullable), 8):
            chunk = nullable[chunk0:chunk0 + 8]
            for bit, pi in enumerate(chunk):
                plans[pi] = dataclasses.replace(plans[pi],
                                                vplane=len(planes), vbit=bit)
            planes.append(_bit_words([cols[pi].validity for pi in chunk]))
            wire += 1
        notes.append("validity:bitpack")
    else:
        for pi in nullable:
            plans[pi] = dataclasses.replace(plans[pi], vplane=len(planes),
                                            vbit=-1)
            planes.append(cols[pi].validity)
            wire += 1
    return DevicePack(plans=tuple(plans), planes=planes,
                      n_planes=len(planes), wire_row_bytes=wire,
                      logical_row_bytes=logical, codec_str=",".join(notes))


def _decode_plane(raw: torch.Tensor, p: _ColPlan) -> torch.Tensor:
    st = p.dtype.storage_dtype()
    if p.codec.startswith("for"):
        return (p.ref + widen_unsigned(raw)).to(st)
    return raw if raw.dtype == st else raw.to(st)


def _decode_validity(arrays, p: _ColPlan) -> Optional[torch.Tensor]:
    if p.vplane < 0:
        return None
    vp = arrays[p.vplane]
    if p.vbit >= 0:
        return ((vp.to(torch.int32) >> p.vbit) & 1).to(torch.bool)
    return vp.to(torch.bool)


def unpack_device(arrays: Sequence, pack: DevicePack) -> List[Column]:
    """Received wire planes back to typed columns (the receiving side's
    decode)."""
    if not pack.plans:
        return []
    n = int(arrays[0].shape[0])
    return [Column(p.dtype, n, _decode_plane(arrays[p.plane], p),
                   _decode_validity(arrays, p)) for p in pack.plans]


def unpack_device_np(arrays: Sequence[np.ndarray], pack: DevicePack
                     ) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """numpy mirror of `unpack_device` for planes pulled to the host:
    [(data, validity or None)] at full length."""
    out = []
    for p in pack.plans:
        raw = arrays[p.plane]
        if p.codec.startswith("for"):
            data = (p.ref + raw.astype(np.int64)).astype(
                torch.empty(0, dtype=p.dtype.storage_dtype()).numpy().dtype)
        else:
            data = raw
        validity = None
        if p.vplane >= 0:
            vp = arrays[p.vplane]
            validity = (((vp >> p.vbit) & 1) if p.vbit >= 0 else vp) \
                .astype(bool)
        out.append((data, validity))
    return out


# ---- key-word narrowing (hash-exchange edges) ---------------------------------

@dataclasses.dataclass(frozen=True)
class WordPlan:
    """How one key-word plane of a hash exchange moves: "raw" (its int64
    word) or "forN" (`word - ref` in the narrow unsigned width); `nbytes`
    its wire bytes a row."""
    codec: str
    ref: int
    nbytes: int


def narrow_words(words: Sequence, live
                 ) -> Tuple[List, Tuple[WordPlan, ...], int, str]:
    """FOR-narrow the int64 key-word planes a hash exchange moves. The
    exchange widens each narrowed plane back to its exact word for the
    Spark hash and moves the narrow plane, so placement is the raw path's
    and only the wire narrows. One masked min/max per plane over the live
    rows (null keys' words are zero, inside the range). Returns (planes,
    plans, wire bytes a row, codec note); all raw gives the input planes
    and an empty note."""
    planes: List = []
    plans: List[WordPlan] = []
    notes: List[str] = []
    wire = 0
    for i, w in enumerate(words):
        plan = WordPlan("raw", 0, 8)
        plane = w
        if w.shape[0]:
            rng = _live_range(w, live)
            if rng is not None:
                lo, hi = rng
                span = hi - lo
                for bits, tgt in _FOR_TARGETS:
                    if span < (1 << bits):
                        plane = narrow_unsigned(w - lo, tgt)
                        plan = WordPlan(f"for{bits}", lo, bits // 8)
                        notes.append(f"key{i}:for{bits}")
                        break
        planes.append(plane)
        plans.append(plan)
        wire += plan.nbytes
    return planes, tuple(plans), wire, ",".join(notes)


def widen_words(planes: Sequence, plans: Sequence[WordPlan]) -> List:
    """The inverse of `narrow_words` for received planes."""
    return [p if wp.codec == "raw" else wp.ref + widen_unsigned(p)
            for p, wp in zip(planes, plans)]


def pack_bits_device(mask) -> Tuple[object, int]:
    """A (n,) bool tensor bit-packed into ceil(n/8) uint8 bytes, little
    bit order (the packed gather's live-mask wire form). Returns (plane,
    n)."""
    n = int(mask.shape[0])
    pad = (-n) % 8
    m = mask.to(torch.int32)
    if pad:
        m = torch.cat([m, torch.zeros(pad, dtype=torch.int32,
                                      device=m.device)])
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=m.device))[None, :]
    return (m.reshape(-1, 8) * weights).sum(1).to(torch.uint8), n


def unpack_bits_np(plane: np.ndarray, n: int) -> np.ndarray:
    bits = np.unpackbits(np.asarray(plane, np.uint8), bitorder="little")
    return bits[:n].astype(bool)


# ---- host-side codecs (materialized edges) ------------------------------------

@dataclasses.dataclass
class _HostColPlan:
    name: str
    dtype: dtypes.DType
    codec: str                        # raw | forN | dictN | rle
    ref: int
    data: Optional[np.ndarray]        # raw/for plane or dict codes
    values: Optional[np.ndarray]      # dict/rle value table
    lengths: Optional[np.ndarray]     # rle run lengths (int32)
    validity: Optional[np.ndarray]    # packbits bitmask or raw bool
    vpacked: bool


@dataclasses.dataclass
class HostPacked:
    """A host-materialized payload in wire form (the broadcast build side).
    `wire_bytes`/`logical_bytes` cover the whole payload once."""
    n: int
    cols: List[_HostColPlan]
    names: Tuple[str, ...]
    wire_bytes: int
    logical_bytes: int
    codec_str: str


def _host_encode_int(a: np.ndarray, codecs: frozenset):
    """The cheapest host codec for one integer array by exact bytes;
    pass-through when nothing beats raw. Returns (codec, data, values,
    lengths, ref, wire bytes)."""
    n = a.shape[0]
    item = a.dtype.itemsize
    best = ("raw", a, None, None, 0, n * item)
    if n == 0:
        return best
    if "rle" in codecs:
        bounds = np.empty(n, bool)
        bounds[0] = True
        np.not_equal(a[1:], a[:-1], out=bounds[1:])
        starts = np.nonzero(bounds)[0]
        rle_bytes = starts.shape[0] * (item + 4)
        if rle_bytes < best[5]:
            lengths = np.diff(np.append(starts, n)).astype(np.int32)
            best = ("rle", None, a[starts], lengths, 0, rle_bytes)
    if "dict" in codecs:
        uniq = np.unique(a)
        for bits, ct in ((8, np.uint8), (16, np.uint16)):
            if uniq.shape[0] <= (1 << bits):
                d_bytes = n * (bits // 8) + uniq.nbytes
                if d_bytes < best[5]:
                    codes = np.searchsorted(uniq, a).astype(ct)
                    best = (f"dict{bits}", codes, uniq, None, 0, d_bytes)
                break
    if "for" in codecs and item >= 2:
        lo, hi = int(a.min()), int(a.max())
        span = hi - lo
        for bits, ct in ((8, np.uint8), (16, np.uint16), (32, np.uint32)):
            if bits // 8 >= item:
                break
            if span < (1 << bits):
                f_bytes = n * (bits // 8)
                if f_bytes < best[5]:
                    best = (f"for{bits}",
                            (a.astype(np.int64) - lo).astype(ct),
                            None, None, lo, f_bytes)
                break
    return best


def pack_host(cols: Sequence[Column], names: Sequence[str],
              codecs: frozenset) -> HostPacked:
    """Encode a payload materialized on the host (the dynamic-size codecs
    apply); lossless for every slot, null slots' data included."""
    out: List[_HostColPlan] = []
    notes: List[str] = []
    wire = 0
    logical = 0
    n = int(cols[0].length) if cols else 0
    for name, c in zip(names, cols):
        logical += logical_col_bytes(c) * n
        a = c.data.cpu().numpy()
        codec, data, values, lengths, ref = "raw", a, None, None, 0
        if np.dtype(a.dtype).kind in "iu" and \
                c.dtype.kind != dtypes.Kind.BOOL:
            codec, data, values, lengths, ref, _ = \
                _host_encode_int(a, codecs)
        wire += sum(x.nbytes for x in (data, values, lengths)
                    if x is not None)
        if codec != "raw":
            notes.append(f"{name}:{codec}")
        validity, vpacked = None, False
        if c.validity is not None:
            v = c.validity.cpu().numpy()
            if "bitpack" in codecs:
                validity = np.packbits(v, bitorder="little")
                vpacked = True
            else:
                validity = v
            wire += validity.nbytes
        out.append(_HostColPlan(name=name, dtype=c.dtype, codec=codec,
                                ref=ref, data=data, values=values,
                                lengths=lengths, validity=validity,
                                vpacked=vpacked))
    if any(p.vpacked for p in out):
        notes.append("validity:bitpack")
    return HostPacked(n=n, cols=out, names=tuple(names), wire_bytes=wire,
                      logical_bytes=logical, codec_str=",".join(notes))


def _np_storage(dt: dtypes.DType):
    return torch.empty(0, dtype=dt.storage_dtype()).numpy().dtype


def _host_decode_np(p: _HostColPlan) -> np.ndarray:
    if p.codec == "raw":
        return p.data
    if p.codec.startswith("for"):
        return (p.ref + p.data.astype(np.int64)).astype(_np_storage(p.dtype))
    if p.codec.startswith("dict"):
        return p.values[p.data]
    if p.codec == "rle":
        return np.repeat(p.values, p.lengths)
    raise ValueError(f"unknown host codec {p.codec!r}")


def unpack_host(packed: HostPacked, device="cpu") -> List[Column]:
    """numpy round trip (tests and host-side consumers)."""
    out = []
    for p in packed.cols:
        data = torch.from_numpy(np.ascontiguousarray(_host_decode_np(p)))
        validity = None
        if p.validity is not None:
            v = unpack_bits_np(p.validity, packed.n) if p.vpacked \
                else p.validity.astype(bool)
            validity = torch.from_numpy(v).to(device)
        out.append(Column(p.dtype, packed.n, data.to(device), validity))
    return out


def _put_np(a: np.ndarray, put) -> torch.Tensor:
    """A host plane onto the device; uint16/uint32 through signed views."""
    signed = {np.dtype(np.uint16): np.int16,
              np.dtype(np.uint32): np.int32}.get(a.dtype)
    if signed is not None:
        t = put(torch.from_numpy(np.ascontiguousarray(a).view(signed)))
        return t.view(torch.uint16 if a.dtype == np.uint16
                      else torch.uint32)
    return put(torch.from_numpy(np.ascontiguousarray(a)))


def unpack_host_device(packed: HostPacked, put) -> List[Column]:
    """Decode a HostPacked payload on the device: `put` lifts each wire
    plane, and the decode runs over the lifted planes (the broadcast's
    unpack on the receiving side)."""
    out = []
    for p in packed.cols:
        st = p.dtype.storage_dtype()
        if p.codec == "raw":
            data = _put_np(p.data, put)
        elif p.codec.startswith("for"):
            data = (p.ref + widen_unsigned(_put_np(p.data, put))).to(st)
        elif p.codec.startswith("dict"):
            codes = widen_unsigned(_put_np(p.data, put))
            data = _put_np(p.values, put).index_select(0, codes)
        elif p.codec == "rle":
            data = torch.repeat_interleave(
                _put_np(p.values, put),
                _put_np(p.lengths, put).to(torch.int64),
                output_size=packed.n)
        else:
            raise ValueError(f"unknown host codec {p.codec!r}")
        validity = None
        if p.validity is not None:
            vp = _put_np(p.validity, put)
            if p.vpacked:
                idx = torch.arange(packed.n, device=vp.device)
                validity = ((vp.index_select(0, idx >> 3).to(torch.int32)
                             >> (idx & 7).to(torch.int32)) & 1).to(
                                 torch.bool)
            else:
                validity = vp.to(torch.bool)
        out.append(Column(p.dtype, packed.n, data, validity))
    return out


# ---- codec-set resolution ------------------------------------------------------

def resolve_codecs(spec: str) -> frozenset:
    """A config string -> a codec set: "auto" all, "none" the layout with
    no encodings, else a comma list checked against the catalog."""
    if spec == "auto":
        return ALL_CODECS
    if spec == "none":
        return frozenset()
    chosen = frozenset(s.strip() for s in spec.split(",") if s.strip())
    unknown = chosen - ALL_CODECS
    if unknown:
        raise ValueError(
            f"unknown exchange codec(s) {sorted(unknown)} "
            f"(expected a subset of {sorted(ALL_CODECS)}, 'auto', or "
            "'none')")
    return chosen
