"""The cast kernels: their bindings and launch counters.

Four sources, one thread a row, each with a plain C interface loaded
through ctypes (`cuda_build`, built at first use):

- `csrc/cast_string.cu`: string -> INT8/16/32/64 and `conv`'s string ->
  integer in base 10 or 16 (`to_integer`, `to_integer_base`);
- `csrc/cast_decimal.cu`: string -> DECIMAL32/64/128 (`to_decimal`);
- `csrc/cast_string_to_float.cu`: string -> FLOAT32/64 (`to_float`);
- `csrc/number_to_string.cu`: FLOAT32/64 -> Java's string (`from_float`),
  `format_float`, DECIMAL32/64/128 -> `BigDecimal.toString`
  (`from_decimal`), integer -> base 10 or 16 (`from_integer_base`): a
  length pass, the offsets by `torch.cumsum`, one host read of the char
  total to allocate, a write pass.

The port's entry points (`cast_string`, `cast_decimal`,
`cast_float_to_string`, `format_float`, `cast_decimal_to_string`) call
these on CUDA columns and their plain versions on CPU ones. A wrapper takes
CUDA columns only; it launches on the current stream and reads nothing
back, except the string formats' char total. `LAUNCHES` counts the
kernel launches and `PLAIN_CALLS` the entry points' plain runs, per op:
"to_integer", "to_integer_base", "to_decimal", "to_float", "from_float",
"format_float", "from_decimal", "from_integer_base". A string format
launches its kernel twice (the two passes; once when every row is empty)
and counts each. A parse writes its ANSI error flags only under
`ansi_mode`, and returns None for them otherwise.

The tables the float kernels read are made here from the plain versions'
own (10^k, where the JAX package's log10 turns, Ryu's factors), so the
kernel and the plain version read the same numbers.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..columnar import Column, make_string_column
from ..dtypes import DType, Kind

OPS = ("to_integer", "to_integer_base", "to_decimal", "to_float",
       "from_float", "format_float", "from_decimal", "from_integer_base")
LAUNCHES = {op: 0 for op in OPS}
PLAIN_CALLS = {op: 0 for op in OPS}

# csrc/number_to_string.cu's NsOp
NS_FLOAT, NS_FORMAT, NS_DECIMAL, NS_INT = 0, 1, 2, 3


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_longlong
# the launchers' argument types; the last argument is the stream
SIGNATURES = {
    "cast_string": ("cs_to_integer",
                    [_P, _P, _P, _N, _I, _I, _I, _I, _P, _P, _P]),
    "cast_decimal": ("cd_to_decimal",
                     [_P, _P, _P, _N, _I, _I, _I, _I, _P, _P, _P]),
    "cast_string_to_float": ("cf_to_float",
                             [_P, _P, _P, _N, _P, _P, _I, _P, _P, _P]),
    "number_to_string": ("ns_number_to_string",
                         [_I, _P, _P, _N, _I, _I, _I, _P, _P, _P, _P]),
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _fn(source: str):
    """The launcher of csrc/<source>.cu, its library built and loaded at
    first use."""
    if source not in _LIBS:
        from .cuda_build import load
        lib = load(source)
        name, args = SIGNATURES[source]
        f = getattr(lib, name)
        f.argtypes = args + [_P]
        f.restype = _I
        _LIBS[source] = lib
    name, _ = SIGNATURES[source]
    return getattr(_LIBS[source], name)


def _launch(source: str, op: str, dev: torch.device, *args) -> None:
    """One launch on `dev`'s current stream; raises on a CUDA error."""
    rc = _fn(source)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cast kernel {source} ({op}): CUDA error {rc}")


def _require_cuda(col: Column, what: str) -> None:
    if col.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA columns, got "
                         f"{col.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def string_buffers(col: Column) -> Tuple[torch.Tensor, torch.Tensor,
                                         Optional[torch.Tensor]]:
    """(offsets, chars, validity) as the kernels read them: contiguous,
    the chars at least one byte (a column of empty strings reads none)."""
    if not col.dtype.is_string:
        raise TypeError(f"expected a STRING column, got {col.dtype!r}")
    chars = col.data.contiguous()
    if chars.numel() == 0:
        chars = torch.zeros(1, dtype=torch.uint8, device=col.device)
    valid = None if col.validity is None else col.validity.contiguous()
    return col.offsets.contiguous(), chars, valid


# ---- the tables -------------------------------------------------------------

_TABLES: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def float_tables(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(10^-350 .. 10^350, the log10 steps) as float64 on `device`."""
    from .cast_string import LOG10_STEPS, POW10_F64
    dev = torch.device(device)
    if ("pow10", dev) not in _TABLES:
        _TABLES[("pow10", dev)] = torch.tensor(POW10_F64, dtype=torch.float64,
                                               device=dev)
        _TABLES[("steps", dev)] = torch.tensor(LOG10_STEPS,
                                               dtype=torch.float64,
                                               device=dev)
    return _TABLES[("pow10", dev)], _TABLES[("steps", dev)]


def ryu_tables(device) -> torch.Tensor:
    """Ryu's factors in number_to_string.cu's layout: F_INV, F_POW5, then
    D_INV and D_POW5 as (low, high) 64-bit pairs, int64 bits."""
    from .cast_float_to_string import D_INV, D_POW5, F_INV, F_POW5
    from .cast_string import wrap64
    dev = torch.device(device)
    if ("ryu", dev) not in _TABLES:
        words = list(F_INV) + list(F_POW5)
        for v in list(D_INV) + list(D_POW5):
            words += [v & ((1 << 64) - 1), v >> 64]
        _TABLES[("ryu", dev)] = torch.tensor([wrap64(w) for w in words],
                                             dtype=torch.int64, device=dev)
    return _TABLES[("ryu", dev)]


# ---- string -> number -------------------------------------------------------

def to_integer(col: Column, out_type: DType, ansi_mode: bool, strip: bool
               ) -> Tuple[Column, torch.Tensor]:
    """csrc/cast_string.cu's Spark cast -> (the column, the ANSI flags;
    None unless `ansi_mode`)."""
    return _to_int(col, out_type, "to_integer", 0, ansi_mode, strip)


def to_integer_base(col: Column, out_type: DType, base: int) -> Column:
    """csrc/cast_string.cu's `conv` (base 10 or 16)."""
    return _to_int(col, out_type, "to_integer_base", base, False, True)[0]


def _to_int(col, out_type, op, base, ansi_mode, strip):
    """-> (the column, the ANSI flags; None for `conv` and unless
    `ansi_mode`)."""
    _require_cuda(col, "string to integer")
    offsets, chars, valid = string_buffers(col)
    n, dev = col.length, col.device
    out = torch.empty(n, dtype=out_type.storage_dtype(), device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    err = (torch.empty(n, dtype=torch.bool, device=dev)
           if ansi_mode and not base else None)
    if n:
        _launch("cast_string", op, dev, offsets.data_ptr(), chars.data_ptr(),
                _ptr(valid), n, out.element_size(), int(strip),
                int(ansi_mode), base, out.data_ptr(), ok.data_ptr(),
                _ptr(err))
        LAUNCHES[op] += 1
    return Column(out_type, n, out, ok), err


def to_float(col: Column, out_type: DType, ansi_mode: bool
             ) -> Tuple[Column, torch.Tensor]:
    """csrc/cast_string_to_float.cu -> (the column, the ANSI flags; None
    unless `ansi_mode`)."""
    _require_cuda(col, "string to float")
    offsets, chars, valid = string_buffers(col)
    n, dev = col.length, col.device
    out = torch.empty(n, dtype=out_type.storage_dtype(), device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    err = torch.empty(n, dtype=torch.bool, device=dev) if ansi_mode else None
    if n:
        pow10, steps = float_tables(dev)
        _launch("cast_string_to_float", "to_float", dev, offsets.data_ptr(),
                chars.data_ptr(), _ptr(valid), n, pow10.data_ptr(),
                steps.data_ptr(), int(out_type.kind == Kind.FLOAT32),
                out.data_ptr(), ok.data_ptr(), _ptr(err))
        LAUNCHES["to_float"] += 1
    return Column(out_type, n, out, ok), err


def to_decimal(col: Column, precision: int, scale: int, ansi_mode: bool,
               strip: bool) -> Tuple[Column, torch.Tensor]:
    """csrc/cast_decimal.cu -> (the column, the ANSI flags; None unless
    `ansi_mode`)."""
    from .. import dtypes
    _require_cuda(col, "string to decimal")
    out_type = dtypes.decimal(precision, scale)
    offsets, chars, valid = string_buffers(col)
    n, dev = col.length, col.device
    shape = (n,) + out_type.row_shape
    out = torch.empty(shape, dtype=out_type.storage_dtype(), device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    err = torch.empty(n, dtype=torch.bool, device=dev) if ansi_mode else None
    if n:
        row_bytes = out.element_size() * (4 if out.dim() == 2 else 1)
        _launch("cast_decimal", "to_decimal", dev, offsets.data_ptr(),
                chars.data_ptr(), _ptr(valid), n, row_bytes, precision,
                scale, int(strip), out.data_ptr(), ok.data_ptr(), _ptr(err))
        LAUNCHES["to_decimal"] += 1
    return Column(out_type, n, out, ok), err


# ---- number -> string -------------------------------------------------------

def _to_string(col: Column, op: str, ns_op: int, in_bytes: int, flag: int,
               param: int) -> Column:
    """The two passes of csrc/number_to_string.cu over a column."""
    _require_cuda(col, "number to string")
    n, dev = col.length, col.device
    data = col.data.contiguous()
    valid = None if col.validity is None else col.validity.contiguous()
    tables = ryu_tables(dev) if ns_op in (NS_FLOAT, NS_FORMAT) else None
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    if n == 0:
        return make_string_column(
            torch.empty(0, dtype=torch.uint8, device=dev), offsets,
            col.validity)
    lens = torch.empty(n, dtype=torch.int32, device=dev)
    args = (ns_op, data.data_ptr(), _ptr(valid), n, in_bytes, flag, param,
            _ptr(tables))
    _launch("number_to_string", op, dev, *args, lens.data_ptr(), None, None)
    LAUNCHES[op] += 1
    ends = torch.cumsum(lens, 0, dtype=torch.int64)
    total = int(ends[-1])                       # the one host read
    if total > 2**31 - 1:
        raise ValueError(f"{op}: {total} chars overflow int32 offsets")
    offsets[1:] = ends
    chars = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        _launch("number_to_string", op, dev, *args, None,
                offsets.data_ptr(), chars.data_ptr())
        LAUNCHES[op] += 1
    return make_string_column(chars, offsets, col.validity)


def from_float(col: Column) -> Column:
    return _to_string(col, "from_float", NS_FLOAT, col.data.element_size(),
                      0, 0)


def format_float(col: Column, digits: int) -> Column:
    return _to_string(col, "format_float", NS_FORMAT,
                      col.data.element_size(), 0, digits)


def from_decimal(col: Column) -> Column:
    row = col.data.element_size() * (4 if col.data.dim() == 2 else 1)
    return _to_string(col, "from_decimal", NS_DECIMAL, row, 0,
                      int(col.dtype.scale or 0))


def from_integer_base(col: Column, base: int) -> Column:
    unsigned = int(col.dtype.kind in (Kind.UINT8, Kind.UINT64))
    return _to_string(col, "from_integer_base", NS_INT,
                      col.data.element_size(), unsigned, base)
