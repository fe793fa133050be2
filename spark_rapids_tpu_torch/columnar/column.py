"""Device column of the PyTorch port: every kind of the reference.

Counterpart of `spark_rapids_tpu/columnar/column.py`, with the same buffer
layout (its lines 9-13), so moving a column between the packages is a copy
of its buffers:

- fixed-width: `data` an (n,) tensor of the storage dtype;
- DECIMAL128: `data` an (n, 4) `torch.uint32` tensor of little-endian limbs;
- STRING: `data` the (total,) `torch.uint8` chars, `offsets` (n+1,) int32;
- LIST: `offsets` (n+1,) int32 and one child column, `data` None;
- STRUCT: one child column per field, `data` None;

and `validity` an unpacked (n,) bool tensor, or None when every row is
valid. The reference's padded (n, L) char matrices (`padded_chars`) are a
TPU tiling device and are not carried over: the card reads chars through
the offsets.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import device as _device
from .. import dtypes
from ..dtypes import DType, Kind


@dataclasses.dataclass
class Column:
    """One logical column. Immutable by convention: ops return new ones."""
    dtype: DType
    length: int
    data: Optional[torch.Tensor] = None       # None for LIST and STRUCT
    validity: Optional[torch.Tensor] = None   # (n,) bool; None == all valid
    offsets: Optional[torch.Tensor] = None    # (n+1,) int32: STRING, LIST
    children: Tuple["Column", ...] = ()       # LIST: (element,); STRUCT

    def __post_init__(self):
        k = self.dtype.kind
        self.children = tuple(self.children)
        if self.dtype.is_nested:
            if self.data is not None:
                raise ValueError(f"{self.dtype!r} columns have no data "
                                 "buffer")
            want = 1 if k == Kind.LIST else len(self.dtype.children)
            if len(self.children) != want:
                raise ValueError(f"{self.dtype!r} column needs {want} "
                                 f"children, got {len(self.children)}")
            for c, dt in zip(self.children, self.dtype.children):
                if c.dtype != dt:
                    raise TypeError(f"{self.dtype!r} column has a "
                                    f"{c.dtype!r} child")
            if k == Kind.STRUCT and any(c.length != self.length
                                        for c in self.children):
                raise ValueError("struct fields must have the struct's "
                                 "length")
        else:
            if self.data is None:
                raise ValueError(f"{self.dtype!r} column needs a data "
                                 "buffer")
            if self.data.dtype != self.dtype.storage_dtype():
                raise TypeError(f"{self.dtype!r} column needs "
                                f"{self.dtype.storage_dtype()} data, got "
                                f"{self.data.dtype}")
            if k == Kind.STRING:
                if self.data.dim() != 1:
                    raise ValueError("string chars must be 1-D")
            elif tuple(self.data.shape) != \
                    (self.length,) + self.dtype.row_shape:
                raise ValueError(f"data shape {tuple(self.data.shape)} "
                                 f"does not match length {self.length}")
        if k in (Kind.STRING, Kind.LIST):
            if (self.offsets is None or self.offsets.dtype != torch.int32
                    or tuple(self.offsets.shape) != (self.length + 1,)):
                raise ValueError(f"{self.dtype!r} column needs (n+1,) "
                                 "int32 offsets")
        elif self.offsets is not None:
            raise ValueError(f"{self.dtype!r} columns have no offsets")
        dev = self.device
        for t in (self.data, self.offsets):
            if t is not None and t.device != dev:
                raise ValueError("a column's buffers must live on one device")
        if any(c.device != dev for c in self.children):
            raise ValueError("a column's children must live on its device")
        if self.validity is not None and (
                self.validity.dtype != torch.bool
                or tuple(self.validity.shape) != (self.length,)
                or self.validity.device != dev):
            raise ValueError("validity must be an (n,) bool tensor on the "
                             "data's device")

    def __len__(self) -> int:
        return self.length

    @property
    def device(self) -> torch.device:
        for t in (self.data, self.offsets, self.validity):
            if t is not None:
                return t.device
        if self.children:
            return self.children[0].device
        return torch.device("cpu")

    @property
    def null_mask(self) -> torch.Tensor:
        """(n,) bool, True where valid."""
        if self.validity is None:
            return torch.ones(self.length, dtype=torch.bool,
                              device=self.device)
        return self.validity

    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int(self.length - int(self.validity.sum()))

    def nbytes(self) -> int:
        return (sum(t.nbytes for t in (self.data, self.validity,
                                        self.offsets) if t is not None)
                + sum(c.nbytes() for c in self.children))

    def to(self, device: Union[str, torch.device],
           non_blocking: bool = False) -> "Column":
        """This column on `device`; `non_blocking` copies from page-locked
        host memory run asynchronously on the current stream."""
        def move(t):
            return None if t is None else t.to(device,
                                               non_blocking=non_blocking)
        return Column(self.dtype, self.length, move(self.data),
                      move(self.validity), move(self.offsets),
                      tuple(c.to(device, non_blocking)
                            for c in self.children))

    def string_lengths(self) -> torch.Tensor:
        """(n,) int32 byte length of each row of a STRING column."""
        if not self.dtype.is_string:
            raise TypeError(f"string_lengths of a {self.dtype!r} column")
        return self.offsets[1:] - self.offsets[:-1]

    # ---- host interop -------------------------------------------------------

    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: DType,
                   validity: Optional[np.ndarray] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "Column":
        """Fixed-width or DECIMAL128 column from its data buffer.
        `device=None` means the CUDA card, as for every entry point."""
        device = _device.resolve(device)
        # torch.tensor copies, so read-only host buffers are fine
        data = torch.tensor(np.ascontiguousarray(arr),
                            dtype=dtype.storage_dtype(), device=device)
        v = None
        if validity is not None:
            v = torch.tensor(np.ascontiguousarray(validity, dtype=np.bool_),
                             device=device)
        return Column(dtype, int(arr.shape[0]), data, v)

    @staticmethod
    def from_pylist(values: Sequence, dtype: DType,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> "Column":
        """Column of Python values, None for nulls (a null row's data is
        0, its string or list empty). DECIMAL128 takes unscaled Python
        ints, kept mod 2^128 as the reference's `from_pylist` keeps them;
        STRING takes str (UTF-8) or bytes; LIST takes sequences and STRUCT
        dicts by field name (a null struct's fields are null).
        `device=None` means the card."""
        device = _device.resolve(device)
        n = len(values)
        valid = np.array([v is not None for v in values], dtype=np.bool_)
        validity = None if valid.all() else torch.tensor(valid,
                                                         device=device)
        k = dtype.kind
        if k == Kind.STRING:
            enc = [b"" if v is None else
                   (v.encode() if isinstance(v, str) else bytes(v))
                   for v in values]
            chars = np.frombuffer(b"".join(enc), dtype=np.uint8)
            return make_string_column(
                torch.tensor(chars, dtype=torch.uint8, device=device),
                _offsets_of([len(e) for e in enc], device), validity)
        if k == Kind.LIST:
            rows = [() if v is None else list(v) for v in values]
            child = Column.from_pylist([x for r in rows for x in r],
                                       dtype.children[0], device)
            return Column.make_list(
                _offsets_of([len(r) for r in rows], device), child, validity)
        if k == Kind.STRUCT:
            kids = tuple(
                Column.from_pylist([None if v is None else v.get(name)
                                    for v in values], dt, device)
                for name, dt in zip(dtype.field_names, dtype.children))
            return Column(dtype, n, None, validity, None, kids)
        if k == Kind.DECIMAL128:
            u = np.array([0 if v is None else int(v) for v in values],
                         dtype=object) & ((1 << 128) - 1)
            arr = np.stack([((u >> (32 * j)) & 0xFFFFFFFF).astype(np.uint32)
                            for j in range(4)], axis=1).reshape(n, 4)
        else:
            filled = [0 if v is None else v for v in values]
            arr = np.array(filled, dtype=np.dtype(
                str(dtype.storage_dtype()).removeprefix("torch.")))
        return Column.from_numpy(arr, dtype, None if valid.all() else valid,
                                 device)

    def to_numpy(self):
        """(data, validity-or-None) as host numpy arrays."""
        v = None if self.validity is None else self.validity.cpu().numpy()
        return self.data.cpu().numpy(), v

    def to_pylist(self) -> List:
        """Host Python values, None for nulls: a DECIMAL128 value is its
        signed unscaled Python int, a string its UTF-8 decoding (bad bytes
        replaced, as in the reference), a list a Python list and a struct
        a dict by field name. Testing aid."""
        valid = self.null_mask.cpu().numpy()
        k = self.dtype.kind
        if k in (Kind.STRING, Kind.LIST):
            offs = self.offsets.cpu().numpy()
        if k == Kind.STRING:
            chars = self.data.cpu().numpy().tobytes()
            vals = [chars[offs[i]:offs[i + 1]].decode("utf-8",
                                                      errors="replace")
                    for i in range(self.length)]
        elif k == Kind.LIST:
            child = self.children[0].to_pylist()
            vals = [child[offs[i]:offs[i + 1]] for i in range(self.length)]
        elif k == Kind.STRUCT:
            kids = [c.to_pylist() for c in self.children]
            vals = [{name: kid[i] for name, kid in
                     zip(self.dtype.field_names, kids)}
                    for i in range(self.length)]
        elif k == Kind.DECIMAL128:
            vals = []
            for row in self.data.cpu().numpy():
                u = sum(int(w) << (32 * j) for j, w in enumerate(row))
                vals.append(u - (1 << 128) if u >= (1 << 127) else u)
        else:
            vals = [x.item() for x in self.data.cpu().numpy()]
        return [vals[i] if valid[i] else None for i in range(self.length)]

    # ---- nested constructors ------------------------------------------------

    @staticmethod
    def make_list(offsets: torch.Tensor, child: "Column",
                  validity: Optional[torch.Tensor] = None) -> "Column":
        return Column(dtypes.list_(child.dtype), int(offsets.shape[0]) - 1,
                      None, validity, offsets.to(torch.int32), (child,))

    @staticmethod
    def make_struct(validity: Optional[torch.Tensor] = None,
                    **fields: "Column") -> "Column":
        cols = tuple(fields.values())
        dt = dtypes.struct(**{k: c.dtype for k, c in fields.items()})
        return Column(dt, cols[0].length, None, validity, None, cols)


def make_string_column(chars: torch.Tensor, offsets: torch.Tensor,
                       validity: Optional[torch.Tensor] = None) -> Column:
    return Column(dtypes.STRING, int(offsets.shape[0]) - 1,
                  chars.to(torch.uint8), validity, offsets.to(torch.int32))


def _offsets_of(lengths: Sequence[int], device) -> torch.Tensor:
    offs = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offs[1:])
    return torch.tensor(offs.astype(np.int32), device=device)
