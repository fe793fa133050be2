"""Tables across packages: a port `Table` from host numpy buffers.

The JAX package and the port share one column layout (data, with (n, 4)
uint32 limbs for DECIMAL128 and uint8 chars for STRING; int32 offsets for
STRING and LIST; children for LIST and STRUCT; an unpacked bool
validity), so the numpy arrays of a JAX `Table` rebuild the same table
here, bit for bit: `table_from_numpy` for flat columns, `column_from_buffers`
for a column of any kind, nested to any depth.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import device as _device
from .columnar import Column, Table
from .dtypes import DType, Kind


@dataclasses.dataclass
class Buffers:
    """Host buffers of one column, as the JAX package's `Column` holds
    them: `data` (None for LIST and STRUCT), `validity` (None = all valid),
    `offsets` (STRING and LIST) and `children` (LIST and STRUCT)."""
    dtype: DType
    length: int
    data: Optional[np.ndarray] = None
    validity: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    children: Tuple["Buffers", ...] = ()


def column_from_buffers(b: Buffers,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Column:
    """Port Column from a column's host buffers, children first.
    `device=None` means the CUDA card, as for every entry point."""
    dev = _device.resolve(device)

    def tensor(a, dt):
        return None if a is None else torch.tensor(np.ascontiguousarray(a),
                                                   dtype=dt, device=dev)
    data = None
    if not b.dtype.is_nested:
        data = tensor(b.data, b.dtype.storage_dtype())
    return Column(b.dtype, int(b.length), data,
                  tensor(b.validity, torch.bool),
                  tensor(b.offsets, torch.int32),
                  tuple(column_from_buffers(c, dev) for c in b.children))


def table_from_numpy(names: Sequence[str], arrays: Sequence[np.ndarray],
                     validities: Sequence[Optional[np.ndarray]],
                     dtypes: Sequence[Union[DType, str]],
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Table:
    """Port Table from per-column numpy data, validity (None = all valid)
    and dtype (a port `DType` or a kind name such as "int64" or "date32")
    of fixed-width and DECIMAL128 columns. `device=None` means the CUDA
    card, as for every entry point."""
    if not (len(names) == len(arrays) == len(validities) == len(dtypes)):
        raise ValueError("names, arrays, validities and dtypes must have "
                         "one entry per column")
    dev = _device.resolve(device)
    cols = []
    for arr, valid, dt in zip(arrays, validities, dtypes):
        if not isinstance(dt, DType):
            dt = DType(Kind(dt))
        cols.append(Column.from_numpy(np.asarray(arr), dt, valid, dev))
    return Table(cols, names)


def table_from_buffers(names: Sequence[str], columns: Sequence[Buffers],
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Table:
    """Port Table from each column's `Buffers`, any kind, any depth."""
    dev = _device.resolve(device)
    return Table([column_from_buffers(b, dev) for b in columns], names)
