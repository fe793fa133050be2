"""Tables across packages: a port `Table` from host numpy buffers.

The JAX package and the port share one column layout for the fixed-width
kinds and DECIMAL128 (data, (n, 4) uint32 limbs for DECIMAL128, plus an
unpacked bool validity), so the numpy arrays of a JAX `Table` (its
columns' `data`, `validity` and dtype) rebuild the same table here, bit
for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import device as _device
from .columnar import Column, Table
from .dtypes import DType, Kind


def table_from_numpy(names: Sequence[str], arrays: Sequence[np.ndarray],
                     validities: Sequence[Optional[np.ndarray]],
                     dtypes: Sequence[Union[DType, str]],
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Table:
    """Port Table from per-column numpy data, validity (None = all valid)
    and dtype (a port `DType` or a kind name such as "int64" or "date32").
    `device=None` means the CUDA card, as for every entry point."""
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
