"""Device column of the PyTorch port: fixed-width kinds and DECIMAL128.

Counterpart of `spark_rapids_tpu/columnar/column.py`, with the same buffer
layout (its lines 9-13): `data` is an (n,) tensor of the storage dtype, or
for DECIMAL128 an (n, 4) `torch.uint32` tensor of little-endian limbs, and
`validity` an unpacked (n,) bool tensor, or None when every row is valid.
Moving a column between the packages is therefore a copy of two buffers.
Strings and nested columns wait for ROADMAP queue A item 1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import device as _device
from ..dtypes import DType, Kind


@dataclasses.dataclass
class Column:
    """One logical column. Immutable by convention: ops return new ones."""
    dtype: DType
    length: int
    data: torch.Tensor
    validity: Optional[torch.Tensor] = None   # (n,) bool; None == all valid

    def __post_init__(self):
        if self.data.dtype != self.dtype.storage_dtype():
            raise TypeError(f"{self.dtype!r} column needs "
                            f"{self.dtype.storage_dtype()} data, got "
                            f"{self.data.dtype}")
        if tuple(self.data.shape) != (self.length,) + self.dtype.row_shape:
            raise ValueError(f"data shape {tuple(self.data.shape)} does not "
                             f"match length {self.length}")
        if self.validity is not None and (
                self.validity.dtype != torch.bool
                or tuple(self.validity.shape) != (self.length,)
                or self.validity.device != self.data.device):
            raise ValueError("validity must be an (n,) bool tensor on the "
                             "data's device")

    def __len__(self) -> int:
        return self.length

    @property
    def device(self) -> torch.device:
        return self.data.device

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
        v = 0 if self.validity is None else self.validity.nbytes
        return self.data.nbytes + v

    def to(self, device: Union[str, torch.device]) -> "Column":
        v = None if self.validity is None else self.validity.to(device)
        return Column(self.dtype, self.length, self.data.to(device), v)

    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: DType,
                   validity: Optional[np.ndarray] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "Column":
        """`device=None` means the CUDA card, as for every entry point."""
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
        0). DECIMAL128 takes unscaled Python ints, kept mod 2^128 as the
        reference's `from_pylist` keeps them. `device=None` means the card."""
        n = len(values)
        valid = np.array([v is not None for v in values], dtype=np.bool_)
        if dtype.kind == Kind.DECIMAL128:
            u = np.array([0 if v is None else int(v) for v in values],
                         dtype=object) & ((1 << 128) - 1)
            arr = np.stack([((u >> (32 * j)) & 0xFFFFFFFF).astype(np.uint32)
                            for j in range(4)], axis=1)
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
        """Host Python values, None for nulls; a DECIMAL128 value is its
        signed unscaled Python int. Testing aid."""
        data, v = self.to_numpy()
        if self.dtype.kind == Kind.DECIMAL128:
            vals = []
            for row in data:
                u = sum(int(w) << (32 * j) for j, w in enumerate(row))
                vals.append(u - (1 << 128) if u >= (1 << 127) else u)
        else:
            vals = [x.item() for x in data]
        return [None if (v is not None and not v[i]) else vals[i]
                for i in range(self.length)]
