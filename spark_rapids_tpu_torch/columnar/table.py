"""Table: an ordered collection of equal-length columns.

Counterpart of `spark_rapids_tpu/columnar/table.py`. All columns of a table
live on one device; `.to(device)` moves them together.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple, Union

import torch

from .column import Column


class Table:
    columns: Tuple[Column, ...]
    names: Tuple[str, ...]

    def __init__(self, columns: Sequence[Column],
                 names: Sequence[str] = None):
        columns = tuple(columns)
        if names is None:
            names = tuple(f"c{i}" for i in range(len(columns)))
        if len(names) != len(columns):
            raise ValueError(f"{len(names)} names for {len(columns)} columns")
        if columns:
            n0, d0 = columns[0].length, columns[0].device
            for c in columns[1:]:
                if c.length != n0:
                    raise ValueError("all columns must have equal length")
                if c.device != d0:
                    raise ValueError("all columns must live on one device")
        self.columns = columns
        self.names = tuple(names)

    @property
    def num_rows(self) -> int:
        return self.columns[0].length if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def device(self) -> torch.device:
        return self.columns[0].device if self.columns else torch.device("cpu")

    def __len__(self) -> int:
        return self.num_rows

    def __getitem__(self, key) -> Column:
        if isinstance(key, int):
            return self.columns[key]
        return self.columns[self.names.index(key)]

    def __iter__(self) -> Iterator[Column]:
        return iter(self.columns)

    def select(self, names: Sequence[str]) -> "Table":
        return Table([self[n] for n in names], names)

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    def to(self, device: Union[str, torch.device]) -> "Table":
        return Table([c.to(device) for c in self.columns], self.names)

    def to_pydict(self) -> Dict[str, List]:
        return {n: c.to_pylist() for n, c in zip(self.names, self.columns)}
