"""The repo's entry step on the port: Spark-exact row hashing and a DECIMAL128
multiply over one columnar batch.

Counterpart of `__graft_entry__.entry()` (its lines 25-50), the JAX
package's entry step: the ops a Spark plan leans on hardest, hash
partitioning and join keys, and decimal arithmetic. `entry()` returns
`(step, (keys, vals))`; `step(keys, vals)` builds the two-INT64 table,
hashes it with murmur3_32 (seed 42) and xxhash64 (seed 42), sign-extends
`vals` to decimal(38, 2) limbs and multiplies them by themselves at scale 4
with the interim cast, and returns `(h32, h64, product limbs (n, 4),
overflow)`, as the reference's step does. On the card that is two launches
of the row-hash kernel and one of the decimal kernel.

    python3 -c "from spark_rapids_tpu_torch.entry import entry; \\
        step, args = entry(); print(step(*args))"
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from . import device as _device
from . import dtypes
from .columnar import Column, Table
from .ops import multiply_decimal128, murmur_hash3_32, xxhash64

_Arrays = Tuple[torch.Tensor, torch.Tensor]


def example_arrays(n: int = 4096, seed: int = 0,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> _Arrays:
    """(keys, vals) int64 tensors as the reference's `_example_arrays`
    draws them from `np.random.default_rng(seed)`; `device=None` means the
    card."""
    dev = _device.resolve(device)
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(2**62), 2**62, size=n, dtype=np.int64)
    vals = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64)
    return torch.tensor(keys, device=dev), torch.tensor(vals, device=dev)


def decimal_limbs(vals: torch.Tensor) -> torch.Tensor:
    """An (n,) int64 tensor as (n, 4) uint32 DECIMAL128 limbs, sign-extended:
    bit views only, no value conversion."""
    halves = vals.contiguous().view(torch.int32).reshape(-1, 2)
    ext = (vals >> 63).to(torch.int32).unsqueeze(1)
    return torch.cat([halves, ext, ext], dim=1).view(torch.uint32)


def step(keys: torch.Tensor, vals: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (murmur3_32 int32 (n,), xxhash64 int64 (n,), vals * vals as
    decimal(38, 4) limbs (n, 4) uint32, overflow bool (n,))."""
    n = int(keys.shape[0])
    t = Table([Column(dtypes.INT64, n, keys), Column(dtypes.INT64, n, vals)])
    h32 = murmur_hash3_32(t, seed=42)
    h64 = xxhash64(t)
    dec = Column(dtypes.decimal(38, 2), n, decimal_limbs(vals))
    overflow, product = multiply_decimal128(dec, dec, 4)
    return h32.data, h64.data, product.data, overflow.data


def entry(n: int = 4096, device: Optional[Union[str, torch.device]] = None,
          seed: int = 0) -> Tuple[Callable, _Arrays]:
    """(step, (keys, vals)) over n rows; `device=None` means the card."""
    return step, example_arrays(n, seed, device)
