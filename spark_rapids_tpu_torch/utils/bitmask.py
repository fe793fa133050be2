"""Arrow packed validity and bitmask combination.

Counterpart of `spark_rapids_tpu/utils/bitmask.py`. Columns keep validity
as an unpacked (n,) bool tensor; these convert it to and from Arrow's
LSB-first packed bitmask for wire parity, and OR packed masks together
(the reference's `bitmask_bitwise_or`, utilities.cu:32).
"""
from __future__ import annotations

from typing import Sequence

import torch


def pack_validity(valid: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> ceil(n/8) uint8, Arrow LSB-first bit order."""
    n = valid.shape[0]
    v = torch.zeros(n + (-n) % 8, dtype=torch.uint8, device=valid.device)
    v[:n] = valid.to(torch.uint8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=valid.device)
    return (v.view(-1, 8).to(torch.int32) * weights).sum(
        1, dtype=torch.int32).to(torch.uint8)


def unpack_validity(packed: torch.Tensor, n: int) -> torch.Tensor:
    """ceil(n/8) uint8 -> (n,) bool, Arrow LSB-first bit order."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def bitmask_bitwise_or(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """OR N equal-length packed (or word) mask buffers (utilities.cu:32)."""
    if not masks:
        raise ValueError("requires at least one mask")
    out = masks[0]
    for m in masks[1:]:
        if m.shape != out.shape:
            raise ValueError("all masks must be the same length")
        out = out | m
    return out
