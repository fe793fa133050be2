"""Environment knobs of the PyTorch port, under their own prefix.

| Variable                    | Default | Meaning |
|-----------------------------|---------|---------|
| SPARK_RAPIDS_TORCH_KERNELS  | —       | kernel-registry overrides, `op=name` pairs (e.g. `hash_join=cuda`; ops/registry.py) |
"""
from __future__ import annotations

import os


def kernel_overrides() -> dict:
    """Comma-separated `op=kernel` pairs from SPARK_RAPIDS_TORCH_KERNELS.
    Format errors raise here; unknown op or kernel names raise in the
    registry, which owns the catalog."""
    out = {}
    for part in os.environ.get("SPARK_RAPIDS_TORCH_KERNELS", "").split(","):
        part = part.strip()
        if not part:
            continue
        op, sep, name = part.partition("=")
        op, name = op.strip(), name.strip()
        if not sep or not op or not name:
            raise ValueError(
                f"SPARK_RAPIDS_TORCH_KERNELS: malformed entry {part!r} "
                "(expected op=kernel, e.g. hash_join=cuda)")
        out[op] = name
    return out
