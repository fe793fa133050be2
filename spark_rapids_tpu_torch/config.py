"""Environment knobs of the PyTorch port, under their own prefix.

| Variable                    | Default | Meaning |
|-----------------------------|---------|---------|
| SPARK_RAPIDS_TORCH_KERNELS  | —       | kernel-registry overrides, `op=name` pairs (e.g. `hash_join=cuda`; ops/registry.py) |
| SPARK_RAPIDS_TORCH_OPTIMIZER | on     | rule-based plan optimizer (plan/optimizer.py): on/off |
| SPARK_RAPIDS_TORCH_VERIFY_PLANS | 0    | static plan verifier gate (analysis/verifier.py): 1 verifies every plan before it runs and every optimizer rule's output; 0, 1, on or off |
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


def optimizer_enabled() -> bool:
    """Rule-based plan optimizer (plan/optimizer.py), run inside
    `PlanExecutor.execute()`: "on" (default) or "off". Anything else
    raises, so a typo cannot silently change which plan shape runs."""
    v = os.environ.get("SPARK_RAPIDS_TORCH_OPTIMIZER", "on")
    if v not in ("on", "off"):
        raise ValueError(
            f"SPARK_RAPIDS_TORCH_OPTIMIZER={v!r}: expected on or off")
    return v == "on"


def verify_plans() -> bool:
    """Static plan verifier gate (analysis/verifier.py): when on,
    `PlanExecutor.execute()` verifies the plan about to run (the rewrite
    pair when the optimizer ran) before any tier runs it, and the optimizer
    re-validates every rule's output. Off by default; the port's plan
    tests turn it on. A typo raises, so it cannot silently disable the
    gate."""
    v = os.environ.get("SPARK_RAPIDS_TORCH_VERIFY_PLANS", "0")
    if v not in ("0", "1", "on", "off"):
        raise ValueError(
            f"SPARK_RAPIDS_TORCH_VERIFY_PLANS={v!r}: expected 0, 1, on, "
            "or off")
    return v in ("1", "on")
