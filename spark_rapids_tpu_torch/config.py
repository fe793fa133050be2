"""Environment knobs of the PyTorch port, under their own prefix.

| Variable                    | Default | Meaning |
|-----------------------------|---------|---------|
| SPARK_RAPIDS_TORCH_KERNELS  | —       | kernel-registry overrides, `op=name` pairs (e.g. `hash_join=cuda`; ops/registry.py) |
| SPARK_RAPIDS_TORCH_OPTIMIZER | on     | rule-based plan optimizer (plan/optimizer.py): on/off |
| SPARK_RAPIDS_TORCH_VERIFY_PLANS | 0    | static plan verifier gate (analysis/verifier.py): 1 verifies every plan before it runs and every optimizer rule's output; 0, 1, on or off |
| SPARK_RAPIDS_TORCH_TRACE    | —       | 1 opens the tracing ranges (utils/tracing.py): `plan.<label>` per eager operator, `plan.capped.attempt` per capped attempt |
| SPARK_RAPIDS_TORCH_STATS    | on      | the stats store (plan/stats.py): on/off |
| SPARK_RAPIDS_TORCH_STATS_CAPACITY | 256 | the store's plan entries (its side tables scale from it) |
| SPARK_RAPIDS_TORCH_STATS_PATH | —     | JSONL file the default store replays and appends to |
| SPARK_RAPIDS_TORCH_CERT_SEED | on     | with a store, the capped tier tightens its starting caps to the certified rows and ceilings its ladder there (analysis/footprint.py): on/off |
| SPARK_RAPIDS_TORCH_CERT_BUDGET_BYTES | 0 | admission budget for a plan's certified residency; 0 is off |
| SPARK_RAPIDS_TORCH_CERT_ADMISSION | reject | over the budget: reject raises ResourceAdmissionError; degrade runs the whole plan on the degraded CPU tier |
| SPARK_RAPIDS_TORCH_BREAKER_DEGRADE | cpu | when the breaker trips: cpu finishes the plan on the CPU tier, off raises |
| SPARK_RAPIDS_TORCH_FAULTINJ_CONFIG_PATH | — | the fault injector's JSON config (faultinj.py), installed at import |
| SPARK_RAPIDS_TORCH_IO_PREFETCH | 2     | streaming-scan prefetch depth (chunks decoded ahead); 0 decodes inline |
| SPARK_RAPIDS_TORCH_IO_CHUNK_ROWS | 0   | streaming-scan chunk row bound (0: one chunk per row group) |
| SPARK_RAPIDS_TORCH_BROADCAST_ROWS | 8192 | distributed tier: estimated build-side rows at or below which exchange_planning picks a broadcast join over a shuffle |
| SPARK_RAPIDS_TORCH_EXCHANGE_PACK | on | exchange payloads in packed wire form (plan/transport.py): on/off |
| SPARK_RAPIDS_TORCH_EXCHANGE_CODECS | auto | the transport's codecs: auto, none or a subset of for,dict,rle,bitpack |
| SPARK_RAPIDS_TORCH_EXCHANGE_ASYNC | off | an Exchange's pack and transfer on a worker thread (plan/distributed.py): on/off |
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


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _on_off(name: str, default: str) -> bool:
    v = os.environ.get(name, default)
    if v not in ("on", "off"):
        raise ValueError(f"{name}={v!r}: expected on or off")
    return v == "on"


def trace_enabled() -> bool:
    """Tracing ranges (utils/tracing.py): on only at exactly "1", as the
    reference's SPARK_RAPIDS_TPU_TRACE."""
    return os.environ.get("SPARK_RAPIDS_TORCH_TRACE", "") == "1"


def stats_enabled() -> bool:
    """The stats store (plan/stats.py): when on, every successful
    execution records what it observed and the optimizer, the capped
    tier and the kernel registry consult it on the next execution of the
    same plan. "off" restores the static decisions. A typo raises."""
    return _on_off("SPARK_RAPIDS_TORCH_STATS", "on")


def stats_capacity() -> int:
    """The store's plan entries kept before the least recent is dropped;
    the subtree and kernel tables scale from it. Read when a store is
    made."""
    return max(1, _int_env("SPARK_RAPIDS_TORCH_STATS_CAPACITY", 256))


def stats_path() -> str:
    """JSONL persistence for the stats store: a store made without an
    explicit path replays this file and appends a line per execution.
    Empty (the default) keeps the store in memory."""
    return os.environ.get("SPARK_RAPIDS_TORCH_STATS_PATH", "")


def cert_seed() -> bool:
    """Capped tier, with a stats store only: tighten the starting caps to
    the resource certifier's rows hi-bound and put a ceiling on the
    escalation ladder there (analysis/footprint.py). A typo raises."""
    return _on_off("SPARK_RAPIDS_TORCH_CERT_SEED", "on")


def cert_budget_bytes() -> int:
    """Admission budget (analysis/footprint.py): when non-zero,
    `PlanExecutor.execute()` compares every operator's certified
    residency with it before anything runs and applies
    `cert_admission()`. 0 (default) is off."""
    return max(0, _int_env("SPARK_RAPIDS_TORCH_CERT_BUDGET_BYTES", 0))


def cert_admission() -> str:
    """The policy over the budget: "reject" raises ResourceAdmissionError
    naming the operator; "degrade" runs the whole plan on the degraded CPU
    tier, where the device budget does not bind. A typo raises
    ValueError."""
    v = os.environ.get("SPARK_RAPIDS_TORCH_CERT_ADMISSION", "reject")
    if v not in ("reject", "degrade"):
        raise ValueError(
            f"SPARK_RAPIDS_TORCH_CERT_ADMISSION={v!r}: expected reject or "
            "degrade")
    return v


def breaker_degrade() -> str:
    """When the breaker trips: "cpu" finishes the plan on the degraded CPU
    tier, "off" raises the fault. A typo raises."""
    v = os.environ.get("SPARK_RAPIDS_TORCH_BREAKER_DEGRADE", "cpu")
    if v not in ("cpu", "off"):
        raise ValueError(
            f"SPARK_RAPIDS_TORCH_BREAKER_DEGRADE={v!r}: expected cpu or off")
    return v


def faultinj_config_path() -> str:
    """The fault injector's config (faultinj.py); "" when unset."""
    return os.environ.get("SPARK_RAPIDS_TORCH_FAULTINJ_CONFIG_PATH", "")


def io_prefetch() -> int:
    """Streaming-scan prefetch depth: how many decoded chunks a Parquet
    scan's host decode thread may run ahead of execution, so that chunk
    N+1 decodes while chunk N runs on the card. 0 runs no thread (decode
    inline on the executing thread)."""
    return max(0, _int_env("SPARK_RAPIDS_TORCH_IO_PREFETCH", 2))


def io_chunk_rows() -> int:
    """Streaming-scan chunk row bound: a decoded row group larger than
    this splits into chunks of at most this many rows. 0 (the default)
    streams one chunk per row group."""
    return max(0, _int_env("SPARK_RAPIDS_TORCH_IO_CHUNK_ROWS", 0))


def broadcast_rows() -> int:
    """Distributed tier: the optimizer's exchange_planning rule replicates
    a join's build side (a broadcast join, no shuffle of the probe side)
    when its estimated rows are at most this, the row analogue of Spark's
    autoBroadcastJoinThreshold."""
    return _int_env("SPARK_RAPIDS_TORCH_BROADCAST_ROWS", 8192)


def exchange_pack() -> bool:
    """Exchange transport packing (plan/transport.py): on, the hash,
    broadcast and gather payloads move as packed planes (FOR-narrowed
    integers, bit-packed validity) and unpack on the receiving side, and
    the metrics split wire from logical bytes; off moves the columns as
    they are (wire == logical). A typo raises."""
    return _on_off("SPARK_RAPIDS_TORCH_EXCHANGE_PACK", "on")


def exchange_codecs() -> frozenset:
    """The codecs the transport may choose from: "auto" all of them (for,
    dict, rle, bitpack), "none" the packed layout with no encoding, or a
    comma list. Unknown names raise."""
    from .plan.transport import resolve_codecs
    return resolve_codecs(
        os.environ.get("SPARK_RAPIDS_TORCH_EXCHANGE_CODECS", "auto"))


def exchange_async() -> bool:
    """Async exchange dispatch (plan/distributed.py): on, an Exchange's
    pack and transfer run on a worker thread while the plan walk goes on,
    until its consumer resolves it; off (the default) keeps the walk
    synchronous. A typo raises."""
    return _on_off("SPARK_RAPIDS_TORCH_EXCHANGE_ASYNC", "off")
