"""Java-facing facade of the PyTorch port: the classes of spark-rapids-jni's
Java API, mapped onto the port's ops.

Counterpart of `spark_rapids_tpu/api.py`. Only the `Hash` class is ported;
the other classes wait for their modules (ROADMAP queue A item 12).
"""
from __future__ import annotations

from typing import Sequence

from . import ops
from .columnar import Column


class Hash:
    """Hash.java:26-86."""

    DEFAULT_XXHASH64_SEED = ops.DEFAULT_XXHASH64_SEED

    @staticmethod
    def murmurHash32(columns: Sequence[Column], seed: int = 0) -> Column:
        return ops.murmur_hash3_32(list(columns), seed=seed)

    @staticmethod
    def xxhash64(columns: Sequence[Column],
                 seed: int = ops.DEFAULT_XXHASH64_SEED) -> Column:
        return ops.xxhash64(list(columns), seed=seed)
