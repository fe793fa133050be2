"""Helpers of the port that belong to no one module: the bounded LRU dict
(`lru`), the tracing ranges (`tracing`) and the bitmask packing
(`bitmask`)."""
from .lru import LruDict
from .tracing import func_range, range_ctx, start_trace, stop_trace, trace

__all__ = ["LruDict", "func_range", "range_ctx", "start_trace",
           "stop_trace", "trace"]
