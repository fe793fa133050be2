"""Bounded LRU dict for the plan engine's caches and the stats store.

Counterpart of `spark_rapids_tpu/utils/lru.py`, a copy of its own:

- `get(key)` refreshes recency (the hit becomes the most recent);
- `d[key] = value` inserts as the most recent (an overwrite refreshes)
  and evicts the least recent entries beyond `maxsize`;
- a plain `d[key]` read does not refresh (dict semantics).

`get` and `__setitem__` hold a lock, so two threads that `get` one key
cannot drop a live entry between a pop and its re-insert. A sequence of
calls (a miss, a compute, an insert) is not atomic: both threads compute
equal values and the last write wins.

`on_evict`, when given, is called with each evicted value (outside the
lock): the capped tier frees a program's CUDA graph there.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class LruDict(dict):
    """Bounded cache: `get` refreshes recency, inserts evict the oldest."""

    def __init__(self, maxsize: int,
                 on_evict: Optional[Callable[[object], None]] = None):
        super().__init__()
        self.maxsize = maxsize
        self.on_evict = on_evict
        self._lru_lock = threading.Lock()

    def get(self, key, default=None):
        with self._lru_lock:
            if key in self:
                val = super().pop(key)
                super().__setitem__(key, val)   # re-insert = most recent
                return val
            return default

    def __setitem__(self, key, value):
        evicted = []
        with self._lru_lock:
            super().pop(key, None)
            super().__setitem__(key, value)
            while len(self) > self.maxsize:
                oldest = next(iter(self))
                evicted.append(super().pop(oldest))
        if self.on_evict is not None:
            for v in evicted:
                self.on_evict(v)
