"""Counting, bounded LRU cache — the plan's engine cache.

Port of `repro/core/cache.py`, the registry mirror included: a cache with
a `name` also counts into the process-wide metrics registry
(`obs/metrics.py`) as ``cache.<name>.{hits,misses,evictions,unhashable}``.

Thread-safety: a single lock around the OrderedDict; `get_or_build` may
build the same value twice under a race but never corrupts the map.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

from ..obs import metrics as _metrics

_MISSING = object()


class CountingLRU:
    """Bounded LRU mapping with hit/miss/eviction/unhashable counters.

    capacity <= 0 disables storage entirely (every get is a miss, every put
    a no-op).

    `name` additionally mirrors every count into the process-global metrics
    registry as ``cache.<name>.{hits,misses,evictions,unhashable}``. The
    int attributes stay the per-INSTANCE truth (and what `stats()`
    reports); registry counters are cumulative for the process and are
    never reset by `clear()`. Unnamed caches stay registry-silent.
    """

    def __init__(self, capacity: int = 64, name: Optional[str] = None):
        self.capacity = int(capacity)
        self.name = name
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.unhashable = 0
        self._mirror = None if name is None else {
            c: _metrics.counter(f"cache.{name}.{c}")
            for c in ("hits", "misses", "evictions", "unhashable")}

    def _count(self, which: str) -> None:
        """Increment an attribute counter (+ its registry mirror). Caller
        holds the instance lock; the registry counter has its own."""
        setattr(self, which, getattr(self, which) + 1)
        if self._mirror is not None:
            self._mirror[which].inc()

    def get(self, key: Any, default: Any = None) -> Any:
        """Counted lookup; unhashable keys count and return `default`."""
        try:
            with self._lock:
                val = self._data.get(key, _MISSING)
                if val is _MISSING:
                    self._count("misses")
                    return default
                self._data.move_to_end(key)
                self._count("hits")
                return val
        except TypeError:
            with self._lock:
                self._count("unhashable")
            return default

    def put(self, key: Any, value: Any) -> None:
        """Insert/refresh; evicts the least-recently-used entry past
        capacity. Unhashable keys count and are dropped."""
        try:
            with self._lock:
                if self.capacity <= 0:
                    return
                if key in self._data:
                    self._data.move_to_end(key)
                self._data[key] = value
                while len(self._data) > self.capacity:
                    self._data.popitem(last=False)
                    self._count("evictions")
        except TypeError:
            with self._lock:
                self._count("unhashable")

    def get_or_build(self, key: Any, build: Callable[[], Any]) -> Any:
        """Counted get, building (and caching) on miss. Unhashable keys
        build uncached — counted, never raised."""
        try:
            hash(key)
        except TypeError:
            with self._lock:
                self._count("unhashable")
            return build()
        val = self.get(key, _MISSING)
        if val is not _MISSING:
            return val
        val = build()
        self.put(key, val)
        return val

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: Any) -> bool:
        try:
            with self._lock:
                return key in self._data
        except TypeError:
            return False

    def keys(self):
        with self._lock:
            return list(self._data.keys())

    def clear(self, reset_counters: bool = False) -> None:
        with self._lock:
            self._data.clear()
            if reset_counters:
                self.hits = self.misses = 0
                self.evictions = self.unhashable = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._data),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "unhashable": self.unhashable,
            }
