"""Counting, bounded LRU cache — the plan's engine cache.

Port of `repro/core/cache.py`. The reference can also mirror its counts
into the process-wide metrics registry (`name=`); the port has no
observability layer yet (ROADMAP Queue 1 item 11), so only the per-instance
counters exist.

Thread-safety: a single lock around the OrderedDict; `get_or_build` may
build the same value twice under a race but never corrupts the map.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable

_MISSING = object()


class CountingLRU:
    """Bounded LRU mapping with hit/miss/eviction/unhashable counters.

    capacity <= 0 disables storage entirely (every get is a miss, every put
    a no-op).
    """

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.unhashable = 0

    def get(self, key: Any, default: Any = None) -> Any:
        """Counted lookup; unhashable keys count and return `default`."""
        try:
            with self._lock:
                val = self._data.get(key, _MISSING)
                if val is _MISSING:
                    self.misses += 1
                    return default
                self._data.move_to_end(key)
                self.hits += 1
                return val
        except TypeError:
            with self._lock:
                self.unhashable += 1
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
                    self.evictions += 1
        except TypeError:
            with self._lock:
                self.unhashable += 1

    def get_or_build(self, key: Any, build: Callable[[], Any]) -> Any:
        """Counted get, building (and caching) on miss. Unhashable keys
        build uncached — counted, never raised."""
        try:
            hash(key)
        except TypeError:
            with self._lock:
                self.unhashable += 1
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
