"""Signature-keyed LRU result cache for the serving tier (the port's own
copy of the JAX package's ``serving/cache.py``).

The common hazard-lookup pattern is *repeats*: the same scenario queried
again and again (a site's design spectrum, a regulator's checklist).  The
batcher keys each entry by ``(engine.signature(), request key)`` — for
surrogate serving the request key is :meth:`Scenario.signature`, so a
repeated scenario is answered from host memory without touching the
device, and a changed model (new checkpoint → new engine signature)
can never serve a stale prediction.

Bounded LRU with hit/miss/eviction counters (surfaced in the server's
``stats``); thread-safe — ``get`` runs on caller threads, ``put`` on the
batch thread.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional


class ResultCache:
    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"cache capacity must be ≥ 1, got {capacity}")
        self.capacity = int(capacity)
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable) -> Optional[Any]:
        """The cached value (refreshed to most-recently-used) or None."""
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
            self._d[key] = value
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)  # least-recently-used out first
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        """Membership without touching recency or the hit/miss counters."""
        with self._lock:
            return key in self._d

    def keys(self) -> list:
        """Current keys, least- to most-recently-used (test introspection)."""
        with self._lock:
            return list(self._d.keys())

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._d),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
