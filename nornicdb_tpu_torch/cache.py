"""LRU + TTL caches with write-generation invalidation (a copy of
``LRUCache``, ``GenerationalCache`` and ``ResultCache`` from
``nornicdb_tpu/cache.py``).

``SearchService.search`` keeps its results in a ``ResultCache``: LRU
1000, TTL 300 s, every index mutation bumps the generation and drops
every entry, a put whose compute raced a bump is not kept, and hits are
copied on the way out. The wire-protocol cache and the fleet's
generation mirror wait for the slices that port those surfaces.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Generic, Hashable, Optional, Tuple, TypeVar

V = TypeVar("V")


class LRUCache(Generic[V]):
    """Thread-safe LRU with per-entry TTL and hit/miss stats."""

    def __init__(self, max_size: int = 1024, ttl_seconds: float = 0.0):
        self.max_size = max(1, max_size)
        self.ttl = ttl_seconds
        self._data: "OrderedDict[Hashable, Tuple[V, float]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, default: Optional[V] = None) -> Optional[V]:
        now = time.monotonic()
        with self._lock:
            item = self._data.get(key)
            if item is None:
                self.misses += 1
                return default
            value, expires = item
            if expires and now > expires:
                del self._data[key]
                self.misses += 1
                return default
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: Hashable, value: V, ttl_seconds: Optional[float] = None) -> None:
        ttl = self.ttl if ttl_seconds is None else ttl_seconds
        expires = time.monotonic() + ttl if ttl else 0.0
        with self._lock:
            self._put_locked(key, value, expires)

    def _put_locked(self, key: Hashable, value: V, expires: float) -> None:
        self._data[key] = (value, expires)
        self._data.move_to_end(key)
        while len(self._data) > self.max_size:
            self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._data), "max_size": self.max_size,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
            }


class GenerationalCache(LRUCache[V]):
    """LRU + TTL cache whose entries are dropped wholesale by bumping a
    write generation: any write invalidates every cached read."""

    def __init__(self, max_size: int = 1024, ttl_seconds: float = 0.0):
        super().__init__(max_size, ttl_seconds)
        self._generation = 0

    def bump_generation(self) -> None:
        with self._lock:
            self._generation += 1
            self._data.clear()

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation


class ResultCache(GenerationalCache[list]):
    """Search-result cache: LRU 1000, 5-minute TTL, invalidated on any
    index mutation, and hardened two ways:

    - generation-guarded puts: a compute that read pre-write state and
      raced an invalidation must not pin its stale result for the TTL
      (the guard and the insert run under one lock acquisition);
    - a per-hit copy hook applied on every get/put return, so callers
      can never mutate a cached entry (hits share nested dicts with
      live nodes by reference).
    """

    def __init__(self, copy_hit: Callable[[Any], Any],
                 max_size: int = 1000, ttl_seconds: float = 300.0):
        super().__init__(max_size, ttl_seconds)
        self._copy_hit = copy_hit

    def get_hits(self, key: Hashable) -> Optional[list]:
        hits = self.get(key)
        if hits is None:
            return None
        return [self._copy_hit(h) for h in hits]

    def put_guarded(self, key: Hashable, hits: list,
                    gen_at_miss: int) -> list:
        """Insert unless an invalidation raced the compute. Returns
        caller-safe copies either way."""
        expires = time.monotonic() + self.ttl if self.ttl else 0.0
        with self._lock:
            if self._generation == gen_at_miss:
                self._put_locked(key, hits, expires)
        return [self._copy_hit(h) for h in hits]
