"""LRU + TTL caches with write-generation invalidation (a copy of
``LRUCache``, ``GenerationalCache`` and ``ResultCache`` from
``nornicdb_tpu/cache.py``).

``SearchService.search`` keeps its results in a ``ResultCache``: LRU
1000, TTL 300 s, every index mutation bumps the generation and drops
every entry, a put whose compute raced a bump is not kept, and hits are
copied on the way out. ``WireCache`` (a copy) is the serialized-response
cache of the protocol surfaces, with the reference's hit, miss and
invalidation counters (``nornicdb_wire_cache_*_total{cache}``); the
surfaces themselves and the fleet's generation mirror wait for the
slices that port them.
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


class WireCache:
    """Shared serialized-response cache for the protocol surfaces.

    Keyed (method, request bytes) -> (generation, response bytes). A hit
    is valid only when the caller's CURRENT generation for that method
    family matches the generation recorded at put time — the same
    write-generation discipline as ``GenerationalCache``, except the
    generation counters live with the data planes (QdrantCompat's search
    cache, SearchService's result cache), each fed by the storage
    mutation listeners wired in db.py. One instance serves every wire
    method of a server, so the hot handlers do ZERO protobuf/JSON work
    on a hit: request bytes in, response bytes out.

    Entries are immutable bytes — no copy-on-return hook is needed
    (unlike ResultCache, whose hits share nested dicts with live nodes).

    Telemetry: hit/miss/invalidation counters under
    ``nornicdb_wire_cache_*_total{cache=<name>}`` — per cache NAME, so
    two instances constructed with the same name share one series. An
    "invalidation" is a generation-mismatch probe — the entry was
    present but a write on some surface outdated it (the generation
    counters live with the data planes, so the mismatch at get() is
    where staleness becomes observable).
    """

    def __init__(self, max_size: int = 2048, ttl_seconds: float = 300.0,
                 name: str = "wire"):
        from nornicdb_tpu_torch.obs import REGISTRY

        self._lru: LRUCache = LRUCache(max_size=max_size,
                                       ttl_seconds=ttl_seconds)
        self.name = name
        self._hits_c = REGISTRY.counter(
            "nornicdb_wire_cache_hits_total",
            "Wire-cache hits (serialized response served)",
            labels=("cache",)).labels(name)
        self._misses_c = REGISTRY.counter(
            "nornicdb_wire_cache_misses_total",
            "Wire-cache misses (response computed + serialized)",
            labels=("cache",)).labels(name)
        self._inval_c = REGISTRY.counter(
            "nornicdb_wire_cache_invalidations_total",
            "Wire-cache entries found stale (generation mismatch)",
            labels=("cache",)).labels(name)

    def get(self, method: str, data: bytes, gen: int) -> Optional[bytes]:
        hit = self._lru.get((method, data))
        if hit is not None and hit[0] == gen:
            self._hits_c.inc()
            return hit[1]
        if hit is not None:
            # present but outdated by a write: the observable moment of
            # invalidation (entries are never proactively swept)
            self._inval_c.inc()
        self._misses_c.inc()
        return None

    def put(self, method: str, data: bytes, gen: int,
            payload: bytes) -> None:
        # gen was sampled BEFORE the compute; a write that raced the
        # compute bumped the live generation, so the stale entry can
        # never validate on get() — no put-side guard needed.
        self._lru.put((method, data), (gen, payload))

    def stats(self) -> dict:
        # wire_* come from the lock-striped registry counters (exact
        # under racing gets) and cover every instance sharing this name
        return {**self._lru.stats(),
                "wire_hits": self._hits_c.value,
                "wire_misses": self._misses_c.value,
                "wire_invalidations": self._inval_c.value}

    def clear(self) -> None:
        self._lru.clear()


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
