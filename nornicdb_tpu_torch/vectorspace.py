"""Vector-space registry: named vector spaces keyed by scope (counterpart
of ``nornicdb_tpu/vectorspace.py``).

Spaces are keyed (database, entity type, vector name, dims, metric), with
the backends ``auto`` (the ANN profile's kind), ``brute``, ``hnsw``,
``ivf_hnsw``, ``ivfpq`` and ``cagra``; chunk vectors get their own space
(``CHUNK_VECTOR_NAME``). The registry carries the device that the
backends holding tensors are built on (``brute`` and ``cagra``, and
``ivf_hnsw``'s partitioner): ``device=None`` means ``cuda``, resolved
when the registry is made, so a CPU caller asks for ``"cpu"``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device

CHUNK_VECTOR_NAME = "chunks"
DEFAULT_VECTOR_NAME = "embedding"

_BACKENDS = ("auto", "brute", "hnsw", "ivf_hnsw", "ivfpq", "cagra")


@dataclass(frozen=True)
class SpaceKey:
    database: str = "neo4j"
    entity_type: str = "node"
    vector_name: str = DEFAULT_VECTOR_NAME
    dims: int = 0
    metric: str = "cosine"


@dataclass
class VectorSpace:
    key: SpaceKey
    backend: str = "auto"
    index: Any = None  # lazily-built index instance
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))
    _build_lock: Any = field(default_factory=threading.Lock, repr=False)

    def ensure_index(self):
        """Build the backend index on first use (auto resolves through
        the ANN profile). Locked: a concurrent double-build would hand
        two callers different instances and silently lose vectors."""
        with self._build_lock:
            return self._ensure_index_locked()

    def _ensure_index_locked(self):
        if self.index is not None:
            return self.index
        from nornicdb_tpu_torch.search.ann_quality import current_profile
        from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

        kind = self.backend
        if kind == "auto":
            kind = current_profile().index_kind
        if kind == "brute":
            self.index = BruteForceIndex(dims=self.key.dims or None, device=self.device)
        elif kind == "hnsw":
            from nornicdb_tpu_torch.search.hnsw import HNSWIndex

            p = current_profile()
            self.index = HNSWIndex(m=p.hnsw_m,
                                   ef_construction=p.hnsw_ef_construction,
                                   ef_search=p.hnsw_ef_search)
        elif kind == "ivf_hnsw":
            from nornicdb_tpu_torch.search.ivf_hnsw import IVFHNSWIndex

            p = current_profile()
            self.index = IVFHNSWIndex(nprobe=p.nprobe, m=p.hnsw_m,
                                      ef_construction=p.hnsw_ef_construction,
                                      ef_search=p.hnsw_ef_search,
                                      device=self.device)
        elif kind == "ivfpq":
            import os

            from nornicdb_tpu_torch.search.ivfpq import IVFPQIndex

            p = current_profile()
            refine = (p.pq_refine and os.environ.get(
                "NORNICDB_VECTOR_PQ_REFINE", "1") != "0")
            self.index = IVFPQIndex(n_subspaces=p.pq_subspaces,
                                    nprobe=p.nprobe,
                                    keep_vectors=refine)
        elif kind == "cagra":
            from nornicdb_tpu_torch.search.ann_quality import cagra_shards_from_env
            from nornicdb_tpu_torch.search.cagra import CagraIndex

            p = current_profile()
            self.index = CagraIndex(
                dims=self.key.dims or None,
                degree=p.cagra_degree, itopk=p.cagra_itopk,
                search_width=p.cagra_width, min_n=p.cagra_min_n,
                n_shards=cagra_shards_from_env(p.cagra_shards),
                device=self.device)
        else:
            raise ValueError(f"unknown backend {kind!r}")
        return self.index


class VectorSpaceRegistry:
    """Thread-safe registry of vector spaces, each built on ``device``."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._spaces: Dict[SpaceKey, VectorSpace] = {}
        self._lock = threading.Lock()

    def register(self, key: SpaceKey, backend: str = "auto") -> VectorSpace:
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        with self._lock:
            sp = self._spaces.get(key)
            if sp is None:
                sp = VectorSpace(key=key, backend=backend, device=self.device)
                self._spaces[key] = sp
            return sp

    def get(self, key: SpaceKey) -> Optional[VectorSpace]:
        with self._lock:
            return self._spaces.get(key)

    def get_or_create(
        self,
        database: str = "neo4j",
        entity_type: str = "node",
        vector_name: str = DEFAULT_VECTOR_NAME,
        dims: int = 0,
        metric: str = "cosine",
        backend: str = "auto",
    ) -> VectorSpace:
        return self.register(
            SpaceKey(database, entity_type, vector_name, dims, metric),
            backend)

    def list(self, database: Optional[str] = None) -> List[SpaceKey]:
        with self._lock:
            return [k for k in self._spaces
                    if database is None or k.database == database]

    def drop(self, key: SpaceKey) -> bool:
        with self._lock:
            return self._spaces.pop(key, None) is not None

    def drop_database(self, database: str) -> int:
        """Drop every space of a database (multi-DB drop path)."""
        with self._lock:
            doomed = [k for k in self._spaces if k.database == database]
            for k in doomed:
                del self._spaces[k]
            return len(doomed)
