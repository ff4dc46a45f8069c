"""DB facade: open / store / flush / search / recall (counterpart of
``nornicdb_tpu/db.py:DB``, in-memory).

Nodes land in an in-memory engine behind the listener layer; the embed
queue embeds them with the default embedder (the committed mini encoder,
or ``HashEmbedder`` when no checkpoint exists) and the search service
indexes them. Disk engines, WAL, encryption, replication, Cypher and the
graph surfaces wait for later slices.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.storage import ListenableEngine, MemoryEngine, Node


class DB:
    """One logical database instance."""

    def __init__(
        self,
        device: DeviceLike = None,
        embedder: Optional[Any] = None,
        auto_embed: bool = True,
    ):
        self.device = resolve_device(device)
        self._listenable = ListenableEngine(MemoryEngine())
        self.storage = self._listenable
        self._lock = threading.Lock()
        self._closed = False
        self._search = None
        self._embedder = embedder if embedder is not None else self._default_embedder()
        self._embed_queue = None
        if auto_embed:
            from nornicdb_tpu_torch.embed.queue import EmbedQueue

            self._embed_queue = EmbedQueue(
                self.storage, self._embedder, on_embedded=self._on_embedded)
            self._listenable.add_listener(self._embed_queue)
            self._embed_queue.start()

    def _default_embedder(self):
        """The committed mini encoder behind an LRU; ``HashEmbedder``
        when the checkpoint is absent."""
        from nornicdb_tpu_torch.embed.embedder import CachedEmbedder, HashEmbedder
        from nornicdb_tpu_torch.models.checkpoint import load_default_embedder

        inner = load_default_embedder(self.device)
        return CachedEmbedder(inner if inner is not None else HashEmbedder())

    @property
    def search(self):
        """The search service, built on first use and backfilled from
        storage (nodes stored before it existed)."""
        with self._lock:
            if self._search is None:
                from nornicdb_tpu_torch.search.service import SearchService

                svc = SearchService(self.storage, embedder=self._embedder,
                                    device=self.device)
                # publish before the backfill so an embed finishing
                # meanwhile lands through _on_embedded (index_node is
                # idempotent)
                self._search = svc
                try:
                    svc.build_indexes()
                except BaseException:
                    self._search = None
                    raise
            return self._search

    def _on_embedded(self, node: Node) -> None:
        if self._search is not None:
            self._search.index_node(node)

    # -- public API ------------------------------------------------------

    def store(
        self,
        content: str,
        labels: Optional[Sequence[str]] = None,
        properties: Optional[Dict[str, Any]] = None,
        node_id: Optional[str] = None,
        embedding: Optional[List[float]] = None,
    ) -> Node:
        """Store a memory node."""
        nid = node_id or str(uuid.uuid4())
        props = dict(properties or {})
        props.setdefault("content", content)
        node = Node(id=nid, labels=list(labels or ["Memory"]),
                    properties=props, embedding=embedding)
        self.storage.create_node(node)
        if embedding is not None and self._search is not None:
            # explicit embeddings bypass the embed queue, so an already
            # built search service indexes them here
            self._search.index_node(self.storage.get_node(nid))
        return self.storage.get_node(nid)

    def recall(self, query: str, limit: int = 10, **kw) -> List[Dict[str, Any]]:
        """Hybrid search over stored memories."""
        return self.search.search(query, limit=limit, **kw)

    def flush(self) -> None:
        """Wait until every stored node is embedded (and indexed)."""
        if self._embed_queue is not None and not self._embed_queue.drain(None):
            raise RuntimeError("embed queue worker stopped with work pending")
        self.storage.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._embed_queue is not None:
            self._embed_queue.stop()
        self.storage.close()

    def __enter__(self) -> "DB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open(device: DeviceLike = None, **kw) -> DB:  # noqa: A001
    """Open an in-memory database on ``device`` (None = cuda)."""
    return DB(device=device, **kw)
