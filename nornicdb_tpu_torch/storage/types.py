"""Node, the node-engine contract and the mutation-listener layer.

Counterpart of ``nornicdb_tpu/storage/types.py``, cut to what the main
path uses: nodes (edges, namespacing and bulk ops wait for a later
slice). All engines are thread-safe.
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

NodeID = str


class NotFoundError(KeyError):
    """A node id that the engine does not hold."""


class AlreadyExistsError(Exception):
    """A create of an id that the engine already holds."""


def now_ms() -> int:
    return int(time.time() * 1000)


@dataclass
class Node:
    """A graph node. ``embedding`` is the whole-document vector;
    ``chunk_embeddings`` holds per-chunk vectors of long documents."""

    id: NodeID
    labels: List[str] = field(default_factory=list)
    properties: Dict[str, Any] = field(default_factory=dict)
    created_at: int = 0
    updated_at: int = 0
    embedding: Optional[List[float]] = None
    chunk_embeddings: Optional[List[List[float]]] = None

    def copy(self) -> "Node":
        return Node(
            id=self.id,
            labels=list(self.labels),
            properties=dict(self.properties),
            created_at=self.created_at,
            updated_at=self.updated_at,
            embedding=list(self.embedding) if self.embedding is not None else None,
            chunk_embeddings=[list(c) for c in self.chunk_embeddings]
            if self.chunk_embeddings is not None
            else None,
        )


class Engine(ABC):
    """Node storage contract."""

    @abstractmethod
    def create_node(self, node: Node) -> None: ...

    @abstractmethod
    def get_node(self, node_id: NodeID) -> Node: ...

    @abstractmethod
    def update_node(self, node: Node) -> None: ...

    @abstractmethod
    def delete_node(self, node_id: NodeID) -> None: ...

    @abstractmethod
    def all_nodes(self) -> Iterable[Node]: ...

    @abstractmethod
    def count_nodes(self) -> int: ...

    def flush(self) -> None:
        """Flush buffered writes (no-op for synchronous engines)."""

    def close(self) -> None:  # noqa: B027
        """Release resources."""


class MutationListener:
    """Callback hooks fired after successful mutations; they drive the
    embed queue."""

    def on_node_upsert(self, node: Node) -> None: ...

    def on_node_delete(self, node_id: NodeID) -> None: ...


class ListenableEngine(Engine):
    """Decorator that fans node mutations out to registered listeners."""

    def __init__(self, inner: Engine):
        self.inner = inner
        self._listeners: List[MutationListener] = []
        self._lock = threading.Lock()

    def add_listener(self, listener: MutationListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def _each(self) -> List[MutationListener]:
        with self._lock:
            return list(self._listeners)

    def create_node(self, node: Node) -> None:
        self.inner.create_node(node)
        for listener in self._each():
            listener.on_node_upsert(node)

    def get_node(self, node_id: NodeID) -> Node:
        return self.inner.get_node(node_id)

    def update_node(self, node: Node) -> None:
        self.inner.update_node(node)
        for listener in self._each():
            listener.on_node_upsert(node)

    def delete_node(self, node_id: NodeID) -> None:
        self.inner.delete_node(node_id)
        for listener in self._each():
            listener.on_node_delete(node_id)

    def all_nodes(self) -> Iterable[Node]:
        return self.inner.all_nodes()

    def count_nodes(self) -> int:
        return self.inner.count_nodes()

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()
