"""Nodes, edges, the engine contract, the decorator base and the
mutation-listener layer (counterpart of
``nornicdb_tpu/storage/types.py``).

The contract holds node and edge CRUD, label and edge-type lookups,
adjacency, counts, batched reads and ``delete_by_prefix``: every engine
stores edges, and a data dir holds edge records, so the contract needs
them before the graph surfaces do. All engines are thread-safe.
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

NodeID = str
EdgeID = str


class NotFoundError(KeyError):
    """An id that the engine does not hold."""


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

    def to_dict(self) -> Dict[str, Any]:
        """The record as the reference stores it (key order included:
        the codec's bytes depend on it)."""
        d: Dict[str, Any] = {
            "id": self.id,
            "labels": self.labels,
            "properties": self.properties,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }
        if self.embedding is not None:
            d["embedding"] = self.embedding
        if self.chunk_embeddings is not None:
            d["chunk_embeddings"] = self.chunk_embeddings
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Node":
        return Node(
            id=d["id"],
            labels=list(d.get("labels") or []),
            properties=dict(d.get("properties") or {}),
            created_at=int(d.get("created_at") or 0),
            updated_at=int(d.get("updated_at") or 0),
            embedding=d.get("embedding"),
            chunk_embeddings=d.get("chunk_embeddings"),
        )


@dataclass
class Edge:
    """A directed, typed relationship."""

    id: EdgeID
    type: str
    start_node: NodeID
    end_node: NodeID
    properties: Dict[str, Any] = field(default_factory=dict)
    created_at: int = 0
    updated_at: int = 0

    def copy(self) -> "Edge":
        return Edge(
            id=self.id,
            type=self.type,
            start_node=self.start_node,
            end_node=self.end_node,
            properties=dict(self.properties),
            created_at=self.created_at,
            updated_at=self.updated_at,
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "type": self.type,
            "start_node": self.start_node,
            "end_node": self.end_node,
            "properties": self.properties,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Edge":
        return Edge(
            id=d["id"],
            type=d["type"],
            start_node=d["start_node"],
            end_node=d["end_node"],
            properties=dict(d.get("properties") or {}),
            created_at=int(d.get("created_at") or 0),
            updated_at=int(d.get("updated_at") or 0),
        )


class Direction:
    OUTGOING = "out"
    INCOMING = "in"
    BOTH = "both"


class Engine(ABC):
    """Storage engine contract. Engines compose as decorators; the DB's
    chain is base -> [Async] -> Namespaced -> Listenable."""

    # -- nodes ----------------------------------------------------------

    @abstractmethod
    def create_node(self, node: Node) -> None: ...

    @abstractmethod
    def get_node(self, node_id: NodeID) -> Node: ...

    @abstractmethod
    def update_node(self, node: Node) -> None: ...

    @abstractmethod
    def delete_node(self, node_id: NodeID) -> None:
        """Delete a node and all its edges."""

    @abstractmethod
    def get_nodes_by_label(self, label: str) -> List[Node]: ...

    def node_ids_by_label(self, label: str) -> List[NodeID]:
        return [n.id for n in self.get_nodes_by_label(label)]

    @abstractmethod
    def all_nodes(self) -> Iterable[Node]: ...

    def batch_get_nodes(self, node_ids: Sequence[NodeID]) -> List[Optional[Node]]:
        """Batched fetch; a missing node yields None."""
        out: List[Optional[Node]] = []
        for nid in node_ids:
            try:
                out.append(self.get_node(nid))
            except KeyError:
                out.append(None)
        return out

    def has_node(self, node_id: NodeID) -> bool:
        try:
            self.get_node(node_id)
            return True
        except KeyError:
            return False

    def has_edge(self, edge_id: EdgeID) -> bool:
        try:
            self.get_edge(edge_id)
            return True
        except KeyError:
            return False

    # -- edges ----------------------------------------------------------

    @abstractmethod
    def create_edge(self, edge: Edge) -> None: ...

    @abstractmethod
    def get_edge(self, edge_id: EdgeID) -> Edge: ...

    @abstractmethod
    def update_edge(self, edge: Edge) -> None: ...

    @abstractmethod
    def delete_edge(self, edge_id: EdgeID) -> None: ...

    @abstractmethod
    def get_edges_by_type(self, edge_type: str) -> List[Edge]: ...

    @abstractmethod
    def all_edges(self) -> Iterable[Edge]: ...

    @abstractmethod
    def get_node_edges(
        self, node_id: NodeID, direction: str = Direction.BOTH
    ) -> List[Edge]: ...

    def degree(self, node_id: NodeID, direction: str = Direction.BOTH) -> int:
        return len(self.get_node_edges(node_id, direction))

    def neighbors(
        self, node_id: NodeID, direction: str = Direction.BOTH
    ) -> List[NodeID]:
        out: List[NodeID] = []
        for e in self.get_node_edges(node_id, direction):
            if e.start_node == node_id and direction in (
                Direction.OUTGOING,
                Direction.BOTH,
            ):
                out.append(e.end_node)
            if e.end_node == node_id and direction in (
                Direction.INCOMING,
                Direction.BOTH,
            ):
                out.append(e.start_node)
        return out

    # -- counts / maintenance -------------------------------------------

    @abstractmethod
    def count_nodes(self) -> int: ...

    @abstractmethod
    def count_edges(self) -> int: ...

    def delete_by_prefix(self, prefix: str) -> Tuple[int, int]:
        """Delete every node and edge whose id starts with ``prefix`` (and
        every edge touching such a node). Returns (nodes, edges)."""
        nodes = [n.id for n in self.all_nodes() if n.id.startswith(prefix)]
        edges = [
            e.id
            for e in self.all_edges()
            if e.id.startswith(prefix)
            or e.start_node.startswith(prefix)
            or e.end_node.startswith(prefix)
        ]
        for eid in edges:
            try:
                self.delete_edge(eid)
            except KeyError:
                pass
        for nid in nodes:
            try:
                self.delete_node(nid)
            except KeyError:
                pass
        return len(nodes), len(edges)

    def list_namespaces(self) -> List[str]:
        """The distinct ``db:`` prefixes of the stored node ids."""
        seen = set()
        for n in self.all_nodes():
            if ":" in n.id:
                seen.add(n.id.split(":", 1)[0])
        return sorted(seen)

    def flush(self) -> None:
        """Flush buffered writes (no-op for synchronous engines)."""

    def close(self) -> None:  # noqa: B027
        """Release resources."""


class EngineDecorator(Engine):
    """Base of decorator engines: forwards everything to ``inner``;
    optional methods of the engines (``count_nodes_with_prefix``, ...)
    are forwarded through ``__getattr__``, so a chain stays transparent
    to ``getattr`` probes."""

    def __init__(self, inner: Engine):
        self.inner = inner

    def __getattr__(self, name: str):
        if name == "inner":  # not yet set during __init__
            raise AttributeError(name)
        return getattr(self.inner, name)

    def create_node(self, node: Node) -> None:
        self.inner.create_node(node)

    def get_node(self, node_id: NodeID) -> Node:
        return self.inner.get_node(node_id)

    def update_node(self, node: Node) -> None:
        self.inner.update_node(node)

    def delete_node(self, node_id: NodeID) -> None:
        self.inner.delete_node(node_id)

    def get_nodes_by_label(self, label: str) -> List[Node]:
        return self.inner.get_nodes_by_label(label)

    def node_ids_by_label(self, label: str) -> List[NodeID]:
        return self.inner.node_ids_by_label(label)

    def all_nodes(self) -> Iterable[Node]:
        return self.inner.all_nodes()

    def batch_get_nodes(self, node_ids: Sequence[NodeID]) -> List[Optional[Node]]:
        return self.inner.batch_get_nodes(node_ids)

    def create_edge(self, edge: Edge) -> None:
        self.inner.create_edge(edge)

    def get_edge(self, edge_id: EdgeID) -> Edge:
        return self.inner.get_edge(edge_id)

    def update_edge(self, edge: Edge) -> None:
        self.inner.update_edge(edge)

    def delete_edge(self, edge_id: EdgeID) -> None:
        self.inner.delete_edge(edge_id)

    def get_edges_by_type(self, edge_type: str) -> List[Edge]:
        return self.inner.get_edges_by_type(edge_type)

    def all_edges(self) -> Iterable[Edge]:
        return self.inner.all_edges()

    def get_node_edges(
        self, node_id: NodeID, direction: str = Direction.BOTH
    ) -> List[Edge]:
        return self.inner.get_node_edges(node_id, direction)

    def degree(self, node_id: NodeID, direction: str = Direction.BOTH) -> int:
        return self.inner.degree(node_id, direction)

    def has_node(self, node_id: NodeID) -> bool:
        return self.inner.has_node(node_id)

    def has_edge(self, edge_id: EdgeID) -> bool:
        return self.inner.has_edge(edge_id)

    def count_nodes(self) -> int:
        return self.inner.count_nodes()

    def count_edges(self) -> int:
        return self.inner.count_edges()

    def delete_by_prefix(self, prefix: str) -> Tuple[int, int]:
        return self.inner.delete_by_prefix(prefix)

    def list_namespaces(self) -> List[str]:
        return self.inner.list_namespaces()

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()


class MutationListener:
    """Callback hooks fired after successful mutations; they drive the
    embed queue."""

    def on_node_upsert(self, node: Node) -> None: ...

    def on_node_delete(self, node_id: NodeID) -> None: ...

    def on_edge_upsert(self, edge: Edge) -> None: ...

    def on_edge_delete(self, edge_id: EdgeID) -> None: ...

    def on_bulk_change(self) -> None:
        """A bulk mutation that carries no per-entity events
        (``clear``, ``delete_by_prefix``)."""


class ListenableEngine(EngineDecorator):
    """Decorator that fans mutations out to registered listeners."""

    def __init__(self, inner: Engine):
        super().__init__(inner)
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

    def update_node(self, node: Node) -> None:
        self.inner.update_node(node)
        for listener in self._each():
            listener.on_node_upsert(node)

    def delete_node(self, node_id: NodeID) -> None:
        self.inner.delete_node(node_id)
        for listener in self._each():
            listener.on_node_delete(node_id)

    def create_edge(self, edge: Edge) -> None:
        self.inner.create_edge(edge)
        for listener in self._each():
            listener.on_edge_upsert(edge)

    def update_edge(self, edge: Edge) -> None:
        self.inner.update_edge(edge)
        for listener in self._each():
            listener.on_edge_upsert(edge)

    def delete_edge(self, edge_id: EdgeID) -> None:
        self.inner.delete_edge(edge_id)
        for listener in self._each():
            listener.on_edge_delete(edge_id)

    def delete_by_prefix(self, prefix: str) -> Tuple[int, int]:
        # without events, a cache above this engine would serve state
        # from before the drop
        out = self.inner.delete_by_prefix(prefix)
        for listener in self._each():
            listener.on_bulk_change()
        return out

    def clear(self) -> None:
        self.inner.clear()
        for listener in self._each():
            listener.on_bulk_change()
