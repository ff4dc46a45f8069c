"""In-memory storage engine (counterpart of
``nornicdb_tpu/storage/memory.py``): label and edge-type secondary
indexes plus per-node adjacency for O(1) degree queries. It is the base
of the pure-Python durable engine (``wal_engine.py``) and of a DB opened
without a data dir."""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from nornicdb_tpu_torch.storage.types import (
    AlreadyExistsError,
    Direction,
    Edge,
    EdgeID,
    Engine,
    Node,
    NodeID,
    NotFoundError,
    now_ms,
)


class MemoryEngine(Engine):
    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: Dict[NodeID, Node] = {}
        self._edges: Dict[EdgeID, Edge] = {}
        self._by_label: Dict[str, Set[NodeID]] = {}
        self._by_type: Dict[str, Set[EdgeID]] = {}
        self._out: Dict[NodeID, Set[EdgeID]] = {}
        self._in: Dict[NodeID, Set[EdgeID]] = {}

    # -- nodes ----------------------------------------------------------

    def create_node(self, node: Node) -> None:
        with self._lock:
            if node.id in self._nodes:
                raise AlreadyExistsError(f"node {node.id} already exists")
            n = node.copy()
            if not n.created_at:
                n.created_at = now_ms()
            if not n.updated_at:
                n.updated_at = n.created_at
            self._nodes[n.id] = n
            for label in n.labels:
                self._by_label.setdefault(label, set()).add(n.id)

    def get_node(self, node_id: NodeID) -> Node:
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None:
                raise NotFoundError(f"node {node_id} not found")
            return n.copy()

    def update_node(self, node: Node) -> None:
        with self._lock:
            old = self._nodes.get(node.id)
            if old is None:
                raise NotFoundError(f"node {node.id} not found")
            n = node.copy()
            n.created_at = old.created_at
            n.updated_at = now_ms()
            for label in old.labels:
                if label not in n.labels:
                    self._by_label.get(label, set()).discard(n.id)
            for label in n.labels:
                self._by_label.setdefault(label, set()).add(n.id)
            self._nodes[n.id] = n

    def delete_node(self, node_id: NodeID) -> None:
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None:
                raise NotFoundError(f"node {node_id} not found")
            for eid in list(self._out.get(node_id, ())) + list(
                self._in.get(node_id, ())
            ):
                if eid in self._edges:
                    self._delete_edge_locked(eid)
            del self._nodes[node_id]
            for label in n.labels:
                self._by_label.get(label, set()).discard(node_id)
            self._out.pop(node_id, None)
            self._in.pop(node_id, None)

    def get_nodes_by_label(self, label: str) -> List[Node]:
        with self._lock:
            ids = self._by_label.get(label, set())
            return [self._nodes[i].copy() for i in ids if i in self._nodes]

    def node_ids_by_label(self, label: str) -> List[NodeID]:
        with self._lock:
            ids = self._by_label.get(label, set())
            return [i for i in ids if i in self._nodes]

    def all_nodes(self) -> Iterable[Node]:
        with self._lock:
            return [n.copy() for n in self._nodes.values()]

    def batch_get_nodes(self, node_ids: Sequence[NodeID]) -> List[Optional[Node]]:
        with self._lock:
            return [
                self._nodes[i].copy() if i in self._nodes else None for i in node_ids
            ]

    # -- edges ----------------------------------------------------------

    def create_edge(self, edge: Edge) -> None:
        with self._lock:
            if edge.id in self._edges:
                raise AlreadyExistsError(f"edge {edge.id} already exists")
            if edge.start_node not in self._nodes:
                raise NotFoundError(f"start node {edge.start_node} not found")
            if edge.end_node not in self._nodes:
                raise NotFoundError(f"end node {edge.end_node} not found")
            e = edge.copy()
            if not e.created_at:
                e.created_at = now_ms()
            if not e.updated_at:
                e.updated_at = e.created_at
            self._edges[e.id] = e
            self._by_type.setdefault(e.type, set()).add(e.id)
            self._out.setdefault(e.start_node, set()).add(e.id)
            self._in.setdefault(e.end_node, set()).add(e.id)

    def get_edge(self, edge_id: EdgeID) -> Edge:
        with self._lock:
            e = self._edges.get(edge_id)
            if e is None:
                raise NotFoundError(f"edge {edge_id} not found")
            return e.copy()

    def update_edge(self, edge: Edge) -> None:
        with self._lock:
            old = self._edges.get(edge.id)
            if old is None:
                raise NotFoundError(f"edge {edge.id} not found")
            e = edge.copy()
            e.created_at = old.created_at
            e.updated_at = now_ms()
            # endpoints and type are immutable
            e.start_node, e.end_node, e.type = (
                old.start_node,
                old.end_node,
                old.type,
            )
            self._edges[e.id] = e

    def _delete_edge_locked(self, edge_id: EdgeID) -> None:
        e = self._edges.pop(edge_id)
        self._by_type.get(e.type, set()).discard(edge_id)
        self._out.get(e.start_node, set()).discard(edge_id)
        self._in.get(e.end_node, set()).discard(edge_id)

    def delete_edge(self, edge_id: EdgeID) -> None:
        with self._lock:
            if edge_id not in self._edges:
                raise NotFoundError(f"edge {edge_id} not found")
            self._delete_edge_locked(edge_id)

    def get_edges_by_type(self, edge_type: str) -> List[Edge]:
        with self._lock:
            ids = self._by_type.get(edge_type, set())
            return [self._edges[i].copy() for i in ids if i in self._edges]

    def all_edges(self) -> Iterable[Edge]:
        with self._lock:
            return [e.copy() for e in self._edges.values()]

    def get_node_edges(
        self, node_id: NodeID, direction: str = Direction.BOTH
    ) -> List[Edge]:
        with self._lock:
            ids: Set[EdgeID] = set()
            if direction in (Direction.OUTGOING, Direction.BOTH):
                ids |= self._out.get(node_id, set())
            if direction in (Direction.INCOMING, Direction.BOTH):
                ids |= self._in.get(node_id, set())
            return [self._edges[i].copy() for i in ids if i in self._edges]

    def degree(self, node_id: NodeID, direction: str = Direction.BOTH) -> int:
        with self._lock:
            if direction == Direction.OUTGOING:
                return len(self._out.get(node_id, ()))
            if direction == Direction.INCOMING:
                return len(self._in.get(node_id, ()))
            return len(
                self._out.get(node_id, set()) | self._in.get(node_id, set())
            )

    # -- counts ---------------------------------------------------------

    def count_nodes(self) -> int:
        with self._lock:
            return len(self._nodes)

    def count_edges(self) -> int:
        with self._lock:
            return len(self._edges)

    def has_node(self, node_id: NodeID) -> bool:
        with self._lock:
            return node_id in self._nodes

    def has_edge(self, edge_id: EdgeID) -> bool:
        with self._lock:
            return edge_id in self._edges

    def count_nodes_by_label(self, label: str) -> int:
        """Label cardinality without materializing nodes."""
        with self._lock:
            return len(self._by_label.get(label, ()))

    def count_nodes_with_prefix(self, prefix: str) -> int:
        with self._lock:
            return sum(1 for i in self._nodes if i.startswith(prefix))

    def count_edges_with_prefix(self, prefix: str) -> int:
        with self._lock:
            return sum(1 for i in self._edges if i.startswith(prefix))

    def delete_by_prefix(self, prefix: str) -> Tuple[int, int]:
        with self._lock:
            return super().delete_by_prefix(prefix)

    def clear(self) -> None:
        with self._lock:
            self._nodes.clear()
            self._edges.clear()
            self._by_label.clear()
            self._by_type.clear()
            self._out.clear()
            self._in.clear()
