"""In-memory node engine (counterpart of ``nornicdb_tpu/storage/memory.py``,
nodes only)."""

from __future__ import annotations

import threading
from typing import Dict, Iterable

from nornicdb_tpu_torch.storage.types import (
    AlreadyExistsError,
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
            self._nodes[n.id] = n

    def delete_node(self, node_id: NodeID) -> None:
        with self._lock:
            if self._nodes.pop(node_id, None) is None:
                raise NotFoundError(f"node {node_id} not found")

    def all_nodes(self) -> Iterable[Node]:
        with self._lock:
            return [n.copy() for n in self._nodes.values()]

    def count_nodes(self) -> int:
        with self._lock:
            return len(self._nodes)
