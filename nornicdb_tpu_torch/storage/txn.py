"""Transaction overlay engine: buffered writes with commit and rollback
(counterpart of ``nornicdb_tpu/storage/txn.py``).

Explicit BEGIN / COMMIT / ROLLBACK transactions. Writes land in an
in-memory overlay (reads see the transaction's own writes), reads fall
through to the inner engine, COMMIT replays the op log onto the inner
engine and ROLLBACK discards it. The Bolt and HTTP transaction endpoints
run statements against this engine.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from nornicdb_tpu_torch.storage.types import (
    Direction,
    Edge,
    EdgeID,
    Engine,
    Node,
    NodeID,
    NotFoundError,
    now_ms,
)


class TransactionClosed(RuntimeError):
    pass


class TransactionOverlay(Engine):
    """One open transaction. Not thread-safe across statements by design —
    a tx belongs to one session (reference: txsession)."""

    def __init__(self, inner: Engine):
        self.inner = inner
        self._nodes: Dict[NodeID, Node] = {}       # created/updated in tx
        self._edges: Dict[EdgeID, Edge] = {}
        self._deleted_nodes: Set[NodeID] = set()
        self._deleted_edges: Set[EdgeID] = set()
        self._ops: List[Tuple[str, object]] = []   # replay log for commit
        self._open = True
        self.started_at = time.time()

    # -- lifecycle -------------------------------------------------------

    def _check_open(self) -> None:
        if not self._open:
            raise TransactionClosed("transaction already closed")

    def commit(self) -> int:
        """Replay buffered ops onto the inner engine. Returns op count."""
        self._check_open()
        self._open = False
        n = 0
        for op, arg in self._ops:
            if op == "create_node":
                self.inner.create_node(arg)  # type: ignore[arg-type]
            elif op == "update_node":
                self.inner.update_node(arg)  # type: ignore[arg-type]
            elif op == "delete_node":
                self.inner.delete_node(arg)  # type: ignore[arg-type]
            elif op == "create_edge":
                self.inner.create_edge(arg)  # type: ignore[arg-type]
            elif op == "update_edge":
                self.inner.update_edge(arg)  # type: ignore[arg-type]
            elif op == "delete_edge":
                self.inner.delete_edge(arg)  # type: ignore[arg-type]
            n += 1
        return n

    def rollback(self) -> int:
        self._check_open()
        self._open = False
        n = len(self._ops)
        self._ops.clear()
        self._nodes.clear()
        self._edges.clear()
        self._deleted_nodes.clear()
        self._deleted_edges.clear()
        return n

    @property
    def is_open(self) -> bool:
        return self._open

    # -- nodes -----------------------------------------------------------

    def create_node(self, node: Node) -> None:
        self._check_open()
        if self.has_node(node.id):
            raise ValueError(f"node exists: {node.id}")
        n = node.copy()
        ts = now_ms()
        n.created_at = n.created_at or ts
        n.updated_at = ts
        self._nodes[n.id] = n
        self._deleted_nodes.discard(n.id)
        self._ops.append(("create_node", n.copy()))

    def get_node(self, node_id: NodeID) -> Node:
        if node_id in self._deleted_nodes:
            raise NotFoundError(f"node {node_id} not found")
        n = self._nodes.get(node_id)
        if n is not None:
            return n.copy()
        return self.inner.get_node(node_id)

    def update_node(self, node: Node) -> None:
        self._check_open()
        old = self.get_node(node.id)  # raises if missing
        n = node.copy()
        n.created_at = old.created_at
        n.updated_at = now_ms()
        self._nodes[n.id] = n
        self._ops.append(("update_node", n.copy()))

    def delete_node(self, node_id: NodeID) -> None:
        self._check_open()
        self.get_node(node_id)  # raises if missing
        for e in self.get_node_edges(node_id, Direction.BOTH):
            self.delete_edge(e.id)
        self._nodes.pop(node_id, None)
        self._deleted_nodes.add(node_id)
        self._ops.append(("delete_node", node_id))

    def get_nodes_by_label(self, label: str) -> List[Node]:
        return [n for n in self.all_nodes() if label in n.labels]

    def all_nodes(self) -> Iterable[Node]:
        seen: Set[NodeID] = set()
        for n in self._nodes.values():
            seen.add(n.id)
            yield n.copy()
        for n in self.inner.all_nodes():
            if n.id not in seen and n.id not in self._deleted_nodes:
                yield n

    def batch_get_nodes(self, node_ids: Sequence[NodeID]) -> List[Optional[Node]]:
        out: List[Optional[Node]] = []
        for nid in node_ids:
            try:
                out.append(self.get_node(nid))
            except KeyError:
                out.append(None)
        return out

    def has_node(self, node_id: NodeID) -> bool:
        if node_id in self._deleted_nodes:
            return False
        return node_id in self._nodes or self.inner.has_node(node_id)

    # -- edges -----------------------------------------------------------

    def create_edge(self, edge: Edge) -> None:
        self._check_open()
        if self.has_edge(edge.id):
            raise ValueError(f"edge exists: {edge.id}")
        if not self.has_node(edge.start_node):
            raise NotFoundError(f"node {edge.start_node} not found")
        if not self.has_node(edge.end_node):
            raise NotFoundError(f"node {edge.end_node} not found")
        e = edge.copy()
        ts = now_ms()
        e.created_at = e.created_at or ts
        e.updated_at = ts
        self._edges[e.id] = e
        self._deleted_edges.discard(e.id)
        self._ops.append(("create_edge", e.copy()))

    def get_edge(self, edge_id: EdgeID) -> Edge:
        if edge_id in self._deleted_edges:
            raise NotFoundError(f"edge {edge_id} not found")
        e = self._edges.get(edge_id)
        if e is not None:
            return e.copy()
        return self.inner.get_edge(edge_id)

    def update_edge(self, edge: Edge) -> None:
        self._check_open()
        old = self.get_edge(edge.id)
        e = edge.copy()
        e.created_at = old.created_at
        e.updated_at = now_ms()
        # endpoints/type immutable (parity with engines)
        e.start_node, e.end_node, e.type = old.start_node, old.end_node, old.type
        self._edges[e.id] = e
        self._ops.append(("update_edge", e.copy()))

    def delete_edge(self, edge_id: EdgeID) -> None:
        self._check_open()
        self.get_edge(edge_id)
        self._edges.pop(edge_id, None)
        self._deleted_edges.add(edge_id)
        self._ops.append(("delete_edge", edge_id))

    def get_edges_by_type(self, edge_type: str) -> List[Edge]:
        return [e for e in self.all_edges() if e.type == edge_type]

    def all_edges(self) -> Iterable[Edge]:
        seen: Set[EdgeID] = set()
        for e in self._edges.values():
            seen.add(e.id)
            yield e.copy()
        for e in self.inner.all_edges():
            if e.id not in seen and e.id not in self._deleted_edges:
                yield e

    def get_node_edges(self, node_id: NodeID, direction: str = Direction.BOTH) -> List[Edge]:
        out = []
        for e in self.all_edges():
            if direction in (Direction.OUTGOING, Direction.BOTH) and e.start_node == node_id:
                out.append(e)
            elif direction in (Direction.INCOMING, Direction.BOTH) and e.end_node == node_id:
                out.append(e)
        return out

    def has_edge(self, edge_id: EdgeID) -> bool:
        if edge_id in self._deleted_edges:
            return False
        return edge_id in self._edges or self.inner.has_edge(edge_id)

    # -- counts ----------------------------------------------------------

    def count_nodes(self) -> int:
        return sum(1 for _ in self.all_nodes())

    def count_edges(self) -> int:
        return sum(1 for _ in self.all_edges())


class TransactionManager:
    """Tracks open transactions per session with timeout reaping
    (reference: pkg/txsession/manager.go:138)."""

    def __init__(self, timeout_seconds: float = 60.0):
        self._txs: Dict[str, TransactionOverlay] = {}
        self._lock = threading.Lock()
        self.timeout = timeout_seconds

    def begin(self, session_id: str, storage: Engine) -> TransactionOverlay:
        with self._lock:
            existing = self._txs.get(session_id)
            if existing is not None and existing.is_open:
                raise RuntimeError("transaction already open for session")
            tx = TransactionOverlay(storage)
            self._txs[session_id] = tx
            return tx

    def get(self, session_id: str) -> Optional[TransactionOverlay]:
        with self._lock:
            tx = self._txs.get(session_id)
            return tx if tx is not None and tx.is_open else None

    def commit(self, session_id: str) -> int:
        tx = self.get(session_id)
        if tx is None:
            raise RuntimeError("no open transaction")
        try:
            return tx.commit()
        finally:
            self._drop(session_id)

    def rollback(self, session_id: str) -> int:
        tx = self.get(session_id)
        if tx is None:
            raise RuntimeError("no open transaction")
        try:
            return tx.rollback()
        finally:
            self._drop(session_id)

    def _drop(self, session_id: str) -> None:
        with self._lock:
            self._txs.pop(session_id, None)

    def reap_expired(self) -> int:
        now = time.time()
        reaped = 0
        with self._lock:
            for sid, tx in list(self._txs.items()):
                if tx.is_open and now - tx.started_at > self.timeout:
                    tx.rollback()
                    del self._txs[sid]
                    reaped += 1
        return reaped
