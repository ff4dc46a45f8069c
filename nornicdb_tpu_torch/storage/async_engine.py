"""Write-behind (async) engine decorator, behind
``DB(async_writes=True)`` (counterpart of
``nornicdb_tpu/storage/async_engine.py``).

Buffers mutations in an in-RAM overlay and flushes them to the inner
engine on a background interval: a write is acknowledged before it is
durable, and reads merge the overlay, so the writer always sees its own
writes. A flush error loses that write; it is logged and kept in
``last_flush_errors``.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from nornicdb_tpu_torch.storage.types import (
    AlreadyExistsError,
    Direction,
    Edge,
    EdgeID,
    Engine,
    EngineDecorator,
    Node,
    NodeID,
    NotFoundError,
    now_ms,
)

logger = logging.getLogger(__name__)

_TOMBSTONE = object()


@dataclass
class FlushResult:
    ops_flushed: int = 0
    errors: List[str] = field(default_factory=list)


class AsyncEngine(EngineDecorator):
    def __init__(self, inner: Engine, flush_interval_s: float = 0.1, max_pending: int = 10_000):
        super().__init__(inner)
        self.flush_interval_s = flush_interval_s
        self.max_pending = max_pending
        self._lock = threading.RLock()
        self._ops: List[Tuple[str, object]] = []
        self._nodes: Dict[NodeID, object] = {}  # Node or _TOMBSTONE
        self._edges: Dict[EdgeID, object] = {}  # Edge or _TOMBSTONE
        self.last_flush_errors: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if flush_interval_s > 0:
            self._thread = threading.Thread(
                target=self._flush_loop, name="async-engine-flush", daemon=True
            )
            self._thread.start()

    # -- background flush ------------------------------------------------

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            try:
                res = self.flush_pending()
                for err in res.errors:
                    logger.error("async flush error (write lost): %s", err)
                    self.last_flush_errors.append(err)
            except Exception:
                logger.exception("async flush loop failure")

    def flush_pending(self) -> FlushResult:
        """Drain buffered ops into the inner engine, preserving order.

        Ops are applied outside the overlay lock, and the overlay is
        cleared only of entries not written again during the flush, so a
        listener calling back into the engine cannot deadlock and a count
        taken meanwhile sees every write once."""
        with self._lock:
            ops = self._ops
            self._ops = []
        res = FlushResult()
        for kind, payload in ops:
            try:
                if kind == "upsert_node":
                    node = payload  # type: ignore[assignment]
                    try:
                        self.inner.update_node(node)
                    except KeyError:
                        self.inner.create_node(node)
                elif kind == "delete_node":
                    try:
                        self.inner.delete_node(payload)  # type: ignore[arg-type]
                    except KeyError:
                        pass
                elif kind == "upsert_edge":
                    edge = payload  # type: ignore[assignment]
                    try:
                        self.inner.update_edge(edge)
                    except KeyError:
                        self.inner.create_edge(edge)
                elif kind == "delete_edge":
                    try:
                        self.inner.delete_edge(payload)  # type: ignore[arg-type]
                    except KeyError:
                        pass
                res.ops_flushed += 1
            except Exception as exc:  # keep flushing; record error
                res.errors.append(f"{kind}: {exc}")
        with self._lock:
            # clear overlay entries that were not re-dirtied meanwhile
            dirty_nodes = {
                op[1].id if isinstance(op[1], Node) else op[1]
                for op in self._ops
                if op[0] in ("upsert_node", "delete_node")
            }
            dirty_edges = {
                op[1].id if isinstance(op[1], Edge) else op[1]
                for op in self._ops
                if op[0] in ("upsert_edge", "delete_edge")
            }
            for nid in list(self._nodes):
                if nid not in dirty_nodes:
                    del self._nodes[nid]
            for eid in list(self._edges):
                if eid not in dirty_edges:
                    del self._edges[eid]
        return res

    def flush(self) -> None:
        self.flush_pending()
        self.inner.flush()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.flush_pending()
        self.inner.close()

    def _over_pending(self) -> bool:
        """Whether the op buffer is over the backpressure threshold.

        Checked under the lock; the flush itself runs OUTSIDE the lock so a
        writer hitting backpressure doesn't stall readers for the whole
        flush (the invariant flush_pending documents)."""
        return len(self._ops) >= self.max_pending

    # -- nodes -----------------------------------------------------------

    def create_node(self, node: Node) -> None:
        n = node.copy()
        if not n.created_at:
            n.created_at = now_ms()
        if not n.updated_at:
            n.updated_at = n.created_at
        with self._lock:
            ov = self._nodes.get(n.id)
            exists = isinstance(ov, Node) or (
                ov is not _TOMBSTONE and self.inner.has_node(n.id)
            )
            if exists:
                raise AlreadyExistsError(f"node {n.id} already exists")
            self._nodes[n.id] = n
            self._ops.append(("upsert_node", n))
            bp = self._over_pending()
        if bp:
            self.flush_pending()

    def update_node(self, node: Node) -> None:
        n = node.copy()
        n.updated_at = now_ms()
        with self._lock:
            self._nodes[n.id] = n
            self._ops.append(("upsert_node", n))
            bp = self._over_pending()
        if bp:
            self.flush_pending()

    def delete_node(self, node_id: NodeID) -> None:
        with self._lock:
            self._nodes[node_id] = _TOMBSTONE
            # tombstone attached edges in the overlay as well
            for eid, ov in list(self._edges.items()):
                if isinstance(ov, Edge) and node_id in (ov.start_node, ov.end_node):
                    self._edges[eid] = _TOMBSTONE
            self._ops.append(("delete_node", node_id))
            bp = self._over_pending()
        if bp:
            self.flush_pending()

    def get_node(self, node_id: NodeID) -> Node:
        with self._lock:
            ov = self._nodes.get(node_id)
        if ov is _TOMBSTONE:
            raise NotFoundError(f"node {node_id} not found")
        if isinstance(ov, Node):
            return ov.copy()
        return self.inner.get_node(node_id)

    def has_node(self, node_id: NodeID) -> bool:
        with self._lock:
            ov = self._nodes.get(node_id)
        if ov is _TOMBSTONE:
            return False
        if isinstance(ov, Node):
            return True
        return self.inner.has_node(node_id)

    def has_edge(self, edge_id: EdgeID) -> bool:
        with self._lock:
            ov = self._edges.get(edge_id)
        if ov is _TOMBSTONE:
            return False
        if isinstance(ov, Edge):
            return True
        return self.inner.has_edge(edge_id)

    def get_nodes_by_label(self, label: str) -> List[Node]:
        base = {n.id: n for n in self.inner.get_nodes_by_label(label)}
        with self._lock:
            overlay = dict(self._nodes)
        for nid, ov in overlay.items():
            if ov is _TOMBSTONE:
                base.pop(nid, None)
            elif isinstance(ov, Node):
                if label in ov.labels:
                    base[nid] = ov
                else:
                    base.pop(nid, None)
        return [n.copy() for n in base.values()]

    def node_ids_by_label(self, label: str) -> List[NodeID]:
        ids = set(self.inner.node_ids_by_label(label))
        with self._lock:
            overlay = dict(self._nodes)
        for nid, ov in overlay.items():
            if ov is _TOMBSTONE:
                ids.discard(nid)
            elif isinstance(ov, Node):
                if label in ov.labels:
                    ids.add(nid)
                else:
                    ids.discard(nid)
        return list(ids)

    def all_nodes(self) -> Iterable[Node]:
        base = {n.id: n for n in self.inner.all_nodes()}
        with self._lock:
            overlay = dict(self._nodes)
        for nid, ov in overlay.items():
            if ov is _TOMBSTONE:
                base.pop(nid, None)
            elif isinstance(ov, Node):
                base[nid] = ov
        return [n.copy() for n in base.values()]

    def batch_get_nodes(self, node_ids: Sequence[NodeID]) -> List[Optional[Node]]:
        with self._lock:
            overlay = dict(self._nodes)
        missing = [i for i in node_ids if i not in overlay]
        fetched = dict(zip(missing, self.inner.batch_get_nodes(missing)))
        out: List[Optional[Node]] = []
        for nid in node_ids:
            ov = overlay.get(nid)
            if ov is _TOMBSTONE:
                out.append(None)
            elif isinstance(ov, Node):
                out.append(ov.copy())
            else:
                out.append(fetched.get(nid))
        return out

    # -- edges -----------------------------------------------------------

    def create_edge(self, edge: Edge) -> None:
        e = edge.copy()
        if not e.created_at:
            e.created_at = now_ms()
        if not e.updated_at:
            e.updated_at = e.created_at
        with self._lock:
            ov = self._edges.get(e.id)
            exists = isinstance(ov, Edge) or (
                ov is not _TOMBSTONE and self.inner.has_edge(e.id)
            )
            if exists:
                raise AlreadyExistsError(f"edge {e.id} already exists")
            dead = self._dead_node_ids()
            for endpoint in (e.start_node, e.end_node):
                present = (
                    isinstance(self._nodes.get(endpoint), Node)
                    or (endpoint not in dead and self.inner.has_node(endpoint))
                )
                if not present:
                    raise NotFoundError(f"node {endpoint} not found")
            self._edges[e.id] = e
            self._ops.append(("upsert_edge", e))
            bp = self._over_pending()
        if bp:
            self.flush_pending()

    def update_edge(self, edge: Edge) -> None:
        e = edge.copy()
        e.updated_at = now_ms()
        with self._lock:
            self._edges[e.id] = e
            self._ops.append(("upsert_edge", e))
            bp = self._over_pending()
        if bp:
            self.flush_pending()

    def delete_edge(self, edge_id: EdgeID) -> None:
        with self._lock:
            self._edges[edge_id] = _TOMBSTONE
            self._ops.append(("delete_edge", edge_id))
            bp = self._over_pending()
        if bp:
            self.flush_pending()

    def get_edge(self, edge_id: EdgeID) -> Edge:
        with self._lock:
            ov = self._edges.get(edge_id)
        if ov is _TOMBSTONE:
            raise NotFoundError(f"edge {edge_id} not found")
        if isinstance(ov, Edge):
            return ov.copy()
        return self.inner.get_edge(edge_id)

    def _dead_node_ids(self) -> Set[NodeID]:
        """Node IDs tombstoned in the overlay (their inner edges must be
        masked from reads until the delete flushes)."""
        return {nid for nid, ov in self._nodes.items() if ov is _TOMBSTONE}

    def _drop_edges_of_dead_nodes(self, base: Dict[EdgeID, Edge]) -> None:
        with self._lock:
            dead = self._dead_node_ids()
        if not dead:
            return
        for eid in list(base):
            e = base[eid]
            if e.start_node in dead or e.end_node in dead:
                del base[eid]

    def get_edges_by_type(self, edge_type: str) -> List[Edge]:
        base = {e.id: e for e in self.inner.get_edges_by_type(edge_type)}
        self._drop_edges_of_dead_nodes(base)
        with self._lock:
            overlay = dict(self._edges)
        for eid, ov in overlay.items():
            if ov is _TOMBSTONE:
                base.pop(eid, None)
            elif isinstance(ov, Edge):
                if ov.type == edge_type:
                    base[eid] = ov
                else:
                    base.pop(eid, None)
        return [e.copy() for e in base.values()]

    def all_edges(self) -> Iterable[Edge]:
        base = {e.id: e for e in self.inner.all_edges()}
        self._drop_edges_of_dead_nodes(base)
        with self._lock:
            overlay = dict(self._edges)
        for eid, ov in overlay.items():
            if ov is _TOMBSTONE:
                base.pop(eid, None)
            elif isinstance(ov, Edge):
                base[eid] = ov
        return [e.copy() for e in base.values()]

    def get_node_edges(
        self, node_id: NodeID, direction: str = Direction.BOTH
    ) -> List[Edge]:
        base = {e.id: e for e in self.inner.get_node_edges(node_id, direction)}
        self._drop_edges_of_dead_nodes(base)
        with self._lock:
            overlay = dict(self._edges)
        for eid, ov in overlay.items():
            if ov is _TOMBSTONE:
                base.pop(eid, None)
            elif isinstance(ov, Edge):
                touches = (
                    direction in (Direction.OUTGOING, Direction.BOTH)
                    and ov.start_node == node_id
                ) or (
                    direction in (Direction.INCOMING, Direction.BOTH)
                    and ov.end_node == node_id
                )
                if touches:
                    base[eid] = ov
                else:
                    base.pop(eid, None)
        return [e.copy() for e in base.values()]

    def degree(self, node_id: NodeID, direction: str = Direction.BOTH) -> int:
        return len(self.get_node_edges(node_id, direction))

    # -- counts (overlay-aware) ------------------------------------------

    def count_nodes(self) -> int:
        with self._lock:
            overlay = dict(self._nodes)
        inner_count = self.inner.count_nodes()
        delta = 0
        for nid, ov in overlay.items():
            exists_inner = self._inner_has_node(nid)
            if ov is _TOMBSTONE and exists_inner:
                delta -= 1
            elif isinstance(ov, Node) and not exists_inner:
                delta += 1
        return inner_count + delta

    def count_edges(self) -> int:
        with self._lock:
            overlay = dict(self._edges)
            dead = self._dead_node_ids()
        if dead:
            # unflushed node deletes mask inner edges; count via merge
            return len(list(self.all_edges()))
        inner_count = self.inner.count_edges()
        delta = 0
        for eid, ov in overlay.items():
            exists_inner = self._inner_has_edge(eid)
            if ov is _TOMBSTONE and exists_inner:
                delta -= 1
            elif isinstance(ov, Edge) and not exists_inner:
                delta += 1
        return inner_count + delta

    def _inner_has_node(self, node_id: NodeID) -> bool:
        return self.inner.has_node(node_id)

    def _inner_has_edge(self, edge_id: EdgeID) -> bool:
        return self.inner.has_edge(edge_id)

    def delete_by_prefix(self, prefix: str) -> Tuple[int, int]:
        self.flush_pending()
        return self.inner.delete_by_prefix(prefix)
