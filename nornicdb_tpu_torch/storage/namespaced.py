"""Namespaced engine decorator (counterpart of
``nornicdb_tpu/storage/namespaced.py``).

Prefixes every node and edge id with ``dbname:`` on the way in and strips
it on the way out, so one store can host many logical databases. The DB
wraps its chain in ``NamespacedEngine(chain, "neo4j")``, as the reference
does, so ids on disk carry the ``neo4j:`` prefix and each package opens
the other's data dirs. ``multidb.py``'s ``DatabaseManager`` hosts more
databases on the same chain, one namespace each.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from nornicdb_tpu_torch.storage.types import (
    Direction,
    Edge,
    EdgeID,
    Engine,
    EngineDecorator,
    Node,
    NodeID,
    NotFoundError,
)

DEFAULT_DB = "neo4j"


class NamespacedEngine(EngineDecorator):
    def __init__(self, inner: Engine, database: str = DEFAULT_DB):
        super().__init__(inner)
        self.database = database
        self._prefix = database + ":"

    # -- id mapping -----------------------------------------------------

    def _q(self, raw_id: str) -> str:
        """Qualify a logical ID with the namespace prefix. Always prepends:
        a user ID that happens to start with "<db>:" must not alias onto a
        different node's physical key."""
        return self._prefix + raw_id

    def _unq(self, qual_id: str) -> str:
        if qual_id.startswith(self._prefix):
            return qual_id[len(self._prefix) :]
        return qual_id

    def _node_in(self, node: Node) -> Node:
        n = node.copy()
        n.id = self._q(n.id)
        return n

    def _node_out(self, node: Node) -> Node:
        node.id = self._unq(node.id)
        return node

    def _edge_in(self, edge: Edge) -> Edge:
        e = edge.copy()
        e.id = self._q(e.id)
        e.start_node = self._q(e.start_node)
        e.end_node = self._q(e.end_node)
        return e

    def _edge_out(self, edge: Edge) -> Edge:
        edge.id = self._unq(edge.id)
        edge.start_node = self._unq(edge.start_node)
        edge.end_node = self._unq(edge.end_node)
        return edge

    def _mine(self, qual_id: str) -> bool:
        return qual_id.startswith(self._prefix)

    # -- nodes ----------------------------------------------------------

    def create_node(self, node: Node) -> None:
        self.inner.create_node(self._node_in(node))

    def get_node(self, node_id: NodeID) -> Node:
        try:
            return self._node_out(self.inner.get_node(self._q(node_id)))
        except NotFoundError:
            raise NotFoundError(f"node {node_id} not found") from None

    def update_node(self, node: Node) -> None:
        self.inner.update_node(self._node_in(node))

    def delete_node(self, node_id: NodeID) -> None:
        try:
            self.inner.delete_node(self._q(node_id))
        except NotFoundError:
            raise NotFoundError(f"node {node_id} not found") from None

    def has_node(self, node_id: NodeID) -> bool:
        return self.inner.has_node(self._q(node_id))

    def has_edge(self, edge_id: EdgeID) -> bool:
        return self.inner.has_edge(self._q(edge_id))

    def get_nodes_by_label(self, label: str) -> List[Node]:
        return [
            self._node_out(n)
            for n in self.inner.get_nodes_by_label(label)
            if self._mine(n.id)
        ]

    def node_ids_by_label(self, label: str) -> List[NodeID]:
        p = self._prefix
        lp = len(p)
        return [i[lp:] for i in self.inner.node_ids_by_label(label)
                if i.startswith(p)]

    def all_nodes(self) -> Iterable[Node]:
        return [self._node_out(n) for n in self.inner.all_nodes() if self._mine(n.id)]

    def batch_get_nodes(self, node_ids: Sequence[NodeID]) -> List[Optional[Node]]:
        got = self.inner.batch_get_nodes([self._q(i) for i in node_ids])
        return [self._node_out(n) if n is not None else None for n in got]

    # -- edges ----------------------------------------------------------

    def create_edge(self, edge: Edge) -> None:
        self.inner.create_edge(self._edge_in(edge))

    def get_edge(self, edge_id: EdgeID) -> Edge:
        try:
            return self._edge_out(self.inner.get_edge(self._q(edge_id)))
        except NotFoundError:
            raise NotFoundError(f"edge {edge_id} not found") from None

    def update_edge(self, edge: Edge) -> None:
        self.inner.update_edge(self._edge_in(edge))

    def delete_edge(self, edge_id: EdgeID) -> None:
        try:
            self.inner.delete_edge(self._q(edge_id))
        except NotFoundError:
            raise NotFoundError(f"edge {edge_id} not found") from None

    def get_edges_by_type(self, edge_type: str) -> List[Edge]:
        return [
            self._edge_out(e)
            for e in self.inner.get_edges_by_type(edge_type)
            if self._mine(e.id)
        ]

    def all_edges(self) -> Iterable[Edge]:
        return [self._edge_out(e) for e in self.inner.all_edges() if self._mine(e.id)]

    def get_node_edges(
        self, node_id: NodeID, direction: str = Direction.BOTH
    ) -> List[Edge]:
        return [
            self._edge_out(e)
            for e in self.inner.get_node_edges(self._q(node_id), direction)
        ]

    def degree(self, node_id: NodeID, direction: str = Direction.BOTH) -> int:
        return self.inner.degree(self._q(node_id), direction)

    # -- counts scoped to this namespace --------------------------------

    def count_nodes(self) -> int:
        counter = getattr(self.inner, "count_nodes_with_prefix", None)
        if counter is not None:
            return counter(self._prefix)
        return sum(1 for n in self.inner.all_nodes() if self._mine(n.id))

    def count_edges(self) -> int:
        counter = getattr(self.inner, "count_edges_with_prefix", None)
        if counter is not None:
            return counter(self._prefix)
        return sum(1 for e in self.inner.all_edges() if self._mine(e.id))

    # -- optional APIs of the engines ---------------------------------
    #
    # These would otherwise fall through EngineDecorator.__getattr__
    # unqualified, seeing every database; each is re-scoped here.

    def count_nodes_by_label(self, label: str) -> int:
        # the inner count spans all namespaces
        return len(self.node_ids_by_label(label))

    def count_nodes_with_prefix(self, prefix: str) -> int:
        return self.inner.count_nodes_with_prefix(self._prefix + prefix)

    def count_edges_with_prefix(self, prefix: str) -> int:
        return self.inner.count_edges_with_prefix(self._prefix + prefix)

    def delete_by_prefix(self, prefix: str) -> Tuple[int, int]:
        return self.inner.delete_by_prefix(self._prefix + prefix)

    def clear(self) -> None:
        # this database only, not the store under it
        self.inner.delete_by_prefix(self._prefix)
