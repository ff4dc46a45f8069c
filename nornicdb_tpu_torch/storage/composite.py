"""CompositeEngine: route reads across multiple engines (counterpart of
``nornicdb_tpu/storage/composite.py``).

Reference: pkg/storage composite_engine.go:48 (NewCompositeEngine) +
composite_routing.go — one logical view over several engines (multi-DB
composite reads). Writes go to the designated primary; reads fan out
and merge. ID-based lookups probe the primary first, then secondaries.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from nornicdb_tpu_torch.storage.types import Direction, Edge, Engine, Node, NotFoundError


class CompositeEngine(Engine):
    def __init__(self, primary: Engine, secondaries: Sequence[Engine] = ()):
        self.primary = primary
        self.secondaries = list(secondaries)

    @property
    def engines(self) -> List[Engine]:
        return [self.primary, *self.secondaries]

    # -- writes: primary only --------------------------------------------

    def create_node(self, node: Node) -> None:
        self.primary.create_node(node)

    def update_node(self, node: Node) -> None:
        self.primary.update_node(node)

    def delete_node(self, node_id: str) -> None:
        self.primary.delete_node(node_id)

    def create_edge(self, edge: Edge) -> None:
        self.primary.create_edge(edge)

    def update_edge(self, edge: Edge) -> None:
        self.primary.update_edge(edge)

    def delete_edge(self, edge_id: str) -> None:
        self.primary.delete_edge(edge_id)

    def delete_by_prefix(self, prefix: str) -> Tuple[int, int]:
        return self.primary.delete_by_prefix(prefix)

    # -- reads: fan out, primary wins ties -------------------------------

    def _first(self, fn_name: str, *args):
        last_exc: Optional[Exception] = None
        for eng in self.engines:
            try:
                return getattr(eng, fn_name)(*args)
            except (KeyError, NotFoundError) as e:
                last_exc = e
        raise last_exc if last_exc is not None else KeyError(args)

    def get_node(self, node_id: str) -> Node:
        return self._first("get_node", node_id)

    def get_edge(self, edge_id: str) -> Edge:
        return self._first("get_edge", edge_id)

    def has_node(self, node_id: str) -> bool:
        return any(e.has_node(node_id) for e in self.engines)

    def has_edge(self, edge_id: str) -> bool:
        return any(e.has_edge(edge_id) for e in self.engines)

    def _merged_nodes(self, lists: Iterable[List[Node]]) -> List[Node]:
        seen = {}
        for lst in lists:  # primary first: its version wins duplicates
            for n in lst:
                if n.id not in seen:
                    seen[n.id] = n
        return list(seen.values())

    def get_nodes_by_label(self, label: str) -> List[Node]:
        return self._merged_nodes(
            e.get_nodes_by_label(label) for e in self.engines)

    def all_nodes(self) -> Iterable[Node]:
        return self._merged_nodes(
            list(e.all_nodes()) for e in self.engines)

    def batch_get_nodes(self, node_ids: Sequence[str]) -> List[Optional[Node]]:
        out: List[Optional[Node]] = [None] * len(node_ids)
        remaining = dict(enumerate(node_ids))
        for eng in self.engines:
            if not remaining:
                break
            got = eng.batch_get_nodes(list(remaining.values()))
            for (pos, _), node in zip(list(remaining.items()), got):
                if node is not None:
                    out[pos] = node
                    del remaining[pos]
        return out

    def get_edges_by_type(self, edge_type: str) -> List[Edge]:
        seen = {}
        for eng in self.engines:
            for e in eng.get_edges_by_type(edge_type):
                seen.setdefault(e.id, e)
        return list(seen.values())

    def all_edges(self) -> Iterable[Edge]:
        seen = {}
        for eng in self.engines:
            for e in eng.all_edges():
                seen.setdefault(e.id, e)
        return list(seen.values())

    def get_node_edges(
        self, node_id: str, direction: str = Direction.BOTH
    ) -> List[Edge]:
        seen = {}
        for eng in self.engines:
            try:
                for e in eng.get_node_edges(node_id, direction):
                    seen.setdefault(e.id, e)
            except (KeyError, NotFoundError):
                continue
        return list(seen.values())

    def degree(self, node_id: str, direction: str = Direction.BOTH) -> int:
        return len(self.get_node_edges(node_id, direction))

    def neighbors(
        self, node_id: str, direction: str = Direction.BOTH
    ) -> List[Node]:
        out = {}
        for e in self.get_node_edges(node_id, direction):
            other = e.end_node if e.start_node == node_id else e.start_node
            if other not in out:
                try:
                    out[other] = self.get_node(other)
                except (KeyError, NotFoundError):
                    pass
        return list(out.values())

    def count_nodes(self) -> int:
        return len(self._merged_nodes(
            list(e.all_nodes()) for e in self.engines))

    def count_edges(self) -> int:
        seen = set()
        for eng in self.engines:
            for e in eng.all_edges():
                seen.add(e.id)
        return len(seen)

    def list_namespaces(self) -> List[str]:
        out = set()
        for eng in self.engines:
            try:
                out.update(eng.list_namespaces())
            except Exception:
                continue
        return sorted(out)

    def flush(self) -> None:
        for eng in self.engines:
            eng.flush()

    def close(self) -> None:
        for eng in self.engines:
            eng.close()
