"""Topology-based link prediction over an adjacency snapshot (counterpart
of ``nornicdb_tpu/linkpredict.py``).

Reference: pkg/linkpredict — topology.go:95-624 (CommonNeighbors, Jaccard,
AdamicAdar, PreferentialAttachment, ResourceAllocation),
graph_builder.go:144, hybrid.go (topology + embedding blend).
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

from nornicdb_tpu_torch.storage.types import Engine


class AdjacencySnapshot:
    """Undirected neighbor sets captured once per prediction run
    (reference: graph_builder.go)."""

    def __init__(self, storage: Engine):
        self.neighbors: Dict[str, Set[str]] = {}
        for e in storage.all_edges():
            self.neighbors.setdefault(e.start_node, set()).add(e.end_node)
            self.neighbors.setdefault(e.end_node, set()).add(e.start_node)

    def of(self, node_id: str) -> Set[str]:
        return self.neighbors.get(node_id, set())

    def degree(self, node_id: str) -> int:
        return len(self.of(node_id))


# snapshot cache keyed on the columnar catalog: rebuilding
# the neighbor sets from storage.all_edges() on EVERY predict_links
# call is O(E) per prediction; with a catalog in hand the snapshot
# stays live until the catalog version moves. WeakKey so a dropped
# catalog never pins its snapshot.
_SNAP_LOCK = threading.Lock()
_SNAP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def adjacency_snapshot(storage: Engine,
                       catalog=None) -> AdjacencySnapshot:
    """The run's adjacency snapshot. With ``catalog`` (a
    ``query.columnar.ColumnarCatalog``), cached per catalog version —
    repeat predictions between writes reuse ONE build, and the device
    background plane's host-parity re-scoring shares the same object
    (bitwise-identical set iteration, background/device_plane.py).
    Without a catalog the legacy build-per-call behavior stands."""
    if catalog is None:
        return AdjacencySnapshot(storage)
    v = catalog.version
    with _SNAP_LOCK:
        hit = _SNAP_CACHE.get(catalog)
    if hit is not None and hit[0] == v:
        return hit[1]
    snap = AdjacencySnapshot(storage)
    with _SNAP_LOCK:
        if catalog.version == v:
            _SNAP_CACHE[catalog] = (v, snap)
    return snap


def common_neighbors(snap: AdjacencySnapshot, a: str, b: str) -> float:
    return float(len(snap.of(a) & snap.of(b)))


def jaccard(snap: AdjacencySnapshot, a: str, b: str) -> float:
    na, nb = snap.of(a), snap.of(b)
    union = na | nb
    if not union:
        return 0.0
    return len(na & nb) / len(union)


def adamic_adar(snap: AdjacencySnapshot, a: str, b: str) -> float:
    total = 0.0
    for z in snap.of(a) & snap.of(b):
        d = snap.degree(z)
        if d > 1:
            total += 1.0 / math.log(d)
    return total


def preferential_attachment(snap: AdjacencySnapshot, a: str, b: str) -> float:
    return float(snap.degree(a) * snap.degree(b))


def resource_allocation(snap: AdjacencySnapshot, a: str, b: str) -> float:
    total = 0.0
    for z in snap.of(a) & snap.of(b):
        d = snap.degree(z)
        if d > 0:
            total += 1.0 / d
    return total


SCORERS = {
    "common_neighbors": common_neighbors,
    "jaccard": jaccard,
    "adamic_adar": adamic_adar,
    "preferential_attachment": preferential_attachment,
    "resource_allocation": resource_allocation,
}


def predict_links(
    storage: Engine,
    node_id: str,
    method: str = "adamic_adar",
    limit: int = 10,
    candidates: Optional[Sequence[str]] = None,
    catalog=None,
) -> List[Tuple[str, float]]:
    """Rank non-neighbor candidate nodes by topological affinity.
    ``catalog`` enables the per-version snapshot cache (the host path
    gets faster between writes even with the device plane off)."""
    snap = adjacency_snapshot(storage, catalog)
    scorer = SCORERS.get(method)
    if scorer is None:
        raise ValueError(f"unknown link prediction method {method!r}")
    existing = snap.of(node_id) | {node_id}
    if candidates is None:
        # 2-hop neighborhood is the sensible default candidate pool
        pool: Set[str] = set()
        for n in snap.of(node_id):
            pool |= snap.of(n)
        pool -= existing
    else:
        pool = set(candidates) - existing
    scored = [(c, scorer(snap, node_id, c)) for c in pool]
    scored = [(c, s) for c, s in scored if s > 0]
    scored.sort(key=lambda kv: (-kv[1], kv[0]))
    return scored[:limit]


def hybrid_predict(
    storage: Engine,
    search_service,
    node_id: str,
    topology_weight: float = 0.5,
    limit: int = 10,
) -> List[Tuple[str, float, float, float]]:
    """Blend topology score with embedding similarity
    (reference: hybrid.go). Returns (node_id, blended_score,
    topology_score, semantic_score) so callers can decompose the blend:
    blended == w*topology + (1-w)*semantic exactly."""
    topo = dict(predict_links(storage, node_id, limit=limit * 3))
    emb: Dict[str, float] = {}
    try:
        node = storage.get_node(node_id)
    except KeyError:
        return []
    if node.embedding is not None and search_service is not None:
        for nid, score in search_service.vector_search_candidates(
            node.embedding, k=limit * 3
        ):
            if nid != node_id:
                emb[nid] = max(score, 0.0)
    # normalize topology scores to [0, 1]
    tmax = max(topo.values(), default=1.0) or 1.0
    out: Dict[str, Tuple[float, float, float]] = {}
    for nid in set(topo) | set(emb):
        t = topo.get(nid, 0.0) / tmax
        s = emb.get(nid, 0.0)
        out[nid] = (topology_weight * t + (1.0 - topology_weight) * s, t, s)
    ranked = sorted(out.items(), key=lambda kv: (-kv[1][0], kv[0]))
    return [(nid, sc, t, s) for nid, (sc, t, s) in ranked[:limit]]
