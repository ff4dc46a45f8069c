"""APOC graph-level long tail: node, rel, label, nodes, neighbors,
spatial, meta, search (counterpart of
``nornicdb_tpu/query/apoc_graph.py``).

Reference: apoc/node, apoc/rel, apoc/label, apoc/nodes, apoc/neighbors,
apoc/spatial, apoc/meta, apoc/search (apoc.go:222 registerAllFunctions).
Pure entity accessors register in the plain APOC table; anything that
reads the graph registers in the ctx table (``register_ctx``) and
receives the executor query context so it can reach ``ctx.storage``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Set

from nornicdb_tpu_torch.errors import CypherRuntimeError
from nornicdb_tpu_torch.query.apoc import register, register_ctx
from nornicdb_tpu_torch.storage.types import Direction, Edge, Node


def _node(x, what: str) -> Node:
    if not isinstance(x, Node):
        raise CypherRuntimeError(f"{what} expects a node, got "
                                 f"{type(x).__name__}")
    return x


def _rel(x, what: str) -> Edge:
    if not isinstance(x, Edge):
        raise CypherRuntimeError(f"{what} expects a relationship, got "
                                 f"{type(x).__name__}")
    return x


def _rel_matches(e: Edge, spec: Optional[str]) -> bool:
    """APOC relationship spec: 'TYPE', 'TYPE>', '<TYPE', 'A|B', '' = any."""
    if not spec:
        return True
    for part in str(spec).split("|"):
        part = part.strip()
        if part.endswith(">"):
            part = part[:-1]
        if part.startswith("<"):
            part = part[1:]
        if not part or part == e.type:
            return True
    return False


def _spec_direction(spec: Optional[str]) -> str:
    s = str(spec or "")
    if s.endswith(">"):
        return Direction.OUTGOING
    if s.startswith("<"):
        return Direction.INCOMING
    return Direction.BOTH


def _node_rels(ctx, node: Node, spec: Optional[str] = None) -> List[Edge]:
    direction = _spec_direction(spec)
    out = []
    for e in ctx.storage.get_node_edges(node.id, direction=direction):
        if _rel_matches(e, spec):
            out.append(e)
    return out


def _get_node(ctx, node_id: str) -> Optional[Node]:
    from nornicdb_tpu_torch.storage.types import NotFoundError
    try:
        return ctx.storage.get_node(node_id)
    except NotFoundError:
        return None


def _install_node_rel() -> None:
    n = "apoc.node."
    register(n + "id", lambda x: _node(x, "apoc.node.id").id)
    register(n + "toMap", lambda x: {
        "id": _node(x, "apoc.node.toMap").id,
        "labels": list(x.labels), "properties": dict(x.properties)})
    register(n + "properties",
             lambda x: dict(_node(x, "apoc.node.properties").properties))
    register(n + "property", lambda x, key: _node(
        x, "apoc.node.property").properties.get(key))
    register(n + "hasLabel",
             lambda x, lb: lb in _node(x, "apoc.node.hasLabel").labels)
    register(n + "hasLabels", lambda x, lbs: all(
        lb in _node(x, "apoc.node.hasLabels").labels for lb in (lbs or [])))
    register(n + "equals", lambda a, b: (
        isinstance(a, Node) and isinstance(b, Node) and a.id == b.id))
    register(n + "diff", lambda a, b: _props_diff(
        _node(a, "apoc.node.diff").properties,
        _node(b, "apoc.node.diff").properties))

    register_ctx(n + "degree", lambda ctx, x, spec=None: len(
        _node_rels(ctx, _node(x, "apoc.node.degree"), spec)))
    register_ctx(n + "degreeIn", lambda ctx, x, etype=None: sum(
        1 for e in ctx.storage.get_node_edges(
            _node(x, "apoc.node.degreeIn").id, direction=Direction.INCOMING)
        if etype is None or e.type == etype))
    register_ctx(n + "degreeOut", lambda ctx, x, etype=None: sum(
        1 for e in ctx.storage.get_node_edges(
            _node(x, "apoc.node.degreeOut").id, direction=Direction.OUTGOING)
        if etype is None or e.type == etype))
    register_ctx(n + "isDense", lambda ctx, x, threshold=50: len(
        ctx.storage.get_node_edges(_node(x, "apoc.node.isDense").id))
        >= int(threshold))
    register_ctx(n + "relationships", lambda ctx, x, spec=None: _node_rels(
        ctx, _node(x, "apoc.node.relationships"), spec))
    register_ctx(n + "relationshipsIn", lambda ctx, x, etype=None: [
        e for e in ctx.storage.get_node_edges(
            _node(x, "apoc.node.relationshipsIn").id,
            direction=Direction.INCOMING)
        if etype is None or e.type == etype])
    register_ctx(n + "relationshipsOut", lambda ctx, x, etype=None: [
        e for e in ctx.storage.get_node_edges(
            _node(x, "apoc.node.relationshipsOut").id,
            direction=Direction.OUTGOING)
        if etype is None or e.type == etype])
    register_ctx(n + "relationshipExists", lambda ctx, x, spec=None: any(
        True for _ in _node_rels(
            ctx, _node(x, "apoc.node.relationshipExists"), spec)))
    register_ctx(n + "relationshipTypes", lambda ctx, x, spec=None: sorted(
        {e.type for e in _node_rels(
            ctx, _node(x, "apoc.node.relationshipTypes"), spec)}))
    register_ctx(n + "relationshipTypesIn", lambda ctx, x: sorted(
        {e.type for e in ctx.storage.get_node_edges(
            _node(x, "apoc.node.relationshipTypesIn").id,
            direction=Direction.INCOMING)}))
    register_ctx(n + "relationshipTypesOut", lambda ctx, x: sorted(
        {e.type for e in ctx.storage.get_node_edges(
            _node(x, "apoc.node.relationshipTypesOut").id,
            direction=Direction.OUTGOING)}))

    def _connected(ctx, a, b, spec=None):
        a = _node(a, "apoc.node.connected")
        b = _node(b, "apoc.node.connected")
        return any(e.start_node == b.id or e.end_node == b.id
                   for e in _node_rels(ctx, a, spec))

    register_ctx(n + "connected", _connected)
    register_ctx(n + "neighbors", lambda ctx, x, spec=None: _neighbor_nodes(
        ctx, _node(x, "apoc.node.neighbors"), spec))
    def _neighbors_one_way(ctx, x, direction):
        node = _node(x, "apoc.node.neighbors")
        seen: Set[str] = set()
        out = []
        for e in ctx.storage.get_node_edges(node.id, direction=direction):
            other_id = (e.start_node if direction == Direction.INCOMING
                        else e.end_node)
            if other_id in seen:
                continue
            seen.add(other_id)
            other = _get_node(ctx, other_id)
            if other is not None:
                out.append(other)
        return out

    register_ctx(n + "neighborsIn", lambda ctx, x: _neighbors_one_way(
        ctx, x, Direction.INCOMING))
    register_ctx(n + "neighborsOut", lambda ctx, x: _neighbors_one_way(
        ctx, x, Direction.OUTGOING))

    r = "apoc.rel."
    register(r + "id", lambda x: _rel(x, "apoc.rel.id").id)
    register(r + "properties",
             lambda x: dict(_rel(x, "apoc.rel.properties").properties))
    register(r + "property", lambda x, key: _rel(
        x, "apoc.rel.property").properties.get(key))
    register(r + "hasProperty", lambda x, key: key in _rel(
        x, "apoc.rel.hasProperty").properties)
    register(r + "hasProperties", lambda x, keys: all(
        k in _rel(x, "apoc.rel.hasProperties").properties
        for k in (keys or [])))
    register(r + "isType", lambda x, t: _rel(
        x, "apoc.rel.isType").type == t)
    register(r + "isAnyType", lambda x, types: _rel(
        x, "apoc.rel.isAnyType").type in (types or []))
    register(r + "isLoop", lambda x: (
        _rel(x, "apoc.rel.isLoop").start_node == x.end_node))
    register(r + "equals", lambda a, b: (
        isinstance(a, Edge) and isinstance(b, Edge) and a.id == b.id))
    register(r + "compare", lambda a, b: _props_diff(
        _rel(a, "apoc.rel.compare").properties,
        _rel(b, "apoc.rel.compare").properties))
    register(r + "toMap", lambda x: {
        "id": _rel(x, "apoc.rel.toMap").id, "type": x.type,
        "start": x.start_node, "end": x.end_node,
        "properties": dict(x.properties)})
    register(r + "weight", lambda x, prop="weight", default=1.0: (
        v if isinstance(v := _rel(x, "apoc.rel.weight").properties.get(
            prop, default), (int, float)) else default))
    register(r + "isBetween", lambda x, a, b: (
        {_rel(x, "apoc.rel.isBetween").start_node, x.end_node}
        == {_node(a, "apoc.rel.isBetween").id,
            _node(b, "apoc.rel.isBetween").id}))
    register(r + "isDirectedBetween", lambda x, a, b: (
        _rel(x, "apoc.rel.isDirectedBetween").start_node
        == _node(a, "apoc.rel.isDirectedBetween").id
        and x.end_node == _node(b, "apoc.rel.isDirectedBetween").id))
    register(r + "direction", lambda x, from_node: (
        "OUTGOING" if _rel(x, "apoc.rel.direction").start_node
        == _node(from_node, "apoc.rel.direction").id else "INCOMING"))
    register(r + "reverse", lambda x: {
        "id": _rel(x, "apoc.rel.reverse").id, "type": x.type,
        "start": x.end_node, "end": x.start_node,
        "properties": dict(x.properties)})

    register_ctx(r + "startNode", lambda ctx, x: _get_node(
        ctx, _rel(x, "apoc.rel.startNode").start_node))
    register_ctx(r + "endNode", lambda ctx, x: _get_node(
        ctx, _rel(x, "apoc.rel.endNode").end_node))
    register_ctx(r + "nodes", lambda ctx, x: [
        _get_node(ctx, _rel(x, "apoc.rel.nodes").start_node),
        _get_node(ctx, x.end_node)])
    register_ctx(r + "otherNode", lambda ctx, x, node: _get_node(
        ctx, _rel(x, "apoc.rel.otherNode").end_node
        if x.start_node == _node(node, "apoc.rel.otherNode").id
        else x.start_node))
    register_ctx(r + "exists", lambda ctx, x: (
        isinstance(x, Edge) and ctx.storage.has_edge(x.id)))


def _neighbor_nodes(ctx, node: Node, spec=None) -> List[Node]:
    seen: Set[str] = set()
    out: List[Node] = []
    for e in _node_rels(ctx, node, spec):
        other_id = e.end_node if e.start_node == node.id else e.start_node
        if other_id in seen:
            continue
        seen.add(other_id)
        other = _get_node(ctx, other_id)
        if other is not None:
            out.append(other)
    return out


def _props_diff(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "leftOnly": {k: v for k, v in a.items() if k not in b},
        "rightOnly": {k: v for k, v in b.items() if k not in a},
        "different": {k: {"left": a[k], "right": b[k]}
                      for k in a.keys() & b.keys() if a[k] != b[k]},
        "inCommon": {k: a[k] for k in a.keys() & b.keys() if a[k] == b[k]},
    }


def _install_label() -> None:
    lb = "apoc.label."
    register(lb + "get", lambda x: list(_node(x, "apoc.label.get").labels))
    register(lb + "has", lambda x, l: l in _node(
        x, "apoc.label.has").labels)
    register(lb + "hasAll", lambda x, ls: all(
        l in _node(x, "apoc.label.hasAll").labels for l in (ls or [])))
    register(lb + "hasAny", lambda x, ls: any(
        l in _node(x, "apoc.label.hasAny").labels for l in (ls or [])))
    register(lb + "compare", lambda a, b: sorted(
        _node(a, "apoc.label.compare").labels)
        == sorted(_node(b, "apoc.label.compare").labels))
    register(lb + "diff", lambda a, b: sorted(
        set(_node(a, "apoc.label.diff").labels)
        - set(_node(b, "apoc.label.diff").labels)))
    register(lb + "intersection", lambda a, b: sorted(
        set(_node(a, "apoc.label.intersection").labels)
        & set(_node(b, "apoc.label.intersection").labels)))
    register(lb + "union", lambda a, b: sorted(
        set(_node(a, "apoc.label.union").labels)
        | set(_node(b, "apoc.label.union").labels)))
    register(lb + "format", lambda x: "".join(
        f":{l}" for l in _node(x, "apoc.label.format").labels))
    register(lb + "toString", lambda x: ":".join(
        _node(x, "apoc.label.toString").labels))
    register(lb + "fromString", lambda s: [
        p for p in str(s or "").split(":") if p])
    register(lb + "fromPattern", lambda s: re.findall(
        r":\s*([A-Za-z_][A-Za-z0-9_]*)", str(s or "")))
    register(lb + "pattern", lambda labels: "".join(
        f":{l}" for l in (labels or [])))
    register(lb + "normalize", lambda s: "".join(
        w.capitalize() for w in re.split(r"[\s_\-]+", str(s or ""))))
    register(lb + "validate", lambda s: bool(re.fullmatch(
        r"[A-Za-z_][A-Za-z0-9_]*", str(s or ""))))

    # NOTE: apoc.label.exists(node, label) already exists in the plain
    # table (apoc.py) — do not shadow it with a ctx variant; the
    # label-presence-in-graph check is apoc.label.count(l) > 0
    register_ctx(lb + "count", lambda ctx, l: len(
        ctx.storage.get_nodes_by_label(l)))
    register_ctx(lb + "nodes", lambda ctx, l: list(
        ctx.storage.get_nodes_by_label(l)))
    register_ctx(lb + "list", lambda ctx: sorted(
        {l for node in ctx.storage.all_nodes() for l in node.labels}))
    register_ctx(lb + "stats", lambda ctx: {
        l: len(ctx.storage.get_nodes_by_label(l))
        for l in sorted({l for node in ctx.storage.all_nodes()
                         for l in node.labels})})
    register_ctx(lb + "search", lambda ctx, pattern: [
        l for l in sorted({l for node in ctx.storage.all_nodes()
                           for l in node.labels})
        if re.search(str(pattern), l)])


def _install_nodes() -> None:
    ns = "apoc.nodes."
    register(ns + "toMap", lambda lst: [
        {"id": x.id, "labels": list(x.labels),
         "properties": dict(x.properties)}
        for x in (lst or []) if isinstance(x, Node)])
    register(ns + "map", lambda lst, key: [
        _node(x, "apoc.nodes.map").properties.get(key)
        for x in (lst or [])])
    register(ns + "filter", lambda lst, key, value: [
        x for x in (lst or [])
        if isinstance(x, Node) and x.properties.get(key) == value])
    register(ns + "sort", lambda lst, key: sorted(
        [x for x in (lst or []) if isinstance(x, Node)],
        key=lambda x: (x.properties.get(key) is None,
                       x.properties.get(key))))
    register(ns + "distinct", lambda lst: list(
        {x.id: x for x in (lst or []) if isinstance(x, Node)}.values()))
    register(ns + "union", lambda a, b: list({
        x.id: x for x in list(a or []) + list(b or [])
        if isinstance(x, Node)}.values()))
    register(ns + "intersect", lambda a, b: [
        x for x in (a or []) if isinstance(x, Node)
        and x.id in {y.id for y in (b or []) if isinstance(y, Node)}])
    register(ns + "difference", lambda a, b: [
        x for x in (a or []) if isinstance(x, Node)
        and x.id not in {y.id for y in (b or []) if isinstance(y, Node)}])
    register(ns + "partition", lambda lst, size: [
        list((lst or [])[i:i + int(size)])
        for i in range(0, len(lst or []), max(int(size), 1))])
    register(ns + "group", lambda lst, key: _group_nodes(lst, key))
    register(ns + "reduce", lambda lst, key: sum(
        v for x in (lst or []) if isinstance(x, Node)
        and isinstance(v := x.properties.get(key), (int, float))
        and not isinstance(v, bool)))

    def _group_nodes(lst, key):
        out: Dict[Any, List[Node]] = {}
        for x in lst or []:
            if isinstance(x, Node):
                out.setdefault(x.properties.get(key), []).append(x)
        return [{"value": k, "nodes": v} for k, v in out.items()]

    register_ctx(ns + "get", lambda ctx, ids: [
        node for i in (ids or [])
        if (node := _get_node(ctx, str(i))) is not None])
    register_ctx(ns + "isDense", lambda ctx, lst, threshold=50: [
        {"node": x, "dense": len(ctx.storage.get_node_edges(x.id))
         >= int(threshold)}
        for x in (lst or []) if isinstance(x, Node)])
    register_ctx(ns + "connected", lambda ctx, a, b: _nodes_connected(
        ctx, a, b))
    register_ctx(ns + "relationships", lambda ctx, lst: _rels_between(
        ctx, lst))
    register_ctx(ns + "distinctRels", lambda ctx, lst: sorted(
        {e.type for e in _rels_between(ctx, lst)}))
    register_ctx(ns + "cycles", lambda ctx, lst, spec=None: _find_cycles(
        ctx, lst, spec))


def _nodes_connected(ctx, a, b) -> bool:
    a = _node(a, "apoc.nodes.connected")
    b = _node(b, "apoc.nodes.connected")
    return any(e.start_node == b.id or e.end_node == b.id
               for e in ctx.storage.get_node_edges(a.id))


def _rels_between(ctx, lst) -> List[Edge]:
    ids = {x.id for x in (lst or []) if isinstance(x, Node)}
    seen: Set[str] = set()
    out: List[Edge] = []
    for nid in ids:
        for e in ctx.storage.get_node_edges(nid):
            if e.id in seen:
                continue
            if e.start_node in ids and e.end_node in ids:
                seen.add(e.id)
                out.append(e)
    return out


def _find_cycles(ctx, lst, spec=None) -> List[List[str]]:
    """Simple directed cycles within the given node set (bounded DFS)."""
    ids = {x.id for x in (lst or []) if isinstance(x, Node)}
    cycles: List[List[str]] = []
    for start in sorted(ids):
        stack = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            if len(path) > 10:
                continue
            for e in ctx.storage.get_node_edges(
                    cur, direction=Direction.OUTGOING):
                if not _rel_matches(e, spec) or e.end_node not in ids:
                    continue
                if e.end_node == start and len(path) > 1:
                    if min(path) == start:  # canonical start: dedupe
                        cycles.append(path + [start])
                elif e.end_node not in path:
                    stack.append((e.end_node, path + [e.end_node]))
    return cycles


def _install_neighbors() -> None:
    nb = "apoc.neighbors."

    def _hop_sets(ctx, node, spec, max_hops) -> List[Set[str]]:
        """Frontier node-id set per hop, 1..max_hops."""
        node = _node(node, "apoc.neighbors")
        visited = {node.id}
        frontier = {node.id}
        levels: List[Set[str]] = []
        for _ in range(int(max_hops)):
            nxt: Set[str] = set()
            for nid in frontier:
                for e in ctx.storage.get_node_edges(
                        nid, direction=_spec_direction(spec)):
                    if not _rel_matches(e, spec):
                        continue
                    other = e.end_node if e.start_node == nid else e.start_node
                    if other not in visited:
                        nxt.add(other)
            visited |= nxt
            levels.append(nxt)
            frontier = nxt
            if not nxt:
                break
        return levels

    def _ids_to_nodes(ctx, ids) -> List[Node]:
        return [node for i in sorted(ids)
                if (node := _get_node(ctx, i)) is not None]

    def _at_hop(ctx, x, spec=None, hop=1):
        levels = _hop_sets(ctx, x, spec, hop)
        if len(levels) < int(hop):
            return []
        return _ids_to_nodes(ctx, levels[int(hop) - 1])

    register_ctx(nb + "atHop", _at_hop)
    def _to_hop(ctx, x, spec=None, hop=1):
        levels = _hop_sets(ctx, x, spec, hop)
        return _ids_to_nodes(ctx, set().union(set(), *levels))

    register_ctx(nb + "toHop", _to_hop)
    register_ctx(nb + "count", lambda ctx, x, spec=None, hop=1: sum(
        len(s) for s in _hop_sets(ctx, x, spec, hop)))
    register_ctx(nb + "exists", lambda ctx, x, spec=None, hop=1: any(
        s for s in _hop_sets(ctx, x, spec, hop)))
    register_ctx(nb + "bfs", lambda ctx, x, spec=None, hop=3: _to_hop(
        ctx, x, spec, hop))

    def _dfs(ctx, x, spec=None, max_depth=3):
        node = _node(x, "apoc.neighbors.dfs")
        visited: List[str] = []
        seen = {node.id}
        stack = [(node.id, 0)]
        while stack:
            cur, depth = stack.pop()
            if depth >= int(max_depth):
                continue
            for e in reversed(ctx.storage.get_node_edges(
                    cur, direction=_spec_direction(spec))):
                if not _rel_matches(e, spec):
                    continue
                other = e.end_node if e.start_node == cur else e.start_node
                if other not in seen:
                    seen.add(other)
                    visited.append(other)
                    stack.append((other, depth + 1))
        return [n for i in visited
                if (n := _get_node(ctx, i)) is not None]

    register_ctx(nb + "dfs", _dfs)


_EARTH_R = 6_371_000.0  # meters


def _install_spatial() -> None:
    from nornicdb_tpu_torch.query import temporal_types as T

    sp = "apoc.spatial."

    def _latlon(p) -> tuple:
        if isinstance(p, T.CypherPoint):
            if p.latitude is None:
                return (p.y, p.x)
            return (p.latitude, p.longitude)
        if isinstance(p, dict):
            low = {k.lower(): v for k, v in p.items()}
            if "latitude" in low:
                return (float(low["latitude"]), float(low["longitude"]))
            if "lat" in low:
                return (float(low["lat"]),
                        float(low.get("lon", low.get("lng", 0.0))))
            if "y" in low:
                return (float(low["y"]), float(low["x"]))
        raise CypherRuntimeError("expected a point or lat/lon map")

    def _haversine(a, b):
        la1, lo1 = _latlon(a)
        la2, lo2 = _latlon(b)
        p1, p2 = math.radians(la1), math.radians(la2)
        dp = math.radians(la2 - la1)
        dl = math.radians(lo2 - lo1)
        h = (math.sin(dp / 2) ** 2
             + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2)
        return 2 * _EARTH_R * math.asin(math.sqrt(h))

    register(sp + "haversineDistance", _haversine)
    register(sp + "distance", _haversine)

    def _vincenty(a, b):
        """Vincenty inverse on the WGS-84 ellipsoid."""
        la1, lo1 = _latlon(a)
        la2, lo2 = _latlon(b)
        a_ax, f = 6378137.0, 1 / 298.257223563
        b_ax = (1 - f) * a_ax
        u1 = math.atan((1 - f) * math.tan(math.radians(la1)))
        u2 = math.atan((1 - f) * math.tan(math.radians(la2)))
        ll = math.radians(lo2 - lo1)
        lam = ll
        for _ in range(100):
            sin_s = math.sqrt(
                (math.cos(u2) * math.sin(lam)) ** 2
                + (math.cos(u1) * math.sin(u2)
                   - math.sin(u1) * math.cos(u2) * math.cos(lam)) ** 2)
            if sin_s == 0:
                return 0.0
            cos_s = (math.sin(u1) * math.sin(u2)
                     + math.cos(u1) * math.cos(u2) * math.cos(lam))
            sig = math.atan2(sin_s, cos_s)
            sin_a = math.cos(u1) * math.cos(u2) * math.sin(lam) / sin_s
            cos2a = 1 - sin_a ** 2
            cos2sm = (cos_s - 2 * math.sin(u1) * math.sin(u2) / cos2a
                      if cos2a else 0.0)
            c = f / 16 * cos2a * (4 + f * (4 - 3 * cos2a))
            lam_prev = lam
            lam = (ll + (1 - c) * f * sin_a
                   * (sig + c * sin_s
                      * (cos2sm + c * cos_s * (-1 + 2 * cos2sm ** 2))))
            if abs(lam - lam_prev) < 1e-12:
                break
        usq = cos2a * (a_ax ** 2 - b_ax ** 2) / b_ax ** 2
        big_a = 1 + usq / 16384 * (4096 + usq * (-768 + usq * (320 - 175 * usq)))
        big_b = usq / 1024 * (256 + usq * (-128 + usq * (74 - 47 * usq)))
        dsig = (big_b * sin_s
                * (cos2sm + big_b / 4
                   * (cos_s * (-1 + 2 * cos2sm ** 2)
                      - big_b / 6 * cos2sm * (-3 + 4 * sin_s ** 2)
                      * (-3 + 4 * cos2sm ** 2))))
        return b_ax * big_a * (sig - dsig)

    register(sp + "vincentyDistance", _vincenty)

    def _bearing(a, b):
        la1, lo1 = _latlon(a)
        la2, lo2 = _latlon(b)
        p1, p2 = math.radians(la1), math.radians(la2)
        dl = math.radians(lo2 - lo1)
        y = math.sin(dl) * math.cos(p2)
        x = (math.cos(p1) * math.sin(p2)
             - math.sin(p1) * math.cos(p2) * math.cos(dl))
        return (math.degrees(math.atan2(y, x)) + 360) % 360

    register(sp + "bearing", _bearing)

    def _destination(p, bearing, dist_m):
        la, lo = _latlon(p)
        p1 = math.radians(la)
        l1 = math.radians(lo)
        br = math.radians(float(bearing))
        dr = float(dist_m) / _EARTH_R
        p2 = math.asin(math.sin(p1) * math.cos(dr)
                       + math.cos(p1) * math.sin(dr) * math.cos(br))
        l2 = l1 + math.atan2(
            math.sin(br) * math.sin(dr) * math.cos(p1),
            math.cos(dr) - math.sin(p1) * math.sin(p2))
        return {"latitude": math.degrees(p2),
                "longitude": (math.degrees(l2) + 540) % 360 - 180}

    register(sp + "destination", _destination)
    register(sp + "midpoint", lambda a, b: _destination(
        a, _bearing(a, b), _haversine(a, b) / 2.0))

    def _centroid(points):
        lls = [_latlon(p) for p in (points or [])]
        if not lls:
            return None
        return {"latitude": sum(x[0] for x in lls) / len(lls),
                "longitude": sum(x[1] for x in lls) / len(lls)}

    register(sp + "centroid", _centroid)

    def _bbox(points):
        lls = [_latlon(p) for p in (points or [])]
        if not lls:
            return None
        return {"minLatitude": min(x[0] for x in lls),
                "maxLatitude": max(x[0] for x in lls),
                "minLongitude": min(x[1] for x in lls),
                "maxLongitude": max(x[1] for x in lls)}

    register(sp + "boundingBox", _bbox)

    def _within(p, bbox):
        la, lo = _latlon(p)
        return (bbox["minLatitude"] <= la <= bbox["maxLatitude"]
                and bbox["minLongitude"] <= lo <= bbox["maxLongitude"])

    register(sp + "within", _within)
    register(sp + "withinDistance", lambda p, center, m: (
        _haversine(p, center) <= float(m)))

    def _area(points):
        """Planar shoelace area of a lat/lon polygon, in m^2 (small
        polygons; equirectangular projection about the centroid)."""
        lls = [_latlon(p) for p in (points or [])]
        if len(lls) < 3:
            return 0.0
        lat0 = sum(x[0] for x in lls) / len(lls)
        scale = math.cos(math.radians(lat0))
        xy = [(math.radians(lo) * _EARTH_R * scale,
               math.radians(la) * _EARTH_R) for la, lo in lls]
        s = 0.0
        for i in range(len(xy)):
            x1, y1 = xy[i]
            x2, y2 = xy[(i + 1) % len(xy)]
            s += x1 * y2 - x2 * y1
        return abs(s) / 2.0

    register(sp + "area", _area)

    _B32 = "0123456789bcdefghjkmnpqrstuvwxyz"

    def _encode_geohash(p, precision=9):
        la, lo = _latlon(p)
        lat_r, lon_r = [-90.0, 90.0], [-180.0, 180.0]
        bits = []
        even = True
        while len(bits) < int(precision) * 5:
            if even:
                mid = (lon_r[0] + lon_r[1]) / 2
                if lo >= mid:
                    bits.append(1)
                    lon_r[0] = mid
                else:
                    bits.append(0)
                    lon_r[1] = mid
            else:
                mid = (lat_r[0] + lat_r[1]) / 2
                if la >= mid:
                    bits.append(1)
                    lat_r[0] = mid
                else:
                    bits.append(0)
                    lat_r[1] = mid
            even = not even
        out = ""
        for i in range(0, len(bits), 5):
            out += _B32[int("".join(map(str, bits[i:i + 5])), 2)]
        return out

    def _decode_geohash(gh):
        lat_r, lon_r = [-90.0, 90.0], [-180.0, 180.0]
        even = True
        for ch in str(gh).lower():
            idx = _B32.index(ch)
            for bit in range(4, -1, -1):
                b = (idx >> bit) & 1
                r = lon_r if even else lat_r
                mid = (r[0] + r[1]) / 2
                if b:
                    r[0] = mid
                else:
                    r[1] = mid
                even = not even
        return {"latitude": (lat_r[0] + lat_r[1]) / 2,
                "longitude": (lon_r[0] + lon_r[1]) / 2}

    register(sp + "encodeGeohash", _encode_geohash)
    register(sp + "decodeGeohash", _decode_geohash)

    def _nearest(p, candidates):
        best, best_d = None, None
        for c in candidates or []:
            d = _haversine(p, c)
            if best_d is None or d < best_d:
                best, best_d = c, d
        return best

    register(sp + "nearest", _nearest)
    register(sp + "kNearest", lambda p, candidates, k: [
        c for c in sorted(candidates or [],
                          key=lambda c: _haversine(p, c))][: int(k)])

    def _to_geojson(p):
        la, lo = _latlon(p)
        return {"type": "Point", "coordinates": [lo, la]}

    register(sp + "toGeoJson", _to_geojson)
    register(sp + "fromGeoJson", lambda g: {
        "latitude": g["coordinates"][1], "longitude": g["coordinates"][0]}
        if isinstance(g, dict) and g.get("type") == "Point" else None)

    def _poly_contains(points, p):
        lls = [_latlon(q) for q in (points or [])]
        la, lo = _latlon(p)
        inside = False
        j = len(lls) - 1
        for i in range(len(lls)):
            yi, xi = lls[i]
            yj, xj = lls[j]
            if (yi > la) != (yj > la) and (
                    lo < (xj - xi) * (la - yi) / (yj - yi) + xi):
                inside = not inside
            j = i
        return inside

    register(sp + "contains", _poly_contains)
    register(sp + "intersects", lambda a_pts, b_pts: any(
        _poly_contains(a_pts, q) for q in (b_pts or []))
        or any(_poly_contains(b_pts, q) for q in (a_pts or [])))


def _install_meta() -> None:
    mt = "apoc.meta."
    register(mt + "isNode", lambda x: isinstance(x, Node))
    register(mt + "isRelationship", lambda x: isinstance(x, Edge))

    def _is_path(x):
        from nornicdb_tpu_torch.query.functions import PathValue
        return isinstance(x, PathValue)

    register(mt + "isPath", _is_path)

    def _cypher_type(x):
        from nornicdb_tpu_torch.query.functions import REGISTRY
        return REGISTRY["valuetype"](x)

    register(mt + "cypherType", _cypher_type)
    register(mt + "typeOf", _cypher_type)
    register(mt + "types", lambda m: {
        k: _cypher_type(v) for k, v in (m or {}).items()})
    register(mt + "cypherTypes", lambda m: {
        k: _cypher_type(v) for k, v in (m or {}).items()})
    register(mt + "isType", lambda x, t: _cypher_type(x) == str(t).upper())

    def _scan(ctx):
        labels: Dict[str, int] = {}
        props: Dict[str, Set[str]] = {}
        for node in ctx.storage.all_nodes():
            for l in node.labels:
                labels[l] = labels.get(l, 0) + 1
                props.setdefault(l, set()).update(node.properties)
        rels: Dict[str, int] = {}
        rprops: Dict[str, Set[str]] = {}
        for e in ctx.storage.all_edges():
            rels[e.type] = rels.get(e.type, 0) + 1
            rprops.setdefault(e.type, set()).update(e.properties)
        return labels, props, rels, rprops

    def _stats(ctx):
        labels, _props, rels, _rp = _scan(ctx)
        return {"nodeCount": ctx.storage.count_nodes(),
                "relCount": ctx.storage.count_edges(),
                "labels": labels, "relTypes": rels}

    register_ctx(mt + "stats", _stats)
    register_ctx(mt + "nodeLabels", lambda ctx: sorted(_scan(ctx)[0]))
    register_ctx(mt + "relTypes", lambda ctx: sorted(_scan(ctx)[2]))

    def _property_keys(ctx):
        _labels, props, _rels, _rp = _scan(ctx)
        return sorted(set().union(*props.values()) if props else set())

    register_ctx(mt + "propertyKeys", _property_keys)
    register_ctx(mt + "nodeTypeProperties", lambda ctx: [
        {"nodeType": l, "propertyName": p}
        for l, ps in sorted(_scan(ctx)[1].items()) for p in sorted(ps)])
    register_ctx(mt + "relTypeProperties", lambda ctx: [
        {"relType": t, "propertyName": p}
        for t, ps in sorted(_scan(ctx)[3].items()) for p in sorted(ps)])

    def _data(ctx):
        labels, props, rels, rprops = _scan(ctx)
        return {"labels": labels, "relTypes": rels,
                "labelProperties": {l: sorted(ps)
                                    for l, ps in props.items()},
                "relProperties": {t: sorted(ps)
                                  for t, ps in rprops.items()}}

    register_ctx(mt + "data", _data)

    def _schema(ctx):
        labels, props, _rels, _rp = _scan(ctx)
        return {l: {"type": "node", "count": c,
                    "properties": sorted(props.get(l, set()))}
                for l, c in labels.items()}

    register_ctx(mt + "schema", _schema)
    register_ctx(mt + "cardinality", lambda ctx, label: len(
        ctx.storage.get_nodes_by_label(label)))

    def _graph_sample(ctx, limit=100):
        nodes = []
        for i, node in enumerate(ctx.storage.all_nodes()):
            if i >= int(limit):
                break
            nodes.append(node)
        ids = {x.id for x in nodes}
        rels = [e for e in ctx.storage.all_edges()
                if e.start_node in ids and e.end_node in ids]
        return {"nodes": nodes, "relationships": rels}

    register_ctx(mt + "graph", lambda ctx: _graph_sample(ctx, 10 ** 9))
    register_ctx(mt + "graphSample", _graph_sample)


def _install_search() -> None:
    se = "apoc.search."

    def _scan_nodes(ctx, label_or_labels):
        if not label_or_labels:
            yield from ctx.storage.all_nodes()
            return
        labels = (label_or_labels if isinstance(label_or_labels, list)
                  else [label_or_labels])
        seen: Set[str] = set()
        for l in labels:
            for node in ctx.storage.get_nodes_by_label(l):
                if node.id not in seen:
                    seen.add(node.id)
                    yield node

    def _match(value, op, query) -> bool:
        if op == "contains":
            return isinstance(value, str) and str(query) in value
        if op == "starts":
            return isinstance(value, str) and value.startswith(str(query))
        if op == "ends":
            return isinstance(value, str) and value.endswith(str(query))
        if op == "regex":
            return isinstance(value, str) and bool(
                re.search(str(query), value))
        if op == "exact":
            return value == query
        if op == "fuzzy":
            from nornicdb_tpu_torch.query.apoc import _levenshtein
            return (isinstance(value, str)
                    and _levenshtein(value.lower(), str(query).lower())
                    <= max(1, len(str(query)) // 4))
        raise CypherRuntimeError(f"unknown search op {op!r}")

    def _search(ctx, labels, prop, op, query):
        out = []
        for node in _scan_nodes(ctx, labels):
            if _match(node.properties.get(prop), op, query):
                out.append(node)
        return out

    register_ctx(se + "node", lambda ctx, labels, prop, query: _search(
        ctx, labels, prop, "contains", query))
    register_ctx(se + "nodeAll", lambda ctx, spec, op, query: [
        node for label, props in (spec or {}).items()
        for node in _scan_nodes(ctx, label)
        if all(_match(node.properties.get(p), op, query)
               for p in (props if isinstance(props, list) else [props]))])
    register_ctx(se + "nodeAny", lambda ctx, spec, op, query: list({
        node.id: node for label, props in (spec or {}).items()
        for node in _scan_nodes(ctx, label)
        if any(_match(node.properties.get(p), op, query)
               for p in (props if isinstance(props, list) else [props]))
    }.values()))
    register_ctx(se + "nodeReduced", lambda ctx, spec, op, query: [
        {"id": node.id, "labels": list(node.labels)}
        for label, props in (spec or {}).items()
        for node in _scan_nodes(ctx, label)
        if any(_match(node.properties.get(p), op, query)
               for p in (props if isinstance(props, list) else [props]))])
    register_ctx(se + "contains", lambda ctx, labels, prop, q: _search(
        ctx, labels, prop, "contains", q))
    register_ctx(se + "prefix", lambda ctx, labels, prop, q: _search(
        ctx, labels, prop, "starts", q))
    register_ctx(se + "suffix", lambda ctx, labels, prop, q: _search(
        ctx, labels, prop, "ends", q))
    register_ctx(se + "regex", lambda ctx, labels, prop, q: _search(
        ctx, labels, prop, "regex", q))
    register_ctx(se + "exists", lambda ctx, labels, prop: [
        node for node in _scan_nodes(ctx, labels)
        if prop in node.properties])
    register_ctx(se + "missing", lambda ctx, labels, prop: [
        node for node in _scan_nodes(ctx, labels)
        if prop not in node.properties])
    register_ctx(se + "null", lambda ctx, labels, prop: [
        node for node in _scan_nodes(ctx, labels)
        if prop in node.properties and node.properties[prop] is None])
    register_ctx(se + "notNull", lambda ctx, labels, prop: [
        node for node in _scan_nodes(ctx, labels)
        if node.properties.get(prop) is not None])
    register_ctx(se + "in", lambda ctx, labels, prop, values: [
        node for node in _scan_nodes(ctx, labels)
        if node.properties.get(prop) in (values or [])])
    register_ctx(se + "notIn", lambda ctx, labels, prop, values: [
        node for node in _scan_nodes(ctx, labels)
        if node.properties.get(prop) not in (values or [])])

    def _range(ctx, labels, prop, lo, hi):
        out = []
        for node in _scan_nodes(ctx, labels):
            v = node.properties.get(prop)
            if (isinstance(v, (int, float)) and not isinstance(v, bool)
                    and float(lo) <= v <= float(hi)):
                out.append(node)
        return out

    register_ctx(se + "range", _range)
    register_ctx(se + "fuzzy", lambda ctx, labels, prop, q: _search(
        ctx, labels, prop, "fuzzy", q))
    register_ctx(se + "match", lambda ctx, labels, prop, q: _search(
        ctx, labels, prop, "exact", q))

    def _autocomplete(ctx, labels, prop, prefix, limit=10):
        vals = sorted({
            v for node in _scan_nodes(ctx, labels)
            if isinstance(v := node.properties.get(prop), str)
            and v.lower().startswith(str(prefix).lower())})
        return vals[: int(limit)]

    register_ctx(se + "autocomplete", _autocomplete)

    def _didyoumean(ctx, labels, prop, q, limit=5):
        from nornicdb_tpu_torch.query.apoc import _levenshtein
        scored = []
        for node in _scan_nodes(ctx, labels):
            v = node.properties.get(prop)
            if isinstance(v, str):
                scored.append((_levenshtein(v.lower(), str(q).lower()), v))
        scored.sort()
        out = []
        for _d, v in scored:
            if v not in out:
                out.append(v)
            if len(out) >= int(limit):
                break
        return out

    register_ctx(se + "didYouMean", _didyoumean)
    register_ctx(se + "suggest", _didyoumean)

    def _highlight(ctx, labels, prop, q, pre="<b>", post="</b>"):
        out = []
        for node in _search(ctx, labels, prop, "contains", q):
            v = node.properties[prop]
            out.append({"node": node, "highlighted": v.replace(
                str(q), f"{pre}{q}{post}")})
        return out

    register_ctx(se + "highlight", _highlight)
    register_ctx(se + "multiSearchAll", lambda ctx, specs, q: [
        node for spec in (specs or [])
        for node in _search(ctx, spec.get("label"), spec.get("prop"),
                            spec.get("op", "contains"), q)])
    register_ctx(se + "multiSearchAny", lambda ctx, specs, q: list({
        node.id: node for spec in (specs or [])
        for node in _search(ctx, spec.get("label"), spec.get("prop"),
                            spec.get("op", "contains"), q)}.values()))

    def _score(ctx, labels, prop, q):
        """Occurrence-count scoring for a contains search."""
        out = []
        for node in _scan_nodes(ctx, labels):
            v = node.properties.get(prop)
            if isinstance(v, str) and str(q) in v:
                out.append({"node": node, "score": v.count(str(q))})
        out.sort(key=lambda d: -d["score"])
        return out

    register_ctx(se + "score", _score)


def install() -> None:
    _install_node_rel()
    _install_label()
    _install_nodes()
    _install_neighbors()
    _install_spatial()
    _install_meta()
    _install_search()


install()
