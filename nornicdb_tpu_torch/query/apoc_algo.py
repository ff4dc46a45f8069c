"""APOC graph algorithms: community detection, path analytics, classic
algo (dijkstra/astar/centralities) (counterpart of
``nornicdb_tpu/query/apoc_algo.py``).

Reference: apoc/community/community.go (1,081 LoC), apoc/paths,
apoc/algo. All ctx-registered (they read the whole graph through
ctx.storage). Community results follow the reference's shape: a list of
{node, communityId}. The reference maps InfoMap -> LabelPropagation and
WalkTrap -> FastGreedy (community.go:803,1056); the same aliases apply
here.
"""

from __future__ import annotations

import heapq
import math
from typing import Any, Dict, List, Optional, Set, Tuple

from nornicdb_tpu_torch.errors import CypherRuntimeError
from nornicdb_tpu_torch.query.apoc import register_ctx
from nornicdb_tpu_torch.storage.types import Direction, Edge, Node

_MAX_NODES = 200_000  # whole-graph algorithm safety cap


def _graph(ctx) -> Tuple[List[Node], List[Edge]]:
    nodes = list(ctx.storage.all_nodes())
    if len(nodes) > _MAX_NODES:
        raise CypherRuntimeError(
            f"graph too large for in-memory algorithm ({len(nodes)} nodes)")
    return nodes, list(ctx.storage.all_edges())


def _adj(nodes: List[Node], rels: List[Edge],
         directed: bool = False) -> Dict[str, Set[str]]:
    ids = {n.id for n in nodes}
    adj: Dict[str, Set[str]] = {n.id: set() for n in nodes}
    for e in rels:
        if e.start_node in ids and e.end_node in ids:
            adj[e.start_node].add(e.end_node)
            if not directed:
                adj[e.end_node].add(e.start_node)
    return adj


def _weight(e: Edge, prop: Optional[str]) -> float:
    if prop:
        v = e.properties.get(prop)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return 1.0


def _result(nodes: List[Node], comm: Dict[str, int]) -> List[Dict[str, Any]]:
    # densify community ids in first-seen order (reference remaps too)
    remap: Dict[int, int] = {}
    out = []
    for n in nodes:
        c = comm.get(n.id, -1)
        if c not in remap:
            remap[c] = len(remap)
        out.append({"node": n, "communityId": remap[c]})
    return out


# -- components ----------------------------------------------------------


def _union_find_components(nodes: List[Node],
                           rels: List[Edge]) -> Dict[str, int]:
    parent: Dict[str, str] = {n.id: n.id for n in nodes}

    def find(x: str) -> str:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for e in rels:
        if e.start_node in parent and e.end_node in parent:
            ra, rb = find(e.start_node), find(e.end_node)
            if ra != rb:
                parent[ra] = rb
    roots: Dict[str, int] = {}
    comm: Dict[str, int] = {}
    for n in nodes:
        r = find(n.id)
        if r not in roots:
            roots[r] = len(roots)
        comm[n.id] = roots[r]
    return comm


def _scc(nodes: List[Node], rels: List[Edge]) -> Dict[str, int]:
    """Tarjan's strongly connected components, iterative."""
    adj = _adj(nodes, rels, directed=True)
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    comm: Dict[str, int] = {}
    counter = [0]
    n_comms = [0]

    for start in (n.id for n in nodes):
        if start in index:
            continue
        work = [(start, iter(sorted(adj[start])))]
        index[start] = low[start] = counter[0]
        counter[0] += 1
        stack.append(start)
        on_stack.add(start)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comm[w] = n_comms[0]
                    if w == v:
                        break
                n_comms[0] += 1
    return comm


def _label_propagation(nodes: List[Node], rels: List[Edge],
                       max_iter: int = 10) -> Dict[str, int]:
    adj = _adj(nodes, rels)
    comm = {n.id: i for i, n in enumerate(nodes)}
    for _ in range(max(int(max_iter), 1)):
        changed = False
        for n in nodes:
            if not adj[n.id]:
                continue
            counts: Dict[int, int] = {}
            for m in adj[n.id]:
                counts[comm[m]] = counts.get(comm[m], 0) + 1
            # deterministic tie-break: highest count, then lowest id
            best = min(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
            if best != comm[n.id]:
                comm[n.id] = best
                changed = True
        if not changed:
            break
    return comm


def _modularity(nodes: List[Node], rels: List[Edge],
                comm: Dict[str, int], weight_prop=None) -> float:
    ids = {n.id for n in nodes}
    m2 = 0.0
    deg: Dict[str, float] = {n.id: 0.0 for n in nodes}
    for e in rels:
        if e.start_node in ids and e.end_node in ids:
            w = _weight(e, weight_prop)
            m2 += 2 * w
            deg[e.start_node] += w
            deg[e.end_node] += w
    if m2 == 0:
        return 0.0
    q = 0.0
    for e in rels:
        if e.start_node in ids and e.end_node in ids:
            if comm.get(e.start_node) == comm.get(e.end_node):
                q += 2 * _weight(e, weight_prop)
    for cid in set(comm.values()):
        tot = sum(deg[nid] for nid, c in comm.items() if c == cid)
        q -= tot * tot / m2
    return q / m2


def _greedy_modularity(nodes: List[Node], rels: List[Edge],
                       max_iter: int = 10) -> Dict[str, int]:
    """One-level greedy modularity optimization (the Louvain local-move
    phase; also serves FastGreedy, as in the reference)."""
    adj_w: Dict[str, Dict[str, float]] = {n.id: {} for n in nodes}
    ids = {n.id for n in nodes}
    m2 = 0.0
    deg: Dict[str, float] = {n.id: 0.0 for n in nodes}
    for e in rels:
        if e.start_node in ids and e.end_node in ids:
            w = _weight(e, "weight")
            adj_w[e.start_node][e.end_node] = \
                adj_w[e.start_node].get(e.end_node, 0.0) + w
            adj_w[e.end_node][e.start_node] = \
                adj_w[e.end_node].get(e.start_node, 0.0) + w
            deg[e.start_node] += w
            deg[e.end_node] += w
            m2 += 2 * w
    comm = {n.id: i for i, n in enumerate(nodes)}
    if m2 == 0:
        return comm
    comm_deg: Dict[int, float] = {}
    for nid, c in comm.items():
        comm_deg[c] = comm_deg.get(c, 0.0) + deg[nid]
    for _ in range(max(int(max_iter), 1)):
        moved = False
        for n in nodes:
            nid = n.id
            cur = comm[nid]
            # weights to neighboring communities
            to_comm: Dict[int, float] = {}
            for m, w in adj_w[nid].items():
                to_comm[comm[m]] = to_comm.get(comm[m], 0.0) + w
            comm_deg[cur] -= deg[nid]
            best, best_gain = cur, 0.0
            for c, w_in in sorted(to_comm.items()):
                gain = w_in / m2 - comm_deg.get(c, 0.0) * deg[nid] / (
                    m2 * m2) * 2
                base = to_comm.get(cur, 0.0) / m2 - comm_deg.get(
                    cur, 0.0) * deg[nid] / (m2 * m2) * 2
                if gain - base > best_gain + 1e-12:
                    best, best_gain = c, gain - base
            comm[nid] = best
            comm_deg[best] = comm_deg.get(best, 0.0) + deg[nid]
            if best != cur:
                moved = True
        if not moved:
            break
    return comm


def _triangles_per_node(nodes: List[Node],
                        rels: List[Edge]) -> Dict[str, int]:
    adj = _adj(nodes, rels)
    tri = {n.id: 0 for n in nodes}
    for n in nodes:
        neigh = sorted(adj[n.id])
        for i in range(len(neigh)):
            for j in range(i + 1, len(neigh)):
                if neigh[j] in adj[neigh[i]]:
                    tri[n.id] += 1
    return tri


def _core_numbers(nodes: List[Node], rels: List[Edge]) -> Dict[str, int]:
    adj = {k: set(v) for k, v in _adj(nodes, rels).items()}
    deg = {nid: len(v) for nid, v in adj.items()}
    core: Dict[str, int] = {}
    remaining = set(deg)
    k = 0
    while remaining:
        k_nodes = sorted(nid for nid in remaining if deg[nid] <= k)
        if not k_nodes:
            k += 1
            continue
        while k_nodes:
            nid = k_nodes.pop()
            core[nid] = k
            remaining.discard(nid)
            for m in adj[nid]:
                if m in remaining:
                    deg[m] -= 1
                    if deg[m] <= k:
                        k_nodes.append(m)
            adj[nid] = set()
    return core


def _install_community() -> None:
    c = "apoc.community."

    def _cc(ctx):
        nodes, rels = _graph(ctx)
        return _result(nodes, _union_find_components(nodes, rels))

    register_ctx(c + "connectedComponents", _cc)
    register_ctx(c + "weaklyConnectedComponents", _cc)

    def _scc_fn(ctx):
        nodes, rels = _graph(ctx)
        return _result(nodes, _scc(nodes, rels))

    register_ctx(c + "stronglyConnectedComponents", _scc_fn)
    register_ctx(c + "numComponents", lambda ctx: len(set(
        _union_find_components(*_graph(ctx)).values())))

    def _lp(ctx, max_iter=10):
        nodes, rels = _graph(ctx)
        return _result(nodes, _label_propagation(nodes, rels, max_iter))

    register_ctx(c + "labelPropagation", _lp)
    register_ctx(c + "infomap", _lp)  # reference community.go:803

    def _louvain(ctx, max_iter=10):
        nodes, rels = _graph(ctx)
        return _result(nodes, _greedy_modularity(nodes, rels, max_iter))

    register_ctx(c + "louvain", _louvain)
    register_ctx(c + "fastGreedy", _louvain)
    register_ctx(c + "walktrap", _louvain)  # reference community.go:1056
    register_ctx(c + "spinglass", lambda ctx, spins=25, gamma=1.0: _louvain(
        ctx))

    def _mod(ctx, community_map=None):
        nodes, rels = _graph(ctx)
        if community_map is None:
            comm = _greedy_modularity(nodes, rels)
        else:
            comm = {str(k): int(v) for k, v in community_map.items()}
        return _modularity(nodes, rels, comm)

    register_ctx(c + "modularity", _mod)

    def _tri(ctx):
        nodes, rels = _graph(ctx)
        t = _triangles_per_node(nodes, rels)
        return [{"node": n, "triangles": t[n.id]} for n in nodes]

    register_ctx(c + "triangleCount", _tri)
    register_ctx(c + "totalTriangles", lambda ctx: sum(
        _triangles_per_node(*_graph(ctx)).values()) // 3)

    def _clustering(ctx):
        nodes, rels = _graph(ctx)
        adj = _adj(nodes, rels)
        tri = _triangles_per_node(nodes, rels)
        out = []
        for n in nodes:
            d = len(adj[n.id])
            coeff = (2.0 * tri[n.id] / (d * (d - 1))) if d >= 2 else 0.0
            out.append({"node": n, "coefficient": coeff})
        return out

    register_ctx(c + "clusteringCoefficient", _clustering)
    register_ctx(c + "averageClusteringCoefficient", lambda ctx: (
        (sum(d["coefficient"] for d in _clustering(ctx)) / len(cs))
        if (cs := _clustering(ctx)) else 0.0))

    def _density(ctx):
        nodes, rels = _graph(ctx)
        n = len(nodes)
        if n < 2:
            return 0.0
        ids = {x.id for x in nodes}
        m = sum(1 for e in rels
                if e.start_node in ids and e.end_node in ids)
        return 2.0 * m / (n * (n - 1))

    register_ctx(c + "density", _density)

    def _conductance(ctx, community_nodes):
        nodes, rels = _graph(ctx)
        inside = {x.id for x in (community_nodes or [])
                  if isinstance(x, Node)}
        cut = vol_in = vol_out = 0
        for e in rels:
            s_in = e.start_node in inside
            t_in = e.end_node in inside
            if s_in != t_in:
                cut += 1
            if s_in:
                vol_in += 1
            if t_in:
                vol_in += 1
            if not s_in:
                vol_out += 1
            if not t_in:
                vol_out += 1
        denom = min(vol_in, vol_out)
        return cut / denom if denom else 0.0

    register_ctx(c + "conductance", _conductance)

    def _kcore(ctx, k=2):
        nodes, rels = _graph(ctx)
        core = _core_numbers(nodes, rels)
        return [n for n in nodes if core.get(n.id, 0) >= int(k)]

    register_ctx(c + "kcore", _kcore)

    def _corenumber(ctx):
        nodes, rels = _graph(ctx)
        core = _core_numbers(nodes, rels)
        return [{"node": n, "coreNumber": core.get(n.id, 0)}
                for n in nodes]

    register_ctx(c + "coreNumber", _corenumber)


# -- paths ---------------------------------------------------------------


def _neighbors_dir(ctx, nid: str, directed: bool) -> List[Tuple[str, Edge]]:
    direction = Direction.OUTGOING if directed else Direction.BOTH
    out = []
    for e in ctx.storage.get_node_edges(nid, direction=direction):
        other = e.end_node if e.start_node == nid else e.start_node
        out.append((other, e))
    return out


def _bfs_dist(ctx, a: Node, b: Node, directed=True) -> Optional[int]:
    p = _bfs_path(ctx, a, b, directed)
    return None if p is None else len(p) - 1


def _bfs_path(ctx, a: Node, b: Node, directed=True) -> Optional[List[str]]:
    """Exact shortest path (node-id list) by BFS with parent tracking."""
    if a.id == b.id:
        return [a.id]
    prev = {a.id: None}
    frontier = [a.id]
    while frontier:
        nxt = []
        for nid in frontier:
            for other, _e in _neighbors_dir(ctx, nid, directed):
                if other in prev:
                    continue
                prev[other] = nid
                if other == b.id:
                    path = [other]
                    while path[-1] != a.id:
                        path.append(prev[path[-1]])
                    return list(reversed(path))
                nxt.append(other)
        frontier = nxt
    return None


def _all_simple_paths(ctx, a: Node, b: Node, max_len=6,
                      limit=1000) -> List[List[str]]:
    paths: List[List[str]] = []
    stack: List[Tuple[str, List[str]]] = [(a.id, [a.id])]
    while stack and len(paths) < int(limit):
        cur, path = stack.pop()
        if len(path) > int(max_len) + 1:
            continue
        for other, _e in _neighbors_dir(ctx, cur, directed=True):
            if other == b.id:
                paths.append(path + [other])
            elif other not in path and len(path) <= int(max_len):
                stack.append((other, path + [other]))
    return paths


def _install_paths() -> None:
    p = "apoc.paths."

    register_ctx(p + "distance", lambda ctx, a, b: _bfs_dist(ctx, a, b))
    register_ctx(p + "exists", lambda ctx, a, b: _bfs_dist(
        ctx, a, b) is not None)
    register_ctx(p + "count", lambda ctx, a, b, max_len=6: len(
        _all_simple_paths(ctx, a, b, max_len)))
    register_ctx(p + "all", lambda ctx, a, b, max_len=6: _all_simple_paths(
        ctx, a, b, max_len))
    register_ctx(p + "simple", lambda ctx, a, b, max_len=6:
                 _all_simple_paths(ctx, a, b, max_len))
    register_ctx(p + "shortest", lambda ctx, a, b: _bfs_path(ctx, a, b))
    register_ctx(p + "longest", lambda ctx, a, b, max_len=8: max(
        _all_simple_paths(ctx, a, b, max_len), key=len, default=None))
    register_ctx(p + "kShortest", lambda ctx, a, b, k=3, max_len=10: sorted(
        _all_simple_paths(ctx, a, b, max_len), key=len)[: int(k)])
    register_ctx(p + "withinLength", lambda ctx, a, b, max_len: [
        q for q in _all_simple_paths(ctx, a, b, max_len)])
    register_ctx(p + "withLength", lambda ctx, a, b, length: [
        q for q in _all_simple_paths(ctx, a, b, int(length))
        if len(q) - 1 == int(length)])
    register_ctx(p + "common", lambda ctx, a, b: sorted(
        {other for other, _ in _neighbors_dir(ctx, a.id, False)}
        & {other for other, _ in _neighbors_dir(ctx, b.id, False)}))
    register_ctx(p + "disjoint", lambda ctx, paths_a, paths_b: not (
        {n for q in (paths_a or []) for n in q}
        & {n for q in (paths_b or []) for n in q}))
    register_ctx(p + "edgeDisjoint", lambda ctx, a, b: _edge_disjoint(
        ctx, a, b))
    register_ctx(p + "unique", lambda ctx, paths: [
        list(q) for q in dict.fromkeys(tuple(q) for q in (paths or []))])
    register_ctx(p + "reverse", lambda ctx, path: list(
        reversed(path or [])))
    register_ctx(p + "slice", lambda ctx, path, start, length: list(
        (path or [])[int(start): int(start) + int(length)]))
    register_ctx(p + "merge", lambda ctx, a, b: (
        list(a or []) + list(b or [])[1:]
        if (a and b and a[-1] == b[0]) else list(a or []) + list(b or [])))
    register_ctx(p + "elementary", lambda ctx, path: len(
        set(path or [])) == len(path or []))

    def _cycles(ctx, start, max_len=8):
        start = start if isinstance(start, Node) else None
        if start is None:
            raise CypherRuntimeError("apoc.paths.cycles expects a node")
        cycles = []
        stack = [(start.id, [start.id])]
        while stack:
            cur, path = stack.pop()
            if len(path) > int(max_len):
                continue
            for other, _e in _neighbors_dir(ctx, cur, directed=True):
                if other == start.id and len(path) > 1:
                    cycles.append(path + [other])
                elif other not in path:
                    stack.append((other, path + [other]))
        return cycles

    register_ctx(p + "cycles", _cycles)

    def _eulerian(ctx):
        """Connected + every node has even degree (undirected check)."""
        nodes, rels = _graph(ctx)
        if not nodes:
            return False
        comp = _union_find_components(
            [n for n in nodes
             if ctx.storage.get_node_edges(n.id)], rels)
        if len(set(comp.values())) > 1:
            return False
        for n in nodes:
            if len(ctx.storage.get_node_edges(n.id)) % 2:
                return False
        return True

    register_ctx(p + "eulerian", _eulerian)

    def _hamiltonian(ctx, max_nodes=12):
        """Exact search, exponential: refuses graphs beyond max_nodes."""
        nodes, rels = _graph(ctx)
        if len(nodes) > int(max_nodes):
            raise CypherRuntimeError(
                "hamiltonian path search is exponential; graph exceeds "
                f"{max_nodes} nodes")
        if not nodes:
            return False
        adj = _adj(nodes, rels)
        n_total = len(nodes)
        for start in nodes:
            stack = [(start.id, {start.id})]
            path_stack = [[start.id]]
            while stack:
                cur, seen = stack.pop()
                path = path_stack.pop()
                if len(seen) == n_total:
                    return True
                for m in sorted(adj[cur]):
                    if m not in seen:
                        stack.append((m, seen | {m}))
                        path_stack.append(path + [m])
        return False

    register_ctx(p + "hamiltonian", _hamiltonian)


def _edge_disjoint(ctx, a: Node, b: Node) -> int:
    """Max edge-disjoint paths between a and b (greedy BFS removal)."""
    used: Set[str] = set()
    count = 0
    while True:
        prev: Dict[str, Tuple[str, str]] = {}
        visited = {a.id}
        frontier = [a.id]
        found = False
        while frontier and not found:
            nxt = []
            for nid in frontier:
                for other, e in _neighbors_dir(ctx, nid, directed=True):
                    if e.id in used or other in visited:
                        continue
                    prev[other] = (nid, e.id)
                    if other == b.id:
                        found = True
                        break
                    visited.add(other)
                    nxt.append(other)
                if found:
                    break
            frontier = nxt
        if not found:
            return count
        cur = b.id
        while cur != a.id:
            pnode, eid = prev[cur]
            used.add(eid)
            cur = pnode
        count += 1


# -- classic algo --------------------------------------------------------


def _install_algo() -> None:
    al = "apoc.algo."

    def _dijkstra(ctx, a, b, weight_prop="weight", default_weight=1.0):
        if not isinstance(a, Node) or not isinstance(b, Node):
            raise CypherRuntimeError("dijkstra expects two nodes")
        dist: Dict[str, float] = {a.id: 0.0}
        prev: Dict[str, str] = {}
        pq: List[Tuple[float, str]] = [(0.0, a.id)]
        done: Set[str] = set()
        while pq:
            d, nid = heapq.heappop(pq)
            if nid in done:
                continue
            done.add(nid)
            if nid == b.id:
                break
            for other, e in _neighbors_dir(ctx, nid, directed=True):
                w = e.properties.get(weight_prop, default_weight)
                w = float(w) if isinstance(w, (int, float)) and \
                    not isinstance(w, bool) else float(default_weight)
                nd = d + w
                if nd < dist.get(other, math.inf):
                    dist[other] = nd
                    prev[other] = nid
                    heapq.heappush(pq, (nd, other))
        if b.id not in dist or b.id not in done:
            return None
        path = [b.id]
        while path[-1] != a.id:
            path.append(prev[path[-1]])
        return {"weight": dist[b.id], "path": list(reversed(path))}

    register_ctx(al + "dijkstra", _dijkstra)

    def _astar(ctx, a, b, weight_prop="weight", lat_prop="latitude",
               lon_prop="longitude"):
        """A* with geographic haversine heuristic; falls back to
        dijkstra when coordinates are absent."""
        if not isinstance(a, Node) or not isinstance(b, Node):
            raise CypherRuntimeError("astar expects two nodes")

        def coords(n: Node):
            la, lo = n.properties.get(lat_prop), n.properties.get(lon_prop)
            if isinstance(la, (int, float)) and isinstance(lo, (int, float)):
                return float(la), float(lo)
            return None

        target = coords(b)

        def h(nid: str) -> float:
            """Haversine meters (reference semantics: edge weights are
            distances in meters when coordinates are present — the same
            unit as the heuristic, keeping A* admissible)."""
            if target is None:
                return 0.0
            from nornicdb_tpu_torch.storage.types import NotFoundError
            try:
                n = ctx.storage.get_node(nid)
            except NotFoundError:
                return 0.0
            c = coords(n)
            if c is None:
                return 0.0
            la1, lo1 = c
            la2, lo2 = target
            p1, p2 = math.radians(la1), math.radians(la2)
            dp = math.radians(la2 - la1)
            dl = math.radians(lo2 - lo1)
            hv = (math.sin(dp / 2) ** 2
                  + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2)
            return 2 * 6_371_000.0 * math.asin(math.sqrt(hv))

        dist: Dict[str, float] = {a.id: 0.0}
        prev: Dict[str, str] = {}
        pq: List[Tuple[float, str]] = [(h(a.id), a.id)]
        done: Set[str] = set()
        while pq:
            _f, nid = heapq.heappop(pq)
            if nid in done:
                continue
            done.add(nid)
            if nid == b.id:
                break
            for other, e in _neighbors_dir(ctx, nid, directed=True):
                w = e.properties.get(weight_prop, 1.0)
                w = float(w) if isinstance(w, (int, float)) and \
                    not isinstance(w, bool) else 1.0
                nd = dist[nid] + w
                if nd < dist.get(other, math.inf):
                    dist[other] = nd
                    prev[other] = nid
                    heapq.heappush(pq, (nd + h(other), other))
        if b.id not in done:
            return None
        path = [b.id]
        while path[-1] != a.id:
            path.append(prev[path[-1]])
        return {"weight": dist[b.id], "path": list(reversed(path))}

    register_ctx(al + "astar", _astar)

    def _degree_centrality(ctx):
        nodes, rels = _graph(ctx)
        n = max(len(nodes) - 1, 1)
        deg: Dict[str, int] = {x.id: 0 for x in nodes}
        for e in rels:
            if e.start_node in deg:
                deg[e.start_node] += 1
            if e.end_node in deg:
                deg[e.end_node] += 1
        return [{"node": x, "centrality": deg[x.id] / n} for x in nodes]

    register_ctx(al + "degreeCentrality", _degree_centrality)

    def _closeness(ctx):
        nodes, rels = _graph(ctx)
        adj = _adj(nodes, rels)
        out = []
        for x in nodes:
            # BFS from x
            dist = {x.id: 0}
            frontier = [x.id]
            d = 0
            while frontier:
                d += 1
                nxt = []
                for nid in frontier:
                    for m in adj[nid]:
                        if m not in dist:
                            dist[m] = d
                            nxt.append(m)
                frontier = nxt
            total = sum(dist.values())
            reach = len(dist) - 1
            c = (reach / total) * (reach / max(len(nodes) - 1, 1)) \
                if total else 0.0
            out.append({"node": x, "centrality": c})
        return out

    register_ctx(al + "closenessCentrality", _closeness)

    def _betweenness(ctx):
        """Brandes' algorithm (unweighted)."""
        nodes, rels = _graph(ctx)
        adj = _adj(nodes, rels)
        cb: Dict[str, float] = {x.id: 0.0 for x in nodes}
        for s in nodes:
            stack: List[str] = []
            pred: Dict[str, List[str]] = {x.id: [] for x in nodes}
            sigma = {x.id: 0.0 for x in nodes}
            sigma[s.id] = 1.0
            dist = {x.id: -1 for x in nodes}
            dist[s.id] = 0
            queue = [s.id]
            while queue:
                v = queue.pop(0)
                stack.append(v)
                for w in sorted(adj[v]):
                    if dist[w] < 0:
                        dist[w] = dist[v] + 1
                        queue.append(w)
                    if dist[w] == dist[v] + 1:
                        sigma[w] += sigma[v]
                        pred[w].append(v)
            delta = {x.id: 0.0 for x in nodes}
            while stack:
                w = stack.pop()
                for v in pred[w]:
                    delta[v] += sigma[v] / sigma[w] * (1 + delta[w])
                if w != s.id:
                    cb[w] += delta[w]
            # undirected: each pair counted twice; halve at the end
        return [{"node": x, "centrality": cb[x.id] / 2.0} for x in nodes]

    register_ctx(al + "betweennessCentrality", _betweenness)

    def _pagerank_power(ctx, iterations=20, damping=0.85):
        """Plain power iteration. The device data-plane PageRank
        (ops/graph.py, gds.pageRank procedures) serves large graphs;
        this is the small-graph convenience surface."""
        nodes, rels = _graph(ctx)
        pos = {n.id: i for i, n in enumerate(nodes)}
        n = len(nodes)
        if n == 0:
            return []
        out_deg = [0] * n
        edges = []
        for e in rels:
            if e.start_node in pos and e.end_node in pos:
                edges.append((pos[e.start_node], pos[e.end_node]))
                out_deg[pos[e.start_node]] += 1
        rank = [1.0 / n] * n
        d = float(damping)
        for _ in range(int(iterations)):
            nxt = [(1 - d) / n] * n
            for s, t in edges:
                if out_deg[s]:
                    nxt[t] += d * rank[s] / out_deg[s]
            sink = sum(rank[i] for i in range(n) if not out_deg[i])
            for i in range(n):
                nxt[i] += d * sink / n
            rank = nxt
        return [{"node": x, "score": rank[pos[x.id]]} for x in nodes]

    register_ctx(al + "pagerank", _pagerank_power)

    def _cover(ctx, node_list):
        """Relationships fully inside the given node set."""
        ids = {x.id for x in (node_list or []) if isinstance(x, Node)}
        return [e for e in ctx.storage.all_edges()
                if e.start_node in ids and e.end_node in ids]

    register_ctx(al + "cover", _cover)

    def _all_pairs(ctx, max_nodes=200):
        nodes, rels = _graph(ctx)
        if len(nodes) > int(max_nodes):
            raise CypherRuntimeError(
                f"allPairs is O(n^2); graph exceeds {max_nodes} nodes")
        adj = _adj(nodes, rels)
        out = []
        for a in nodes:
            dist = {a.id: 0}
            frontier = [a.id]
            d = 0
            while frontier:
                d += 1
                nxt = []
                for nid in frontier:
                    for m in adj[nid]:
                        if m not in dist:
                            dist[m] = d
                            nxt.append(m)
                frontier = nxt
            for b in nodes:
                if b.id != a.id and b.id in dist:
                    out.append({"source": a.id, "target": b.id,
                                "distance": dist[b.id]})
        return out

    register_ctx(al + "allPairs", _all_pairs)

    def _community(ctx, max_iter=10):
        nodes, rels = _graph(ctx)
        return _result(nodes, _label_propagation(nodes, rels, max_iter))

    register_ctx(al + "community", _community)


def install() -> None:
    _install_community()
    _install_paths()
    _install_algo()


install()
