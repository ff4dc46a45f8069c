"""APOC long tail: periodic, triggers, path expansion, export/import,
create/merge, util/hashing, and additional function categories
(counterpart of ``nornicdb_tpu/query/apoc_ext.py``).

Reference: apoc/ (~40 categories, apoc/apoc.go:222 registerAllFunctions);
apoc.periodic.iterate/commit (apoc/periodic/), triggers (apoc/trigger/),
path expansion (apoc/path/), export/import/load (apoc/export/,
apoc/load/), create/merge (apoc/create/, apoc/merge/). Functions register
into the shared APOC table (query/apoc.py); procedures dispatch through
``run_ext_procedure``.
"""

from __future__ import annotations

import csv
import hashlib
import io
import json
import os
import time
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional

from nornicdb_tpu_torch.errors import CypherRuntimeError
from nornicdb_tpu_torch.query.apoc import APOC_FUNCS, _jsonable, register
from nornicdb_tpu_torch.storage.types import Direction, Edge, Node


# -- additional function categories ---------------------------------------


def _install_functions():
    import math
    import re as _re

    # apoc.coll long tail
    register("apoc.coll.partition", lambda l, size: [
        (l or [])[i:i + int(size)] for i in range(0, len(l or []), int(size))])
    register("apoc.coll.split", lambda l, v: _coll_split(l or [], v))
    register("apoc.coll.occurrences", lambda l, v: (l or []).count(v))
    register("apoc.coll.removeAll", lambda l, items: [
        x for x in (l or []) if x not in (items or [])])
    register("apoc.coll.insert", lambda l, idx, v: (
        (l or [])[: int(idx)] + [v] + (l or [])[int(idx):]))
    register("apoc.coll.set", lambda l, idx, v: [
        v if i == int(idx) else x for i, x in enumerate(l or [])])
    register("apoc.coll.remove", lambda l, idx, length=1: (
        (l or [])[: int(idx)] + (l or [])[int(idx) + int(length):]))
    register("apoc.coll.duplicates", lambda l: [
        k for k, c in Counter(l or []).items() if c > 1])
    register("apoc.coll.different", lambda l: len(set(l or [])) == len(l or []))
    register("apoc.coll.dropDuplicateNeighbors", lambda l: [
        x for i, x in enumerate(l or []) if i == 0 or x != l[i - 1]])
    register("apoc.coll.fill", lambda v, n: [v] * int(n))
    register("apoc.coll.sumLongs", lambda l: int(sum(l or [])))
    # isBiasCorrected defaults true in APOC => sample stdev (divide n-1)
    register("apoc.coll.stdev", lambda l, bias_corrected=True: _stdev(
        l or [], biased=not bias_corrected))
    register("apoc.coll.sortMaps", lambda l, key: sorted(
        l or [], key=lambda m: (m.get(key) is None, m.get(key)), reverse=True))
    register("apoc.coll.randomItem", lambda l: (
        __import__("random").choice(l) if l else None))
    register("apoc.coll.containsAll", lambda l, items: all(
        x in (l or []) for x in (items or [])))
    register("apoc.coll.containsAny", lambda l, items: any(
        x in (l or []) for x in (items or [])))
    register("apoc.coll.unionAll", lambda a, b: (a or []) + (b or []))
    register("apoc.coll.min", lambda l: min(l) if l else None)

    # apoc.map long tail
    register("apoc.map.clean", lambda m, keys, values: {
        k: v for k, v in (m or {}).items()
        if k not in (keys or []) and v not in (values or [])})
    register("apoc.map.flatten", lambda m, delim=".": _map_flatten(m or {}, delim))
    register("apoc.map.groupBy", lambda l, key: {
        str(m.get(key)): m for m in (l or []) if m.get(key) is not None})
    register("apoc.map.groupByMulti", lambda l, key: _group_by_multi(l or [], key))
    register("apoc.map.mget", lambda m, keys: [(m or {}).get(k) for k in (keys or [])])
    register("apoc.map.submap", lambda m, keys: {
        k: (m or {}).get(k) for k in (keys or [])})
    register("apoc.map.sortedProperties", lambda m: [
        [k, (m or {})[k]] for k in sorted(m or {})])
    register("apoc.map.values", lambda m, keys=None: (
        [(m or {}).get(k) for k in keys] if keys else list((m or {}).values())))
    register("apoc.map.fromValues", lambda l: {
        l[i]: l[i + 1] for i in range(0, len(l or []) - 1, 2)})
    register("apoc.map.setEntry", lambda m, k, v: {**(m or {}), k: v})
    register("apoc.map.merge", lambda a, b: {**(a or {}), **(b or {})})

    # apoc.text long tail
    register("apoc.text.format", lambda fmt, params: (
        fmt % tuple(params or []) if "%" in (fmt or "") else fmt))
    register("apoc.text.regexGroups", lambda s, regex: [
        [m.group(0)] + list(m.groups())
        for m in _re.finditer(regex, s or "")])
    register("apoc.text.regreplace", lambda s, regex, repl: _re.sub(
        regex, repl, s or ""))
    register("apoc.text.slug", lambda s, delim="-": _re.sub(
        r"[\W_]+", delim, (s or "").strip()).strip(delim))
    register("apoc.text.hammingDistance", lambda a, b: (
        abs(len(a or "") - len(b or ""))
        + sum(x != y for x, y in zip(a or "", b or ""))))
    register("apoc.text.jaroWinklerDistance", _jaro_winkler)
    register("apoc.text.sorensenDiceSimilarity", _sorensen_dice)
    register("apoc.text.fuzzyMatch", lambda a, b: _fuzzy_match(a, b))
    register("apoc.text.code", lambda cp: chr(int(cp)))
    register("apoc.text.charAt", lambda s, i: (
        ord(s[int(i)]) if s and 0 <= int(i) < len(s) else None))
    register("apoc.text.repeat", lambda s, n: (s or "") * int(n))
    register("apoc.text.snakeCase", lambda s: _re.sub(
        r"[\s_-]+", "_", _re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", s or "")).lower())
    register("apoc.text.toUpperCase", lambda s: (s or "").upper())
    register("apoc.text.swapCase", lambda s: (s or "").swapcase())
    register("apoc.text.byteCount", lambda s, charset="UTF-8": len(
        (s or "").encode(charset)))

    # apoc.number
    register("apoc.number.parseInt", lambda s, radix=10: (
        int(s, int(radix)) if s else None))
    register("apoc.number.parseFloat", lambda s: float(s) if s else None)

    # apoc.date long tail
    register("apoc.date.add", lambda epoch, unit, value, value_unit: (
        int(epoch) + int(value) * _unit_ms(value_unit) // _unit_ms_div(unit)))
    register("apoc.date.convert", lambda v, frm, to: (
        int(int(v) * _unit_ms(frm) / _unit_ms(to))))
    register("apoc.date.field", _date_field)
    register("apoc.date.toISO8601", lambda ms, unit="ms": __import__(
        "datetime").datetime.fromtimestamp(
        int(ms) * _unit_ms(unit) / 1000.0,
        tz=__import__("datetime").timezone.utc).isoformat())
    register("apoc.date.fromISO8601", lambda s: int(__import__(
        "datetime").datetime.fromisoformat(
        s.replace("Z", "+00:00")).timestamp() * 1000))
    register("apoc.temporal.format", _temporal_format)

    # apoc.util / hashing
    register("apoc.util.md5", lambda vals: _digest("md5", vals))
    register("apoc.util.sha1", lambda vals: _digest("sha1", vals))
    register("apoc.util.sha256", lambda vals: _digest("sha256", vals))
    register("apoc.util.sha512", lambda vals: _digest("sha512", vals))
    register("apoc.hashing.fingerprint", lambda v, excl=None: _digest(
        "md5", [_stable_json(v, excl or [])]))
    register("apoc.version", lambda: "5.x-compat (nornicdb-tpu)")

    # apoc.node / any (degree is a procedure — it needs storage context)
    register("apoc.node.labels", lambda n: list(n.labels)
             if isinstance(n, Node) else None)
    register("apoc.rel.type", lambda r: r.type if isinstance(r, Edge) else None)
    register("apoc.any.properties", lambda x: (
        dict(x.properties) if isinstance(x, (Node, Edge)) else
        (dict(x) if isinstance(x, dict) else None)))
    register("apoc.any.property", lambda x, k: (
        x.properties.get(k) if isinstance(x, (Node, Edge)) else
        (x.get(k) if isinstance(x, dict) else None)))
    register("apoc.create.uuid", lambda: str(__import__("uuid").uuid4()))
    register("apoc.create.uuidBase64", lambda: __import__(
        "base64").urlsafe_b64encode(
        __import__("uuid").uuid4().bytes).decode().rstrip("="))
    register("apoc.label.exists", lambda node, label: (
        label in node.labels if isinstance(node, Node) else False))


def _coll_split(l: List, v) -> List[List]:
    out, cur = [], []
    for x in l:
        if x == v:
            if cur:
                out.append(cur)
            cur = []
        else:
            cur.append(x)
    if cur:
        out.append(cur)
    return out


def _stdev(l: List[float], biased: bool) -> Optional[float]:
    if len(l) < 2:
        return 0.0 if l else None
    mean = sum(l) / len(l)
    var = sum((x - mean) ** 2 for x in l) / (len(l) if biased else len(l) - 1)
    return var ** 0.5


def _map_flatten(m: Dict, delim: str, prefix: str = "") -> Dict:
    out = {}
    for k, v in m.items():
        key = f"{prefix}{delim}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_map_flatten(v, delim, key))
        else:
            out[key] = v
    return out


def _group_by_multi(l: List[Dict], key: str) -> Dict[str, List[Dict]]:
    out: Dict[str, List[Dict]] = {}
    for m in l:
        v = m.get(key)
        if v is not None:
            out.setdefault(str(v), []).append(m)
    return out


def _jaro_winkler(a: str, b: str) -> float:
    a, b = a or "", b or ""
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    window = max(len(a), len(b)) // 2 - 1
    match_a = [False] * len(a)
    match_b = [False] * len(b)
    matches = 0
    for i, ca in enumerate(a):
        lo, hi = max(0, i - window), min(len(b), i + window + 1)
        for j in range(lo, hi):
            if not match_b[j] and b[j] == ca:
                match_a[i] = match_b[j] = True
                matches += 1
                break
    if matches == 0:
        return 0.0
    t = 0
    k = 0
    for i in range(len(a)):
        if match_a[i]:
            while not match_b[k]:
                k += 1
            if a[i] != b[k]:
                t += 1
            k += 1
    t //= 2
    jaro = (matches / len(a) + matches / len(b)
            + (matches - t) / matches) / 3
    prefix = 0
    for ca, cb in zip(a, b):
        if ca != cb or prefix == 4:
            break
        prefix += 1
    return jaro + prefix * 0.1 * (1 - jaro)


def _sorensen_dice(a: str, b: str) -> float:
    a, b = (a or "").lower(), (b or "").lower()
    if a == b:
        return 1.0
    bi_a = Counter(a[i:i + 2] for i in range(len(a) - 1))
    bi_b = Counter(b[i:i + 2] for i in range(len(b) - 1))
    inter = sum((bi_a & bi_b).values())
    total = sum(bi_a.values()) + sum(bi_b.values())
    return 2.0 * inter / total if total else 0.0


def _fuzzy_match(a: str, b: str) -> bool:
    from nornicdb_tpu_torch.query.apoc import _levenshtein

    a, b = (a or "").lower(), (b or "").lower()
    shorter = min(len(a), len(b))
    if shorter < 3:
        return a == b
    allowed = 1 if shorter < 5 else 2
    return _levenshtein(a, b) <= allowed


_UNIT_MS = {
    "ms": 1, "millis": 1, "milliseconds": 1,
    "s": 1000, "seconds": 1000, "sec": 1000,
    "m": 60_000, "minutes": 60_000, "minute": 60_000,
    "h": 3_600_000, "hours": 3_600_000, "hour": 3_600_000,
    "d": 86_400_000, "days": 86_400_000, "day": 86_400_000,
}


def _unit_ms(unit: str) -> int:
    u = _UNIT_MS.get((unit or "ms").lower())
    if u is None:
        raise CypherRuntimeError(f"unknown time unit {unit!r}")
    return u


def _unit_ms_div(unit: str) -> int:
    return _unit_ms(unit)


def _date_field(epoch_ms, unit: str = "d", tz: str = "UTC"):
    import datetime as _dt

    d = _dt.datetime.fromtimestamp(int(epoch_ms) / 1000.0, tz=_dt.timezone.utc)
    u = (unit or "d").lower()
    return {
        "years": d.year, "year": d.year,
        "months": d.month, "month": d.month,
        "days": d.day, "day": d.day, "d": d.day,
        "hours": d.hour, "hour": d.hour, "h": d.hour,
        "minutes": d.minute, "minute": d.minute, "m": d.minute,
        "seconds": d.second, "second": d.second, "s": d.second,
    }.get(u)


def _temporal_format(value, fmt: str) -> str:
    from nornicdb_tpu_torch.query.apoc import _convert_java_format

    return _nonstr(value).strftime(_convert_java_format(fmt))


def _nonstr(v):
    from nornicdb_tpu_torch.query import temporal_types as T

    if isinstance(v, (T.CypherDate, T.CypherDateTime, T.CypherLocalDateTime,
                      T.CypherTime, T.CypherLocalTime)):
        return v._dt
    raise CypherRuntimeError("expected a temporal value")


def _digest(algo: str, vals) -> str:
    h = hashlib.new(algo)
    if not isinstance(vals, list):
        vals = [vals]
    for v in vals:
        h.update(str(v).encode("utf-8"))
    return h.hexdigest()


def _stable_json(v, exclude: List[str]) -> str:
    j = _jsonable(v)
    if isinstance(j, dict):
        j = {k: x for k, x in sorted(j.items()) if k not in exclude}
    return json.dumps(j, sort_keys=True, default=str)


# -- trigger registry -----------------------------------------------------


class TriggerRegistry:
    """apoc.trigger.* — statements fired after any updating query
    (reference: apoc/trigger; subset: 'after' phase, no txData params)."""

    def __init__(self):
        self.triggers: Dict[str, Dict[str, Any]] = {}

    def add(self, name: str, statement: str, selector: Optional[Dict] = None):
        self.triggers[name] = {
            "name": name, "statement": statement,
            "selector": selector or {}, "paused": False,
        }
        return self.triggers[name]

    def remove(self, name: str) -> Optional[Dict]:
        return self.triggers.pop(name, None)

    def remove_all(self) -> int:
        n = len(self.triggers)
        self.triggers.clear()
        return n

    def set_paused(self, name: str, paused: bool) -> Optional[Dict]:
        t = self.triggers.get(name)
        if t:
            t["paused"] = paused
        return t

    def fire(self, executor) -> None:
        for t in list(self.triggers.values()):
            if t["paused"]:
                continue
            try:
                executor._execute_for_trigger(t["statement"])
            except RuntimeError:
                # a device fault (CUDA, out of memory, a part not ported)
                # fails the outer query (ROADMAP C29)
                raise
            except Exception:
                pass  # trigger failure must not fail the outer query


# -- path expansion -------------------------------------------------------


def _parse_rel_filter(spec: Optional[str]):
    """'KNOWS>|<WORKS_AT|LIKES' -> [(type, direction)]."""
    if not spec:
        return None
    out = []
    for part in str(spec).split("|"):
        part = part.strip()
        if not part:
            continue
        if part.endswith(">"):
            out.append((part[:-1], "out"))
        elif part.startswith("<"):
            out.append((part[1:], "in"))
        else:
            out.append((part, "both"))
    return out


def _parse_label_filter(spec: Optional[str]):
    """'+Person|-Banned' -> (allow, deny, terminate, end)."""
    allow, deny, term, end = set(), set(), set(), set()
    if spec:
        for part in str(spec).split("|"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("+"):
                allow.add(part[1:])
            elif part.startswith("-"):
                deny.add(part[1:])
            elif part.startswith("/"):
                term.add(part[1:])
            elif part.startswith(">"):
                end.add(part[1:])
            else:
                allow.add(part)
    return allow, deny, term, end


def _expand_paths(storage, start: Node, rel_filter, label_filter,
                  min_level: int, max_level: int, bfs: bool = True,
                  uniqueness: str = "RELATIONSHIP_PATH"):
    """BFS path expansion (reference: apoc/path/path.go expandConfig)."""
    from nornicdb_tpu_torch.query.functions import PathValue

    allow, deny, term, end = label_filter
    results = []
    queue = [(start, [], [start], set())]
    while queue:
        node, rels, nodes, used = queue.pop(0 if bfs else -1)
        depth = len(rels)
        if depth >= min_level:
            ok = True
            if allow and not (set(node.labels) & allow) and node.id != start.id:
                ok = False
            if end and not (set(node.labels) & end):
                ok = False
            if ok:
                results.append(PathValue(list(nodes), list(rels)))
        if depth >= max_level >= 0:
            continue
        if term and (set(node.labels) & term) and node.id != start.id:
            continue
        for e in storage.get_node_edges(node.id, Direction.BOTH):
            if e.id in used:
                continue
            if e.start_node == node.id:
                other_id, direction = e.end_node, "out"
            else:
                other_id, direction = e.start_node, "in"
            if rel_filter is not None:
                match = False
                for t, d in rel_filter:
                    if (not t or t == e.type) and d in (direction, "both"):
                        match = True
                        break
                if not match:
                    continue
            try:
                other = storage.get_node(other_id)
            except KeyError:
                continue
            if deny and (set(other.labels) & deny):
                continue
            queue.append((other, rels + [e], nodes + [other], used | {e.id}))
    return results


# -- procedures -----------------------------------------------------------


def _bfs_subgraph(storage, start: Node, rel_filter, label_filter,
                  max_level: int):
    """NODE_GLOBAL-uniqueness BFS (reference: apoc/path subgraph
    procedures) — each node visited once via its first (tree) path, so
    dense graphs stay linear instead of enumerating factorially many
    relationship-unique walks."""
    from collections import deque

    from nornicdb_tpu_torch.query.functions import PathValue

    allow, deny, term, end = label_filter

    def rel_ok(e: Edge, direction: str) -> bool:
        return rel_filter is None or any(
            (not t or t == e.type) and d in (direction, "both")
            for t, d in rel_filter
        )

    visited = {start.id}
    tree_paths = [PathValue([start], [])]
    queue = deque([(start, [], [start])])
    while queue:
        node, rels, nodes = queue.popleft()
        depth = len(rels)
        if depth >= max_level >= 0:
            continue
        if term and (set(node.labels) & term) and node.id != start.id:
            continue
        for e in storage.get_node_edges(node.id, Direction.BOTH):
            if e.start_node == node.id:
                other_id, direction = e.end_node, "out"
            else:
                other_id, direction = e.start_node, "in"
            if not rel_ok(e, direction):
                continue
            try:
                other = storage.get_node(other_id)
            except KeyError:
                continue
            if deny and (set(other.labels) & deny):
                continue
            if allow and not (set(other.labels) & allow):
                continue
            if other.id in visited:
                continue
            visited.add(other.id)
            p = PathValue(nodes + [other], rels + [e])
            tree_paths.append(p)
            queue.append((other, rels + [e], nodes + [other]))
    # relationships = ALL matching edges between subgraph nodes, including
    # frontier-to-frontier edges never expanded by the tree walk (real
    # APOC subgraphAll semantics)
    all_rels: Dict[str, Edge] = {}
    for nid in visited:
        for e in storage.get_node_edges(nid, Direction.BOTH):
            direction = "out" if e.start_node == nid else "in"
            if not rel_ok(e, direction):
                continue
            if e.start_node in visited and e.end_node in visited:
                all_rels[e.id] = e
    return tree_paths, all_rels


def run_ext_procedure(executor, name: str, args: List[Any],
                      ctx) -> Optional[Iterator[Dict[str, Any]]]:
    """Dispatch for the extended APOC procedures; returns None when the
    name is not handled here."""
    storage = ctx.storage

    if name == "apoc.periodic.iterate":
        return _periodic_iterate(executor, args, ctx)
    if name == "apoc.periodic.commit":
        return _periodic_commit(executor, args, ctx)
    if name in ("apoc.cypher.run", "apoc.cypher.dorit", "apoc.cypher.doit"):
        return _cypher_run(executor, args, ctx)
    if name in ("apoc.when", "apoc.do.when"):
        return _do_when(executor, args, ctx)

    if name.startswith("apoc.trigger."):
        return _trigger_proc(executor, name, args)

    if name == "apoc.path.expand":
        start, rel_spec, label_spec, min_l, max_l = (list(args) + [None] * 5)[:5]
        paths = _expand_paths(
            storage, _as_node(storage, start),
            _parse_rel_filter(rel_spec), _parse_label_filter(label_spec),
            int(min_l) if min_l is not None else 1,
            int(max_l) if max_l is not None else 5,
        )
        return iter([{"path": p} for p in paths])
    if name == "apoc.path.expandconfig":
        # config-map form (reference apoc/path expandConfig)
        start, cfg = (list(args) + [{}])[:2]
        cfg = cfg or {}
        paths = _expand_paths(
            storage, _as_node(storage, start),
            _parse_rel_filter(cfg.get("relationshipFilter")),
            _parse_label_filter(cfg.get("labelFilter")),
            int(cfg.get("minLevel", 1)),
            int(cfg.get("maxLevel", 5)),
            bfs=bool(cfg.get("bfs", True)),
            uniqueness=str(cfg.get("uniqueness", "RELATIONSHIP_PATH")),
        )
        limit = cfg.get("limit")
        if limit is not None:
            paths = paths[: int(limit)]
        return iter([{"path": p} for p in paths])
    if name in ("apoc.path.shortestpath", "apoc.path.allshortestpaths"):
        from nornicdb_tpu_torch.query.functions import PathValue

        a, b = (list(args) + [None, None])[:2]
        a = _as_node(storage, a)
        b = _as_node(storage, b)
        # BFS with parent tracking; allshortestpaths collects every
        # parent at the shortest depth
        # undirected BFS (shortestPath semantics ignore direction)
        prev: Dict[str, List[tuple]] = {a.id: []}
        frontier = [a.id]
        depth_of = {a.id: 0}
        found_depth = None
        while frontier and found_depth is None:
            nxt = []
            for nid in frontier:
                for e in storage.get_node_edges(nid, direction="both"):
                    other = (e.end_node if e.start_node == nid
                             else e.start_node)
                    if other not in depth_of:
                        depth_of[other] = depth_of[nid] + 1
                        prev[other] = [(nid, e)]
                        nxt.append(other)
                    elif depth_of[other] == depth_of[nid] + 1:
                        prev[other].append((nid, e))
                    if other == b.id:
                        found_depth = depth_of[other]
            frontier = nxt
        if b.id not in prev and a.id != b.id:
            return iter([])

        def build(nid) -> List[List[tuple]]:
            if nid == a.id:
                return [[]]
            out = []
            for pnode, e in prev[nid]:
                for tail in build(pnode):
                    out.append(tail + [(pnode, e)])
            return out

        combos = build(b.id)
        if name == "apoc.path.shortestpath":
            combos = combos[:1]
        results = []
        for combo in combos:
            nodes = [a]
            rels = []
            for pnode, e in combo:
                rels.append(e)
                other = e.end_node if e.start_node == pnode else e.start_node
                nodes.append(storage.get_node(other))
            results.append({"path": PathValue(nodes, rels)})
        return iter(results)
    if name in ("apoc.path.subgraphnodes", "apoc.path.subgraphall",
                "apoc.path.spanningtree"):
        start, cfg = (list(args) + [{}])[:2]
        cfg = cfg or {}
        tree_paths, all_rels = _bfs_subgraph(
            storage, _as_node(storage, start),
            _parse_rel_filter(cfg.get("relationshipFilter")),
            _parse_label_filter(cfg.get("labelFilter")),
            int(cfg.get("maxLevel", -1)),
        )
        if name == "apoc.path.subgraphnodes":
            return iter([{"node": p.nodes[-1]} for p in tree_paths])
        if name == "apoc.path.spanningtree":
            return iter([{"path": p} for p in tree_paths])
        return iter([{"nodes": [p.nodes[-1] for p in tree_paths],
                      "relationships": list(all_rels.values())}])

    if name == "apoc.create.node":
        labels, props = (list(args) + [{}])[:2]
        node = _create_node(storage, ctx, labels or [], props or {})
        return iter([{"node": node}])
    if name == "apoc.create.nodes":
        labels, props_list = (list(args) + [[]])[:2]
        return iter([
            {"node": _create_node(storage, ctx, labels or [], p or {})}
            for p in (props_list or [])
        ])
    if name == "apoc.create.relationship":
        frm, rel_type, props, to = args
        import uuid as _uuid

        edge = Edge(id=str(_uuid.uuid4()), type=rel_type,
                    start_node=_as_id(frm), end_node=_as_id(to),
                    properties=props or {})
        storage.create_edge(edge)
        ctx.stats.relationships_created += 1
        return iter([{"rel": storage.get_edge(edge.id)}])
    if name == "apoc.create.setproperty":
        target, key, value = args
        node = storage.get_node(_as_id(target))
        node.properties[key] = value
        storage.update_node(node)
        ctx.stats.properties_set += 1
        return iter([{"node": storage.get_node(node.id)}])

    if name == "apoc.merge.node":
        labels, ident, on_create = (list(args) + [{}, {}])[:3]
        return iter([_merge_node(storage, ctx, labels or [], ident or {},
                                 on_create or {})])
    if name == "apoc.merge.relationship":
        frm, rel_type, ident, on_create, to = (list(args) + [{}])[:5]
        return iter([_merge_rel(storage, ctx, frm, rel_type, ident or {},
                                on_create or {}, to)])

    if name in ("apoc.export.json.all", "apoc.export.csv.all"):
        fmt = "json" if ".json." in name else "csv"
        file_path = args[0] if args else None
        return iter([_export_all(storage, file_path, fmt)])
    if name == "apoc.import.json":
        return iter([_import_json(storage, ctx, args[0])])
    if name == "apoc.load.json":
        return _load_json(args[0])
    if name == "apoc.load.csv":
        return _load_csv(args[0])

    if name == "apoc.util.sleep":
        time.sleep(min(float(args[0]) / 1000.0, 10.0))
        return iter([])
    if name == "apoc.util.validate":
        predicate, message = args[0], args[1] if len(args) > 1 else "failed"
        if predicate:
            raise CypherRuntimeError(str(message))
        return iter([])
    if name == "apoc.node.degree":
        node, spec = (list(args) + [None])[:2]
        rf = _parse_rel_filter(spec)
        n = _as_node(storage, node)
        deg = 0
        for e in storage.get_node_edges(n.id, Direction.BOTH):
            direction = "out" if e.start_node == n.id else "in"
            if rf is None or any(
                (not t or t == e.type) and d in (direction, "both")
                for t, d in rf
            ):
                deg += 1
        return iter([{"value": deg}])

    return None


def _as_node(storage, v) -> Node:
    if isinstance(v, Node):
        return v
    return storage.get_node(str(v))


def _as_id(v) -> str:
    return v.id if isinstance(v, Node) else str(v)


def _create_node(storage, ctx, labels: List[str], props: Dict) -> Node:
    import uuid as _uuid

    node = Node(id=str(_uuid.uuid4()), labels=list(labels),
                properties=dict(props))
    storage.create_node(node)
    ctx.stats.nodes_created += 1
    ctx.stats.labels_added += len(labels)
    ctx.stats.properties_set += len(props)
    return storage.get_node(node.id)


def _merge_node(storage, ctx, labels, ident, on_create):
    label = labels[0] if labels else None
    candidates = (storage.get_nodes_by_label(label) if label
                  else list(storage.all_nodes()))
    for n in candidates:
        if all(l in n.labels for l in labels) and all(
            n.properties.get(k) == v for k, v in ident.items()
        ):
            return {"node": n}
    node = _create_node(storage, ctx, labels, {**ident, **on_create})
    return {"node": node}


def _merge_rel(storage, ctx, frm, rel_type, ident, on_create, to):
    import uuid as _uuid

    frm_id, to_id = _as_id(frm), _as_id(to)
    for e in storage.get_node_edges(frm_id, Direction.OUTGOING):
        if (e.type == rel_type and e.end_node == to_id and all(
            e.properties.get(k) == v for k, v in ident.items()
        )):
            return {"rel": e}
    edge = Edge(id=str(_uuid.uuid4()), type=rel_type, start_node=frm_id,
                end_node=to_id, properties={**ident, **on_create})
    storage.create_edge(edge)
    ctx.stats.relationships_created += 1
    return {"rel": storage.get_edge(edge.id)}


def _export_all(storage, file_path: Optional[str], fmt: str) -> Dict:
    t0 = time.time()
    n_nodes = n_rels = 0
    if fmt == "json":
        buf = io.StringIO()
        # "kind" is the record discriminator; "type" stays the edge type
        for n in storage.all_nodes():
            buf.write(json.dumps(
                {"kind": "node", **_jsonable(n)}, default=str) + "\n")
            n_nodes += 1
        for e in storage.all_edges():
            buf.write(json.dumps(
                {"kind": "relationship", **_jsonable(e)}, default=str) + "\n")
            n_rels += 1
        data = buf.getvalue()
    else:
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["_id", "_labels", "_type", "_start", "_end", "properties"])
        for n in storage.all_nodes():
            w.writerow([n.id, ";".join(n.labels), "", "", "",
                        json.dumps(n.properties, default=str)])
            n_nodes += 1
        for e in storage.all_edges():
            w.writerow([e.id, "", e.type, e.start_node, e.end_node,
                        json.dumps(e.properties, default=str)])
            n_rels += 1
        data = buf.getvalue()
    if file_path:
        with open(file_path, "w") as f:
            f.write(data)
    return {
        "file": file_path or "(memory)", "format": fmt,
        "nodes": n_nodes, "relationships": n_rels,
        "time": int((time.time() - t0) * 1000),
        "data": None if file_path else data,
    }


def _import_json(storage, ctx, file_path: str) -> Dict:
    n_nodes = n_rels = 0
    with open(file_path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    # nodes first so relationships resolve
    for rec in records:
        if rec.get("kind") == "node":
            node = Node(id=rec["id"], labels=rec.get("labels", []),
                        properties=rec.get("properties", {}))
            if not storage.has_node(node.id):
                storage.create_node(node)
                n_nodes += 1
                ctx.stats.nodes_created += 1
    for rec in records:
        if rec.get("kind") == "relationship":
            edge = Edge(id=rec["id"], type=rec.get("type", "RELATED"),
                        start_node=rec.get("start") or rec.get("start_node"),
                        end_node=rec.get("end") or rec.get("end_node"),
                        properties=rec.get("properties", {}))
            if not storage.has_edge(edge.id):
                storage.create_edge(edge)
                n_rels += 1
                ctx.stats.relationships_created += 1
    return {"file": file_path, "nodes": n_nodes, "relationships": n_rels}


def _load_json(path: str) -> Iterator[Dict]:
    """File-path loading only (zero-egress environment: no URLs)."""
    if str(path).startswith(("http://", "https://")):
        raise CypherRuntimeError(
            "apoc.load.json: remote URLs are disabled (no egress); "
            "use a file path"
        )
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        for item in json.loads(text):
            yield {"value": item}
    else:
        for line in text.splitlines():
            if line.strip():
                yield {"value": json.loads(line)}


def _load_csv(path: str) -> Iterator[Dict]:
    if str(path).startswith(("http://", "https://")):
        raise CypherRuntimeError(
            "apoc.load.csv: remote URLs are disabled (no egress); "
            "use a file path"
        )
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        for i, row in enumerate(reader):
            yield {"lineNo": i, "map": dict(row),
                   "list": list(row.values())}


def _periodic_iterate(executor, args, ctx) -> Iterator[Dict]:
    """CALL apoc.periodic.iterate(outer, action, {batchSize, params})
    (reference: apoc/periodic — batched write execution)."""
    if len(args) < 2:
        raise CypherRuntimeError(
            "apoc.periodic.iterate(cypherIterate, cypherAction, config)")
    outer_q, action_q = args[0], args[1]
    cfg = args[2] if len(args) > 2 else {}
    batch_size = int((cfg or {}).get("batchSize", 1000))
    params = (cfg or {}).get("params", {})
    t0 = time.time()
    outer = executor._execute_for_trigger(outer_q, params)
    records = outer.records()
    total = len(records)
    batches = failed_ops = committed = 0
    errors: Dict[str, int] = {}
    for i in range(0, total, batch_size):
        batch = records[i:i + batch_size]
        batches += 1
        for rec in batch:
            # outer row columns become variables in the action (APOC
            # semantics): prepend `WITH $col AS col, ...`
            cols = [k for k in rec if k.isidentifier()]
            action = action_q
            if cols:
                action = ("WITH " + ", ".join(f"${k} AS {k}" for k in cols)
                          + " " + action_q)
            try:
                executor._execute_for_trigger(action, {**params, **rec})
                committed += 1
            except RuntimeError:
                raise  # a device fault is not a failed operation (C29)
            except Exception as exc:
                failed_ops += 1
                key = str(exc)[:120]
                errors[key] = errors.get(key, 0) + 1
    yield {
        "batches": batches, "total": total,
        "timeTaken": int((time.time() - t0) * 1000),
        "committedOperations": committed,
        "failedOperations": failed_ops,
        "failedBatches": 0 if not failed_ops else batches,
        "retries": 0,
        "errorMessages": errors,
        "operations": {"total": total, "committed": committed,
                       "failed": failed_ops, "errors": errors},
    }


def _periodic_commit(executor, args, ctx) -> Iterator[Dict]:
    """Run a LIMIT-ed statement until it stops updating."""
    if not args:
        raise CypherRuntimeError("apoc.periodic.commit(statement, params)")
    statement = args[0]
    params = args[1] if len(args) > 1 else {}
    if "limit" not in statement.lower():
        raise CypherRuntimeError("apoc.periodic.commit requires a LIMIT")
    executions = updates = 0
    for _ in range(10_000):  # runaway guard
        r = executor._execute_for_trigger(statement, params)
        executions += 1
        delta = (r.stats.nodes_created + r.stats.nodes_deleted
                 + r.stats.relationships_created
                 + r.stats.relationships_deleted + r.stats.properties_set
                 + r.stats.labels_added + r.stats.labels_removed)
        updates += delta
        if delta == 0:
            break
    yield {"updates": updates, "executions": executions,
           "batchSize": -1, "failedBatches": 0}


def _cypher_run(executor, args, ctx) -> Iterator[Dict]:
    statement = args[0]
    params = args[1] if len(args) > 1 else {}
    r = executor._execute_for_trigger(statement, params or {})
    for rec in r.records():
        # APOC contract: each row is wrapped as the `value` map
        yield {"value": rec}


def _do_when(executor, args, ctx) -> Iterator[Dict]:
    if len(args) < 3:
        raise CypherRuntimeError(
            "apoc.do.when(condition, ifQuery, elseQuery, params)")
    cond, if_q, else_q = args[0], args[1], args[2]
    params = args[3] if len(args) > 3 else {}
    q = if_q if cond else else_q
    if not q:
        return
    r = executor._execute_for_trigger(q, params or {})
    for rec in r.records():
        yield {"value": rec}


def _trigger_proc(executor, name: str, args) -> Iterator[Dict]:
    reg = executor.triggers
    if name == "apoc.trigger.add":
        t = reg.add(args[0], args[1], args[2] if len(args) > 2 else None)
        return iter([{"name": t["name"], "query": t["statement"],
                      "selector": t["selector"], "paused": False,
                      "installed": True}])
    if name == "apoc.trigger.remove":
        t = reg.remove(args[0])
        return iter([{"name": args[0], "installed": False,
                      "removed": t is not None}])
    if name == "apoc.trigger.removeall":
        n = reg.remove_all()
        return iter([{"removed": n}])
    if name == "apoc.trigger.list":
        return iter([
            {"name": t["name"], "query": t["statement"],
             "paused": t["paused"]}
            for t in reg.triggers.values()
        ])
    if name == "apoc.trigger.pause":
        reg.set_paused(args[0], True)
        return iter([{"name": args[0], "paused": True}])
    if name == "apoc.trigger.resume":
        reg.set_paused(args[0], False)
        return iter([{"name": args[0], "paused": False}])
    return None  # unknown trigger name: fall through to the ctx table
    # (apoc_io registers show/install/before/onCreate/... there)


_install_functions()
