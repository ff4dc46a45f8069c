"""GraphQL API: a hand-rolled spec-subset engine with NornicDB's resolvers
(counterpart of ``nornicdb_tpu/api/graphql.py``).

A compact lexer, parser and executor (no codegen, no GraphQL library)
covering the subset the schema needs: named and anonymous queries and
mutations, variables with defaults, aliases, arguments (every literal
kind and variables), nested selection sets, named and inline fragments,
``@skip``/``@include`` and ``__typename``. Host Python; the ``search``
and ``similar`` resolvers reach ``db.search``, and through it the query
embed (B2) and the exact vector tier (B1) on the DB's device.

Wire format: ``POST /graphql {"query", "variables", "operationName"}`` ->
``{"data": ..., "errors": [...]}``; ``GET /graphql`` serves a minimal
playground. A resolver's error is answered as a GraphQL error, as in the
reference; where the reference's resolvers swallow an error into
``null``, ``false`` or a count (a node lookup, the deletes, ``clearAll``),
a device fault (``errors.is_device_fault``) is raised instead, and so
answered (ROADMAP C42).
"""

from __future__ import annotations

import functools
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from nornicdb_tpu_torch.errors import is_device_fault
from nornicdb_tpu_torch.storage.types import Direction


class GraphQLError(Exception):
    pass


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[\s,]+)
  | (?P<comment>\#[^\n\r]*)
  | (?P<spread>\.\.\.)
  | (?P<name>[_A-Za-z][_0-9A-Za-z]*)
  | (?P<float>-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\d+[eE][+-]?\d+)
  | (?P<int>-?\d+)
  | (?P<block_string>\"\"\"(?:[^"]|"(?!""))*\"\"\")
  | (?P<string>"(?:[^"\\\n]|\\.)*")
  | (?P<punct>[!$&():=@\[\]{|}])
    """,
    re.VERBOSE,
)


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise GraphQLError(f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------------------
# parser → document AST (plain dicts)
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, src: str):
        self.toks = _tokenize(src)
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str) -> None:
        kind, v = self.next()
        if v != value:
            raise GraphQLError(f"expected {value!r}, got {v!r}")

    def accept(self, value: str) -> bool:
        if self.peek()[1] == value:
            self.i += 1
            return True
        return False

    def parse_document(self) -> Dict[str, Any]:
        ops: List[Dict[str, Any]] = []
        fragments: Dict[str, Dict[str, Any]] = {}
        while self.peek()[0] != "eof":
            kind, v = self.peek()
            if v == "{":
                ops.append({"operation": "query", "name": None,
                            "variables": [],
                            "selection_set": self.parse_selection_set()})
            elif v in ("query", "mutation", "subscription"):
                ops.append(self.parse_operation())
            elif v == "fragment":
                frag = self.parse_fragment()
                fragments[frag["name"]] = frag
            else:
                raise GraphQLError(f"unexpected token {v!r}")
        return {"operations": ops, "fragments": fragments}

    def parse_operation(self) -> Dict[str, Any]:
        _, op = self.next()
        name = None
        if self.peek()[0] == "name" and self.peek()[1] not in ("{",):
            name = self.next()[1]
        variables = []
        if self.accept("("):
            while not self.accept(")"):
                self.expect("$")
                var = self.next()[1]
                self.expect(":")
                vtype = self.parse_type()
                default = None
                if self.accept("="):
                    default = self.parse_value(const=True)
                variables.append({"name": var, "type": vtype,
                                  "default": default})
        # directives on operations: skip
        return {"operation": op, "name": name, "variables": variables,
                "selection_set": self.parse_selection_set()}

    def parse_type(self) -> str:
        if self.accept("["):
            inner = self.parse_type()
            self.expect("]")
            t = f"[{inner}]"
        else:
            t = self.next()[1]
        if self.accept("!"):
            t += "!"
        return t

    def parse_fragment(self) -> Dict[str, Any]:
        self.expect("fragment")
        name = self.next()[1]
        self.expect("on")
        type_cond = self.next()[1]
        return {"name": name, "on": type_cond,
                "selection_set": self.parse_selection_set()}

    def parse_selection_set(self) -> List[Dict[str, Any]]:
        self.expect("{")
        sels: List[Dict[str, Any]] = []
        while not self.accept("}"):
            if self.accept("..."):
                if self.peek()[1] == "on":
                    self.next()
                    type_cond = self.next()[1]
                    sels.append({"kind": "inline_fragment", "on": type_cond,
                                 "directives": self.parse_directives(),
                                 "selection_set":
                                     self.parse_selection_set()})
                else:
                    sels.append({"kind": "fragment_spread",
                                 "name": self.next()[1],
                                 "directives": self.parse_directives()})
                continue
            name = self.next()[1]
            alias = None
            if self.accept(":"):
                alias, name = name, self.next()[1]
            args = {}
            if self.accept("("):
                while not self.accept(")"):
                    aname = self.next()[1]
                    self.expect(":")
                    args[aname] = self.parse_value()
            directives = self.parse_directives()
            sub = None
            if self.peek()[1] == "{":
                sub = self.parse_selection_set()
            sels.append({"kind": "field", "name": name, "alias": alias,
                         "args": args, "directives": directives,
                         "selection_set": sub})
        return sels

    def parse_directives(self) -> List[Dict[str, Any]]:
        out = []
        while self.accept("@"):
            name = self.next()[1]
            args = {}
            if self.accept("("):
                while not self.accept(")"):
                    aname = self.next()[1]
                    self.expect(":")
                    args[aname] = self.parse_value()
            out.append({"name": name, "args": args})
        return out

    def parse_value(self, const: bool = False) -> Dict[str, Any]:
        kind, v = self.peek()
        if v == "$":
            if const:
                raise GraphQLError("variable in const position")
            self.next()
            return {"kind": "var", "name": self.next()[1]}
        if v == "[":
            self.next()
            items = []
            while not self.accept("]"):
                items.append(self.parse_value(const))
            return {"kind": "list", "items": items}
        if v == "{":
            self.next()
            fields = {}
            while not self.accept("}"):
                fname = self.next()[1]
                self.expect(":")
                fields[fname] = self.parse_value(const)
            return {"kind": "object", "fields": fields}
        self.next()
        if kind == "int":
            return {"kind": "const", "value": int(v)}
        if kind == "float":
            return {"kind": "const", "value": float(v)}
        if kind == "string":
            return {"kind": "const", "value": _decode_string(v[1:-1])}
        if kind == "block_string":
            return {"kind": "const", "value": v[3:-3]}
        if v == "true":
            return {"kind": "const", "value": True}
        if v == "false":
            return {"kind": "const", "value": False}
        if v == "null":
            return {"kind": "const", "value": None}
        return {"kind": "enum", "value": v}


_ESCAPES = {'"': '"', "\\": "\\", "/": "/", "b": "\b", "f": "\f",
            "n": "\n", "r": "\r", "t": "\t"}


def _decode_string(raw: str) -> str:
    """GraphQL string escape decoding. NOT unicode_escape — that
    reinterprets UTF-8 bytes as Latin-1 and mojibakes non-ASCII."""
    out: List[str] = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        if i + 1 >= len(raw):
            raise GraphQLError("dangling escape in string literal")
        e = raw[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e == "u":
            if i + 6 > len(raw):
                raise GraphQLError("bad \\u escape in string literal")
            out.append(chr(int(raw[i + 2:i + 6], 16)))
            i += 6
        else:
            raise GraphQLError(f"unknown escape \\{e}")
    return "".join(out)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

Resolver = Callable[[Any, Dict[str, Any], "GraphQLAPI"], Any]


class _Executor:
    def __init__(self, doc: Dict[str, Any], variables: Dict[str, Any],
                 api: "GraphQLAPI"):
        self.doc = doc
        self.vars = variables
        self.api = api

    def run(self, operation_name: Optional[str]) -> Any:
        ops = self.doc["operations"]
        if not ops:
            raise GraphQLError("no operations in document")
        if operation_name:
            matches = [o for o in ops if o["name"] == operation_name]
            if not matches:
                raise GraphQLError(f"unknown operation {operation_name!r}")
            op = matches[0]
        elif len(ops) == 1:
            op = ops[0]
        else:
            raise GraphQLError("operationName required for multi-op document")
        # bind variables (apply defaults)
        bound = dict(self.vars)
        for v in op["variables"]:
            if v["name"] not in bound and v["default"] is not None:
                bound[v["name"]] = self._value(v["default"])
        self.vars = bound
        if op["operation"] == "query":
            root = self.api.query_fields
        elif op["operation"] == "mutation":
            root = self.api.mutation_fields
        else:
            raise GraphQLError("subscriptions are not supported over HTTP")
        return self._select(op["selection_set"], root, None, "Query"
                            if op["operation"] == "query" else "Mutation")

    def _value(self, v: Dict[str, Any]) -> Any:
        k = v["kind"]
        if k == "const":
            return v["value"]
        if k == "enum":
            return v["value"]
        if k == "var":
            if v["name"] not in self.vars:
                raise GraphQLError(f"variable ${v['name']} not provided")
            return self.vars[v["name"]]
        if k == "list":
            return [self._value(x) for x in v["items"]]
        if k == "object":
            return {n: self._value(x) for n, x in v["fields"].items()}
        raise GraphQLError(f"bad value kind {k}")

    def _included(self, directives: List[Dict[str, Any]]) -> bool:
        for d in directives:
            if d["name"] == "skip" and self._value(
                d["args"].get("if", {"kind": "const", "value": False})
            ):
                return False
            if d["name"] == "include" and not self._value(
                d["args"].get("if", {"kind": "const", "value": True})
            ):
                return False
        return True

    def _select(
        self,
        selections: List[Dict[str, Any]],
        fields: Dict[str, Resolver],
        parent: Any,
        type_name: str,
    ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for sel in selections:
            if not self._included(sel.get("directives", [])):
                continue
            if sel["kind"] == "fragment_spread":
                frag = self.doc["fragments"].get(sel["name"])
                if frag is None:
                    raise GraphQLError(f"unknown fragment {sel['name']!r}")
                if frag["on"] in (type_name, None):
                    out.update(self._select(frag["selection_set"], fields,
                                            parent, type_name))
                continue
            if sel["kind"] == "inline_fragment":
                if sel["on"] in (type_name, None):
                    out.update(self._select(sel["selection_set"], fields,
                                            parent, type_name))
                continue
            name = sel["name"]
            key = sel["alias"] or name
            if name == "__typename":
                out[key] = type_name
                continue
            args = {n: self._value(v) for n, v in sel["args"].items()}
            resolver = fields.get(name)
            if resolver is None:
                raise GraphQLError(
                    f"unknown field {name!r} on {type_name}")
            value = resolver(parent, args, self.api)
            out[key] = self._complete(value, sel.get("selection_set"))
        return out

    def _complete(self, value: Any, sub: Optional[List[Dict[str, Any]]]):
        if value is None:
            return None
        if isinstance(value, list):
            return [self._complete(v, sub) for v in value]
        if isinstance(value, _Object):
            if sub is None:
                raise GraphQLError(
                    f"field of type {value.type_name} needs a selection set")
            return self._select(sub, value.fields, value.parent,
                                value.type_name)
        return value


class _Object:
    """A typed object value: resolvers keyed by field name."""

    def __init__(self, type_name: str, fields: Dict[str, Resolver],
                 parent: Any):
        self.type_name = type_name
        self.fields = fields
        self.parent = parent


# ---------------------------------------------------------------------------
# NornicDB schema + resolvers (reference: schema.graphql Query/Mutation)
# ---------------------------------------------------------------------------


def _prop(name, conv=None):
    def resolver(parent, args, api):
        v = getattr(parent, name, None)
        return conv(v) if conv and v is not None else v

    return resolver


_NODE_FIELDS: Dict[str, Resolver] = {}
_REL_FIELDS: Dict[str, Resolver] = {}


def _node_obj(node) -> Optional[_Object]:
    if node is None:
        return None
    return _Object("Node", _NODE_FIELDS, node)


def _rel_obj(edge) -> Optional[_Object]:
    if edge is None:
        return None
    return _Object("Relationship", _REL_FIELDS, edge)


def _node_relationships(parent, args, api):
    from nornicdb_tpu_torch.storage.types import Direction

    direction = {
        "OUTGOING": Direction.OUTGOING,
        "INCOMING": Direction.INCOMING,
        "BOTH": Direction.BOTH,
    }.get(str(args.get("direction", "BOTH")).upper(), Direction.BOTH)
    edges = api.db.storage.get_node_edges(parent.id, direction)
    rel_type = args.get("type")
    if rel_type:
        edges = [e for e in edges if e.type == rel_type]
    limit = int(args.get("limit", 100))
    return [_rel_obj(e) for e in edges[:limit]]


_NODE_FIELDS.update({
    "id": _prop("id"),
    "labels": _prop("labels"),
    "properties": _prop("properties"),
    "embedding": _prop("embedding"),
    "createdAt": _prop("created_at"),
    "updatedAt": _prop("updated_at"),
    "relationships": _node_relationships,
    "degree": lambda p, a, api: api.db.storage.degree(p.id),
})

_REL_FIELDS.update({
    "id": _prop("id"),
    "type": _prop("type"),
    "properties": _prop("properties"),
    "startNode": lambda p, a, api: _node_obj(
        api.db.storage.get_node(p.start_node)),
    "endNode": lambda p, a, api: _node_obj(
        api.db.storage.get_node(p.end_node)),
    "startNodeId": _prop("start_node"),
    "endNodeId": _prop("end_node"),
})


def _search_result_obj(hit: Dict[str, Any], api) -> _Object:
    fields: Dict[str, Resolver] = {
        "score": lambda p, a, _api: p.get("score"),
        "bm25Score": lambda p, a, _api: p.get("bm25_score"),
        "vectorScore": lambda p, a, _api: p.get("vector_score"),
        "node": lambda p, a, _api: _node_obj(
            _api.db.storage.get_node(p["id"])),
    }
    return _Object("SearchResult", fields, hit)


def _cypher_result_obj(result) -> _Object:
    fields: Dict[str, Resolver] = {
        "columns": lambda p, a, api: p.columns,
        "rows": lambda p, a, api: _jsonable_rows(p.rows),
        "nodesCreated": lambda p, a, api: p.stats.nodes_created,
        "nodesDeleted": lambda p, a, api: p.stats.nodes_deleted,
        "relationshipsCreated":
            lambda p, a, api: p.stats.relationships_created,
        "relationshipsDeleted":
            lambda p, a, api: p.stats.relationships_deleted,
        "propertiesSet": lambda p, a, api: p.stats.properties_set,
    }
    return _Object("CypherResult", fields, result)


def _jsonable_rows(rows):
    from nornicdb_tpu_torch.storage.types import Edge, Node

    def conv(v):
        if isinstance(v, Node):
            return {"id": v.id, "labels": v.labels,
                    "properties": v.properties}
        if isinstance(v, Edge):
            return {"id": v.id, "type": v.type,
                    "startNodeId": v.start_node, "endNodeId": v.end_node,
                    "properties": v.properties}
        if isinstance(v, list):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    return [[conv(v) for v in row] for row in rows]


def _q_node(parent, args, api):
    try:
        return _node_obj(api.db.storage.get_node(args["id"]))
    except Exception as exc:
        if is_device_fault(exc):
            raise
        return None


def _page_by_label(storage, label: str, offset: int, limit: int):
    """Sort/slice on ids from the label index, then fetch ONLY the page —
    copying every labeled node per request would make nodes(label:) O(N)."""
    import heapq

    all_ids = storage.node_ids_by_label(label)
    want = offset + limit
    if 0 <= want < 64:  # partial selection beats a full sort
        ids = heapq.nsmallest(want, all_ids)[offset:]
    else:
        ids = sorted(all_ids)[offset:want if want >= 0 else None]
    return [n for n in storage.batch_get_nodes(ids) if n is not None]


def _q_all_nodes(parent, args, api):
    limit = int(args.get("limit", 100))
    offset = int(args.get("offset", 0))
    if args.get("label"):
        page = _page_by_label(api.db.storage, args["label"], offset, limit)
    else:
        page = sorted(api.db.storage.all_nodes(),
                      key=lambda n: n.id)[offset:offset + limit]
    return [_node_obj(n) for n in page]


def _q_nodes_by_label(parent, args, api):
    limit = int(args.get("limit", 100))
    page = _page_by_label(api.db.storage, args["label"], 0, limit)
    return [_node_obj(n) for n in page]


def _q_search(parent, args, api):
    results = api.db.search.search(
        query=args.get("query", ""),
        limit=int(args.get("limit", 10)),
    )
    return [_search_result_obj(r, api) for r in results]


def _q_similar(parent, args, api):
    results = api.db.search.similar(args["id"],
                                    limit=int(args.get("limit", 10)))
    return [_search_result_obj(r, api) for r in results]


_CYPHER_WRITE_RE = re.compile(
    r"\b(CREATE|MERGE|DELETE|DETACH|SET|REMOVE|DROP|LOAD\s+CSV)\b",
    re.IGNORECASE,
)


def _q_cypher_readonly(parent, args, api):
    """Cypher on the Query root: read-only. Write Cypher must go through
    the mutation (executeCypher) so it carries WRITE authorization."""
    q = args["query"]
    if _CYPHER_WRITE_RE.search(q):
        raise GraphQLError(
            "write Cypher is not allowed on the Query root; use the "
            "executeCypher mutation")
    return _cypher_result_obj(
        api.db.cypher(q, args.get("parameters") or {}))


def _q_cypher(parent, args, api):
    result = api.db.cypher(args["query"], args.get("parameters") or {})
    return _cypher_result_obj(result)


def _m_create_node(parent, args, api):
    import uuid

    from nornicdb_tpu_torch.storage.types import Node

    inp = args.get("input", args)
    node = Node(
        id=inp.get("id") or str(uuid.uuid4()),
        labels=list(inp.get("labels", [])),
        properties=dict(inp.get("properties", {})),
        embedding=inp.get("embedding"),
    )
    api.db.storage.create_node(node)
    return _node_obj(api.db.storage.get_node(node.id))


def _m_update_node(parent, args, api):
    node = api.db.storage.get_node(args["id"])
    inp = args.get("input", args)
    if inp.get("labels") is not None:
        node.labels = list(inp["labels"])
    if inp.get("properties") is not None:
        node.properties.update(inp["properties"])
    api.db.storage.update_node(node)
    return _node_obj(api.db.storage.get_node(node.id))


def _m_delete_node(parent, args, api):
    try:
        api.db.storage.delete_node(args["id"])
        return True
    except Exception as exc:
        if is_device_fault(exc):
            raise
        return False


def _m_merge_node(parent, args, api):
    inp = args.get("input", args)
    nid = inp.get("id")
    if nid and api.db.storage.has_node(nid):
        return _m_update_node(parent, {"id": nid, "input": inp}, api)
    return _m_create_node(parent, args, api)


def _m_create_relationship(parent, args, api):
    import uuid

    from nornicdb_tpu_torch.storage.types import Edge

    inp = args.get("input", args)
    edge = Edge(
        id=inp.get("id") or str(uuid.uuid4()),
        start_node=inp["startNodeId"],
        end_node=inp["endNodeId"],
        type=inp.get("type", "RELATED"),
        properties=dict(inp.get("properties", {})),
    )
    api.db.storage.create_edge(edge)
    return _rel_obj(api.db.storage.get_edge(edge.id))


def _m_delete_relationship(parent, args, api):
    try:
        api.db.storage.delete_edge(args["id"])
        return True
    except Exception as exc:
        if is_device_fault(exc):
            raise
        return False


def _m_bulk_create_nodes(parent, args, api):
    return [_m_create_node(parent, {"input": item}, api)
            for item in args.get("input", [])]


def _m_bulk_delete_nodes(parent, args, api):
    return sum(1 for nid in args.get("ids", [])
               if _m_delete_node(parent, {"id": nid}, api))


def _m_rebuild_search_index(parent, args, api):
    return api.db.search.build_indexes()


def _q_labels(parent, args, api):
    labels = set()
    for n in api.db.storage.all_nodes():
        labels.update(n.labels)
    return sorted(labels)


def _q_rel_types(parent, args, api):
    return sorted({e.type for e in api.db.storage.all_edges()})


def _q_stats(parent, args, api):
    """Reference: schema.graphql GraphStats (nodeCount,
    relationshipCount, labels, relationshipTypes, embeddedNodeCount)."""
    storage = api.db.storage
    label_counts: Dict[str, int] = {}
    embedded = 0
    for n in storage.all_nodes():
        if n.embedding is not None and len(n.embedding or []):
            embedded += 1
        for lbl in n.labels:
            label_counts[lbl] = label_counts.get(lbl, 0) + 1
    type_counts: Dict[str, int] = {}
    for e in storage.all_edges():
        type_counts[e.type] = type_counts.get(e.type, 0) + 1
    stats = {
        "nodeCount": storage.count_nodes(),
        "relationshipCount": storage.count_edges(),
        "labels": [
            {"label": k, "count": v}
            for k, v in sorted(label_counts.items())
        ],
        "relationshipTypes": [
            {"type": k, "count": v}
            for k, v in sorted(type_counts.items())
        ],
        "embeddedNodeCount": embedded,
    }
    fields = {k: (lambda p, a, _api, _k=k: p[_k]) for k in stats}
    return _Object("GraphStats", fields, stats)


def _q_schema(parent, args, api):
    """Graph schema summary (reference: Query.schema / db.schema.*):
    labels, relationship types, and property keys in use."""
    storage = api.db.storage
    prop_keys = set()
    for n in storage.all_nodes():
        prop_keys.update(n.properties.keys())
    for e in storage.all_edges():
        prop_keys.update(e.properties.keys())
    data = {
        "labels": _q_labels(parent, args, api),
        "relationshipTypes": _q_rel_types(parent, args, api),
        "propertyKeys": sorted(prop_keys),
    }
    fields = {k: (lambda p, a, _api, _k=k: p[_k]) for k in data}
    return _Object("GraphSchema", fields, data)


def _q_search_by_property(parent, args, api):
    limit = int(args.get("limit", 100))
    label = args.get("label")
    key, value = args["property"], args.get("value")
    nodes = (api.db.storage.get_nodes_by_label(label) if label
             else api.db.storage.all_nodes())
    hits = [n for n in nodes if n.properties.get(key) == value]
    return [_node_obj(n) for n in sorted(hits, key=lambda n: n.id)[:limit]]


def _edges_between(storage, a: str, b: str, types=None):
    out = []
    for e in storage.get_node_edges(a, Direction.BOTH):
        if types and e.type not in types:
            continue
        if (e.start_node == a and e.end_node == b) or (
            e.start_node == b and e.end_node == a
        ):
            out.append(e)
    return out


def _q_rels_between(parent, args, api):
    edges = _edges_between(
        api.db.storage, args["startId"], args["endId"], args.get("types"))
    return [_rel_obj(e) for e in sorted(edges, key=lambda e: e.id)]


def _path_obj(storage, node_ids, edges):
    data = {
        "nodes": [_node_obj(storage.get_node(i)) for i in node_ids],
        "relationships": [_rel_obj(e) for e in edges],
        "length": len(edges),
    }
    fields = {k: (lambda p, a, _api, _k=k: p[_k]) for k in data}
    return _Object("Path", fields, data)


def _q_shortest_path(parent, args, api):
    """BFS shortest path (reference: Query.shortestPath; apoc.algo)."""
    storage = api.db.storage
    start, end = args["startId"], args["endId"]
    types = args.get("types")
    if start == end:
        return _path_obj(storage, [start], [])
    prev: Dict[str, Any] = {start: None}
    frontier = [start]
    max_depth = int(args.get("maxDepth", 15))
    for _ in range(max_depth):
        nxt = []
        for nid in frontier:
            for e in storage.get_node_edges(nid, Direction.BOTH):
                if types and e.type not in types:
                    continue
                other = e.end_node if e.start_node == nid else e.start_node
                if other in prev:
                    continue
                prev[other] = (nid, e)
                if other == end:
                    ids, edges = [end], []
                    cur = end
                    while prev[cur] is not None:
                        p, pe = prev[cur]
                        edges.append(pe)
                        ids.append(p)
                        cur = p
                    return _path_obj(
                        storage, list(reversed(ids)),
                        list(reversed(edges)))
                nxt.append(other)
        frontier = nxt
        if not frontier:
            break
    return None


def _q_all_paths(parent, args, api):
    """Bounded DFS path enumeration (reference: Query.allPaths)."""
    storage = api.db.storage
    start, end = args["startId"], args["endId"]
    max_depth = int(args.get("maxDepth", 4))
    limit = int(args.get("limit", 25))
    out = []

    def dfs(nid, path_ids, path_edges, used_edges):
        if len(out) >= limit:
            return
        if nid == end and path_edges:
            out.append(_path_obj(storage, list(path_ids), list(path_edges)))
            return
        if len(path_edges) >= max_depth:
            return
        for e in sorted(storage.get_node_edges(nid, Direction.BOTH),
                        key=lambda e: e.id):
            if e.id in used_edges:
                continue
            other = e.end_node if e.start_node == nid else e.start_node
            if other in path_ids and other != end:
                continue  # simple paths only
            used_edges.add(e.id)
            path_ids.append(other)
            path_edges.append(e)
            dfs(other, path_ids, path_edges, used_edges)
            used_edges.discard(e.id)
            path_ids.pop()
            path_edges.pop()

    dfs(start, [start], [], set())
    return out


def _q_neighborhood(parent, args, api):
    """BFS neighborhood subgraph (reference: Query.neighborhood)."""
    storage = api.db.storage
    depth = int(args.get("depth", 1))
    limit = int(args.get("limit", 100))
    seen = {args["id"]}
    frontier = [args["id"]]
    edges = {}
    for _ in range(depth):
        nxt = []
        for nid in frontier:
            for e in storage.get_node_edges(nid, Direction.BOTH):
                edges[e.id] = e
                other = e.end_node if e.start_node == nid else e.start_node
                if other not in seen and len(seen) < limit:
                    seen.add(other)
                    nxt.append(other)
        frontier = nxt
    data = {
        "nodes": [_node_obj(storage.get_node(i)) for i in sorted(seen)],
        # induced subgraph (reference semantics): only edges with BOTH
        # endpoints inside the returned node set — no dangling endpoints
        # from the limit cap, no edges one hop past `depth`
        "relationships": [
            _rel_obj(e)
            for _, e in sorted(edges.items())
            if e.start_node in seen and e.end_node in seen
        ],
    }
    fields = {k: (lambda p, a, _api, _k=k: p[_k]) for k in data}
    return _Object("Neighborhood", fields, data)


def _m_update_relationship(parent, args, api):
    e = api.db.storage.get_edge(args["id"])
    props = args.get("properties") or {}
    if args.get("replace"):
        e.properties = dict(props)
    else:
        e.properties.update(props)
    api.db.storage.update_edge(e)
    return _rel_obj(api.db.storage.get_edge(args["id"]))


def _m_merge_relationship(parent, args, api):
    """Find-or-create by (start, end, type) (reference:
    Mutation.mergeRelationship)."""
    start = args.get("startId", args.get("startNodeId"))
    end = args.get("endId", args.get("endNodeId"))
    existing = [
        e for e in _edges_between(api.db.storage, start, end, [args["type"]])
        if e.start_node == start
    ]
    if existing:
        e = existing[0]
        if args.get("properties"):
            e.properties.update(args["properties"])
            api.db.storage.update_edge(e)
        return _rel_obj(e)
    return _m_create_relationship(parent, {
        "startNodeId": start, "endNodeId": end, "type": args["type"],
        "properties": args.get("properties", {}),
    }, api)


def _m_bulk_create_relationships(parent, args, api):
    return [
        _m_create_relationship(parent, item, api)
        for item in args.get("relationships", args.get("inputs", []))
    ]


def _m_bulk_delete_relationships(parent, args, api):
    n = 0
    for rid in args.get("ids", []):
        try:
            api.db.storage.delete_edge(rid)
            n += 1
        except Exception as exc:
            if is_device_fault(exc):
                raise
            continue
    return n


def _m_clear_all(parent, args, api):
    """Dangerous full wipe; requires confirm: true (reference:
    Mutation.clearAll)."""
    if not args.get("confirm"):
        raise GraphQLError("clearAll requires confirm: true")
    storage = api.db.storage
    n_edges = 0
    for e in list(storage.all_edges()):
        try:
            storage.delete_edge(e.id)
            n_edges += 1
        except Exception as exc:
            if is_device_fault(exc):
                raise
            pass
    n_nodes = 0
    for n in list(storage.all_nodes()):
        try:
            storage.delete_node(n.id)
            n_nodes += 1
        except Exception as exc:
            if is_device_fault(exc):
                raise
            pass
    return {"nodesDeleted": n_nodes, "relationshipsDeleted": n_edges}


def _m_run_decay(parent, args, api):
    """One decay sweep now (reference: Mutation.runDecay)."""
    scored, archived = api.db.decay.sweep()
    return {"processed": scored, "archived": archived}


def _m_trigger_embedding(parent, args, api):
    """Queue a node for (re-)embedding (reference:
    Mutation.triggerEmbedding)."""
    queue = getattr(api.db, "_embed_queue", None)
    if queue is None:
        return False
    queue.enqueue(args["id"])
    return True


class GraphQLAPI:
    """The NornicDB GraphQL endpoint (reference: pkg/graphql handler.go)."""

    query_fields: Dict[str, Resolver] = {
        "node": _q_node,
        "allNodes": _q_all_nodes,
        "nodes": _q_all_nodes,
        "nodesByLabel": _q_nodes_by_label,
        "nodeCount": lambda p, a, api: api.db.storage.count_nodes(),
        "relationship": lambda p, a, api: _rel_obj(
            api.db.storage.get_edge(a["id"])),
        "allRelationships": lambda p, a, api: [
            _rel_obj(e) for e in sorted(
                api.db.storage.all_edges(), key=lambda e: e.id
            )[:int(a.get("limit", 100))]
        ],
        "relationshipsByType": lambda p, a, api: [
            _rel_obj(e)
            for e in api.db.storage.get_edges_by_type(a["type"])
            [:int(a.get("limit", 100))]
        ],
        "relationshipCount": lambda p, a, api: api.db.storage.count_edges(),
        "relationshipsBetween": _q_rels_between,
        "search": _q_search,
        "searchByProperty": _q_search_by_property,
        "similar": _q_similar,
        "cypher": _q_cypher_readonly,
        "labels": _q_labels,
        "relationshipTypes": _q_rel_types,
        "stats": _q_stats,
        "schema": _q_schema,
        "shortestPath": _q_shortest_path,
        "allPaths": _q_all_paths,
        "neighborhood": _q_neighborhood,
    }
    mutation_fields: Dict[str, Resolver] = {
        "createNode": _m_create_node,
        "updateNode": _m_update_node,
        "deleteNode": _m_delete_node,
        "mergeNode": _m_merge_node,
        "bulkCreateNodes": _m_bulk_create_nodes,
        "bulkDeleteNodes": _m_bulk_delete_nodes,
        "createRelationship": _m_create_relationship,
        "updateRelationship": _m_update_relationship,
        "mergeRelationship": _m_merge_relationship,
        "deleteRelationship": _m_delete_relationship,
        "bulkCreateRelationships": _m_bulk_create_relationships,
        "bulkDeleteRelationships": _m_bulk_delete_relationships,
        "executeCypher": _q_cypher,
        "cypher": _q_cypher,
        "rebuildSearchIndex": _m_rebuild_search_index,
        "clearAll": _m_clear_all,
        "runDecay": _m_run_decay,
        "triggerEmbedding": _m_trigger_embedding,
    }

    def __init__(self, db):
        self.db = db
        self._lock = threading.Lock()

    @staticmethod
    @functools.lru_cache(maxsize=256)
    def parse_cached(query: str) -> Dict[str, Any]:
        """LRU document cache keyed on query text (mirrors the Cypher
        executor's parse cache, executor.py). Safe to share: the
        executor treats parsed documents as read-only. The HTTP route
        parses every document twice (operation_kind for authorization,
        then execute), so repeated documents — the normal client
        pattern — skip both parses."""
        return _Parser(query).parse_document()

    @staticmethod
    def operation_kind(query: str, operation_name: Optional[str]) -> str:
        """Resolve which operation would run — authorization must be
        based on the parsed document (a leading comment or a multi-op
        document defeats any regex on the raw text)."""
        doc = GraphQLAPI.parse_cached(query)
        ops = doc["operations"]
        if not ops:
            raise GraphQLError("no operations in document")
        if operation_name:
            matches = [o for o in ops if o["name"] == operation_name]
            if not matches:
                raise GraphQLError(f"unknown operation {operation_name!r}")
            return matches[0]["operation"]
        if len(ops) == 1:
            return ops[0]["operation"]
        raise GraphQLError("operationName required for multi-op document")

    def execute(
        self,
        query: str,
        variables: Optional[Dict[str, Any]] = None,
        operation_name: Optional[str] = None,
    ) -> Dict[str, Any]:
        try:
            doc = self.parse_cached(query)
            data = _Executor(doc, variables or {}, self).run(operation_name)
            return {"data": data}
        except GraphQLError as e:
            return {"data": None, "errors": [{"message": str(e)}]}
        except Exception as e:  # resolver errors surface as GraphQL errors
            return {"data": None,
                    "errors": [{"message": f"{type(e).__name__}: {e}"}]}


PLAYGROUND_HTML = """<!DOCTYPE html>
<html><head><title>NornicDB GraphQL</title></head>
<body><h1>NornicDB GraphQL</h1>
<p>POST GraphQL documents to this endpoint as
<code>{"query": "...", "variables": {...}}</code>.</p>
<textarea id="q" rows="10" cols="80">{ nodeCount }</textarea><br/>
<button onclick="run()">Run</button><pre id="out"></pre>
<script>
async function run() {
  const r = await fetch(location.pathname, {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({query: document.getElementById('q').value})});
  document.getElementById('out').textContent =
    JSON.stringify(await r.json(), null, 2);
}
</script></body></html>"""
