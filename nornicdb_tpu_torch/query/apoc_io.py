"""APOC IO + orchestration long tail: cypher subqueries, export/import,
load, virtual graphs, triggers, periodic jobs, and per-category
leftovers (map, path, node/rel write forms, search index mgmt, hashing)
(counterpart of ``nornicdb_tpu/query/apoc_io.py``).

Reference: apoc/cypher, apoc/export, apoc/import, apoc/load, apoc/graph,
apoc/trigger, apoc/periodic. External-system loaders (kafka, jdbc, s3,
elasticsearch, ...) mirror the reference's observable behavior: they are
acknowledged placeholders returning empty results (apoc/load/load.go:425
"Placeholder - would consume from Kafka"). The simplified xxhash/cityhash
formulas reproduce the reference's actual outputs
(apoc/hashing/hashing.go:302-360: cityHash64 == fnv1a64; byte-loop
xxhash variants).
"""

from __future__ import annotations

import csv as _csv
import io as _io
import json as _json
import os
import threading
import time as _time
from typing import Any, Dict, Iterator, List, Optional

from nornicdb_tpu_torch.errors import CypherRuntimeError
from nornicdb_tpu_torch.query.apoc import register, register_ctx
from nornicdb_tpu_torch.storage.types import Edge, Node

_U32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1


# -- apoc.cypher ----------------------------------------------------------


def _sub(ctx, statement: str, params: Optional[Dict] = None):
    return ctx.ex._execute_for_trigger(str(statement), params or {})


def _install_cypher() -> None:
    cy = "apoc.cypher."

    register_ctx(cy + "run", lambda ctx, stmt, params=None: [
        rec for rec in _sub(ctx, stmt, params).records()])
    register_ctx(cy + "doIt", lambda ctx, stmt, params=None: [
        rec for rec in _sub(ctx, stmt, params).records()])
    register_ctx(cy + "runFirstColumn",
                 lambda ctx, stmt, params=None, first_only=False: (
                     (vals[0] if vals else None) if first_only
                     else vals)
                 if (vals := _first_col(ctx, stmt, params)) is not None
                 else None)
    register_ctx(cy + "runFirstColumnMany",
                 lambda ctx, stmt, params=None: _first_col(
                     ctx, stmt, params))
    register_ctx(cy + "runFirstColumnSingle",
                 lambda ctx, stmt, params=None: (
                     vals[0] if (vals := _first_col(ctx, stmt, params))
                     else None))

    def _run_many(ctx, statements, params=None):
        out = []
        for i, stmt in enumerate(_split_statements(statements)):
            r = _sub(ctx, stmt, params)
            out.append({"index": i, "rows": [list(row) for row in r.rows],
                        "columns": list(r.columns)})
        return out

    register_ctx(cy + "runMany", _run_many)

    def _run_file(ctx, path):
        with open(str(path), "r", encoding="utf-8") as f:
            return _run_many(ctx, f.read())

    register_ctx(cy + "runFile", _run_file)

    register_ctx(cy + "toJson", lambda ctx, stmt, params=None: _json.dumps(
        [_jsonable(rec) for rec in _sub(ctx, stmt, params).records()]))
    register_ctx(cy + "toList", lambda ctx, stmt, params=None: [
        list(row) for row in _sub(ctx, stmt, params).rows])
    register_ctx(cy + "toMap", lambda ctx, stmt, params=None: (
        recs[0] if (recs := _sub(ctx, stmt, params).records()) else {}))

    def _explain(ctx, stmt):
        r = ctx.ex.execute(f"EXPLAIN {stmt}")
        return r.plan

    register_ctx(cy + "explain", _explain)

    def _profile(ctx, stmt, params=None):
        r = ctx.ex.execute(f"PROFILE {stmt}", params or {})
        return r.plan

    register_ctx(cy + "profile", _profile)

    def _parse(ctx, stmt):
        from nornicdb_tpu_torch.query.parser import parse

        uq = parse(str(stmt))
        return {"parts": len(uq.parts),
                "clauses": [type(c).__name__ for p in uq.parts
                            for c in p.clauses]}

    register_ctx(cy + "parse", _parse)

    def _validate(ctx, stmt):
        from nornicdb_tpu_torch.query.strict import validate

        return [{"severity": d.severity, "message": d.message,
                 "line": d.line, "column": d.column}
                for d in validate(str(stmt))]

    register_ctx(cy + "validate", _validate)

    # parallel forms execute sequentially here: correctness first; the
    # data plane parallelism lives in the columnar/vectorized engine
    register_ctx(cy + "parallel", lambda ctx, stmt, params_list=None,
                 key="value": [
                     {"value": rec} for p in (params_list or [{}])
                     for rec in _sub(ctx, stmt, p if isinstance(p, dict)
                                     else {key: p}).records()])
    register_ctx(cy + "mapParallel", lambda ctx, stmt, items=None: [
        rec for item in (items or [])
        for rec in _sub(ctx, stmt, {"_": item}).records()])


def _first_col(ctx, stmt, params) -> List[Any]:
    r = _sub(ctx, stmt, params)
    return [row[0] for row in r.rows] if r.columns else []


def _split_statements(text: Any) -> List[str]:
    if isinstance(text, list):
        return [str(s) for s in text if str(s).strip()]
    return [s.strip() for s in str(text).split(";") if s.strip()]


def _jsonable(v: Any) -> Any:
    if isinstance(v, Node):
        return {"id": v.id, "labels": list(v.labels),
                "properties": _jsonable(v.properties)}
    if isinstance(v, Edge):
        return {"id": v.id, "type": v.type, "start": v.start_node,
                "end": v.end_node, "properties": _jsonable(v.properties)}
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# -- apoc.export / apoc.import / apoc.load --------------------------------


def _all_graph(ctx):
    return list(ctx.storage.all_nodes()), list(ctx.storage.all_edges())


def _nodes_csv(nodes: List[Node]) -> str:
    keys = sorted({k for n in nodes for k in n.properties})
    buf = _io.StringIO()
    w = _csv.writer(buf)
    w.writerow(["_id", "_labels"] + keys)
    for n in nodes:
        w.writerow([n.id, ";".join(n.labels)]
                   + [_csv_val(n.properties.get(k)) for k in keys])
    return buf.getvalue()


def _rels_csv(rels: List[Edge]) -> str:
    keys = sorted({k for e in rels for k in e.properties})
    buf = _io.StringIO()
    w = _csv.writer(buf)
    w.writerow(["_id", "_type", "_start", "_end"] + keys)
    for e in rels:
        w.writerow([e.id, e.type, e.start_node, e.end_node]
                   + [_csv_val(e.properties.get(k)) for k in keys])
    return buf.getvalue()


def _csv_val(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, (list, dict)):
        return _json.dumps(v)
    return str(v)


def _graph_json(nodes: List[Node], rels: List[Edge]) -> str:
    rows = [_json.dumps({"type": "node", **_jsonable(n)}) for n in nodes]
    for e in rels:
        d = _jsonable(e)
        d["relType"] = d.pop("type")  # row kind key takes "type"
        d["type"] = "relationship"
        rows.append(_json.dumps(d))
    return "\n".join(rows)


def _graph_cypher(nodes: List[Node], rels: List[Edge]) -> str:
    lines = []
    for n in nodes:
        labels = "".join(f":`{l}`" for l in n.labels)
        props = {**n.properties, "_import_id": n.id}
        lines.append(f"CREATE ({labels} {_cy_map(props)});")
    for e in rels:
        lines.append(
            f"MATCH (a {{_import_id: {_json.dumps(e.start_node)}}}), "
            f"(b {{_import_id: {_json.dumps(e.end_node)}}}) "
            f"CREATE (a)-[:`{e.type}` {_cy_map(e.properties)}]->(b);")
    return "\n".join(lines)


def _cy_map(props: Dict[str, Any]) -> str:
    if not props:
        return "{}"
    parts = [f"`{k}`: {_json.dumps(v)}" for k, v in sorted(props.items())]
    return "{" + ", ".join(parts) + "}"


def _graph_graphml(nodes: List[Node], rels: List[Edge]) -> str:
    from xml.sax.saxutils import escape, quoteattr

    out = ['<?xml version="1.0" encoding="UTF-8"?>',
           '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">',
           '<graph id="G" edgedefault="directed">']
    for n in nodes:
        out.append(f"<node id={quoteattr(n.id)} "
                   f"labels={quoteattr(':'.join(n.labels))}>")
        for k, v in sorted(n.properties.items()):
            out.append(f"<data key={quoteattr(k)}>"
                       f"{escape(_csv_val(v))}</data>")
        out.append("</node>")
    for e in rels:
        out.append(f"<edge id={quoteattr(e.id)} "
                   f"source={quoteattr(e.start_node)} "
                   f"target={quoteattr(e.end_node)} "
                   f"label={quoteattr(e.type)}>")
        for k, v in sorted(e.properties.items()):
            out.append(f"<data key={quoteattr(k)}>"
                       f"{escape(_csv_val(v))}</data>")
        out.append("</edge>")
    out.append("</graph></graphml>")
    return "\n".join(out)


def _install_export() -> None:
    ex = "apoc.export."

    def _pick(ctx, nodes=None, rels=None):
        if nodes is None and rels is None:
            return _all_graph(ctx)
        return ([x for x in (nodes or []) if isinstance(x, Node)],
                [e for e in (rels or []) if isinstance(e, Edge)])

    register_ctx(ex + "csv", lambda ctx, nodes=None, rels=None: (
        lambda g: {"nodes": _nodes_csv(g[0]), "relationships":
                   _rels_csv(g[1])})(_pick(ctx, nodes, rels)))
    def _csv_all(ctx):
        nodes, rels = _all_graph(ctx)
        return {"nodes": _nodes_csv(nodes), "relationships":
                _rels_csv(rels)}

    register_ctx(ex + "csvAll", _csv_all)
    register_ctx(ex + "csvData", lambda ctx, nodes, rels: {
        "nodes": _nodes_csv([x for x in (nodes or [])
                             if isinstance(x, Node)]),
        "relationships": _rels_csv([e for e in (rels or [])
                                    if isinstance(e, Edge)])})
    register_ctx(ex + "json", lambda ctx, nodes=None, rels=None:
                 _graph_json(*_pick(ctx, nodes, rels)))
    register_ctx(ex + "jsonAll", lambda ctx: _graph_json(*_all_graph(ctx)))
    register_ctx(ex + "jsonData", lambda ctx, nodes, rels: _graph_json(
        [x for x in (nodes or []) if isinstance(x, Node)],
        [e for e in (rels or []) if isinstance(e, Edge)]))
    register_ctx(ex + "cypher", lambda ctx, nodes=None, rels=None:
                 _graph_cypher(*_pick(ctx, nodes, rels)))
    register_ctx(ex + "cypherAll", lambda ctx: _graph_cypher(
        *_all_graph(ctx)))
    register_ctx(ex + "cypherData", lambda ctx, nodes, rels: _graph_cypher(
        [x for x in (nodes or []) if isinstance(x, Node)],
        [e for e in (rels or []) if isinstance(e, Edge)]))
    register_ctx(ex + "graphml", lambda ctx, nodes=None, rels=None:
                 _graph_graphml(*_pick(ctx, nodes, rels)))
    register_ctx(ex + "graphmlAll", lambda ctx: _graph_graphml(
        *_all_graph(ctx)))
    register_ctx(ex + "graphmlData", lambda ctx, nodes, rels:
                 _graph_graphml(
                     [x for x in (nodes or []) if isinstance(x, Node)],
                     [e for e in (rels or []) if isinstance(e, Edge)]))
    register_ctx(ex + "toString", lambda ctx, fmt="json": (
        _graph_json(*_all_graph(ctx)) if fmt == "json"
        else _graph_cypher(*_all_graph(ctx)) if fmt == "cypher"
        else _graph_graphml(*_all_graph(ctx)) if fmt == "graphml"
        else _nodes_csv(_all_graph(ctx)[0])))

    def _to_file(ctx, path, fmt="json"):
        content = {
            "json": lambda: _graph_json(*_all_graph(ctx)),
            "cypher": lambda: _graph_cypher(*_all_graph(ctx)),
            "graphml": lambda: _graph_graphml(*_all_graph(ctx)),
        }.get(str(fmt))
        if content is None:
            raise CypherRuntimeError(f"unknown export format {fmt!r}")
        text = content()
        with open(str(path), "w", encoding="utf-8") as f:
            f.write(text)
        return {"file": str(path), "bytes": len(text.encode())}

    register_ctx(ex + "toFile", _to_file)


def _install_import_load() -> None:
    im = "apoc.import."

    def _import_json_rows(ctx, rows):
        id_map: Dict[str, str] = {}
        nodes = rels = 0
        pending_rels = []
        from nornicdb_tpu_torch.query.apoc_admin import _fresh_edge, _fresh_node

        for row in rows:
            if not isinstance(row, dict):
                continue
            kind = row.get("type")
            if kind == "node":
                node = _fresh_node(ctx, row.get("labels") or [],
                                   row.get("properties") or {})
                if row.get("id") is not None:
                    id_map[str(row["id"])] = node.id
                nodes += 1
            elif kind == "relationship":
                pending_rels.append(row)
        for row in pending_rels:
            start = id_map.get(str(row.get("start")), str(row.get("start")))
            end = id_map.get(str(row.get("end")), str(row.get("end")))
            _fresh_edge(ctx, row.get("relType") or row.get("label")
                        or "RELATED",
                        start, end, row.get("properties") or {})
            rels += 1
        return {"nodes": nodes, "relationships": rels}

    def _import_json(ctx, text):
        rows = []
        for line in str(text).splitlines():
            line = line.strip()
            if line:
                rows.append(_json.loads(line))
        return _import_json_rows(ctx, rows)

    register_ctx(im + "json", _import_json)
    register_ctx(im + "jsonData", lambda ctx, rows: _import_json_rows(
        ctx, rows or []))

    def _import_csv(ctx, nodes_csv, rels_csv=None):
        from nornicdb_tpu_torch.query.apoc_admin import _fresh_edge, _fresh_node

        id_map: Dict[str, str] = {}
        n_nodes = n_rels = 0
        for rec in _csv.DictReader(_io.StringIO(str(nodes_csv))):
            labels = [l for l in (rec.pop("_labels", "") or "").split(";")
                      if l]
            ext_id = rec.pop("_id", None)
            node = _fresh_node(ctx, labels,
                               {k: v for k, v in rec.items() if v != ""})
            if ext_id:
                id_map[ext_id] = node.id
            n_nodes += 1
        if rels_csv:
            for rec in _csv.DictReader(_io.StringIO(str(rels_csv))):
                etype = rec.pop("_type", "RELATED")
                start = id_map.get(rec.pop("_start", ""), "")
                end = id_map.get(rec.pop("_end", ""), "")
                rec.pop("_id", None)
                if start and end:
                    _fresh_edge(ctx, etype, start, end,
                                {k: v for k, v in rec.items() if v != ""})
                    n_rels += 1
        return {"nodes": n_nodes, "relationships": n_rels}

    register_ctx(im + "csv", _import_csv)
    register_ctx(im + "csvData", _import_csv)

    def _import_cypher(ctx, script):
        n = 0
        for stmt in _split_statements(script):
            _sub(ctx, stmt)
            n += 1
        return {"statements": n}

    register_ctx(im + "cypher", _import_cypher)
    register_ctx(im + "cypherData", _import_cypher)

    def _import_graphml(ctx, text):
        import xml.etree.ElementTree as ET

        from nornicdb_tpu_torch.query.apoc_admin import _fresh_edge, _fresh_node

        ns = {"g": "http://graphml.graphdrawing.org/xmlns"}
        root = ET.fromstring(str(text))
        id_map: Dict[str, str] = {}
        n_nodes = n_rels = 0
        for el in root.iter("{http://graphml.graphdrawing.org/xmlns}node"):
            props = {d.get("key"): d.text or ""
                     for d in el.findall("g:data", ns)}
            labels = [l for l in (el.get("labels") or "").split(":") if l]
            node = _fresh_node(ctx, labels, props)
            id_map[el.get("id") or node.id] = node.id
            n_nodes += 1
        for el in root.iter("{http://graphml.graphdrawing.org/xmlns}edge"):
            props = {d.get("key"): d.text or ""
                     for d in el.findall("g:data", ns)}
            start = id_map.get(el.get("source") or "")
            end = id_map.get(el.get("target") or "")
            if start and end:
                _fresh_edge(ctx, el.get("label") or "RELATED", start, end,
                            props)
                n_rels += 1
        return {"nodes": n_nodes, "relationships": n_rels}

    register_ctx(im + "graphml", _import_graphml)
    register_ctx(im + "graphmlData", _import_graphml)

    def _import_file(ctx, path):
        text = open(str(path), "r", encoding="utf-8").read()
        p = str(path).lower()
        if p.endswith(".json") or p.endswith(".jsonl"):
            return _import_json(ctx, text)
        if p.endswith(".graphml") or p.endswith(".xml"):
            return _import_graphml(ctx, text)
        if p.endswith(".cypher") or p.endswith(".cql"):
            return _import_cypher(ctx, text)
        if p.endswith(".csv"):
            return _import_csv(ctx, text)
        raise CypherRuntimeError(f"unknown import format for {path!r}")

    register_ctx(im + "file", _import_file)
    register_ctx(im + "stream", lambda ctx, rows: _import_json_rows(
        ctx, rows or []))
    register_ctx(im + "batch", lambda ctx, batches: [
        _import_json_rows(ctx, b or []) for b in (batches or [])])

    register(im + "parseCsvLine", lambda line, sep=",": next(
        _csv.reader(_io.StringIO(str(line)), delimiter=str(sep)), []))
    register(im + "parseJsonLine", lambda line: _json.loads(str(line)))

    def _convert_type(value, typ):
        t = str(typ).lower()
        if value is None or value == "":
            return None
        if t in ("int", "integer", "long"):
            return int(float(value))
        if t in ("float", "double"):
            return float(value)
        if t in ("bool", "boolean"):
            return str(value).lower() in ("true", "1", "yes")
        if t == "string":
            return str(value)
        raise CypherRuntimeError(f"unknown type {typ!r}")

    register(im + "convertType", _convert_type)
    register(im + "transform", lambda rows, mapping: [
        {mapping.get(k, k): v for k, v in (row or {}).items()}
        for row in (rows or [])])
    register(im + "filter", lambda rows, key, value: [
        row for row in (rows or []) if (row or {}).get(key) == value])
    register(im + "merge", lambda a, b: list(a or []) + list(b or []))

    def _validate_schema(rows, schema):
        errors = []
        for i, row in enumerate(rows or []):
            for key, typ in (schema or {}).items():
                if key not in (row or {}):
                    errors.append(f"row {i}: missing {key!r}")
                    continue
                try:
                    _convert_type(row[key], typ)
                except (ValueError, CypherRuntimeError):
                    errors.append(
                        f"row {i}: {key!r} not coercible to {typ}")
        return {"valid": not errors, "errors": errors}

    register(im + "validateSchema", _validate_schema)
    register(im + "url", lambda url: _egress_placeholder("import.url"))

    ld = "apoc.load."
    register(ld + "csv", lambda text, sep=",": [
        dict(rec) for rec in _csv.DictReader(
            _io.StringIO(str(text)), delimiter=str(sep))])
    register(ld + "csvStream", lambda text, sep=",": [
        row for row in _csv.reader(_io.StringIO(str(text)),
                                   delimiter=str(sep))])
    register(ld + "json", lambda text: _json.loads(str(text)))
    register(ld + "jsonArray", lambda text: (
        v if isinstance(v := _json.loads(str(text)), list) else [v]))
    register(ld + "jsonStream", lambda text: [
        _json.loads(line) for line in str(text).splitlines()
        if line.strip()])
    register(ld + "jsonParams", lambda text, params: _json.loads(
        str(text) % (params or {})))

    def _json_schema(value):
        if isinstance(value, dict):
            return {k: _json_schema(v) for k, v in value.items()}
        if isinstance(value, list):
            return [_json_schema(value[0])] if value else []
        return type(value).__name__

    register(ld + "jsonSchema", lambda text: _json_schema(
        _json.loads(str(text)) if isinstance(text, str) else text))

    def _load_xml(text, simple=False):
        from nornicdb_tpu_torch.query.apoc import APOC_FUNCS

        return APOC_FUNCS["apoc.xml.parse"](text)

    register(ld + "xml", _load_xml)
    register(ld + "xmlSimple", lambda text: _load_xml(text, simple=True))

    def _load_html(text):
        """Tag-stripping text extraction + link/title capture (the
        reference parses with a full HTML parser; this covers the
        common scrape fields)."""
        import re as _re

        s = str(text)
        title = _re.search(r"<title[^>]*>(.*?)</title>", s,
                           _re.IGNORECASE | _re.DOTALL)
        links = _re.findall(r'href=["\']([^"\']+)["\']', s)
        body = _re.sub(r"<script.*?</script>|<style.*?</style>", " ", s,
                       flags=_re.DOTALL | _re.IGNORECASE)
        body = _re.sub(r"<[^>]+>", " ", body)
        return {"title": title.group(1).strip() if title else None,
                "links": links,
                "text": " ".join(body.split())}

    register(ld + "html", _load_html)

    def _load_directory(path, pattern="*"):
        import fnmatch

        out = []
        for name in sorted(os.listdir(str(path))):
            if fnmatch.fnmatch(name, str(pattern)):
                full = os.path.join(str(path), name)
                out.append({"name": name, "path": full,
                            "isDirectory": os.path.isdir(full),
                            "size": os.path.getsize(full)
                            if os.path.isfile(full) else 0})
        return out

    register(ld + "directory", _load_directory)

    def _load_tree(path, max_depth=5):
        out = []

        def walk(p, depth):
            if depth > int(max_depth):
                return
            for name in sorted(os.listdir(p)):
                full = os.path.join(p, name)
                out.append({"path": full, "depth": depth,
                            "isDirectory": os.path.isdir(full)})
                if os.path.isdir(full):
                    walk(full, depth + 1)

        walk(str(path), 0)
        return out

    register(ld + "directoryTree", _load_tree)
    register(ld + "stream", lambda path: open(
        str(path), "r", encoding="utf-8").read())
    register(ld + "binary", lambda path: list(
        open(str(path), "rb").read()))

    # external systems: acknowledged placeholders, the reference's own
    # behavior (apoc/load/load.go "Placeholder - would ...")
    for external in ("kafka", "redis", "elasticsearch", "jdbc",
                     "jdbcUpdate", "s3", "gcs", "azure", "rest",
                     "graphql", "ldap", "arrow", "avro", "parquet",
                     "driver"):
        register(ld + external,
                 (lambda name: lambda *args: _egress_placeholder(name))
                 (external))


def _egress_placeholder(name: str) -> List[Any]:
    """Reference parity: external-system loaders return empty result
    sets (no egress in this environment either way)."""
    return []


# -- apoc.graph (virtual graphs) ------------------------------------------


def _vgraph(nodes, rels, name="virtual") -> Dict[str, Any]:
    return {"name": name,
            "nodes": [x for x in (nodes or []) if isinstance(x, Node)],
            "relationships": [e for e in (rels or [])
                              if isinstance(e, Edge)]}


def _install_graph() -> None:
    g = "apoc.graph."
    register(g + "from", lambda nodes, rels, name="virtual": _vgraph(
        nodes, rels, name))
    register(g + "fromData", lambda nodes, rels, name="virtual": _vgraph(
        nodes, rels, name))

    def _from_paths(paths, name="virtual"):
        from nornicdb_tpu_torch.query.functions import PathValue

        nodes: Dict[str, Node] = {}
        rels: Dict[str, Edge] = {}
        for p in paths if isinstance(paths, list) else [paths]:
            if isinstance(p, PathValue):
                for n in p.nodes:
                    nodes[n.id] = n
                for e in p.rels:
                    rels[e.id] = e
        return _vgraph(list(nodes.values()), list(rels.values()), name)

    register(g + "fromPath", _from_paths)
    register(g + "fromPaths", _from_paths)

    def _from_document(doc, name="virtual"):
        """JSON document -> virtual graph: maps become nodes, nested
        maps/lists become CONTAINS relationships."""
        import uuid as _uuid

        doc = _json.loads(doc) if isinstance(doc, str) else doc
        nodes: List[Node] = []
        rels: List[Edge] = []

        def visit(value, label) -> Optional[Node]:
            if not isinstance(value, dict):
                return None
            scalars = {k: v for k, v in value.items()
                       if not isinstance(v, (dict, list))}
            node = Node(id=f"vnode-{_uuid.uuid4()}",
                        labels=[str(label)], properties=scalars)
            nodes.append(node)
            for k, v in value.items():
                children = v if isinstance(v, list) else [v]
                for child in children:
                    sub = visit(child, k)
                    if sub is not None:
                        rels.append(Edge(
                            id=f"vrel-{_uuid.uuid4()}", type=k.upper(),
                            start_node=node.id, end_node=sub.id,
                            properties={}))
            return node

        visit(doc, (doc or {}).get("type", "Document")
              if isinstance(doc, dict) else "Document")
        return _vgraph(nodes, rels, name)

    register(g + "fromDocument", _from_document)
    register(g + "fromMap", _from_document)

    def _from_cypher(ctx, stmt, params=None, name="virtual"):
        recs = _sub(ctx, stmt, params).records()  # executed ONCE
        return _vgraph(
            [v for rec in recs for v in rec.values()
             if isinstance(v, Node)],
            [v for rec in recs for v in rec.values()
             if isinstance(v, Edge)],
            name)

    register_ctx(g + "fromCypher", _from_cypher)

    register(g + "nodes", lambda graph: list((graph or {}).get(
        "nodes", [])))
    register(g + "relationships", lambda graph: list((graph or {}).get(
        "relationships", [])))
    register(g + "stats", lambda graph: {
        "nodeCount": len((graph or {}).get("nodes", [])),
        "relCount": len((graph or {}).get("relationships", [])),
        "labels": sorted({l for n in (graph or {}).get("nodes", [])
                          for l in n.labels})})
    register(g + "toMap", lambda graph: {
        "name": (graph or {}).get("name"),
        "nodes": [_jsonable(n) for n in (graph or {}).get("nodes", [])],
        "relationships": [_jsonable(e) for e in (graph or {}).get(
            "relationships", [])]})

    def _validate_graph(graph):
        ids = {n.id for n in (graph or {}).get("nodes", [])}
        dangling = [e.id for e in (graph or {}).get("relationships", [])
                    if e.start_node not in ids or e.end_node not in ids]
        return {"valid": not dangling, "danglingRelationships": dangling}

    register(g + "validate", _validate_graph)
    register(g + "clone", lambda graph: {
        "name": (graph or {}).get("name"),
        "nodes": list((graph or {}).get("nodes", [])),
        "relationships": list((graph or {}).get("relationships", []))})

    def _merge_graphs(a, b):
        nodes = {n.id: n for n in list((a or {}).get("nodes", []))
                 + list((b or {}).get("nodes", []))}
        rels = {e.id: e for e in list((a or {}).get("relationships", []))
                + list((b or {}).get("relationships", []))}
        return _vgraph(list(nodes.values()), list(rels.values()),
                       (a or {}).get("name", "virtual"))

    register(g + "merge", _merge_graphs)

    def _subgraph(graph, node_ids):
        keep = {str(i) for i in (node_ids or [])}
        nodes = [n for n in (graph or {}).get("nodes", [])
                 if n.id in keep]
        ids = {n.id for n in nodes}
        rels = [e for e in (graph or {}).get("relationships", [])
                if e.start_node in ids and e.end_node in ids]
        return _vgraph(nodes, rels, (graph or {}).get("name", "virtual"))

    register(g + "subgraph", _subgraph)

    def _graph_clone_ctx(ctx):
        nodes, rels = _all_graph(ctx)
        return _vgraph(nodes, rels, "snapshot")

    register_ctx(g + "fromStore", _graph_clone_ctx)
    register_ctx(g + "snapshot", _graph_clone_ctx)


# -- triggers, periodic, leftovers ----------------------------------------


class _JobRegistry:
    """apoc.periodic.* background jobs (submit/repeat/countdown)."""

    def __init__(self):
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def submit(self, name: str, kind: str, meta: Dict[str, Any]):
        with self._lock:
            self.jobs[name] = {"name": name, "kind": kind,
                               "submitted": _time.time(),
                               "cancelled": False, **meta}
            return dict(self.jobs[name])

    def cancel(self, name: str) -> bool:
        with self._lock:
            job = self.jobs.get(name)
            if job is None:
                return False
            job["cancelled"] = True
            timer = job.get("_timer")
        if timer is not None:
            timer.cancel()
        return True

    def list(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{k: v for k, v in j.items()
                     if not k.startswith("_")}
                    for j in self.jobs.values()]


JOBS = _JobRegistry()


def _install_trigger_periodic() -> None:
    tr = "apoc.trigger."

    def _registry(ctx):
        return ctx.ex.triggers

    def _add(ctx, name, statement, selector=None, phase="after"):
        t = _registry(ctx).add(str(name), str(statement), selector)
        t["phase"] = phase
        return dict(t)

    register_ctx(tr + "add", _add)
    register_ctx(tr + "install", _add)
    register_ctx(tr + "after", lambda ctx, name, stmt, sel=None: _add(
        ctx, name, stmt, sel, "after"))
    register_ctx(tr + "afterAsync", lambda ctx, name, stmt, sel=None:
                 _add(ctx, name, stmt, sel, "after"))
    register_ctx(tr + "before", lambda ctx, name, stmt, sel=None: _add(
        ctx, name, stmt, sel, "before"))
    register_ctx(tr + "onCreate", lambda ctx, name, stmt: _add(
        ctx, name, stmt, {"event": "create"}))
    register_ctx(tr + "onDelete", lambda ctx, name, stmt: _add(
        ctx, name, stmt, {"event": "delete"}))
    register_ctx(tr + "onUpdate", lambda ctx, name, stmt: _add(
        ctx, name, stmt, {"event": "update"}))
    register_ctx(tr + "remove", lambda ctx, name: _registry(ctx).remove(
        str(name)) is not None)
    register_ctx(tr + "drop", lambda ctx, name: _registry(ctx).remove(
        str(name)) is not None)
    register_ctx(tr + "removeAll", lambda ctx: _registry(
        ctx).remove_all())
    register_ctx(tr + "list", lambda ctx: [
        dict(t) for t in _registry(ctx).triggers.values()])
    register_ctx(tr + "show", lambda ctx: [
        dict(t) for t in _registry(ctx).triggers.values()])
    register_ctx(tr + "count", lambda ctx: len(_registry(ctx).triggers))
    register_ctx(tr + "pause", lambda ctx, name: dict(
        _registry(ctx).set_paused(str(name), True) or {}))
    register_ctx(tr + "resume", lambda ctx, name: dict(
        _registry(ctx).set_paused(str(name), False) or {}))
    register_ctx(tr + "disable", lambda ctx, name: dict(
        _registry(ctx).set_paused(str(name), True) or {}))
    register_ctx(tr + "enable", lambda ctx, name: dict(
        _registry(ctx).set_paused(str(name), False) or {}))
    register_ctx(tr + "isEnabled", lambda ctx, name: (
        (t := _registry(ctx).triggers.get(str(name))) is not None
        and not t["paused"]))
    register_ctx(tr + "stats", lambda ctx: {
        "count": len(_registry(ctx).triggers),
        "paused": sum(1 for t in _registry(ctx).triggers.values()
                      if t["paused"])})
    register_ctx(tr + "export", lambda ctx: [
        dict(t) for t in _registry(ctx).triggers.values()])

    def _import_triggers(ctx, data):
        n = 0
        for t in data or []:
            _registry(ctx).add(t["name"], t["statement"],
                               t.get("selector"))
            n += 1
        return n

    register_ctx(tr + "import", _import_triggers)
    register_ctx(tr + "nodeByLabel", lambda ctx, name, label, stmt: _add(
        ctx, name, stmt, {"label": label}))
    register_ctx(tr + "relationshipByType", lambda ctx, name, etype,
                 stmt: _add(ctx, name, stmt, {"relType": etype}))

    pd = "apoc.periodic."
    register(pd + "list", lambda: JOBS.list())
    register(pd + "cancel", lambda name: JOBS.cancel(str(name)))
    register(pd + "submit", lambda name, statement: JOBS.submit(
        str(name), "submit", {"statement": str(statement),
                              "state": "registered"}))
    register(pd + "repeat", lambda name, statement, interval_s: JOBS.
             submit(str(name), "repeat", {
                 "statement": str(statement),
                 "intervalSeconds": float(interval_s),
                 "state": "registered"}))
    register(pd + "schedule", lambda name, statement, delay_s: JOBS.
             submit(str(name), "schedule", {
                 "statement": str(statement),
                 "delaySeconds": float(delay_s), "state": "registered"}))
    register(pd + "countdown", lambda name, statement, count: JOBS.
             submit(str(name), "countdown", {
                 "statement": str(statement), "remaining": int(count),
                 "state": "registered"}))
    register(pd + "rock", lambda: {"rocked": True})  # reference easter egg

    def _truncate(ctx, batch_size=1000):
        deleted = 0
        while True:
            batch = []
            for i, node in enumerate(ctx.storage.all_nodes()):
                if i >= int(batch_size):
                    break
                batch.append(node.id)
            if not batch:
                break
            for nid in batch:
                ctx.storage.delete_node(nid)
                deleted += 1
        ctx.stats.nodes_deleted += deleted
        ctx.non_create_writes = True
        return {"deleted": deleted}

    register_ctx(pd + "truncate", _truncate)


def _install_leftovers() -> None:
    # map leftovers
    mp = "apoc.map."
    register(mp + "get", lambda m, key, default=None: (
        (m or {}).get(key, default)))
    register(mp + "dropNullValues",
             lambda m: {k: v for k, v in (m or {}).items()
                        if v is not None})
    register(mp + "removeKeys", lambda m, keys: {
        k: v for k, v in (m or {}).items() if k not in (keys or [])})
    register(mp + "mergeList", lambda maps: {
        k: v for m in (maps or []) for k, v in (m or {}).items()})
    register(mp + "setLists", lambda keys, values: {
        str(k): v for k, v in zip(keys or [], values or [])})
    register(mp + "setPairs", lambda pairs: {
        str(p[0]): (p[1] if len(p) > 1 else None)
        for p in (pairs or [])})
    register(mp + "setValues", lambda m, pairs: {
        **(m or {}), **{str(p[0]): (p[1] if len(p) > 1 else None)
                        for p in (pairs or [])}})

    def _unflatten_map(flat, sep="."):
        out: Dict[str, Any] = {}
        for key, value in (flat or {}).items():
            cur = out
            parts = str(key).split(str(sep))
            for part in parts[:-1]:
                nxt = cur.get(part)
                if not isinstance(nxt, dict):
                    nxt = {}
                    cur[part] = nxt
                cur = nxt
            cur[parts[-1]] = value
        return out

    register(mp + "unflatten", _unflatten_map)

    def _update_tree(tree, key, value):
        import copy

        out = copy.deepcopy(tree or {})

        def walk(m):
            if isinstance(m, dict):
                if key in m:
                    m[key] = value
                for v in m.values():
                    walk(v)
            elif isinstance(m, list):
                for v in m:
                    walk(v)

        walk(out)
        return out

    register(mp + "updateTree", _update_tree)

    # node/rel write forms (delegate to the admin impls' semantics)
    from nornicdb_tpu_torch.query.apoc import APOC_CTX_FUNCS

    nd = "apoc.node."
    register_ctx(nd + "addLabel", lambda ctx, x, l: APOC_CTX_FUNCS[
        "apoc.create.addlabels"](ctx, x, [l]))
    register_ctx(nd + "addLabels", lambda ctx, x, ls: APOC_CTX_FUNCS[
        "apoc.create.addlabels"](ctx, x, ls))
    register_ctx(nd + "removeLabel", lambda ctx, x, l: APOC_CTX_FUNCS[
        "apoc.create.removelabels"](ctx, x, [l]))
    register_ctx(nd + "removeLabels", lambda ctx, x, ls: APOC_CTX_FUNCS[
        "apoc.create.removelabels"](ctx, x, ls))
    register_ctx(nd + "setProperty", lambda ctx, x, k, v: APOC_CTX_FUNCS[
        "apoc.create.setproperty"](ctx, x, k, v))
    register_ctx(nd + "setProperties", lambda ctx, x, m: APOC_CTX_FUNCS[
        "apoc.create.setproperties"](ctx, x, m))
    register_ctx(nd + "removeProperty", lambda ctx, x, k: APOC_CTX_FUNCS[
        "apoc.create.removeproperties"](ctx, x, [k]))
    register_ctx(nd + "removeProperties", lambda ctx, x, ks:
                 APOC_CTX_FUNCS["apoc.create.removeproperties"](
                     ctx, x, ks))

    def _node_clone(ctx, x):
        return APOC_CTX_FUNCS["apoc.create.clone"](ctx, x)

    register_ctx(nd + "clone", _node_clone)

    def _node_from_map(ctx, m):
        from nornicdb_tpu_torch.query.apoc_admin import _fresh_node

        m = dict(m or {})
        labels = m.pop("_labels", m.pop("labels", []))
        props = m.get("properties", m)
        if "properties" in m:
            props = m["properties"]
        return _fresh_node(ctx, labels, props)

    register_ctx(nd + "fromMap", _node_from_map)

    rl = "apoc.rel."
    register_ctx(rl + "setProperty", lambda ctx, x, k, v: APOC_CTX_FUNCS[
        "apoc.create.setproperty"](ctx, x, k, v))
    register_ctx(rl + "setProperties", lambda ctx, x, m: APOC_CTX_FUNCS[
        "apoc.create.setproperties"](ctx, x, m))
    register_ctx(rl + "removeProperty", lambda ctx, x, k: APOC_CTX_FUNCS[
        "apoc.create.removeproperties"](ctx, x, [k]))
    register_ctx(rl + "removeProperties", lambda ctx, x, ks:
                 APOC_CTX_FUNCS["apoc.create.removeproperties"](
                     ctx, x, ks))

    def _rel_clone(ctx, e):
        from nornicdb_tpu_torch.query.apoc_admin import _fresh_edge

        if not isinstance(e, Edge):
            raise CypherRuntimeError("apoc.rel.clone expects a rel")
        return _fresh_edge(ctx, e.type, e.start_node, e.end_node,
                           e.properties)

    register_ctx(rl + "clone", _rel_clone)

    def _rel_delete(ctx, e):
        if not isinstance(e, Edge):
            raise CypherRuntimeError("apoc.rel.delete expects a rel")
        ctx.storage.delete_edge(e.id)
        ctx.stats.relationships_deleted += 1
        ctx.non_create_writes = True
        return True

    register_ctx(rl + "delete", _rel_delete)

    def _rel_from_map(ctx, m):
        from nornicdb_tpu_torch.query.apoc_admin import _fresh_edge

        m = dict(m or {})
        return _fresh_edge(ctx, m.get("type", "RELATED"),
                           str(m.get("start")), str(m.get("end")),
                           m.get("properties") or {})

    register_ctx(rl + "fromMap", _rel_from_map)

    # label write forms
    lb = "apoc.label."
    register_ctx(lb + "add", lambda ctx, x, l: APOC_CTX_FUNCS[
        "apoc.create.addlabels"](ctx, x, [l]))
    register_ctx(lb + "remove", lambda ctx, x, l: APOC_CTX_FUNCS[
        "apoc.create.removelabels"](ctx, x, [l]))
    register_ctx(lb + "set", lambda ctx, x, ls: _label_set(ctx, x, ls))
    register_ctx(lb + "clear", lambda ctx, x: _label_set(ctx, x, []))
    register_ctx(lb + "replace", lambda ctx, x, old, new: (
        _label_set(ctx, x, [new if l == old else l for l in x.labels])))
    register_ctx(lb + "merge", lambda ctx, x, ls: APOC_CTX_FUNCS[
        "apoc.create.addlabels"](ctx, x, ls))

    def _label_set(ctx, x, labels):
        if not isinstance(x, Node):
            raise CypherRuntimeError("apoc.label.set expects a node")
        before = set(x.labels)
        after = list(dict.fromkeys(labels or []))
        x.labels = after
        ctx.storage.update_node(x)
        ctx.stats.labels_added += len(set(after) - before)
        ctx.stats.labels_removed += len(before - set(after))
        ctx.non_create_writes = True
        return x

    # nodes leftovers
    ns = "apoc.nodes."

    def _nodes_delete(ctx, nodes):
        n = 0
        for x in nodes or []:
            if isinstance(x, Node):
                ctx.storage.delete_node(x.id)
                n += 1
        ctx.stats.nodes_deleted += n
        ctx.non_create_writes = True
        return n

    register_ctx(ns + "delete", _nodes_delete)

    def _nodes_link(ctx, nodes, etype):
        from nornicdb_tpu_torch.query.apoc_admin import _fresh_edge

        made = []
        chain = [x for x in (nodes or []) if isinstance(x, Node)]
        for a, b in zip(chain, chain[1:]):
            made.append(_fresh_edge(ctx, str(etype), a.id, b.id, {}))
        return made

    register_ctx(ns + "link", _nodes_link)
    def _collapse_nodes(ctx, nodes):
        from nornicdb_tpu_torch.query.apoc import APOC_CTX_FUNCS as T

        return T["apoc.refactor.mergenodes"](ctx, nodes)

    register_ctx(ns + "collapse", _collapse_nodes)

    register_ctx(ns + "fromMap", lambda ctx, maps: [
        _node_from_map(ctx, m) for m in (maps or [])])
    register_ctx(ns + "batch", lambda ctx, maps, size=1000: [
        _node_from_map(ctx, m) for m in (maps or [])[: int(size)]])

    # search index management: indexes are synchronous label/property
    # maps + the vector/BM25 services; these acknowledge per reference
    # call_index_mgmt.go semantics
    se = "apoc.search."
    register(se + "index", lambda label=None, props=None: {
        "label": label, "properties": props or [], "state": "ONLINE"})
    register(se + "reindex", lambda label=None: {"state": "ONLINE"})
    register(se + "dropIndex", lambda label=None: True)
    register_ctx(se + "fulltext", lambda ctx, labels, prop, q:
                 APOC_CTX_FUNCS["apoc.search.contains"](
                     ctx, labels, prop, q))
    register_ctx(se + "parallel", lambda ctx, specs, q:
                 APOC_CTX_FUNCS["apoc.search.multisearchany"](
                     ctx, specs, q))

    # meta leftovers
    mt = "apoc.meta."
    register(mt + "version",
             lambda: {"version": "2.0", "edition": "tpu"})
    register(mt + "fromString", lambda s: _json.loads(str(s)))
    register(mt + "toString", lambda m: _json.dumps(_jsonable(m)))
    register(mt + "compare", lambda a, b: {
        "equal": _jsonable(a) == _jsonable(b)})
    register(mt + "diff", lambda a, b: {
        "leftOnly": sorted(set(a or {}) - set(b or {})),
        "rightOnly": sorted(set(b or {}) - set(a or {}))})
    register(mt + "config", lambda: {"sampling": "full"})
    register(mt + "pattern", lambda m: " | ".join(
        f"(:{l})" for l in sorted((m or {}).get("labels", {}))))

    def _meta_ctx(name):
        def get(ctx):
            from nornicdb_tpu_torch.query.apoc import APOC_CTX_FUNCS as T

            return T["apoc.meta.data"](ctx)
        return get

    register_ctx(mt + "analyze", _meta_ctx("analyze"))
    register_ctx(mt + "snapshot", _meta_ctx("snapshot"))
    register_ctx(mt + "export", _meta_ctx("export"))
    register_ctx(mt + "subgraph", lambda ctx, labels: {
        l: len(ctx.storage.get_nodes_by_label(l))
        for l in (labels or [])})

    def _meta_constraints(ctx):
        from nornicdb_tpu_torch.query.apoc import APOC_CTX_FUNCS as T

        return T["apoc.schema.info"](ctx)["constraints"]

    register_ctx(mt + "constraints", _meta_constraints)
    register_ctx(mt + "indexes", lambda ctx: [])
    register_ctx(mt + "validate", lambda ctx: APOC_CTX_FUNCS[
        "apoc.schema.validate"](ctx))
    register_ctx(mt + "import", lambda ctx, data: APOC_CTX_FUNCS[
        "apoc.schema.import"](ctx, data))
    register_ctx(mt + "restore", lambda ctx, data: APOC_CTX_FUNCS[
        "apoc.schema.import"](ctx, data))

    def _meta_functions(ctx):
        from nornicdb_tpu_torch.query.apoc import APOC_CTX_FUNCS, APOC_FUNCS
        from nornicdb_tpu_torch.query.functions import REGISTRY

        return sorted(set(REGISTRY) | set(APOC_FUNCS)
                      | set(APOC_CTX_FUNCS))

    register_ctx(mt + "functions", _meta_functions)
    register_ctx(mt + "procedures", lambda ctx: sorted({
        "apoc.periodic.iterate", "apoc.periodic.commit",
        "apoc.cypher.run", "apoc.path.expand", "apoc.path.spanningTree",
        "apoc.trigger.add", "db.labels", "db.relationshipTypes",
        "db.schema.visualization", "gds.pageRank.stream"}))

    # path leftovers (list-of-node-ids convention shared with
    # apoc.paths.*; the PathValue procedure forms live in apoc_ext)
    pt = "apoc.path."
    register(pt + "combine", lambda a, b: (
        list(a or []) + list(b or [])[1:]
        if a and b and a[-1] == b[0] else list(a or []) + list(b or [])))
    register(pt + "slice", lambda p, start, length=None: list(
        (p or [])[int(start): None if length is None
                  else int(start) + int(length)]))

    def _path_elements(p):
        from nornicdb_tpu_torch.query.functions import PathValue

        if isinstance(p, PathValue):
            out: List[Any] = []
            for i, n in enumerate(p.nodes):
                out.append(n)
                if i < len(p.rels):
                    out.append(p.rels[i])
            return out
        return list(p or [])

    register(pt + "elements", _path_elements)

    # lock.with*: run a statement while holding the named locks
    lk = "apoc.lock."

    def _with_lock(ctx, items, statement, params=None):
        from nornicdb_tpu_torch.query.apoc_admin import LOCKS, _ids_of

        keys = _ids_of(items)
        if not LOCKS.acquire(keys, timeout=10.0):
            raise CypherRuntimeError("could not acquire locks")
        try:
            return [rec for rec in _sub(ctx, statement, params).records()]
        finally:
            LOCKS.release(keys)

    register_ctx(lk + "withLock", _with_lock)
    register_ctx(lk + "withReadLock", _with_lock)

    # hashing leftovers: the reference's simplified formulas
    # (apoc/hashing/hashing.go:302-360; cityHash64 delegates to fnv1a64)
    h = "apoc.hashing."

    def _cat(parts) -> bytes:
        if isinstance(parts, list):
            return "".join(str(p) for p in parts).encode()
        return str(parts).encode()

    def _xxhash32(v, seed=0):
        p1, p2, p3, p5 = 2654435761, 2246822519, 3266489917, 374761393
        data = _cat(v)
        h32 = (int(seed) + p5 + len(data)) & _U32
        for b in data:
            h32 = (h32 + b * p5) & _U32
            h32 = (((h32 << 11) | (h32 >> 21)) & _U32) * p1 & _U32
        h32 ^= h32 >> 15
        h32 = (h32 * p2) & _U32
        h32 ^= h32 >> 13
        h32 = (h32 * p3) & _U32
        h32 ^= h32 >> 16
        return h32

    def _xxhash64(v, seed=0):
        p1 = 11400714785074694791
        p2 = 14029467366897019727
        p3 = 1609587929392839161
        p5 = 2870177450012600261
        data = _cat(v)
        h64 = (int(seed) + p5 + len(data)) & _U64
        for b in data:
            h64 = (h64 + b * p5) & _U64
            h64 = (((h64 << 11) | (h64 >> 53)) & _U64) * p1 & _U64
        h64 ^= h64 >> 33
        h64 = (h64 * p2) & _U64
        h64 ^= h64 >> 29
        h64 = (h64 * p3) & _U64
        h64 ^= h64 >> 32
        return h64 - (1 << 64) if h64 >= (1 << 63) else h64

    register(h + "xxhash32", _xxhash32)
    register(h + "xxhash64", _xxhash64)

    def _cityhash64(v):
        from nornicdb_tpu_torch.query.apoc import APOC_FUNCS

        return APOC_FUNCS["apoc.hashing.fnv1a64"](v)

    register(h + "cityhash64", _cityhash64)

    # merge leftovers: transactional forms are out of scope for a
    # function surface; expose explicit state helpers
    mg = "apoc.merge."
    register(mg + "strategy", lambda name="right": {
        "name": str(name),
        "valid": str(name) in ("left", "right", "deep")})
    register_ctx(mg + "snapshot", lambda ctx, x: (
        {"id": x.id, "properties": dict(x.properties)}
        if isinstance(x, (Node, Edge))
        else _raise_merge("snapshot expects a node or relationship")))

    def _rollback(ctx, x, snapshot):
        ent = x if isinstance(x, (Node, Edge)) else None
        if ent is None or not isinstance(snapshot, dict):
            raise CypherRuntimeError(
                "apoc.merge.rollback(entity, snapshot)")
        ent.properties.clear()
        ent.properties.update(snapshot.get("properties") or {})
        if isinstance(ent, Node):
            ctx.storage.update_node(ent)
        else:
            ctx.storage.update_edge(ent)
        ctx.stats.properties_set += 1
        ctx.non_create_writes = True
        return ent

    register_ctx(mg + "rollback", _rollback)

    def _merge_pattern(ctx, frm_labels, frm_ident, etype, to_labels,
                       to_ident):
        from nornicdb_tpu_torch.query.apoc import APOC_CTX_FUNCS as T

        a = T["apoc.merge.mergenode"](ctx, frm_labels, frm_ident)
        b = T["apoc.merge.mergenode"](ctx, to_labels, to_ident)
        e = T["apoc.merge.mergerelationship"](ctx, a, etype, {}, b)
        return {"from": a, "rel": e, "to": b}

    register_ctx(mg + "pattern", _merge_pattern)

    # create.node/nodes/relationship function forms (procedures exist in
    # apoc_ext; function form returns the entity)
    cr = "apoc.create."

    def _create_node_fn(ctx, labels, props=None):
        from nornicdb_tpu_torch.query.apoc_admin import _fresh_node

        return _fresh_node(ctx, labels or [], props or {})

    register_ctx(cr + "node", _create_node_fn)
    register_ctx(cr + "nodes", lambda ctx, labels, props_list: [
        _create_node_fn(ctx, labels, p) for p in (props_list or [])])

    def _create_rel_fn(ctx, frm, etype, props, to):
        from nornicdb_tpu_torch.query.apoc_admin import _fresh_edge

        start = frm.id if isinstance(frm, Node) else str(frm)
        end = to.id if isinstance(to, Node) else str(to)
        return _fresh_edge(ctx, str(etype), start, end, props or {})

    register_ctx(cr + "relationship", _create_rel_fn)

    # convert leftover
    def _set_json_property(ctx, node, key, value):
        if not isinstance(node, Node):
            raise CypherRuntimeError(
                "apoc.convert.setJsonProperty expects a node")
        node.properties[key] = _json.dumps(_jsonable(value))
        ctx.storage.update_node(node)
        ctx.stats.properties_set += 1
        ctx.non_create_writes = True
        return node

    register_ctx("apoc.convert.setJsonProperty", _set_json_property)


def _raise_merge(msg: str):
    raise CypherRuntimeError(f"apoc.merge.{msg}")


def install() -> None:
    _install_cypher()
    _install_export()
    _install_import_load()
    _install_graph()
    _install_trigger_periodic()
    _install_leftovers()


install()
