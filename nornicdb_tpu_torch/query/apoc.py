"""APOC function/procedure library: the registries, the core subset and
the procedure dispatch (counterpart of ``nornicdb_tpu/query/apoc.py``).

Reference: apoc/ (23k LoC, ~40 categories, apoc.go:78 Initialize /
:222 registerAllFunctions). The core surface: coll, map, text, math,
convert/json, date helpers, meta, merge, plus apoc.algo.pageRank and
apoc.path procedures. The long tail grows by registering into the same
table.
"""

from __future__ import annotations

import json
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from nornicdb_tpu_torch.errors import CypherRuntimeError

APOC_FUNCS: Dict[str, Callable[..., Any]] = {}


def register(name: str, fn: Callable[..., Any]) -> None:
    APOC_FUNCS[name.lower()] = fn


def lookup_apoc(name: str) -> Optional[Callable[..., Any]]:
    return APOC_FUNCS.get(name.lower())


# storage-backed APOC functions: impls take (ctx, *args) where ctx is the
# executor's query context (ctx.storage, ctx.ex). The reference gives its
# whole apoc registry storage access via apoc.GetStorage (apoc/apoc.go:110);
# here only the functions that need it are context-aware.
APOC_CTX_FUNCS: Dict[str, Callable[..., Any]] = {}


def register_ctx(name: str, fn: Callable[..., Any]) -> None:
    APOC_CTX_FUNCS[name.lower()] = fn


def lookup_apoc_ctx(name: str) -> Optional[Callable[..., Any]]:
    return APOC_CTX_FUNCS.get(name.lower())


def _flatten(lst, out):
    for x in lst:
        if isinstance(x, list):
            _flatten(x, out)
        else:
            out.append(x)
    return out


def _install():
    # -- apoc.coll -------------------------------------------------------
    register("apoc.coll.sum", lambda l: float(sum(l)) if l else 0.0)
    register("apoc.coll.avg", lambda l: (sum(l) / len(l)) if l else None)
    register("apoc.coll.min", lambda l: min(l) if l else None)
    register("apoc.coll.max", lambda l: max(l) if l else None)
    register("apoc.coll.contains", lambda l, v: v in (l or []))
    register("apoc.coll.reverse", lambda l: list(reversed(l or [])))
    register("apoc.coll.sort", lambda l: sorted(l or []))
    register("apoc.coll.sortNodes", lambda l, prop: sorted(
        l or [], key=lambda n: (n.properties.get(prop) is None, n.properties.get(prop))))
    register("apoc.coll.toSet", lambda l: list(dict.fromkeys(l or [])))
    register("apoc.coll.flatten", lambda l: _flatten(l or [], []))
    register("apoc.coll.indexOf", lambda l, v: (l or []).index(v) if v in (l or []) else -1)
    register("apoc.coll.pairs", lambda l: [
        [l[i], l[i + 1] if i + 1 < len(l) else None] for i in range(len(l or []))])
    register("apoc.coll.zip", lambda a, b: [[x, y] for x, y in zip(a or [], b or [])])
    register("apoc.coll.union", lambda a, b: list(dict.fromkeys((a or []) + (b or []))))
    register("apoc.coll.intersection", lambda a, b: [x for x in dict.fromkeys(a or []) if x in (b or [])])
    register("apoc.coll.subtract", lambda a, b: [x for x in dict.fromkeys(a or []) if x not in (b or [])])
    register("apoc.coll.shuffle", lambda l: __import__("random").sample(l or [], len(l or [])))
    register("apoc.coll.frequencies", lambda l: [
        {"item": k, "count": v}
        for k, v in __import__("collections").Counter(l or []).items()])

    # -- apoc.map --------------------------------------------------------
    register("apoc.map.fromPairs", lambda pairs: {p[0]: p[1] for p in (pairs or [])})
    register("apoc.map.fromLists", lambda ks, vs: dict(zip(ks or [], vs or [])))
    register("apoc.map.merge", lambda a, b: {**(a or {}), **(b or {})})
    register("apoc.map.setKey", lambda m, k, v: {**(m or {}), k: v})
    register("apoc.map.removeKey", lambda m, k: {
        kk: vv for kk, vv in (m or {}).items() if kk != k})
    register("apoc.map.keys", lambda m: sorted((m or {}).keys()))
    register("apoc.map.values", lambda m, keys=None: (
        [m.get(k) for k in keys] if keys else list((m or {}).values())))

    # -- apoc.text -------------------------------------------------------
    register("apoc.text.join", lambda l, d: d.join(str(x) for x in (l or [])))
    register("apoc.text.split", lambda s, regex: __import__("re").split(regex, s or ""))
    register("apoc.text.replace", lambda s, regex, repl: __import__("re").sub(regex, repl, s or ""))
    register("apoc.text.capitalize", lambda s: (s or "").capitalize())
    register("apoc.text.decapitalize", lambda s: (s[:1].lower() + s[1:]) if s else s)
    register("apoc.text.upperCamelCase", lambda s: "".join(
        w.capitalize() for w in __import__("re").split(r"[\s_-]+", s or "")))
    register("apoc.text.camelCase", lambda s: (lambda parts: (
        parts[0].lower() + "".join(w.capitalize() for w in parts[1:]) if parts else ""))(
        __import__("re").split(r"[\s_-]+", s or "")))
    register("apoc.text.random", lambda length, valid="A-Za-z0-9": "".join(
        __import__("random").choices("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789", k=int(length))))
    register("apoc.text.lpad", lambda s, count, delim=" ": str(s).rjust(int(count), delim))
    register("apoc.text.rpad", lambda s, count, delim=" ": str(s).ljust(int(count), delim))
    register("apoc.text.indexOf", lambda s, sub: (s or "").find(sub))
    register("apoc.text.distance", _levenshtein)
    register("apoc.text.clean", lambda s: "".join(
        c for c in (s or "").lower() if c.isalnum()))

    # -- apoc.math / number ---------------------------------------------
    register("apoc.math.round", lambda x, prec=0: round(x, int(prec)))
    register("apoc.math.maxLong", lambda: 2**63 - 1)
    register("apoc.math.minLong", lambda: -(2**63))
    register("apoc.math.sigmoid", lambda x: 1.0 / (1.0 + math.exp(-x)))
    register("apoc.math.tanh", lambda x: math.tanh(x))
    register("apoc.number.format", lambda x, pattern=None: f"{x:,}")

    # -- apoc.convert / json ---------------------------------------------
    register("apoc.convert.toJson", lambda v: json.dumps(_jsonable(v)))
    register("apoc.convert.fromJsonMap", lambda s: json.loads(s))
    register("apoc.convert.fromJsonList", lambda s: json.loads(s))
    register("apoc.convert.toList", lambda v: list(v) if v is not None else [])
    register("apoc.convert.toString", lambda v: None if v is None else str(v))
    register("apoc.convert.toInteger", lambda v: int(v) if v is not None else None)
    register("apoc.convert.toFloat", lambda v: float(v) if v is not None else None)
    register("apoc.convert.toBoolean", lambda v: bool(v))
    register("apoc.json.path", lambda s, path="$": json.loads(s))

    # -- apoc.date -------------------------------------------------------
    register("apoc.date.currentTimestamp", lambda: int(time.time() * 1000))
    register("apoc.date.format", _date_format)
    register("apoc.date.parse", _date_parse)

    # -- apoc.label / meta ----------------------------------------------
    register("apoc.label.exists", lambda node, label: (
        label in node.labels if hasattr(node, "labels") else False))
    register("apoc.meta.type", _meta_type)

    # -- apoc.scoring ----------------------------------------------------
    register("apoc.scoring.existence", lambda score, exists: float(score) if exists else 0.0)
    register("apoc.scoring.pareto", lambda minimumThreshold, eightyPercentValue, maximumValue, score: (
        0.0 if score < minimumThreshold else
        maximumValue * (1 - math.exp(-score * math.log(5.0) / eightyPercentValue))))


def _levenshtein(a: str, b: str) -> int:
    a, b = a or "", b or ""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _jsonable(v):
    from nornicdb_tpu_torch.storage.types import Edge, Node

    if isinstance(v, Node):
        return {"id": v.id, "labels": v.labels, "properties": v.properties}
    if isinstance(v, Edge):
        return {"id": v.id, "type": v.type, "start": v.start_node,
                "end": v.end_node, "properties": v.properties}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


_JAVA_TO_STRFTIME = [
    ("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
]


def _convert_java_format(fmt: str) -> str:
    for j, p in _JAVA_TO_STRFTIME:
        fmt = fmt.replace(j, p)
    return fmt


def _date_format(epoch, unit="ms", fmt="yyyy-MM-dd HH:mm:ss"):
    from datetime import datetime, timezone

    secs = epoch / 1000.0 if unit == "ms" else float(epoch)
    return datetime.fromtimestamp(secs, tz=timezone.utc).strftime(
        _convert_java_format(fmt)
    )


def _date_parse(text, unit="ms", fmt="yyyy-MM-dd HH:mm:ss"):
    from datetime import datetime, timezone

    dt = datetime.strptime(text, _convert_java_format(fmt)).replace(
        tzinfo=timezone.utc
    )
    v = dt.timestamp()
    return int(v * 1000) if unit == "ms" else int(v)


def _meta_type(v):
    from nornicdb_tpu_torch.storage.types import Edge, Node

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "FLOAT"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, list):
        return "LIST"
    if isinstance(v, dict):
        return "MAP"
    if isinstance(v, Node):
        return "NODE"
    if isinstance(v, Edge):
        return "RELATIONSHIP"
    return type(v).__name__.upper()


_install()

# extended categories (periodic/trigger/path/export/create/merge/util —
# apoc_ext.py) register into the same table on import, as does the
# value-level bulk tail (bitwise/number/math/stats/scoring/temporal/
# text/util/json/diff/convert/xml/hashing/agg — apoc_bulk.py)
from nornicdb_tpu_torch.query import apoc_ext as _apoc_ext  # noqa: E402,F401
from nornicdb_tpu_torch.query import apoc_bulk as _apoc_bulk  # noqa: E402,F401
from nornicdb_tpu_torch.query import apoc_graph as _apoc_graph  # noqa: E402,F401
from nornicdb_tpu_torch.query import apoc_algo as _apoc_algo  # noqa: E402,F401
from nornicdb_tpu_torch.query import apoc_admin as _apoc_admin  # noqa: E402,F401
from nornicdb_tpu_torch.query import apoc_io as _apoc_io  # noqa: E402,F401

# -- APOC procedures (CALL apoc.*) ---------------------------------------


def run_apoc_procedure(executor, name: str, args: List[Any], ctx) -> Iterator[Dict[str, Any]]:
    name = name.lower()
    from nornicdb_tpu_torch.query.apoc_ext import run_ext_procedure

    ext = run_ext_procedure(executor, name, args, ctx)
    if ext is not None:
        yield from ext
        return
    if name == "apoc.algo.pagerank":
        # args: [nodes] or nothing — run over whole graph
        from nornicdb_tpu_torch.ops.graph import pagerank_engine

        # the executor's device graph plane caches the edge snapshot +
        # its device transfer per catalog version (only valid when this
        # query runs against the executor's own storage view)
        plane = (getattr(executor, "device_graph", None)
                 if ctx.storage is getattr(executor, "storage", None)
                 else None)
        # without the plane (a foreign storage view) PageRank runs on the
        # executor's device, not the default card
        scores = pagerank_engine(ctx.storage, plane=plane,
                                 device=getattr(executor, "device", None))
        for node_id, score in scores:
            try:
                node = ctx.storage.get_node(node_id)
            except KeyError:
                continue
            yield {"node": node, "score": float(score)}
        return
    if name == "apoc.help":
        prefix = (args[0] if args else "").lower()
        for fname in sorted(APOC_FUNCS):
            if prefix in fname:
                yield {"name": fname, "text": fname}
        return
    if name == "apoc.meta.stats":
        labels: Dict[str, int] = {}
        for n in ctx.storage.all_nodes():
            for l in n.labels:
                labels[l] = labels.get(l, 0) + 1
        rel_types: Dict[str, int] = {}
        for e in ctx.storage.all_edges():
            rel_types[e.type] = rel_types.get(e.type, 0) + 1
        yield {
            "nodeCount": ctx.storage.count_nodes(),
            "relCount": ctx.storage.count_edges(),
            "labels": labels,
            "relTypes": rel_types,
        }
        return
    cfn = lookup_apoc_ctx(name)
    if cfn is not None:
        out = cfn(ctx, *args)
        # procedure form: map results yield their fields as columns
        if isinstance(out, dict):
            yield out
        elif isinstance(out, list) and all(
                isinstance(x, dict) for x in out):
            yield from out  # empty list = zero rows, stable columns
        else:
            yield {"value": out}
        return
    fn = lookup_apoc(name)
    if fn is not None:
        yield {"value": fn(*args)}
        return
    raise CypherRuntimeError(f"unknown APOC procedure {name}")
