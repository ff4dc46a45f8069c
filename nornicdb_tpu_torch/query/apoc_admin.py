"""APOC admin + write-path long tail: atomic, create/merge extras,
refactor, schema, lock, log, warmup (counterpart of
``nornicdb_tpu/query/apoc_admin.py``).

Reference: apoc/atomic, apoc/create, apoc/merge, apoc/refactor,
apoc/schema, apoc/lock, apoc/log, apoc/warmup. Write functions mutate
``ctx.storage`` and bump ``ctx.stats`` so the executor's end-of-query
cache maintenance sees them (the same contract apoc_ext's create/merge
procedures follow). Locks and the log ring are process-wide singletons,
like the reference's global registries (apoc/lock/lock.go,
apoc/log/log.go).
"""

from __future__ import annotations

import logging
import threading
import time as _time
import uuid as _uuid
from typing import Any, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.errors import CypherRuntimeError
from nornicdb_tpu_torch.query.apoc import register, register_ctx
from nornicdb_tpu_torch.storage.types import Edge, Node

_log = logging.getLogger("nornicdb_tpu_torch.apoc")


# -- shared write helpers -------------------------------------------------


def _entity(ctx, x, what: str):
    if isinstance(x, (Node, Edge)):
        return x
    raise CypherRuntimeError(f"{what} expects a node or relationship")


def _refetch(ctx, x, what: str):
    """Fresh read of a query-bound entity: engines return copies on
    read, so a read-modify-write must re-read inside the atomic lock or
    concurrent updates are lost."""
    ent = _entity(ctx, x, what)
    from nornicdb_tpu_torch.storage.types import NotFoundError

    try:
        if isinstance(ent, Node):
            return ctx.storage.get_node(ent.id)
        return ctx.storage.get_edge(ent.id)
    except NotFoundError:
        raise CypherRuntimeError(f"{what}: entity {ent.id} no longer exists")


def _persist(ctx, ent) -> None:
    if isinstance(ent, Node):
        ctx.storage.update_node(ent)
        ctx.stats.properties_set += 1
    else:
        ctx.storage.update_edge(ent)
        ctx.stats.properties_set += 1
    ctx.non_create_writes = True


def _fresh_node(ctx, labels, props) -> Node:
    node = Node(id=str(_uuid.uuid4()), labels=list(labels or []),
                properties=dict(props or {}))
    ctx.storage.create_node(node)
    ctx.stats.nodes_created += 1
    ctx.stats.labels_added += len(node.labels)
    ctx.stats.properties_set += len(node.properties)
    ctx.created_nodes.append(node)
    return node


def _fresh_edge(ctx, etype, start, end, props) -> Edge:
    edge = Edge(id=str(_uuid.uuid4()), type=etype, start_node=start,
                end_node=end, properties=dict(props or {}))
    ctx.storage.create_edge(edge)
    ctx.stats.relationships_created += 1
    ctx.created_edges.append(edge)
    return edge


# -- apoc.atomic ----------------------------------------------------------

_ATOMIC_LOCK = threading.Lock()


def _install_atomic() -> None:
    at = "apoc.atomic."

    def _update_num(ctx, x, prop, delta):
        with _ATOMIC_LOCK:
            ent = _refetch(ctx, x, "apoc.atomic")
            cur = ent.properties.get(prop, 0)
            if not isinstance(cur, (int, float)) or isinstance(cur, bool):
                raise CypherRuntimeError(
                    f"apoc.atomic: property {prop!r} is not numeric")
            ent.properties[prop] = cur + delta
            _persist(ctx, ent)
            return ent.properties[prop]

    register_ctx(at + "add", lambda ctx, x, prop, v: _update_num(
        ctx, x, prop, v))
    register_ctx(at + "subtract", lambda ctx, x, prop, v: _update_num(
        ctx, x, prop, -v))
    register_ctx(at + "increment", lambda ctx, x, prop: _update_num(
        ctx, x, prop, 1))
    register_ctx(at + "decrement", lambda ctx, x, prop: _update_num(
        ctx, x, prop, -1))

    def _concat(ctx, x, prop, suffix):
        with _ATOMIC_LOCK:
            ent = _refetch(ctx, x, "apoc.atomic.concat")
            ent.properties[prop] = str(ent.properties.get(prop, "")) \
                + str(suffix)
            _persist(ctx, ent)
            return ent.properties[prop]

    register_ctx(at + "concat", _concat)

    def _insert(ctx, x, prop, pos, value):
        with _ATOMIC_LOCK:
            ent = _refetch(ctx, x, "apoc.atomic.insert")
            lst = list(ent.properties.get(prop) or [])
            lst.insert(int(pos), value)
            ent.properties[prop] = lst
            _persist(ctx, ent)
            return lst

    register_ctx(at + "insert", _insert)

    def _remove(ctx, x, prop, pos):
        with _ATOMIC_LOCK:
            ent = _refetch(ctx, x, "apoc.atomic.remove")
            lst = list(ent.properties.get(prop) or [])
            if 0 <= int(pos) < len(lst):
                lst.pop(int(pos))
            ent.properties[prop] = lst
            _persist(ctx, ent)
            return lst

    register_ctx(at + "remove", _remove)

    def _update(ctx, x, prop, value):
        with _ATOMIC_LOCK:
            ent = _refetch(ctx, x, "apoc.atomic.update")
            ent.properties[prop] = value
            _persist(ctx, ent)
            return value

    register_ctx(at + "update", _update)

    def _cas(ctx, x, prop, expected, value):
        with _ATOMIC_LOCK:
            ent = _refetch(ctx, x, "apoc.atomic.compareAndSwap")
            if ent.properties.get(prop) != expected:
                return False
            ent.properties[prop] = value
            _persist(ctx, ent)
            return True

    register_ctx(at + "compareAndSwap", _cas)


# -- apoc.create extras ---------------------------------------------------


def _install_create() -> None:
    cr = "apoc.create."

    def _add_labels(ctx, x, labels):
        node = x if isinstance(x, Node) else None
        if node is None:
            raise CypherRuntimeError("addLabels expects a node")
        for l in labels or []:
            if l not in node.labels:
                node.labels.append(l)
                ctx.stats.labels_added += 1
        ctx.storage.update_node(node)
        ctx.non_create_writes = True
        return node

    register_ctx(cr + "addLabels", _add_labels)

    def _remove_labels(ctx, x, labels):
        node = x if isinstance(x, Node) else None
        if node is None:
            raise CypherRuntimeError("removeLabels expects a node")
        for l in labels or []:
            if l in node.labels:
                node.labels.remove(l)
                ctx.stats.labels_removed += 1
        ctx.storage.update_node(node)
        ctx.non_create_writes = True
        return node

    register_ctx(cr + "removeLabels", _remove_labels)

    def _set_property(ctx, x, key, value):
        ent = _entity(ctx, x, "apoc.create.setProperty")
        ent.properties[key] = value
        _persist(ctx, ent)
        return ent

    register_ctx(cr + "setProperty", _set_property)
    register_ctx(cr + "setRelProperty", _set_property)

    def _set_properties(ctx, x, keys, values=None):
        ent = _entity(ctx, x, "apoc.create.setProperties")
        if isinstance(keys, dict):
            ent.properties.update(keys)
        else:
            for k, v in zip(keys or [], values or []):
                ent.properties[k] = v
        _persist(ctx, ent)
        return ent

    register_ctx(cr + "setProperties", _set_properties)
    register_ctx(cr + "setRelProperties", _set_properties)

    def _remove_properties(ctx, x, keys):
        ent = _entity(ctx, x, "apoc.create.removeProperties")
        for k in keys or []:
            ent.properties.pop(k, None)
        _persist(ctx, ent)
        return ent

    register_ctx(cr + "removeProperties", _remove_properties)
    register_ctx(cr + "removeRelProperties", _remove_properties)

    def _clone(ctx, x):
        node = x if isinstance(x, Node) else None
        if node is None:
            raise CypherRuntimeError("clone expects a node")
        return _fresh_node(ctx, node.labels, node.properties)

    register_ctx(cr + "clone", _clone)

    def _clone_subgraph(ctx, nodes, rels=None):
        mapping: Dict[str, Node] = {}
        out_nodes = []
        for n in nodes or []:
            if isinstance(n, Node):
                clone = _fresh_node(ctx, n.labels, n.properties)
                mapping[n.id] = clone
                out_nodes.append(clone)
        out_rels = []
        for e in rels or []:
            if isinstance(e, Edge) and e.start_node in mapping \
                    and e.end_node in mapping:
                out_rels.append(_fresh_edge(
                    ctx, e.type, mapping[e.start_node].id,
                    mapping[e.end_node].id, e.properties))
        return {"nodes": out_nodes, "relationships": out_rels}

    register_ctx(cr + "cloneSubgraph", _clone_subgraph)
    register(cr + "uuids", lambda n: [str(_uuid.uuid4())
                                      for _ in range(int(n))])

    # virtual entities: returned, never persisted (reference
    # apoc/create vNode family)
    register(cr + "vNode", lambda labels, props=None: Node(
        id=f"vnode-{_uuid.uuid4()}", labels=list(labels or []),
        properties=dict(props or {})))
    register(cr + "vNodes", lambda labels, props_list: [
        Node(id=f"vnode-{_uuid.uuid4()}", labels=list(labels or []),
             properties=dict(p or {})) for p in (props_list or [])])
    register(cr + "vRelationship", lambda frm, etype, props, to: Edge(
        id=f"vrel-{_uuid.uuid4()}", type=etype,
        start_node=frm.id if isinstance(frm, Node) else str(frm),
        end_node=to.id if isinstance(to, Node) else str(to),
        properties=dict(props or {})))

    def _vpattern(frm_map, etype, props, to_map):
        a = Node(id=f"vnode-{_uuid.uuid4()}",
                 labels=list((frm_map or {}).get("_labels", [])),
                 properties={k: v for k, v in (frm_map or {}).items()
                             if k != "_labels"})
        b = Node(id=f"vnode-{_uuid.uuid4()}",
                 labels=list((to_map or {}).get("_labels", [])),
                 properties={k: v for k, v in (to_map or {}).items()
                             if k != "_labels"})
        e = Edge(id=f"vrel-{_uuid.uuid4()}", type=etype, start_node=a.id,
                 end_node=b.id, properties=dict(props or {}))
        return {"from": a, "rel": e, "to": b}

    register(cr + "vPattern", _vpattern)


# -- apoc.merge extras ----------------------------------------------------


def _install_merge() -> None:
    mg = "apoc.merge."

    def _merge_node(ctx, labels, ident_props, on_create=None,
                    on_match=None):
        labels = list(labels or [])
        ident = dict(ident_props or {})
        for node in ctx.storage.get_nodes_by_label(
                labels[0]) if labels else ctx.storage.all_nodes():
            if all(node.properties.get(k) == v for k, v in ident.items()) \
                    and all(l in node.labels for l in labels):
                if on_match:
                    node.properties.update(on_match)
                    _persist(ctx, node)
                return node
        props = {**ident, **(on_create or {})}
        return _fresh_node(ctx, labels, props)

    register_ctx(mg + "mergeNode", _merge_node)
    register_ctx(mg + "nodeEager", _merge_node)
    register_ctx(mg + "nodes", lambda ctx, labels, ident_list: [
        _merge_node(ctx, labels, ident) for ident in (ident_list or [])])

    def _merge_rel(ctx, start, etype, ident_props, to, on_create=None):
        a = start if isinstance(start, Node) else None
        b = to if isinstance(to, Node) else None
        if a is None or b is None:
            raise CypherRuntimeError("mergeRelationship expects nodes")
        ident = dict(ident_props or {})
        for e in ctx.storage.get_node_edges(a.id, direction="out"):
            if (e.type == etype and e.end_node == b.id and all(
                    e.properties.get(k) == v for k, v in ident.items())):
                return e
        return _fresh_edge(ctx, etype, a.id, b.id,
                           {**ident, **(on_create or {})})

    register_ctx(mg + "mergeRelationship", _merge_rel)
    # reference signature: (start, relType, identProps, onCreateProps, end)
    register_ctx(mg + "relationshipEager",
                 lambda ctx, start, etype, ident, on_create, to:
                 _merge_rel(ctx, start, etype, ident, to, on_create))

    def _merge_labels(ctx, x, labels):
        node = x if isinstance(x, Node) else None
        if node is None:
            raise CypherRuntimeError("merge.labels expects a node")
        changed = False
        for l in labels or []:
            if l not in node.labels:
                node.labels.append(l)
                ctx.stats.labels_added += 1
                changed = True
        if changed:
            ctx.storage.update_node(node)
            ctx.non_create_writes = True
        return node

    register_ctx(mg + "labels", _merge_labels)

    def _merge_properties(ctx, x, props, overwrite=False):
        ent = _entity(ctx, x, "apoc.merge.properties")
        for k, v in (props or {}).items():
            if overwrite or k not in ent.properties:
                ent.properties[k] = v
        _persist(ctx, ent)
        return ent

    register_ctx(mg + "properties", _merge_properties)

    def _deep_merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = _deep_merge(a[k], v) if k in a else v
            return out
        return b

    register(mg + "deepMerge", _deep_merge)
    register(mg + "conflict", lambda a, b, strategy="right": (
        {**(a or {}), **(b or {})} if strategy == "right"
        else {**(b or {}), **(a or {})} if strategy == "left"
        else _deep_merge(a or {}, b or {})))
    register(mg + "preview", lambda existing, incoming: {
        "unchanged": {k: v for k, v in (existing or {}).items()
                      if (incoming or {}).get(k, v) == v},
        "added": {k: v for k, v in (incoming or {}).items()
                  if k not in (existing or {})},
        "overwritten": {k: {"old": (existing or {})[k], "new": v}
                        for k, v in (incoming or {}).items()
                        if k in (existing or {})
                        and (existing or {})[k] != v}})
    register(mg + "validate", lambda ident: (
        bool(ident) and all(v is not None for v in ident.values())))

    def _merge_batch(ctx, labels, ident_list, on_create=None):
        return [{"node": _merge_node(ctx, labels, ident, on_create)}
                for ident in (ident_list or [])]

    register_ctx(mg + "batch", _merge_batch)

    def _conditional(ctx, cond, labels, ident, on_create=None):
        if not cond:
            return None
        return _merge_node(ctx, labels, ident, on_create)

    register_ctx(mg + "conditional", _conditional)


# -- apoc.refactor --------------------------------------------------------


def _install_refactor() -> None:
    rf = "apoc.refactor."

    def _rename_label(ctx, old, new):
        n = 0
        for node in list(ctx.storage.get_nodes_by_label(old)):
            node.labels = [new if l == old else l for l in node.labels]
            ctx.storage.update_node(node)
            n += 1
        if n:
            ctx.stats.labels_added += n
            ctx.stats.labels_removed += n
            ctx.non_create_writes = True
        return n

    register_ctx(rf + "renameLabel", _rename_label)

    def _rename_type(ctx, old, new):
        n = 0
        for e in list(ctx.storage.get_edges_by_type(old)):
            ctx.storage.delete_edge(e.id)
            ctx.storage.create_edge(Edge(
                id=e.id, type=new, start_node=e.start_node,
                end_node=e.end_node, properties=dict(e.properties)))
            n += 1
        if n:
            ctx.stats.relationships_created += n
            ctx.stats.relationships_deleted += n
            ctx.non_create_writes = True
        return n

    register_ctx(rf + "renameType", _rename_type)
    register_ctx(rf + "setType", lambda ctx, e, new: _set_type(ctx, e, new))
    register_ctx(rf + "changeType", lambda ctx, e, new: _set_type(
        ctx, e, new))

    def _set_type(ctx, e, new):
        if not isinstance(e, Edge):
            raise CypherRuntimeError("setType expects a relationship")
        ctx.storage.delete_edge(e.id)
        out = Edge(id=e.id, type=new, start_node=e.start_node,
                   end_node=e.end_node, properties=dict(e.properties))
        ctx.storage.create_edge(out)
        ctx.stats.relationships_created += 1
        ctx.stats.relationships_deleted += 1
        ctx.non_create_writes = True
        return out

    def _rename_property(ctx, old, new, labels=None):
        n = 0
        nodes = (ctx.storage.get_nodes_by_label(labels[0])
                 if labels else ctx.storage.all_nodes())
        for node in list(nodes):
            if old in node.properties:
                node.properties[new] = node.properties.pop(old)
                ctx.storage.update_node(node)
                n += 1
        if n:
            ctx.stats.properties_set += n
            ctx.non_create_writes = True
        return n

    register_ctx(rf + "renameProperty", _rename_property)

    def _merge_nodes(ctx, nodes):
        """Merge all nodes onto the first: union labels/props, re-home
        relationships, delete the rest."""
        nodes = [x for x in (nodes or []) if isinstance(x, Node)]
        if not nodes:
            return None
        target = nodes[0]
        for other in nodes[1:]:
            for l in other.labels:
                if l not in target.labels:
                    target.labels.append(l)
            for k, v in other.properties.items():
                target.properties.setdefault(k, v)
            for e in list(ctx.storage.get_node_edges(other.id)):
                ctx.storage.delete_edge(e.id)
                s = target.id if e.start_node == other.id else e.start_node
                t = target.id if e.end_node == other.id else e.end_node
                if s == t == target.id and e.start_node != e.end_node:
                    continue  # collapse would self-loop a merged pair
                ctx.storage.create_edge(Edge(
                    id=e.id, type=e.type, start_node=s, end_node=t,
                    properties=dict(e.properties)))
            ctx.storage.delete_node(other.id)
            ctx.stats.nodes_deleted += 1
        ctx.storage.update_node(target)
        ctx.non_create_writes = True
        return target

    register_ctx(rf + "mergeNodes", _merge_nodes)

    def _merge_relationships(ctx, rels):
        rels = [e for e in (rels or []) if isinstance(e, Edge)]
        if not rels:
            return None
        target = rels[0]
        for other in rels[1:]:
            for k, v in other.properties.items():
                target.properties.setdefault(k, v)
            ctx.storage.delete_edge(other.id)
            ctx.stats.relationships_deleted += 1
        ctx.storage.update_edge(target)
        ctx.non_create_writes = True
        return target

    register_ctx(rf + "mergeRelationships", _merge_relationships)

    def _redirect(ctx, e, node, end=True):
        if not isinstance(e, Edge) or not isinstance(node, Node):
            raise CypherRuntimeError(
                "redirectRelationship expects (rel, node)")
        ctx.storage.delete_edge(e.id)
        out = Edge(id=e.id, type=e.type,
                   start_node=e.start_node if end else node.id,
                   end_node=node.id if end else e.end_node,
                   properties=dict(e.properties))
        ctx.storage.create_edge(out)
        ctx.stats.relationships_created += 1
        ctx.stats.relationships_deleted += 1
        ctx.non_create_writes = True
        return out

    register_ctx(rf + "redirectRelationship", _redirect)
    register_ctx(rf + "to", lambda ctx, e, node: _redirect(
        ctx, e, node, end=True))
    register_ctx(rf + "from", lambda ctx, e, node: _redirect(
        ctx, e, node, end=False))

    def _invert(ctx, e):
        if not isinstance(e, Edge):
            raise CypherRuntimeError("invertRelationship expects a rel")
        ctx.storage.delete_edge(e.id)
        out = Edge(id=e.id, type=e.type, start_node=e.end_node,
                   end_node=e.start_node, properties=dict(e.properties))
        ctx.storage.create_edge(out)
        ctx.stats.relationships_created += 1
        ctx.stats.relationships_deleted += 1
        ctx.non_create_writes = True
        return out

    register_ctx(rf + "invertRelationship", _invert)

    def _clone_nodes(ctx, nodes, with_rels=False):
        mapping: Dict[str, Node] = {}
        out = []
        src = [x for x in (nodes or []) if isinstance(x, Node)]
        for node in src:
            clone = _fresh_node(ctx, node.labels, node.properties)
            mapping[node.id] = clone
            out.append(clone)
        if with_rels:
            ids = {x.id for x in src}
            seen = set()
            for node in src:
                for e in ctx.storage.get_node_edges(node.id):
                    if e.id in seen or e.start_node not in ids \
                            or e.end_node not in ids:
                        continue
                    seen.add(e.id)
                    _fresh_edge(ctx, e.type, mapping[e.start_node].id,
                                mapping[e.end_node].id, e.properties)
        return out

    register_ctx(rf + "cloneNodes", _clone_nodes)
    register_ctx(rf + "cloneSubgraph", lambda ctx, nodes: _clone_nodes(
        ctx, nodes, with_rels=True))

    def _clone_from_paths(ctx, paths):
        from nornicdb_tpu_torch.query.functions import PathValue
        nodes: Dict[str, Node] = {}
        for p in paths or []:
            if isinstance(p, PathValue):
                for n in p.nodes:
                    nodes[n.id] = n
        return _clone_nodes(ctx, list(nodes.values()), with_rels=True)

    register_ctx(rf + "cloneSubgraphFromPaths", _clone_from_paths)

    def _extract_node(ctx, e, labels):
        """Relationship -> intermediate node (reference extractNode)."""
        if not isinstance(e, Edge):
            raise CypherRuntimeError("extractNode expects a relationship")
        mid = _fresh_node(ctx, labels or [e.type], e.properties)
        _fresh_edge(ctx, e.type + "_FROM", e.start_node, mid.id, {})
        _fresh_edge(ctx, e.type + "_TO", mid.id, e.end_node, {})
        ctx.storage.delete_edge(e.id)
        ctx.stats.relationships_deleted += 1
        ctx.non_create_writes = True
        return mid

    register_ctx(rf + "extractNode", _extract_node)

    def _collapse_node(ctx, node, etype):
        """Node with exactly one in- and one out-edge -> single edge."""
        if not isinstance(node, Node):
            raise CypherRuntimeError("collapseNode expects a node")
        ins = ctx.storage.get_node_edges(node.id, direction="in")
        outs = ctx.storage.get_node_edges(node.id, direction="out")
        if len(ins) != 1 or len(outs) != 1:
            raise CypherRuntimeError(
                "collapseNode requires exactly one incoming and one "
                "outgoing relationship")
        new = _fresh_edge(ctx, etype, ins[0].start_node, outs[0].end_node,
                          node.properties)
        ctx.storage.delete_node(node.id)
        ctx.stats.nodes_deleted += 1
        ctx.non_create_writes = True
        return new

    register_ctx(rf + "collapseNode", _collapse_node)

    def _delete_reconnect(ctx, node, etype=None):
        """Delete a node, reconnecting its in-neighbors to out-neighbors."""
        if not isinstance(node, Node):
            raise CypherRuntimeError("deleteAndReconnect expects a node")
        ins = ctx.storage.get_node_edges(node.id, direction="in")
        outs = ctx.storage.get_node_edges(node.id, direction="out")
        made = []
        for ei in ins:
            for eo in outs:
                if ei.start_node == eo.end_node:
                    continue
                made.append(_fresh_edge(
                    ctx, etype or eo.type, ei.start_node, eo.end_node, {}))
        ctx.storage.delete_node(node.id)
        ctx.stats.nodes_deleted += 1
        ctx.non_create_writes = True
        return made

    register_ctx(rf + "deleteAndReconnect", _delete_reconnect)

    def _normalize_bool(ctx, node, prop, true_values, false_values):
        if not isinstance(node, Node):
            raise CypherRuntimeError("normalizeAsBoolean expects a node")
        v = node.properties.get(prop)
        if v in (true_values or []):
            node.properties[prop] = True
        elif v in (false_values or []):
            node.properties[prop] = False
        else:
            node.properties.pop(prop, None)
        _persist(ctx, node)
        return node

    register_ctx(rf + "normalizeAsBoolean", _normalize_bool)
    register_ctx(rf + "normalize", _normalize_bool)

    def _categorize(ctx, prop, etype, label, out_key="name"):
        """Property value -> category node + relationship
        (reference categorizeProperty)."""
        cats: Dict[Any, Node] = {}
        n = 0
        for node in list(ctx.storage.all_nodes()):
            if label in node.labels:
                continue  # category nodes themselves
            v = node.properties.get(prop)
            if v is None or isinstance(v, (list, dict)):
                continue
            cat = cats.get(v)
            if cat is None:
                for existing in ctx.storage.get_nodes_by_label(label):
                    if existing.properties.get(out_key) == v:
                        cat = existing
                        break
                if cat is None:
                    cat = _fresh_node(ctx, [label], {out_key: v})
                cats[v] = cat
            _fresh_edge(ctx, etype, node.id, cat.id, {})
            node.properties.pop(prop, None)
            ctx.storage.update_node(node)
            n += 1
        if n:
            ctx.non_create_writes = True
        return n

    register_ctx(rf + "categorizeProperty", _categorize)
    register_ctx(rf + "denormalize", lambda ctx, prop, etype, label,
                 out_key="name": _categorize(ctx, prop, etype, label,
                                             out_key))


# -- apoc.schema ----------------------------------------------------------


def _schema_mgr(ctx):
    """Find a SchemaManager on the engine chain, else a per-executor one
    (registry-only until a ConstrainedEngine enforces it)."""
    eng = ctx.storage
    for _ in range(8):
        mgr = getattr(eng, "schema", None)
        if mgr is not None and hasattr(mgr, "add") and hasattr(mgr, "list"):
            return mgr
        eng = getattr(eng, "inner", None)
        if eng is None:
            break
    mgr = getattr(ctx.ex, "_apoc_schema", None)
    if mgr is None:
        from nornicdb_tpu_torch.storage.schema import SchemaManager

        mgr = SchemaManager()
        ctx.ex._apoc_schema = mgr
    return mgr


def _install_schema() -> None:
    from nornicdb_tpu_torch.storage.schema import Constraint

    sc = "apoc.schema."

    def _mk_all(kind, label, props, rel=False) -> List[Constraint]:
        """One Constraint per property (the schema model is
        single-property; composite keys expand)."""
        props = props if isinstance(props, list) else [props]
        out = []
        for p in props:
            out.append(Constraint(
                name=f"{kind}_{label}_{p}", kind=kind,
                label="" if rel else label,
                rel_type=label if rel else "", property=p))
        return out

    def _create(ctx, kind, label, props):
        mgr = _schema_mgr(ctx)
        have = {c.name for c in mgr.list()}
        made = []
        for c in _mk_all(kind, label, props):
            if c.name not in have:  # idempotent re-create
                mgr.add(c)
            made.append(c.to_dict())
        return made

    register_ctx(sc + "createUniqueConstraint", lambda ctx, label, props:
                 _create(ctx, "unique", label, props))
    register_ctx(sc + "createExistsConstraint", lambda ctx, label, props:
                 _create(ctx, "exists", label, props))
    register_ctx(sc + "createNodeKeyConstraint", lambda ctx, label, props:
                 _create(ctx, "unique", label, props)
                 + _create(ctx, "exists", label, props))
    register_ctx(sc + "createConstraint", lambda ctx, label, props,
                 kind="unique": _create(ctx, kind, label, props))
    register_ctx(sc + "dropConstraint", lambda ctx, name: _schema_mgr(
        ctx).drop(name))
    register_ctx(sc + "nodeConstraints", lambda ctx: [
        c.to_dict() for c in _schema_mgr(ctx).list() if c.label])
    register_ctx(sc + "relationshipConstraints", lambda ctx: [
        c.to_dict() for c in _schema_mgr(ctx).list() if c.rel_type])
    register_ctx(sc + "nodeConstraintExists", lambda ctx, label, props:
                 all(any(c.label == label and c.property == p
                         for c in _schema_mgr(ctx).list())
                     for p in (props if isinstance(props, list)
                               else [props])))

    def _assert(ctx, indexes, constraints):
        """Declarative schema: drop anything not listed, create what is
        (reference apoc.schema.assert). constraints: {label: [props]}
        (unique). Indexes are synchronous label/property maps here."""
        mgr = _schema_mgr(ctx)
        wanted: List[Constraint] = []
        for label, props in (constraints or {}).items():
            wanted.extend(_mk_all("unique", label, props))
        keep = {c.name for c in wanted}
        dropped = [c.name for c in mgr.list() if c.name not in keep]
        for name in dropped:
            mgr.drop(name)
        created = []
        have = {c.name for c in mgr.list()}
        for c in wanted:
            if c.name not in have:
                mgr.add(c)
                created.append(c.name)
        return {"created": created, "dropped": dropped,
                "indexes": indexes or {}}

    register_ctx(sc + "assert", _assert)

    def _info(ctx):
        mgr = _schema_mgr(ctx)
        return {"constraints": [c.to_dict() for c in mgr.list()],
                "indexes": []}

    register_ctx(sc + "info", _info)
    register_ctx(sc + "export", _info)
    register_ctx(sc + "snapshot", _info)

    def _import(ctx, data):
        mgr = _schema_mgr(ctx)
        have = {c.name for c in mgr.list()}
        n = 0
        for d in (data or {}).get("constraints", []):
            c = Constraint.from_dict(d)
            if c.name in have:
                continue  # idempotent restore
            mgr.add(c)
            have.add(c.name)
            n += 1
        return n

    register_ctx(sc + "import", _import)
    register_ctx(sc + "restore", _import)

    register_ctx(sc + "labels", lambda ctx: sorted(
        {c.label for c in _schema_mgr(ctx).list() if c.label}))
    register_ctx(sc + "relationships", lambda ctx: sorted(
        {c.rel_type for c in _schema_mgr(ctx).list() if c.rel_type}))
    register_ctx(sc + "properties", lambda ctx: sorted(
        {c.property for c in _schema_mgr(ctx).list() if c.property}))
    register_ctx(sc + "nodes", lambda ctx: [
        c.to_dict() for c in _schema_mgr(ctx).list() if c.label])
    register_ctx(sc + "stats", lambda ctx: {
        "constraintCount": len(_schema_mgr(ctx).list())})

    def _validate(ctx):
        """Check existing data against registered constraints."""
        from nornicdb_tpu_torch.storage.schema import ConstrainedEngine

        eng = ctx.storage
        for _ in range(8):
            if isinstance(eng, ConstrainedEngine):
                return eng.validate_existing()
            nxt = getattr(eng, "inner", None)
            if nxt is None:
                break
            eng = nxt
        # registry-only mode: run the unique/exists checks directly
        mgr = _schema_mgr(ctx)
        violations: List[str] = []
        for c in mgr.list():
            if not c.label or not c.property:
                continue
            if c.kind == "unique":
                seen: Dict[Any, str] = {}
                for node in ctx.storage.get_nodes_by_label(c.label):
                    v = node.properties.get(c.property)
                    if v is None or isinstance(v, (list, dict)):
                        continue
                    if v in seen:
                        violations.append(
                            f"{c.name}: duplicate {v!r} on nodes "
                            f"{seen[v]} and {node.id}")
                    else:
                        seen[v] = node.id
            elif c.kind == "exists":
                for node in ctx.storage.get_nodes_by_label(c.label):
                    if node.properties.get(c.property) is None:
                        violations.append(
                            f"{c.name}: missing {c.property!r} on node "
                            f"{node.id}")
        return violations

    register_ctx(sc + "validate", _validate)
    register_ctx(sc + "analyze", _validate)

    def _compare(ctx, other):
        mine = {c.name for c in _schema_mgr(ctx).list()}
        theirs = {d.get("name") for d in (other or {}).get(
            "constraints", [])}
        return {"onlyLocal": sorted(mine - theirs),
                "onlyOther": sorted(theirs - mine),
                "common": sorted(mine & theirs)}

    register_ctx(sc + "compare", _compare)

    # index management maps onto the synchronous label/property maps
    # (reference call_index_mgmt.go semantics: acknowledged, no async
    # population phase)
    register_ctx(sc + "createIndex", lambda ctx, label, props: {
        "label": label,
        "properties": props if isinstance(props, list) else [props],
        "state": "ONLINE"})
    register_ctx(sc + "dropIndex", lambda ctx, label, props=None: True)
    register_ctx(sc + "nodeIndexes", lambda ctx: [])
    register_ctx(sc + "relationshipIndexes", lambda ctx: [])
    register_ctx(sc + "nodeIndexExists", lambda ctx, label, props: True)
    register_ctx(sc + "optimize", lambda ctx: {"status": "ok"})
    register_ctx(sc + "types", lambda ctx: sorted(
        {c.kind for c in _schema_mgr(ctx).list()}))
    register_ctx(sc + "propertiesDistinct", lambda ctx, label, prop: sorted(
        {v for n in ctx.storage.get_nodes_by_label(label)
         if not isinstance(v := n.properties.get(prop), (list, dict))
         and v is not None},
        key=lambda x: (str(type(x).__name__), str(x))))


# -- apoc.lock ------------------------------------------------------------


class _LockManager:
    """Named re-entrant locks over node/rel ids plus one global lock.
    Process-wide singleton, like the reference's lock registry."""

    def __init__(self):
        self._guard = threading.Lock()
        self._locks: Dict[str, threading.RLock] = {}
        self._held: Dict[str, int] = {}

    def _get(self, key: str) -> threading.RLock:
        with self._guard:
            lock = self._locks.get(key)
            if lock is None:
                lock = threading.RLock()
                self._locks[key] = lock
            return lock

    def acquire(self, keys: List[str], timeout: float = 10.0) -> bool:
        got: List[str] = []
        for key in sorted(keys):  # total order prevents deadlock
            if not self._get(key).acquire(timeout=timeout):
                self.release(got)  # roll back: locks must not leak
                return False
            got.append(key)
            with self._guard:
                self._held[key] = self._held.get(key, 0) + 1
        return True

    def try_acquire(self, keys: List[str]) -> bool:
        got: List[str] = []
        for key in sorted(keys):
            if self._get(key).acquire(blocking=False):
                with self._guard:  # count immediately: release() on
                    self._held[key] = self._held.get(key, 0) + 1
                got.append(key)  # rollback decrements symmetrically
            else:
                self.release(got)
                return False
        return True

    def release(self, keys: List[str]) -> int:
        n = 0
        for key in keys:
            lock = self._locks.get(key)
            if lock is None:
                continue
            try:
                lock.release()
                n += 1
                with self._guard:
                    if self._held.get(key, 0) > 0:
                        self._held[key] -= 1
            except RuntimeError:
                pass  # not held by this thread
        return n

    def release_all(self) -> int:
        return self.release(list(self._locks))

    def is_locked(self, key: str) -> bool:
        with self._guard:
            return self._held.get(key, 0) > 0

    def stats(self) -> Dict[str, Any]:
        with self._guard:
            return {"locks": len(self._locks),
                    "held": sum(1 for v in self._held.values() if v > 0)}


LOCKS = _LockManager()


def _ids_of(items) -> List[str]:
    out = []
    for x in items if isinstance(items, list) else [items]:
        if isinstance(x, (Node, Edge)):
            out.append(x.id)
        elif x is not None:
            out.append(str(x))
    return out


def _install_lock() -> None:
    lk = "apoc.lock."
    register(lk + "nodes", lambda nodes, timeout=10.0: LOCKS.acquire(
        _ids_of(nodes), float(timeout)))
    register(lk + "relationships", lambda rels, timeout=10.0: LOCKS.acquire(
        _ids_of(rels), float(timeout)))
    register(lk + "readNodes", lambda nodes, timeout=10.0: LOCKS.acquire(
        _ids_of(nodes), float(timeout)))
    register(lk + "readRelationships",
             lambda rels, timeout=10.0: LOCKS.acquire(
                 _ids_of(rels), float(timeout)))
    register(lk + "all", lambda timeout=10.0: LOCKS.acquire(
        ["__global__"], float(timeout)))
    register(lk + "tryLock", lambda items: LOCKS.try_acquire(
        _ids_of(items)))
    register(lk + "isLocked", lambda item: LOCKS.is_locked(
        _ids_of(item)[0]) if _ids_of(item) else False)
    register(lk + "unlockNodes", lambda nodes: LOCKS.release(
        _ids_of(nodes)))
    register(lk + "unlockRelationships", lambda rels: LOCKS.release(
        _ids_of(rels)))
    register(lk + "unlockBatch", lambda items: LOCKS.release(
        _ids_of(items)))
    register(lk + "unlockAll", lambda: LOCKS.release_all())
    register(lk + "clear", lambda: LOCKS.release_all())
    register(lk + "batch", lambda items, timeout=10.0: LOCKS.acquire(
        _ids_of(items), float(timeout)))
    register(lk + "stats", lambda: LOCKS.stats())
    register(lk + "detectDeadlock", lambda: {
        "deadlocks": [], "note": "lock keys are acquired in total order; "
        "cycles cannot form"})
    register(lk + "waitFor", lambda item, timeout=10.0: (
        LOCKS.acquire(_ids_of(item), float(timeout))
        and bool(LOCKS.release(_ids_of(item)) or True)))
    register(lk + "priority", lambda level=0: {"priority": int(level)})
    register(lk + "trylock", lambda items: LOCKS.try_acquire(
        _ids_of(items)))


# -- apoc.log -------------------------------------------------------------


class _LogRing:
    """In-memory log ring + timers, served behind apoc.log.* (reference
    apoc/log; tail/search/stream read the ring)."""

    LEVELS = ("trace", "debug", "info", "warn", "error")

    def __init__(self, cap: int = 2048):
        self.cap = cap
        self.entries: List[Dict[str, Any]] = []
        self.level = "info"
        self.timers: Dict[str, float] = {}
        self._lock = threading.Lock()

    def log(self, level: str, message: str, category: str = "general"):
        level = level if level in self.LEVELS else "info"
        if self.LEVELS.index(level) < self.LEVELS.index(self.level):
            return None
        entry = {"ts": _time.time(), "level": level,
                 "message": str(message), "category": category}
        with self._lock:
            self.entries.append(entry)
            if len(self.entries) > self.cap:
                del self.entries[: len(self.entries) - self.cap]
        py_level = {"trace": "debug", "warn": "warning"}.get(level, level)
        getattr(_log, py_level)("%s: %s", category, message)
        return entry["message"]

    def tail(self, n: int = 10) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.entries[-int(n):])

    def search(self, pattern: str) -> List[Dict[str, Any]]:
        import re as _re
        rx = _re.compile(str(pattern))
        with self._lock:
            return [e for e in self.entries if rx.search(e["message"])]

    def clear(self) -> int:
        with self._lock:
            n = len(self.entries)
            self.entries.clear()
            return n


LOG = _LogRing()


def _install_log() -> None:
    lg = "apoc.log."
    for level in ("trace", "debug", "info", "warn", "error"):
        register(lg + level,
                 (lambda lv: lambda message, *args: LOG.log(
                     lv, str(message) % tuple(args) if args else message))
                 (level))
    register(lg + "setLevel", lambda level: (
        setattr(LOG, "level", level) or level
        if level in _LogRing.LEVELS
        else _raise_level(level)))
    register(lg + "getLevel", lambda: LOG.level)
    register(lg + "tail", lambda n=10: LOG.tail(n))
    register(lg + "stream", lambda: LOG.tail(len(LOG.entries)))
    register(lg + "search", lambda pattern: LOG.search(pattern))
    register(lg + "clear", lambda: LOG.clear())
    register(lg + "rotate", lambda: LOG.clear())
    register(lg + "stats", lambda: {
        "entries": len(LOG.entries), "level": LOG.level,
        "byLevel": {lv: sum(1 for e in LOG.entries if e["level"] == lv)
                    for lv in _LogRing.LEVELS}})
    register(lg + "format", lambda fmt, *args: LOG.log(
        "info", str(fmt) % tuple(args)))
    register(lg + "custom", lambda category, message: LOG.log(
        "info", message, category=str(category)))
    register(lg + "audit", lambda message: LOG.log(
        "info", message, category="audit"))
    register(lg + "security", lambda message: LOG.log(
        "warn", message, category="security"))
    register(lg + "query", lambda message: LOG.log(
        "debug", message, category="query"))
    register(lg + "result", lambda message: LOG.log(
        "debug", message, category="result"))
    register(lg + "progress", lambda current, total, message="": LOG.log(
        "info", f"[{current}/{total}] {message}", category="progress"))

    def _timer(name, reset=False):
        now = _time.time()
        if reset or name not in LOG.timers:
            LOG.timers[name] = now
            return 0.0
        return (now - LOG.timers[name]) * 1000.0

    register(lg + "timer", _timer)

    def _memory():
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"maxRssKb": ru.ru_maxrss}

    register(lg + "memory", _memory)
    register(lg + "metrics", lambda: {
        "entries": len(LOG.entries),
        "timers": {k: (_time.time() - v) * 1000.0
                   for k, v in LOG.timers.items()}})
    register(lg + "performance", lambda: {
        "timers": {k: (_time.time() - v) * 1000.0
                   for k, v in LOG.timers.items()}})

    def _to_file(path):
        import json as _json
        with open(str(path), "a", encoding="utf-8") as f:
            for e in LOG.tail(len(LOG.entries)):
                f.write(_json.dumps(e) + "\n")
        return len(LOG.entries)

    register(lg + "toFile", _to_file)


def _raise_level(level):
    raise CypherRuntimeError(
        f"unknown log level {level!r}; expected one of "
        f"{', '.join(_LogRing.LEVELS)}")


# -- apoc.warmup ----------------------------------------------------------


def _install_warmup() -> None:
    wu = "apoc.warmup."

    def _catalog(ctx):
        return getattr(ctx.ex, "columnar", None)

    def _warm_nodes(ctx):
        cat = _catalog(ctx)
        n = len(cat.nodes()) if cat is not None else sum(
            1 for _ in ctx.storage.all_nodes())
        return {"nodesLoaded": n}

    def _warm_rels(ctx):
        cat = _catalog(ctx)
        total = 0
        if cat is not None:
            for t in cat.edge_types():
                total += len(cat.edge_table(t))
        else:
            total = sum(1 for _ in ctx.storage.all_edges())
        return {"relationshipsLoaded": total}

    def _warm_props(ctx):
        cat = _catalog(ctx)
        keys = set()
        for node in ctx.storage.all_nodes():
            keys.update(node.properties)
        if cat is not None:
            for k in keys:
                cat.node_prop_col(k)
        return {"propertyColumns": len(keys)}

    def _warm_indexes(ctx):
        cat = _catalog(ctx)
        built = 0
        if cat is not None:
            labels = {l for n in ctx.storage.all_nodes() for l in n.labels}
            for l in labels:
                cat.label_rows(l)
                built += 1
        return {"labelIndexes": built}

    def _run(ctx):
        out = {}
        out.update(_warm_nodes(ctx))
        out.update(_warm_rels(ctx))
        out.update(_warm_props(ctx))
        out.update(_warm_indexes(ctx))
        out["status"] = "ok"
        return out

    register_ctx(wu + "run", _run)
    register_ctx(wu + "runWithParams", lambda ctx, params=None: _run(ctx))
    register_ctx(wu + "nodes", _warm_nodes)
    register_ctx(wu + "relationships", _warm_rels)
    register_ctx(wu + "properties", _warm_props)
    register_ctx(wu + "indexes", _warm_indexes)
    register_ctx(wu + "cache", _run)
    register_ctx(wu + "clear", lambda ctx: (
        _catalog(ctx).invalidate() if _catalog(ctx) is not None else None,
        {"status": "cleared"})[1])
    register_ctx(wu + "stats", lambda ctx: {
        "nodeCount": ctx.storage.count_nodes(),
        "relCount": ctx.storage.count_edges(),
        "catalogVersion": getattr(_catalog(ctx), "version", None)})
    register_ctx(wu + "status", lambda ctx: {
        "warm": _catalog(ctx) is not None, "status": "ok"})
    register_ctx(wu + "progress", lambda ctx: {"progress": 1.0})
    register_ctx(wu + "optimize", lambda ctx: _run(ctx))
    register_ctx(wu + "subgraph", lambda ctx, label: {
        "nodesLoaded": len(ctx.storage.get_nodes_by_label(label))})
    register_ctx(wu + "path", lambda ctx, label=None: _run(ctx))

    def _schedule(ctx, interval_s=3600):
        return {"scheduled": False,
                "note": "use apoc.periodic.repeat('warmup', "
                        "'CALL apoc.warmup.run()', interval)"}

    register_ctx(wu + "schedule", _schedule)


def install() -> None:
    _install_atomic()
    _install_create()
    _install_merge()
    _install_refactor()
    _install_schema()
    _install_lock()
    _install_log()
    _install_warmup()


install()
