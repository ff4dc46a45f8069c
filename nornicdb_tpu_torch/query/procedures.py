"""CALL procedure implementations (counterpart of
``nornicdb_tpu/query/procedures.py``): the ``db.*`` and ``dbms.*``
procedures and ``gds.*`` (the graph catalog, host FastRP and host link
prediction, as the reference's); ``apoc.*`` dispatches to
``query/apoc.py:run_apoc_procedure``.

Reference: pkg/cypher/call.go:613 executeCall dispatch + the db.*/dbms.*
surface (call_vector.go:19 db.index.vector.queryNodes, call_fulltext.go,
executor_show.go).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List

from nornicdb_tpu_torch.errors import CypherRuntimeError


def _coerce_instant(v: Any):
    """Any temporal-ish value -> comparable instant (epoch seconds).
    Bare numbers are epoch MILLIS, matching the datetime() builtin's
    convention (temporal_types.make_datetime; Neo4j
    datetime({epochMillis: v})) so mixed string/numeric temporal
    properties compare on one scale."""
    from nornicdb_tpu_torch.query import temporal_types as T

    if v is None:
        return None
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v) / 1000.0
    if isinstance(v, str):
        return T.make_datetime(v)._epoch_seconds()
    if isinstance(v, (T.CypherDateTime, T.CypherLocalDateTime)):
        return v._epoch_seconds()
    if isinstance(v, T.CypherDate):
        return T.make_datetime(v)._epoch_seconds()
    raise CypherRuntimeError(f"not a datetime: {v!r}")


def _find_wal(storage):
    """Unwrap the engine chain to the WAL, if one is present."""
    eng = storage
    for _ in range(8):
        wal = getattr(eng, "wal", None)
        if wal is not None:
            return wal
        eng = getattr(eng, "inner", None)
        if eng is None:
            return None
    return None


def run_procedure(
    executor, name: str, args: List[Any], ctx
) -> Iterator[Dict[str, Any]]:
    name = name.lower()
    storage = ctx.storage

    if name == "db.labels":
        seen = {}
        for n in storage.all_nodes():
            for l in n.labels:
                seen[l] = None
        for l in sorted(seen):
            yield {"label": l}
        return

    if name == "db.relationshiptypes":
        seen = {}
        for e in storage.all_edges():
            seen[e.type] = None
        for t in sorted(seen):
            yield {"relationshipType": t}
        return

    if name == "db.propertykeys":
        seen = {}
        for n in storage.all_nodes():
            for k in n.properties:
                seen[k] = None
        for e in storage.all_edges():
            for k in e.properties:
                seen[k] = None
        for k in sorted(seen):
            yield {"propertyKey": k}
        return

    if name == "db.schema.visualization":
        labels = {}
        for n in storage.all_nodes():
            for l in n.labels:
                labels[l] = None
        yield {"nodes": sorted(labels), "relationships": []}
        return

    if name in ("dbms.components",):
        from nornicdb_tpu_torch import __version__

        yield {
            "name": "nornicdb-tpu",
            "versions": [__version__],
            "edition": "tpu",
        }
        return

    if name == "db.index.vector.querynodes":
        # (indexName, k, queryVector) — reference call_vector.go:19
        if len(args) < 3:
            raise CypherRuntimeError(
                "db.index.vector.queryNodes(indexName, k, vector)"
            )
        _index_name, k, vector = args[0], int(args[1]), args[2]
        svc = executor._search
        if svc is None:
            raise CypherRuntimeError("no search service wired")
        for node_id, score in svc.vector_search_candidates(vector, k):
            try:
                node = storage.get_node(node_id)
            except KeyError:
                continue
            yield {"node": node, "score": float(score)}
        return

    if name == "db.index.fulltext.querynodes":
        if len(args) < 2:
            raise CypherRuntimeError(
                "db.index.fulltext.queryNodes(indexName, query[, k])"
            )
        _index_name, query = args[0], args[1]
        k = int(args[2]) if len(args) > 2 else 10
        svc = executor._search
        if svc is None:
            raise CypherRuntimeError("no search service wired")
        for node_id, score in svc.bm25.search(query, k):
            try:
                node = storage.get_node(node_id)
            except KeyError:
                continue
            yield {"node": node, "score": float(score)}
        return

    if name == "db.temporal.asof":
        # (label, keyProp, keyValue, validFromProp, validToProp, asOf) —
        # most recent node whose [validFrom, validTo) covers asOf
        # (reference: call_temporal.go:98 callDbTemporalAsOf)
        if len(args) < 6:
            raise CypherRuntimeError(
                "db.temporal.asOf(label, keyProp, keyValue, validFromProp, "
                "validToProp, asOf)")
        label, key_prop, key_value, from_prop, to_prop, as_of = args[:6]
        as_of_v = _coerce_instant(as_of)
        if as_of_v is None:
            raise CypherRuntimeError("asOf must be a valid datetime")
        best = None
        best_from = None
        for n in storage.get_nodes_by_label(str(label)):
            if n.properties.get(key_prop) != key_value:
                continue
            vf = _coerce_instant(n.properties.get(from_prop))
            vt = n.properties.get(to_prop)
            vt_v = _coerce_instant(vt) if vt is not None else None
            if vf is None or vf > as_of_v:
                continue
            if vt_v is not None and vt_v <= as_of_v:
                continue
            if best_from is None or vf > best_from:
                best, best_from = n, vf
        if best is not None:
            yield {"node": best}
        return

    if name == "db.temporal.assertnooverlap":
        # (label, keyProp, validFromProp, validToProp, keyValue,
        #  newValidFrom, newValidTo) — reference: call_temporal.go:29
        if len(args) < 7:
            raise CypherRuntimeError(
                "db.temporal.assertNoOverlap requires 7 parameters")
        label, key_prop, from_prop, to_prop, key_value, nf, nt = args[:7]
        new_from = _coerce_instant(nf)
        if new_from is None:
            raise CypherRuntimeError("newValidFrom must be a valid datetime")
        new_to = _coerce_instant(nt) if nt is not None else None
        for n in storage.get_nodes_by_label(str(label)):
            if n.properties.get(key_prop) != key_value:
                continue
            vf = _coerce_instant(n.properties.get(from_prop))
            vt = n.properties.get(to_prop)
            vt_v = _coerce_instant(vt) if vt is not None else None
            if vf is None:
                continue
            # [vf, vt) overlaps [new_from, new_to)?
            starts_before_existing_ends = vt_v is None or new_from < vt_v
            existing_starts_before_new_ends = new_to is None or vf < new_to
            if starts_before_existing_ends and existing_starts_before_new_ends:
                raise CypherRuntimeError(
                    f"temporal overlap with node {n.id} "
                    f"[{n.properties.get(from_prop)}, "
                    f"{n.properties.get(to_prop)})")
        yield {"ok": True}
        return

    if name == "db.txlog.entries":
        # (fromSeq[, toSeq]) — reference: call_txlog.go:17; yields the
        # WAL's seq-tagged mutation history
        wal = _find_wal(executor.storage)
        if wal is None:
            raise CypherRuntimeError(
                "db.txlog.entries requires a WAL-backed engine")
        from_seq = int(args[0]) if args else 0
        to_seq = int(args[1]) if len(args) > 1 else None
        # drain the whole engine chain first: with async_writes the
        # AsyncEngine overlay holds committed mutations until flushed
        try:
            executor.storage.flush()
        except Exception:
            pass
        wal.flush()  # segment writes are buffered; readers open the file
        for rec in wal.iter_records(from_seq=max(0, from_seq - 1)):
            seq = rec.get("seq", 0)
            if seq < from_seq or (to_seq is not None and seq > to_seq):
                continue
            yield {"sequence": seq, "operation": rec.get("op", ""),
                   "data": rec.get("data", {})}
        return

    if name in ("db.awaitindex", "db.awaitindexes", "db.resampleindex",
                "db.resampleoutdatedindexes"):
        # indexes here are synchronous (label/type maps maintained on
        # write; columnar snapshots built lazily) — nothing to wait for
        # (reference: call_index_mgmt.go)
        yield {"ok": True}
        return

    if name.startswith("db.stats."):
        stats = getattr(executor, "_db_stats", None)
        if name == "db.stats.collect":
            executor._db_stats = {"collecting": True, "queries": 0}
            yield {"section": "QUERIES", "success": True,
                   "message": "collection started"}
            return
        if name == "db.stats.stop":
            if stats is not None:
                stats["collecting"] = False
            yield {"section": "QUERIES", "success": True,
                   "message": "collection stopped"}
            return
        if name == "db.stats.clear":
            executor._db_stats = None
            yield {"section": "QUERIES", "success": True,
                   "message": "cleared"}
            return
        if name == "db.stats.retrieve":
            yield {"section": "QUERIES",
                   "data": dict(stats or {}, **{
                       "cache": executor.query_cache.stats()})}
            return

    if name == "gds.version":
        yield {"version": "2.x-compat (nornicdb-tpu)"}
        return

    if name.startswith("gds.graph.") or name == "gds.fastrp.stream":
        # graph catalog + FastRP (reference: pkg/cypher/fastrp.go:8-26)
        from nornicdb_tpu_torch.ops.fastrp import GdsGraphCatalog

        catalog = getattr(executor, "gds_catalog", None)
        if catalog is None:
            catalog = GdsGraphCatalog()
            executor.gds_catalog = catalog
        if name == "gds.graph.project":
            if len(args) < 3:
                raise CypherRuntimeError(
                    "gds.graph.project(name, nodeProjection, relProjection)")
            g = catalog.project(storage, str(args[0]),
                                args[1] if args[1] != "*" else None,
                                args[2] if args[2] != "*" else None)
            yield {
                "graphName": g["name"], "nodeCount": g["nodeCount"],
                "relationshipCount": g["relationshipCount"],
                "nodeProjection": g["nodeProjection"],
                "relationshipProjection": g["relationshipProjection"],
            }
            return
        if name == "gds.graph.list":
            for g in catalog.list():
                yield {"graphName": g["name"], "nodeCount": g["nodeCount"],
                       "relationshipCount": g["relationshipCount"]}
            return
        if name == "gds.graph.drop":
            g = catalog.drop(str(args[0]) if args else "")
            if g is None:
                raise CypherRuntimeError(f"graph {args[0]!r} not found")
            yield {"graphName": g["name"]}
            return
        if name == "gds.fastrp.stream":
            if not args:
                raise CypherRuntimeError(
                    "gds.fastRP.stream(graphName, config)")
            cfg = args[1] if len(args) > 1 else {}
            cfg = cfg or {}
            try:
                ids, emb = catalog.fastrp(
                    str(args[0]),
                    dim=int(cfg.get("embeddingDimension", 64)),
                    iteration_weights=cfg.get("iterationWeights",
                                              (0.0, 1.0, 1.0)),
                    normalization_strength=float(
                        cfg.get("normalizationStrength", 0.0)),
                    seed=int(cfg.get("randomSeed", 42)),
                )
            except KeyError as e:
                raise CypherRuntimeError(str(e))
            for nid, vec in zip(ids, emb):
                yield {"nodeId": nid, "embedding": [float(x) for x in vec]}
            return

    if name.startswith("gds.linkprediction."):
        # Neo4j GDS link-prediction procedures (reference:
        # pkg/cypher/linkprediction.go:1-559 — always available, result
        # format {node1, node2, score}; hybrid predict adds
        # topology_score/semantic_score).
        from nornicdb_tpu_torch.linkpredict import hybrid_predict, predict_links

        method_map = {
            "gds.linkprediction.adamicadar.stream": "adamic_adar",
            "gds.linkprediction.commonneighbors.stream": "common_neighbors",
            "gds.linkprediction.jaccard.stream": "jaccard",
            "gds.linkprediction.preferentialattachment.stream":
                "preferential_attachment",
            "gds.linkprediction.resourceallocation.stream":
                "resource_allocation",
        }
        cfg = args[0] if args else {}
        if not isinstance(cfg, dict):
            raise CypherRuntimeError(
                "gds.linkPrediction.*.stream expects a configuration map "
                "{sourceNode, topK}"
            )
        source = cfg.get("sourceNode") or cfg.get("sourcenode")
        if source is None:
            raise CypherRuntimeError("configuration requires sourceNode")
        source_id = source.id if hasattr(source, "id") else str(source)
        top_k = int(cfg.get("topK", cfg.get("topk", 10)))
        if name in method_map:
            for nid, score in predict_links(
                storage, source_id, method=method_map[name], limit=top_k
            ):
                yield {"node1": source_id, "node2": nid, "score": float(score)}
            return
        if name == "gds.linkprediction.predict.stream":
            weight = float(cfg.get("topologyWeight",
                                   cfg.get("topologyweight", 0.5)))
            for nid, score, topo, sem in hybrid_predict(
                storage, executor._search, source_id,
                topology_weight=weight, limit=top_k,
            ):
                yield {
                    "node1": source_id, "node2": nid, "score": float(score),
                    "topology_score": float(topo),
                    "semantic_score": float(sem),
                }
            return
        raise CypherRuntimeError(f"unknown procedure {name}")

    if name.startswith("apoc."):
        from nornicdb_tpu_torch.query.apoc import run_apoc_procedure

        yield from run_apoc_procedure(executor, name, args, ctx)
        return

    raise CypherRuntimeError(f"unknown procedure {name}")
