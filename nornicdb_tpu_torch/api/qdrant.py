"""Qdrant-compatible translation layer: collections and points onto
storage and search (counterpart of ``nornicdb_tpu/api/qdrant.py``).

Collections are meta nodes and points labelled nodes (``_Qdrant:<name>``),
so they survive a restart and a data dir opens in either package; vectors
supplied by the client are authoritative and never re-embedded (the
embed queue and the search service skip ``_`` labels). Served over the
Qdrant REST wire format (``api/http_server.py``'s ``/collections``
routes) and gRPC (``api/grpc_server.py``, ``api/qdrant_official_grpc.py``).

Device work: each collection's ``BruteForceIndex`` lives in a registered
vector space (``vectorspace.py``, backend ``brute``) on the layer's
device, and a Cosine search rides the collection's ``MicroBatcher`` into
its batched search, B1 on the card (the ``cagra`` profile wraps the index
in a ``CagraIndex`` past its threshold). Dot and Euclid score the raw
client vectors in host NumPy, as the reference does. ``device=None``
means ``cuda``; the CPU is asked for by name.

Where the port differs (ROADMAP C42): the shadow audit's offer, which the
reference makes best effort, lets a device fault through.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike
from nornicdb_tpu_torch.errors import is_device_fault
from nornicdb_tpu_torch.obs import annotate as _obs_annotate
from nornicdb_tpu_torch.obs import attach_span as _obs_attach_span
from nornicdb_tpu_torch.obs import audit as _audit
from nornicdb_tpu_torch.obs import cost as _cost
from nornicdb_tpu_torch.obs import register_resource
from nornicdb_tpu_torch.obs import tenant as _tenant
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex
from nornicdb_tpu_torch.storage.types import Node, NotFoundError, now_ms

_META_PREFIX = "qdrant-meta/"
_POINT_PREFIX = "qdrant/"
_COLLECTION_LABEL = "_QdrantCollection"
_ALIAS_META_ID = "qdrant-meta-aliases"


class QdrantError(ValueError):
    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


def _point_node_id(collection: str, point_id: Any) -> str:
    return f"{_POINT_PREFIX}{collection}/{point_id}"


# per-instance ordinal for the upsert-convoy resource registration
_CONVOY_SEQ = itertools.count(1)


class QdrantCompat:
    """Collection + point operations with Qdrant semantics."""

    def __init__(self, storage, vector_registry=None, device: DeviceLike = None):
        from nornicdb_tpu_torch.cache import ResultCache
        from nornicdb_tpu_torch.vectorspace import VectorSpaceRegistry

        self.storage = storage
        # per-collection indexes live in registered vector spaces keyed
        # (db="qdrant", entity_type=collection), built on the registry's
        # device
        self.vector_registry = vector_registry or VectorSpaceRegistry(device)
        self.device = self.vector_registry.device
        # raw (unnormalized) vectors for Dot/Euclid collections:
        # name -> (ids, [N,D] matrix); invalidated on any point mutation
        self._raw: Dict[str, Any] = {}
        # search result cache — in the reference every public search
        # entrypoint (REST, gRPC, qdrant) shares the service's
        # searchResultCache (search.go:88-92); the qdrant surface here
        # has its own per-collection indexes, so it carries its own
        # ResultCache with the same semantics, invalidated on any point
        # or collection mutation. The generation is also how the gRPC
        # raw-bytes wire cache validates its entries.
        self._search_cache: ResultCache = ResultCache(self._copy_hit)
        # per-collection micro-batching: concurrent single-vector
        # searches (gRPC executor threads, REST worker threads) coalesce
        # into ONE batched index dispatch with power-of-two bucketed
        # shapes — the same leader-election window the native search
        # service rides (search/microbatch.py; SURVEY §7)
        self._microbatchers: Dict[str, Any] = {}
        # per-collection device graph ANN (profile cagra): wraps the
        # collection's brute index so the coalesced batches walk the
        # graph instead of scanning the matrix once N crosses the
        # profile threshold (search/cagra.py)
        self._cagra: Dict[str, Any] = {}
        # concurrent point upserts merge into one apply per collection:
        # one lock acquisition + one generation bump per convoy
        from nornicdb_tpu_torch.search.microbatch import BatchCoalescer

        self._upsert_coalescer = BatchCoalescer(
            self._apply_upsert_batch, self._apply_upsert_single,
            surface="qdrant:upsert_convoy")
        # write convoys get the same queue-depth gauge + /readyz
        # saturation check the search MicroBatchers have. The
        # registration name is per-INSTANCE (the resource registry keys
        # by (family, name) and replaces on collision, so two live
        # compat layers in one process must not shadow each other's
        # gauge); the stage-histogram surface label above stays fixed
        # to keep metric cardinality bounded.
        seq = next(_CONVOY_SEQ)
        self._convoy_resource_name = (
            "qdrant:upsert_convoy" if seq == 1
            else f"qdrant:upsert_convoy:{seq}")
        register_resource("queue", self._convoy_resource_name,
                          self._upsert_coalescer)
        self._lock = threading.Lock()
        # depth of in-progress writes by THIS layer (thread-local): its
        # own storage writes already maintain the indexes incrementally,
        # so the external-mutation listener must ignore them
        self._own = threading.local()

    # -- cross-surface invalidation --------------------------------------

    def _own_write(self):
        """Context manager marking storage writes issued by this layer."""
        compat = self

        class _Ctx:
            def __enter__(self):
                compat._own.depth = getattr(compat._own, "depth", 0) + 1

            def __exit__(self, *exc):
                compat._own.depth -= 1

        return _Ctx()

    def _on_external_mutation(self, node_id: str) -> None:
        """A qdrant-owned node changed through a NON-qdrant surface
        (Cypher SET/DELETE over Bolt/HTTP, GDPR delete, …). The cached
        per-collection index and any cached search results no longer
        reflect storage — drop them so the next read rebuilds lazily.
        (Reference analog: every mutation path invalidates the shared
        searchResultCache, search.go:88-92.)"""
        if getattr(self._own, "depth", 0) > 0:
            return
        name = None
        if node_id.startswith(_POINT_PREFIX):
            name = node_id[len(_POINT_PREFIX):].split("/", 1)[0]
        elif node_id.startswith(_META_PREFIX):
            name = node_id[len(_META_PREFIX):]
        elif node_id != _ALIAS_META_ID:
            return
        with self._lock:
            if name is not None:
                space = self.vector_registry.get(self._space_key(name))
                if space is not None:
                    space.index = None
                self._raw.pop(name, None)
                self._cagra.pop(name, None)
        self._clear_search_cache()

    def _space_key(self, name: str):
        from nornicdb_tpu_torch.vectorspace import DEFAULT_VECTOR_NAME, SpaceKey

        # dims intentionally 0 in the key: the collection's vector size
        # lives in its meta config, and a fixed key keeps lookups O(1)
        return SpaceKey(database="qdrant", entity_type=name,
                        vector_name=DEFAULT_VECTOR_NAME, dims=0,
                        metric="cosine")

    def _space(self, name: str):
        return self.vector_registry.register(self._space_key(name),
                                             backend="brute")

    # -- collections -----------------------------------------------------

    def create_collection(
        self, name: str, vectors: Optional[Dict[str, Any]] = None
    ) -> bool:
        """PUT /collections/{name}. vectors: {"size": N, "distance": "Cosine"}."""
        meta_id = _META_PREFIX + name
        if self.storage.has_node(meta_id):
            raise QdrantError(f"collection `{name}` already exists")
        distance = (vectors or {}).get("distance", "Cosine")
        if distance not in ("Cosine", "Dot", "Euclid"):
            raise QdrantError(f"unsupported distance {distance!r}")
        cfg = {
            "size": int((vectors or {}).get("size", 0)),
            "distance": distance,
        }
        with self._own_write():
            self.storage.create_node(Node(
                id=meta_id,
                labels=[_COLLECTION_LABEL],
                properties={"name": name, "config": cfg,
                            "created_at": now_ms()},
            ))
        with self._lock:
            idx = self._space(name).ensure_index()
        # device-memory/freshness gauges from birth; the lazy-rebuild
        # path (_index after restart/invalidation) re-registers the
        # replacement index under the same key
        register_resource("brute", f"qdrant:{name}", idx)
        # collection-list / collection-info responses are wire-cached by
        # the gRPC surfaces against this generation — a create must show
        # up in the next List/Get, same as every other mutation
        self._clear_search_cache()
        return True

    def delete_collection(self, name: str) -> bool:
        meta_id = _META_PREFIX + name
        if not self.storage.has_node(meta_id):
            return False
        with self._own_write():
            for node in self.storage.get_nodes_by_label(self._label(name)):
                self.storage.delete_node(node.id)
            self.storage.delete_node(meta_id)
        self._clear_search_cache()
        with self._lock:
            self.vector_registry.drop(self._space_key(name))
            self._raw.pop(name, None)
            self._cagra.pop(name, None)
            # drop the coalescer too: a recreated namesake may change
            # dims, and the batcher's dispatch must bind the new index
            self._microbatchers.pop(name, None)
            # upstream qdrant drops aliases with the collection; keeping
            # them would leave resolve() routing point ops at a missing
            # collection and block alias-name reuse
            aliases = self._alias_map()
            dangling = [a for a, c in aliases.items() if c == name]
            if dangling:
                for a in dangling:
                    del aliases[a]
                self._save_aliases(aliases)
        return True

    def list_collections(self) -> List[str]:
        return sorted(
            n.properties.get("name", "")
            for n in self.storage.get_nodes_by_label(_COLLECTION_LABEL)
        )

    def get_collection(self, name: str) -> Dict[str, Any]:
        name = self.resolve(name)
        meta = self._meta(name)
        return {
            "status": "green",
            "optimizer_status": "ok",
            "points_count": self.count_points(name),
            "indexed_vectors_count": len(self._index(name)),
            "segments_count": 1,
            "config": {
                "params": {"vectors": meta.properties.get("config", {})},
            },
        }

    def _meta(self, name: str) -> Node:
        try:
            return self.storage.get_node(_META_PREFIX + name)
        except (KeyError, NotFoundError):
            raise QdrantError(f"collection `{name}` not found", status=404)

    # -- aliases (reference: Collections/UpdateAliases etc.,
    # pkg/qdrantgrpc/server.go:658-665) --------------------------------

    def _alias_map(self) -> Dict[str, str]:
        try:
            node = self.storage.get_node(_ALIAS_META_ID)
            return dict(node.properties.get("aliases", {}))
        except (KeyError, NotFoundError):
            return {}

    def _save_aliases(self, aliases: Dict[str, str]) -> None:
        node = Node(id=_ALIAS_META_ID, labels=[_COLLECTION_LABEL + "Alias"],
                    properties={"aliases": aliases})
        with self._own_write():
            if self.storage.has_node(_ALIAS_META_ID):
                self.storage.update_node(node)
            else:
                self.storage.create_node(node)

    def resolve(self, name: str) -> str:
        """Alias -> collection name (identity when not an alias).
        Point/read operations accept aliases, like upstream qdrant.

        Every point/read op funnels through here, so this is also the
        tenant-refinement chokepoint: a request that arrived
        without an explicit tenant (header/metadata) derives one from
        the collection->tenant mapping — an explicit tenant always
        wins (refine never overrides it)."""
        resolved = self._alias_map().get(name, name)
        _tenant.refine(_tenant.tenant_for_collection(resolved))
        return resolved

    def update_aliases(self, actions: Sequence[Dict[str, Any]]) -> bool:
        """Atomic batch of alias ops. Each action is one of:
        {"create": {"alias": a, "collection": c}},
        {"rename": {"old": o, "new": n}}, {"delete": {"alias": a}}."""
        with self._lock:
            aliases = self._alias_map()
            for act in actions:
                if "create" in act:
                    a = act["create"]["alias"]
                    c = act["create"]["collection"]
                    if not self.storage.has_node(_META_PREFIX + c):
                        raise QdrantError(
                            f"collection `{c}` not found", status=404)
                    if self.storage.has_node(_META_PREFIX + a):
                        raise QdrantError(
                            f"alias `{a}` collides with a collection")
                    aliases[a] = c
                elif "rename" in act:
                    old = act["rename"]["old"]
                    new = act["rename"]["new"]
                    if old not in aliases:
                        raise QdrantError(f"alias `{old}` not found",
                                          status=404)
                    aliases[new] = aliases.pop(old)
                elif "delete" in act:
                    a = act["delete"]["alias"]
                    if a not in aliases:
                        raise QdrantError(f"alias `{a}` not found",
                                          status=404)
                    del aliases[a]
                else:
                    raise QdrantError(f"unknown alias action {act!r}")
            self._save_aliases(aliases)
        # an alias re-point changes what a cached search request bytes
        # resolve to — serving the old target for the TTL would break
        # the canonical blue/green alias-swap pattern
        self._clear_search_cache()
        return True

    def list_aliases(
        self, collection: Optional[str] = None
    ) -> List[Dict[str, str]]:
        return sorted(
            ({"alias_name": a, "collection_name": c}
             for a, c in self._alias_map().items()
             if collection is None or c == collection),
            key=lambda d: d["alias_name"],
        )

    # -- snapshots (reference: pkg/qdrantgrpc/snapshots_service.go) ------

    @staticmethod
    def _check_path_component(kind: str, value: str) -> str:
        """Reject names that could escape the snapshot tree. Both the
        HTTP and gRPC surfaces pass client strings straight into
        filesystem paths, so every component is validated here, at the
        single choke point, rather than per-route."""
        import os

        if (not value or value in (".", "..")
                or "/" in value or "\\" in value
                or os.sep in value or (os.altsep and os.altsep in value)
                or "\x00" in value):
            raise QdrantError(f"invalid {kind} {value!r}", status=400)
        return value

    def _snap_dir(self, base: str, name: Optional[str] = None) -> str:
        import os

        if name is not None:
            self._check_path_component("collection name", name)
        d = (os.path.join(base, "collections", name)
             if name else os.path.join(base, "full"))
        os.makedirs(d, exist_ok=True)
        return d

    def _snap_path(self, base_dir: str, snap_name: str,
                   collection: Optional[str] = None) -> str:
        """Resolved path of one snapshot file, guaranteed to live under
        the snapshot base dir (defense in depth on top of the component
        check: symlinked bases still can't be escaped via `..`)."""
        import os

        self._check_path_component("snapshot name", snap_name)
        d = self._snap_dir(base_dir, collection)
        path = os.path.join(d, snap_name)
        real_base = os.path.realpath(d)
        if os.path.commonpath(
            [real_base, os.path.realpath(path)]
        ) != real_base:
            raise QdrantError(f"invalid snapshot name {snap_name!r}",
                              status=400)
        return path

    def _snapshot_payload(self, name: str) -> Dict[str, Any]:
        meta = self._meta(name)
        points = []
        for node in self.storage.get_nodes_by_label(self._label(name)):
            points.append({
                "id": node.properties.get("_point_id"),
                "vector": node.properties.get("_vector") or [],
                "payload": node.properties.get("payload") or {},
            })
        return {
            "version": "nornicdb-tpu-qdrant-1",
            "collection": name,
            "config": meta.properties.get("config", {}),
            "points": points,
        }

    def create_snapshot(self, name: str, base_dir: str) -> Dict[str, Any]:
        import json as _json
        import os

        name = self.resolve(name)
        payload = self._snapshot_payload(name)
        ts = time.time()
        snap_name = f"{name}-{int(ts * 1e9)}.snapshot"
        path = os.path.join(self._snap_dir(base_dir, name), snap_name)
        with open(path, "w", encoding="utf-8") as f:
            _json.dump(payload, f)
        return {"name": snap_name, "size": os.path.getsize(path),
                "creation_time": ts}

    def list_snapshots(self, name: str, base_dir: str) -> List[Dict[str, Any]]:
        import os

        name = self.resolve(name)
        self._meta(name)
        d = self._snap_dir(base_dir, name)
        out = []
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".snapshot"):
                st = os.stat(os.path.join(d, fn))
                out.append({"name": fn, "size": st.st_size,
                            "creation_time": st.st_mtime})
        return out

    def delete_snapshot(self, name: str, snap_name: str,
                        base_dir: str) -> bool:
        import os

        name = self.resolve(name)
        path = self._snap_path(base_dir, snap_name, name)
        if not os.path.exists(path):
            raise QdrantError(f"snapshot `{snap_name}` not found",
                              status=404)
        os.remove(path)
        return True

    def create_full_snapshot(self, base_dir: str) -> Dict[str, Any]:
        """One archive of every collection (reference CreateFull)."""
        import json as _json
        import os

        ts = time.time()
        snap_name = f"full-{int(ts * 1e9)}.snapshot"
        payload = {
            "version": "nornicdb-tpu-qdrant-1",
            "collections": [self._snapshot_payload(n)
                            for n in self.list_collections()],
            "aliases": self._alias_map(),
        }
        path = os.path.join(self._snap_dir(base_dir), snap_name)
        with open(path, "w", encoding="utf-8") as f:
            _json.dump(payload, f)
        return {"name": snap_name, "size": os.path.getsize(path),
                "creation_time": ts}

    def list_full_snapshots(self, base_dir: str) -> List[Dict[str, Any]]:
        import os

        d = self._snap_dir(base_dir)
        out = []
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".snapshot"):
                st = os.stat(os.path.join(d, fn))
                out.append({"name": fn, "size": st.st_size,
                            "creation_time": st.st_mtime})
        return out

    def delete_full_snapshot(self, snap_name: str, base_dir: str) -> bool:
        import os

        path = self._snap_path(base_dir, snap_name)
        if not os.path.exists(path):
            raise QdrantError(f"snapshot `{snap_name}` not found",
                              status=404)
        os.remove(path)
        return True

    def recover_snapshot(self, name: str, snap_name: str,
                         base_dir: str) -> int:
        """Restore a collection from a snapshot file (drops current
        contents first). Returns restored point count."""
        import json as _json
        import os

        # resolve aliases like create/list/delete do — recovering by
        # alias must land on the collection the snapshot was written
        # under, not create a literal collection named like the alias
        name = self.resolve(name)
        path = self._snap_path(base_dir, snap_name, name)
        if not os.path.exists(path):
            raise QdrantError(f"snapshot `{snap_name}` not found",
                              status=404)
        with open(path, encoding="utf-8") as f:
            payload = _json.load(f)
        # aliases survive recovery (upstream qdrant keeps them): the
        # delete+recreate below would otherwise drop every alias of the
        # recovered collection via delete_collection's cleanup
        preserved = {a: c for a, c in self._alias_map().items()
                     if c == name}
        if self.storage.has_node(_META_PREFIX + name):
            self.delete_collection(name)
        self.create_collection(name, payload.get("config") or None)
        if preserved:
            with self._lock:
                aliases = self._alias_map()
                aliases.update(preserved)
                self._save_aliases(aliases)
        return self.upsert_points(name, payload.get("points", []))

    @staticmethod
    def _label(name: str) -> str:
        return f"_Qdrant:{name}"

    # -- index cache (reference: vector_index_cache.go) -------------------

    def _index(self, name: str) -> BruteForceIndex:
        with self._lock:
            space = self.vector_registry.get(self._space_key(name))
            if space is not None and space.index is not None:
                return space.index
        # lazy rebuild from storage (post-restart)
        self._meta(name)  # raises if collection doesn't exist
        idx = BruteForceIndex(device=self.device)
        for node in self.storage.get_nodes_by_label(self._label(name)):
            vec = node.properties.get("_vector")
            if vec:
                idx.add(node.id, vec)
        with self._lock:
            space = self._space(name)
            if space.index is None:
                space.index = idx
            # per-collection device-memory/freshness gauges; the metric
            # family's cardinality cap folds pathological collection
            # churn into __other__ instead of unbounded series
            register_resource("brute", f"qdrant:{name}", space.index)
            return space.index

    # -- points ----------------------------------------------------------

    def upsert_points(
        self, name: str, points: Sequence[Dict[str, Any]]
    ) -> int:
        """PUT /collections/{name}/points. Client vectors are
        authoritative (embedding-ownership rule, COMPAT.md:12-14).
        The whole batch is validated before any write so a bad point
        never leaves a partially-applied batch."""
        name = self.resolve(name)
        meta = self._meta(name)
        want = meta.properties.get("config", {}).get("size", 0)
        idx = self._index(name)
        if not want:
            want = idx.dims or 0
        # pass 1: validate everything — including float coercion, so a
        # non-numeric vector element fails here, before any write, and never
        # leaves a partially-applied batch
        coerced: List[List[float]] = []
        for p in points:
            if "id" not in p:
                raise QdrantError("point missing id")
            vec = p.get("vector") or []
            if vec:
                if want and len(vec) != want:
                    raise QdrantError(
                        f"vector size {len(vec)} != collection size {want}"
                    )
                want = want or len(vec)
                try:
                    coerced.append([float(x) for x in vec])
                except (TypeError, ValueError) as exc:
                    raise QdrantError(
                        f"point {p['id']}: non-numeric vector element ({exc})"
                    )
            else:
                coerced.append([])
        # pass 2: apply
        n = 0
        with self._own_write():
            for p, vec in zip(points, coerced):
                nid = _point_node_id(name, p["id"])
                node = Node(
                    id=nid,
                    labels=[self._label(name)],
                    properties={
                        "_point_id": p["id"],
                        "_vector": vec,
                        "payload": p.get("payload") or {},
                    },
                )
                if self.storage.has_node(nid):
                    self.storage.update_node(node)
                else:
                    self.storage.create_node(node)
                if vec:
                    idx.add(nid, vec)
                n += 1
        if n:
            self._invalidate_raw(name)
            # write-path pricing: bulk upserts were unpriced
            # — a flooding tenant looked free to the cost meter. Under
            # a convoy the coalescer's batch mix splits this across the
            # merged riders by tenant.
            if _cost.pricing_enabled() and want:
                flops, bytes_ = _cost.price_upsert(n, want)
                _cost.record_query_cost("upsert", f"qdrant:{name}",
                                        n, flops, bytes_)
        return n

    # -- microbatched point ops (gRPC serving path) ----------------------

    def upsert_points_coalesced(
        self, name: str, points: Sequence[Dict[str, Any]]
    ) -> int:
        """Upsert through the convoy coalescer: concurrent callers are
        merged into one ``upsert_points`` apply per collection (one
        validation pass, one index touch, ONE cache-generation bump for
        the whole convoy). Semantics match upsert_points — on a merged
        batch the caller's ack still covers exactly its own points.

        Bulk upsert convoys ride the BACKGROUND admission lane
        (interactive > replay > background): under pressure
        a multi-lane backlog seals interactive searches first, and the
        admission controller sheds convoys before reads."""
        from nornicdb_tpu_torch import admission as _adm

        with _adm.lane_scope(_adm.LANE_BACKGROUND):
            return self._upsert_coalescer.submit((name, list(points)))

    def _apply_upsert_batch(self, items):
        """Coalescer batch apply: merge per collection, ack per item.
        A raise falls back to _apply_upsert_single per item (upserts are
        idempotent node writes, so a partial merged apply followed by
        the single-item replay cannot double-count)."""
        groups: Dict[str, List[Any]] = {}
        order: List[str] = []
        for idx, (name, points) in enumerate(items):
            if name not in groups:
                groups[name] = []
                order.append(name)
            groups[name].append((idx, points))
        results = [0] * len(items)
        for name in order:
            merged: List[Dict[str, Any]] = []
            for _idx, pts in groups[name]:
                merged.extend(pts)
            self.upsert_points(name, merged)
            for idx, pts in groups[name]:
                results[idx] = len(pts)
        return results

    def _apply_upsert_single(self, item):
        name, points = item
        return self.upsert_points(name, points)

    def retrieve_points(
        self,
        name: str,
        ids: Sequence[Any],
        with_payload: bool = True,
        with_vector: bool = False,
    ) -> List[Dict[str, Any]]:
        name = self.resolve(name)
        self._meta(name)
        out = []
        for pid in ids:
            try:
                node = self.storage.get_node(_point_node_id(name, pid))
            except (KeyError, NotFoundError):
                continue
            out.append(self._point_dict(node, with_payload, with_vector))
        return out

    def delete_points(self, name: str, ids: Sequence[Any]) -> int:
        name = self.resolve(name)
        self._meta(name)
        idx = self._index(name)
        n = 0
        with self._own_write():
            for pid in ids:
                nid = _point_node_id(name, pid)
                if self.storage.has_node(nid):
                    self.storage.delete_node(nid)
                    idx.remove(nid)
                    n += 1
        if n:
            self._invalidate_raw(name)
        return n

    def count_points(self, name: str) -> int:
        name = self.resolve(name)
        self._meta(name)
        counter = getattr(self.storage, "count_nodes_by_label", None)
        if counter is not None:
            return counter(self._label(name))
        return len(self.storage.get_nodes_by_label(self._label(name)))

    def scroll_points(
        self,
        name: str,
        offset: Optional[Any] = None,
        limit: int = 10,
        with_payload: bool = True,
        with_vector: bool = False,
    ) -> Dict[str, Any]:
        name = self.resolve(name)
        self._meta(name)
        nodes = sorted(
            self.storage.get_nodes_by_label(self._label(name)),
            key=lambda n: str(n.properties.get("_point_id")),
        )
        if offset is not None:
            nodes = [
                n for n in nodes
                if str(n.properties.get("_point_id")) >= str(offset)
            ]
        page = nodes[:limit]
        next_off = (
            str(nodes[limit].properties.get("_point_id"))
            if len(nodes) > limit else None
        )
        return {
            "points": [
                self._point_dict(n, with_payload, with_vector) for n in page
            ],
            "next_page_offset": next_off,
        }

    def search_points(
        self,
        name: str,
        vector: Sequence[float],
        limit: int = 10,
        with_payload: bool = True,
        with_vector: bool = False,
        score_threshold: Optional[float] = None,
        query_filter: Optional[Dict[str, Any]] = None,
    ) -> List[Dict[str, Any]]:
        """POST /collections/{name}/points/search — brute-force device
        kNN over the collection's index (reference: search path
        points_service.go via SearchServiceProvider, server.go:167).

        Distance semantics follow the collection config: Cosine rides
        the normalized device index; Dot/Euclid score the raw client
        vectors (magnitudes preserved; Euclid scores are negated
        distances so higher-is-better ordering holds uniformly, with
        score_threshold compared on the true distance)."""
        if not vector:
            raise QdrantError("search vector is required")
        name = self.resolve(name)
        # bool() on the selectors: REST clients may pass list/dict
        # selectors (unhashable), and _point_dict only uses truthiness
        cache_key = (
            name, bytes(np.asarray(vector, np.float32).data), limit,
            bool(with_payload), bool(with_vector), score_threshold,
            None if query_filter is None
            else json.dumps(query_filter, sort_keys=True, default=str),
        )
        cached = self._search_cache.get_hits(cache_key)
        if cached is not None:
            _obs_annotate(result_cache="hit")
            return cached
        gen_at_miss = self._search_cache.generation
        meta = self._meta(name)
        # reject wrong-sized vectors HERE, with a 400-class error, before
        # the query can reach the shared microbatcher (a dim mismatch
        # inside a coalesced np.stack would fail the whole convoy with a
        # bare ValueError) or the raw-matrix broadcast
        want = meta.properties.get("config", {}).get("size", 0)
        if want and len(vector) != want:
            raise QdrantError(
                f"search vector size {len(vector)} != collection "
                f"size {want}")
        distance = meta.properties.get("config", {}).get("distance", "Cosine")
        if distance == "Cosine":
            ranked = self._ranked_cosine(name, vector)
        else:
            ranked = self._ranked_raw(name, vector, distance)
        # the rank generator runs lazily inside the loop below, so this
        # stamp-and-graft interval covers the real device work; the
        # MicroBatcher's coalesce-wait/dispatch spans land as siblings
        t_rank = time.time()
        out = []
        for nid, score in ranked:
            if score_threshold is not None:
                true_score = -score if distance == "Euclid" else score
                if distance == "Euclid":
                    if true_score > score_threshold:
                        continue
                elif true_score < score_threshold:
                    continue
            try:
                node = self.storage.get_node(nid)
            except (KeyError, NotFoundError):
                continue
            if query_filter is not None and not _match_filter(
                node.properties.get("payload") or {}, query_filter,
                point_id=node.properties.get("_point_id"),
            ):
                continue
            d = self._point_dict(node, with_payload, with_vector)
            d["score"] = float(-score if distance == "Euclid" else score)
            out.append(d)
            if len(out) >= limit:
                break
        if distance == "Cosine":
            # the ANN first round can under-fill (stale-graph filtering
            # or walk misses) and the exact widening rounds then append
            # higher-scored hits AFTER it — re-sort so the response
            # honors the score-desc contract. Exact-only paths are
            # already ordered, so this is a no-op for them.
            out.sort(key=lambda d: -d["score"])
        _obs_attach_span("qdrant.rank", t_rank, time.time(),
                         collection=name, distance=distance)
        return self._search_cache.put_guarded(cache_key, out,
                                              gen_at_miss)

    def _collection_microbatch(self, name: str):
        """Per-collection MicroBatcher over the index's batched search.
        The dispatch closure re-resolves the index per batch, so an
        invalidation/rebuild between batches binds the fresh index."""
        from nornicdb_tpu_torch.search.microbatch import MicroBatcher

        with self._lock:
            mb = self._microbatchers.get(name)
            if mb is None:
                mb = MicroBatcher(
                    lambda queries, k, _n=name:
                        self._ann_search_index(_n).search_batch(queries, k),
                    # one bounded stage label for ALL collections — the
                    # per-collection split lives in the resource gauges,
                    # not in histogram label cardinality
                    surface="qdrant",
                    # rider-level serving-tier attribution:
                    # the dispatch path (brute/cagra/quant plane) notes
                    # the rung that answered, each rider records it
                    tier_surface="vector")
                self._microbatchers[name] = mb
                register_resource("queue", f"qdrant:{name}", mb)
            return mb

    def _ann_search_index(self, name: str):
        """The index the coalesced batches dispatch to: the collection's
        brute index, wrapped by the device graph ANN when the profile
        selects cagra and the collection has crossed its threshold. The
        wrapper shares the brute index (zero vector copies) and rebuilds
        its graph off the brute mutation counter; a collection-index
        invalidation (external mutation, lazy rebuild) is caught by the
        identity check and re-wraps the fresh index."""
        idx = self._index(name)
        from nornicdb_tpu_torch.search.ann_quality import current_profile

        p = current_profile()
        if p.index_kind != "cagra" or len(idx) < p.cagra_min_n:
            # drop any retired wrapper: a collection that shrank below
            # the threshold (or a profile switch) must not pin the old
            # graph's device arrays in memory until collection delete
            with self._lock:
                self._cagra.pop(name, None)
            return idx
        from nornicdb_tpu_torch.search.ann_quality import cagra_shards_from_env
        from nornicdb_tpu_torch.search.cagra import CagraIndex

        with self._lock:
            wrap = self._cagra.get(name)
            if wrap is None or wrap._brute is not idx:
                # build_inline=False: the first graph build happens in
                # background too — a search convoy crossing the size
                # threshold serves the exact brute kernel instead of
                # stalling its MicroBatcher leader for the device kNN
                wrap = CagraIndex(
                    brute=idx, degree=p.cagra_degree, itopk=p.cagra_itopk,
                    search_width=p.cagra_width, min_n=p.cagra_min_n,
                    n_shards=cagra_shards_from_env(p.cagra_shards),
                    build_inline=False)
                self._cagra[name] = wrap
                register_resource("cagra", f"qdrant:{name}", wrap)
            return wrap

    def _maybe_shadow_vector(self, idx, q, k: int, hits) -> None:
        """Offer one coalesced, device-served collection search to the
        shadow-parity auditor (reference: the exact brute scan of the
        same index, executed on the audit worker). Best-effort."""
        if not _audit.sampling_active():
            return
        tier = _audit.last_served()
        if tier is None or tier == "host":
            return
        try:
            qv = np.asarray(q, dtype=np.float32)

            def versions_now():
                return {"brute_mutations": getattr(idx, "mutations", 0)}

            # (id, score) pairs: exact tiers score tie-aware rank
            # parity (padded-batch vs b=1 tie permutations are parity)
            _audit.maybe_sample(
                "vector", tier, [(i, float(s)) for i, s in hits],
                k=min(10, k),
                ref=lambda: [(i, float(s)) for i, s in idx.search_batch(
                    qv[None, :], k, exact=True)[0]],
                versions=versions_now(), versions_now=versions_now,
                query={"k": k})
        except Exception as exc:  # noqa: BLE001
            if is_device_fault(exc):
                raise  # never hidden behind the audit's offer (C42)

    def _ranked_cosine(self, name: str, vector: Sequence[float]):
        """Yield (node_id, cosine) best-first, progressively widening the
        kNN so selective filters still fill `limit` (a fixed 4x
        oversample starves on rare payloads).

        The first (and almost always only) round routes through the
        collection's MicroBatcher: concurrent single-vector searches
        from any surface coalesce into one power-of-two-bucketed batch
        dispatch. Widening rounds (selective filters) are rare and go
        direct — their k varies too much to bucket usefully."""
        idx = self._index(name)
        total = len(idx)
        k = 40
        first = True
        # dedupe by id, not by list position: the batched round-1 call
        # (GEMM over a padded batch) and the direct widening calls can
        # order float near-ties differently, so positional continuation
        # could re-yield or drop a boundary point
        yielded = set()
        q = np.asarray(vector, dtype=np.float32)
        while True:
            k_req = min(k, total) if total else k
            if first:
                hits = self._collection_microbatch(name).search(q, k_req)
                self._maybe_shadow_vector(idx, q, k_req, hits)
                first = False
                # a short FIRST round is not exhaustion: the ANN wrapper
                # (cagra) live-filters rows deleted since its build, so
                # it can return < k while thousands of live rows remain.
                # Widening rounds query the brute index directly and ARE
                # authoritative.
                ann_round = True
            else:
                hits = idx.search(q, k=k_req)
                ann_round = False
            for nid, score in hits:
                if nid in yielded:
                    continue
                yielded.add(nid)
                yield nid, score
            if len(yielded) >= total:
                return
            if len(hits) < k and not ann_round:
                return
            k *= 4

    def _raw_matrix(self, name: str, dims: int):
        """Cached (ids, [N,D]) raw-vector matrix for Dot/Euclid — the
        analog of the normalized index cache; rebuilt only after a point
        mutation invalidates it (a per-query storage scan would be O(N)
        reads on every search)."""
        with self._lock:
            cached = self._raw.get(name)
        if cached is not None and cached[1].shape[1] == dims:
            return cached
        ids: List[str] = []
        rows: List[List[float]] = []
        for node in self.storage.get_nodes_by_label(self._label(name)):
            vec = node.properties.get("_vector")
            if vec and len(vec) == dims:
                ids.append(node.id)
                rows.append(vec)
        m = np.asarray(rows, dtype=np.float32) if rows else np.zeros(
            (0, dims), np.float32)
        with self._lock:
            self._raw[name] = (ids, m)
        return ids, m

    def _clear_search_cache(self) -> None:
        self._search_cache.bump_generation()

    @property
    def cache_gen(self) -> int:
        return self._search_cache.generation

    @staticmethod
    def _copy_hit(d: Dict[str, Any]) -> Dict[str, Any]:
        """Cache-safe copy: _point_dict shares the node's payload dict
        by reference, so a caller mutating hit['payload'] must not
        rewrite the cached entry."""
        from nornicdb_tpu_torch.search.service import _copy_tree

        c = dict(d)
        if "payload" in c:
            c["payload"] = _copy_tree(c["payload"])
        if "vector" in c:
            c["vector"] = list(c["vector"])
        return c

    def _invalidate_raw(self, name: str) -> None:
        with self._lock:
            self._raw.pop(name, None)
        self._clear_search_cache()

    def _ranked_raw(self, name: str, vector: Sequence[float], distance: str):
        """Dot / Euclid over the raw (unnormalized) client vectors.
        Euclid yields NEGATED distances so callers sort uniformly
        best-first."""
        q = np.asarray(vector, dtype=np.float32)
        ids, m = self._raw_matrix(name, len(q))
        if not ids:
            return
        if distance == "Dot":
            scores = m @ q
        else:  # Euclid
            scores = -np.linalg.norm(m - q[None, :], axis=1)
        for i in np.argsort(-scores):
            yield ids[int(i)], float(scores[int(i)])

    @staticmethod
    def _point_dict(
        node: Node, with_payload: bool, with_vector: bool
    ) -> Dict[str, Any]:
        d: Dict[str, Any] = {"id": node.properties.get("_point_id"),
                             "version": 0}
        if with_payload:
            d["payload"] = node.properties.get("payload") or {}
        if with_vector:
            d["vector"] = node.properties.get("_vector") or []
        return d


def _match_filter(payload: Dict[str, Any], flt: Dict[str, Any],
                  point_id: Optional[Any] = None) -> bool:
    """Qdrant filter subset: must / should / must_not with
    match.value / match.any / range / has_id / is_null / is_empty
    conditions on payload keys."""
    for cond in flt.get("must", []):
        if not _match_condition(payload, cond, point_id):
            return False
    for cond in flt.get("must_not", []):
        if _match_condition(payload, cond, point_id):
            return False
    should = flt.get("should", [])
    if should and not any(
        _match_condition(payload, c, point_id) for c in should
    ):
        return False
    return True


def _match_condition(payload: Dict[str, Any], cond: Dict[str, Any],
                     point_id: Optional[Any] = None) -> bool:
    if "filter" in cond:  # nested filter
        return _match_filter(payload, cond["filter"], point_id)
    if "has_id" in cond:
        wanted = {str(x) for x in cond["has_id"]}
        return point_id is not None and str(point_id) in wanted
    if "is_null" in cond:
        # accepts both the REST wire shape {"is_null": {"key": k}} and the
        # gRPC-normalized bare string
        k = cond["is_null"]
        if isinstance(k, dict):
            k = k.get("key")
        return k in payload and payload[k] is None
    if "is_empty" in cond:
        k = cond["is_empty"]
        if isinstance(k, dict):
            k = k.get("key")
        v = payload.get(k)
        return v is None or v == [] or v == ""
    key = cond.get("key")
    if key is None:
        return True
    value = payload
    for part in str(key).split("."):
        if isinstance(value, dict) and part in value:
            value = value[part]
        else:
            return False
    match = cond.get("match")
    if match is not None:
        if "value" in match:
            return value == match["value"]
        if "any" in match:
            return value in match["any"]
        if "text" in match:
            return str(match["text"]).lower() in str(value).lower()
    rng = cond.get("range")
    if rng is not None:
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        if "gt" in rng and not v > rng["gt"]:
            return False
        if "gte" in rng and not v >= rng["gte"]:
            return False
        if "lt" in rng and not v < rng["lt"]:
            return False
        if "lte" in rng and not v <= rng["lte"]:
            return False
        return True
    return True
