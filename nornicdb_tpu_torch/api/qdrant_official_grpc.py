"""The official Qdrant gRPC wire contract served over the Qdrant layer
(counterpart of ``nornicdb_tpu/api/qdrant_official_grpc.py``).

``api/proto/qdrant.proto`` replicates the upstream package (``qdrant``),
its service names (``qdrant.Collections``, ``qdrant.Points``,
``qdrant.Snapshots``), method names and field numbers, so official Qdrant
client SDKs speak to this server unmodified; handlers are registered
generically (no generated service stubs).

Serving path: handlers are ``grpc.aio`` coroutines on one event loop,
registered raw (no deserializer or serializer), so the server moves
request and response bytes:

- hot reads (Search, Scroll, Count, Get, collection info) probe a shared
  ``cache.WireCache`` first: the same request bytes against an unchanged
  generation return the cached response inline on the loop;
- misses and writes run on a small executor, where concurrent Search and
  Upsert calls coalesce through the layer's ``MicroBatcher`` (B1 on the
  card) and ``BatchCoalescer``;
- fixed-shape acks are pre-serialized templates with the ``time`` field
  appended;
- admission sheds work by lane (``RESOURCE_EXHAUSTED`` with a retry
  pushback), and an expired deadline answers ``DEADLINE_EXCEEDED``.

``grpc`` and ``google.protobuf`` are imported by this module and the
modules under ``api/proto``, and by nothing else of the port but
``api/grpc_server.py``. Where the port differs (ROADMAP C42): a device
fault (``errors.is_device_fault``) is answered ``INTERNAL`` with its
message, where the reference lets it escape the handler (``UNKNOWN``).
"""

from __future__ import annotations

import asyncio
import contextvars
import os
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import grpc

from nornicdb_tpu_torch import admission as _adm
from nornicdb_tpu_torch import obs
from nornicdb_tpu_torch.api.proto import qdrant_pb2 as q
from nornicdb_tpu_torch.api.qdrant import QdrantError, _match_filter
from nornicdb_tpu_torch.errors import is_device_fault
from nornicdb_tpu_torch.obs import tenant as _tenant

# per-surface, per-method request latency (tentpole: real histograms,
# not gauges). Method label cardinality is bounded by the proto surface.
_GRPC_H = obs.REGISTRY.histogram(
    "nornicdb_grpc_request_seconds",
    "gRPC request latency by method (both aio surfaces)",
    labels=("method",))

# large-response serialization runs on THIS dedicated pool, not the
# shared compute executor and never the event loop: a 10MB
# Scroll page flattening to bytes must not occupy a coalescing compute
# thread nor stall the loop's cache hits. Lazily built; responses under
# the threshold keep serializing inline in their compute hop.
_ser_pool = None
_ser_lock = threading.Lock()


def _serializer_pool():
    global _ser_pool
    if _ser_pool is None:
        with _ser_lock:
            if _ser_pool is None:
                from concurrent import futures

                _ser_pool = futures.ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="grpc-serialize")
    return _ser_pool


def serialize_offload_threshold() -> int:
    """Responses whose ``ByteSize()`` exceeds this serialize on the
    dedicated serializer pool (``NORNICDB_WIRE_SERIALIZE_OFFLOAD_BYTES``,
    default 256KB; 0 offloads everything, -1 disables offload)."""
    try:
        return int(os.environ.get(
            "NORNICDB_WIRE_SERIALIZE_OFFLOAD_BYTES", str(256 * 1024)))
    except ValueError:
        return 256 * 1024


def _serialize_timed(out) -> bytes:
    t0 = time.perf_counter()
    data_out = out.SerializeToString()
    obs.record_stage("grpc", "serialize", time.perf_counter() - t0)
    return data_out


def _iter_matching_points(compat, name: str, flt: Optional[Dict[str, Any]],
                          with_payload: bool = True,
                          with_vector: bool = False):
    """Stream points of a collection in scroll (id) order, filtered.
    Pages through scroll_points so no full-collection materialization or
    silent cap is involved."""
    offset = None
    while True:
        page = compat.scroll_points(name, offset=offset, limit=10_000,
                                    with_payload=True,
                                    with_vector=with_vector)
        for d in page["points"]:
            if flt is None or _match_filter(
                d.get("payload") or {}, flt, point_id=d["id"]
            ):
                if not with_payload:
                    d = {**d, "payload": None}
                yield d
        offset = page.get("next_page_offset")
        if offset is None:
            return


# -- value conversion -----------------------------------------------------


def value_to_py(v: "q.Value") -> Any:
    kind = v.WhichOneof("kind")
    if kind is None or kind == "null_value":
        return None
    if kind == "struct_value":
        return {k: value_to_py(x) for k, x in v.struct_value.fields.items()}
    if kind == "list_value":
        return [value_to_py(x) for x in v.list_value.values]
    return getattr(v, kind)


def py_to_value(x: Any) -> "q.Value":
    v = q.Value()
    if x is None:
        v.null_value = q.NULL_VALUE
    elif isinstance(x, bool):
        v.bool_value = x
    elif isinstance(x, int):
        v.integer_value = x
    elif isinstance(x, float):
        v.double_value = x
    elif isinstance(x, str):
        v.string_value = x
    elif isinstance(x, dict):
        for k, item in x.items():
            v.struct_value.fields[str(k)].CopyFrom(py_to_value(item))
    elif isinstance(x, (list, tuple)):
        v.list_value.values.extend(py_to_value(i) for i in x)
    else:
        v.string_value = str(x)
    return v


def point_id_to_py(pid: "q.PointId") -> Any:
    which = pid.WhichOneof("point_id_options")
    if which == "num":
        return int(pid.num)
    return pid.uuid


def py_to_point_id(x: Any) -> "q.PointId":
    pid = q.PointId()
    # stored point ids round-trip as strings; numeric strings go back out
    # as the numeric id form the client upserted
    try:
        pid.num = int(x)
    except (TypeError, ValueError):
        pid.uuid = str(x)
    return pid


def filter_to_dict(flt: "q.Filter") -> Optional[Dict[str, Any]]:
    if not (flt.must or flt.should or flt.must_not):
        return None

    def cond_to_dict(c: "q.Condition") -> Dict[str, Any]:
        which = c.WhichOneof("condition_one_of")
        if which == "field":
            fc = c.field
            out: Dict[str, Any] = {"key": fc.key}
            mwhich = fc.match.WhichOneof("match_value")
            if mwhich == "keyword":
                out["match"] = {"value": fc.match.keyword}
            elif mwhich == "integer":
                out["match"] = {"value": int(fc.match.integer)}
            elif mwhich == "boolean":
                out["match"] = {"value": fc.match.boolean}
            elif mwhich == "text":
                out["match"] = {"text": fc.match.text}
            elif mwhich is not None:
                raise QdrantError(f"unsupported match kind {mwhich!r}")
            rng = {}
            for field in ("lt", "gt", "gte", "lte"):
                if fc.range.HasField(field):
                    rng[field] = getattr(fc.range, field)
            if rng:
                out["range"] = rng
            if "match" not in out and "range" not in out:
                raise QdrantError(
                    f"field condition on {fc.key!r} has no supported "
                    "match or range clause")
            return out
        if which == "has_id":
            ids = [point_id_to_py(p) for p in c.has_id.has_id]
            return {"has_id": ids}
        if which == "filter":
            return {"filter": filter_to_dict(c.filter) or {}}
        if which == "is_null":
            return {"is_null": c.is_null.key}
        if which == "is_empty":
            return {"is_empty": c.is_empty.key}
        raise QdrantError(f"unsupported filter condition {which!r}")

    return {
        "must": [cond_to_dict(c) for c in flt.must],
        "should": [cond_to_dict(c) for c in flt.should],
        "must_not": [cond_to_dict(c) for c in flt.must_not],
    }


def _with_payload(sel: "q.WithPayloadSelector") -> bool:
    which = sel.WhichOneof("selector_options")
    if which is None:
        return True  # qdrant default for search is payload on
    if which == "enable":
        return sel.enable
    return True  # include/exclude subset: return full payload


def _with_vectors(msg, field: str = "with_vectors") -> bool:
    if not msg.HasField(field):
        return False
    sel = getattr(msg, field)
    which = sel.WhichOneof("selector_options")
    if which == "enable":
        return sel.enable
    return which is not None


def grpc_status_of(e: Exception) -> grpc.StatusCode:
    if isinstance(e, QdrantError) and getattr(e, "status", 400) == 404:
        return grpc.StatusCode.NOT_FOUND
    if getattr(e, "status", 400) == 503:
        return grpc.StatusCode.UNAVAILABLE
    return grpc.StatusCode.INVALID_ARGUMENT


# methods that perform admitted WORK (device dispatch, storage scans,
# merged applies) and therefore pass through admission control; cheap
# metadata reads are never shed. Resolved once per handler BUILD —
# the per-request path pays one `is not None` check.
_SHED_METHODS = ("Search", "Query", "Hybrid", "Upsert", "Scroll",
                 "Recommend", "Count", "Delete", "SetPayload")


def _shed_lane_of(method: str) -> Optional[str]:
    tail = method.rsplit("/", 1)[-1]
    if not any(tail.startswith(m) for m in _SHED_METHODS):
        return None
    # bulk upsert convoys and point deletes ride the BACKGROUND lane
    # (interactive > replay > background rebuild/bulk upsert
    # convoy) — under pressure, writes shed before reads
    if tail.startswith(("Upsert", "Delete", "SetPayload")):
        return _adm.LANE_BACKGROUND
    return _adm.LANE_INTERACTIVE


# -- aio handler plumbing (shared with api/grpc_server.py) ----------------


def _fresh_time_tag(resp_cls):
    """(1-byte protobuf tag, unit scale) of the response's ``time``/
    ``took_ms`` double field, if it has one — used to stamp cache hits
    with THIS request's serving time (scalar fields are last-wins, so
    appending overrides the stale value frozen into the cached bytes).
    ``time`` is seconds (qdrant contract); ``took_ms`` milliseconds."""
    if resp_cls is None:
        return None
    for fname, scale in (("time", 1.0), ("took_ms", 1e3)):
        fd = resp_cls.DESCRIPTOR.fields_by_name.get(fname)
        if fd is not None and fd.type == fd.TYPE_DOUBLE and fd.number < 16:
            return bytes([(fd.number << 3) | 1]), scale  # wire type 1
    return None


def aio_unary_raw(
    fn: Callable[[bytes], Any],
    *,
    method: str = "",
    wire=None,
    gen: Optional[Callable[[], int]] = None,
    executor=None,
    error_cls=QdrantError,
    resp_cls=None,
):
    """Raw-bytes aio unary handler around ``fn(request_bytes) -> response
    message | bytes``.

    Wire-cache hits return serialized bytes inline on the event loop (no
    protobuf, no executor hop); when ``resp_cls`` exposes a time/took_ms
    double, the hit gets a fresh 9-byte time field appended so clients
    see THIS request's latency, not the miss's. Everything else runs on
    ``executor`` so a slow compute can't stall the loop. ``error_cls``
    exceptions map to gRPC status via :func:`grpc_status_of`."""
    time_tag = scale = None
    cached_served = None
    cached_surf = None
    if wire is not None:
        tagged = _fresh_time_tag(resp_cls)
        if tagged is not None:
            time_tag, scale = tagged
        if "Search" in method or "Query" in method \
                or method.endswith("/Hybrid"):
            # serving-tier mix: a wire-cache hit on a search
            # RPC answered from cached bytes — no ladder rung executed.
            # Surface by RPC semantics: only the nornic Hybrid RPC is
            # the hybrid surface; every other search-shaped method
            # (/qdrant.Points/Search, nornic QdrantService points ops,
            # nornic SearchService/Search) is a vector search. Child
            # resolved once per handler build; hit path pays one
            # striped inc, no labels() probe.
            surf = "hybrid" if method.endswith("/Hybrid") else "vector"
            cached_served = obs.audit.served_counter(surf, "cached")
            cached_surf = surf

    # the offload threshold is resolved ONCE per handler build (server
    # construction), not per response: a per-query os.environ read on
    # the hottest surface costs real throughput
    def serve(data: bytes, _threshold=serialize_offload_threshold()):
        out = fn(data)
        if isinstance(out, bytes):
            return out
        # serialize stage: message -> wire bytes (the parse stage is
        # timed symmetrically in _parse); pre-serialized ack templates
        # and cache hits return bytes above and skip both. LARGE
        # responses return the message unflattened — the handler hops
        # them to the dedicated serializer pool so neither the event
        # loop nor a coalescing compute thread pays for the flatten.
        if _threshold >= 0 and out.ByteSize() > _threshold:
            return out
        return _serialize_timed(out)

    latency = _GRPC_H.labels(method or "unknown")
    # admission pre-gate: which lane this method sheds on,
    # resolved once per handler build. None = never shed (cheap
    # metadata reads); cache HITS are served even under overload —
    # a hit costs nothing and is pure goodput.
    shed_lane = _shed_lane_of(method) if method else None

    async def handler(data: bytes, context):
        g = 0
        t0 = time.time()
        # tenant resolution: explicit x-nornic-tenant
        # metadata, else the namespace default — a non-explicit tenant
        # is refined by the qdrant collection->tenant mapping once the
        # op resolves its collection (the contextvar cell crosses the
        # executor hop with copy_context below)
        try:
            md = dict(context.invocation_metadata() or ())
            ten_hdr = md.get(_tenant.GRPC_METADATA_KEY)
        except Exception:  # noqa: BLE001 — metadata API absent in tests
            ten_hdr = None
        ten, ten_explicit = _tenant.resolve(ten_hdr, None, None)
        # root span per RPC: grpc.aio runs each handler in its own
        # asyncio task (own contextvar context), so concurrent RPCs
        # never share a current-span slot
        with _tenant.tenant_scope(ten, explicit=ten_explicit), \
                obs.trace("wire", method=method,
                          transport="grpc") as root:
            if wire is not None:
                g = gen()
                hit = wire.get(method, data, g)
                if hit is not None:
                    root.annotate(cache="hit")
                    if cached_served is not None:
                        root.annotate(served_by="cached")
                        cached_served.inc()
                        # the plane-wide counter above bypasses
                        # audit.record_served, so the per-tenant side
                        # records here — a cache hit is still this
                        # tenant's request (attribution completeness)
                        _tenant.record_served(cached_surf, "cached",
                                              seconds=time.time() - t0)
                    latency.observe(time.time() - t0)
                    if time_tag is not None:
                        return (hit + time_tag + struct.pack(
                            "<d", (time.time() - t0) * scale))
                    return hit
            # deadline budget minted at ingress: the
            # client's gRPC deadline when one rode the RPC, else the
            # surface default derived from the SLO objective; visible
            # on the trace root (acceptance: budget at ingress)
            try:
                budget = context.time_remaining()
            except Exception:  # noqa: BLE001 — context without deadline API
                budget = None
            dl, explicit = _adm.mint_deadline("grpc", budget, now=t0)
            root.annotate(deadline_ms=round((dl - t0) * 1e3, 1))
            # the lane the shed verdict resolved also binds the scope,
            # so per-lane in-flight/drain accounting sees the same
            # lane the verdict used (a write flood counts as
            # background pressure, not interactive)
            with _adm.request_scope("grpc", dl, lane_name=shed_lane,
                                    explicit=explicit):
                if shed_lane is not None:
                    try:
                        _adm.check("grpc", shed_lane)
                    except _adm.ShedError as e:
                        latency.observe(time.time() - t0)
                        # honest backpressure: RESOURCE_EXHAUSTED with
                        # retry-pushback metadata derived from the
                        # lane's drain rate (the gRPC analog of
                        # HTTP 429 + Retry-After)
                        await context.abort(
                            grpc.StatusCode.RESOURCE_EXHAUSTED, str(e),
                            trailing_metadata=(
                                ("grpc-retry-pushback-ms",
                                 str(int(e.retry_after_s * 1e3))),))
                try:
                    if executor is not None:
                        # copy_context carries the root span AND the
                        # admission context into the executor thread,
                        # so spans opened by the compute (coalesce
                        # wait, device dispatch) land in THIS request's
                        # trace and the batcher sees its budget/lane.
                        # The executor-queue delay is a measured wait
                        # observation for the admission controller —
                        # under overload THIS is where the queue lives.
                        ctx = contextvars.copy_context()
                        t_q = time.time()

                        def _serve_queued(data=data, t_q=t_q):
                            _adm.CONTROLLER.note_wait(
                                _adm.lane(), time.time() - t_q)
                            return serve(data)

                        out = await asyncio.get_running_loop(
                            ).run_in_executor(executor, ctx.run,
                                              _serve_queued)
                    else:
                        out = serve(data)
                    if not isinstance(out, bytes):
                        # over-threshold response: flatten on the
                        # serializer pool — the loop awaits, it never
                        # serializes (pinned by the 10MB loop-block
                        # test)
                        ctx = contextvars.copy_context()
                        out = await asyncio.get_running_loop(
                            ).run_in_executor(_serializer_pool(),
                                              ctx.run,
                                              _serialize_timed, out)
                except _adm.DeadlineExceeded as e:
                    # the budget expired in queue: failed fast, honest
                    # DEADLINE_EXCEEDED instead of a late answer
                    latency.observe(time.time() - t0)
                    await context.abort(
                        grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
                except error_cls as e:
                    latency.observe(time.time() - t0)
                    await context.abort(grpc_status_of(e), str(e))
                except Exception as e:  # noqa: BLE001
                    if not is_device_fault(e):
                        raise
                    # a device fault is answered, never a bare UNKNOWN
                    latency.observe(time.time() - t0)
                    await context.abort(grpc.StatusCode.INTERNAL,
                                        f"{type(e).__name__}: {e}")
                if wire is not None:
                    wire.put(method, data, g, out)
                latency.observe(time.time() - t0)
                return out

    # no request_deserializer / response_serializer: the server hands us
    # the wire bytes and sends back exactly the bytes we return
    return grpc.unary_unary_rpc_method_handler(handler)


def _parse(fn: Callable[[Any], Any], req_cls) -> Callable[[bytes], Any]:
    def parse_then(data: bytes):
        # wire/parse stage of the request's latency decomposition
        t0 = time.perf_counter()
        req = req_cls.FromString(data)
        obs.record_stage("grpc", "parse", time.perf_counter() - t0)
        return fn(req)

    return parse_then


class _AckTemplate:
    """Pre-serialized fixed-shape reply + trailing ``time`` field.

    Protobuf fields may be emitted in any order, so a response whose
    only variable field is ``time`` (double, field 2 in every qdrant
    *OperationResponse) serializes as <template bytes> + <0x11> +
    <8-byte LE double> — no message object, no SerializeToString."""

    __slots__ = ("prefix", "tag")

    def __init__(self, message):
        self.prefix = message.SerializeToString()
        num = message.DESCRIPTOR.fields_by_name["time"].number
        if num >= 16:  # pragma: no cover — upstream proto pins time=2
            raise ValueError("time field number too large for 1-byte tag")
        self.tag = bytes([(num << 3) | 1])  # wire type 1: 64-bit

    def render(self, t0: float) -> bytes:
        return self.prefix + self.tag + struct.pack("<d", time.time() - t0)


_POINTS_ACK = _AckTemplate(q.PointsOperationResponse(
    result=q.UpdateResult(operation_id=0, status=q.Completed)))
_COLLECTION_OK = _AckTemplate(q.CollectionOperationResponse(result=True))


_DISTANCE_NAMES = {
    q.Cosine: "Cosine", q.Euclid: "Euclid", q.Dot: "Dot",
    q.Manhattan: "Manhattan", q.UnknownDistance: "Cosine",
}
_DISTANCE_ENUMS = {
    "Cosine": q.Cosine, "Euclid": q.Euclid, "Dot": q.Dot,
    "Manhattan": q.Manhattan,
}


class OfficialCollectionsServicer:
    """qdrant.Collections (reference: collections_service.go).

    Methods are plain ``request -> response`` translations raising
    QdrantError; the aio wire layer (handlers()) adds byte caching,
    executor offload and status mapping."""

    def __init__(self, compat):
        self.compat = compat

    def Get(self, request):
        t0 = time.time()
        info = self.compat.get_collection(request.collection_name)
        vec_cfg = info["config"]["params"].get("vectors", {})
        resp = q.GetCollectionInfoResponse(
            result=q.CollectionInfo(
                status=q.Green,
                vectors_count=int(info.get("indexed_vectors_count", 0)),
                segments_count=int(info.get("segments_count", 1)),
                points_count=int(info.get("points_count", 0)),
            ),
            time=time.time() - t0,
        )
        if vec_cfg:
            params = q.VectorParams(
                size=int(vec_cfg.get("size", 0)),
                distance=_DISTANCE_ENUMS.get(
                    vec_cfg.get("distance", "Cosine"), q.Cosine),
            )
            resp.result.config.params.vectors_config.params.CopyFrom(params)
        return resp

    def List(self, request):
        t0 = time.time()
        return q.ListCollectionsResponse(
            collections=[
                q.CollectionDescription(name=n)
                for n in self.compat.list_collections()
            ],
            time=time.time() - t0,
        )

    def Create(self, request):
        t0 = time.time()
        size = 0
        distance = "Cosine"
        if request.HasField("vectors_config"):
            which = request.vectors_config.WhichOneof("config")
            if which == "params":
                p = request.vectors_config.params
                size = int(p.size)
                distance = _DISTANCE_NAMES.get(p.distance, "Cosine")
            elif which == "params_map":
                # single-vector subset: first named vector wins
                for _name, p in request.vectors_config.params_map.map.items():
                    size = int(p.size)
                    distance = _DISTANCE_NAMES.get(p.distance, "Cosine")
                    break
        ok = self.compat.create_collection(
            request.collection_name,
            {"size": size, "distance": distance},
        )
        return q.CollectionOperationResponse(result=ok, time=time.time() - t0)

    def Delete(self, request):
        t0 = time.time()
        ok = self.compat.delete_collection(request.collection_name)
        return q.CollectionOperationResponse(result=ok, time=time.time() - t0)

    def CollectionExists(self, request):
        t0 = time.time()
        exists = request.collection_name in self.compat.list_collections()
        return q.CollectionExistsResponse(
            result=q.CollectionExists(exists=exists), time=time.time() - t0)

    def UpdateAliases(self, request):
        t0 = time.time()
        actions = []
        for op in request.actions:
            which = op.WhichOneof("action")
            if which == "create_alias":
                actions.append({"create": {
                    "alias": op.create_alias.alias_name,
                    "collection": op.create_alias.collection_name}})
            elif which == "rename_alias":
                actions.append({"rename": {
                    "old": op.rename_alias.old_alias_name,
                    "new": op.rename_alias.new_alias_name}})
            elif which == "delete_alias":
                actions.append({"delete": {
                    "alias": op.delete_alias.alias_name}})
        self.compat.update_aliases(actions)
        return _COLLECTION_OK.render(t0)

    def ListCollectionAliases(self, request):
        t0 = time.time()
        return q.ListAliasesResponse(
            aliases=[q.AliasDescription(**d) for d in
                     self.compat.list_aliases(request.collection_name)],
            time=time.time() - t0)

    def ListAliases(self, request):
        t0 = time.time()
        return q.ListAliasesResponse(
            aliases=[q.AliasDescription(**d)
                     for d in self.compat.list_aliases()],
            time=time.time() - t0)

    def handlers(self, wire=None, executor=None):
        gen = lambda: self.compat.cache_gen  # noqa: E731
        svc = "qdrant.Collections"

        def unary(name, fn, req_cls, resp_cls=None):
            return aio_unary_raw(
                _parse(fn, req_cls), method=f"/{svc}/{name}",
                wire=wire if resp_cls is not None else None, gen=gen,
                executor=executor, resp_cls=resp_cls)

        return grpc.method_handlers_generic_handler(svc, {
            "Get": unary("Get", self.Get, q.GetCollectionInfoRequest,
                         q.GetCollectionInfoResponse),
            "List": unary("List", self.List, q.ListCollectionsRequest,
                          q.ListCollectionsResponse),
            "Create": unary("Create", self.Create, q.CreateCollection),
            "Delete": unary("Delete", self.Delete, q.DeleteCollection),
            "CollectionExists": unary(
                "CollectionExists", self.CollectionExists,
                q.CollectionExistsRequest, q.CollectionExistsResponse),
            "UpdateAliases": unary(
                "UpdateAliases", self.UpdateAliases, q.ChangeAliases),
            "ListCollectionAliases": unary(
                "ListCollectionAliases", self.ListCollectionAliases,
                q.ListCollectionAliasesRequest, q.ListAliasesResponse),
            "ListAliases": unary(
                "ListAliases", self.ListAliases, q.ListAliasesRequest,
                q.ListAliasesResponse),
        })


class OfficialSnapshotsServicer:
    """qdrant.Snapshots (reference: snapshots_service.go — Create/List/
    Delete per collection + CreateFull/ListFull/DeleteFull). Snapshot
    files are JSON in ``snapshot_dir`` (both packages' own format; the
    reference likewise writes NornicDB-native snapshots, not qdrant's
    tar format). Never wire-cached: filesystem state is not generation-
    tracked."""

    def __init__(self, compat, snapshot_dir: str):
        self.compat = compat
        self.snapshot_dir = snapshot_dir

    @staticmethod
    def _desc(d):
        return q.SnapshotDescription(
            name=d["name"], creation_time=d["creation_time"],
            size=d["size"])

    def Create(self, request):
        t0 = time.time()
        d = self.compat.create_snapshot(
            request.collection_name, self.snapshot_dir)
        return q.CreateSnapshotResponse(
            snapshot_description=self._desc(d), time=time.time() - t0)

    def List(self, request):
        t0 = time.time()
        return q.ListSnapshotsResponse(
            snapshot_descriptions=[
                self._desc(d) for d in self.compat.list_snapshots(
                    request.collection_name, self.snapshot_dir)],
            time=time.time() - t0)

    def Delete(self, request):
        t0 = time.time()
        self.compat.delete_snapshot(
            request.collection_name, request.snapshot_name,
            self.snapshot_dir)
        return q.DeleteSnapshotResponse(time=time.time() - t0)

    def CreateFull(self, request):
        t0 = time.time()
        d = self.compat.create_full_snapshot(self.snapshot_dir)
        return q.CreateSnapshotResponse(
            snapshot_description=self._desc(d), time=time.time() - t0)

    def ListFull(self, request):
        t0 = time.time()
        return q.ListSnapshotsResponse(
            snapshot_descriptions=[
                self._desc(d) for d in
                self.compat.list_full_snapshots(self.snapshot_dir)],
            time=time.time() - t0)

    def DeleteFull(self, request):
        t0 = time.time()
        self.compat.delete_full_snapshot(
            request.snapshot_name, self.snapshot_dir)
        return q.DeleteSnapshotResponse(time=time.time() - t0)

    def handlers(self, wire=None, executor=None):
        svc = "qdrant.Snapshots"

        def unary(name, fn, req_cls):
            return aio_unary_raw(_parse(fn, req_cls),
                                 method=f"/{svc}/{name}", executor=executor)

        return grpc.method_handlers_generic_handler(svc, {
            "Create": unary("Create", self.Create, q.CreateSnapshotRequest),
            "List": unary("List", self.List, q.ListSnapshotsRequest),
            "Delete": unary("Delete", self.Delete, q.DeleteSnapshotRequest),
            "CreateFull": unary(
                "CreateFull", self.CreateFull, q.CreateFullSnapshotRequest),
            "ListFull": unary(
                "ListFull", self.ListFull, q.ListFullSnapshotsRequest),
            "DeleteFull": unary(
                "DeleteFull", self.DeleteFull, q.DeleteFullSnapshotRequest),
        })


class OfficialPointsServicer:
    """qdrant.Points (reference: points_service.go).

    The former per-servicer raw-bytes Search cache is replaced by the
    server-wide shared WireCache (cache.py) covering Search/Scroll/
    Count/Get — validated against the compat layer's cache generation,
    which every write surface bumps (point ops here, Cypher writes via
    the db.py mutation listener, alias/collection ops)."""

    def __init__(self, compat):
        self.compat = compat

    # -- helpers --------------------------------------------------------

    def _scored(self, d: Dict[str, Any]) -> "q.ScoredPoint":
        sp = q.ScoredPoint(
            id=py_to_point_id(d["id"]),
            score=float(d.get("score", 0.0)),
            version=0,
        )
        for k, v in (d.get("payload") or {}).items():
            sp.payload[k].CopyFrom(py_to_value(v))
        if d.get("vector") is not None:
            sp.vectors.vector.data.extend(float(x) for x in d["vector"])
        return sp

    def _retrieved(self, d: Dict[str, Any]) -> "q.RetrievedPoint":
        rp = q.RetrievedPoint(id=py_to_point_id(d["id"]))
        for k, v in (d.get("payload") or {}).items():
            rp.payload[k].CopyFrom(py_to_value(v))
        if d.get("vector") is not None:
            rp.vectors.vector.data.extend(float(x) for x in d["vector"])
        return rp

    # -- rpcs -----------------------------------------------------------

    def Upsert(self, request):
        t0 = time.time()
        points = []
        for p in request.points:
            vec: List[float] = []
            if p.HasField("vectors"):
                which = p.vectors.WhichOneof("vectors_options")
                if which == "vector":
                    vec = list(p.vectors.vector.data)
                elif which == "vectors":
                    for _name, v in p.vectors.vectors.vectors.items():
                        vec = list(v.data)
                        break
            points.append({
                "id": point_id_to_py(p.id),
                "vector": vec,
                "payload": {k: value_to_py(v) for k, v in p.payload.items()},
            })
        try:
            # convoy-coalesced: concurrent Upserts merge into one apply
            self.compat.upsert_points_coalesced(
                request.collection_name, points)
        except QdrantError:
            raise
        except (ValueError, TypeError) as e:
            raise QdrantError(str(e))
        return _POINTS_ACK.render(t0)

    def Delete(self, request):
        t0 = time.time()
        which = request.points.WhichOneof("points_selector_one_of")
        if which == "points":
            ids = [point_id_to_py(p) for p in request.points.points.ids]
            self.compat.delete_points(request.collection_name, ids)
        elif which == "filter":
            flt = filter_to_dict(request.points.filter)
            doomed = [
                d["id"] for d in _iter_matching_points(
                    self.compat, request.collection_name, flt)
            ]
            self.compat.delete_points(request.collection_name, doomed)
        return _POINTS_ACK.render(t0)

    def Get(self, request):
        t0 = time.time()
        ids = [point_id_to_py(p) for p in request.ids]
        points = self.compat.retrieve_points(
            request.collection_name, ids,
            with_payload=_with_payload(request.with_payload),
            with_vector=_with_vectors(request),
        )
        return q.GetResponse(
            result=[self._retrieved(d) for d in points],
            time=time.time() - t0,
        )

    def Search(self, request):
        t0 = time.time()
        offset = int(request.offset) if request.HasField("offset") else 0
        hits = self.compat.search_points(
            request.collection_name,
            list(request.vector),
            limit=(int(request.limit) or 10) + offset,
            with_payload=_with_payload(request.with_payload),
            with_vector=_with_vectors(request),
            score_threshold=(
                request.score_threshold
                if request.HasField("score_threshold") else None),
            query_filter=filter_to_dict(request.filter),
        )
        return q.SearchResponse(
            result=[self._scored(d) for d in hits[offset:]],
            time=time.time() - t0,
        )

    def Scroll(self, request):
        t0 = time.time()
        offset = None
        if request.HasField("offset"):
            offset = point_id_to_py(request.offset)
        limit = int(request.limit) if request.HasField("limit") else 10
        flt = filter_to_dict(request.filter)
        if flt is None:
            page = self.compat.scroll_points(
                request.collection_name,
                offset=offset,
                limit=limit,
                with_payload=_with_payload(request.with_payload),
                with_vector=_with_vectors(request),
            )
            points = page["points"]
            next_offset = page.get("next_page_offset")
        else:
            # qdrant semantics: a page holds up to `limit` MATCHING
            # points; next_page_offset is the following match's id
            points = []
            next_offset = None
            for d in _iter_matching_points(
                self.compat, request.collection_name, flt,
                with_payload=_with_payload(request.with_payload),
                with_vector=_with_vectors(request),
            ):
                if offset is not None and str(d["id"]) < str(offset):
                    continue
                if len(points) == limit:
                    next_offset = d["id"]
                    break
                points.append(d)
        resp = q.ScrollResponse(
            result=[self._retrieved(d) for d in points],
            time=time.time() - t0,
        )
        if next_offset is not None:
            resp.next_page_offset.CopyFrom(py_to_point_id(next_offset))
        return resp

    def Count(self, request):
        t0 = time.time()
        flt = filter_to_dict(request.filter)
        if flt is None:
            n = self.compat.count_points(request.collection_name)
        else:
            n = sum(1 for _ in _iter_matching_points(
                self.compat, request.collection_name, flt))
        return q.CountResponse(
            result=q.CountResult(count=n), time=time.time() - t0)

    def handlers(self, wire=None, executor=None):
        gen = lambda: self.compat.cache_gen  # noqa: E731
        svc = "qdrant.Points"

        def unary(name, fn, req_cls, resp_cls=None):
            return aio_unary_raw(
                _parse(fn, req_cls), method=f"/{svc}/{name}",
                wire=wire if resp_cls is not None else None, gen=gen,
                executor=executor, resp_cls=resp_cls)

        return grpc.method_handlers_generic_handler(svc, {
            "Upsert": unary("Upsert", self.Upsert, q.UpsertPoints),
            "Delete": unary("Delete", self.Delete, q.DeletePoints),
            "Get": unary("Get", self.Get, q.GetPoints, q.GetResponse),
            "Search": unary("Search", self.Search, q.SearchPoints,
                            q.SearchResponse),
            "Scroll": unary("Scroll", self.Scroll, q.ScrollPoints,
                            q.ScrollResponse),
            "Count": unary("Count", self.Count, q.CountPoints,
                           q.CountResponse),
        })
