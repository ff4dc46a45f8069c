"""gRPC API: the native search service and the Qdrant-semantics
collections and points service (counterpart of
``nornicdb_tpu/api/grpc_server.py``), beside the official Qdrant services
of ``api/qdrant_official_grpc.py``, all on one port.

One ``grpc.aio`` server on its own event-loop thread; every handler is a
coroutine registered raw, so the server moves request and response
bytes. Hot reads ride one shared ``cache.WireCache`` validated against
the owning plane's write generation (the Qdrant layer's search-cache
generation, the search service's result-cache generation), both fed by
the storage listeners ``db.py`` wires, so a write on any surface
invalidates cached bytes. Misses and point operations run on a small
executor, where concurrent requests coalesce through the layer's
``MicroBatcher`` (search: B1 on the card) and ``BatchCoalescer``
(upserts). ``SearchService/Search`` goes through
``vector_search_candidates`` and ``Hybrid`` through ``search`` (B2 for a
text query's embed, B1 on the exact tier).

The public lifecycle is synchronous: ``GrpcServer(db, port=0).start()``
and ``.stop()``; construction binds the port. ``auth_token`` puts a
bearer-token interceptor in front of every method. Where the port
differs (ROADMAP C42): a device fault (``errors.is_device_fault``) is
answered ``INTERNAL`` (``qdrant_official_grpc.aio_unary_raw``), and a
hit's payload lookup, which the reference makes best effort, lets one
through.
"""

from __future__ import annotations

import asyncio
import contextvars
import errno
import json
import os
import threading
import time
from typing import Optional

import grpc
import numpy as np

from nornicdb_tpu_torch.api.proto import nornic_pb2 as pb
from nornicdb_tpu_torch.api.qdrant import QdrantError
from nornicdb_tpu_torch.errors import is_device_fault


def _unary_raw(fn, req_cls, method, wire=None, gen=None, executor=None,
               resp_cls=None):
    from nornicdb_tpu_torch.api.qdrant_official_grpc import _parse, aio_unary_raw

    # _parse times the FromString as the request's "parse" stage, same
    # as the official-proto surface
    return aio_unary_raw(
        _parse(fn, req_cls), method=method,
        wire=wire, gen=gen, executor=executor, resp_cls=resp_cls)


class SearchServicer:
    """nornic.v1.SearchService — raw vector + hybrid search.

    Concurrent Search RPCs funnel (via the executor) into the search
    service's MicroBatcher: many b=1 queries, one batched device
    dispatch (search/service.py vector_search_candidates)."""

    def __init__(self, db):
        self.db = db

    def Search(self, request):
        t0 = time.time()
        hits = self.db.search.vector_search_candidates(
            np.asarray(list(request.vector), dtype=np.float32),
            k=int(request.limit) or 10,
        )
        return pb.SearchResponse(
            hits=[self._hit(nid, score) for nid, score in hits],
            took_ms=(time.time() - t0) * 1e3,
        )

    def Hybrid(self, request):
        t0 = time.time()
        results = self.db.search.search(
            query=request.query,
            limit=int(request.limit) or 10,
            query_embedding=(
                np.asarray(list(request.vector), dtype=np.float32)
                if request.vector else None
            ),
        )
        hits = []
        for r in results:
            hits.append(pb.Hit(
                node_id=str(r.get("id", "")),
                score=float(r.get("score", 0.0)),
                payload_json=json.dumps(r.get("properties", {}), default=str),
            ))
        return pb.SearchResponse(hits=hits, took_ms=(time.time() - t0) * 1e3)

    def _hit(self, node_id: str, score: float) -> "pb.Hit":
        payload = "{}"
        try:
            node = self.db.storage.get_node(node_id)
            payload = json.dumps(node.properties, default=str)
        except Exception as exc:
            if is_device_fault(exc):
                raise  # never hidden behind an empty payload (C42)
        return pb.Hit(node_id=node_id, score=float(score),
                      payload_json=payload)

    def _stream_search(self, executor):
        """Batched streaming Search: one RPC, many queries.
        A high-fanout client streams SearchRequests and reads
        SearchResponses in order; the server gathers each arrival
        burst (one short gather window, MicroBatcher-style) and
        dispatches the whole burst concurrently on the executor, so
        the rows coalesce into one device dispatch below — per-query
        RPC overhead drops to one varint-framed message each way."""
        max_batch = 64
        gather_s = 0.0005
        servicer = self

        def one(data: bytes) -> bytes:
            return servicer.Search(
                pb.SearchRequest.FromString(data)).SerializeToString()

        async def handler(request_iterator, context):
            loop = asyncio.get_running_loop()
            it = request_iterator.__aiter__()
            pending = None
            done = False
            try:
                while not done:
                    if pending is None:
                        pending = asyncio.ensure_future(it.__anext__())
                    try:
                        first = await pending
                    except StopAsyncIteration:
                        return
                    pending = None
                    batch = [first]
                    while len(batch) < max_batch:
                        pending = asyncio.ensure_future(it.__anext__())
                        try:
                            nxt = await asyncio.wait_for(
                                asyncio.shield(pending), gather_s)
                        except asyncio.TimeoutError:
                            break  # burst over; keep pending for later
                        except StopAsyncIteration:
                            pending = None
                            done = True
                            break
                        pending = None
                        batch.append(nxt)
                    outs = await asyncio.gather(*[
                        loop.run_in_executor(
                            executor, contextvars.copy_context().run,
                            one, b)
                        for b in batch])
                    for out in outs:
                        yield out
            finally:
                if pending is not None:
                    pending.cancel()

        return grpc.stream_stream_rpc_method_handler(handler)

    def handlers(self, wire=None, executor=None):
        svc = "nornic.v1.SearchService"
        # cached response bytes validate against the search service's
        # result-cache generation: any index mutation bumps it
        gen = lambda: self.db.search.generation  # noqa: E731
        return grpc.method_handlers_generic_handler(svc, {
            "Search": _unary_raw(self.Search, pb.SearchRequest,
                                 f"/{svc}/Search", wire, gen, executor,
                                 resp_cls=pb.SearchResponse),
            "SearchStream": self._stream_search(executor),
            "Hybrid": _unary_raw(self.Hybrid, pb.HybridRequest,
                                 f"/{svc}/Hybrid", wire, gen, executor,
                                 resp_cls=pb.SearchResponse),
        })


# the whole ok-ack is constant bytes — no message build, no serialize
_ACK_OK = pb.AckResponse(ok=True).SerializeToString()


class QdrantServicer:
    """nornic.v1.QdrantService — qdrant-semantics ops over QdrantCompat."""

    def __init__(self, compat):
        self.compat = compat

    def _ack(self, fn):
        try:
            fn()
            return _ACK_OK
        except QdrantError as e:
            return pb.AckResponse(ok=False, error=str(e))

    def CreateCollection(self, request):
        vectors = {"size": int(request.vector_size),
                   "distance": request.distance or "Cosine"}
        return self._ack(lambda: self.compat.create_collection(
            request.collection, vectors))

    def DeleteCollection(self, request):
        return self._ack(lambda: self.compat.delete_collection(
            request.collection))

    def ListCollections(self, request):
        return pb.ListCollectionsResponse(
            collections=self.compat.list_collections())

    def GetCollection(self, request):
        try:
            info = self.compat.get_collection(request.collection)
        except QdrantError:
            return pb.CollectionInfoResponse(status="not_found")
        vec = info["config"]["params"]["vectors"]
        return pb.CollectionInfoResponse(
            status=info["status"],
            points_count=info["points_count"],
            vector_size=int(vec.get("size", 0)),
            distance=str(vec.get("distance", "Cosine")),
        )

    def Upsert(self, request):
        points = [
            {
                "id": p.id,
                "vector": list(p.vector),
                "payload": json.loads(p.payload_json) if p.payload_json else {},
            }
            for p in request.points
        ]
        # convoy-coalesced: concurrent Upserts merge into one apply
        return self._ack(lambda: self.compat.upsert_points_coalesced(
            request.collection, points))

    def SearchPoints(self, request):
        t0 = time.time()
        hits = self.compat.search_points(
            request.collection,
            list(request.vector),
            limit=int(request.limit) or 10,
            with_payload=request.with_payload,
            with_vector=request.with_vector,
            score_threshold=(
                float(request.score_threshold)
                if request.has_score_threshold else None
            ),
            query_filter=(
                json.loads(request.filter_json)
                if request.filter_json else None
            ),
        )
        return pb.SearchPointsResponse(
            points=[
                pb.ScoredPoint(
                    id=str(h["id"]),
                    score=h.get("score", 0.0),
                    payload_json=json.dumps(h.get("payload", {}), default=str),
                    vector=h.get("vector", []),
                )
                for h in hits
            ],
            took_ms=(time.time() - t0) * 1e3,
        )

    def DeletePoints(self, request):
        return self._ack(lambda: self.compat.delete_points(
            request.collection, list(request.ids)))

    def CountPoints(self, request):
        return pb.CountResponse(count=self.compat.count_points(
            request.collection))

    def handlers(self, wire=None, executor=None):
        svc = "nornic.v1.QdrantService"
        gen = lambda: self.compat.cache_gen  # noqa: E731

        def unary(name, fn, req_cls, resp_cls=None):
            return _unary_raw(fn, req_cls, f"/{svc}/{name}",
                              wire if resp_cls is not None else None,
                              gen, executor, resp_cls=resp_cls)

        return grpc.method_handlers_generic_handler(svc, {
            "CreateCollection": unary(
                "CreateCollection", self.CreateCollection,
                pb.CreateCollectionRequest),
            "DeleteCollection": unary(
                "DeleteCollection", self.DeleteCollection,
                pb.CollectionRequest),
            "ListCollections": unary(
                "ListCollections", self.ListCollections, pb.Empty,
                pb.ListCollectionsResponse),
            "GetCollection": unary(
                "GetCollection", self.GetCollection, pb.CollectionRequest,
                pb.CollectionInfoResponse),
            "Upsert": unary("Upsert", self.Upsert, pb.UpsertRequest),
            "SearchPoints": unary(
                "SearchPoints", self.SearchPoints, pb.SearchPointsRequest,
                pb.SearchPointsResponse),
            "DeletePoints": unary(
                "DeletePoints", self.DeletePoints, pb.DeletePointsRequest),
            "CountPoints": unary(
                "CountPoints", self.CountPoints, pb.CollectionRequest,
                pb.CountResponse),
        })


def _aio_token_interceptor(token: str):
    """Bearer-token auth interceptor: gRPC writes must not be weaker
    than the REST surface's WRITE authorization."""
    import hmac

    class _Interceptor(grpc.aio.ServerInterceptor):
        def __init__(self):
            async def abort(request, context):
                await context.abort(grpc.StatusCode.UNAUTHENTICATED,
                                    "invalid or missing bearer token")

            self._abort = grpc.unary_unary_rpc_method_handler(abort)

        async def intercept_service(self, continuation, details):
            md = dict(details.invocation_metadata or ())
            if hmac.compare_digest(
                md.get("authorization", ""), f"Bearer {token}"
            ):
                return await continuation(details)
            return self._abort

    return _Interceptor()


class GrpcServer:
    """Hosts both services on one port (reference: server.go:328 Start).
    Shares the DB's QdrantCompat with the REST surface so the
    per-collection index caches stay coherent across surfaces.

    Implementation: a ``grpc.aio`` server living on its own event-loop
    thread. Construction binds the port (so ``.address`` is valid before
    ``start()``, as callers expect); ``start()``/``stop()`` submit the
    aio server's lifecycle onto the loop and block until done."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 8, auth_token: Optional[str] = None,
                 snapshot_dir: Optional[str] = None):
        from concurrent import futures

        from nornicdb_tpu_torch.cache import WireCache

        self.db = db
        if snapshot_dir is None:
            # reference default: ./data/qdrant-snapshots (server.go:184);
            # here snapshots live with the store when one exists
            import tempfile

            data_dir = getattr(db, "_data_dir", None)
            snapshot_dir = (
                os.path.join(data_dir, "qdrant-snapshots") if data_dir
                else os.path.join(tempfile.gettempdir(),
                                  "nornicdb-qdrant-snapshots"))
        self.snapshot_dir = snapshot_dir
        self._auth_token = auth_token
        # one shared response-bytes cache across ALL services/methods of
        # this server — both gRPC surfaces serve hot reads from it
        self.wire_cache = WireCache(name="grpc")
        # miss/mutation work runs here, NOT on the event loop: a storage
        # scan must never stall cache hits, and concurrent point ops
        # coalesce across these threads via the compat layer's batchers
        self._executor = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="grpc-work")
        self.search_servicer = SearchServicer(db)
        self.qdrant_servicer = QdrantServicer(db.qdrant_compat)
        # official qdrant wire contract (qdrant.Collections / qdrant.Points)
        # alongside the native services — reference: pkg/qdrantgrpc serves
        # the upstream proto so official SDKs connect (COMPAT.md)
        from nornicdb_tpu_torch.api.qdrant_official_grpc import (
            OfficialCollectionsServicer,
            OfficialPointsServicer,
            OfficialSnapshotsServicer,
        )

        self.official_collections = OfficialCollectionsServicer(db.qdrant_compat)
        self.official_points = OfficialPointsServicer(db.qdrant_compat)
        self.official_snapshots = OfficialSnapshotsServicer(
            db.qdrant_compat, self.snapshot_dir)
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, daemon=True, name="grpc-aio-loop")
        self._loop_thread.start()
        self._started = False
        self._stopped = False
        self.host = host
        self.port = self._submit(self._build(host, port)).result(30)

    @staticmethod
    def _quiet_poller_eagain(loop, context) -> None:
        # grpcio's aio completion-queue poller is process-global and
        # binds to the first aio loop; when a SECOND aio loop exists in
        # the process (an in-process grpc.aio client — the open-loop
        # bench harness, tests), its cross-loop wakeups surface here as
        # harmless EAGAIN callbacks that would spam stderr per request.
        # Only those are swallowed: any other BlockingIOError errno or
        # exception type still reaches the default handler.
        exc = context.get("exception")
        if (isinstance(exc, BlockingIOError)
                and exc.errno in (errno.EAGAIN, errno.EWOULDBLOCK)):
            return
        loop.default_exception_handler(context)

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.set_exception_handler(self._quiet_poller_eagain)
        try:
            self._loop.run_forever()
        finally:
            try:
                self._loop.close()
            except RuntimeError:
                pass

    def _submit(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    async def _build(self, host: str, port: int) -> int:
        interceptors = (
            [_aio_token_interceptor(self._auth_token)]
            if self._auth_token else []
        )
        server = grpc.aio.server(interceptors=interceptors)
        wire, ex = self.wire_cache, self._executor
        server.add_generic_rpc_handlers((
            self.search_servicer.handlers(wire=wire, executor=ex),
            self.qdrant_servicer.handlers(wire=wire, executor=ex),
            self.official_collections.handlers(wire=wire, executor=ex),
            self.official_points.handlers(wire=wire, executor=ex),
            self.official_snapshots.handlers(executor=ex),
        ))
        self._server = server
        return server.add_insecure_port(f"{host}:{port}")

    def start(self) -> "GrpcServer":
        self._submit(self._server.start()).result(30)
        self._started = True
        return self

    def stop(self, grace: Optional[float] = 0.5) -> None:
        if self._stopped:
            return
        self._stopped = True
        try:
            # unconditional: __init__ already bound the port via
            # _build(), so even a never-started server holds the
            # listening socket until stopped
            self._submit(self._server.stop(grace)).result(30)
        except Exception:
            pass  # a dying loop must not block process shutdown
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=10)
        self._executor.shutdown(wait=False)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"
