"""HTTP server: Neo4j HTTP API, REST search, admin, metrics, health
(counterpart of ``nornicdb_tpu/api/http_server.py``; the same routes,
status codes and bodies).

The Neo4j transactional HTTP API (``/db/{name}/tx/commit``), the REST
search/similar/decay/embed endpoints, auth (JWT bearer and basic),
Prometheus ``/metrics``, ``/health`` and ``/status``, GDPR export and
delete, rate limiting, multi-database admin, MCP at ``/mcp`` and
Heimdall's OpenAI-compatible chat. Built on the standard library's
``ThreadingHTTPServer``. Deadlines are minted here from
``admission.DEADLINE_HEADER``; a shed answers 429 with ``Retry-After``
and an expired deadline 504.

GraphQL at ``/graphql`` (``api/graphql.py``, with a response-bytes
cache for query documents validated against a graph-mutation generation)
and the Qdrant REST wire format at ``/collections`` (``api/qdrant.py``,
the DB's ``qdrant_compat``; snapshots under the data dir's
``qdrant-snapshots``).

Where the port differs (ROADMAP C39): a device fault
(``errors.is_device_fault``) inside a readiness or scrape probe, which
the reference swallows, re-raises. Every error the reference answers is
still answered, device faults among them (500).
"""

from __future__ import annotations

import base64
import functools
import json
import os
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from nornicdb_tpu_torch import admission as _adm
from nornicdb_tpu_torch import obs
from nornicdb_tpu_torch.errors import is_device_fault
from nornicdb_tpu_torch.obs import tenant as _tenant

# tier-mix truth for search wire-cache hits (ISSUE 10): cached child —
# the response-bytes hit path must not pay a labels() probe per request
_SEARCH_CACHED_SERVED = obs.audit.served_counter("hybrid", "cached")
from nornicdb_tpu_torch.audit import ADMIN_ACTION, AUTH, DATA_WRITE, GDPR, AuditLog
from nornicdb_tpu_torch.auth import ADMIN, READ, WRITE, AuthError, PermissionDenied
from nornicdb_tpu_torch.storage.txn import TransactionManager

SERVER_NAME = "nornicdb-tpu"
API_VERSION = "1.0"


class ReuseportThreadingHTTPServer(ThreadingHTTPServer):
    """SO_REUSEPORT-bound ThreadingHTTPServer: the wire plane's
    parallel frontend workers (ISSUE 11) share one listening port and
    let the kernel balance accepted connections. Shared by HttpServer
    (``reuse_port=True``) and the worker frontends (wire_plane.py)."""

    daemon_threads = True

    def server_bind(self):
        import socket as _socket

        self.socket.setsockopt(_socket.SOL_SOCKET,
                               _socket.SO_REUSEPORT, 1)
        ThreadingHTTPServer.server_bind(self)

_HTTP_H = obs.REGISTRY.histogram(
    "nornicdb_http_request_seconds",
    "HTTP request latency by route family", labels=("route",))


# routes admission control never sheds: probes, observability and
# admin surfaces must stay reachable on an overloaded node — shedding
# /readyz or /admin/scheduler would blind the operator exactly when
# the scheduler is acting (ISSUE 15)
_SHED_EXEMPT = ("health", "readyz", "metrics", "admin", "auth",
                "status", "openapi.json", "swagger", "docs", "browser",
                "bifrost", "")


# qdrant point READ sub-routes: POST /collections/<c>/points/<tail> is
# a read for these tails (mirrors the gRPC _shed_lane_of split: only
# point WRITES ride the background lane)
_POINT_READ_TAILS = ("search", "query", "scroll", "count", "recommend",
                     "retrieve")


def _shed_lane_for(method: str, path: str) -> Optional[str]:
    """Admission lane of one HTTP request, or None when the route is
    exempt from shedding. Writes (PUT/DELETE, bulk point upserts and
    point delete/payload ops) ride the background lane — under
    pressure they shed before reads; the qdrant point READ endpoints
    (search/query/scroll/count/recommend) stay interactive."""
    seg = path.split("/", 2)[1] if path.startswith("/") else path
    if seg in _SHED_EXEMPT:
        return None
    if method in ("PUT", "DELETE"):
        return _adm.LANE_BACKGROUND
    if method == "POST" and "/points" in path \
            and path.rsplit("/", 1)[-1] not in _POINT_READ_TAILS:
        return _adm.LANE_BACKGROUND
    return _adm.LANE_INTERACTIVE


def _route_family(path: str) -> str:
    """Coarse route label — first path segment, special-casing the tx
    API — so metric cardinality stays bounded no matter what clients
    request (raw paths carry ids/collection names)."""
    segments = [s for s in path.split("/") if s]
    if not segments:
        return "root"
    head = segments[0]
    if head == "db":
        return "tx"
    if head in ("nornicdb", "collections", "graphql", "admin", "heimdall",
                "mcp", "metrics", "health", "status", "auth", "browser",
                "v1", "debug"):
        return head
    return "other"


def _accepts_openmetrics(accept: str) -> bool:
    """True when the Accept header prefers the OpenMetrics exposition.

    Honors q-values (RFC 9110 §12.4.2): ``q=0`` means "not acceptable",
    and OpenMetrics is only served when its q is at least that of any
    classic-text range (``text/plain``, ``text/*``, ``*/*``) — a
    scraper sending ``text/plain;q=1.0, application/openmetrics-text;
    q=0.1`` prefers (and gets) classic Prometheus text."""
    om_q = 0.0
    classic_q = 0.0
    saw_om = False
    for part in accept.split(","):
        fields = part.strip().split(";")
        mtype = fields[0].strip().lower()
        if not mtype:
            continue
        q = 1.0
        for param in fields[1:]:
            key, _, value = param.strip().partition("=")
            if key.strip().lower() == "q":
                try:
                    q = float(value)
                except ValueError:
                    pass
        if mtype == "application/openmetrics-text":
            saw_om = True
            om_q = max(om_q, q)
        elif mtype in ("text/plain", "text/*", "*/*"):
            classic_q = max(classic_q, q)
    return saw_om and om_q > 0.0 and om_q >= classic_q


class _NegotiatedText(str):
    """A pre-rendered text body carrying its own content type (used by
    the OpenMetrics exposition, whose media type the default
    str-payload sniffing in ``_reply`` cannot infer)."""

    content_type: str = "text/plain; charset=utf-8"


class _Metrics:
    """Server counters, now backed by the process-wide telemetry
    registry (nornicdb_tpu_torch/obs) so /metrics serves REAL Prometheus
    types — ``counter`` lines for these, ``histogram`` exposition with
    _bucket/_sum/_count for the latency families — instead of the old
    everything-is-a-gauge text. The inc(name) call-site contract is
    unchanged."""

    def __init__(self) -> None:
        from nornicdb_tpu_torch.obs import REGISTRY

        self._registry = REGISTRY
        self._fams: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.started_at = time.time()

    def inc(self, name: str, value: float = 1.0) -> None:
        fam = self._fams.get(name)
        if fam is None:
            with self._lock:
                fam = self._fams.get(name)
                if fam is None:
                    fam = self._registry.counter(
                        f"nornicdb_{name}", f"server counter {name}")
                    self._fams[name] = fam
        fam.inc(value)

    def _extra_gauges(self, extra: Dict[str, float]) -> Dict[str, float]:
        gauges = {f"nornicdb_{k}": v for k, v in extra.items()}
        gauges["nornicdb_uptime_seconds"] = time.time() - self.started_at
        return gauges

    def render(self, extra: Dict[str, float]) -> str:
        return self._registry.render(self._extra_gauges(extra))

    def render_openmetrics(self, extra: Dict[str, float]) -> _NegotiatedText:
        body = _NegotiatedText(
            self._registry.render_openmetrics(self._extra_gauges(extra)))
        body.content_type = self._registry.OPENMETRICS_CONTENT_TYPE
        return body


class _RateLimiter:
    """Fixed-window per-client limiter (reference: rate limiting in
    pkg/server). One dict per CURRENT window: when the minute rolls
    over, every recorded count belongs to a dead window, so the whole
    map is dropped — a long-lived server no longer leaks one entry per
    client ever seen (the old map kept stale (window, count) tuples
    forever)."""

    def __init__(self, per_minute: int):
        self.per_minute = per_minute
        self._window = -1
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def allow(self, client: str) -> bool:
        if not self.per_minute:
            return True
        window = int(time.time() // 60)
        with self._lock:
            if window != self._window:
                self._window = window
                self._counts.clear()
            n = self._counts.get(client, 0)
            if n >= self.per_minute:
                return False
            self._counts[client] = n + 1
            return True

    def tracked_clients(self) -> int:
        with self._lock:
            return len(self._counts)


class HTTPError(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = status
        self.code = code
        self.message = message


class _GraphGeneration:
    """MutationListener that versions the whole graph: every mutation
    event (including bulk clears) bumps one counter, giving response-
    bytes caches a safe validity token. The bump is an itertools.count
    next() — atomic under the GIL, unlike `gen += 1`, whose lost
    updates could leave the generation unmoved across a racing pair of
    writes and let a stale entry validate."""

    __slots__ = ("gen", "_c")

    def __init__(self):
        import itertools

        self._c = itertools.count(1)
        self.gen = 0

    def _bump(self) -> None:
        self.gen = next(self._c)

    def on_node_upsert(self, node) -> None:
        self._bump()

    def on_node_delete(self, node_id) -> None:
        self._bump()

    def on_edge_upsert(self, edge) -> None:
        self._bump()

    def on_edge_delete(self, edge_id) -> None:
        self._bump()

    def on_bulk_change(self) -> None:
        self._bump()


class HttpServer:
    """One HTTP surface over a DB (+ optional multidb manager, auth,
    audit)."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 7474,
                 authenticator=None, database_manager=None,
                 audit: Optional[AuditLog] = None,
                 rate_limit_per_minute: int = 0,
                 reuse_port: bool = False):
        self.db = db
        self.host = host
        self.port = port
        # SO_REUSEPORT bind (ISSUE 11): parallel wire-plane frontend
        # workers share one listening port; the kernel load-balances
        # accepted connections across their listeners
        self._reuse_port = reuse_port
        self.authenticator = authenticator
        self.database_manager = database_manager
        self.audit = audit or AuditLog(enabled=False)
        self.metrics = _Metrics()
        self.rate_limiter = _RateLimiter(rate_limit_per_minute)
        self.tx_manager = TransactionManager(timeout_seconds=60.0)
        self.default_database = getattr(db, "database", "neo4j")
        # executors this server builds (other databases, explicit
        # transactions) run on the DB's device
        self.device = getattr(db, "device", None)
        self._executors: Dict[str, Any] = {}
        self._tx_executors: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._mcp = None  # lazily-mounted MCP endpoint (/mcp)
        # /nornicdb/search response-bytes cache: (auth, body) ->
        # (search generation, serialized 200 response)
        from nornicdb_tpu_torch.cache import LRUCache

        self._search_wire: LRUCache = LRUCache(max_size=512,
                                               ttl_seconds=300.0)
        # /graphql response-bytes cache for query-kind documents, keyed
        # the same way and validated against a graph-mutation
        # generation fed by a storage listener (any write through any
        # surface — bolt, tx API, qdrant, bulk clears — invalidates)
        self._graphql_wire: LRUCache = LRUCache(max_size=512,
                                                ttl_seconds=300.0)
        self._graph_gen = _GraphGeneration()
        if hasattr(db, "storage") and hasattr(db.storage, "add_listener"):
            db.storage.add_listener(self._graph_gen)

    @property
    def mcp(self):
        if self._mcp is None:
            from nornicdb_tpu_torch.api.mcp import McpServer

            self._mcp = McpServer(self.db)
        return self._mcp

    # -- routing helpers -------------------------------------------------

    def storage_for(self, database: str):
        if self.database_manager is not None and database != self.default_database:
            return self.database_manager.get_storage(database)
        if database != self.default_database:
            raise HTTPError(404, "Neo.ClientError.Database.DatabaseNotFound",
                            f"database {database!r} not found")
        return self.db.storage

    def executor_for(self, database: str):
        if database == self.default_database:
            return self.db.executor
        with self._lock:
            ex = self._executors.get(database)
            if ex is None:
                from nornicdb_tpu_torch.query.executor import CypherExecutor

                ex = CypherExecutor(self.storage_for(database),
                                    device=self.device)
                self._executors[database] = ex
            return ex

    # -- auth ------------------------------------------------------------

    def authenticate(self, headers) -> Optional[str]:
        """Returns username or None (anonymous). Raises HTTPError(401)."""
        if self.authenticator is None:
            return None
        header = headers.get("Authorization", "")
        try:
            if header.startswith("Bearer "):
                claims = self.authenticator.verify_token(header[7:])
                return claims.get("sub")
            if header.startswith("Basic "):
                raw = base64.b64decode(header[6:]).decode()
                username, _, password = raw.partition(":")
                self.authenticator.login(username, password)
                return username
        except AuthError as e:
            self.audit.record(AUTH, "reject", success=False, reason=str(e))
            raise HTTPError(401, "Neo.ClientError.Security.Unauthorized", str(e))
        if self.authenticator.allow_anonymous_reads:
            return None
        raise HTTPError(401, "Neo.ClientError.Security.Unauthorized",
                        "authentication required")

    def authorize(self, username: Optional[str], database: str, privilege: str) -> None:
        if self.authenticator is None:
            return
        try:
            self.authenticator.check(username, database, privilege)
        except PermissionDenied as e:
            raise HTTPError(403, "Neo.ClientError.Security.Forbidden", str(e))

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "HttpServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # keep-alive throughput: without TCP_NODELAY the two-write
            # response (headers, then body) stalls ~40ms per request on
            # the Nagle + delayed-ACK interaction — measured 23 ops/s vs
            # 3,300 with it on the same handler. The buffered wfile
            # (flushed once per request by handle_one_request) makes the
            # response a single segment.
            disable_nagle_algorithm = True
            wbufsize = 64 * 1024

            def log_message(self, *args):  # silence stdlib logging
                pass

            def _dispatch(self, method: str) -> None:
                outer.metrics.inc("http_requests_total")
                client = self.client_address[0]
                if not outer.rate_limiter.allow(client):
                    self._reply(429, {"error": "rate limit exceeded"})
                    return
                path = self.path.split("?")[0]
                if method == "GET" and path == "/bifrost/events":
                    # SSE push channel (reference: heimdall Bifrost,
                    # bifrost.go:15,42) — streamed, bypasses JSON reply
                    # AND the latency histogram (stream lifetime is not
                    # request latency)
                    outer._stream_bifrost(self)
                    return
                t0 = time.perf_counter()
                # cross-node trace propagation (ISSUE 13): a request
                # forwarded by the fleet router (RemoteReplica) carries
                # its originating trace context in X-Nornic-Trace — the
                # root opened here joins that trace instead of minting
                # a new id, so one fleet-routed read is ONE trace
                tctx = obs.unpack_context(
                    self.headers.get(obs.TRACE_HEADER, ""))
                # deadline budget minted at ingress (ISSUE 15): the
                # client's X-Nornic-Deadline-Ms when present, else the
                # surface default derived from the SLO objective; the
                # route's admission lane binds the scope so per-lane
                # accounting matches the shed verdict
                dl, explicit = _adm.parse_deadline_header(
                    self.headers.get(_adm.DEADLINE_HEADER), "http")
                lane = _shed_lane_for(method, path)
                # tenant resolution (ISSUE 18): explicit X-Nornic-Tenant
                # header > tenant propagated in the trace context > the
                # multidb namespace (/db/{name}/... routes name their
                # DB; everything else is the server's default database)
                segs = [s for s in path.split("/") if s]
                if len(segs) > 1 and segs[0] == "db":
                    namespace = segs[1]
                elif len(segs) > 1 and segs[0] == "collections":
                    # qdrant routes derive the tenant from the
                    # collection BEFORE admission, so a shed verdict
                    # is attributed to the right tenant (the deeper
                    # alias-resolving refine still runs on admitted
                    # requests)
                    namespace = (_tenant.tenant_for_collection(segs[1])
                                 or outer.default_database)
                else:
                    namespace = outer.default_database
                ten, ten_explicit = _tenant.resolve(
                    self.headers.get(_tenant.TENANT_HEADER), tctx,
                    namespace)
                try:
                    # propagated_trace opens a plain root when no
                    # context came across — one call site, both cases
                    with _tenant.tenant_scope(ten,
                                              explicit=ten_explicit), \
                            obs.propagated_trace(
                                "wire", tctx,
                                method=f"{method} {path}",
                                transport="http"):
                        obs.annotate(
                            deadline_ms=round(
                                (dl - time.time()) * 1e3, 1),
                            tenant=_tenant.current_tenant())
                        with _adm.request_scope("http", dl,
                                                lane_name=lane,
                                                explicit=explicit):
                            self._handle(method, lane)
                finally:
                    # finally: a handler that raises (client hung up
                    # mid-write) is exactly the request p99 wants
                    _HTTP_H.labels(_route_family(path)).observe(
                        time.perf_counter() - t0)

            def _reply_shed(self, e) -> None:
                outer.metrics.inc("http_errors_total")
                self._reply(
                    429,
                    {"errors": [{
                        "code": "Neo.TransientError.Request."
                                "ResourceExhausted",
                        "message": str(e)}]},
                    extra_headers={"Retry-After": str(
                        max(1, int(round(e.retry_after_s))))})

            def _handle(self, method: str,
                        lane: Optional[str]) -> None:
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                # admission verdict (ISSUE 15): work routes pass the
                # controller before any storage/device work; a shed is
                # an honest 429 with Retry-After from the lane's drain
                # rate — never a silent queue entry. The wire-cached
                # byte routes below check INSIDE their helpers, after
                # the cache probe: a byte-fresh hit is never shed.
                cached_route = (method == "POST" and self.path in
                                ("/nornicdb/search", "/graphql"))
                if lane is not None and not cached_route:
                    try:
                        _adm.check("http", lane)
                    except _adm.ShedError as e:
                        self._reply_shed(e)
                        return
                if cached_route:
                    # response-bytes wire cache (same pattern as the
                    # qdrant gRPC Search): identical request bytes
                    # against unchanged state skip execution, hit
                    # copies AND json serialization entirely
                    try:
                        data = (outer._search_response_bytes(
                                    body, self.headers)
                                if self.path == "/nornicdb/search" else
                                outer._graphql_response_bytes(
                                    body, self.headers))
                    except HTTPError as e:
                        outer.metrics.inc("http_errors_total")
                        self._reply(e.status, {"errors": [
                            {"code": e.code, "message": e.message}]})
                        return
                    except _adm.ShedError as e:
                        # miss-path shed from inside the cached-byte
                        # helper (hits never reach the controller)
                        self._reply_shed(e)
                        return
                    except _adm.DeadlineExceeded as e:
                        outer.metrics.inc("http_errors_total")
                        self._reply(504, {"errors": [
                            {"code": "Neo.TransientError.Request."
                                     "DeadlineExceeded",
                             "message": str(e)}]})
                        return
                    except Exception as e:  # noqa: BLE001
                        outer.metrics.inc("http_errors_total")
                        self._reply(500, {"errors": [
                            {"code": "Neo.DatabaseError.General."
                                     "UnknownError",
                             "message": str(e)}]})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                try:
                    status, payload = outer.route(
                        method, self.path, body, self.headers)
                except HTTPError as e:
                    outer.metrics.inc("http_errors_total")
                    self._reply(e.status, {"errors": [
                        {"code": e.code, "message": e.message}]})
                    return
                except _adm.DeadlineExceeded as e:
                    # budget expired in queue: honest 504 fail-fast
                    # (the ledger/journal record is the batcher's)
                    outer.metrics.inc("http_errors_total")
                    self._reply(504, {"errors": [
                        {"code": "Neo.TransientError.Request."
                                 "DeadlineExceeded",
                         "message": str(e)}]})
                    return
                except Exception as e:  # noqa: BLE001 — surface boundary
                    outer.metrics.inc("http_errors_total")
                    self._reply(500, {"errors": [
                        {"code": "Neo.DatabaseError.General.UnknownError",
                         "message": str(e)}]})
                    return
                self._reply(status, payload)

            def _reply(self, status: int, payload: Dict[str, Any],
                       extra_headers: Optional[Dict[str, str]] = None
                       ) -> None:
                if isinstance(payload, _NegotiatedText):
                    ctype = payload.content_type
                    data = payload.encode()
                elif isinstance(payload, str):
                    # pre-rendered text bodies: playground HTML, or the
                    # Prometheus exposition format (/metrics)
                    ctype = ("text/html; charset=utf-8"
                             if payload.lstrip().startswith("<") else
                             "text/plain; version=0.0.4")
                    data = payload.encode()
                else:
                    ctype = "application/json"
                    # _json_default converts Node/Edge/numpy lazily — an
                    # eager _jsonable() walk over every response value
                    # cost ~0.1ms/request on the search surface
                    t_ser = time.perf_counter()
                    data = json.dumps(payload,
                                      default=_json_default).encode()
                    obs.record_stage("http", "serialize",
                                     time.perf_counter() - t_ser)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        server_cls = (ReuseportThreadingHTTPServer if self._reuse_port
                      else ThreadingHTTPServer)
        self._server = server_cls((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    # -- router (reference: server_router.go:59-314) ---------------------

    def route(self, method: str, path: str, body: bytes,
              headers) -> Tuple[int, Any]:
        parsed = urlparse(path)
        segments = [s for s in parsed.path.split("/") if s]
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        payload: Dict[str, Any] = {}
        if body:
            t_parse = time.perf_counter()
            try:
                payload = json.loads(body)
            except json.JSONDecodeError:
                raise HTTPError(400, "Neo.ClientError.Request.InvalidFormat",
                                "request body must be JSON")
            obs.record_stage("http", "parse",
                             time.perf_counter() - t_parse)

        # public endpoints (no auth)
        if parsed.path == "/health":
            return 200, {"status": "ok"}
        if parsed.path == "/readyz":
            # readiness (distinct from liveness): a live node that is
            # mid-rebuild, near changelog overrun or queue-saturated
            # should be rotated out of traffic, not restarted
            return self._readyz()
        if parsed.path == "/metrics":
            # content negotiation: OpenMetrics (exemplars, # EOF) when
            # asked for, classic Prometheus text — byte-compatible with
            # what every prior round served — otherwise
            accept = str(headers.get("Accept", "") or "") if headers else ""
            if _accepts_openmetrics(accept):
                return 200, self.metrics.render_openmetrics(
                    self._metric_snapshot())
            return 200, self.metrics.render(self._metric_snapshot())
        if parsed.path == "/" and method == "GET":
            return 200, {"server": SERVER_NAME, "version": API_VERSION,
                         "bolt": "bolt://", "transaction": "/db/{name}/tx",
                         "browser": "/browser"}
        if parsed.path in ("/browser", "/browser/") and method == "GET":
            # embedded admin browser (reference: ui/ React app served by
            # the binary via embed.go)
            return 200, _browser_html()
        if parsed.path == "/openapi.json" and method == "GET":
            from nornicdb_tpu_torch.api.openapi import openapi_spec

            return 200, openapi_spec()
        if parsed.path in ("/swagger", "/swagger/", "/docs") and \
                method == "GET":
            # interactive API docs (reference: cmd/swagger-ui); single
            # self-contained page, no CDN assets
            from nornicdb_tpu_torch.api.openapi import docs_page

            return 200, docs_page()
        if parsed.path == "/auth/login" and method == "POST":
            return self._login(payload)

        username = self.authenticate(headers)

        # MCP JSON-RPC endpoint (reference: pkg/mcp streamable HTTP)
        if parsed.path == "/mcp" and method == "POST":
            self.authorize(username, self.default_database, WRITE)
            response = self.mcp.handle_jsonrpc(payload)
            return (200, response) if response is not None else (202, {})

        # GraphQL endpoint + playground
        if parsed.path == "/graphql":
            if method == "GET":
                from nornicdb_tpu_torch.api.graphql import PLAYGROUND_HTML

                return 200, PLAYGROUND_HTML
            if method == "POST":
                from nornicdb_tpu_torch.api.graphql import GraphQLAPI, GraphQLError

                q = payload.get("query", "")
                op_name = payload.get("operationName")
                try:
                    kind = GraphQLAPI.operation_kind(q, op_name)
                except GraphQLError as e:
                    return 200, {"data": None,
                                 "errors": [{"message": str(e)}]}
                self.authorize(
                    username, self.default_database,
                    WRITE if kind == "mutation" else READ,
                )
                return 200, self.graphql.execute(
                    q, payload.get("variables"), op_name)

        if parsed.path == "/status":
            return 200, self._status()
        if parsed.path == "/debug/profile" and method == "POST":
            # pprof analog (reference keeps pprof routes behind a build
            # flag, server_router.go:302-314): profile one statement and
            # return the hottest frames. Admin-only.
            self.authorize(username, self.default_database, ADMIN)
            return self._debug_profile(payload)

        # Neo4j transactional HTTP API: /db/{name}/tx[/commit|/{txid}...]
        if segments[:1] == ["db"] and len(segments) >= 3:
            return self._db_routes(method, segments, payload, username)

        # REST convenience API (reference: server_nornicdb.go)
        if segments[:1] == ["nornicdb"]:
            return self._nornicdb_routes(method, segments, payload, query, username)

        # Heimdall: OpenAI-compatible chat + management
        # (reference: pkg/heimdall OpenAI-compatible chat, scheduler.go:311)
        if parsed.path == "/v1/chat/completions" and method == "POST":
            self.authorize(username, self.default_database, READ)
            return self._chat_completions(payload, username)
        if segments[:1] == ["heimdall"]:
            self.authorize(username, self.default_database,
                           WRITE if method == "POST" else READ)
            return self._heimdall_routes(method, segments, payload, username)

        # Qdrant-compatible REST surface: the Qdrant HTTP wire format
        # over the DB's QdrantCompat
        if segments[:1] == ["collections"]:
            self.authorize(
                username, self.default_database,
                WRITE if method in ("PUT", "DELETE") or
                (len(segments) >= 3 and segments[2] == "points" and
                 segments[-1] in ("delete",)) else READ,
            )
            return self._qdrant_routes(method, segments, payload, query)

        # admin
        if segments[:1] == ["admin"]:
            return self._admin_routes(method, segments, payload, username)

        raise HTTPError(404, "Neo.ClientError.Request.Invalid",
                        f"no route for {method} {parsed.path}")

    def _metric_snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        try:
            out["nodes_total"] = float(self.db.storage.count_nodes())
            out["edges_total"] = float(self.db.storage.count_edges())
        except Exception as exc:
            if is_device_fault(exc):
                raise  # never hidden behind a probe (C39)
        return out

    def _readyz(self) -> Tuple[int, Any]:
        """Readiness verdict from the resource-accounting snapshot:
        degraded (503) while any registered index has a background
        rebuild in flight, any changelog is near overrun (the device
        paths are about to fall back to host-exact serving), or any
        MicroBatcher queue is saturated past its drain rate. Thresholds:
        ``NORNICDB_READY_CHANGELOG_FRAC`` (default 0.9) and
        ``NORNICDB_READY_QUEUE_FACTOR`` (default 1.0 x max_batch)."""
        from nornicdb_tpu_torch.config import env_float

        changelog_frac = env_float("READY_CHANGELOG_FRAC", 0.9)
        queue_factor = env_float("READY_QUEUE_FACTOR", 1.0)
        reasons: List[str] = []
        checks = {"indexes": 0, "queues": 0, "rebuilds_pending": 0,
                  "changelogs_near_overrun": 0, "queues_saturated": 0,
                  "parity_breaches": 0}
        for entry in obs.resource_snapshot():
            name = f"{entry['family']}/{entry['index']}"
            if "queue_depth" in entry and "rows" not in entry:
                checks["queues"] += 1
                limit = max(1, int((entry.get("max_batch") or 64)
                                   * queue_factor))
                if entry["queue_depth"] >= limit:
                    checks["queues_saturated"] += 1
                    reasons.append(
                        f"queue_saturated:{entry['index']}"
                        f"({entry['queue_depth']}/{limit})")
                continue
            checks["indexes"] += 1
            if entry.get("rebuild_in_flight"):
                checks["rebuilds_pending"] += 1
                reasons.append(f"index_rebuild:{name}")
            depth = entry.get("changelog_depth")
            cap = entry.get("changelog_cap")
            if depth is not None and cap and depth >= changelog_frac * cap:
                checks["changelogs_near_overrun"] += 1
                reasons.append(
                    f"changelog_near_overrun:{name}({depth}/{cap})")
        # device-memory ledger (ISSUE 20): shape-derived gauges vs the
        # backend's own live-buffer accounting — sustained drift past
        # the bound means bytes the accounting cannot name (a leak, or
        # an unregistered resident slab); either way this node's
        # capacity story is wrong and an operator must look
        try:
            mem = obs.device.reconcile()
            checks["device_mem_leak"] = int(bool(mem["leak_suspected"]))
            if mem["leak_suspected"]:
                reasons.append(
                    f"device_mem_drift:{mem['drift_bytes']}"
                    f">{mem['bound_bytes']}")
        except Exception as exc:
            if is_device_fault(exc):
                raise  # never hidden behind a probe (C39)
        # shadow-parity breaches (ISSUE 10): a tier whose device/host
        # parity sits below its documented floor must rotate this node
        # out of traffic — serving fast wrong answers is not ready
        try:
            for b in obs.parity_breaches():
                checks["parity_breaches"] += 1
                reasons.append(
                    f"parity_breach:{b['surface']}:{b['tier']}"
                    f"({b['ratio']}<{b['floor']})")
        except Exception as exc:
            if is_device_fault(exc):
                raise  # never hidden behind a probe (C39)
        # read-replica freshness (ISSUE 12): a fleet node behind the
        # NORNICDB_READY_MAX_LAG_OPS threshold or mid catch-up must
        # drain — the router (and any load balancer probing this
        # endpoint) stops sending it reads instead of letting it serve
        # answers staler than the documented bound
        fleet = getattr(self.db, "fleet_node", None)
        replica_doc: Optional[Dict[str, Any]] = None
        if fleet is not None:
            checks["replica"] = 1
            checks["replica_not_ready"] = 0
            try:
                for r in fleet.ready_reasons():
                    checks["replica_not_ready"] += 1
                    reasons.append(r)
            except Exception as exc:
                if is_device_fault(exc):
                    raise  # never hidden behind a probe (C39)
                # fail CLOSED: a replica whose freshness verdict cannot
                # be computed (teardown race, bad env) must drain, not
                # keep taking reads it can no longer prove fresh
                checks["replica_not_ready"] += 1
                reasons.append("replica_state_unknown")
            # watermark truth for remote probers (ISSUE 16): the fleet
            # router's lease grants and lag checks read this node's
            # applied seq/epoch off the same probe that carries the
            # ready verdict — no second round-trip
            st = getattr(fleet, "standby", None)
            if st is not None:
                try:
                    replica_doc = {
                        "node": fleet.name,
                        "applied_seq": int(st.applied_seq),
                        "lag_ops": int(st.lag_ops()),
                        "epoch": int(st.epoch),
                        "catching_up": bool(st.catching_up),
                    }
                except Exception as exc:  # noqa: BLE001 — probe stays best-effort
                    if is_device_fault(exc):
                        raise  # never hidden behind a probe (C39)
                    replica_doc = None
        # keep the SLO sample ring warm from the probe cadence (the
        # engine is scrape-driven; kubelet-style periodic readiness
        # probes give it a steady clock even with /metrics unscraped)
        try:
            obs.get_slo_engine().tick()
        except Exception as exc:
            if is_device_fault(exc):
                raise  # never hidden behind a probe (C39)
        if reasons:
            doc = {"status": "degraded", "reasons": sorted(reasons),
                   "checks": checks}
            if replica_doc is not None:
                doc["replica"] = replica_doc
            return 503, doc
        doc = {"status": "ready", "checks": checks}
        if replica_doc is not None:
            doc["replica"] = replica_doc
        return 200, doc

    def _debug_profile(self, payload: Dict[str, Any]) -> Tuple[int, Any]:
        """Run one Cypher statement under cProfile; return wall time and
        the top frames by cumulative time."""
        import cProfile
        import pstats

        if not isinstance(payload, dict):
            return 400, {"error": "JSON object body required"}
        statement = str(payload.get("statement") or "")
        if not statement:
            return 400, {"error": "statement required"}
        params = payload.get("parameters") or {}
        try:
            repeat = int(payload.get("repeat", 1))
        except (TypeError, ValueError):
            return 400, {"error": "repeat must be an integer"}
        repeat = max(1, min(repeat, 1000))
        executor = self.db.executor
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        try:
            for _ in range(repeat):
                result = executor.execute(statement, params)
        except Exception as exc:
            # caller's statement failed: client error, not a server
            # fault (the finally disables the profiler)
            return 400, {"error": f"{type(exc).__name__}: {exc}"[:400]}
        finally:
            prof.disable()
        wall_ms = (time.perf_counter() - t0) * 1e3
        stats = pstats.Stats(prof)
        frames = []
        for func, (cc, nc, tt, ct, _callers) in sorted(
                stats.stats.items(), key=lambda kv: -kv[1][3])[:25]:
            filename, line, name = func
            frames.append({
                "function": f"{filename.rsplit('/', 1)[-1]}:{line}({name})",
                "calls": nc,
                "tottime_ms": round(tt * 1e3, 3),
                "cumtime_ms": round(ct * 1e3, 3),
            })
        return 200, {
            "statement": statement,
            "repeat": repeat,
            "wall_ms": round(wall_ms, 3),
            "rows": result.n_rows,
            "top_frames": frames,
        }

    def _status(self) -> Dict[str, Any]:
        dbs: List[str] = [self.default_database]
        if self.database_manager is not None:
            dbs = [d.name for d in self.database_manager.list_databases()]
        doc = {
            "server": SERVER_NAME, "version": API_VERSION,
            "databases": dbs,
            "counts": {"nodes": self.db.storage.count_nodes(),
                       "edges": self.db.storage.count_edges()},
        }
        svc = self.db._search  # don't force an index build from /status
        if svc is not None:
            doc["search"] = {
                "indexed_docs": svc.stats.indexed_docs,
                "indexed_vectors": svc.stats.indexed_vectors,
                "strategy": svc.stats.strategy,
            }
            if svc.stats.last_timings:  # NORNICDB_TPU_SEARCH_DIAG set
                doc["search"]["last_timings_ms"] = {
                    k: round(v, 3) for k, v in svc.stats.last_timings.items()
                }
        return doc

    def _login(self, payload: Dict[str, Any]) -> Tuple[int, Any]:
        if self.authenticator is None:
            raise HTTPError(400, "Neo.ClientError.Request.Invalid",
                            "auth disabled")
        try:
            token = self.authenticator.login(
                payload.get("username", ""), payload.get("password", ""))
        except AuthError as e:
            self.audit.record(AUTH, "login", actor=payload.get("username", ""),
                              success=False)
            raise HTTPError(401, "Neo.ClientError.Security.Unauthorized", str(e))
        self.audit.record(AUTH, "login", actor=payload.get("username", ""))
        return 200, {"token": token}

    # -- Neo4j transactional HTTP API ------------------------------------

    def _db_routes(self, method: str, segments: List[str],
                   payload: Dict[str, Any],
                   username: Optional[str]) -> Tuple[int, Any]:
        database = segments[1]
        if segments[2] != "tx":
            raise HTTPError(404, "Neo.ClientError.Request.Invalid", "unknown route")
        statements = payload.get("statements", [])
        writes = any(_is_write(s.get("statement", "")) for s in statements)
        self.authorize(username, database, WRITE if writes else READ)

        # POST /db/{name}/tx/commit — one-shot
        if len(segments) == 4 and segments[3] == "commit":
            executor = self.executor_for(database)
            if writes:
                self.metrics.inc("cypher_writes_total")
                self.audit.record(DATA_WRITE, "cypher", actor=username or "",
                                  database=database)
            return 200, self._run_statements(executor, statements,
                                               database=database)

        # POST /db/{name}/tx — open explicit tx
        if len(segments) == 3 and method == "POST":
            tx_id = uuid.uuid4().hex[:16]
            storage = self.storage_for(database)
            tx = self.tx_manager.begin(tx_id, storage)
            from nornicdb_tpu_torch.query.executor import CypherExecutor

            ex = CypherExecutor(tx, device=self.device)
            with self._lock:
                self._tx_executors[tx_id] = ex
            result = self._run_statements(ex, statements,
                                          database=database)
            result["commit"] = f"/db/{database}/tx/{tx_id}/commit"
            result["transaction"] = {"id": tx_id}
            return 201, result

        # /db/{name}/tx/{txid}[/commit]
        tx_id = segments[3]
        tx = self.tx_manager.get(tx_id)
        with self._lock:
            ex = self._tx_executors.get(tx_id)
        if tx is None or ex is None:
            raise HTTPError(404, "Neo.ClientError.Transaction.TransactionNotFound",
                            f"transaction {tx_id} not found")
        if len(segments) == 5 and segments[4] == "commit":
            result = self._run_statements(ex, statements,
                                          database=database)
            self.tx_manager.commit(tx_id)
            with self._lock:
                self._tx_executors.pop(tx_id, None)
            return 200, result
        if method == "DELETE":
            self.tx_manager.rollback(tx_id)
            with self._lock:
                self._tx_executors.pop(tx_id, None)
            return 200, {"results": [], "errors": []}
        if method == "POST":
            return 200, self._run_statements(ex, statements,
                                           database=database)
        raise HTTPError(405, "Neo.ClientError.Request.Invalid", "bad method")

    def _run_statements(self, executor, statements,
                        database: Optional[str] = None) -> Dict[str, Any]:
        results, errors = [], []
        for stmt in statements:
            q = stmt.get("statement", "")
            params = stmt.get("parameters", {}) or {}
            try:
                if database is not None and self.database_manager is not None:
                    # per-db rate limits + result caps (reference:
                    # pkg/multidb limits.go + enforcement.go)
                    self.database_manager.enforce_query(database, _is_write(q))
                r = executor.execute(q, params)
                if database is not None and self.database_manager is not None:
                    self.database_manager.truncate_result(database, r)
            except Exception as e:  # noqa: BLE001 — per-statement errors
                errors.append({"code": _http_error_code(e), "message": str(e)})
                break  # Neo4j stops at first error
            results.append({
                "columns": r.columns,
                "data": [{"row": [_jsonable(v) for v in row], "meta": []}
                         for row in r.rows],
                "stats": r.stats.to_dict() if hasattr(r.stats, "to_dict") else {},
            })
        # the cypher tx path has no audit serve chokepoint — the
        # per-tenant request still counts, once per tx (ISSUE 18)
        _tenant.record_served("http", "host")
        return {"results": results, "errors": errors}

    def _search_response_bytes(self, body: bytes, headers) -> bytes:
        """Serve POST /nornicdb/search from the response-bytes cache,
        computing + storing on miss. Keyed on (Authorization, body) so a
        differently-privileged caller can never ride another's entry;
        generation-validated against the search result cache so any
        index mutation invalidates (reference: searchResultCache
        semantics, search.go:88-92)."""
        svc = self.db.search
        gen = svc._result_cache.generation
        key = (headers.get("Authorization", ""), body)
        hit = self._search_wire.get(key)
        if hit is not None and hit[0] == gen:
            self.metrics.inc("search_requests_total")
            _SEARCH_CACHED_SERVED.inc()
            # the pre-bound child skips record_served; per-tenant
            # attribution still counts the hit (ISSUE 18)
            _tenant.record_served("hybrid", "cached")
            return hit[1]
        # admission verdict AFTER the cache probe (ISSUE 15): a
        # byte-fresh hit is pure goodput and is never shed — only a
        # MISS (real device/storage work) passes the controller
        _adm.check("http", _adm.lane())
        status, payload = self.route("POST", "/nornicdb/search", body,
                                     headers)
        if status != 200:
            raise HTTPError(status, "Neo.ClientError.Request.Invalid",
                            str(payload)[:200])
        data = json.dumps(payload, default=_json_default).encode()
        self._search_wire.put(key, (gen, data))
        return data

    def _graphql_response_bytes(self, body: bytes, headers) -> bytes:
        """Serve POST /graphql from the response-bytes cache. Only
        query-kind documents are stored (mutations always execute), and
        entries are validated against the graph-mutation generation, so
        a write through ANY surface invalidates."""
        gen = self._graph_gen.gen
        key = (headers.get("Authorization", ""), body)
        hit = self._graphql_wire.get(key)
        if hit is not None and hit[0] == gen:
            return hit[1]
        # miss-only admission verdict: cache hits are never shed
        _adm.check("http", _adm.lane())
        status, payload = self.route("POST", "/graphql", body, headers)
        if status != 200:
            raise HTTPError(status, "Neo.ClientError.Request.Invalid",
                            str(payload)[:200])
        data = json.dumps(payload, default=_json_default).encode()
        try:
            from nornicdb_tpu_torch.api.graphql import GraphQLAPI

            doc = json.loads(body)
            kind = GraphQLAPI.operation_kind(
                doc.get("query", ""), doc.get("operationName"))
        except Exception:
            kind = "mutation"  # unparseable: never cache
        if (kind == "query" and isinstance(payload, dict)
                and not payload.get("errors")):
            # gen was read BEFORE execution: a write racing the compute
            # leaves a stale-gen entry the next get rejects
            self._graphql_wire.put(key, (gen, data))
        return data

    # -- REST convenience API --------------------------------------------

    def _nornicdb_routes(self, method: str, segments: List[str],
                         payload: Dict[str, Any], query: Dict[str, str],
                         username: Optional[str]) -> Tuple[int, Any]:
        database = query.get("db", self.default_database)
        action = segments[1] if len(segments) > 1 else ""

        if action == "search" and method == "POST":
            self.authorize(username, database, READ)
            self.metrics.inc("search_requests_total")
            q = payload.get("query", "")
            limit = int(payload.get("limit", 10))
            kw: Dict[str, Any] = {}
            if payload.get("mode"):
                mode = str(payload["mode"])
                if mode not in ("hybrid", "text", "vector"):
                    # the openapi enum is the contract: a typo'd mode
                    # must be a 400, not a silently empty result set
                    raise HTTPError(
                        400, "Neo.ClientError.Request.InvalidFormat",
                        "mode must be one of hybrid, text, vector")
                kw["mode"] = mode
            # weighted RRF (reference: Service.Search weighted fusion):
            # [lexical, vector] source weights, validated here so a bad
            # body is a 400, not a device-path error
            w = payload.get("weights")
            if w is not None:
                if (not isinstance(w, (list, tuple)) or len(w) != 2
                        or not all(isinstance(x, (int, float)) for x in w)):
                    raise HTTPError(
                        400, "Neo.ClientError.Request.InvalidFormat",
                        "weights must be [lexical_weight, vector_weight]")
                kw["weights"] = (float(w[0]), float(w[1]))
            results = self.db.search.search(q, limit=limit, **kw)
            # raw results: _reply's json default converts lazily
            return 200, {"results": results}

        if action == "similar" and method == "POST":
            self.authorize(username, database, READ)
            node_id = payload.get("node_id", "")
            limit = int(payload.get("limit", 10))
            results = self.db.search.similar(node_id, limit=limit)
            return 200, {"results": results}

        if action == "graph_search" and method == "POST":
            # fused traverse-then-rank (query/device_graph.py): expand
            # 1-2 hops from the anchor, rank the distinct frontier by
            # cosine similarity — one device dispatch when gated on
            self.authorize(username, database, READ)
            anchor = payload.get("anchor_id", "")
            vec = payload.get("vector")
            hops = payload.get("hops")
            if not anchor or not isinstance(vec, list) or not vec \
                    or not isinstance(hops, list) or not hops:
                raise HTTPError(
                    400, "Neo.ClientError.Request.InvalidFormat",
                    "graph_search needs anchor_id, hops and vector")
            limit = int(payload.get("limit", 10))
            try:
                hits = self.db.graph_vector_search(
                    anchor, hops, vec, k=limit)
            except ValueError as exc:
                raise HTTPError(
                    400, "Neo.ClientError.Request.InvalidFormat",
                    str(exc))
            return 200, {"results": [
                {"node_id": nid, "score": score} for nid, score in hits]}

        if action == "store" and method == "POST":
            self.authorize(username, database, WRITE)
            node = self.db.store(
                payload.get("content", ""),
                labels=payload.get("labels"),
                properties=payload.get("properties"),
                node_id=payload.get("id"),
                embedding=payload.get("embedding"),
            )
            self.audit.record(DATA_WRITE, "store", actor=username or "",
                              database=database, target=node.id)
            return 201, {"id": node.id}

        if action == "decay" and method == "GET":
            self.authorize(username, database, READ)
            scores = self.db.decay.scores()
            return 200, {"scores": [
                {"node_id": s.node_id, "score": s.score, "tier": s.tier}
                for s in scores]}

        if action == "embed" and method == "POST":
            self.authorize(username, database, WRITE)
            if self.db._embedder is None:
                raise HTTPError(400, "Neo.ClientError.Request.Invalid",
                                "no embedder configured")
            vectors = self.db._embedder.embed_batch(payload.get("texts", []))
            return 200, {"embeddings": [list(map(float, v)) for v in vectors]}

        if action == "gdpr" and len(segments) > 2:
            from nornicdb_tpu_torch.retention import gdpr_delete, gdpr_export

            prop = payload.get("property", "")
            value = payload.get("value")
            if segments[2] == "export" and method == "POST":
                self.authorize(username, database, READ)
                self.audit.record(GDPR, "export", actor=username or "")
                return 200, gdpr_export(self.db.storage, prop, value)
            if segments[2] == "delete" and method == "POST":
                self.authorize(username, database, ADMIN)
                n = gdpr_delete(self.db.storage, prop, value)
                self.audit.record(GDPR, "delete", actor=username or "",
                                  details={"deleted": n})
                return 200, {"deleted": n}

        raise HTTPError(404, "Neo.ClientError.Request.Invalid",
                        f"no route /nornicdb/{action}")

    # -- qdrant-compatible REST ------------------------------------------

    @property
    def qdrant(self):
        return self.db.qdrant_compat

    @property
    def graphql(self):
        if getattr(self, "_graphql", None) is None:
            from nornicdb_tpu_torch.api.graphql import GraphQLAPI

            self._graphql = GraphQLAPI(self.db)
        return self._graphql

    def _qdrant_snapshot_dir(self) -> str:
        import tempfile

        data_dir = getattr(self.db, "_data_dir", None)
        return (os.path.join(data_dir, "qdrant-snapshots") if data_dir
                else os.path.join(tempfile.gettempdir(),
                                  "nornicdb-qdrant-snapshots"))

    def _qdrant_routes(self, method: str, segments: List[str],
                       payload: Dict[str, Any],
                       query: Dict[str, str]) -> Tuple[int, Any]:
        """Qdrant REST wire format: every response is
        {"result": ..., "status": "ok", "time": seconds}."""
        from nornicdb_tpu_torch.api.qdrant import QdrantError

        t0 = time.time()

        def ok(result: Any, status: int = 200) -> Tuple[int, Any]:
            return status, {"result": result, "status": "ok",
                            "time": time.time() - t0}

        try:
            q = self.qdrant
            if len(segments) == 1 and method == "GET":
                return ok({"collections": [
                    {"name": n} for n in q.list_collections()
                ]})
            if segments[1:] == ["aliases"] and method == "GET":
                return ok({"aliases": q.list_aliases()})
            name = segments[1] if len(segments) > 1 else ""
            if len(segments) == 2:
                if method == "PUT":
                    return ok(q.create_collection(
                        name, payload.get("vectors")))
                if method == "DELETE":
                    return ok(q.delete_collection(name))
                if method == "GET":
                    return ok(q.get_collection(name))
            if segments[1:] == ["aliases"] and method == "POST":
                # upstream POST /collections/aliases ChangeAliases body
                actions = []
                for act in payload.get("actions", []):
                    if "create_alias" in act:
                        a = act["create_alias"]
                        actions.append({"create": {
                            "alias": a.get("alias_name", ""),
                            "collection": a.get("collection_name", "")}})
                    elif "rename_alias" in act:
                        a = act["rename_alias"]
                        actions.append({"rename": {
                            "old": a.get("old_alias_name", ""),
                            "new": a.get("new_alias_name", "")}})
                    elif "delete_alias" in act:
                        actions.append({"delete": {
                            "alias": act["delete_alias"].get(
                                "alias_name", "")}})
                return ok(q.update_aliases(actions))
            if len(segments) == 3 and segments[2] == "aliases" \
                    and method == "GET":
                return ok({"aliases": q.list_aliases(name)})
            if len(segments) >= 3 and segments[2] == "snapshots":
                snap_dir = self._qdrant_snapshot_dir()
                if method == "POST" and len(segments) == 3:
                    return ok(q.create_snapshot(name, snap_dir))
                if method == "GET" and len(segments) == 3:
                    return ok(q.list_snapshots(name, snap_dir))
                if method == "DELETE" and len(segments) == 4:
                    return ok(q.delete_snapshot(name, segments[3],
                                                snap_dir))
                if method == "PUT" and len(segments) == 5 \
                        and segments[4] == "recover":
                    return ok({"restored": q.recover_snapshot(
                        name, segments[3], snap_dir)})
            if len(segments) >= 3 and segments[2] == "points":
                action = segments[3] if len(segments) > 3 else ""
                if method == "PUT" and not action:
                    n = q.upsert_points(name, payload.get("points", []))
                    # write path has no audit serve chokepoint — the
                    # per-tenant request (and its rate window) still
                    # counts the bulk upsert
                    _tenant.record_served("qdrant", "host")
                    return ok({"operation_id": n, "status": "completed"})
                if method == "POST" and not action:
                    return ok(q.retrieve_points(
                        name, payload.get("ids", []),
                        with_payload=payload.get("with_payload", True),
                        with_vector=payload.get("with_vector", False)))
                if method == "POST" and action == "search":
                    return ok(q.search_points(
                        name, payload.get("vector", []),
                        limit=int(payload.get("limit", 10)),
                        with_payload=payload.get("with_payload", True),
                        with_vector=payload.get("with_vector", False),
                        score_threshold=payload.get("score_threshold"),
                        query_filter=payload.get("filter")))
                if method == "POST" and action == "query":
                    # universal query API subset: nearest by raw vector
                    qv = payload.get("query")
                    if isinstance(qv, dict):
                        qv = qv.get("nearest")
                    pts = q.search_points(
                        name, qv or [],
                        limit=int(payload.get("limit", 10)),
                        with_payload=payload.get("with_payload", True),
                        with_vector=payload.get("with_vector", False),
                        query_filter=payload.get("filter"))
                    return ok({"points": pts})
                if method == "POST" and action == "delete":
                    n = q.delete_points(
                        name,
                        payload.get("points", payload.get("ids", [])))
                    return ok({"operation_id": n, "status": "completed"})
                if method == "POST" and action == "count":
                    return ok({"count": q.count_points(name)})
                if method == "POST" and action == "scroll":
                    return ok(q.scroll_points(
                        name,
                        offset=payload.get("offset"),
                        limit=int(payload.get("limit", 10)),
                        with_payload=payload.get("with_payload", True),
                        with_vector=payload.get("with_vector", False)))
        except QdrantError as e:
            return e.status, {"status": {"error": str(e)},
                              "time": time.time() - t0}
        raise HTTPError(404, "Neo.ClientError.Request.Invalid",
                        f"no qdrant route {method} /{'/'.join(segments)}")

    # -- Heimdall ----------------------------------------------------------

    @property
    def heimdall(self):
        """Heimdall manager + Bifrost, lazily stood up with the tiny
        in-process SLM registered on the DB's device."""
        with self._lock:
            if getattr(self, "_heimdall", None) is None:
                from nornicdb_tpu_torch.heimdall import (
                    Bifrost, Manager, ModelSpec,
                )
                from nornicdb_tpu_torch.heimdall.model import DecoderConfig

                mgr = Manager()
                mgr.register(ModelSpec(
                    name="heimdall-slm", backend="torch",
                    options={"cfg": DecoderConfig.tiny(),
                             "device": getattr(self.db, "device", None)}))
                mgr.bifrost = Bifrost()
                self._heimdall = mgr
            return self._heimdall

    def _stream_bifrost(self, handler, idle_timeout: float = 10.0) -> None:
        """Stream Bifrost events as SSE until the client disconnects or
        the stream is idle past idle_timeout. Auth runs first — the feed
        carries tool-call args and must not be weaker than other routes."""
        from urllib.parse import parse_qs as _pq, urlparse as _up

        try:
            username = self.authenticate(handler.headers)
            self.authorize(username, self.default_database, READ)
        except (AuthError, PermissionDenied, HTTPError) as e:
            status = getattr(e, "status", 401)
            handler._reply(status if isinstance(status, int) else 401,
                           {"errors": [{"message": str(e)}]})
            return
        q = {k: v[0] for k, v in _pq(_up(handler.path).query).items()}
        try:
            idle = min(max(float(q.get("idle_timeout", idle_timeout)),
                           0.1), 120.0)
        except (TypeError, ValueError):
            handler._reply(400, {"errors": [
                {"message": "idle_timeout must be a number"}]})
            return
        bifrost = self.heimdall.bifrost
        sid = bifrost.subscribe()
        try:
            handler.close_connection = True  # streamed body has no length
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Connection", "close")
            handler.end_headers()
            handler.wfile.write(b": connected\n\n")
            handler.wfile.flush()
            for msg in bifrost.events(sid, timeout=idle):
                handler.wfile.write(bifrost.sse(msg).encode())
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            bifrost.unsubscribe(sid)

    def _chat_completions(self, payload: Dict[str, Any],
                          username: Optional[str]) -> Tuple[int, Any]:
        """OpenAI-compatible /v1/chat/completions."""
        messages = payload.get("messages") or []
        result = self.heimdall.chat(
            messages,
            model=payload.get("model"),
            max_tokens=int(payload.get("max_tokens", 256)),
            temperature=float(payload.get("temperature", 0.0)),
            user=username,
        )
        now = int(time.time())
        return 200, {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": now,
            "model": result.model,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": result.text},
                "finish_reason": "stop",
            }],
            "usage": _usage(messages, result.text),
        }

    def _heimdall_routes(self, method: str, segments: List[str],
                         payload: Dict[str, Any],
                         username: Optional[str]) -> Tuple[int, Any]:
        action = segments[1] if len(segments) > 1 else ""
        mgr = self.heimdall
        if action == "models" and method == "GET":
            return 200, {"models": [
                {"name": s.name, "backend": s.backend, "loaded": s.loaded,
                 "memory_bytes": s.memory_bytes}
                for s in mgr.models()
            ]}
        if action == "generate" and method == "POST":
            r = mgr.generate(
                payload.get("prompt", ""),
                model=payload.get("model"),
                max_tokens=int(payload.get("max_tokens", 256)),
                temperature=float(payload.get("temperature", 0.0)),
                user=username,
            )
            return 200, {"text": r.text, "model": r.model,
                         "took_ms": r.took_ms}
        if action == "tools" and method == "POST":
            r = mgr.generate_with_tools(
                payload.get("prompt", ""), self.mcp,
                model=payload.get("model"),
                max_rounds=int(payload.get("max_rounds", 4)),
                max_tokens=int(payload.get("max_tokens", 256)),
                user=username,
            )
            return 200, {"text": r.text, "model": r.model,
                         "tool_calls": r.tool_calls, "took_ms": r.took_ms}
        raise HTTPError(404, "Neo.ClientError.Request.Invalid",
                        f"no heimdall route {method} /{'/'.join(segments)}")

    # -- admin -----------------------------------------------------------

    def _admin_routes(self, method: str, segments: List[str],
                      payload: Dict[str, Any],
                      username: Optional[str]) -> Tuple[int, Any]:
        self.authorize(username, "system", ADMIN)
        action = segments[1] if len(segments) > 1 else ""

        if action == "traces" and method == "GET":
            # slow-request ring buffer: full span trees of the most
            # recent requests over NORNICDB_OBS_SLOW_MS (default 0 =
            # every request, ring-bounded). /admin/traces/slowest ranks
            # by duration instead of recency.
            if len(segments) > 2 and segments[2] == "slowest":
                return 200, {"slow_ms": obs.TRACES.slow_ms,
                             "recorded": obs.TRACES.recorded,
                             "traces": obs.TRACES.slowest(limit=10)}
            return 200, {"slow_ms": obs.TRACES.slow_ms,
                         "recorded": obs.TRACES.recorded,
                         "traces": obs.TRACES.snapshot(limit=50)}

        if action == "telemetry" and method == "GET":
            # include_empty: brand-new/idle histogram series report
            # count 0 with null percentiles — never a raise, never a
            # silent hole in the series list
            doc: Dict[str, Any] = {
                "latency": obs.latency_summary(include_empty=True),
                "compile_universe": obs.compile_universe(),
                "resources": obs.resource_snapshot(),
                # stage decomposition + queueing fraction per surface:
                # "slow because queued" vs "slow because compute" is
                # one query here, not a histogram-math exercise
                "stages": obs.stage_summary(),
                # per-query device cost: flops/bytes per (kind, index),
                # the pricing admission control / routing will consume
                "cost": obs.cost_summary(),
                # serving-tier truth (ISSUE 10): which ladder rung
                # answered (tier mix) and the shadow-parity state
                "tiers": obs.tier_mix(),
                "parity": obs.audit_summary(),
                # the admission actuator's verdict + lane state
                # (ISSUE 15): same block /admin/scheduler serves
                "scheduler": _adm.scheduler_summary(),
                "rate_limiter_clients":
                    self.rate_limiter.tracked_clients(),
                # per-tenant truth (ISSUE 18): top-K by cost with the
                # attribution-completeness and noisy-neighbor state
                "tenants": obs.tenants_summary(),
                # device truth (ISSUE 20): measured per-kind roofline
                # (effective FLOPs/s, bytes/s, padding efficiency), the
                # calibrated compile split and the memory ledger
                "device": obs.device_summary(),
            }
            svc = self.db._search  # no index build from a telemetry read
            if svc is not None:
                doc["microbatch"] = svc.microbatch_stats()
            return 200, doc

        if action == "tenants" and method == "GET":
            # per-tenant rollup (ISSUE 18): requests/qps/p99/tier mix/
            # sheds/degrades + the cumulative cost meter, top-K by
            # cost, with attribution completeness and the
            # noisy-neighbor detector's window state
            top = None
            if len(segments) > 2 and segments[2].isdigit():
                top = int(segments[2])  # /admin/tenants/<top>
            return 200, obs.tenants_summary(top=top)

        if action == "scheduler" and method == "GET":
            # the admission-control actuator (ISSUE 15): per-lane
            # queue/in-flight depth + drain rates, deadline-miss
            # counters, shed totals and the current admission verdict
            return 200, _adm.scheduler_summary()

        if action == "device" and method == "GET":
            # device truth (ISSUE 20): the calibration roofline per
            # dispatch kind (measured seconds joined against analytic
            # FLOPs/bytes), per-bucket service-time models with the
            # compile/execute split, unexpected-recompile count, and
            # the device-memory ledger reconciliation
            return 200, obs.device_summary()

        if action == "degrades" and method == "GET":
            # the unified degrade ledger (ISSUE 10): structured
            # (from_tier, to_tier, reason, versions) records of every
            # ladder step-down, newest first, plus a reason rollup
            limit = 100
            if len(segments) > 2 and segments[2].isdigit():
                limit = int(segments[2])  # /admin/degrades/<limit>
            doc = dict(obs.degrade_summary())
            doc["degrades"] = obs.degrade_snapshot(limit=limit)
            return 200, doc

        if action == "events" and method == "GET":
            # the unified incident timeline (ISSUE 13): degrades,
            # drains/admits, failovers, quarantines and SLO breaches
            # in one causally-ordered, trace-id-linked stream
            limit = 100
            if len(segments) > 2 and segments[2].isdigit():
                limit = int(segments[2])  # /admin/events/<limit>
            doc = dict(obs.event_summary())
            doc["events"] = obs.event_snapshot(limit=limit)
            return 200, doc

        if action == "fleet" and method == "GET":
            if len(segments) > 2 and segments[2] == "state":
                # this node's registry snapshot in the JSON-safe wire
                # shape — the scrape endpoint remote fleet aggregators
                # pull (obs.fleet.http_state_source)
                from nornicdb_tpu_torch.obs import fleet as _fleet
                from nornicdb_tpu_torch.obs.metrics import dump_state

                return 200, {"state": _fleet.state_to_jsonable(
                    dump_state())}
            # the fleet telemetry aggregator (ISSUE 13): merged
            # worker/plane/replica truth — lag in ops AND seconds,
            # tier mix, failovers, source health, incident rollup
            return 200, obs.fleet_summary()

        if action == "slo":
            engine = obs.get_slo_engine()
            if method == "GET":
                engine.tick()
                return 200, engine.status()
            if method == "POST" and len(segments) > 2 \
                    and segments[2] == "dump":
                # manual flight-recorder capture (same artifact a
                # breach writes automatically)
                path = engine.dump(reason="manual")
                self.audit.record(ADMIN_ACTION, "slo_dump",
                                  actor=username or "", target=path)
                return 200, {"path": path}

        if action == "databases":
            if self.database_manager is None:
                raise HTTPError(400, "Neo.ClientError.Request.Invalid",
                                "multi-database not enabled")
            if method == "GET":
                return 200, {"databases": [
                    {"name": d.name, "status": d.status, "default": d.default}
                    for d in self.database_manager.list_databases()]}
            if method == "POST":
                name = payload.get("name", "")
                self.database_manager.create_database(name)
                self.audit.record(ADMIN_ACTION, "create_database",
                                  actor=username or "", target=name)
                return 201, {"name": name}
            if method == "DELETE" and len(segments) > 2:
                self.database_manager.drop_database(segments[2])
                self.audit.record(ADMIN_ACTION, "drop_database",
                                  actor=username or "", target=segments[2])
                return 200, {"dropped": segments[2]}

        if action == "users":
            # reference: AdminUsers.tsx over the users admin API
            if self.authenticator is None:
                raise HTTPError(400, "Neo.ClientError.Request.Invalid",
                                "auth not enabled")
            a = self.authenticator
            if method == "GET":
                return 200, {"users": [
                    {"username": u,
                     "roles": list(a._users[u].roles),
                     "suspended": a._users[u].suspended}
                    for u in a.list_users()]}
            if method == "POST":
                name = payload.get("username", "")
                pw = payload.get("password", "")
                if not name or not pw:
                    raise HTTPError(400, "Neo.ClientError.Request.Invalid",
                                    "username and password required")
                a.create_user(name, pw, roles=payload.get("roles"))
                self.audit.record(ADMIN_ACTION, "create_user",
                                  actor=username or "", target=name)
                return 201, {"username": name}
            if method == "DELETE" and len(segments) > 2:
                a.delete_user(segments[2])
                self.audit.record(ADMIN_ACTION, "delete_user",
                                  actor=username or "", target=segments[2])
                return 200, {"deleted": segments[2]}
            if method == "PUT" and len(segments) > 2:
                target = segments[2]
                if "suspended" in payload:
                    a.suspend_user(target, bool(payload["suspended"]))
                if "password" in payload:
                    a.set_password(target, payload["password"])
                for role in payload.get("grant_roles", []):
                    a.grant_role(target, role)
                for role in payload.get("revoke_roles", []):
                    a.revoke_role(target, role)
                self.audit.record(ADMIN_ACTION, "update_user",
                                  actor=username or "", target=target)
                return 200, {"username": target}

        if action == "backup" and method == "POST":
            target = payload.get("path", "")
            if not target:
                raise HTTPError(400, "Neo.ClientError.Request.Invalid",
                                "path required")
            n = _backup(self.db.storage, target)
            self.audit.record(ADMIN_ACTION, "backup", actor=username or "",
                              details={"records": n})
            return 200, {"records": n, "path": target}

        if action == "flags":
            from nornicdb_tpu_torch.config import flags

            if method == "GET":
                return 200, flags.all()
            if method == "PUT":
                for k, v in payload.items():
                    flags.set(k, v)
                return 200, flags.all()

        raise HTTPError(404, "Neo.ClientError.Request.Invalid",
                        f"no route /admin/{action}")


_WRITE_RE = re.compile(
    r"\b(CREATE|MERGE|DELETE|DETACH|SET|REMOVE|DROP|LOAD\s+CSV)\b", re.I)


def _usage(messages, completion: str) -> Dict[str, int]:
    """OpenAI-wire usage block (~4 chars/token heuristic). content may
    be explicitly null for assistant tool-call turns."""
    prompt_tokens = sum(
        len(m.get("content") or "") for m in messages) // 4
    completion_tokens = len(completion) // 4
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def _is_write(query: str) -> bool:
    return bool(_WRITE_RE.search(query))


def _http_error_code(e: Exception) -> str:
    from nornicdb_tpu_torch.errors import CypherSyntaxError
    from nornicdb_tpu_torch.multidb import DatabaseLimitExceeded

    if isinstance(e, CypherSyntaxError):
        return "Neo.ClientError.Statement.SyntaxError"
    if isinstance(e, DatabaseLimitExceeded):
        # distinct, retryable class: clients must be able to tell a
        # throttle from a genuine execution failure
        return "Neo.ClientError.Request.RateLimited"
    return "Neo.DatabaseError.Statement.ExecutionFailed"


def _json_default(value: Any) -> Any:
    """json.dumps default hook: called only for values the C encoder
    can't serialize, so the common all-plain-types response pays zero
    conversion cost."""
    from nornicdb_tpu_torch.storage.types import Edge, Node

    if isinstance(value, Node):
        return {"id": value.id, "labels": value.labels,
                "properties": _jsonable(value.properties)}
    if isinstance(value, Edge):
        return {"id": value.id, "type": value.type,
                "start": value.start_node, "end": value.end_node,
                "properties": _jsonable(value.properties)}
    import numpy as np
    import torch

    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, torch.Tensor):
        # a 0-d tensor is the scalar numpy would give: a float32 score
        # becomes the same Python float as float(np.float32(score)), and
        # a bool the string the reference makes of a numpy bool
        if value.ndim == 0 and value.dtype == torch.bool:
            return str(bool(value))
        return value.tolist()
    return str(value)


def _jsonable(value: Any) -> Any:
    from nornicdb_tpu_torch.storage.types import Edge, Node

    if isinstance(value, Node):
        return {"id": value.id, "labels": value.labels,
                "properties": _jsonable(value.properties)}
    if isinstance(value, Edge):
        return {"id": value.id, "type": value.type,
                "start": value.start_node, "end": value.end_node,
                "properties": _jsonable(value.properties)}
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    import numpy as np
    import torch

    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, torch.Tensor):
        return value.tolist()
    return value


@functools.lru_cache(maxsize=1)
def _browser_html() -> str:
    """The embedded single-page admin browser (a copy of the reference's
    ``ui/browser.html``), loaded once per process."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ui", "browser.html")
    with open(path, encoding="utf-8") as f:
        return f.read()


def _backup(storage, target_path: str) -> int:
    """Write a JSONL backup of all nodes+edges (reference:
    badger_backup.go + /admin/backup route)."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(target_path)), exist_ok=True)

    def _default(v):
        # typed property values (temporal/duration/point) keep their tag
        # so a restore revives them; anything else degrades to str
        from nornicdb_tpu_torch.query.temporal_types import encode_value

        try:
            return encode_value(v)
        except TypeError:
            return str(v)

    n = 0
    tmp = target_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for node in storage.all_nodes():
            f.write(json.dumps({"kind": "node", **node.to_dict()},
                               default=_default) + "\n")
            n += 1
        for edge in storage.all_edges():
            f.write(json.dumps({"kind": "edge", **edge.to_dict()},
                               default=_default) + "\n")
            n += 1
    os.replace(tmp, target_path)
    return n
