"""Bolt protocol server (4.0–4.4), which official Neo4j drivers speak
(counterpart of ``nornicdb_tpu/api/bolt.py``; the same messages, codes
and bytes).

Handshake magic 0x6060B017 and version negotiation, chunked transport,
HELLO auth, RUN/PULL/DISCARD streaming with has_more, explicit
BEGIN/COMMIT/ROLLBACK transactions over ``storage/txn.py``'s overlay,
bookmarks. An error in a statement, a device fault among them, is
answered with FAILURE as the reference answers it.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from nornicdb_tpu_torch import obs
from nornicdb_tpu_torch.api.packstream import Packer, Structure, Unpacker, to_packable
from nornicdb_tpu_torch.storage.txn import TransactionOverlay

_BOLT_H = obs.REGISTRY.histogram(
    "nornicdb_bolt_request_seconds",
    "Bolt message handling latency by message type", labels=("msg",))

BOLT_MAGIC = 0x6060B017
SUPPORTED_VERSIONS = [(4, 4), (4, 3), (4, 2), (4, 1), (4, 0)]

# request signatures (reference: server.go:150-158)
MSG_HELLO = 0x01
MSG_GOODBYE = 0x02
MSG_RESET = 0x0F
MSG_RUN = 0x10
MSG_BEGIN = 0x11
MSG_COMMIT = 0x12
MSG_ROLLBACK = 0x13
MSG_DISCARD = 0x2F
MSG_PULL = 0x3F
# response signatures
MSG_SUCCESS = 0x70
MSG_RECORD = 0x71
MSG_IGNORED = 0x7E
MSG_FAILURE = 0x7F

SERVER_AGENT = "NornicTPU/1.0"


class _Stream:
    """One materialized result awaiting PULL/DISCARD."""

    def __init__(self, columns: List[str], rows: List[List[Any]],
                 stats: Optional[Dict[str, Any]] = None):
        self.columns = columns
        self.rows = rows
        self.pos = 0
        self.stats = stats or {}


class BoltSession:
    """Per-connection protocol state machine.

    States: CONNECTED -> READY -> STREAMING (autocommit) or
    TX_READY/TX_STREAMING (explicit tx) -> DEFUNCT on failure until RESET.
    """

    def __init__(self, server: "BoltServer"):
        self.server = server
        self.authed = False
        self.username: Optional[str] = None
        self.failed = False
        self.database = server.default_database
        self.tx: Optional[TransactionOverlay] = None
        self.tx_executor = None
        self.stream: Optional[_Stream] = None
        self.last_bookmark = ""

    # -- message handlers ------------------------------------------------

    _MSG_NAMES = {
        MSG_HELLO: "hello", MSG_GOODBYE: "goodbye", MSG_RESET: "reset",
        MSG_RUN: "run", MSG_BEGIN: "begin", MSG_COMMIT: "commit",
        MSG_ROLLBACK: "rollback", MSG_DISCARD: "discard",
        MSG_PULL: "pull",
    }

    def handle(self, sig: int, fields: List[Any]) -> List[Tuple[int, List[Any]]]:
        """Returns a list of (signature, fields) response messages."""
        t0 = time.perf_counter()
        try:
            if sig == MSG_RUN:
                # RUN carries the query execution — the latency that
                # matters; a root span makes bolt queries show up in
                # the slow-request ring like every other surface
                with obs.trace("wire", method="RUN", transport="bolt"):
                    return self._handle_inner(sig, fields)
            return self._handle_inner(sig, fields)
        finally:
            _BOLT_H.labels(
                self._MSG_NAMES.get(sig, "other")).observe(
                time.perf_counter() - t0)

    def _handle_inner(
        self, sig: int, fields: List[Any]
    ) -> List[Tuple[int, List[Any]]]:
        if self.failed and sig not in (MSG_RESET, MSG_GOODBYE):
            return [(MSG_IGNORED, [{}])]
        try:
            if sig == MSG_HELLO:
                return self._hello(fields[0] if fields else {})
            if sig == MSG_GOODBYE:
                raise _Goodbye()
            if sig == MSG_RESET:
                return self._reset()
            if not self.authed:
                return self._failure("Neo.ClientError.Security.Unauthorized",
                                     "HELLO required before other messages")
            if sig == MSG_RUN:
                return self._run(*(fields + [{}] * (3 - len(fields)))[:3])
            if sig == MSG_PULL:
                return self._pull(fields[0] if fields else {})
            if sig == MSG_DISCARD:
                return self._discard(fields[0] if fields else {})
            if sig == MSG_BEGIN:
                return self._begin(fields[0] if fields else {})
            if sig == MSG_COMMIT:
                return self._commit()
            if sig == MSG_ROLLBACK:
                return self._rollback()
            return self._failure("Neo.ClientError.Request.Invalid",
                                 f"unknown message 0x{sig:02X}")
        except _Goodbye:
            raise
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return self._failure(_error_code(e), str(e))

    def _hello(self, extra: Dict[str, Any]) -> List[Tuple[int, List[Any]]]:
        auth = self.server.authenticator
        if auth is not None:
            scheme = extra.get("scheme", "none")
            principal = extra.get("principal", "")
            credentials = extra.get("credentials", "")
            try:
                if scheme == "basic":
                    auth.login(principal, credentials)
                    self.username = principal
                elif scheme == "bearer":
                    claims = auth.verify_token(credentials)
                    self.username = claims.get("sub")
                else:
                    raise ValueError(f"unsupported auth scheme {scheme!r}")
            except Exception as e:
                self.failed = True
                return self._failure("Neo.ClientError.Security.Unauthorized", str(e))
        self.authed = True
        return [(MSG_SUCCESS, [{
            "server": SERVER_AGENT,
            "connection_id": f"bolt-{uuid.uuid4().hex[:8]}",
        }])]

    def _reset(self) -> List[Tuple[int, List[Any]]]:
        self.failed = False
        self.stream = None
        if self.tx is not None and self.tx.is_open:
            self.tx.rollback()
        self.tx = None
        self.tx_executor = None
        return [(MSG_SUCCESS, [{}])]

    def _executor_for(self, extra: Dict[str, Any]):
        db = extra.get("db") or self.database
        return self.server.executor_for(db)

    def _run(self, query: str, params: Dict[str, Any],
             extra: Dict[str, Any]) -> List[Tuple[int, List[Any]]]:
        if self.stream is not None:
            return self._failure("Neo.ClientError.Request.Invalid",
                                 "previous result not consumed")
        if self.tx is not None and self.tx.is_open:
            executor = self.tx_executor
        else:
            executor = self._executor_for(extra)
        try:
            result = executor.execute(query, params or {})
        except Exception as e:
            self.failed = True
            return self._failure(_error_code(e), str(e))
        self.stream = _Stream(result.columns, result.rows,
                              getattr(result.stats, "to_dict", dict)())
        return [(MSG_SUCCESS, [{"fields": self.stream.columns, "t_first": 0}])]

    def _pull(self, extra: Dict[str, Any]) -> List[Tuple[int, List[Any]]]:
        if self.stream is None:
            return self._failure("Neo.ClientError.Request.Invalid", "no result to pull")
        n = extra.get("n", -1)
        out: List[Tuple[int, List[Any]]] = []
        s = self.stream
        end = len(s.rows) if n < 0 else min(s.pos + n, len(s.rows))
        while s.pos < end:
            out.append((MSG_RECORD, [[to_packable(v) for v in s.rows[s.pos]]]))
            s.pos += 1
        if s.pos >= len(s.rows):
            meta: Dict[str, Any] = {"t_last": 0}
            if s.stats:
                meta["stats"] = s.stats
            if self.tx is None:
                self.last_bookmark = f"bm-{uuid.uuid4().hex[:12]}"
                meta["bookmark"] = self.last_bookmark
            self.stream = None
            out.append((MSG_SUCCESS, [meta]))
        else:
            out.append((MSG_SUCCESS, [{"has_more": True}]))
        return out

    def _discard(self, extra: Dict[str, Any]) -> List[Tuple[int, List[Any]]]:
        if self.stream is None:
            return self._failure("Neo.ClientError.Request.Invalid", "no result to discard")
        n = extra.get("n", -1)
        s = self.stream
        if n < 0 or s.pos + n >= len(s.rows):
            self.stream = None
            return [(MSG_SUCCESS, [{"t_last": 0}])]
        s.pos += n
        return [(MSG_SUCCESS, [{"has_more": True}])]

    def _begin(self, extra: Dict[str, Any]) -> List[Tuple[int, List[Any]]]:
        if self.tx is not None and self.tx.is_open:
            return self._failure("Neo.ClientError.Request.Invalid",
                                 "transaction already open")
        db = extra.get("db") or self.database
        storage = self.server.storage_for(db)
        self.tx = TransactionOverlay(storage)
        from nornicdb_tpu_torch.query.executor import CypherExecutor

        self.tx_executor = CypherExecutor(self.tx, device=self.server.device)
        base = self.server.executor_for(db)
        if getattr(base, "_search", None) is not None:
            self.tx_executor.set_search_service(base._search)
        return [(MSG_SUCCESS, [{}])]

    def _commit(self) -> List[Tuple[int, List[Any]]]:
        if self.tx is None or not self.tx.is_open:
            return self._failure("Neo.ClientError.Request.Invalid", "no open transaction")
        self.tx.commit()
        self.tx = None
        self.tx_executor = None
        self.last_bookmark = f"bm-{uuid.uuid4().hex[:12]}"
        return [(MSG_SUCCESS, [{"bookmark": self.last_bookmark}])]

    def _rollback(self) -> List[Tuple[int, List[Any]]]:
        if self.tx is None or not self.tx.is_open:
            return self._failure("Neo.ClientError.Request.Invalid", "no open transaction")
        self.tx.rollback()
        self.tx = None
        self.tx_executor = None
        return [(MSG_SUCCESS, [{}])]

    def _failure(self, code: str, message: str) -> List[Tuple[int, List[Any]]]:
        self.failed = True
        return [(MSG_FAILURE, [{"code": code, "message": message}])]


class _Goodbye(Exception):
    pass


def _error_code(e: Exception) -> str:
    from nornicdb_tpu_torch.errors import CypherSyntaxError
    from nornicdb_tpu_torch.storage.types import NotFoundError

    if isinstance(e, CypherSyntaxError):
        return "Neo.ClientError.Statement.SyntaxError"
    if isinstance(e, NotFoundError):
        return "Neo.ClientError.Statement.EntityNotFound"
    return "Neo.DatabaseError.General.UnknownError"


# ---------------------------------------------------------------------------
# Transport: handshake + chunked messages over TCP
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def read_message(sock: socket.socket) -> bytes:
    """Read one chunked message (2-byte BE size chunks, 0x0000 ends)."""
    out = b""
    while True:
        size = struct.unpack(">H", _recv_exact(sock, 2))[0]
        if size == 0:
            if out:
                return out
            continue  # NOOP keepalive chunk
        out += _recv_exact(sock, size)


def write_message(sock: socket.socket, payload: bytes) -> None:
    buf = bytearray()
    for i in range(0, len(payload), 65535):
        chunk = payload[i:i + 65535]
        buf += struct.pack(">H", len(chunk)) + chunk
    buf += b"\x00\x00"
    sock.sendall(bytes(buf))


class BoltServer:
    """TCP server hosting BoltSessions over a DB (or DatabaseManager)."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 7687,
                 authenticator=None, database_manager=None):
        self.db = db
        self.host = host
        self.port = port
        self.authenticator = authenticator
        self.database_manager = database_manager
        self.default_database = getattr(db, "database", "neo4j")
        # executors this server builds (other databases, explicit
        # transactions) run on the DB's device
        self.device = getattr(db, "device", None)
        self._executors: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- routing ---------------------------------------------------------

    def storage_for(self, database: str):
        if self.database_manager is not None and database != self.default_database:
            return self.database_manager.get_storage(database)
        return self.db.storage

    def executor_for(self, database: str):
        if database == self.default_database:
            return self.db.executor
        with self._lock:
            ex = self._executors.get(database)
            if ex is None:
                from nornicdb_tpu_torch.query.executor import CypherExecutor

                ex = CypherExecutor(self.storage_for(database), device=self.device)
                self._executors[database] = ex
            return ex

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "BoltServer":
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: D102
                try:
                    # Bolt is a small-message request/response protocol:
                    # without TCP_NODELAY, Nagle + delayed ACK stalls
                    # every exchange ~40ms (observed 22 ops/s vs 2k+)
                    self.request.setsockopt(socket.IPPROTO_TCP,
                                            socket.TCP_NODELAY, 1)
                    outer._serve_connection(self.request)
                except (ConnectionError, OSError, _Goodbye):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="bolt-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    # -- per-connection protocol loop -----------------------------------

    def _serve_connection(self, sock: socket.socket) -> None:
        magic = struct.unpack(">I", _recv_exact(sock, 4))[0]
        if magic != BOLT_MAGIC:
            sock.close()
            return
        proposals = [struct.unpack(">I", _recv_exact(sock, 4))[0] for _ in range(4)]
        chosen = 0
        for p in proposals:
            major, minor = p & 0xFF, (p >> 8) & 0xFF
            if (major, minor) in SUPPORTED_VERSIONS:
                chosen = p & 0xFFFF
                break
            # range notation: minor..minor-range supported in 4.3+
            rng = (p >> 16) & 0xFF
            for delta in range(rng + 1):
                if (major, minor - delta) in SUPPORTED_VERSIONS:
                    chosen = ((minor - delta) << 8) | major
                    break
            if chosen:
                break
        sock.sendall(struct.pack(">I", chosen))
        if chosen == 0:
            sock.close()
            return

        session = BoltSession(self)
        while True:
            payload = read_message(sock)
            msg = Unpacker(payload).unpack()
            if not isinstance(msg, Structure):
                raise ConnectionError("malformed message")
            try:
                responses = session.handle(msg.tag, msg.fields)
            except _Goodbye:
                sock.close()
                return
            for sig, fields in responses:
                p = Packer()
                p.pack(Structure(sig, fields))
                write_message(sock, p.data())
