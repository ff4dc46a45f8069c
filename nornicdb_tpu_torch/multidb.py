"""Multi-database manager over one shared base engine (counterpart of
``nornicdb_tpu/multidb.py``).

Reference: pkg/multidb/manager.go:43 ``DatabaseManager`` with
CreateDatabase/DropDatabase/GetStorage (manager.go:300,339,388), per-DB
limits & enforcement (limits.go, enforcement.go), routing (routing.go).
Databases share one physical store via NamespacedEngine prefixes
(``dbname:``), so create/drop are metadata ops plus a prefix sweep.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nornicdb_tpu_torch.storage import (
    DEFAULT_DB,
    Engine,
    ListenableEngine,
    NamespacedEngine,
    NotFoundError,
)

SYSTEM_DB = "system"

_NAME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9_.-]{0,62}$")


class DatabaseError(ValueError):
    pass


class DatabaseLimitExceeded(DatabaseError):
    """Reference: pkg/multidb/limits.go enforcement."""


@dataclass
class DatabaseLimits:
    """Per-database quotas (reference: limits.go StorageLimits +
    QueryLimits + ConnectionLimits + RateLimits). 0 = unlimited."""

    max_nodes: int = 0
    max_edges: int = 0
    max_bytes: int = 0              # exact serialized size (limits.go:59)
    max_results: int = 0            # rows returned per query
    max_queries_per_second: int = 0
    max_writes_per_second: int = 0
    max_concurrent_queries: int = 0  # QueryLimits.MaxConcurrentQueries
    max_connections: int = 0         # ConnectionLimits.MaxConnections

    def is_unlimited(self) -> bool:
        """Reference: limits.go:136 IsUnlimited."""
        return not any((
            self.max_nodes, self.max_edges, self.max_bytes,
            self.max_results, self.max_queries_per_second,
            self.max_writes_per_second, self.max_concurrent_queries,
            self.max_connections,
        ))


def entity_size(obj) -> int:
    """Exact serialized size of a node/edge for max_bytes accounting
    (reference: enforcement.go:344 calculateNodeSize — gob-serialized
    exact size, no estimation; here the canonical JSON encoding is the
    storage-format equivalent)."""
    import json

    if hasattr(obj, "labels"):
        payload = {"id": obj.id, "labels": obj.labels,
                   "properties": obj.properties}
    else:
        payload = {"id": obj.id, "type": obj.type,
                   "start": obj.start_node, "end": obj.end_node,
                   "properties": obj.properties}
    return len(json.dumps(payload, default=str,
                          separators=(",", ":")).encode("utf-8"))


@dataclass
class DatabaseInfo:
    name: str
    status: str = "online"  # online | offline
    default: bool = False
    system: bool = False
    limits: DatabaseLimits = field(default_factory=DatabaseLimits)


class LimitedEngine(NamespacedEngine):
    """NamespacedEngine that enforces per-DB node/edge/byte quotas on
    create (reference: pkg/multidb/enforcement.go). Byte accounting is
    exact and incremental — one initial scan, then O(1) per mutation
    (enforcement.go: 'Storage size is tracked incrementally for O(1)
    limit checks')."""

    def __init__(self, inner: Engine, database: str, limits: DatabaseLimits):
        super().__init__(inner, database)
        self._limits = limits
        self._bytes: Optional[int] = None  # lazy initial scan
        self._bytes_lock = threading.Lock()

    def _current_bytes_locked(self) -> int:
        if self._bytes is None:
            total = 0
            for n in self.all_nodes():
                total += entity_size(n)
            for e in self.all_edges():
                total += entity_size(e)
            self._bytes = total
        return self._bytes

    def _check_bytes(self, obj) -> int:
        size = entity_size(obj)
        with self._bytes_lock:
            current = self._current_bytes_locked()
            if current + size > self._limits.max_bytes:
                raise DatabaseLimitExceeded(
                    f"would exceed max_bytes limit (current: {current} "
                    f"bytes, limit: {self._limits.max_bytes} bytes, "
                    f"new entity: {size} bytes)")
        return size

    def _add_bytes(self, delta: int) -> None:
        with self._bytes_lock:
            if self._bytes is not None:
                self._bytes = max(0, self._bytes + delta)

    def create_node(self, node):
        lim = self._limits
        if lim.max_nodes and self.count_nodes() >= lim.max_nodes:
            raise DatabaseLimitExceeded(
                f"database has reached max_nodes limit "
                f"({self.count_nodes()}/{lim.max_nodes})")
        size = self._check_bytes(node) if lim.max_bytes else 0
        super().create_node(node)
        if lim.max_bytes:
            self._add_bytes(size)

    def create_edge(self, edge):
        lim = self._limits
        if lim.max_edges and self.count_edges() >= lim.max_edges:
            raise DatabaseLimitExceeded(
                f"database has reached max_edges limit "
                f"({self.count_edges()}/{lim.max_edges})")
        size = self._check_bytes(edge) if lim.max_bytes else 0
        super().create_edge(edge)
        if lim.max_bytes:
            self._add_bytes(size)

    def update_node(self, node):
        if self._limits.max_bytes:
            try:
                old = entity_size(self.get_node(node.id))
            except Exception:
                old = 0
            self._add_bytes(entity_size(node) - old)
        super().update_node(node)

    def delete_node(self, node_id):
        if self._limits.max_bytes:
            try:
                self._add_bytes(-entity_size(self.get_node(node_id)))
            except Exception:
                pass
        super().delete_node(node_id)

    def delete_edge(self, edge_id):
        if self._limits.max_bytes:
            try:
                self._add_bytes(-entity_size(self.get_edge(edge_id)))
            except Exception:
                pass
        super().delete_edge(edge_id)

    def current_bytes(self) -> int:
        """Exact tracked storage size (enforcement.go:244)."""
        with self._bytes_lock:
            return self._current_bytes_locked()


class ConnectionTracker:
    """Per-database connection counting against MaxConnections
    (reference: enforcement.go:513 ConnectionTracker)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def try_increment(self, manager: "DatabaseManager", name: str) -> None:
        lim = manager.get_info(name).limits
        with self._lock:
            cur = self._counts.get(name, 0)
            if lim.max_connections and cur >= lim.max_connections:
                raise DatabaseLimitExceeded(
                    f"database {name!r} has reached max_connections "
                    f"limit ({cur}/{lim.max_connections})")
            self._counts[name] = cur + 1

    def decrement(self, name: str) -> None:
        with self._lock:
            cur = self._counts.get(name, 0)
            if cur <= 1:
                self._counts.pop(name, None)
            else:
                self._counts[name] = cur - 1

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)


class DatabaseManager:
    """Create/drop/list logical databases over one base engine."""

    def __init__(self, base: Engine, default_database: str = DEFAULT_DB,
                 max_databases: int = 64):
        self._base = base
        self._max = max_databases
        self._lock = threading.Lock()
        self._dbs: Dict[str, DatabaseInfo] = {}
        self._engines: Dict[str, ListenableEngine] = {}
        # per-db (window_second, queries, writes) for rate enforcement
        self._rate_windows: Dict[str, tuple] = {}
        # per-db in-flight query counts (MaxConcurrentQueries)
        self._active_queries: Dict[str, int] = {}
        self._dbs[SYSTEM_DB] = DatabaseInfo(name=SYSTEM_DB, system=True)
        self._dbs[default_database] = DatabaseInfo(name=default_database, default=True)
        # adopt pre-existing namespaces found in the store (restart path)
        for ns in base.list_namespaces():
            if ns not in self._dbs and _NAME_RE.match(ns):
                self._dbs[ns] = DatabaseInfo(name=ns)

    # -- lifecycle -------------------------------------------------------

    def create_database(self, name: str, limits: Optional[DatabaseLimits] = None,
                        if_not_exists: bool = False) -> DatabaseInfo:
        with self._lock:
            if not _NAME_RE.match(name):
                raise DatabaseError(f"invalid database name: {name!r}")
            if name in self._dbs:
                if self._dbs[name].status == "dropping":
                    raise DatabaseError(f"database being dropped: {name}")
                if if_not_exists:
                    return self._dbs[name]
                raise DatabaseError(f"database exists: {name}")
            user_dbs = sum(1 for d in self._dbs.values() if not d.system)
            if self._max and user_dbs >= self._max:
                raise DatabaseLimitExceeded(f"max databases ({self._max}) reached")
            info = DatabaseInfo(name=name, limits=limits or DatabaseLimits())
            self._dbs[name] = info
            return info

    def drop_database(self, name: str, if_exists: bool = False) -> bool:
        with self._lock:
            info = self._dbs.get(name)
            if info is None:
                if if_exists:
                    return False
                raise NotFoundError(f"database not found: {name}")
            if info.system:
                raise DatabaseError("cannot drop system database")
            if info.default:
                raise DatabaseError("cannot drop default database")
            if info.status == "dropping":
                raise DatabaseError(f"database already being dropped: {name}")
            # keep the entry as a tombstone until the sweep finishes so a
            # concurrent create_database(name) can't race the deletion
            info.status = "dropping"
            self._engines.pop(name, None)
            self._rate_windows.pop(name, None)
        try:
            # prefix sweep outside the lock — can be large
            self._base.delete_by_prefix(name + ":")
        except BaseException:
            # failed sweep: keep the tombstone so the undeleted rows can't
            # reappear inside a freshly recreated database; a retry of
            # drop_database is blocked with "already being dropped" until
            # an operator resolves it, which is the safe failure mode
            raise
        with self._lock:
            self._dbs.pop(name, None)
        return True

    def list_databases(self) -> List[DatabaseInfo]:
        with self._lock:
            return sorted(self._dbs.values(), key=lambda d: d.name)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._dbs

    def get_info(self, name: str) -> DatabaseInfo:
        with self._lock:
            info = self._dbs.get(name)
        if info is None:
            raise NotFoundError(f"database not found: {name}")
        return info

    def set_status(self, name: str, status: str) -> None:
        if status not in ("online", "offline"):
            raise DatabaseError(f"invalid status: {status}")
        info = self.get_info(name)
        info.status = status

    def set_limits(self, name: str, limits: DatabaseLimits) -> None:
        info = self.get_info(name)
        with self._lock:
            info.limits = limits
            self._engines.pop(name, None)  # rebuild with new limits

    # -- routing (reference: routing.go) ---------------------------------

    def get_storage(self, name: str) -> ListenableEngine:
        """Namespaced, limit-enforcing, listenable view of one database
        (reference: manager.go:388 GetStorage)."""
        with self._lock:
            info = self._dbs.get(name)
            if info is None:
                raise NotFoundError(f"database not found: {name}")
            if info.status != "online":
                raise DatabaseError(f"database offline: {name}")
            eng = self._engines.get(name)
            if eng is None:
                eng = ListenableEngine(LimitedEngine(self._base, name, info.limits))
                self._engines[name] = eng
            return eng

    def enforce_query(self, name: str, is_write: bool = False) -> None:
        """Per-database rate limiting (reference: enforcement.go; fixed
        one-second windows). Raises DatabaseLimitExceeded when the
        database's query or write rate is exhausted."""
        info = self.get_info(name)
        lim = info.limits
        if not (lim.max_queries_per_second or lim.max_writes_per_second):
            return
        now = int(time.time())
        with self._lock:
            win, q, w = self._rate_windows.get(name, (now, 0, 0))
            if win != now:
                win, q, w = now, 0, 0
            q += 1
            if is_write:
                w += 1
            self._rate_windows[name] = (win, q, w)
        if lim.max_queries_per_second and q > lim.max_queries_per_second:
            raise DatabaseLimitExceeded(
                f"database {name!r} query rate limit "
                f"{lim.max_queries_per_second}/s exceeded")
        if is_write and lim.max_writes_per_second and (
            w > lim.max_writes_per_second
        ):
            raise DatabaseLimitExceeded(
                f"database {name!r} write rate limit "
                f"{lim.max_writes_per_second}/s exceeded")

    def query_slot(self, name: str):
        """Context manager enforcing MaxConcurrentQueries (reference:
        enforcement.go:382 CheckQueryLimits): entering counts the query
        against the database's concurrency cap, exiting releases it."""
        manager = self

        class _Slot:
            def __enter__(self):
                lim = manager.get_info(name).limits
                with manager._lock:
                    cur = manager._active_queries.get(name, 0)
                    if (lim.max_concurrent_queries
                            and cur >= lim.max_concurrent_queries):
                        raise DatabaseLimitExceeded(
                            f"database {name!r} has reached "
                            f"max_concurrent_queries limit "
                            f"({cur}/{lim.max_concurrent_queries})")
                    manager._active_queries[name] = cur + 1
                return self

            def __exit__(self, *exc):
                with manager._lock:
                    cur = manager._active_queries.get(name, 1)
                    if cur <= 1:
                        manager._active_queries.pop(name, None)
                    else:
                        manager._active_queries[name] = cur - 1
                return False

        return _Slot()

    # -- legacy migration (reference: migration.go:53) --------------------

    MIGRATION_MARKER = "system:__migration_complete__"

    def is_migration_complete(self) -> bool:
        """Reference: migration.go:98."""
        try:
            return self._base.get_node(self.MIGRATION_MARKER) is not None
        except Exception:
            return False

    def migrate_legacy_data(self, target: Optional[str] = None) -> Dict[str, int]:
        """Move unprefixed (pre-multidb) nodes/edges under the default
        database's namespace (reference: migration.go:53
        migrateLegacyData + detectUnprefixedData + performMigration).
        Idempotent: a completion marker in the system namespace skips
        re-scans on every boot."""
        from nornicdb_tpu_torch.storage.types import Node

        if self.is_migration_complete():
            return {"nodes": 0, "edges": 0, "skipped": 1}
        target = target or next(
            d.name for d in self._dbs.values() if d.default)
        prefix = target + ":"
        known = {d + ":" for d in self._dbs}
        moved_nodes = moved_edges = 0
        legacy_nodes = [
            n for n in self._base.all_nodes()
            if not any(n.id.startswith(p) for p in known)
            and n.id != self.MIGRATION_MARKER
        ]
        legacy_edges = [
            e for e in self._base.all_edges()
            if not any(e.id.startswith(p) for p in known)
        ]
        # create prefixed copies first, then re-point edges, then drop
        # the originals — an interrupted migration leaves duplicates (a
        # re-run converges) rather than data loss
        for n in legacy_nodes:
            c = n.copy()
            c.id = prefix + c.id
            self._base.create_node(c)
            moved_nodes += 1
        for e in legacy_edges:
            c = e.copy()
            c.id = prefix + c.id
            if not any(c.start_node.startswith(p) for p in known):
                c.start_node = prefix + c.start_node
            if not any(c.end_node.startswith(p) for p in known):
                c.end_node = prefix + c.end_node
            self._base.create_edge(c)
            moved_edges += 1
        for e in legacy_edges:
            self._base.delete_edge(e.id)
        for n in legacy_nodes:
            self._base.delete_node(n.id)
        self._base.create_node(Node(
            id=self.MIGRATION_MARKER, labels=["_Migration"],
            properties={"completed": True},
        ))
        return {"nodes": moved_nodes, "edges": moved_edges, "skipped": 0}

    def truncate_result(self, name: str, result) -> None:
        """Cap result rows at the database's max_results (reference:
        QueryLimits.MaxResults)."""
        lim = self.get_info(name).limits
        if lim.max_results and len(result.rows) > lim.max_results:
            del result.rows[lim.max_results:]

    def counts(self, name: str) -> Dict[str, int]:
        eng = self.get_storage(name)
        return {"nodes": eng.count_nodes(), "edges": eng.count_edges()}
