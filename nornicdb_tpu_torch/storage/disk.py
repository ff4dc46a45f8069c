"""Native persistent storage engine over the KV store of
``csrc/kv_host.cpp`` (counterpart of ``nornicdb_tpu/storage/disk.py``;
the same files, key spaces and record bytes).

Node and edge records plus secondary key spaces for label, edge-type and
adjacency lookups, all in one log-structured store, loaded through
ctypes. Values are the record codec's msgpack (``storage/codec.py``).

Key spaces:
  ``n:<id>``                     node record
  ``e:<id>``                     edge record
  ``l:<label>\\x00<id>``          label index (empty value)
  ``t:<type>\\x00<id>``           edge-type index
  ``a:<node>\\x00o\\x00<edge>``    outgoing adjacency
  ``a:<node>\\x00i\\x00<edge>``    incoming adjacency

A store encrypted at rest (its sentinel key, or a value behind the
``NKE1`` magic) raises ``EncryptedStoreError``: at-rest encryption is not
ported.
"""

from __future__ import annotations

import ctypes
import glob
import os
import threading
import time
from typing import Any, Iterable, List, Optional, Sequence, Tuple

from nornicdb_tpu_torch.errors import EncryptedStoreError
from nornicdb_tpu_torch.storage.codec import pack, unpack
from nornicdb_tpu_torch.storage.types import (
    Direction,
    Edge,
    EdgeID,
    Engine,
    Node,
    NodeID,
    NotFoundError,
    now_ms,
)

_SEP = b"\x00"
_ENC_MAGIC = b"NKE1"
_ENC_SENTINEL_KEY = b"\x00meta:enc"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.nkv_open.restype = ctypes.c_void_p
    lib.nkv_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]
    lib.nkv_put.restype = ctypes.c_int
    lib.nkv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                            ctypes.c_char_p, ctypes.c_int]
    lib.nkv_get.restype = ctypes.c_int
    lib.nkv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
    lib.nkv_has.restype = ctypes.c_int
    lib.nkv_has.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.nkv_delete.restype = ctypes.c_int
    lib.nkv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.nkv_count.restype = ctypes.c_long
    lib.nkv_count.argtypes = [ctypes.c_void_p]
    lib.nkv_count_prefix.restype = ctypes.c_long
    lib.nkv_count_prefix.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.nkv_live_bytes.restype = ctypes.c_long
    lib.nkv_live_bytes.argtypes = [ctypes.c_void_p]
    lib.nkv_dead_bytes.restype = ctypes.c_long
    lib.nkv_dead_bytes.argtypes = [ctypes.c_void_p]
    lib.nkv_repaired.restype = ctypes.c_int
    lib.nkv_repaired.argtypes = [ctypes.c_void_p]
    lib.nkv_sync.restype = ctypes.c_int
    lib.nkv_sync.argtypes = [ctypes.c_void_p]
    lib.nkv_compact.restype = ctypes.c_int
    lib.nkv_compact.argtypes = [ctypes.c_void_p]
    lib.nkv_scan.restype = ctypes.c_void_p
    lib.nkv_scan.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.nkv_scan_next.restype = ctypes.c_int
    lib.nkv_scan_next.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
    lib.nkv_scan_free.argtypes = [ctypes.c_void_p]
    lib.nkv_free.argtypes = [ctypes.c_void_p]
    lib.nkv_close.argtypes = [ctypes.c_void_p]
    return lib


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The bound library, built with ``c++`` first if needed
    (``ops/_build.py:host_library``); raises when it cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from nornicdb_tpu_torch.ops._build import host_library

            _lib = _bind(host_library("kv_host"))
        return _lib


def native_available() -> bool:
    """Whether the native store's library builds (or is built) here."""
    try:
        get_lib()
        return True
    except (OSError, RuntimeError):
        return False


class DiskKV:
    """Thin handle over one KV store directory."""

    def __init__(self, directory: str, sync_every_write: bool = False,
                 max_segment_bytes: int = 64 * 1024 * 1024):
        self._lib = get_lib()
        os.makedirs(directory, exist_ok=True)
        self._h = self._lib.nkv_open(directory.encode(), 1 if sync_every_write else 0,
                                     max_segment_bytes)
        if not self._h:
            raise IOError(f"nkv_open failed for {directory}")
        self._closed = False

    def put(self, key: bytes, value: bytes) -> None:
        if self._lib.nkv_put(self._h, key, len(key), value, len(value)) != 0:
            raise IOError("nkv_put failed")

    def get(self, key: bytes) -> Optional[bytes]:
        val = ctypes.c_void_p()
        vlen = ctypes.c_int()
        rc = self._lib.nkv_get(self._h, key, len(key), ctypes.byref(val), ctypes.byref(vlen))
        if rc == 1:
            return None
        if rc != 0:
            raise IOError("nkv_get failed")
        try:
            return ctypes.string_at(val, vlen.value)
        finally:
            self._lib.nkv_free(val)

    def has(self, key: bytes) -> bool:
        return self._lib.nkv_has(self._h, key, len(key)) == 1

    def delete(self, key: bytes) -> bool:
        rc = self._lib.nkv_delete(self._h, key, len(key))
        if rc < 0:
            raise IOError("nkv_delete failed")
        return rc == 0

    def count(self) -> int:
        return self._lib.nkv_count(self._h)

    def count_prefix(self, prefix: bytes) -> int:
        return self._lib.nkv_count_prefix(self._h, prefix, len(prefix))

    def scan(self, prefix: bytes) -> Iterable[Tuple[bytes, bytes]]:
        it = self._lib.nkv_scan(self._h, prefix, len(prefix))
        try:
            while True:
                k = ctypes.c_void_p()
                klen = ctypes.c_int()
                v = ctypes.c_void_p()
                vlen = ctypes.c_int()
                rc = self._lib.nkv_scan_next(it, ctypes.byref(k), ctypes.byref(klen),
                                             ctypes.byref(v), ctypes.byref(vlen))
                if rc == 1:
                    return
                if rc != 0:
                    raise IOError("nkv_scan_next failed")
                key = ctypes.string_at(k, klen.value)
                val = ctypes.string_at(v, vlen.value)
                self._lib.nkv_free(k)
                self._lib.nkv_free(v)
                yield key, val
        finally:
            self._lib.nkv_scan_free(it)

    def sync(self) -> None:
        self._lib.nkv_sync(self._h)

    def compact(self) -> None:
        if self._lib.nkv_compact(self._h) != 0:
            raise IOError("nkv_compact failed")

    @property
    def live_bytes(self) -> int:
        return self._lib.nkv_live_bytes(self._h)

    @property
    def dead_bytes(self) -> int:
        return self._lib.nkv_dead_bytes(self._h)

    @property
    def repaired(self) -> int:
        return self._lib.nkv_repaired(self._h)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.nkv_close(self._h)


class DiskEngine(Engine):
    """Engine over ``DiskKV`` with secondary key spaces. Compacts the
    store when dead bytes exceed both 64 MB and half the live bytes.
    ``open_s`` is the seconds the open took (the segment scan)."""

    def __init__(self, data_dir: str, sync_every_write: bool = False,
                 auto_compact: bool = True):
        # a native store beside pure-Python engine data would shadow that
        # database as an empty one
        if not os.path.isdir(os.path.join(data_dir, "kv")) and (
            glob.glob(os.path.join(data_dir, "wal-*.log"))
            or glob.glob(os.path.join(data_dir, "snapshot-*.bin"))
        ):
            raise ValueError(
                f"{data_dir} holds pure-Python engine data; open it with "
                "engine='python' instead of creating a native store beside it"
            )
        t0 = time.perf_counter()
        self.kv = DiskKV(os.path.join(data_dir, "kv"), sync_every_write=sync_every_write)
        self.open_s = time.perf_counter() - t0
        if self.kv.has(_ENC_SENTINEL_KEY):
            self.kv.close()
            raise EncryptedStoreError(
                "the store is encrypted at rest, which is not ported yet")
        self.auto_compact = auto_compact
        self._lock = threading.Lock()  # serializes multi-key mutations

    # -- helpers --------------------------------------------------------

    @staticmethod
    def _nk(node_id: str) -> bytes:
        return b"n:" + node_id.encode()

    @staticmethod
    def _ek(edge_id: str) -> bytes:
        return b"e:" + edge_id.encode()

    @staticmethod
    def _lk(label: str, node_id: str) -> bytes:
        return b"l:" + label.encode() + _SEP + node_id.encode()

    @staticmethod
    def _tk(edge_type: str, edge_id: str) -> bytes:
        return b"t:" + edge_type.encode() + _SEP + edge_id.encode()

    @staticmethod
    def _ak(node_id: str, direction: bytes, edge_id: str) -> bytes:
        return b"a:" + node_id.encode() + _SEP + direction + _SEP + edge_id.encode()

    @staticmethod
    def _unpack(raw: bytes) -> Any:
        if raw[: len(_ENC_MAGIC)] == _ENC_MAGIC:
            raise EncryptedStoreError(
                "a record is encrypted at rest, which is not ported yet")
        return unpack(raw)

    def _node(self, raw: bytes) -> Node:
        return Node.from_dict(self._unpack(raw))

    def _edge(self, raw: bytes) -> Edge:
        return Edge.from_dict(self._unpack(raw))

    def _maybe_compact(self) -> None:
        if not self.auto_compact:
            return
        dead = self.kv.dead_bytes
        if dead > 64 * 1024 * 1024 and dead > self.kv.live_bytes // 2:
            self.kv.compact()

    # -- nodes ----------------------------------------------------------

    def create_node(self, node: Node) -> None:
        with self._lock:
            key = self._nk(node.id)
            if self.kv.has(key):
                raise ValueError(f"node exists: {node.id}")
            n = node.copy()
            ts = now_ms()
            n.created_at = n.created_at or ts
            n.updated_at = ts
            self.kv.put(key, pack(n.to_dict()))
            for label in n.labels:
                self.kv.put(self._lk(label, n.id), b"")

    def get_node(self, node_id: NodeID) -> Node:
        raw = self.kv.get(self._nk(node_id))
        if raw is None:
            raise NotFoundError(node_id)
        return self._node(raw)

    def update_node(self, node: Node) -> None:
        with self._lock:
            raw = self.kv.get(self._nk(node.id))
            if raw is None:
                raise NotFoundError(node.id)
            old = self._node(raw)
            n = node.copy()
            n.created_at = old.created_at
            n.updated_at = now_ms()
            for label in set(old.labels) - set(n.labels):
                self.kv.delete(self._lk(label, n.id))
            for label in set(n.labels) - set(old.labels):
                self.kv.put(self._lk(label, n.id), b"")
            self.kv.put(self._nk(n.id), pack(n.to_dict()))
        self._maybe_compact()

    def delete_node(self, node_id: NodeID) -> None:
        with self._lock:
            raw = self.kv.get(self._nk(node_id))
            if raw is None:
                raise NotFoundError(node_id)
            node = self._node(raw)
            for eid in [e.id for e in self._node_edges(node_id, Direction.BOTH)]:
                self._delete_edge_locked(eid)
            for label in node.labels:
                self.kv.delete(self._lk(label, node_id))
            self.kv.delete(self._nk(node_id))
        self._maybe_compact()

    def get_nodes_by_label(self, label: str) -> List[Node]:
        return [n for n in self.batch_get_nodes(self.node_ids_by_label(label))
                if n is not None]

    def node_ids_by_label(self, label: str) -> List[NodeID]:
        prefix = b"l:" + label.encode() + _SEP
        return [k[len(prefix):].decode() for k, _ in self.kv.scan(prefix)]

    def all_nodes(self) -> Iterable[Node]:
        for _, raw in self.kv.scan(b"n:"):
            yield self._node(raw)

    def batch_get_nodes(self, node_ids: Sequence[NodeID]) -> List[Optional[Node]]:
        out: List[Optional[Node]] = []
        for nid in node_ids:
            raw = self.kv.get(self._nk(nid))
            out.append(None if raw is None else self._node(raw))
        return out

    def has_node(self, node_id: NodeID) -> bool:
        return self.kv.has(self._nk(node_id))

    # -- edges ----------------------------------------------------------

    def create_edge(self, edge: Edge) -> None:
        with self._lock:
            key = self._ek(edge.id)
            if self.kv.has(key):
                raise ValueError(f"edge exists: {edge.id}")
            if not self.kv.has(self._nk(edge.start_node)):
                raise NotFoundError(edge.start_node)
            if not self.kv.has(self._nk(edge.end_node)):
                raise NotFoundError(edge.end_node)
            e = edge.copy()
            ts = now_ms()
            e.created_at = e.created_at or ts
            e.updated_at = ts
            self.kv.put(key, pack(e.to_dict()))
            self.kv.put(self._tk(e.type, e.id), b"")
            self.kv.put(self._ak(e.start_node, b"o", e.id), b"")
            self.kv.put(self._ak(e.end_node, b"i", e.id), b"")

    def get_edge(self, edge_id: EdgeID) -> Edge:
        raw = self.kv.get(self._ek(edge_id))
        if raw is None:
            raise NotFoundError(edge_id)
        return self._edge(raw)

    def update_edge(self, edge: Edge) -> None:
        with self._lock:
            raw = self.kv.get(self._ek(edge.id))
            if raw is None:
                raise NotFoundError(edge.id)
            old = self._edge(raw)
            e = edge.copy()
            e.created_at = old.created_at
            e.updated_at = now_ms()
            # endpoints and type are immutable, as in MemoryEngine
            e.start_node, e.end_node, e.type = old.start_node, old.end_node, old.type
            self.kv.put(self._ek(e.id), pack(e.to_dict()))
        self._maybe_compact()

    def _delete_edge_locked(self, edge_id: EdgeID) -> None:
        raw = self.kv.get(self._ek(edge_id))
        if raw is None:
            raise NotFoundError(edge_id)
        edge = self._edge(raw)
        self.kv.delete(self._tk(edge.type, edge_id))
        self.kv.delete(self._ak(edge.start_node, b"o", edge_id))
        self.kv.delete(self._ak(edge.end_node, b"i", edge_id))
        self.kv.delete(self._ek(edge_id))

    def delete_edge(self, edge_id: EdgeID) -> None:
        with self._lock:
            self._delete_edge_locked(edge_id)
        self._maybe_compact()

    def get_edges_by_type(self, edge_type: str) -> List[Edge]:
        prefix = b"t:" + edge_type.encode() + _SEP
        out = []
        for k, _ in self.kv.scan(prefix):
            raw = self.kv.get(self._ek(k[len(prefix):].decode()))
            if raw is not None:
                out.append(self._edge(raw))
        return out

    def all_edges(self) -> Iterable[Edge]:
        for _, raw in self.kv.scan(b"e:"):
            yield self._edge(raw)

    def _node_edges(self, node_id: NodeID, direction: str) -> List[Edge]:
        dirs = []
        if direction in (Direction.OUTGOING, Direction.BOTH):
            dirs.append(b"o")
        if direction in (Direction.INCOMING, Direction.BOTH):
            dirs.append(b"i")
        out: List[Edge] = []
        seen = set()
        for d in dirs:
            prefix = b"a:" + node_id.encode() + _SEP + d + _SEP
            for k, _ in self.kv.scan(prefix):
                eid = k[len(prefix):].decode()
                if eid in seen:
                    continue
                seen.add(eid)
                raw = self.kv.get(self._ek(eid))
                if raw is not None:
                    out.append(self._edge(raw))
        return out

    def get_node_edges(self, node_id: NodeID, direction: str = Direction.BOTH) -> List[Edge]:
        return self._node_edges(node_id, direction)

    def has_edge(self, edge_id: EdgeID) -> bool:
        return self.kv.has(self._ek(edge_id))

    # -- counts / maintenance -------------------------------------------

    def count_nodes(self) -> int:
        return self.kv.count_prefix(b"n:")

    def count_edges(self) -> int:
        return self.kv.count_prefix(b"e:")

    def count_nodes_by_label(self, label: str) -> int:
        """Key-only count over the label index (no node fetches)."""
        return self.kv.count_prefix(b"l:" + label.encode() + _SEP)

    def count_nodes_with_prefix(self, prefix: str) -> int:
        """Key-only count through the ordered key index: the namespaced
        engine's count probes for it."""
        return self.kv.count_prefix(b"n:" + prefix.encode())

    def count_edges_with_prefix(self, prefix: str) -> int:
        return self.kv.count_prefix(b"e:" + prefix.encode())

    def compact(self) -> None:
        self.kv.compact()

    @property
    def repaired(self) -> int:
        """Torn-tail truncations made during open (crash recovery)."""
        return self.kv.repaired

    def flush(self) -> None:
        self.kv.sync()

    def close(self) -> None:
        self.kv.close()
