"""WAL engine decorator and the pure-Python durable engine (counterpart
of ``nornicdb_tpu/storage/wal_engine.py``).

``WALEngine`` applies each mutation to its inner engine (which validates
it) and then appends it to the WAL, both under one mutation lock, so the
log's order is the applied order and an invalid mutation never reaches
the log. ``DurableEngine`` is ``MemoryEngine + WAL``: on open it restores
the newest snapshot and replays the log's tail; on close it writes a
snapshot; every ``auto_compact_every`` records (50,000) it writes one
too, pruning the segments it covers.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from nornicdb_tpu_torch.storage.memory import MemoryEngine
from nornicdb_tpu_torch.storage.types import (
    AlreadyExistsError,
    Edge,
    EdgeID,
    Engine,
    EngineDecorator,
    Node,
    NodeID,
)
from nornicdb_tpu_torch.storage.wal import WAL, ReplayResult, WALCorruptionError


def decode_op_args(op: str, data: Dict[str, Any]) -> tuple:
    """A WAL record's op and data as engine-call arguments; ``ValueError``
    on an op outside the vocabulary."""
    if op in ("create_node", "update_node"):
        return (Node.from_dict(data),)
    if op in ("create_edge", "update_edge"):
        return (Edge.from_dict(data),)
    if op in ("delete_node", "delete_edge"):
        return (data["id"],)
    if op == "delete_by_prefix":
        return (data["prefix"],)
    raise ValueError(f"unknown WAL op {op}")


class WALEngine(EngineDecorator):
    """Apply-then-log: a write is acknowledged after its WAL append."""

    def __init__(self, inner: Engine, wal: WAL, auto_compact_every: int = 0):
        super().__init__(inner)
        self.wal = wal
        self.auto_compact_every = auto_compact_every
        self._since_compact = 0
        self._lock = threading.Lock()
        self._mut = threading.Lock()
        self.snapshots = 0

    # -- replay ----------------------------------------------------------

    def apply_record(self, op: str, data: Dict[str, Any]) -> None:
        """Apply one WAL record to the inner engine during replay."""
        try:
            # decode first: it whitelists the op, so getattr is safe
            args = decode_op_args(op, data)
            getattr(self.inner, op)(*args)
        except (KeyError, ValueError, AlreadyExistsError):
            # a record the snapshot already holds, a delete of a deleted
            # entity, or an op of a newer version: replay is idempotent
            return

    def recover(self) -> ReplayResult:
        """Restore the newest snapshot into inner, then replay the tail.
        Refuses when snapshot files exist but none is readable: older
        segments were pruned at snapshot time, so a replay from seq 0
        would open a near-empty store."""
        state, snap_seq = self.wal.load_snapshot()
        if state is None and self.wal.has_snapshots():
            raise WALCorruptionError(
                "snapshot files exist but none is readable; refusing to "
                "recover from the WAL tail alone (pre-snapshot segments were "
                "pruned). Restore a snapshot or remove the snapshot files to "
                "force tail-only recovery."
            )
        if state is not None:
            self._load_state(state)
        return self.wal.replay(self.apply_record, from_seq=snap_seq)

    def _load_state(self, state: Dict[str, Any]) -> None:
        for nd in state.get("nodes", []):
            try:
                self.inner.create_node(Node.from_dict(nd))
            except (KeyError, ValueError, AlreadyExistsError):
                pass
        for ed in state.get("edges", []):
            try:
                self.inner.create_edge(Edge.from_dict(ed))
            except (KeyError, ValueError, AlreadyExistsError):
                pass

    def _dump_state(self) -> Dict[str, Any]:
        return {
            "nodes": [n.to_dict() for n in self.inner.all_nodes()],
            "edges": [e.to_dict() for e in self.inner.all_edges()],
        }

    def snapshot(self) -> str:
        """Write a full-state snapshot, pruning old segments. The mutation
        lock spans the dump and the seq stamp: an append between them
        would be pruned as covered while missing from the state."""
        with self._mut:
            path = self.wal.write_snapshot(self._dump_state())
        self.snapshots += 1
        return path

    def _maybe_compact(self) -> None:
        if self.auto_compact_every <= 0:
            return
        with self._lock:
            self._since_compact += 1
            if self._since_compact < self.auto_compact_every:
                return
            self._since_compact = 0
        self.snapshot()

    # -- mutations -------------------------------------------------------

    def _apply_and_log(self, op: str, arg: Any, data: Dict[str, Any]) -> Any:
        with self._mut:
            out = getattr(self.inner, op)(arg)
            self.wal.append(op, data)
        self._maybe_compact()
        return out

    def create_node(self, node: Node) -> None:
        self._apply_and_log("create_node", node, node.to_dict())

    def update_node(self, node: Node) -> None:
        self._apply_and_log("update_node", node, node.to_dict())

    def delete_node(self, node_id: NodeID) -> None:
        self._apply_and_log("delete_node", node_id, {"id": node_id})

    def create_edge(self, edge: Edge) -> None:
        self._apply_and_log("create_edge", edge, edge.to_dict())

    def update_edge(self, edge: Edge) -> None:
        self._apply_and_log("update_edge", edge, edge.to_dict())

    def delete_edge(self, edge_id: EdgeID) -> None:
        self._apply_and_log("delete_edge", edge_id, {"id": edge_id})

    def delete_by_prefix(self, prefix: str) -> Tuple[int, int]:
        with self._mut:
            result = self.inner.delete_by_prefix(prefix)
            self.wal.append("delete_by_prefix", {"prefix": prefix})
        return result

    def flush(self) -> None:
        self.wal.flush()
        self.inner.flush()

    def close(self) -> None:
        self.wal.close()
        self.inner.close()


class DurableEngine(WALEngine):
    """Persistent engine: RAM working set + WAL + snapshots. Opens (or
    creates) a data dir, restores the newest snapshot and replays the
    tail; ``replay_result`` says what recovery did and ``open_s`` how long
    it took (snapshot load and replay together)."""

    def __init__(
        self,
        data_dir: str,
        sync_every_write: bool = False,
        auto_compact_every: int = 50_000,
        max_segment_bytes: int = 16 * 1024 * 1024,
        encryptor=None,
    ):
        t0 = time.perf_counter()
        wal = WAL(data_dir, max_segment_bytes=max_segment_bytes,
                  sync_every_write=sync_every_write, encryptor=encryptor)
        super().__init__(MemoryEngine(), wal, auto_compact_every=auto_compact_every)
        self.replay_result: Optional[ReplayResult] = self.recover()
        self.open_s = time.perf_counter() - t0

    def close(self) -> None:
        """Snapshot, then close. Unlike the reference, a failed snapshot
        raises (after the log is closed): the log still holds every write."""
        try:
            self.snapshot()
        finally:
            super().close()
