"""Write-ahead log: segmented, checksummed, with snapshots and tail repair
(counterpart of ``nornicdb_tpu/storage/wal.py``; same files, byte for
byte).

Record framing:  ``uint32 payload_len | uint32 crc32(payload) | payload``,
little-endian; the payload is the record codec's msgpack
(``storage/codec.py``). A torn or corrupt tail record truncates the
newest segment at the last valid record instead of failing recovery;
corruption in an older segment stops its replay there and reports it
(``degraded``). Appends and fsyncs are observed in the reference's
latency histograms (``nornicdb_wal_append_seconds``,
``nornicdb_wal_fsync_seconds``) and counted in ``counters``, with their
seconds. With an ``encryptor`` (``encryption.Encryptor``) every record
and snapshot payload is ``NKE1`` followed by its AES-256-GCM ciphertext;
an encrypted log opened without the passphrase, or with a wrong one,
raises ``EncryptionError``.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.encryption import EncryptionError
from nornicdb_tpu_torch.obs import REGISTRY
from nornicdb_tpu_torch.storage.codec import pack as _pack
from nornicdb_tpu_torch.storage.codec import unpack as _unpack


class WALCorruptionError(Exception):
    """Snapshot files exist but none is readable."""


_APPEND_H = REGISTRY.histogram(
    "nornicdb_wal_append_seconds",
    "WAL record append latency (encode + write [+ fsync when "
    "sync_every_write])")
_FSYNC_H = REGISTRY.histogram(
    "nornicdb_wal_fsync_seconds", "WAL fsync latency")

_HEADER = struct.Struct("<II")  # payload_len, crc32
SEGMENT_PREFIX = "wal-"
SEGMENT_SUFFIX = ".log"
SNAPSHOT_PREFIX = "snapshot-"
_ENC_MAGIC = b"NKE1"
SNAPSHOT_SUFFIX = ".bin"


@dataclass
class ReplayResult:
    records_applied: int = 0
    segments_read: int = 0
    snapshot_seq: int = 0
    last_seq: int = 0
    torn_tail_repaired: bool = False
    corrupt_segments: List[str] = field(default_factory=list)
    degraded: bool = False


class WAL:
    """Segmented append-only log. Thread-safe."""

    def __init__(
        self,
        directory: str,
        max_segment_bytes: int = 16 * 1024 * 1024,
        sync_every_write: bool = False,
        retained_segments: int = 4,
        encryptor=None,
    ):
        self.dir = directory
        self.max_segment_bytes = max_segment_bytes
        self.sync_every_write = sync_every_write
        self.retained_segments = retained_segments
        self._enc = encryptor
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = None
        self._fh_path: Optional[str] = None
        self._fh_size = 0
        # appends / fsyncs and their seconds (append: encode + write
        # [+ fsync when sync_every_write])
        self.counters: Dict[str, float] = {
            "appends": 0, "append_s": 0.0, "fsyncs": 0, "fsync_s": 0.0}
        os.makedirs(self.dir, exist_ok=True)
        self._seq = self._scan_last_seq()

    # -- payload codec (AES-256-GCM at rest under an encryptor) ------------

    def _encode(self, obj) -> bytes:
        payload = _pack(obj)
        if self._enc is not None:
            payload = _ENC_MAGIC + self._enc.encrypt(payload)
        return payload

    def _decode(self, payload: bytes):
        if payload[: len(_ENC_MAGIC)] == _ENC_MAGIC:
            if self._enc is None:
                raise EncryptionError("WAL is encrypted; open with the passphrase")
            payload = self._enc.decrypt(payload[len(_ENC_MAGIC):])
        return _unpack(payload)

    # -- segment bookkeeping --------------------------------------------

    def _segment_paths(self) -> List[str]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(SEGMENT_PREFIX) and name.endswith(SEGMENT_SUFFIX):
                out.append(os.path.join(self.dir, name))
        out.sort(key=lambda p: self._segment_start_seq(p))
        return out

    @staticmethod
    def _segment_start_seq(path: str) -> int:
        base = os.path.basename(path)
        return int(base[len(SEGMENT_PREFIX) : -len(SEGMENT_SUFFIX)])

    def _snapshot_paths(self) -> List[str]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(SNAPSHOT_PREFIX) and name.endswith(SNAPSHOT_SUFFIX):
                out.append(os.path.join(self.dir, name))
        out.sort(key=lambda p: self._snapshot_seq(p))
        return out

    @staticmethod
    def _snapshot_seq(path: str) -> int:
        base = os.path.basename(path)
        return int(base[len(SNAPSHOT_PREFIX) : -len(SNAPSHOT_SUFFIX)])

    def _scan_last_seq(self) -> int:
        """Find the last sequence number. Sequences are monotone across
        segments, so only the newest segment needs decoding; older segments'
        coverage is derivable from filenames (start seqs)."""
        last = 0
        snaps = self._snapshot_paths()
        if snaps:
            last = self._snapshot_seq(snaps[-1])
        segs = self._segment_paths()
        if segs:
            last = max(last, self._segment_start_seq(segs[-1]))
            for rec, _ in _iter_records(segs[-1], self._decode):
                seq = rec.get("seq", 0)
                if seq > last:
                    last = seq
        return last

    def has_snapshots(self) -> bool:
        return bool(self._snapshot_paths())

    # -- append ---------------------------------------------------------

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def append(self, op: str, data: Dict[str, Any]) -> int:
        """Append one record; returns its sequence number."""
        t0 = time.perf_counter()
        with self._lock:
            self._seq += 1
            # the append time rides every record; replay ignores it
            rec = {"seq": self._seq, "op": op, "data": data,
                   "ts": round(time.time(), 6)}
            payload = self._encode(rec)
            frame = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
            self._ensure_segment_locked(len(frame))
            self._fh.write(frame)
            self._fh_size += len(frame)
            if self.sync_every_write:
                self._fh.flush()
                self._fsync_locked()
            seq = self._seq
            self.counters["appends"] += 1
            self.counters["append_s"] += time.perf_counter() - t0
        _APPEND_H.observe(time.perf_counter() - t0)
        return seq

    def _fsync_locked(self) -> None:
        ts = time.perf_counter()
        os.fsync(self._fh.fileno())
        dt = time.perf_counter() - ts
        self.counters["fsyncs"] += 1
        self.counters["fsync_s"] += dt
        _FSYNC_H.observe(dt)

    def _ensure_segment_locked(self, incoming: int) -> None:
        if self._fh is not None and self._fh_size + incoming <= self.max_segment_bytes:
            return
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
        start = self._seq
        path = os.path.join(self.dir, f"{SEGMENT_PREFIX}{start}{SEGMENT_SUFFIX}")
        self._fh = open(path, "ab")
        self._fh_path = path
        self._fh_size = os.path.getsize(path)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fsync_locked()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None

    # -- snapshot / retention -------------------------------------------

    def write_snapshot(self, state: Dict[str, Any]) -> str:
        """Atomically persist a full-state snapshot at the current seq and
        prune old segments and snapshots."""
        with self._lock:
            seq = self._seq
            payload = self._encode({"seq": seq, "state": state})
            path = os.path.join(self.dir, f"{SNAPSHOT_PREFIX}{seq}{SNAPSHOT_SUFFIX}")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._prune_locked(seq)
            return path

    def _prune_locked(self, snapshot_seq: int) -> None:
        # drop all snapshots except the newest
        snaps = self._snapshot_paths()
        for p in snaps[:-1]:
            try:
                os.remove(p)
            except OSError:
                pass
        # drop fully-covered segments beyond the retention window. A
        # segment's records all have seq <= the next segment's start seq
        # (filenames carry start seqs), so coverage needs no decoding.
        segs = self._segment_paths()
        covered = []
        for i, p in enumerate(segs):
            if i + 1 < len(segs):
                seg_last = self._segment_start_seq(segs[i + 1])
            else:
                seg_last = self._seq
            if seg_last <= snapshot_seq:
                covered.append(p)
        for p in covered[: max(0, len(covered) - self.retained_segments)]:
            if p == self._fh_path:
                continue
            try:
                os.remove(p)
            except OSError:
                pass

    # -- replay ---------------------------------------------------------

    def load_snapshot(self) -> Tuple[Optional[Dict[str, Any]], int]:
        """Return (state, seq) of the newest valid snapshot, or (None, 0)."""
        for path in reversed(self._snapshot_paths()):
            try:
                with open(path, "rb") as f:
                    head = f.read(_HEADER.size)
                    if len(head) < _HEADER.size:
                        continue
                    ln, crc = _HEADER.unpack(head)
                    payload = f.read(ln)
                    if len(payload) != ln or zlib.crc32(payload) != crc:
                        continue
                    doc = self._decode(payload)
                    return doc["state"], doc["seq"]
            except (OSError, ValueError, KeyError):
                continue
        return None, 0

    def iter_records(self, from_seq: int = 0) -> List[Dict[str, Any]]:
        """The records (seq included) with seq > ``from_seq``, in log
        order, read under the lock (so auto-compaction cannot prune a
        segment midway); no tail repair. ``db.txlog.entries`` reads it."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for path in self._segment_paths():
                for rec, _ in _iter_records(path, self._decode):
                    if rec.get("seq", 0) > from_seq:
                        out.append(rec)
        return out

    def replay(
        self, apply: Callable[[str, Dict[str, Any]], None], from_seq: int = 0
    ) -> ReplayResult:
        """Apply every record with seq > from_seq, repairing a torn tail on
        the newest segment and flagging mid-log corruption as degraded."""
        res = ReplayResult(snapshot_seq=from_seq, last_seq=from_seq)
        with self._lock:
            segs = self._segment_paths()
            for i, path in enumerate(segs):
                is_tail_segment = i == len(segs) - 1
                res.segments_read += 1
                good_bytes = 0
                corrupt = False
                for rec, end_off in _iter_records(path, self._decode, from_seq):
                    good_bytes = end_off
                    if rec is None:
                        continue  # at or below from_seq: not decoded
                    seq = rec.get("seq", 0)
                    if seq > from_seq:
                        apply(rec["op"], rec.get("data", {}))
                        res.records_applied += 1
                        res.last_seq = max(res.last_seq, seq)
                size = os.path.getsize(path)
                if good_bytes < size:
                    corrupt = True
                if corrupt:
                    if is_tail_segment:
                        # torn tail: truncate to last valid record
                        with open(path, "ab") as f:
                            f.truncate(good_bytes)
                        res.torn_tail_repaired = True
                    else:
                        res.corrupt_segments.append(path)
                        res.degraded = True
            if res.last_seq > self._seq:
                self._seq = res.last_seq
        return res


_SEQ_KEY = b"\xa3seq"


def _seq_at_most(payload: bytes, from_seq: int) -> bool:
    """Whether a record's payload, as ``append`` writes it (a map whose
    first key is ``seq``), has a seq of at most ``from_seq``, read without
    decoding the record; False when it cannot tell."""
    if len(payload) < 6 or not 0x80 <= payload[0] <= 0x8F or payload[1:5] != _SEQ_KEY:
        return False
    c = payload[5]
    if c <= 0x7F:
        seq = c
    else:
        width = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8}.get(c)
        if width is None or len(payload) < 6 + width:
            return False
        seq = int.from_bytes(payload[6:6 + width], "big")
    return seq <= from_seq


def _iter_records(path: str, decode: Callable[[bytes], Any], skip_to: Optional[int] = None):
    """Yield (record, end_offset) for each valid record; stop at the first
    corrupt or torn frame. With ``skip_to``, a record whose seq is at most
    it (a snapshot covers it) yields None in place of the record, without
    being decoded. A wrong or missing encryption passphrase raises
    instead of passing for a torn log, which replay would truncate."""
    try:
        with open(path, "rb") as f:
            off = 0
            while True:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    return
                ln, crc = _HEADER.unpack(head)
                if ln > 256 * 1024 * 1024:  # insane length => corrupt header
                    return
                payload = f.read(ln)
                if len(payload) != ln or zlib.crc32(payload) != crc:
                    return
                off += _HEADER.size + ln
                if skip_to is not None and _seq_at_most(payload, skip_to):
                    yield None, off
                    continue
                try:
                    rec = decode(payload)
                except EncryptionError:
                    raise
                except Exception:
                    return
                if not isinstance(rec, dict) or "op" not in rec:
                    return
                yield rec, off
    except OSError:
        return
