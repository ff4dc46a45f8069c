"""Append-only compliance audit log (GDPR/HIPAA/FISMA/SOC2)
(counterpart of ``nornicdb_tpu/audit.py``).

Reference: pkg/audit/audit.go:1-30 — JSON lines, append-only, retention
window, queryable. Each entry is one JSON object per line; the file is
only ever appended (compliance requirement), retention rewrites
atomically.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterator, List, Optional

# event categories (reference: audit.go event types)
AUTH = "auth"
DATA_READ = "data_read"
DATA_WRITE = "data_write"
DATA_DELETE = "data_delete"
ADMIN_ACTION = "admin"
GDPR = "gdpr"


@dataclass
class AuditEvent:
    timestamp_ms: int
    category: str
    action: str
    actor: str = ""
    database: str = ""
    target: str = ""
    success: bool = True
    details: Dict[str, Any] = field(default_factory=dict)


class AuditLog:
    """Thread-safe append-only JSONL audit log."""

    def __init__(self, path: Optional[str] = None, enabled: bool = True,
                 retention_days: int = 0):
        self.path = path
        self.enabled = enabled
        self.retention_days = retention_days
        self._lock = threading.Lock()
        self._mem: List[AuditEvent] = []  # in-memory ring when no path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def record(self, category: str, action: str, actor: str = "",
               database: str = "", target: str = "", success: bool = True,
               **details: Any) -> Optional[AuditEvent]:
        if not self.enabled:
            return None
        ev = AuditEvent(
            timestamp_ms=int(time.time() * 1000), category=category,
            action=action, actor=actor, database=database, target=target,
            success=success, details=details,
        )
        line = json.dumps(asdict(ev), separators=(",", ":"))
        with self._lock:
            if self.path:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
            else:
                self._mem.append(ev)
                if len(self._mem) > 100_000:
                    del self._mem[:50_000]
        return ev

    def events(self, category: Optional[str] = None, actor: Optional[str] = None,
               since_ms: int = 0) -> Iterator[AuditEvent]:
        for ev in self._iter_all():
            if category and ev.category != category:
                continue
            if actor and ev.actor != actor:
                continue
            if since_ms and ev.timestamp_ms < since_ms:
                continue
            yield ev

    def _iter_all(self) -> Iterator[AuditEvent]:
        if self.path and os.path.exists(self.path):
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        d = json.loads(line)
                        yield AuditEvent(**d)
                    except (json.JSONDecodeError, TypeError):
                        continue  # a torn tail line must not kill queries
        else:
            with self._lock:
                batch = list(self._mem)
            yield from batch

    def apply_retention(self, now_ms: Optional[int] = None) -> int:
        """Drop entries older than the retention window. Returns removed
        count. Atomic rewrite (tmp + rename)."""
        if not self.retention_days:
            return 0
        cutoff = (now_ms or int(time.time() * 1000)) - self.retention_days * 86_400_000
        removed = 0
        if self.path and os.path.exists(self.path):
            keep: List[str] = []
            with self._lock:
                with open(self.path, "r", encoding="utf-8") as f:
                    for line in f:
                        try:
                            if json.loads(line).get("timestamp_ms", 0) >= cutoff:
                                keep.append(line)
                            else:
                                removed += 1
                        except json.JSONDecodeError:
                            removed += 1
                tmp = self.path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.writelines(keep)
                os.replace(tmp, self.path)
        else:
            with self._lock:
                before = len(self._mem)
                self._mem = [e for e in self._mem if e.timestamp_ms >= cutoff]
                removed = before - len(self._mem)
        return removed
