"""Disk partition store: the cold tier of the tiered vector ladder (a copy
of ``nornicdb_tpu/storage/partition_store.py``).

The tiered serving plane (``search/tiered_store.py``) keeps only a
bounded set of partitions device-resident; every partition's payload —
its brute slot ids, external ids, PQ codes and float32 rows — spills
here at build time as one ``.npz`` file per partition. Background
promotion reads a partition back to fill a device slab; the exact cold
side-scan reads rows when a query probes a partition that is neither
device- nor host-resident.

Writes are atomic (tmp file + ``os.replace``) so a crashed build can
never leave a torn partition behind, and every read validates the key
set — a missing or malformed file returns ``None`` and the caller
degrades through the freshness ladder (tiered -> quant -> f32 -> host),
never answers from garbage.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional

import numpy as np

_KEYS = ("slots", "ext_ids", "rows", "codes")


class PartitionStore:
    """One directory of per-partition ``part_<pid>.npz`` files.

    Thread-safe: the build thread writes whole partitions while the
    background pager reads others; a per-store lock serializes the
    directory-level bookkeeping (file create/replace/delete), while the
    payload serialization itself runs outside it.
    """

    def __init__(self, root_dir: Optional[str] = None):
        if root_dir is None:
            root_dir = tempfile.mkdtemp(prefix="nornic_tiered_")
            self._owns_dir = True
        else:
            os.makedirs(root_dir, exist_ok=True)
            self._owns_dir = False
        self.root_dir = root_dir
        self._lock = threading.Lock()

    def _path(self, pid: int) -> str:
        return os.path.join(self.root_dir, f"part_{int(pid)}.npz")

    # -- write ------------------------------------------------------------

    def save_partition(
        self,
        pid: int,
        slots: np.ndarray,
        ext_ids: List[str],
        rows: np.ndarray,
        codes: np.ndarray,
    ) -> None:
        """Persist one partition atomically (tmp + rename)."""
        payload = {
            "slots": np.asarray(slots, dtype=np.int64),
            "ext_ids": np.asarray(ext_ids),
            "rows": np.asarray(rows, dtype=np.float32),
            "codes": np.asarray(codes, dtype=np.uint8),
        }
        fd, tmp = tempfile.mkstemp(
            prefix=f"part_{int(pid)}.", suffix=".tmp", dir=self.root_dir)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, **payload)
            with self._lock:
                os.replace(tmp, self._path(pid))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- read -------------------------------------------------------------

    def load_partition(self, pid: int) -> Optional[Dict[str, Any]]:
        """Partition payload dict, or None when missing/torn (the
        caller degrades down the ladder instead of crashing)."""
        path = self._path(pid)
        try:
            with np.load(path, allow_pickle=False) as data:
                if any(k not in data for k in _KEYS):
                    return None
                return {
                    "slots": np.asarray(data["slots"], dtype=np.int64),
                    "ext_ids": [str(e) for e in data["ext_ids"]],
                    "rows": np.asarray(data["rows"], dtype=np.float32),
                    "codes": np.asarray(data["codes"], dtype=np.uint8),
                }
        except (OSError, ValueError, KeyError):
            return None

    def has_partition(self, pid: int) -> bool:
        return os.path.exists(self._path(pid))

    def partition_ids(self) -> List[int]:
        out: List[int] = []
        try:
            names = os.listdir(self.root_dir)
        except OSError:
            return out
        for name in names:
            if name.startswith("part_") and name.endswith(".npz"):
                try:
                    out.append(int(name[len("part_"):-len(".npz")]))
                except ValueError:
                    continue
        return sorted(out)

    # -- bookkeeping ------------------------------------------------------

    def delete_partition(self, pid: int) -> bool:
        with self._lock:
            try:
                os.unlink(self._path(pid))
                return True
            except OSError:
                return False

    def clear(self) -> None:
        for pid in self.partition_ids():
            self.delete_partition(pid)

    def disk_bytes(self) -> int:
        """Total on-disk payload bytes — the cold-tier footprint the
        resource gauges report next to device/host bytes."""
        total = 0
        try:
            names = os.listdir(self.root_dir)
        except OSError:
            return 0
        for name in names:
            if name.startswith("part_") and name.endswith(".npz"):
                try:
                    total += os.path.getsize(
                        os.path.join(self.root_dir, name))
                except OSError:
                    continue
        return total

    def close(self) -> None:
        """Drop the spill directory when this store created it."""
        if self._owns_dir:
            shutil.rmtree(self.root_dir, ignore_errors=True)
