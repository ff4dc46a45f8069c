"""Brute-force exact kNN index with a device-resident matrix (counterpart
of ``nornicdb_tpu/search/vector_index.py:BruteForceIndex``).

A host NumPy mirror is the source of truth. A capacity-padded [C, D]
normalized matrix and its validity mask are copied to the device lazily,
behind a dirty set (after a few writes only their rows, into a copy of
the device arrays, so a reader holding the previous pair keeps it), and
queried with the fused cosine top-k kernel
(``ops/topk.py``). Growth re-pads to the next power-of-two capacity.
Small indexes stay on the host (``_SMALL_HOST``). ``device_view`` hands
the same device arrays to the fused hybrid tier, and ``slots_of`` joins
ids to slots at a pinned mutation generation; ``slots_changed_since``
reads a capped log of the ids whose slot changed, so a join derived once
can be patched after writes. A second capped log, the changelog, keeps
the ids added or updated after each mutation (``changed_since``), so a
graph built over a snapshot (``search/cagra.py``) can score its writes
exactly until it rebuilds. Once deleted rows outnumber both
``compact_min_dead`` and ``compact_dead_frac`` of the used slots, the
index compacts, as the reference's does: live rows move to the front in
slot order, capacity shrinks to ``pad_dim(n_alive)`` and the device pair
is dropped, so every slot-keyed join derives afresh. ``save`` writes the
live rows, compacted, to an ``.npz`` the reference reads, and ``load``
restores them verbatim.

``search_batch`` runs the reference's ladder, tiered -> quant -> float32
-> host: with ``NORNICDB_VECTOR_TIERED`` on and at least
``NORNICDB_TIERED_MIN_N`` (4,096) live rows the tiered plane
(``search/tiered_store.py``) answers, else with ``NORNICDB_VECTOR_QUANT``
int8 or pq and at least ``NORNICDB_QUANT_MIN_N`` (8,192) the quantized
plane (``search/device_quant.py``), else B1 over the float32 device pair
(or the host below ``_SMALL_HOST``). A plane's named freshness gaps step
down a rung; ``exact=True`` skips both planes. One plane of each kind per
index, created at first use with every ``NORNICDB_QUANT_*`` and
``NORNICDB_TIERED_*`` knob read then. The float32 device pair stays lazy:
a batch a plane answers never uploads it. The planes' exact rerank reads
``rows_for_slots`` and ``delta_vectors``; the quantized fused tier reads
``ids_meta``. Unlike the reference, an error in a plane propagates
(ROADMAP C23), so the reference's ``degrade_error`` records have no
counterpart. The float32 tier prices each batch (``obs/cost.py``,
``price_brute``) and notes its serving tier for the batch leader
(``audit.note_batch_tier("vector_brute_f32")``), and ``resource_stats`` reports the device pair's bytes
and the changelog's depth to ``obs/resources.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.config import env_bool, env_float, env_int, env_str
from nornicdb_tpu_torch.obs import audit as _audit
from nornicdb_tpu_torch.obs import cost as _cost
from nornicdb_tpu_torch.ops.similarity import l2_normalize, pad_dim
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk
from nornicdb_tpu_torch.search.device_quant import (
    QuantizedBrutePlane,
    quant_min_n,
    quant_mode,
)
from nornicdb_tpu_torch.search.tiered_store import (
    TIERED_NPROBE,
    TieredStore,
    tiered_enabled,
    tiered_min_n,
)


class DimsMismatch(ValueError):
    """A vector's width differs from the index's."""


class BruteForceIndex:
    """Exact cosine kNN over (id -> vector). Thread-safe."""

    # below this many matrix cells, host numpy beats a device round trip
    _SMALL_HOST = 1 << 18
    # ids whose slot changed (new id or removal) kept for join patching
    _SLOT_LOG_CAP = 4096

    # the reference's compaction policy: dead rows past both
    compact_min_dead = 1024
    compact_dead_frac = 0.5

    def __init__(self, dims: Optional[int] = None, device: DeviceLike = None):
        self.dims = dims
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._capacity = 0
        self._count = 0  # high-water mark of used slots
        self._matrix: Optional[np.ndarray] = None  # [cap, D] normalized f32
        self._valid: Optional[np.ndarray] = None  # [cap] bool
        self._ext_ids: List[Optional[str]] = []
        self._slot_of: Dict[str, int] = {}
        self._free: List[int] = []  # recycled slots (deletes)
        self._n_alive = 0
        self.mutations = 0  # bumped on every add/remove/compaction
        self.compactions = 0
        self.load_s: Dict[str, float] = {}  # set by load
        self._dev_matrix: Optional[torch.Tensor] = None
        self._dev_valid: Optional[torch.Tensor] = None
        # slots written since the last device copy; None = copy it all
        self._dirty_rows: Optional[Set[int]] = None
        self._ids_view: Optional[Tuple[int, List[Optional[str]]]] = None
        # (mutations after the change, ext id) per slot change; changes at
        # or before _slot_log_floor were trimmed
        self._slot_log: List[Tuple[int, str]] = []
        self._slot_log_floor = 0
        # (mutations after the write, ext id) per add or update, as the
        # reference's changelog; entries at or before _changelog_floor
        # were trimmed
        self._changelog: List[Tuple[int, str]] = []
        self._changelog_floor = 0
        # the serving planes, created at first use (quant_plane, tiered_plane)
        self._quant: Optional[QuantizedBrutePlane] = None
        self._tiered: Optional[TieredStore] = None

    def __len__(self) -> int:
        return self._n_alive

    def __contains__(self, ext_id: str) -> bool:
        with self._lock:
            return ext_id in self._slot_of

    def contains_many(self, ext_ids) -> Set[str]:
        """The live members of ``ext_ids``, under one lock hold."""
        with self._lock:
            return {e for e in ext_ids if e in self._slot_of}

    def ids(self) -> List[str]:
        """Live external ids, under one lock hold."""
        with self._lock:
            return list(self._slot_of)

    @staticmethod
    def _normalize(v: np.ndarray) -> np.ndarray:
        n = np.linalg.norm(v)
        return v / n if n > 1e-12 else v

    def _ensure_capacity_locked(self, needed: int, dims: int) -> None:
        if self.dims is None:
            self.dims = dims
        if dims != self.dims:
            raise DimsMismatch(f"dims mismatch: index={self.dims}, vector={dims}")
        if needed <= self._capacity:
            return
        new_cap = pad_dim(needed)
        new_m = np.zeros((new_cap, self.dims), dtype=np.float32)
        new_v = np.zeros((new_cap,), dtype=bool)
        if self._matrix is not None:
            new_m[: self._capacity] = self._matrix
            new_v[: self._capacity] = self._valid
        self._matrix = new_m
        self._valid = new_v
        self._ext_ids.extend([None] * (new_cap - len(self._ext_ids)))
        self._capacity = new_cap
        self._dirty_rows = None

    # -- mutation ---------------------------------------------------------

    def _add_locked(self, ext_id: str, v: np.ndarray) -> None:
        slot = self._slot_of.get(ext_id)
        if slot is None:
            self._ensure_capacity_locked(
                self._count + (0 if self._free else 1), v.shape[0])
            if self._free:
                slot = self._free.pop()
            else:
                slot = self._count
                self._count += 1
            self._valid[slot] = True
            self._ext_ids[slot] = ext_id
            self._slot_of[ext_id] = slot
            self._n_alive += 1
            self._log_slot_locked(ext_id)
        elif v.shape[0] != self.dims:
            raise DimsMismatch(f"dims mismatch: index={self.dims}, vector={v.shape[0]}")
        self._matrix[slot] = self._normalize(v)
        self._mark_dirty_locked(slot)
        self.mutations += 1
        self._log_change_locked(ext_id)

    def _mark_dirty_locked(self, slot: int) -> None:
        rows = self._dirty_rows
        if rows is not None:
            rows.add(slot)
            if len(rows) > self._capacity // 8:
                self._dirty_rows = None  # a whole copy is cheaper

    def _log_slot_locked(self, ext_id: str) -> None:
        """Log a slot change as of the mutation about to be counted."""
        self._slot_log.append((self.mutations + 1, ext_id))
        if len(self._slot_log) > 2 * self._SLOT_LOG_CAP:
            cut = len(self._slot_log) - self._SLOT_LOG_CAP
            self._slot_log_floor = self._slot_log[cut - 1][0]
            del self._slot_log[:cut]

    def _log_change_locked(self, ext_id: str) -> None:
        self._changelog.append((self.mutations, ext_id))
        limit = self.changelog_cap()
        if len(self._changelog) > limit:
            cut = len(self._changelog) - limit
            self._changelog_floor = self._changelog[cut - 1][0]
            del self._changelog[:cut]

    def changelog_cap(self) -> int:
        """The changelog's length cap, well above a derived index's
        rebuild threshold (10% of the corpus)."""
        return max(4096, self._capacity // 4)

    def resource_stats(self) -> Dict[str, float]:
        """Memory and freshness accounting for obs/resources.py: the
        device pair's bytes, the host mirror's, tombstone pressure, the
        changelog's depth against its cap, and the planes' keys. One
        short lock hold."""
        with self._lock:
            dims = self.dims or 0
            dev_b = 0
            if self._dev_matrix is not None:
                dev_b = (self._dev_matrix.numel() * self._dev_matrix.element_size()
                         + self._dev_valid.numel() * self._dev_valid.element_size())
            used = max(self._count, 1)
            quant = self._quant
            tiered = self._tiered
            stats = {
                "rows": self._n_alive,
                "capacity": self._capacity,
                "device_bytes": dev_b,
                # host mirror + the ext-id slot table (pointer-sized slots)
                "host_bytes": self._capacity * dims * 4 + self._capacity
                + 8 * len(self._ext_ids),
                "dead_fraction": round((self._count - self._n_alive) / used, 6),
                "changelog_depth": len(self._changelog),
                "changelog_cap": self.changelog_cap(),
                "mutations": self.mutations,
            }
        if quant is not None:
            stats.update(quant.resource_stats_extra())
        if tiered is not None:
            stats.update(tiered.resource_stats_extra())
        return stats

    def changed_since(self, seq: int) -> Optional[List[str]]:
        """Ids added or updated after mutation ``seq``, latest first and
        deduplicated; removals are not reported (consumers filter them
        by liveness). None when the changelog was trimmed past ``seq``."""
        with self._lock:
            if seq < self._changelog_floor:
                return None
            out: List[str] = []
            for s, eid in reversed(self._changelog):
                if s <= seq:
                    break
                out.append(eid)
        return list(dict.fromkeys(out))

    def add(self, ext_id: str, vector: Sequence[float]) -> None:
        v = np.asarray(vector, dtype=np.float32)
        with self._lock:
            self._add_locked(ext_id, v)

    def add_batch(self, items: Sequence[Tuple[str, Sequence[float]]]) -> None:
        """Same result as ``add`` per item, with capacity grown once."""
        if not items:
            return
        vecs = np.asarray([v for _, v in items], dtype=np.float32)
        with self._lock:
            new = len({e for e, _ in items if e not in self._slot_of})
            self._ensure_capacity_locked(
                self._count + max(new - len(self._free), 0), vecs.shape[1])
            for (ext_id, _), v in zip(items, vecs):
                self._add_locked(ext_id, v)

    def remove(self, ext_id: str) -> bool:
        with self._lock:
            slot = self._slot_of.pop(ext_id, None)
            if slot is None:
                return False
            self._valid[slot] = False
            self._ext_ids[slot] = None
            self._free.append(slot)
            self._n_alive -= 1
            self._log_slot_locked(ext_id)
            self._mark_dirty_locked(slot)
            self.mutations += 1
            self._maybe_compact_locked()
            return True

    def _maybe_compact_locked(self) -> None:
        dead = self._count - self._n_alive
        if (dead < self.compact_min_dead
                or dead < self.compact_dead_frac * max(self._count, 1)):
            return
        self._compact_locked()

    def compact(self) -> bool:
        """Re-pack the live rows and re-pad capacity; False when no row is
        dead. The remove path triggers it by the policy above."""
        with self._lock:
            if self._count == self._n_alive:
                return False
            self._compact_locked()
            return True

    def _live_rows_locked(self) -> List[int]:
        return [i for i, e in enumerate(self._ext_ids)
                if e is not None and self._valid[i]]

    def _compact_locked(self) -> None:
        """Live rows move to the front in slot order and capacity shrinks
        to ``pad_dim(n_alive)``. Every slot moves, so the slot log is
        cut (joins derive afresh) and the device pair is dropped (it is
        copied whole on the next read; readers holding the old pair keep
        it until they let go)."""
        rows = self._live_rows_locked()
        if not rows:
            self._capacity = 0
            self._matrix = None
            self._valid = None
            self._ext_ids = []
        else:
            new_cap = pad_dim(len(rows))
            new_m = np.zeros((new_cap, self.dims), dtype=np.float32)
            new_m[: len(rows)] = self._matrix[rows]
            new_v = np.zeros((new_cap,), dtype=bool)
            new_v[: len(rows)] = True
            self._ext_ids = ([self._ext_ids[i] for i in rows]
                             + [None] * (new_cap - len(rows)))
            self._matrix = new_m
            self._valid = new_v
            self._capacity = new_cap
        self._slot_of = {e: s for s, e in enumerate(self._ext_ids) if e is not None}
        self._count = len(rows)
        self._free = []
        self._dev_matrix = None
        self._dev_valid = None
        self._dirty_rows = None
        self.mutations += 1
        self.compactions += 1
        self._slot_log.clear()
        self._slot_log_floor = self.mutations

    def get(self, ext_id: str) -> Optional[np.ndarray]:
        with self._lock:
            slot = self._slot_of.get(ext_id)
            if slot is None:
                return None
            return self._matrix[slot].copy()

    def delta_vectors(self, ext_ids) -> Tuple[List[str], Optional[np.ndarray]]:
        """(ids, current rows [n, D] or None) of changelog ids under one
        lock hold, skipping ids removed since they were logged: the planes'
        exact side-scan of writes since their build."""
        with self._lock:
            ids: List[str] = []
            rows = []
            for eid in ext_ids:
                slot = self._slot_of.get(eid)
                if slot is None:
                    continue
                ids.append(eid)
                rows.append(self._matrix[slot].copy())
        return ids, (np.stack(rows) if ids else None)

    def rows_for_slots(self, slots, expect_compactions: Optional[int] = None):
        """(rows [n, D] copy, alive [n], ext ids [n]) of the given slots under
        one lock hold: the planes' exact rerank gather, current values. None
        when ``expect_compactions`` no longer matches (the slots address
        another layout) or a slot is out of range."""
        with self._lock:
            if expect_compactions is not None and self.compactions != expect_compactions:
                return None
            if self._matrix is None:
                return None
            sl = np.asarray(slots, dtype=np.int64)
            if sl.size and (sl.min() < 0 or sl.max() >= self._capacity):
                return None
            return (self._matrix[sl].copy(), self._valid[sl].copy(),
                    [self._ext_ids[int(i)] for i in sl])

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray, List[Optional[str]]]:
        """(matrix[cap, D], valid[cap], ext_ids), normalized, host side."""
        with self._lock:
            if self._matrix is None:
                return (np.zeros((0, self.dims or 0), np.float32),
                        np.zeros((0,), bool), [])
            return self._matrix.copy(), self._valid.copy(), list(self._ext_ids)

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the live rows, compacted, to an ``.npz`` (``ids``,
        ``matrix``), the reference's format. Written through a file object,
        since ``np.savez`` would append ``.npz`` to a bare path and break a
        caller's write-then-rename."""
        with self._lock:
            if self._matrix is None or self._n_alive == 0:
                ids = np.asarray([], dtype="U1")
                matrix = np.zeros((0, 0), np.float32)
            else:
                rows = self._live_rows_locked()
                ids = np.asarray([self._ext_ids[i] for i in rows])
                matrix = self._matrix[rows]
        with open(path, "wb") as f:
            np.savez_compressed(f, ids=ids, matrix=matrix)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "BruteForceIndex":
        """Restore a saved index: rows go back verbatim (normalizing a
        float32 row again can move it by a rounding step and reorder ties).
        On the card the matrix is uploaded at once, in one copy.
        ``load_s`` splits the seconds into ``read`` and ``upload``."""
        t0 = time.perf_counter()
        idx = cls(device=device)
        with np.load(path, allow_pickle=False) as data:
            ids = data["ids"]
            matrix = np.asarray(data["matrix"], np.float32)
        n = len(ids)
        if n:
            idx._ensure_capacity_locked(n, matrix.shape[1])
            idx._matrix[:n] = matrix
            idx._valid[:n] = True
            ext = ids.tolist()
            idx._ext_ids[:n] = ext
            idx._slot_of = {e: i for i, e in enumerate(ext)}
            idx._count = n
            idx._n_alive = n
        t1 = time.perf_counter()
        if n and idx.device.type == "cuda" and not idx._host_served_locked():
            with idx._lock:
                idx._device_arrays_locked()
            torch.cuda.synchronize(idx.device)
        idx.load_s = {"read": t1 - t0, "upload": time.perf_counter() - t1}
        return idx

    # -- search -----------------------------------------------------------

    def _host_served_locked(self) -> bool:
        """Small indexes answer on the host (``_SMALL_HOST``)."""
        return self._capacity * (self.dims or 1) <= self._SMALL_HOST

    def _device_arrays_locked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._dev_matrix is None or self._dirty_rows is None:
            self._dev_matrix = torch.from_numpy(self._matrix).to(
                self.device, copy=True)
            self._dev_valid = torch.from_numpy(self._valid).to(
                self.device, copy=True)
        elif self._dirty_rows:
            rows = np.fromiter(self._dirty_rows, np.int64, len(self._dirty_rows))
            idx = torch.from_numpy(rows).to(self.device)
            m = self._dev_matrix.clone()
            m[idx] = torch.from_numpy(self._matrix[rows]).to(self.device)
            valid = self._dev_valid.clone()
            valid[idx] = torch.from_numpy(self._valid[rows]).to(self.device)
            self._dev_matrix, self._dev_valid = m, valid
        self._dirty_rows = set()
        return self._dev_matrix, self._dev_valid

    def slots_of(
        self, ext_ids: Sequence[str], expect_mutations: Optional[int] = None,
    ) -> Optional[List[int]]:
        """Current slot per ext id (-1 when absent), or None when
        ``expect_mutations`` no longer matches: a write landed since the
        caller captured its view, and joining fresh slots against that
        view could mis-join. Read and check share one lock hold."""
        with self._lock:
            if expect_mutations is not None and self.mutations != expect_mutations:
                return None
            return [self._slot_of.get(e, -1) for e in ext_ids]

    def slots_changed_since(
        self, since: int, expect_mutations: int,
    ) -> Optional[Dict[str, int]]:
        """Current slot (-1 when absent) of each id whose slot changed
        after mutation ``since``, or None when ``expect_mutations`` no
        longer matches (as in ``slots_of``) or the log no longer reaches
        back to ``since``. Writes that keep an id's slot are not logged:
        they leave a join unchanged."""
        with self._lock:
            if self.mutations != expect_mutations or since < self._slot_log_floor:
                return None
            out: Dict[str, int] = {}
            for gen, eid in reversed(self._slot_log):
                if gen <= since:
                    break
                out.setdefault(eid, self._slot_of.get(eid, -1))
            return out

    def view_meta(self) -> Optional[int]:
        """The mutation counter, or None while the index is empty,
        without bringing the device arrays up to date."""
        with self._lock:
            if self._n_alive == 0 or self._matrix is None:
                return None
            return self.mutations

    def ids_meta(self) -> Optional[Tuple[List[Optional[str]], int, int]]:
        """(slot -> id list, mutations, compactions), or None while empty,
        without bringing the device arrays up to date (the quantized fused
        tier joins on slots and never reads the float32 pair)."""
        with self._lock:
            if self._n_alive == 0 or self._matrix is None:
                return None
            return self._ids_locked(), self.mutations, self.compactions

    def device_view(
        self,
    ) -> Optional[Tuple[torch.Tensor, torch.Tensor, List[Optional[str]], int]]:
        """(matrix [C, D], valid [C], slot -> id list, mutations) captured
        under one lock hold, or None while empty: the device arrays
        ``search_batch`` dispatches against, for batched callers (the
        fused hybrid tier)."""
        with self._lock:
            if self._n_alive == 0 or self._matrix is None:
                return None
            m, valid = self._device_arrays_locked()
            return m, valid, self._ids_locked(), self.mutations

    def _ids_locked(self) -> List[Optional[str]]:
        """The slot -> id list, copied once per mutation generation."""
        if self._ids_view is None or self._ids_view[0] != self.mutations:
            self._ids_view = (self.mutations, list(self._ext_ids))
        return self._ids_view[1]

    @staticmethod
    def _search_host(queries, m, valid, ext_ids, k_eff):
        qn = queries / np.maximum(
            np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
        scores = qn @ m.T
        scores[:, ~valid] = -np.inf
        out: List[List[Tuple[str, float]]] = []
        for row in range(scores.shape[0]):
            top = np.argpartition(-scores[row], k_eff - 1)[:k_eff]
            # exact ties order lower slot first, as the device path does
            top = top[np.lexsort((top, -scores[row][top]))]
            hits = []
            for idx in top:
                if not np.isfinite(scores[row, idx]):
                    break
                eid = ext_ids[int(idx)]
                if eid is not None:
                    hits.append((eid, float(scores[row, idx])))
            out.append(hits)
        return out

    def quant_plane(self) -> Optional[QuantizedBrutePlane]:
        """The quantized plane when NORNICDB_VECTOR_QUANT is int8 or pq and
        the index holds at least ``quant_min_n()`` live rows, else None;
        one per index, shared by direct search and the fused tier, its
        knobs (``NORNICDB_QUANT_SHARDS`` row shards among them) read here,
        once."""
        if quant_mode() == "off" or self._n_alive < quant_min_n():
            return None
        with self._lock:
            if self._quant is None:
                self._quant = QuantizedBrutePlane(
                    self, n_shards=max(1, env_int("QUANT_SHARDS", 1)),
                    build_inline=env_bool("QUANT_INLINE_BUILD", False),
                    overfetch=max(1, env_int("QUANT_OVERFETCH", 8)),
                    min_pool=max(1, env_int("QUANT_MIN_POOL", 128)))
            return self._quant

    def tiered_plane(self) -> Optional[TieredStore]:
        """The tiered plane when NORNICDB_VECTOR_TIERED is on and the index
        holds at least ``tiered_min_n()`` live rows, else None; one per
        index, every NORNICDB_TIERED_* knob read here, once."""
        if not tiered_enabled() or self._n_alive < tiered_min_n():
            return None
        with self._lock:
            if self._tiered is None:
                self._tiered = TieredStore(
                    self,
                    nprobe=max(1, env_int("TIERED_NPROBE", TIERED_NPROBE)),
                    parts=max(0, env_int("TIERED_PARTS", 0)),
                    resident_max=max(0, env_int("TIERED_RESIDENT", 0)),
                    part_rows=max(256, env_int("TIERED_PART_ROWS", 4096)),
                    lex_bonus=env_float("TIERED_LEX_BONUS", 0.15),
                    build_inline=env_bool("TIERED_INLINE_BUILD", False),
                    overfetch=max(1, env_int("TIERED_OVERFETCH", 8)),
                    min_pool=max(1, env_int("TIERED_MIN_POOL", 128)),
                    root_dir=env_str("TIERED_DIR", "") or None)
            return self._tiered

    def _tiered_search_batch(self, queries, k, lex_hints=None):
        """The tiered rung: its answers, or None when the lower rungs serve
        (plane off, below its floor, or at a named gap)."""
        plane = self.tiered_plane()
        if plane is None:
            return None
        return plane.search_batch(np.asarray(queries, dtype=np.float32), k,
                                  lex_hints=lex_hints)

    def _quant_search_batch(self, queries, k):
        """The quantized rung: its answers, or None when float32 serves."""
        plane = self.quant_plane()
        if plane is None:
            return None
        return plane.search_batch(np.asarray(queries, dtype=np.float32), k)

    def search(self, query: Sequence[float], k: int = 10) -> List[Tuple[str, float]]:
        """One query's [(ext_id, cosine)], through ``search_batch``."""
        return self.search_batch(np.asarray([query], dtype=np.float32), k)[0]

    def search_batch(
        self, queries: np.ndarray, k: int = 10, exact: bool = False,
    ) -> List[List[Tuple[str, float]]]:
        """Batched search; per-query [(ext_id, cosine)]: the tiered and
        quantized rungs when they serve (their scores are exact cosines of
        live rows), else exact float32. ``exact=True`` skips the planes.
        Above the small-host rung the float32 tier answers through the
        fused top-k kernel (its plain version when the index lives on the
        CPU)."""
        if not exact:
            out = self._tiered_search_batch(queries, k)
            if out is None:
                out = self._quant_search_batch(queries, k)
            if out is not None:
                return out
        # every answer below is the exact float32 tier's (a plane notes
        # its own tier before it returns above)
        _audit.note_batch_tier("vector_brute_f32")
        with self._lock:
            if self._n_alive == 0:
                return [[] for _ in range(len(queries))]
            k_eff = min(k, self._n_alive)
            # the scan's price from its shapes: B queries against the
            # capacity-padded [C, D] matrix, host or device alike
            if _cost.pricing_enabled():
                flops, byts = _cost.price_brute(len(queries), self._capacity, self.dims or 1)
                _cost.record_query_cost("brute", _cost.cost_name(self), len(queries),
                                        flops, byts)
            if self._host_served_locked():
                return self._search_host(
                    np.asarray(queries, np.float32), self._matrix,
                    self._valid, self._ext_ids, k_eff)
            m, valid = self._device_arrays_locked()
            ext_ids = self._ids_locked()
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        s, i = fused_cosine_topk(l2_normalize(q).contiguous(), m, valid, k_eff)
        s = s.cpu().numpy()
        i = i.cpu().numpy()
        out: List[List[Tuple[str, float]]] = []
        for row in range(s.shape[0]):
            hits = []
            for col in range(s.shape[1]):
                if s[row, col] < -1e29:
                    break
                eid = ext_ids[int(i[row, col])]
                if eid is not None:
                    hits.append((eid, float(s[row, col])))
            out.append(hits)
        return out
