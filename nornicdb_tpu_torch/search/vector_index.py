"""Brute-force exact kNN index with a device-resident matrix (counterpart
of ``nornicdb_tpu/search/vector_index.py:BruteForceIndex``).

A host NumPy mirror is the source of truth. A capacity-padded [C, D]
normalized matrix and its validity mask are copied to the device lazily,
behind a dirty flag, and queried with the fused cosine top-k kernel
(``ops/topk.py``). Growth re-pads to the next power-of-two capacity.
Small indexes stay on the host (``_SMALL_HOST``). The quantized and
tiered planes, CAGRA and compaction wait for later slices.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.similarity import l2_normalize, pad_dim
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk


class BruteForceIndex:
    """Exact cosine kNN over (id -> vector). Thread-safe."""

    # below this many matrix cells, host numpy beats a device round trip
    _SMALL_HOST = 1 << 18

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
        self.mutations = 0  # bumped on every add/remove
        self._dev_matrix: Optional[torch.Tensor] = None
        self._dev_valid: Optional[torch.Tensor] = None
        self._dirty = True
        self._ids_view: Optional[Tuple[int, List[Optional[str]]]] = None

    def __len__(self) -> int:
        return self._n_alive

    def __contains__(self, ext_id: str) -> bool:
        with self._lock:
            return ext_id in self._slot_of

    @staticmethod
    def _normalize(v: np.ndarray) -> np.ndarray:
        n = np.linalg.norm(v)
        return v / n if n > 1e-12 else v

    def _ensure_capacity_locked(self, needed: int, dims: int) -> None:
        if self.dims is None:
            self.dims = dims
        if dims != self.dims:
            raise ValueError(f"dims mismatch: index={self.dims}, vector={dims}")
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
        self._dirty = True

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
        elif v.shape[0] != self.dims:
            raise ValueError(f"dims mismatch: index={self.dims}, vector={v.shape[0]}")
        self._matrix[slot] = self._normalize(v)
        self._dirty = True
        self.mutations += 1

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
            self._dirty = True
            self.mutations += 1
            return True

    def get(self, ext_id: str) -> Optional[np.ndarray]:
        with self._lock:
            slot = self._slot_of.get(ext_id)
            if slot is None:
                return None
            return self._matrix[slot].copy()

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray, List[Optional[str]]]:
        """(matrix[cap, D], valid[cap], ext_ids), normalized, host side."""
        with self._lock:
            if self._matrix is None:
                return (np.zeros((0, self.dims or 0), np.float32),
                        np.zeros((0,), bool), [])
            return self._matrix.copy(), self._valid.copy(), list(self._ext_ids)

    # -- search -----------------------------------------------------------

    def _device_arrays_locked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._dirty or self._dev_matrix is None:
            self._dev_matrix = torch.from_numpy(self._matrix).to(
                self.device, copy=True)
            self._dev_valid = torch.from_numpy(self._valid).to(
                self.device, copy=True)
            self._dirty = False
        return self._dev_matrix, self._dev_valid

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

    def search_batch(
        self, queries: np.ndarray, k: int = 10
    ) -> List[List[Tuple[str, float]]]:
        """Batched exact search; per-query [(ext_id, cosine)]. Above the
        small-host rung, the device answers through the fused top-k
        kernel (its plain version when the index lives on the CPU)."""
        with self._lock:
            if self._n_alive == 0:
                return [[] for _ in range(len(queries))]
            k_eff = min(k, self._n_alive)
            if self._capacity * (self.dims or 1) <= self._SMALL_HOST:
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
