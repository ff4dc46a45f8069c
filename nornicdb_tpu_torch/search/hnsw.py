"""HNSW approximate-nearest-neighbor index with batched wave builds
(counterpart of ``nornicdb_tpu/search/hnsw.py:HNSWIndex``).

Host NumPy, as in the reference: the graph walk is serial pointer
chasing per query, the host tier of the search service.

- Adjacency is one padded int32 matrix per level, [capacity, width],
  so a wave of beam searches runs batched.
- ``build()`` inserts in waves: each wave searches the pre-wave graph,
  then links are connected. Waves are capped relative to the current
  graph so that intra-wave blindness cannot degrade the backbone.
- BM25-seeded insertion order: lexically discriminative docs go first
  and form the backbone; the bulk after them searches with half the
  construction beam.
- The wave search, the connect phase and queries run in the host
  library ``csrc/hnsw_host.cpp`` (``search/hnsw_native.py``); the Python
  path beside them computes the same graph and answers and runs only
  where ``hnsw_native.get_lib`` is replaced to return None.

The RNG (``default_rng(seed=42)``) and the constants are the reference's,
so both packages build the same graph from the same inputs. Tombstoned
entries are traversed but never returned; past ``rebuild_threshold`` the
owner rebuilds. ``save``/``load`` use the reference's ``.npz`` fields
(neighbour lists as an object array, read with ``allow_pickle=True``),
so each package loads the other's file.
"""

from __future__ import annotations

import heapq
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nornicdb_tpu_torch.search import hnsw_native


class HNSWIndex:
    def __init__(
        self,
        dims: Optional[int] = None,
        m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 64,
        seed: int = 42,
        rebuild_threshold: float = 0.2,
    ):
        self.dims = dims
        self.m = m
        self.m0 = 2 * m  # level-0 degree cap
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.rebuild_threshold = rebuild_threshold
        self._ml = 1.0 / math.log(m)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.RLock()

        self._vectors: Optional[np.ndarray] = None  # [cap, D] normalized
        self._capacity = 0
        self._count = 0
        self._ext_ids: List[Optional[str]] = []
        self._slot_of: Dict[str, int] = {}
        self._alive: List[bool] = []
        self._levels: List[int] = []
        # per-level padded adjacency: _nbrL[lv] int32 [cap, width] (-1
        # pad), _cntL[lv] int32 [cap]; width = m0 at level 0 else m
        self._nbrL: List[np.ndarray] = []
        self._cntL: List[np.ndarray] = []
        self._entry: int = -1
        self._max_level: int = -1
        self._tombstones = 0
        # reusable visited-stamp scratch for batched searches (guarded by
        # self._lock); zeroed only when the uint8 generation space wraps
        self._visit_buf: Optional[np.ndarray] = None
        self._visit_base = 0

    def __len__(self) -> int:
        return len(self._slot_of)

    def ids(self) -> List[str]:
        """Alive external ids (an IVF-HNSW reload rebuilds its routing
        map from these)."""
        with self._lock:
            return list(self._slot_of.keys())

    def __contains__(self, ext_id: str) -> bool:
        with self._lock:
            return ext_id in self._slot_of

    @property
    def tombstone_ratio(self) -> float:
        total = self._count
        return self._tombstones / total if total else 0.0

    def should_rebuild(self) -> bool:
        """True once the tombstone ratio passes ``rebuild_threshold``."""
        return self.tombstone_ratio > self.rebuild_threshold

    # -- storage ----------------------------------------------------------

    @staticmethod
    def _normalize(v: np.ndarray) -> np.ndarray:
        n = np.linalg.norm(v)
        return v / n if n > 1e-12 else v

    # adjacency rows carry this much slack past the degree cap; a row is
    # pruned back to the cap only when the slack fills, amortizing the
    # (vectorized but still per-node) diversity prune across ~SLACK
    # back-link insertions
    SLACK = 8

    def _level_width(self, lv: int) -> int:
        return (self.m0 if lv == 0 else self.m) + self.SLACK

    def _level_cap(self, lv: int) -> int:
        return self.m0 if lv == 0 else self.m

    def _ensure_level(self, lv: int) -> None:
        while len(self._nbrL) <= lv:
            w = self._level_width(len(self._nbrL))
            self._nbrL.append(np.full((self._capacity, w), -1, np.int32))
            self._cntL.append(np.zeros(self._capacity, np.int32))

    def _grow(self, needed: int, dims: int) -> None:
        if self.dims is None:
            self.dims = dims
        if dims != self.dims:
            raise ValueError(f"dims mismatch: index={self.dims}, vector={dims}")
        if needed <= self._capacity:
            return
        new_cap = max(256, self._capacity * 2, needed)
        new_m = np.zeros((new_cap, self.dims), dtype=np.float32)
        if self._vectors is not None:
            new_m[: self._capacity] = self._vectors
        self._vectors = new_m
        for lv in range(len(self._nbrL)):
            w = self._nbrL[lv].shape[1]
            grown = np.full((new_cap, w), -1, np.int32)
            grown[: self._capacity] = self._nbrL[lv]
            self._nbrL[lv] = grown
            gcnt = np.zeros(new_cap, np.int32)
            gcnt[: self._capacity] = self._cntL[lv]
            self._cntL[lv] = gcnt
        self._capacity = new_cap

    def _neighbors_of(self, slot: int, lv: int) -> np.ndarray:
        return self._nbrL[lv][slot, : self._cntL[lv][slot]]

    def _set_neighbors(self, slot: int, lv: int, nbrs: Sequence[int]) -> None:
        w = self._nbrL[lv].shape[1]
        nbrs = list(nbrs)[:w]
        self._nbrL[lv][slot, : len(nbrs)] = nbrs
        self._nbrL[lv][slot, len(nbrs):] = -1
        self._cntL[lv][slot] = len(nbrs)

    def _dist_many(self, q: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Batched cosine distances (1 - dot) — one mat-vec per call."""
        return 1.0 - self._vectors[slots] @ q

    # -- layer search ------------------------------------------------------

    def _search_layer(
        self, q: np.ndarray, entries: List[Tuple[float, int]], ef: int, level: int
    ) -> List[Tuple[float, int]]:
        """Beam search one layer, single query (latency path).
        entries/result: (dist, slot) min-heaps."""
        visited = {s for _, s in entries}
        candidates = list(entries)  # min-heap by dist
        heapq.heapify(candidates)
        result = [(-d, s) for d, s in entries]  # max-heap (neg dist)
        heapq.heapify(result)
        while candidates:
            d, slot = heapq.heappop(candidates)
            if result and d > -result[0][0]:
                break
            row = self._neighbors_of(slot, level)
            neigh = [n for n in row.tolist() if n not in visited]
            if not neigh:
                continue
            visited.update(neigh)
            dists = self._dist_many(q, np.asarray(neigh, np.int64))
            worst = -result[0][0] if result else float("inf")
            for nd, ns in zip(dists, neigh):
                nd = float(nd)
                if len(result) < ef or nd < worst:
                    heapq.heappush(candidates, (nd, ns))
                    heapq.heappush(result, (-nd, ns))
                    if len(result) > ef:
                        heapq.heappop(result)
                    worst = -result[0][0]
        return sorted((-nd, s) for nd, s in result)

    def _select_neighbors(
        self, cands: List[Tuple[float, int]], m: int
    ) -> List[int]:
        """Heuristic neighbor selection with diversity pruning: a candidate
        is kept only if it is closer to the query than to any already-kept
        neighbor (standard HNSW heuristic). Vectorized: one pairwise
        distance matrix over the (4m-capped) candidate list, then a
        greedy mask update per kept neighbor — no per-candidate matvec."""
        cands = cands[: 4 * m]
        C = len(cands)
        if C <= m:
            return [s for _, s in cands]
        slots = np.fromiter((s for _, s in cands), dtype=np.int64, count=C)
        dq = np.fromiter((d for d, _ in cands), dtype=np.float32, count=C)
        V = self._vectors[slots]
        M = 1.0 - V @ V.T  # [C, C] candidate-candidate distances
        ok = np.ones(C, dtype=bool)
        taken = np.zeros(C, dtype=bool)
        kept: List[int] = []
        for i in range(C):
            if not ok[i]:
                continue
            kept.append(int(slots[i]))
            taken[i] = True
            if len(kept) >= m:
                break
            # survivors must be closer to the query than to neighbor i
            ok &= dq < M[:, i]
            ok[i] = False
        # backfill with closest if the heuristic was too aggressive
        if len(kept) < m:
            for i in range(C):
                if not taken[i]:
                    kept.append(int(slots[i]))
                    taken[i] = True
                    if len(kept) >= m:
                        break
        return kept

    def _visit_scratch(self, rows: int) -> Tuple[np.ndarray, np.ndarray]:
        """[rows, capacity] stamp buffer + per-row generation starts
        (caller holds the lock and consumes at most 16 generations —
        one per (level, phase), far above any real level count). The
        buffer is reallocated only on growth and zeroed only when the
        uint8 generation space wraps, instead of ~100MB of fresh zeroed
        pages per wave."""
        buf = self._visit_buf
        if (buf is None or buf.shape[0] < rows
                or buf.shape[1] < self._capacity):
            rows_cap = max(rows, self.WAVE_MAX)
            self._visit_buf = buf = np.zeros(
                (rows_cap, self._capacity), np.uint8)
            self._visit_base = 0
        if self._visit_base > 239:
            buf[:] = 0
            self._visit_base = 0
        base = self._visit_base
        self._visit_base = base + 16
        return buf, np.full(rows, base, np.uint8)

    def _add_link(self, c: int, lv: int, slot: int) -> None:
        """Append back-link c -> slot; when the slack fills, prune the
        row back to the level's degree cap."""
        cnt = int(self._cntL[lv][c])
        w = self._nbrL[lv].shape[1]
        if cnt < w:
            self._nbrL[lv][c, cnt] = slot
            self._cntL[lv][c] = cnt + 1
            return
        nb = self._nbrL[lv][c].tolist() + [slot]
        d = 1.0 - self._vectors[nb] @ self._vectors[c]
        order = sorted(zip(d.tolist(), nb))
        self._set_neighbors(
            c, lv, self._select_neighbors(order, self._level_cap(lv))
        )

    # -- insert ------------------------------------------------------------

    MAX_LEVEL = 12  # clamp the geometric tail: _visit_scratch reserves 16
    # generations per call (one per level + slack); an unbounded draw
    # could overlap the next call's range and stamp false "visited"

    def _sample_level(self) -> int:
        return min(
            int(-math.log(max(self._rng.random(), 1e-12)) * self._ml),
            self.MAX_LEVEL,
        )

    def add(self, ext_id: str, vector: Sequence[float]) -> None:
        v = self._normalize(np.asarray(vector, dtype=np.float32))
        with self._lock:
            if ext_id in self._slot_of:
                # an in-place vector overwrite would leave the node's graph
                # edges anchored in the old region (silent recall loss);
                # tombstone the old slot and insert fresh so links re-form
                self.remove(ext_id)
            level = self._sample_level()
            slot = self._alloc_slot(ext_id, v, level)
            if self._entry < 0:
                self._entry = slot
                self._max_level = level
                return
            self._connect(slot, v, level)
            if level > self._max_level:
                self._max_level = level
                self._entry = slot

    def _alloc_slot(self, ext_id: str, v: np.ndarray, level: int) -> int:
        self._grow(self._count + 1, v.shape[0])
        slot = self._count
        self._count += 1
        self._vectors[slot] = v
        self._ext_ids.append(ext_id)
        self._slot_of[ext_id] = slot
        self._alive.append(True)
        self._levels.append(level)
        self._ensure_level(max(level, 0))
        return slot

    def _connect(self, slot: int, v: np.ndarray, level: int) -> None:
        """Descend + link one node (single-query latency path)."""
        ep = [(float(1.0 - self._vectors[self._entry] @ v), self._entry)]
        for lv in range(self._max_level, level, -1):
            ep = self._search_layer(v, ep, 1, lv)
        for lv in range(min(self._max_level, level), -1, -1):
            cands = self._search_layer(v, ep, self.ef_construction, lv)
            self._link_from_cands(slot, lv, cands)
            ep = cands

    def _link_from_cands(
        self, slot: int, lv: int, cands: List[Tuple[float, int]]
    ) -> None:
        chosen = self._select_neighbors(cands, self.m)
        self._set_neighbors(slot, lv, chosen)
        for c in chosen:
            self._add_link(c, lv, slot)

    # -- bulk build (batched waves) -----------------------------------------

    # Wave members search the pre-wave graph only; capping the wave at
    # this fraction of the current graph keeps the backbone intact. The
    # absolute cap bounds the [wave, capacity] visited buffer and keeps
    # per-step gathers cache-sized.
    WAVE_FRACTION = 8
    WAVE_MAX = 1024
    BOOTSTRAP = 256

    def build(
        self,
        items: Sequence[Tuple[str, Sequence[float]]],
        seed_ids: Optional[Sequence[str]] = None,
        bulk_ef_scale: float = 0.5,
    ) -> None:
        """Bulk build; if ``seed_ids`` given (BM25 seeds), those docs are
        inserted first to form the backbone. Inserts run in batched
        waves: each wave's beam searches run against the pre-wave graph,
        then its links connect.

        The seeded build turns backbone quality into build time: the
        backbone (seeds, full ef_construction) is topically
        representative, so the bulk phase descends through it straight
        to the right neighborhood and a smaller construction beam
        (``bulk_ef_scale`` x ef_construction) finds the same links, with
        ~2x fewer distance evaluations per insert."""
        if seed_ids:
            seed_set = set(seed_ids)
            by_id = {i: v for i, v in items}
            ordered = [(i, by_id[i]) for i in seed_ids if i in by_id]
            n_seed = len(ordered)
            ordered += [(i, v) for i, v in items if i not in seed_set]
        else:
            ordered = list(items)
            n_seed = 0
        bulk_ef = max(32, int(self.ef_construction * bulk_ef_scale))
        with self._lock:
            i = 0
            n = len(ordered)
            while i < n and self._count < self.BOOTSTRAP:
                self.add(*ordered[i])
                i += 1
            while i < n:
                wave = min(
                    max(64, self._count // self.WAVE_FRACTION),
                    self.WAVE_MAX,
                )
                batch = ordered[i: i + wave]
                efc = (self.ef_construction
                       if (n_seed == 0 or i < n_seed)
                       else bulk_ef)
                i += len(batch)
                self._build_wave_locked(batch, efc=efc)

    def _build_wave_locked(self, batch: Sequence[Tuple[str, Sequence[float]]],
                    efc: Optional[int] = None) -> None:
        # intra-wave duplicate ids: keep the last occurrence (add()'s
        # overwrite order); without this, two alive slots share one id
        # and remove() can only ever reach the tracked one
        last = {ext_id: i for i, (ext_id, _) in enumerate(batch)}
        if len(last) != len(batch):
            batch = [bv for i, bv in enumerate(batch)
                     if last[bv[0]] == i]
        B = len(batch)
        Q = np.stack([
            self._normalize(np.asarray(v, dtype=np.float32))
            for _, v in batch
        ])
        # duplicate ids: tombstone + reinsert (same semantics as add())
        for ext_id, _ in batch:
            if ext_id in self._slot_of:
                self.remove(ext_id)
        levels = [self._sample_level() for _ in range(B)]
        pre_entry, pre_max = self._entry, self._max_level
        slots = [
            self._alloc_slot(batch[j][0], Q[j], levels[j]) for j in range(B)
        ]
        if pre_entry < 0:
            # empty index: seed sequentially (rare — build() bootstraps)
            self._entry = slots[0]
            self._max_level = levels[0]
            for j in range(1, B):
                self._connect(slots[j], Q[j], levels[j])
                if levels[j] > self._max_level:
                    self._max_level = levels[j]
                    self._entry = slots[j]
            return

        efc = efc or self.ef_construction
        lvq = np.asarray(levels)
        lib = hnsw_native.get_lib()
        if lib is not None:
            # native search + connect: the classic per-query heap search
            # in C++ does the same distance evaluations as the numpy
            # wave search below, without its per-step array glue
            n_levels = min(len(self._nbrL), pre_max + 1)
            wd, ws = hnsw_native.wave_search(
                lib, self._vectors, self._nbrL[:n_levels],
                self._cntL[:n_levels], Q, lvq, pre_entry, efc,
                self._capacity)
            for lv in range(min(int(lvq.max()), n_levels - 1), -1, -1):
                collect = np.nonzero(lvq >= lv)[0]
                if len(collect) == 0:
                    continue
                counts = []
                for j in collect:
                    counts.append(int((ws[j, lv] >= 0).sum()))
                off = np.zeros(len(collect) + 1, np.int64)
                np.cumsum(counts, out=off[1:])
                cs = np.empty(int(off[-1]), np.int64)
                cd = np.empty(int(off[-1]), np.float32)
                for i, j in enumerate(collect):
                    k = counts[i]
                    lo = int(off[i])
                    cs[lo:lo + k] = ws[j, lv, :k]
                    cd[lo:lo + k] = wd[j, lv, :k]
                wave_slots = np.asarray([slots[j] for j in collect],
                                        np.int64)
                hnsw_native.connect_wave(
                    lib, self._vectors, self._nbrL[lv], self._cntL[lv],
                    self.m, self._level_cap(lv), wave_slots, off, cs, cd)
            top = int(np.argmax(lvq))
            if levels[top] > self._max_level:
                self._max_level = levels[top]
                self._entry = slots[top]
            return

        visited, gen = self._visit_scratch(B)

        d0 = 1.0 - Q @ self._vectors[pre_entry]
        bd = np.full((B, efc), np.inf, dtype=np.float32)
        bs = np.full((B, efc), -1, dtype=np.int64)
        bd[:, 0] = d0
        bs[:, 0] = pre_entry
        cands_at: Dict[int, List[Tuple[int, List[Tuple[float, int]]]]] = {}
        for lv in range(pre_max, -1, -1):
            collect = np.nonzero(lvq >= lv)[0]
            greedy = np.nonzero(lvq < lv)[0]
            for sub, ef in ((greedy, 1), (collect, efc)):
                if len(sub) == 0:
                    continue
                gen[sub] += 1
                rd, rs = self._batched_search_layer(
                    Q, bd, bs, sub, ef, lv, visited, gen
                )
                bd[sub] = np.inf
                bs[sub] = -1
                bd[sub, : rd.shape[1]] = rd
                bs[sub, : rs.shape[1]] = rs
            if len(collect):
                per = []
                for row, j in enumerate(collect):
                    dd = bd[j]
                    ss = bs[j]
                    ok = ss >= 0
                    order = np.argsort(dd[ok], kind="stable")
                    per.append((
                        int(j),
                        list(zip(dd[ok][order].tolist(),
                                 ss[ok][order].tolist())),
                    ))
                cands_at[lv] = per

        # connect phase: wave nodes link against the pre-wave graph
        for lv in sorted(cands_at.keys(), reverse=True):
            for j, cands in cands_at[lv]:
                self._link_from_cands(slots[j], lv, cands)
        top = int(np.argmax(lvq))
        if levels[top] > self._max_level:
            self._max_level = levels[top]
            self._entry = slots[top]

    def _batched_search_layer(
        self,
        Q: np.ndarray,
        bd: np.ndarray,
        bs: np.ndarray,
        sub: np.ndarray,
        ef: int,
        lv: int,
        visited: np.ndarray,
        gen: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Beam search one layer for the query subset ``sub``, batched.

        The beam doubles as the candidate pool (the bulk-builder variant
        of HNSW's search: every beam entry is expanded exactly once; an
        entry that leaves the beam is abandoned). Each expansion step is
        a gather + one einsum over [A, width, D] — no per-node Python.
        Entry beams arrive in bd/bs[sub]; returns (dist, slot) arrays
        [A, ef], +inf/-1 padded.
        """
        A = len(sub)
        qd = np.where(bs[sub] >= 0, bd[sub], np.inf)[:, :ef]
        qs = bs[sub][:, :ef]
        if qd.shape[1] < ef:
            pad = ef - qd.shape[1]
            qd = np.pad(qd, ((0, 0), (0, pad)), constant_values=np.inf)
            qs = np.pad(qs, ((0, 0), (0, pad)), constant_values=-1)
        exp = qs < 0  # padding counts as already-expanded
        # stamp entries visited (vectorized over the whole subset)
        er, ec = np.nonzero(qs >= 0)
        visited[sub[er], qs[er, ec]] = gen[sub[er]]
        nbr = self._nbrL[lv]
        Qs = Q[sub]
        # expand the E best unexpanded beam entries per step: total
        # expansions are unchanged (every beam slot expands at most
        # once), but the per-step Python/alloc overhead is amortized E
        # ways — this is what makes the wave build fast
        E = max(1, min(16, ef))
        while True:
            dmask = np.where(exp, np.inf, qd)
            if E == 1:
                j = np.argmin(dmask, axis=1)[:, None]
            else:
                j = np.argpartition(dmask, E - 1, axis=1)[:, :E]
            jd = np.take_along_axis(dmask, j, axis=1)  # [A, E]
            act = np.nonzero(np.isfinite(jd).any(axis=1))[0]
            if len(act) == 0:
                return qd, qs
            ja = j[act]
            fin = np.isfinite(jd[act])
            rows = np.where(fin, np.take_along_axis(qs[act], ja, axis=1), -1)
            ea = exp[act]
            np.put_along_axis(ea, ja, True, axis=1)
            exp[act] = ea
            w = nbr.shape[1]
            nb = np.where(rows[:, :, None] >= 0, nbr[np.maximum(rows, 0)],
                          -1).reshape(len(act), -1)  # [A', E*W]
            valid = nb >= 0
            nb0 = np.where(valid, nb, 0)
            suba = sub[act]
            seen = visited[suba[:, None], nb0] == gen[suba][:, None]
            valid &= ~seen
            # compact to the unvisited entries before touching vectors:
            # typically most neighbor slots were already visited, and the
            # [A, E*W, D] gather would dwarf every other cost
            vr, vc = np.nonzero(valid)
            dd = np.full(nb.shape, np.inf, dtype=np.float32)
            if len(vr):
                flat_slots = nb0[vr, vc]
                # E>1 concatenates several nodes' neighbor lists into one
                # row, so a slot can repeat within this step — the seen
                # stamp can't catch that; keep first occurrences only
                key = vr.astype(np.int64) * self._capacity + flat_slots
                _, first = np.unique(key, return_index=True)
                if len(first) != len(vr):
                    vr, vc = vr[first], vc[first]
                    flat_slots = flat_slots[first]
                visited[suba[vr], flat_slots] = gen[suba[vr]]
                dd[vr, vc] = 1.0 - np.einsum(
                    "nd,nd->n", self._vectors[flat_slots], Qs[act][vr],
                    optimize=True,
                )
            # convergence: a query whose step produced nothing better
            # than its current worst beam entry is done — the classic
            # search's best-candidate > worst-result stop, batched. (A
            # filling beam has +inf padding, so its worst is +inf and it
            # always continues.)
            worst = qd[act].max(axis=1)
            stalled = dd.min(axis=1) >= worst
            md = np.concatenate([qd[act], dd], axis=1)
            ms = np.concatenate([qs[act], nb0], axis=1)
            me = np.concatenate(
                [ea, np.zeros((len(act), nb.shape[1]), dtype=bool)], axis=1
            )
            me |= ~np.isfinite(md)
            sel = np.argpartition(md, ef - 1, axis=1)[:, :ef]
            qd[act] = np.take_along_axis(md, sel, axis=1)
            qs[act] = np.where(
                np.isfinite(qd[act]),
                np.take_along_axis(ms, sel, axis=1), -1,
            )
            newexp = np.take_along_axis(me, sel, axis=1)
            newexp |= stalled[:, None]
            exp[act] = newexp

    # -- delete (tombstones) ----------------------------------------------

    def remove(self, ext_id: str) -> bool:
        with self._lock:
            slot = self._slot_of.pop(ext_id, None)
            if slot is None:
                return False
            self._alive[slot] = False
            self._tombstones += 1
            return True

    # -- query -------------------------------------------------------------

    def search(
        self, query: Sequence[float], k: int = 10, ef: Optional[int] = None
    ) -> List[Tuple[str, float]]:
        q = self._normalize(np.asarray(query, dtype=np.float32))
        with self._lock:
            if self._entry < 0 or not self._slot_of:
                return []
            ef = max(ef or self.ef_search, k)
            # tombstones are filtered from results after the beam, so widen
            # the beam proportionally or k alive survivors may not remain
            if self._tombstones:
                ef = int(ef * (1.0 + 2.0 * self.tombstone_ratio)) + 1
            native = self._native_query(q[None, :], ef)
            if native is not None:
                wd, ws = native
                return self._collect_alive(wd[0, 0], ws[0, 0], k)
            ep = [(float(1.0 - self._vectors[self._entry] @ q), self._entry)]
            for lv in range(self._max_level, 0, -1):
                ep = self._search_layer(q, ep, 1, lv)
            found = self._search_layer(q, ep, ef, 0)
            out = []
            for d, slot in found:
                if not self._alive[slot]:
                    continue
                out.append((self._ext_ids[slot], 1.0 - d))
                if len(out) >= k:
                    break
            return out

    def _native_query(self, Q: np.ndarray, ef: int):
        """Query-time use of the native wave kernel: query_levels=0, so
        the beam is collected at level 0 only after a greedy descent —
        classic HNSW search, same distance evaluations as the Python
        heap path without its interpreter overhead. Caller holds the
        lock. Returns (dists, slots), or None on the Python path."""
        lib = hnsw_native.get_lib()
        if lib is None:
            return None
        n_levels = min(len(self._nbrL), self._max_level + 1)
        if n_levels <= 0:
            return None
        return hnsw_native.wave_search(
            lib, self._vectors, self._nbrL[:n_levels],
            self._cntL[:n_levels],
            np.ascontiguousarray(Q, np.float32),
            np.zeros(len(Q), np.int64), self._entry, ef,
            self._capacity)

    def _collect_alive(self, dists, slots, k: int):
        out = []
        for d, slot in zip(dists.tolist(), slots.tolist()):
            if slot < 0:
                break
            if not self._alive[slot]:
                continue
            out.append((self._ext_ids[slot], 1.0 - d))
            if len(out) >= k:
                break
        return out

    def search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: Optional[int] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Batched queries over the same matrices the builder uses —
        amortizes the per-step Python across the whole batch (the
        throughput path; ``search`` is the latency path)."""
        Q = np.asarray(queries, dtype=np.float32)
        norms = np.linalg.norm(Q, axis=1, keepdims=True)
        Q = Q / np.maximum(norms, 1e-12)
        if len(Q) > self.WAVE_MAX:
            out: List[List[Tuple[str, float]]] = []
            for i in range(0, len(Q), self.WAVE_MAX):
                out.extend(self.search_batch(Q[i: i + self.WAVE_MAX], k, ef))
            return out
        with self._lock:
            if self._entry < 0 or not self._slot_of:
                return [[] for _ in range(len(Q))]
            B = len(Q)
            ef = max(ef or self.ef_search, k)
            if self._tombstones:
                ef = int(ef * (1.0 + 2.0 * self.tombstone_ratio)) + 1
            native = self._native_query(Q, ef)
            if native is not None:
                wd, ws = native
                return [self._collect_alive(wd[j, 0], ws[j, 0], k)
                        for j in range(B)]
            visited, gen = self._visit_scratch(B)
            d0 = 1.0 - Q @ self._vectors[self._entry]
            bd = np.full((B, ef), np.inf, dtype=np.float32)
            bs = np.full((B, ef), -1, dtype=np.int64)
            bd[:, 0] = d0
            bs[:, 0] = self._entry
            allq = np.arange(B)
            for lv in range(self._max_level, -1, -1):
                width = 1 if lv > 0 else ef
                gen += 1
                rd, rs = self._batched_search_layer(
                    Q, bd, bs, allq, width, lv, visited, gen
                )
                bd[:] = np.inf
                bs[:] = -1
                bd[:, : rd.shape[1]] = rd
                bs[:, : rs.shape[1]] = rs
            out: List[List[Tuple[str, float]]] = []
            for r in range(B):
                ok = bs[r] >= 0
                dd, ss = bd[r][ok], bs[r][ok]
                order = np.argsort(dd, kind="stable")
                hits: List[Tuple[str, float]] = []
                for d, slot in zip(dd[order].tolist(), ss[order].tolist()):
                    if not self._alive[slot]:
                        continue
                    hits.append((self._ext_ids[slot], 1.0 - d))
                    if len(hits) >= k:
                        break
                out.append(hits)
            return out

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the graph to ``path`` (``np.savez_compressed`` appends
        ``.npz`` to a path without it)."""
        with self._lock:
            neighbors = np.empty(self._count, dtype=object)
            for slot in range(self._count):
                neighbors[slot] = [self._neighbors_of(slot, lv).tolist()
                                   for lv in range(self._levels[slot] + 1)]
            np.savez_compressed(
                path,
                vectors=self._vectors[: self._count]
                if self._vectors is not None
                else np.zeros((0, 0), np.float32),
                levels=np.asarray(self._levels, dtype=np.int32),
                alive=np.asarray(self._alive, dtype=bool),
                ext_ids=np.asarray([e if e is not None else "" for e in self._ext_ids],
                                   dtype=object),
                neighbors=neighbors,
                meta=np.asarray([self._entry, self._max_level, self.m, self.dims or 0,
                                 self.ef_construction, self.ef_search], dtype=np.int64),
            )

    @classmethod
    def load(cls, path: str) -> "HNSWIndex":
        with np.load(path if path.endswith(".npz") else path + ".npz",
                     allow_pickle=True) as data:
            meta = [int(x) for x in data["meta"]]
            vecs = data["vectors"]
            levels = data["levels"]
            alive = data["alive"]
            ext_ids = data["ext_ids"]
            neighbors = data["neighbors"]
        entry, max_level, m, dims = meta[:4]
        # a 4-field meta predates the persisted beams
        ef_c = meta[4] if len(meta) > 4 else 200
        ef_s = meta[5] if len(meta) > 5 else 64
        idx = cls(dims=dims or None, m=m, ef_construction=ef_c, ef_search=ef_s)
        idx._count = vecs.shape[0]
        idx._capacity = vecs.shape[0]
        idx._vectors = np.ascontiguousarray(vecs, dtype=np.float32)
        idx._levels = [int(x) for x in levels]
        idx._alive = [bool(x) for x in alive]
        idx._ext_ids = [str(e) if e else None for e in ext_ids]
        idx._ensure_level(max(idx._levels, default=0))
        for slot, per_node in enumerate(neighbors):
            for lv, lst in enumerate(per_node):
                idx._set_neighbors(slot, lv, [int(x) for x in lst])
        idx._slot_of = {e: i for i, e in enumerate(idx._ext_ids)
                        if e is not None and idx._alive[i]}
        idx._tombstones = sum(1 for a in idx._alive if not a)
        idx._entry = entry
        idx._max_level = max_level
        return idx
