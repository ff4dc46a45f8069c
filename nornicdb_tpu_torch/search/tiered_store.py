"""Tiered vector storage: cluster-routed demand paging (counterpart of
``nornicdb_tpu/search/tiered_store.py``, one device).

- **Partitions.** ``ops/kmeans.py:kmeans_fit`` clusters the corpus on the
  card, one partition per centroid; every partition spills at build to
  the disk store (``storage/partition_store.py``): slots, ext ids,
  float32 rows and PQ codes.
- **Residency.** The card holds the PQ codes of at most ``resident_max``
  partitions in fixed slabs (one pow2-padded slab each), so residency
  churn never changes a shape. The float32 rows stay on the host (the
  brute index, read by ``rows_for_slots``); cold partitions stay on disk
  until the background pager promotes them (LRU eviction).
- **Routing.** Each query scores the centroids on the host, plus a flat
  bonus for partitions that hold its BM25 top docs (``lex_hints``), and
  probes its best ``nprobe``. Resident probes run as one masked slab ADC
  (``_tiered_topk_impl``) with an exact host rerank; cold probes are
  scanned exactly on the host (``cold_scan``) and queued for promotion.
- **Freshness.** A mutation-generation snapshot of its brute index:
  writes since the build are scored exactly from the changelog, deletes
  are filtered at the rerank gather. The named gaps (not built yet, a
  compaction, a changelog overrun, a rerank race, an under-filled answer,
  a promotion or eviction landing while a batch was in flight:
  ``paging_race``) return None, so the quant or float32 rung serves,
  each counted in ``counts``; any other error propagates (ROADMAP C23).

Every knob is read once, when ``BruteForceIndex.tiered_plane`` creates the
plane. The pager's background admission lane and the cost records wait
for ROADMAP §A12.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.config import env_bool, env_int
from nornicdb_tpu_torch.ops.kmeans import kmeans_fit
from nornicdb_tpu_torch.ops.similarity import NEG_INF, l2_normalize, pad_dim
from nornicdb_tpu_torch.search.device_quant import (
    _chunked_topk,
    _pq_adc_scores,
    encode_pq_t,
    rank_candidates,
    train_pq,
    usable_ids,
)
from nornicdb_tpu_torch.search.microbatch import pow2_bucket
from nornicdb_tpu_torch.storage.partition_store import PartitionStore

_BUILD_SEQ = itertools.count(1)

# Partitions probed per query, the reference's default
# (NORNICDB_TIERED_NPROBE sets it when the plane is created).
TIERED_NPROBE = 8


def tiered_enabled() -> bool:
    """NORNICDB_VECTOR_TIERED=1 turns the tiered plane on; default off."""
    return env_bool("VECTOR_TIERED", False)


def tiered_min_n() -> int:
    """Corpus floor below which the tiered plane never engages."""
    return max(1, env_int("TIERED_MIN_N", 4096))


def _tiered_topk_impl(qn, codes_t, codebooks, valid, sel, k):
    """Partition-masked ADC top-k over the resident slabs: ``codes_t``
    ``[M, R*S]`` (R slabs of S slots), ``sel`` the per-query ``[B, R]``
    probe mask. The whole slab array is scored, then masked to each
    query's slabs."""
    c = valid.shape[0]
    mask = torch.repeat_interleave(sel, c // sel.shape[1], dim=1) & valid[None, :]
    return _chunked_topk(lambda lo, hi: _pq_adc_scores(qn, codes_t, codebooks, lo, hi),
                         mask, c, c, min(k, c))


class TieredStore:
    """Cluster-partitioned tiered serving plane over a ``BruteForceIndex``,
    on the index's device.

    ``counts``: ``build``, ``background_rebuild``, ``dispatch``,
    ``delta_merge``, ``cold_scan``, ``promote``, ``promote_miss`` and
    ``evict`` per event; ``degrade_<reason>`` per batch handed down at a
    named gap. ``build_s`` splits the latest build (``snapshot``,
    ``kmeans``, ``codebooks``, ``encode``, ``spill``, ``upload``,
    ``total``)."""

    def __init__(
        self,
        brute,
        nprobe: int = TIERED_NPROBE,
        parts: int = 0,
        resident_max: int = 0,
        part_rows: int = 4096,
        lex_bonus: float = 0.15,
        min_n: Optional[int] = None,
        rebuild_stale_frac: float = 0.1,
        build_inline: bool = False,
        pq_m: Optional[int] = None,
        pq_codes: int = 256,
        overfetch: int = 8,
        min_pool: int = 128,
        root_dir: Optional[str] = None,
    ):
        self.brute = brute
        self.device = brute.device
        self.nprobe = max(1, nprobe)
        self.parts = max(0, parts)  # 0: from part_rows
        self.resident_max = max(0, resident_max)  # 0: all resident
        self.part_rows = max(256, part_rows)
        self.lex_bonus = float(lex_bonus)
        self.min_n = tiered_min_n() if min_n is None else max(1, min_n)
        self.rebuild_stale_frac = rebuild_stale_frac
        self.build_inline = build_inline
        self.pq_m = pq_m
        self.pq_codes = pq_codes
        self.overfetch = max(1, overfetch)
        self.min_pool = max(1, min_pool)
        self.store = PartitionStore(root_dir)
        self._snap: Optional[Dict[str, Any]] = None
        self._build_lock = threading.Lock()
        self._rebuilding = False
        self._rebuild_flag_lock = threading.Lock()
        # the resident map, slab tables and residency generation move
        # together under this lock
        self._res_lock = threading.Lock()
        self._page_pending: Set[int] = set()
        self._paging = False
        self._page_lock = threading.Lock()
        self.builds = 0
        self.promotions = 0
        self.evictions = 0
        self.cold_scans = 0
        self.build_s: Dict[str, float] = {}
        self.counts: Counter = Counter()

    # -- build ------------------------------------------------------------

    def _pq_m_for(self, d: int) -> int:
        m = self.pq_m or max(4, min(64, d // 4))
        while m > 1 and d % m != 0:
            m -= 1
        return max(1, m)

    def _n_parts_for(self, n_alive: int) -> int:
        if self.parts:
            return max(2, self.parts)
        return max(2, min(128, n_alive // self.part_rows))

    def build(self) -> bool:
        with self._build_lock:
            return self._build_locked()

    def _build_locked(self) -> bool:
        brute = self.brute
        mutations = brute.mutations
        snap = self._snap
        if snap is not None and snap["built_mutations"] == mutations:
            return True  # raced another builder
        t0 = time.perf_counter()
        matrix, valid, ext_ids = brute.snapshot()
        n_alive = int(valid.sum())
        if n_alive < self.min_n:
            self._snap = None
            return False
        cap, d = matrix.shape
        dev = self.device
        t1 = time.perf_counter()
        res = kmeans_fit(matrix, k=self._n_parts_for(n_alive), valid=valid, seed=0, device=dev)
        t2 = time.perf_counter()
        assign = res.assignments  # -1 for dead and pad slots
        k_parts = res.centroids.shape[0]
        part_slots = [np.nonzero(assign == pid)[0].astype(np.int64) for pid in range(k_parts)]
        slab_rows = pad_dim(max(max((len(s) for s in part_slots), default=1), 1))
        r_slabs = min(k_parts, self.resident_max) if self.resident_max else k_parts
        m = self._pq_m_for(d)
        codebooks = train_pq(matrix[valid] if n_alive < cap else matrix, m, self.pq_codes,
                             device=dev)
        t3 = time.perf_counter()
        codebooks_t = torch.from_numpy(codebooks).to(dev)
        codes_all = encode_pq_t(matrix, codebooks_t).T.cpu().numpy()  # [cap, M]
        t4 = time.perf_counter()
        pid_of_ext: Dict[str, int] = {}
        for pid, slots in enumerate(part_slots):
            for s in slots:
                eid = ext_ids[int(s)]
                if eid is not None:
                    pid_of_ext[eid] = pid
        # every partition spills: the cold tier, read back by promotions
        for pid, slots in enumerate(part_slots):
            self.store.save_partition(pid, slots, [ext_ids[int(s)] or "" for s in slots],
                                      matrix[slots], codes_all[slots])
        t5 = time.perf_counter()
        snap = {
            "capacity": cap, "dims": d, "rows": n_alive, "parts": k_parts,
            "slab_rows": slab_rows, "r_slabs": r_slabs, "pq_m": m,
            "pq_codes": self.pq_codes, "codebooks": codebooks_t,
            "centroids": np.asarray(res.centroids, dtype=np.float32),
            "part_slots": part_slots, "pid_of_ext": pid_of_ext,
            "built_mutations": mutations, "built_compactions": brute.compactions,
            "build_seq": next(_BUILD_SEQ),
            # residency state, under _res_lock once published
            "resident": {}, "slab_pid": [-1] * r_slabs,
            "slab_slots": np.full((r_slabs, slab_rows), -1, dtype=np.int64),
            "lru": [], "residency_gen": 0,
        }
        codes_slab = np.zeros((r_slabs * slab_rows, m), dtype=np.uint8)
        slab_valid = np.zeros((r_slabs * slab_rows,), dtype=bool)
        # largest partitions resident first: they carry the most probe mass
        order = sorted(range(k_parts), key=lambda p: -len(part_slots[p]))[:r_slabs]
        for slab_idx, pid in enumerate(order):
            slots = part_slots[pid]
            lo = slab_idx * slab_rows
            codes_slab[lo: lo + len(slots)] = codes_all[slots]
            slab_valid[lo: lo + len(slots)] = True
            snap["slab_slots"][slab_idx, :len(slots)] = slots
            snap["resident"][pid] = slab_idx
            snap["slab_pid"][slab_idx] = pid
            snap["lru"].append(pid)
        snap["codes_t"] = torch.from_numpy(np.ascontiguousarray(codes_slab.T)).to(dev)
        snap["slab_valid"] = torch.from_numpy(slab_valid).to(dev)
        snap["device_bytes"] = (r_slabs * slab_rows * m + r_slabs * slab_rows
                                + int(codebooks.nbytes))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t6 = time.perf_counter()
        self._snap = snap
        self.builds += 1
        self.build_s = {"snapshot": t1 - t0, "kmeans": t2 - t1, "codebooks": t3 - t2,
                        "encode": t4 - t3, "spill": t5 - t4, "upload": t6 - t5,
                        "total": t6 - t0}
        self.counts["build"] += 1
        return True

    def _kick_background_rebuild(self) -> None:
        with self._rebuild_flag_lock:
            if self._rebuilding:
                return
            self._rebuilding = True
        self.counts["background_rebuild"] += 1

        def run():
            try:
                self.build()
            finally:
                with self._rebuild_flag_lock:
                    self._rebuilding = False

        threading.Thread(target=run, name="tiered-rebuild", daemon=True).start()

    def ensure(self) -> Optional[Dict[str, Any]]:
        """The current snapshot under the rebuild policy, or None while a
        lower rung must serve."""
        snap = self._snap
        if snap is not None:
            churn = self.brute.mutations - snap["built_mutations"]
            if churn > self.rebuild_stale_frac * max(snap["rows"], 1):
                self._kick_background_rebuild()
            return snap
        if not self.build_inline:
            self._kick_background_rebuild()
            return self._snap
        self.build()
        return self._snap

    @property
    def plane_built(self) -> bool:
        return self._snap is not None

    # -- residency and paging ---------------------------------------------

    def _install_partition_locked(self, snap: Dict[str, Any], pid: int) -> bool:
        """Promote one partition into a slab (``_res_lock`` held): a free
        slab, else the LRU partition's. False when its payload cannot be
        read back (it stays cold; the host scan answers for it)."""
        if pid in snap["resident"]:
            return True
        payload = self.store.load_partition(pid)
        if payload is None:
            self.counts["promote_miss"] += 1
            return False
        slab_rows = snap["slab_rows"]
        slab_idx = next((i for i, owner in enumerate(snap["slab_pid"]) if owner < 0), None)
        if slab_idx is None:
            victim = snap["lru"].pop(0)
            slab_idx = snap["resident"].pop(victim)
            self.evictions += 1
            self.counts["evict"] += 1
        lo = slab_idx * slab_rows
        n_p = len(payload["slots"])
        codes = np.zeros((slab_rows, snap["pq_m"]), dtype=np.uint8)
        codes[:n_p] = payload["codes"]
        vmask = np.zeros((slab_rows,), dtype=bool)
        vmask[:n_p] = True
        # new arrays: a batch in flight keeps the ones it captured, and the
        # residency_gen recheck sees the swap
        codes_t = snap["codes_t"].clone()
        codes_t[:, lo: lo + slab_rows] = torch.from_numpy(
            np.ascontiguousarray(codes.T)).to(self.device)
        slab_valid = snap["slab_valid"].clone()
        slab_valid[lo: lo + slab_rows] = torch.from_numpy(vmask).to(self.device)
        snap["codes_t"], snap["slab_valid"] = codes_t, slab_valid
        snap["slab_slots"][slab_idx] = -1
        snap["slab_slots"][slab_idx, :n_p] = payload["slots"]
        snap["resident"][pid] = slab_idx
        snap["slab_pid"][slab_idx] = pid
        snap["lru"].append(pid)
        snap["residency_gen"] += 1
        self.promotions += 1
        self.counts["promote"] += 1
        return True

    def promote_inline(self, pids: Sequence[int]) -> int:
        """Synchronous promotion: how many partitions were installed."""
        snap = self._snap
        if snap is None:
            return 0
        done = 0
        with self._res_lock:
            for pid in pids:
                if 0 <= pid < snap["parts"] and self._install_partition_locked(snap, pid):
                    done += 1
        return done

    def _kick_promote(self, pids: Sequence[int]) -> None:
        """Queue cold partitions; one pager thread drains the set."""
        with self._page_lock:
            self._page_pending.update(int(p) for p in pids)
            if self._paging or not self._page_pending:
                return
            self._paging = True

        def run():
            try:
                while True:
                    with self._page_lock:
                        if not self._page_pending:
                            self._paging = False
                            return
                        pid = self._page_pending.pop()
                    self.promote_inline([pid])
            except BaseException:
                with self._page_lock:
                    self._paging = False
                raise

        threading.Thread(target=run, name="tiered-pager", daemon=True).start()

    @property
    def paging(self) -> bool:
        """True while the pager has partitions to promote."""
        with self._page_lock:
            return self._paging

    # -- routing ----------------------------------------------------------

    def route(self, qn: np.ndarray, snap: Dict[str, Any],
              lex_hints: Optional[Sequence[Optional[Sequence[str]]]] = None) -> np.ndarray:
        """Per-query probe set [B, nprobe], best first (score descending,
        partition ascending): query-centroid cosine plus ``lex_bonus`` for
        each partition owning one of the query's BM25 top docs."""
        scores = qn @ snap["centroids"].T  # [B, K]
        if lex_hints is not None:
            pid_of_ext = snap["pid_of_ext"]
            for i, hints in enumerate(lex_hints):
                if not hints or i >= scores.shape[0]:
                    continue
                for eid in hints:
                    pid = pid_of_ext.get(eid)
                    if pid is not None:
                        scores[i, pid] += self.lex_bonus
        nprobe = min(self.nprobe, snap["parts"])
        probe = np.argpartition(-scores, nprobe - 1, axis=1)[:, :nprobe]
        row_scores = np.take_along_axis(scores, probe, axis=1)
        order = np.lexsort((probe, -row_scores), axis=1)
        return np.take_along_axis(probe, order, axis=1)

    def pool_for(self, k: int, snap: Dict[str, Any]) -> int:
        """ADC rerank pool: max(overfetch * k, min_pool, slab capacity /
        n_codes), pow2-bucketed, at most the slab capacity."""
        slab_cap = snap["r_slabs"] * snap["slab_rows"]
        floor = max(k * self.overfetch, self.min_pool, slab_cap // min(snap["pq_codes"], 256))
        return min(pow2_bucket(floor), slab_cap)

    def resource_stats_extra(self) -> Dict[str, Any]:
        """Partitions, residency, device slab bytes, disk bytes, and the
        capacity ratio against all-device float32."""
        snap = self._snap
        if snap is None:
            return {"partitions": 0, "resident_partitions": 0, "tiered_device_bytes": 0,
                    "disk_bytes": self.store.disk_bytes()}
        with self._res_lock:
            resident = len(snap["resident"])
        dev_b = snap["device_bytes"]
        return {
            "partitions": snap["parts"],
            "resident_partitions": resident,
            "tiered_device_bytes": dev_b,
            "disk_bytes": self.store.disk_bytes(),
            "tiered_capacity_ratio": round(snap["capacity"] * snap["dims"] * 4 / max(dev_b, 1), 3),
            "promotions": self.promotions,
            "evictions": self.evictions,
            "cold_scans": self.cold_scans,
        }

    # -- serving ----------------------------------------------------------

    def search_batch(
        self, queries: np.ndarray, k: int = 10,
        lex_hints: Optional[Sequence[Optional[Sequence[str]]]] = None,
    ) -> Optional[List[List[Tuple[str, float]]]]:
        """Cluster-routed coarse-then-exact batched search, or None when a
        lower rung must serve this batch. Every answered score is an exact
        float32 cosine of a live row."""
        brute = self.brute
        snap = self.ensure()
        if snap is None:
            self.counts["degrade_pending_build"] += 1
            return None
        if snap["built_compactions"] != brute.compactions:
            return self._degrade("compaction", rebuild=True)
        delta = brute.changed_since(snap["built_mutations"])
        if delta is None:
            return self._degrade("changelog_overrun", rebuild=True)
        n_alive = len(brute)
        if n_alive == 0:
            return [[] for _ in range(len(queries))]
        k_eff = min(k, n_alive)
        b = len(queries)
        pool = self.pool_for(k, snap)
        qn_t = l2_normalize(torch.from_numpy(np.array(queries, np.float32)).to(self.device))
        qn = qn_t.cpu().numpy()
        probe = self.route(qn, snap, lex_hints)

        # one consistent residency view: probe mask, slab table, generation
        r_slabs = snap["r_slabs"]
        cold_need: List[Set[int]] = [set() for _ in range(b)]
        sel = np.zeros((b, r_slabs), dtype=bool)
        with self._res_lock:
            gen0 = snap["residency_gen"]
            codes_t, slab_valid = snap["codes_t"], snap["slab_valid"]
            slab_slots = snap["slab_slots"].copy()
            resident = dict(snap["resident"])
            for i in range(b):
                for pid in probe[i]:
                    slab = resident.get(int(pid))
                    if slab is None:
                        cold_need[i].add(int(pid))
                    else:
                        sel[i, slab] = True
            touched = {int(p) for row in probe for p in row if int(p) in resident}
            if touched:  # LRU: probed partitions move to the back
                snap["lru"] = ([p for p in snap["lru"] if p not in touched]
                               + [p for p in snap["lru"] if p in touched])

        s = slots = None
        if sel.any():
            s_t, cells = _tiered_topk_impl(qn_t.contiguous(), codes_t, snap["codebooks"],
                                           slab_valid, torch.from_numpy(sel).to(self.device),
                                           pool)
            s, cells = s_t.cpu().numpy(), cells.cpu().numpy()
            with self._res_lock:
                raced = snap["residency_gen"] != gen0
            if raced:
                # a promotion or eviction landed while the batch was in flight
                return self._degrade("paging_race")
            slots = slab_slots.reshape(-1)[cells]
            slots[s < 0.5 * NEG_INF] = -1

        # exact delta side-scan: adds and updates since the build
        d_ids, d_mat = brute.delta_vectors(delta) if delta else ([], None)
        d_set = set(d_ids)

        # exact rerank of the resident pool on the host's current rows
        exact_u = None
        if slots is not None:
            uniq = np.unique(slots[slots >= 0])
            if uniq.size:
                got = brute.rows_for_slots(uniq, expect_compactions=snap["built_compactions"])
                if got is None:
                    return self._degrade("rerank_race")
                rows_u, alive_u, ids_u = got
                exact_u = qn @ rows_u.T
                inv = np.searchsorted(uniq, np.clip(slots, 0, None))
                ok_u = usable_ids(ids_u, alive_u, d_set)
                ids_u = np.asarray(ids_u, dtype=object)

        # cold partitions: an exact host scan of their current rows, and
        # their promotion queued
        cold_pids = sorted({p for need in cold_need for p in need})
        cold_scores = None
        if cold_pids:
            self.cold_scans += 1
            self.counts["cold_scan"] += 1
            cold_slots = np.concatenate([snap["part_slots"][p] for p in cold_pids])
            cold_pid_of = np.concatenate([np.full(len(snap["part_slots"][p]), p, dtype=np.int64)
                                          for p in cold_pids])
            got = brute.rows_for_slots(cold_slots, expect_compactions=snap["built_compactions"])
            if got is None:
                return self._degrade("rerank_race")
            cold_rows, cold_alive, cold_ids = got
            cold_scores = qn @ cold_rows.T
            cold_ok = usable_ids(cold_ids, cold_alive, d_set)
            cold_ids = np.asarray(cold_ids, dtype=object)
            self._kick_promote(cold_pids)

        d_scores = qn @ d_mat.T if d_ids else np.zeros((b, 0), np.float32)
        d_eids = np.asarray(d_ids, dtype=object)
        d_slots = snap["capacity"] + np.arange(len(d_ids))
        out: List[List[Tuple[str, float]]] = []
        for r in range(b):
            # resident pool, the query's cold partitions, the delta: the
            # three are disjoint (a row lives in one partition; delta ids
            # are dropped from the other two)
            eids, scores, cand_slots = [d_eids], [d_scores[r]], [d_slots]
            if exact_u is not None:
                j = inv[r][(s[r] >= 0.5 * NEG_INF) & (slots[r] >= 0)]
                j = j[ok_u[j]]
                eids.append(ids_u[j])
                scores.append(exact_u[r, j])
                cand_slots.append(uniq[j])
            if cold_scores is not None and cold_need[r]:
                m = np.isin(cold_pid_of, list(cold_need[r])) & cold_ok
                eids.append(cold_ids[m])
                scores.append(cold_scores[r, m])
                cand_slots.append(cold_slots[m])
            out.append(rank_candidates(np.concatenate(eids), np.concatenate(scores),
                                       np.concatenate(cand_slots), k_eff))
        if any(len(hits) < k_eff for hits in out):
            # clustered deletes, or a probe set that ran dry
            return self._degrade("underfill")
        self.counts["dispatch"] += 1
        if d_ids:
            self.counts["delta_merge"] += 1
        return out

    def _degrade(self, reason: str, rebuild: bool = False) -> None:
        self.counts["degrade_" + reason] += 1
        if rebuild:
            self._kick_background_rebuild()
        return None

    def close(self) -> None:
        """Wait for the pager, and drop the spill directory when the store
        created it."""
        while self.paging:
            time.sleep(0.01)
        self.store.close()
