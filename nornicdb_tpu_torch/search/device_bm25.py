"""Device BM25: batched Okapi scoring over CSR postings on the card
(counterpart of ``nornicdb_tpu/search/device_bm25.py:DeviceBM25``, one
shard).

- **Layout.** The live postings flatten into CSR columns on the device
  (per-term offset ranges, kept on the host, over ``(doc_row, tf)``
  pairs) plus ``doc_len`` and ``alive`` over a capacity-padded row space.
  tf and doc length are integer counts, stored in 16 bits (the bits of a
  uint16) while they stay below 65536, and widened to float32 after the
  gather: lossless.
- **Scoring.** The host plans a batch: each unique query term's posting
  range flattens once into ``(posting, term row)`` entries, and the idf,
  from the index's live df counters, rides a ``[B, U]`` selection
  matrix. The device gathers the postings, applies Okapi in float32,
  writes each (term, doc) cell of a dense ``[U, C]`` matrix once (a
  posting owns its cell, so the write is a plain, deterministic store),
  multiplies by the selection matrix and takes a stable top-k (ties to
  the lower row, as ``lax.top_k``). These are PyTorch ops: the reference
  computes them as jitted XLA, not as a Pallas kernel. The batch and the
  entry columns are not padded to powers of two (that bounds XLA's
  compile cache), so no overflow row is needed; the int32 rule of
  ``PlanOverflow`` still holds, so the same batches degrade.
- **Freshness.** The snapshot records the index's mutation generation.
  Tombstones are filtered per slot (``refresh_alive``; df comes from the
  live counters), adds and updates ride the index's capped changelog
  into an exact host side-scan (read-your-writes), and churn beyond
  ``rebuild_stale_frac`` starts one background rebuild whose snapshot is
  swapped in whole. A trimmed changelog, a compaction or an overflowing
  plan hands the batch to the host index, counted by reason in
  ``events``.
- **Observability.** The reference's lifecycle counter
  (``nornicdb_device_bm25_events_total``), a ``record_dispatch`` of kind
  ``bm25_score`` per device batch with its ``price_bm25`` cost, and
  ``resource_stats`` for ``obs/resources.py``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.obs import REGISTRY, declare_kind, record_dispatch
from nornicdb_tpu_torch.obs import cost as _cost
from nornicdb_tpu_torch.ops.similarity import NEG_INF, pad_dim, topk_stable
from nornicdb_tpu_torch.search.bm25 import B, K1, BM25Index, tokenize
from nornicdb_tpu_torch.search.microbatch import pow2_bucket

_U16_MAX = 65535

# lifecycle and freshness decisions of the device lexical snapshot
_LEX_C = REGISTRY.counter(
    "nornicdb_device_bm25_events_total",
    "Device BM25 snapshot lifecycle and per-search freshness decisions",
    labels=("event",))

declare_kind("bm25_score")


class PlanOverflow(Exception):
    """The (U+1)*C segment-id space of a planned batch would exceed int32
    (the reference's index width). Callers serve the batch host-exact."""


class SnapshotStale(Exception):
    """A compaction remapped the host slot space after this snapshot's
    freshness checks began; callers serve host-exact (a rebuild is due)."""


def _counts16(col: np.ndarray) -> np.ndarray:
    """An integer-count column as the bits of a uint16 in int16 storage
    when every value fits, else float32."""
    if col.size == 0 or float(col.max()) <= _U16_MAX:
        return col.astype(np.uint16).view(np.int16)
    return col.astype(np.float32)


def _widen(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int16:
        return (x.to(torch.int32) & _U16_MAX).to(torch.float32)
    return x


def bm25_dense_scores(
    ptr: torch.Tensor,  # [P] int64 posting per entry
    urow: torch.Tensor,  # [P] int64 unique-term row per entry
    sel: torch.Tensor,  # [B, U] f32 idf-weighted term selection
    post_doc: torch.Tensor,  # [Pcap] int32 doc row per posting
    post_tf: torch.Tensor,  # [Pcap] tf (16-bit counts or f32)
    doc_len: torch.Tensor,  # [C] doc length (16-bit counts or f32)
    alive: torch.Tensor,  # [C] bool
    avgdl: torch.Tensor,  # [] f32 on the device
) -> torch.Tensor:
    """Dense BM25 scores [B, C]; docs no query term touches, and dead
    rows, score NEG_INF. Okapi contributions are positive, so
    ``score > 0`` is the touched mask. ``avgdl`` is a device tensor: CUDA
    divides by a host scalar through its reciprocal, which can round
    differently from the host index's division."""
    u = sel.shape[1]
    c = doc_len.shape[0]
    d = post_doc[ptr].long()
    tf = _widen(post_tf[ptr])
    dl = _widen(doc_len[d])
    tf_norm = tf * (K1 + 1.0) / (tf + K1 * (1.0 - B + B * dl / avgdl))
    m = torch.zeros(u * c, dtype=torch.float32, device=sel.device)
    m.index_put_((urow * c + d,), tf_norm)
    dense = sel @ m.view(u, c)
    return torch.where(alive[None, :] & (dense > 0.0), dense,
                       torch.full_like(dense, NEG_INF))


class DeviceBM25:
    """Batched device BM25 over a wrapped host :class:`BM25Index`, which
    stays the mutable source of truth. Below ``min_n`` live docs, or
    while the first build runs in the background, the host index serves.
    """

    def __init__(
        self,
        bm25: BM25Index,
        min_n: int = 256,
        rebuild_stale_frac: float = 0.1,
        build_inline: bool = True,
        device: DeviceLike = None,
    ):
        self.bm25 = bm25
        self.min_n = min_n
        self.rebuild_stale_frac = rebuild_stale_frac
        # False defers even the first build to a background thread (the
        # serving default); True blocks once (tests)
        self.build_inline = build_inline
        self.device = resolve_device(device)
        self._snap: Optional[Dict[str, Any]] = None
        self._build_lock = threading.Lock()
        self._rebuilding = False
        self._rebuild_started = 0.0  # the open rebuild's start (resource_stats)
        self._rebuild_flag_lock = threading.Lock()
        # per-thread (posting mass, unique terms) of the latest plan():
        # the cost record reads it instead of re-deriving the term stats
        self._plan_cost = threading.local()
        self._alive_lock = threading.Lock()
        self._map_lock = threading.Lock()
        self._delta_cache: Optional[Tuple] = None
        self.builds = 0
        self.build_s = 0.0  # host seconds of the latest build
        self.events: Counter = Counter()  # host hand-offs of search_batch

    # -- build ------------------------------------------------------------

    def build(self) -> bool:
        """(Re)build the device snapshot. False when below ``min_n``."""
        with self._build_lock:
            snap = self._snap
            if snap is not None and snap["built_gen"] == self.bm25.mut_gen:
                return True  # raced another build; already fresh
            t0 = time.perf_counter()
            base = self.bm25.csr_snapshot()
            n = len(base["row_ids"])
            if n < self.min_n:
                self._snap = None
                return False
            c = pad_dim(n)
            doc_len = np.zeros(c, dtype=np.float32)
            doc_len[:n] = base["doc_len"]
            alive = np.zeros(c, dtype=bool)
            alive[:n] = True
            slots = np.full(c, -1, dtype=np.int64)
            slots[:n] = base["slots"]
            dev = self.device
            snap = {
                "n": n,
                "c": c,
                "built_gen": base["gen"],
                "built_compactions": base["compactions"],
                "vocab": base["vocab"],
                "offsets": base["offsets"],
                "post_doc": torch.from_numpy(
                    base["post_doc"].astype(np.int32)).to(dev),
                "post_tf": torch.from_numpy(_counts16(base["post_tf"])).to(dev),
                "doc_len": torch.from_numpy(_counts16(doc_len)).to(dev),
                "alive_np": alive,
                "alive": torch.from_numpy(alive).to(dev),
                "alive_tombstones": base["tombstones"],
                "row_ids": base["row_ids"] + [None] * (c - n),
                "row_of": {e: r for r, e in enumerate(base["row_ids"])},
                "slots": slots,
            }
            if snap["post_tf"].dtype == torch.int16 or snap["doc_len"].dtype == torch.int16:
                _LEX_C.labels("quant_cols").inc()
            self._snap = snap
            self.builds += 1
            self.build_s = time.perf_counter() - t0
            _LEX_C.labels("build").inc()
            return True

    def _kick_background_rebuild(self) -> None:
        with self._rebuild_flag_lock:
            if self._rebuilding:
                return
            self._rebuilding = True
            self._rebuild_started = time.time()
        _LEX_C.labels("background_rebuild").inc()

        def run():
            try:
                self.build()
            finally:
                with self._rebuild_flag_lock:
                    self._rebuilding = False
                    self._rebuild_started = 0.0

        threading.Thread(target=run, name="device-bm25-rebuild",
                         daemon=True).start()

    def ensure_snapshot(self) -> Optional[Dict[str, Any]]:
        """The current snapshot (possibly stale but corrected), or None
        while the host index must serve."""
        snap = self._snap
        if snap is not None:
            churn = self.bm25.mut_gen - snap["built_gen"]
            if churn > self.rebuild_stale_frac * max(snap["n"], 1):
                self._kick_background_rebuild()
            return snap
        if len(self.bm25) < self.min_n:
            return None
        if not self.build_inline:
            self._kick_background_rebuild()
            return self._snap
        self.build()
        return self._snap

    @property
    def snapshot_built(self) -> bool:
        return self._snap is not None

    def device_bytes(self) -> int:
        """Bytes of the snapshot's device columns."""
        snap = self._snap
        if snap is None:
            return 0
        return sum(snap[key].numel() * snap[key].element_size()
                   for key in ("post_doc", "post_tf", "doc_len", "alive"))

    def resource_stats(self) -> Dict[str, Any]:
        """Memory and freshness accounting for obs/resources.py: the CSR
        columns' device bytes, the host offset and slot tables, the
        mutation gap between the live index and the snapshot, and the
        rebuild backlog."""
        snap = self._snap
        started = self._rebuild_started
        return {
            "rows": snap["n"] if snap is not None else 0,
            "capacity": snap["c"] if snap is not None else 0,
            "device_bytes": self.device_bytes(),
            "host_bytes": ((snap["offsets"].nbytes + snap["slots"].nbytes
                            + 8 * len(snap["row_ids"])) if snap is not None else 0),
            "mutation_gap": (self.bm25.mut_gen - snap["built_gen"]) if snap is not None else 0,
            "rebuild_in_flight": 1.0 if self._rebuilding else 0.0,
            "rebuild_backlog_s": (round(time.time() - started, 3)
                                  if self._rebuilding and started else 0.0),
            "builds": self.builds,
        }

    # -- shared snapshot plumbing -----------------------------------------

    def row_map(
        self, snap: Dict[str, Any], name: str, token: int,
        derive: Callable[[Optional[Tuple[int, torch.Tensor]]], Optional[torch.Tensor]],
    ) -> Optional[torch.Tensor]:
        """Memoized ``snapshot row -> foreign row`` device map ``name``:
        ``"l2v"`` joins lexical rows to brute slots (the exact tier),
        ``"l2g"`` to graph rows (the walk tier). The maps live on the
        snapshot (a rebuild drops them), each keyed by ``token``, the
        foreign index's monotone generation (brute mutations, graph build
        sequence). ``derive(prev)`` gets this name's published (token,
        map) or None, and returns the map at ``token`` (a patch of
        ``prev`` or a full derivation), or None when the foreign index
        moved meanwhile."""
        with self._map_lock:
            cur = snap.setdefault("row_maps", {}).get(name)
            if cur is not None and cur[0] == token:
                return cur[1]
        dev = derive(cur)  # outside the lock: up to O(corpus) host work
        if dev is None:
            return None
        with self._map_lock:
            maps = snap["row_maps"]
            cur = maps.get(name)
            if cur is not None and cur[0] == token:
                return cur[1]  # raced another deriver; theirs serves
            if cur is None or cur[0] < token:
                maps[name] = (token, dev)
            return dev

    # -- freshness --------------------------------------------------------

    def refresh_alive(self, snap: Dict[str, Any]) -> None:
        """Re-derive the device alive vector from per-SLOT liveness after
        tombstones (a re-indexed doc tombstones its old slot while its id
        stays live; the new row arrives through the delta side-scan).
        Docs added since the build own no snapshot row, so the vector is
        keyed on the index's tombstone counter, not on every mutation.
        Raises :class:`SnapshotStale` when a compaction remapped slots."""
        tomb = self.bm25.tombstones
        if snap["alive_tombstones"] == tomb:
            return
        with self._alive_lock:
            if snap["alive_tombstones"] == tomb:
                return
            alive = snap["alive_np"].copy()
            rows = np.nonzero(alive)[0]
            if rows.size:
                live = self.bm25.alive_slots(
                    snap["slots"][rows],
                    expect_compactions=snap["built_compactions"])
                if live is None:
                    raise SnapshotStale
                alive[rows] = live
            snap["alive"] = torch.from_numpy(alive).to(self.device)
            snap["alive_tombstones"] = tomb

    def delta_block(self, snap: Dict[str, Any]) -> Optional[List[str]]:
        """ext ids added or updated since the build (exact-scored on the
        host), or None when the changelog no longer reaches back to it.
        Memoized on the mutation counter."""
        m = self.bm25.mut_gen
        cached = self._delta_cache
        if cached is not None and cached[0] == m and cached[1] == snap["built_gen"]:
            return cached[2]
        ids = self.bm25.changed_since(snap["built_gen"])
        self._delta_cache = (m, snap["built_gen"], ids)
        return ids

    # -- planning (host side of a batch) ----------------------------------

    def plan(
        self, snap: Dict[str, Any], token_rows: Sequence[Sequence[str]],
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.float32]:
        """Entry columns (posting, term row), the [B, U] idf-weighted
        selection matrix and the current avgdl for a tokenized batch.
        Terms are deduped across the batch and kept in sorted order (the
        host's accumulation order); idf comes from the live df counters,
        so deletes correct df without a rebuild."""
        vocab = snap["vocab"]
        offsets = snap["offsets"]
        uniq_all = sorted({t for row in token_rows for t in row})
        dfs, n_alive, avgdl = self.bm25.term_stats(uniq_all)
        self._plan_cost.stats = (float(sum(dfs.values())), len(uniq_all))
        n = max(n_alive, 1)
        terms: List[str] = []
        idfs: List[np.float32] = []
        u_of: Dict[str, int] = {}
        for t in uniq_all:
            df = dfs.get(t, 0)
            if df > 0 and t in vocab:
                u_of[t] = len(terms)
                terms.append(t)
                idfs.append(np.float32(math.log(1.0 + (n - df + 0.5) / (df + 0.5))))
        if (pow2_bucket(max(len(terms), 1)) + 1) * snap["c"] > 2**31 - 1:
            raise PlanOverflow
        sel = np.zeros((len(token_rows), len(terms)), dtype=np.float32)
        for qi, row in enumerate(token_rows):
            for t in set(row):
                ui = u_of.get(t)
                if ui is not None:
                    sel[qi, ui] = idfs[ui]
        ptr_parts: List[np.ndarray] = []
        counts: List[int] = []
        for t in terms:
            ti = vocab[t]
            a, b = int(offsets[ti]), int(offsets[ti + 1])
            ptr_parts.append(np.arange(a, b, dtype=np.int64))
            counts.append(b - a)
        ptr = np.concatenate(ptr_parts) if ptr_parts else np.zeros(0, np.int64)
        urow = np.repeat(np.arange(len(terms), dtype=np.int64), counts)
        return ptr, urow, sel, np.float32(avgdl)

    def device_args(self, snap, ptr, urow, sel, avgdl) -> Tuple[torch.Tensor, ...]:
        """A plan's columns on the device, with the snapshot's, in the
        argument order of ``bm25_dense_scores``."""
        dev = self.device
        return (torch.from_numpy(ptr).to(dev), torch.from_numpy(urow).to(dev),
                torch.from_numpy(sel).to(dev), snap["post_doc"],
                snap["post_tf"], snap["doc_len"], snap["alive"],
                torch.tensor(avgdl, dtype=torch.float32, device=dev))

    # -- search -----------------------------------------------------------

    def search_batch(
        self, queries: Sequence[str], k: int = 10
    ) -> List[List[Tuple[str, float]]]:
        """Batched BM25 top-k with the contract of
        :meth:`BM25Index.search_batch`; the host index serves while the
        snapshot is missing and at each freshness rung."""
        queries = list(queries)
        if not queries:
            return []
        snap = self.ensure_snapshot()
        if snap is None:
            return self.bm25.search_batch(queries, k)
        delta = self.delta_block(snap)
        if delta is None:
            self.events["host_changelog"] += 1
            _LEX_C.labels("host_fallback_changelog").inc()
            self._kick_background_rebuild()
            return self.bm25.search_batch(queries, k)
        token_rows = [tokenize(q) for q in queries]
        b = len(queries)
        kb = min(pow2_bucket(max(min(k, snap["n"]), 1)), snap["c"])
        t0 = time.time()
        try:
            self.refresh_alive(snap)
            args = self.device_args(snap, *self.plan(snap, token_rows))
        except SnapshotStale:
            self.events["host_compaction"] += 1
            _LEX_C.labels("host_fallback_compaction").inc()
            self._kick_background_rebuild()
            return self.bm25.search_batch(queries, k)
        except PlanOverflow:
            self.events["host_overflow"] += 1
            _LEX_C.labels("host_fallback_overflow").inc()
            return self.bm25.search_batch(queries, k)
        s, i = topk_stable(bm25_dense_scores(*args), kb)
        s, i = s.cpu().numpy(), i.cpu().numpy()  # to the host inside the timed window
        record_dispatch("bm25_score", pow2_bucket(b), kb, time.time() - t0)
        # the batch's unique-term posting mass (each scattered once) plus
        # the [B, U] x [U, C] idf-weighted product, at the B rows run
        if _cost.pricing_enabled():
            nnz, u = self._plan_cost.stats
            flops, byts = _cost.price_bm25(b, nnz, u, snap["c"])
            _cost.record_query_cost("bm25_score", _cost.cost_name(self), b, flops, byts)
        out = self._resolve(snap, s, i, min(k, kb))
        if delta:
            self.events["delta_merge"] += 1
            _LEX_C.labels("delta_merge").inc()
            out = self._merge_delta(out, delta, token_rows, k)
        return out

    @staticmethod
    def _resolve(snap, s, i, k_eff):
        row_ids = snap["row_ids"]
        out: List[List[Tuple[str, float]]] = []
        for r in range(s.shape[0]):
            hits: List[Tuple[str, float]] = []
            for c in range(s.shape[1]):
                if s[r, c] < 0.5 * NEG_INF:
                    break
                eid = row_ids[int(i[r, c])]
                if eid is None:
                    continue
                hits.append((eid, float(s[r, c])))
                if len(hits) >= k_eff:
                    break
            out.append(hits)
        return out

    def _merge_delta(self, rows, delta_ids, token_rows, k):
        """Exact host scores of docs indexed since the build, merged in
        (read-your-writes). An updated doc's old row died in the alive
        refresh; any same-id device entry is dropped all the same. The
        stable sort keeps device-rank order on exact ties."""
        dset = set(delta_ids)
        out: List[List[Tuple[str, float]]] = []
        for qi, hits in enumerate(rows):
            fresh = self.bm25.score_docs(token_rows[qi], delta_ids)
            merged = [(eid, sc) for eid, sc in hits if eid not in dset]
            merged.extend(sorted(fresh.items()))
            merged.sort(key=lambda kv: -kv[1])
            out.append(merged[:k])
        return out
