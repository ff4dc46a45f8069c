"""Device BM25: batched Okapi scoring over CSR postings on the card
(counterpart of ``nornicdb_tpu/search/device_bm25.py:DeviceBM25``, its
one-shard program and its sharded layout's single-device loop).

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
- **Shards.** With ``n_shards`` > 1 (``NORNICDB_HYBRID_SHARDS`` through
  the fused tier) the snapshot takes the reference's row-sharded layout
  (``shard_layout``) and a batch is scored shard by shard, each shard's
  top-k made global and merged in shard order (``topk_shards``, through
  ``ops/similarity.py:concat_topk``): the reference's loop for more
  shards than devices, which its mesh path matches bitwise. With at least
  as many devices as shards (``parallel/mesh.py:mesh_members``) the build
  places shard ``i``'s columns on member device ``i`` once, and a batch is
  scored one shard a member (``topk_mesh``, the reference's
  ``_sharded_bm25_impl``): only the plan goes in and the ``[B, k]`` blocks
  come out.
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
  ``resource_stats`` for ``obs/resources.py``. A background rebuild runs
  on the background admission lane.
"""

from __future__ import annotations

import math
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch import admission as _adm
from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.obs import REGISTRY, declare_kind, record_dispatch
from nornicdb_tpu_torch.obs import cost as _cost
from nornicdb_tpu_torch.ops.similarity import NEG_INF, concat_topk, pad_dim, topk_stable
from nornicdb_tpu_torch.parallel.mesh import (
    layout_members,
    merge_members,
    mesh_members,
    place_rows,
    run_members,
    sync_members,
    to_member,
)
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


def shard_layout(base: Dict[str, Any], s_n: int) -> Dict[str, Any]:
    """The host arrays of a snapshot of ``s_n`` row shards over a
    ``csr_snapshot`` (the reference's layout, ``device_bm25.py:251-310``):
    shard ``sh`` holds rows ``[sh * base_rows, (sh + 1) * base_rows)`` with
    ``base_rows = ceil(n / s_n)``, at ``sh * c_local`` with ``c_local =
    pad_dim(base_rows)``; every term's (ascending-row) posting range is
    split at the shard edges, its rows made shard-local, and each shard's
    postings padded to one ``p_cap``. A last shard may be empty. One shard
    keeps its postings unpadded."""
    n = len(base["row_ids"])
    offsets, post_doc, post_tf = base["offsets"], base["post_doc"], base["post_tf"]
    base_rows = -(-n // s_n)
    c_local = pad_dim(base_rows)
    if s_n == 1:
        off_sh = offsets[None, :]
        p_cap = len(post_doc)
        pd_all = post_doc.astype(np.int32)
        pt_all = post_tf
    else:
        n_terms = len(offsets) - 1
        off_sh = np.zeros((s_n, n_terms + 1), dtype=np.int64)
        doc_lists: List[List[np.ndarray]] = [[] for _ in range(s_n)]
        tf_lists: List[List[np.ndarray]] = [[] for _ in range(s_n)]
        edges = np.arange(s_n + 1, dtype=np.int64) * base_rows
        for ti in range(n_terms):
            lo, hi = offsets[ti], offsets[ti + 1]
            docs = post_doc[lo:hi]
            bounds = np.searchsorted(docs, edges)
            for sh in range(s_n):
                a, b = bounds[sh], bounds[sh + 1]
                doc_lists[sh].append(docs[a:b] - sh * base_rows)
                tf_lists[sh].append(post_tf[lo + a:lo + b])
                off_sh[sh, ti + 1] = off_sh[sh, ti] + (b - a)
        doc_parts = [np.concatenate(d) if d else np.zeros(0, np.int32) for d in doc_lists]
        tf_parts = [np.concatenate(t) if t else np.zeros(0, np.float32) for t in tf_lists]
        p_cap = pad_dim(max(max(len(d) for d in doc_parts), 1))
        pd_all = np.zeros((s_n, p_cap), dtype=np.int32)
        pt_all = np.zeros((s_n, p_cap), dtype=np.float32)
        for sh in range(s_n):
            pd_all[sh, :len(doc_parts[sh])] = doc_parts[sh]
            pt_all[sh, :len(tf_parts[sh])] = tf_parts[sh]
        pd_all, pt_all = pd_all.reshape(-1), pt_all.reshape(-1)
    c = s_n * c_local
    doc_len = np.zeros(c, dtype=np.float32)
    alive = np.zeros(c, dtype=bool)
    slots = np.full(c, -1, dtype=np.int64)
    row_ids: List[Optional[str]] = [None] * c
    for sh in range(s_n):
        lo, hi = sh * base_rows, min((sh + 1) * base_rows, n)
        if lo >= hi:
            continue
        at = slice(sh * c_local, sh * c_local + hi - lo)
        doc_len[at] = base["doc_len"][lo:hi]
        alive[at] = True
        slots[at] = base["slots"][lo:hi]
        row_ids[at] = base["row_ids"][lo:hi]
    return {"shards": s_n, "c_local": c_local, "c": c, "p_cap": p_cap, "off_sh": off_sh,
            "post_doc": pd_all, "post_tf": pt_all, "doc_len": doc_len, "alive_np": alive,
            "slots": slots, "row_ids": row_ids}


def shard_args(snap: Dict[str, Any], args: Sequence, sh: int) -> Tuple:
    """Shard ``sh``'s part of ``DeviceBM25.device_args``'s columns, in the
    argument order of ``bm25_dense_scores``: its planned entries and its
    postings, doc lengths and alive flags, all shard-local. A snapshot
    placed on a mesh holds one block a shard on its member; the loop reads
    it on its own device."""
    ptr, urow, sel, post_doc, post_tf, doc_len, alive, avgdl = args
    if "members" in snap:
        cols = (post_doc[sh], post_tf[sh], doc_len[sh], alive[sh])
        return (ptr[sh], urow[sh], sel, *(x.to(sel.device) for x in cols), avgdl)
    posts = slice(sh * snap["p_cap"], (sh + 1) * snap["p_cap"])
    rows = slice(sh * snap["c_local"], (sh + 1) * snap["c_local"])
    return (ptr[sh], urow[sh], sel, post_doc[posts], post_tf[posts], doc_len[rows],
            alive[rows], avgdl)


def member_args(snap: Dict[str, Any], plan: Tuple, m: int, dev: torch.device) -> Tuple:
    """Member ``m``'s arguments of ``bm25_dense_scores`` on its device
    ``dev``: the host plan's entry columns for its shard, the batch's
    selection matrix and avgdl, uploaded on the member's stream, and its
    placed columns."""
    ptr, urow, sel, avgdl = plan
    cols = (to_member(snap[key][m], dev) for key in ("post_doc", "post_tf", "doc_len", "alive"))
    return (torch.from_numpy(ptr[m]).to(dev), torch.from_numpy(urow[m]).to(dev),
            torch.from_numpy(sel).to(dev), *cols,
            torch.tensor(avgdl, dtype=torch.float32, device=dev))


def topk_mesh(snap: Dict[str, Any], plan: Tuple, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded layout on its mesh (the reference's
    ``_sharded_bm25_impl``): each member's top ``min(k, c_local)`` of its
    own rows, made global at ``m * c_local``, merged in member order; the
    same operations as ``topk_shards``, so the same bits."""
    c_local = snap["c_local"]
    k_local = min(k, c_local)

    def local(m, dev):
        s, i = topk_stable(bm25_dense_scores(*member_args(snap, plan, m, dev)), k_local)
        return s, i + m * c_local

    return merge_members(run_members("bm25", snap["members"], local), k)


def _nbytes(x) -> int:
    if isinstance(x, list):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size()


def topk_shards(snap: Dict[str, Any], args: Sequence, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded layout's loop on one device (the reference's
    ``_topk_shards_single_device``): each shard's top ``min(k, c_local)``
    of its own rows, made global at ``sh * c_local``, merged in shard
    order by ``concat_topk``."""
    c_local = snap["c_local"]
    parts_s, parts_i = [], []
    for sh in range(snap["shards"]):
        s, i = topk_stable(bm25_dense_scores(*shard_args(snap, args, sh)), min(k, c_local))
        parts_s.append(s)
        parts_i.append(i + sh * c_local)
    return concat_topk(parts_s, parts_i, k)


class DeviceBM25:
    """Batched device BM25 over a wrapped host :class:`BM25Index`, which
    stays the mutable source of truth. Below ``min_n`` live docs, or
    while the first build runs in the background, the host index serves.
    ``n_shards`` > 1 lays the snapshot out in row shards (``shard_layout``),
    scored shard by shard and merged (``topk_shards``), or one shard a
    member device when there are as many (``topk_mesh``).
    """

    def __init__(
        self,
        bm25: BM25Index,
        n_shards: int = 1,
        min_n: int = 256,
        rebuild_stale_frac: float = 0.1,
        build_inline: bool = True,
        device: DeviceLike = None,
    ):
        self.bm25 = bm25
        self.n_shards = max(1, n_shards)
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
            snap = shard_layout(base, self.n_shards)
            dev = self.device
            row_ids = snap["row_ids"]
            cols = {"post_doc": snap["post_doc"], "post_tf": _counts16(snap["post_tf"]),
                    "doc_len": _counts16(snap["doc_len"]), "alive": snap["alive_np"]}
            if cols["post_tf"].dtype == np.int16 or cols["doc_len"].dtype == np.int16:
                _LEX_C.labels("quant_cols").inc()
            members = mesh_members(self.n_shards, dev)
            if members is not None:
                # placed once: shard i's columns on member i
                cols = {key: place_rows(col, members) for key, col in cols.items()}
                sync_members(members)
                snap["members"] = members
            else:
                cols = {key: torch.from_numpy(col).to(dev) for key, col in cols.items()}
            snap.update(
                cols,
                n=n,
                built_gen=base["gen"],
                built_compactions=base["compactions"],
                vocab=base["vocab"],
                alive_tombstones=base["tombstones"],
                row_of={e: r for r, e in enumerate(row_ids) if e is not None},
            )
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
                # the background lane: a coalescer ride from this thread
                # seals behind interactive work
                with _adm.lane_scope(_adm.LANE_BACKGROUND):
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
        """Bytes of the snapshot's device columns (on every member)."""
        snap = self._snap
        if snap is None:
            return 0
        return sum(_nbytes(snap[key]) for key in ("post_doc", "post_tf", "doc_len", "alive"))

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
            "host_bytes": ((snap["off_sh"].nbytes + snap["slots"].nbytes
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

    def placed_map(self, snap: Dict[str, Any], name: str, full: torch.Tensor) -> List[torch.Tensor]:
        """The row map ``full`` of a placed snapshot split into its members'
        row blocks, placed once per published map (the reference places
        its maps on the mesh when it derives them)."""
        with self._map_lock:
            cur = snap.setdefault("placed_maps", {}).get(name)
            if cur is not None and cur[0] is full:
                return cur[1]
        parts = place_rows(full, snap["members"])
        with self._map_lock:
            snap["placed_maps"][name] = (full, parts)
        return parts

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
            if "members" in snap:
                snap["alive"] = place_rows(alive, snap["members"])
            else:
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

    def plan(self, snap: Dict[str, Any], token_rows: Sequence[Sequence[str]]) -> Tuple:
        """Entry columns (posting, term row), the [B, U] idf-weighted
        selection matrix and the current avgdl for a tokenized batch.
        Terms are deduped across the batch and kept in sorted order (the
        host's accumulation order); idf comes from the live df counters,
        so deletes correct df without a rebuild. A sharded snapshot gets
        one (posting, term row) pair of columns per shard, in lists, its
        postings shard-local."""
        vocab = snap["vocab"]
        off_sh = snap["off_sh"]
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
        # the reference's id space is one shard's: (U + 1) * c_local
        if (pow2_bucket(max(len(terms), 1)) + 1) * (snap["c"] // snap["shards"]) > 2**31 - 1:
            raise PlanOverflow
        sel = np.zeros((len(token_rows), len(terms)), dtype=np.float32)
        for qi, row in enumerate(token_rows):
            for t in set(row):
                ui = u_of.get(t)
                if ui is not None:
                    sel[qi, ui] = idfs[ui]
        ptrs, urows = [], []
        for sh in range(snap["shards"]):
            ptr_parts: List[np.ndarray] = []
            counts: List[int] = []
            for t in terms:
                ti = vocab[t]
                a, b = int(off_sh[sh, ti]), int(off_sh[sh, ti + 1])
                ptr_parts.append(np.arange(a, b, dtype=np.int64))
                counts.append(b - a)
            ptrs.append(np.concatenate(ptr_parts) if ptr_parts else np.zeros(0, np.int64))
            urows.append(np.repeat(np.arange(len(terms), dtype=np.int64), counts))
        if snap["shards"] == 1:
            return ptrs[0], urows[0], sel, np.float32(avgdl)
        return ptrs, urows, sel, np.float32(avgdl)

    def device_args(self, snap, ptr, urow, sel, avgdl) -> Tuple:
        """A plan's columns on the device, with the snapshot's, in the
        argument order of ``bm25_dense_scores`` (a sharded plan's entry
        columns stay lists, one tensor a shard: ``shard_args``)."""
        dev = self.device

        def put(x):
            if isinstance(x, list):
                return [torch.from_numpy(a).to(dev) for a in x]
            return torch.from_numpy(x).to(dev)

        return (put(ptr), put(urow), torch.from_numpy(sel).to(dev), snap["post_doc"],
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
            plan = self.plan(snap, token_rows)
        except SnapshotStale:
            self.events["host_compaction"] += 1
            _LEX_C.labels("host_fallback_compaction").inc()
            self._kick_background_rebuild()
            return self.bm25.search_batch(queries, k)
        except PlanOverflow:
            self.events["host_overflow"] += 1
            _LEX_C.labels("host_fallback_overflow").inc()
            return self.bm25.search_batch(queries, k)
        if snap["shards"] == 1:
            s, i = topk_stable(bm25_dense_scores(*self.device_args(snap, *plan)), kb)
        elif layout_members(snap, self.device) is not None:
            s, i = topk_mesh(snap, plan, kb)
        else:
            s, i = topk_shards(snap, self.device_args(snap, *plan), kb)
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
