"""Fused hybrid search: BM25 + vector + RRF in one device dispatch
(counterpart of ``nornicdb_tpu/search/hybrid_fused.py:FusedHybrid``, one
device: its exact tier ``hybrid_brute_f32``, its walk tier
``hybrid_walk_f32``, and their quantized forms ``hybrid_brute_int8`` /
``hybrid_brute_pq`` and ``hybrid_walk_quant``).

One dispatch takes a coalesced batch's query embeddings and its planned
lexical entries and returns the RRF-fused ranking with both candidate
lists (the service's ``min_score`` gate and hit payloads need the raw
scores):

1. **lexical**: ``device_bm25.bm25_dense_scores`` over the CSR snapshot,
   then a stable top-k of rows;
2. **vector**, one of two tiers:
   - the **exact tier**: B1, ``ops/topk.py:fused_cosine_topk``, over the
     brute index's device arrays (``BruteForceIndex.device_view``): the
     same exact cosine top-k, ties to the lower slot, that the host
     path's ``search_batch`` launches;
   - the **walk tier**, at and above ``walk_min_n`` live vectors once the
     graph is built: the CAGRA greedy walk (``cagra.walk_body``) over the
     graph's device copy of the rows, at the pool's width ``itopk``;
3. **fuse**: the lists join on a device ``lexical row -> vector row`` map
   (brute slots for the exact tier, graph rows for the walk), so a doc in
   both sources is one candidate; reciprocal-rank weights add in float32,
   lexical first, as the host ``rrf_fuse`` does, and a stable top-k
   orders by (score, concatenated position) = the host's (score, first
   seen).

Contract: on the exact tier, lexical and vector ids equal to the host
path's, tie-aware where scores lie within float rounding (cuBLAS may add
the lexical terms in another order than the host), fused scores bitwise
equal to the host ``rrf_fuse`` over the same two lists. The walk tier is
approximate by construction: its fused top-k is held to recall@10 >= 0.95
against the host hybrid ranking (walk-parity), its fused scores stay
bitwise the host ``rrf_fuse`` of its own lists.

Freshness follows ``DeviceBM25``: tombstones are filtered, post-build
writes are exact-scored on the host and re-fused there (those rows are
served by ``host``). On the walk tier, rows removed since the graph build
are filtered by one ``contains_many``, and rows added or updated since
are scored exactly and merged (the row is then re-fused on the host).
The walk steps down to the exact tier, counted in ``counts`` as
``walk_<reason>``, while its graph builds (``pending_build``), when a
request is deeper than the pool (``itopk_exceeded``), when the changelog
no longer reaches the build (``changelog_overrun``) and when the live
filter left a row short (``underfill``); never to the host. Each named
rung of the snapshot (changelog overrun, compaction, plan overflow, a
vector write racing the join map, an empty vector index) hands the batch
to the host path, counted as ``handoff_<reason>``. Nothing else does: an
error in planning, dispatch or decode propagates.

**Quantized tiers.** Under ``NORNICDB_VECTOR_QUANT`` the vector half reads
the brute index's quantized plane (``device_quant.py``) instead of the
float32 pair: the device scores the lexical top-k and a coarse int8 or PQ
top-``pool`` (the plane's pool), the decode re-scores the pool exactly on
the host rows, merges writes since the plane's build, and re-fuses every
row on the host (``rrf_fuse``, bitwise the device fuse's arithmetic): the
coarse scores rank the pool, never an answer. The walk over a quantized
graph base (``cagra.py``) does the same with its pool. A quantized tier
steps down to the float32 tier (never to the host), counted as
``quant_<reason>``: the plane not built yet (``pending_build``), a
compaction, a changelog overrun, a write racing the join map
(``vec_race``), a compaction during the rerank (``rerank_race``), an
under-filled row (``underfill``). The sharded tiers wait for a later
slice.

**Observability.** The float32 tiers record what the reference's record:
``nornicdb_hybrid_fused_events_total`` by event (dispatches, host
fallbacks, the walk's step-downs, delta merges), one
``record_dispatch`` per device batch (``hybrid_fused``,
``hybrid_walk_fused``, ``hybrid_walk_fused_quant``) timed to the answer's
arrival on the host, its cost (the lexical CSR price plus the vector
half's: ``price_brute`` or ``price_walk*``, at the B rows run), and each
row's stage ``times`` for the service's trace spans. The quantized brute
tier's records come with the admission slice.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.obs import REGISTRY, declare_kind, record_dispatch
from nornicdb_tpu_torch.obs import cost as _cost
from nornicdb_tpu_torch.ops.similarity import NEG_INF, l2_normalize, topk_stable
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk
from nornicdb_tpu_torch.search.ann_quality import current_profile
from nornicdb_tpu_torch.search.bm25 import BM25Index
from nornicdb_tpu_torch.search.cagra import CagraIndex, merge_delta_hits, rerank_pool, walk_body
from nornicdb_tpu_torch.search.device_bm25 import (
    DeviceBM25,
    PlanOverflow,
    SnapshotStale,
    bm25_dense_scores,
)
from nornicdb_tpu_torch.search.device_quant import (
    _int8_topk_impl,
    _pq_topk_impl,
    _walk_body_pq,
    _walk_body_quant,
    quant_mode,
)
from nornicdb_tpu_torch.search.microbatch import pow2_bucket
from nornicdb_tpu_torch.search.rrf import DEFAULT_RRF_K, rrf_fuse
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

_HYB_C = REGISTRY.counter(
    "nornicdb_hybrid_fused_events_total",
    "Fused hybrid pipeline dispatches and freshness decisions",
    labels=("event",))

declare_kind("hybrid_fused")
declare_kind("hybrid_walk_fused")
declare_kind("hybrid_fused_quant")
declare_kind("hybrid_walk_fused_quant")

TIER_BRUTE_F32 = "hybrid_brute_f32"
# hand-offs to the host path the reference counts as host_fallback_<reason>
_HOST_FALLBACK_EVENTS = ("changelog", "compaction", "overflow", "vec_race")
TIER_WALK_F32 = "hybrid_walk_f32"
TIER_WALK_QUANT = "hybrid_walk_quant"


def quant_tier(mode: str) -> str:
    return f"hybrid_brute_{mode}"


def _pad_cols(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    if x.shape[1] >= k:
        return x
    pad = torch.full((x.shape[0], k - x.shape[1]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=1)


def rrf_fuse_device(
    ls: torch.Tensor,  # [B, kq] lexical scores, NEG_INF padded
    lid: torch.Tensor,  # [B, kq] vector slot per lexical hit (-1 = none)
    lgrow: torch.Tensor,  # [B, kq] lexical rows
    vs: torch.Tensor,  # [B, kq] vector scores
    vi: torch.Tensor,  # [B, kq] vector slots
    n_cand: torch.Tensor,  # [B] per-request candidate depth
    w_lex: torch.Tensor,  # [B]
    w_vec: torch.Tensor,  # [B]
    rrf_k: int,
    c_vec: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted RRF over the concatenated candidate lists. A doc in both
    lists joins through ``lid`` and keeps its first (lexical) position;
    each fused score is at most two float32 terms added lexical first,
    bitwise the host ``rrf_fuse``. Returns (scores [B, 2kq], concatenated
    positions [B, 2kq])."""
    kq = ls.shape[1]
    dev = ls.device
    r = torch.arange(kq, device=dev)
    in_cand = r[None, :] < n_cand[:, None]
    lval = (ls > 0.5 * NEG_INF) & in_cand
    vval = (vs > 0.5 * NEG_INF) & in_cand
    # one id space: the vector slot when the lexical doc has a vector,
    # else a unique id past the vector capacity
    cid = torch.cat([torch.where(lid >= 0, lid, c_vec + lgrow), vi], dim=1)
    val = torch.cat([lval, vval], dim=1)
    inv = (rrf_k + 1.0 + r).to(torch.float32)
    w = torch.cat([w_lex[:, None] / inv[None, :], w_vec[:, None] / inv[None, :]],
                  dim=1)
    w = torch.where(val, w, torch.zeros_like(w))
    match = ((cid[:, :, None] == cid[:, None, :])
             & val[:, :, None] & val[:, None, :])
    # a row of `match` has at most two hits, one per source: the sum is
    # one float32 add, and adding zeros is exact
    fused = (match.to(torch.float32) * w[:, None, :]).sum(dim=2)
    m2 = torch.arange(2 * kq, device=dev)
    dup = (match & (m2[None, None, :] < m2[None, :, None])).any(dim=2)
    fused = torch.where(val & ~dup, fused, torch.full_like(fused, NEG_INF))
    return topk_stable(fused, 2 * kq)


def lex_parts(ptr, urow, sel, post_doc, post_tf, doc_len, alive, avgdl, l2map, kq):
    """The lexical top-k (scores, rows) and each row's joined vector row
    through ``l2map`` (the reference's ``_lex_parts``)."""
    dense = bm25_dense_scores(ptr, urow, sel, post_doc, post_tf, doc_len,
                              alive, avgdl)
    ls, lgrow = topk_stable(dense, min(kq, doc_len.shape[0]))
    return ls, l2map[lgrow], lgrow


def _fuse(ls, lid, lgrow, vs, vi, n_cand, w_lex, w_vec, kq, c_vec):
    ls = _pad_cols(ls, kq, NEG_INF)
    lid = _pad_cols(lid, kq, 0)
    lgrow = _pad_cols(lgrow, kq, 0)
    vs = _pad_cols(vs, kq, NEG_INF)
    vi = _pad_cols(vi, kq, 0)
    fs, fpos = rrf_fuse_device(ls, lid, lgrow, vs, vi, n_cand, w_lex, w_vec,
                               DEFAULT_RRF_K, c_vec)
    return ls, lgrow, vs, vi, fs, fpos


def fused_single(ptr, urow, sel, post_doc, post_tf, doc_len, alive, avgdl,
                 l2v, qn, vmatrix, vvalid, n_cand, w_lex, w_vec, kq):
    """The exact tier's device half of one batch (the reference's
    ``_fused_single``): each source's top-k, the lexical rows joined to
    vector slots, and the fuse. Returns (lexical scores, rows, vector
    scores, slots) [B, kq] and (fused scores, positions) [B, 2kq]."""
    ls, lid, lgrow = lex_parts(ptr, urow, sel, post_doc, post_tf, doc_len,
                               alive, avgdl, l2v, kq)
    vs, vi = fused_cosine_topk(qn, vmatrix, vvalid, kq)
    return _fuse(ls, lid, lgrow, vs, vi, n_cand, w_lex, w_vec, kq, vmatrix.shape[0])


def walk_fused_single(ptr, urow, sel, post_doc, post_tf, doc_len, alive, avgdl,
                      l2g, qn, gmatrix, gadj, gvalidf, n_cand, w_lex, w_vec, kq,
                      iters, width, itopk, hash_bits, n_seeds):
    """The walk tier's device half of one batch (the reference's
    ``_walk_fused_single``): the lexical top-k joined to graph rows, the
    greedy walk over the graph, and the fuse over the graph's rows."""
    ls, lid, lgrow = lex_parts(ptr, urow, sel, post_doc, post_tf, doc_len,
                               alive, avgdl, l2g, kq)
    vs, vi = walk_body(qn, gmatrix, gadj, gvalidf, min(kq, itopk), iters, width,
                       itopk, hash_bits, n_seeds)
    return _fuse(ls, lid, lgrow, vs, vi.to(torch.int64), n_cand, w_lex, w_vec, kq,
                 gmatrix.shape[0])


def fused_single_quant(ptr, urow, sel, post_doc, post_tf, doc_len, alive, avgdl,
                       l2v, qn, codes_t, aux, vvalid, kq, pool, mode):
    """The quantized brute tier's device half (the reference's
    ``_fused_single_quant``): the lexical top-k and the coarse vector
    top-``pool`` (``aux``: the int8 scales or the PQ codebooks); no device
    fuse, since the decode re-fuses over the exact rerank."""
    ls, _, lgrow = lex_parts(ptr, urow, sel, post_doc, post_tf, doc_len,
                             alive, avgdl, l2v, kq)
    topk = _int8_topk_impl if mode == "int8" else _pq_topk_impl
    vs, vi = topk(qn, codes_t, aux, vvalid, pool)
    return (_pad_cols(ls, kq, NEG_INF), _pad_cols(lgrow, kq, 0),
            _pad_cols(vs, pool, NEG_INF), _pad_cols(vi, pool, 0))


def walk_fused_single_q(ptr, urow, sel, post_doc, post_tf, doc_len, alive, avgdl,
                        l2g, qp, codes, codes_head, scale, gadj, gvalidf, kq,
                        iters, width, itopk, hash_bits, n_seeds, keep):
    """The walk tier over an int8 graph base (the reference's
    ``_walk_fused_single_q``): the lexical top-k and the whole pool of the
    two-stage walk (``qp``: the PCA-projected queries)."""
    ls, _, lgrow = lex_parts(ptr, urow, sel, post_doc, post_tf, doc_len,
                             alive, avgdl, l2g, kq)
    vs, vi = _walk_body_quant(qp, codes, codes_head, scale, gadj, gvalidf, itopk,
                              iters, width, itopk, hash_bits, n_seeds, keep)
    return _pad_cols(ls, kq, NEG_INF), _pad_cols(lgrow, kq, 0), vs, vi


def walk_fused_single_pq(ptr, urow, sel, post_doc, post_tf, doc_len, alive, avgdl,
                         l2g, qn, codes, codebooks, gadj, gvalidf, kq,
                         iters, width, itopk, hash_bits, n_seeds):
    """The walk tier over a PQ graph base (the reference's
    ``_walk_fused_single_pq``): the lexical top-k and the ADC walk's pool."""
    ls, _, lgrow = lex_parts(ptr, urow, sel, post_doc, post_tf, doc_len,
                             alive, avgdl, l2g, kq)
    vs, vi = _walk_body_pq(qn, codes, codebooks, gadj, gvalidf, itopk, iters, width,
                           itopk, hash_bits, n_seeds)
    return _pad_cols(ls, kq, NEG_INF), _pad_cols(lgrow, kq, 0), vs, vi


class FusedHybrid:
    """Device-fused hybrid search over a (BM25Index, BruteForceIndex)
    pair, on the brute index's device. State beyond the lexical snapshot
    (owned by :class:`DeviceBM25`) is the join maps and, for the walk
    tier, the graph (a :class:`CagraIndex` over the same brute index,
    shared with the service's ``cagra`` strategy when it has one); all of
    it re-derives from the live host indexes.

    ``counts``: ``dispatch`` per exact-tier dispatch, ``quant_dispatch``
    per quantized brute-tier dispatch and ``walk_dispatch`` per walk
    dispatch; per row the tier that served it (``hybrid_brute_f32``,
    ``hybrid_brute_int8``, ``hybrid_brute_pq``, ``hybrid_walk_f32``,
    ``hybrid_walk_quant``, or ``host`` for a row re-fused on the host
    after a post-build write on a float32 tier); ``walk_<reason>`` and
    ``quant_<reason>`` per batch handed to a lower tier;
    ``handoff_<reason>`` per batch handed to the host path; ``join_full``
    and ``join_patch`` per derivation of the row -> slot map."""

    def __init__(
        self,
        bm25: BM25Index,
        brute: BruteForceIndex,
        min_n: int = 256,
        rebuild_stale_frac: float = 0.1,
        build_inline: bool = True,
        walk_min_n: Optional[int] = None,
    ):
        self.bm25 = bm25
        self.brute = brute
        self.lex = DeviceBM25(bm25, min_n=min_n,
                              rebuild_stale_frac=rebuild_stale_frac,
                              build_inline=build_inline, device=brute.device)
        self.counts: Counter = Counter()
        # the walk tier: at and above walk_min_n live vectors (None: off),
        # over a graph of its own until rebind_cagra shares another
        self.walk_min_n = walk_min_n
        self.cagra: Optional[CagraIndex] = None
        if walk_min_n is not None:
            p = current_profile()
            self.cagra = CagraIndex(brute=brute, degree=p.cagra_degree, itopk=p.cagra_itopk,
                                    search_width=p.cagra_width, min_n=walk_min_n,
                                    build_inline=build_inline)
        self._grow_cache: Optional[Tuple[int, Dict[str, int]]] = None

    def build(self) -> bool:
        return self.lex.build()

    @property
    def ready(self) -> bool:
        return self.lex.snapshot_built

    def ensure(self) -> bool:
        """Have (or start building) a lexical snapshot; False while the
        host path must serve."""
        return self.lex.ensure_snapshot() is not None

    def handoffs(self) -> int:
        return sum(n for key, n in self.counts.items() if key.startswith("handoff_"))

    def _ensure_map(self, snap: Dict[str, Any], mutations: int) -> Optional[torch.Tensor]:
        """Device lexical row -> vector slot map at brute generation
        ``mutations``, or None when a write moved the index on since the
        captured view (both reads below pin the generation). After
        writes, the published map is patched at the rows of the ids whose
        slot changed; the full derivation (one lookup per snapshot row)
        runs once per snapshot and when the slot log no longer reaches
        back to the published map."""

        def derive(prev):
            if prev is not None and prev[0] < mutations:
                changed = self.brute.slots_changed_since(prev[0], mutations)
                if changed is not None:
                    self.counts["join_patch"] += 1
                    row_of = snap["row_of"]
                    hits = [(row_of[e], s) for e, s in changed.items() if e in row_of]
                    if not hits:
                        return prev[1]
                    rows, slots = zip(*hits)
                    out = prev[1].clone()  # in-flight batches keep reading prev
                    out[torch.tensor(rows, device=out.device)] = torch.tensor(
                        slots, dtype=out.dtype, device=out.device)
                    return out
            ids = ["" if e is None else e for e in snap["row_ids"]]
            raw = self.brute.slots_of(ids, expect_mutations=mutations)
            if raw is None:
                return None
            self.counts["join_full"] += 1
            return torch.tensor(raw, dtype=torch.int64, device=self.lex.device)

        return self.lex.row_map(snap, "l2v", mutations, derive)

    def _ensure_walk_map(self, snap: Dict[str, Any], g: Dict[str, Any]) -> torch.Tensor:
        """Device lexical row -> graph row map, keyed on the graph's build
        sequence, so a rebuilt graph rebinds the join on its first batch."""

        def derive(prev):
            grow = self._graph_rows(g)
            return torch.tensor([-1 if e is None else grow.get(e, -1) for e in snap["row_ids"]],
                                dtype=torch.int64, device=self.lex.device)

        return self.lex.row_map(snap, "l2g", g["build_seq"], derive)

    def _graph_rows(self, g: Dict[str, Any]) -> Dict[str, int]:
        # keyed on build_seq, not on the dict, which would pin a replaced
        # graph's device arrays until the next walk
        cached = self._grow_cache
        if cached is not None and cached[0] == g["build_seq"]:
            return cached[1]
        grow = {e: i for i, e in enumerate(g["row_ids"]) if e is not None}
        self._grow_cache = (g["build_seq"], grow)
        return grow

    def rebind_cagra(self, cagra: CagraIndex) -> bool:
        """Walk ``cagra``'s graph from now on (the strategy machine built
        one over the same brute index): one graph, one rebuild cadence,
        and the lexical snapshot keeps serving. False, and nothing
        changes, when it wraps another brute index: its rows and
        freshness counters belong to another corpus."""
        if cagra is not None and cagra._brute is not self.brute:
            return False
        self.cagra = cagra
        self._grow_cache = None
        return True

    def _handoff(self, reason: str, b: int) -> List[None]:
        self.counts["handoff_" + reason] += 1
        if reason in _HOST_FALLBACK_EVENTS:
            _HYB_C.labels("host_fallback_" + reason).inc()
        return [None] * b

    def _record_cost(self, kind: str, b: int, snap: Dict[str, Any],
                     vec_flops_bytes: Tuple[float, float]) -> None:
        """One fused dispatch's price: the lexical CSR price from the
        (posting mass, unique terms) the lexical plan() stashed on this
        thread, at the snapshot's padded doc width, plus the vector
        half's price."""
        if not _cost.pricing_enabled():
            return
        nnz, u = self.lex._plan_cost.stats
        lex_f, lex_b = _cost.price_bm25(b, nnz, u, int(snap["c"]))
        vec_f, vec_b = vec_flops_bytes
        _cost.record_query_cost(kind, _cost.cost_name(self.lex), b,
                                lex_f + vec_f, lex_b + vec_b)

    def search_batch(
        self, queries_emb: np.ndarray, kq: int, extras: Sequence[Dict[str, Any]],
    ) -> List[Optional[Dict[str, Any]]]:
        """One fused dispatch for a coalesced hybrid batch.

        ``extras[i]`` carries request i's ``tokens``, ``n_cand`` (its
        overfetch depth) and ``w`` ((w_lex, w_vec)). Returns per query a
        dict of ``lex``/``vec``/``fused`` ranked lists, ``served_by`` and
        ``tier`` (``walk`` or ``brute``), or None for every query when a
        freshness rung hands the batch to the host path."""
        b = len(queries_emb)
        snap = self.lex.ensure_snapshot()
        if snap is None:
            return self._handoff("no_snapshot", b)
        delta = self.lex.delta_block(snap)
        if delta is None:
            self.lex._kick_background_rebuild()
            return self._handoff("changelog", b)
        if self.brute.view_meta() is None:
            return self._handoff("vec_empty", b)
        token_rows = [e["tokens"] for e in extras]
        t_plan0 = time.time()
        try:
            self.lex.refresh_alive(snap)
            plan = self.lex.plan(snap, token_rows)
        except SnapshotStale:
            self.lex._kick_background_rebuild()
            return self._handoff("compaction", b)
        except PlanOverflow:
            return self._handoff("overflow", b)
        dev = self.lex.device
        lex_args = self.lex.device_args(snap, *plan)
        qn = l2_normalize(torch.as_tensor(
            np.asarray(queries_emb, np.float32)).to(dev)).contiguous()
        tail = (torch.tensor([int(e["n_cand"]) for e in extras], device=dev),
                torch.tensor([e["w"][0] for e in extras], dtype=torch.float32, device=dev),
                torch.tensor([e["w"][1] for e in extras], dtype=torch.float32, device=dev))
        # the walk tier when eligible; a vetoed walk batch falls through to
        # the exact tier, never to the host
        wctx = self._walk_context(snap, kq)
        if wctx is not None:
            rows = self._dispatch_walk(snap, wctx, lex_args, qn, tail, delta,
                                       token_rows, extras, t_plan0)
            if rows is not None:
                return rows
            t_plan0 = time.time()  # the vetoed walk is no part of this plan
        # the quantized brute tier; a vetoed batch falls through to float32
        qctx = self._quant_context()
        if qctx is not None:
            rows = self._dispatch_quant(snap, qctx, lex_args, qn, kq, delta, token_rows,
                                        extras)
            if rows is not None:
                return rows
            t_plan0 = time.time()
        # the float32 pair is read only here: a batch a quantized or walk
        # tier served never uploads it
        view = self.brute.device_view()
        if view is None:
            return self._handoff("vec_empty", b)
        m, valid, vec_ids, mutations = view
        l2v = self._ensure_map(snap, mutations)
        if l2v is None:
            return self._handoff("vec_race", b)
        t0 = time.time()
        out = fused_single(*lex_args, l2v, qn, m, valid, *tail, kq=kq)
        ls, lgrow, vs, vi, fs, fpos = (x.cpu().numpy() for x in out)
        t1 = time.time()
        record_dispatch("hybrid_fused", pow2_bucket(b), kq, t1 - t0)
        self.counts["dispatch"] += 1
        _HYB_C.labels("dispatch").inc()
        self._record_cost("hybrid_fused", b, snap,
                          vec_flops_bytes=_cost.price_brute(b, int(m.shape[0]), int(m.shape[1])))
        rows = self._decode(snap, vec_ids, delta, token_rows, extras,
                            ls, lgrow, vs, vi, fs, fpos, kq)
        if delta:
            _HYB_C.labels("delta_merge").inc(len(extras))
        times = {"plan_s": t0 - t_plan0, "device_t0": t0, "device_t1": t1,
                 "decode_s": time.time() - t1, "tier": "brute"}
        for row in rows:
            self.counts[row["served_by"]] += 1
            row["tier"] = "brute"
            row["times"] = times
        return rows

    # -- quantized brute tier ---------------------------------------------

    def _quant_context(self) -> Optional[Dict[str, Any]]:
        """The brute index's quantized plane and its freshness for one
        batch, or None when the float32 tier serves (each named step
        counted)."""
        if quant_mode() == "off":
            return None
        brute = self.brute
        plane = brute.quant_plane()
        if plane is None:
            return None
        qsnap = plane.ensure()
        if qsnap is None:
            self.counts["quant_pending_build"] += 1
            return None
        if qsnap["built_compactions"] != brute.compactions:
            self.counts["quant_compaction"] += 1
            plane._kick_background_rebuild()
            return None
        vdelta = brute.changed_since(qsnap["built_mutations"])
        if vdelta is None:
            self.counts["quant_changelog_overrun"] += 1
            plane._kick_background_rebuild()
            return None
        ids_view = brute.ids_meta()
        if ids_view is None or ids_view[2] != qsnap["built_compactions"]:
            return None
        ids, mutations, _ = ids_view
        return {"plane": plane, "qsnap": qsnap, "vdelta": vdelta, "ids": ids,
                "mutations": mutations}

    def _dispatch_quant(self, snap, qctx, lex_args, qn, kq, delta, token_rows, extras):
        """One quantized brute-tier dispatch: the decoded rows, or None when
        the float32 tier must serve the batch."""
        qsnap = qctx["qsnap"]
        tier = quant_tier(qsnap["mode"])
        brute = self.brute
        l2v = self._ensure_map(snap, qctx["mutations"])
        if l2v is None:
            self.counts["quant_vec_race"] += 1
            return None
        # the vector half overfetches past kq: the plane's rerank pool
        pool = qctx["plane"].pool_for(kq, qsnap)
        aux = qsnap["scale"] if qsnap["mode"] == "int8" else qsnap["codebooks"]
        out = fused_single_quant(*lex_args, l2v, qn, qsnap["codes_t"], aux, qsnap["valid"],
                                 kq=kq, pool=pool, mode=qsnap["mode"])
        ls, lgrow, vs, vi = (x.cpu().numpy() for x in out)
        # exact rerank on the host's current rows, one lock hold
        qh = qn.cpu().numpy()
        uniq = np.unique(vi)
        got = brute.rows_for_slots(uniq, expect_compactions=qsnap["built_compactions"])
        if got is None:
            self.counts["quant_rerank_race"] += 1
            return None
        rows_u, alive_u, _ = got
        inv = np.searchsorted(uniq, vi)
        vs_e = np.take_along_axis(qh @ rows_u.T, inv, axis=1)
        ok = (vs > 0.5 * NEG_INF) & alive_u[inv]
        vs_e = np.where(ok, vs_e, np.float32(NEG_INF)).astype(np.float32)
        order = np.argsort(-vs_e, axis=1, kind="stable")
        vs_e = np.take_along_axis(vs_e, order, axis=1)
        vi = np.take_along_axis(vi, order, axis=1)
        # writes since the plane's build: scored exactly, merged
        rows = self._decode(snap, qctx["ids"], delta, token_rows, extras, ls, lgrow, vs_e, vi,
                            None, None, kq, vec_delta=brute.delta_vectors(qctx["vdelta"]),
                            qn=qh, force_refuse=True, tier=tier)
        alive_n = len(brute)
        if any(len(row["vec"]) < min(int(e["n_cand"]), kq, alive_n)
               for row, e in zip(rows, extras)):
            self.counts["quant_underfill"] += 1
            return None
        self.counts["quant_dispatch"] += 1
        for row in rows:
            self.counts[row["served_by"]] += 1
            row["tier"] = "brute"
        return rows

    # -- walk tier --------------------------------------------------------

    def _walk_context(self, snap: Dict[str, Any], kq: int) -> Optional[Dict[str, Any]]:
        """The graph and its freshness for one walk batch, or None when
        the exact tier serves it (each named step counted)."""
        cagra = self.cagra
        if cagra is None or self.walk_min_n is None or len(self.brute) < self.walk_min_n:
            return None
        g = cagra.ensure_graph()
        if g is None:
            # the first build (or one after the corpus shrank) is running
            self.counts["walk_pending_build"] += 1
            _HYB_C.labels("walk_pending_build").inc()
            return None
        if kq > cagra.itopk:
            # the pool only ever holds itopk candidates
            self.counts["walk_itopk_exceeded"] += 1
            _HYB_C.labels("walk_fallback_itopk").inc()
            return None
        delta_ids, delta_vecs = cagra.delta_block(g)
        if delta_ids is None:
            # churn outran the changelog while a rebuild runs
            self.counts["walk_changelog_overrun"] += 1
            _HYB_C.labels("walk_fallback_changelog").inc()
            return None
        # staleness from the live counter, read after delta_block drained
        # the changelog: a delete landing in between must not skip the
        # live filter
        return {"g": g, "l2g": self._ensure_walk_map(snap, g),
                "delta_ids": delta_ids, "delta_vecs": delta_vecs,
                "stale": self.brute.mutations != g["built_mutations"],
                "iters": g["iters"], "width": cagra.search_width,
                "itopk": cagra.itopk, "hash_bits": cagra.hash_bits,
                "n_seeds": cagra.n_seeds,
                "tier": TIER_WALK_F32 if g["quant"] is None else TIER_WALK_QUANT}

    def _dispatch_walk(self, snap, wctx, lex_args, qn, tail, delta, token_rows, extras,
                       t_plan0):
        """One walk-tier dispatch: the decoded rows, or None when the live
        filter (or a walk miss) left a row short of the candidates the
        corpus has, and the exact tier must serve the batch."""
        g = wctx["g"]
        quant = g["quant"]
        # both sources at the pool's width, not kq: the fuse masks depth by
        # n_cand, and the spare columns give the live filter slack
        kp = wctx["itopk"]
        statics = dict(iters=wctx["iters"], width=wctx["width"], itopk=kp,
                       hash_bits=wctx["hash_bits"], n_seeds=wctx["n_seeds"])
        t0 = time.time()
        if quant is None:
            out = walk_fused_single(*lex_args, wctx["l2g"], qn, g["matrix"], g["adj"],
                                    g["validf"], *tail, kq=kp, **statics)
            ls, lgrow, vs, vi, fs, fpos = (x.cpu().numpy() for x in out)
        else:
            if quant["mode"] == "pq":
                # a pool 4x as wide: ADC noise steers the walk
                statics["itopk"] = min(4 * kp, 1024)
                out = walk_fused_single_pq(*lex_args, wctx["l2g"], qn, quant["codes"],
                                           quant["codebooks"], g["adj"], g["validf"],
                                           kq=kp, **statics)
                kp = statics["itopk"]
            else:
                out = walk_fused_single_q(*lex_args, wctx["l2g"], qn @ quant["rot_dev"],
                                          quant["codes"], quant["codes_head"], quant["scale"],
                                          g["adj"], g["validf"], kq=kp, **statics,
                                          keep=quant["keep"])
            ls, lgrow, vs, vi = (x.cpu().numpy() for x in out)
            # the whole pool re-scored on the host rows; the decode re-fuses
            vs, vi = rerank_pool(g["matrix"], qn.cpu().numpy(), vs, vi, vs.shape[1])
            fs = fpos = None
        t1 = time.time()
        b = len(extras)
        kind = "hybrid_walk_fused" if quant is None else "hybrid_walk_fused_quant"
        record_dispatch(kind, pow2_bucket(b), kp, t1 - t0)
        self.counts["walk_dispatch"] += 1
        _HYB_C.labels("walk_dispatch").inc()
        d_model, degree = int(qn.shape[1]), int(g["adj"].shape[1])
        if quant is None:
            vec_price = _cost.price_walk(b, d_model, wctx["iters"], wctx["width"], degree,
                                         wctx["itopk"], n_seeds=wctx["n_seeds"])
        else:
            if quant["mode"] == "pq":
                vf, vb = _cost.price_walk_pq(b, d_model, wctx["iters"], wctx["width"], degree,
                                             kp, quant["pq_m"], quant["pq_codes"],
                                             n_seeds=wctx["n_seeds"])
            else:
                vf, vb = _cost.price_walk_quant(b, d_model, wctx["iters"], wctx["width"],
                                                degree, wctx["itopk"], quant["head_dims"],
                                                quant["keep"], n_seeds=wctx["n_seeds"])
            rf, rb = _cost.price_rerank(b, kp, d_model)
            vec_price = (vf + rf, vb + rb)
        self._record_cost(kind, b, snap, vec_flops_bytes=vec_price)
        rows = self._decode(snap, g["row_ids"], delta, token_rows, extras,
                            ls, lgrow, vs, vi, fs, fpos, kp,
                            vec_delta=(wctx["delta_ids"], wctx["delta_vecs"]),
                            vec_stale=wctx["stale"],
                            qn=qn.cpu().numpy() if wctx["delta_ids"] else None,
                            force_refuse=quant is not None, tier=wctx["tier"])
        alive_n = len(self.brute)
        if any(len(row["vec"]) < min(int(e["n_cand"]), kp, alive_n)
               for row, e in zip(rows, extras)):
            self.counts["walk_underfill"] += 1
            _HYB_C.labels("walk_underfill_brute").inc()
            return None
        # freshness accounting only once the walk serves the batch
        if wctx["delta_ids"]:
            _HYB_C.labels("walk_delta_merge").inc()
        elif wctx["stale"]:
            _HYB_C.labels("walk_live_filter").inc()
        if delta:
            _HYB_C.labels("delta_merge").inc(len(extras))
        times = {"plan_s": t0 - t_plan0, "device_t0": t0, "device_t1": t1,
                 "decode_s": time.time() - t1, "tier": "walk",
                 "walk_iters": wctx["iters"], "walk_itopk": wctx["itopk"]}
        for row in rows:
            self.counts[row["served_by"]] += 1
            row["tier"] = "walk"
            row["times"] = times
        return rows

    def _decode(self, snap, vec_ids, delta, token_rows, extras,
                ls, lgrow, vs, vi, fs, fpos, kq,
                vec_delta=None, vec_stale=False, qn=None, force_refuse=False,
                tier=TIER_BRUTE_F32):
        """Per-request ranked lists from one dispatch's candidates.
        ``vec_ids`` maps vector candidates to ext ids (brute slots, or the
        graph's rows). With docs written since the snapshot build, their
        exact host scores merge into the lexical list; on the walk tier,
        candidates removed since the graph build are dropped
        (``vec_stale``) and rows written since are scored exactly
        (``vec_delta``, against ``qn``) and merged. A row either change
        touched is re-fused by the (bitwise-compatible) host ``rrf_fuse``
        and served by ``host``; the others by ``tier``. The quantized tiers
        re-fuse every row on the host (``force_refuse``: no device fuse)
        and keep their tier's name."""
        row_ids = snap["row_ids"]
        d_ids, d_vecs = vec_delta if vec_delta is not None else ([], None)
        d_set = set(d_ids)
        d_scores = qn @ d_vecs.T if d_ids else None  # stored rows are normalized
        live = None
        if vec_stale:
            # one locked membership pass over every distinct candidate
            cand = {vec_ids[i] for i in np.unique(vi)}
            cand.discard(None)
            live = self.brute.contains_many(cand)
        out: List[Dict[str, Any]] = []
        for r in range(len(extras)):
            n_cand = int(extras[r]["n_cand"])
            lex_hits: List[Tuple[str, float]] = []
            lex_by_pos: Dict[int, str] = {}
            for c in range(ls.shape[1]):
                if ls[r, c] < 0.5 * NEG_INF or len(lex_hits) >= n_cand:
                    break
                eid = row_ids[int(lgrow[r, c])]
                if eid is None:
                    continue
                lex_by_pos[c] = eid
                lex_hits.append((eid, float(ls[r, c])))
            vec_hits: List[Tuple[str, float]] = []
            vec_by_pos: Dict[int, str] = {}
            vec_fixed = force_refuse  # this row's vector list left the device's
            for c in range(vs.shape[1]):
                if vs[r, c] < 0.5 * NEG_INF or len(vec_hits) >= n_cand:
                    break
                eid = vec_ids[int(vi[r, c])]
                if eid is None or eid in d_set:
                    continue  # the walk scored a written row's old vector
                if live is not None and eid not in live:
                    vec_fixed = True
                    continue  # removed since the graph build
                vec_by_pos[c] = eid
                vec_hits.append((eid, float(vs[r, c])))
            if d_ids:
                vec_hits = merge_delta_hits(vec_hits, d_ids, d_scores[r], n_cand)
                vec_fixed = True
            served_by = tier
            if delta or vec_fixed:
                if delta:
                    lex_hits = self.lex._merge_delta([lex_hits], delta,
                                                     [token_rows[r]], n_cand)[0]
                fused = rrf_fuse([lex_hits, vec_hits],
                                 weights=list(extras[r]["w"]), limit=n_cand)
                if not force_refuse:
                    served_by = "host"
            else:
                fused = []
                for c in range(fs.shape[1]):
                    if fs[r, c] < 0.5 * NEG_INF or len(fused) >= n_cand:
                        break
                    pos = int(fpos[r, c])
                    eid = (lex_by_pos.get(pos) if pos < kq
                           else vec_by_pos.get(pos - kq))
                    if eid is None:
                        continue
                    fused.append((eid, float(fs[r, c])))
            out.append({"lex": lex_hits, "vec": vec_hits, "fused": fused,
                        "served_by": served_by})
        return out
