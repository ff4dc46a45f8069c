"""Fused hybrid search: BM25 + vector + RRF in one device dispatch
(counterpart of the exact tier, ``hybrid_brute_f32``, of
``nornicdb_tpu/search/hybrid_fused.py:FusedHybrid``).

One dispatch takes a coalesced batch's query embeddings and its planned
lexical entries and returns the RRF-fused ranking with both candidate
lists (the service's ``min_score`` gate and hit payloads need the raw
scores):

1. **lexical**: ``device_bm25.bm25_dense_scores`` over the CSR snapshot,
   then a stable top-k of rows;
2. **vector**: B1, ``ops/topk.py:fused_cosine_topk``, over the brute
   index's device arrays (``BruteForceIndex.device_view``): the same
   exact cosine top-k, ties to the lower slot, that the host path's
   ``search_batch`` launches, so the vector list is the host tier's by
   construction;
3. **fuse**: the lists join on a device ``lexical row -> vector slot``
   map, so a doc in both sources is one candidate; reciprocal-rank
   weights add in float32, lexical first, as the host ``rrf_fuse`` does,
   and a stable top-k orders by (score, concatenated position) = the
   host's (score, first seen).

Contract: lexical and vector ids equal to the host path's, tie-aware
where scores lie within float rounding (cuBLAS may add the lexical terms
in another order than the host); fused scores bitwise equal to the host
``rrf_fuse`` over the same two lists. Freshness follows ``DeviceBM25``:
tombstones are filtered, post-build writes are exact-scored on the host
and re-fused there (those rows are served by ``host``), and each named
rung (changelog overrun, compaction, plan overflow, a vector write
racing the join map, an empty vector index) hands the batch to the host
path, counted by reason in ``counts``. Nothing else does: an error in
planning, dispatch or decode propagates. The walk, quantized and sharded
tiers wait for later slices.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.ops.similarity import NEG_INF, l2_normalize, topk_stable
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk
from nornicdb_tpu_torch.search.bm25 import BM25Index
from nornicdb_tpu_torch.search.device_bm25 import (
    DeviceBM25,
    PlanOverflow,
    SnapshotStale,
    bm25_dense_scores,
)
from nornicdb_tpu_torch.search.rrf import DEFAULT_RRF_K, rrf_fuse
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

TIER_BRUTE_F32 = "hybrid_brute_f32"


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


def fused_single(ptr, urow, sel, post_doc, post_tf, doc_len, alive, avgdl,
                 l2v, qn, vmatrix, vvalid, n_cand, w_lex, w_vec, kq):
    """The device half of one batch (the reference's ``_fused_single``
    with its ``_local_parts``/``_lex_parts``): each source's top-k, the
    lexical rows joined to vector slots, and the fuse. Returns (lexical
    scores, rows, vector scores, slots) [B, kq] and (fused scores,
    positions) [B, 2kq]."""
    dense = bm25_dense_scores(ptr, urow, sel, post_doc, post_tf, doc_len,
                              alive, avgdl)
    ls, lgrow = topk_stable(dense, min(kq, doc_len.shape[0]))
    lid = l2v[lgrow]
    vs, vi = fused_cosine_topk(qn, vmatrix, vvalid, kq)
    ls = _pad_cols(ls, kq, NEG_INF)
    lid = _pad_cols(lid, kq, 0)
    lgrow = _pad_cols(lgrow, kq, 0)
    vs = _pad_cols(vs, kq, NEG_INF)
    vi = _pad_cols(vi, kq, 0)
    fs, fpos = rrf_fuse_device(ls, lid, lgrow, vs, vi, n_cand, w_lex, w_vec,
                               DEFAULT_RRF_K, vmatrix.shape[0])
    return ls, lgrow, vs, vi, fs, fpos


class FusedHybrid:
    """Device-fused hybrid search over a (BM25Index, BruteForceIndex)
    pair, on the brute index's device. State beyond the lexical snapshot
    (owned by :class:`DeviceBM25`) is the row -> slot join map; both
    re-derive from the live host indexes.

    ``counts``: ``dispatch`` per device dispatch; per row the tier that
    served it (``hybrid_brute_f32``, or ``host`` for a row re-fused on
    the host after a post-build write); ``handoff_<reason>`` per batch
    handed to the host path; ``join_full`` and ``join_patch`` per
    derivation of the row -> slot map."""

    def __init__(
        self,
        bm25: BM25Index,
        brute: BruteForceIndex,
        min_n: int = 256,
        rebuild_stale_frac: float = 0.1,
        build_inline: bool = True,
    ):
        self.bm25 = bm25
        self.brute = brute
        self.lex = DeviceBM25(bm25, min_n=min_n,
                              rebuild_stale_frac=rebuild_stale_frac,
                              build_inline=build_inline, device=brute.device)
        self.counts: Counter = Counter()

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

        return self.lex.row_map(snap, mutations, derive)

    def _handoff(self, reason: str, b: int) -> List[None]:
        self.counts["handoff_" + reason] += 1
        return [None] * b

    def search_batch(
        self, queries_emb: np.ndarray, kq: int, extras: Sequence[Dict[str, Any]],
    ) -> List[Optional[Dict[str, Any]]]:
        """One fused dispatch for a coalesced hybrid batch.

        ``extras[i]`` carries request i's ``tokens``, ``n_cand`` (its
        overfetch depth) and ``w`` ((w_lex, w_vec)). Returns per query a
        dict of ``lex``/``vec``/``fused`` ranked lists, ``served_by`` and
        the batch's ``times``, or None for every query when a freshness
        rung hands the batch to the host path."""
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
        try:
            self.lex.refresh_alive(snap)
            plan = self.lex.plan(snap, token_rows)
        except SnapshotStale:
            self.lex._kick_background_rebuild()
            return self._handoff("compaction", b)
        except PlanOverflow:
            return self._handoff("overflow", b)
        view = self.brute.device_view()
        if view is None:
            return self._handoff("vec_empty", b)
        m, valid, vec_ids, mutations = view
        l2v = self._ensure_map(snap, mutations)
        if l2v is None:
            return self._handoff("vec_race", b)
        dev = self.lex.device
        lex_args = self.lex.device_args(snap, *plan)
        qn = l2_normalize(torch.as_tensor(
            np.asarray(queries_emb, np.float32)).to(dev)).contiguous()
        tail = (torch.tensor([int(e["n_cand"]) for e in extras], device=dev),
                torch.tensor([e["w"][0] for e in extras], dtype=torch.float32, device=dev),
                torch.tensor([e["w"][1] for e in extras], dtype=torch.float32, device=dev))
        out = fused_single(*lex_args, l2v, qn, m, valid, *tail, kq=kq)
        ls, lgrow, vs, vi, fs, fpos = (x.cpu().numpy() for x in out)
        self.counts["dispatch"] += 1
        rows = self._decode(snap, vec_ids, delta, token_rows, extras,
                            ls, lgrow, vs, vi, fs, fpos, kq)
        for row in rows:
            self.counts[row["served_by"]] += 1
        return rows

    def _decode(self, snap, vec_ids, delta, token_rows, extras,
                ls, lgrow, vs, vi, fs, fpos, kq):
        """Per-request ranked lists from one dispatch's candidates. With
        docs written since the build, their exact host scores merge into
        the lexical list and the (bitwise-compatible) host ``rrf_fuse``
        re-fuses that row, which is then served by ``host``."""
        row_ids = snap["row_ids"]
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
            for c in range(vs.shape[1]):
                if vs[r, c] < 0.5 * NEG_INF or len(vec_hits) >= n_cand:
                    break
                eid = vec_ids[int(vi[r, c])]
                if eid is None:
                    continue
                vec_by_pos[c] = eid
                vec_hits.append((eid, float(vs[r, c])))
            served_by = TIER_BRUTE_F32
            if delta:
                lex_hits = self.lex._merge_delta([lex_hits], delta,
                                                 [token_rows[r]], n_cand)[0]
                fused = rrf_fuse([lex_hits, vec_hits],
                                 weights=list(extras[r]["w"]), limit=n_cand)
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
