"""Device graph ANN: a CAGRA-style fixed-out-degree index (counterpart
of ``nornicdb_tpu/search/cagra.py``, one device).

- **Build.** A k-NN graph from B1, the fused cosine top-k
  (``ops/topk.py:fused_cosine_topk``), in chunks of 1,024 queries at
  k = degree + 1 (``knn_forward``); then the reference's rank-based
  reorder on the host (``rank_reorder``, NumPy, copied exactly): the top
  degree/2 forward edges stay, reverse edges fill the rest, which gives
  clustered data the reachability a pure k-NN graph lacks.
- **Search.** ``walk_body``: a seed round over ``n_seeds`` strided rows,
  then a fixed number of iterations that expand the best ``width``
  unexplored entries of an ``itopk`` pool, skip neighbours already seen
  (a per-query hash bitmask) and merge the fresh ones into the pool, and
  a final top-k. The reference runs it as one jitted XLA program, not as
  a Pallas kernel; here it is PyTorch ops on the device of its inputs,
  with every top-k a stable sort (ties to the lower index, as
  ``lax.top_k``).
- **Freshness.** The index wraps a ``BruteForceIndex``, the mutable
  source of truth. Rows removed after a build are filtered by liveness,
  rows added or updated are scored exactly from the brute index's
  changelog and merged in; churn past ``rebuild_stale_frac`` starts one
  background rebuild while the old graph serves. Below ``min_n`` live
  rows, and at three named steps (a deeper request than the pool, a
  changelog that no longer reaches the build, a row left short by the
  live filter), the brute index answers, counted by reason in ``counts``.

Under ``NORNICDB_VECTOR_QUANT`` (int8 or pq) the build quantizes the
graph's base (``device_quant.quantize_graph_base``): the card holds int8
PCA-projected codes with their head column and scales, or PQ codes and
codebooks, and the float32 rows stay on the host. The walk is then
``_walk_body_quant`` (head prefilter, then the full int8 dot, keeping
``NORNICDB_QUANT_WALK_KEEP``, by default 3/4 of each expansion) or
``_walk_body_pq`` (ADC over a pool 4x as wide, at most 1,024), and the
whole pool is re-scored exactly on the host rows, so every answered score
is an exact cosine.

``save``/``load`` keep the vectors only, as the reference's do; the
graph is rebuilt on demand. As the reference's, the index counts its
lifecycle and step-downs in ``nornicdb_cagra_events_total``, records each
walk as ``record_dispatch("cagra_walk", ...)`` with its ``price_walk*``
cost, and reports its device arrays through ``resource_stats`` (fed by
``device_bytes``). As the reference's, a walk that serves notes its tier
for the batch leader (``audit.note_batch_tier``: ``vector_walk_f32`` or
``vector_walk_quant``); each step down to exact brute force is one
degrade-ledger record, and the walk steps down while the shadow-parity
auditor quarantines its tier or the admission posture is ``degrade`` or
worse (reasons ``quarantine``, ``admission``). A background rebuild runs on
the background admission lane.

With ``n_shards`` > 1 (``NORNICDB_CAGRA_SHARDS`` on the ``cagra`` profile,
``NORNICDB_HYBRID_SHARDS`` on the fused tier's own graph) the build takes
the reference's layout: live row ``i`` goes to shard ``i // ceil(n / s)``,
each shard padded to ``rows_per_shard = pad_dim(ceil(n / s))`` rows with a
graph over its own rows (B1 k-NN and the reorder per shard), sliced once
(``shard_slices``). A walk then runs each shard apart and merges them in
shard order (``_walk_shards_single_device``, ``ops/similarity.py:concat_topk``),
the reference's loop for more shards than devices. With at least as many
devices as shards (``parallel/mesh.py:mesh_members``) each shard's rows go
to its member device at build, its k-NN runs there, and its graph stays
there (``members``; the full arrays are not kept): a walk then runs one
shard a member and merges on member 0 (``_walk_mesh``, the reference's
``sharded_cagra_walk``), bitwise the loop's. A sharded graph keeps float32
under quant (the quantized walks are one-shard), counted as
``quant_shards``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch import admission as _adm
from nornicdb_tpu_torch._device import DeviceLike
from nornicdb_tpu_torch.config import env_int
from nornicdb_tpu_torch.obs import REGISTRY, declare_kind, record_dispatch
from nornicdb_tpu_torch.obs import audit as _audit
from nornicdb_tpu_torch.obs import cost as _cost
from nornicdb_tpu_torch.ops.similarity import (
    NEG_INF,
    concat_topk,
    l2_normalize,
    pad_dim,
    topk_stable,
)
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk
from nornicdb_tpu_torch.parallel.mesh import (
    layout_members,
    merge_members,
    mesh_members,
    place_rows,
    run_members,
    sync_members,
    to_member,
)
from nornicdb_tpu_torch.search.ann_quality import CAGRA_ITOPK, CAGRA_WIDTH
from nornicdb_tpu_torch.search.device_quant import (
    _walk_body_pq,
    _walk_body_quant,
    quant_mode,
    quantize_graph_base,
)
from nornicdb_tpu_torch.search.microbatch import pow2_bucket
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

_HASH_MULT = 2654435761  # Knuth's multiplicative hash, as a uint32
# one sequence over every index: consumers key per-graph state on it, and
# two indexes' first builds must not share a number
_BUILD_SEQ = itertools.count(1)

# graph (re)builds, delta side-scans merged into walk results and the
# exact-fallback reasons
_CAGRA_C = REGISTRY.counter(
    "nornicdb_cagra_events_total",
    "CAGRA index lifecycle and per-search freshness decisions",
    labels=("event",))

declare_kind("cagra_walk")

# counts[] reason -> the reference's event label
_FALLBACK_EVENTS = {"itopk_exceeded": "exact_fallback_itopk",
                    "changelog_overrun": "exact_fallback_changelog",
                    "underfill": "exact_fallback_underfill",
                    "quarantine": "exact_fallback_quarantine",
                    "admission": "exact_fallback_quarantine"}


def hash_bucket(ids: torch.Tensor, hash_bits: int) -> torch.Tensor:
    """The reference's ``(uint32(ids) * _HASH_MULT) >> (32 - hash_bits)``
    with uint32 wraparound. PyTorch has no full uint32 arithmetic, so the
    product runs in int64 (exact for ids below 2^31) and is masked to its
    low 32 bits before the shift."""
    h = ((ids.to(torch.int64) & 0xFFFFFFFF) * _HASH_MULT) & 0xFFFFFFFF
    return h >> (32 - hash_bits)


def walk_body(
    queries: torch.Tensor,  # [B, D] L2-normalized
    matrix: torch.Tensor,  # [C, D] L2-normalized, zero pad rows
    adj: torch.Tensor,  # [C, deg] int32 rows (pad rows -> 0)
    validf: torch.Tensor,  # [C] float32 {0, 1}
    k: int,
    iters: int,
    width: int,
    itopk: int,
    hash_bits: int,
    n_seeds: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration batched greedy walk (the reference's
    ``_walk_body``). Returns (scores [B, k], rows [B, k] int32)
    best-first; slots that never filled score <= NEG_INF."""
    b = queries.shape[0]
    c, deg = adj.shape
    p = itopk
    m = width * deg
    dev = queries.device
    neg = torch.tensor(NEG_INF, dtype=queries.dtype, device=dev)
    # seed round: strided rows, so every sizable cluster gets an entry
    # point; when c < s0 the ids wrap around and the repeats are masked,
    # so no id can surface twice with a finite score
    s0 = max(n_seeds, p)
    stride = max(1, c // s0)
    seed_n = torch.arange(s0, device=dev)
    seed_ids = ((seed_n * stride) % c).to(adj.dtype)
    seed_ok = (seed_n < c) & (validf[seed_ids] > 0.0)
    seed_s = torch.where(seed_ok[None, :], queries @ matrix[seed_ids].T, neg)
    pool_s, pos0 = topk_stable(seed_s, p)
    pool_i = seed_ids[pos0]
    explored = torch.zeros((b, p), dtype=torch.bool, device=dev)
    # visited hash bitmask per query: a collision only ever skips a row.
    # Every scored seed is marked: the pool only improves, so a seed that
    # lost the seed round cannot reach a final top-k with k <= itopk.
    visited = torch.zeros((b, 1 << hash_bits), dtype=torch.uint8, device=dev)
    visited[:, hash_bucket(seed_ids, hash_bits)] = 1
    slot = torch.arange(p, device=dev)
    mcol = torch.arange(m, device=dev)
    # earlier[0, i, j]: column j precedes column i in one expansion
    earlier = (mcol[None, :] < mcol[:, None])[None]
    unexplored = torch.zeros((b, m), dtype=torch.bool, device=dev)
    for _ in range(iters):
        # frontier: the best `width` unexplored pool entries
        f_s, f_pos = topk_stable(torch.where(explored, neg, pool_s), width)
        f_ids = torch.gather(pool_i, 1, f_pos)
        explored = explored | (slot[None, None, :] == f_pos[:, :, None]).any(1)
        f_ok = f_s > 0.5 * NEG_INF  # an exhausted pool expands nothing
        nbrs = adj[f_ids].reshape(b, m)
        h = hash_bucket(nbrs, hash_bits)
        seen = torch.gather(visited, 1, h) > 0
        dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(2)
        fresh = (f_ok.repeat_interleave(deg, dim=1) & ~seen & ~dup
                 & (validf[nbrs] > 0.0))
        scores = torch.bmm(matrix[nbrs], queries[:, :, None])[:, :, 0]
        scores = torch.where(fresh, scores, neg)
        # max is an OR, well defined when two neighbours of one query share
        # a bucket; a plain store would leave the winner undefined
        visited.scatter_reduce_(1, h, fresh.to(torch.uint8), "amax")
        pool_s, pos = topk_stable(torch.cat([pool_s, scores], 1), p)
        pool_i = torch.gather(torch.cat([pool_i, nbrs], 1), 1, pos)
        explored = torch.gather(torch.cat([explored, unexplored], 1), 1, pos)
    top_s, pos = topk_stable(pool_s, k)
    return top_s, torch.gather(pool_i, 1, pos)


def merge_delta_hits(
    hits: Sequence[Tuple[str, float]],
    delta_ids: Sequence[str],
    delta_scores,
    k: int,
) -> List[Tuple[str, float]]:
    """One ranked list with exact delta scores merged in: an updated id's
    stale entry is replaced, the list re-sorts by score and is cut to
    ``k`` (the reference's read-your-writes merge)."""
    merged = dict(hits)
    for j, eid in enumerate(delta_ids):
        merged[eid] = float(delta_scores[j])
    return sorted(merged.items(), key=lambda kv: -kv[1])[:k]


def rerank_pool(matrix: np.ndarray, qn: np.ndarray, s: np.ndarray, i: np.ndarray,
                k: int) -> Tuple[np.ndarray, np.ndarray]:
    """A quantized walk's pool (approximate scores ``s``, rows ``i``
    [B, P]) re-scored exactly against the host float32 ``matrix``, sorted
    (stable) and cut to ``k``; never-filled slots stay at NEG_INF."""
    exact = np.einsum("bpd,bd->bp", matrix[i], qn)
    exact = np.where(s > 0.5 * NEG_INF, exact, np.float32(NEG_INF)).astype(np.float32)
    order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(exact, order, axis=1), np.take_along_axis(i, order, axis=1)


# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------


def knn_forward(matrix: torch.Tensor, degree: int, chunk: int = 1024) -> np.ndarray:
    """Forward k-NN edges [n, deg] by rank, self excluded: B1 over the
    normalized rows ``matrix`` [n, D] in query chunks of ``chunk`` at
    k = deg + 1 (its plain version on the CPU)."""
    n = matrix.shape[0]
    deg = min(degree, max(n - 1, 1))
    k_knn = min(deg + 1, n)
    valid = torch.ones(n, dtype=torch.bool, device=matrix.device)
    fwd = np.empty((n, deg), dtype=np.int32)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        _, idx = fused_cosine_topk(matrix[start:stop], matrix, valid, k_knn)
        idx = idx.cpu().numpy().astype(np.int32)
        # drop self wherever it ranked (duplicate vectors can push it out
        # of the top-k); the stable sort keeps the others in rank order
        not_self = idx != np.arange(start, stop, dtype=np.int32)[:, None]
        order = np.argsort(~not_self, axis=1, kind="stable")
        fwd[start:stop] = np.take_along_axis(idx, order, axis=1)[:, :deg]
    return fwd


def rank_reorder(fwd: np.ndarray, degree: int, chunk: int = 8192) -> np.ndarray:
    """CAGRA-style rank-based reordering (the reference's
    ``_rank_reorder``): keep the top ``degree//2`` forward edges, fill the
    rest with rank-ordered reverse edges (deduplicated against the kept
    set), then backfill with the remaining forward edges."""
    n, deg = fwd.shape
    if n <= 1:
        return np.zeros((n, degree), dtype=np.int32)
    keep_f = min(max(degree // 2, 1), deg)

    # reverse lists grouped by destination, ordered (rank, src)
    dst = fwd.ravel()
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    rank = np.tile(np.arange(deg, dtype=np.int32), n)
    order = np.lexsort((src, rank, dst))
    dsts, srcs = dst[order], src[order]
    counts = np.bincount(dsts, minlength=n)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    pos = np.arange(len(dsts), dtype=np.int64) - offsets[dsts]
    rev = np.full((n, degree), -1, dtype=np.int32)
    take = pos < degree
    rev[dsts[take], pos[take]] = srcs[take]

    adj = np.full((n, degree), -1, dtype=np.int32)
    adj[:, :keep_f] = fwd[:, :keep_f]
    fill_w = degree - keep_f
    if fill_w == 0:
        return adj
    cand = np.concatenate([rev, fwd[:, keep_f:]], axis=1)
    mc = cand.shape[1]
    earlier = np.arange(mc)[None, :] < np.arange(mc)[:, None]
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        c = cand[start:stop]
        bad = (c < 0) | (c == np.arange(start, stop, dtype=np.int32)[:, None])
        bad |= (c[:, :, None] == adj[start:stop, None, :keep_f]).any(2)
        bad |= ((c[:, :, None] == c[:, None, :]) & earlier[None]).any(2)
        good_first = np.argsort(bad, axis=1, kind="stable")
        picked = np.take_along_axis(c, good_first[:, :fill_w], axis=1)
        n_good = (~bad).sum(axis=1)
        usable = np.arange(fill_w)[None, :] < n_good[:, None]
        # short rows repeat their best forward edge: a repeated slot is a
        # no-op at search time (visited mask), never a wrong edge
        adj[start:stop, keep_f:] = np.where(usable, picked, fwd[start:stop, :1])
    return adj


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------


class CagraIndex:
    """Fixed-out-degree graph ANN over a wrapped ``BruteForceIndex``, on
    that index's device.

    ``counts``: ``walk`` per walk dispatch, ``delta_merge`` per walk batch
    that merged post-build writes, ``fallback_<reason>`` per batch the
    brute index answered at a named step (``itopk_exceeded``,
    ``changelog_overrun``, ``underfill``), ``background_rebuild`` per
    rebuild started off the search path, ``quant_shards`` per build that
    kept float32 under quant because it is sharded. ``build_s`` splits the latest
    build into ``device_copy``, ``knn_forward``, ``reorder``, ``quantize``
    and ``total`` host seconds."""

    def __init__(
        self,
        dims: Optional[int] = None,
        degree: int = 32,
        itopk: int = CAGRA_ITOPK,
        search_width: int = CAGRA_WIDTH,
        iters: Optional[int] = None,
        hash_bits: int = 16,
        n_seeds: int = 1024,
        min_n: int = 4096,
        n_shards: int = 1,
        rebuild_stale_frac: float = 0.1,
        build_inline: bool = True,
        brute: Optional[BruteForceIndex] = None,
        device: DeviceLike = None,
    ):
        if itopk <= 0 or itopk & (itopk - 1):
            raise ValueError(f"itopk must be a positive power of two, got {itopk}")
        self.degree = degree
        self.itopk = itopk
        self.search_width = search_width
        self.iters = iters
        self.hash_bits = hash_bits
        self.n_seeds = n_seeds
        self.min_n = min_n
        self.n_shards = max(1, n_shards)
        self.rebuild_stale_frac = rebuild_stale_frac
        # False defers even the first build to a background thread (the
        # brute index answers until it lands); True blocks once
        self.build_inline = build_inline
        self._brute = brute if brute is not None else BruteForceIndex(dims, device=device)
        self.device = self._brute.device
        self._graph: Optional[Dict[str, Any]] = None
        self._build_lock = threading.Lock()
        self._rebuilding = False
        self._rebuild_started = 0.0  # the open rebuild's start (resource_stats)
        self._rebuild_flag_lock = threading.Lock()
        # a background build that raised: re-raised by every later
        # ensure_graph instead of building again
        self._build_error: Optional[BaseException] = None
        # (brute mutations, built mutations, ids, vectors) of the last
        # delta block: unchanged until a write lands
        self._delta_cache: Optional[Tuple] = None
        self.builds = 0
        self.build_s: Dict[str, float] = {}
        self.counts: Counter = Counter()

    # -- writes go to the brute index, the source of truth; they may also
    # reach it directly (the service's do), so freshness reads its counters

    def add(self, ext_id: str, vector: Sequence[float]) -> None:
        self._brute.add(ext_id, vector)

    def add_batch(self, items) -> None:
        self._brute.add_batch(items)

    def remove(self, ext_id: str) -> bool:
        return self._brute.remove(ext_id)

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """Vectors only (the brute index's ``.npz``): the graph is derived
        state, rebuilt on demand after a load."""
        self._brute.save(path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None, **kwargs) -> "CagraIndex":
        return cls(brute=BruteForceIndex.load(path, device=device), **kwargs)

    # -- build ------------------------------------------------------------

    def _auto_iters(self, n: int) -> int:
        # ~0.75 * log2(n) hops after the wide seed round, floor 8
        return max(8, int(np.ceil(0.75 * np.log2(max(n, 4)))))

    def build(self) -> bool:
        """(Re)build the graph from the brute snapshot. False when below
        ``min_n`` (the brute index answers)."""
        with self._build_lock:
            return self._build_locked()

    def _build_locked(self) -> bool:
        mutations = self._brute.mutations
        g = self._graph
        if g is not None and g["built_mutations"] == mutations:
            return True  # raced another build over the same snapshot
        t0 = time.perf_counter()
        matrix, valid, ext_ids = self._brute.snapshot()
        live = [i for i, e in enumerate(ext_ids) if e is not None and valid[i]]
        n = len(live)
        if n < self.min_n:
            self._graph = None
            return False
        # shard sh holds live rows [sh * base, (sh + 1) * base) at sh * r; a
        # last shard may be empty
        s_n = self.n_shards
        base = -(-n // s_n)
        r = pad_dim(base)
        spans = [(sh, sh * base, min((sh + 1) * base, n)) for sh in range(s_n)]
        spans = [(sh, lo, hi) for sh, lo, hi in spans if lo < hi]
        mat = np.zeros((s_n * r, matrix.shape[1]), dtype=np.float32)
        validf = np.zeros((s_n * r,), dtype=np.float32)
        row_ids: List[Optional[str]] = [None] * (s_n * r)
        for sh, lo, hi in spans:
            at = slice(sh * r, sh * r + hi - lo)
            mat[at] = matrix[live[lo:hi]]
            validf[at] = 1.0
            row_ids[at] = [ext_ids[i] for i in live[lo:hi]]
        t1 = time.perf_counter()
        members = mesh_members(s_n, self.device)
        if members is None:
            mat_dev = torch.from_numpy(mat).to(self.device)
            mat_parts = [mat_dev[sh * r:(sh + 1) * r] for sh in range(s_n)]
        else:
            # placed once: shard i's rows on member i, where its k-NN runs
            mat_dev = None
            mat_parts = place_rows(mat, members)
        t2 = time.perf_counter()
        # each shard's graph over its own rows: B1 k-NN, then the reorder
        fwds = [knn_forward(mat_parts[sh][:hi - lo], self.degree) for sh, lo, hi in spans]
        t3 = time.perf_counter()
        adj = np.zeros((s_n * r, self.degree), dtype=np.int32)
        for (sh, lo, hi), fwd in zip(spans, fwds):
            adj[sh * r:sh * r + hi - lo] = rank_reorder(fwd, self.degree)
        t4 = time.perf_counter()
        quant = None
        if quant_mode() != "off":
            if s_n == 1:
                # None: a PQ gap (indivisible dims, too few rows), the f32 base serves
                quant = quantize_graph_base(mat, self.device)
                if quant is not None and quant["mode"] == "int8":
                    quant["keep"] = max(8, env_int(
                        "QUANT_WALK_KEEP", (3 * self.search_width * self.degree) // 4))
            else:
                # the quantized walks are one-shard: a sharded graph keeps float32
                self.counts["quant_shards"] += 1
        t_q = time.perf_counter()
        graph = {
            "n": n,
            "shards": s_n,
            "rows_per_shard": r,
            "degree": self.degree,
            "quant": quant,
            "row_ids": row_ids,
            "iters": self.iters if self.iters is not None else self._auto_iters(n),
            "built_mutations": mutations,
            "build_seq": next(_BUILD_SEQ),
        }
        if members is None:
            graph.update(
                # under quant the float32 rows stay on the host (the rerank's)
                matrix=mat if quant is not None else mat_dev,
                adj=torch.from_numpy(adj).to(self.device),
                validf=torch.from_numpy(validf).to(self.device))
            if s_n > 1:
                # cut once: each walk reads its shard's rows, adjacency and flags
                graph["shard_slices"] = [
                    tuple(graph[key][sh * r:(sh + 1) * r] for key in ("matrix", "adj", "validf"))
                    for sh in range(s_n)]
        else:
            # each member holds its shard only
            graph.update(matrix=None, adj=None, validf=None, members=members,
                         shard_slices=list(zip(mat_parts, place_rows(adj, members),
                                               place_rows(validf, members))))
            sync_members(members)
        t5 = time.perf_counter()
        self._graph = graph
        self.builds += 1
        _CAGRA_C.labels("build").inc()
        self.build_s = {"device_copy": (t2 - t1) + (t5 - t_q), "knn_forward": t3 - t2,
                        "reorder": t4 - t3, "quantize": t_q - t4, "total": t5 - t0}
        return True

    def ensure_graph(self) -> Optional[Dict[str, Any]]:
        """The current graph under the rebuild policy (churn starts a
        background rebuild; the stale graph keeps serving), or None while
        callers must take an exact tier. Raises once a background build
        has failed."""
        if self._build_error is not None:
            raise RuntimeError("the CAGRA graph's background build failed") \
                from self._build_error
        g = self._graph
        if g is not None:
            churn = self._brute.mutations - g["built_mutations"]
            if churn > self.rebuild_stale_frac * max(g["n"], 1):
                # the stale graph keeps serving (deletes filtered, writes
                # merged) while a fresh one builds off the search path
                self._kick_background_rebuild()
            return g
        if len(self._brute) < self.min_n:
            return None
        if not self.build_inline:
            self._kick_background_rebuild()
            return self._graph
        self.build()
        return self._graph

    def _kick_background_rebuild(self) -> None:
        with self._rebuild_flag_lock:
            if self._rebuilding:
                return
            self._rebuilding = True
            self._rebuild_started = time.time()
        self.counts["background_rebuild"] += 1
        _CAGRA_C.labels("background_rebuild").inc()

        def run():
            try:
                # the background lane: a coalescer ride from this thread
                # seals behind interactive work
                with _adm.lane_scope(_adm.LANE_BACKGROUND):
                    self.build()
            except BaseException as exc:  # noqa: BLE001 -- re-raised by ensure_graph
                self._build_error = exc
            finally:
                with self._rebuild_flag_lock:
                    self._rebuilding = False
                    self._rebuild_started = 0.0

        threading.Thread(target=run, name="cagra-rebuild", daemon=True).start()

    @property
    def graph_built(self) -> bool:
        return self._graph is not None

    def device_bytes(self) -> int:
        """Bytes of the graph's device arrays: adjacency, validity, and the
        float32 matrix or, under quant, the compressed base (int8: codes,
        head, scales, rotation; PQ: codes, codebooks)."""
        g = self._graph
        if g is None:
            return 0
        quant = g["quant"]
        if "members" in g:
            return sum(a.numel() * a.element_size() for part in g["shard_slices"] for a in part)
        if quant is None:
            arrays = [g["matrix"]]
        elif quant["mode"] == "pq":
            arrays = [quant["codes"], quant["codebooks"]]
        else:
            arrays = [quant[key] for key in ("codes", "codes_head", "scale", "rot_dev")]
        return sum(a.numel() * a.element_size() for a in arrays + [g["adj"], g["validf"]])

    def resource_stats(self) -> Dict[str, Any]:
        """Memory and freshness accounting for obs/resources.py: the
        graph's device bytes (``device_bytes``), the host row-id table
        (and under quant the float32 base, held on the host), the
        mutation gap between the live brute index and the built graph,
        and the background-rebuild backlog."""
        g = self._graph
        stats: Dict[str, Any] = {}
        host_extra = 0
        if g is not None and g["quant"] is not None:
            quant = g["quant"]
            f32_base = int(g["matrix"].nbytes)  # the host rerank's rows
            host_extra = f32_base
            keys = (("codes", "codebooks") if quant["mode"] == "pq"
                    else ("codes", "codes_head", "scale", "rot_dev"))
            quant_b = sum(quant[key].numel() * quant[key].element_size() for key in keys)
            stats = {"quant_device_bytes": quant_b,
                     "compression_ratio": round(f32_base / max(quant_b, 1), 3)}
        started = self._rebuild_started
        return {
            **stats,
            "rows": g["n"] if g is not None else 0,
            "capacity": (g["shards"] * g["rows_per_shard"]) if g is not None else 0,
            "device_bytes": self.device_bytes(),
            "host_bytes": (8 * len(g["row_ids"]) + host_extra) if g is not None else 0,
            "mutation_gap": (self._brute.mutations - g["built_mutations"]) if g is not None else 0,
            "rebuild_in_flight": 1.0 if self._rebuilding else 0.0,
            "rebuild_backlog_s": (round(time.time() - started, 3)
                                  if self._rebuilding and started else 0.0),
            "builds": self.builds,
        }

    def stats(self) -> Dict[str, Any]:
        g = self._graph
        return {
            "n_alive": len(self._brute),
            "graph_built": g is not None,
            "graph_n": g["n"] if g else 0,
            "shards": g["shards"] if g else 0,
            "degree": self.degree,
            "itopk": self.itopk,
            "iters": g["iters"] if g else None,
            "builds": self.builds,
        }

    # -- search -----------------------------------------------------------

    def search(self, query: Sequence[float], k: int = 10, **kw) -> List[Tuple[str, float]]:
        return self.search_batch(np.asarray([query], dtype=np.float32), k, **kw)[0]

    def search_batch(
        self,
        queries: np.ndarray,
        k: int = 10,
        itopk: Optional[int] = None,
        iters: Optional[int] = None,
        width: Optional[int] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Batched ANN search; per query [(ext_id, cosine)] best-first.
        The batch and k are padded to powers of two, as in the reference
        (the answers do not depend on the batch's padding). ``itopk``,
        ``iters`` and ``width`` override the index's for sweeps."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError(f"queries must be [B, D], got {queries.shape}")
        if len(queries) == 0:
            return []
        g = self.ensure_graph()
        if g is None:
            return self._brute.search_batch(queries, k)
        quant = g["quant"]
        tier = "vector_walk_quant" if quant is not None else "vector_walk_f32"
        hold = None
        if not _audit.tier_allowed(tier):
            hold = "quarantine"  # the shadow-parity auditor's breach
        elif not _audit.admission_allows(tier):
            hold = "admission"  # overload sheds device pressure
        if hold is not None:
            return self._fallback(hold, queries, k, tier, g)
        p = itopk or self.itopk
        if quant is not None and quant["mode"] == "pq" and itopk is None:
            # ADC noise steers the walk: a pool 4x as wide for the rerank
            p = min(4 * p, 1024)
        if min(k, g["n"]) > p:
            # the pool only ever holds itopk candidates
            return self._fallback("itopk_exceeded", queries, k, tier, g)
        delta_ids, delta_vecs = self.delta_block(g)
        if delta_ids is None:
            return self._fallback("changelog_overrun", queries, k, tier, g)
        k_eff = min(k, g["n"], p)
        if k_eff < 1:
            return [[] for _ in range(len(queries))]
        b = len(queries)
        bb = pow2_bucket(b)
        kb = min(pow2_bucket(k_eff), p)
        padded = np.concatenate(
            [queries, np.broadcast_to(queries[:1], (bb - b,) + queries.shape[1:])])
        qn = l2_normalize(torch.from_numpy(padded).to(self.device))
        n_iters = iters if iters is not None else g["iters"]
        w = width or self.search_width
        t0 = time.time()
        if quant is None:
            if g["shards"] == 1:
                s, i = walk_body(qn, g["matrix"], g["adj"], g["validf"], kb, n_iters, w, p,
                                 self.hash_bits, self.n_seeds)
            elif layout_members(g, self.device) is not None:
                s, i = self._walk_mesh(g, qn, kb, n_iters, w, p)
            else:
                s, i = self._walk_shards_single_device(g, qn, kb, n_iters, w, p)
            s, i = s.cpu().numpy(), i.cpu().numpy()
        else:
            s, i = self._walk_quant(g, qn, kb, n_iters, w, p)
        # the answer reached the host inside the timed window
        record_dispatch("cagra_walk", bb, kb, time.time() - t0)
        self.counts["walk"] += 1
        # the seed round plus iters x width x degree distance evaluations
        # at the padded batch; the real queries counted
        if _cost.pricing_enabled():
            d = int(queries.shape[1])
            if quant is None:
                flops, byts = _cost.price_walk(bb, d, n_iters, w, self.degree, p,
                                               n_seeds=self.n_seeds)
            else:
                if quant["mode"] == "pq":
                    flops, byts = _cost.price_walk_pq(bb, d, n_iters, w, self.degree, p,
                                                      quant["pq_m"], quant["pq_codes"],
                                                      n_seeds=self.n_seeds)
                else:
                    flops, byts = _cost.price_walk_quant(bb, d, n_iters, w, self.degree, p,
                                                         quant["head_dims"], quant["keep"],
                                                         n_seeds=self.n_seeds)
                rf, rb = _cost.price_rerank(bb, p, d)
                flops, byts = flops + rf, byts + rb
            _cost.record_query_cost("cagra_walk", _cost.cost_name(self), b, flops, byts)
        out = self._resolve(g, s[:b], i[:b], k_eff)
        if delta_ids:
            self.counts["delta_merge"] += 1
            _CAGRA_C.labels("delta_merge").inc()
            ds = qn[:b].cpu().numpy() @ delta_vecs.T  # stored rows are normalized
            out = [merge_delta_hits(hits, delta_ids, ds[r], k_eff)
                   for r, hits in enumerate(out)]
        # the live filter can leave a row short though live rows remain
        # (deletes around the query): the batch is answered exactly
        want = min(k_eff, len(self._brute))
        if any(len(hits) < want for hits in out):
            return self._fallback("underfill", queries, k, tier, g)
        _audit.note_batch_tier(tier)
        return out

    def _walk_shards_single_device(self, g, qn, kb, n_iters, w, p):
        """The sharded graph on one device (the reference's
        ``_walk_shards_single_device``): a walk of each shard's own rows,
        rows made global at ``sh * rows_per_shard``, merged in shard order
        by ``concat_topk``. Each shard is walked apart, so the answer need
        not equal one walk of all rows: it is held by recall."""
        r = g["rows_per_shard"]
        parts_s, parts_i = [], []
        for sh, slices in enumerate(g["shard_slices"]):
            # a graph placed on a mesh is read on this device
            m_sh, a_sh, v_sh = (x.to(qn.device) for x in slices)
            s, i = walk_body(qn, m_sh, a_sh, v_sh, kb, n_iters, w, p, self.hash_bits,
                             self.n_seeds)
            parts_s.append(s)
            parts_i.append(i.to(torch.int64) + sh * r)
        return concat_topk(parts_s, parts_i, kb)

    def _walk_mesh(self, g, qn, kb, n_iters, w, p):
        """The graph on its mesh (the reference's ``sharded_cagra_walk``):
        a walk of each member's own rows and shard-local adjacency, rows
        made global at ``m * rows_per_shard``, merged on member 0 in member
        order; ``_walk_shards_single_device``'s operations."""
        r = g["rows_per_shard"]

        def local(m, dev):
            s, i = walk_body(*(to_member(x, dev) for x in (qn, *g["shard_slices"][m])), kb,
                             n_iters, w, p, self.hash_bits, self.n_seeds)
            return s, i.to(torch.int64) + m * r

        return merge_members(run_members("cagra_walk", g["members"], local), kb)

    def _walk_quant(self, g, qn, kb, n_iters, w, p):
        """The walk over the quantized base, then the whole pool re-scored
        exactly on the host's float32 rows: (scores, rows) host arrays
        [B, kb], best first (ties to the pool's order)."""
        q = g["quant"]
        if q["mode"] == "pq":
            s, i = _walk_body_pq(qn, q["codes"], q["codebooks"], g["adj"], g["validf"],
                                 p, n_iters, w, p, self.hash_bits, self.n_seeds)
        else:
            s, i = _walk_body_quant(qn @ q["rot_dev"], q["codes"], q["codes_head"], q["scale"],
                                    g["adj"], g["validf"], p, n_iters, w, p, self.hash_bits,
                                    self.n_seeds, q["keep"])
        return rerank_pool(g["matrix"], qn.cpu().numpy(), s.cpu().numpy(), i.cpu().numpy(), kb)

    def _fallback(self, reason: str, queries: np.ndarray, k: int, tier: str, g):
        """Exact brute force for this batch, counted and ledgered."""
        self.counts["fallback_" + reason] += 1
        _CAGRA_C.labels(_FALLBACK_EVENTS[reason]).inc()
        _audit.record_degrade(
            "vector", tier, "vector_brute_f32", reason,
            index=_cost.cost_name(self._brute),
            versions={"build_seq": g.get("build_seq"),
                      "built_mutations": g.get("built_mutations"),
                      "mutations": getattr(self._brute, "mutations", 0)})
        return self._brute.search_batch(queries, k)

    def delta_block(self, g) -> Tuple[Optional[List[str]], Optional[np.ndarray]]:
        """(ids, vectors [m, D]) added or updated since ``g`` was built,
        from the brute changelog (writes that bypassed this wrapper
        included), memoized on the mutation counter; (None, None) when the
        changelog no longer reaches back to the build."""
        m = self._brute.mutations
        cached = self._delta_cache
        if cached is not None and cached[0] == m and cached[1] == g["built_mutations"]:
            return cached[2], cached[3]
        ids = self._brute.changed_since(g["built_mutations"])
        if ids is None:
            block = (None, None)
        else:
            pairs = [(eid, v) for eid, v in ((e, self._brute.get(e)) for e in ids)
                     if v is not None]  # None: removed since it was logged
            block = ([eid for eid, _ in pairs],
                     np.stack([v for _, v in pairs]) if pairs else None)
        self._delta_cache = (m, g["built_mutations"], block[0], block[1])
        return block

    def _resolve(self, g, s, i, k_eff):
        """Walk rows to ext ids, dropping never-filled slots and rows
        removed since the build."""
        row_ids = g["row_ids"]
        stale = self._brute.mutations != g["built_mutations"]
        out: List[List[Tuple[str, float]]] = []
        for row in range(s.shape[0]):
            hits: List[Tuple[str, float]] = []
            for col in range(s.shape[1]):
                if s[row, col] < 0.5 * NEG_INF:
                    break
                eid = row_ids[int(i[row, col])]
                if eid is None or (stale and eid not in self._brute):
                    continue
                hits.append((eid, float(s[row, col])))
                if len(hits) >= k_eff:
                    break
            out.append(hits)
        return out
