"""Hybrid search service: BM25 + vector + RRF, with the strategy machine
and the result cache (counterpart of
``nornicdb_tpu/search/service.py:SearchService``).

BM25 and the vector tier each give ``max(limit*3, 30)`` candidates,
``rrf_fuse`` ranks them, the ``min_score`` gate filters on raw scores,
and hits are enriched from storage. Results are cached by query and
options (``cache.py:ResultCache``: LRU 1000, TTL 300 s); every index
mutation bumps the cache's generation.

Vector tiers: below ``hnsw_threshold`` (10,000) vectors, exact brute
force, whose concurrent queries coalesce through a micro-batcher into
one batched top-k; at the threshold the strategy machine builds a host
HNSW (BM25-seeded, ``search/hnsw.py``) and vector search is served from
it, as in the reference, or, under the ``cagra`` ANN profile
(``NORNICDB_VECTOR_ANN_QUALITY=cagra``), the device graph
(``search/cagra.py``), whose walks the same micro-batcher coalesces
(``_ann_search_batch``). ``exact=True`` always takes exact brute force
(no plane), never through the batcher. A live write switches at the write
that crosses the threshold; ``build_indexes`` holds the switch back until
its backfill ends, so one build covers the whole corpus. Brute force runs
the index's own ladder (tiered -> quant -> float32, ``vector_index.py``);
with the tiered plane on, a request that carries its BM25 top docs
(``lexical_doc_ids``: the hybrid host path passes its top 32) is routed
by them first, ahead of the graph tiers, as the reference routes it.
``vector_routes`` counts each vector request's route.

Above ``NORNICDB_HYBRID_MIN_N`` (4,096) BM25 documents, hybrid queries
coalesce through a second batcher into one device dispatch of the fused
tier (``hybrid_fused.py``: device BM25 + a vector half + RRF); below it,
while its snapshot builds, and at its freshness rungs the host path
serves, with the vector tier above for its vector half. The fused tier's
vector half is exact (B1) below ``NORNICDB_HYBRID_WALK_MIN_N`` (100,000)
live vectors and the CAGRA walk at and above it, once its graph is built
(``NORNICDB_HYBRID_WALK=0`` keeps it exact); the walk shares the
``cagra`` strategy's graph when there is one. Unlike the reference, an
error on the fused path raises instead of falling back to the host.
Three knobs lay the device tiers out in row shards, served on this one
card by the reference's single-device loops: ``NORNICDB_HYBRID_SHARDS``
(the fused tier's snapshot and its own graph), ``NORNICDB_CAGRA_SHARDS``
(the ``cagra`` strategy's graph) and ``NORNICDB_QUANT_SHARDS`` (the int8
plane, ``vector_index.py``); each is read where the reference reads it,
when its tier is created, and a value below 1 or not a number reads as 1.
A walk tier whose graph has another shard count than the snapshot steps
down to the exact tier (``walk_shard_mismatch``).
With a ``reranker`` (``rerank.py``) the whole fused overfetch is reranked
and then cut to ``limit``, uncached; a ``RuntimeError`` from it raises
(ROADMAP C29), any other error keeps the fused order. ``similar`` finds
the nodes nearest a stored node's embedding through the vector tiers.
Observability as the reference's: ``nornicdb_search_strategy_total``
counts each vector request's route and each fused ride's tier; the
indexes, the batchers' queues, the fused tier's lexical snapshot and the
graphs are registered with ``obs/resources.py`` under
``resource_name`` (``service:neo4j`` unless the caller names the
service); a request's lexical, fuse and rerank stages (and the fused
dispatch's split) ride its trace as spans. Every vector and hybrid
answer is counted by the ladder tier that served it
(``audit.record_served``: per rider through the vector batcher, per row of
the fused tier, ``host``, ``cached``), and with sampling on
(``NORNICDB_AUDIT_SAMPLE``) a device-served answer is offered to the
shadow-parity auditor with an exact reference closure (host BM25, exact
brute force, ``rrf_fuse``); a device fault the auditor raises passes
through the sampling wrappers (ROADMAP C31). A deadline miss in the fused
ride raises ``DeadlineExceeded`` (C7: the fused path fails closed), where
the reference serves the host path. The IVF backends wait for a later
slice.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zipfile
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike
from nornicdb_tpu_torch.cache import ResultCache
from nornicdb_tpu_torch.config import env_bool, env_int
from nornicdb_tpu_torch.errors import is_device_fault
from nornicdb_tpu_torch.obs import REGISTRY, attach_span, register_resource
from nornicdb_tpu_torch.obs import audit as _audit
from nornicdb_tpu_torch.obs import tenant as _tenant
from nornicdb_tpu_torch.search.ann_quality import cagra_shards_from_env, current_profile
from nornicdb_tpu_torch.search.bm25 import BM25Index, tokenize
from nornicdb_tpu_torch.search.cagra import CagraIndex
from nornicdb_tpu_torch.search.hnsw import HNSWIndex
from nornicdb_tpu_torch.search.hybrid_fused import FusedHybrid
from nornicdb_tpu_torch.search.microbatch import MicroBatcher
from nornicdb_tpu_torch.search.rrf import rrf_fuse
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex
from nornicdb_tpu_torch.storage.types import Engine, Node
from nornicdb_tpu_torch.vectorspace import VectorSpaceRegistry

logger = logging.getLogger(__name__)

TEXT_PROPERTIES = ("content", "title", "name", "description", "text", "summary")
# which index the strategy machine routed each vector search to, and
# which tier served each fused hybrid ride
_STRATEGY_C = REGISTRY.counter(
    "nornicdb_search_strategy_total",
    "Vector search dispatches by chosen strategy", labels=("strategy",))
MODES = ("hybrid", "vector", "text")
# a result-cache hit, counted without a labels() probe per query
_HYBRID_CACHED_SERVED = _audit.served_counter("hybrid", "cached")
# HNSW's query beam. At the reference's 64, recall@10 against exact
# search falls under the 0.95 a statistical tier must hold on
# chip_smoke.py's 100,000 documents and short queries (it prints the
# recall at both beams); 128, the beam of the reference's ``accurate``
# profile, holds it. The graph does not depend on it.
HNSW_EF_SEARCH = 128


def _copy_tree(v):
    """Deep copy of plain JSON-shaped data (dicts, lists, scalars)."""
    if isinstance(v, dict):
        return {k: _copy_tree(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_copy_tree(x) for x in v]
    return v


def _copy_hit(r: Dict[str, Any]) -> Dict[str, Any]:
    """Cache-safe copy of one search hit: its properties and labels are
    the node's own by reference, so a caller's mutation of a shallow copy
    would poison the cached entry for the whole TTL."""
    c = dict(r)
    if "properties" in c:
        c["properties"] = _copy_tree(c["properties"])
    if "labels" in c:
        c["labels"] = list(c["labels"])
    return c


def extract_text(node: Node) -> str:
    """Searchable text of a node: title/content-ish properties + labels."""
    parts: List[str] = []
    for key in TEXT_PROPERTIES:
        v = node.properties.get(key)
        if isinstance(v, str) and v:
            parts.append(v)
    parts.extend(node.labels)
    return " ".join(parts)


@dataclass
class SearchResult:
    node_id: str
    score: float
    node: Optional[Node] = None
    bm25_score: Optional[float] = None
    vector_score: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"id": self.node_id, "score": self.score}
        if self.bm25_score is not None:
            d["bm25_score"] = self.bm25_score
        if self.vector_score is not None:
            d["vector_score"] = self.vector_score
        if self.node is not None:
            d["labels"] = self.node.labels
            d["properties"] = self.node.properties
        return d


@dataclass
class SearchStats:
    indexed_docs: int = 0
    indexed_vectors: int = 0
    strategy: str = "brute"
    searches: int = 0
    cache_hits: int = 0
    hnsw_builds: int = 0
    cagra_builds: int = 0
    # per-stage timings of the most recent search, kept while
    # NORNICDB_TPU_SEARCH_DIAG is set
    last_timings: Dict[str, float] = field(default_factory=dict)


class SearchService:
    """One search service per logical database."""

    def __init__(
        self,
        storage: Optional[Engine] = None,
        embedder: Optional[Any] = None,
        device: DeviceLike = None,
        hnsw_threshold: int = 10_000,
        hnsw_m: int = 16,
        hnsw_ef_search: int = HNSW_EF_SEARCH,
        reranker: Optional[Any] = None,
        database: str = "neo4j",
        vector_registry: Optional[VectorSpaceRegistry] = None,
        persist_dir: Optional[str] = None,
        save_debounce_s: float = 5.0,
        resource_name: Optional[str] = None,
    ):
        self.storage = storage
        self.embedder = embedder
        self.reranker = reranker  # stage-2 rerank (rerank.py), optional
        self.device = device
        self.hnsw_threshold = hnsw_threshold
        self._lock = threading.RLock()
        self.bm25 = BM25Index()
        # the document vector index lives in a registered vector space,
        # (database, "node", "embedding"), of this service's registry
        # unless the caller shares one; its brute index is built on the
        # registry's device
        self.database = database
        self.vector_registry = vector_registry or VectorSpaceRegistry(device)
        self._doc_space = self.vector_registry.get_or_create(
            database=database, entity_type="node", backend="brute")
        self.vectors = self._doc_space.ensure_index()
        self.hnsw: Optional[HNSWIndex] = None
        # the device graph of the cagra profile, over self.vectors
        self.cagra: Optional[CagraIndex] = None
        self._hnsw_m = hnsw_m
        self._hnsw_ef = hnsw_ef_search
        self.stats = SearchStats()
        self._result_cache = ResultCache(_copy_hit)
        # concurrent single vector queries ride one batched call of the
        # vector tier the strategy machine owns (the graph walk or B1)
        self._microbatch = MicroBatcher(self._ann_search_batch,
                                        surface="service:vector",
                                        tier_surface="vector")
        # vector requests by route: tiered_route, cagra, hnsw, exact, brute
        self.vector_routes: Counter = Counter()
        # concurrent hybrid queries ride one fused dispatch; tokens and
        # fusion options ride as extras, and rows come back shaped
        self._fused: Optional[FusedHybrid] = None
        self._hybrid_batch = MicroBatcher(self._fused_hybrid_dispatch,
                                          pass_extras=True,
                                          surface="service:hybrid")
        # index persistence: debounced saves, load on build
        self.persist_dir = persist_dir
        self.save_debounce_s = save_debounce_s
        self._save_timer: Optional[threading.Timer] = None
        # the pending timer; apart from the writer's lock, so that an index
        # write never waits for a snapshot being written
        self._timer_lock = threading.Lock()
        self._timers: List[threading.Timer] = []  # joined at close
        self._save_lock = threading.Lock()  # one snapshot writer at a time
        self._saved_at_ms = 0
        # an index write since the last save or load: the close saves only
        # then (the reference saves on every close)
        self._unsaved = False
        self._closed = False
        # saves: count, those the timer ran, failures, seconds (sum, most,
        # and the last save's split), bytes per file of the last save
        self.save_stats: Dict[str, Any] = {
            "saves": 0, "timer_saves": 0, "failed": 0, "save_s": 0.0,
            "max_save_s": 0.0, "last_split_s": {}, "last_bytes": {}}
        # the last load's seconds by part; after a resumed build, the
        # nodes it indexed again and the ids it removed
        self.load_stats: Dict[str, Any] = {}
        # resource accounting (obs/resources.py, weakly held): the
        # indexes' device and host bytes and freshness, the queues' depth
        self.resource_name = resource_name or "service:neo4j"
        register_resource("bm25", self.resource_name, self.bm25)
        register_resource("brute", self.resource_name, self.vectors)
        register_resource("queue", f"{self.resource_name}:vector", self._microbatch)
        register_resource("queue", f"{self.resource_name}:hybrid", self._hybrid_batch)

    def _ann_search_batch(self, queries: np.ndarray, k: int):
        """The vector batcher's dispatch: the CAGRA walk once the cagra
        strategy built its graph, else brute force."""
        cagra = self.cagra
        if cagra is not None:
            return cagra.search_batch(queries, k)
        return self.vectors.search_batch(queries, k)

    def _fused_hybrid_dispatch(self, queries: np.ndarray, k_max: int,
                               extras: List[Dict[str, Any]]):
        """The hybrid batcher's dispatch; None rows send riders to the
        host path."""
        fused = self._fused
        if fused is None:
            return [None] * len(queries)
        return fused.search_batch(queries, k_max, extras)

    def _ensure_fused(self) -> Optional[FusedHybrid]:
        """The fused hybrid tier, or None while the host path must serve:
        switched by NORNICDB_HYBRID_FUSED (on), floored at
        NORNICDB_HYBRID_MIN_N BM25 documents (4,096), and built in the
        background unless NORNICDB_HYBRID_INLINE_BUILD (off) asks for a
        blocking first build. Its walk tier is switched by
        NORNICDB_HYBRID_WALK (on) and floored at NORNICDB_HYBRID_WALK_MIN_N
        live vectors (100,000), and laid out in NORNICDB_HYBRID_SHARDS row
        shards (1), all read when the tier is created; a graph the
        strategy machine builds later is rebound in place."""
        with self._lock:
            f = self._ensure_fused_locked()
        if f is None or not f.ensure():
            return None  # the first build runs in the background
        return f

    def _ensure_fused_locked(self) -> Optional[FusedHybrid]:
        if not env_bool("HYBRID_FUSED", True):
            self._fused = None
            return None
        min_n = env_int("HYBRID_MIN_N", 4096)
        if len(self.bm25) < min_n or len(self.vectors) == 0:
            self._fused = None
            return None
        f = self._fused
        if f is None or f.bm25 is not self.bm25 or f.brute is not self.vectors:
            # none yet, or a load replaced the indexes it wraps
            walk_min_n = (env_int("HYBRID_WALK_MIN_N", 100_000)
                          if env_bool("HYBRID_WALK", True) else None)
            f = self._fused = FusedHybrid(
                self.bm25, self.vectors, n_shards=max(1, env_int("HYBRID_SHARDS", 1)),
                min_n=min_n,
                build_inline=env_bool("HYBRID_INLINE_BUILD", False),
                walk_min_n=walk_min_n)
            register_resource("device_bm25", self.resource_name, f.lex)
            if f.cagra is not None and f.cagra is not self.cagra:
                # the tier's own graph (no cagra strategy profile)
                register_resource("cagra", f"{self.resource_name}:hybrid_walk", f.cagra)
        if self.cagra is not None and f.cagra is not self.cagra:
            # the strategy machine built a graph over the same brute index:
            # one graph, one rebuild cadence, and the snapshot keeps serving
            f.rebind_cagra(self.cagra)
        return f

    def _fused_hybrid_trio(self, query: str, qv: np.ndarray, overfetch: int,
                           weights: Optional[Sequence[float]]):
        """One coalesced fused-hybrid ride: this query's (lex, vec, fused)
        candidate lists, or None when the host path must serve. Errors
        propagate: the reference's fallback on any exception is not kept."""
        f = self._ensure_fused()
        if f is None:
            return None
        w = tuple(weights) if weights else (1.0, 1.0)
        if len(w) != 2:
            return None  # the host rrf_fuse takes other weight shapes
        t_ride = time.time()
        trio = self._hybrid_batch.search(
            qv, overfetch, extra={"tokens": tuple(tokenize(query)),
                                  "n_cand": overfetch, "w": w})
        if trio is None:
            return None
        tier = trio.get("tier", "brute")
        _STRATEGY_C.labels("hybrid_walk_fused" if tier == "walk" else "hybrid_fused").inc()
        # this row's tier: a live-filter re-fuse makes one rider "host"
        # while its batch-mates keep the device tier
        served = trio.get("served_by", "hybrid_brute_f32")
        _audit.record_served("hybrid", served, seconds=time.time() - t_ride)
        if served != "host" and _audit.sampling_active():
            self._maybe_shadow_hybrid(served, trio, query, qv, overfetch, w)
        t = trio.get("times")
        if t:
            # the lexical and vector halves ran in one dispatch: split the
            # trace at the decode boundary
            attach_span("lexical.score", t["device_t0"] - t["plan_s"], t["device_t1"])
            if tier == "walk":
                attach_span("vector.walk", t["device_t0"], t["device_t1"],
                            iters=t.get("walk_iters"), itopk=t.get("walk_itopk"))
            attach_span("fuse", t["device_t1"], t["device_t1"] + t["decode_s"])
        return trio

    def _maybe_shadow_hybrid(self, tier, trio, query, qv, overfetch, w):
        """Offer one device-served hybrid answer to the shadow-parity
        auditor. Its reference closure runs the host hybrid path (host
        BM25, exact brute force, ``rrf_fuse``) on the auditor's worker
        thread. Sampling never fails a search, but a device fault the
        auditor remembered passes (ROADMAP C31)."""
        try:
            device_ids = [i for i, _ in trio["fused"]]
            bm25, vectors = self.bm25, self.vectors
            weights = list(w)

            def ref():
                bm_hits = bm25.search(query, overfetch)
                vec_hits = vectors.search_batch(qv[None, :], overfetch, exact=True)[0]
                fused = rrf_fuse([bm_hits, vec_hits], weights=weights, limit=overfetch)
                return [i for i, _ in fused]

            # every index mutation bumps the cache generation: a write
            # between sampling and the replay drops the sample as stale
            def versions_now():
                return {"generation": self._result_cache.generation}

            _audit.maybe_sample(
                "hybrid", tier, device_ids, k=min(10, overfetch), ref=ref,
                versions=versions_now(), versions_now=versions_now,
                query={"query": query, "overfetch": overfetch, "weights": weights})
        except Exception as exc:  # noqa: BLE001
            if is_device_fault(exc):
                raise

    def _vector_ride(self, query_vec, k: int):
        """One coalesced vector ride. The batcher stamps the serving tier
        on this rider's count and span; the answer is then offered to the
        shadow-parity auditor with an exact brute-force reference."""
        hits = self._microbatch.search(query_vec, k)
        if _audit.sampling_active():
            tier = _audit.last_served()
            if tier is not None and tier != "host":
                try:
                    qv = np.asarray(query_vec, dtype=np.float32)
                    vectors = self.vectors

                    def versions_now():
                        return {"brute_mutations": getattr(vectors, "mutations", 0)}

                    # (id, score) pairs: exact tiers score tie-aware rank
                    # parity (a batch may order an exact tie otherwise
                    # than the single-query replay)
                    _audit.maybe_sample(
                        "vector", tier, [(i, float(sc)) for i, sc in hits], k=min(10, k),
                        ref=lambda: [(i, float(sc)) for i, sc in
                                     vectors.search_batch(qv[None, :], k, exact=True)[0]],
                        versions=versions_now(), versions_now=versions_now,
                        query={"k": k})
                except Exception as exc:  # noqa: BLE001
                    if is_device_fault(exc):
                        raise
        return hits

    def _clear_result_cache(self) -> None:
        self._result_cache.bump_generation()

    @property
    def generation(self) -> int:
        """Write generation of the result cache, bumped on every index
        mutation."""
        return self._result_cache.generation

    def microbatch_stats(self) -> Dict[str, float]:
        """How many concurrent single vector queries rode one dispatch."""
        mb = self._microbatch
        return {
            "batches": mb.batches,
            "batched_queries": mb.batched_queries,
            "mean_batch": mb.batched_queries / max(mb.batches, 1),
        }

    # -- indexing ---------------------------------------------------------

    def index_node(self, node: Node) -> None:
        """Index one node's text + embedding; switches the vector tier at
        the write that crosses ``hnsw_threshold``."""
        self._index_node(node, switch=True)

    def _index_node(self, node: Node, switch: bool) -> None:
        if any(lbl.startswith("_") for lbl in node.labels):
            return  # system-owned nodes stay out of the native index
        text = extract_text(node)
        try:
            self._index_node_locked(node, text, switch)
        finally:
            # the write is in the indexes even when the switch raises
            self._clear_result_cache()
            self._schedule_save()

    def _index_node_locked(self, node: Node, text: str, switch: bool) -> None:
        with self._lock:
            if text:
                self.bm25.index(node.id, text)
            else:
                self.bm25.remove(node.id)  # update cleared the text
            vec = node.embedding
            if vec is None and node.chunk_embeddings:
                # whole-doc vector = mean of chunks
                vec = list(np.mean(np.asarray(node.chunk_embeddings), axis=0))
            if vec is not None:
                self.vectors.add(node.id, vec)
                if self.hnsw is not None:
                    self.hnsw.add(node.id, vec)
            else:
                # update removed the embedding: drop stale vectors
                self.vectors.remove(node.id)
                if self.hnsw is not None:
                    self.hnsw.remove(node.id)
            self.stats.indexed_docs = len(self.bm25)
            self.stats.indexed_vectors = len(self.vectors)
            if switch:
                self._maybe_switch_strategy()

    def remove_node(self, node_id: str) -> None:
        try:
            with self._lock:
                self.bm25.remove(node_id)
                self.vectors.remove(node_id)
                if self.hnsw is not None:
                    self.hnsw.remove(node_id)
                    if self.hnsw.should_rebuild():
                        self._rebuild_hnsw_locked()
                self.stats.indexed_docs = len(self.bm25)
                self.stats.indexed_vectors = len(self.vectors)
        finally:
            self._clear_result_cache()
            self._schedule_save()

    def prune_missing(self) -> int:
        """Drop every indexed id whose node left storage without a
        per-node event (a replayed ``delete_by_prefix``), through
        ``remove_node``. Returns the number pruned."""
        if self.storage is None:
            return 0
        with self._lock:
            indexed = set(self.bm25.ids()) | set(self.vectors.ids())
        pruned = 0
        for nid in indexed:
            if not self.storage.has_node(nid):
                self.remove_node(nid)
                pruned += 1
        return pruned

    def build_indexes(self) -> int:
        """Index every node in storage. Returns the count indexed.

        With a ``persist_dir`` a valid snapshot is loaded first, and only
        the nodes written since it, or missing from it, are indexed; ids
        that left storage meanwhile are removed. The strategy switch is
        held back until the backfill ends, so one BM25-seeded wave build
        covers the whole corpus; the reference switches at the
        threshold's node and then inserts every later node alone, through
        the single-insert Python path."""
        if self.storage is None:
            return 0
        resumed = self.load_indexes()
        n = 0
        live = set()
        try:
            for node in self.storage.all_nodes():
                live.add(node.id)
                if resumed and not self._needs_reindex(node):
                    continue
                self._index_node(node, switch=False)
                n += 1
            with self._lock:
                self._maybe_switch_strategy()
        finally:
            self._clear_result_cache()
        if resumed:
            # both halves: a text-only node never enters the vector index
            with self._lock:
                stale = (set(self.vectors.ids()) | set(self.bm25.ids())) - live
            for ext_id in stale:
                self.remove_node(ext_id)
            self.load_stats.update(reindexed=n, removed=len(stale))
        return n

    def _needs_reindex(self, node: Node) -> bool:
        if any(lbl.startswith("_") for lbl in node.labels):
            return False  # never indexed (index_node)
        if (node.updated_at or 0) > self._saved_at_ms:
            return True
        has_vec = node.embedding is not None or node.chunk_embeddings
        if has_vec and node.id not in self.vectors:
            return True
        return node.id not in self.bm25 and bool(extract_text(node))

    # -- persistence ------------------------------------------------------

    _FORMAT_VERSION = 1

    def save_indexes(self) -> bool:
        """Write BM25, vector (and HNSW) snapshots; False without a
        ``persist_dir``. One writer at a time: a timer save and the close
        save over the same temporary files would publish a torn one."""
        if not self.persist_dir:
            return False
        with self._save_lock:
            return self._save_indexes_locked()

    def _save_indexes_locked(self) -> bool:
        t0 = time.perf_counter()
        d = self.persist_dir
        os.makedirs(d, exist_ok=True)
        # captured under the service lock; the slow compression and writes
        # run outside it (the indexes snapshot under their own locks)
        with self._lock:
            self._unsaved = False  # a write after this capture sets it again
            saved_at = int(time.time() * 1000)
            bm25_doc = self.bm25.to_dict()
            vectors = self.vectors
            hnsw = self.hnsw
            strategy = self.stats.strategy
        t1 = time.perf_counter()
        vectors.save(os.path.join(d, "vectors.npz.tmp"))
        t2 = time.perf_counter()
        if hnsw is not None:
            hnsw.save(os.path.join(d, "hnsw.tmp"))  # np.savez adds .npz
        t3 = time.perf_counter()
        with open(os.path.join(d, "bm25.json.tmp"), "w") as f:
            json.dump(bm25_doc, f)
        meta = {"format": self._FORMAT_VERSION, "saved_at_ms": saved_at,
                "has_hnsw": hnsw is not None, "strategy": strategy}
        with open(os.path.join(d, "meta.json.tmp"), "w") as f:
            json.dump(meta, f)
        # publish meta last: a torn save is ignored on load
        sizes = {}
        for tmp_name, name in (("vectors.npz.tmp", "vectors.npz"),
                               ("hnsw.tmp.npz", "hnsw.npz"),
                               ("bm25.json.tmp", "bm25.json"),
                               ("meta.json.tmp", "meta.json")):
            tmp = os.path.join(d, tmp_name)
            if os.path.exists(tmp):
                sizes[name] = os.path.getsize(tmp)
                os.replace(tmp, os.path.join(d, name))
        self._saved_at_ms = saved_at
        t4 = time.perf_counter()
        st = self.save_stats
        st["saves"] += 1
        st["save_s"] += t4 - t0
        st["max_save_s"] = max(st["max_save_s"], t4 - t0)
        st["last_split_s"] = {"capture": t1 - t0, "vectors": t2 - t1, "hnsw": t3 - t2,
                              "bm25_meta": t4 - t3, "total": t4 - t0}
        st["last_bytes"] = sizes
        return True

    def load_indexes(self) -> bool:
        """Load a persisted snapshot; False when it is absent, corrupt or
        of another format version (the caller rebuilds). After a load the
        service serves the restored indexes: the CAGRA graph and the fused
        tier, which wrap the replaced ones, are dropped (the graph is
        rebuilt now if the saved strategy was ``cagra``), and the result
        cache's generation moves on."""
        if not self.persist_dir:
            return False
        d = self.persist_dir
        t0 = time.perf_counter()
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            if meta.get("format") != self._FORMAT_VERSION:
                return False
            with open(os.path.join(d, "bm25.json")) as f:
                bm25 = BM25Index.from_dict(json.load(f))
            t1 = time.perf_counter()
            vectors = BruteForceIndex.load(os.path.join(d, "vectors.npz"),
                                           device=self.device)
            t2 = time.perf_counter()
            hnsw = None
            if meta.get("has_hnsw"):
                hnsw = HNSWIndex.load(os.path.join(d, "hnsw.npz"))
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return False
        t3 = time.perf_counter()
        with self._lock:
            self.bm25 = bm25
            # the registered space's index is still the live one
            self._doc_space.index = vectors
            self.vectors = vectors
            # the resource gauges follow the restored structures
            register_resource("bm25", self.resource_name, bm25)
            register_resource("brute", self.resource_name, vectors)
            self.hnsw = hnsw
            self.cagra = None
            self._fused = None
            self._saved_at_ms = int(meta.get("saved_at_ms", 0))
            self._unsaved = False
            self.stats.indexed_docs = len(self.bm25)
            self.stats.indexed_vectors = len(self.vectors)
            self.stats.strategy = "hnsw" if hnsw is not None else "brute"
            self._clear_result_cache()
            if hnsw is None and meta.get("strategy") == "cagra":
                # derived state: rebuilt from the restored vectors now, so a
                # read-only workload after a restart still walks the graph
                self._maybe_switch_strategy()
        self.load_stats = {"bm25_s": t1 - t0, "vectors_read_s": vectors.load_s["read"],
                           "vectors_upload_s": vectors.load_s["upload"],
                           "vectors_s": t2 - t1, "hnsw_s": t3 - t2,
                           "total_s": time.perf_counter() - t0}
        return True

    def _schedule_save(self) -> None:
        """At most one pending timer: a steady write stream saves every
        debounce interval instead of pushing the save out for ever."""
        if not self.persist_dir or self._closed:
            return
        self._unsaved = True
        with self._timer_lock:
            if self._save_timer is not None:
                return
            t = threading.Timer(self.save_debounce_s, self._timer_save)
            t.daemon = True
            self._save_timer = t
            self._timers = [x for x in self._timers if x.is_alive()] + [t]
            t.start()

    def _timer_save(self) -> None:
        with self._timer_lock:
            self._save_timer = None
        try:
            with self._save_lock:
                if self._closed:
                    return  # the close makes the last save
                self._save_indexes_locked()
                self.save_stats["timer_saves"] += 1
        except Exception:  # noqa: BLE001 -- counted; the close save raises
            self.save_stats["failed"] += 1
            logger.exception("index save failed")

    def close(self) -> None:
        """Cancel a pending save, wait for one in flight, and make the final
        one, which raises on failure; none when no index write landed since
        the last save or load (the snapshot on disk is already the indexes).
        No timer thread outlives it."""
        self._closed = True
        with self._timer_lock:
            if self._save_timer is not None:
                self._save_timer.cancel()
                self._save_timer = None
            timers, self._timers = self._timers, []
        for t in timers:
            if t is not threading.current_thread():
                t.join()
        if self._unsaved:
            self.save_indexes()

    # -- strategy state machine -------------------------------------------

    def _maybe_switch_strategy(self) -> None:
        if len(self.vectors) < self.hnsw_threshold:
            return
        if current_profile().index_kind == "cagra":
            # after its first build the graph keeps its own rebuild cadence
            if self.cagra is None:
                self._rebuild_cagra_locked()
            return
        if self.hnsw is None:
            self._rebuild_hnsw_locked()

    def _rebuild_cagra_locked(self) -> None:
        """Build the device graph over the live brute index, here on the
        write path; a later build from scratch (after the corpus shrank
        under min_n and regrew) runs in the background while brute force
        answers."""
        p = current_profile()
        idx = CagraIndex(brute=self.vectors, degree=p.cagra_degree, itopk=p.cagra_itopk,
                         search_width=p.cagra_width,
                         min_n=min(p.cagra_min_n, self.hnsw_threshold),
                         n_shards=cagra_shards_from_env(p.cagra_shards),
                         build_inline=False)
        if not idx.build():
            return
        self.cagra = idx
        register_resource("cagra", self.resource_name, idx)
        # the graph index as a vector space of its own, as the hnsw tier
        self.vector_registry.get_or_create(
            database=self.database, entity_type="node",
            vector_name="embedding_cagra", backend="cagra").index = idx
        self.stats.cagra_builds += 1
        self.stats.strategy = "cagra"

    def _rebuild_hnsw_locked(self) -> None:
        """(Re)build HNSW from the brute index, BM25 seeds first."""
        items = []
        matrix, valid, ext_ids = self.vectors.snapshot()
        for slot, eid in enumerate(ext_ids):
            if eid is not None and valid[slot]:
                items.append((eid, matrix[slot]))
        seeds = self.bm25.seed_doc_ids()
        idx = HNSWIndex(m=self._hnsw_m, ef_search=self._hnsw_ef)
        idx.build(items, seed_ids=seeds)
        self.hnsw = idx
        self.vector_registry.get_or_create(
            database=self.database, entity_type="node",
            vector_name="embedding_hnsw", backend="hnsw").index = idx
        self.stats.hnsw_builds += 1
        self.stats.strategy = "hnsw"

    # -- search -----------------------------------------------------------

    def _query_embedding(self, query: str) -> Optional[np.ndarray]:
        if self.embedder is None:
            return None
        return np.asarray(self.embedder.embed(query), dtype=np.float32)

    def similar(self, node_id: str, limit: int = 10) -> List[Dict[str, Any]]:
        """Nodes nearest to a stored node's embedding, the node itself left
        out (the reference's REST /similar). Empty when the node has no
        vector yet. Routed as ``vector_search_candidates``: B1 below the
        HNSW threshold, HNSW above it."""
        try:
            node = self.storage.get_node(node_id)
        except KeyError:
            return []
        emb = node.embedding or (
            node.chunk_embeddings[0] if node.chunk_embeddings else None)
        if emb is None:
            return []
        hits = self.vector_search_candidates(emb, limit + 1)
        out: List[Dict[str, Any]] = []
        for nid, score in hits:
            if nid == node_id:
                continue
            res = SearchResult(node_id=nid, score=score, vector_score=score)
            try:
                res.node = self.storage.get_node(nid)
            except KeyError:
                continue
            out.append(res.to_dict())
            if len(out) >= limit:
                break
        return out

    def vector_search_candidates(
        self, query_vec: Sequence[float], k: int = 10, exact: bool = False,
        lexical_doc_ids: Optional[Sequence[str]] = None,
    ) -> List[Tuple[str, float]]:
        """Raw vector candidates. Unless ``exact``: the tiered plane routed
        by ``lexical_doc_ids`` (the BM25 top docs) when it serves, called
        directly since the hints are per query; then the strategy's ANN
        index once built: the CAGRA walk, micro-batched with concurrent
        callers, or HNSW; else brute force, micro-batched. ``exact=True``
        calls exact brute force directly: it never rides the batcher,
        whose dispatch may walk the graph, and skips the planes."""
        with self._lock:
            hnsw, cagra = self.hnsw, self.cagra
        q = np.asarray([query_vec], dtype=np.float32)
        if exact:
            self._route("exact")
            _audit.record_served("vector", "vector_brute_f32")
            return self.vectors.search_batch(q, k, exact=True)[0]
        if lexical_doc_ids:
            out = self.vectors._tiered_search_batch(q, k, lex_hints=[list(lexical_doc_ids)])
            if out is not None:
                self._route("tiered_route")
                _audit.record_served("vector", _audit.consume_batch_tier() or "vector_tiered")
                return out[0]
        if cagra is None and hnsw is not None:
            self._route("hnsw")
            _audit.record_served("vector", "host")  # a host-resident graph
            return hnsw.search(query_vec, k)
        self._route("cagra" if cagra is not None else "brute")
        return self._vector_ride(query_vec, k)

    def _route(self, route: str) -> None:
        self.vector_routes[route] += 1
        _STRATEGY_C.labels(route).inc()

    def search(
        self,
        query: str = "",
        limit: int = 10,
        query_embedding: Optional[Sequence[float]] = None,
        mode: str = "hybrid",
        min_score: float = 0.0,
        enrich: bool = True,
        labels: Optional[Sequence[str]] = None,
        weights: Optional[Sequence[float]] = None,
    ) -> List[Dict[str, Any]]:
        """BM25 + vector candidate lists fused with (optionally weighted)
        RRF, enriched from storage; on a large corpus the fused tier
        computes all three in one device dispatch. ``weights`` is the
        per-source (lexical, vector) weighting; None means (1.0, 1.0).
        Results are cached by query and options until the next index
        mutation; a request with an explicit ``query_embedding`` bypasses
        the cache. A ``mode`` outside ``MODES`` reads neither source and
        answers ``[]`` (cached), as the reference does."""
        self.stats.searches += 1
        # read per search, so the toggle takes effect on the next one;
        # stale timings are cleared before the cache probe, so a hit
        # cannot serve an earlier diagnostic run's timings
        diag = env_bool("TPU_SEARCH_DIAG")
        if not diag and self.stats.last_timings:
            self.stats.last_timings = {}
        cache_key = None
        if query_embedding is None and self.reranker is None:
            cache_key = (query, limit, mode, min_score, enrich,
                         tuple(labels) if labels else None,
                         tuple(weights) if weights else None)
            cached = self._result_cache.get_hits(cache_key)
            if cached is not None:
                self.stats.cache_hits += 1
                _HYBRID_CACHED_SERVED.inc()
                # the child counter skips record_served; the tenant's
                # request still counts the hit
                _tenant.record_served("hybrid", "cached")
                return cached
            gen_at_miss = self._result_cache.generation
        timings: Dict[str, float] = {}
        t0 = time.perf_counter() if diag else 0.0
        overfetch = max(limit * 3, 30)
        bm25_hits: List[Tuple[str, float]] = []
        vec_hits: List[Tuple[str, float]] = []
        qv = None
        if mode in ("hybrid", "vector"):
            if query_embedding is not None:
                qv = np.asarray(query_embedding, dtype=np.float32)
            elif query.strip():
                qv = self._query_embedding(query)
            if diag:
                timings["embed_ms"] = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
        trio = None
        trio_eligible = mode == "hybrid" and bool(query) and qv is not None and len(self.vectors) > 0
        if trio_eligible:
            trio = self._fused_hybrid_trio(query, qv, overfetch, weights)
            if trio is None:
                # a fused-eligible query the host path serves
                _audit.record_served("hybrid", "host")
        if trio is not None:
            bm25_hits, vec_hits = trio["lex"], trio["vec"]
            if diag:
                timings["fused_ms"] = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
        else:
            if mode in ("hybrid", "text") and query:
                t_lex = time.time()
                bm25_hits = self.bm25.search(query, overfetch)
                attach_span("lexical.score", t_lex, time.time())
            if diag:
                timings["bm25_ms"] = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
            if qv is not None and len(self.vectors) > 0:
                if trio_eligible:
                    # counted once as the hybrid host tier: the nested
                    # vector ride is no second served query
                    with _audit.suppress_attribution():
                        vec_hits = self.vector_search_candidates(
                            qv, overfetch, lexical_doc_ids=[d for d, _ in bm25_hits[:32]])
                else:
                    vec_hits = self.vector_search_candidates(
                        qv, overfetch, lexical_doc_ids=[d for d, _ in bm25_hits[:32]])
            if diag:
                timings["vector_ms"] = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()

        if bm25_hits and vec_hits:
            # the trio's device fuse is bitwise the host rrf_fuse
            if trio is not None:
                fused = trio["fused"]
            else:
                t_fuse = time.time()
                fused = rrf_fuse([bm25_hits, vec_hits],
                                 weights=list(weights) if weights else (), limit=overfetch)
                attach_span("fuse", t_fuse, time.time())
        elif bm25_hits:
            fused = bm25_hits[:overfetch]
        else:
            fused = vec_hits[:overfetch]
        if diag:
            timings["fuse_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()

        t_rerank = time.time()
        bm = dict(bm25_hits)
        vs = dict(vec_hits)
        out: List[Dict[str, Any]] = []
        for node_id, score in fused:
            # min_score filters on the raw scores (cosine and/or BM25), not
            # the fused RRF value; a hit survives if ANY raw score clears it
            v_sc, b_sc = vs.get(node_id), bm.get(node_id)
            gates = [g for g in (v_sc, b_sc) if g is not None]
            if gates and max(gates) < min_score:
                continue
            res = SearchResult(node_id=node_id, score=score,
                               bm25_score=b_sc, vector_score=v_sc)
            if (enrich or labels) and self.storage is not None:
                try:
                    node = self.storage.get_node(node_id)
                except KeyError:
                    continue  # deleted since indexing; drop the stale hit
                if labels and not set(labels) & set(node.labels):
                    continue
                if enrich:
                    res.node = node
            out.append(res.to_dict())
            if len(out) >= limit and self.reranker is None:
                break
        if self.reranker is not None and out:
            # stage-2 rerank over the full fused overfetch, then cut; it
            # gets the query embedding already computed
            try:
                out = self.reranker.rerank(query, out, limit=limit,
                                           query_embedding=qv)
            except Exception as exc:
                if is_device_fault(exc):
                    raise  # a device fault fails the search (ROADMAP C29)
                out = out[:limit]  # fail-open, as the reference
        attach_span("rerank", t_rerank, time.time(), reranker=self.reranker is not None)
        if diag:
            # enrichment and, with a reranker, the rerank
            timings["enrich_rerank_ms"] = (time.perf_counter() - t0) * 1e3
            self.stats.last_timings = timings
        out = out[:limit]
        if cache_key is not None:
            return self._result_cache.put_guarded(cache_key, out, gen_at_miss)
        return out
