"""Hybrid search service: BM25 + brute-force vector + RRF (counterpart of
``nornicdb_tpu/search/service.py:SearchService``).

BM25 and the vector index each give ``max(limit*3, 30)`` candidates,
``rrf_fuse`` ranks them, the ``min_score`` gate filters on raw scores,
and hits are enriched from storage. Concurrent vector queries coalesce
through a micro-batcher into one batched top-k. Above
``NORNICDB_HYBRID_MIN_N`` (4,096) BM25 documents, hybrid queries coalesce
through a second batcher into one device dispatch of the fused tier
(``hybrid_fused.py``: device BM25 + B1 + RRF); below it, while its
snapshot builds, and at its freshness rungs the host path serves. Unlike
the reference, an error on the fused path raises instead of falling back
to the host. The result cache, persistence, reranking, HNSW/CAGRA, the
walk/quant/sharded hybrid tiers and audit/cost accounting wait for later
slices.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike
from nornicdb_tpu_torch.config import env_bool, env_int
from nornicdb_tpu_torch.search.bm25 import BM25Index, tokenize
from nornicdb_tpu_torch.search.hybrid_fused import FusedHybrid
from nornicdb_tpu_torch.search.microbatch import MicroBatcher
from nornicdb_tpu_torch.search.rrf import rrf_fuse
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex
from nornicdb_tpu_torch.storage.types import Engine, Node

TEXT_PROPERTIES = ("content", "title", "name", "description", "text", "summary")
MODES = ("hybrid", "vector", "text")


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


class SearchService:
    """One search service per logical database."""

    def __init__(
        self,
        storage: Optional[Engine] = None,
        embedder: Optional[Any] = None,
        device: DeviceLike = None,
    ):
        self.storage = storage
        self.embedder = embedder
        self._lock = threading.RLock()
        self.bm25 = BM25Index()
        self.vectors = BruteForceIndex(device=device)
        # concurrent single vector queries ride one batched top-k
        self._microbatch = MicroBatcher(self.vectors.search_batch)
        # concurrent hybrid queries ride one fused dispatch; tokens and
        # fusion options ride as extras, and rows come back shaped
        self._fused: Optional[FusedHybrid] = None
        self._hybrid_batch = MicroBatcher(self._fused_hybrid_dispatch,
                                          pass_extras=True)

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
        blocking first build."""
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
        if self._fused is None:
            self._fused = FusedHybrid(
                self.bm25, self.vectors, min_n=min_n,
                build_inline=env_bool("HYBRID_INLINE_BUILD", False))
        return self._fused

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
        return self._hybrid_batch.search(
            qv, overfetch, extra={"tokens": tuple(tokenize(query)),
                                  "n_cand": overfetch, "w": w})

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
        """Index one node's text + embedding."""
        if any(lbl.startswith("_") for lbl in node.labels):
            return  # system-owned nodes stay out of the native index
        text = extract_text(node)
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
            else:
                self.vectors.remove(node.id)  # update removed the embedding

    def remove_node(self, node_id: str) -> None:
        with self._lock:
            self.bm25.remove(node_id)
            self.vectors.remove(node_id)

    def build_indexes(self) -> int:
        """Index every node in storage. Returns the count indexed."""
        if self.storage is None:
            return 0
        n = 0
        for node in self.storage.all_nodes():
            self.index_node(node)
            n += 1
        return n

    # -- search -----------------------------------------------------------

    def _query_embedding(self, query: str) -> Optional[np.ndarray]:
        if self.embedder is None:
            return None
        return np.asarray(self.embedder.embed(query), dtype=np.float32)

    def vector_search_candidates(
        self, query_vec: Sequence[float], k: int = 10,
    ) -> List[Tuple[str, float]]:
        """Raw vector candidates from the brute-force index, micro-batched
        with concurrent callers."""
        return self._microbatch.search(query_vec, k)

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
        per-source (lexical, vector) weighting; None means (1.0, 1.0)."""
        if mode not in MODES:
            raise ValueError(f"unknown search mode {mode!r}")
        overfetch = max(limit * 3, 30)
        bm25_hits: List[Tuple[str, float]] = []
        vec_hits: List[Tuple[str, float]] = []
        qv = None
        if mode in ("hybrid", "vector"):
            if query_embedding is not None:
                qv = np.asarray(query_embedding, dtype=np.float32)
            elif query.strip():
                qv = self._query_embedding(query)
        trio = None
        if mode == "hybrid" and query and qv is not None and len(self.vectors) > 0:
            trio = self._fused_hybrid_trio(query, qv, overfetch, weights)
        if trio is not None:
            bm25_hits, vec_hits = trio["lex"], trio["vec"]
        else:
            if mode in ("hybrid", "text") and query:
                bm25_hits = self.bm25.search(query, overfetch)
            if qv is not None and len(self.vectors) > 0:
                vec_hits = self.vector_search_candidates(qv, overfetch)

        if bm25_hits and vec_hits:
            # the trio's device fuse is bitwise the host rrf_fuse
            fused = trio["fused"] if trio is not None else rrf_fuse(
                [bm25_hits, vec_hits],
                weights=list(weights) if weights else (), limit=overfetch)
        elif bm25_hits:
            fused = bm25_hits[:overfetch]
        else:
            fused = vec_hits[:overfetch]

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
            if len(out) >= limit:
                break
        return out
