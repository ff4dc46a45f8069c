"""Hybrid search service: BM25 + brute-force vector + RRF (counterpart of
``nornicdb_tpu/search/service.py:SearchService``).

This slice keeps the host hybrid path: BM25 and the vector index each
give ``max(limit*3, 30)`` candidates, ``rrf_fuse`` ranks them, the
``min_score`` gate filters on raw scores, and hits are enriched from
storage. The micro-batcher, the result cache, the device BM25/fused
hybrid tier, persistence, reranking, HNSW/CAGRA and audit/cost
accounting wait for later slices.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike
from nornicdb_tpu_torch.search.bm25 import BM25Index
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
        """Raw vector candidates from the brute-force index."""
        return self.vectors.search_batch(
            np.asarray([query_vec], dtype=np.float32), k)[0]

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
        RRF, enriched from storage. ``weights`` is the per-source
        (lexical, vector) weighting; None means (1.0, 1.0)."""
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
        if mode in ("hybrid", "text") and query:
            bm25_hits = self.bm25.search(query, overfetch)
        if qv is not None and len(self.vectors) > 0:
            vec_hits = self.vector_search_candidates(qv, overfetch)

        if bm25_hits and vec_hits:
            fused = rrf_fuse([bm25_hits, vec_hits],
                             weights=list(weights) if weights else (),
                             limit=overfetch)
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
