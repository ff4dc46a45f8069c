"""Stage-2 reranking after RRF fusion (counterpart of
``nornicdb_tpu/search/rerank.py``).

Reference: pkg/search rerank.go / local_rerank.go / llm_rerank.go — a
second-stage reranker over the fused candidate list: a local
cross-encoder (GGUF in the Go original; here the embedding cosine of the
DB's own embedder blended with term overlap) or a fail-open LLM reranker
(unparseable output leaves the original order untouched). A device
fault in the query embed raises (ROADMAP C29).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from nornicdb_tpu_torch.errors import is_device_fault


class LocalReranker:
    """Cross signal scorer: blends embedding cosine with lexical term
    overlap (the analog of the reference's local cross-encoder pass).
    The query embed is the only device work."""

    def __init__(self, embedder=None, alpha: float = 0.7):
        self.embedder = embedder
        self.alpha = alpha

    @staticmethod
    def _terms(text: str) -> set:
        return set(re.findall(r"[a-z0-9]+", text.lower()))

    def rerank(
        self,
        query: str,
        candidates: List[Dict[str, Any]],
        query_embedding: Optional[Sequence[float]] = None,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        if not candidates:
            return candidates
        q_terms = self._terms(query)
        lex = np.zeros(len(candidates), dtype=np.float32)
        for i, c in enumerate(candidates):
            props = c.get("properties") or {}
            text = " ".join(str(v) for v in props.values())
            terms = self._terms(text)
            if q_terms and terms:
                lex[i] = len(q_terms & terms) / len(q_terms)
        cos = np.zeros(len(candidates), dtype=np.float32)
        qv = None
        if query_embedding is not None:
            qv = np.asarray(query_embedding, dtype=np.float32)
        elif self.embedder is not None and query:
            try:
                qv = np.asarray(self.embedder.embed(query),
                                dtype=np.float32)
            except Exception as exc:
                if is_device_fault(exc):
                    # a device fault (CUDA, out of memory) is not a reason
                    # to rank by terms alone: it fails the search (C29)
                    raise
                qv = None  # fail-open: lexical-only rerank
        if qv is not None:
            qv = qv / max(np.linalg.norm(qv), 1e-12)
            for i, c in enumerate(candidates):
                v = c.get("_embedding")
                if v is None:
                    cos[i] = float(c.get("vector_score") or 0.0)
                else:
                    v = np.asarray(v, dtype=np.float32)
                    v = v / max(np.linalg.norm(v), 1e-12)
                    cos[i] = float(v @ qv)
        scores = self.alpha * cos + (1.0 - self.alpha) * lex
        order = np.argsort(-scores)
        out = []
        for rank, i in enumerate(order):
            c = dict(candidates[int(i)])
            c["rerank_score"] = float(scores[int(i)])
            out.append(c)
        return out[: limit or len(out)]


class LLMReranker:
    """Fail-open LLM reranker (reference: llm_rerank.go) — asks a
    Heimdall ``Manager`` (``heimdall/scheduler.py``) to order candidate
    ids; any failure (bad output, backend error) leaves the original
    order untouched."""

    def __init__(self, manager, model: Optional[str] = None):
        self.manager = manager
        self.model = model

    def rerank(
        self,
        query: str,
        candidates: List[Dict[str, Any]],
        query_embedding: Optional[Sequence[float]] = None,  # unused; API parity
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        if len(candidates) < 2:
            return candidates[: limit or len(candidates)]
        listing = "\n".join(
            f"{c.get('id')}: "
            f"{json.dumps(c.get('properties') or {}, default=str)[:300]}"
            for c in candidates
        )
        prompt = (
            "Rank these documents by relevance to the query. Reply with "
            "ONLY a JSON array of ids, best first.\n"
            f"Query: {query}\nDocuments:\n{listing}\nRanking:"
        )
        try:
            result = self.manager.generate(prompt, model=self.model,
                                           max_tokens=256)
            m = re.search(r"\[.*?\]", result.text, re.DOTALL)
            ranked_ids = json.loads(m.group(0)) if m else None
        except Exception:
            ranked_ids = None
        if not ranked_ids:
            return candidates[: limit or len(candidates)]  # fail-open
        by_id = {str(c.get("id")): c for c in candidates}
        out = [by_id[str(i)] for i in ranked_ids if str(i) in by_id]
        # anything the model forgot keeps its original relative order
        seen = {str(c.get("id")) for c in out}
        out += [c for c in candidates if str(c.get("id")) not in seen]
        return out[: limit or len(out)]
