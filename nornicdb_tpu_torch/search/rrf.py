"""Reciprocal Rank Fusion of BM25 and vector result lists (a copy of
``nornicdb_tpu/search/rrf.py``).

Float32 accumulation, source-major; equal fused scores order by first
occurrence across (source index, rank within source), then id.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_RRF_K = 60


def rrf_fuse(
    result_lists: Sequence[List[Tuple[str, float]]],
    weights: Sequence[float] = (),
    k: int = DEFAULT_RRF_K,
    limit: int = 10,
) -> List[Tuple[str, float]]:
    """Fuse ranked lists of (id, score) by reciprocal rank:
    score(id) = sum_i w_i / (k + rank_i(id)), ``weights`` 1.0 per source
    by default. Returns the top ``limit`` by fused score."""
    if not weights:
        weights = [1.0] * len(result_lists)
    fused: Dict[str, np.float32] = {}
    first_seen: Dict[str, Tuple[int, int]] = {}
    for src, (w, results) in enumerate(zip(weights, result_lists)):
        w32 = np.float32(w)
        for rank, (doc_id, _score) in enumerate(results):
            contrib = w32 / np.float32(k + rank + 1)
            fused[doc_id] = np.float32(
                fused.get(doc_id, np.float32(0.0)) + contrib)
            if doc_id not in first_seen:
                first_seen[doc_id] = (src, rank)
    ranked = sorted(
        fused.items(),
        key=lambda kv: (-kv[1], first_seen[kv[0]], kv[0]),
    )
    return [(doc_id, float(s)) for doc_id, s in ranked[:limit]]
