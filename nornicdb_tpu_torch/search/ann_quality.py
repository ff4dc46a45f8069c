"""ANN quality profiles: the global strategy selector (a copy of
``nornicdb_tpu/search/ann_quality.py``).

One env knob, ``NORNICDB_VECTOR_ANN_QUALITY``, maps to an index kind and
its parameters. The search service reads the kind: ``cagra`` builds the
device graph (``search/cagra.py``) above the service's threshold, every
other profile HNSW. The walk tier of the fused hybrid pipeline reads the
``cagra_*`` fields of whichever profile is current.

One value differs from the reference: the CAGRA walk's search breadth
(``CAGRA_ITOPK``, ``CAGRA_WIDTH``; ROADMAP C14).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from nornicdb_tpu_torch.config import env_int

# The CAGRA walk's pool and frontier width. At the reference's 64 and 1,
# recall@10 against exact search falls under the 0.95 a statistical tier
# must hold on chip_smoke.py's 100,000 documents (ROADMAP C14, with
# scripts/cagra_sweep.py's grid); a pool of 128 expanded 8 rows at a
# time holds it, with the reference's iteration count and graph.
CAGRA_ITOPK = 128
CAGRA_WIDTH = 8


@dataclass(frozen=True)
class ANNProfile:
    name: str
    index_kind: str  # brute | hnsw | ivf_hnsw | ivfpq | cagra
    hnsw_m: int = 16
    hnsw_ef_construction: int = 100
    hnsw_ef_search: int = 64
    nprobe: int = 8
    pq_subspaces: int = 16
    # exact-rerank refine store of the ivfpq tier (fp16 vector copy)
    pq_refine: bool = True
    # cagra tier: fixed out-degree device graph; below cagra_min_n live
    # vectors the index serves from the brute kernel
    cagra_degree: int = 32
    cagra_itopk: int = CAGRA_ITOPK
    cagra_width: int = CAGRA_WIDTH
    cagra_min_n: int = 4096
    cagra_shards: int = 1


PROFILES = {
    "fast": ANNProfile(
        name="fast", index_kind="hnsw",
        hnsw_m=8, hnsw_ef_construction=60, hnsw_ef_search=32, nprobe=2),
    "balanced": ANNProfile(
        name="balanced", index_kind="hnsw",
        hnsw_m=16, hnsw_ef_construction=100, hnsw_ef_search=64, nprobe=4),
    "accurate": ANNProfile(
        name="accurate", index_kind="hnsw",
        hnsw_m=32, hnsw_ef_construction=200, hnsw_ef_search=128, nprobe=8),
    "compressed": ANNProfile(
        name="compressed", index_kind="ivfpq",
        nprobe=8, pq_subspaces=16),
    "cagra": ANNProfile(
        name="cagra", index_kind="cagra",
        cagra_degree=32, cagra_itopk=CAGRA_ITOPK, cagra_width=CAGRA_WIDTH,
        cagra_min_n=4096),
}


def cagra_shards_from_env(default: int = 1) -> int:
    """NORNICDB_CAGRA_SHARDS: row-shard count for the cagra tier, read by
    the service when it builds the strategy's graph; one card serves the
    shards through ``CagraIndex._walk_shards_single_device``."""
    return max(1, env_int("CAGRA_SHARDS", default))


ENV_VAR = "NORNICDB_VECTOR_ANN_QUALITY"


def current_profile(name: str | None = None) -> ANNProfile:
    """Resolve a profile by explicit name or the env knob; unknown names
    fall back to balanced."""
    key = (name or os.environ.get(ENV_VAR, "balanced")).strip().lower()
    return PROFILES.get(key, PROFILES["balanced"])
