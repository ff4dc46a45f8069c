"""Per-query device cost accounting: what does one search *cost*?

The roadmap's admission control (item 4) and replica routing (item 3)
both need to reason about load in resource units, not just QPS — a
brute matmul over a 10M-row matrix and a 16-iteration graph walk are
wildly different answers to "one query". This module prices every
batched device dispatch from its KNOWN shapes at dispatch time:

- brute cosine top-k: a ``[B, D] x [D, C]`` matmul — ``2*B*C*D`` FLOPs,
  the matrix + queries + scores moved once;
- CAGRA walk: the wide seed round plus ``iters`` frontier expansions of
  ``width * degree`` candidate distance evaluations per query;
- device BM25: the CSR gather/segment-sum over the batch's unique-term
  postings (nnz) plus the ``[B, U] x [U, C]`` idf-weighted matmul;
- fused hybrid: lexical + vector tier + the RRF fuse, composed from
  the pieces above.

Costs land in three counters labeled ``{kind, index}`` (index = the
structure's resource-registration name, so aggregation follows the
same identity as the memory/freshness gauges — per service database or
per qdrant collection):

- ``nornicdb_query_cost_flops_total``
- ``nornicdb_query_cost_bytes_total`` (device bytes touched)
- ``nornicdb_query_cost_queries_total`` (REAL queries served, pre-pad)

FLOPs/bytes are priced at the PADDED shapes (the device executes the
pow2 bucket, not the request) while queries count the real batch —
``cost_summary()``'s flops-per-query therefore includes padding waste,
which is exactly what a router deciding where to send one more query
needs to see. Estimates are arithmetic-only (no memory-hierarchy
model): stable units for relative pricing, not a roofline claim.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.obs import metrics as _m
from nornicdb_tpu_torch.obs import tenant as _tenant
from nornicdb_tpu_torch.obs.metrics import REGISTRY, Registry

_F32 = 4  # bytes

_FLOPS_C = REGISTRY.counter(
    "nornicdb_query_cost_flops_total",
    "Estimated device FLOPs spent, by dispatch kind and index",
    labels=("kind", "index"))
_BYTES_C = REGISTRY.counter(
    "nornicdb_query_cost_bytes_total",
    "Estimated device bytes touched, by dispatch kind and index",
    labels=("kind", "index"))
_QUERIES_C = REGISTRY.counter(
    "nornicdb_query_cost_queries_total",
    "Real (pre-padding) queries priced, by dispatch kind and index",
    labels=("kind", "index"))


def pricing_enabled() -> bool:
    """Gate for call sites: skip the pricing arithmetic (unique-term
    sets, stats lookups) entirely when telemetry is off, not just the
    counter increments — the zero-overhead discipline obs documents."""
    return _m.enabled()


# -- pricing functions (pure) ------------------------------------------------


def price_brute(b: int, rows: int, d: int) -> Tuple[float, float]:
    """(flops, bytes) of one brute cosine top-k dispatch: [b,d]x[d,rows]
    matmul over the capacity-padded matrix."""
    flops = 2.0 * b * rows * d
    bytes_ = _F32 * (rows * d + b * d + b * rows)
    return flops, bytes_


def price_walk(b: int, d: int, iters: int, width: int, degree: int,
               itopk: int, n_seeds: int = 1024) -> Tuple[float, float]:
    """(flops, bytes) of one batched CAGRA greedy walk: the wide seed
    round then ``iters`` expansions of ``width*degree`` distance evals,
    each a d-dim dot product, plus the itopk pool maintenance."""
    evals = float(n_seeds + iters * width * degree)
    flops = b * (evals * 2.0 * d + iters * itopk * 2.0)
    bytes_ = _F32 * b * (evals * d + iters * degree * width)
    return flops, bytes_


def price_int8_coarse(b: int, rows: int, d: int) -> Tuple[float, float]:
    """(flops, bytes) of one int8 coarse top-k dispatch: the same
    [b,d]x[d,rows] arithmetic as the float32 matmul (codes cast to f32
    chunk-by-chunk in cache — the cast never lands in HBM), but the
    matrix moves ONE byte per element (+ the per-row f32 scales) — the
    4x HBM win the compression exists for shows up on the same axis."""
    flops = 2.0 * b * rows * d
    bytes_ = (rows * d  # int8 codes
              + _F32 * rows  # per-row scales
              + _F32 * (b * d + b * rows))  # f32 queries + scores
    return flops, bytes_


def price_pq_adc(b: int, rows: int, m: int, n_codes: int,
                 d_sub: int) -> Tuple[float, float]:
    """(flops, bytes) of one PQ ADC dispatch: the per-subspace
    [b, n_codes] table matmuls plus the gather+sum over the uint8 code
    columns — bytes are dominated by the m*rows code bytes, which is
    the entire point."""
    flops = 2.0 * b * m * n_codes * d_sub + 1.0 * b * m * rows
    bytes_ = (m * rows  # uint8 codes
              + _F32 * (m * n_codes * d_sub  # codebooks
                        + b * m * d_sub  # query subvectors
                        + b * rows))  # scores
    return flops, bytes_


def price_tiered_route(b: int, parts: int, d: int) -> Tuple[float, float]:
    """(flops, bytes) of the host-side cluster routing matmul: one
    [b,d]x[d,parts] centroid scoring per batch — the tiny price that
    buys skipping every unprobed partition's codes entirely."""
    flops = 2.0 * b * parts * d
    bytes_ = _F32 * (parts * d + b * d + b * parts)
    return flops, bytes_


def price_rerank(b: int, pool: int, d: int) -> Tuple[float, float]:
    """(flops, bytes) of the exact rerank over a gathered candidate
    pool: one [b,d]x[d,pool] float32 matmul over rows gathered from the
    host source of truth (counted as bytes moved — the gather IS the
    cost the overfetch knob trades against recall)."""
    flops = 2.0 * b * pool * d
    bytes_ = _F32 * (b * pool * d + b * d + b * pool)
    return flops, bytes_


def price_walk_quant(b: int, d: int, iters: int, width: int,
                     degree: int, itopk: int, head_dims: int, keep: int,
                     n_seeds: int = 1024) -> Tuple[float, float]:
    """(flops, bytes) of one QUANTIZED CAGRA walk: the seed round reads
    full int8 rows, each iteration gathers ``width*degree`` candidate
    HEADS (head_dims int8 each — the PCA prefilter) and only ``keep``
    full int8 rows; the host-side exact rerank of the pool is priced
    separately (``price_rerank``)."""
    m = float(width * degree)
    flops = b * (n_seeds * 2.0 * d
                 + iters * (m * 2.0 * head_dims + keep * 2.0 * d
                            + itopk * 2.0))
    bytes_ = b * (n_seeds * d  # int8 seed rows
                  + iters * (m * head_dims + keep * d  # int8 gathers
                             + _F32 * m))  # adjacency/scale columns
    return flops, bytes_


def price_walk_pq(b: int, d: int, iters: int, width: int, degree: int,
                  itopk: int, m: int, n_codes: int,
                  n_seeds: int = 1024) -> Tuple[float, float]:
    """(flops, bytes) of one PQ CAGRA walk: one
    per-query ADC table einsum ([m, n_codes] dots of d/m dims), then
    the seed round and each iteration's ``width*degree`` candidates
    cost ``m`` uint8 code gathers + table adds apiece; the host exact
    rerank of the pool is priced separately (``price_rerank``)."""
    cand = float(iters * width * degree)
    d_sub = d / max(m, 1)
    flops = b * (2.0 * m * n_codes * d_sub  # ADC tables
                 + (n_seeds + cand) * m  # table-lookup adds
                 + iters * itopk * 2.0)  # pool maintenance
    bytes_ = b * (m * (n_seeds + cand)  # uint8 code gathers
                  + _F32 * (m * n_codes + cand))  # tables + adjacency
    return flops, bytes_


def price_chain_topk(b: int, f: int, kp: int) -> Tuple[float, float]:
    """(flops, bytes) of one device graph chain-top-k dispatch
    (query/device_graph.py): per anchor, a width-``f`` CSR friend
    gather, ``f*kp`` strip-head rank gathers, and the top-k merge over
    the ``f*kp`` composite keys. Gather-dominated: flops are the merge
    comparisons, bytes the int32 index/rank/neighbor traffic."""
    width = float(f * kp)
    flops = b * (2.0 * width + width)  # top-k compares + key composition
    bytes_ = 4.0 * b * (2 + 2 * f + 3 * width)
    return flops, bytes_


def price_graph_agg(e1: int, e2: int, n: int) -> Tuple[float, float]:
    """(flops, bytes) of one strip-aggregation build dispatch: the
    terminal-degree segment-sum over ``e2`` edges, the weighted group
    segment-sum over ``e1``, and the lexicographic distinct-pair pass
    (sort ~ e1*log2(e1))."""
    import math

    lg = math.log2(max(e1, 2))
    flops = 2.0 * e2 + 3.0 * e1 + e1 * lg
    bytes_ = 4.0 * (3 * e1 + 2 * e2 + 3 * n)
    return flops, bytes_


def price_cooc_gram(m: int, a: int, bcols: int) -> Tuple[float, float]:
    """(flops, bytes) of one co-occurrence Gram contraction
    ``[a, m] x [m, b]`` over the padded incidence matrices."""
    flops = 2.0 * m * a * bcols
    bytes_ = _F32 * (m * a + m * bcols + a * bcols)
    return flops, bytes_


def price_traverse_rank(b: int, frontier: int, d: int,
                        kp: int) -> Tuple[float, float]:
    """(flops, bytes) of one fused traverse-then-rank dispatch: the
    frontier expansion gathers, the ``[b, frontier, d]`` vector gather
    + cosine dot, and the top-k over frontier scores."""
    flops = b * (frontier * 2.0 * d + 2.0 * frontier + kp * 2.0)
    bytes_ = _F32 * b * (frontier * d + d + 2 * frontier)
    return flops, bytes_


def price_upsert(n_points: int, d: int) -> Tuple[float, float]:
    """(flops, bytes) of one bulk vector upsert: the
    normalize pass (~2 flops/dim) over ``n_points`` rows plus the rows
    moved host->device twice (staging + index append). Write traffic
    was unpriced before this; a bulk-upserting tenant looked free to
    the cost meter while monopolizing the device."""
    flops = 2.0 * n_points * d
    bytes_ = 2.0 * _F32 * n_points * d
    return flops, bytes_


def price_decay_sweep(m: int) -> Tuple[float, float]:
    """(flops, bytes) of one background decay sweep dispatch
    (background/device_plane.py): ~10 elementwise ops per node over
    seven f32 input columns and three output columns, priced at the
    padded bucket ``m``."""
    flops = 10.0 * m
    bytes_ = _F32 * 10.0 * m
    return flops, bytes_


def price_linkpredict(b: int, f1: int, f2: int,
                      kp: int) -> Tuple[float, float]:
    """(flops, bytes) of one background link-prediction dispatch: per
    seed, the ``f1*f2`` two-hop candidate expansion, the sort over the
    expansion (``W*log2(W)`` compares), the segment reduction, and the
    top-``kp`` selection; bytes are the int32/f32 gather traffic over
    the expansion."""
    import math

    w = float(f1 * f2)
    lg = math.log2(max(w, 2.0))
    flops = b * (w * lg + 4.0 * w + 2.0 * kp)
    bytes_ = 4.0 * b * (f1 + 3.0 * w + 2.0 * kp)
    return flops, bytes_


def price_fastrp(n: int, edges: int, dim: int,
                 iters: int) -> Tuple[float, float]:
    """(flops, bytes) of one background FastRP dispatch: ``iters``
    neighbor-mean propagations (one ``dim``-wide segment-sum over both
    edge directions apiece) plus the per-iteration row normalization
    over ``n`` rows."""
    flops = iters * (2.0 * 2.0 * edges * dim + 5.0 * n * dim)
    bytes_ = _F32 * iters * (2.0 * edges * dim + 3.0 * n * dim)
    return flops, bytes_


def price_bm25(b: int, nnz: int, unique_terms: int,
               rows: int) -> Tuple[float, float]:
    """(flops, bytes) of one device-BM25 scoring dispatch: tf/idf math +
    segment-sum over the batch's unique-term postings (nnz), then the
    [b, U] x [U, rows] idf-weighted score matmul."""
    flops = 8.0 * nnz + 2.0 * b * max(unique_terms, 1) * rows
    bytes_ = _F32 * (2 * nnz + b * max(unique_terms, 1) + b * rows)
    return flops, bytes_


# -- recording ---------------------------------------------------------------


def cost_name(obj: Any) -> str:
    """The structure's resource-accounting identity (stamped by
    ``obs.resources.register``), or 'unregistered'."""
    return getattr(obj, "_obs_resource_name", None) or "unregistered"


def set_observer(fn) -> None:
    """Register the per-record cost observer (obs/device.py):
    called as ``fn(kind, queries, flops, bytes_)`` so calibration can
    join analytic cost against measured dispatch seconds."""
    global _observer
    _observer = fn


_observer = None


def record_query_cost(kind: str, index: str, queries: int,
                      flops: float, bytes_: float) -> None:
    """Record one priced dispatch. ``queries`` is the REAL batch size
    (pre-padding); flops/bytes are the padded program's."""
    if not _m.enabled():
        return
    _FLOPS_C.labels(kind, index).inc(flops)
    _BYTES_C.labels(kind, index).inc(bytes_)
    _QUERIES_C.labels(kind, index).inc(queries)
    # per-tenant metering: under an active batch mix the
    # padded-dispatch cost splits across riders by tenant (the
    # leader->rider channel); else the current context's tenant pays
    _tenant.record_cost(queries, flops, bytes_)
    obs_fn = _observer
    if obs_fn is not None:
        obs_fn(kind, queries, flops, bytes_)


def cost_summary(registry: Optional[Registry] = None
                 ) -> List[Dict[str, Any]]:
    """Aggregated cost-per-query per (kind, index): the telemetry that
    admission control / replica routing consume. Scrape-time only."""
    reg = registry if registry is not None else REGISTRY
    fams = {
        "flops": reg.get("nornicdb_query_cost_flops_total"),
        "bytes": reg.get("nornicdb_query_cost_bytes_total"),
        "queries": reg.get("nornicdb_query_cost_queries_total"),
    }
    if any(f is None for f in fams.values()):
        return []
    children = {name: fam.children() for name, fam in fams.items()}
    out: List[Dict[str, Any]] = []
    for key in sorted(children["queries"]):
        kind, index = key
        queries = children["queries"][key].value
        if queries <= 0:
            continue
        flops = (children["flops"].get(key).value
                 if key in children["flops"] else 0.0)
        byts = (children["bytes"].get(key).value
                if key in children["bytes"] else 0.0)
        out.append({
            "kind": kind, "index": index, "queries": int(queries),
            "flops_total": flops, "bytes_total": byts,
            "flops_per_query": round(flops / queries, 1),
            "bytes_per_query": round(byts / queries, 1),
        })
    return out
