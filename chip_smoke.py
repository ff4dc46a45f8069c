#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nornicdb_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--docs N] [--index-rows N]

Phases, in order; any failure exits non-zero:

1. Device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. Build: compiles both CUDA kernels from ``nornicdb_tpu_torch/csrc``.
3. Kernel vs plain version on the card, on seeded inputs: the fused
   cosine top-k (B1) against a matmul + mask + stable top-k (D in {160,
   1024} x B in {1, 2, 3, 4, 5, 7, 8, 16, 33, 64, 65, 200, 256} x k in
   {1, 10, 30, 128, 256}; at B in {1, 4, 7, 64}: D = 33 and a misaligned
   base (the scalar or 4-byte copy variants), C = 5, an all-masked index
   and fewer valid rows than k; phase 7's vector index, C 8,192 with
   8,000 valid rows, k 10, at B in {1, 4, 5, 8, 15, 16}; phase 9's inference
   index, C 8,192 with 8,000 valid rows and C 16,384 with 8,320, at B 1 and
   k in {9, 16}; two calls
   bitwise equal at B in {1, 4, 8, 64, 256}), and flash attention (B2) against the materializing softmax,
   in f32 and in bf16: S in {1, 16, 33, 64, 100, 128, 512} x (H, Dh) in
   {(4, 16), (4, 40), (16, 64)} with one row fully masked, two calls
   bitwise equal at the ingest shape (and in f32 at 8, 512, 16, 64), and
   an f32 query whose base is not 16-byte aligned.
4. Main path through the public entry points: ``open(device="cuda")`` with
   the committed mini encoder (bf16, the default), ``store`` of seeded
   documents, ``flush`` (the embed queue must have failed no node, and the
   vector index must hold every document). The host HNSW library
   (``csrc/hnsw_host.cpp``) is built with ``c++`` and timed apart. The
   first ``db.search`` backfills the indexes; at 10,000 vectors and above
   the strategy machine builds HNSW once at its end (``stats.strategy``
   must read ``hnsw``, ``hnsw_builds`` 1). Then 64 queries each in vector,
   text and hybrid mode, one at a time, with the result cache invalidated
   (a generation bump) before each mode, so no timed query is a cache hit.
   Vector mode is served from HNSW, held to recall@10 >= 0.95 against
   ``vector_search_candidates(..., exact=True)``. Above
   ``NORNICDB_HYBRID_MIN_N`` (4,096) documents the first hybrid query
   starts the fused tier's snapshot build in the background, and the
   phase waits for it (``HYBRID_BUILD_TIMEOUT_S``); at
   ``NORNICDB_HYBRID_WALK_MIN_N`` (100,000) vectors the next one starts
   the walk graph's build (B1 over the rows in chunks of 1,024 at k 33,
   then the host reorder), and the phase waits for that too and prints
   its seconds by part, B1's launches by B, ``iters`` and the graph's
   device bytes against the ``memory_allocated`` delta. (A run with fewer
   documents lowers both floors to half its size.) Every timed hybrid
   query must then be served by the walk tier (``hybrid_walk_f32``, no
   step down, no hand-off) with lexical lists tie-aware the host path's,
   fused lists bitwise the host ``rrf_fuse`` of their own lists, and
   walk-parity (fused top 10 against the host hybrid ranking) and vector
   recall@10 (against ``exact=True``) >= 0.95 at the port's walk
   defaults; both recalls are printed at the reference's (itopk 64, width
   1) too. A block with the walk off on the live pipeline times the same
   queries on the exact tier (``hybrid_brute_f32``, one B1 launch each,
   lists agreeing with the host path). The walk runs again on the CPU on
   the same graph and queries, and must agree (ids tie-aware, scores
   within 1e-5). Both kernels' launch counters must grow, and the vector
   answers must match the plain path (B = 64). Then 16 client threads
   send 32 queries each, alternating vector and hybrid, with the cache's
   probe missing so that every request reaches its tier: the hybrid
   batcher must coalesce (mean batch above 1, a dispatch at B >= 5);
   vector queries call HNSW directly (no vector rides) above the
   threshold; every answer must agree with the one-at-a-time answer. Then
   the same threads ride the brute tier's vector batcher directly
   (``svc._microbatch.search``, the route of every deployment under the
   threshold) over the same index: mean batch above 1, a B1 launch at
   B >= 5 on that route, answers equal to one-at-a-time ``exact=True``
   answers. The fused dispatch is timed by part (host plan, device by
   events and by ``torch.profiler`` with its kernel count, decode, the
   whole ``search_batch``) on both tiers at B in ``FUSED_TIMED_B``. The
   cache phase repeats the 64 hybrid queries twice after an invalidation:
   the second pass must be 64 cache hits equal to the first pass's
   answers, and after one ``store`` the next repeat must miss. Then
   ``vector_search_candidates(qv, 300, exact=True)`` must take the
   wide-k route and not B1, and agree with the plain path. Then stores
   while it recalls: ``WRITE_MIX_BLOCKS`` blocks of ``WRITE_MIX_ROUNDS``
   rounds, each one ``store`` and one timed hybrid ``recall``, blocks
   cycling through the walk tier, the host path (whose vector half is
   HNSW) and the exact tier; it reports each arm's p50/p99 and host ms
   per query by part, with the HNSW insert each store makes, accepts no
   hand-off but a vector race, requires the walk to merge the stores
   (rows re-fused on the host), and after a flush every recent document
   must be found by its own text with fused answers that agree with the
   host path. Last, the ``cagra`` ANN profile: a second service over the
   same rows' embeddings builds the device graph once (``strategy
   cagra``), and 64 vector queries must each ride the vector batcher into
   a walk, with recall@10 >= 0.95 against ``exact=True``.
   The observability core (``nornicdb_tpu_torch/obs``) is reset at the
   phase's start and read in four parts (``obs (a)``-``(d)`` lines): (a)
   once the snapshot and the walk graph are built, ``reconcile()``: its
   ``backend_bytes`` must equal ``torch.cuda.memory_allocated()`` read
   beside it, the lexical snapshot's resource bytes the snapshot's own
   (its ``memory_allocated`` delta within the allocator's 512-byte
   rounding per tensor) and the graph's resource bytes plus the exact
   tier's join map the graph's delta; the drift is split into the
   encoder's weights, the join maps, cuBLAS's workspaces (the bytes
   ``torch._C._cuda_clearCublasWorkspaces()`` frees) and the rest. (b) At the phase's end,
   ``calibration_summary()``: each kind's dispatches must equal the
   phase's own counts (``hybrid_fused`` and ``hybrid_walk_fused`` the
   fused tier's dispatches, ``microbatch`` the batches of the three
   batchers, ``cagra_walk`` the walks, ``bm25_score`` eight direct
   ``DeviceBM25.search_batch`` calls of eight queries, held against the
   host index); the EWMA per bucket and the effective FLOPs/s and bytes/s
   beside the card's roofs are printed. Over the concurrent block's
   direct vector rides the ``microbatch`` dispatches must equal B1's
   launch growth. (c) Hybrid p50 on the exact tier with the layer on and
   with ``obs.set_enabled(False)``, ``OBS_BLOCKS`` interleaved blocks of
   the 64 queries per arm (1 in a late run): on must stay within 2x off
   + 1 ms (the reference's overhead budget); the ratio is printed. (d)
   ``REGISTRY.render()``: bytes and ms, and every family the wired modules
   declare at import must appear. ``OBS_PHASE_S`` joins the late rule.
5. Index at deployment scale: a 1,048,576 x 1024 float32
   ``BruteForceIndex`` filled through ``add_batch`` and searched at
   the (B, k) of ``INDEX_TIMED``, through B1, checked against the plain
   path.
6. Durable: phase 4's corpus stored again through ``open(data_dir,
   engine="native")`` (the native KV engine, ``csrc/kv_host.cpp``, built
   with ``c++``), all but the last 1,024 docs with phase 4's embeddings
   passed explicitly and those 1,024 through the embed queue (B2), in a
   git-ignored ``_durable/`` dir. The first search backfills and builds
   HNSW; the index saves the debounce timer makes meanwhile are counted
   and timed. 64 queries each of vector, text, hybrid on the exact tier
   (walk off) and hybrid on the walk tier (its floor lowered to half the
   docs, since the forgets drop the live count under 100,000); then 64
   ``forget``s of ids those answers named, the four modes again (the
   answers before the close), ``close`` (the final index save), and
   ``memory_allocated`` must be back within 1 MB of its value before the
   phase. The reopen (``engine="auto"``) must be the native engine, build
   no HNSW, re-index and embed no node, count the docs less the
   forgotten, answer no forgotten id, give vector, text and exact-tier
   answers bitwise those before the close and walk answers tie-aware
   (walk-parity and recall@10 against the answers before the close
   >= 0.95), and launch B1 for the graph's rebuild and the exact tier. It
   prints the time to recover by part (segment scan, BM25, vector read,
   device upload, HNSW load, resume scan, first query per mode, snapshot
   and graph waits), close times and bytes on disk per file, and the
   record codec's MB/s. Then the same nodes through
   ``engine="python"`` (WAL + snapshots, no search): store, close,
   reopen, every id read back; and for each engine a child process that
   writes with ``sync_every_write=True`` until it has acknowledged 1,000
   writes and is SIGKILLed: the reopen must find every acknowledged id.
7. Cypher, in four parts. (a) The reference's Cypher benchmark graph
   (``bench.py:_bench_cypher``, ``random.Random(11)``: 50,000 persons
   with 20 KNOWS each, 100,000 messages, 50 cities, 40 tags, ~1.35 M
   edges) in ``NamespacedEngine(MemoryEngine(), "bench")`` under a
   ``CypherExecutor`` with its query cache off; the four LDBC shapes and
   the Northwind write each run for ``LDBC_WINDOW_S`` (queries/s, p50,
   p99), and each read shape's fast-path rows must equal the row
   interpreter's as multisets (8 rotating parameters per point shape,
   one run per aggregate shape); every Northwind write must create its
   edge, and no read shape any. Under the default
   ``NORNICDB_GRAPH_DEVICE=auto`` the executor's device graph plane
   builds ``avg_friends_per_city``'s strip view on the card; the other
   shapes serve from the host. (d), right after (a), on its graph and
   executor: ``recent_messages_friends`` rows against the same executor
   under ``off``, for 64 single reads under ``on`` (one dispatch each)
   and 16 threads x 16 reads under ``auto`` (coalesced batches,
   dispatched or below ``MIN_B``), one B 16 and one B 64 dispatch timed;
   the strip view and the tag Gram built on a fresh catalog on the card
   and on the host, bitwise, and ``tag_cooccurrence`` rows under ``on``;
   traverse-then-rank over ``KNOWS`` (1 and 2 hops, B 1, 16, 64, k 10)
   into a 50,000 x 160 ``BruteForceIndex`` of seeded unit vectors against
   the host version (ids tie-aware, scores within 1e-5); a fresh plane's
   chain, rank and whole-graph snapshots against the ``memory_allocated``
   delta (within 1 MB), PageRank (20 iterations) against the host
   version (rtol 1e-4, atol 1e-7), degree counts against
   ``np.bincount``, the snapshot cached. (b) On the card, through
   ``open(data_dir, engine="native")``: 8,000 ``Memory`` nodes of a
   seeded Zipf corpus created by ``UNWIND $rows ... CREATE`` in batches
   of 500, a flush (every memory embedded through the queue, B2), then 3
   ``RELATES_TO`` edges each by ``UNWIND ... MATCH ... CREATE`` in
   batches of 500;
   then 64 queries each, one at a time: GraphRAG
   (``db.index.vector.queryNodes`` then a ``MATCH``; below the HNSW
   threshold the procedure rides the vector batcher into B1), rows
   against B1's plain version over the index's device rows (ids
   tie-aware, scores within 1e-5); ``db.index.fulltext.queryNodes``
   against the BM25 index; a 2-hop ``MATCH`` against the row
   interpreter. B1 is timed on the index's rows at B in {1, 4, 8}. 16 threads
   × 16 GraphRAG queries must coalesce (mean batch above 1, a B1 launch
   at B >= 5) and answer as one at a time. ``DB.graph_vector_search``
   from 32 anchors over 1 and 2 ``RELATES_TO`` hops must answer as the
   plane's host version, in one dispatch each, with no B1 launch. (c)
   1,000 ``Event`` nodes with
   ``datetime``, ``date`` and ``duration`` values created by Cypher; the
   DB is closed and reopened (``engine="auto"``): the values, and
   GraphRAG answers (bitwise), must be those before the close, with no
   node re-embedded; then ``multidb_manager`` creates two databases,
   writes to each, checks their counts are isolated and drops one. The
   launches of (b) and (c) are the kernels line's ``launches_cypher``.
   (e) APOC, strict mode, rerank and ``similar``, each part's launches
   counted apart (counts set to 0 just before it, read just after, the
   enclosing path's put back): on (a)'s graph, right after (d),
   ``CALL apoc.algo.pageRank() YIELD node, score`` through (a)'s executor
   (query cache off), every node once with scores within rtol 1e-4 / atol
   1e-7 of the host version, descending beyond that tolerance, the
   plane's snapshot built at most once and reused, wall split into
   PageRank and row materialisation; on (b)'s DB, before (c):
   ``svc.similar`` for 64 stored nodes (B1 through the vector batcher) against B1's
   plain top-k over the index's rows without the node (ids tie-aware,
   scores within 1e-5); 64 hybrid ``recall``s of texts the embedder has
   not cached with ``LocalReranker(embedder)`` attached, each answer's
   order and ``rerank_score`` equal to the reranker's formula recomputed
   in numpy from the candidates it was handed (within 1e-6), B1 and B2
   launched, timed against the same 64 without the reranker (embed cache
   cleared between); (b)'s three read shapes, 64 parameters each,
   alternating ``parser_mode`` fast and strict on the DB's executor
   (query cache off): rows equal, the added ms per query; a trigger added
   by ``apoc.trigger.add`` fires on one write and is removed;
   ``apoc.periodic.iterate`` sets a property on all 8,000 memories in
   batches of 1,000 (8,000 committed, 0 failed), and 2-hop chain reads
   afterwards see it, equal to those of an executor whose catalog is built
   after the writes, from a new catalog version. On phase 4's DB, after its recall check: ``similar`` for 64
   stored nodes served by HNSW (no B1 launch), recall@10 >= 0.95 against
   ``exact=True``. Its launches are the kernels line's ``launches_apoc``;
   ``APOC_PHASE_S`` joins the late rule (a late run takes 1 timed
   repetition and 1 strict-corpus repeat, not ``APOC_REPS``).
8. Quant and tiered (``NORNICDB_VECTOR_QUANT``, ``NORNICDB_VECTOR_TIERED``,
   each set for the block and restored). (b) runs right after phase 5, on
   its 1,048,576 x 1024 index: the int8 plane's build by part, its device
   bytes against the ``memory_allocated`` delta (within 1 MB), bytes per
   vector against float32's, the transient peak of a B 64 batch
   (``max_memory_allocated``), p50 of 32 single queries and of 3 batches
   of 64 (k 10), recall@10 >= 0.95 against B1 (``exact=True``, computed
   before the counts are set to 0); the int8 path launches neither
   kernel, so its launches (``launches_quant_index``) must be 0.
   (a) runs last, over phase 4's corpus (100,000 bf16 embeddings, a
   131,072 x 160 index, its BM25 index and 64 queries embedded again):
   for int8 and PQ each, a fresh index's plane (built inline) with the
   same records, 64 queries one at a time and one batch of 64 through
   ``search_batch``, every answer's scores within 1e-5 of the exact
   float32 cosines, recall@10 >= 0.95 against B1, the plane's
   ``dispatch`` count for every batch and no step-down, and the float32
   pair never uploaded; then the fused hybrid tier over that plane (walk
   off: every query served by ``hybrid_brute_<mode>``), the ``cagra``
   profile's strategy build over a quantized graph base (B1 k-NN, then
   the base quantized; vector queries through the service's batcher into
   the quantized walk, recall@10 >= 0.95) and the fused walk tier on that
   graph (every query ``hybrid_walk_quant``), each with walk-parity
   >= 0.95 against the host hybrid ranking and a ``torch.profiler`` count
   of one B 1 walk's kernels. Last the tiered plane, half of its
   partitions resident, under a ``SearchService`` whose HNSW threshold
   lies above the corpus: each query through
   ``vector_search_candidates(qv, 30, lexical_doc_ids=<its BM25 top
   32>)`` (the ``tiered_route``). Routing, at ``NORNICDB_TIERED_NPROBE=20``
   (this corpus misses recall 0.95 at the default 8): an answer that
   probed cold partitions must agree with an exact host scan of them
   (cold parity 1.0), recall@10 >= 0.95. Paging, at the default 8 (its
   recall@10 printed): the pager is drained and the same query asked
   again must be served from the slabs (no cold scan). Then 8 hybrid
   searches on the host path (``NORNICDB_HYBRID_FUSED=0``), each text
   embedded by the service, must route through the tiered plane too. It
   prints partitions, resident device bytes against the
   ``memory_allocated`` delta, bytes on disk (a temporary directory,
   removed after), promotions and evictions. Its launches
   (``launches_quant``) are counted after the queries are embedded and
   the exact answers computed, and must be exactly the paths' own: B1
   for the two graph builds' k-NN, B2 for the 8 hybrid searches.
9. The memory plane, in three parts. (a) The background plane at the
   reference's size (``bench.py:_bench_background``): two identical
   engines of 100,000 nodes and 300,000 KNOWS/LIKES edges, one node in
   three accessed in the last 40 days; a ``BackgroundDevicePlane`` on the
   card with a ``DecayManager`` (threshold 0.45) on one, the host loops on
   the other. A cold and a warm decay sweep: (scored, archived) and the
   archived sets must equal the host loop's. 256 seeds with each of
   ``common_neighbors``, ``adamic_adar`` and ``resource_allocation`` at
   limit 10 (the snapshots both sides reuse built and timed first): every
   list must equal host ``predict_links``; the step-downs are printed by
   reason. FastRP at dim 64 over the union graph: min
   cosine against host ``fastrp_embeddings`` above 0.999. Each op again
   on the card and on CPU copies of its tensors: decay scores within
   1e-6, link-prediction ids tie-aware with values within 1e-6 and equal
   distinct counts, FastRP rows at cosine >= 0.9999. It prints each job's
   wall time on the device against the host loop, each op's device ms by
   CUDA events, and the snapshot's device bytes against the
   ``memory_allocated`` delta (within 1 MB). (b) A port DB (in memory,
   on the card) of 8,000 memories with explicit, clustered 160-wide
   embeddings, below the HNSW threshold: 256 more stored with
   ``auto_link=True`` (candidates ride B1 through the vector batcher, at
   least one launch each); every inferred ``SIMILAR_TO`` edge's confidence
   at or above the threshold and within 1e-5 of its exact cosine (float64
   on the host, and ``exact=True``). 64 more stored plain, then
   ``inference.on_store_batch`` with the plane attached must give the
   per-node path's suggestions (both first as dry runs from the same
   state), then write them. 8 rounds of ``remember`` on an unlinked pair
   must make the evidence-gated ``CO_ACCESSED_WITH`` edge. (c)
   ``gds.graph.project``, ``gds.fastRP.stream`` and
   ``gds.linkPrediction.adamicAdar.stream`` (16 sources) through
   ``DB.cypher`` on (b)'s graph: rows equal to the module calls they
   wrap. The launches of (b) and (c), without the checks' (the dry runs,
   ``exact=True``), are the kernels line's ``launches_memory``: B1 only.

Timing uses CUDA events over back-to-back calls, and ``torch.profiler``
for the device time of each kernel per call: B1 by stage and its library
call (matmul + where + topk) at B in ``MAIN_TIMED_B`` on the main path's
index, at the graph build's shape (B 1,024 of the rows, k 33), and at
``INDEX_TIMED`` on the deployment-scale one, B2 and SDPA at the shapes in
``ATTN_TIMED``; the quantized walks' kernels per B 1 call in phase 8. The
second-to-last line is a JSON object with
one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A copy of every measurement goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # bf16 tensor cores, dense

# Tolerances. Both kernels compute in float32 and differ from their plain
# versions only in the order of float sums (sequential fmaf against cuBLAS
# and torch's softmax reductions), so:
TOPK_SCORE_ATOL = 1e-5  # |cosine| <= 1 over D <= 1024 terms
ATTN_F32_ATOL = 2e-5    # outputs are convex combinations of |v| ~ 1 values
# bf16: both sides round to bf16, and their f32 sums run in another order
# (tensor-core MMAs against cuBLAS and torch's softmax), so an output that
# lies within ~1e-6 of a rounding midpoint may land one rounding step
# apart: at most 3.9e-3 below |out| = 1, 7.8e-3 between 1 and 2. The
# check allows 4e-3 or one step of the value (attn_allowed); the report
# keeps the plain max abs error.
ATTN_BF16_ATOL = 4e-3
# The same encoder in float32 on the card and on the CPU: float sums in
# another order only.
EMBED_F32_COS_MIN = 0.99999
# The DB's bf16 encoder against the float32 one: each rounding to bf16
# keeps 8 mantissa bits, and two layers of projections round many times.
EMBED_BF16_COS_MIN = 0.9995
# Lexical scores of the fused tier against the host index: the dense
# [B, U] x [U, C] product adds a doc's terms in another order than the
# host (and may fuse a multiply-add), so a score may move by a rounding
# step; lists agree tie-aware within this relative tolerance.
LEX_RTOL = 1e-5
# HNSW is the statistical tier above 10,000 vectors: its answers are held
# to recall@10 against exact search, as the reference holds its own
RECALL_MIN = 0.95
REFERENCE_EF_SEARCH = 64  # the JAX package's SearchService default
HYBRID_BUILD_TIMEOUT_S = 300.0  # the hybrid snapshot's and the walk graph's builds
# the JAX package's CAGRA walk defaults (pool, frontier width), printed
# beside the port's (ROADMAP C14)
REFERENCE_WALK = (64, 1)
CONCURRENT_THREADS = 16
CONCURRENT_PER_THREAD = 32
VECTOR_RIDE_K = 30  # a recall(limit=10)'s vector overfetch
# the store-while-recall phase: blocks alternate fused tier and host path
WRITE_MIX_ARMS = ("walk", "host", "brute")  # the fused tier on the walk, the host path,
# the fused tier with its walk off; blocks cycle through them twice
WRITE_MIX_BLOCKS = 6
WRITE_MIX_ROUNDS = 48

RUN_LIMIT_S = 1200.0  # the whole run must end within this
# phase 7's length at full windows, with room: it took 143-158 s on an
# H100; a run that could not fit it before the limit measures (a)'s
# shapes for 0.5 s each instead (its graph keeps its size)
CYPHER_PHASE_S = 240.0
GRAPH_PLANE_S = 60.0  # phase 7 (d)'s budget; a late run shortens its timing, not its checks
QUANT_PHASE_S = 260.0  # phase 8 (a)'s length (206-237 s on an H100 80GB, 700 W), with room
OBS_PHASE_S = 20.0  # phase 4's observability block (a)-(d); a late run times 1 block in (c)
OBS_BLOCKS = 4  # (c)'s interleaved on/off blocks of the 64 hybrid queries per arm
# families the modules wired into the observability core declare at import
OBS_FAMILIES = (
    "nornicdb_microbatch_batch_size", "nornicdb_microbatch_queue_depth",
    "nornicdb_convoy_batch_size", "nornicdb_deadline_early_dispatch_total",
    "nornicdb_request_stage_seconds", "nornicdb_device_dispatch_total",
    "nornicdb_device_compile_total", "nornicdb_device_dispatch_seconds",
    "nornicdb_device_first_call_seconds", "nornicdb_device_compile_seconds",
    "nornicdb_device_eff_flops_per_s", "nornicdb_device_eff_bytes_per_s",
    "nornicdb_device_padding_efficiency", "nornicdb_device_mem_ledger_bytes",
    "nornicdb_device_mem_backend_bytes", "nornicdb_device_mem_drift_bytes",
    "nornicdb_device_mem_leak_total", "nornicdb_device_unexpected_recompile_total",
    "nornicdb_search_strategy_total", "nornicdb_device_bm25_events_total",
    "nornicdb_hybrid_fused_events_total", "nornicdb_cagra_events_total",
    "nornicdb_query_cost_flops_total", "nornicdb_query_cost_bytes_total",
    "nornicdb_query_cost_queries_total", "nornicdb_wal_append_seconds",
    "nornicdb_wal_fsync_seconds", "nornicdb_index_device_bytes", "nornicdb_index_rows",
    "nornicdb_queue_depth", "nornicdb_compile_cache_entries",
    "nornicdb_tenant_cost_flops_total", "nornicdb_tenant_device_seconds_total",
    "nornicdb_events_total")

REPORT: dict = {}
T_START = time.perf_counter()  # main() sets it when the run starts


def log(msg: str) -> None:
    print(msg, flush=True)


def run_is_late(extra_s: float = 0.0) -> bool:
    """The late rule: whether the run so far, ``extra_s`` more and the
    budgets of phases 7-9 would pass ``RUN_LIMIT_S``. A late phase
    shortens its timing, never its checks."""
    return (time.perf_counter() - T_START + extra_s + CYPHER_PHASE_S + GRAPH_PLANE_S
            + APOC_PHASE_S + QUANT_PHASE_S + MEMORY_PHASE_S > RUN_LIMIT_S)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _kernel_name(key: str) -> str:
    """A profiler kernel name without return type, namespace noise,
    template arguments or parameters."""
    import re

    if "Memset" in key:
        return "memset"
    key = re.sub(r"^void ", "", key).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", key, maxsplit=1)[0].strip()


def device_split(fn, iters: int = 10, expect: str = "", launches: dict = None) -> dict:
    """Device milliseconds per call of each kernel (and memset) that ``fn``
    launches, from a torch.profiler trace of ``iters`` calls; ``launches``,
    when given, receives each one's launches per call. A trace that lost
    the kernel named ``expect`` (the profiler now and then drops a ctypes
    launch's record, or a whole trace) is taken again, up to three times;
    if all three lose it, CUDA events time the whole call instead, under
    one key that says so, and ``launches`` stays empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for ev in prof.key_averages():
            total_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            if total_us and ev.device_type == torch.autograd.DeviceType.CUDA:
                name = _kernel_name(ev.key)
                out[name] = out.get(name, 0.0) + total_us / iters / 1e3
                counts[name] = counts.get(name, 0) + ev.count / iters
        if out and any(expect.lower() in name.lower() for name in out):
            if launches is not None:
                launches.update(counts)
            return out
    ms = time_ms(fn, iters=iters, warmup=0)
    key = f"{expect or 'all kernels'} (CUDA events; the profiler lost the trace)"
    REPORT.setdefault("profiler_lost", []).append(key)
    log(f"profiler: three traces lost the device records of {expect or 'fn'} (last: "
        f"{json.dumps(out)}); timed by CUDA events instead: {ms:.4f} ms per call")
    return {key: ms}


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = None):
    """(least milliseconds the card could take, which roof binds); the
    operations run at ``flops_per_s`` (float32 outside the tensor cores
    unless given)."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / (flops_per_s or F32_FLOPS_PER_S)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def topk_cost(b: int, c: int, d: int, k: int):
    """Bytes (matrix, queries, mask read once; scores + ids written once)
    and float32 FLOPs of one exact top-k call."""
    return c * d * 4 + b * d * 4 + c + b * k * 8, 2.0 * b * c * d


def attn_cost(b: int, s: int, h: int, dh: int, elem: int):
    """Bytes (q, k, v read once, out written once, mask) and FLOPs."""
    return 4 * b * s * h * dh * elem + b * s, 4.0 * b * h * s * s * dh


# B1's timed query counts, k = MAIN_K on the main path's index, and (B, k) on
# the deployment-scale one: B = 1 is what a search sends, B <= 4 the
# streaming scan, B >= 5 the register-tiled kernel (8 on the bytes side of
# the B = 40 crossover, 64 and 256 on the operations side; k = 128 at
# B = 64 takes a 32-query tile, so the matrix is read twice).
MAIN_TIMED_B = (1, 4, 8, 64)
MAIN_K = 32  # recall(limit=10) asks 30 candidates, which the batchers round to 32
FUSED_TIMED_B = (1, 8, 64)
INDEX_TIMED = ((1, 10), (4, 10), (8, 10), (64, 10), (256, 10), (64, 128))

# B2's timed shapes (B, S, H, Dh), each in both types: ingest through the
# mini encoder, one query embedded on the search path, the mini encoder at
# its max_len (the long-document bucket), and bge-m3-like heads (the most
# work per launch). bf16 is the main path's type; f32 serves exact
# embeddings, and is bound by its FMAs from S = 80.
ATTN_SHAPES = ((16, 64, 4, 40), (1, 16, 4, 40), (16, 512, 4, 40), (8, 512, 16, 64))
ATTN_TIMED = tuple((shape, dtype) for dtype in ("bfloat16", "float32")
                   for shape in ATTN_SHAPES)


# -- phase 1 ---------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    REPORT["card"] = smi
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from nornicdb_tpu_torch import resolve_device

    return resolve_device("cuda")  # also turns TF32 off for the plain versions


# -- phase 2 ---------------------------------------------------------------


def phase_build():
    from nornicdb_tpu_torch.ops import _build

    t0 = time.perf_counter()
    compile_s = _build.build()
    _build.library("cosine_topk")
    _build.library("flash_attention")
    total = time.perf_counter() - t0
    REPORT["build_s"] = total
    log(f"build: {total:.2f} s (nvcc {compile_s:.2f} s, both sources in parallel)")
    for name in _build.SOURCES:
        for line in _build.ptxas_lines(_build.build_log(name)):
            log(f"  ptxas[{name}]: {line}")


# -- phase 3 ---------------------------------------------------------------


def _normalized(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def check_topk(dev, rng, c, d, b, k, valid_frac=0.9, m=None, misaligned=False):
    """One B1 case: masked rows, duplicated rows (exact ties), queries
    that hit the duplicates. ``misaligned`` offsets both bases by one
    float (the scalar path). Returns the max abs score error."""
    import torch

    from nornicdb_tpu_torch.ops.similarity import cosine_topk
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree

    n_dup = min(c // 4, 512)
    if m is None:  # a matrix passed in carries the same duplicates
        m = _normalized(rng, c, d)
        m[c - n_dup:] = m[:n_dup]  # exact duplicates -> exact score ties
    valid = rng.random(c) < valid_frac
    q = _normalized(rng, b, d)
    q[: b // 2] = m[rng.integers(0, n_dup, b // 2)]  # queries on duplicated rows
    if misaligned:
        qt, mt = (torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(np.float32))
                  .to(dev)[1:].view(x.shape) for x in (q, m))
    else:
        qt, mt = (torch.from_numpy(x).to(dev) for x in (q, m))
    vt = torch.from_numpy(valid).to(dev)
    s_k, i_k = fused_cosine_topk(qt, mt, vt, k)
    s_p, i_p = cosine_topk(qt, mt, vt, k)
    torch.cuda.synchronize()
    s_k, i_k, s_p, i_p = (x.cpu().numpy() for x in (s_k, i_k, s_p, i_p))
    if (s_k.shape != (b, min(k, c)) or i_k.dtype != np.int64
            or not np.isfinite(s_k).all()):
        raise AssertionError(f"B1 bad output shape/values at C={c} D={d} B={b} k={k}")
    err = float(np.abs(s_k - s_p).max())
    if not topk_agree(i_k, s_k, i_p, s_p, TOPK_SCORE_ATOL):
        raise AssertionError(
            f"B1 disagrees with its plain version at C={c} D={d} B={b} k={k} "
            f"valid {valid_frac} misaligned {misaligned} (max score err {err:.3g})")
    return err


def check_topk_deterministic(dev, rng, c, d, b, k):
    """Two calls on the same inputs give bitwise-equal scores and ids."""
    import torch

    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk

    m = torch.from_numpy(_normalized(rng, c, d)).to(dev)
    m[c // 2: c // 2 + 512] = m[:512]  # exact ties across distant blocks
    valid = torch.from_numpy(rng.random(c) < 0.9).to(dev)
    q = m[torch.arange(b, device=dev) * 7].contiguous()
    first = fused_cosine_topk(q, m, valid, k)
    second = fused_cosine_topk(q, m, valid, k)
    if not (torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])):
        raise AssertionError(f"B1 is not deterministic at C={c} D={d} B={b} k={k}")


def attn_allowed(ref, dtype, atol):
    """Largest difference allowed from the plain version's output ``ref``:
    ``atol`` in float32; in bf16 also one rounding step of ``ref`` (2^-7
    of its power of two), which exceeds ``atol`` from |ref| = 1 on."""
    import torch

    if dtype != torch.bfloat16:
        return torch.full_like(ref.float(), atol)
    step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=1e-30))) - 7)
    return step.clamp(min=atol)


def check_attention(dev, rng, b, s, h, dh, dtype, atol, fully_masked=False,
                    twice=False, misaligned=False):
    """One B2 case with ragged key lengths (the first row full). With
    ``fully_masked`` the last row masks every key, so the plain version
    gives the uniform average over its S keys; with ``twice`` two calls
    must be bitwise equal; with ``misaligned`` q's base lies one element
    off a 16-byte boundary. Returns the max abs error."""
    import torch

    from nornicdb_tpu_torch.ops.attention import flash_attention, reference_attention

    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32))
               .to(dev).to(dtype) for _ in range(3))
    if misaligned:
        flat = torch.empty(q.numel() + 1, dtype=dtype, device=dev)
        q = flat[1:].view(q.shape).copy_(q)
        if q.data_ptr() % 16 == 0:
            raise AssertionError("the misaligned query base is aligned")
    lengths = rng.integers(1, s + 1, b)
    lengths[0] = s
    if fully_masked:
        lengths[-1] = 0
    mask = torch.from_numpy(np.arange(s)[None, :] < lengths[:, None]).to(dev)
    out = flash_attention(q, k, v, mask)
    ref = reference_attention(q, k, v, mask)
    torch.cuda.synchronize()
    what = f"B={b} S={s} H={h} Dh={dh} {dtype}"
    if out.shape != q.shape or out.dtype != dtype or not torch.isfinite(out).all():
        raise AssertionError(f"B2 bad output at {what}")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    over = diff > attn_allowed(ref, dtype, atol)
    if over.any():
        i = int(over.flatten().nonzero()[0])
        raise AssertionError(
            f"B2 disagrees with its plain version at {what}: {int(over.sum())} outputs "
            f"over the tolerance, first {out.flatten()[i].item()} against "
            f"{ref.flatten()[i].item()}; max abs {err:.3g}")
    if fully_masked:
        uniform = v[-1].float().mean(0, keepdim=True).expand(s, h, dh).to(dtype).float()
        if ((ref[-1].float() - uniform).abs() > attn_allowed(uniform, dtype, atol)).any():
            raise AssertionError(f"B2's plain version is not uniform on a masked row at {what}")
    if twice and not torch.equal(out, flash_attention(q, k, v, mask)):
        raise AssertionError(f"B2 is not deterministic at {what}")
    return err


def phase_kernels(dev, seed):
    import torch

    rng = np.random.default_rng(seed)
    errs = []
    for d, c in ((160, 100_003), (1024, 30_011)):
        m = _normalized(rng, c, d)
        m[c - 512:] = m[:512]  # exact duplicates -> exact score ties
        for b in (1, 2, 3, 4, 5, 7, 8, 16, 33, 64, 65, 200, 256):
            for k in (1, 10, 30, 128, 256):
                errs.append(check_topk(dev, rng, c, d, b, k, m=m))
        if d == 160:  # the walk graph's k-NN chunk (search/cagra.py:knn_forward)
            errs.append(check_topk(dev, rng, c, d, 1024, 33, m=m))
    for b in (1, 4, 7, 64):
        for k in (10, 256):
            errs.append(check_topk(dev, rng, 5000, 33, b, k))  # D % 4 != 0: scalar copies
        errs.append(check_topk(dev, rng, 5000, 160, b, 30, misaligned=True))
        errs.append(check_topk(dev, rng, 5, 160, b, 5))        # fewer rows than blocks or QB
        errs.append(check_topk(dev, rng, 5, 33, b, 3))
        errs.append(check_topk(dev, rng, 3000, 160, b, 30, valid_frac=0.0))  # all masked
        # fewer valid rows than k: the tail carries the masked score
        errs.append(check_topk(dev, rng, 300, 160, b, 256, valid_frac=0.3))
    # phase 7's vector procedure: C 8,192 (the index's capacity), 8,000
    # valid rows, k 10, B as the batcher coalesces 16 clients
    for b in CYPHER_TOPK_B:
        errs.append(check_topk(dev, rng, CYPHER_CAPACITY, 160, b, 10,
                               valid_frac=CYPHER_MEMORIES / CYPHER_CAPACITY))
    # phase 9's inference path: B 1 at the batcher's k and exact=True's, on
    # the index's capacity before and after its stores cross 8,192 rows
    for c, valid_rows in INFER_CAPACITIES:
        for k in INFER_K:
            errs.append(check_topk(dev, rng, c, INFER_DIMS, 1, k, valid_frac=valid_rows / c))
    repeat_b = (1, 4, 8, 64, 256)
    for b in repeat_b:
        check_topk_deterministic(dev, rng, 131_072, 160, b, 30)
    REPORT["topk_max_abs_err"] = max(errs)
    log(f"B1 vs plain: {len(errs)} cases agree (tie-aware), max score err "
        f"{max(errs):.3g} <= {TOPK_SCORE_ATOL}; two calls bitwise equal at B in {repeat_b}")
    errs = {}
    for dtype, atol in ((torch.float32, ATTN_F32_ATOL), (torch.bfloat16, ATTN_BF16_ATOL)):
        e = errs[dtype] = [check_attention(dev, rng, 16, 64, 4, 40, dtype, atol,
                                           twice=True)]  # the ingest shape
        for h, dh in ((4, 16), (4, 40), (16, 64)):
            for s in (1, 16, 33, 64, 100, 128, 512):
                e.append(check_attention(dev, rng, 8, s, h, dh, dtype, atol,
                                         fully_masked=True))
    f32 = errs[torch.float32]
    f32.append(check_attention(dev, rng, 8, 512, 16, 64, torch.float32, ATTN_F32_ATOL,
                               fully_masked=True, twice=True))
    f32.append(check_attention(dev, rng, 8, 33, 4, 40, torch.float32, ATTN_F32_ATOL,
                               fully_masked=True, misaligned=True))
    bf = errs[torch.bfloat16]
    REPORT["attention_max_abs_err"] = max(max(f32), max(bf))
    REPORT["attention_f32_max_abs_err"] = max(f32)
    REPORT["attention_bf16_max_abs_err"] = max(bf)
    log(f"B2 vs plain: f32 {len(f32)} cases max abs {max(f32):.3g} <= {ATTN_F32_ATOL}; bf16 "
        f"{len(bf)} cases max abs {max(bf):.3g} (allowed: {ATTN_BF16_ATOL} or one bf16 "
        f"rounding step of the value); one row fully masked in each case but the first; "
        f"two calls bitwise equal at the ingest shape in both types and at "
        f"B=8 S=512 H=16 Dh=64 in f32; an f32 query base off 16-byte alignment")


# -- phase 4 ---------------------------------------------------------------


def make_corpus(rng, n_docs, n_words=5000):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.integers(3, 10))) for _ in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)  # Zipf-like word frequencies
    p /= p.sum()
    lengths = rng.integers(10, 61, n_docs)
    words = rng.choice(n_words, size=int(lengths.sum()), p=p)
    docs, pos = [], 0
    for n in lengths:
        docs.append(" ".join(vocab[w] for w in words[pos:pos + n]))
        pos += n
    queries = [" ".join(vocab[w] for w in rng.choice(n_words, rng.integers(3, 7), p=p))
               for _ in range(64)]
    return docs, queries


def hits_agree(a, b, atol):
    """Tie-aware agreement of two ranked [(id, score)] lists."""
    from nornicdb_tpu_torch.ops.topk import topk_agree

    if len(a) != len(b):
        return False
    return not a or topk_agree([[i for i, _ in a]], [[s for _, s in a]],
                               [[i for i, _ in b]], [[s for _, s in b]], atol)


def lex_atol(hits):
    return LEX_RTOL * max([1.0] + [abs(s) for _, s in hits])


def trio_agrees(trio, lex, vec, overfetch):
    """A fused-tier answer against lexical and vector lists computed
    another way: each list tie-aware, the fused list bitwise the host
    ``rrf_fuse`` of the trio's own lists, and equal to the other answer's
    fuse where both lists match id for id."""
    from nornicdb_tpu_torch.search.rrf import rrf_fuse

    if not (hits_agree(trio["lex"], lex, lex_atol(lex))
            and hits_agree(trio["vec"], vec, TOPK_SCORE_ATOL)):
        return False
    if not (trio["lex"] and trio["vec"]):
        return True
    if trio["fused"] != rrf_fuse([trio["lex"], trio["vec"]], limit=overfetch):
        return False
    same = ([i for i, _ in trio["lex"]] == [i for i, _ in lex]
            and [i for i, _ in trio["vec"]] == [i for i, _ in vec])
    return not same or trio["fused"] == rrf_fuse([lex, vec], limit=overfetch)


def walk_trio_agrees(trio, lex, overfetch):
    """A walk-tier answer against the host's lexical list: that list
    tie-aware, the fused list bitwise the host ``rrf_fuse`` of the trio's
    own lists (its vector list is approximate: held by recall)."""
    from nornicdb_tpu_torch.search.rrf import rrf_fuse

    if not hits_agree(trio["lex"], lex, lex_atol(lex)):
        return False
    return not (trio["lex"] and trio["vec"]) or \
        trio["fused"] == rrf_fuse([trio["lex"], trio["vec"]], limit=overfetch)


def recall10(got, want):
    """Recall@10 of one ranked list against another's top 10."""
    truth = {i for i, _ in want[:10]}
    return len({i for i, _ in got[:10]} & truth) / max(len(truth), 1)


class TrioRecorder:
    """Keeps each fused-tier answer the service consumes (query, trio),
    for checking after the timed run; the service's behaviour is unchanged."""

    def __init__(self, svc):
        self.inner = svc._fused_hybrid_trio
        self.rows = []
        svc._fused_hybrid_trio = self

    def __call__(self, query, qv, overfetch, weights):
        trio = self.inner(query, qv, overfetch, weights)
        self.rows.append((query, trio))
        return trio


def wait_for_snapshot(svc):
    """The fused tier once its background snapshot build has landed."""
    t0 = time.perf_counter()
    while True:
        fused = svc._fused
        if fused is not None and fused.ready:
            return fused, time.perf_counter() - t0
        if time.perf_counter() - t0 > HYBRID_BUILD_TIMEOUT_S:
            raise AssertionError(
                f"the hybrid snapshot was not built within {HYBRID_BUILD_TIMEOUT_S} s")
        time.sleep(0.05)


def wait_for_graph(fused):
    """The walk tier's graph once its background build has landed; a
    failed build raises from ``ensure_graph`` at once."""
    t0 = time.perf_counter()
    while fused.cagra.ensure_graph() is None:
        if time.perf_counter() - t0 > HYBRID_BUILD_TIMEOUT_S:
            raise AssertionError(
                f"the walk graph was not built within {HYBRID_BUILD_TIMEOUT_S} s")
        time.sleep(0.05)
    return fused.cagra._graph, time.perf_counter() - t0


def batcher_delta(mb, before):
    """(batches, queries, sizes) a batcher served since ``before``."""
    from collections import Counter

    sizes = Counter(mb.sizes)
    sizes.subtract(before[2])
    return (mb.batches - before[0], mb.batched_queries - before[1],
            {b: n for b, n in sorted(sizes.items()) if n})


def batcher_mark(mb):
    from collections import Counter

    return mb.batches, mb.batched_queries, Counter(mb.sizes)


def invalidate_cache(svc, why):
    """Bump the result cache's generation, as an index write does, so the
    next queries reach their tier."""
    gen = svc.generation
    svc._clear_result_cache()
    log(f"  result cache invalidated {why} (generation {gen} -> {svc.generation})")


class CacheBypass:
    """Inside a ``with`` block every probe of the service's result cache
    misses (counted in ``probes``), so repeated queries reach their tier;
    puts are unchanged."""

    def __init__(self, svc):
        self.cache = svc._result_cache
        self.probes = 0

    def __enter__(self):
        def miss(key):
            self.probes += 1
            return None

        self.cache.get_hits = miss
        return self

    def __exit__(self, *exc):
        del self.cache.get_hits


def route_split(total, vector, fused):
    """B1 launches by batch size on each route: the micro-batched vector
    ride, the fused hybrid dispatch, and direct calls (the rest)."""
    direct = dict(total)
    for part in (vector, fused):
        for b, n in part.items():
            direct[b] = direct.get(b, 0) - n
    return {"vector_ride": vector, "fused_hybrid": fused,
            "direct": {b: n for b, n in sorted(direct.items()) if n}}


def phase_main_path(dev, seed, n_docs):
    import torch

    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.ops.attention import flash_attention
    from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto, l2_normalize
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree
    from nornicdb_tpu_torch.search import hnsw_native
    from nornicdb_tpu_torch.search.hnsw import HNSWIndex
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_BRUTE_F32, TIER_WALK_F32

    rng = np.random.default_rng(seed + 1)
    docs, queries = make_corpus(rng, n_docs)
    # a quick run: bring the fused tier's and the walk's floors under it
    for knob, floor in (("NORNICDB_HYBRID_MIN_N", 4096), ("NORNICDB_HYBRID_WALK_MIN_N", 100_000)):
        if n_docs < floor:
            os.environ.setdefault(knob, str(max(n_docs // 2, 1)))
            log(f"  {knob}={os.environ[knob]} for {n_docs} docs")

    flash_attention.launches = 0
    fused_cosine_topk.launches = 0
    fused_cosine_topk.launch_sizes.clear()
    # the observability core counts this phase from here (obs (b))
    from nornicdb_tpu_torch import obs
    from nornicdb_tpu_torch.obs import dispatch as obs_dispatch

    obs.set_enabled(True)
    obs.device.reset()
    obs_dispatch.reset()
    db = nornicdb_tpu_torch.open(device=dev)
    t0 = time.perf_counter()
    for i, text in enumerate(docs):
        db.store(text, node_id=f"d{i}")
    store_s = time.perf_counter() - t0
    db.flush()
    flush_s = time.perf_counter() - t0 - store_s
    # the embed queue is fail-open: a kernel fault while embedding is
    # logged and the node left without a vector, so count both here
    if db._embed_queue.failed_count:
        raise AssertionError(f"the embed queue failed {db._embed_queue.failed_count} nodes")
    # the host HNSW library (c++ -march=native, at first use on this CPU),
    # built here so that the HNSW build below is timed without it
    t1 = time.perf_counter()
    hnsw_native.get_lib()
    host_build_s = time.perf_counter() - t1
    log(f"  host HNSW library: built or loaded in {host_build_s:.2f} s")
    t1 = time.perf_counter()
    hnsw_build = PartTimer({"build": (HNSWIndex, "build")})
    try:
        svc = db.search  # builds BM25 + vector (+ HNSW) indexes over the stored nodes
    finally:
        hnsw_build.close()
    index_s = time.perf_counter() - t1
    if len(svc.vectors) != n_docs:
        raise AssertionError(f"the vector index holds {len(svc.vectors)} of {n_docs} documents")
    use_hnsw = n_docs >= svc.hnsw_threshold
    strategy = {"strategy": svc.stats.strategy, "hnsw_builds": svc.stats.hnsw_builds,
                "host_library_s": host_build_s,
                "hnsw_build_s": hnsw_build.ms["build"] / 1e3, "threshold": svc.hnsw_threshold}
    if use_hnsw:
        hnsw = svc.hnsw
        if svc.stats.strategy != "hnsw" or svc.stats.hnsw_builds != 1 \
                or hnsw_build.calls["build"] != 1 \
                or hnsw is None or len(hnsw) != n_docs:
            raise AssertionError(f"the backfill did not build HNSW once over every vector: {strategy}")
        strategy.update(hnsw_vectors=len(hnsw), hnsw_max_level=hnsw._max_level,
                        hnsw_m=hnsw.m, hnsw_ef_construction=hnsw.ef_construction,
                        hnsw_ef_search=hnsw.ef_search)
        log(f"  strategy {svc.stats.strategy}: {svc.stats.hnsw_builds} HNSW build over "
            f"{len(hnsw)} vectors in {strategy['hnsw_build_s']:.3f} s (of the "
            f"{index_s:.2f} s index build), top level {hnsw._max_level}")
    elif svc.stats.strategy != "brute" or svc.stats.hnsw_builds:
        raise AssertionError(f"HNSW built below its threshold: {strategy}")
    else:
        log(f"  strategy brute: {n_docs} docs, under the {svc.hnsw_threshold}-vector threshold")
    vec_mark, hyb_mark = batcher_mark(svc._microbatch), batcher_mark(svc._hybrid_batch)
    lat = {}
    results = {}

    def timed(mode, label=None):
        label = label or mode
        invalidate_cache(svc, f"before the timed {label} queries")
        hits0 = svc.stats.cache_hits
        ts = []
        for q in queries:
            t = time.perf_counter()
            results[(label, q)] = db.recall(q, limit=10, mode=mode)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        lat[label] = ts
        if svc.stats.cache_hits != hits0 + len(queries) - len(set(queries)):
            raise AssertionError(f"a timed {label} query was served by the result cache")

    def counts_since(before):
        return {key: n - before.get(key, 0) for key, n in fused.counts.items()
                if n != before.get(key, 0)}

    timed("vector")
    timed("text")
    # the first hybrid query (served by the host path) starts the fused
    # tier's snapshot build in the background
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    db.recall(queries[0], limit=10, mode="hybrid")
    fused, wait_s = wait_for_snapshot(svc)
    torch.cuda.synchronize()
    snap_alloc = torch.cuda.memory_allocated() - mem0
    snap_bytes = fused.lex.device_bytes()
    log(f"  hybrid snapshot: built in {fused.lex.build_s:.3f} s (waited {wait_s:.3f} s), "
        f"{snap_bytes} bytes of columns on the card, memory_allocated grew {snap_alloc} "
        f"bytes; capacity {fused.lex._snap['c']} rows")
    # the next hybrid query is the first fused dispatch: at walk_min_n
    # vectors it starts the walk graph's build in the background and the
    # exact tier serves it meanwhile. The brute matrix's device copy is
    # made first, so that the memory delta below is the graph's (and the
    # exact tier's join map's)
    walk_min_n = fused.walk_min_n
    use_walk = walk_min_n is not None and len(svc.vectors) >= walk_min_n
    svc.vectors.device_view()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    invalidate_cache(svc, "before the query that starts the walk graph's build")
    db.recall(queries[1], limit=10, mode="hybrid")
    walk = {"used": use_walk, "walk_min_n": walk_min_n}
    graph = None
    if use_walk:
        graph, graph_wait_s = wait_for_graph(fused)
        torch.cuda.synchronize()
        graph_alloc = torch.cuda.memory_allocated() - mem0
        cg = fused.cagra
        l2v = fused.lex._snap["row_maps"]["l2v"][1]
        l2v_bytes = l2v.numel() * l2v.element_size()
        knn_sizes = dict(sorted(fused_cosine_topk.launch_sizes.items()))
        n = graph["n"]
        if knn_sizes.get(1024, 0) != n // 1024 or (n % 1024 and not knn_sizes.get(n % 1024)):
            raise AssertionError(f"the graph build's B1 launches by B are {knn_sizes} for {n} rows")
        if graph["iters"] != cg._auto_iters(n) or cg.builds != 1:
            raise AssertionError(f"graph: iters {graph['iters']}, builds {cg.builds}")
        walk.update(graph_rows=n, graph_capacity=graph["rows"], build_s=cg.build_s,
                    graph_wait_s=graph_wait_s, iters=graph["iters"], degree=cg.degree,
                    itopk=cg.itopk, width=cg.search_width,
                    graph_device_bytes=cg.device_bytes(), l2v_map_bytes=l2v_bytes,
                    memory_allocated_delta=graph_alloc, b1_launch_sizes=knn_sizes)
        log(f"  walk graph: built in {cg.build_s['total']:.3f} s (k-NN forward "
            f"{cg.build_s['knn_forward']:.3f} s, reorder {cg.build_s['reorder']:.3f} s, device "
            f"copy {cg.build_s['device_copy']:.3f} s; waited {graph_wait_s:.3f} s), {n} rows, "
            f"capacity {graph['rows']}, degree {cg.degree}, iters {graph['iters']}, itopk "
            f"{cg.itopk}, width {cg.search_width}; B1 launches by B {knn_sizes} "
            f"(fused_cosine_topk.launch_sizes); {cg.device_bytes()} bytes of graph on the card "
            f"+ {l2v_bytes} of the exact tier's join map, memory_allocated grew {graph_alloc}")
    else:
        log(f"  walk tier off: {len(svc.vectors)} vectors, walk_min_n {walk_min_n}")
    ledger = obs_ledger(db, svc, fused, snap_bytes, snap_alloc,
                        walk.get("memory_allocated_delta"), walk.get("l2v_map_bytes", 0))
    recorder = TrioRecorder(svc)
    counts0 = dict(fused.counts)
    timed("hybrid")  # invalidates first: the warm-up queries above were cached
    served = counts_since(counts0)
    launches = {"flash_attention": flash_attention.launches,
                "cosine_topk": fused_cosine_topk.launches}
    sizes = dict(sorted(fused_cosine_topk.launch_sizes.items()))
    vec_rides = batcher_delta(svc._microbatch, vec_mark)[2]
    if use_walk:
        # a walk launches no B1: the graph build's chunks are a route of
        # their own, and the hybrid rides that launched B1 are those the
        # exact tier served (the query that started the build)
        build = {1024: graph["n"] // 1024, graph["n"] % 1024: 1} if graph["n"] % 1024 \
            else {1024: graph["n"] // 1024}
        fused_b1 = {b: n - build.get(b, 0) - vec_rides.get(b, 0) for b, n in sizes.items()}
        routes = {"graph_build": build, "vector_ride": vec_rides,
                  "fused_hybrid": {b: n for b, n in fused_b1.items() if n}}
    else:
        routes = route_split(sizes, vec_rides, batcher_delta(svc._hybrid_batch, hyb_mark)[2])
    embedded = db._embedder.misses  # texts that reached the encoder
    log(f"main path launches: {launches} ({embedded} texts through the encoder); "
        f"B1 launches by B {sizes}, by route {routes}; fused tier {served}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    tier = TIER_WALK_F32 if use_walk else TIER_BRUTE_F32
    dispatch = "walk_dispatch" if use_walk else "dispatch"
    if served != {tier: len(queries), dispatch: len(queries)}:
        raise AssertionError(f"timed hybrid queries not all served by {tier}: {served}")
    walk_trios = dict(recorder.rows)
    brute_trios, brute = walk_trios, {"served": served}
    if use_walk:
        # the exact tier in a block of its own: the walk off on the live
        # pipeline, B1's counts set to 0 just before and read just after
        recorder.rows = []
        counts0 = dict(fused.counts)
        fused_cosine_topk.launches = 0
        fused_cosine_topk.launch_sizes.clear()
        flash_attention.launches = 0
        fused.walk_min_n = None
        try:
            timed("hybrid", "hybrid_brute")
        finally:
            fused.walk_min_n = walk_min_n
        brute = {"served": counts_since(counts0),
                 "flash_attention_launches": flash_attention.launches,
                 "cosine_topk_launches": fused_cosine_topk.launches,
                 "cosine_topk_launch_sizes": dict(fused_cosine_topk.launch_sizes)}
        log(f"  exact tier block (walk off): fused tier {brute['served']}; B1 launches "
            f"{brute['cosine_topk_launches']} by B {brute['cosine_topk_launch_sizes']}")
        if brute["served"] != {TIER_BRUTE_F32: len(queries), "dispatch": len(queries)} \
                or brute["cosine_topk_launch_sizes"] != {1: len(queries)}:
            raise AssertionError(f"the exact tier's block: {brute}")
        brute_trios = dict(recorder.rows)

    # the vector tier's answers against exact search (after the counts
    # were read): HNSW is approximate above the threshold, held to
    # recall@10 >= 0.95
    exact = {}
    for q in queries:
        qv = np.asarray(db._embedder.embed(q), np.float32)
        exact[q] = svc.vector_search_candidates(qv, 10, exact=True)
    recall10_vec = float(np.mean([
        len({h["id"] for h in results[("vector", q)]} & {i for i, _ in exact[q]}) / 10
        for q in queries]))
    strategy["vector_recall_at_10"] = recall10_vec
    extra = ""
    if use_hnsw:
        # the same queries at the reference's query beam (64), beside the
        # port's (ROADMAP C11)
        ref_hits = [hnsw.search(np.asarray(db._embedder.embed(q), np.float32), 30,
                                ef=REFERENCE_EF_SEARCH)[:10] for q in queries]
        ref_recall = float(np.mean([
            len({i for i, _ in h} & {i for i, _ in exact[q]}) / 10
            for h, q in zip(ref_hits, queries)]))
        strategy["recall_at_10_reference_ef"] = ref_recall
        extra = (f" at ef_search {hnsw.ef_search}; {ref_recall:.4f} at the reference's "
                 f"ef_search {REFERENCE_EF_SEARCH}")
    log(f"  vector mode ({svc.stats.strategy}): recall@10 {recall10_vec:.4f} against "
        f"exact=True over {len(queries)} queries{extra}")
    if recall10_vec < RECALL_MIN:
        raise AssertionError(f"vector recall@10 {recall10_vec:.4f} < {RECALL_MIN}")
    if use_hnsw:  # phase 7 (e)'s part on this DB
        REPORT.setdefault("apoc", {})["similar_hnsw"] = apoc_similar_hnsw(
            db, svc, n_docs, REPORT["card"])
    # right answers: hits are well-formed
    for (mode, q), hits in results.items():
        if not hits or len(hits) > 10:
            raise AssertionError(f"{mode} search for {q!r} returned {len(hits)} hits")
        if any(not np.isfinite(h["score"]) for h in hits):
            raise AssertionError(f"{mode} search returned a non-finite score")
    # the fused tier's answers against the host path for the same query
    qvs = np.asarray(db._embedder.embed_batch(queries), np.float32)
    host_lex = {q: svc.bm25.search(q, 30) for q in queries}
    exact30 = {q: svc.vectors.search_batch(qv[None, :], 30)[0] for q, qv in zip(queries, qvs)}
    for trios in (walk_trios, brute_trios):
        if sorted(trios) != sorted(set(queries)):
            raise AssertionError("the recorder missed timed hybrid queries")
    for q, trio in brute_trios.items():
        if trio is None or trio["served_by"] != TIER_BRUTE_F32 \
                or not trio_agrees(trio, host_lex[q], exact30[q], 30):
            raise AssertionError(f"the exact tier disagrees with the host path on {q!r}")
    log(f"  hybrid, exact tier: {len(brute_trios)} fused answers agree with the host path "
        f"(lexical tie-aware within {LEX_RTOL} relative, vector within {TOPK_SCORE_ATOL}, "
        f"fused bitwise the host rrf_fuse)")
    if use_walk:
        walk.update(check_walk_answers(fused, walk_trios, queries, qvs, host_lex, exact30))
        walk.update(check_walk_on_cpu(dev, fused, qvs))
    seq_trios = walk_trios
    # a stored document's own text finds that document first by exact
    # search (HNSW's answer is approximate by contract)
    probe = [int(x) for x in rng.integers(0, n_docs, 16)]
    dup = {}
    for i, t in enumerate(docs):
        dup.setdefault(t, i)
    for i in probe:
        qv = np.asarray(db._embedder.embed(docs[i]), np.float32)
        hit_id, score = svc.vector_search_candidates(qv, 1, exact=True)[0]
        if hit_id != f"d{dup[docs[i]]}" and abs(score - 1.0) > 1e-5:
            raise AssertionError(f"doc d{i} is not its own nearest neighbour: {hit_id} {score}")

    # embeddings on the card agree with the CPU port on a small input: two
    # explicit float32 embedders agree to float sums, and the DB's default
    # bf16 embedder agrees with them to bf16 rounding
    from nornicdb_tpu_torch.models.checkpoint import load_default_embedder

    sample = docs[:8] + queries[:8]
    f32 = [np.asarray(load_default_embedder(d, dtype=torch.float32).embed_batch(sample))
           for d in (dev, "cpu")]
    bf16 = np.asarray(db._embedder.inner.embed_batch(sample))
    if db._embedder.inner.cfg.dtype != torch.bfloat16:
        raise AssertionError("the default DB does not embed in bf16")
    for a, b, cos_min, what in ((f32[0], f32[1], EMBED_F32_COS_MIN, "f32 card vs CPU"),
                                (bf16, f32[1], EMBED_BF16_COS_MIN, "bf16 card vs f32 CPU")):
        cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
        if cos.min() < cos_min or not np.isfinite(a).all() or a.shape != (16, 160):
            raise AssertionError(f"{what} embedding cosine {cos.min():.7f} < {cos_min}")
        log(f"  embeddings {what}: min cosine {cos.min():.7f} >= {cos_min}")

    # vector answers vs the plain path over the same device index
    vecs = svc.vectors
    with vecs._lock:
        m, valid = vecs._device_arrays_locked()
    qv = l2_normalize(torch.tensor(np.asarray(db._embedder.embed_batch(queries)),
                                   dtype=torch.float32, device=dev)).contiguous()
    s_k, i_k = fused_cosine_topk(qv, m, valid, 30)
    s_p, i_p = cosine_topk_auto(qv, m, valid, 30)
    s_k, i_k, s_p, i_p = (x.cpu().numpy() for x in (s_k, i_k, s_p, i_p))
    if not topk_agree(i_k, s_k, i_p, s_p, TOPK_SCORE_ATOL):
        raise AssertionError("main-path vector answers disagree with the plain path")

    conc = phase_concurrent(db, svc, fused, recorder, queries, results, seq_trios)
    # the exact tier's coalesced dispatch under the same clients, the walk
    # off on the live pipeline (the route below walk_min_n vectors)
    conc_exact = (phase_concurrent(db, svc, fused, recorder, queries, results, brute_trios,
                                   exact_tier=True) if use_walk else None)
    fused_rows = [time_fused(db, svc, fused, queries, b, REPORT["card"], tier)
                  for tier in (("walk", "brute") if use_walk else ("brute",))
                  for b in FUSED_TIMED_B]

    cache = phase_cache(db, svc, fused, queries)

    # k = 300 > MAX_K: the reference's XLA route, counted apart from B1's
    # launches (recall(limit=100) asks HNSW for 300 above the threshold)
    before = (fused_cosine_topk.launches, fused_cosine_topk.wide_k_calls)
    wide_q = queries[:4]
    qw_np = np.asarray(db._embedder.embed_batch(wide_q), np.float32)
    wide = [svc.vector_search_candidates(qv, 300, exact=True) for qv in qw_np]
    grew = (fused_cosine_topk.launches - before[0], fused_cosine_topk.wide_k_calls - before[1])
    if grew != (0, len(wide_q)):
        raise AssertionError(f"k = 300 exact searches took B1 or skipped the wide-k route: {grew}")
    with vecs._lock:
        m, valid = vecs._device_arrays_locked()
    qw = l2_normalize(torch.tensor(qw_np, dtype=torch.float32, device=dev)).contiguous()
    s_p, i_p = (x.cpu().numpy() for x in cosine_topk_auto(qw, m, valid, 300))
    ext = vecs._ids_locked()
    for row, hits in enumerate(wide):
        if len(hits) != 300:
            raise AssertionError(f"a k = 300 exact search returned {len(hits)} hits")
        if not topk_agree([[i for i, _ in hits]], [[s for _, s in hits]],
                          [[ext[int(i)] for i in i_p[row]]], [s_p[row]], TOPK_SCORE_ATOL):
            raise AssertionError("k = 300 exact search disagrees with the plain path")
    log(f"  vector_search_candidates(k=300, exact=True): {len(wide_q)} wide-k calls, "
        f"0 B1 launches, answers agree")
    write_mix = phase_write_mix(db, svc, fused, docs, queries, rng)
    profile = phase_cagra_profile(dev, svc, qvs)
    obs_out = phase_obs(db, svc, fused, queries, profile, conc, run_is_late(OBS_PHASE_S))
    obs_out["ledger"] = ledger

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))

    mp = {
        "docs": n_docs, "store_docs_per_s": n_docs / store_s,
        "store_s": store_s, "flush_s": flush_s, "index_build_s": index_s,
        "embed_docs_per_s_incl_store": n_docs / (store_s + flush_s),
        "capacity": vecs._capacity, "dims": vecs.dims,
        "launches": launches,
        "cosine_topk_launch_sizes": sizes,
        "cosine_topk_routes": routes,
        "wide_k_calls": grew[1],
        "strategy": strategy,
        "cache": cache,
        "queries_per_mode": len(queries),
        "texts_embedded": embedded,
        "launches_per_query": {
            # on the exact tier a hybrid search scans the index once (the
            # walk launches no kernel); above the threshold a vector
            # search takes HNSW, below it one B1 ride more
            "cosine_topk": (brute["cosine_topk_launches"] / len(queries) if use_walk else
                            launches["cosine_topk"] / (len(queries) * (1 if use_hnsw else 2))),
            # per text through the encoder (one launch per layer per batch)
            "flash_attention": launches["flash_attention"] / max(embedded, 1),
        },
        "hybrid_fused": {
            "served": served, "snapshot_build_s": fused.lex.build_s,
            "snapshot_wait_s": wait_s, "snapshot_device_bytes": snap_bytes,
            "snapshot_memory_allocated_delta": snap_alloc,
            "snapshot_rows": fused.lex._snap["n"], "snapshot_capacity": fused.lex._snap["c"],
            "builds": fused.lex.builds, "dispatch_split": fused_rows,
        },
        "walk": walk,
        "exact_tier_block": brute,
        "concurrent": conc,
        "concurrent_exact_tier": conc_exact,
        "write_mix": write_mix,
        "cagra_profile": profile,
        "obs": obs_out,
    }
    for mode, ts in lat.items():
        mp[f"{mode}_p50_ms"] = pct(ts, 50)
        mp[f"{mode}_p99_ms"] = pct(ts, 99)
        # the first query of a mode pays one-time work (the device copy
        # of the matrix, the fused tier's row -> slot join map)
        mp[f"{mode}_first_ms"] = ts[0]
        mp[f"{mode}_max_after_first_ms"] = max(ts[1:])
    REPORT["main_path"] = mp
    log(f"main path: stored {n_docs} docs at {mp['store_docs_per_s']:.0f} docs/s, "
        f"flush {flush_s:.2f} s, index build {index_s:.2f} s, "
        f"capacity {vecs._capacity} x {vecs.dims}")
    for mode in lat:
        tier = {"vector": f" ({svc.stats.strategy})", "hybrid_brute": " (exact tier, walk off)",
                "hybrid": " (walk tier)" if use_walk else ""}.get(mode, "")
        log(f"  search {mode}{tier}: p50 {mp[mode + '_p50_ms']:.3f} ms "
            f"p99 {mp[mode + '_p99_ms']:.3f} ms (first {mp[mode + '_first_ms']:.3f} ms, "
            f"max after it {mp[mode + '_max_after_first_ms']:.3f} ms)")
    # phase 6 stores this corpus again, most of it with these embeddings
    nodes = db.storage.batch_get_nodes([f"d{i}" for i in range(n_docs)])
    corpus = (docs, queries, np.asarray([n.embedding for n in nodes], np.float32))
    del nodes
    bm25 = svc.bm25  # host state; phase 8 reads it after the close
    db.close()
    # each path's launches, its counts set to 0 just before it
    path_launches = {"one_at_a_time": launches, "concurrent": conc["launches"],
                     "write_mix": write_mix["launches"], "cagra_profile": profile["launches"]}
    if use_walk:
        path_launches["exact_tier_block"] = {
            "cosine_topk": brute["cosine_topk_launches"],
            "flash_attention": brute["flash_attention_launches"]}
        path_launches["concurrent_exact_tier"] = conc_exact["launches"]
    return path_launches, vecs, graph, corpus, bm25


def check_walk_answers(fused, trios, queries, qvs, host_lex, exact30):
    """The walk tier's timed answers: each trio served by the walk, its
    lexical list tie-aware the host's and its fused list bitwise the host
    ``rrf_fuse`` of its own lists; walk-parity (its fused top 10 against
    the host hybrid ranking) and vector recall@10 (its vector list against
    ``exact=True``), both held to RECALL_MIN at the port's walk defaults
    and printed at the reference's (ROADMAP C14)."""
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_WALK_F32
    from nornicdb_tpu_torch.search.rrf import rrf_fuse

    host = {q: rrf_fuse([host_lex[q], exact30[q]], limit=30) for q in queries}
    for q, trio in trios.items():
        if trio is None or trio["served_by"] != TIER_WALK_F32 or trio["tier"] != "walk" \
                or not walk_trio_agrees(trio, host_lex[q], 30):
            raise AssertionError(f"the walk tier's answer for {q!r} disagrees with the host path")
    parity = float(np.mean([recall10(trios[q]["fused"], host[q]) for q in queries]))
    vector = float(np.mean([recall10(trios[q]["vec"], exact30[q]) for q in queries]))
    cg = fused.cagra
    itopk, width = REFERENCE_WALK
    ref = cg.search_batch(qvs, 30, itopk=itopk, width=width)
    ref_parity = float(np.mean([recall10(rrf_fuse([host_lex[q], r], limit=30), host[q])
                                for q, r in zip(queries, ref)]))
    ref_vector = float(np.mean([recall10(r, exact30[q]) for q, r in zip(queries, ref)]))
    log(f"  hybrid, walk tier: {len(trios)} answers served by {TIER_WALK_F32}, lexical lists "
        f"tie-aware the host's, fused lists bitwise the host rrf_fuse of their own lists; at "
        f"itopk {cg.itopk}, width {cg.search_width}: walk-parity recall@10 {parity:.4f}, "
        f"vector recall@10 {vector:.4f}; at the reference's itopk {itopk}, width {width}: "
        f"{ref_parity:.4f} and {ref_vector:.4f}")
    if min(parity, vector) < RECALL_MIN:
        raise AssertionError(f"walk recall@10: parity {parity:.4f}, vector {vector:.4f} "
                             f"< {RECALL_MIN}")
    return {"walk_parity_recall_at_10": parity, "vector_recall_at_10": vector,
            "reference_walk": {"itopk": itopk, "width": width,
                               "walk_parity_recall_at_10": ref_parity,
                               "vector_recall_at_10": ref_vector}}


def check_walk_on_cpu(dev, fused, qvs):
    """The same graph and queries through ``walk_body`` on the card and on
    the CPU: ids tie-aware, scores within TOPK_SCORE_ATOL (batched
    products summed in another order)."""
    import torch

    from nornicdb_tpu_torch.ops.similarity import l2_normalize
    from nornicdb_tpu_torch.ops.topk import topk_agree
    from nornicdb_tpu_torch.search.cagra import walk_body

    cg, g = fused.cagra, fused.cagra._graph
    args = (MAIN_K, g["iters"], cg.search_width, cg.itopk, cg.hash_bits, cg.n_seeds)
    qn = l2_normalize(torch.from_numpy(qvs).to(dev)).contiguous()
    arrays = (qn, g["matrix"], g["adj"], g["validf"])
    t = time.perf_counter()
    s_g, i_g = (x.cpu().numpy() for x in walk_body(*arrays, *args))
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    s_c, i_c = (x.numpy() for x in walk_body(*(a.cpu() for a in arrays), *args))
    cpu_s = time.perf_counter() - t
    err = float(np.abs(s_g - s_c).max())
    same = float((i_g == i_c).mean())
    log(f"  walk on the card against the CPU: B {len(qvs)}, k {MAIN_K}: max score err "
        f"{err:.3g}, ids equal at {same:.4f} of positions ({card_s:.3f} s card, {cpu_s:.3f} s "
        f"CPU)")
    if not topk_agree(i_g, s_g, i_c, s_c, TOPK_SCORE_ATOL):
        raise AssertionError(f"the walk on the card disagrees with the CPU's (max err {err:.3g})")
    return {"card_vs_cpu_max_abs_err": err, "card_vs_cpu_ids_equal": same}


def phase_cagra_profile(dev, svc, qvs):
    """Vector search under the cagra ANN profile: a second service over
    explicit embeddings of the main path's rows (no text), backfilled
    once, so the strategy machine builds the device graph at its end. It
    must read ``strategy cagra`` with one build; then ``qvs`` one at a time
    in vector mode: every one rides the vector batcher into a walk
    (``_ann_search_batch``), recall@10 against ``exact=True`` >= RECALL_MIN,
    p50/p99 printed. The env knob is restored after."""
    import torch

    from nornicdb_tpu_torch.ops.attention import flash_attention
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk
    from nornicdb_tpu_torch.search.service import SearchService
    from nornicdb_tpu_torch.storage.memory import MemoryEngine
    from nornicdb_tpu_torch.storage.types import Node

    t_phase = time.perf_counter()
    matrix, valid, ext_ids = svc.vectors.snapshot()
    storage = MemoryEngine()
    for slot, eid in enumerate(ext_ids):
        if eid is not None and valid[slot]:
            storage.create_node(Node(id=eid, labels=[], properties={},
                                     embedding=matrix[slot].tolist()))
    flash_attention.launches = 0
    fused_cosine_topk.launches = 0
    fused_cosine_topk.launch_sizes.clear()
    old = os.environ.get("NORNICDB_VECTOR_ANN_QUALITY")
    os.environ["NORNICDB_VECTOR_ANN_QUALITY"] = "cagra"
    try:
        prof = SearchService(storage, device=dev, resource_name="service:cagra-profile")
        t0 = time.perf_counter()
        n = prof.build_indexes()
        index_s = time.perf_counter() - t0
        cg = prof.cagra
        if prof.stats.strategy != "cagra" or prof.stats.cagra_builds != 1 or cg is None \
                or cg.builds != 1 or prof.hnsw is not None:
            raise AssertionError(f"the cagra profile did not build one graph: {prof.stats}")
        walks0, mark = cg.counts["walk"], batcher_mark(prof._microbatch)
        lat, hits = [], []
        for qv in qvs:
            t = time.perf_counter()
            hits.append(prof.search(query_embedding=qv, mode="vector", limit=10, enrich=False))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        walks = cg.counts["walk"] - walks0
        rides = batcher_delta(prof._microbatch, mark)
        launches = {"flash_attention": flash_attention.launches,
                    "cosine_topk": fused_cosine_topk.launches}
        sizes = dict(fused_cosine_topk.launch_sizes)
        exact = [prof.vector_search_candidates(qv, 10, exact=True) for qv in qvs]
        recall = float(np.mean([recall10([(h["id"], h["score"]) for h in got], want)
                                for got, want in zip(hits, exact)]))
    finally:
        if old is None:
            del os.environ["NORNICDB_VECTOR_ANN_QUALITY"]
        else:
            os.environ["NORNICDB_VECTOR_ANN_QUALITY"] = old
    out = {"vectors": n, "index_build_s": index_s, "build_s": cg.build_s,
           "strategy": prof.stats.strategy, "cagra_builds": prof.stats.cagra_builds,
           "walks": walks, "vector_rides": rides[1], "ride_batches": rides[0],
           "recall_at_10": recall, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "itopk": cg.itopk,
           "width": cg.search_width, "iters": cg._graph["iters"], "launches": launches,
           "cosine_topk_launch_sizes": sizes, "fallbacks": {
               k: v for k, v in cg.counts.items() if k.startswith("fallback_")},
           # the whole service's, for obs (b)'s dispatch counts
           "batcher_batches": prof._microbatch.batches, "walks_total": cg.counts["walk"],
           "phase_s": time.perf_counter() - t_phase}
    log(f"cagra profile: {n} vectors (explicit embeddings of the main path's rows, no "
        f"text) backfilled in {index_s:.2f} s; strategy {out['strategy']}, "
        f"{out['cagra_builds']} build in {cg.build_s['total']:.3f} s (B1 launches by B "
        f"{sizes}); {len(qvs)} vector queries: {walks} walks from {rides[1]} vector rides in "
        f"{rides[0]} batches, recall@10 {recall:.4f} against exact=True at itopk {cg.itopk}, "
        f"width {cg.search_width}; p50 {out['p50_ms']:.3f} p99 {out['p99_ms']:.3f} ms; the "
        f"phase took {out['phase_s']:.2f} s")
    if walks != len(qvs) or rides[1] != len(qvs) or out["fallbacks"]:
        raise AssertionError(f"cagra profile: vector queries did not all walk: {out}")
    if recall < RECALL_MIN:
        raise AssertionError(f"cagra profile: recall@10 {recall:.4f} < {RECALL_MIN}")
    return out


def obs_dispatches(kind):
    """Dispatches of ``kind`` the observability core recorded since the
    phase reset it."""
    from nornicdb_tpu_torch import obs

    return obs.calibration_summary()["kinds"].get(kind, {}).get("dispatches", 0)


def obs_ledger(db, svc, fused, snap_bytes, snap_alloc, graph_alloc, l2v_bytes):
    """Phase 4's obs (a): one ``reconcile()`` once the snapshot and the
    graph are built. Its backend bytes must equal ``memory_allocated``
    read beside it; the lexical snapshot's resource bytes equal the
    snapshot's columns (its delta within 512 bytes a tensor: the
    allocator's rounding), the graph's resource bytes plus the exact
    tier's join map the graph's delta. The drift is split into the
    encoder's weights, the join maps, cuBLAS's workspaces and the rest."""
    import torch

    from nornicdb_tpu_torch import obs
    from nornicdb_tpu_torch.obs import device as obs_device

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rec = obs_device.reconcile()
    after = torch.cuda.memory_allocated()
    log(f"obs (a) reconcile: ledger_bytes {rec['ledger_bytes']}, backend_bytes "
        f"{rec['backend_bytes']} (memory_allocated {before} before, {after} after), "
        f"drift_bytes {rec['drift_bytes']}, bound {rec['bound_bytes']}, leak "
        f"{rec['leak_suspected']}; device {obs_device.ledger_device()}")
    if not before == rec["backend_bytes"] == after:
        raise AssertionError(f"obs: backend_bytes {rec['backend_bytes']} is not "
                             f"memory_allocated {before}/{after}")
    res = {(e["family"], e["index"]): e for e in obs.resource_snapshot()}
    for (family, index), e in sorted(res.items()):
        if "device_bytes" in e:
            log(f"obs (a) resource {family} {index}: device_bytes {e['device_bytes']}, rows "
                f"{e.get('rows')}, capacity {e.get('capacity')}")
    lex = res[("device_bm25", svc.resource_name)]["device_bytes"]
    if lex != snap_bytes or abs(snap_alloc - lex) >= 512 * 4:
        raise AssertionError(f"obs: the snapshot's resource bytes {lex} against its columns "
                             f"{snap_bytes} and its memory_allocated delta {snap_alloc}")
    graph = None
    if graph_alloc is not None:
        graph = res[("cagra", f"{svc.resource_name}:hybrid_walk")]["device_bytes"]
        if graph + l2v_bytes != graph_alloc:
            raise AssertionError(f"obs: the graph's resource bytes {graph} + the join map "
                                 f"{l2v_bytes} against its memory_allocated delta {graph_alloc}")
    model = db._embedder.inner.model
    encoder = sum(t.numel() * t.element_size()
                  for t in list(model.parameters()) + list(model.buffers()) if t.is_cuda)
    maps = sum(m[1].numel() * m[1].element_size()
               for m in fused.lex._snap.get("row_maps", {}).values())
    # cuBLAS keeps its workspaces in PyTorch's allocator: the bytes that
    # clearing them frees (the next product allocates them again)
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    cublas = after - torch.cuda.memory_allocated()
    rest = rec["drift_bytes"] - encoder - maps - cublas
    log(f"obs (a) drift {rec['drift_bytes']} = encoder weights {encoder} + join maps {maps} "
        f"+ cuBLAS workspaces {cublas} + the rest {rest}; snapshot {lex} against its delta "
        f"{snap_alloc}; graph {graph} + join map {l2v_bytes} against its delta {graph_alloc}")
    return {**rec, "memory_allocated": before, "snapshot_device_bytes": lex,
            "snapshot_delta": snap_alloc, "graph_device_bytes": graph, "graph_delta": graph_alloc,
            "drift_encoder_bytes": encoder, "drift_join_map_bytes": maps,
            "drift_cublas_workspace_bytes": cublas, "drift_rest_bytes": rest,
            "resources": {f"{f}:{i}": e.get("device_bytes") for (f, i), e in res.items()
                          if "device_bytes" in e}}


def phase_obs(db, svc, fused, queries, profile, conc, late):
    """Phase 4's obs (b), (c) and (d), on the main path's live service at
    the phase's end: the calibration against the phase's own dispatch
    counts, the layer's overhead on the exact tier's hybrid p50, and the
    exposition."""
    import torch

    from nornicdb_tpu_torch import obs

    t_phase = time.perf_counter()
    # (b) bm25_score: direct batches through the lexical snapshot
    lex = fused.lex
    ev0 = dict(lex.events)
    batches = [queries[i:i + 8] for i in range(0, 64, 8)]
    for batch in batches:
        got = lex.search_batch(batch, 10)
        want = svc.bm25.search_batch(batch, 10)
        for g, w in zip(got, want):
            if not hits_agree(g, w, lex_atol(w)):
                raise AssertionError(f"obs: DeviceBM25 disagrees with the host index on {batch}")
    handoffs = sum(n - ev0.get(k, 0) for k, n in lex.events.items() if k.startswith("host_"))
    cal = obs.calibration_summary()
    kinds = cal["kinds"]
    cagra = fused.cagra.counts["walk"] if fused.cagra is not None else 0
    own = {"microbatch": (svc._microbatch.batches + svc._hybrid_batch.batches
                          + profile["batcher_batches"]),
           "hybrid_fused": fused.counts["dispatch"],
           "hybrid_walk_fused": fused.counts["walk_dispatch"],
           "cagra_walk": profile["walks_total"] + cagra,
           "bm25_score": len(batches) - handoffs}
    rows = {}
    for kind in ("microbatch", "hybrid_fused", "hybrid_walk_fused", "cagra_walk", "bm25_score"):
        d = kinds.get(kind, {})
        rows[kind] = {"dispatches": d.get("dispatches", 0), "phase_count": own[kind],
                      "top_dispatches": d.get("top_dispatches", 0),
                      "ewma_ms": {b: bk["execute_ms"] for b, bk in d.get("buckets", {}).items()},
                      "samples": {b: bk["samples"] for b, bk in d.get("buckets", {}).items()},
                      "compile_s_est": d.get("compile_s_est"), "execute_s": d.get("execute_s"),
                      "eff_flops_per_s": d.get("eff_flops_per_s"),
                      "eff_bytes_per_s": d.get("eff_bytes_per_s"),
                      "padding_efficiency": d.get("padding_efficiency")}
        r = rows[kind]
        flops, byts = r["eff_flops_per_s"], r["eff_bytes_per_s"]
        log(f"obs (b) {kind}: {r['dispatches']} dispatches (the phase counts {own[kind]}), "
            f"{r['top_dispatches']} top-level; EWMA ms by bucket {r['ewma_ms']} (samples "
            f"{r['samples']}); first-use split {r['compile_s_est']} s of {r['execute_s']} s "
            f"execute; eff FLOPs/s {flops} ({(flops or 0) / F32_FLOPS_PER_S:.2e} of the f32 "
            f"roof), eff bytes/s {byts} ({(byts or 0) / HBM_BYTES_PER_S:.2e} of HBM); padding "
            f"efficiency {r['padding_efficiency']}")
    log(f"obs (b) served kinds {cal['served_kinds']}, calibrated {cal['calibrated_kinds']}, "
        f"coverage {cal['calibration_coverage']}, unexpected recompiles "
        f"{cal['unexpected_recompiles']}; direct vector rides "
        f"{conc['direct_vector_rides']['obs']}")
    wrong = {k: r for k, r in rows.items() if r["dispatches"] != r["phase_count"]}
    if wrong:
        raise AssertionError(f"obs: dispatch counts differ from the phase's own: {wrong}")

    # (c) the layer's overhead on the exact tier's hybrid p50
    blocks = 1 if late else OBS_BLOCKS
    lat = {"on": [], "off": []}
    walk_min_n = fused.walk_min_n
    d0 = fused.counts["dispatch"]
    invalidate_cache(svc, "before obs (c)")
    fused.walk_min_n = None
    try:
        with CacheBypass(svc):
            for blk in range(blocks):
                for arm in (("on", "off") if blk % 2 == 0 else ("off", "on")):
                    obs.set_enabled(arm == "on")
                    try:
                        for q in queries:
                            t = time.perf_counter()
                            db.recall(q, limit=10, mode="hybrid")
                            torch.cuda.synchronize()
                            lat[arm].append((time.perf_counter() - t) * 1e3)
                    finally:
                        obs.set_enabled(True)
    finally:
        fused.walk_min_n = walk_min_n
    served = fused.counts["dispatch"] - d0
    p50 = {arm: float(np.percentile(v, 50)) for arm, v in lat.items()}
    ratio = p50["on"] / p50["off"]
    overhead = {"blocks": blocks, "queries_per_arm": len(lat["on"]), "p50_on_ms": p50["on"],
                "p50_off_ms": p50["off"], "ratio": ratio, "late": late,
                "p99_on_ms": float(np.percentile(lat["on"], 99)),
                "p99_off_ms": float(np.percentile(lat["off"], 99))}
    log(f"obs (c) hybrid p50 on the exact tier, {blocks} interleaved block(s) of {len(queries)} "
        f"queries per arm: layer on {p50['on']:.4f} ms, off {p50['off']:.4f} ms, ratio "
        f"{ratio:.4f} (p99 {overhead['p99_on_ms']:.3f} / {overhead['p99_off_ms']:.3f} ms); "
        f"{served} fused dispatches")
    if served != 2 * blocks * len(queries):
        raise AssertionError(f"obs (c): {served} fused dispatches for "
                             f"{2 * blocks * len(queries)} queries")
    if p50["on"] > 2.0 * p50["off"] + 1.0:
        raise AssertionError(f"obs (c): the layer's p50 {p50['on']:.3f} ms is over 2x "
                             f"{p50['off']:.3f} + 1 ms")

    # (d) the exposition
    import nornicdb_tpu_torch.cache  # noqa: F401 -- declare their families
    import nornicdb_tpu_torch.storage.wal  # noqa: F401

    t = time.perf_counter()
    text = obs.REGISTRY.render()
    render_ms = (time.perf_counter() - t) * 1e3
    missing = [f for f in OBS_FAMILIES if f"# TYPE {f} " not in text]
    log(f"obs (d) REGISTRY.render(): {len(text.encode())} bytes in {render_ms:.3f} ms, "
        f"{text.count(chr(10))} lines; {len(OBS_FAMILIES) - len(missing)} of "
        f"{len(OBS_FAMILIES)} wired families present")
    if missing:
        raise AssertionError(f"obs (d): families missing from the exposition: {missing}")
    out = {"calibration": rows, "served_kinds": cal["served_kinds"],
           "calibrated_kinds": cal["calibrated_kinds"], "overhead": overhead,
           "render_bytes": len(text.encode()), "render_ms": render_ms,
           "phase_s": time.perf_counter() - t_phase}
    log(f"obs (b)-(d) took {out['phase_s']:.2f} s")
    return out


def phase_concurrent(db, svc, fused, recorder, queries, results, seq_trios,
                     exact_tier=False):
    """16 client threads, 32 queries each, alternating vector and hybrid,
    with every result-cache probe missing (each mode's 256 requests repeat
    its 64 queries, which the cache would otherwise answer): the
    hybrid batcher must coalesce into dispatches at B >= 5 (walks on the
    walk tier, B1 launches on the exact tier), vector queries call HNSW
    directly above the threshold (no vector rides) and ride their batcher
    below it, and each answer must agree with the one-at-a-time answer
    (``results`` and ``seq_trios`` of the same tier). Then the same
    threads ride the vector batcher directly, as every recall does below
    the threshold: it must coalesce into a B1 launch at B >= 5, with
    answers equal to one-at-a-time exact answers.

    ``exact_tier`` switches the walk off on the live pipeline for the
    clients, so their hybrid queries take the exact tier's coalesced
    dispatch (``hybrid_brute_f32``, B1 at the batch's size), the route of
    every deployment between the fused floor and the walk's; the direct
    rides are left to the walk run."""
    import threading

    import torch

    from nornicdb_tpu_torch.ops.attention import flash_attention
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_BRUTE_F32, TIER_WALK_F32

    walk_min_n = fused.walk_min_n
    walk = (not exact_tier and walk_min_n is not None and fused.cagra is not None
            and fused.cagra.graph_built)
    hybrid_label = "hybrid_brute" if exact_tier else "hybrid"
    qvs = np.asarray(db._embedder.embed_batch(queries), np.float32)
    flash_attention.launches = 0
    fused_cosine_topk.launches = 0
    fused_cosine_topk.launch_sizes.clear()
    vec_mark, hyb_mark = batcher_mark(svc._microbatch), batcher_mark(svc._hybrid_batch)
    counts0 = dict(fused.counts)
    recorder.rows = []
    answers = []
    errors = []
    barrier = threading.Barrier(CONCURRENT_THREADS)

    def client(t):
        try:
            barrier.wait()
            for j in range(CONCURRENT_PER_THREAD):
                q = queries[(t * 5 + j) % len(queries)]
                mode = "vector" if j % 2 == 0 else "hybrid"
                label = mode if mode == "vector" else hybrid_label
                answers.append((label, q, db.recall(q, limit=10, mode=mode)))
        except BaseException as exc:  # noqa: BLE001 -- re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(CONCURRENT_THREADS)]
    invalidate_cache(svc, "before the concurrent phase; inside it every probe misses")
    hits0 = svc.stats.cache_hits
    if exact_tier:
        fused.walk_min_n = None
    try:
        with CacheBypass(svc) as bypass:
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        fused.walk_min_n = walk_min_n
    if any(th.is_alive() for th in threads):
        raise AssertionError("a concurrent client did not finish")
    if errors:
        raise errors[0]
    recall_vq = batcher_delta(svc._microbatch, vec_mark)[1]

    # the brute tier's vector batcher, the route of every deployment
    # under the threshold: above it no recall rides it, so the clients
    # ride it directly over the same index
    ride_mark = batcher_mark(svc._microbatch)
    ride_obs0 = obs_dispatches("microbatch")
    ride_b1_0 = fused_cosine_topk.launches
    rides = []
    ride_barrier = threading.Barrier(CONCURRENT_THREADS)

    def rider(t):
        try:
            ride_barrier.wait()
            for j in range(CONCURRENT_PER_THREAD):
                i = (t * 5 + j) % len(queries)
                rides.append((i, svc._microbatch.search(qvs[i], VECTOR_RIDE_K)))
        except BaseException as exc:  # noqa: BLE001 -- re-raised below
            errors.append(exc)

    threads = [] if exact_tier else [threading.Thread(target=rider, args=(t,))
                                     for t in range(CONCURRENT_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    ride_wall_s = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError("a vector rider did not finish")
    if errors:
        raise errors[0]
    # every direct ride's dispatch went to the brute index: one B1 launch
    # and one microbatch dispatch record each
    ride_obs = {"microbatch_dispatches": obs_dispatches("microbatch") - ride_obs0,
                "cosine_topk_launches": fused_cosine_topk.launches - ride_b1_0}
    launches = {"flash_attention": flash_attention.launches,
                "cosine_topk": fused_cosine_topk.launches}
    sizes = dict(sorted(fused_cosine_topk.launch_sizes.items()))
    rb, rq, rsizes = batcher_delta(svc._microbatch, ride_mark)
    vb, vq, vsizes = batcher_delta(svc._microbatch, vec_mark)
    hb, hq, hsizes = batcher_delta(svc._hybrid_batch, hyb_mark)
    served = {key: n - counts0.get(key, 0) for key, n in fused.counts.items()
              if n != counts0.get(key, 0)}
    n_q = CONCURRENT_THREADS * CONCURRENT_PER_THREAD
    use_hnsw = svc.hnsw is not None
    out = {"threads": CONCURRENT_THREADS, "queries": n_q, "wall_s": wall_s,
           "queries_per_s": n_q / wall_s, "launches": launches,
           "vector_tier": "hnsw" if use_hnsw else "brute",
           "hybrid_tier": "walk" if walk else "brute",
           "cache_probes_missed": bypass.probes,
           "cosine_topk_launch_sizes": sizes,
           "cosine_topk_routes": route_split(sizes, vsizes, hsizes),
           "recall_vector_rides": recall_vq,
           "vector_batches": vb, "vector_queries": vq, "vector_mean_batch": vq / max(vb, 1),
           "vector_batch_sizes": vsizes,
           "direct_vector_rides": {"queries": rq, "batches": rb, "wall_s": ride_wall_s,
                                   "queries_per_s": rq / ride_wall_s if rq else 0.0,
                                   "mean_batch": rq / max(rb, 1), "batch_sizes": rsizes,
                                   "obs": ride_obs},
           "hybrid_batches": hb, "hybrid_queries": hq, "hybrid_mean_batch": hq / max(hb, 1),
           "hybrid_batch_sizes": hsizes,
           "mean_batch": (vq + hq) / max(vb + hb, 1), "fused_served": served}
    log(f"concurrent{' (walk off)' if exact_tier else ''}: {n_q} queries from "
        f"{CONCURRENT_THREADS} threads in {wall_s:.3f} s; "
        f"vector tier {out['vector_tier']}: {recall_vq} recall vector rides; hybrid mean "
        f"batch {out['hybrid_mean_batch']:.3f} over {hb} batches (sizes {hsizes}); "
        f"B1 launches {launches['cosine_topk']} by B {sizes}; fused tier {served}; "
        f"{bypass.probes} cache probes missed; hybrid tier {out['hybrid_tier']}")
    if not exact_tier:
        log(f"  direct vector rides: {rq} in {rb} batches in {ride_wall_s:.3f} s, mean batch "
            f"{rq / max(rb, 1):.3f} (sizes {rsizes}); vector batcher in all {vq} rides in "
            f"{vb} batches, mean {out['vector_mean_batch']:.3f}")
        log(f"obs (b) direct vector rides: {ride_obs['microbatch_dispatches']} microbatch "
            f"dispatches recorded, B1 launches grew {ride_obs['cosine_topk_launches']}, "
            f"{rb} batches")
        if not (ride_obs["microbatch_dispatches"] == ride_obs["cosine_topk_launches"] == rb):
            raise AssertionError(f"obs: direct rides' microbatch dispatches against B1: "
                                 f"{ride_obs}, {rb} batches")
    if bypass.probes != n_q or svc.stats.cache_hits != hits0:
        raise AssertionError(f"the result cache answered in the concurrent phase: {out}")
    n_rides = 0 if exact_tier else n_q
    if hq != n_q // 2 or recall_vq != (0 if use_hnsw else n_q // 2) or rq != n_rides:
        raise AssertionError(f"vector or hybrid queries took the wrong route: {out}")
    if out["hybrid_mean_batch"] <= 1.0 or (vq and out["vector_mean_batch"] <= 1.0) \
            or (rq and rq / rb <= 1.0):
        raise AssertionError(f"the batchers did not coalesce: {out}")
    # each ride is one B1 launch at its batch's size (a walk launches none)
    hybrid_b1 = {} if walk else hsizes
    if any(sizes.get(b, 0) < vsizes.get(b, 0) + hybrid_b1.get(b, 0)
           for b in set(vsizes) | set(hybrid_b1)):
        raise AssertionError(f"a batcher's ride did not launch B1: {out}")
    if not any(b >= 5 for b in hsizes) or not (walk or any(b >= 5 for b in sizes)):
        raise AssertionError(f"no hybrid ride was dispatched at B >= 5: {out}")
    if vq and not any(b >= 5 for b in vsizes):
        raise AssertionError(f"no vector ride launched B1's batched kernel (B >= 5): {out}")
    tier, dispatch = ((TIER_WALK_F32, "walk_dispatch") if walk else (TIER_BRUTE_F32, "dispatch"))
    if served.get(tier) != hq or served.get(dispatch) != hb or fused.handoffs() \
            or any(key.startswith("walk_") and key != "walk_dispatch" for key in served):
        raise AssertionError(f"concurrent hybrid queries not all served by {tier}: {served}")

    def lists(trio):
        return trio["lex"], trio["vec"], trio["fused"]

    changed = set()
    for q, trio in recorder.rows:
        seq = seq_trios[q]
        if trio is None or not trio_agrees(trio, seq["lex"], seq["vec"], 30):
            raise AssertionError(f"concurrent hybrid answer for {q!r} differs from one at a time")
        if lists(trio) != lists(seq):
            changed.add(q)
    for label, q, hits in answers:
        want = results[(label, q)]
        got = [(h["id"], h["score"]) for h in hits]
        if label == "vector" and not hits_agree(got, [(h["id"], h["score"]) for h in want],
                                                TOPK_SCORE_ATOL):
            raise AssertionError(f"concurrent vector answer for {q!r} differs from one at a time")
        if label == hybrid_label and q not in changed and got != [(h["id"], h["score"]) for h in want]:
            raise AssertionError(f"concurrent hybrid hits for {q!r} differ from one at a time")
    one = {i: svc.vector_search_candidates(qvs[i], VECTOR_RIDE_K, exact=True)
           for i in sorted({i for i, _ in rides})}
    for i, hits in rides:
        if not hits_agree(hits, one[i], TOPK_SCORE_ATOL):
            raise AssertionError(f"a vector ride for {queries[i]!r} differs from exact=True")
    same = sum(lists(trio) == lists(seq_trios[q]) for q, trio in recorder.rows)
    log(f"  concurrent answers agree with one at a time ({same} of {len(recorder.rows)} "
        f"hybrid trios identical; {len(rides)} vector rides equal to exact=True)")
    out["hybrid_trios_identical"] = same
    return out


def dispatches(fused):
    """The fused tier's dispatches on either vector tier."""
    return fused.counts["dispatch"] + fused.counts["walk_dispatch"]


def phase_cache(db, svc, fused, queries):
    """The result cache on its own: after an invalidation, the hybrid
    queries once as misses (served by the fused tier) and once more as
    hits, which must equal the misses' answers; then one ``store`` (its
    index write bumps the generation) makes the next repeat a miss."""
    import torch

    uniq = list(dict.fromkeys(queries))
    invalidate_cache(svc, "before the cache phase")
    lat = {"miss": [], "hit": []}
    answers = {}
    for kind in ("miss", "hit"):
        hits0, dispatch0 = svc.stats.cache_hits, dispatches(fused)
        for q in uniq:
            t = time.perf_counter()
            hits = db.recall(q, limit=10, mode="hybrid")
            torch.cuda.synchronize()
            lat[kind].append((time.perf_counter() - t) * 1e3)
            if kind == "miss":
                answers[q] = hits
            elif hits != answers[q]:
                raise AssertionError(f"cache: the hit for {q!r} differs from the miss's answer")
        grew = (svc.stats.cache_hits - hits0, dispatches(fused) - dispatch0)
        want = (0, len(uniq)) if kind == "miss" else (len(uniq), 0)
        if grew != want:
            raise AssertionError(f"cache {kind} pass: (cache hits, fused dispatches) grew "
                                 f"by {grew}, not {want}")
    gen = svc.generation
    db.store("cache invalidation probe " + uniq[0], node_id="cache_probe")
    db.flush()
    hits0 = svc.stats.cache_hits
    after = db.recall(uniq[0], limit=10, mode="hybrid")
    if svc.generation <= gen or svc.stats.cache_hits != hits0:
        raise AssertionError("cache: a store did not make the next repeat a miss")
    hits0 = svc.stats.cache_hits
    if db.recall(uniq[0], limit=10, mode="hybrid") != after or svc.stats.cache_hits != hits0 + 1:
        raise AssertionError("cache: the repeat after the store's miss was not a hit")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))

    out = {"queries": len(uniq), "hits": len(uniq), "generation_after_store": svc.generation,
           "stats_cache_hits": svc.stats.cache_hits, "stats_searches": svc.stats.searches}
    for kind, ts in lat.items():
        out[f"{kind}_p50_ms"] = pct(ts, 50)
        out[f"{kind}_p99_ms"] = pct(ts, 99)
    log(f"cache: {len(uniq)} hybrid queries as misses p50 {out['miss_p50_ms']:.4f} p99 "
        f"{out['miss_p99_ms']:.4f} ms, then as hits p50 {out['hit_p50_ms']:.4f} p99 "
        f"{out['hit_p99_ms']:.4f} ms; stats.cache_hits grew by {len(uniq)}, every hit equals "
        f"its miss; one store bumped the generation and the next repeat missed")
    return out


class PartTimer:
    """Host ms spent inside chosen methods, and their calls, by name: each
    is wrapped on its instance or class (behaviour unchanged) until
    ``close``. Calls from any thread count, so a part shared with a
    background thread is not measured apart."""

    def __init__(self, parts):
        from collections import Counter

        self.ms = Counter()
        self.calls = Counter()
        self._wrapped = []
        for name, (obj, attr) in parts.items():
            inner = getattr(obj, attr)
            own = vars(obj).get(attr)  # a class's own function, restored on close

            def timed(*args, _inner=inner, _name=name, **kw):
                t = time.perf_counter()
                try:
                    return _inner(*args, **kw)
                finally:
                    self.ms[_name] += (time.perf_counter() - t) * 1e3
                    self.calls[_name] += 1

            setattr(obj, attr, timed)
            self._wrapped.append((obj, attr, own))

    def close(self):
        for obj, attr, own in self._wrapped:
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)


def phase_write_mix(db, svc, fused, docs, queries, rng):
    """Stores while it recalls: each round stores one new document (the
    embed queue indexes it in the background) and times one hybrid
    recall, in blocks that cycle through ``WRITE_MIX_ARMS``: the fused
    tier on its walk (when the walk is on), the host path (the service's
    hybrid branch with the fused ride answering None, so the fused tier
    keeps its snapshot and graph between blocks), and the fused tier with
    its walk off. Reports each arm's p50/p99 and host ms per query by
    part, the host ms of the HNSW insert each store makes above the
    threshold (every store must make one), and the fused tier's rows by
    tier, hand-offs, walk step-downs and join-map derivations per arm. On
    the walk, post-build stores are merged exactly, so those rows are
    re-fused on the host (``host``). After a flush, every written document
    must be found by its own text, and the fused tier must agree with the
    host path."""
    from collections import Counter

    import torch

    from nornicdb_tpu_torch.ops.attention import flash_attention
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_BRUTE_F32, TIER_WALK_F32

    flash_attention.launches = 0
    fused_cosine_topk.launches = 0
    ride = svc._fused_hybrid_trio
    walk_min_n = fused.walk_min_n
    arms = WRITE_MIX_ARMS if walk_min_n is not None else ("brute", "host")
    lat = {arm: [] for arm in arms}
    parts = {arm: Counter() for arm in arms}
    arm_counts = {arm: Counter() for arm in arms}
    timed_parts = {
        # the matrix's copy to the card after vector writes (exact tier, host path)
        "vector_device_copy": (svc.vectors, "_device_arrays_locked"),
        "query_embed": (svc, "_query_embedding"),
        "host_bm25": (svc.bm25, "search"),
        # the host path's vector half: HNSW above the threshold
        "host_vector_search": (svc, "vector_search_candidates"),
        "fused_alive_refresh": (fused.lex, "refresh_alive"),
        "fused_plan": (fused.lex, "plan"),
        "fused_join_map": (fused, "_ensure_map"),
        "fused_decode": (fused, "_decode"),
        "fused_search_batch": (fused, "search_batch"),
    }
    hnsw = svc.hnsw
    if hnsw is not None:
        # each store's HNSW insert, on the embed queue's thread (index_node)
        timed_parts["hnsw_insert"] = (hnsw, "add")
    timer = PartTimer(timed_parts)
    written = []
    n = 0
    # a recall may land before the embed queue has indexed the store just
    # made, and so hit an entry cached before it: counted per arm
    invalidate_cache(svc, "before the write mix")
    cache_hits = Counter()
    try:
        for block in range(WRITE_MIX_BLOCKS):
            arm = arms[block % len(arms)]
            svc._fused_hybrid_trio = ride if arm != "host" else (lambda *a: None)
            fused.walk_min_n = walk_min_n if arm == "walk" else None
            mark, counts0 = Counter(timer.ms), Counter(fused.counts)
            hits0 = svc.stats.cache_hits
            for _ in range(WRITE_MIX_ROUNDS):
                a, b = (docs[int(i)].split() for i in rng.integers(0, len(docs), 2))
                text = " ".join(a[: len(a) // 2] + b[len(b) // 2:])
                db.store(text, node_id=f"w{n}")
                written.append((f"w{n}", text))
                q = queries[n % len(queries)]
                n += 1
                t = time.perf_counter()
                db.recall(q, limit=10, mode="hybrid")
                torch.cuda.synchronize()
                lat[arm].append((time.perf_counter() - t) * 1e3)
            parts[arm].update(timer.ms)
            parts[arm].subtract(mark)
            arm_counts[arm].update(fused.counts)
            arm_counts[arm].subtract(counts0)
            cache_hits[arm] += svc.stats.cache_hits - hits0
        db.flush()
        inserts = (timer.calls["hnsw_insert"], timer.ms["hnsw_insert"])
    finally:
        svc._fused_hybrid_trio = ride
        fused.walk_min_n = walk_min_n
        timer.close()
    if hnsw is not None and (svc.hnsw is not hnsw or inserts[0] != len(written)
                             or any(doc_id not in hnsw for doc_id, _ in written)):
        raise AssertionError(f"write mix: {inserts[0]} HNSW inserts for {len(written)} stores")
    launches = {"flash_attention": flash_attention.launches,
                "cosine_topk": fused_cosine_topk.launches}
    counts = {arm: {key: n for key, n in c.items() if n} for arm, c in arm_counts.items()
              if arm != "host"}
    for arm, c in counts.items():
        rows = c.get(TIER_BRUTE_F32, 0) + c.get(TIER_WALK_F32, 0) + c.get("host", 0)
        handoffs = {key: n for key, n in c.items() if key.startswith("handoff_")}
        if rows + sum(handoffs.values()) + cache_hits[arm] != len(lat[arm]):
            raise AssertionError(f"write mix: {arm}-arm queries unaccounted for: {c}, "
                                 f"cache hits {dict(cache_hits)}")
        if set(handoffs) - {"handoff_vec_race"}:
            raise AssertionError(f"write mix: unexpected hand-offs {handoffs}")
    if "walk" in counts and not (counts["walk"].get("walk_dispatch")
                                 and counts["walk"].get("host")):
        raise AssertionError(f"write mix: the walk merged no post-build store: {counts}")
    # read-your-writes: each written document by its own text
    recorder = TrioRecorder(svc)
    for doc_id, text in written[-16:]:
        hits = db.recall(text, limit=10, mode="hybrid")
        if doc_id not in [h["id"] for h in hits]:
            raise AssertionError(f"write mix: {doc_id} not found by its own text")
    for q, trio in recorder.rows:
        qv = np.asarray(db._embedder.embed(q), np.float32)
        lex = svc.bm25.search(q, 30)
        vec = svc.vectors.search_batch(qv[None, :], 30)[0]
        if trio is None or not (walk_trio_agrees(trio, lex, 30) if trio["tier"] == "walk"
                                else trio_agrees(trio, lex, vec, 30)):
            raise AssertionError(f"write mix: the fused tier disagrees with the host path on {q!r}")
    svc._fused_hybrid_trio = recorder.inner

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))

    out = {"rounds_per_path": {arm: len(ts) for arm, ts in lat.items()},
           "writes": len(written), "launches": launches, "fused_counts": counts,
           "cache_hits": dict(cache_hits),
           "hnsw_inserts": inserts[0],
           "hnsw_insert_ms_per_store": inserts[1] / len(written),
           "read_back_served": dict(Counter(f"{t['tier']}:{t['served_by']}"
                                            for _, t in recorder.rows if t is not None)),
           "host_ms_per_query_by_part": {
               arm: {key: ms / len(lat[arm]) for key, ms in sorted(parts[arm].items()) if ms}
               for arm in lat}}
    for arm, ts in lat.items():
        out[f"{arm}_p50_ms"] = pct(ts, 50)
        out[f"{arm}_p99_ms"] = pct(ts, 99)
        out[f"{arm}_max_ms"] = max(ts)
    by_arm = "; ".join(f"{arm} p50 {out[arm + '_p50_ms']:.3f} p99 {out[arm + '_p99_ms']:.3f} "
                       f"max {out[arm + '_max_ms']:.3f} ms" for arm in lat)
    log(f"write mix: {len(written)} stores, each followed by a hybrid recall; {by_arm}; "
        f"fused tier by arm {counts}; cache hits {dict(cache_hits)}; 16 written docs read "
        f"back by their text ({out['read_back_served']}) and agree with the host path; "
        f"{inserts[0]} HNSW inserts, {out['hnsw_insert_ms_per_store']:.3f} host ms per store")
    for arm, by_part in out["host_ms_per_query_by_part"].items():
        log(f"  write mix, {arm} arm: host ms per query by part (nested: fused_search_batch "
            f"holds the fused_* parts and, on the exact tier, one vector_device_copy) "
            f"{json.dumps({key: round(ms, 4) for key, ms in by_part.items()})}")
    return out


def time_fused(db, svc, fused, queries, b, card, tier="brute"):
    """One fused dispatch at B queries on ``tier`` (``walk`` or ``brute``),
    by part: the host plan (with its copies to the card), the device
    program (CUDA events over back-to-back calls, and the profiler's
    device time by kernel), the decode, and the whole ``search_batch``
    (the exact tier's with the walk off). Runs after the main path's
    counts were read."""
    import torch

    from nornicdb_tpu_torch.ops.similarity import l2_normalize
    from nornicdb_tpu_torch.search.bm25 import tokenize
    from nornicdb_tpu_torch.search.hybrid_fused import (
        TIER_WALK_F32,
        fused_single,
        walk_fused_single,
    )

    qs = [queries[i % len(queries)] for i in range(b)]
    embs = np.asarray(db._embedder.embed_batch(qs), np.float32)
    extras = [{"tokens": tuple(tokenize(q)), "n_cand": 30, "w": (1.0, 1.0)} for q in qs]
    token_rows = [e["tokens"] for e in extras]
    snap = fused.lex._snap

    def host_ms(fn, iters=20):
        fn()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / iters

    def plan():
        return fused.lex.device_args(snap, *fused.lex.plan(snap, token_rows))

    plan_ms = host_ms(plan)
    lex_args = plan()
    dev = fused.lex.device
    qn = l2_normalize(torch.from_numpy(embs).to(dev)).contiguous()
    tail = (torch.full((b,), 30, device=dev), torch.ones(b, device=dev),
            torch.ones(b, device=dev))
    walk_min_n = fused.walk_min_n
    if tier == "walk":
        cg, g = fused.cagra, fused.cagra._graph
        l2g = fused._ensure_walk_map(snap, g)
        kq = cg.itopk

        def program():
            return walk_fused_single(*lex_args, l2g, qn, g["matrix"], g["adj"], g["validf"],
                                     *tail, kq=kq, iters=g["iters"], width=cg.search_width,
                                     itopk=kq, hash_bits=cg.hash_bits, n_seeds=cg.n_seeds)

        def decode(out):
            return fused._decode(snap, g["row_ids"], [], token_rows, extras, *out, kq,
                                 tier=TIER_WALK_F32)
    else:
        m, valid, vec_ids, mutations = svc.vectors.device_view()
        l2v = fused._ensure_map(snap, mutations)
        kq = MAIN_K

        def program():
            return fused_single(*lex_args, l2v, qn, m, valid, *tail, kq=kq)

        def decode(out):
            return fused._decode(snap, vec_ids, [], token_rows, extras, *out, kq)

    event_ms = time_ms(program)
    per_kernel = {}
    split = device_split(program, expect="" if tier == "walk" else "merge_kernel",
                         launches=per_kernel)
    out = [x.cpu().numpy() for x in program()]
    decode_ms = host_ms(lambda: decode(out))
    if tier != "walk":
        fused.walk_min_n = None
    try:
        counts0 = fused.counts["walk_dispatch" if tier == "walk" else "dispatch"]
        total_ms = host_ms(lambda: fused.search_batch(embs, MAIN_K, extras))
        if fused.counts["walk_dispatch" if tier == "walk" else "dispatch"] != counts0 + 21:
            raise AssertionError(f"time_fused: search_batch did not take the {tier} tier")
    finally:
        fused.walk_min_n = walk_min_n
    n_terms = int(lex_args[2].shape[1])
    device_ms = sum(split.values())
    row = {"tier": tier, "B": b, "kq": kq, "unique_terms": n_terms,
           "postings": int(lex_args[0].numel()), "plan_ms": plan_ms,
           "device_event_ms": event_ms, "device_ms": device_ms, "device_split": split,
           "kernels_per_call": sum(per_kernel.values()) if per_kernel else None,
           "decode_ms": decode_ms, "search_batch_ms": total_ms,
           "device_share_of_search_batch": device_ms / total_ms, "card": card}
    top = dict(sorted(split.items(), key=lambda kv: -kv[1])[:8])
    n_kernels = "uncounted" if not per_kernel else f"{row['kernels_per_call']:.0f}"
    log(f"fused dispatch {tier} B={b} kq {kq} ({n_terms} unique terms, {row['postings']} "
        f"postings) [{card}]: plan_ms {plan_ms:.4f} device_event_ms {event_ms:.4f} device_ms "
        f"{device_ms:.4f} in {n_kernels} kernels decode_ms {decode_ms:.4f} "
        f"search_batch_ms {total_ms:.4f} (device {100 * device_ms / total_ms:.1f}% of it); "
        f"device ms by kernel "
        f"{json.dumps(top if tier == 'walk' else split)}")
    return row


# -- timing at the main path's shapes -------------------------------------


def time_topk(dev, m, valid, b, k, seed, card, queries=None):
    """B1 at [B, D] x [C, D], k, held to its plain version on the same
    inputs (tie-aware, TOPK_SCORE_ATOL) and timed against it and the
    library call; ``queries`` (else seeded random unit rows) are the B
    queries."""
    import torch

    from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree

    c, d = m.shape
    rng = np.random.default_rng(seed)
    q = queries if queries is not None else torch.from_numpy(_normalized(rng, b, d)).to(dev)
    saved = fused_cosine_topk.launches
    s_k, i_k = fused_cosine_topk(q, m, valid, k)
    s_p, i_p = cosine_topk_auto(q, m, valid, k)
    s_k, i_k, s_p, i_p = (x.cpu().numpy() for x in (s_k, i_k, s_p, i_p))
    err = float(np.abs(s_k - s_p).max())
    if not topk_agree(i_k, s_k, i_p, s_p, TOPK_SCORE_ATOL):
        raise AssertionError(f"B1 disagrees with its plain version at the timed shape C={c} "
                             f"D={d} B={b} k={k} (max score err {err:.3g})")
    REPORT["topk_max_abs_err"] = max(REPORT["topk_max_abs_err"], err)
    kernel = time_ms(lambda: fused_cosine_topk(q, m, valid, k))
    stages = device_split(lambda: fused_cosine_topk(q, m, valid, k), expect="merge_kernel")
    fused_cosine_topk.launches = saved  # comparison launches do not count
    plain = time_ms(lambda: cosine_topk_auto(q, m, valid, k), iters=5)
    neg = torch.tensor(-1e30, device=dev)

    def library():
        s = torch.where(valid[None, :], torch.matmul(q, m.T), neg)
        return torch.topk(s, k, dim=1)

    lib = time_ms(library, iters=10)
    lib_split = device_split(library, expect="topk")
    n_bytes, flops = topk_cost(b, c, d, k)
    bnd, by = bound_ms(n_bytes, flops)
    row = {"C": c, "D": d, "B": b, "k": k, "max_abs_err": err,
           "kernel_ms": kernel, "plain_ms": plain,
           "library_ms": lib, "library_device_ms": sum(lib_split.values()),
           "library_split": lib_split, "bound_ms": bnd, "bound_by": by,
           "device_ms": stages, "card": card}
    log(f"B1 C={c} D={d} B={b} k={k} [{card}]: agrees with plain (max score err "
        f"{err:.3g}); kernel_ms {kernel:.4f} device_ms "
        f"{sum(stages.values()):.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
        f"library_device_ms {row['library_device_ms']:.4f} bound_ms {bnd:.4f} ({by}); "
        f"device ms per call by stage {json.dumps(stages)} library kernels "
        f"{json.dumps(lib_split)}")
    return row


def time_attention(dev, b, s, h, dh, dtype, seed, card):
    import torch
    import torch.nn.functional as F

    from nornicdb_tpu_torch.ops.attention import flash_attention, reference_attention

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32))
               .to(dev).to(dtype) for _ in range(3))
    lengths = rng.integers(s // 4, s + 1, b)
    mask = torch.from_numpy(np.arange(s)[None, :] < lengths[:, None]).to(dev)
    saved = flash_attention.launches
    kernel = time_ms(lambda: flash_attention(q, k, v, mask), iters=50)
    split = device_split(lambda: flash_attention(q, k, v, mask), iters=20, expect="flash_")
    flash_attention.launches = saved
    plain = time_ms(lambda: reference_attention(q, k, v, mask), iters=20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    am = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

    lib = time_ms(library, iters=50)
    lib_split = device_split(library, iters=20)
    n_bytes, flops = attn_cost(b, s, h, dh, q.element_size())
    bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S if dtype == torch.bfloat16
                       else F32_FLOPS_PER_S)
    name = str(dtype).replace("torch.", "")
    row = {"B": b, "S": s, "H": h, "Dh": dh, "dtype": name, "kernel_ms": kernel,
           "device_ms": sum(split.values()), "device_split": split,
           "plain_ms": plain, "library_ms": lib,
           "library_device_ms": sum(lib_split.values()), "library_split": lib_split,
           "bound_ms": bnd, "bound_by": by, "card": card}
    log(f"B2 B={b} S={s} H={h} Dh={dh} {name} [{card}]: kernel_ms {kernel:.4f} device_ms "
        f"{row['device_ms']:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
        f"library_device_ms {row['library_device_ms']:.4f} bound_ms {bnd:.4f} ({by}); "
        f"kernels {json.dumps(split)} library kernels {json.dumps(lib_split)}")
    return row


# -- phase 5 ---------------------------------------------------------------


def phase_index(dev, seed, n_rows, card):
    import torch

    from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    d = 1024
    rng = np.random.default_rng(seed + 2)
    idx = BruteForceIndex(dims=d, device=dev)
    t0 = time.perf_counter()
    step = 65_536
    for start in range(0, n_rows, step):
        n = min(step, n_rows - start)
        vecs = rng.random((n, d), dtype=np.float32) - 0.5
        idx.add_batch([(f"v{start + j}", vecs[j]) for j in range(n)])
    fill_s = time.perf_counter() - t0
    log(f"index: filled {len(idx)} x {d} (capacity {idx._capacity}) in {fill_s:.2f} s")
    rows = []
    for b, k in INDEX_TIMED:
        queries = rng.random((b, d), dtype=np.float32) - 0.5
        before = fused_cosine_topk.launches
        t = time.perf_counter()
        hits = idx.search_batch(queries, k=k)
        first_s = time.perf_counter() - t
        if fused_cosine_topk.launches != before + 1:
            raise AssertionError("the deployment-scale index did not answer through B1")
        if len(hits) != b or any(len(h) != k for h in hits):
            raise AssertionError("index search returned the wrong number of hits")
        with idx._lock:
            m, valid = idx._device_arrays_locked()
        qn = torch.from_numpy(queries).to(dev)
        qn = qn / qn.norm(dim=1, keepdim=True)
        s_p, i_p = cosine_topk_auto(qn, m, valid, k)
        ids = np.asarray([[int(e[1:]) for e, _ in h] for h in hits])
        sc = np.asarray([[s for _, s in h] for h in hits])
        if not topk_agree(ids, sc, i_p.cpu().numpy(), s_p.cpu().numpy(), TOPK_SCORE_ATOL):
            raise AssertionError(f"1M-row index answers disagree with the plain path at B={b}")
        row = time_topk(dev, m, valid, b, k, seed, card)
        row["first_search_s"] = first_s
        row["launches_per_search"] = 1
        rows.append(row)
    REPORT["index"] = {"rows": len(idx), "dims": d, "fill_s": fill_s, "timings": rows}
    del m, valid
    return idx  # phase 8 (b) quantizes it next


# -- phase 6: durable ------------------------------------------------------

DURABLE_QUEUE_DOCS = 1024  # stored without an embedding: the embed queue's (B2)
DURABLE_FORGET = 64
DURABLE_KILL_WRITES = 1000
DURABLE_CODEC_RECORDS = 10_000
DURABLE_MEM_SLACK = 1 << 20  # memory_allocated after the close, against before
# a child process that writes until it is killed, printing each id once
# its store returned (the write is acknowledged)
_KILL_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import nornicdb_tpu_torch as nt
from nornicdb_tpu_torch.embed.embedder import HashEmbedder
db = nt.open(sys.argv[2], device="cpu", engine=sys.argv[3], sync_every_write=True,
             auto_embed=False, embedder=HashEmbedder())
print("open", flush=True)
for i in range(10 ** 7):
    db.store(f"kill test write {i}", node_id=f"k{i}")
    print(f"k{i}", flush=True)
"""


def dir_bytes(path):
    """Bytes on disk per file under ``path``, by path relative to it."""
    out = {}
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            out[os.path.relpath(full, path)] = os.path.getsize(full)
    return dict(sorted(out.items()))


def reset_counts():
    from nornicdb_tpu_torch.ops.attention import flash_attention
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk

    flash_attention.launches = 0
    fused_cosine_topk.launches = 0
    fused_cosine_topk.launch_sizes.clear()


def read_counts():
    from nornicdb_tpu_torch.ops.attention import flash_attention
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk

    return {"flash_attention": flash_attention.launches,
            "cosine_topk": fused_cosine_topk.launches}


def device_memory():
    """memory_allocated after a collection, with the caches that hold no
    data of the program (free blocks, cuBLAS workspaces) emptied."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def durable_modes(db, queries, tag):
    """64 queries in each of vector, text, hybrid on the exact tier (walk
    off) and hybrid on the walk tier, after a cache invalidation each.
    The fused tier's snapshot and walk graph are waited for first, as in
    phase 4. Returns (answers, latencies, first-query and wait times,
    walk trios, fused-tier counts of each hybrid block)."""
    import torch

    svc = db.search
    answers, lat, first = {}, {}, {}

    def block(label, mode):
        invalidate_cache(svc, f"before the {tag} {label} queries")
        ts = []
        for q in queries:
            t = time.perf_counter()
            answers[(label, q)] = [(h["id"], h["score"])
                                   for h in db.recall(q, limit=10, mode=mode)]
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        lat[label] = ts

    for mode in ("vector", "text"):
        block(mode, mode)
    # the first hybrid query starts the fused tier's snapshot build (the
    # host path answers it); the next starts the walk graph's
    invalidate_cache(svc, f"before the {tag} first hybrid query")
    t = time.perf_counter()
    db.recall(queries[0], limit=10, mode="hybrid")
    first["hybrid_first_ms"] = (time.perf_counter() - t) * 1e3
    fused, first["snapshot_wait_s"] = wait_for_snapshot(svc)
    invalidate_cache(svc, f"before the {tag} query that starts the walk graph's build")
    t = time.perf_counter()
    db.recall(queries[1], limit=10, mode="hybrid")
    first["hybrid_first_fused_ms"] = (time.perf_counter() - t) * 1e3
    _, first["graph_wait_s"] = wait_for_graph(fused)
    first["graph_build_s"] = fused.cagra.build_s
    counts = {}
    walk_min_n = fused.walk_min_n
    c0 = dict(fused.counts)
    fused.walk_min_n = None
    try:
        block("hybrid_exact", "hybrid")
    finally:
        fused.walk_min_n = walk_min_n
    counts["hybrid_exact"] = {k: n - c0.get(k, 0) for k, n in fused.counts.items()
                              if n != c0.get(k, 0)}
    recorder = TrioRecorder(svc)
    c0 = dict(fused.counts)
    try:
        block("hybrid_walk", "hybrid")
    finally:
        del svc._fused_hybrid_trio  # the recorder holds the service
    counts["hybrid_walk"] = {k: n - c0.get(k, 0) for k, n in fused.counts.items()
                             if n != c0.get(k, 0)}
    return answers, lat, first, dict(recorder.rows), counts


def durable_kill(dev, engine, root):
    """A child stores with sync_every_write=True until it has acknowledged
    DURABLE_KILL_WRITES writes and is SIGKILLed mid-stream; the parent
    reopens the dir and must find every acknowledged id."""
    import signal
    import tempfile

    import nornicdb_tpu_torch as nt
    from nornicdb_tpu_torch.embed.embedder import HashEmbedder

    d = tempfile.mkdtemp(prefix=f"kill-{engine}-", dir=root)
    proc = subprocess.Popen([sys.executable, "-c", _KILL_CHILD, HERE, d, engine],
                            stdout=subprocess.PIPE, text=True)
    acked = []
    try:
        if proc.stdout.readline().strip() != "open":
            raise AssertionError(f"the {engine} kill child did not open its store")
        t0 = time.perf_counter()
        while len(acked) < DURABLE_KILL_WRITES:
            line = proc.stdout.readline().strip()
            if not line:
                raise AssertionError(f"the {engine} kill child died after {len(acked)} writes")
            acked.append(line)
        write_s = time.perf_counter() - t0
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait()
    t = time.perf_counter()
    db = nt.open(d, device=dev, auto_embed=False, embedder=HashEmbedder())
    reopen_s = time.perf_counter() - t
    try:
        kind = type(db._base).__name__
        missing = [i for i in acked if not db.storage.has_node(i)]
        stored = db.storage.count_nodes()
        repair = (db._base.repaired if kind == "DiskEngine"
                  else db._base.replay_result.torn_tail_repaired)
    finally:
        db.close()
    out = {"engine": kind, "acknowledged": len(acked), "found": len(acked) - len(missing),
           "stored": stored, "write_s": write_s, "reopen_s": reopen_s,
           "torn_tail_repaired": repair}
    log(f"  kill ({engine}): {len(acked)} acknowledged writes in {write_s:.2f} s "
        f"(sync_every_write), SIGKILL, reopened as {kind} in {reopen_s:.3f} s: "
        f"{out['found']} found, {stored} stored, torn tail repaired {repair}")
    if missing or kind != {"native": "DiskEngine", "python": "DurableEngine"}[engine]:
        raise AssertionError(f"kill ({engine}): {len(missing)} acknowledged writes lost: {out}")
    return out


def durable_python(dev, docs, emb, root):
    """The same nodes with their embeddings through the WAL + snapshot
    engine, no search: close (snapshot), reopen (snapshot load + tail
    replay), every id read back."""
    import tempfile

    import nornicdb_tpu_torch as nt
    from nornicdb_tpu_torch.embed.embedder import HashEmbedder
    from nornicdb_tpu_torch.storage.wal_engine import DurableEngine

    d = tempfile.mkdtemp(prefix="python-", dir=root)
    n = len(docs)
    db = nt.open(d, device=dev, engine="python", auto_embed=False, embedder=HashEmbedder())
    t = time.perf_counter()
    for i, text in enumerate(docs):
        db.store(text, node_id=f"d{i}", embedding=emb[i].tolist())
    store_s = time.perf_counter() - t
    wal = db._base.wal.counters
    auto_snapshots = db._base.snapshots
    t = time.perf_counter()
    db.close()
    close_s = time.perf_counter() - t
    on_disk = dir_bytes(d)
    t = time.perf_counter()
    db = nt.open(d, device=dev, auto_embed=False, embedder=HashEmbedder())
    reopen_s = time.perf_counter() - t
    try:
        base = db._base
        if not isinstance(base, DurableEngine):
            raise AssertionError(f"the Python engine's dir reopened as {type(base).__name__}")
        rr = base.replay_result
        t = time.perf_counter()
        got = db.storage.batch_get_nodes([f"d{i}" for i in range(n)])
        read_s = time.perf_counter() - t
        missing = sum(1 for g in got if g is None)
        bad = [i for i in range(0, n, 997)
               if got[i] is None or got[i].embedding != emb[i].tolist()]
        count = db.storage.count_nodes()
    finally:
        db.close()
    out = {"nodes": n, "store_s": store_s, "store_nodes_per_s": n / store_s,
           "wal_appends": wal["appends"], "wal_append_s": wal["append_s"],
           "auto_snapshots": auto_snapshots, "close_s": close_s, "reopen_s": reopen_s,
           "engine_open_s": base.open_s, "replayed_records": rr.records_applied,
           "snapshot_seq": rr.snapshot_seq, "read_back_s": read_s, "bytes": on_disk}
    log(f"  python engine: stored {n} nodes in {store_s:.2f} s ({n / store_s:.0f}/s, "
        f"{auto_snapshots} auto-compaction snapshot(s)), close (snapshot) {close_s:.2f} s, "
        f"reopen {reopen_s:.2f} s (snapshot load + replay {base.open_s:.2f} s, "
        f"{rr.records_applied} records replayed over snapshot seq {rr.snapshot_seq}), "
        f"read back {n - missing} ids in {read_s:.2f} s; on disk {on_disk}")
    if missing or bad or count != n:
        raise AssertionError(f"python engine: {missing} ids missing, {len(bad)} embeddings "
                             f"differ, {count} of {n} counted")
    return out


def phase_durable(dev, corpus):
    """Phase 6 (module docstring): phase 4's corpus stored durably through
    the native engine, searched, partly forgotten, closed and reopened on
    the card; then the Python engine, and a SIGKILLed writer per engine.
    Returns the kernel launches of the durable path (native engine, from
    the open to the last query after the reopen)."""
    import shutil
    import tempfile

    import torch

    import nornicdb_tpu_torch as nt
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_BRUTE_F32, TIER_WALK_F32
    from nornicdb_tpu_torch.storage import codec
    from nornicdb_tpu_torch.storage.disk import DiskEngine

    docs, queries, emb = corpus
    n = len(docs)
    n_explicit = max(n - DURABLE_QUEUE_DOCS, 0)
    out = {"docs": n, "explicit_embeddings": n_explicit, "queue_docs": n - n_explicit}
    REPORT["durable"] = out
    log(f"durable: {n} docs ({n_explicit} with phase 4's embeddings, {n - n_explicit} "
        f"through the embed queue)")

    # the record codec's rate on node records of this corpus
    recs = [{"id": f"neo4j:d{i}", "labels": ["Memory"], "properties": {"content": docs[i]},
             "created_at": 1, "updated_at": 1, "embedding": emb[i].tolist()}
            for i in range(min(DURABLE_CODEC_RECORDS, n))]
    t = time.perf_counter()
    packed = [codec.pack(r) for r in recs]
    pack_s = time.perf_counter() - t
    t = time.perf_counter()
    back = [codec.unpack(b) for b in packed]
    unpack_s = time.perf_counter() - t
    mb = sum(len(b) for b in packed) / 1e6
    if back != recs:
        raise AssertionError("the codec does not round-trip node records")
    out["codec"] = {"records": len(recs), "mb": mb, "pack_mb_per_s": mb / pack_s,
                    "unpack_mb_per_s": mb / unpack_s,
                    "record_bytes": len(packed[0])}
    log(f"  codec: {len(recs)} node records ({mb:.1f} MB, {len(packed[0])} bytes each): "
        f"pack {mb / pack_s:.1f} MB/s, unpack {mb / unpack_s:.1f} MB/s")
    del recs, packed, back

    # the walk tier at the forgotten corpus's size: the live count falls
    # under the 100,000 floor after the forgets
    saved_env = {k: os.environ.get(k) for k in ("NORNICDB_HYBRID_WALK_MIN_N",)}
    os.environ["NORNICDB_HYBRID_WALK_MIN_N"] = str(max(n // 2, 1))
    root = os.path.join(HERE, "_durable")
    os.makedirs(root, exist_ok=True)
    d = tempfile.mkdtemp(prefix="native-", dir=root)
    try:
        mem0 = device_memory()
        reset_counts()
        t0 = time.perf_counter()
        db = nt.open(d, device=dev, engine="native")
        open_s = time.perf_counter() - t0
        if not isinstance(db._base, DiskEngine):
            raise AssertionError(f"engine='native' opened {type(db._base).__name__}")
        t = time.perf_counter()
        for i in range(n_explicit):
            db.store(docs[i], node_id=f"d{i}", embedding=emb[i].tolist())
        store_s = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(n_explicit, n):
            db.store(docs[i], node_id=f"d{i}")
        db.flush()
        queue_s = time.perf_counter() - t
        embedded = (db._embed_queue.embedded_count, db._embed_queue.failed_count)
        b2_ingest = read_counts()["flash_attention"]
        if embedded != (n - n_explicit, 0) or b2_ingest < 1:
            raise AssertionError(f"the embed queue embedded and failed {embedded}, B2 "
                                 f"launched {b2_ingest}")
        t = time.perf_counter()
        svc = db.search  # backfill + the HNSW build
        first_search_s = time.perf_counter() - t
        if svc.stats.strategy != "hnsw" or svc.stats.hnsw_builds != 1 or len(svc.vectors) != n:
            raise AssertionError(f"the first search: strategy {svc.stats.strategy}, "
                                 f"{svc.stats.hnsw_builds} HNSW builds, {len(svc.vectors)} vectors")
        saves_after_build = dict(svc.save_stats)
        log(f"  native engine: opened in {open_s:.3f} s, stored {n_explicit} docs with "
            f"embeddings in {store_s:.2f} s ({n_explicit / store_s:.0f}/s), {n - n_explicit} "
            f"through the queue + flush in {queue_s:.2f} s (B2 launches {b2_ingest}); first "
            f"search (backfill + HNSW build) {first_search_s:.2f} s, "
            f"{saves_after_build['saves']} debounced saves meanwhile "
            f"({saves_after_build['save_s']:.2f} s in all)")
        ans0, lat0, first0, _, counts0 = durable_modes(db, queries, "first")
        # forget ids the answers name
        forget = []
        for (label, _), hits in ans0.items():
            for i, _ in hits[:2]:
                if i not in forget and len(forget) < DURABLE_FORGET:
                    forget.append(i)
        for i in range(n):
            if len(forget) >= DURABLE_FORGET:
                break
            if f"d{i}" not in forget:
                forget.append(f"d{i}")
        t = time.perf_counter()
        for i in forget:
            db.forget(i)
        forget_s = time.perf_counter() - t
        saves_at_forget = svc.save_stats["saves"]
        before, lat1, _, _, counts1 = durable_modes(db, queries, "before-close")
        gone = set(forget)
        for hits in before.values():
            if gone & {i for i, _ in hits}:
                raise AssertionError("a forgotten id was answered before the close")
        svc_saves = dict(svc.save_stats)
        save_stats = svc.save_stats  # the close's save lands here too
        del svc
        t = time.perf_counter()
        db.close()
        close_s = time.perf_counter() - t
        final = dict(save_stats)
        on_disk = dir_bytes(d)
        del db
        mem_after = device_memory()
        split = final["last_split_s"]
        closing = final["saves"] - svc_saves["saves"]
        log(f"  close: {close_s:.2f} s, {closing} index save in it; the last save "
            f"{split['total']:.2f} s (vectors {split['vectors']:.2f}, HNSW {split['hnsw']:.2f}, "
            f"BM25 + meta {split['bm25_meta']:.2f}); {svc_saves['saves']} saves before the close "
            f"({svc_saves['timer_saves']} by the debounce timer, {svc_saves['save_s']:.2f} s "
            f"in all, longest {svc_saves['max_save_s']:.2f} s); memory_allocated {mem_after} "
            f"against {mem0} before the phase")
        if abs(mem_after - mem0) > DURABLE_MEM_SLACK:
            raise AssertionError(f"memory_allocated after the close {mem_after} vs {mem0} "
                                 f"before the phase")
        if final["failed"] or final["saves"] <= saves_at_forget:
            raise AssertionError(f"index saves: no save after the forgets, or one failed: {final}")

        # -- reopen -------------------------------------------------------
        t0 = time.perf_counter()
        db = nt.open(d, device=dev)
        reopen_open_s = time.perf_counter() - t0
        base = db._base
        if not isinstance(base, DiskEngine):
            raise AssertionError(f"the dir reopened as {type(base).__name__}")
        engine_open_s = base.open_s
        b1_at_reopen = read_counts()["cosine_topk"]
        t = time.perf_counter()
        svc = db.search  # index load + the resume scan
        search_open_s = time.perf_counter() - t
        ls = dict(svc.load_stats)
        if svc.stats.hnsw_builds != 0 or svc.hnsw is None or ls.get("reindexed") != 0:
            raise AssertionError(f"the reopen rebuilt: hnsw_builds {svc.stats.hnsw_builds}, "
                                 f"load {ls}")
        count = db.storage.count_nodes()
        if count != n - len(forget):
            raise AssertionError(f"count_nodes {count} after the reopen, want {n - len(forget)}")
        after, lat2, first2, trios, counts2 = durable_modes(db, queries, "after-reopen")
        db.flush()
        if db._embed_queue.embedded_count or db._embed_queue.failed_count:
            raise AssertionError(f"the embed queue processed {db._embed_queue.embedded_count} "
                                 "nodes after the reopen")
        path = read_counts()
        b1_reopen = path["cosine_topk"] - b1_at_reopen
        fused = svc._fused
        g = fused.cagra._graph
        graph_b1 = g["n"] // 1024 + (1 if g["n"] % 1024 else 0)
        if b1_reopen < graph_b1 + len(queries):
            raise AssertionError(f"B1 launched {b1_reopen} times after the reopen, fewer than "
                                 f"the graph build's {graph_b1} + the exact tier's {len(queries)}")
        if counts2["hybrid_exact"] != {TIER_BRUTE_F32: len(queries), "dispatch": len(queries)} \
                or counts2["hybrid_walk"] != {TIER_WALK_F32: len(queries),
                                              "walk_dispatch": len(queries)}:
            raise AssertionError(f"hybrid tiers after the reopen: {counts2}")
        for (label, qq), hits in after.items():
            if gone & {i for i, _ in hits}:
                raise AssertionError(f"a forgotten id was answered after the reopen ({label})")
            if label != "hybrid_walk" and hits != before[(label, qq)]:
                raise AssertionError(f"{label} answer for {qq!r} after the reopen differs from "
                                     "the one before the close")
        # the walk: a graph built anew over the compacted rows
        qvs = np.asarray(db._embedder.embed_batch(queries), np.float32)
        host_lex = {qq: svc.bm25.search(qq, 30) for qq in queries}
        exact30 = {qq: svc.vectors.search_batch(qv[None, :], 30)[0]
                   for qq, qv in zip(queries, qvs)}
        walk = check_walk_answers(fused, trios, queries, qvs, host_lex, exact30)
        same = [hits_agree(after[("hybrid_walk", qq)], before[("hybrid_walk", qq)],
                           TOPK_SCORE_ATOL) for qq in queries]
        walk["agree_with_before_close"] = float(np.mean(same))
        walk["recall_at_10_vs_before_close"] = float(np.mean(
            [recall10(after[("hybrid_walk", qq)], before[("hybrid_walk", qq)])
             for qq in queries]))
        log(f"  walk after the reopen: {walk['agree_with_before_close']:.4f} of answers "
            f"tie-aware (within {TOPK_SCORE_ATOL}) those before the close, recall@10 against "
            f"them {walk['recall_at_10_vs_before_close']:.4f}")
        if walk["recall_at_10_vs_before_close"] < RECALL_MIN:
            raise AssertionError(f"walk answers after the reopen: {walk}")
        del fused, g, svc, trios
        t = time.perf_counter()
        db.close()
        close2_s = time.perf_counter() - t
        del db, base
        recovery = {
            "db_open_s": reopen_open_s, "engine_open_s": engine_open_s,
            "search_open_s": search_open_s, "index_load": ls,
            "first_query_ms": {"vector": lat2["vector"][0], "text": lat2["text"][0],
                               **first2},
        }
        out.update({
            "open_s": open_s, "store_s": store_s, "store_docs_per_s": n_explicit / store_s,
            "queue_flush_s": queue_s, "first_search_s": first_search_s,
            "saves_during_build": saves_after_build, "saves_before_close": svc_saves,
            "forget": len(forget), "forget_s": forget_s,
            "close_s": close_s, "final_save": final, "close_after_reopen_s": close2_s,
            "bytes": on_disk,
            "memory_allocated": {"before": mem0, "after_close": mem_after},
            "recovery": recovery, "launches": path, "b1_after_reopen": b1_reopen,
            "graph_b1_launches": graph_b1, "walk": walk,
            "first_ms": {"first": first0, "after_reopen": first2},
            "fused_counts": {"first": counts0, "before_close": counts1, "after_reopen": counts2},
        })
        for tag, lat in (("first", lat0), ("before_close", lat1), ("after_reopen", lat2)):
            out[f"p50_ms_{tag}"] = {m: float(np.percentile(v, 50)) for m, v in lat.items()}
        log(f"  reopen: DB open {reopen_open_s:.3f} s (segment scan "
            f"{recovery['engine_open_s']:.3f} s), search open {search_open_s:.2f} s (BM25 "
            f"{ls['bm25_s']:.2f} s, vectors read {ls['vectors_read_s']:.2f} s, device upload "
            f"{ls['vectors_upload_s']:.3f} s, HNSW {ls['hnsw_s']:.2f} s, resume scan "
            f"{search_open_s - ls['total_s']:.2f} s; {ls['reindexed']} reindexed); first "
            f"query vector {lat2['vector'][0]:.1f} ms, text {lat2['text'][0]:.1f} ms, hybrid "
            f"{first2['hybrid_first_ms']:.1f} ms (snapshot wait {first2['snapshot_wait_s']:.2f} "
            f"s, graph wait {first2['graph_wait_s']:.2f} s); B1 {b1_reopen} launches after the "
            f"reopen ({graph_b1} the graph build's); close {close2_s:.2f} s")
        log(f"  answers after the reopen: vector, text and exact-tier hybrid bitwise those "
            f"before the close ({len(queries)} queries each), {len(forget)} forgotten ids "
            f"answered nowhere, count_nodes {count}; on disk {on_disk}")
        log(f"durable path launches: {path}")
        if min(path.values()) < 1:
            raise AssertionError(f"a kernel of the durable path never launched: {path}")

        out["python_engine"] = durable_python(dev, docs, emb, root)
        out["kill"] = {e: durable_kill(dev, e, root) for e in ("native", "python")}
        return path
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


# -- phase 7 ---------------------------------------------------------------

# (a) the reference's Cypher benchmark graph (bench.py:_bench_cypher)
LDBC_PERSONS = 50_000
LDBC_MESSAGES = 100_000
LDBC_KNOWS = 20
LDBC_WINDOW_S = 2.0  # per shape; shrinks first if the run nears its limit
LDBC_PARITY_POINTS = 8  # rotating parameters per point shape
# (b) the memory graph on the card
CYPHER_MEMORIES = 8_000
CYPHER_CAPACITY = 8_192  # the vector index's capacity at 8,000 rows
CYPHER_TOPK_B = (1, 4, 5, 8, 15, 16)  # B1 checked at these B in phase 3
CYPHER_TIMED_B = (1, 4, 8)  # and timed in phase 7 on the index's own rows
CYPHER_BATCH = 500  # rows per UNWIND ... CREATE
CYPHER_LINKS = 3  # RELATES_TO edges per memory
CYPHER_THREADS = 16
CYPHER_PER_THREAD = 16
# (c) temporal values and restart
CYPHER_EVENTS = 1_000
CYPHER_RESTART_QUERIES = 16
# (d) the device graph plane on (a)'s graph (and DB.graph_vector_search on (b)'s)
GRAPH_SINGLE_READS = 64
GRAPH_THREADS = 16
GRAPH_PER_THREAD = 16
GRAPH_CHAIN_TIMED_B = (16, 64)
GRAPH_HOPS = (("KNOWS", "out"), ("KNOWS", "out"))
GRAPH_RANK_B = (1, 16, 64)
GRAPH_RANK_K = 10
GRAPH_RANK_DIMS = 160  # the DB's width
GRAPH_GVS_ANCHORS = 32
GRAPH_REPS = 10  # timing repetitions; a late run takes 2 (the checks stay)
GRAPH_MEM_SLACK = 1 << 20  # the snapshots' device bytes against the memory_allocated delta
PAGERANK_RTOL, PAGERANK_ATOL = 1e-4, 1e-7  # the reference's (tests/test_ops.py:364)

GRAPHRAG = ("CALL db.index.vector.queryNodes('memory', 10, $v) YIELD node, score "
            "MATCH (node)-[:RELATES_TO]->(r:Memory) "
            "RETURN node.mid, score, count(r) ORDER BY score DESC")
FULLTEXT = ("CALL db.index.fulltext.queryNodes('memory', $q, 10) YIELD node, score "
            "RETURN node.mid, score")
TWO_HOP = ("MATCH (a:Memory {mid: $m})-[:RELATES_TO]->(b:Memory)-[:RELATES_TO]->(c:Memory) "
           "RETURN count(DISTINCT c)")


def ldbc_graph(n_people, n_msgs, knows_per):
    """The LDBC-shaped social graph of the reference's Cypher benchmark,
    seed 11, in ``NamespacedEngine(MemoryEngine(), "bench")``. Returns
    (engine, counts, the five shapes as (query, params of iteration))."""
    import random

    from nornicdb_tpu_torch.storage import Edge, MemoryEngine, NamespacedEngine, Node

    eng = NamespacedEngine(MemoryEngine(), "bench")
    rng = random.Random(11)
    cities = [f"city{c}" for c in range(50)]
    tags = [f"tag{t}" for t in range(40)]
    seq = iter(range(10**9))

    def add_node(labels, props):
        n = Node(id=f"n{next(seq)}", labels=labels, properties=props)
        eng.create_node(n)
        return n.id

    def add_edge(etype, a, b):
        eng.create_edge(Edge(id=f"e{next(seq)}", type=etype, start_node=a, end_node=b))

    city_ids = [add_node(["City"], {"name": c}) for c in cities]
    tag_ids = [add_node(["Tag"], {"name": t}) for t in tags]
    people = [add_node(["Person"], {"id": i, "name": f"p{i}", "age": 18 + (i * 7) % 50})
              for i in range(n_people)]
    n_knows = 0
    for i, pid in enumerate(people):
        add_edge("IS_LOCATED_IN", pid, city_ids[i % len(cities)])
        for j in rng.sample(range(n_people), knows_per):
            if j != i:
                add_edge("KNOWS", pid, people[j])
                n_knows += 1
    for m in range(n_msgs):
        mid = add_node(["Message"], {"id": 100000 + m, "content": f"msg {m}",
                                     "creationDate": 1700000000 + m * 37})
        add_edge("HAS_CREATOR", mid, people[rng.randrange(n_people)])
        for t in rng.sample(range(len(tags)), rng.randrange(1, 4)):
            add_edge("HAS_TAG", mid, tag_ids[t])
    shapes = {
        "msg_content_lookup": (
            "MATCH (m:Message {id: $mid}) RETURN m.content",
            lambda it: {"mid": 100000 + (it * 7) % n_msgs}),
        "recent_messages_friends": (
            "MATCH (p:Person {id: $pid})-[:KNOWS]->(f:Person)<-[:HAS_CREATOR]-(m:Message) "
            "RETURN f.name, m.content, m.creationDate ORDER BY m.creationDate DESC LIMIT 10",
            lambda it: {"pid": (it * 13) % n_people}),
        "avg_friends_per_city": (
            "MATCH (c:City)<-[:IS_LOCATED_IN]-(p:Person)-[:KNOWS]->(f:Person) "
            "RETURN c.name, count(f) / count(DISTINCT p) AS avgFriends",
            lambda it: {}),
        "tag_cooccurrence": (
            "MATCH (t1:Tag)<-[:HAS_TAG]-(m:Message)-[:HAS_TAG]->(t2:Tag) "
            "WHERE t1 <> t2 RETURN t1.name, t2.name, count(m) AS freq",
            lambda it: {}),
        "northwind_writes": (
            "MATCH (a:Person {id: $a}), (b:Person {id: $b}) CREATE (a)-[:BOUGHT_WITH]->(b)",
            lambda it: {"a": (it * 7) % n_people, "b": (it * 13 + 1) % n_people}),
    }
    counts = {"persons": n_people, "knows_edges": n_knows, "messages": n_msgs,
              "cities": len(cities), "tags": len(tags), "nodes": eng.count_nodes(),
              "edges": eng.count_edges()}
    return eng, counts, shapes


def latency_summary(lat_ms):
    lat = np.asarray(lat_ms)
    return {"queries": int(lat.size), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "mean_ms": float(lat.mean())}


def cypher_ldbc(card, n_people, n_msgs, knows_per, window_s):
    """Phase 7 (a): the LDBC shapes, fast paths against the row
    interpreter. Returns (report, engine, executor, shapes)."""
    from collections import Counter

    from nornicdb_tpu_torch.query.executor import CypherExecutor

    t = time.perf_counter()
    eng, counts, shapes = ldbc_graph(n_people, n_msgs, knows_per)
    build_s = time.perf_counter() - t
    ex = CypherExecutor(eng)
    ex.enable_query_cache = False
    t = time.perf_counter()
    ex.columnar.nodes()  # the node table and its label columns
    catalog_s = time.perf_counter() - t
    out = {"graph": counts, "build_s": build_s, "catalog_nodes_s": catalog_s, "shapes": {}}
    log(f"cypher (a): LDBC graph {counts} built in {build_s:.2f} s; catalog node table "
        f"{catalog_s:.3f} s ({card})")
    slow = CypherExecutor(eng)
    slow.enable_query_cache = False
    slow.enable_fastpaths = False
    for name, (q, mk) in shapes.items():
        edges0 = eng.count_edges()
        t = time.perf_counter()
        created = ex.execute(q, mk(0)).stats.relationships_created  # cold: builds views
        cold_ms = (time.perf_counter() - t) * 1e3
        lat = []
        t0 = time.perf_counter()
        it = 1
        while time.perf_counter() - t0 < window_s and it <= 20_000:
            t = time.perf_counter()
            created += ex.execute(q, mk(it)).stats.relationships_created
            lat.append((time.perf_counter() - t) * 1e3)
            it += 1
        wall = time.perf_counter() - t0
        # the write shape creates one edge a query, and no read shape any
        want = it if name == "northwind_writes" else 0
        if created != want or eng.count_edges() - edges0 != want:
            raise AssertionError(f"{name}: {it} queries created {created} edges "
                                 f"({eng.count_edges() - edges0} stored), want {want}")
        row = {"cold_ms": cold_ms, "queries_per_s": len(lat) / wall, **latency_summary(lat)}
        if name != "northwind_writes":
            # the fast path's rows against the row interpreter's, as multisets
            runs = [mk(i * 997 + 1) for i in range(LDBC_PARITY_POINTS)] if mk(0) else [{}]
            t = time.perf_counter()
            for params in runs:
                fast = Counter(map(repr, ex.execute(q, params).rows))
                rows = Counter(map(repr, slow.execute(q, params).rows))
                if fast != rows or not rows:
                    raise AssertionError(f"{name}: the fast path's rows differ from the row "
                                         f"interpreter's for {params} ({sum(fast.values())} "
                                         f"against {sum(rows.values())} rows)")
            row["parity_runs"] = len(runs)
            row["interpreter_s"] = time.perf_counter() - t
        out["shapes"][name] = row
        log(f"  {name}: {row['queries_per_s']:.1f} queries/s, p50 {row['p50_ms']:.3f} ms, "
            f"p99 {row['p99_ms']:.3f} ms over {row['queries']} in {wall:.2f} s (cold "
            f"{cold_ms:.1f} ms)" + (f"; rows equal to the row interpreter's on "
                                    f"{row['parity_runs']} runs ({row['interpreter_s']:.2f} s)"
                                    if "parity_runs" in row else "") + f" ({card})")
    out["plane_counts"] = dict(ex.device_graph.counts)
    log(f"  device graph plane under auto: {out['plane_counts']}, "
        f"{ex.device_graph.dispatches} chain/rank dispatches")
    return out, eng, ex, shapes


def graphrag_rows(db, qv):
    return [tuple(r) for r in db.cypher(GRAPHRAG, {"v": qv}).rows]


def graphrag_agrees(got, want):
    """Two GraphRAG answers: mids tie-aware with scores within 1e-5, and
    each mid's count of related memories equal."""
    if not hits_agree([(m, s) for m, s, _ in got], [(m, s) for m, s, _ in want],
                      TOPK_SCORE_ATOL):
        return False
    counts = {m: c for m, _, c in want}
    return all(counts.get(m, c) == c for m, _, c in got)


def plain_vector_hits(svc, qvs, k, mid_of):
    """Each query's top ``k`` (mid, score) by B1's plain version (matmul,
    mask, stable top-k) over the vector index's own device rows: the
    answer the vector procedure must give, computed without the kernel."""
    import torch

    from nornicdb_tpu_torch.ops.similarity import cosine_topk, l2_normalize

    m, valid, ids, _ = svc.vectors.device_view()
    q = l2_normalize(torch.tensor(qvs, dtype=torch.float32, device=m.device))
    s, i = (x.cpu().numpy() for x in cosine_topk(q, m, valid, k))
    return [[(mid_of[ids[j]], float(v)) for v, j in zip(sr, ir)] for sr, ir in zip(s, i)]


def cypher_reads(db, svc, queries, qvs, mid_of, card):
    """Phase 7 (b)'s reads: 64 queries of each shape, one at a time,
    each held against another route to the same answer."""
    from nornicdb_tpu_torch.query.executor import CypherExecutor

    lat = {"graphrag": [], "fulltext": [], "two_hop": []}
    answers = []
    for qv in qvs:
        t = time.perf_counter()
        rows = graphrag_rows(db, qv)
        lat["graphrag"].append((time.perf_counter() - t) * 1e3)
        answers.append(rows)
    for rows, want in zip(answers, plain_vector_hits(svc, qvs, 10, mid_of)):
        if len(rows) != 10 or not hits_agree([(m, s) for m, s, _ in rows], want,
                                             TOPK_SCORE_ATOL):
            raise AssertionError(f"GraphRAG rows {rows} differ from the plain top-k {want}")
        if any(c != CYPHER_LINKS for _, _, c in rows):
            raise AssertionError(f"GraphRAG counts {rows}, want {CYPHER_LINKS} each")
    for q in queries:
        t = time.perf_counter()
        rows = db.cypher(FULLTEXT, {"q": q}).rows
        lat["fulltext"].append((time.perf_counter() - t) * 1e3)
        want = [mid_of[i] for i, _ in svc.bm25.search(q, 10)]
        if [r[0] for r in rows] != want:
            raise AssertionError(f"fulltext rows for {q!r} differ from the BM25 index's")
    slow = CypherExecutor(db.storage)
    slow.enable_fastpaths = False
    slow.enable_query_cache = False
    for i in range(len(queries)):
        m = (i * 127) % len(mid_of)
        t = time.perf_counter()
        rows = db.cypher(TWO_HOP, {"m": m}).rows
        lat["two_hop"].append((time.perf_counter() - t) * 1e3)
        if rows != slow.execute(TWO_HOP, {"m": m}).rows or not rows[0][0]:
            raise AssertionError(f"two-hop rows for mid {m}: {rows}")
    out = {k: latency_summary(v) for k, v in lat.items()}
    for k, v in out.items():
        log(f"  {k}: p50 {v['p50_ms']:.3f} ms, p99 {v['p99_ms']:.3f} ms over {v['queries']} "
            f"queries one at a time ({card})")
    return out, answers


def cypher_concurrent(db, svc, qvs, answers, card):
    """16 client threads send GraphRAG queries through ``DB.cypher``: the
    vector procedure's rides must coalesce, and every answer equal the
    one-at-a-time answer."""
    import threading

    import torch

    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk

    mb = svc._microbatch
    mark = batcher_mark(mb)
    sizes0 = dict(fused_cosine_topk.launch_sizes)
    got, errors = [], []
    barrier = threading.Barrier(CYPHER_THREADS)

    def client(t):
        try:
            barrier.wait()
            for j in range(CYPHER_PER_THREAD):
                i = (t * 5 + j) % len(qvs)
                got.append((i, graphrag_rows(db, qvs[i])))
        except BaseException as exc:  # noqa: BLE001 -- re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(CYPHER_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError("a GraphRAG client did not finish")
    if errors:
        raise errors[0]
    batches, rode, bsizes = batcher_delta(mb, mark)
    launched = {b: n - sizes0.get(b, 0) for b, n in fused_cosine_topk.launch_sizes.items()
                if n != sizes0.get(b, 0)}
    out = {"threads": CYPHER_THREADS, "queries": len(got), "wall_s": wall,
           "queries_per_s": len(got) / wall, "batches": batches, "rides": rode,
           "mean_batch": rode / max(batches, 1), "batch_sizes": bsizes,
           "cosine_topk_launch_sizes": dict(sorted(launched.items()))}
    log(f"  concurrent GraphRAG: {len(got)} queries from {CYPHER_THREADS} threads in "
        f"{wall:.3f} s ({out['queries_per_s']:.1f}/s); {rode} vector rides in {batches} "
        f"batches, mean {out['mean_batch']:.3f} (sizes {bsizes}); B1 launches by B "
        f"{out['cosine_topk_launch_sizes']} ({card})")
    if rode != len(got) or out["mean_batch"] <= 1.0 or not any(b >= 5 for b in launched):
        raise AssertionError(f"the GraphRAG rides did not coalesce: {out}")
    for i, rows in got:
        if not graphrag_agrees(rows, answers[i]):
            raise AssertionError(f"concurrent GraphRAG answer {rows} for query {i} differs "
                                 f"from the one at a time, {answers[i]}")
    out["identical"] = sum(rows == answers[i] for i, rows in got)
    log(f"  concurrent answers agree with one at a time ({out['identical']} of {len(got)} "
        f"identical)")
    return out


def cypher_events(db, rng):
    """Phase 7 (c)'s writes: typed values created by Cypher."""
    t = time.perf_counter()
    for i in range(CYPHER_EVENTS):
        day = int(rng.integers(0, 3650))
        secs = int(rng.integers(0, 86400))
        db.cypher("CREATE (:Event {eid: $i, at: datetime($s), d: date($d), span: duration($p)})",
                  {"i": i,
                   "s": f"20{10 + day // 365:02d}-{1 + day % 12:02d}-{1 + day % 28:02d}T"
                        f"{secs // 3600:02d}:{secs // 60 % 60:02d}:{secs % 60:02d}Z",
                   "d": f"19{50 + day // 100:02d}-{1 + day % 12:02d}-{1 + day % 28:02d}",
                   "p": f"P{day}DT{secs}S"})
    return time.perf_counter() - t


EVENTS = "MATCH (e:Event) RETURN e.eid, e.at, e.d, e.span ORDER BY e.eid"


def event_rows(db):
    rows = db.cypher(EVENTS).rows
    if len(rows) != CYPHER_EVENTS or {type(v).__name__ for r in rows for v in r[1:]} != {
            "CypherDateTime", "CypherDate", "CypherDuration"}:
        raise AssertionError(f"events read back: {len(rows)} rows, types "
                             f"{ {type(v).__name__ for r in rows for v in r[1:]} }")
    return [[repr(v) for v in r] for r in rows]


def cypher_multidb(db):
    """Two databases beside the DB's own through ``multidb_manager``."""
    from nornicdb_tpu_torch.query.executor import CypherExecutor

    mgr = db.multidb_manager()
    own = mgr.counts("neo4j")
    for name, n in (("tenant_a", 300), ("tenant_b", 200)):
        mgr.create_database(name)
        CypherExecutor(mgr.get_storage(name)).execute(
            "UNWIND range(1, $n) AS i CREATE (:Doc {i: i})", {"n": n})
    counts = {name: mgr.counts(name) for name in ("neo4j", "tenant_a", "tenant_b")}
    want = {"neo4j": own, "tenant_a": {"nodes": 300, "edges": 0},
            "tenant_b": {"nodes": 200, "edges": 0}}
    if counts != want:
        raise AssertionError(f"database counts {counts}, want {want}")
    mgr.drop_database("tenant_b")
    left = sorted(d.name for d in mgr.list_databases())
    if left != ["neo4j", "system", "tenant_a"] or mgr.counts("tenant_a")["nodes"] != 300 \
            or db.storage.count_nodes() != own["nodes"]:
        raise AssertionError(f"after the drop: {left}, {mgr.counts('tenant_a')}")
    log(f"  multidb: counts {counts}, isolated; tenant_b dropped, left {left}")
    return {"counts": counts, "after_drop": left}


@contextlib.contextmanager
def graph_mode(value):
    """NORNICDB_GRAPH_DEVICE set for a block, and restored."""
    prev = os.environ.get("NORNICDB_GRAPH_DEVICE")
    os.environ["NORNICDB_GRAPH_DEVICE"] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("NORNICDB_GRAPH_DEVICE", None)
        else:
            os.environ["NORNICDB_GRAPH_DEVICE"] = prev


class Capture:
    """Wraps a program of ``query/device_graph.py`` for a block: records
    each call's arguments and the batch it served (anchors >= 0)."""

    def __init__(self, name):
        from nornicdb_tpu_torch.query import device_graph as dg

        self.dg, self.name, self.real = dg, name, getattr(dg, name)
        self.args, self.calls, self.riders = None, 0, 0

    def __enter__(self):
        def wrapped(*args):
            self.args = args
            self.calls += 1
            if self.name in ("_chain_topk", "_traverse_rank"):
                self.riders += int((args[0] >= 0).sum())
            return self.real(*args)

        setattr(self.dg, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.dg, self.name, self.real)

    def event_ms(self, reps):
        """CUDA-event ms of the program alone on the last call's inputs."""
        return time_ms(lambda: self.real(*self.args), iters=reps, warmup=1)


def graph_chain(ex, shapes, card, reps):
    """(d) 1: ``recent_messages_friends`` on the plane. Rows against the
    host path's (the same executor under ``off``) for every read; 64
    single-stream reads under ``on`` (one dispatch each), 16 threads x 16
    reads under ``auto`` and again under ``on`` (riders per dispatch); one
    B 16 and one B 64 dispatch timed, kernels per call by the profiler."""
    import threading

    import torch

    q, mk = shapes["recent_messages_friends"]
    plane = ex.device_graph
    single = [mk(it) for it in range(GRAPH_SINGLE_READS)]
    conc = [[mk(5000 + t * GRAPH_PER_THREAD + j) for j in range(GRAPH_PER_THREAD)]
            for t in range(GRAPH_THREADS)]
    with graph_mode("off"):
        d0 = plane.dispatches
        want = {p["pid"]: ex.execute(q, p).rows for p in single + [p for c in conc for p in c]}
        if plane.dispatches != d0:
            raise AssertionError("the plane dispatched under NORNICDB_GRAPH_DEVICE=off")
    out = {}
    with graph_mode("on"):
        plane._forced = None  # the pre-gate's cached mode: read it again now
        d0 = plane.dispatches
        t = time.perf_counter()
        ex.execute(q, single[0])  # builds the chain snapshot
        out["first_read_s"] = time.perf_counter() - t
        lat = []
        for p in single:
            t = time.perf_counter()
            rows = ex.execute(q, p).rows
            lat.append((time.perf_counter() - t) * 1e3)
            if rows != want[p["pid"]]:
                raise AssertionError(f"chain rows for {p} differ from the host path's")
        out["on_dispatches"] = plane.dispatches - d0
        out["on_single"] = latency_summary(lat)
        if out["on_dispatches"] != len(single) + 1:
            raise AssertionError(f"{len(single) + 1} reads under on made "
                                 f"{out['on_dispatches']} dispatches")
    spec = next(k[1:] for k in plane._batchers if k[0] == "chainb")
    batcher = plane._chain_batcher(spec)

    def concurrent(mode):
        got, errors = [], []
        barrier = threading.Barrier(GRAPH_THREADS)

        def client(t):
            try:
                barrier.wait()
                for p in conc[t]:
                    got.append((p["pid"], ex.execute(q, p).rows))
            except BaseException as exc:  # noqa: BLE001 -- re-raised below
                errors.append(exc)

        with graph_mode(mode), Capture("_chain_topk") as cap:
            b0, i0, d0 = batcher.batches, batcher.batched_items, plane.dispatches
            below0 = plane.counts["batch_below_min_b"]
            threads = [threading.Thread(target=client, args=(t,)) for t in range(GRAPH_THREADS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads):
            raise AssertionError("a chain client did not finish")
        if errors:
            raise errors[0]
        for pid, rows in got:
            if rows != want[pid]:
                raise AssertionError(f"concurrent chain rows for pid {pid} differ from the "
                                     f"host's")
        row = {"reads": len(got), "wall_s": wall, "queries_per_s": len(got) / wall,
               "coalesced_batches": batcher.batches - b0, "riders": batcher.batched_items - i0,
               "dispatched": plane.dispatches - d0, "riders_dispatched": cap.riders,
               "min_batch": plane.counts["batch_below_min_b"] - below0}
        row["mean_riders_per_dispatch"] = cap.riders / max(row["dispatched"], 1)
        log(f"  chain, {GRAPH_THREADS} threads x {GRAPH_PER_THREAD} under {mode}: "
            f"{row['reads']} reads in {wall:.3f} s ({row['queries_per_s']:.0f}/s), "
            f"{row['coalesced_batches']} coalesced batches of {row['riders']} riders, "
            f"{row['dispatched']} dispatched ({row['riders_dispatched']} riders, mean "
            f"{row['mean_riders_per_dispatch']:.2f}), {row['min_batch']} below min_b; rows "
            f"equal ({card})")
        return row

    out["auto_concurrent"] = auto = concurrent("auto")
    out["on_concurrent"] = concurrent("on")
    if out["on_concurrent"]["dispatched"] < 1:
        raise AssertionError("the concurrent reads under on never dispatched")
    timed = {}
    rows = ex.columnar.label_rows("Person")
    with graph_mode("on"):
        for b in GRAPH_CHAIN_TIMED_B:
            items = [(int(r), 10) for r in rows[:b]]
            with Capture("_chain_topk") as cap:
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(reps):
                    res = plane._chain_batch(spec, items)
                wall_ms = (time.perf_counter() - t) * 1e3 / reps
            if any(r is None for r in res):
                raise AssertionError(f"a B {b} chain dispatch stepped down: {plane.counts}")
            args = cap.args
            kernels = {}
            split = device_split(lambda: cap.real(*args), iters=3, launches=kernels)
            timed[b] = {"event_ms": cap.event_ms(reps), "wall_ms": wall_ms,
                        "f": int(args[-2]), "kp": int(args[-1]),
                        "device_ms": sum(split.values()), "kernels": sum(kernels.values())}
    out["timed"] = timed
    log(f"cypher (d) chain: {len(single)} single reads under on, {out['on_dispatches']} "
        f"dispatches, p50 {out['on_single']['p50_ms']:.3f} ms, p99 "
        f"{out['on_single']['p99_ms']:.3f} ms (first read with the snapshot "
        f"{out['first_read_s']:.3f} s); rows equal to the host path's ({card})")
    for b, row in timed.items():
        log(f"  chain dispatch B={b} (f {row['f']}, kp {row['kp']}): event "
            f"{row['event_ms']:.4f} ms, device {row['device_ms']:.4f} ms in "
            f"{row['kernels']:.0f} kernels, _chain_batch wall {row['wall_ms']:.3f} ms ({card})")
    return out, spec


def graph_strip_gram(dev, eng, ex, shapes, card, reps):
    """(d) 2 and 3: the strip view and the co-occurrence Gram, each built
    on the card and on the host from one fresh catalog (its tables built
    first), bitwise; ``tag_cooccurrence`` rows under ``on`` equal the host
    view's."""
    from nornicdb_tpu_torch.query.executor import CypherExecutor

    if ex.device_graph.counts["strip_view_device_built"] < 1:
        raise AssertionError(f"(a)'s avg_friends_per_city did not build its view on the "
                             f"card: {ex.device_graph.counts}")
    fresh = CypherExecutor(eng, device=dev)
    fresh.enable_query_cache = False
    cat, plane = fresh.columnar, fresh.device_graph
    args = ("IS_LOCATED_IN", "dst", "Person", "KNOWS", "out", "Person")
    t = time.perf_counter()
    for et in ("IS_LOCATED_IN", "KNOWS", "HAS_TAG"):
        cat.edge_table(et)
    cat.label_mask("Person")
    inc = cat.incidence("HAS_TAG", "mid_src", "Message", "Tag")[0]
    tables_s = time.perf_counter() - t
    dev_s, host_s = [], []
    for _ in range(reps):
        with cat._lock:
            cat._strip_views.clear()
        with graph_mode("on"):
            t = time.perf_counter()
            sv_d = plane.build_strip_view(*args)
            dev_s.append(time.perf_counter() - t)
        with cat._lock:
            cat._strip_views.clear()
        t = time.perf_counter()
        sv_h = cat.strip_view(*args)
        host_s.append(time.perf_counter() - t)
        if sv_d is None or any(not np.array_equal(getattr(sv_d, k), getattr(sv_h, k))
                               or getattr(sv_d, k).dtype != getattr(sv_h, k).dtype
                               for k in ("deg", "sum_deg", "nnz")):
            raise AssertionError("the card's strip view differs from the host build")
    gram_d, gram_h = [], []
    with graph_mode("on"), Capture("_gram") as cap:
        for _ in range(reps):
            t = time.perf_counter()
            c = plane.gram_matmul(inc, inc)
            gram_d.append(time.perf_counter() - t)
            t = time.perf_counter()
            h = inc.T @ inc
            gram_h.append(time.perf_counter() - t)
            if c is None or c.dtype != h.dtype or not np.array_equal(c, h):
                raise AssertionError("the card's Gram differs from the host's Ma^T @ Ma")
        gram_ms = cap.event_ms(reps)
        q = shapes["tag_cooccurrence"][0]
        calls = cap.calls
        rows_on = sorted(map(repr, fresh.execute(q).rows))
        if cap.calls != calls + 1:
            raise AssertionError("tag_cooccurrence under on did not multiply on the card")
    with graph_mode("off"):
        if rows_on != sorted(map(repr, ex.execute(q).rows)):
            raise AssertionError("tag_cooccurrence rows under on differ from the host's")
    out = {"tables_s": tables_s, "strip_device_s": dev_s, "strip_host_s": host_s,
           "gram_shape": list(inc.shape), "gram_device_s": gram_d, "gram_host_s": gram_h,
           "gram_event_ms": gram_ms, "tag_rows": len(rows_on)}
    log(f"cypher (d) strip view: card build {min(dev_s):.4f} s (wall, best of {reps}) against "
        f"the host's {min(host_s):.4f} s, arrays bitwise; the catalog's tables "
        f"{tables_s:.2f} s first; Gram {inc.shape[0]} x {inc.shape[1]}: card {min(gram_d):.4f}"
        f" s wall ({gram_ms:.4f} event ms for the product) against host {min(gram_h):.4f} s, "
        f"bitwise; tag_cooccurrence rows under on equal the host's ({card})")
    return out


def graph_rank(dev, ex, card, reps, seed):
    """(d) 4: traverse-then-rank over ``KNOWS`` (1 and 2 hops) into a
    50,000-row index of seeded unit vectors, against the host version.
    Returns (report, index)."""
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    cat, plane = ex.columnar, ex.device_graph
    nodes = cat.nodes()
    persons = cat.label_rows("Person")
    rng = np.random.default_rng(seed + 17)
    vecs = rng.normal(size=(len(persons), GRAPH_RANK_DIMS)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    idx = BruteForceIndex(dims=GRAPH_RANK_DIMS, device=dev)
    t = time.perf_counter()
    idx.add_batch([(nodes[int(r)].id, v) for r, v in zip(persons, vecs)])
    index_s = time.perf_counter() - t
    out = {"index_rows": len(persons), "index_s": index_s, "runs": []}
    for hops in (GRAPH_HOPS[:1], GRAPH_HOPS):
        for b in GRAPH_RANK_B:
            anchors = [int(a) for a in rng.choice(persons, size=b, replace=False)]
            qv = rng.normal(size=(b, GRAPH_RANK_DIMS)).astype(np.float32)
            with graph_mode("on"), Capture("_traverse_rank") as cap:
                plane.traverse_rank(anchors, hops, qv, GRAPH_RANK_K, idx)  # the snapshot
                d0 = plane.dispatches
                t = time.perf_counter()
                for _ in range(reps):
                    got = plane.traverse_rank(anchors, hops, qv, GRAPH_RANK_K, idx)
                wall_ms = (time.perf_counter() - t) * 1e3 / reps
                if got is None or plane.dispatches - d0 != reps:
                    raise AssertionError(f"traverse_rank stepped down: {plane.counts}")
                event_ms = cap.event_ms(reps)
                args, kernels = cap.args, {}
                split = device_split(lambda: cap.real(*args), iters=3, launches=kernels)
            t = time.perf_counter()
            host = plane.traverse_rank_host(anchors, hops, qv, GRAPH_RANK_K, idx)
            host_ms = (time.perf_counter() - t) * 1e3
            for g, h in zip(got, host):
                if not hits_agree(g, h, TOPK_SCORE_ATOL):
                    raise AssertionError(f"traverse_rank {g} differs from the host's {h}")
            run = {"hops": len(hops), "b": b, "f1": int(cap.args[-3]), "f2": int(cap.args[-2]),
                   "kp": int(cap.args[-1]), "event_ms": event_ms, "wall_ms": wall_ms,
                   "device_ms": sum(split.values()), "kernels": sum(kernels.values()),
                   "host_ms": host_ms,
                   "ids_equal": sum([i for i, _ in g] == [i for i, _ in h]
                                    for g, h in zip(got, host))}
            out["runs"].append(run)
            log(f"  traverse_rank {len(hops)} hop(s) B={b} (frontier {run['f1']} x "
                f"{max(run['f2'], 1)}, k {GRAPH_RANK_K}): event {event_ms:.4f} ms, device "
                f"{run['device_ms']:.4f} ms in {run['kernels']:.0f} kernels, wall "
                f"{wall_ms:.3f} ms against the host version's {host_ms:.3f} ms; rows agree "
                f"({run['ids_equal']} of {b} with the same ids in the same order) ({card})")
    log(f"cypher (d) traverse_rank: {len(persons)} x {GRAPH_RANK_DIMS} index on the card in "
        f"{index_s:.2f} s; every answer agrees with the host version ({card})")
    return out, idx


def graph_pagerank(dev, ex, spec, idx, card, reps):
    """(d) 6 and 7: a fresh plane's chain, rank and whole-graph snapshots
    against the ``memory_allocated`` delta; PageRank (20 iterations) on the
    card against the host version; degree counts against ``np.bincount``;
    the snapshot cached."""
    from nornicdb_tpu_torch.ops.graph import (
        _pagerank_host,
        pagerank_arrays,
        pagerank_engine,
        pagerank_torch,
    )
    from nornicdb_tpu_torch.query.device_graph import DeviceGraphPlane

    plane = DeviceGraphPlane(ex.columnar, dev)
    with graph_mode("on"):
        before = device_memory()
        t = time.perf_counter()
        plane._chain_snapshot(spec)
        plane._rank_snapshot(GRAPH_HOPS, idx)
        snap_s = time.perf_counter() - t
        t = time.perf_counter()
        snap = plane.pagerank_snapshot()
        pr_snap_s = time.perf_counter() - t
        delta = device_memory() - before
    stats = plane.resource_stats()
    if len(plane._snaps) != 3 or abs(stats["device_bytes"] - delta) > GRAPH_MEM_SLACK:
        raise AssertionError(f"the plane's {len(plane._snaps)} snapshots state "
                             f"{stats['device_bytes']} device bytes, memory_allocated moved "
                             f"{delta}")
    src, dst, n = snap["src"], snap["dst"], len(snap["ids"])
    got = pagerank_arrays(src, dst, n, dev_src=snap["dev_src"], dev_dst=snap["dev_dst"])
    t = time.perf_counter()
    host = _pagerank_host(src, dst, n, 20, 0.85)
    host_ms = (time.perf_counter() - t) * 1e3
    err = np.abs(got.astype(np.float64) - host)
    if not np.all(err <= PAGERANK_ATOL + PAGERANK_RTOL * np.abs(host)):
        raise AssertionError(f"PageRank on the card differs from the host version by "
                             f"{err.max():.3g}")
    dev_ms = time_ms(lambda: pagerank_torch(snap["dev_src"], snap["dev_dst"], n, 20, 0.85),
                     iters=reps, warmup=1)
    pr_kernels = {}
    pr_split = device_split(lambda: pagerank_torch(snap["dev_src"], snap["dev_dst"], n, 20,
                                                   0.85), iters=2, launches=pr_kernels)
    out_d, in_d = plane.degree_counts()
    if not (np.array_equal(out_d, np.bincount(src, minlength=n))
            and np.array_equal(in_d, np.bincount(dst, minlength=n))):
        raise AssertionError("degree counts differ from np.bincount")
    # the engine's top score, from the cached snapshot (CUDA's float
    # index_add_ may add in another order on each call)
    ranked = pagerank_engine(ex.columnar.storage, plane=plane)
    top = float(got.max())
    if plane.pagerank_snapshot() is not snap \
            or abs(ranked[0][1] - top) > PAGERANK_ATOL + PAGERANK_RTOL * top:
        raise AssertionError("the PageRank snapshot was rebuilt, or the engine ranks otherwise")
    out = {"snapshots": {k[0]: int(s["device_bytes"]) for k, s in plane._snaps.items()},
           "device_bytes": stats["device_bytes"], "memory_allocated_delta": delta,
           "chain_rank_snapshots_s": snap_s, "pagerank_snapshot_s": pr_snap_s,
           "nodes": n, "edges": int(len(src)), "pagerank_device_ms": dev_ms,
           "pagerank_host_ms": host_ms, "pagerank_max_err": float(err.max()),
           "pagerank_device_split": pr_split, "pagerank_kernels": sum(pr_kernels.values())}
    log(f"cypher (d) PageRank: {n} nodes, {len(src)} edges, 20 iterations: card {dev_ms:.4f} "
        f"event ms ({out['pagerank_kernels']:.0f} kernels, device ms by kernel "
        f"{json.dumps({k: round(v, 4) for k, v in pr_split.items()})}) against the host "
        f"version's {host_ms:.2f} ms, max |err| {err.max():.3g}; "
        f"degree counts equal np.bincount; the snapshot cached (built in {pr_snap_s:.2f} s); "
        f"snapshots {out['snapshots']}: {stats['device_bytes']} device bytes, memory_allocated "
        f"+{delta} ({card})")
    return out


def phase_graph_plane(dev, seed, eng, ex, shapes, card, reps):
    """Phase 7 (d) (module docstring): the device graph plane on (a)'s
    graph."""
    t0 = time.perf_counter()
    out = {}
    out["chain"], spec = graph_chain(ex, shapes, card, reps)
    out["strip_gram"] = graph_strip_gram(dev, eng, ex, shapes, card, reps)
    out["rank"], idx = graph_rank(dev, ex, card, reps, seed)
    out["pagerank"] = graph_pagerank(dev, ex, spec, idx, card, reps)
    out["counts"] = dict(ex.device_graph.counts)
    out["dispatches"] = ex.device_graph.dispatches
    out["total_s"] = time.perf_counter() - t0
    log(f"cypher (d): the plane's counts {out['counts']}, {out['dispatches']} dispatches; "
        f"{out['total_s']:.1f} s ({card})")
    return out


def cypher_graph_vector_search(db, svc, qvs, mid_of, card):
    """(d) 5: ``DB.graph_vector_search`` on (b)'s DB, 1 and 2
    ``RELATES_TO`` hops from 32 anchors, against the host version."""
    plane, cat = db.executor.device_graph, db.executor.columnar
    id_of = {m: nid for nid, m in mid_of.items()}
    anchors = [id_of[(i * 251) % len(id_of)] for i in range(GRAPH_GVS_ANCHORS)]
    d0 = plane.dispatches
    lat = {1: [], 2: []}
    for hops in (["RELATES_TO"], ["RELATES_TO", "RELATES_TO"]):
        for i, a in enumerate(anchors):
            qv = qvs[i % len(qvs)]
            t = time.perf_counter()
            got = db.graph_vector_search(a, hops, qv, k=10)
            lat[len(hops)].append((time.perf_counter() - t) * 1e3)
            nodes = cat.nodes()
            want = [(nodes[r].id, s) for r, s in plane.traverse_rank_host(
                [cat.node_row(a)], [(h, "out") for h in hops],
                np.asarray([qv], np.float32), 10, svc.vectors)[0]]
            if not got or not hits_agree(got, want, TOPK_SCORE_ATOL):
                raise AssertionError(f"graph_vector_search from {a} over {hops}: {got} "
                                     f"against the host version's {want}")
    out = {"anchors": len(anchors), "dispatches": plane.dispatches - d0,
           **{f"hops{h}": latency_summary(v) for h, v in lat.items()}}
    if out["dispatches"] != 2 * len(anchors):
        raise AssertionError(f"{2 * len(anchors)} searches made {out['dispatches']} dispatches")
    log(f"  graph_vector_search: {len(anchors)} anchors x 1 and 2 hops, {out['dispatches']} "
        f"dispatches, p50 {out['hops1']['p50_ms']:.3f} / {out['hops2']['p50_ms']:.3f} ms; "
        f"answers agree with the host version ({card})")
    return out


# -- phase 7 (e): APOC, strict mode, rerank and similar ------------------------

APOC_PHASE_S = 45.0  # (e)'s budget in the late rule
APOC_SIMILAR = 64  # stored nodes asked for their 10 nearest
APOC_RECALLS = 64  # hybrid recalls with the reranker, and the same without it
APOC_REPS = 3  # timed repetitions and strict-corpus repeats; a late run takes 1
APOC_PERIODIC_BATCH = 1000
APOC_STAMP = 7
RERANK_ATOL = 1e-6
PERIODIC = ("CALL apoc.periodic.iterate('MATCH (m:Memory) RETURN m', 'SET m.touched = $stamp', "
            "{batchSize: $batch, params: {stamp: $stamp}}) "
            "YIELD batches, total, committedOperations, failedOperations "
            "RETURN batches, total, committedOperations, failedOperations")
TOUCHED_CHAIN = ("MATCH (a:Memory {mid: $m})-[:RELATES_TO]->(b:Memory)-[:RELATES_TO]->(c:Memory) "
                 "RETURN count(DISTINCT c), min(c.touched), max(c.touched)")

# (e)'s kernel launches over its three parts, counted apart from the
# paths they run inside
APOC_LAUNCHES = {"flash_attention": 0, "cosine_topk": 0}


@contextlib.contextmanager
def apoc_window():
    """Counts set to 0 just before the block and read just after, into
    the yielded dict and ``APOC_LAUNCHES``; the enclosing path's counts
    are put back after it."""
    from nornicdb_tpu_torch.ops.attention import flash_attention
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk

    saved, sizes = read_counts(), dict(fused_cosine_topk.launch_sizes)
    reset_counts()
    got = {}
    try:
        yield got
    finally:
        got.update(read_counts())
        for name, n in got.items():
            APOC_LAUNCHES[name] += n
        flash_attention.launches = saved["flash_attention"]
        fused_cosine_topk.launches = saved["cosine_topk"]
        fused_cosine_topk.launch_sizes.clear()
        fused_cosine_topk.launch_sizes.update(sizes)


def apoc_pagerank(dev, ex, card, reps):
    """(e) on (a)'s graph: ``CALL apoc.algo.pageRank()`` through (a)'s
    executor; every node once, scores against the host version, the
    plane's snapshot built at most once, wall split into PageRank and
    row materialisation."""
    from nornicdb_tpu_torch.ops import graph as tgraph

    t0 = time.perf_counter()
    plane = ex.device_graph
    built0 = plane.counts.get("snapshot_built", 0)
    cache_on, ex.enable_query_cache = ex.enable_query_cache, False
    timer = PartTimer({"pagerank": (tgraph, "pagerank_engine")})
    walls, pr_ms = [], []
    try:
        with apoc_window() as launches:
            for _ in range(1 + reps):
                before = timer.ms["pagerank"]
                t = time.perf_counter()
                rows = ex.execute("CALL apoc.algo.pageRank() YIELD node, score").rows
                walls.append((time.perf_counter() - t) * 1e3)
                pr_ms.append(timer.ms["pagerank"] - before)
    finally:
        timer.close()
        ex.enable_query_cache = cache_on
    builds = plane.counts.get("snapshot_built", 0) - built0
    snap = plane._get_snap(("pagerank",))
    if snap is None or snap["dev_src"].device.type != dev.type or builds > 1:
        raise AssertionError(f"PageRank snapshot: {builds} builds, cached "
                             f"{snap is not None}, on the card {snap and snap['dev_src'].device}")
    n = len(snap["ids"])
    host = dict(zip(snap["ids"], tgraph._pagerank_host(snap["src"], snap["dst"], n, 20, 0.85)))
    ids = [r[0].id for r in rows]
    if len(ids) != n or n != ex.storage.count_nodes() or set(ids) != host.keys():
        raise AssertionError(f"apoc.algo.pageRank answered {len(ids)} rows "
                             f"({len(set(ids))} nodes) for {n} nodes")
    got = np.asarray([r[1] for r in rows], np.float64)
    want = np.asarray([host[i] for i in ids])
    err = np.abs(got - want)
    if not np.all(err <= PAGERANK_ATOL + PAGERANK_RTOL * np.abs(want)):
        raise AssertionError(f"apoc.algo.pageRank differs from the host version by {err.max():.3g}")
    # descending, wherever two scores differ by more than the tolerance
    if not np.all(got[:-1] >= got[1:] - (PAGERANK_ATOL + PAGERANK_RTOL * np.abs(got[1:]))):
        raise AssertionError("apoc.algo.pageRank rows are not in score order")
    steady = walls[1:]
    steady_pr = pr_ms[1:]
    out = {"nodes": n, "edges": int(len(snap["src"])), "snapshot_builds": builds,
           "first_wall_ms": walls[0], "first_pagerank_ms": pr_ms[0],
           "wall_ms": float(np.median(steady)), "pagerank_ms": float(np.median(steady_pr)),
           "rows_ms": float(np.median(np.subtract(steady, steady_pr))),
           "max_err": float(err.max()), "launches": dict(launches),
           "s": time.perf_counter() - t0}
    log(f"cypher (e) apoc.algo.pageRank: {n} rows, every node once, max |err| "
        f"{err.max():.3g} against the host version; snapshot builds {builds} (then reused); "
        f"wall {out['wall_ms']:.1f} ms = PageRank {out['pagerank_ms']:.1f} + rows "
        f"{out['rows_ms']:.1f} (first call {walls[0]:.1f} ms, PageRank {pr_ms[0]:.1f}) ({card})")
    return out


def rerank_formula(query, cands, qv, alpha):
    """``LocalReranker``'s scores recomputed in numpy: ``alpha`` x cosine
    (the candidate's vector score without its own embedding) + the rest x
    the share of query terms in its properties."""
    import re

    def terms(text):
        return set(re.findall(r"[a-z0-9]+", text.lower()))

    q = terms(query)
    lex = np.zeros(len(cands), np.float32)
    for i, c in enumerate(cands):
        t = terms(" ".join(str(v) for v in (c.get("properties") or {}).values()))
        if q and t:
            lex[i] = len(q & t) / len(q)
    cos = np.zeros(len(cands), np.float32)
    if qv is not None:
        for i, c in enumerate(cands):
            cos[i] = float(c.get("vector_score") or 0.0)
    return alpha * cos + (1.0 - alpha) * lex


def apoc_similar_rerank(db, svc, docs, queries, mid_of, card, reps):
    """(e) on (b)'s DB: ``similar`` against B1's plain top-k, and hybrid
    recalls with ``LocalReranker`` against its formula and against the
    same recalls without it."""
    from nornicdb_tpu_torch.search.rerank import LocalReranker

    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    node_ids = sorted(mid_of)
    pick = [node_ids[int(i)] for i in rng.choice(len(node_ids), APOC_SIMILAR, replace=False)]
    embs = [list(db.storage.get_node(nid).embedding) for nid in pick]
    lat = []
    with apoc_window() as sim_launches:
        answers = [svc.similar(nid, 10) for nid in pick]
        for _ in range(reps):
            for nid in pick:
                t = time.perf_counter()
                svc.similar(nid, 10)
                lat.append((time.perf_counter() - t) * 1e3)
    if sim_launches["cosine_topk"] < APOC_SIMILAR:
        raise AssertionError(f"similar launched B1 {sim_launches['cosine_topk']} times for "
                             f"{APOC_SIMILAR} nodes")
    for nid, got, want in zip(pick, answers, plain_vector_hits(svc, embs, 11, mid_of)):
        want = [(m, s) for m, s in want if m != mid_of[nid]][:10]
        got = [(mid_of[h["id"]], h["score"]) for h in got]
        if len(got) != 10 or mid_of[nid] in {m for m, _ in got} \
                or not hits_agree(got, want, TOPK_SCORE_ATOL):
            raise AssertionError(f"similar({nid}) {got} differs from the plain top-k {want}")
    out = {"similar": {**latency_summary(lat), "launches": dict(sim_launches),
                       "s": time.perf_counter() - t0}}
    t0 = time.perf_counter()

    class Recording:
        def __init__(self, inner):
            self.inner, self.calls = inner, []

        def rerank(self, query, candidates, query_embedding=None, limit=None):
            self.calls.append((query, candidates, query_embedding))
            return self.inner.rerank(query, candidates, query_embedding=query_embedding,
                                     limit=limit)

    # texts the embedder has not cached, so each recall embeds through B2
    texts = [f"{q} {docs[int(i)].split()[0]}"
             for q, i in zip(queries, rng.integers(0, len(docs), len(queries)))][:APOC_RECALLS]
    reranker = Recording(LocalReranker(db._embedder))
    lat = {"reranked": [], "plain": []}
    with apoc_window() as rr_launches:
        for arm in ("reranked", "plain"):
            with db._embedder._lock:  # both arms embed their texts through B2
                db._embedder._cache.clear()
            svc.reranker = reranker if arm == "reranked" else None
            try:
                results = []
                for text in texts:
                    t = time.perf_counter()
                    results.append(db.recall(text, limit=10))
                    lat[arm].append((time.perf_counter() - t) * 1e3)
            finally:
                svc.reranker = None
            if arm == "reranked":
                reranked, counts = results, read_counts()
    if counts["flash_attention"] < 1 or counts["cosine_topk"] < 1:
        raise AssertionError(f"reranked recalls launched {counts}")
    if len(reranker.calls) != len(texts):
        raise AssertionError(f"the reranker ran {len(reranker.calls)} times for {len(texts)}")
    for hits, (query, cands, qv) in zip(reranked, reranker.calls):
        scores = rerank_formula(query, cands, qv, reranker.inner.alpha)
        order = np.argsort(-scores)[:10]
        want = [(cands[int(i)]["id"], float(scores[int(i)])) for i in order]
        if len(cands) <= 10 or [h["id"] for h in hits] != [i for i, _ in want] or any(
                abs(h["rerank_score"] - s) > RERANK_ATOL for h, (_, s) in zip(hits, want)):
            raise AssertionError(f"reranked recall of {query!r} differs from the formula")
    out["rerank"] = {"reranked": latency_summary(lat["reranked"]),
                     "plain": latency_summary(lat["plain"]),
                     "candidates_mean": float(np.mean([len(c) for _, c, _ in reranker.calls])),
                     "launches": dict(rr_launches), "s": time.perf_counter() - t0}
    s, r = out["similar"], out["rerank"]
    log(f"cypher (e) similar: {APOC_SIMILAR} nodes, ids tie-aware and scores within "
        f"{TOPK_SCORE_ATOL} of B1's plain top-k; p50 {s['p50_ms']:.3f} ms, p99 "
        f"{s['p99_ms']:.3f} ms; B1 launches {sim_launches['cosine_topk']} ({card})")
    log(f"cypher (e) reranked recall: {len(texts)} hybrid recalls, order and rerank_score "
        f"equal the formula within {RERANK_ATOL} over {r['candidates_mean']:.1f} candidates "
        f"each; p50 {r['reranked']['p50_ms']:.3f} / p99 {r['reranked']['p99_ms']:.3f} ms "
        f"against {r['plain']['p50_ms']:.3f} / {r['plain']['p99_ms']:.3f} ms without the "
        f"reranker; launches {rr_launches} ({card})")
    return out


def apoc_strict(db, queries, qvs, mid_of, card, reps):
    """(e): (b)'s read shapes under ``parser_mode="strict"``, rows equal
    to the fast mode's, alternating per query."""
    t0 = time.perf_counter()
    ex = db.executor
    corpus = ([("graphrag", GRAPHRAG, {"v": qv}) for qv in qvs]
              + [("fulltext", FULLTEXT, {"q": q}) for q in queries]
              + [("two_hop", TWO_HOP, {"m": (i * 127) % len(mid_of)})
                 for i in range(len(queries))])
    lat = {mode: {shape: [] for shape in ("graphrag", "fulltext", "two_hop")}
           for mode in ("fast", "strict")}
    cache_on, ex.enable_query_cache = ex.enable_query_cache, False
    try:
        with apoc_window() as launches:
            for _ in range(reps):
                for shape, q, params in corpus:
                    rows = {}
                    for mode in ("fast", "strict"):
                        ex.parser_mode = mode
                        t = time.perf_counter()
                        rows[mode] = ex.execute(q, params).rows
                        lat[mode][shape].append((time.perf_counter() - t) * 1e3)
                    if rows["strict"] != rows["fast"] or not rows["fast"]:
                        raise AssertionError(f"{shape} rows under strict mode differ")
    finally:
        ex.parser_mode = "fast"
        ex.enable_query_cache = cache_on
    added = {shape: float(np.mean(lat["strict"][shape]) - np.mean(lat["fast"][shape]))
             for shape in lat["fast"]}
    out = {"queries": len(corpus) * reps, "added_ms": added,
           "added_ms_mean": float(np.mean(list(added.values()))),
           "fast": {k: latency_summary(v) for k, v in lat["fast"].items()},
           "strict": {k: latency_summary(v) for k, v in lat["strict"].items()},
           "launches": dict(launches), "s": time.perf_counter() - t0}
    log(f"cypher (e) strict: {out['queries']} queries of 3 shapes, rows equal the fast mode's; "
        f"added ms per query {json.dumps({k: round(v, 4) for k, v in added.items()})} ({card})")
    return out


def apoc_writes(db, mid_of, card):
    """(e): a trigger fires on one write and is removed;
    ``apoc.periodic.iterate`` sets a property on every memory in batches,
    and a chain read afterwards answers from a fresh snapshot."""
    from nornicdb_tpu_torch.query.executor import CypherExecutor

    t0 = time.perf_counter()
    ex = db.executor
    stamped = "MATCH (m:Memory) WHERE m.mid < 4 RETURN m.mid, m.stamped ORDER BY m.mid"
    with apoc_window() as launches:
        db.cypher("CALL apoc.trigger.add('stamp', 'MATCH (m:Memory) WHERE m.mid < 4 "
                  "SET m.stamped = coalesce(m.stamped, 0) + 1', {})")
        db.cypher("CREATE (:_Probe {n: 1})")  # exempt from the embed queue
        fired = db.cypher(stamped).rows
        db.cypher("CALL apoc.trigger.remove('stamp')")
        db.cypher("MATCH (p:_Probe) DELETE p")
        after = db.cypher(stamped).rows
        if fired != [[i, 1] for i in range(4)] or after != fired or ex.triggers.triggers:
            raise AssertionError(f"the trigger stamped {fired}, then {after}")
        version0 = ex.columnar.version
        t = time.perf_counter()
        res = db.cypher(PERIODIC, {"batch": APOC_PERIODIC_BATCH, "stamp": APOC_STAMP}).rows
        periodic_s = time.perf_counter() - t
        n = len(mid_of)
        if res != [[-(-n // APOC_PERIODIC_BATCH), n, n, 0]]:
            raise AssertionError(f"apoc.periodic.iterate answered {res} for {n} memories")
        # the live executor's reads against an executor whose catalog is
        # built from the store now
        fresh = CypherExecutor(db.storage, device=db.device)
        fresh.enable_query_cache = False
        for i in range(16):
            m = (i * 389) % n
            rows = db.cypher(TOUCHED_CHAIN, {"m": m}).rows
            if rows != fresh.execute(TOUCHED_CHAIN, {"m": m}).rows or rows[0][1:] != \
                    [APOC_STAMP, APOC_STAMP] or db.cypher(TWO_HOP, {"m": m}).rows != \
                    fresh.execute(TWO_HOP, {"m": m}).rows:
                raise AssertionError(f"the chain read after the periodic writes: {rows}")
        if ex.columnar.version == version0:
            raise AssertionError("the chain read answered from the snapshot before the writes")
        chain_s = time.perf_counter() - t - periodic_s
    out = {"trigger_rows": len(fired), "periodic_s": periodic_s,
           "periodic_ops_per_s": n / periodic_s, "batches": res[0][0], "committed": res[0][2],
           "failed": res[0][3], "chain_reads_s": chain_s, "launches": dict(launches),
           "s": time.perf_counter() - t0}
    log(f"cypher (e) writes: a trigger fired on one write ({len(fired)} memories stamped) and "
        f"was removed; apoc.periodic.iterate set {n} memories in {res[0][0]} batches of "
        f"{APOC_PERIODIC_BATCH} in {periodic_s:.2f} s ({n / periodic_s:.0f}/s), 0 failed; "
        f"chain reads see the writes ({card})")
    return out


def apoc_similar_hnsw(db, svc, n_docs, card):
    """(e) on phase 4's DB: ``similar`` for 64 stored nodes served by HNSW,
    recall@10 against ``exact=True`` (computed after the counts are read)."""
    rng = np.random.default_rng(19)
    pick = [f"d{int(i)}" for i in rng.choice(n_docs, APOC_SIMILAR, replace=False)]
    routes0 = svc.vector_routes["hnsw"]
    lat, answers = [], []
    with apoc_window() as launches:
        for nid in pick:
            t = time.perf_counter()
            answers.append(svc.similar(nid, 10))
            lat.append((time.perf_counter() - t) * 1e3)
    if svc.vector_routes["hnsw"] - routes0 != APOC_SIMILAR or launches["cosine_topk"]:
        raise AssertionError(f"similar took {svc.vector_routes} with launches {launches}")
    hit = 0
    for nid, got in zip(pick, answers):
        emb = db.storage.get_node(nid).embedding
        exact = [i for i, _ in svc.vector_search_candidates(emb, 11, exact=True) if i != nid]
        if nid in {h["id"] for h in got} or len(got) != 10:
            raise AssertionError(f"similar({nid}) answered {len(got)} hits or itself")
        hit += len({h["id"] for h in got} & set(exact[:10]))
    recall = hit / (10 * len(pick))
    out = {**latency_summary(lat), "recall_at_10": recall, "launches": dict(launches)}
    log(f"cypher (e) similar (hnsw): {len(pick)} nodes of {n_docs}, recall@10 {recall:.4f} "
        f"against exact=True; p50 {out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms ({card})")
    if recall < RECALL_MIN:
        raise AssertionError(f"similar's recall@10 {recall:.4f} < {RECALL_MIN}")
    return out


def phase_cypher(dev, seed, card, window_s=LDBC_WINDOW_S, graph_reps=GRAPH_REPS,
                 apoc_reps=APOC_REPS):
    """Phase 7 (module docstring). Returns the kernel launches of parts
    (b) and (c); (e)'s are counted apart (``APOC_LAUNCHES``)."""
    import shutil
    import tempfile

    import nornicdb_tpu_torch as nt
    from nornicdb_tpu_torch.storage.disk import DiskEngine

    out = REPORT["cypher"] = {}
    out["ldbc"], eng, ex, shapes = cypher_ldbc(card, LDBC_PERSONS, LDBC_MESSAGES, LDBC_KNOWS,
                                               window_s)
    out["graph_plane"] = phase_graph_plane(dev, seed, eng, ex, shapes, card, graph_reps)
    apoc = REPORT.setdefault("apoc", {})
    t_apoc = time.perf_counter()
    apoc["pagerank"] = apoc_pagerank(dev, ex, card, apoc_reps)
    apoc_s = time.perf_counter() - t_apoc
    del eng, ex, shapes
    memories = CYPHER_MEMORIES

    rng = np.random.default_rng(seed + 13)
    docs, queries = make_corpus(rng, memories)
    root = os.path.join(HERE, "_durable")
    os.makedirs(root, exist_ok=True)
    d = tempfile.mkdtemp(prefix="cypher-", dir=root)
    try:
        reset_counts()
        db = nt.open(d, device=dev, engine="native")
        if not isinstance(db._base, DiskEngine):
            raise AssertionError(f"engine='native' opened {type(db._base).__name__}")
        svc = db.search  # empty: the embed queue indexes what it embeds
        t = time.perf_counter()
        for lo in range(0, memories, CYPHER_BATCH):
            db.cypher("UNWIND $rows AS r CREATE (:Memory {mid: r.mid, content: r.content})",
                      {"rows": [{"mid": i, "content": docs[i]}
                                for i in range(lo, min(lo + CYPHER_BATCH, memories))]})
        create_s = time.perf_counter() - t
        t = time.perf_counter()
        db.flush()
        flush_s = time.perf_counter() - t
        writes = read_counts()
        targets = rng.integers(1, memories, size=(memories, CYPHER_LINKS))
        pairs = [{"a": a, "b": int((a + off) % memories)}
                 for a in range(memories) for off in targets[a]]
        t = time.perf_counter()
        for lo in range(0, len(pairs), CYPHER_BATCH):
            db.cypher("UNWIND $pairs AS p MATCH (a:Memory {mid: p.a}), (b:Memory {mid: p.b}) "
                      "CREATE (a)-[:RELATES_TO]->(b)", {"pairs": pairs[lo:lo + CYPHER_BATCH]})
        link_s = time.perf_counter() - t
        embedded = (db._embed_queue.embedded_count, db._embed_queue.failed_count)
        if embedded != (memories, 0) or writes["flash_attention"] < 1 \
                or len(svc.vectors) != memories:
            raise AssertionError(f"the embed queue embedded and failed {embedded}, B2 launched "
                                 f"{writes['flash_attention']}, {len(svc.vectors)} indexed")
        if svc.hnsw is not None or svc.stats.strategy != "brute":
            raise AssertionError(f"{memories} vectors took the {svc.stats.strategy} tier")
        n_edges = db.storage.count_edges()
        if n_edges != memories * CYPHER_LINKS:
            raise AssertionError(f"{n_edges} RELATES_TO edges, want {memories * CYPHER_LINKS}")
        b = {"memories": memories, "edges": n_edges, "create_s": create_s,
             "creates_per_s": memories / create_s, "flush_s": flush_s, "link_s": link_s,
             "links_per_s": n_edges / link_s, "write_launches": writes}
        log(f"cypher (b): {memories} memories by UNWIND ... CREATE in {create_s:.2f} s "
            f"({memories / create_s:.0f}/s), flush (the queue embeds them) {flush_s:.2f} s, "
            f"B2 launches {writes['flash_attention']}; {n_edges} RELATES_TO by UNWIND ... "
            f"MATCH ... CREATE in {link_s:.2f} s ({n_edges / link_s:.0f}/s) ({card})")
        mid_of = {row[1].id: row[0] for row in db.cypher(
            "MATCH (m:Memory) RETURN m.mid, m").rows}
        qvs = [list(v) for v in db._embedder.embed_batch(queries)]
        b1_before = read_counts()["cosine_topk"]
        b["reads"], answers = cypher_reads(db, svc, queries, qvs, mid_of, card)
        b1_reads = read_counts()["cosine_topk"] - b1_before
        if b1_reads < len(qvs):
            raise AssertionError(f"B1 launched {b1_reads} times for {len(qvs)} GraphRAG queries")
        b["reads_b1_launches"] = b1_reads
        b["concurrent"] = cypher_concurrent(db, svc, qvs, answers, card)
        b1_before = read_counts()["cosine_topk"]
        b["graph_vector_search"] = cypher_graph_vector_search(db, svc, qvs, mid_of, card)
        if read_counts()["cosine_topk"] != b1_before:
            raise AssertionError("graph_vector_search launched B1")
        m, valid, _, _ = svc.vectors.device_view()
        if tuple(m.shape) != (CYPHER_CAPACITY, 160) or int(valid.sum()) != memories:
            raise AssertionError(f"the vector index is {tuple(m.shape)} with {int(valid.sum())} "
                                 f"valid rows, not the shape phase 3 checked")
        b["b1_timed"] = [time_topk(dev, m, valid, bb, 10, seed, card) for bb in CYPHER_TIMED_B]
        del m, valid
        out["memory_graph"] = b

        # -- (e) APOC, strict mode, rerank and similar on (b)'s DB -----------
        t_apoc = time.perf_counter()
        apoc.update(apoc_similar_rerank(db, svc, docs, queries, mid_of, card, apoc_reps))
        apoc["strict"] = apoc_strict(db, queries, qvs, mid_of, card, apoc_reps)
        apoc["writes"] = apoc_writes(db, mid_of, card)
        apoc["phase7_s"] = apoc_s + time.perf_counter() - t_apoc
        log(f"cypher (e): {apoc['phase7_s']:.1f} s in phase 7; launches so far "
            f"{APOC_LAUNCHES} ({card})")

        # -- (c) temporal values and restart ---------------------------------
        events_s = cypher_events(db, rng)
        db.flush()
        events_before = event_rows(db)
        rag_before = [graphrag_rows(db, qv) for qv in qvs[:CYPHER_RESTART_QUERIES]]
        del svc
        t = time.perf_counter()
        db.close()
        close_s = time.perf_counter() - t
        t = time.perf_counter()
        db = nt.open(d, device=dev, engine="auto")
        open_s = time.perf_counter() - t
        try:
            if not isinstance(db._base, DiskEngine):
                raise AssertionError(f"the dir reopened as {type(db._base).__name__}")
            t = time.perf_counter()
            svc = db.search
            search_open_s = time.perf_counter() - t
            if event_rows(db) != events_before:
                raise AssertionError("temporal values differ after the reopen")
            rag_after = [graphrag_rows(db, qv) for qv in qvs[:CYPHER_RESTART_QUERIES]]
            if rag_after != rag_before:
                raise AssertionError("GraphRAG answers after the reopen differ from before")
            db.flush()
            reembedded = (db._embed_queue.embedded_count, svc.load_stats.get("reindexed"))
            if reembedded != (0, 0):
                raise AssertionError(f"the reopen re-embedded or reindexed: {reembedded}")
            c = {"events": CYPHER_EVENTS, "events_s": events_s, "close_s": close_s,
                 "open_s": open_s, "search_open_s": search_open_s,
                 "graphrag_bitwise": len(rag_after), "reembedded": 0,
                 "multidb": cypher_multidb(db)}
        finally:
            db.close()
        path = read_counts()
        log(f"cypher (c): {CYPHER_EVENTS} events with datetime, date and duration in "
            f"{events_s:.2f} s; close {close_s:.2f} s; reopen {open_s:.3f} s + search open "
            f"{search_open_s:.2f} s; events equal, {len(rag_after)} GraphRAG answers bitwise "
            f"those before the close, 0 re-embedded ({card})")
        out["restart"] = c
        out["launches"] = path
        log(f"cypher path launches: {path}")
        if min(path.values()) < 1:
            raise AssertionError(f"a kernel of the Cypher path never launched: {path}")
        return path
    finally:
        shutil.rmtree(d, ignore_errors=True)


# -- driver ----------------------------------------------------------------


# -- phase 8: quant and tiered ---------------------------------------------

QUANT_MODES = ("int8", "pq")
QUANT_MEM_SLACK = 1 << 20  # a plane's device bytes against the memory_allocated delta
QUANT_SCORE_ATOL = 1e-5  # answered scores are exact float32 cosines (host products)
QUANT_TIMED_B1 = 32  # single-query searches timed on the deployment-scale index
QUANT_B64_REPEATS = 3
TIERED_PART_ROWS = 4096  # NORNICDB_TIERED_PART_ROWS, the reference's default
# NORNICDB_TIERED_NPROBE for the routing pass. The corpus's embeddings
# have no cluster structure for its 24 partitions to follow: at the
# default, 8 (the paging pass reads its recall), recall@10 falls well
# below 0.95; 20 holds it (ROADMAP C24). The paging pass runs at the
# default, whose probes fit the resident half of the slabs.
TIERED_ROUTING_NPROBE = 20


class env_scope:
    """Set ``NORNICDB_*`` switches for a block and restore them after."""

    def __init__(self, **knobs):
        self.knobs = {"NORNICDB_" + k: str(v) for k, v in knobs.items()}
        self.old = {}

    def __enter__(self):
        for k, v in self.knobs.items():
            self.old[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pctl(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def timed_calls(fn, args):
    """Host milliseconds of ``fn(a)`` per ``a`` (card synchronized), and
    the answers."""
    import torch

    lat, out = [], []
    for a in args:
        t = time.perf_counter()
        out.append(fn(a))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    return lat, out


def exact_scores_hold(hits_rows, qvs, brute):
    """Largest gap between an answered score and the exact float32 cosine
    of its row (host product)."""
    qn = qvs / np.linalg.norm(qvs, axis=1, keepdims=True)
    worst = 0.0
    for r, hits in enumerate(hits_rows):
        for eid, s in hits:
            worst = max(worst, abs(s - float(qn[r] @ brute.get(eid))))
    return worst


def quant_plane_block(dev, mode, items, qvs, exact10):
    """One quantized plane over a fresh copy of the main path's rows: the
    build by part, its device bytes against memory_allocated, 64 queries
    one at a time and one batch of 64, recall and exact scores; the
    float32 pair must not go up for a quant-served batch."""
    import torch

    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    brute = BruteForceIndex(device=dev)
    brute.add_batch(items)
    mem0 = device_memory()
    plane = brute.quant_plane()
    if plane is None:
        raise AssertionError(f"{mode}: no quantized plane over {len(brute)} rows")
    t0 = time.perf_counter()
    plane.build()
    build_s = time.perf_counter() - t0
    alloc = device_memory() - mem0
    dev_bytes = plane.device_bytes()
    snap = plane._snap
    lat, hits = timed_calls(lambda q: brute.search_batch(q[None, :], 10)[0], qvs)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    batch = brute.search_batch(qvs, 10)
    torch.cuda.synchronize()
    b64_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) - base
    uploaded = brute._dev_matrix is not None
    counts = dict(plane.counts)
    kernels = {}
    split = device_split(lambda: brute.search_batch(qvs[:1], 10), iters=3, launches=kernels)
    out = {
        "mode": mode, "rows": len(brute), "capacity": snap["capacity"], "dims": snap["dims"],
        "build_s": build_s, "build_split_s": plane.build_s, "device_bytes": dev_bytes,
        "memory_allocated_delta": alloc, "bytes_per_vector": dev_bytes / snap["capacity"],
        "f32_bytes_per_vector": snap["dims"] * 4 + 1, "pool_k10": plane.pool_for(10, snap),
        "p50_ms": pctl(lat, 50), "p99_ms": pctl(lat, 99), "b64_ms": b64_ms,
        "b64_peak_transient_bytes": peak, "counts": counts,
        "b1_device_ms": sum(split.values()), "b1_kernels": sum(kernels.values()),
        "recall_at_10": float(np.mean([recall10(g, w) for g, w in zip(hits, exact10)])),
        "b64_recall_at_10": float(np.mean([recall10(g, w) for g, w in zip(batch, exact10)])),
        "max_score_gap": exact_scores_hold(hits, qvs, brute),
        "f32_uploaded_by_quant_batches": uploaded,
    }
    if mode == "pq":
        out["pq_m"] = snap["pq_m"]
    log(f"quant {mode}: plane over {out['rows']} x {out['dims']} (capacity {out['capacity']}) "
        f"built in {build_s:.3f} s {json.dumps({k: round(v, 3) for k, v in plane.build_s.items()})}"
        f"; {dev_bytes} device bytes against a memory_allocated delta of {alloc}; "
        f"{out['bytes_per_vector']:.2f} B/vector against f32's {out['f32_bytes_per_vector']}; "
        f"64 queries p50 {out['p50_ms']:.3f} p99 {out['p99_ms']:.3f} ms (pool "
        f"{out['pool_k10']}; B 1: {out['b1_kernels']:.0f} kernels, {out['b1_device_ms']:.4f} "
        f"device ms), B 64 {b64_ms:.3f} ms (transient peak {peak} B); recall@10 "
        f"{out['recall_at_10']:.4f} (B 64 {out['b64_recall_at_10']:.4f}), scores within "
        f"{out['max_score_gap']:.2e} of exact; counts {counts}")
    if abs(alloc - dev_bytes) > QUANT_MEM_SLACK:
        raise AssertionError(f"{mode}: device bytes {dev_bytes} vs memory_allocated {alloc}")
    if uploaded:
        raise AssertionError(f"{mode}: a quant-served batch uploaded the float32 matrix")
    if counts.get("dispatch") != len(qvs) + 1 or any(k.startswith("degrade") for k in counts):
        raise AssertionError(f"{mode}: the plane did not serve every batch: {counts}")
    if min(out["recall_at_10"], out["b64_recall_at_10"]) < RECALL_MIN:
        raise AssertionError(f"{mode}: recall@10 {out['recall_at_10']:.4f} < {RECALL_MIN}")
    if out["max_score_gap"] > QUANT_SCORE_ATOL:
        raise AssertionError(f"{mode}: an answered score is {out['max_score_gap']} off exact")
    return brute, out


def fused_rows_timed(fused, qvs, extras):
    """Each query alone through the fused tier: host ms and its row."""
    from nornicdb_tpu_torch.search.microbatch import pow2_bucket

    return timed_calls(lambda i: fused.search_batch(qvs[i:i + 1], pow2_bucket(30),
                                                    extras[i:i + 1])[0], range(len(qvs)))


def hybrid_parity(rows, host):
    """Walk-parity: each fused top 10 against the host hybrid ranking."""
    return float(np.mean([recall10(r["fused"], h) for r, h in zip(rows, host)]))


def quant_fused_block(dev, mode, brute, bm25, qvs, extras, host_hybrid, exact10, walk_min_n):
    """The fused hybrid tier over the plane (walk off), then the cagra
    profile over a quantized graph base, then the fused walk on that
    graph: p50/p99, tiers, walk-parity and recall."""
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_WALK_QUANT, FusedHybrid, quant_tier
    from nornicdb_tpu_torch.search.service import SearchService

    fused = FusedHybrid(bm25, brute, min_n=1, build_inline=True)
    t0 = time.perf_counter()
    fused.build()
    snap_s = time.perf_counter() - t0
    lat, rows = fused_rows_timed(fused, qvs, extras)
    served = {r["served_by"] for r in rows}
    out = {"snapshot_build_s": snap_s, "brute_p50_ms": pctl(lat, 50),
           "brute_p99_ms": pctl(lat, 99), "brute_parity": hybrid_parity(rows, host_hybrid),
           "brute_served": sorted(served)}
    if served != {quant_tier(mode)} or fused.counts["quant_dispatch"] != len(qvs):
        raise AssertionError(f"{mode}: fused queries not all on the quant tier: "
                             f"{dict(fused.counts)}")
    # the cagra profile over a quantized base: the strategy machine's build
    with env_scope(VECTOR_ANN_QUALITY="cagra"):
        prof = SearchService(device=dev, hnsw_threshold=min(10_000, len(brute)))
        prof.vectors = brute
        t0 = time.perf_counter()
        with prof._lock:
            prof._maybe_switch_strategy()
        graph_s = time.perf_counter() - t0
    cg = prof.cagra
    if cg is None or cg._graph["quant"] is None or cg._graph["quant"]["mode"] != mode:
        raise AssertionError(f"{mode}: the cagra profile did not build a quantized base")
    lat_v, vec = timed_calls(lambda q: prof.vector_search_candidates(q, 10), qvs)
    fallbacks = {k: v for k, v in cg.counts.items() if k.startswith("fallback_")}
    walk_kernels = {}
    split = device_split(lambda: cg.search_batch(qvs[:1], 10), iters=3, launches=walk_kernels)
    out.update(graph_build_s=graph_s, graph_build_split_s=cg.build_s,
               graph_device_bytes=cg.device_bytes(), graph_iters=cg._graph["iters"],
               profile_p50_ms=pctl(lat_v, 50), profile_p99_ms=pctl(lat_v, 99),
               profile_recall=float(np.mean([recall10(g, w) for g, w in zip(vec, exact10)])),
               profile_walks=cg.counts["walk"], profile_fallbacks=fallbacks,
               walk_b1_device_ms=sum(split.values()),
               walk_b1_kernels=sum(walk_kernels.values()))
    if cg.counts["walk"] < len(qvs) or fallbacks or out["profile_recall"] < RECALL_MIN:
        raise AssertionError(f"{mode}: cagra profile walks {dict(cg.counts)}, recall "
                             f"{out['profile_recall']:.4f}")
    # the fused walk over the same graph
    fused.walk_min_n = walk_min_n
    fused.rebind_cagra(cg)
    lat_w, rows_w = fused_rows_timed(fused, qvs, extras)
    served = {r["served_by"] for r in rows_w}
    w_kernels = {}
    from nornicdb_tpu_torch.search.microbatch import pow2_bucket

    w_split = device_split(lambda: fused.search_batch(qvs[:1], pow2_bucket(30), extras[:1]),
                           iters=3, launches=w_kernels)
    out.update(walk_p50_ms=pctl(lat_w, 50), walk_p99_ms=pctl(lat_w, 99),
               walk_parity=hybrid_parity(rows_w, host_hybrid), walk_served=sorted(served),
               fused_walk_b1_device_ms=sum(w_split.values()),
               fused_walk_b1_kernels=sum(w_kernels.values()),
               counts=dict(fused.counts))
    log(f"quant {mode} fused: snapshot {snap_s:.3f} s; brute tier p50 {out['brute_p50_ms']:.3f} "
        f"p99 {out['brute_p99_ms']:.3f} ms, walk-parity {out['brute_parity']:.4f}; cagra "
        f"profile graph {graph_s:.3f} s {json.dumps({k: round(v, 3) for k, v in cg.build_s.items()})}"
        f", {out['graph_device_bytes']} device bytes, vector p50 {out['profile_p50_ms']:.3f} "
        f"p99 {out['profile_p99_ms']:.3f} ms, recall@10 {out['profile_recall']:.4f}, one walk "
        f"B 1: {out['walk_b1_kernels']:.0f} kernels, {out['walk_b1_device_ms']:.4f} device ms; "
        f"fused walk p50 {out['walk_p50_ms']:.3f} p99 {out['walk_p99_ms']:.3f} ms, walk-parity "
        f"{out['walk_parity']:.4f}, B 1: {out['fused_walk_b1_kernels']:.0f} kernels, "
        f"{out['fused_walk_b1_device_ms']:.4f} device ms")
    if served != {TIER_WALK_QUANT} or min(out["brute_parity"], out["walk_parity"]) < RECALL_MIN:
        raise AssertionError(f"{mode}: fused walk {sorted(served)}, parity "
                             f"{out['brute_parity']:.4f} / {out['walk_parity']:.4f}")
    return out


COLD_ATOL = 1e-6  # the host products of the plane and of the check
TIERED_HYBRID_SEARCHES = 8  # host-path hybrid searches through the tiered route


def cold_parity(hits, qn, cold, tiered, brute):
    """1.0 when the answer agrees with an exact host scan of the query's
    cold probed partitions: every row there scoring above the k-th answer
    is in the answer, and every answered row from there carries its exact
    score."""
    snap = tiered._snap
    slots = np.concatenate([snap["part_slots"][p] for p in cold])
    rows, alive, ids = brute.rows_for_slots(slots)
    scores = rows @ qn
    exact = {ids[j]: float(scores[j]) for j in range(len(slots)) if alive[j] and ids[j]}
    kth = hits[-1][1]
    got = dict(hits)
    ok = all(e in got for e, s in exact.items() if s > kth + COLD_ATOL)
    ok = ok and all(abs(s - exact[e]) <= COLD_ATOL for e, s in got.items() if e in exact)
    return 1.0 if ok else 0.0


def drain_pager(plane):
    while plane.paging:
        time.sleep(0.002)


def tiered_block(dev, items, bm25, queries, qvs, exact10, embedder):
    """The tiered plane (half the partitions resident) under a service
    whose HNSW threshold lies above the corpus, every request through
    ``vector_search_candidates`` with the query's BM25 top 32. Routing:
    each query once at ``TIERED_ROUTING_NPROBE`` (set by the reference's
    knob), its cold probes scanned exactly on the host (cold parity),
    recall@10. Paging: at the default nprobe, which the resident slabs
    can hold, each query (its recall@10 recorded), the pager drained,
    then the same query again, which the slabs must serve. The pager is
    drained between queries, so no promotion lands while one is in
    flight. Last, hybrid searches on the host path, each query's text
    embedded by the service (B2)."""
    import torch

    from nornicdb_tpu_torch.ops.similarity import l2_normalize
    from nornicdb_tpu_torch.search.service import SearchService
    from nornicdb_tpu_torch.search.tiered_store import TIERED_NPROBE

    n = len(items)
    parts = max(2, min(128, n // TIERED_PART_ROWS))  # the plane's own rule
    with env_scope(VECTOR_TIERED=1, TIERED_INLINE_BUILD=1, TIERED_PART_ROWS=TIERED_PART_ROWS,
                   TIERED_RESIDENT=parts // 2, TIERED_NPROBE=TIERED_ROUTING_NPROBE,
                   HYBRID_FUSED=0):
        svc = SearchService(embedder=embedder, device=dev, hnsw_threshold=n + 1)
        svc.bm25 = bm25
        svc.vectors.add_batch(items)
        mem0 = device_memory()
        plane = svc.vectors.tiered_plane()
        t0 = time.perf_counter()
        plane.build()
        build_s = time.perf_counter() - t0
        alloc = device_memory() - mem0
        snap = plane._snap
        hints = [[d for d, _ in bm25.search(q, 32)] for q in queries]
        # normalized as the plane does it, one query at a time on the card
        qn = np.concatenate([l2_normalize(torch.from_numpy(qvs[i:i + 1]).to(dev)).cpu().numpy()
                             for i in range(len(qvs))])

        def ask(i):
            scans = plane.cold_scans
            t = time.perf_counter()
            hits = svc.vector_search_candidates(qvs[i], 30, lexical_doc_ids=hints[i])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            cold = plane.cold_scans - scans
            drain_pager(plane)
            return hits, ms, cold

        routing_ms, parities, recall, unscanned = [], [], [], 0
        for i in range(len(qvs)):
            probes = plane.route(qn[i:i + 1], snap, [hints[i]])[0]
            cold = [int(p) for p in probes if int(p) not in snap["resident"]]
            hits, ms, scanned = ask(i)
            routing_ms.append(ms)
            recall.append(recall10(hits, exact10[i]))
            if cold:
                unscanned += scanned != 1
                parities.append(cold_parity(hits, qn[i], cold, plane, svc.vectors))
        # the paging pass at the default, set on the plane: a second plane
        # would train its PQ codebooks again on the host
        plane.nprobe = TIERED_NPROBE
        first_ms, again_ms, paging_recall, cold_first, slab_served = [], [], [], 0, 0
        for i in range(len(qvs)):
            hits, ms, scanned = ask(i)
            first_ms.append(ms)
            paging_recall.append(recall10(hits, exact10[i]))
            cold_first += scanned
            _, ms, scanned = ask(i)
            again_ms.append(ms)
            slab_served += scanned == 0
        routes0 = svc.vector_routes["tiered_route"]
        for q in queries[:TIERED_HYBRID_SEARCHES]:
            svc.search(q, limit=10, mode="hybrid", enrich=False)
            drain_pager(plane)
        hybrid_routes = svc.vector_routes["tiered_route"] - routes0
        stats = plane.resource_stats_extra()
        out = {"rows": n, "partitions": snap["parts"], "resident": snap["r_slabs"],
               "slab_rows": snap["slab_rows"], "pq_m": snap["pq_m"],
               "nprobe": TIERED_ROUTING_NPROBE,
               "build_s": build_s, "build_split_s": plane.build_s,
               "device_bytes": snap["device_bytes"], "memory_allocated_delta": alloc,
               "disk_bytes": stats["disk_bytes"], "capacity_ratio": stats["tiered_capacity_ratio"],
               "promotions": plane.promotions, "evictions": plane.evictions,
               "cold_scans": plane.cold_scans, "cold_queries": len(parities),
               "cold_parity": float(np.mean(parities)) if parities else None,
               "cold_probes_unscanned": unscanned, "recall_at_10": float(np.mean(recall)),
               "routing_p50_ms": pctl(routing_ms, 50), "routing_p99_ms": pctl(routing_ms, 99),
               "paging_nprobe": TIERED_NPROBE, "paging_cold_queries": cold_first,
               "paging_recall_at_10": float(np.mean(paging_recall)),
               "slab_served_after_promotion": slab_served,
               "paging_first_p50_ms": pctl(first_ms, 50), "paging_first_p99_ms": pctl(first_ms, 99),
               "paging_again_p50_ms": pctl(again_ms, 50), "paging_again_p99_ms": pctl(again_ms, 99),
               "routes": dict(svc.vector_routes), "hybrid_tiered_routes": hybrid_routes,
               "counts": dict(plane.counts), "pool_k30": plane.pool_for(30, snap),
               "f32_uploaded": svc.vectors._dev_matrix is not None}
        plane.close()
    log(f"tiered: {out['partitions']} partitions ({out['resident']} resident slabs of "
        f"{out['slab_rows']}) over {n} rows built in {build_s:.3f} s "
        f"{json.dumps({k: round(v, 3) for k, v in out['build_split_s'].items()})}; "
        f"{out['device_bytes']} device bytes against a memory_allocated delta of {alloc}; "
        f"{out['disk_bytes']} bytes on disk. Routing at nprobe {out['nprobe']}: {len(parities)} "
        f"of {len(qvs)} queries probed cold partitions, cold parity {out['cold_parity']}, "
        f"recall@10 {out['recall_at_10']:.4f}, p50 {out['routing_p50_ms']:.3f} p99 "
        f"{out['routing_p99_ms']:.3f} ms. Paging at nprobe {TIERED_NPROBE}: recall@10 "
        f"{out['paging_recall_at_10']:.4f}, "
        f"{cold_first} queries scanned cold partitions, then {slab_served} served from the "
        f"slabs when asked again; p50 {out['paging_first_p50_ms']:.3f} p99 "
        f"{out['paging_first_p99_ms']:.3f} ms, again {out['paging_again_p50_ms']:.3f} / "
        f"{out['paging_again_p99_ms']:.3f} ms; {out['promotions']} promotions, "
        f"{out['evictions']} evictions; routes {out['routes']} ({hybrid_routes} from hybrid "
        f"host-path searches); counts {out['counts']}")
    if abs(alloc - out["device_bytes"]) > QUANT_MEM_SLACK:
        raise AssertionError(f"tiered: device bytes {out['device_bytes']} vs {alloc}")
    if out["routes"].get("tiered_route") != 3 * len(qvs) + TIERED_HYBRID_SEARCHES \
            or hybrid_routes != TIERED_HYBRID_SEARCHES:
        raise AssertionError(f"tiered: not every request took the tiered route: {out['routes']}")
    if not parities or out["cold_parity"] != 1.0 or unscanned:
        raise AssertionError(f"tiered: cold parity {out['cold_parity']} over {len(parities)} "
                             f"queries, {unscanned} cold probes unscanned")
    if not cold_first or slab_served != len(qvs):
        raise AssertionError(f"tiered: {slab_served} of {len(qvs)} re-asked queries served "
                             f"from the slabs after the pager ({cold_first} scanned cold)")
    if out["recall_at_10"] < RECALL_MIN or out["f32_uploaded"]:
        raise AssertionError(f"tiered: recall@10 {out['recall_at_10']:.4f}, f32 uploaded "
                             f"{out['f32_uploaded']}")
    return out


def phase_quant_tiered(dev, corpus, bm25):
    """Phase 8 (a): the quantized planes, the quantized fused tiers and
    graph base, and the tiered plane over the main path's corpus (module
    docstring). Returns its kernel launches: the counts are set to 0
    after the queries are embedded and the exact answers computed, so
    they hold only what the paths launch, and each must be what those
    paths do: B1 only in the two graph builds' k-NN (one launch per
    1,024 rows), B2 only in the tiered block's host-path hybrid searches
    (one launch per encoder layer)."""
    import torch

    from nornicdb_tpu_torch.models.checkpoint import load_default_embedder
    from nornicdb_tpu_torch.search.bm25 import tokenize
    from nornicdb_tpu_torch.search.rrf import rrf_fuse
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    t_phase = time.perf_counter()
    docs, queries, emb = corpus
    n = len(emb)
    items = [(f"d{i}", emb[i]) for i in range(n)]
    embedder = load_default_embedder(dev)
    qvs = np.asarray(embedder.embed_batch(queries), np.float32)
    ref = BruteForceIndex(device=dev)
    ref.add_batch(items)
    exact10 = ref.search_batch(qvs, 10, exact=True)
    exact30 = ref.search_batch(qvs, 30, exact=True)
    del ref
    lex30 = [bm25.search(q, 30) for q in queries]
    host_hybrid = [rrf_fuse([lx, vx], limit=30) if lx else vx
                   for lx, vx in zip(lex30, exact30)]
    extras = [{"tokens": tuple(tokenize(q)), "n_cand": 30, "w": (1.0, 1.0)} for q in queries]
    walk_min_n = min(100_000, max(n // 2, 1))
    out = {"queries": len(qvs), "rows": n}
    reset_counts()
    for mode in QUANT_MODES:
        with env_scope(VECTOR_QUANT=mode, QUANT_INLINE_BUILD=1):
            brute, plane_out = quant_plane_block(dev, mode, items, qvs, exact10)
            plane_out["fused"] = quant_fused_block(dev, mode, brute, bm25, qvs, extras,
                                                   host_hybrid, exact10, walk_min_n)
        out[mode] = plane_out
        del brute
        torch.cuda.empty_cache()
    out["tiered"] = tiered_block(dev, items, bm25, queries, qvs, exact10, embedder)
    launches = read_counts()
    expected = {"flash_attention": TIERED_HYBRID_SEARCHES * embedder.cfg.num_layers,
                "cosine_topk": len(QUANT_MODES) * -(-n // 1024)}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    REPORT["quant_tiered"] = out
    log(f"quant and tiered: the phase took {out['phase_s']:.2f} s; launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"phase 8 (a) launched {launches}, its paths launch {expected}")
    return launches


def phase_quant_index(dev, idx, seed):
    """Phase 8 (b): the int8 plane over phase 5's deployment-scale index:
    build, bytes per vector, the transient peak of a B 64 batch, p50 at
    B 1 and B 64, recall@10 against B1 (module docstring). The int8
    path launches neither kernel (its coarse scan is a matmul): the
    counts, set to 0 after the exact answers, must stay 0."""
    import torch

    rng = np.random.default_rng(seed + 8)
    d = idx.dims
    qs = (rng.random((64, d), dtype=np.float32) - 0.5).astype(np.float32)
    exact = idx.search_batch(qs, 10, exact=True)
    reset_counts()
    with env_scope(VECTOR_QUANT="int8", QUANT_INLINE_BUILD=1):
        mem0 = device_memory()
        plane = idx.quant_plane()
        t0 = time.perf_counter()
        plane.build()
        build_s = time.perf_counter() - t0
        alloc = device_memory() - mem0
        lat1, hits1 = timed_calls(lambda q: idx.search_batch(q[None, :], 10)[0],
                                  qs[:QUANT_TIMED_B1])
        base = torch.cuda.memory_allocated(dev)
        lat64 = []
        for _ in range(QUANT_B64_REPEATS):
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            batch = idx.search_batch(qs, 10)
            torch.cuda.synchronize()
            lat64.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) - base
        counts = dict(plane.counts)
        kernels = {}
        split = device_split(lambda: idx.search_batch(qs[:1], 10), iters=3, launches=kernels)
        launches = read_counts()
    snap = plane._snap
    out = {"rows": len(idx), "dims": d, "capacity": snap["capacity"], "build_s": build_s,
           "build_split_s": plane.build_s, "device_bytes": plane.device_bytes(),
           "memory_allocated_delta": alloc,
           "bytes_per_vector": plane.device_bytes() / snap["capacity"],
           "f32_bytes_per_vector": d * 4 + 1, "b1_p50_ms": pctl(lat1, 50),
           "b1_p99_ms": pctl(lat1, 99), "b64_ms": lat64, "b64_p50_ms": pctl(lat64, 50),
           "b64_peak_transient_bytes": peak, "counts": counts,
           "b1_device_ms": sum(split.values()), "b1_kernels": sum(kernels.values()),
           "b1_device_split_ms": split,
           "recall_at_10": float(np.mean([recall10(g, w) for g, w in zip(batch, exact)])),
           "b1_recall_at_10": float(np.mean([recall10(g, w)
                                             for g, w in zip(hits1, exact[:QUANT_TIMED_B1])])),
           "launches": launches}
    idx._quant = None
    del plane, snap
    torch.cuda.empty_cache()
    REPORT["quant_index"] = out
    log(f"quant index: int8 plane over {out['rows']} x {d} built in {build_s:.3f} s "
        f"{json.dumps({k: round(v, 3) for k, v in out['build_split_s'].items()})}; "
        f"{out['device_bytes']} device bytes against a memory_allocated delta of {alloc}; "
        f"{out['bytes_per_vector']:.2f} B/vector against f32's {out['f32_bytes_per_vector']}; "
        f"B 1 p50 {out['b1_p50_ms']:.3f} p99 {out['b1_p99_ms']:.3f} ms ({out['b1_kernels']:.0f} "
        f"kernels, {out['b1_device_ms']:.4f} device ms: "
        f"{json.dumps({k: round(v, 4) for k, v in split.items()})}), B 64 "
        f"{out['b64_p50_ms']:.3f} ms (transient peak {peak} B); recall@10 "
        f"{out['recall_at_10']:.4f} (B 1 {out['b1_recall_at_10']:.4f}); counts {counts}")
    if abs(alloc - out["device_bytes"]) > QUANT_MEM_SLACK:
        raise AssertionError(f"quant index: device bytes {out['device_bytes']} vs {alloc}")
    if counts.get("dispatch") != QUANT_TIMED_B1 + QUANT_B64_REPEATS \
            or min(out["recall_at_10"], out["b1_recall_at_10"]) < RECALL_MIN:
        raise AssertionError(f"quant index: {counts}, recall {out['recall_at_10']:.4f}")
    if any(launches.values()):
        raise AssertionError(f"quant index: the int8 path launched {launches}")
    return launches


# -- phase 9: the memory plane ----------------------------------------------

# (a): bench.py:_bench_background's graph and jobs, at its size
MEMORY_NODES = 100_000
MEMORY_EDGES_PER_NODE = 3  # 300,000 edges, KNOWS and LIKES alternating
MEMORY_SEEDS = 256
MEMORY_SCORERS = ("common_neighbors", "adamic_adar", "resource_allocation")
MEMORY_LIMIT = 10
MEMORY_ARCHIVE = 0.45
MEMORY_NOW_MS = 1_700_000_000_000
DAY_MS = 86_400_000
FASTRP_DIM = 64
FASTRP_COS_MIN = 0.999  # tests/test_background_plane.py's bound, card against host
# each op on the card against the same op on CPU tensors: float32 sums in
# another order (decay scores are O(1), link-prediction values sums of at
# most 32 weights <= 1.45), and FastRP rows after three normalizations
CARD_CPU_ATOL = 1e-6
CARD_CPU_FASTRP_COS = 0.9999
MEMORY_MEM_SLACK = 1 << 20  # the snapshot's device bytes against the memory_allocated delta
# (b): the DB's inference path below the HNSW threshold, so candidates
# ride B1 through the vector batcher (k 9 -> 16) and exact=True (k 9)
INFER_MEMORIES = 8_000
INFER_STORES = 256  # stored with auto_link=True
INFER_BATCH = 64  # stored plain, then on_store_batch with the plane attached
INFER_DIMS = 160
INFER_CLUSTER = 4  # memories per cluster on average: cosines ~0.89 inside, ~0 across
INFER_K = (9, 16)  # exact=True's k, and the batcher's (max_links_per_store * 3, rounded)
INFER_CAPACITIES = ((8_192, INFER_MEMORIES), (16_384, INFER_MEMORIES + INFER_STORES + INFER_BATCH))
INFER_CONF_ATOL = 1e-5
INFER_REMEMBER_ROUNDS = 8
GDS_SOURCES = 16
MEMORY_PHASE_S = 150.0  # phase 9's length, with room


class ArgRecorder:
    """Records the arguments of every call of ``mod.name`` inside the
    block (the callers look the name up on the module, so they reach the
    recorder); the calls themselves are unchanged."""

    def __init__(self, mod, name):
        self.mod, self.name, self.calls = mod, name, []

    def __enter__(self):
        self.real = getattr(self.mod, self.name)

        def record(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.real(*args, **kwargs)

        setattr(self.mod, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def memory_engine(n):
    """``bench.py:_bench_background``'s graph: ``n`` nodes with uniform
    importance created up to 80 days back, ``3 n`` edges alternating
    KNOWS and LIKES between uniform endpoints (``random.Random(19)``)."""
    import random

    from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node

    eng = MemoryEngine()
    r = random.Random(19)
    for i in range(n):
        eng.create_node(Node(id=f"n{i}", labels=["T"], properties={"importance": r.random()},
                             created_at=MEMORY_NOW_MS - r.randrange(0, 80 * DAY_MS)))
    for j in range(MEMORY_EDGES_PER_NODE * n):
        eng.create_edge(Edge(id=f"e{j}", type=("KNOWS", "LIKES")[j % 2],
                             start_node=f"n{r.randrange(n)}", end_node=f"n{r.randrange(n)}"))
    return eng


def memory_decay(eng, n):
    """One node in three accessed in the last 40 days; threshold 0.45."""
    import random

    from nornicdb_tpu_torch.decay import DecayManager

    dm = DecayManager(eng, archive_threshold=MEMORY_ARCHIVE)
    r = random.Random(7)
    for i in range(0, n, 3):
        dm.record_access(f"n{i}", at_ms=MEMORY_NOW_MS - r.randrange(0, 40 * DAY_MS))
    return dm


def archived_ids(eng):
    return sorted(nd.id for nd in eng.all_nodes() if nd.properties.get("_archived"))


def lp_card_vs_cpu(dev, calls):
    """Each recorded link-prediction pass again on the card and on CPU
    copies of its tensors: (max |value| error, device ms by CUDA events of
    all passes); raises unless distinct counts are equal and the ids agree
    tie-aware."""
    import torch

    from nornicdb_tpu_torch.ops import linkpredict as olp
    from nornicdb_tpu_torch.ops.topk import topk_agree

    err, ms = 0.0, 0.0
    for args, _ in calls:
        seed_rows, ip, nb, w, n, f1, f2, kp = args
        s = torch.as_tensor(np.asarray(seed_rows, np.int64), device=dev)
        card = [t.cpu().numpy() for t in olp.linkpredict_topk_t(s, ip, nb, w, n, f1, f2, kp)]
        cpu = [t.numpy() for t in olp.linkpredict_topk_t(s.cpu(), ip.cpu(), nb.cpu(), w.cpu(),
                                                         n, f1, f2, kp)]
        live = np.isfinite(cpu[0])
        if not np.array_equal(card[2], cpu[2]) or not np.array_equal(np.isfinite(card[0]), live):
            raise AssertionError(f"link prediction card vs CPU: distinct counts or live slots "
                                 f"differ at f1 {f1}")
        if not topk_agree(card[1], np.where(live, card[0], -1e30),
                          cpu[1], np.where(live, cpu[0], -1e30), atol=CARD_CPU_ATOL):
            raise AssertionError(f"link prediction card vs CPU: ids disagree at f1 {f1}")
        if live.any():
            err = max(err, float(np.max(np.abs(card[0][live] - cpu[0][live]))))
        ms += time_ms(lambda: olp.linkpredict_topk_t(s, ip, nb, w, n, f1, f2, kp),
                      iters=5, warmup=1)
    return err, ms


def memory_plane(dev, card, n, n_seeds):
    """Phase 9 (a): the background plane at the reference's size."""
    import torch

    from nornicdb_tpu_torch import linkpredict as lp
    from nornicdb_tpu_torch.background.device_plane import BackgroundDevicePlane
    from nornicdb_tpu_torch.ops import decay as odecay
    from nornicdb_tpu_torch.ops import fastrp as ofastrp
    from nornicdb_tpu_torch.ops import linkpredict as olp
    from nornicdb_tpu_torch.query.columnar import ColumnarCatalog

    out = {"nodes": n, "edges": MEMORY_EDGES_PER_NODE * n, "seeds": n_seeds}
    t = time.perf_counter()
    eng_dev, eng_host = memory_engine(n), memory_engine(n)
    dm_dev, dm_host = memory_decay(eng_dev, n), memory_decay(eng_host, n)
    out["build_s"] = time.perf_counter() - t
    cat_dev, cat_host = ColumnarCatalog(eng_dev), ColumnarCatalog(eng_host)
    plane = BackgroundDevicePlane(eng_dev, cat_dev, decay=dm_dev, device=dev)

    # -- decay: a cold sweep, then a warm one a day later ------------------
    sweeps = []
    for at in (MEMORY_NOW_MS, MEMORY_NOW_MS + DAY_MS):
        with ArgRecorder(odecay, "decay_scores") as rec:
            t = time.perf_counter()
            res_dev = dm_dev.sweep(at)
            dev_s = time.perf_counter() - t
        t = time.perf_counter()
        res_host = dm_host.sweep(at)
        host_s = time.perf_counter() - t
        if len(rec.calls) != 1:
            raise AssertionError(f"the plane did not serve the sweep: {dict(plane.counts)}")
        if res_dev != res_host or archived_ids(eng_dev) != archived_ids(eng_host):
            raise AssertionError(f"decay verdicts differ: device {res_dev}, host {res_host}")
        sweeps.append({"scored_archived": list(res_dev), "device_s": dev_s, "host_s": host_s})
    # the warm sweep's columns again on the card and on the CPU
    args = rec.calls[0][0]
    cols, (weights, q, r) = args[:7], args[7:10]

    def tensors(d):
        return [torch.from_numpy(np.asarray(c)).to(d) for c in cols]

    cd, cc = tensors(dev), tensors("cpu")
    card_out = [x.cpu().numpy() for x in odecay.decay_scores_t(*cd, weights, q, r)]
    cpu_out = [x.numpy() for x in odecay.decay_scores_t(*cc, weights, q, r)]
    decay_err = max(float(np.max(np.abs(a.astype(np.float64) - b)))
                    for a, b in zip(card_out, cpu_out))
    if decay_err > CARD_CPU_ATOL:
        raise AssertionError(f"decay card vs CPU: max err {decay_err:.3g} > {CARD_CPU_ATOL}")
    decay_ms = time_ms(lambda: odecay.decay_scores_t(*cd, weights, q, r))
    del cd, cc
    out["decay"] = {"sweeps": sweeps, "card_cpu_max_err": decay_err, "device_ms": decay_ms,
                    "counts": dict(plane.counts)}
    log(f"memory (a) decay: {n} nodes, cold sweep {sweeps[0]['scored_archived']} on both, "
        f"device {sweeps[0]['device_s']:.3f} s against host {sweeps[0]['host_s']:.3f} s; warm "
        f"{sweeps[1]['scored_archived']}, device {sweeps[1]['device_s']:.3f} s against host "
        f"{sweeps[1]['host_s']:.3f} s; archived sets equal; the pass {decay_ms:.4f} device ms "
        f"(CUDA events), card vs CPU max err {decay_err:.3g} ({card})")

    # -- link prediction: 256 seeds x 3 scorers ------------------------------
    seeds = [f"n{i}" for i in range(n_seeds)]
    # the snapshots every later call reuses, timed apart: the plane's union
    # CSR, and the host AdjacencySnapshot of each engine (the host loop's,
    # and the one the plane's re-scores and step-downs read)
    builds = {}
    for name, fn in (("union_csr", plane._union_snapshot),
                     ("adjacency_device_engine", lambda: lp.adjacency_snapshot(eng_dev, cat_dev)),
                     ("adjacency_host_engine", lambda: lp.adjacency_snapshot(eng_host, cat_host))):
        t = time.perf_counter()
        fn()
        builds[name] = time.perf_counter() - t
    mem0 = device_memory()
    lp_out = {"snapshot_build_s": builds}
    log(f"memory (a) snapshots: union CSR {builds['union_csr']:.3f} s, host adjacency "
        f"{builds['adjacency_device_engine']:.3f} s (the plane's engine) and "
        f"{builds['adjacency_host_engine']:.3f} s (the host loop's)")
    for method in MEMORY_SCORERS:
        before = dict(plane.counts)
        with ArgRecorder(olp, "linkpredict_topk") as rec:
            t = time.perf_counter()
            got = plane.linkpredict_topk(seeds, method=method, limit=MEMORY_LIMIT)
            dev_s = time.perf_counter() - t
        t = time.perf_counter()
        want = {s: lp.predict_links(eng_host, s, method=method, limit=MEMORY_LIMIT,
                                    catalog=cat_host) for s in seeds}
        host_s = time.perf_counter() - t
        if got is None:
            raise AssertionError(f"{method}: the plane stepped the batch down: "
                                 f"{dict(plane.counts)}")
        bad = [s for s in seeds if got[s] != want[s]]
        if bad:
            raise AssertionError(f"{method}: {len(bad)} seeds differ from host predict_links, "
                                 f"first {bad[0]}: {got[bad[0]]} vs {want[bad[0]]}")
        steps = {k: v - before.get(k, 0) for k, v in plane.counts.items()
                 if k.startswith("degrade_") and v != before.get(k, 0)}
        err, ms = lp_card_vs_cpu(dev, rec.calls)
        groups = [(a[5], len(a[0])) for a, _ in rec.calls]
        lp_out[method] = {"lists_equal": len(seeds), "device_s": dev_s, "host_s": host_s,
                          "step_downs": steps, "groups_f1_b": groups, "device_ms": ms,
                          "card_cpu_max_err": err}
        log(f"memory (a) linkpredict {method}: {len(seeds)} lists equal to host predict_links; "
            f"device {dev_s:.3f} s against host {host_s:.3f} s; step-downs {steps}; passes "
            f"(f1, seeds) {groups} in {ms:.4f} device ms; card vs CPU max err {err:.3g} ({card})")
    stats = plane.resource_stats()
    delta = device_memory() - mem0
    if abs(delta - stats["device_bytes"]) > MEMORY_MEM_SLACK:
        raise AssertionError(f"snapshot device bytes {stats['device_bytes']} against the "
                             f"memory_allocated delta {delta}")
    lp_out["snapshot"] = dict(stats, memory_allocated_delta=delta)
    log(f"memory (a) snapshot: {stats['rows']} CSR rows, {stats['device_bytes']} device bytes "
        f"(memory_allocated +{delta}), {stats['host_bytes']} host bytes")
    out["linkpredict"] = lp_out

    # -- FastRP over the union graph -----------------------------------------
    with ArgRecorder(ofastrp, "fastrp_device") as rec:
        t = time.perf_counter()
        res = plane.fastrp(dim=FASTRP_DIM)
        dev_s = time.perf_counter() - t
    if res is None or len(rec.calls) != 1:
        raise AssertionError(f"the plane did not serve FastRP: {dict(plane.counts)}")
    ids, emb = res
    src, dst = plane.fastrp_edges(plane._union_snapshot())
    t = time.perf_counter()
    host = ofastrp.fastrp_embeddings(len(ids), src, dst, dim=FASTRP_DIM)
    host_s = time.perf_counter() - t
    live = np.linalg.norm(host, axis=1) > 1e-9
    if not np.array_equal(np.linalg.norm(emb, axis=1) > 1e-9, live):
        raise AssertionError("FastRP: the card's zero rows differ from the host's")
    cos = float(np.sum(emb[live] * host[live], axis=1).min())
    if not cos > FASTRP_COS_MIN:
        raise AssertionError(f"FastRP min cosine {cos} against host <= {FASTRP_COS_MIN}")
    a = rec.calls[0][0]
    card_rows = ofastrp.fastrp_device(*a).cpu().numpy()
    cpu_rows = ofastrp.fastrp_device(*[x.cpu() if torch.is_tensor(x) else x for x in a]).numpy()
    cc = float(np.sum(card_rows[live] * cpu_rows[live], axis=1).min())
    if not cc >= CARD_CPU_FASTRP_COS:
        raise AssertionError(f"FastRP card vs CPU min cosine {cc} < {CARD_CPU_FASTRP_COS}")
    fr_ms = time_ms(lambda: ofastrp.fastrp_device(*a), iters=5, warmup=1)
    out["fastrp"] = {"dim": FASTRP_DIM, "rows": len(ids), "live_rows": int(live.sum()),
                     "min_cos_host": cos, "min_cos_card_cpu": cc, "device_s": dev_s,
                     "host_s": host_s, "device_ms": fr_ms}
    log(f"memory (a) fastrp: dim {FASTRP_DIM} over {len(ids)} nodes, min cosine {cos:.7f} "
        f"against host fastrp_embeddings; device {dev_s:.3f} s against host {host_s:.3f} s; "
        f"the chain {fr_ms:.4f} device ms; card vs CPU min cosine {cc:.7f} ({card})")
    out["counts"] = dict(plane.counts)
    return out


def clustered_memories(rng, n, d):
    """Unit float32 rows around ``n / INFER_CLUSTER`` random centers: ~0.89
    cosine inside a cluster, ~0 across."""
    centers = rng.standard_normal((max(1, n // INFER_CLUSTER), d))
    cid = rng.integers(0, len(centers), n)
    x = centers[cid] + 0.35 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32), cid


def suggestion_keys(res):
    return {nid: [(s.from_id, s.to_id, s.rel_type, s.confidence) for s in sugs]
            for nid, sugs in res.items()}


def memory_db(dev, seed, card, memories):
    """Phase 9 (b) and (c): inference and gds.* through a port DB. Returns
    the kernel launches of the path (the checks' launches left out) and
    the report."""
    import nornicdb_tpu_torch as nt
    from nornicdb_tpu_torch import linkpredict as lp
    from nornicdb_tpu_torch.background.device_plane import BackgroundDevicePlane
    from nornicdb_tpu_torch.inference import EvidenceBuffer, InferenceEngine
    from nornicdb_tpu_torch.ops.fastrp import GdsGraphCatalog
    from nornicdb_tpu_torch.query.columnar import ColumnarCatalog

    rng = np.random.default_rng(seed + 19)
    total = memories + INFER_STORES + INFER_BATCH
    vecs, cid = clustered_memories(rng, total, INFER_DIMS)
    out = {"memories": memories, "auto_link_stores": INFER_STORES, "batch": INFER_BATCH}
    db = nt.open(device=dev)
    try:
        svc = db.search
        t = time.perf_counter()
        for i in range(memories):
            db.store(f"memory {i}", node_id=f"mem{i}", embedding=vecs[i].tolist())
        out["store_s"] = time.perf_counter() - t
        if len(svc.vectors) != memories or svc.stats.strategy != "brute":
            raise AssertionError(f"{len(svc.vectors)} vectors on the {svc.stats.strategy} tier")
        reset_counts()
        check_b1 = 0
        t = time.perf_counter()
        for i in range(memories, memories + INFER_STORES):
            db.store(f"memory {i}", node_id=f"mem{i}", embedding=vecs[i].tolist(),
                     auto_link=True)
        out["auto_link_s"] = time.perf_counter() - t
        b1_auto = read_counts()["cosine_topk"]
        if b1_auto < INFER_STORES:
            raise AssertionError(f"B1 launched {b1_auto} times for {INFER_STORES} auto-link "
                                 f"stores")
        inf = db.inference
        fresh = [f"mem{i}" for i in range(memories + INFER_STORES, total)]
        for nid in fresh:
            i = int(nid[3:])
            db.store(f"memory {i}", node_id=nid, embedding=vecs[i].tolist())
        nodes = [db.storage.get_node(nid) for nid in fresh]
        plane = BackgroundDevicePlane(db.storage, ColumnarCatalog(db.storage), inference=inf,
                                      device=dev)
        # the batched path against the per-node path from the same state:
        # two engines that write no edge (a check: its launches are not the path's)
        c0 = read_counts()["cosine_topk"]
        dry = {}
        for name, attached in (("batched", True), ("per_node", False)):
            eng = InferenceEngine(db.storage, svc, evidence=EvidenceBuffer())
            eng.device_plane = plane if attached else None
            eng._create = lambda sug: True
            dry[name] = suggestion_keys(eng.on_store_batch(nodes))
        check_b1 += read_counts()["cosine_topk"] - c0
        if dry["batched"] != dry["per_node"]:
            raise AssertionError("on_store_batch through the plane differs from the per-node path")
        t = time.perf_counter()
        got = suggestion_keys(inf.on_store_batch(nodes))
        out["batch_s"] = time.perf_counter() - t
        if got != dry["batched"] or plane.counts["infer_candidates_device"] != 2:
            raise AssertionError(f"on_store_batch wrote other suggestions than its dry run: "
                                 f"{dict(plane.counts)}")
        n_batch = sum(len(v) for v in got.values())
        # evidence-gated co-access: two memories of different clusters, unlinked
        a, b = next((f"mem{i}", f"mem{j}") for i in range(memories) for j in range(i + 1, memories)
                    if cid[i] != cid[j] and not db.storage.get_node_edges(f"mem{i}")
                    and not db.storage.get_node_edges(f"mem{j}"))
        t = time.perf_counter()
        for _ in range(INFER_REMEMBER_ROUNDS):
            db.remember(a)
            db.remember(b)
        out["remember_s"] = time.perf_counter() - t
        co = [e for e in db.storage.get_node_edges(a)
              if e.type == "CO_ACCESSED_WITH" and {e.start_node, e.end_node} == {a, b}]
        if len(co) != 1 or co[0].properties.get("inferred") is not True:
            raise AssertionError(f"{INFER_REMEMBER_ROUNDS} rounds of remember made {len(co)} "
                                 f"CO_ACCESSED_WITH edges between {a} and {b}")
        out["evidence"] = inf.evidence.stats()

        # -- (c) gds.* through DB.cypher --------------------------------------
        t = time.perf_counter()
        proj = db.cypher("CALL gds.graph.project('mem', 'Memory', 'SIMILAR_TO')").rows
        ref = GdsGraphCatalog()
        g = ref.project(db.storage, "mem", "Memory", "SIMILAR_TO")
        if proj != [["mem", g["nodeCount"], g["relationshipCount"], "Memory", "SIMILAR_TO"]]:
            raise AssertionError(f"gds.graph.project: {proj} against the catalog's {g}")
        rows = db.cypher("CALL gds.fastRP.stream('mem', {embeddingDimension: 64}) "
                         "YIELD nodeId, embedding RETURN nodeId, embedding").rows
        ids, emb = ref.fastrp("mem", dim=64)
        if rows != [[nid, [float(x) for x in vec]] for nid, vec in zip(ids, emb)]:
            raise AssertionError("gds.fastRP.stream rows differ from fastrp_embeddings'")
        sims = sorted({e.start_node for e in db.storage.all_edges() if e.type == "SIMILAR_TO"})
        sources = sims[:GDS_SOURCES]
        for s in sources:
            rows = db.cypher("CALL gds.linkPrediction.adamicAdar.stream({sourceNode: $s, "
                             "topK: 10}) YIELD node1, node2, score RETURN node1, node2, score",
                             {"s": s}).rows
            want = [[s, nid, float(sc)] for nid, sc in
                    lp.predict_links(db.storage, s, method="adamic_adar", limit=10)]
            if rows != want:
                raise AssertionError(f"gds.linkPrediction.adamicAdar.stream from {s}: "
                                     f"{rows} against predict_links {want}")
        out["gds_s"] = time.perf_counter() - t
        counts = read_counts()
        path = {"cosine_topk": counts["cosine_topk"] - check_b1,
                "flash_attention": counts["flash_attention"]}

        # -- checks after the path's counts ------------------------------------
        inferred = [e for e in db.storage.all_edges() if e.type == "SIMILAR_TO"]
        worst = 0.0
        exact_lists = {}
        for e in inferred:
            conf = e.properties.get("confidence")
            if e.properties.get("inferred") is not True or conf < inf.similarity_threshold:
                raise AssertionError(f"inferred edge {e.start_node}->{e.end_node}: {e.properties}")
            i, j = int(e.start_node[3:]), int(e.end_node[3:])
            worst = max(worst, abs(conf - float(np.dot(vecs[i].astype(np.float64),
                                                       vecs[j].astype(np.float64)))))
            if i not in exact_lists:
                exact_lists[i] = dict(svc.vector_search_candidates(vecs[i].tolist(), k=INFER_K[0],
                                                                   exact=True))
            if e.end_node in exact_lists[i]:
                worst = max(worst, abs(conf - exact_lists[i][e.end_node]))
        if not inferred or worst > INFER_CONF_ATOL:
            raise AssertionError(f"{len(inferred)} inferred edges, max |confidence - exact "
                                 f"cosine| {worst:.3g} > {INFER_CONF_ATOL}")
        out.update({"similar_to": len(inferred), "from_batch": n_batch,
                    "confidence_max_err": worst, "b1_auto_link": b1_auto,
                    "gds_sources": len(sources), "plane_counts": dict(plane.counts),
                    "launches": path})
        log(f"memory (b): {memories} memories stored in {out['store_s']:.2f} s; {INFER_STORES} "
            f"auto_link stores in {out['auto_link_s']:.2f} s (B1 {b1_auto} launches); "
            f"on_store_batch of {INFER_BATCH} through the plane in {out['batch_s']:.3f} s, "
            f"the per-node path's suggestions ({n_batch}); {len(inferred)} SIMILAR_TO edges, "
            f"confidence >= {inf.similarity_threshold}, max |conf - exact cosine| {worst:.3g}; "
            f"{INFER_REMEMBER_ROUNDS} remember rounds made the CO_ACCESSED_WITH edge in "
            f"{out['remember_s']:.3f} s ({card})")
        log(f"memory (c): gds.graph.project ({g['nodeCount']} nodes, "
            f"{g['relationshipCount']} rels), gds.fastRP.stream and "
            f"gds.linkPrediction.adamicAdar.stream from {len(sources)} sources equal the "
            f"module calls, in {out['gds_s']:.2f} s; path launches {path}")
        if path["cosine_topk"] < 1:
            raise AssertionError(f"B1 never launched on the memory path: {path}")
        return path, out
    finally:
        db.close()


def phase_memory(dev, seed, card, n_nodes=MEMORY_NODES, n_seeds=MEMORY_SEEDS,
                 memories=INFER_MEMORIES):
    """Phase 9 (module docstring). Returns the launches of (b) and (c)."""
    out = REPORT["memory"] = {}
    out["plane"] = memory_plane(dev, card, n_nodes, n_seeds)
    path, out["db"] = memory_db(dev, seed, card, memories)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--index-rows", type=int, default=1 << 20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    global T_START
    t_start = T_START = time.perf_counter()
    phase_s = REPORT["phase_s"] = {}

    def lap(name):
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())

    dev = phase_device()
    card = REPORT["card"]
    phase_build()
    lap("build")
    phase_kernels(dev, args.seed)
    lap("kernels")
    path_launches, vecs, graph, corpus, bm25 = phase_main_path(dev, args.seed, args.docs)

    # each kernel timed at the shape the main path gives it
    mp = REPORT["main_path"]
    with vecs._lock:
        m, valid = vecs._device_arrays_locked()
    topk_rows = [time_topk(dev, m, valid, b, MAIN_K, args.seed, card) for b in MAIN_TIMED_B]
    topk_row = topk_rows[0]
    del m, valid, vecs
    if graph is not None:
        # the walk graph's k-NN build: B = 1,024 queries of its own rows
        # at k = degree + 1 (all rows valid)
        rows = graph["matrix"][:graph["n"]]
        topk_rows.append(time_topk(dev, rows, torch.ones(graph["n"], dtype=torch.bool, device=dev),
                                   1024, 33, args.seed, card, queries=rows[:1024]))
        del rows, graph
    # the main path's encoder runs in bf16, so B2 is timed in bf16; the
    # first row is the ingest shape, the one the kernels line reports
    attn_rows = [time_attention(dev, *shape, getattr(torch, dtype), args.seed, card)
                 for shape, dtype in ATTN_TIMED]
    attn_row = attn_rows[0]
    REPORT["main_path_timings"] = {"cosine_topk": topk_rows, "flash_attention": attn_rows}
    log(f"launches per query: cosine_topk {mp['launches_per_query']['cosine_topk']:.3f} "
        f"(per hybrid search of the exact tier; the walk launches none; per vector search too "
        f"below the HNSW threshold), flash_attention "
        f"{mp['launches_per_query']['flash_attention']:.4f} (per text through the encoder)")

    lap("main_path")
    idx = phase_index(dev, args.seed, args.index_rows, card)
    lap("index")
    # phase 8 (b) on phase 5's index, while it is on the card
    path_launches["quant_index"] = phase_quant_index(dev, idx, args.seed)
    del idx
    torch.cuda.empty_cache()
    lap("quant_index")
    path_launches["durable"] = phase_durable(dev, corpus)
    lap("durable")
    # a run near the chip call's limit shortens (a)'s windows, not its graph
    late = run_is_late()
    window_s = 0.5 if late else LDBC_WINDOW_S
    path_launches["cypher"] = phase_cypher(dev, args.seed, card, window_s=window_s,
                                           graph_reps=2 if late else GRAPH_REPS,
                                           apoc_reps=1 if late else APOC_REPS)
    # phase 7 (e)'s launches, over its parts in phases 4 and 7
    path_launches["apoc"] = dict(APOC_LAUNCHES)
    log(f"apoc path launches: {path_launches['apoc']}")
    if min(path_launches["apoc"].values()) < 1:
        raise AssertionError(f"a kernel of (e)'s path never launched: {path_launches['apoc']}")
    lap("cypher")
    path_launches["quant"] = phase_quant_tiered(dev, corpus, bm25)
    del corpus, bm25
    lap("quant_tiered")
    path_launches["memory"] = phase_memory(dev, args.seed, card)
    lap("memory")
    REPORT["total_s"] = time.perf_counter() - t_start

    def path_sum(name):
        return sum(p[name] for p in path_launches.values())

    kernels = [
        {"name": "cosine_topk", "route": "cuda",
         "source": "nornicdb_tpu_torch/csrc/cosine_topk.cu",
         "replaces": "nornicdb_tpu/ops/pallas_topk.py:125",
         "launches": path_sum("cosine_topk"),
         **{f"launches_{name}": p["cosine_topk"] for name, p in path_launches.items()},
         "max_abs_err": REPORT["topk_max_abs_err"],
         "ms": topk_row["kernel_ms"], "device_ms": sum(topk_row["device_ms"].values()),
         "plain_ms": topk_row["plain_ms"],
         "bound_ms": topk_row["bound_ms"], "bound_by": topk_row["bound_by"],
         "library_ms": topk_row["library_ms"],
         "library_device_ms": topk_row["library_device_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "nornicdb_tpu_torch/csrc/flash_attention.cu",
         "replaces": "nornicdb_tpu/ops/pallas_attention.py:131",
         "launches": path_sum("flash_attention"),
         **{f"launches_{name}": p["flash_attention"] for name, p in path_launches.items()},
         "max_abs_err": REPORT["attention_max_abs_err"],
         "ms": attn_row["kernel_ms"], "device_ms": attn_row["device_ms"],
         "plain_ms": attn_row["plain_ms"],
         "bound_ms": attn_row["bound_ms"], "bound_by": attn_row["bound_by"],
         "library_ms": attn_row["library_ms"],
         "library_device_ms": attn_row["library_device_ms"]},
    ]
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    if REPORT.get("profiler_lost"):
        log(f"profiler: {len(REPORT['profiler_lost'])} split(s) timed by CUDA events instead: "
            f"{json.dumps(REPORT['profiler_lost'])}")
    log(f"total {REPORT['total_s']:.1f} s; by phase (s) "
        f"{ {k: round(v, 1) for k, v in phase_s.items()} }")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
