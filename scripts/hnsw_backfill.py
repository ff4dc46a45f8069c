#!/usr/bin/env python3
"""HNSW over ``chip_smoke.py``'s corpus: build order, build time, recall
by query beam.

Run from the root of a checkout:

    python3 scripts/hnsw_backfill.py [--docs N] [--seed S] [--device cuda|cpu]
        [--reference-order]

Embeds the same seeded documents and 64 queries as ``chip_smoke.py``
phase 4 through the port's DB (its default bf16 mini encoder on
``--device``), then builds ``search/hnsw.py:HNSWIndex`` over the
brute index's rows (slot order, the BM25 seeds of the service) the way
the port's backfill does: one seeded wave build. With
``--reference-order`` it also builds it the way the JAX package's
backfill does, one ``index_node`` per node: a seeded wave build over the
first 10,000 vectors (the switch), then one single ``add`` for each
later vector. For each graph it prints the host seconds of the build
and recall@10 against exact search of the queries' answers (the top 10
of a k = 30 search, what ``recall(limit=10)`` asks) at ef_search 64 (the
reference's default), 96, 128 (the port's) and 200. HNSW is host code:
its times are the host CPU's. One JSON line per graph also goes to
``chiprun_out/hnsw_backfill.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EFS = (64, 96, 128, 200)
REFERENCE_SWITCH = 10_000  # the JAX package's hnsw_threshold


def corpus_vectors(n_docs: int, seed: int, device: str):
    """(rows as (id, vector), BM25 seeds, query vectors) of chip_smoke.py's corpus."""
    import nornicdb_tpu_torch
    from chip_smoke import make_corpus

    docs, queries = make_corpus(np.random.default_rng(seed + 1), n_docs)
    db = nornicdb_tpu_torch.open(device=device)
    try:
        for i, text in enumerate(docs):
            db.store(text, node_id=f"d{i}")
        db.flush()
        # the indexes without the switch: the builds below are the subject
        from nornicdb_tpu_torch.search.service import SearchService

        svc = SearchService(db.storage, embedder=db._embedder, device=device,
                            hnsw_threshold=n_docs + 1)
        svc.build_indexes()
        matrix, valid, ext_ids = svc.vectors.snapshot()
        rows = [(eid, matrix[slot]) for slot, eid in enumerate(ext_ids)
                if eid is not None and valid[slot]]
        seeds = svc.bm25.seed_doc_ids()
        qv = np.asarray(db._embedder.embed_batch(queries), np.float32)
    finally:
        db.close()
    return rows, seeds, qv


def recall_by_ef(idx, rows, qv):
    ids = [e for e, _ in rows]
    m = np.stack([v for _, v in rows])
    qn = qv / np.linalg.norm(qv, axis=1, keepdims=True)
    truth = np.argsort(-(qn @ m.T), axis=1, kind="stable")[:, :10]
    out = {}
    for ef in EFS:
        got = [idx.search(q, 30, ef=ef)[:10] for q in qv]
        out[ef] = float(np.mean([len({ids[i] for i in truth[r]} & {e for e, _ in got[r]}) / 10
                                 for r in range(len(qv))]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference-order", action="store_true")
    args = ap.parse_args()
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card: pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nornicdb_tpu_torch.search.hnsw import HNSWIndex
    from nornicdb_tpu_torch.search.service import HNSW_EF_SEARCH

    t = time.perf_counter()
    rows, seeds, qv = corpus_vectors(args.docs, args.seed, args.device)
    print(f"embedded {len(rows)} docs and {len(qv)} queries on {args.device} in "
          f"{time.perf_counter() - t:.1f} s; {len(seeds)} BM25 seeds", flush=True)
    orders = ["one_wave_build"] + (["reference_order"] if args.reference_order else [])
    results = []
    for order in orders:
        idx = HNSWIndex(ef_search=HNSW_EF_SEARCH)
        t = time.perf_counter()
        if order == "one_wave_build":
            idx.build(rows, seed_ids=seeds)
        else:
            # the reference's switch sees the first 10,000 rows; its seeds
            # come from the BM25 index as it stands then, approximated
            # here by the whole corpus's seeds among those rows
            first = rows[:REFERENCE_SWITCH]
            have = {e for e, _ in first}
            idx.build(first, seed_ids=[s for s in seeds if s in have])
            for eid, v in rows[REFERENCE_SWITCH:]:
                idx.add(eid, v)
        build_s = time.perf_counter() - t
        rec = {"order": order, "docs": len(rows), "device": args.device,
               "build_s": build_s, "recall_at_10_by_ef": recall_by_ef(idx, rows, qv)}
        results.append(rec)
        print(json.dumps(rec), flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hnsw_backfill.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
