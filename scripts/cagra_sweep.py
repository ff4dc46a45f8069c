#!/usr/bin/env python3
"""The CAGRA walk's search breadth over ``chip_smoke.py``'s corpus:
recall by (itopk, width, iters).

Run from the root of a checkout:

    python3 scripts/cagra_sweep.py [--docs N] [--seed S] [--device cuda|cpu]

Embeds the same seeded documents and 64 queries as ``chip_smoke.py``
phase 4 through the port's DB (its default bf16 mini encoder on
``--device``), indexes them in BM25 and brute force without a strategy
switch, and builds ``search/cagra.py:CagraIndex`` once over the brute
index (degree 32, B1 on the card). Then, for each setting of ``GRID``
(the walk's pool ``itopk``, frontier ``width`` and ``iters``; ``auto`` is
the index's ``max(8, ceil(0.75 log2 n))``), it asks the walk for the 30
candidates a ``recall(limit=10)`` asks and prints two recalls@10 over
the queries:

- ``vector``: the walk's top 10 against exact search's;
- ``hybrid``: the host ``rrf_fuse`` of the BM25 list and the walk's list
  against the same fuse over the exact list (the walk tier's contract,
  ``hybrid_fused.py``);

with the host ms of one ``search_batch`` of all queries and of one query
alone (means, after a warm-up, synchronized on the card). One JSON line
per setting also goes to ``chiprun_out/cagra_sweep.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (itopk, width, iters); None = the index's automatic iteration count
GRID = ((64, 1, None), (64, 1, 32), (64, 4, 16), (64, 8, None), (128, 2, 24),
        (128, 4, 24), (128, 8, None), (128, 8, 16), (256, 8, None))
OVERFETCH = 30  # recall(limit=10) asks max(3 * 10, 30) candidates


def corpus_service(n_docs: int, seed: int, device: str):
    """(service with BM25 and brute force over the corpus, query texts,
    query vectors) of chip_smoke.py's corpus."""
    import nornicdb_tpu_torch
    from chip_smoke import make_corpus
    from nornicdb_tpu_torch.search.service import SearchService

    docs, queries = make_corpus(np.random.default_rng(seed + 1), n_docs)
    db = nornicdb_tpu_torch.open(device=device)
    try:
        for i, text in enumerate(docs):
            db.store(text, node_id=f"d{i}")
        db.flush()
        svc = SearchService(db.storage, embedder=db._embedder, device=device,
                            hnsw_threshold=n_docs + 1)
        svc.build_indexes()
        qv = np.asarray(db._embedder.embed_batch(queries), np.float32)
    finally:
        db.close()
    return svc, queries, qv


def top10(hits):
    return {e for e, _ in hits[:10]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA card: pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nornicdb_tpu_torch.search.cagra import CagraIndex
    from nornicdb_tpu_torch.search.rrf import rrf_fuse

    t = time.perf_counter()
    svc, queries, qv = corpus_service(args.docs, args.seed, args.device)
    print(f"embedded and indexed {len(svc.vectors)} docs and {len(qv)} queries on "
          f"{args.device} in {time.perf_counter() - t:.1f} s", flush=True)
    idx = CagraIndex(brute=svc.vectors, degree=32, min_n=1)
    if not idx.build():
        raise AssertionError("the graph was not built")
    g = idx._graph
    print(f"graph: {g['n']} rows, degree {idx.degree}, auto iters {g['iters']}; build s "
          f"{json.dumps(idx.build_s)}", flush=True)
    exact = [svc.vectors.search_batch(q[None, :], OVERFETCH)[0] for q in qv]
    lex = [svc.bm25.search(q, OVERFETCH) for q in queries]
    ref_fused = [rrf_fuse([lx, ex], limit=OVERFETCH) for lx, ex in zip(lex, exact)]
    sync = torch.cuda.synchronize if args.device.startswith("cuda") else (lambda: None)

    def host_ms(fn, reps):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) * 1e3 / reps

    results = []
    for itopk, width, iters in GRID:
        kw = {"itopk": itopk, "width": width, "iters": iters}
        walk = idx.search_batch(qv, OVERFETCH, **kw)
        if idx.counts.get("fallback_itopk_exceeded") or idx.counts.get("fallback_underfill"):
            raise AssertionError(f"the walk fell back to brute force: {dict(idx.counts)}")
        vec = float(np.mean([len(top10(w) & top10(e)) / 10 for w, e in zip(walk, exact)]))
        hyb = float(np.mean([
            len(top10(rrf_fuse([lx, w], limit=OVERFETCH)) & top10(rf)) / 10
            for lx, w, rf in zip(lex, walk, ref_fused)]))
        rec = {"itopk": itopk, "width": width,
               "iters": iters if iters is not None else g["iters"], "auto_iters": iters is None,
               "vector_recall_at_10": vec, "hybrid_walk_parity_recall_at_10": hyb,
               "batch_ms": host_ms(lambda: idx.search_batch(qv, OVERFETCH, **kw), 5),
               "single_ms": host_ms(lambda: [idx.search_batch(q[None, :], OVERFETCH, **kw)
                                             for q in qv[:16]], 2) / 16,
               "queries": len(qv), "docs": len(svc.vectors), "device": args.device}
        results.append(rec)
        print(json.dumps(rec), flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cagra_sweep.json"), "w") as f:
        for rec in results:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
