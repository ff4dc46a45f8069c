"""The port's search path wired into its observability core, against the
reference's: one seeded workload (stores through the Python WAL, flush,
vector, text and hybrid search through the fused tier, result-cache hits,
a Cypher ``PROFILE``) through the JAX ``DB`` and the port's
``DB(device="cpu")``, with the fused tier's floor lowered (as
``tests/test_torch_hybrid.py`` does) so 400 documents reach it.

Compared, as deltas of each package's process-wide registry over the
workload: the set of (family, label names) recorded, the counts that do
not depend on time (dispatches per kind and bucket, strategy counters,
the fused tier's and the lexical snapshot's events, histogram ``_count``s
per series), the result cache's hits, and each registered resource's
``rows``, ``capacity`` and ``device_bytes``. Families and series of the
reference's layers that are not ported yet (the audit and tenant
serving records, admission's lane mirror) are named and left out.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu.obs as J
import nornicdb_tpu_torch
import nornicdb_tpu_torch.obs as T
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.obs import dispatch as j_dsp
from nornicdb_tpu.obs import metrics as j_metrics
from nornicdb_tpu.obs import resources as j_res
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from nornicdb_tpu_torch.obs import dispatch as t_dsp
from nornicdb_tpu_torch.obs import metrics as t_metrics
from nornicdb_tpu_torch.obs import resources as t_res

torch.set_num_threads(1)

VOCAB = [f"term{i}" for i in range(64)]
D = 32
N_DOCS = 400
QUERIES = ["term1 term2 term3", "term4 term9 term11", "term7 term8", "term0 term63",
           "term5 term5 term6", "term20", "term21 term22 textonly", "zzz qqq nothing"]

# families only the reference's unported layers record: the audit's
# served-tier and degrade ledger and the tenant serving records it drives
# (ROADMAP §A12)
UNPORTED_FAMILY_PREFIXES = ("nornicdb_served_tier", "nornicdb_tier_", "nornicdb_degrade",
                            "nornicdb_tenant_requests", "nornicdb_tenant_served",
                            "nornicdb_tenant_request_seconds", "nornicdb_admission",
                            "nornicdb_shadow", "nornicdb_audit", "nornicdb_slo",
                            "nornicdb_fleet", "nornicdb_deadline_miss")


def _unported(name: str) -> bool:
    return name.startswith(UNPORTED_FAMILY_PREFIXES)


def _state(m):
    return {f["name"]: f for f in m.dump_state()}


def _count(v):
    return v["count"] if isinstance(v, dict) else v


def _delta(before, after):
    """(family, label names) -> {label values: count delta}, for every
    series that moved over the workload (counters: their value; histograms:
    their ``_count``; gauges: left out, they hold levels)."""
    out = {}
    for name, fam in after.items():
        if fam["kind"] == "gauge" or _unported(name):
            continue
        prev = before.get(name, {"children": {}})["children"]
        moved = {}
        for key, v in fam["children"].items():
            if key and str(key[0]).startswith("lane:"):
                continue  # admission's per-lane mirror of the stage split
            d = _count(v) - _count(prev.get(key, 0.0 if not isinstance(v, dict) else {"count": 0}))
            if d:
                moved[tuple(key)] = d
        if moved:
            out[(name, tuple(fam["labels"]))] = moved
    return out


def _workload(db, path_rng_seed=5):
    rng = np.random.default_rng(path_rng_seed)
    db.recall("warm", mode="text")  # build the service first
    for i in range(N_DOCS):
        text = " ".join(rng.choice(VOCAB, size=int(rng.integers(3, 10))))
        db.store(text, labels=["Doc"], node_id=f"n{i}",
                 embedding=[float(x) for x in rng.standard_normal(D).astype(np.float32)])
    db.flush()
    qvs = rng.standard_normal((len(QUERIES), D)).astype(np.float32)
    svc = db.search
    for q, qv in zip(QUERIES, qvs):
        svc.search(q, limit=10, query_embedding=qv, mode="vector")
        svc.search(q, limit=10, mode="text")
        svc.search(q, limit=10, mode="text")  # a result-cache hit
        svc.search(q, limit=10, query_embedding=qv)  # hybrid: the fused tier
        svc.search(q, limit=5, query_embedding=qv, weights=(2.0, 0.5))
    svc.vector_search_candidates(qvs[0], 10, exact=True)
    prof = db.cypher("PROFILE MATCH (n:Doc) WHERE n.content CONTAINS 'term1' RETURN count(n)")
    return prof


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("NORNICDB_HYBRID_MIN_N", "50")
    mp.setenv("NORNICDB_HYBRID_INLINE_BUILD", "1")
    mp.setenv("NORNICDB_DEVICE_TIMING_SAMPLE", "1")
    out = {}
    try:
        for name, pkg, obs, metrics, dsp, res, emb, kw in (
                ("jax", nornicdb_tpu, J, j_metrics, j_dsp, j_res, JHash(), {}),
                ("port", nornicdb_tpu_torch, T, t_metrics, t_dsp, t_res, THash(),
                 {"device": "cpu"})):
            obs.device.reload()
            obs.device.reset()
            dsp.reset()
            before = _state(metrics)
            db = pkg.open(str(tmp_path_factory.mktemp(name)), engine="python",
                          auto_embed=False, embedder=emb, **kw)
            try:
                prof = _workload(db)
                after = _state(metrics)
                # this DB's registered objects only: other tests in the
                # process may hold objects registered under the same names
                svc = db.search
                owned = {id(o) for o in (svc.bm25, svc.vectors, svc._microbatch,
                                         svc._hybrid_batch, svc._fused.lex,
                                         db._executor.device_graph)}
                keys = {(f, n) for f, n, o in res._live_objects() if id(o) in owned}
                resources = {(e["family"], e["index"]): e for e in res.snapshot()
                             if (e["family"], e["index"]) in keys}
                out[name] = {
                    "delta": _delta(before, after),
                    "universe": dsp.compile_universe(),
                    "calibration": obs.device.calibration_summary(),
                    "resources": resources,
                    "cache_hits": db.search.stats.cache_hits,
                    "profile_rows": prof.rows,
                    "svc": db.search,
                }
            finally:
                db.close()
    finally:
        mp.undo()
        for obs in (J, T):
            obs.device._tls.__dict__.clear()  # no stashed note outlives the workload
    return out


def test_the_same_families_are_recorded(runs):
    j = set(runs["jax"]["delta"])
    t = set(runs["port"]["delta"])
    assert t == j, (sorted(j - t), sorted(t - j))
    names = {n for n, _ in t}
    for family in ("nornicdb_device_dispatch_total", "nornicdb_device_dispatch_seconds",
                   "nornicdb_device_compile_total", "nornicdb_microbatch_batch_size",
                   "nornicdb_microbatch_queue_depth", "nornicdb_request_stage_seconds",
                   "nornicdb_search_strategy_total", "nornicdb_hybrid_fused_events_total",
                   "nornicdb_device_bm25_events_total", "nornicdb_query_cost_flops_total",
                   "nornicdb_wal_append_seconds", "nornicdb_profile_db_hits",
                   "nornicdb_profile_query_seconds"):
        assert family in names, family


def test_time_free_counts_match(runs):
    j, t = runs["jax"]["delta"], runs["port"]["delta"]
    for key in sorted(j):
        name = key[0]
        if name.endswith("_seconds") and name not in (
                "nornicdb_request_stage_seconds", "nornicdb_device_dispatch_seconds",
                "nornicdb_wal_append_seconds", "nornicdb_profile_query_seconds"):
            continue
        if name in ("nornicdb_query_cost_flops_total", "nornicdb_query_cost_bytes_total",
                    "nornicdb_tenant_cost_flops_total", "nornicdb_tenant_cost_bytes_total",
                    "nornicdb_tenant_device_seconds_total"):
            continue  # compared below, or measured time
        assert t[key] == j[key], key


def test_dispatch_universe_and_calibration_counts_match(runs):
    strip = [[{k: v for k, v in e.items() if not k.endswith("_ms")} for e in runs[s]["universe"]]
             for s in ("jax", "port")]
    assert strip[0] == strip[1]
    kinds = [{k: (d["dispatches"], d["top_dispatches"], d["padded_rows"] if "padded_rows" in d
                  else None, sorted((b, bk["samples"]) for b, bk in d["buckets"].items()))
              for k, d in runs[s]["calibration"]["kinds"].items()} for s in ("jax", "port")]
    assert kinds[0] == kinds[1]
    assert {"microbatch", "hybrid_fused"} <= set(kinds[1])


def test_costs_match_at_batch_one(runs):
    """One query at a time, so every batch is its own power-of-two
    bucket and the port prices the same shapes as the reference."""
    for name in ("nornicdb_query_cost_flops_total", "nornicdb_query_cost_bytes_total",
                 "nornicdb_query_cost_queries_total"):
        key = (name, ("kind", "index"))
        assert runs["port"]["delta"][key] == runs["jax"]["delta"][key]
    cal = [runs[s]["calibration"]["kinds"] for s in ("jax", "port")]
    for kind in cal[0]:
        for field in ("flops", "bytes", "padding_efficiency"):
            assert cal[1][kind][field] == cal[0][kind][field], (kind, field)


def test_resources_match(runs):
    j, t = runs["jax"]["resources"], runs["port"]["resources"]
    assert set(t) == set(j) and len(t) == 6
    lex = ("device_bm25", "service:neo4j")
    for key in j:
        for field in ("rows", "capacity", "device_bytes", "queue_depth"):
            if key == lex and field == "device_bytes":
                continue  # the layouts differ by design: below
            assert t[key].get(field) == j[key].get(field), (key, field)
    assert t[("brute", "service:neo4j")]["device_bytes"] > 0
    # the lexical snapshot's columns (ROADMAP C30): the reference pads the
    # posting columns to a power of two and keeps ``alive`` in float32;
    # the port keeps the postings unpadded and ``alive`` as bool. Each
    # side's device_bytes is its own columns' bytes.
    snaps = [runs[s]["svc"]._fused.lex._snap for s in ("jax", "port")]
    nnz_padded = int(snaps[0]["post_doc"].shape[0])
    nnz = int(snaps[1]["post_doc"].numel())
    c = t[lex]["capacity"]
    assert nnz_padded >= nnz and nnz_padded & (nnz_padded - 1) == 0
    assert j[lex]["device_bytes"] == nnz_padded * (4 + 2) + c * (2 + 4)
    assert t[lex]["device_bytes"] == nnz * (4 + 2) + c * (2 + 1)


def test_cache_hits_and_profile_match(runs):
    assert runs["port"]["cache_hits"] == runs["jax"]["cache_hits"] == len(QUERIES)
    assert runs["port"]["profile_rows"] == runs["jax"]["profile_rows"]
