"""The port's observability core (``nornicdb_tpu_torch/obs``) against the
reference's (``nornicdb_tpu/obs``): the same call sequences through both
packages, with the state of both reset by one twin fixture.

Compared: exposition text byte for byte, ``dump_state``/``merge_states``,
span trees by shape and attributes, tenant rollups, stage summaries, every
``price_*`` over a grid of shapes, the calibration plane (EWMA,
``predict_ms``, ``calibration_summary``, the compile split on a patched
clock, the recompile journal) and the memory ledger's drift episodes
under one injected backend probe. Then the port's own divergences (ROADMAP
C30): ``backend_bytes`` is None on the CPU, and device faults are not
swallowed by a scrape. Last, the reference's overhead guard on the
port's ``MicroBatcher``.
"""

from __future__ import annotations

import itertools
import time
import types

import numpy as np
import pytest
import torch

import nornicdb_tpu.obs as J
import nornicdb_tpu_torch.obs as T
from nornicdb_tpu.obs import cost as j_cost
from nornicdb_tpu.obs import device as j_dev
from nornicdb_tpu.obs import dispatch as j_dsp
from nornicdb_tpu.obs import events as j_events
from nornicdb_tpu.obs import metrics as j_metrics
from nornicdb_tpu.obs import resources as j_res
from nornicdb_tpu.obs import stages as j_stages
from nornicdb_tpu.obs import tenant as j_tenant
from nornicdb_tpu.obs import tracing as j_tracing
from nornicdb_tpu_torch.obs import cost as t_cost
from nornicdb_tpu_torch.obs import device as t_dev
from nornicdb_tpu_torch.obs import dispatch as t_dsp
from nornicdb_tpu_torch.obs import events as t_events
from nornicdb_tpu_torch.obs import metrics as t_metrics
from nornicdb_tpu_torch.obs import resources as t_res
from nornicdb_tpu_torch.obs import stages as t_stages
from nornicdb_tpu_torch.obs import tenant as t_tenant
from nornicdb_tpu_torch.obs import tracing as t_tracing

# names of the reference's obs.__all__ that come with its audit, SLO and
# fleet layers (ported with admission): the next slice adds them
LEFT_OUT = {
    "SloEngine", "audit", "audit_summary", "degrade_snapshot", "degrade_summary",
    "fleet", "fleet_summary", "get_slo_engine", "http_state_source", "maybe_sample",
    "parity_breaches", "record_degrade", "record_served", "register_fleet_source",
    "slo", "tier_allowed", "tier_mix", "unregister_fleet_source",
}

# one intra-op thread: the overhead guards time host paths beside the
# suite's other workers on shared cores
torch.set_num_threads(1)

JAX = types.SimpleNamespace(obs=J, cost=j_cost, dev=j_dev, dsp=j_dsp, events=j_events,
                            metrics=j_metrics, res=j_res, stages=j_stages,
                            tenant=j_tenant, tracing=j_tracing)
PORT = types.SimpleNamespace(obs=T, cost=t_cost, dev=t_dev, dsp=t_dsp, events=t_events,
                             metrics=t_metrics, res=t_res, stages=t_stages,
                             tenant=t_tenant, tracing=t_tracing)
SIDES = (JAX, PORT)


@pytest.fixture
def twin(monkeypatch):
    """Both packages with fresh calibration, dispatch, ledger, journal and
    trace state, every steady dispatch sampled, and no resource
    registered (the registries' counters keep their monotone totals, so
    comparisons read test-unique labels or deltas)."""
    monkeypatch.setenv("NORNICDB_DEVICE_TIMING_SAMPLE", "1")
    for side in SIDES:
        side.dev.reload()
        side.dev.reset()
        side.dev.set_backend_probe(None)
        side.dsp.reset()
        side.tracing.TRACES.clear()
        side.events.JOURNAL.clear()
        side.tenant.reload()
        monkeypatch.setattr(side.res, "_objects", {})
        monkeypatch.setattr(side.res, "_live_series", {})
    yield SIDES
    for side in SIDES:
        # a sample decision or a real-row note stashed for this thread and
        # not consumed (a dispatch that priced nothing) would skew the next
        # test's first steady sample or cost join
        side.dev._tls.__dict__.clear()
        side.dev.set_backend_probe(None)
        side.dev.reset()
        side.dev.reload()
        side.dsp.reset()
        side.metrics.set_enabled(True)


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------


def test_all_is_the_references_minus_the_admission_layers():
    assert set(J.__all__) - set(T.__all__) == LEFT_OUT
    assert set(T.__all__) <= set(J.__all__)
    assert len(T.__all__) == len(set(T.__all__))
    for name in T.__all__:
        assert hasattr(T, name), name


_FAMILIES_PROBE = """
import json, sys
import {pkg}.obs as obs
print(json.dumps({{f.name: [f.kind, list(f.label_names)] for f in obs.REGISTRY.families()}}))
"""


def _families_in_a_fresh_process(pkg):
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _FAMILIES_PROBE.format(pkg=pkg)], cwd=repo,
                         env=env, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_families_registered_at_import_match():
    """Each package's obs alone, in a fresh process: the port registers the
    reference's families with the same kinds and labels, less those its
    audit, SLO and fleet layers register."""
    import os
    import re

    j = _families_in_a_fresh_process("nornicdb_tpu")
    t = _families_in_a_fresh_process("nornicdb_tpu_torch")
    assert t == {name: j[name] for name in t}
    ref = os.path.join(os.path.dirname(J.__file__))
    left_out = set()
    for mod in ("audit", "slo", "fleet"):
        with open(os.path.join(ref, mod + ".py")) as f:
            left_out |= set(re.findall(r'"(nornicdb_[a-z0-9_]+)"', f.read()))
    assert set(j) - set(t) and set(j) - set(t) <= left_out


# ---------------------------------------------------------------------------
# metrics: exposition, dump/merge
# ---------------------------------------------------------------------------


def _populate(m):
    """One fixed call sequence into a fresh registry of module ``m``."""
    reg = m.Registry()
    c = reg.counter("nornicdb_twin_requests_total", "Requests", labels=("surface", "code"))
    c.labels("http", "200").inc()
    c.labels("http", "200").inc(2.5)
    c.labels("grpc", "500").inc()
    g = reg.gauge("nornicdb_twin_depth", "Depth")
    g.set(7)
    g2 = reg.gauge("nornicdb_twin_rows", "Rows", labels=("index",))
    g2.labels("a").set(1e-7)
    g2.labels("b\"x\\y").set(123456789.0)
    h = reg.histogram("nornicdb_twin_seconds", "Latency", labels=("kind",))
    for v in (0.0002, 0.003, 0.003, 0.04, 0.5, 7.0, 100.0):
        h.labels("brute").observe(v)
    h.labels("walk").observe(0.011)
    hs = reg.histogram("nornicdb_twin_batch", "Batch", buckets=m.SIZE_BUCKETS)
    for v in (1, 2, 3, 64, 65, 1000):
        hs.observe(v)
    reg.gauge("nornicdb_twin_cb", "Callback", fn=lambda: 42.0)
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
def test_exposition_is_byte_for_byte(twin, openmetrics):
    was = [side.metrics.exemplars_enabled() for side in twin]
    for side in twin:
        side.metrics.set_exemplars_enabled(False)
    try:
        regs = [_populate(side.metrics) for side in twin]
        if openmetrics:
            texts = [r.render_openmetrics() for r in regs]
        else:
            texts = [r.render(extra_gauges={"nornicdb_twin_extra": 3.5}) for r in regs]
    finally:
        for side, w in zip(twin, was):
            side.metrics.set_exemplars_enabled(w)
    assert texts[0] == texts[1]
    assert "nornicdb_twin_seconds_bucket" in texts[1]


def test_dump_merge_and_render_merged_match(twin):
    regs = [_populate(side.metrics) for side in twin]
    dumps = [side.metrics.dump_state(r) for side, r in zip(twin, regs)]
    assert dumps[0] == dumps[1]
    remote = _populate(j_metrics)
    remote_state = j_metrics.dump_state(remote)
    merged = [side.metrics.merge_states(d, [remote_state, remote_state])
              for side, d in zip(twin, dumps)]
    assert merged[0] == merged[1]
    texts = [side.metrics.render_merged([remote_state], registry=r)
             for side, r in zip(twin, regs)]
    assert texts[0] == texts[1]
    summaries = [side.metrics.latency_summary(r) for side, r in zip(twin, regs)]
    assert summaries[0] == summaries[1]


def test_label_cardinality_cap_folds_the_same(twin):
    outs = []
    for side in twin:
        reg = side.metrics.Registry(max_label_children=4)
        c = reg.counter("nornicdb_twin_cap_total", "Capped", labels=("t",))
        for i in range(9):
            c.labels(f"t{i}").inc(i)
        outs.append(reg.render())
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# tracing, tenants, stages, events
# ---------------------------------------------------------------------------


def _shape(doc):
    return {"name": doc["name"], "attrs": doc["attrs"],
            "children": [_shape(c) for c in doc["children"]]}


def _drive_trace(side):
    tr = side.tracing
    with tr.trace("wire", method="/search") as root:
        with tr.span("parse", bytes=12):
            tr.annotate(ok=True)
        tr.attach_span("device.dispatch", root.t0, root.t0 + 0.002, batch=4, k=16)
        with tr.span("merge"):
            with tr.span("inner", depth=2):
                pass
        ctx = tr.trace_context()
    packed = tr.pack_context(ctx)
    return root, tr.unpack_context(packed), packed


def test_span_trees_match_by_shape_and_attributes(twin):
    docs, ctxs = [], []
    for side in twin:
        root, ctx, packed = _drive_trace(side)
        docs.append(_shape(side.tracing.export_span(root)))
        ctxs.append(ctx)
        assert side.tracing.TRACES.snapshot(limit=1)[0]["name"] == "wire"
        assert ctx["trace_id"] == root.trace_id
    assert docs[0] == docs[1]
    # a context packed by one package unpacks in the other
    _, _, packed = _drive_trace(twin[0])
    assert twin[1].tracing.unpack_context(packed) == twin[0].tracing.unpack_context(packed)


def test_tenant_rollups_match(twin):
    rollups = []
    for side in twin:
        t = side.tenant
        with t.tenant_scope("twin-acme"):
            t.record_served("hybrid", "hybrid_brute_f32", seconds=0.004)
            t.record_cost(1, 1e6, 2e5)
            t.record_device_seconds(0.002)
        with t.batch_scope(["twin-acme", "twin-beta", "twin-beta", None]):
            t.record_served("vector", "vector_brute_f32", n=4)
            t.record_cost(4, 8e6, 4e6)
            t.record_device_seconds(0.008)
        with t.tenant_scope("twin-beta"):
            t.record_shed("vector", "queue_full")
            t.record_degrade("hybrid", "vec_race")
        docs = {d["tenant"]: d for d in t.tenants_summary(top=1000)["tenants"]
                if d["tenant"].startswith("twin-")}
        for d in docs.values():
            d.pop("qps", None)
            d.pop("cost_share", None)
        rollups.append(docs)
    assert rollups[0] == rollups[1]
    assert rollups[1]["twin-beta"]["cost"]["flops"] == pytest.approx(4e6)


def test_stage_summaries_match(twin):
    outs = []
    for side in twin:
        reg = side.metrics.Registry()
        fam = reg.histogram("nornicdb_request_stage_seconds", "Stages",
                            labels=("surface", "stage"),
                            buckets=side.metrics.LATENCY_BUCKETS)
        for stage, v in (("coalesce_wait", 0.001), ("device_dispatch", 0.004),
                         ("merge", 0.0002), ("coalesce_wait", 0.003)):
            fam.labels("service:twin", stage).observe(v)
        outs.append(side.stages.stage_summary(reg))
        side.stages.record_stage("service:twin-global", "device_dispatch", 0.002)
    assert outs[0] == outs[1]
    glob = [side.stages.stage_summary()["service:twin-global"] for side in twin]
    assert glob[0].keys() == glob[1].keys()


def test_event_journal_matches(twin):
    snaps = []
    for side in twin:
        side.events.record_event("recompile", surface="microbatch", reason="bucket_churn",
                                 detail={"b": 4, "k": 16})
        side.events.record_event("leak_suspected", surface="device")
        snap = side.events.event_snapshot(limit=10)
        snaps.append([{k: v for k, v in e.items() if k not in ("ts", "seq", "t")}
                      for e in snap])
    assert snaps[0] == snaps[1]


def test_wire_cache_counters_match():
    """``WireCache``'s hit, miss and invalidation counters, per cache
    name, after the same gets and puts."""
    from nornicdb_tpu.cache import WireCache as JWire
    from nornicdb_tpu_torch.cache import WireCache as TWire

    stats = []
    for cls, reg in ((JWire, J.REGISTRY), (TWire, T.REGISTRY)):
        fams = ("nornicdb_wire_cache_hits_total", "nornicdb_wire_cache_misses_total",
                "nornicdb_wire_cache_invalidations_total")
        before = [reg.get(f).labels("twin-wire").value if reg.get(f) else 0.0 for f in fams]
        w = cls(max_size=2, name="twin-wire")
        w.get("search", b"q1", 1)
        w.put("search", b"q1", 1, b"r1")
        w.get("search", b"q1", 1)
        w.get("search", b"q1", 2)  # outdated by a write
        w.put("search", b"q2", 2, b"r2")
        w.put("search", b"q3", 2, b"r3")  # evicts q1
        w.get("search", b"q1", 2)
        w.get("search", b"q3", 2)
        after = [reg.get(f).labels("twin-wire").value for f in fams]
        lru = {k: v for k, v in w.stats().items() if not k.startswith("wire_")}
        stats.append(([a - b for a, b in zip(after, before)], lru))
    assert stats[0] == stats[1]
    assert stats[1][0] == [2.0, 3.0, 1.0]


# ---------------------------------------------------------------------------
# cost: every price over a grid of shapes
# ---------------------------------------------------------------------------

_PRICE_GRID = {
    "price_brute": [dict(b=b, rows=r, d=d) for b in (1, 5, 64)
                    for r in (1, 8192, 131072) for d in (1, 160, 1024)],
    "price_walk": [dict(b=b, d=d, iters=i, width=w, degree=g, itopk=p, n_seeds=s)
                   for b in (1, 64) for d in (32, 160) for i in (8, 13) for w in (1, 8)
                   for g in (32,) for p in (64, 128) for s in (256, 1024)],
    "price_int8_coarse": [dict(b=b, rows=r, d=d) for b in (1, 64) for r in (8192, 131072)
                          for d in (64, 1024)],
    "price_pq_adc": [dict(b=b, rows=r, m=m, n_codes=c, d_sub=160 // m) for b in (1, 8)
                     for r in (8192, 100000) for m in (8, 40) for c in (16, 256)],
    "price_tiered_route": [dict(b=b, parts=p, d=d) for b in (1, 4) for p in (24, 256)
                           for d in (160, 1024)],
    "price_rerank": [dict(b=b, pool=p, d=d) for b in (1, 64) for p in (64, 512) for d in (160,)],
    "price_walk_quant": [dict(b=b, d=160, iters=13, width=w, degree=32, itopk=128,
                              head_dims=h, keep=k, n_seeds=1024)
                         for b in (1, 64) for w in (1, 8) for h in (16, 32) for k in (24, 192)],
    "price_walk_pq": [dict(b=b, d=160, iters=13, width=8, degree=32, itopk=p, m=40,
                           n_codes=256, n_seeds=1024) for b in (1, 8) for p in (128, 512)],
    "price_chain_topk": [dict(b=b, f=f, kp=k) for b in (1, 64) for f in (10, 5000)
                         for k in (8, 64)],
    "price_graph_agg": [dict(e1=a, e2=c, n=n) for a in (10, 1365126) for c in (0, 500)
                        for n in (1, 150090)],
    "price_cooc_gram": [dict(m=m, a=a, bcols=c) for m in (10, 100000) for a in (1, 50)
                        for c in (1, 300)],
    "price_traverse_rank": [dict(b=b, frontier=f, d=160, kp=k) for b in (1, 64)
                            for f in (10, 50000) for k in (8, 64)],
    "price_upsert": [dict(n_points=n, d=d) for n in (1, 1000) for d in (160, 1024)],
    "price_decay_sweep": [dict(m=m) for m in (0, 1, 100000)],
    "price_linkpredict": [dict(b=b, f1=a, f2=c, kp=k) for b in (1, 256) for a in (3, 300)
                          for c in (0, 9000) for k in (16, 64)],
    "price_fastrp": [dict(n=n, edges=e, dim=d, iters=i) for n in (10, 100000)
                     for e in (0, 300000) for d in (64, 256) for i in (1, 3)],
    "price_bm25": [dict(b=b, nnz=z, unique_terms=u, rows=r) for b in (1, 64)
                   for z in (0, 12345) for u in (0, 1, 40) for r in (4096, 131072)],
}


def test_every_price_is_in_the_grid():
    prices = {n for n in dir(t_cost) if n.startswith("price_")}
    assert prices == {n for n in dir(j_cost) if n.startswith("price_")}
    assert prices == set(_PRICE_GRID)


@pytest.mark.parametrize("name", sorted(_PRICE_GRID))
def test_prices_match_over_the_grid(name):
    import inspect

    jf, tf = getattr(j_cost, name), getattr(t_cost, name)
    params = set(inspect.signature(jf).parameters)
    assert params == set(inspect.signature(tf).parameters)
    for kw in _PRICE_GRID[name]:
        assert set(kw) <= params, (name, kw)
        assert tf(**kw) == jf(**kw), (name, kw)


class _Res:
    def __init__(self, **stats):
        self.stats = stats

    def resource_stats(self):
        return dict(self.stats)


def test_record_query_cost_and_summary_match(twin):
    outs = []
    for side in twin:
        reg = side.metrics.Registry()
        for fam, helptext in (("nornicdb_query_cost_flops_total", "f"),
                              ("nornicdb_query_cost_bytes_total", "b"),
                              ("nornicdb_query_cost_queries_total", "q")):
            reg.counter(fam, helptext, labels=("kind", "index"))
        f = reg.get("nornicdb_query_cost_flops_total")
        f.labels("brute", "service:twin").inc(2 * 64 * 131072 * 160)
        reg.get("nornicdb_query_cost_bytes_total").labels("brute", "service:twin").inc(9e7)
        reg.get("nornicdb_query_cost_queries_total").labels("brute", "service:twin").inc(40)
        outs.append(side.cost.cost_summary(reg))
        obj = _Res()
        side.res.register("brute", "service:twin-cost", obj)
        assert side.cost.cost_name(obj) == "service:twin-cost"
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the calibration plane
# ---------------------------------------------------------------------------


def _feed(side, kind, b, k, first_s, steady_s, n_steady):
    side.dev.observe_dispatch(kind, b, k, first_s, True)
    for _ in range(n_steady):
        side.dev.observe_dispatch(kind, b, k, steady_s, False)


def test_ewma_predict_abstain_and_answer_match(twin):
    for side in twin:
        _feed(side, "twin_kind", 4, 16, 0.5, 0.002, 7)
        assert side.dev.predict_ms("twin_kind", 4) is None  # below min samples
    for side in twin:
        side.dev.observe_dispatch("twin_kind", 4, 16, 0.004, False)
        for v in (0.003, 0.001, 0.0025):
            side.dev.observe_dispatch("twin_kind", 4, 16, v, False)
    preds = [side.dev.predict_ms("twin_kind", 4) for side in twin]
    assert preds[0] is not None and preds[0] == preds[1]
    assert [side.dev.predict_ms("twin_kind", 8) for side in twin] == [None, None]
    assert [side.dev.predict_ms("unknown", 4) for side in twin] == [None, None]


def test_calibration_summary_matches_with_cost_join(twin):
    sums = []
    for side in twin:
        # the recompile counter is the process registry's monotone total
        recompiles0 = side.dev.calibration_summary()["unexpected_recompiles"]
        for b, n in ((1, 12), (8, 9), (64, 3)):
            _feed(side, "microbatch", b, 32, 0.2 + b * 1e-3, 1e-3 * (1 + b / 8), n)
        with side.dev.dispatch_scope("microbatch"):
            side.dev.note_real_rows(5.0)
            side.cost.record_query_cost("brute", "service:twin", 8,
                                        *side.cost.price_brute(8, 131072, 160))
            side.dsp.record_dispatch("brute_inner", 8, 32, 0.001)
        side.cost.record_query_cost("bm25_score", "service:twin", 1,
                                    *side.cost.price_bm25(1, 300, 3, 131072))
        _feed(side, "bm25_score", 1, 32, 0.05, 3e-4, 10)
        cal = side.dev.calibration_summary()
        cal["unexpected_recompiles"] -= recompiles0
        sums.append(cal)
    assert sums[0] == sums[1]
    cal = sums[1]
    assert "microbatch" in cal["calibrated_kinds"]
    assert cal["kinds"]["brute_inner"]["top_dispatches"] == 0  # nested
    assert cal["kinds"]["microbatch"]["padding_efficiency"] is not None


def test_compile_split_on_a_patched_clock(twin, monkeypatch):
    """Each package's MicroBatcher over a host dispatch whose only clock
    advance is inside the dispatch: the first call 50 ms (the first use),
    later calls 2 ms. The dispatch universe, the calibration's compile
    split and the first-call gauge agree."""
    from nornicdb_tpu.search import microbatch as j_mb
    from nornicdb_tpu_torch.search import microbatch as t_mb

    docs = []
    for side, mb_mod in zip(twin, (j_mb, t_mb)):
        clock = {"t": 1000.0, "n": 0}
        fake = types.SimpleNamespace(time=lambda: clock["t"], perf_counter=time.perf_counter,
                                     sleep=time.sleep, monotonic=time.monotonic)
        monkeypatch.setattr(mb_mod, "time", fake)

        def search_batch(q, k, clock=clock):
            clock["t"] += 0.05 if clock["n"] == 0 else 0.002
            clock["n"] += 1
            return [[("x", 1.0)] * k for _ in range(len(q))]

        mb = mb_mod.MicroBatcher(search_batch, surface="twin-clock")
        for i in range(12):
            mb.search(np.ones(8, np.float32), 10)
        cal = side.dev.calibration_summary()["kinds"]["microbatch"]
        docs.append((side.dsp.compile_universe(), cal))
    assert docs[0] == docs[1]
    universe, cal = docs[1]
    assert universe == [{"kind": "microbatch", "b": 1, "k": 16, "dispatches": 12,
                         "first_call_ms": 50.0, "mean_ms": pytest.approx(6.0, abs=1e-3)}]
    assert cal["compile_s_est"] == pytest.approx(0.048, abs=1e-9)


def test_warm_recompile_counts_and_journals_the_same(twin, monkeypatch):
    monkeypatch.setenv("NORNICDB_DEVICE_RECOMPILE_WARMUP", "4")
    evs = []
    for side in twin:
        side.dev.reload()
        before = side.dev.calibration_summary()["unexpected_recompiles"]
        _feed(side, "twin_rc", 1, 8, 0.1, 0.001, 5)
        side.dev.observe_dispatch("twin_rc", 2, 8, 0.2, True)  # warm: churn
        after = side.dev.calibration_summary()["unexpected_recompiles"]
        assert after - before == 1
        evs.append([{k: v for k, v in e.items() if k not in ("ts", "seq", "t")}
                    for e in side.events.event_snapshot(limit=5)
                    if e.get("kind") == "recompile"])
    assert evs[0] == evs[1] and len(evs[1]) == 1


# ---------------------------------------------------------------------------
# the memory ledger
# ---------------------------------------------------------------------------


def test_ledger_drift_episodes_match_under_one_probe(twin, monkeypatch):
    monkeypatch.setenv("NORNICDB_DEVICE_MEM_DRIFT_BYTES", str(1 << 20))
    monkeypatch.setenv("NORNICDB_DEVICE_MEM_DRIFT_S", "10")
    backend = [0.0]
    keep = []
    for side in twin:
        side.dev.reload()
        side.dev.set_backend_probe(lambda: backend[0])
        a = _Res(device_bytes=4 << 20, rows=10)
        b = _Res(device_bytes=1 << 20, quant_device_bytes=512, tiered_device_bytes=256,
                 host_bytes=99)
        keep += [a, b]
        side.res.register("brute", "twin:a", a)
        side.res.register("cagra", "twin:b", b)
    steps = [(0.0, 5 << 20), (1.0, 9 << 20), (5.0, 9 << 20), (12.0, 9 << 20),
             (13.0, 9 << 20), (14.0, 5 << 20), (20.0, 12 << 20), (31.0, 12 << 20)]
    seqs = [[], []]
    for now, val in steps:
        backend[0] = float(val)
        for i, side in enumerate(twin):
            seqs[i].append(side.dev.reconcile(now=now))
    assert seqs[0] == seqs[1]
    assert seqs[1][0]["ledger_bytes"] == (5 << 20) + 768
    assert [r["leak_suspected"] for r in seqs[1]] == [False, False, False, True, True,
                                                       False, False, True]
    docs = [side.dev.device_summary() for side in twin]
    for d in docs:
        d["memory"].pop("sustained_s")
    assert docs[0]["memory"] == docs[1]["memory"]


def test_backend_bytes_is_none_on_the_cpu_where_jax_sums_live_arrays(twin):
    """C30: PyTorch keeps no live-tensor ledger, so without a probe the
    port's reconcile abstains on the CPU; the reference sums
    ``jax.live_arrays()`` there. A CPU resource's device is learned, and
    a lazily resolving ``device`` property is never forced."""
    import jax.numpy as jnp
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex
    from nornicdb_tpu_torch.storage.memory import MemoryEngine
    from nornicdb_tpu_torch.query.device_graph import DeviceGraphPlane
    from nornicdb_tpu_torch.query.columnar import ColumnarCatalog

    held = jnp.ones((256,), jnp.float32)  # noqa: F841 -- a live array
    assert j_dev.backend_bytes() is not None and j_dev.backend_bytes() >= 1024
    plane = DeviceGraphPlane(ColumnarCatalog(MemoryEngine()))  # device=None, lazy
    t_res.register("device_graph", "twin:lazy", plane)
    assert t_dev.backend_bytes() is None
    assert plane._device is None  # not resolved by the ledger
    idx = BruteForceIndex(device="cpu")
    t_res.register("brute", "twin:cpu", idx)
    assert str(t_dev.ledger_device()) == "cpu"
    assert t_dev.backend_bytes() is None
    rec = t_dev.reconcile()
    assert rec["backend_bytes"] is None and rec["drift_bytes"] is None


def test_a_device_fault_in_a_scrape_propagates_where_jax_swallows_it(twin):
    """C30: a RuntimeError (a CUDA error, OOM, NotPortedError) from the
    ledger's probe or a collector is raised by the port's render; the
    reference's scrape swallows every exception."""
    def fault():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    for side in twin:
        side.dev.set_backend_probe(fault)
    J.REGISTRY.render()  # swallowed
    with pytest.raises(RuntimeError, match="illegal memory access"):
        T.REGISTRY.render()
    with pytest.raises(RuntimeError):
        t_dev.device_summary()
    t_dev.set_backend_probe(None)
    # an ordinary probe failure is still swallowed by the scrape, as the reference's
    t_dev.set_backend_probe(lambda: (_ for _ in ()).throw(ValueError("no backend")))
    T.REGISTRY.render()


def test_maybe_sync_on_host_results_samples_without_a_sync(twin, monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: synced.append(d))
    for side in twin:
        assert side.dev.maybe_sync([[("a", 1.0)]]) is True
    assert t_dev.maybe_sync({"s": torch.zeros(3), "rows": [torch.ones(2)]}) is True
    assert synced == []  # CPU tensors: nothing to synchronize
    monkeypatch.setenv("NORNICDB_DEVICE_TIMING_SAMPLE", "0")
    for side in twin:
        side.dev.reload()
        assert side.dev.maybe_sync([1]) is False


def test_disabled_layer_records_nothing(twin):
    for side in twin:
        side.metrics.set_enabled(False)
        try:
            side.dsp.record_dispatch("twin_off", 1, 1, 0.1)
            assert side.dev.maybe_sync([1]) is False
        finally:
            side.metrics.set_enabled(True)
        assert side.dsp.compile_universe() == []


# ---------------------------------------------------------------------------
# the overhead guard (the reference's tests/test_observability.py)
# ---------------------------------------------------------------------------


def test_instrumented_microbatch_path_within_budget(twin):
    """The port's MicroBatcher instrumented (histograms, dispatch record,
    calibration sample, stage split and spans under a root trace) against
    the same path with the layer off: within 2x + 1 ms per op."""
    from nornicdb_tpu_torch.search.microbatch import MicroBatcher
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    idx = BruteForceIndex(device="cpu")
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((512, 32)).astype(np.float32)
    idx.add_batch([(f"v{i}", vecs[i]) for i in range(512)])
    mb = MicroBatcher(idx.search_batch, surface="t-overhead")
    n = 300

    def measure():
        for i in range(30):
            mb.search(vecs[i], 10)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(n):
                with T.trace("wire", method="/overhead"):
                    mb.search(vecs[i % 512], 10)
            best = min(best, time.perf_counter() - t0)
        return best

    assert T.exemplars_enabled()
    t_on = measure()
    fam = T.REGISTRY.get("nornicdb_request_stage_seconds")
    assert ("t-overhead", "device_dispatch") in fam.children()
    T.set_enabled(False)
    try:
        t_off = measure()
    finally:
        T.set_enabled(True)
    assert t_on <= t_off * 2.0 + n * 1e-3, f"instrumented {t_on:.4f}s vs bare {t_off:.4f}s"


def test_primitive_costs_within_budget():
    r = t_metrics.Registry()
    c = r.counter("nornicdb_ov_total", "t")
    h = r.histogram("nornicdb_ov_seconds", "t")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        c.inc()
    counter_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        h.observe(0.001)
    observe_us = (time.perf_counter() - t0) / n * 1e6
    n = 2_000
    t0 = time.perf_counter()
    for _ in itertools.repeat(None, n):
        with T.trace("wire", method="/ov"):
            with T.span("child"):
                pass
    trace_us = (time.perf_counter() - t0) / n * 1e6
    assert counter_us < 50, f"counter inc {counter_us:.1f}us/op"
    assert observe_us < 50, f"histogram observe {observe_us:.1f}us/op"
    assert trace_us < 500, f"trace+span {trace_us:.1f}us/req"
