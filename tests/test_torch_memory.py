"""The port's AI-native memory plane (``filters.py``, ``decay.py``,
``temporal.py``, ``linkpredict.py``, ``inference.py`` and the DB's
``decay``/``temporal``/``inference``/``remember``/``store(auto_link=True)``)
against the JAX package's, on the same seeded inputs with pinned clocks.

These modules are host Python in both packages, copied but for the
admission lanes, so their answers are held equal: Kalman states, decay
scores, tiers, sweeps, temporal statistics and patterns, link-prediction
scores and rankings bitwise; where a score comes from a vector search
(``hybrid_predict``, inference's similarity), within 1e-6 (float32
products summed in another order), with the same ids."""

import dataclasses
import random
import time

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu import decay as jd
from nornicdb_tpu import filters as jf
from nornicdb_tpu import inference as ji
from nornicdb_tpu import linkpredict as jl
from nornicdb_tpu import temporal as jt
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.search.service import SearchService as JService
from nornicdb_tpu.storage import Edge as JEdge
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import Node as JNode
from nornicdb_tpu_torch import decay as td
from nornicdb_tpu_torch import filters as tf
from nornicdb_tpu_torch import inference as ti
from nornicdb_tpu_torch import linkpredict as tl
from nornicdb_tpu_torch import temporal as tt
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from nornicdb_tpu_torch.search.service import SearchService as TService
from nornicdb_tpu_torch.storage import Edge as TEdge
from nornicdb_tpu_torch.storage import MemoryEngine as TMemory
from nornicdb_tpu_torch.storage import Node as TNode

torch.set_num_threads(1)

SCORE_ATOL = 1e-6  # float32 cosines summed in another order
DAY_MS = 86_400_000
NOW_MS = 1_700_000_000_000
T0 = 1_700_000_000.0  # the temporal tracker's clock, seconds


def _vars(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(vars(obj))


# -- Kalman filters ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["KalmanFilter", "AdaptiveKalmanFilter"])
def test_scalar_kalman_filters_match_jax(kind, seed):
    rng = np.random.default_rng(seed)
    a, b = getattr(jf, kind)(), getattr(tf, kind)()
    for z in rng.normal(0.5, 0.3, 64).tolist():
        assert a.update(z) == b.update(z)
    assert _vars(a) == _vars(b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_velocity_kalman_filter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = jf.VelocityKalmanFilter(process_noise=1e-2, measurement_noise=0.5)
    b = tf.VelocityKalmanFilter(process_noise=1e-2, measurement_noise=0.5)
    t = 0.0
    for z in np.cumsum(rng.random(48)).tolist():
        t += float(rng.exponential(60.0))
        assert a.update(z, t) == b.update(z, t)
    assert vars(a) == vars(b)


# -- decay -------------------------------------------------------------------


def _memory_nodes(node_cls, n=120, seed=5):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        imp = rng.random()
        if i % 17 == 0:
            imp = "high"  # non-numeric importance must not abort sweeps
        elif i % 13 == 0:
            imp = 1.7  # clamped to [0, 1]
        out.append(node_cls(id=f"n{i}", labels=["M"], properties={"importance": imp},
                            created_at=NOW_MS - rng.randrange(0, 90 * DAY_MS)))
    return out


def _decay_pair(**kw):
    pair = []
    for mem_cls, node_cls, mod in ((JMemory, JNode, jd), (TMemory, TNode, td)):
        eng = mem_cls()
        for node in _memory_nodes(node_cls):
            eng.create_node(node)
        dm = mod.DecayManager(eng, **kw)
        rng = random.Random(9)
        for _ in range(400):
            dm.record_access(f"n{rng.randrange(60)}",
                             at_ms=NOW_MS - rng.randrange(0, 30 * DAY_MS))
        pair.append((eng, dm))
    return pair


def _archived(eng):
    return sorted((n.id, n.properties.get("_archived_at")) for n in eng.all_nodes()
                  if n.properties.get("_archived"))


@pytest.mark.parametrize("kw", [
    {},
    {"use_kalman": False, "archive_threshold": 0.3},
    {"archive_threshold": 0.45, "recency_weight": 0.6, "frequency_weight": 0.2,
     "importance_weight": 0.2},
    {"half_life_ms": {"EPISODIC": DAY_MS, "SEMANTIC": 10 * DAY_MS, "PROCEDURAL": 100 * DAY_MS}},
], ids=["default", "no_kalman", "weights", "half_lives"])
def test_decay_manager_scores_tiers_and_sweeps_match_jax(kw):
    (je, jdm), (te, tdm) = _decay_pair(**kw)
    for i in range(120):
        assert jdm.tier_of(f"n{i}") == tdm.tier_of(f"n{i}")
    for now in (NOW_MS, NOW_MS + 3 * DAY_MS):
        for i in range(120):
            a = jdm.score(je.get_node(f"n{i}"), now)
            b = tdm.score(te.get_node(f"n{i}"), now)
            assert _vars(a) == _vars(b)
    for now in (NOW_MS + 5 * DAY_MS, NOW_MS + 40 * DAY_MS):
        assert jdm.sweep(now) == tdm.sweep(now)
        assert _archived(je) == _archived(te)
    for tier in ("EPISODIC", "SEMANTIC", "PROCEDURAL"):
        assert jdm.half_life(tier) == tdm.half_life(tier)


def test_decay_promotion_climbs_tiers_as_jax():
    tiers = []
    for mod in (jd, td):
        dm = mod.DecayManager(TMemory())
        seen = []
        for k in range(30):
            dm.record_access("x", at_ms=NOW_MS + k)
            seen.append(dm.tier_of("x"))
        tiers.append(seen)
        assert mod.HALF_LIFE_MS == jd.HALF_LIFE_MS
        assert mod.PROMOTE_ACCESSES == jd.PROMOTE_ACCESSES
    assert tiers[0] == tiers[1]
    assert tiers[1][3] == "EPISODIC" and tiers[1][4] == "SEMANTIC"
    assert tiers[1][24] == "PROCEDURAL"


# -- temporal ----------------------------------------------------------------


def _access_stream(seed, n=600, nodes=12):
    """(node, at) pairs over ~20 days: a daily-peaked node, a weekly one,
    a late burst, and co-accessed pairs inside the 5-minute window."""
    rng = random.Random(seed)
    out = []
    t = T0
    for _ in range(n):
        t += rng.choice([20.0, 45.0, 200.0, 2400.0, 9000.0])
        out.append((f"m{rng.randrange(nodes)}", t))
    for d in range(14):  # m_daily at 09:xx every day
        out.append(("m_daily", T0 - T0 % 86400 + d * 86400 + 9 * 3600 + rng.random() * 600))
    for w in range(4):  # m_weekly on one weekday
        for k in range(3):
            out.append(("m_weekly", T0 + w * 7 * 86400 + k * 3600))
    end = max(at for _, at in out)
    for k in range(10):  # a burst in the last hour
        out.append(("m_burst", end + k * 60.0))
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_temporal_tracker_matches_jax(seed):
    stream = _access_stream(seed)
    trackers = [jt.TemporalTracker(history_limit=2000), tt.TemporalTracker(history_limit=2000)]
    for nid, at in stream:
        for tr in trackers:
            tr.record_access(nid, at=at)
    a, b = trackers
    end = max(at for _, at in stream)
    assert a.session == b.session
    assert a.hot_nodes(20) == b.hot_nodes(20)
    for nid in sorted({nid for nid, _ in stream}):
        assert _vars(a.stats(nid)) == _vars(b.stats(nid))
        assert a.co_accessed(nid) == b.co_accessed(nid)
        assert a.co_accessed(nid, window_s=60.0) == b.co_accessed(nid, window_s=60.0)
        for now in (end, end + 7200.0):
            assert [_vars(p) for p in a.detect_patterns(nid, now=now)] \
                == [_vars(p) for p in b.detect_patterns(nid, now=now)]
        assert a.patterns.peak_access_time(nid) == b.patterns.peak_access_time(nid)
    assert a.stats("absent") is None and b.stats("absent") is None
    ev_a, ev_b = a.evolution, b.evolution
    for name in ("strengthening", "weakening"):
        assert [_vars(t) for t in getattr(ev_a, name)(50)] \
            == [_vars(t) for t in getattr(ev_b, name)(50)]
    for now in (end, end + 30 * 86400.0):
        assert [_vars(t) for t in ev_a.emerging(50, now=now)] \
            == [_vars(t) for t in ev_b.emerging(50, now=now)]
    kinds = {p.type for nid in ("m_daily", "m_weekly", "m_burst")
             for p in b.detect_patterns(nid, now=end + 600.0)}
    assert {"daily", "weekly", "burst"} <= kinds


def test_pattern_detector_and_relationship_evolution_match_jax():
    outs = []
    for mod in (jt, tt):
        pd = mod.PatternDetector(min_accesses=4)
        for k in range(12):
            pd.record_access("p", at=T0 + k * 86400.0 + 3600.0 * (k % 2))
        ev = mod.RelationshipEvolution(max_edges=20)
        for k in range(60):  # eviction at 20 pairs, then decayed updates
            ev.record_co_access(f"a{k % 25}", f"b{k % 7}", weight=1.0 + k % 3, at=T0 + k * 3600.0)
        for k in range(6):
            ev.update_weight("a1", "b1", 5.0 - k, at=T0 + (70 + k) * 3600.0)
        outs.append((
            [_vars(p) for p in pd.detect_patterns("p", velocity=0.5, now=T0 + 12 * 86400.0)],
            [_vars(p) for p in pd.detect_patterns("p", velocity=-0.5, now=T0)],
            pd.has_pattern("p", "growing", velocity=0.5), pd.peak_access_time("p"),
            sorted(ev._edges), _vars(ev.get_trend("a1", "b1")),
            ev.predict_strength("a1", "b1", steps=3), ev.should_prune("a1", "b1"),
            ev.should_prune("zz", "yy"), ev.get_trend("zz", "yy"),
        ))
        pd.reset_node("p")
        assert pd.peak_access_time("p") == (0, 0, 0.0)
    assert outs[0] == outs[1]


# -- link prediction ---------------------------------------------------------


def _graph_pair(n=80, e=320, seed=11, embed_dims=0):
    """The same seeded graph in both packages' memory engines; with
    ``embed_dims``, every node carries a seeded unit embedding."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    emb = nrng.standard_normal((n, max(1, embed_dims))).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    edges = [(f"g{rng.randrange(n)}", f"g{rng.randrange(n)}", rng.choice(["KNOWS", "LIKES"]))
             for _ in range(e)]
    engines = []
    for mem_cls, node_cls, edge_cls in ((JMemory, JNode, JEdge), (TMemory, TNode, TEdge)):
        eng = mem_cls()
        for i in range(n):
            eng.create_node(node_cls(id=f"g{i}", labels=["G"], properties={"content": f"g{i}"},
                                     embedding=emb[i].tolist() if embed_dims else None))
        for j, (s, d, t) in enumerate(edges):
            eng.create_edge(edge_cls(id=f"e{j}", type=t, start_node=s, end_node=d))
        engines.append(eng)
    return engines


@pytest.mark.parametrize("method", sorted(jl.SCORERS))
def test_scorers_and_predict_links_match_jax(method):
    je, te = _graph_pair()
    js, ts = jl.AdjacencySnapshot(je), tl.AdjacencySnapshot(te)
    assert js.neighbors == ts.neighbors
    for a in range(0, 80, 7):
        for b in range(80):
            x, y = f"g{a}", f"g{b}"
            assert jl.SCORERS[method](js, x, y) == tl.SCORERS[method](ts, x, y)
    for i in range(80):
        sid = f"g{i}"
        assert jl.predict_links(je, sid, method=method, limit=10) \
            == tl.predict_links(te, sid, method=method, limit=10)
        cands = [f"g{k}" for k in range(0, 80, 3)]
        assert jl.predict_links(je, sid, method=method, limit=5, candidates=cands) \
            == tl.predict_links(te, sid, method=method, limit=5, candidates=cands)
    assert tl.predict_links(te, "absent", method=method) == []


def test_predict_links_rejects_an_unknown_method_as_jax():
    je, te = _graph_pair(n=10, e=20)
    with pytest.raises(ValueError) as want:
        jl.predict_links(je, "g0", method="nosuch")
    with pytest.raises(ValueError) as got:
        tl.predict_links(te, "g0", method="nosuch")
    assert str(got.value) == str(want.value)


def _services(je, te, n):
    jsvc, tsvc = JService(je), TService(te, device="cpu")
    for i in range(n):
        jsvc.index_node(je.get_node(f"g{i}"))
        tsvc.index_node(te.get_node(f"g{i}"))
    return jsvc, tsvc


def _same_scored(a, b, key_len):
    """Equal ids in order; float fields within SCORE_ATOL."""
    assert [r[0] for r in a] == [r[0] for r in b]
    for ra, rb in zip(a, b):
        assert np.allclose(ra[1:key_len], rb[1:key_len], rtol=0.0, atol=SCORE_ATOL), (ra, rb)


@pytest.mark.parametrize("weight", [0.0, 0.5, 1.0])
def test_hybrid_predict_matches_jax(weight):
    je, te = _graph_pair(n=60, e=180, embed_dims=16)
    jsvc, tsvc = _services(je, te, 60)
    for i in range(0, 60, 4):
        a = jl.hybrid_predict(je, jsvc, f"g{i}", topology_weight=weight, limit=6)
        b = tl.hybrid_predict(te, tsvc, f"g{i}", topology_weight=weight, limit=6)
        _same_scored(a, b, 4)
    assert tl.hybrid_predict(te, tsvc, "absent") == [] == jl.hybrid_predict(je, jsvc, "absent")
    assert tl.hybrid_predict(te, None, "g1", limit=4) == jl.hybrid_predict(je, None, "g1", limit=4)


def test_adjacency_snapshot_is_cached_per_catalog_version():
    from nornicdb_tpu_torch.query.columnar import ColumnarCatalog

    _, te = _graph_pair(n=20, e=40)
    cat = ColumnarCatalog(te)
    s1 = tl.adjacency_snapshot(te, cat)
    assert tl.adjacency_snapshot(te, cat) is s1
    assert tl.adjacency_snapshot(te) is not s1  # no catalog: built per call
    e = TEdge(id="bump", type="LIKES", start_node="g1", end_node="g7")
    te.create_edge(e)
    cat.apply_edge_created(e)
    assert tl.adjacency_snapshot(te, cat) is not s1


# -- inference ---------------------------------------------------------------


def _edges(eng, types=None):
    out = []
    for e in eng.all_edges():
        if types is None or e.type in types:
            p = e.properties
            out.append((e.start_node, e.end_node, e.type, round(p.get("confidence", -1.0), 5),
                        p.get("inferred"), p.get("reason")))
    return sorted(out)


def _sug(s):
    return (s.from_id, s.to_id, s.rel_type, s.reason)


def _close_clusters(n=48, d=16, seed=2):
    """Unit vectors in tight clusters of four: similarities above the
    0.75 threshold inside a cluster, below it across."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((n // 4, d))
    x = cent.repeat(4, axis=0) + 0.15 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inference_pair(n=48, **kw):
    vecs = _close_clusters(n)
    out = []
    for mem_cls, node_cls, mod, svc_of in (
            (JMemory, JNode, ji, lambda e: JService(e)),
            (TMemory, TNode, ti, lambda e: TService(e, device="cpu"))):
        eng = mem_cls()
        svc = svc_of(eng)
        for i in range(n):
            node = node_cls(id=f"v{i}", labels=["M"], properties={"content": f"memory {i}"},
                            embedding=vecs[i].tolist())
            eng.create_node(node)
            svc.index_node(eng.get_node(node.id))
        out.append((eng, svc, mod.InferenceEngine(eng, svc, **kw)))
    return out


@pytest.mark.parametrize("kw", [{}, {"similarity_threshold": 0.5, "max_links_per_store": 5},
                                {"min_confidence": 0.95}], ids=["default", "wide", "strict"])
def test_on_store_matches_jax(kw, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    (je, _, jinf), (te, _, tinf) = _inference_pair(**kw)
    for i in range(0, 48, 3):
        a = jinf.on_store(je.get_node(f"v{i}"))
        b = tinf.on_store(te.get_node(f"v{i}"))
        assert [_sug(s) for s in a] == [_sug(s) for s in b]
        assert np.allclose([s.confidence for s in a], [s.confidence for s in b],
                           rtol=0.0, atol=SCORE_ATOL)
    assert _edges(je) == _edges(te)
    assert jinf.created_count == tinf.created_count


def test_on_store_best_of_chunks_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    (je, _, jinf), (te, _, tinf) = _inference_pair()
    vecs = _close_clusters()
    for eng, inf, cls in ((je, jinf, JNode), (te, tinf, TNode)):
        node = cls(id="chunked", labels=["M"], properties={},
                   chunk_embeddings=[vecs[1].tolist(), vecs[21].tolist()])
        eng.create_node(node)
        inf.on_store(node)
        assert inf.on_store(cls(id="bare", labels=["M"], properties={})) == []
    assert _edges(je) == _edges(te)
    assert any(e[0] == "chunked" for e in _edges(te))


def test_on_store_batch_matches_per_node_path_and_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    (je, _, jinf), (te, _, tinf) = _inference_pair()
    ids = [f"v{i}" for i in range(0, 48, 5)]
    a = jinf.on_store_batch([je.get_node(i) for i in ids])  # no plane: per node
    b = tinf.on_store_batch([te.get_node(i) for i in ids])
    assert {k: [_sug(s) for s in v] for k, v in a.items()} \
        == {k: [_sug(s) for s in v] for k, v in b.items()}
    assert _edges(je) == _edges(te)
    assert ti.InferenceEngine(te).on_store_batch([te.get_node("v0")]) == {"v0": []}


def test_cooldown_arms_and_expires_as_jax(monkeypatch):
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    for mod in (ji, ti):
        inf = mod.InferenceEngine(TMemory(), cooldown_s=300.0)
        assert inf._peek_cooldown("a", "b") is False
        assert inf._on_cooldown("a", "b") is False  # arms
        assert inf._on_cooldown("b", "a") is True  # the pair is unordered
        assert inf._peek_cooldown("a", "b") is True
        clock[0] += 301.0
        assert inf._on_cooldown("a", "b") is False
        clock[0] = T0


def _transitive_engines():
    out = []
    for mem_cls, node_cls, edge_cls in ((JMemory, JNode, JEdge), (TMemory, TNode, TEdge)):
        eng = mem_cls()
        for i in range(8):
            eng.create_node(node_cls(id=f"t{i}", labels=["M"], properties={}))
        for j, (s, d, t) in enumerate([("t0", "t1", "SIMILAR_TO"), ("t1", "t2", "SIMILAR_TO"),
                                       ("t3", "t0", "RELATES_TO"), ("t3", "t4", "RELATES_TO"),
                                       ("t1", "t5", "KNOWS"), ("t2", "t6", "SIMILAR_TO"),
                                       ("t6", "t1", "RELATES_TO"), ("t4", "t7", "SIMILAR_TO")]):
            eng.create_edge(edge_cls(id=f"x{j}", type=t, start_node=s, end_node=d))
        out.append(eng)
    return out


@pytest.mark.parametrize("limit", [1, 2, 5])
def test_suggest_transitive_matches_jax(limit):
    je, te = _transitive_engines()
    for i in range(8):
        a = ji.InferenceEngine(je).suggest_transitive(f"t{i}", limit=limit)
        b = ti.InferenceEngine(te).suggest_transitive(f"t{i}", limit=limit)
        assert [_vars(s) for s in a] == [_vars(s) for s in b]


def test_on_access_with_evidence_matches_jax(monkeypatch):
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    runs = []
    for mem_cls, node_cls, tmod, imod in ((JMemory, JNode, jt, ji), (TMemory, TNode, tt, ti)):
        eng = mem_cls()
        for i in range(4):
            eng.create_node(node_cls(id=f"c{i}", labels=["M"], properties={}))
        tracker = tmod.TemporalTracker()
        inf = imod.InferenceEngine(eng, evidence=imod.EvidenceBuffer(), cooldown_s=60.0)
        got = []
        for k in range(16):
            clock[0] = T0 + k * 20.0
            tracker.record_access("c0", at=clock[0])
            tracker.record_access(f"c{1 + k % 3}", at=clock[0] + 5.0)
            got.append([_vars(s) for s in inf.on_access(tracker, f"c{1 + k % 3}")])
        runs.append((got, _edges(eng), inf.evidence.stats()))
        clock[0] = T0
    assert runs[0] == runs[1]
    assert runs[1][1], "co-access evidence never materialized an edge"


def test_on_access_without_evidence_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    runs = []
    for mem_cls, node_cls, tmod, imod in ((JMemory, JNode, jt, ji), (TMemory, TNode, tt, ti)):
        eng = mem_cls()
        for i in range(3):
            eng.create_node(node_cls(id=f"c{i}", labels=["M"], properties={}))
        tracker = tmod.TemporalTracker()
        for k in range(6):
            tracker.record_access("c0", at=T0 + k)
            tracker.record_access("c1", at=T0 + k + 0.5)
        inf = imod.InferenceEngine(eng)
        runs.append(([_vars(s) for s in inf.on_access(tracker, "c0", min_count=3)], _edges(eng)))
    assert runs[0] == runs[1] and runs[1][0]


@pytest.mark.parametrize("scores", [[0.6, 0.5, 0.6], [2.0], [0.1] * 6, [0.9, 0.9, 0.9, 0.9]])
def test_evidence_buffer_matches_jax(scores):
    runs = []
    for mod in (ji, ti):
        buf = mod.EvidenceBuffer(
            thresholds={"FAST": mod.EvidenceThreshold(min_count=1, min_score=0.5)},
            default=mod.EvidenceThreshold(min_count=3, min_score=1.5, max_age_s=100.0))
        got = []
        for label in ("SLOW", "FAST"):
            for k, s in enumerate(scores):
                ev = buf.add("a", "b", label, s, signal=f"sig{k % 2}",
                             session=f"s{k}", at=T0 + 30.0 * k)
                got.append(None if ev is None else _vars(ev))
        buf.add("x", "y", "SLOW", 0.2, at=T0)
        if got[0] is None and scores[0] < 1.5:
            buf.restore(mod.Evidence(src="a", dst="b", label="SLOW", count=1, score_sum=0.1,
                                     first_ts=T0, last_ts=T0, sessions=set(), signals=[]))
        got.append(buf.expire(now=T0 + 120.0))
        got.append(buf.stats())
        buf.set_threshold("SLOW", mod.EvidenceThreshold(min_count=1, min_score=0.0))
        got.append(_vars(buf.add("p", "q", "SLOW", 0.0, session="s", at=T0)))
        runs.append(got)
    assert runs[0] == runs[1]


def _qc_pair(reply):
    out = []
    for mod, mem_cls, node_cls in ((ji, JMemory, JNode), (ti, TMemory, TNode)):
        eng = mem_cls()
        for i in range(4):
            eng.create_node(node_cls(id=f"q{i}", labels=["Doc"], properties={"content": f"doc {i}"}))
        calls = []

        def generate(prompt, calls=calls):
            calls.append(prompt)
            if reply is None:
                raise RuntimeError("model down")
            return reply

        sugs = [mod.Suggestion("q0", f"q{i}", "SIMILAR_TO", c, "similarity")
                for i, c in ((1, 0.8), (2, 0.95), (3, 0.6))]
        out.append((mod.HeimdallQC(generate), eng, sugs, calls))
    return out


@pytest.mark.parametrize("reply", ["Answers:\nY\nN\n", "N\nN", "Y", None],
                         ids=["one_each", "reject", "short", "error"])
def test_heimdall_qc_matches_jax(reply, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    runs = []
    for qc, eng, sugs, calls in _qc_pair(reply):
        first = [_vars(s) for s in qc.review_batch(eng, sugs)]
        second = [_vars(s) for s in qc.review_batch(eng, sugs)]
        runs.append((first, second, calls, qc.batches, qc.suggestions_in, qc.suggestions_out,
                     qc.cache_hits, qc.errors))
    assert runs[0] == runs[1]


def test_inference_with_qc_gates_edges_as_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    (je, _, jinf), (te, _, tinf) = _inference_pair(similarity_threshold=0.5)
    jinf.qc = ji.HeimdallQC(lambda p: "N\n" * 10, min_confidence_to_skip=0.97)
    tinf.qc = ti.HeimdallQC(lambda p: "N\n" * 10, min_confidence_to_skip=0.97)
    for i in range(0, 48, 4):
        jinf.on_store(je.get_node(f"v{i}"))
        tinf.on_store(te.get_node(f"v{i}"))
    assert _edges(je) == _edges(te)
    assert jinf.qc.suggestions_out == tinf.qc.suggestions_out


# -- the DB facade -------------------------------------------------------------


def _dbs():
    jdb = nornicdb_tpu.open(embedder=JHash(dims=16), auto_embed=False)
    tdb = nornicdb_tpu_torch.open(device="cpu", embedder=THash(dims=16), auto_embed=False)
    return jdb, tdb


def test_db_store_auto_link_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    vecs = _close_clusters(40)
    jdb, tdb = _dbs()
    try:
        for db in (jdb, tdb):
            db.search  # explicit embeddings index once the service exists
            for i in range(24):
                db.store(f"memory {i}", node_id=f"d{i}", embedding=vecs[i].tolist())
            for i in range(24, 40):
                db.store(f"memory {i}", node_id=f"d{i}", embedding=vecs[i].tolist(),
                         auto_link=True)
            db.store("no embedding", node_id="plain", auto_link=True)
        assert _edges(jdb.storage) == _edges(tdb.storage)
        inferred = _edges(tdb.storage, {"SIMILAR_TO"})
        assert inferred and all(e[4] is True and e[3] >= 0.75 for e in inferred)
        assert isinstance(tdb.inference, ti.InferenceEngine)
        assert isinstance(tdb.inference.evidence, ti.EvidenceBuffer)
        assert tdb.inference.search is tdb.search
    finally:
        jdb.close()
        tdb.close()


def test_db_remember_materializes_the_evidence_gated_edge_as_jax(monkeypatch):
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    runs = []
    for db in _dbs():
        try:
            for i in range(3):
                db.store(f"doc {i}", node_id=f"r{i}")
            assert db.remember("r2").id == "r2"  # no inference engine yet
            db.inference  # the store/auto-link path builds it
            seq = []
            for k in range(10):
                for nid in ("r0", "r1"):
                    clock[0] += 15.0
                    node = db.remember(nid)
                    seq.append((node.id, db.decay.tier_of(nid)))
            stats = {nid: _vars(db.temporal.stats(nid)) for nid in ("r0", "r1", "r2")}
            decay = [_vars(db.decay.score(db.storage.get_node(f"r{i}"), int(clock[0] * 1000)))
                     for i in range(3)]
            runs.append((seq, stats, decay, _edges(db.storage), db.inference.evidence.stats()))
        finally:
            db.close()
        clock[0] = T0
    assert runs[0] == runs[1]
    assert [e[2] for e in runs[1][3]] == ["CO_ACCESSED_WITH"]
    with pytest.raises(KeyError):
        tdb = nornicdb_tpu_torch.open(device="cpu", embedder=THash(dims=16), auto_embed=False)
        try:
            tdb.remember("absent")
        finally:
            tdb.close()


def test_db_remember_survives_a_failing_inference_as_jax(monkeypatch):
    for db in _dbs():
        try:
            db.store("doc", node_id="s0")
            inf = db.inference
            monkeypatch.setattr(inf, "on_access", lambda *a, **k: 1 / 0)
            assert db.remember("s0").id == "s0"
            assert db.temporal.stats("s0").count == 1
        finally:
            db.close()


def test_db_close_stops_the_decay_manager():
    _, tdb = _dbs()
    dm = tdb.decay
    assert tdb.decay is dm and tdb.temporal is tdb.temporal
    tdb.close()
    assert dm._stop.is_set()
