"""The port's device graph plane (``query/device_graph.py``,
``ops/graph.py``, ``search/microbatch.py:BatchCoalescer``) and
``DB.graph_vector_search``, held against the JAX package on the CPU.

The graph is the reference test's (``tests/test_device_graph.py:
_build_graph``), built in the JAX engine and copied record by record into
the port's. JAX runs its jitted programs on the CPU with
``NORNICDB_GRAPH_DEVICE=on``; the port runs its PyTorch programs with
``device="cpu"``. Chain and traverse-rank rows must be equal (scores
within 1e-5), strip and Gram arrays bitwise, PageRank within the
reference's own tolerance (rtol 1e-4, atol 1e-7), and routing the same:
the port dispatches where JAX dispatches. Where they differ by design
(ROADMAP C28: an error in a dispatch propagates) the test says so.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import nornicdb_tpu.ops.graph as jgraph
import nornicdb_tpu.query.device_graph as jdg
import test_device_graph as ref
from nornicdb_tpu.query.executor import CypherExecutor as JExecutor
from nornicdb_tpu.search.vector_index import BruteForceIndex as JIndex
from nornicdb_tpu_torch.ops import graph as tgraph
from nornicdb_tpu_torch.query import device_graph as tdg
from nornicdb_tpu_torch.query.executor import CypherExecutor
from nornicdb_tpu_torch.search.microbatch import BatchCoalescer
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, NamespacedEngine, Node

Q_CHAIN, Q_STRIP, Q_COOC = ref.Q_CHAIN, ref.Q_STRIP, ref.Q_COOC
STRIP_ARGS = ("IS_LOCATED_IN", "dst", "Person", "KNOWS", "out", "Person")
GRAM_KEY = ("HAS_TAG", "mid_src", "Message", "Tag", "Tag")
SCORE_ATOL = 1e-5  # float32 cosine sums in another order
PR_RTOL, PR_ATOL = 1e-4, 1e-7  # tests/test_ops.py's PageRank tolerance


@pytest.fixture()
def mode(monkeypatch):
    """Sets the plane's knobs for this test only."""
    for k in ("NORNICDB_GRAPH_DEVICE", "NORNICDB_GRAPH_DEVICE_MIN_N",
              "NORNICDB_GRAPH_DEVICE_MIN_B"):
        monkeypatch.delenv(k, raising=False)

    def set_mode(value, **extra):
        monkeypatch.setenv("NORNICDB_GRAPH_DEVICE", value)
        for k, v in extra.items():
            monkeypatch.setenv(f"NORNICDB_GRAPH_DEVICE_{k}", str(v))

    return set_mode


def copy_engine(jeng):
    teng = NamespacedEngine(MemoryEngine(), "t")
    for n in jeng.all_nodes():
        teng.create_node(Node.from_dict(n.to_dict()))
    for e in jeng.all_edges():
        teng.create_edge(Edge.from_dict(e.to_dict()))
    return teng


def build_pair(**kw):
    jeng = ref._build_graph(**kw)
    return jeng, copy_engine(jeng)


def jex(eng):
    ex = JExecutor(eng)
    ex.enable_query_cache = False
    return ex


def tex(eng, device="cpu"):
    ex = CypherExecutor(eng, device=device)
    ex.enable_query_cache = False
    return ex


def both(jeng, teng, fn):
    """Run ``fn(engine, node_cls, edge_cls)`` on both engines."""
    from nornicdb_tpu.storage.types import Edge as JEdge
    from nornicdb_tpu.storage.types import Node as JNode

    fn(jeng, JNode, JEdge)
    fn(teng, Node, Edge)


@pytest.fixture(scope="module")
def shared_pair():
    """One graph for the read-only chain cases."""
    return build_pair()


# -- chain top-k ---------------------------------------------------------------

CHAIN_CASES = [(pid, tail) for pid in (0, 3, 17, 29, 49)
               for tail in ("LIMIT 10", "LIMIT 1", "LIMIT 3", "SKIP 2 LIMIT 5",
                            "LIMIT 1000")] + [(10 ** 9, "LIMIT 10")]


@pytest.mark.parametrize("pid,tail", CHAIN_CASES)
def test_chain_rows_and_routing_match_jax(mode, shared_pair, pid, tail):
    jeng, teng = shared_pair
    q, params = Q_CHAIN + tail, {"pid": pid}
    mode("off")
    want = jex(jeng).execute(q, params)
    mode("on")
    jd, td = jex(jeng), tex(teng)
    got_j, got_t = jd.execute(q, params), td.execute(q, params)
    assert got_t.columns == want.columns
    assert got_t.rows == got_j.rows == want.rows
    assert td.device_graph.dispatches == jd.device_graph.dispatches
    assert td.device_graph.dispatches == (1 if pid < 10 ** 9 else 0)


def _empty_frontier(jeng, teng):
    both(jeng, teng, lambda e, N, _E: e.create_node(
        N(id="p_lonely", labels=["Person"], properties={"id": 7777, "name": "lonely"})))
    return Q_CHAIN + "LIMIT 5", {"pid": 7777}


def _dangling_label(jeng, teng):
    return ("MATCH (p:Person {id: $pid})-[:KNOWS]->(f:Ghost)"
            "<-[:HAS_CREATOR]-(m:Message) RETURN m.content "
            "ORDER BY m.creationDate DESC LIMIT 5"), {"pid": 0}


def _multi_hit_anchor(jeng, teng):
    both(jeng, teng, lambda e, N, _E: e.create_node(
        N(id="p_dup", labels=["Person"], properties={"id": 0, "name": "dup"})))
    return Q_CHAIN + "LIMIT 10", {"pid": 0}


@pytest.mark.parametrize("case", [_empty_frontier, _dangling_label, _multi_hit_anchor],
                         ids=lambda f: f.__name__.strip("_"))
def test_chain_edge_cases_match_jax(mode, case):
    jeng, teng = build_pair()
    q, params = case(jeng, teng)
    mode("off")
    want = jex(jeng).execute(q, params).rows
    mode("on")
    jd, td = jex(jeng), tex(teng)
    assert td.execute(q, params).rows == jd.execute(q, params).rows == want
    assert td.device_graph.dispatches == jd.device_graph.dispatches
    if case is _multi_hit_anchor:
        assert td.device_graph.dispatches == 0  # several anchors: the host's


def test_coalesced_concurrent_reads_share_dispatches(mode, monkeypatch):
    jeng, teng = build_pair()
    mode("off")
    want = {pid: jex(jeng).execute(Q_CHAIN + "LIMIT 10", {"pid": pid}).rows
            for pid in range(20)}
    mode("on")
    ex = tex(teng)
    ex.execute(Q_CHAIN + "LIMIT 10", {"pid": 0})  # warm the snapshot
    real, gate = tdg._chain_topk, threading.Event()

    def slow_first(*args):
        gate.wait(5.0)  # the first leader holds until every rider queued
        return real(*args)

    monkeypatch.setattr(tdg, "_chain_topk", slow_first)
    results, errors = {}, []

    def worker(pid):
        try:
            results[pid] = ex.execute(Q_CHAIN + "LIMIT 10", {"pid": pid}).rows
        except Exception as exc:  # noqa: BLE001 -- asserted below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(pid,)) for pid in range(20)]
    for t in threads:
        t.start()
    batcher = next(b for k, b in ex.device_graph._batchers.items() if k[0] == "chainb")
    deadline = time.time() + 10
    while batcher.batched_items + batcher.queue_depth() < 21 and time.time() < deadline:
        time.sleep(0.005)
    gate.set()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert results == want
    assert batcher.batched_items == 21
    assert ex.device_graph.inflight == 0
    # the warm-up, the first leader's batch, then every rider that queued
    # behind it in one more
    assert batcher.batches == ex.device_graph.dispatches <= 3


# -- freshness ladder -----------------------------------------------------------


def _friend_of_p0(ex):
    return ex.execute("MATCH (p:Person {id: 0})-[:KNOWS]->(f:Person) RETURN f.name").rows[0][0]


@pytest.mark.parametrize("rung", ["write_visible", "invalidation_and_delete",
                                  "mutation_mid_batch"])
def test_freshness_ladder_matches_jax(mode, monkeypatch, rung):
    jeng, teng = build_pair()
    mode("on")
    jd, td = jex(jeng), tex(teng)
    q = Q_CHAIN + "LIMIT 10"
    for ex in (jd, td):
        assert ex.execute(q, {"pid": 1}).rows
    if rung == "write_visible":
        friend = _friend_of_p0(td)
        for ex in (jd, td):
            ex.execute("MATCH (f:Person {name: $n}) CREATE (m:Message {id: 999999, "
                       "content: 'fresh', creationDate: 1900000000})-[:HAS_CREATOR]->(f)",
                       {"n": friend})
        got = td.execute(q, {"pid": 0}).rows
        assert any(row[1] == "fresh" for row in got)
        assert got == jd.execute(q, {"pid": 0}).rows
    elif rung == "invalidation_and_delete":
        for stmt in ("MATCH (m:Message {id: 1000}) SET m.creationDate = 1950000000",
                     "MATCH (m:Message {id: 1000}) DETACH DELETE m"):
            for ex in (jd, td):
                ex.execute(stmt, {})
            got = td.execute(q, {"pid": 1}).rows
            mode("off")
            assert got == jex(jeng).execute(q, {"pid": 1}).rows
            mode("on")
    else:
        fired = []

        def racing(*args):
            if not fired:
                fired.append(1)
                teng.create_node(Node(id="race_node", labels=["Person"],
                                      properties={"id": 55555}))
                td.columnar.apply_node_created(teng.get_node("race_node"))
            return real(*args)

        real = tdg._chain_topk
        monkeypatch.setattr(tdg, "_chain_topk", racing)
        before = td.device_graph.counts["degrade_stale"]
        got = td.execute(q, {"pid": 2}).rows
        assert fired and td.device_graph.counts["degrade_stale"] == before + 1
        mode("off")
        assert got == jex(jeng).execute(q, {"pid": 2}).rows


# -- strip view and Gram ---------------------------------------------------------

STRIP_VARIANTS = {
    "parallel_edge": STRIP_ARGS,
    "labels_none": ("IS_LOCATED_IN", "dst", None, "KNOWS", "out", None),
    "creator_city": ("HAS_CREATOR", "dst", "Person", "IS_LOCATED_IN", "out", "City"),
}


@pytest.mark.parametrize("variant", sorted(STRIP_VARIANTS))
def test_strip_arrays_bitwise_match_jax(mode, variant):
    jeng, teng = build_pair()
    if variant == "parallel_edge":  # duplicate (g, p) membership: DISTINCT
        both(jeng, teng, lambda e, _N, E: e.create_edge(
            E(id="dup1", type="IS_LOCATED_IN", start_node="p0", end_node="c_Oslo",
              properties={})))
    args = STRIP_VARIANTS[variant]
    mode("off")
    host = tex(teng).columnar.strip_view(*args)
    mode("on")
    jsv = jex(jeng).device_graph.build_strip_view(*args)
    td = tex(teng)
    tsv = td.device_graph.build_strip_view(*args)
    assert tsv is not None and jsv is not None
    for name in ("deg", "sum_deg", "nnz"):
        got = getattr(tsv, name)
        assert got.dtype == np.int64 == getattr(host, name).dtype
        assert np.array_equal(got, getattr(jsv, name))
        assert np.array_equal(got, getattr(host, name))
    assert td.device_graph.counts["strip_view_device_built"] == 1


def test_strip_query_parity_and_maintenance(mode):
    jeng, teng = build_pair()
    mode("on")
    jd, td = jex(jeng), tex(teng)
    assert ref._sorted_rows(td.execute(Q_STRIP)) == ref._sorted_rows(jd.execute(Q_STRIP))
    assert td.device_graph.counts["strip_view_device_built"] == 1
    # the installed view rides the catalog's incremental maintenance
    for ex in (jd, td):
        ex.execute("MATCH (a:Person {id: 0}), (b:Person {id: 49}) CREATE (a)-[:KNOWS]->(b)")
    assert ref._sorted_rows(td.execute(Q_STRIP)) == ref._sorted_rows(jd.execute(Q_STRIP))
    mode("off")
    assert ref._sorted_rows(td.execute(Q_STRIP)) == ref._sorted_rows(jex(jeng).execute(Q_STRIP))


def test_gram_bitwise_and_query_parity(mode):
    jeng, teng = build_pair()
    mode("off")
    host = tex(teng).columnar.cooc_gram(*GRAM_KEY)
    mode("on")
    jd, td = jex(jeng), tex(teng)
    jg = jd.columnar.cooc_gram(*GRAM_KEY, device_plane=jd.device_graph)
    tg = td.columnar.cooc_gram(*GRAM_KEY, device_plane=td.device_graph)
    assert np.array_equal(tg.C, jg.C) and np.array_equal(tg.C, host.C)
    inc = td.columnar.incidence("HAS_TAG", "mid_src", "Message", "Tag")
    raw = td.device_graph.gram_matmul(inc[0], inc[0])
    assert raw.dtype == np.float32 and np.array_equal(raw, inc[0].T @ inc[0])
    assert ref._sorted_rows(td.execute(Q_COOC)) == ref._sorted_rows(jd.execute(Q_COOC))


def test_exactness_guard_steps_down_and_is_counted(mode, monkeypatch):
    jeng, teng = build_pair()
    mode("on")
    td = tex(teng)
    monkeypatch.setattr(tdg, "_EXACT_F32", 1.0)
    monkeypatch.setattr(jdg, "_EXACT_F32", 1.0)
    assert td.device_graph.build_strip_view(*STRIP_ARGS) is None
    assert jex(jeng).device_graph.build_strip_view(*STRIP_ARGS) is None
    assert td.device_graph.counts["degrade_exactness"] == 1
    mode("off")
    want = ref._sorted_rows(jex(jeng).execute(Q_STRIP))
    mode("on")
    assert ref._sorted_rows(td.execute(Q_STRIP)) == want


# -- traverse-then-rank ---------------------------------------------------------


def rank_setup(mode_fn, with_vectors=True):
    jeng, teng = build_pair(n_people=30, n_msgs=60)
    mode_fn("on")
    jd, td = jex(jeng), tex(teng)
    rng = np.random.default_rng(5)
    jidx, tidx = JIndex(use_device=True), BruteForceIndex(device="cpu")
    if with_vectors:
        cat = td.columnar
        nodes = cat.nodes()
        ids = [nodes[int(r)].id for r in cat.label_rows("Message")]
        vecs = rng.normal(size=(len(ids), 24)).astype(np.float32)
        jidx.add_batch(list(zip(ids, vecs)))
        tidx.add_batch(list(zip(ids, vecs)))
    return (jeng, jd, jidx), (teng, td, tidx), rng


def assert_rank_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [r for r, _ in g] == [r for r, _ in w]
        assert np.allclose([s for _, s in g], [s for _, s in w], atol=SCORE_ATOL)


RANK_CASES = ["two_hops", "one_hop_unrankable", "empty_frontier", "index_mutation",
              "knows_one_hop"]


@pytest.mark.parametrize("case", RANK_CASES)
def test_traverse_rank_matches_jax(mode, case):
    (jeng, jd, jidx), (teng, td, tidx), rng = rank_setup(mode)
    hops = [("KNOWS", "out"), ("HAS_CREATOR", "in")]
    row = td.columnar.node_row
    anchors = [int(row(f"p{i}")) for i in (0, 3, 9, 21)]
    k = 7
    if case == "one_hop_unrankable":  # Person has no vector
        anchors, hops, k = [int(row("m0"))], [("HAS_CREATOR", "out")], 5
    elif case == "knows_one_hop":
        hops = [("KNOWS", "out")]
    elif case == "empty_frontier":
        both(jeng, teng, lambda e, N, _E: e.create_node(
            N(id="iso", labels=["Person"], properties={"id": 424242})))
        for ex in (jd, td):
            ex.invalidate_caches()
        anchors, k = [int(td.columnar.node_row("iso"))], 5
    q = rng.normal(size=(len(anchors), 24)).astype(np.float32)
    if case == "index_mutation":
        anchors, k = anchors[:1], 5
        q = q[:1]
        assert td.device_graph.traverse_rank(anchors, hops, q, k, tidx) is not None
        target = td.device_graph.traverse_rank_host(anchors, hops, q, 50, tidx)[0][-1][0]
        tid = td.columnar.nodes()[target].id
        jidx.add(tid, q[0])
        tidx.add(tid, q[0])
    got = td.device_graph.traverse_rank(anchors, hops, q, k, tidx)
    host = td.device_graph.traverse_rank_host(anchors, hops, q, k, tidx)
    assert got is not None
    assert_rank_equal(got, host)
    assert_rank_equal(got, jd.device_graph.traverse_rank(anchors, hops, q, k, jidx))
    assert_rank_equal(host, jd.device_graph.traverse_rank_host(anchors, hops, q, k, jidx))
    if case in ("one_hop_unrankable", "empty_frontier"):
        assert got == [[]]
    if case == "index_mutation":
        assert got[0][0][0] == target


def test_traverse_rank_tied_scores_go_to_the_lower_row(mode):
    _, (teng, td, tidx), _ = rank_setup(mode, with_vectors=False)
    cat = td.columnar
    nodes = cat.nodes()
    ids = [nodes[int(r)].id for r in cat.label_rows("Message")]
    v = np.ones(24, np.float32)
    tidx.add_batch([(i, v) for i in ids])  # every score ties
    a = [int(cat.node_row("p0"))]
    hops = [("KNOWS", "out"), ("HAS_CREATOR", "in")]
    got = td.device_graph.traverse_rank(a, hops, v[None, :], 5, tidx)
    host = td.device_graph.traverse_rank_host(a, hops, v[None, :], 5, tidx)
    assert [r for r, _ in got[0]] == [r for r, _ in host[0]]
    assert [r for r, _ in got[0]] == sorted(r for r, _ in got[0])


# -- PageRank and degree counts ---------------------------------------------------


@pytest.mark.parametrize("iters,damping", [(20, 0.85), (5, 0.85), (20, 0.5), (1, 0.85)])
def test_pagerank_matches_jax(iters, damping):
    jeng, teng = build_pair(n_people=25, n_msgs=30)
    src, dst, ids = tgraph.graph_snapshot(teng)
    jsrc, jdst, jids = jgraph.graph_snapshot(jeng)
    assert ids == jids and np.array_equal(src, jsrc) and np.array_equal(dst, jdst)
    n = len(ids)
    got = tgraph.pagerank_arrays(src, dst, n, iters, damping, device="cpu")
    assert got.dtype == np.float32
    want_dev = np.asarray(jgraph._pagerank_impl(src, dst, n, iters, damping))
    want_host = jgraph._pagerank_host(src, dst, n, iters, damping)
    np.testing.assert_allclose(got, want_dev, rtol=PR_RTOL, atol=PR_ATOL)
    np.testing.assert_allclose(got, want_host, rtol=PR_RTOL, atol=PR_ATOL)
    # the port's host version is the reference's, line for line
    np.testing.assert_array_equal(tgraph._pagerank_host(src, dst, n, iters, damping),
                                  want_host)


def test_pagerank_edge_cases_match_jax():
    for src, dst, n in ((np.zeros(0, np.int32), np.zeros(0, np.int32), 0),
                        (np.zeros(0, np.int32), np.zeros(0, np.int32), 4),
                        (np.array([0, 0, 1], np.int32), np.array([1, 1, 0], np.int32), 3)):
        got = tgraph.pagerank_arrays(src, dst, n, device="cpu")
        want = jgraph.pagerank_arrays(src, dst, n)
        np.testing.assert_allclose(got, want, rtol=PR_RTOL, atol=PR_ATOL)
        assert got.shape == (n,)


def test_pagerank_snapshot_is_cached_and_bitwise(mode):
    jeng, teng = build_pair(n_people=25, n_msgs=30)
    mode("on")
    td = tex(teng)
    plane = td.device_graph
    base = tgraph.pagerank_engine(teng, device="cpu")
    via_plane = tgraph.pagerank_engine(teng, plane=plane)
    assert base == via_plane  # the same snapshot recipe and program
    want = jgraph.pagerank_engine(jeng, plane=jex(jeng).device_graph)
    assert {i for i, _ in base} == {i for i, _ in want}
    scores = dict(want)
    np.testing.assert_allclose([s for _, s in base], [scores[i] for i, _ in base],
                               rtol=PR_RTOL, atol=PR_ATOL)
    snap1 = plane.pagerank_snapshot()
    assert plane.pagerank_snapshot() is snap1
    td.execute("CREATE (:Person {id: 909090})")
    snap3 = plane.pagerank_snapshot()
    assert snap3 is not snap1 and len(snap3["ids"]) == len(snap1["ids"]) + 1


def test_degree_counts_match_jax(mode):
    jeng, teng = build_pair(n_people=20, n_msgs=20)
    mode("on")
    out_d, in_d = tex(teng).device_graph.degree_counts()
    jout, jin = jex(jeng).device_graph.degree_counts()
    src, dst, ids = tgraph.graph_snapshot(teng)
    assert np.array_equal(out_d, jout) and np.array_equal(in_d, jin)
    assert np.array_equal(out_d, np.bincount(src, minlength=len(ids)))
    assert np.array_equal(in_d, np.bincount(dst, minlength=len(ids)))
    o, i = tgraph.degree_counts(torch.from_numpy(src), torch.from_numpy(dst), len(ids))
    assert o.dtype == torch.int32 and np.array_equal(o.numpy(), out_d)


# -- resources, gates and step-downs ------------------------------------------------


def test_resource_stats_match_jax(mode):
    jeng, teng = build_pair()
    mode("on")
    jd, td = jex(jeng), tex(teng)
    for ex in (jd, td):
        ex.execute(Q_CHAIN + "LIMIT 10", {"pid": 0})
        ex.device_graph.pagerank_snapshot()
    stats, jstats = td.device_graph.resource_stats(), jd.device_graph.resource_stats()
    assert {k: v for k, v in stats.items() if k != "device_bytes"} == \
        {k: v for k, v in jstats.items() if k != "device_bytes"}
    # the reference counts the chain snapshot's far1 twice
    # (device_graph.py:460); the port counts the tensors it holds
    far1 = next(s["far1"] for k, s in td.device_graph._snaps.items() if k[0] == "chain")
    assert jstats["device_bytes"] - stats["device_bytes"] == 4 * far1.numel()
    assert stats["device_bytes"] > 0 and stats["rows"] > 0 and stats["mutation_gap"] == 0
    tensors = [v for s in td.device_graph._snaps.values() for v in s.values()
               if isinstance(v, torch.Tensor)]
    assert stats["device_bytes"] == sum(t.numel() * t.element_size() for t in tensors)
    td.execute("CREATE (:Person {id: 777777})")
    assert td.device_graph.resource_stats()["mutation_gap"] >= 1


def _chain_reads(ex, n=5):
    for pid in range(n):
        ex.execute(Q_CHAIN + "LIMIT 10", {"pid": pid})


@pytest.mark.parametrize("surface", ["chain", "strip", "gram", "rank"])
def test_gate_off_never_dispatches(mode, surface):
    _, (teng, td, tidx), rng = rank_setup(mode)
    mode("off")
    plane = td.device_graph
    if surface == "chain":
        _chain_reads(td)
        assert plane.chain_topk(("KNOWS", "out", "Person", "HAS_CREATOR", "dst",
                                 "creationDate", "Message"), 0, 10, 10 ** 9) is None
    elif surface == "strip":
        assert plane.build_strip_view(*STRIP_ARGS) is None
    elif surface == "gram":
        inc = td.columnar.incidence("HAS_TAG", "mid_src", "Message", "Tag")
        assert plane.gram_matmul(inc[0], inc[0]) is None
    else:
        q = rng.normal(size=(1, 24)).astype(np.float32)
        assert plane.traverse_rank([0], [("KNOWS", "out")], q, 5, tidx) is None
    assert plane.dispatches == 0 and plane._snaps == {}
    assert plane.counts["degrade_off"] >= 1


@pytest.mark.parametrize("case", ["single_stream", "concurrent", "strip", "gram",
                                  "rank_below_min_b", "rank_at_min_b", "unresolved"])
def test_auto_on_a_cpu_device_routes_as_jax_on_its_cpu_backend(mode, case):
    (jeng, jd, jidx), (teng, td, tidx), rng = rank_setup(mode)
    mode("auto", MIN_N=1, MIN_B=2)
    jd, td = jex(jeng), tex(teng)
    jplane, plane = jd.device_graph, td.device_graph
    if case == "single_stream":
        _chain_reads(td)
        _chain_reads(jd)
    elif case == "concurrent":
        ths = [threading.Thread(target=_chain_reads, args=(ex, 8))
               for ex in (td, td, td, jd, jd, jd)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
    elif case == "strip":
        assert plane.build_strip_view(*STRIP_ARGS) is None
        assert jplane.build_strip_view(*STRIP_ARGS) is None
    elif case == "gram":
        inc = td.columnar.incidence("HAS_TAG", "mid_src", "Message", "Tag")
        assert plane.gram_matmul(inc[0], inc[0]) is None
        assert jplane.gram_matmul(inc[0], inc[0]) is None
    elif case.startswith("rank"):
        n_anchors = 1 if case == "rank_below_min_b" else 2
        a = [int(td.columnar.node_row(f"p{i}")) for i in range(n_anchors)]
        q = rng.normal(size=(n_anchors, 24)).astype(np.float32)
        hops = [("KNOWS", "out"), ("HAS_CREATOR", "in")]
        got, want = (plane.traverse_rank(a, hops, q, 5, tidx),
                     jplane.traverse_rank(a, hops, q, 5, jidx))
        assert (got is None) == (want is None) == (n_anchors == 1)
        if got is not None:
            assert_rank_equal(got, want)
    else:  # a plane that never routes to a device never resolves one
        mode("auto", MIN_N=200_000)
        ex = CypherExecutor(teng)
        _chain_reads(ex)
        ex.execute(Q_STRIP)
        ex.execute(Q_COOC)
        assert ex.device_graph._device is None
    assert plane.dispatches == jplane.dispatches


def test_on_without_a_card_raises(mode, monkeypatch):
    _, teng = build_pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mode("on")
    ex = CypherExecutor(teng)  # device=None means cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.execute(Q_CHAIN + "LIMIT 10", {"pid": 0})


@pytest.mark.parametrize("gap", ["min_batch", "rank_overflow", "snapshot_raced", "torn",
                                 "no_iteration", "stale_rank"])
def test_named_gaps_step_down_and_are_counted(mode, monkeypatch, gap):
    (jeng, jd, jidx), (teng, td, tidx), rng = rank_setup(mode)
    plane = td.device_graph
    spec = ("KNOWS", "out", "Person", "HAS_CREATOR", "dst", "creationDate", None)
    a = int(td.columnar.node_row("p0"))
    if gap == "min_batch":
        mode("auto", MIN_B=3)
        assert plane._chain_batch(spec, [(a, 10), (a, 5)]) == [None, None]
        assert jd.device_graph._chain_batch(spec, [(a, 10), (a, 5)]) == [None, None]
        counted = "batch_below_min_b"
    elif gap == "rank_overflow":
        monkeypatch.setattr(tdg, "_I32_MAX", 8)
        monkeypatch.setattr(jdg, "_I32_MAX", 8)
        assert plane._chain_batch(spec, [(a, 10)]) == [None]
        assert jd.device_graph._chain_batch(spec, [(a, 10)]) == [None]
        counted = "degrade_rank_overflow"
    elif gap == "snapshot_raced":
        key = ("chain",) + spec
        stale = {"version": td.columnar.version - 1}
        assert not plane._put_snap(key, stale)
        assert not jd.device_graph._put_snap(key, dict(stale))
        counted = "snapshot_raced"
    elif gap == "torn":
        def torn(*_a, **_k):
            raise IndexError("torn")

        for ex in (td, jd):
            monkeypatch.setattr(ex.columnar, "edge_table", torn)
            assert ex.device_graph.build_strip_view(*STRIP_ARGS) is None
        counted = "degrade_torn"
    elif gap == "no_iteration":
        def no_iteration():
            raise NotImplementedError

        monkeypatch.setattr(teng, "all_nodes", no_iteration)
        monkeypatch.setattr(jeng, "all_nodes", no_iteration)
        assert plane.pagerank_snapshot() is None
        assert jd.device_graph.pagerank_snapshot() is None
        counted = "degrade_no_iteration"
    else:  # the index moved between the rank snapshot and the dispatch
        hops = [("KNOWS", "out"), ("HAS_CREATOR", "in")]
        q = rng.normal(size=(1, 24)).astype(np.float32)
        real = tdg._traverse_rank

        def racing(*args):
            tidx.add("m0", q[0])
            return real(*args)

        monkeypatch.setattr(tdg, "_traverse_rank", racing)
        assert plane.traverse_rank([a], hops, q, 5, tidx) is None
        counted = "degrade_stale"
    assert plane.counts[counted] == 1
    assert plane.dispatches == (1 if gap == "stale_rank" else 0)


# -- C28: the plane fails closed ----------------------------------------------------


def _boom(*_a, **_k):
    raise RuntimeError("device fault")


@pytest.mark.parametrize("surface", ["chain", "chain_riders", "strip", "gram", "rank"])
def test_a_raising_dispatch_propagates_where_jax_answers_from_the_host(
        mode, monkeypatch, surface):
    (jeng, jd, jidx), (teng, td, tidx), rng = rank_setup(mode)
    mode("on")
    monkeypatch.setattr(jdg, "_chain_topk_fn", lambda *a: _boom)
    monkeypatch.setattr(jdg, "_strip_agg_fn", lambda *a: _boom)
    monkeypatch.setattr(jdg, "_gram_fn", lambda *a: _boom)
    monkeypatch.setattr(jdg, "_traverse_rank_fn", lambda *a: _boom)
    for name in ("_chain_topk", "_strip_agg", "_gram", "_traverse_rank"):
        monkeypatch.setattr(tdg, name, _boom)
    if surface == "chain":
        assert jd.execute(Q_CHAIN + "LIMIT 10", {"pid": 0}).rows
        with pytest.raises(RuntimeError, match="device fault"):
            td.execute(Q_CHAIN + "LIMIT 10", {"pid": 0})
    elif surface == "chain_riders":
        gate = threading.Event()

        def held(*_a):
            gate.wait(5.0)
            raise RuntimeError("device fault")

        monkeypatch.setattr(tdg, "_chain_topk", held)
        errors = []

        def rider(pid):
            try:
                td.execute(Q_CHAIN + "LIMIT 10", {"pid": pid})
            except RuntimeError as exc:
                errors.append(exc)

        ths = [threading.Thread(target=rider, args=(p,)) for p in range(6)]
        for t in ths:
            t.start()
        time.sleep(0.3)
        gate.set()
        for t in ths:
            t.join(timeout=60)
        assert len(errors) == 6  # every rider of the batch sees the fault
    elif surface == "strip":
        assert ref._sorted_rows(jd.execute(Q_STRIP))
        with pytest.raises(RuntimeError, match="device fault"):
            td.execute(Q_STRIP)
    elif surface == "gram":
        assert ref._sorted_rows(jd.execute(Q_COOC))
        with pytest.raises(RuntimeError, match="device fault"):
            td.execute(Q_COOC)
    else:
        a = [int(td.columnar.node_row("p0"))]
        q = rng.normal(size=(1, 24)).astype(np.float32)
        hops = [("KNOWS", "out"), ("HAS_CREATOR", "in")]
        assert jd.device_graph.traverse_rank(a, hops, q, 5, jidx) is None
        with pytest.raises(RuntimeError, match="device fault"):
            td.device_graph.traverse_rank(a, hops, q, 5, tidx)


# -- the coalescer --------------------------------------------------------------------


def test_coalescer_isolates_a_poisoned_item_with_apply_single():
    def apply_batch(values):
        if "bad" in values:
            raise ValueError("poison")
        return [v.upper() for v in values]

    def apply_single(v):
        if v == "bad":
            raise ValueError("poison")
        return v.upper()

    for single, want_errors in ((apply_single, 1), (None, 3)):
        gate = threading.Event()
        first = []

        def gated(values, _single=single):
            if not first:
                first.append(1)
                gate.wait(5.0)
            return apply_batch(values)

        co = BatchCoalescer(gated, apply_single=single, max_batch=8)
        out, errors = {}, []

        def run(v):
            try:
                out[v] = co.submit(v)
            except ValueError as exc:
                errors.append(exc)

        lead = threading.Thread(target=run, args=("lead",))
        lead.start()
        time.sleep(0.05)
        ths = [threading.Thread(target=run, args=(v,)) for v in ("a", "bad", "b")]
        for t in ths:
            t.start()
        while co.queue_depth() < 3:
            time.sleep(0.005)
        gate.set()
        for t in [lead] + ths:
            t.join(timeout=60)
        assert co.batches == 2 and co.batched_items == 4
        assert len(errors) == want_errors
        assert out["lead"] == "LEAD"
        if single is not None:
            assert out["a"] == "A" and out["b"] == "B"


def test_coalescer_stress_every_caller_gets_its_own_answer():
    """More threads than cores and a short switch interval: every value is
    applied once, in some batch, and answered to its own caller."""
    import sys

    seen = []
    co = BatchCoalescer(lambda values: seen.extend(values) or [v * 2 for v in values],
                        max_batch=16)
    out, errors = {}, []

    def run(t):
        try:
            for j in range(50):
                v = t * 1000 + j
                out[v] = co.submit(v)
        except Exception as exc:  # noqa: BLE001 -- asserted below
            errors.append(exc)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=run, args=(t,)) for t in range(32)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not errors and not any(t.is_alive() for t in ths)
    assert out == {v: v * 2 for v in out} and len(out) == 32 * 50
    assert sorted(seen) == sorted(out) and co.batched_items == len(out)
    assert co.queue_depth() == 0 and co.batches < len(out)


# -- DB.graph_vector_search ---------------------------------------------------------


@pytest.mark.parametrize("gate", ["on", "off", "auto"])
def test_graph_vector_search_matches_jax(mode, gate):
    from nornicdb_tpu.db import DB as JDB
    from nornicdb_tpu_torch.db import DB

    mode(gate)
    results = []
    for db in (JDB(), DB(device="cpu")):
        try:
            rng = np.random.default_rng(1)
            for i in range(8):
                db.store(f"n{i}", labels=["Person"], properties={"pid": i}, node_id=f"p{i}",
                         embedding=rng.normal(size=12).tolist())
            for i in range(8):
                db.link(f"p{i}", f"p{(i + 1) % 8}", "KNOWS")
            q = rng.normal(size=12).tolist()
            hits = db.graph_vector_search("p0", ["KNOWS"], q, k=3)
            two = db.graph_vector_search("p0", [("KNOWS", "out"), ("KNOWS", "in")], q, k=5)
            db.store("late", labels=["Person"], properties={"pid": 99}, node_id="p_late",
                     embedding=q)
            db.link("p0", "p_late", "KNOWS")
            late = db.graph_vector_search("p0", ["KNOWS"], q, k=3)
            errors = []
            for bad in ([], [("KNOWS", "up")], [1], ["KNOWS"] * 3):
                with pytest.raises(ValueError) as err:
                    db.graph_vector_search("p0", bad, q)
                errors.append(str(err.value))
            with pytest.raises(ValueError):
                db.graph_vector_search("p0", ["KNOWS"], q[:5])
            results.append((hits, two, late, errors,
                            db.graph_vector_search("missing", ["KNOWS"], q)))
        finally:
            db.close()
    (jh, jt, jl, je, jm), (th, tt, tl, te, tm) = results
    assert th[0][0] == "p1" and tl[0][0] == "p_late"
    for got, want in ((th, jh), (tt, jt), (tl, jl)):
        assert [i for i, _ in got] == [i for i, _ in want]
        assert np.allclose([s for _, s in got], [s for _, s in want], atol=SCORE_ATOL)
    assert te == je and tm == jm == []
