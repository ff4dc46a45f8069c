"""The port's Cypher layer (``nornicdb_tpu_torch/query``) against the JAX
package's on the same inputs: parser ASTs over the queries of the
reference's Cypher tests, the differential fuzzer's graphs and queries
with the fast paths on and off, the fast-path parity corpus, temporal
values and their record bytes, the ``db.*`` and ``gds.*`` procedures,
Cypher writes through the DB and both result caches, and APOC and the
strict parser mode where the port raised ``NotPortedError`` before them.

The JAX side is ``nornicdb_tpu.query.executor.CypherExecutor`` over the
JAX ``NamespacedEngine(MemoryEngine())``; both sides run on the host (no
module of the Cypher layer holds a kernel)."""

import ast as pyast
import dataclasses
import os
import random

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
import test_cypher_differential as fuzz
import test_fastpath_parity as parity
from nornicdb_tpu.errors import CypherRuntimeError as JRuntimeError
from nornicdb_tpu.errors import CypherSyntaxError as JSyntaxError
from nornicdb_tpu.query import parser as jparser
from nornicdb_tpu.query import temporal_types as jtemporal
from nornicdb_tpu.query.executor import CypherExecutor as JExecutor
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import NamespacedEngine as JNamespaced
from nornicdb_tpu.storage.wal import _pack as j_pack
from nornicdb_tpu_torch.embed.embedder import HashEmbedder
from nornicdb_tpu_torch.embed.queue import build_embedding_text
from nornicdb_tpu_torch.errors import CypherRuntimeError, CypherSyntaxError
from nornicdb_tpu_torch.ops.topk import topk_agree
from nornicdb_tpu_torch.query import fastpaths as tfastpaths
from nornicdb_tpu_torch.query import parser as tparser
from nornicdb_tpu_torch.query import temporal_types as ttemporal
from nornicdb_tpu_torch.query.executor import CypherExecutor
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, NamespacedEngine, Node
from nornicdb_tpu_torch.storage import codec

TESTS = os.path.dirname(os.path.abspath(__file__))
# cosine scores of the same unit vectors, summed in another order
SCORE_ATOL = 1e-5

torch.set_num_threads(1)


# -- parser ------------------------------------------------------------------


def _query_strings(name):
    """The string literals a test file passes to execute/cypher/parse."""
    with open(os.path.join(TESTS, name)) as f:
        tree = pyast.parse(f.read())
    out = []
    for node in pyast.walk(tree):
        if isinstance(node, pyast.Call) and node.args:
            fn = node.func
            attr = fn.attr if isinstance(fn, pyast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if attr in ("execute", "cypher", "parse") and isinstance(arg, pyast.Constant) \
                    and isinstance(arg.value, str):
                out.append(arg.value)
    return out


PARSER_QUERIES = sorted(set(_query_strings("test_cypher.py"))
                        | set(_query_strings("test_fastpath_parity.py"))
                        | {q for q, _, _ in parity.CORPUS})


def _tree(obj):
    """An AST as nested (class name, fields) tuples."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, _tree(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_tree(x) for x in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _tree(v)) for k, v in obj.items())
    return (type(obj).__name__, obj)


def _strip_prefix(q):
    head = q.lstrip()[:7].upper()
    return q.lstrip()[7:] if head in ("EXPLAIN", "PROFILE") else q


def test_parser_corpus_is_the_reference_tests():
    assert len(PARSER_QUERIES) > 150


@pytest.mark.parametrize("query", PARSER_QUERIES)
def test_parser_asts_equal_jax(query):
    q = _strip_prefix(query)
    try:
        want = _tree(jparser.parse(q))
    except JSyntaxError as e:
        with pytest.raises(CypherSyntaxError) as got:
            tparser.parse(q)
        assert str(got.value) == str(e)
        return
    assert _tree(tparser.parse(q)) == want


@pytest.mark.parametrize("query", [
    "MATCH (n RETURN n", "RETURN 1 +", "MATCH (a)-[:X->(b) RETURN a",
    "CREATE (n:Person {name: 'x'}", "MATCH (n) RETURN n ORDER", "WITH 1 AS x RETURN y(",
])
def test_parser_errors_equal_jax(query):
    with pytest.raises(JSyntaxError) as want:
        jparser.parse(query)
    with pytest.raises(CypherSyntaxError) as got:
        tparser.parse(query)
    assert str(got.value) == str(want.value)


# -- differential fuzzing ------------------------------------------------------


def _four(ns):
    """JAX and port executors, each with the fast paths on and off."""
    jf = JExecutor(JNamespaced(JMemory(), ns))
    js = JExecutor(JNamespaced(JMemory(), ns))
    tf = CypherExecutor(NamespacedEngine(MemoryEngine(), ns))
    ts = CypherExecutor(NamespacedEngine(MemoryEngine(), ns))
    for ex in (js, ts):
        ex.enable_fastpaths = False
        ex.enable_query_cache = False
    return jf, js, tf, ts


@pytest.mark.parametrize("seed", list(range(20)))
def test_differential_fuzz_matches_jax(seed):
    rng = random.Random(1000 + seed)
    exs = _four("dz")
    fuzz._build_graph(rng, list(exs))
    for qi in range(52):
        q = fuzz._gen_query(rng) if qi % 4 else fuzz._gen_advanced(rng)
        jf, js, tf, ts = (fuzz._canon(ex.execute(q)) for ex in exs)
        assert tf == ts == jf == js, f"seed={seed} #{qi}: {q}"


@pytest.mark.parametrize("seed", list(range(8)))
def test_differential_write_fuzz_matches_jax(seed):
    rng = random.Random(5000 + seed)
    exs = _four("dw")
    fuzz._build_graph(rng, list(exs))
    next_id = [10_000]
    for qi in range(120):
        q = fuzz._gen_write(rng, next_id) if rng.random() < 0.55 else fuzz._gen_query(rng)
        results = [ex.execute(q) for ex in exs]
        assert len({repr(fuzz._canon(r)) for r in results}) == 1, f"seed={seed} #{qi}: {q}"
        stats = {(r.stats.nodes_created, r.stats.nodes_deleted, r.stats.relationships_created,
                  r.stats.relationships_deleted, r.stats.properties_set) for r in results}
        assert len(stats) == 1, f"seed={seed} #{qi}: {q}"
    assert len({repr(fuzz._state_digest(ex)) for ex in exs}) == 1


# -- fast-path parity corpus -----------------------------------------------------


@pytest.fixture(scope="module")
def parity_graphs():
    """The parity corpus's graph, built by its fixture in the JAX package
    and copied record by record into the port's engine (same ids, same
    insertion order)."""
    build = getattr(parity.graph, "__wrapped__", parity.graph)
    jeng = build()
    teng = NamespacedEngine(MemoryEngine(), "test")
    for n in jeng.all_nodes():
        teng.create_node(Node.from_dict(n.to_dict()))
    for e in jeng.all_edges():
        teng.create_edge(Edge.from_dict(e.to_dict()))
    return jeng, teng


@pytest.mark.parametrize("query,params,ordered", parity.CORPUS)
def test_fastpath_parity_corpus_matches_jax(parity_graphs, query, params, ordered):
    jeng, teng = parity_graphs
    jf = JExecutor(jeng)
    tf = CypherExecutor(teng)
    ts = CypherExecutor(teng)
    ts.enable_fastpaths = False
    for ex in (jf, tf, ts):
        ex.enable_query_cache = False
    want = jf.execute(query, params)
    for got in (tf.execute(query, params), ts.execute(query, params)):
        assert got.columns == want.columns
        if ordered:
            assert [repr(r) for r in got.rows] == [repr(r) for r in want.rows]
        else:
            assert sorted(map(repr, got.rows)) == sorted(map(repr, want.rows))


def test_fast_paths_engage_on_the_flagship_shapes(parity_graphs):
    _, teng = parity_graphs
    ex = CypherExecutor(teng)
    ex.enable_query_cache = False

    class _Ctx:
        storage = teng
        params = {"mid": 1042, "pid": 3}

    for i in (0, 2, 5, 7, 9):
        query = parity.CORPUS[i][0]
        assert tfastpaths.try_fast_path(ex, tparser.parse(query).parts[0], _Ctx()) is not None, query


def test_point_lookup_edge_cases_match_jax(parity_graphs):
    jeng, teng = parity_graphs
    jf, tf = JExecutor(jeng), CypherExecutor(teng)
    for params in ({"i": 0}, {"i": 59}, {"i": -1}, {"i": "0"}, {"i": None}, {"i": True}):
        q = "MATCH (p:Person {id: $i}) RETURN p.name"
        assert tf.execute(q, params).rows == jf.execute(q, params).rows, params


def test_explain_and_profile_match_jax(parity_graphs):
    jeng, teng = parity_graphs
    jf, tf = JExecutor(jeng), CypherExecutor(teng)
    for query, params, _ in parity.CORPUS[:10]:
        je, te = jf.execute("EXPLAIN " + query, params), tf.execute("EXPLAIN " + query, params)
        assert (te.columns, te.rows, te.plan) == (je.columns, je.rows, je.plan)
        jp, tp = jf.execute("PROFILE " + query, params), tf.execute("PROFILE " + query, params)
        assert sorted(map(repr, tp.rows)) == sorted(map(repr, jp.rows))
        assert tp.plan == jp.plan  # db hits and row counts included


# -- executor semantics pinned by the reference's tests -------------------------


def test_cache_hit_and_write_invalidation():
    ex = CypherExecutor(NamespacedEngine(MemoryEngine(), "test"))
    ex.execute("CREATE (:X {v: 1})")
    r1 = ex.execute("MATCH (x:X) RETURN x.v")
    h0 = ex.query_cache.hits
    assert ex.execute("MATCH (x:X) RETURN x.v").rows == r1.rows
    assert ex.query_cache.hits == h0 + 1
    ex.execute("MATCH (x:X) SET x.v = 2")
    assert ex.execute("MATCH (x:X) RETURN x.v").rows == [[2]]


def test_pure_creates_extend_the_snapshot_in_place():
    ex = CypherExecutor(NamespacedEngine(MemoryEngine(), "test"))
    ex.execute("CREATE (:P {id: 1})-[:K]->(:P {id: 2})")
    assert ex.execute("MATCH (a:P)-[:K]->(b:P) RETURN count(*)").rows == [[1]]
    version = ex.columnar.version
    ex.execute("CREATE (:P {id: 3})")
    assert ex.columnar._nodes is not None and ex.columnar.version != version
    assert ex.execute("MATCH (a:P)-[:K]->(b:P) RETURN count(*)").rows == [[1]]
    ex.execute("MATCH (a:P {id: 2}), (b:P {id: 3}) CREATE (a)-[:K]->(b)")
    assert ex.execute("MATCH (a:P)-[:K]->(b:P) RETURN count(*)").rows == [[2]]


def test_failed_write_query_invalidates_caches():
    ex = CypherExecutor(NamespacedEngine(MemoryEngine(), "test"))
    ex.execute("CREATE (:P {v: 0})")
    assert ex.execute("MATCH (p:P) RETURN count(p)").rows == [[1]]
    with pytest.raises(CypherRuntimeError):
        ex.execute("UNWIND [1, 0] AS i CREATE (:P {v: i}) RETURN 1 / i")
    assert ex.execute("MATCH (p:P) RETURN count(p)").rows == [[3]]


def test_union_later_parts_see_earlier_writes():
    ex = CypherExecutor(NamespacedEngine(MemoryEngine(), "test"))
    ex.execute("CREATE (:X {v: 1})")
    ex.execute("MATCH (x:X) RETURN x.v")
    r = ex.execute("CREATE (:X {v: 2}) RETURN 99 AS `x.v` UNION ALL MATCH (x:X) RETURN x.v")
    assert sorted(r.rows) == [[1], [2], [99]]


# -- temporal values -------------------------------------------------------------

TEMPORAL_EXPRS = [
    "date('2024-01-02')",
    "date({year: 2024, month: 2, day: 29})",
    "date('2024-01-31') + duration('P1M')",
    "date('2024-03-01') - duration('P1D')",
    "datetime('2024-01-02T03:04:05Z')",
    "datetime('2024-01-02T03:04:05.123+02:00')",
    "datetime({epochMillis: 1700000000123})",
    "datetime('2024-03-10T12:00:00Z') - duration('PT36H')",
    "localdatetime('2024-01-02T03:04:05')",
    "time('03:04:05Z')",
    "localtime('03:04:05.5')",
    "duration('P1Y2M3DT4H5M6.5S')",
    "duration({days: 3, hours: 4})",
    "duration('P1D') + duration('PT12H')",
    "duration.between(date('2024-01-01'), date('2024-03-15'))",
    "duration.inDays(date('2024-01-01'), date('2024-03-15'))",
    "duration.inSeconds(datetime('2024-01-01T00:00:00Z'), datetime('2024-01-02T01:00:00Z'))",
    "date.truncate('month', date('2024-05-17'))",
    "datetime.truncate('hour', datetime('2024-05-17T13:45:10Z'))",
    "point({x: 1.0, y: 2.0})",
    "point({x: 1, y: 2, z: 3})",
    "point({latitude: 59.9, longitude: 10.7})",
    "point.distance(point({x: 0.0, y: 0.0}), point({x: 3.0, y: 4.0}))",
    "date('2024-01-02') < date('2024-01-03')",
    "datetime('2024-01-02T00:00:00Z') = datetime('2024-01-02T01:00:00+01:00')",
    "date('2024-07-04').year + date('2024-07-04').dayOfWeek",
    "datetime('2024-01-02T03:04:05Z').epochMillis",
    "duration('P1DT2H').hours",
    "toString(date('2024-01-02'))",
    "[date('2024-01-02'), duration('PT1S'), point({x: 1.0, y: 1.0})]",
]


def _eval_both(expr, params=None):
    jv = JExecutor(JNamespaced(JMemory(), "t")).execute(f"RETURN {expr} AS v", params).rows[0][0]
    tv = CypherExecutor(NamespacedEngine(MemoryEngine(), "t")).execute(
        f"RETURN {expr} AS v", params).rows[0][0]
    return jv, tv


@pytest.mark.parametrize("expr", TEMPORAL_EXPRS)
def test_temporal_values_and_their_bytes_match_jax(expr):
    jv, tv = _eval_both(expr)
    assert repr(tv) == repr(jv) and str(tv) == str(jv)
    assert type(tv).__name__ == type(jv).__name__
    assert codec.pack({"v": tv}) == j_pack({"v": jv})
    assert str(codec.unpack(codec.pack({"v": tv}))["v"]) == str(tv)


@pytest.mark.parametrize("value", [
    "2024-01-02", "2024-02-29T23:59:59.999999Z", "2024-01-02T03:04:05+05:30",
    "P2W", "PT0.000001S", "-P1D",
])
def test_temporal_constructors_of_parameters_match_jax(value):
    fn = "duration" if value.lstrip("-").startswith("P") else (
        "date" if len(value) == 10 else "datetime")
    jv, tv = _eval_both(f"{fn}($s)", {"s": value})
    assert str(tv) == str(jv)
    assert codec.pack(tv) == j_pack(jv)


def test_temporal_encode_and_decode_match_jax():
    for expr in TEMPORAL_EXPRS[:22]:
        jv, tv = _eval_both(expr)
        if not hasattr(jv, "__slots__"):
            continue
        assert ttemporal.encode_value(tv) == jtemporal.encode_value(jv)
        assert str(ttemporal.decode_map(jtemporal.encode_value(jv))) == str(jv)


def test_temporal_errors_match_jax():
    for expr in ("date('2024-13-01')", "duration('nonsense')", "datetime('x')"):
        with pytest.raises(JRuntimeError) as want:
            JExecutor(JNamespaced(JMemory(), "t")).execute(f"RETURN {expr}")
        with pytest.raises(CypherRuntimeError) as got:
            CypherExecutor(NamespacedEngine(MemoryEngine(), "t")).execute(f"RETURN {expr}")
        assert str(got.value) == str(want.value)


# -- procedures on a DB ------------------------------------------------------------


def _rows_for_procedures(seed=13, n=160, dims=16):
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
    vecs = rng.standard_normal((n, dims)).astype(np.float32)
    vecs[n - 10:] = vecs[:10]  # exact duplicates: exact score ties
    rows = []
    for i in range(n):
        words = " ".join(rng.choice(vocab, int(rng.integers(2, 7))))
        rows.append((f"d{i}", words, ["Doc"] if i % 3 else ["Doc", "Note"],
                     [float(x) for x in vecs[i]]))
    queries = [[float(x) for x in rng.standard_normal(dims)] for _ in range(8)]
    return rows, queries + [rows[3][3], rows[n - 1][3]]


@pytest.fixture(scope="module")
def proc_dbs():
    rows, queries = _rows_for_procedures()
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False)
    jdb = nornicdb_tpu.open(auto_embed=False)
    for db in (tdb, jdb):
        for nid, text, labels, vec in rows:
            db.store(text, labels=labels, node_id=nid, embedding=vec)
        db.link("d0", "d1", "CITES")
        db.search  # the procedures read the search service
    yield tdb, jdb, queries
    tdb.close()
    jdb.close()


def _hits(result):
    return [(row[0].id, row[1]) for row in result.rows]


def _agree(a, b):
    return len(a) == len(b) and (not a or topk_agree(
        [[i for i, _ in a]], [[s for _, s in a]], [[i for i, _ in b]], [[s for _, s in b]],
        SCORE_ATOL))


def test_vector_procedure_matches_jax(proc_dbs):
    tdb, jdb, queries = proc_dbs
    q = "CALL db.index.vector.queryNodes('idx', $k, $v) YIELD node, score RETURN node, score"
    for v in queries:
        for k in (1, 5, 10):
            got, want = _hits(tdb.cypher(q, {"k": k, "v": v})), _hits(jdb.cypher(q, {"k": k, "v": v}))
            assert len(got) == k and _agree(got, want), (k, got, want)


def test_vector_procedure_rides_the_brute_force_tier(proc_dbs):
    tdb, _, queries = proc_dbs
    svc = tdb.search
    assert svc.hnsw is None and svc.stats.strategy == "brute"
    r = tdb.cypher("CALL db.index.vector.queryNodes('idx', 5, $v) YIELD node, score "
                   "RETURN node, score", {"v": queries[0]})
    exact = svc.vector_search_candidates(queries[0], 5, exact=True)
    assert _agree(_hits(r), exact)


def test_fulltext_procedure_matches_jax(proc_dbs):
    tdb, jdb, _ = proc_dbs
    q = "CALL db.index.fulltext.queryNodes('idx', $q, $k) YIELD node, score RETURN node.id, score"
    for text in ("alpha", "beta gamma", "theta eta zeta", "nothing"):
        for k in (3, 10):
            got, want = tdb.cypher(q, {"q": text, "k": k}).rows, jdb.cypher(q, {"q": text, "k": k}).rows
            assert [r[0] for r in got] == [r[0] for r in want], text
            assert np.allclose([r[1] for r in got], [r[1] for r in want], atol=1e-6)


@pytest.mark.parametrize("query", [
    "CALL db.labels()",
    "CALL db.relationshipTypes()",
    "CALL db.propertyKeys()",
    "CALL db.schema.visualization()",
    "CALL db.awaitIndexes()",
    "CALL db.labels() YIELD label RETURN label ORDER BY label DESC",
    "MATCH (a:Doc)-[:CITES]->(b) RETURN a.content, b.content",
    "CALL db.index.vector.queryNodes('idx', 3, $v) YIELD node, score "
    "MATCH (node)-[:CITES]->(r) RETURN node.id, count(r)",
])
def test_catalog_procedures_match_jax(proc_dbs, query):
    tdb, jdb, queries = proc_dbs
    params = {"v": [float(x) for x in np.eye(16, dtype=np.float32)[0]]}
    got, want = tdb.cypher(query, params), jdb.cypher(query, params)
    assert got.columns == want.columns and got.rows == want.rows


def test_db_stats_procedures_match_jax(proc_dbs):
    tdb, jdb, _ = proc_dbs
    for db in (tdb, jdb):
        db.cypher("CALL db.stats.collect()")
    for q in ("CALL db.stats.stop()", "CALL db.stats.clear()"):
        assert tdb.cypher(q).rows == jdb.cypher(q).rows


def test_temporal_procedures_match_jax():
    stmts = [
        "CREATE (:V {k: 'a', from: datetime('2024-01-01T00:00:00Z'), "
        "to: datetime('2024-02-01T00:00:00Z'), v: 1})",
        "CREATE (:V {k: 'a', from: datetime('2024-02-01T00:00:00Z'), v: 2})",
    ]
    jx, tx = JExecutor(JNamespaced(JMemory(), "t")), CypherExecutor(NamespacedEngine(MemoryEngine(), "t"))
    for s in stmts:
        jx.execute(s)
        tx.execute(s)
    for at in ("2024-01-15T00:00:00Z", "2024-03-01T00:00:00Z", "2023-01-01T00:00:00Z"):
        q = ("CALL db.temporal.asOf('V', 'k', 'a', 'from', 'to', datetime($at)) "
             "YIELD node RETURN node.v")
        assert tx.execute(q, {"at": at}).rows == jx.execute(q, {"at": at}).rows
    q = ("CALL db.temporal.assertNoOverlap('V', 'k', 'from', 'to', 'a', "
         "datetime('2024-01-10T00:00:00Z'), datetime('2024-01-20T00:00:00Z'))")
    with pytest.raises(JRuntimeError) as want:
        jx.execute(q)
    with pytest.raises(CypherRuntimeError) as got:
        tx.execute(q)
    assert str(got.value).split("node ")[0] == str(want.value).split("node ")[0]  # ids differ


def test_txlog_entries_match_jax_on_a_wal_engine(tmp_path):
    tdb = nornicdb_tpu_torch.open(str(tmp_path / "t"), device="cpu", engine="python",
                                  auto_embed=False)
    jdb = nornicdb_tpu.open(str(tmp_path / "j"), engine="python", auto_embed=False)
    try:
        for db in (tdb, jdb):
            db.cypher("CREATE (:A {n: 1, at: date('2024-01-02')})")
            db.cypher("MATCH (a:A) SET a.n = 2")
            db.cypher("MATCH (a:A) CREATE (a)-[:R]->(:B {n: 3})")
            db.cypher("MATCH (b:B) DETACH DELETE b")
        q = ("CALL db.txlog.entries($from) YIELD sequence, operation, data "
             "RETURN sequence, operation, data")

        def entries(db, start):
            return [(s, op, {k: v for k, v in d.items() if k in ("labels", "properties", "type")}
                     if isinstance(d, dict) else d)
                    for s, op, d in db.cypher(q, {"from": start}).rows]

        for start in (0, 2, 4):
            got, want = entries(tdb, start), entries(jdb, start)
            assert got and repr(got) == repr(want)
    finally:
        tdb.close()
        jdb.close()


def test_txlog_entries_without_a_wal_raise_as_jax():
    tx = CypherExecutor(NamespacedEngine(MemoryEngine(), "t"))
    with pytest.raises(CypherRuntimeError, match="WAL-backed"):
        tx.execute("CALL db.txlog.entries(0)")


# -- writes through the DB --------------------------------------------------------


@pytest.fixture
def hash_db():
    db = nornicdb_tpu_torch.open(device="cpu", embedder=HashEmbedder(dims=64))
    yield db
    db.close()


WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india juliett kilo lima "
         "mike november oscar papa quebec romeo sierra tango").split()


def test_cypher_create_reaches_the_embed_queue_and_the_index(hash_db):
    db = hash_db
    db.search
    db.cypher("UNWIND $rows AS r CREATE (:Memory {content: r.text, mid: r.mid})",
              {"rows": [{"text": f"note {w} about oslo", "mid": i} for i, w in enumerate(WORDS)]})
    db.flush()
    assert (db._embed_queue.embedded_count, db._embed_queue.failed_count) == (20, 0)
    mids = db.cypher("MATCH (m:Memory) WHERE m.mid < 3 RETURN m").rows
    assert len(mids) == 3 and all(row[0].embedding is not None for row in mids)
    assert len(db.search.vectors) == 20
    hits = db.recall("note hotel about oslo", limit=3)
    assert hits[0]["properties"]["mid"] == 7
    lima = db.cypher("MATCH (m:Memory {mid: 11}) RETURN m").rows[0][0]
    v = db._embedder.embed(build_embedding_text(lima))  # content and labels
    r = db.cypher("CALL db.index.vector.queryNodes('memory', 1, $v) YIELD node, score "
                  "RETURN node.mid, score", {"v": v})
    assert r.rows[0][0] == 11 and abs(r.rows[0][1] - 1.0) < 1e-5


def test_a_cypher_write_invalidates_both_result_caches(hash_db):
    db = hash_db
    db.cypher("CREATE (:Memory {content: 'alpha beta'})")
    db.flush()
    svc = db.search
    count = "MATCH (m:Memory) RETURN count(m)"
    assert db.cypher(count).rows == [[1]]
    hits0 = db.executor.query_cache.hits
    assert db.cypher(count).rows == [[1]] and db.executor.query_cache.hits == hits0 + 1
    assert len(db.recall("alpha")) == 1
    cache_hits = svc.stats.cache_hits
    assert len(db.recall("alpha")) == 1 and svc.stats.cache_hits == cache_hits + 1
    gen = svc.generation
    db.cypher("CREATE (:Memory {content: 'alpha gamma'})")
    db.flush()
    assert svc.generation > gen
    assert db.cypher(count).rows == [[2]]
    assert len(db.recall("alpha")) == 2 and svc.stats.cache_hits == cache_hits + 1


def test_own_writes_keep_the_snapshot_and_external_writes_drop_it():
    db = nornicdb_tpu_torch.open(device="cpu", auto_embed=False)
    try:
        db.cypher("CREATE (:P {id: 1})")
        catalog = db.executor.columnar
        db.cypher("MATCH (p:P {id: 1}) RETURN p.id")
        assert catalog._nodes is not None
        db.cypher("CREATE (:P {id: 2})")
        assert catalog._nodes is not None, "the listener dropped the executor's own delta"
        db.cypher("MATCH (a:P {id: 1}), (b:P {id: 2}) CREATE (a)-[:K]->(b)")
        assert catalog._nodes is not None
        assert db.cypher("MATCH (p:P) RETURN count(p)").rows == [[2]]
        db.store("external", node_id="x1", labels=["P"])  # appended as a delta
        assert db.cypher("MATCH (p:P) RETURN count(p)").rows == [[3]]
        db.link("x1", db.cypher("MATCH (p:P {id: 1}) RETURN p").rows[0][0].id, "K")
        assert catalog._nodes is None  # an external edge drops the snapshot
        assert db.cypher("MATCH (a)-[:K]->(b) RETURN count(*)").rows == [[2]]
    finally:
        db.close()


def test_embedding_write_backs_swap_the_snapshot_in_place(hash_db):
    db = hash_db
    db._embed_queue.stop()  # write back by hand, as the queue would
    db.cypher("CREATE (:Memory {content: 'alpha', mid: 1})")
    db.cypher("MATCH (m:Memory) RETURN m.mid")
    catalog = db.executor.columnar
    version = catalog.version
    node = db.storage.get_node(db.cypher("MATCH (m:Memory) RETURN m").rows[0][0].id)
    node.embedding = [1.0] + [0.0] * 63
    db.storage.update_node(node)
    assert catalog._nodes is not None and catalog.version == version
    assert db.cypher("MATCH (m:Memory) RETURN m").rows[0][0].embedding == node.embedding


def test_link_and_neighbors_match_jax():
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False)
    jdb = nornicdb_tpu.open(auto_embed=False)
    try:
        for db in (tdb, jdb):
            for nid in "abcd":
                db.store(f"node {nid}", node_id=nid)
            db.link("a", "b", edge_id="e1")
            db.link("c", "a", "KNOWS", {"w": 2}, edge_id="e2")
            db.link("a", "d", edge_id="e3")
        for direction in ("outgoing", "incoming", "both"):
            assert (sorted(n.id for n in tdb.neighbors("a", direction))
                    == sorted(n.id for n in jdb.neighbors("a", direction)))
        e = tdb.storage.get_edge("e2")
        assert (e.type, e.start_node, e.end_node, e.properties) == ("KNOWS", "c", "a", {"w": 2})
        q = "MATCH (a {content: 'node a'})-[r]-(x) RETURN type(r), x.content ORDER BY x.content"
        assert tdb.cypher(q).rows == jdb.cypher(q).rows
    finally:
        tdb.close()
        jdb.close()


@pytest.mark.parametrize("engine", ["python", "native"])
def test_temporal_properties_written_by_cypher_reopen_across_packages(tmp_path, engine):
    stmt = "CREATE (:Event {k: $k, at: datetime($s), d: date($d), span: duration($p), p: point({x: 1.5, y: $k})})"
    q = "MATCH (e:Event) RETURN e.k, e.at, e.d, e.span, e.p ORDER BY e.k"
    for writer, reader in ((nornicdb_tpu_torch, nornicdb_tpu), (nornicdb_tpu, nornicdb_tpu_torch)):
        path = str(tmp_path / writer.__name__)
        kw = {"device": "cpu"} if writer is nornicdb_tpu_torch else {}
        db = writer.open(path, engine=engine, auto_embed=False, **kw)
        for k in range(5):
            db.cypher(stmt, {"k": k, "s": f"2024-0{k + 1}-02T03:04:05Z", "d": f"2023-12-2{k}",
                             "p": f"P{k}DT{k + 1}H"})
        before = [[str(v) for v in row] for row in db.cypher(q).rows]
        db.close()
        kw = {"device": "cpu"} if reader is nornicdb_tpu_torch else {}
        db = reader.open(path, engine="auto", auto_embed=False, **kw)
        try:
            rows = db.cypher(q).rows
            assert [[str(v) for v in row] for row in rows] == before
            assert type(rows[0][1]).__name__ == "CypherDateTime"
            assert db.cypher("MATCH (e:Event) WHERE e.at > datetime('2024-03-01T00:00:00Z') "
                             "RETURN count(e)").rows == [[3]]
        finally:
            db.close()


# -- APOC, once NotPortedError ----------------------------------------------------


@pytest.mark.parametrize("query", [
    "RETURN apoc.coll.sum([1, 2])",
    "UNWIND [1, 2] AS x RETURN apoc.agg.median(x)",
    "CALL apoc.help('coll')",
])
def test_apoc_and_gds_raise_not_ported_where_jax_answers(query):
    """Its name dates from when the port raised ``NotPortedError`` here
    (ROADMAP C21): an APOC function, an ``apoc.agg.*`` aggregate and a
    ``CALL apoc.*`` now answer as the JAX package does."""
    want = JExecutor(JNamespaced(JMemory(), "t")).execute(query)
    got = CypherExecutor(NamespacedEngine(MemoryEngine(), "t"), device="cpu").execute(query)
    assert got.columns == want.columns
    assert got.rows == want.rows and got.rows


# -- gds.* procedures ------------------------------------------------------------

_GDS_PROJECT = "CALL gds.graph.project('g', 'P', 'KNOWS')"
_LP_SOURCES = ("p0", "p3", "p7", "p12")


def _gds_pair():
    """The same seeded graph (24 people, KNOWS and LIKES edges, unit
    embeddings) under both executors, each with a search service over it
    for ``gds.linkPrediction.predict.stream``."""
    from nornicdb_tpu.search.service import SearchService as JService
    from nornicdb_tpu.storage import Edge as JEdge
    from nornicdb_tpu.storage import Node as JNode
    from nornicdb_tpu_torch.search.service import SearchService as TService

    rng = random.Random(4)
    vecs = np.random.default_rng(4).standard_normal((24, 8)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    edges = [(f"p{rng.randrange(24)}", f"p{rng.randrange(24)}", rng.choice(["KNOWS", "LIKES"]))
             for _ in range(70)]
    out = []
    for mem, ns, node_cls, edge_cls, ex_cls, svc_of in (
            (JMemory, JNamespaced, JNode, JEdge, JExecutor, JService),
            (MemoryEngine, NamespacedEngine, Node, Edge, CypherExecutor,
             lambda e: TService(e, device="cpu"))):
        eng = ns(mem(), "t")
        svc = svc_of(eng)
        for i in range(24):
            eng.create_node(node_cls(id=f"p{i}", labels=["P"] if i < 20 else ["Q"],
                                     properties={"name": f"p{i}"}, embedding=vecs[i].tolist()))
            svc.index_node(eng.get_node(f"p{i}"))
        for j, (a, b, t) in enumerate(edges):
            eng.create_edge(edge_cls(id=f"k{j}", type=t, start_node=a, end_node=b))
        ex = ex_cls(eng)
        ex.set_search_service(svc)
        out.append(ex)
    return out


_LP_PROCS = ("adamicAdar", "commonNeighbors", "jaccard", "preferentialAttachment",
             "resourceAllocation")

GDS_CASES = {
    "version": ["CALL gds.version() YIELD version RETURN version"],
    "graph_list_empty": ["CALL gds.graph.list()"],
    "project_list_drop": [
        _GDS_PROJECT, "CALL gds.graph.project('all', '*', '*')",
        "CALL gds.graph.list() YIELD graphName, nodeCount, relationshipCount "
        "RETURN graphName, nodeCount, relationshipCount ORDER BY graphName",
        "CALL gds.graph.drop('g')", "CALL gds.graph.list()"],
    "fastrp_default": [_GDS_PROJECT, "CALL gds.fastRP.stream('g', {}) YIELD nodeId, embedding "
                       "RETURN nodeId, embedding"],
    "fastrp_config": [
        "CALL gds.graph.project('all', '*', '*')",
        "CALL gds.fastRP.stream('all', {embeddingDimension: 16, iterationWeights: [1.0, 0.5], "
        "normalizationStrength: -0.5, randomSeed: 7}) YIELD nodeId, embedding "
        "RETURN nodeId, embedding"],
    **{f"linkprediction_{p}": [
        f"CALL gds.linkPrediction.{p}.stream({{sourceNode: '{s}', topK: 5}}) "
        "YIELD node1, node2, score RETURN node1, node2, score" for s in _LP_SOURCES]
       for p in _LP_PROCS},
    "linkprediction_predict": [
        f"CALL gds.linkPrediction.predict.stream({{sourceNode: '{s}', topK: 4, "
        f"topologyWeight: {w}}}) YIELD node1, node2, score, topology_score, semantic_score "
        "RETURN node1, node2, score, topology_score, semantic_score"
        for s in _LP_SOURCES for w in (0.3, 1.0)],
}

GDS_ERRORS = [
    "CALL gds.fastRP.stream('missing', {})",
    "CALL gds.graph.drop('missing')",
    "CALL gds.graph.project('g', 'P')",
    "CALL gds.linkPrediction.adamicAdar.stream({topK: 3})",
    "CALL gds.linkPrediction.adamicAdar.stream('p1')",
    "CALL gds.linkPrediction.nosuch.stream({sourceNode: 'p1'})",
]


@pytest.mark.parametrize("case", sorted(GDS_CASES))
def test_gds_procedures_match_jax(case):
    """Each ``gds.*`` procedure answers as the JAX package's: the graph
    catalog, host FastRP (bitwise), host link prediction (bitwise); the
    hybrid ``predict.stream`` blends a vector search's cosines, so its
    scores agree within 1e-6 with the same node order."""
    jex, tex = _gds_pair()
    for q in GDS_CASES[case]:
        want, got = jex.execute(q), tex.execute(q)
        assert got.columns == want.columns, q
        if case == "linkprediction_predict":
            assert [r[:2] for r in got.rows] == [r[:2] for r in want.rows], q
            assert np.allclose([r[2:] for r in got.rows], [r[2:] for r in want.rows],
                               rtol=0.0, atol=1e-6), q
        else:
            assert got.rows == want.rows, q
        if case.startswith(("fastrp", "linkprediction")) and "project" not in q:
            assert got.rows, q


@pytest.mark.parametrize("query", GDS_ERRORS)
def test_gds_procedure_errors_match_jax(query):
    jex, tex = _gds_pair()
    jex.execute(_GDS_PROJECT)
    tex.execute(_GDS_PROJECT)
    if "project" in query:
        query = _GDS_PROJECT  # a second projection of the same name
    with pytest.raises(Exception) as want:
        jex.execute(query)
    with pytest.raises(Exception) as got:
        tex.execute(query)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_strict_parser_mode_raises_not_ported():
    """Its name dates from when the port raised ``NotPortedError`` for
    ``parser_mode="strict"`` (ROADMAP C21): the mode now validates as the
    JAX package's, answering a valid query and raising the same error,
    diagnostics and all, for one the fast parser would take."""
    ex = CypherExecutor(NamespacedEngine(MemoryEngine(), "t"), parser_mode="strict")
    jex = JExecutor(JNamespaced(JMemory(), "t"), parser_mode="strict")
    assert ex.execute("RETURN 1 AS x").rows == jex.execute("RETURN 1 AS x").rows == [[1]]
    bad = "MATCH (n) RETURN m"
    with pytest.raises(JSyntaxError) as want:
        jex.execute(bad)
    with pytest.raises(CypherSyntaxError) as got:
        ex.execute(bad)
    assert str(got.value) == str(want.value)
    assert CypherExecutor(NamespacedEngine(MemoryEngine(), "t")).execute(bad).rows == []


def test_unknown_function_and_procedure_raise_as_jax():
    for query in ("RETURN nosuch(1)", "CALL db.nosuch()"):
        with pytest.raises(JRuntimeError) as want:
            JExecutor(JNamespaced(JMemory(), "t")).execute(query)
        with pytest.raises(CypherRuntimeError) as got:
            CypherExecutor(NamespacedEngine(MemoryEngine(), "t")).execute(query)
        assert str(got.value) == str(want.value)


def test_vector_procedure_without_a_search_service_raises_as_jax():
    q = "CALL db.index.vector.queryNodes('i', 1, [1.0])"
    with pytest.raises(JRuntimeError) as want:
        JExecutor(JNamespaced(JMemory(), "t")).execute(q)
    with pytest.raises(CypherRuntimeError) as got:
        CypherExecutor(NamespacedEngine(MemoryEngine(), "t")).execute(q)
    assert str(got.value) == str(want.value)
