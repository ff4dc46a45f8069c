"""The port's namespaces and per-database limits (``multidb.py``,
``storage/composite.py``, ``DB.multidb_manager``) against the JAX
package's: the ``multidb.py`` cases of ``tests/test_schema_multidb.py``,
each run on both packages, and answers compared where both give one."""

import types

import pytest

import nornicdb_tpu
import nornicdb_tpu.multidb as jmultidb
import nornicdb_tpu_torch
import nornicdb_tpu_torch.multidb as tmultidb
from nornicdb_tpu.query.executor import CypherExecutor as JExecutor
from nornicdb_tpu.storage import CompositeEngine as JComposite
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import NamespacedEngine as JNamespaced
from nornicdb_tpu.storage.types import Edge as JEdge
from nornicdb_tpu.storage.types import Node as JNode
from nornicdb_tpu_torch.query.executor import CypherExecutor
from nornicdb_tpu_torch.storage import CompositeEngine, Edge, MemoryEngine, NamespacedEngine, Node

PACKAGES = {
    "jax": types.SimpleNamespace(
        m=jmultidb, Memory=JMemory, Namespaced=JNamespaced, Composite=JComposite,
        Node=JNode, Edge=JEdge, Executor=JExecutor, open=nornicdb_tpu.open, kw={}),
    "port": types.SimpleNamespace(
        m=tmultidb, Memory=MemoryEngine, Namespaced=NamespacedEngine, Composite=CompositeEngine,
        Node=Node, Edge=Edge, Executor=CypherExecutor, open=nornicdb_tpu_torch.open,
        kw={"device": "cpu"}),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _mgr(pkg, **kw):
    return pkg.m.DatabaseManager(pkg.Memory(), **kw)


# -- the DatabaseManager cases of tests/test_schema_multidb.py ---------------


def test_defaults_present(pkg):
    names = [d.name for d in _mgr(pkg).list_databases()]
    assert "system" in names and "neo4j" in names


def test_create_drop(pkg):
    mgr = _mgr(pkg)
    mgr.create_database("tenant1")
    mgr.get_storage("tenant1").create_node(pkg.Node(id="x", labels=["T"]))
    assert mgr.counts("tenant1") == {"nodes": 1, "edges": 0}
    assert mgr.get_storage("neo4j").count_nodes() == 0
    assert mgr.drop_database("tenant1") is True
    with pytest.raises(KeyError):
        mgr.get_storage("tenant1")
    mgr.create_database("tenant1")
    assert mgr.get_storage("tenant1").count_nodes() == 0


def test_invalid_names_and_duplicates(pkg):
    mgr = _mgr(pkg)
    with pytest.raises(pkg.m.DatabaseError):
        mgr.create_database("9starts-with-digit")
    with pytest.raises(pkg.m.DatabaseError):
        mgr.create_database("neo4j")
    assert mgr.create_database("neo4j", if_not_exists=True).default


def test_cannot_drop_system_or_default(pkg):
    mgr = _mgr(pkg)
    for name in ("system", "neo4j"):
        with pytest.raises(pkg.m.DatabaseError):
            mgr.drop_database(name)


def test_limits_enforced(pkg):
    mgr = _mgr(pkg)
    mgr.create_database("small", limits=pkg.m.DatabaseLimits(max_nodes=2, max_edges=1))
    eng = mgr.get_storage("small")
    eng.create_node(pkg.Node(id="1"))
    eng.create_node(pkg.Node(id="2"))
    with pytest.raises(pkg.m.DatabaseLimitExceeded):
        eng.create_node(pkg.Node(id="3"))
    eng.create_edge(pkg.Edge(id="e1", type="R", start_node="1", end_node="2"))
    with pytest.raises(pkg.m.DatabaseLimitExceeded):
        eng.create_edge(pkg.Edge(id="e2", type="R", start_node="2", end_node="1"))


def test_offline_status_blocks_routing(pkg):
    mgr = _mgr(pkg)
    mgr.create_database("t")
    mgr.set_status("t", "offline")
    with pytest.raises(pkg.m.DatabaseError):
        mgr.get_storage("t")
    mgr.set_status("t", "online")
    assert mgr.get_storage("t") is not None


def test_adopts_existing_namespaces_on_restart(pkg):
    base = pkg.Memory()
    mgr = pkg.m.DatabaseManager(base)
    mgr.create_database("t1")
    mgr.get_storage("t1").create_node(pkg.Node(id="n"))
    mgr2 = pkg.m.DatabaseManager(base)
    assert mgr2.exists("t1") and mgr2.get_storage("t1").count_nodes() == 1


def test_failed_sweep_keeps_tombstone(pkg):
    mgr = _mgr(pkg)
    mgr.create_database("t")
    mgr.get_storage("t").create_node(pkg.Node(id="n"))
    orig = mgr._base.delete_by_prefix
    mgr._base.delete_by_prefix = lambda p: (_ for _ in ()).throw(IOError("disk"))
    with pytest.raises(IOError):
        mgr.drop_database("t")
    mgr._base.delete_by_prefix = orig
    with pytest.raises(pkg.m.DatabaseError):
        mgr.create_database("t")


def test_max_databases(pkg):
    mgr = _mgr(pkg, max_databases=2)
    mgr.create_database("a")
    with pytest.raises(pkg.m.DatabaseLimitExceeded):
        mgr.create_database("b")


# -- the query and rate limits of tests/test_schema_multidb.py --------------


def _limited(pkg):
    mgr = _mgr(pkg)
    mgr.create_database("tenant", limits=pkg.m.DatabaseLimits(
        max_results=3, max_queries_per_second=5, max_writes_per_second=2))
    return mgr


def test_result_truncation(pkg):
    mgr = _limited(pkg)
    ex = pkg.Executor(mgr.get_storage("tenant"))
    for i in range(10):
        ex.execute("CREATE (:T {i: $i})", {"i": i})
    r = ex.execute("MATCH (t:T) RETURN t.i")
    mgr.truncate_result("tenant", r)
    assert len(r.rows) == 3


def test_query_rate_limit(pkg):
    mgr = _limited(pkg)
    for _ in range(5):
        mgr.enforce_query("tenant")
    with pytest.raises(pkg.m.DatabaseLimitExceeded):
        mgr.enforce_query("tenant")


def test_write_rate_limit_separate(pkg):
    mgr = _limited(pkg)
    mgr.enforce_query("tenant", is_write=True)
    mgr.enforce_query("tenant", is_write=True)
    with pytest.raises(pkg.m.DatabaseLimitExceeded):
        mgr.enforce_query("tenant", is_write=True)


def test_unlimited_db_unaffected(pkg):
    mgr = _limited(pkg)
    for _ in range(100):
        mgr.enforce_query("neo4j")


# -- the rest of multidb.py, against the JAX package ------------------------


def test_byte_limits_and_entity_sizes_match_jax():
    answers = []
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        mgr = _mgr(pkg)
        mgr.create_database("b", limits=pkg.m.DatabaseLimits(max_bytes=400))
        eng = mgr.get_storage("b")
        sizes, refused = [], 0
        for i in range(12):
            node = pkg.Node(id=f"n{i}", labels=["L"], properties={"text": "x" * (3 * i)})
            sizes.append(pkg.m.entity_size(node))
            try:
                eng.create_node(node)
            except pkg.m.DatabaseLimitExceeded:
                refused += 1
        eng.delete_node("n0")
        answers.append((sizes, refused, eng.inner.current_bytes(), eng.count_nodes()))
    assert answers[0] == answers[1]
    assert answers[0][1] > 0


def test_concurrent_query_slots_match_jax():
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        mgr = _mgr(pkg)
        mgr.create_database("c", limits=pkg.m.DatabaseLimits(max_concurrent_queries=1))
        with mgr.query_slot("c"):
            with pytest.raises(pkg.m.DatabaseLimitExceeded):
                with mgr.query_slot("c"):
                    pass
        with mgr.query_slot("c"):
            pass


def test_legacy_migration_matches_jax():
    answers = []
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        base = pkg.Memory()
        base.create_node(pkg.Node(id="old1", labels=["L"]))
        base.create_node(pkg.Node(id="old2"))
        base.create_edge(pkg.Edge(id="e", type="R", start_node="old1", end_node="old2"))
        mgr = pkg.m.DatabaseManager(base)
        first = mgr.migrate_legacy_data()
        again = mgr.migrate_legacy_data()
        neo = mgr.get_storage("neo4j")
        answers.append((first, again, sorted(n.id for n in neo.all_nodes()),
                        [(e.start_node, e.end_node) for e in neo.all_edges()],
                        mgr.is_migration_complete()))
    assert answers[0] == answers[1]
    assert answers[0][2] == ["old1", "old2"] and answers[0][1]["skipped"] == 1


def test_list_databases_and_listeners_match_jax():
    answers = []
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        mgr = _mgr(pkg)
        mgr.create_database("zeta")
        mgr.create_database("alpha", limits=pkg.m.DatabaseLimits(max_nodes=5))
        eng = mgr.get_storage("alpha")
        assert mgr.get_storage("alpha") is eng
        events = []

        class _Rec:
            def on_node_upsert(self, node):
                events.append(("upsert", node.id))

            def on_node_delete(self, node_id):
                events.append(("delete", node_id))

            def on_edge_upsert(self, edge):
                pass

            def on_edge_delete(self, edge_id):
                pass

            def on_bulk_change(self):
                events.append(("bulk",))

        eng.add_listener(_Rec())
        eng.create_node(pkg.Node(id="a"))
        eng.delete_node("a")
        mgr.set_limits("alpha", pkg.m.DatabaseLimits(max_nodes=1))
        answers.append(([(d.name, d.default, d.system, d.status) for d in mgr.list_databases()],
                        events, mgr.get_storage("alpha") is eng))
    assert answers[0] == answers[1]


def test_composite_engine_matches_jax():
    answers = []
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        primary, second = pkg.Memory(), pkg.Memory()
        second.create_node(pkg.Node(id="s1", labels=["L"]))
        comp = pkg.Composite(primary, [second])
        comp.create_node(pkg.Node(id="p1", labels=["L"]))
        comp.create_node(pkg.Node(id="p2"))
        comp.create_edge(pkg.Edge(id="e", type="R", start_node="p1", end_node="p2"))
        answers.append((
            sorted(n.id for n in comp.get_nodes_by_label("L")), comp.get_node("s1").id,
            comp.count_nodes(), comp.count_edges(), [n.id for n in comp.neighbors("p1")],
            primary.count_nodes(), second.count_nodes(),
        ))
        with pytest.raises(KeyError):
            comp.get_node("nope")
    assert answers[0] == answers[1]


def test_cypher_per_database_is_isolated_as_jax():
    answers = []
    for pkg in (PACKAGES["jax"], PACKAGES["port"]):
        mgr = _mgr(pkg)
        for name in ("a", "b"):
            mgr.create_database(name)
        ea, eb = (pkg.Executor(mgr.get_storage(n)) for n in ("a", "b"))
        ea.execute("UNWIND range(1, 5) AS i CREATE (:N {i: i})")
        eb.execute("CREATE (:N {i: 100})-[:R]->(:M)")
        out = [ex.execute("MATCH (n:N) RETURN count(n), sum(n.i)").rows for ex in (ea, eb)]
        mgr.drop_database("b")
        out.append(ea.execute("MATCH (n) RETURN count(n)").rows)
        out.append(sorted(mgr._base.list_namespaces()))
        answers.append(out)
    assert answers[0] == answers[1] == [[[5, 15]], [[1, 100]], [[5]], ["a"]]


@pytest.mark.parametrize("engine", ["memory", "python", "native"])
def test_db_multidb_manager_matches_jax(engine, tmp_path):
    """DB.multidb_manager: two databases beside the DB's own, on the
    chain below its namespace, durable with it."""
    answers = []
    for name, pkg in sorted(PACKAGES.items()):
        path = None if engine == "memory" else str(tmp_path / name)
        db = pkg.open(path, engine=engine, auto_embed=False, **pkg.kw)
        try:
            db.store("in the default database", node_id="d0")
            mgr = db.multidb_manager()
            assert db.multidb_manager() is mgr
            for tenant, n in (("t1", 3), ("t2", 2)):
                mgr.create_database(tenant)
                ex = pkg.Executor(mgr.get_storage(tenant))
                ex.execute("UNWIND range(1, $n) AS i CREATE (:T {i: i})", {"n": n})
            out = [mgr.counts(t) for t in ("neo4j", "t1", "t2")]
            out.append(db.cypher("MATCH (n) RETURN count(n)").rows)
            assert mgr.drop_database("t2")
            out.append(sorted(d.name for d in mgr.list_databases()))
        finally:
            db.close()
        if path is not None:
            db = pkg.open(path, engine="auto", auto_embed=False, **pkg.kw)
            try:
                mgr = db.multidb_manager()
                out.append((mgr.exists("t1"), mgr.exists("t2"), mgr.counts("t1")))
            finally:
                db.close()
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[0][:3] == [{"nodes": 1, "edges": 0}, {"nodes": 3, "edges": 0},
                              {"nodes": 2, "edges": 0}]
