"""The port's strict parser mode (``nornicdb_tpu_torch/query/strict.py``,
``strict_grammar.py``) against the JAX package's: the grammar's verdict
and position, ``validate``'s whole diagnostics and ``assert_valid``'s
error over the accept/reject corpus of ``tests/test_strict_grammar.py``,
the parser corpus that ``tests/test_torch_cypher.py`` uses and a few
semantic and APOC cases; and ``parser_mode="strict"`` executors of both
packages on the fast-path parity corpus, whose rows must equal the fast
mode's. Both sides are host code: results compare exactly."""

import dataclasses

import pytest
import torch

import test_fastpath_parity as parity
import test_strict_grammar as reference
from nornicdb_tpu.query import strict as jstrict
from nornicdb_tpu.query import strict_grammar as jgrammar
from nornicdb_tpu.query.executor import CypherExecutor as JExecutor
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import NamespacedEngine as JNamespaced
from nornicdb_tpu_torch.query import strict as tstrict
from nornicdb_tpu_torch.query import strict_grammar as tgrammar
from nornicdb_tpu_torch.query.executor import CypherExecutor
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, NamespacedEngine, Node
from test_torch_cypher import PARSER_QUERIES

torch.set_num_threads(1)

SEMANTIC = [
    "MATCH (n) RETURN m",
    "MATCH (n)\nWHERE count(n) > 1\nRETURN n",
    "MATCH (n) RETURN nosuch(n)",
    "RETURN apoc.nosuch.fn(1)",
    "UNWIND [1, 2] AS x RETURN apoc.agg.median(x), apoc.agg.nosuch(x)",
    "RETURN apoc.text.join(['a'], '-') AS j, apoc.coll.sum([1]) AS s",
    "MATCH (n) WITH n AS m RETURN n",
    "CALL apoc.help('coll') YIELD name RETURN name",
    "MATCH (a)-[r]->(b)\nWITH a\nRETURN r",
    "MATCH (n)\nRETURN n\nLIMIT -1",
    "MATCH (n) RETURN n LIMIT $lim SKIP $s",
    "RETURN [x IN [1, 2] | y] AS bad",
]

CORPUS = sorted(set(reference.VALID) | set(reference.MALFORMED_BOTH)
                | set(reference.STRICT_ONLY) | set(PARSER_QUERIES) | set(SEMANTIC))


def _grammar(mod, query):
    try:
        mod.parse(query)
        return None
    except Exception as e:  # compared across packages
        return (type(e).__name__, str(e), getattr(e, "line", None), getattr(e, "column", None),
                getattr(e, "bare_message", None))


@pytest.mark.parametrize("query", CORPUS)
def test_grammar_verdict_and_position_match_jax(query):
    assert _grammar(tgrammar, query) == _grammar(jgrammar, query)


@pytest.mark.parametrize("query", CORPUS)
def test_validate_diagnostics_match_jax(query):
    want = jstrict.validate(query)
    got = tstrict.validate(query)
    assert [dataclasses.astuple(d) for d in got] == [dataclasses.astuple(d) for d in want]
    assert [str(d) for d in got] == [str(d) for d in want]


def _assert_valid(mod, query):
    try:
        mod.assert_valid(query)
        return None
    except Exception as e:  # compared across packages
        return type(e).__name__, str(e)


@pytest.mark.parametrize("query", CORPUS)
def test_assert_valid_errors_match_jax(query):
    assert _assert_valid(tstrict, query) == _assert_valid(jstrict, query)


def test_corpus_holds_every_verdict():
    verdicts = {_assert_valid(tstrict, q) is None for q in CORPUS}
    assert verdicts == {True, False}
    assert any(tstrict.validate(q) and tstrict.validate(q)[0].line > 1 for q in CORPUS)


@pytest.fixture(scope="module")
def parity_graphs():
    """The parity corpus's graph in both packages (same ids and order)."""
    build = getattr(parity.graph, "__wrapped__", parity.graph)
    jeng = build()
    teng = NamespacedEngine(MemoryEngine(), "test")
    for n in jeng.all_nodes():
        teng.create_node(Node.from_dict(n.to_dict()))
    for e in jeng.all_edges():
        teng.create_edge(Edge.from_dict(e.to_dict()))
    return jeng, teng


@pytest.mark.parametrize("query,params,ordered", parity.CORPUS)
def test_strict_mode_rows_equal_fast_mode_and_jax(parity_graphs, query, params, ordered):
    """A query the strict mode takes answers the fast mode's rows; one it
    refuses (a reserved word as a label, an aggregate nested in a
    function) raises the same error in both packages."""
    jeng, teng = parity_graphs
    js = JExecutor(jeng, parser_mode="strict")
    ts = CypherExecutor(teng, parser_mode="strict", device="cpu")
    tf = CypherExecutor(teng, device="cpu")
    for ex in (js, ts, tf):
        ex.enable_query_cache = False
    refused = _assert_valid(jstrict, query)
    if refused is not None:
        with pytest.raises(Exception) as got:
            ts.execute(query, params)
        assert (type(got.value).__name__, str(got.value)) == refused
        with pytest.raises(Exception) as want:
            js.execute(query, params)
        assert (type(want.value).__name__, str(want.value)) == refused
        return
    want = js.execute(query, params)
    for got in (ts.execute(query, params), tf.execute(query, params)):
        assert got.columns == want.columns
        if ordered:
            assert [repr(r) for r in got.rows] == [repr(r) for r in want.rows]
        else:
            assert sorted(map(repr, got.rows)) == sorted(map(repr, want.rows))


@pytest.mark.parametrize("query", reference.STRICT_ONLY + ["MATCH (n) RETURN m"])
def test_strict_executor_refuses_as_jax(query):
    """What the fast mode runs and the strict mode refuses raises the
    same error in both packages' strict executors."""
    jex = JExecutor(JNamespaced(JMemory(), "t"), parser_mode="strict")
    tex = CypherExecutor(NamespacedEngine(MemoryEngine(), "t"), parser_mode="strict",
                         device="cpu")
    with pytest.raises(Exception) as want:
        jex.execute(query)
    with pytest.raises(Exception) as got:
        tex.execute(query)
    assert type(got.value).__name__ == type(want.value).__name__ == "CypherSyntaxError"
    assert str(got.value) == str(want.value)

