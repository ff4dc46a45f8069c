"""The port's transaction overlay and manager (``nornicdb_tpu_torch/storage/txn.py``)
against the JAX package's: the same op sequences through both packages'
``TransactionOverlay`` and ``TransactionManager`` (commit, rollback,
timeout reaping, reads of a transaction's own writes, and conflicts)
give the same answers, the same errors and the same committed state."""

import types

import pytest

from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import txn as j_txn
from nornicdb_tpu.storage.types import Edge as JEdge
from nornicdb_tpu.storage.types import Node as JNode
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node
from nornicdb_tpu_torch.storage import txn as t_txn

JAX = types.SimpleNamespace(txn=j_txn, Memory=JMemory, Node=JNode, Edge=JEdge)
PORT = types.SimpleNamespace(txn=t_txn, Memory=MemoryEngine, Node=Node, Edge=Edge)


def _state(eng):
    nodes = sorted((n.id, sorted(n.labels), n.properties) for n in eng.all_nodes())
    edges = sorted((e.id, e.start_node, e.end_node, e.type, e.properties)
                   for e in eng.all_edges())
    return nodes, edges


def _attempt(fn):
    """(result, None) or (None, error class name and message)."""
    try:
        return fn(), None
    except Exception as exc:  # noqa: BLE001 -- the error is what is compared
        return None, (type(exc).__name__, str(exc))


def _seeded(side):
    eng = side.Memory()
    eng.create_node(side.Node("a", labels=["P"], properties={"v": 1}))
    eng.create_node(side.Node("b", labels=["P"], properties={"v": 2}))
    eng.create_edge(side.Edge("ab", "KNOWS", "a", "b", properties={"w": 1}))
    return eng


def _script(side, finish):
    """One transaction's ops over a seeded engine; ``finish`` is commit or
    rollback. Returns what the transaction read, the errors it met, the
    op count its end returned and the inner engine's state."""
    eng = _seeded(side)
    tx = side.txn.TransactionOverlay(eng)
    seen = []
    tx.create_node(side.Node("c", labels=["Q"], properties={"v": 3}))
    seen.append(tx.get_node("c").properties)  # read-your-writes
    seen.append(eng.has_node("c"))  # not yet visible below
    n = tx.get_node("a")
    n.properties["v"] = 10
    tx.update_node(n)
    seen.append(tx.get_node("a").properties["v"])
    seen.append(eng.get_node("a").properties["v"])
    tx.create_edge(side.Edge("ca", "LIKES", "c", "a"))
    seen.append(sorted(e.id for e in tx.get_node_edges("a")))
    tx.delete_node("b")  # cascades the KNOWS edge inside the tx
    seen.append((tx.has_node("b"), tx.has_edge("ab"), eng.has_edge("ab")))
    seen.append(sorted(x.id for x in tx.get_nodes_by_label("P")))
    seen.append(sorted(x.id for x in tx.get_edges_by_type("LIKES")))
    seen.append([x.id if x else None for x in tx.batch_get_nodes(["a", "b", "c", "zz"])])
    seen.append((tx.count_nodes(), tx.count_edges()))
    seen.append(_attempt(lambda: tx.create_node(side.Node("a"))))  # conflict
    seen.append(_attempt(lambda: tx.get_node("b")))
    seen.append(_attempt(lambda: tx.create_edge(side.Edge("x", "R", "a", "nope"))))
    seen.append(_attempt(lambda: tx.delete_edge("nope")))
    e = tx.get_edge("ca")
    e.type, e.properties = "CHANGED", {"k": 1}
    tx.update_edge(e)  # the type is immutable
    seen.append((tx.get_edge("ca").type, tx.get_edge("ca").properties))
    ops = getattr(tx, finish)()
    seen.append(_attempt(lambda: tx.create_node(side.Node("late"))))  # closed
    seen.append(_attempt(getattr(tx, finish)))
    return seen, ops, tx.is_open, _state(eng)


@pytest.mark.parametrize("finish", ["commit", "rollback"])
def test_overlay_script_matches(finish):
    j, t = _script(JAX, finish), _script(PORT, finish)
    assert j == t
    seen, ops, is_open, (nodes, edges) = t
    assert not is_open and ops == 6  # create, update, create edge, cascade, delete, update edge
    assert seen[0] == {"v": 3} and seen[1] is False and seen[2:4] == [10, 1]
    if finish == "commit":
        assert [n[0] for n in nodes] == ["a", "c"] and [e[0] for e in edges] == ["ca"]
    else:
        assert [n[0] for n in nodes] == ["a", "b"] and [e[0] for e in edges] == ["ab"]


def _manager(side, clock):
    mgr = side.txn.TransactionManager(timeout_seconds=30.0)
    eng = _seeded(side)
    out = []
    tx = mgr.begin("s1", eng)
    tx.create_node(side.Node("n1"))
    out.append(_attempt(lambda: mgr.begin("s1", eng)))  # one open tx per session
    out.append(mgr.get("s1") is tx)
    out.append(mgr.commit("s1"))
    out.append(mgr.get("s1"))
    out.append(_attempt(lambda: mgr.commit("s1")))
    out.append(_attempt(lambda: mgr.rollback("nobody")))
    tx2 = mgr.begin("s1", eng)  # a committed session may begin again
    tx2.create_node(side.Node("n2"))
    out.append(mgr.rollback("s1"))
    tx3 = mgr.begin("s2", eng)
    tx3.create_node(side.Node("n3"))
    mgr.begin("s3", eng)
    tx3.started_at = clock - 31.0  # s2 is past its timeout, s3 is not
    out.append(mgr.reap_expired())
    out.append((mgr.get("s2"), tx3.is_open, mgr.get("s3") is not None))
    out.append(_attempt(lambda: tx3.create_node(side.Node("n4"))))
    return out, _state(eng)


def test_manager_commit_rollback_conflict_and_timeout():
    import time

    now = time.time()
    j, t = _manager(JAX, now), _manager(PORT, now)
    assert j == t
    out, (nodes, _) = t
    assert out[0][1][0] == "RuntimeError" and out[2] == 1 and out[6] == 1
    assert out[7] == 1 and out[8] == (None, False, True) and out[9][1][0] == "TransactionClosed"
    assert [n[0] for n in nodes] == ["a", "b", "n1"]


@pytest.mark.parametrize("side", [JAX, PORT], ids=["jax", "port"])
def test_two_transactions_do_not_see_each_other(side):
    eng = _seeded(side)
    t1 = side.txn.TransactionOverlay(eng)
    t2 = side.txn.TransactionOverlay(eng)
    t1.create_node(side.Node("only1"))
    assert not t2.has_node("only1") and not eng.has_node("only1")
    t1.commit()
    assert t2.has_node("only1")  # reads fall through to the inner engine
    t2.delete_node("a")
    t2.rollback()
    assert eng.has_node("a")


def test_closed_error_class_matches():
    assert t_txn.TransactionClosed.__mro__[1].__name__ == j_txn.TransactionClosed.__mro__[1].__name__
    tx = t_txn.TransactionOverlay(MemoryEngine())
    tx.rollback()
    with pytest.raises(t_txn.TransactionClosed, match="already closed"):
        tx.commit()
