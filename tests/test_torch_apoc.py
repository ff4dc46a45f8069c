"""The port's APOC (``nornicdb_tpu_torch/query/apoc*.py``) and schema
registry (``storage/schema.py``) against the JAX package's.

Every test of the reference's APOC files (``test_apoc_admin.py``,
``test_apoc_bulk.py``, ``test_apoc_ext.py``, ``test_apoc_graph_algo.py``,
``test_apoc_io.py``) and the APOC tests of ``test_cypher.py`` runs twice,
as a parametrised case of each test below:

- ``test_reference_apoc_twin``: the test's executors are twins, one of
  each package over storage of its own; every query goes through both,
  their columns and rows must be equal (floats exactly: this is the same
  host code), errors of the same type and message, and the test's own
  asserts read the JAX side's answers;
- ``test_reference_apoc_on_port``: the test runs on the port alone, so its
  asserts read the port's answers.

Within a twin, ``uuid.uuid4`` draws from a seeded stream of each side and
``random`` is reseeded alike before each side's query, so generated ids,
virtual entities and shuffles agree by value. Clocks do not: values under
time keys (log entries, job and periodic timings) compare by type, length
and format. ``CALL apoc.algo.pageRank``
compares as a node -> score map within rtol 1e-4 / atol 1e-7 (the JAX
program and PyTorch sum in other orders; ROADMAP C28).

The module-level registries (locks, the log ring, periodic jobs) are
fresh in each case for both packages and the jobs are cancelled at its
end. The concurrency cases of ``test_concurrency_apoc.py`` run on the
port, the schema cases of ``test_schema_multidb.py`` against the JAX
package's (error types and messages, receipt hashes, the constraint
file's bytes), and the C29 pins show a device fault in a trigger or an
``apoc.periodic`` batch propagating where the JAX package swallows it."""

import dataclasses
import importlib
import inspect
import math
import random
import re
import sys
import threading
import uuid

import numpy as np
import pytest
import torch

import nornicdb_tpu.query.apoc_admin as japoc_admin
import nornicdb_tpu.query.apoc_io as japoc_io
import nornicdb_tpu.storage.schema as jschema
import nornicdb_tpu_torch.errors as terrors
import nornicdb_tpu_torch.query.apoc as tapoc
import nornicdb_tpu_torch.query.apoc_admin as tapoc_admin
import nornicdb_tpu_torch.query.apoc_io as tapoc_io
import nornicdb_tpu_torch.storage.schema as tschema
from nornicdb_tpu.query.executor import CypherExecutor as JExecutor
from nornicdb_tpu.query.functions import PathValue as JPath
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import NamespacedEngine as JNamespaced
from nornicdb_tpu.storage.types import Edge as JEdge
from nornicdb_tpu.storage.types import Node as JNode
from nornicdb_tpu_torch.query.executor import CypherExecutor
from nornicdb_tpu_torch.query.functions import PathValue as TPath
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, NamespacedEngine, Node

torch.set_num_threads(1)

REFERENCE_FILES = ("test_apoc_admin", "test_apoc_bulk", "test_apoc_ext",
                   "test_apoc_graph_algo", "test_apoc_io")
# the APOC tests of test_cypher.py (its TestCallProcedures)
CYPHER_APOC = ("test_apoc_meta_stats", "test_apoc_functions", "test_pagerank")
PAGERANK_RTOL, PAGERANK_ATOL = 1e-4, 1e-7
# keys whose values are wall-clock readings: the log ring's entries, a
# periodic job's submission, apoc.periodic.iterate's duration
TIME_KEYS = {"ts", "submitted", "timeTaken"}


# -- the two sides of a twin -----------------------------------------------------

_SIDE = threading.local()
_REAL_UUID4 = uuid.uuid4


class _Streams:
    """One seeded uuid stream per side; threads outside a twin's query
    draw real uuids."""

    def __init__(self):
        self.rng = {"j": random.Random(1729), "t": random.Random(1729)}

    def uuid4(self):
        side = getattr(_SIDE, "name", None)
        if side is None:
            return _REAL_UUID4()
        return uuid.UUID(int=self.rng[side].getrandbits(128), version=4)


class _Run:
    def __init__(self, side):
        self.side = side

    def __enter__(self):
        _SIDE.name = self.side

    def __exit__(self, *exc):
        _SIDE.name = None


def _to_port(v):
    """A JAX-side value (a result read back as a parameter) in the
    port's types."""
    if isinstance(v, JNode):
        return Node(**{f.name: _to_port(getattr(v, f.name)) for f in dataclasses.fields(v)})
    if isinstance(v, JEdge):
        return Edge(**{f.name: _to_port(getattr(v, f.name)) for f in dataclasses.fields(v)})
    if isinstance(v, JPath):
        return TPath([_to_port(n) for n in v.nodes], [_to_port(r) for r in v.rels])
    if isinstance(v, dict):
        return {k: _to_port(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_port(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_to_port(x) for x in v)
    return v


def _norm(v, loose=False):
    """A comparable form of a result value of either package; ``loose``
    keeps only types, lengths and formats (clock readings)."""
    if isinstance(v, (JNode, Node)):
        return ("node", v.id, list(v.labels), _norm(v.properties, loose))
    if isinstance(v, (JEdge, Edge)):
        return ("edge", v.id, v.type, v.start_node, v.end_node, _norm(v.properties, loose))
    if isinstance(v, (JPath, TPath)):
        return ("path", [_norm(n, loose) for n in v.nodes], [_norm(r, loose) for r in v.rels])
    if isinstance(v, dict):
        return {str(k): _norm(x, loose or str(k) in TIME_KEYS) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x, loose) for x in v]
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, None if loose else v.tolist())
    if type(v).__module__.split(".")[0] in ("nornicdb_tpu", "nornicdb_tpu_torch"):
        return (type(v).__name__, len(str(v)) if loose else str(v))
    if isinstance(v, float) and math.isnan(v):
        return ("float", "nan")
    if loose:
        if isinstance(v, str):
            return ("str", len(v), re.sub(r"\d", "0", v))
        return (type(v).__name__,)
    if isinstance(v, (bool, int, float)):
        return (type(v).__name__, v)
    return v


def _same_pagerank(jr, tr):
    """The same rows as a map from the non-score columns to the score,
    within the tolerance; descending wherever two scores differ by more."""
    assert tr.columns == jr.columns and len(tr.rows) == len(jr.rows)
    si = [i for i, c in enumerate(jr.columns) if "score" in c][0]

    def by_key(rows):
        return {repr(_norm([v for i, v in enumerate(r) if i != si])): r[si] for r in rows}

    want, got = by_key(jr.rows), by_key(tr.rows)
    assert got.keys() == want.keys()
    for k, score in want.items():
        assert math.isclose(got[k], score, rel_tol=PAGERANK_RTOL, abs_tol=PAGERANK_ATOL), k
    scores = [r[si] for r in tr.rows]
    for a, b in zip(scores, scores[1:]):
        assert a >= b - (PAGERANK_ATOL + PAGERANK_RTOL * abs(b))


class TwinExecutor:
    """A JAX executor and a port executor over storage of their own,
    driven with the same queries; answers the JAX side's result."""

    def __init__(self, store, streams, **kw):
        self.j = JExecutor(store[0], **kw)
        self.t = CypherExecutor(store[1], device="cpu", **kw)
        self._streams = streams
        self._n = 0

    @property
    def storage(self):
        return self.j.storage

    @property
    def enable_query_cache(self):
        return self.j.enable_query_cache

    @enable_query_cache.setter
    def enable_query_cache(self, on):
        self.j.enable_query_cache = self.t.enable_query_cache = on

    def execute(self, query, params=None):
        self._n += 1
        state = random.getstate()
        out = {}
        for side, ex, p in (("j", self.j, params), ("t", self.t, _to_port(params))):
            random.seed(self._n)
            with _Run(side):
                try:
                    out[side] = (ex.execute(query, p), None)
                except Exception as e:  # compared below
                    out[side] = (None, e)
        random.setstate(state)
        (jr, je), (tr, te) = out["j"], out["t"]
        if je is not None:
            assert te is not None, f"the port answered where JAX raised {je!r}: {query}"
            assert type(te).__name__ == type(je).__name__, (query, te, je)
            assert str(te) == str(je), query
            raise je
        if te is not None:
            raise te
        if re.search(r"call\s+apoc\.algo\.pagerank", query, re.IGNORECASE):
            _same_pagerank(jr, tr)
            return jr
        assert tr.columns == jr.columns, query
        assert _norm(tr.rows) == _norm(jr.rows), query
        return jr


def _twin_factories(streams, made):
    def memory():
        return (JMemory(), MemoryEngine())

    def namespaced(inner, name):
        return (JNamespaced(inner[0], name), NamespacedEngine(inner[1], name))

    def executor(store, **kw):
        ex = TwinExecutor(store, streams, **kw)
        made.append(ex)
        return ex

    return {"MemoryEngine": memory, "NamespacedEngine": namespaced,
            "CypherExecutor": executor}


def _port_factories():
    return {"MemoryEngine": MemoryEngine, "NamespacedEngine": NamespacedEngine,
            "CypherExecutor": lambda store, **kw: CypherExecutor(store, device="cpu", **kw)}


# -- the reference's cases ------------------------------------------------------


def _expand(fn):
    """(id suffix, kwargs) of each parametrised case of ``fn``."""
    cases = [("", {})]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        new = []
        for sfx, kw in cases:
            for i, v in enumerate(values):
                v = v.values if hasattr(v, "values") and not isinstance(v, dict) else v
                vals = v if len(names) > 1 else (v,)
                new.append((f"{sfx}[{i}]", {**kw, **dict(zip(names, vals))}))
        cases = new
    return cases


def _reference_cases():
    cases = []
    for modname in REFERENCE_FILES + ("test_cypher",):
        mod = importlib.import_module(modname)
        for name, obj in vars(mod).items():
            if inspect.isclass(obj) and name.startswith("Test"):
                members = [(f"{name}::{m}", obj, getattr(obj, m)) for m in vars(obj)
                           if m.startswith("test_")]
            elif name.startswith("test_") and inspect.isfunction(obj):
                members = [(name, None, obj)]
            else:
                continue
            for label, cls, fn in members:
                if modname == "test_cypher" and fn.__name__ not in CYPHER_APOC:
                    continue
                for sfx, kw in _expand(fn):
                    cases.append(pytest.param(modname, cls, fn, kw,
                                              id=f"{modname}::{label}{sfx}"))
    return cases


CASES = _reference_cases()


@pytest.fixture()
def fresh_registries(monkeypatch):
    """Fresh locks, log ring and periodic jobs in both packages; the jobs
    are cancelled when the case ends."""
    jobs = []
    for admin, io in ((japoc_admin, japoc_io), (tapoc_admin, tapoc_io)):
        monkeypatch.setattr(admin, "LOCKS", admin._LockManager())
        monkeypatch.setattr(admin, "LOG", admin._LogRing())
        reg = io._JobRegistry()
        monkeypatch.setattr(io, "JOBS", reg)
        jobs.append(reg)
    yield
    for reg in jobs:
        for job in reg.list():
            reg.cancel(job["name"])


def _run_reference(mod, cls, fn, kw, tmp_path):
    self = cls() if cls is not None else None
    params = list(inspect.signature(fn).parameters)
    if self is not None:
        params = params[1:]
    args = dict(kw)
    if "ex" in params or "graph" in params:
        args["ex"] = mod.ex._get_wrapped_function()()
    if "graph" in params:
        args["graph"] = cls.graph._get_wrapped_function()(self, args["ex"])
    if "tmp_path" in params:
        args["tmp_path"] = tmp_path
    args = {k: v for k, v in args.items() if k in params}
    if self is not None:
        return fn(self, **args)
    return fn(**args)


@pytest.mark.parametrize("modname,cls,fn,kw", CASES)
def test_reference_apoc_twin(modname, cls, fn, kw, tmp_path, monkeypatch, fresh_registries):
    mod = importlib.import_module(modname)
    streams = _Streams()
    monkeypatch.setattr(uuid, "uuid4", streams.uuid4)
    made = []
    for name, factory in _twin_factories(streams, made).items():
        monkeypatch.setattr(mod, name, factory)
    _run_reference(mod, cls, fn, kw, tmp_path)
    takes_ex = {"ex", "graph"} & set(inspect.signature(fn).parameters)
    assert made or not takes_ex  # the fixture's executor was a twin


# modules a reference test imports inside its body, aliased to the port's
_PORT_ALIASES = {
    "nornicdb_tpu.errors": terrors,
    "nornicdb_tpu.query.apoc": tapoc,
    "nornicdb_tpu.query.apoc_admin": tapoc_admin,
}


@pytest.mark.parametrize("modname,cls,fn,kw", CASES)
def test_reference_apoc_on_port(modname, cls, fn, kw, tmp_path, monkeypatch, fresh_registries):
    mod = importlib.import_module(modname)
    for name, factory in _port_factories().items():
        monkeypatch.setattr(mod, name, factory)
    for name in ("CypherRuntimeError", "CypherSyntaxError"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, getattr(terrors, name))
    for name, port_mod in _PORT_ALIASES.items():
        monkeypatch.setitem(sys.modules, name, port_mod)
    _run_reference(mod, cls, fn, kw, tmp_path)


# -- the concurrency cases of test_concurrency_apoc.py, on the port -------------

CONCURRENCY_CLASSES = ("TestAtomicUnderThreads", "TestColumnarCachesUnderWrites",
                       "TestCacheBuildersRacingWriters", "TestLockManagerContention")


def _concurrency_cases():
    mod = importlib.import_module("test_concurrency_apoc")
    return [pytest.param(getattr(mod, c), m, id=f"{c}::{m}")
            for c in CONCURRENCY_CLASSES for m in vars(getattr(mod, c)) if m.startswith("test_")]


@pytest.mark.parametrize("cls,name", _concurrency_cases())
def test_concurrency_apoc_on_port(cls, name, monkeypatch, fresh_registries):
    """apoc.atomic under threads (no lost update, one CAS winner), the
    columnar caches under racing writes, and the lock manager's mutual
    exclusion and deadlock freedom, as the reference's cases assert them,
    on the port's executor and lock manager."""
    mod = importlib.import_module("test_concurrency_apoc")
    for attr, factory in _port_factories().items():
        monkeypatch.setattr(mod, attr, factory)
    for alias, port_mod in _PORT_ALIASES.items():
        monkeypatch.setitem(sys.modules, alias, port_mod)
    getattr(cls(), name)()


def test_atomic_add_under_threads_matches_jax():
    """Eight threads of apoc.atomic.add and apoc.atomic.increment on one
    counter end at the same value in both packages."""
    finals = []
    for ex in (JExecutor(JNamespaced(JMemory(), "conc")),
               CypherExecutor(NamespacedEngine(MemoryEngine(), "conc"), device="cpu")):
        ex.enable_query_cache = False
        ex.execute("CREATE (:Counter {id: 1, n: 0})")

        def worker(ex=ex):
            for i in range(20):
                fn = "apoc.atomic.add(c, 'n', 2)" if i % 2 else "apoc.atomic.increment(c, 'n')"
                ex.execute(f"MATCH (c:Counter {{id:1}}) RETURN {fn}")

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        finals.append(ex.execute("MATCH (c:Counter {id:1}) RETURN c.n").rows)
    assert finals[0] == finals[1] == [[8 * (10 * 2 + 10)]]


# -- storage/schema.py against the JAX package's ---------------------------------


def _schema_ops(S, Node, Edge, Memory):
    """The constraint cases of test_schema_multidb.py as one script of
    operations; each answers ('ok', value) or ('err', type, message)."""
    sm = S.SchemaManager()
    eng = S.ConstrainedEngine(Memory(), sm)

    def node(nid, labels=("Person",), **props):
        return Node(id=nid, labels=list(labels), properties=props)

    def update(nid, **props):
        n = eng.get_node(nid)
        n.properties.update(props)
        eng.update_node(n)

    C = S.Constraint
    return [
        lambda: sm.add(C(name="u", kind="unique", label="Person", property="email")),
        lambda: eng.create_node(node("a", email="x@y.z")),
        lambda: eng.create_node(node("b", email="x@y.z")),
        lambda: eng.create_node(node("c", email="other@y.z")),
        lambda: update("a", name="Ada"),
        lambda: update("c", email="x@y.z"),
        lambda: update("a", email="new@y.z"),
        lambda: eng.create_node(node("d", email="x@y.z")),
        lambda: eng.delete_node("d"),
        lambda: eng.create_node(node("e", email="x@y.z")),
        lambda: eng.create_node(node("f", email="new@y.z")),
        lambda: sm.add(C(name="u", kind="unique", label="Person", property="email")),
        lambda: sm.add(C(name="k", kind="nosuch")),
        lambda: sm.add(C(name="e", kind="exists", label="Person", property="name")),
        lambda: sm.add(C(name="t", kind="type", label="Person", property="age",
                         property_type="int")),
        lambda: eng.create_node(node("g")),
        lambda: eng.create_node(node("h", name="Hal", age=36)),
        lambda: eng.create_node(node("i", name="Bob", age="old")),
        lambda: eng.create_node(node("j", name="Eve", age=True)),
        lambda: sm.add(C(name="r", kind="rel_endpoints", rel_type="WORKS_AT",
                         start_label="Person", end_label="Company")),
        lambda: eng.create_node(node("co", labels=("Company",))),
        lambda: eng.create_node(node("x", labels=("Robot",))),
        lambda: eng.create_edge(Edge(id="ok", type="WORKS_AT", start_node="h", end_node="co")),
        lambda: eng.create_edge(Edge(id="bad", type="WORKS_AT", start_node="x", end_node="co")),
        lambda: eng.create_edge(Edge(id="any", type="KNOWS", start_node="x", end_node="h")),
        lambda: sm.add(C(name="iv", kind="temporal", label="Event", property="start",
                         property2="end")),
        lambda: eng.create_node(node("ev1", labels=("Event",), start=1, end=5)),
        lambda: eng.create_node(node("ev2", labels=("Event",), start=9, end=5)),
        lambda: eng.create_node(node("ev3", labels=("Event",), start=1, end="x")),
        lambda: sm.add(C(name="g", kind="unique", label="", property="key")),
        lambda: eng.create_node(Node(id="l1", labels=[], properties={"key": "x"})),
        lambda: eng.create_node(Node(id="l2", labels=[], properties={"key": "x"})),
        lambda: eng.create_node(node("l3", key="x", name="L", email="l3@y.z")),
        lambda: eng.validate_existing(),
        lambda: [c.to_dict() for c in sm.list()],
        lambda: sm.drop("u"),
        lambda: sm.drop("u"),
    ]


def _outcomes(ops):
    out = []
    for op in ops:
        try:
            v = op()
            out.append(("ok", v))
        except Exception as e:  # compared across packages
            out.append(("err", type(e).__name__, str(e)))
    return out


def test_constraints_answer_as_jax():
    """Unique (with the maintained index through updates and deletes),
    exists, type, relationship endpoints, temporal intervals, a global
    constraint and the sweep of existing data: the same answers, and
    the same ConstraintViolation type and message at each refusal."""
    import nornicdb_tpu.storage.types as jtypes

    want = _outcomes(_schema_ops(jschema, jtypes.Node, jtypes.Edge, JMemory))
    got = _outcomes(_schema_ops(tschema, Node, Edge, MemoryEngine))
    assert got == want
    refused = [o for o in got if o[0] == "err"]
    assert len(refused) >= 10 and {o[1] for o in refused} == {"ConstraintViolation"}
    assert issubclass(tschema.ConstraintViolation, terrors.ConstraintViolationError)
    assert issubclass(tschema.ConstraintViolation, ValueError)


@pytest.mark.parametrize("timestamps", ["fixed", "clock"])
def test_receipt_hashes_bitwise(timestamps, monkeypatch):
    """The hash chain of a ledger, receipt by receipt, and its
    verification after tampering, equal bitwise between packages."""
    import nornicdb_tpu.storage.types as jtypes
    import nornicdb_tpu_torch.storage.types as ttypes

    if timestamps == "clock":  # the ledger stamps receipts itself
        for mod in (jtypes, ttypes):
            monkeypatch.setattr(mod, "now_ms", lambda: 1_700_000_000_123)
    chains = []
    for S in (jschema, tschema):
        ledger = S.ReceiptLedger()
        for i in range(6):
            kw = {"timestamp_ms": 1_000 + i, "sequence": 10 + i} if timestamps == "fixed" else {}
            ledger.record(("create_node", "update_node", "delete_node")[i % 3], f"n{i}", **kw)
        rows = [dataclasses.astuple(r) for r in ledger.all()]
        ok = ledger.verify()
        ledger._receipts[3].entity_id = "evil"
        chains.append((rows, ok, ledger.verify()))
    assert chains[0] == chains[1]
    assert chains[1][1] == (True, -1) and chains[1][2] == (False, 3)


def test_schema_file_bytes_and_cross_reading(tmp_path):
    """The constraint file of each package is byte-equal to the other's,
    and each package reads the other's."""
    paths = {}
    for tag, S in (("j", jschema), ("t", tschema)):
        path = str(tmp_path / f"schema-{tag}.json")
        sm = S.SchemaManager(path)
        sm.add(S.Constraint(name="u", kind="unique", label="L", property="p"))
        sm.add(S.Constraint(name="r", kind="rel_endpoints", rel_type="R",
                            start_label="A", end_label="B"))
        sm.add(S.Constraint(name="iv", kind="temporal", label="E", property="s",
                            property2="e"))
        sm.drop("u")
        sm.add(S.Constraint(name="t", kind="type", label="L", property="n",
                            property_type="float"))
        paths[tag] = path
    with open(paths["j"], "rb") as fj, open(paths["t"], "rb") as ft:
        assert fj.read() == ft.read()
    for S, other in ((jschema, paths["t"]), (tschema, paths["j"])):
        assert [c.to_dict() for c in S.SchemaManager(other).list()] == \
            [c.to_dict() for c in jschema.SchemaManager(paths["j"]).list()]


def _schema_cases():
    mod = importlib.import_module("test_schema_multidb")
    cases = [pytest.param(getattr(mod, c), m, id=f"{c}::{m}")
             for c in ("TestConstraints", "TestReceipts")
             for m in vars(getattr(mod, c)) if m.startswith("test_")]
    cases.append(pytest.param(mod.TestDatabaseManager, "test_unique_index_tracks_mutations",
                              id="TestDatabaseManager::test_unique_index_tracks_mutations"))
    return cases


@pytest.mark.parametrize("cls,name", _schema_cases())
def test_schema_reference_on_port(cls, name, tmp_path, monkeypatch):
    """The constraint and receipt cases of test_schema_multidb.py, with
    the port's schema classes, engine and entities."""
    import nornicdb_tpu_torch.storage as tstorage

    mod = importlib.import_module("test_schema_multidb")
    for attr in ("ConstrainedEngine", "Constraint", "ConstraintViolation", "MemoryEngine",
                 "ReceiptLedger", "SchemaManager", "Edge", "Node"):
        monkeypatch.setattr(mod, attr, getattr(tstorage, attr))
    monkeypatch.setitem(sys.modules, "nornicdb_tpu.storage", tstorage)
    obj = cls()
    if cls.__name__ == "TestConstraints":
        obj.setup_method()
    fn = getattr(obj, name)
    fn(tmp_path) if "tmp_path" in inspect.signature(fn).parameters else fn()


def test_cypher_constraints_on_a_constrained_engine_answer_as_jax():
    """apoc.schema.* over a ConstrainedEngine in the chain: the executor
    finds its schema, writes that break it raise the same error, and
    apoc.schema.validate sweeps the store alike."""
    answers = []
    for S, Memory, Namespaced, Ex, kw in (
            (jschema, JMemory, JNamespaced, JExecutor, {}),
            (tschema, MemoryEngine, NamespacedEngine, CypherExecutor, {"device": "cpu"})):
        ex = Ex(Namespaced(S.ConstrainedEngine(Memory()), "sc"), **kw)
        out = []
        for q in ("CREATE (:U {k: 1}), (:U {k: 2})",
                  "RETURN apoc.schema.createUniqueConstraint('U', 'k')",
                  "CREATE (:U {k: 1})",
                  "CREATE (:U {k: 3})",
                  "MATCH (u:U) RETURN u.k ORDER BY u.k",
                  "RETURN apoc.schema.nodeConstraintExists('U', ['k'])",
                  "RETURN apoc.schema.stats()",
                  "MATCH (u:U {k: 3}) SET u.k = 2",
                  "RETURN apoc.schema.validate()",
                  "RETURN apoc.schema.dropConstraint('U', 'k')"):
            try:
                r = ex.execute(q)
                out.append((r.columns, _norm(r.rows)))
            except Exception as e:  # compared across packages
                out.append((type(e).__name__, str(e)))
        answers.append(out)
    assert answers[0] == answers[1]
    assert any(a[0] == "ConstraintViolation" for a in answers[1])


# -- export bytes ----------------------------------------------------------------

EXPORTS = [
    ("json_all", "CALL apoc.export.json.all($f, {}) YIELD nodes RETURN nodes"),
    ("csv_all", "CALL apoc.export.csv.all($f, {}) YIELD nodes RETURN nodes"),
    ("to_file_json", "RETURN apoc.export.toFile($f, 'json')"),
    ("to_file_cypher", "RETURN apoc.export.toFile($f, 'cypher')"),
    ("to_file_graphml", "RETURN apoc.export.toFile($f, 'graphml')"),
]


@pytest.mark.parametrize("name,query", EXPORTS, ids=[e[0] for e in EXPORTS])
def test_export_files_byte_equal(name, query, tmp_path, monkeypatch):
    """The same graph exported by each package to a file of its own under
    ``tmp_path``: the same bytes; the JSON dump imports back alike."""
    streams = _Streams()
    monkeypatch.setattr(uuid, "uuid4", streams.uuid4)
    ex = TwinExecutor((JNamespaced(JMemory(), "ex"), NamespacedEngine(MemoryEngine(), "ex")),
                      streams)
    ex.execute("CREATE (a:P {name: 'a', n: 1, xs: [1, 2]})-[:R {w: 0.5}]->"
               "(b:P:Q {name: 'b & \"c\"', ok: true}), (b)-[:S]->(:Co {name: 'x'})")
    data = {}
    for side, inner in (("j", ex.j), ("t", ex.t)):
        path = str(tmp_path / f"{side}-{name}")
        with _Run(side):
            inner.execute(query, {"f": path})
        with open(path, "rb") as f:
            data[side] = f.read()
    assert data["j"] == data["t"] and len(data["t"]) > 50
    if name == "json_all":
        path = str(tmp_path / f"j-{name}")
        twin = TwinExecutor((JNamespaced(JMemory(), "im"), NamespacedEngine(MemoryEngine(), "im")),
                            streams)
        twin.execute("CALL apoc.import.json($f) YIELD nodes, relationships RETURN *", {"f": path})
        twin.execute("MATCH (n)-[r]->(m) RETURN n.name, type(r), m.name ORDER BY n.name")


# -- C29: a device fault in a trigger or a periodic batch propagates ---------------


def _device_fault(*_a, **_k):
    raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


def _fault_pair(monkeypatch, fault):
    """Both packages' apoc.text.clean raising ``fault`` (the port's a
    RuntimeError subclass, as a CUDA or out-of-memory error is)."""
    import nornicdb_tpu.query.apoc as japoc

    monkeypatch.setitem(japoc.APOC_FUNCS, "apoc.text.clean", fault)
    monkeypatch.setitem(tapoc.APOC_FUNCS, "apoc.text.clean", fault)
    exs = (JExecutor(JNamespaced(JMemory(), "c29")),
           CypherExecutor(NamespacedEngine(MemoryEngine(), "c29"), device="cpu"))
    for ex in exs:
        ex.execute("UNWIND range(1, 5) AS i CREATE (:Item {i: i, s: 'x'})")
    return exs


def test_trigger_device_fault_propagates_where_jax_swallows(monkeypatch):
    jex, tex = _fault_pair(monkeypatch, _device_fault)
    for ex in (jex, tex):
        ex.execute("CALL apoc.trigger.add('t', 'MATCH (i:Item) SET i.c = apoc.text.clean(i.s)', {})")
    assert jex.execute("CREATE (:Item {i: 6})").stats.nodes_created == 1
    with pytest.raises(torch.OutOfMemoryError):
        tex.execute("CREATE (:Item {i: 6})")
    # the outer write landed before its trigger fired, as in the reference
    assert tex.execute("MATCH (i:Item) RETURN count(i)").rows == [[6]]


def test_trigger_query_error_is_still_swallowed_as_jax(monkeypatch):
    def value_fault(*_a):
        raise ValueError("bad value")

    jex, tex = _fault_pair(monkeypatch, value_fault)
    answers = []
    for ex in (jex, tex):
        ex.execute("CALL apoc.trigger.add('t', 'MATCH (i:Item) SET i.c = apoc.text.clean(i.s)', {})")
        ex.execute("CALL apoc.trigger.add('u', 'MATCH (i:Item) SET i.d = 1', {})")
        ex.execute("CREATE (:Item {i: 6})")
        answers.append(ex.execute("MATCH (i:Item) RETURN i.i, i.c, i.d ORDER BY i.i").rows)
    assert answers[0] == answers[1] and answers[1][0] == [1, None, 1]


_ITERATE = ("CALL apoc.periodic.iterate('MATCH (i:Item) RETURN i', "
            "'SET i.c = apoc.text.clean(i.s)', {batchSize: 2}) "
            "YIELD batches, committedOperations, failedOperations, errorMessages "
            "RETURN batches, committedOperations, failedOperations, errorMessages")


def test_periodic_batch_device_fault_propagates_where_jax_counts_it(monkeypatch):
    jex, tex = _fault_pair(monkeypatch, _device_fault)
    assert jex.execute(_ITERATE).rows[0][:3] == [3, 0, 5]
    with pytest.raises(torch.OutOfMemoryError):
        tex.execute(_ITERATE)


def test_periodic_batch_query_error_is_counted_as_jax(monkeypatch):
    def value_fault(*_a):
        raise ValueError("no")

    jex, tex = _fault_pair(monkeypatch, value_fault)
    rows = [ex.execute(_ITERATE).rows for ex in (jex, tex)]
    assert rows[0] == rows[1] == [[3, 0, 5, {"no": 5}]]


def test_trigger_writes_reach_the_chain_read_and_the_graph_plane():
    """A trigger's nested write goes through ``_execute_for_trigger``: a
    2-hop fast-path read warmed before it sees it afterwards (the query
    cache and the columnar catalog drop their copies, so the device graph
    plane's snapshots key on a new version), in both packages alike."""
    chain = ("MATCH (a:P {k: 0})-[:R]->(b:P)-[:R]->(c:P) "
             "RETURN count(DISTINCT c), sum(c.flag)")
    answers = []
    for ex in (JExecutor(JNamespaced(JMemory(), "tr")),
               CypherExecutor(NamespacedEngine(MemoryEngine(), "tr"), device="cpu")):
        ex.execute("UNWIND range(0, 29) AS i CREATE (:P {k: i, flag: 0})")
        ex.execute("MATCH (a:P), (b:P) WHERE b.k = (a.k + 1) % 30 OR b.k = (a.k + 7) % 30 "
                   "CREATE (a)-[:R]->(b)")
        before = ex.execute(chain).rows
        version = ex.columnar.version
        ex.execute("CALL apoc.trigger.add('flag', 'MATCH (p:P) SET p.flag = 1', {})")
        ex.execute("CREATE (:Q)")
        answers.append((before, ex.execute(chain).rows, ex.columnar.version > version))
    assert answers[0] == answers[1]
    assert answers[1][0] == [[3, 0]] and answers[1][1] == [[3, 4]] and answers[1][2]
