"""The port's storage layer against the JAX package: the record codec
against msgpack, the WAL's files byte for byte, the WAL and durable-engine
cases of ``tests/test_storage.py``, the engine contract, and data dirs of
both engines written by one package and opened by the other. ``msgpack``
is imported here only; the port does not use it."""

import os
import random
import string

import msgpack
import numpy as np
import pytest
from hypothesis import given, seed, settings
from hypothesis import strategies as st

import nornicdb_tpu.storage.wal as jwal
from nornicdb_tpu.storage import DurableEngine as JDurable
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import NamespacedEngine as JNamespaced
from nornicdb_tpu.storage import make_persistent_engine as j_make_persistent
from nornicdb_tpu.storage.disk import DiskEngine as JDisk
from nornicdb_tpu.storage.types import Edge as JEdge
from nornicdb_tpu.storage.types import Node as JNode
from nornicdb_tpu_torch.storage import (
    WAL,
    AlreadyExistsError,
    AsyncEngine,
    Direction,
    DurableEngine,
    Edge,
    MemoryEngine,
    NamespacedEngine,
    Node,
    NotFoundError,
    WALCorruptionError,
    WALEngine,
    make_persistent_engine,
)
from nornicdb_tpu_torch.storage import codec
from nornicdb_tpu_torch.storage import wal as twal
from nornicdb_tpu_torch.storage.disk import DiskEngine
from nornicdb_tpu_torch.storage.wal_engine import decode_op_args

PINNED_TIME = 1760000000.123456


def _msgpack(obj):
    return msgpack.packb(obj, use_bin_type=True)


def _unmsgpack(b):
    return msgpack.unpackb(b, raw=False, strict_map_key=False)


def _node_record(rng, i, dims=160):
    return {
        "id": f"neo4j:d{i}",
        "labels": ["Memory", f"L{i % 3}"],
        "properties": {"content": " ".join(rng.choice(["alpha", "beta", "gämma", "δ"])
                                           for _ in range(rng.randint(1, 40))),
                       "n": rng.randint(-2**40, 2**40), "f": rng.random()},
        "created_at": 1760000000000 + i,
        "updated_at": 1760000000000 + i,
        "embedding": [rng.uniform(-1, 1) for _ in range(dims)],
    }


# -- codec ----------------------------------------------------------------

INT_BOUNDARIES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                  2**63 - 1, 2**63, 2**64 - 1, -1, -32, -33, -128, -129,
                  -32768, -32769, -2**31, -2**31 - 1, -2**63]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("x", INT_BOUNDARIES)
def test_codec_ints_match_msgpack(x):
    assert codec.pack(x) == _msgpack(x)
    assert codec.unpack(_msgpack(x)) == x


@pytest.mark.parametrize("x", [2**64, -2**63 - 1])
def test_codec_refuses_ints_out_of_range_like_msgpack(x):
    with pytest.raises(OverflowError):
        _msgpack(x)
    with pytest.raises(OverflowError):
        codec.pack(x)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["str", "wide_str", "bin", "array", "float_array", "map"])
def test_codec_length_classes_match_msgpack(kind, n):
    obj = {"str": "x" * n, "wide_str": "é" * (n // 2), "bin": b"\x01" * n,
           "array": list(range(n)), "float_array": [i / 7 for i in range(n)],
           "map": {f"k{i}": i for i in range(n)}}[kind]
    b = _msgpack(obj)
    assert codec.pack(obj) == b
    assert codec.unpack(b) == _unmsgpack(b)


@pytest.mark.parametrize("x", [None, True, False, 0.0, -0.0, 1.5, float("inf"), -1e300,
                               (1, 2), [[], {}], {"a": {"b": [1.0, "x", None]}},
                               {1: "int key"}, [1.0, 2, 3.0], bytearray(b"ab"),
                               np.float64(0.25)])
def test_codec_scalars_and_nesting_match_msgpack(x):
    b = _msgpack(x)
    assert codec.pack(x) == b
    assert codec.unpack(b) == _unmsgpack(b)


def test_codec_node_records_match_msgpack():
    rng = random.Random(7)
    for i in range(200):
        rec = _node_record(rng, i)
        b = _msgpack(rec)
        assert codec.pack(rec) == b
        back = codec.unpack(b)
        assert back == _unmsgpack(b)
        assert all(type(x) is float for x in back["embedding"])


def test_codec_reads_float32_and_nan():
    b = msgpack.packb([1.5, 2.5], use_single_float=True)
    assert codec.unpack(b) == [1.5, 2.5]
    (nan,) = codec.unpack(_msgpack([float("nan")]))
    assert nan != nan


_plain = st.recursive(
    st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
    | st.floats(allow_nan=False) | st.text() | st.binary(),
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=8), inner, max_size=20),
    max_leaves=60)


@seed(20261017)
@settings(max_examples=300, deadline=None, database=None)
@given(_plain)
def test_codec_matches_msgpack_on_generated_values(obj):
    b = _msgpack(obj)
    assert codec.pack(obj) == b
    assert codec.unpack(b) == _unmsgpack(b)


@pytest.mark.parametrize("obj", [{1, 2}, object(), np.float32(1.0), np.int64(3),
                                 {"a": [complex(1, 2)]}])
def test_codec_refuses_values_that_are_not_plain(obj):
    with pytest.raises(TypeError):
        codec.pack(obj)


@pytest.mark.parametrize("data", [b"", b"\x92\x01", b"\xa5abc", b"\x01\x02",
                                  b"\xc1", b"\xd4\x01\x02"])
def test_codec_refuses_truncated_extra_or_foreign_data(data):
    with pytest.raises(ValueError):
        codec.unpack(data)


TAG = "__nornic_value__"


@pytest.mark.parametrize("m", [
    {TAG: "date", "v": "2024-01-02"},
    {TAG: "datetime", "v": "2024-01-02T03:04:05Z"},
    {TAG: "localdatetime", "v": "2024-01-02T03:04:05"},
    {TAG: "time", "v": "03:04:05Z"},
    {TAG: "localtime", "v": "03:04:05"},
    {TAG: "duration", "m": 1, "d": 2, "s": 3, "n": 4},
    {TAG: "point", "x": 1.0, "y": 2.0, "z": None, "crs": "cartesian"},
])
def test_codec_refuses_temporal_values_the_reference_revives(m):
    """The codec revives each tagged map into the value the reference's
    ``_unpack`` gives, and packs that value back into the same bytes.
    (The name dates from when the codec refused these maps, ROADMAP C17,
    now closed; it is kept so the test's history stays one line.)"""
    from nornicdb_tpu.storage.wal import _pack as j_pack
    from nornicdb_tpu.storage.wal import _unpack as j_unpack

    b = _msgpack({"properties": {"when": m}})
    want = j_unpack(b)["properties"]["when"]
    got = codec.unpack(b)["properties"]["when"]
    assert not isinstance(got, dict)  # revived, as the reference does
    assert type(got).__name__ == type(want).__name__
    assert (repr(got), str(got)) == (repr(want), str(want))
    assert codec.pack({"properties": {"when": got}}) == j_pack({"properties": {"when": want}})


@pytest.mark.parametrize("m", [
    {TAG: "date", "v": 3},
    {TAG: "date", "v": "2024-01-02", "extra": 1},
    {TAG: "duration", "m": 1},
    {TAG: "unknown", "v": "x"},
    {"v": "2024-01-02"},
])
def test_codec_returns_other_tagged_maps_unchanged_as_the_reference(m):
    from nornicdb_tpu.storage.wal import _unpack as j_unpack

    b = _msgpack(m)
    assert codec.unpack(b) == j_unpack(b) == m


# -- WAL ------------------------------------------------------------------


def _pin_clock(monkeypatch):
    monkeypatch.setattr(jwal.time, "time", lambda: PINNED_TIME)
    monkeypatch.setattr(twal.time, "time", lambda: PINNED_TIME)


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, d)] = f.read()
    return out


def _drive(mk_node, mk_edge, engine, n=60, dims=16):
    rng = random.Random(3)
    for i in range(n):
        engine.create_node(mk_node(f"n{i}", labels=["L", f"K{i % 3}"],
                                   properties={"content": f"doc {i}", "i": i - 30},
                                   embedding=[rng.uniform(-1, 1) for _ in range(dims)]))
    for i in range(n // 3):
        engine.create_edge(mk_edge(f"e{i}", "REL", f"n{i}", f"n{i + 1}", {"w": i / 3}))
    node = engine.get_node("n3")
    node.properties["content"] = "changed"
    node.labels = ["L", "New"]
    engine.update_node(node)
    edge = engine.get_edge("e1")
    edge.properties["w"] = -1
    engine.update_edge(edge)
    engine.delete_edge("e2")
    engine.delete_node("n5")


@pytest.mark.parametrize("snapshot_every", [0, 25])
def test_wal_files_are_byte_identical_to_jax(tmp_path, monkeypatch, snapshot_every):
    """The same ops through both durable engines (small segments, so
    they roll; with auto-compaction, so snapshots prune) write the same
    files, byte for byte, with the clock pinned."""
    _pin_clock(monkeypatch)
    for engine_cls, node, edge, d in ((JDurable, JNode, JEdge, tmp_path / "j"),
                                      (DurableEngine, Node, Edge, tmp_path / "t")):
        eng = engine_cls(str(d), auto_compact_every=snapshot_every, max_segment_bytes=2048)
        _drive(node, edge, eng)
        eng.close()
    j, t = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert len(t) > 2 and sorted(t) == sorted(j)
    for name in j:
        assert t[name] == j[name], name


def test_wal_append_and_replay(tmp_path):
    wal = WAL(str(tmp_path))
    wal.append("create_node", {"id": "a"})
    wal.append("create_node", {"id": "b"})
    wal.close()
    assert wal.counters["appends"] == 2
    wal2 = WAL(str(tmp_path))
    seen = []
    res = wal2.replay(lambda op, d: seen.append((op, d["id"])))
    assert res.records_applied == 2
    assert seen == [("create_node", "a"), ("create_node", "b")]
    assert wal2.last_seq == 2


def test_wal_torn_tail_repair(tmp_path):
    wal = WAL(str(tmp_path))
    wal.append("create_node", {"id": "a"})
    wal.append("create_node", {"id": "b"})
    wal.close()
    seg = [p for p in os.listdir(tmp_path) if p.startswith("wal-")][0]
    size = os.path.getsize(tmp_path / seg)
    with open(tmp_path / seg, "ab") as f:
        f.write(b"\x07\x00\x00\x00garbage!!")
    seen = []
    res = WAL(str(tmp_path)).replay(lambda op, d: seen.append(d["id"]))
    assert res.records_applied == 2 and seen == ["a", "b"]
    assert res.torn_tail_repaired and not res.degraded
    assert os.path.getsize(tmp_path / seg) == size
    assert not WAL(str(tmp_path)).replay(lambda op, d: None).torn_tail_repaired


def test_wal_mid_segment_corruption_stops_replay_and_reports_degraded(tmp_path):
    wal = WAL(str(tmp_path), max_segment_bytes=300)
    for i in range(40):
        wal.append("put", {"k": f"key{i}", "v": "x" * 40})
    wal.close()
    segs = sorted((p for p in os.listdir(tmp_path) if p.startswith("wal-")),
                  key=lambda p: int(p[4:-4]))
    assert len(segs) >= 3
    victim = str(tmp_path / segs[0])
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xDE\xAD\xBE\xEF" * 4)
    applied = []
    res = WAL(str(tmp_path)).replay(lambda op, data: applied.append(data["k"]))
    assert res.degraded and res.corrupt_segments == [victim]
    assert os.path.getsize(victim) == size  # not truncated
    assert applied and applied[-1] == "key39" and len(applied) < 40


def test_wal_snapshot_prunes_and_restores(tmp_path):
    wal = WAL(str(tmp_path), retained_segments=0, max_segment_bytes=64)
    for i in range(10):
        wal.append("create_node", {"id": f"n{i}"})
    before = len([p for p in os.listdir(tmp_path) if p.startswith("wal-")])
    wal.write_snapshot({"nodes": [{"id": "snapshot-state"}], "edges": []})
    wal.append("create_node", {"id": "after-snap"})
    wal.close()
    after = len([p for p in os.listdir(tmp_path) if p.startswith("wal-")])
    assert after < before
    wal2 = WAL(str(tmp_path))
    state, seq = wal2.load_snapshot()
    assert state["nodes"][0]["id"] == "snapshot-state" and seq == 10
    applied = []
    res = wal2.replay(lambda op, d: applied.append(d["id"]), from_seq=seq)
    assert applied == ["after-snap"] and res.last_seq == 11


def test_wal_replay_skips_decoding_records_a_snapshot_covers(tmp_path, monkeypatch):
    wal = WAL(str(tmp_path))
    for i in range(300):  # seqs past every int width the peek reads
        wal.append("create_node", {"id": f"n{i}"})
    wal.close()
    wal2 = WAL(str(tmp_path))
    decoded = []
    real = wal2._decode
    monkeypatch.setattr(wal2, "_decode", lambda b: decoded.append(1) or real(b))
    applied = []
    res = wal2.replay(lambda op, d: applied.append(d["id"]), from_seq=290)
    assert applied == [f"n{i}" for i in range(290, 300)] and res.last_seq == 300
    assert len(decoded) == 10
    assert twal._seq_at_most(codec.pack({"seq": 70000, "op": "x"}), 70000)
    assert not twal._seq_at_most(codec.pack({"seq": 70001, "op": "x"}), 70000)
    assert not twal._seq_at_most(codec.pack({"op": "x", "seq": 1}), 5)  # cannot tell


def test_wal_segment_rotation(tmp_path):
    wal = WAL(str(tmp_path), max_segment_bytes=256)
    for i in range(50):
        wal.append("create_node", {"id": f"node-{i}", "pad": "x" * 50})
    wal.close()
    assert len([p for p in os.listdir(tmp_path) if p.startswith("wal-")]) > 1
    assert WAL(str(tmp_path)).replay(lambda op, d: None).records_applied == 50


def test_unreadable_snapshot_refuses_silent_recovery(tmp_path):
    eng = DurableEngine(str(tmp_path))
    eng.create_node(Node("a"))
    eng.snapshot()
    eng.close()
    snaps = [p for p in os.listdir(tmp_path) if p.startswith("snapshot-")]
    with open(tmp_path / snaps[0], "r+b") as f:
        f.write(b"\xff" * 16)
    with pytest.raises(WALCorruptionError):
        DurableEngine(str(tmp_path))


def test_temporal_wal_record_raises_instead_of_truncating(tmp_path):
    """A WAL record with a tagged value, written by the JAX package, opens
    in the port with the value revived and the log untouched; the port's
    record of a typed value opens in the JAX package the same way. (The
    name dates from when the port raised on such a record, ROADMAP C17,
    now closed; it is kept so the test's history stays one line.)"""
    from nornicdb_tpu.query.temporal_types import make_date as j_date
    from nornicdb_tpu_torch.query.temporal_types import make_date

    jeng = JDurable(str(tmp_path / "j"), auto_compact_every=0)
    jeng.create_node(JNode("a", properties={"when": "plain"}))
    jeng.wal.append("create_node", {"id": "b", "properties": {
        "when": {TAG: "date", "v": "2024-01-02"}}})
    jeng.wal.flush()
    size = sum(os.path.getsize(tmp_path / "j" / p) for p in os.listdir(tmp_path / "j"))
    eng = DurableEngine(str(tmp_path / "j"))
    assert sum(os.path.getsize(tmp_path / "j" / p) for p in os.listdir(tmp_path / "j")) == size
    assert eng.replay_result.records_applied == 2 and not eng.replay_result.torn_tail_repaired
    got = eng.get_node("b").properties["when"]
    assert type(got).__name__ == "CypherDate" and str(got) == str(j_date("2024-01-02"))
    eng.wal.close()

    teng = DurableEngine(str(tmp_path / "t"), auto_compact_every=0)
    teng.create_node(Node("b", properties={"when": make_date("2024-01-02")}))
    teng.wal.close()  # no snapshot: the JAX package replays the record
    j = JDurable(str(tmp_path / "t"))
    want = j.get_node("b").properties["when"]
    assert type(want).__name__ == "CypherDate" and str(want) == "2024-01-02"
    j.close()


# -- durable engine and the contract ---------------------------------------


def test_durable_engine_survives_restart(tmp_path):
    eng = DurableEngine(str(tmp_path))
    eng.create_node(Node("a", properties={"name": "alice"}))
    eng.create_node(Node("b"))
    eng.create_edge(Edge("e1", "T", "a", "b"))
    eng.delete_node("b")
    eng.close()
    eng2 = DurableEngine(str(tmp_path))
    assert eng2.get_node("a").properties["name"] == "alice"
    assert (eng2.count_nodes(), eng2.count_edges()) == (1, 0)
    eng2.close()


def test_durable_engine_crash_without_snapshot_and_duplicate_create(tmp_path):
    eng = DurableEngine(str(tmp_path))
    eng.create_node(Node("a"))
    with pytest.raises(AlreadyExistsError):
        eng.create_node(Node("a"))  # never reaches the log
    eng.snapshot()
    eng.create_node(Node("b"))
    eng.wal.flush()
    eng2 = DurableEngine(str(tmp_path))  # no close: replay over the snapshot
    assert eng2.count_nodes() == 2 and eng2.replay_result.records_applied == 1
    eng2.close()


def test_wal_engine_over_memory_recovers(tmp_path):
    eng = WALEngine(MemoryEngine(), WAL(str(tmp_path)))
    eng.create_node(Node("x"))
    eng.close()
    eng2 = WALEngine(MemoryEngine(), WAL(str(tmp_path)))
    eng2.recover()
    assert eng2.count_nodes() == 1


def test_decode_op_args_whitelists_ops():
    assert decode_op_args("delete_node", {"id": "a"}) == ("a",)
    assert decode_op_args("create_edge", Edge("e", "T", "a", "b").to_dict())[0].type == "T"
    with pytest.raises(ValueError):
        decode_op_args("drop_everything", {})


@pytest.mark.parametrize("make", ["memory", "durable", "disk", "async"])
def test_engine_contract(make, tmp_path):
    eng = {"memory": lambda: MemoryEngine(),
           "durable": lambda: DurableEngine(str(tmp_path)),
           "disk": lambda: DiskEngine(str(tmp_path)),
           "async": lambda: AsyncEngine(MemoryEngine(), flush_interval_s=0)}[make]()
    for nid, labels in (("a", ["P"]), ("b", ["P", "Q"]), ("c", [])):
        eng.create_node(Node(nid, labels, {"k": nid}))
    eng.create_edge(Edge("ab", "KNOWS", "a", "b"))
    eng.create_edge(Edge("bc", "LIKES", "b", "c"))
    assert sorted(n.id for n in eng.get_nodes_by_label("P")) == ["a", "b"]
    assert sorted(eng.node_ids_by_label("Q")) == ["b"]
    assert [n.id if n else None for n in eng.batch_get_nodes(["c", "zz", "a"])] == ["c", None, "a"]
    assert eng.has_node("a") and not eng.has_node("zz") and eng.has_edge("ab")
    assert [e.id for e in eng.get_edges_by_type("LIKES")] == ["bc"]
    assert sorted(e.id for e in eng.get_node_edges("b")) == ["ab", "bc"]
    assert [e.id for e in eng.get_node_edges("b", Direction.OUTGOING)] == ["bc"]
    assert eng.degree("b") == 2
    node = eng.get_node("b")
    node.labels = ["Q"]
    eng.update_node(node)
    assert sorted(eng.node_ids_by_label("P")) == ["a"]
    eng.delete_node("b")  # cascades both edges
    assert (eng.count_nodes(), eng.count_edges()) == (2, 0)
    with pytest.raises(KeyError):
        eng.get_node("b")
    eng.create_node(Node("x:1"))
    eng.create_node(Node("x:2"))
    assert eng.delete_by_prefix("x:")[0] == 2 and eng.count_nodes() == 2
    eng.close()


def test_namespaced_engine_scopes_ids_as_jax():
    base, jbase = MemoryEngine(), JMemory()
    for b, ns, mk, mke in ((base, NamespacedEngine, Node, Edge),
                           (jbase, JNamespaced, JNode, JEdge)):
        db1, db2 = ns(b, "db1"), ns(b, "neo4j")
        db1.create_node(mk("x", ["L"]))
        db1.create_node(mk("db1:x", ["L"]))  # distinct, not an alias
        db2.create_node(mk("x", ["L"]))
        db2.create_node(mk("y"))
        db2.create_edge(mke("e", "T", "x", "y"))
        assert db1.count_nodes() == 2 and db2.count_nodes() == 2
        assert sorted(db1.node_ids_by_label("L")) == ["db1:x", "x"]
        assert db2.get_edge("e").start_node == "x"
    assert sorted(n.id for n in base.all_nodes()) == sorted(n.id for n in jbase.all_nodes())
    assert sorted(e.id for e in base.all_edges()) == ["neo4j:e"]
    with pytest.raises(NotFoundError):
        NamespacedEngine(base, "db1").get_node("y")


def test_async_engine_read_your_writes_and_count_race():
    import threading

    eng = AsyncEngine(MemoryEngine(), flush_interval_s=0)
    eng.create_node(Node("a", properties={"name": "alice"}))
    with pytest.raises(AlreadyExistsError):
        eng.create_node(Node("a"))
    assert eng.get_node("a").properties["name"] == "alice" and eng.count_nodes() == 1
    eng.delete_node("a")
    with pytest.raises(NotFoundError):
        eng.get_node("a")
    eng.flush_pending()
    assert eng.inner.count_nodes() == 0
    eng2 = AsyncEngine(MemoryEngine(), flush_interval_s=0.001)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            eng2.create_node(Node(f"w{i}"))
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(50):
            eng2.flush_pending()
    finally:
        stop.set()
        t.join()
    eng2.flush_pending()
    assert eng2.count_nodes() == eng2.inner.count_nodes()
    eng2.close()


# -- cross-open --------------------------------------------------------------

ENGINES = {
    "python": (JDurable, DurableEngine),
    "native": (JDisk, DiskEngine),
}


def _contents(eng):
    nodes = {n.id: (sorted(n.labels), n.properties, n.embedding) for n in eng.all_nodes()}
    edges = {e.id: (e.type, e.start_node, e.end_node, e.properties) for e in eng.all_edges()}
    labels = {lbl: sorted(eng.node_ids_by_label(lbl)) for lbl in ("L", "K0", "K1", "New")}
    return nodes, edges, labels, eng.count_nodes(), eng.count_edges()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_data_dirs_cross_open(engine, writer, tmp_path):
    j_cls, t_cls = ENGINES[engine]
    w_cls, r_cls = (j_cls, t_cls) if writer == "jax" else (t_cls, j_cls)
    w_node, w_edge = (JNode, JEdge) if writer == "jax" else (Node, Edge)
    w = w_cls(str(tmp_path))
    _drive(w_node, w_edge, w)
    want = _contents(w)
    w.close()
    r = r_cls(str(tmp_path))
    assert _contents(r) == want
    assert want[3] == 59 and want[4] == 17
    r.close()


@pytest.mark.parametrize("layout", ["fresh", "python", "native", "both"])
def test_make_persistent_engine_chooses_as_jax(layout, tmp_path):
    d = str(tmp_path)
    if layout == "python":
        JDurable(d).close()
    elif layout == "native":
        JDisk(d).close()
    elif layout == "both":
        JDurable(d).close()
        os.makedirs(os.path.join(d, "kv"))
    if layout == "both":
        for make in (make_persistent_engine, j_make_persistent):
            with pytest.raises(RuntimeError, match="BOTH"):
                make(d)
        return
    j = j_make_persistent(d)
    jkind = type(j).__name__
    j.close()
    t = make_persistent_engine(d)
    assert type(t).__name__ == jkind == ("DurableEngine" if layout == "python" else "DiskEngine")
    t.close()


def test_native_store_refuses_to_shadow_python_data(tmp_path):
    DurableEngine(str(tmp_path)).close()
    with pytest.raises(ValueError, match="pure-Python"):
        DiskEngine(str(tmp_path))


def test_disk_engine_repairs_a_torn_tail_as_jax(tmp_path):
    eng = DiskEngine(str(tmp_path))
    for i in range(5):
        eng.create_node(Node(f"n{i}", properties={"s": "".join(random.choices(string.ascii_letters, k=30))}))
    eng.close()
    seg = os.path.join(str(tmp_path), "kv", "kv-000000.log")
    with open(seg, "ab") as f:
        f.write(b"a torn record, not a header")
    eng = DiskEngine(str(tmp_path))
    assert eng.repaired == 1 and eng.count_nodes() == 5
    eng.close()
    j = JDisk(str(tmp_path))
    assert j.repaired == 0 and j.count_nodes() == 5
    j.close()


def test_native_store_across_segments_and_compaction_as_jax(tmp_path):
    """Small segments: values read back from sealed segments (kept-open
    descriptors), after a compaction that drops them, and by the JAX
    package's library, which reads the same files."""
    from nornicdb_tpu.storage.disk import DiskKV as JKV
    from nornicdb_tpu_torch.storage.disk import DiskKV

    d = os.path.join(str(tmp_path), "kv")
    kv = DiskKV(d, max_segment_bytes=4096)
    want = {}
    for i in range(300):
        key, val = f"k{i % 120}".encode(), bytes([i % 251]) * (i % 97)
        kv.put(key, val)
        want[key] = val
    for i in range(0, 120, 7):
        kv.delete(f"k{i}".encode())
        want.pop(f"k{i}".encode())
    assert len([p for p in os.listdir(d) if p.startswith("kv-")]) > 3
    assert {k: kv.get(k) for k in want} == want
    kv.close()
    kv = DiskKV(d, max_segment_bytes=4096)
    assert dict(kv.scan(b"k")) == want and kv.dead_bytes > 0
    kv.compact()
    assert dict(kv.scan(b"k")) == want and kv.dead_bytes == 0
    kv.put(b"after", b"compaction")
    kv.close()
    j = JKV(d)
    assert dict(j.scan(b"k")) == want and j.get(b"after") == b"compaction"
    j.close()


# -- typed values on disk ------------------------------------------------------

TYPED = [
    ("date", "2024-01-02"), ("datetime", "2024-01-02T03:04:05.123Z"),
    ("localdatetime", "2024-01-02T03:04:05"), ("time", "03:04:05+02:00"),
    ("localtime", "03:04:05.5"), ("duration", "P1Y2M3DT4H5M6.5S"), ("point", None),
]


def _typed_props(temporal):
    props = {}
    for kind, text in TYPED:
        if kind == "point":
            props[kind] = temporal.make_point({"x": 1.5, "y": -2.0})
        elif kind == "duration":
            props[kind] = temporal.parse_duration(text)
        else:
            props[kind] = getattr(temporal, f"make_{kind}")(text)
    props["nested"] = [temporal.make_date("2020-02-29"), {"at": temporal.make_date("2021-03-01")}]
    return props


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_temporal_values_cross_open(engine, writer, tmp_path):
    """Typed properties written by either package open in the other with
    equal values, on both engines (C17 closed)."""
    from nornicdb_tpu.query import temporal_types as jt
    from nornicdb_tpu_torch.query import temporal_types as tt

    j_cls, t_cls = ENGINES[engine]
    w_cls, r_cls, w_node, temporal = ((j_cls, t_cls, JNode, jt) if writer == "jax"
                                      else (t_cls, j_cls, Node, tt))
    w = w_cls(str(tmp_path))
    props = _typed_props(temporal)
    w.create_node(w_node("n", ["Event"], props))
    w.create_node(w_node("m", ["Event"], {"plain": {TAG: "unknown", "v": "x"}}))
    w.close()
    r = r_cls(str(tmp_path))
    got = r.get_node("n").properties
    assert repr(got) == repr(props)
    assert [type(got[k]).__name__ for k in props] == [type(v).__name__ for v in props.values()]
    assert r.get_node("m").properties == {"plain": {TAG: "unknown", "v": "x"}}
    r.close()


@pytest.mark.parametrize("make", ["memory", "durable", "disk", "namespaced"])
def test_graph_methods_match_jax(make, tmp_path):
    """neighbors, list_namespaces, count_nodes_by_label and clear, which
    the Cypher layer and multidb use, as the JAX engines answer them."""
    pairs = {
        "memory": (lambda: MemoryEngine(), lambda: JMemory()),
        "durable": (lambda: DurableEngine(str(tmp_path / "t")),
                    lambda: JDurable(str(tmp_path / "j"))),
        "disk": (lambda: DiskEngine(str(tmp_path / "t")), lambda: JDisk(str(tmp_path / "j"))),
        "namespaced": (lambda: NamespacedEngine(MemoryEngine(), "db1"),
                       lambda: JNamespaced(JMemory(), "db1")),
    }[make]
    answers = []
    for mk, mk_node, mk_edge in ((pairs[0], Node, Edge), (pairs[1], JNode, JEdge)):
        eng = mk()
        for nid, labels in (("a:1", ["P"]), ("a:2", ["P", "Q"]), ("b:1", []), ("c", ["P"])):
            eng.create_node(mk_node(nid, labels))
        eng.create_edge(mk_edge("e1", "K", "a:1", "a:2"))
        eng.create_edge(mk_edge("e2", "K", "b:1", "a:1"))
        eng.create_edge(mk_edge("e3", "L", "a:1", "a:1"))
        out = [sorted(eng.neighbors("a:1", d)) for d in (Direction.OUTGOING, Direction.INCOMING,
                                                          Direction.BOTH)]
        out += [eng.list_namespaces(), eng.count_nodes_by_label("P"), eng.count_nodes_by_label("Z")]
        if hasattr(eng, "clear"):
            eng.clear()
            out.append((eng.count_nodes(), eng.count_edges()))
        answers.append(out)
        eng.close()
    assert answers[0] == answers[1]
    assert answers[0][0] == ["a:1", "a:2"] and answers[0][4] == 3
