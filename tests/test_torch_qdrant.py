"""The port's Qdrant translation layer (``api/qdrant.py``, ``DB.qdrant_compat``)
and its REST routes against the JAX package's, the port on ``device="cpu"``.

The same sequence of operations goes to both packages' ``QdrantCompat``
and each answer is compared field by field: collections, upserts,
searches with and without a payload filter and a score threshold in all
three distances, retrieve, scroll, count, delete, aliases and snapshots.
Cosine scores come from each package's brute index (an f32 product in
another summation order), so they agree within ``SCORE_ATOL`` and ids
tie-aware; Dot and Euclid are host NumPy in both and agree exactly. Then
a Cypher write invalidates a collection in both; a convoy of concurrent
upserts lands as one ordered apply would; the same requests to both
``HttpServer``s' ``/collections`` routes give equal bodies but ``time``;
and a data dir either package wrote opens in the other and answers the
same. The reference's own cases (``tests/test_qdrant_grpc.py``'s compat,
filter and review cases, ``tests/test_races_qdrant.py``'s compat races)
run once more against the port, their module's names pointed at the
port's. Finally the port's pins: the device rule and C42."""

import functools
import gc
import json
import os
import threading

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
import test_qdrant_grpc as ref_qg
import test_races_qdrant as ref_rq
from nornicdb_tpu.api import qdrant as jq
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import NamespacedEngine as JNamespaced
from nornicdb_tpu_torch.api import qdrant as tq
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from nornicdb_tpu_torch.storage import MemoryEngine as TMemory
from nornicdb_tpu_torch.storage import NamespacedEngine as TNamespaced
from test_torch_http import request

torch.set_num_threads(1)

SCORE_ATOL = 1e-5  # cosine over D <= 32 float32 terms, two summation orders
D = 8


def _points(n, dims=D, seed=0, int_ids=False):
    rng = np.random.default_rng(seed)
    return [{"id": i if int_ids else str(i),
             "vector": [float(x) for x in rng.standard_normal(dims)],
             "payload": {"city": ("oslo", "bergen", "kyoto")[i % 3], "rank": i,
                         "meta": {"lang": "no" if i % 2 else "ja"},
                         "tags": ["a"] if i % 4 else [], "note": None if i % 5 else "x"}}
            for i in range(n)]


def _same_hits(j, t):
    """Equal hits: every field equal but ``score`` (within SCORE_ATOL), ids
    equal up to a swap inside a run of scores within SCORE_ATOL."""
    assert len(j) == len(t)
    for i, (a, b) in enumerate(zip(j, t)):
        assert set(a) == set(b) and abs(a["score"] - b["score"]) <= SCORE_ATOL
        if a["id"] == b["id"]:
            assert {k: v for k, v in a.items() if k != "score"} == \
                {k: v for k, v in b.items() if k != "score"}
        else:
            run = [h["id"] for h in j if abs(h["score"] - a["score"]) <= 2 * SCORE_ATOL]
            assert b["id"] in run, (i, a, b)


class Twin:
    """One ``QdrantCompat`` of each package over an empty namespaced store;
    ``call`` runs one operation on both and returns both outcomes, an
    exception as (class name, message, status)."""

    def __init__(self, jstore=None, tstore=None):
        self.j = jq.QdrantCompat(jstore or JNamespaced(JMemory(), "test"))
        self.t = tq.QdrantCompat(tstore or TNamespaced(TMemory(), "test"), device="cpu")

    @staticmethod
    def _run(compat, op, args, kw):
        try:
            return getattr(compat, op)(*args, **kw)
        except Exception as e:  # noqa: BLE001 -- compared below
            return ("raised", type(e).__name__, str(e), getattr(e, "status", None))

    def call(self, op, *args, **kw):
        return self._run(self.j, op, args, kw), self._run(self.t, op, args, kw)

    def same(self, op, *args, **kw):
        j, t = self.call(op, *args, **kw)
        assert t == j, (op, args, kw)
        return t

    def same_search(self, *args, **kw):
        j, t = self.call("search_points", *args, **kw)
        if isinstance(j, tuple):
            assert t == j
        else:
            _same_hits(j, t)
        return t


@pytest.fixture(autouse=True)
def _collect_cycles():
    """The resource registries hold objects weakly, and a Qdrant layer's
    batchers close over it: collect the cycles a test leaves, so later
    tests' readiness counts see only their own structures."""
    yield
    gc.collect()


@pytest.fixture
def twin():
    return Twin()


FILTERS = [
    None,
    {"must": [{"key": "city", "match": {"value": "bergen"}}]},
    {"must": [{"key": "rank", "range": {"gte": 5, "lt": 40}}],
     "must_not": [{"key": "city", "match": {"value": "oslo"}}]},
    {"should": [{"key": "city", "match": {"any": ["kyoto", "oslo"]}},
                {"has_id": ["3", "7", 11]}]},
    {"must": [{"key": "meta.lang", "match": {"value": "no"}},
              {"filter": {"must_not": [{"is_empty": {"key": "tags"}}]}}]},
    {"must": [{"is_null": {"key": "note"}}, {"key": "city", "match": {"text": "ERG"}}]},
]


@pytest.mark.parametrize("distance", ["Cosine", "Dot", "Euclid"])
def test_operation_sequence_matches_jax(twin, distance):
    assert twin.same("create_collection", "c", {"size": D, "distance": distance}) is True
    twin.same("get_collection", "c")
    pts = _points(60)
    assert twin.same("upsert_points", "c", pts[:40]) == 40
    assert twin.same("upsert_points", "c", pts[30:] + [pts[2]]) == 31
    assert twin.same("count_points", "c") == 60
    for i, flt in enumerate(FILTERS):
        q = pts[i * 7]["vector"]
        for limit, thr in ((5, None), (10, 0.1 if distance != "Euclid" else 3.5), (60, None)):
            twin.same_search("c", q, limit=limit, score_threshold=thr, query_filter=flt,
                             with_vector=bool(i % 2), with_payload=not i % 3)
    twin.same("retrieve_points", "c", ["1", "5", "nope", 7], with_vector=True)
    twin.same("retrieve_points", "c", ["2"], with_payload=False)
    offset = None
    for _ in range(4):
        page = twin.same("scroll_points", "c", offset=offset, limit=17, with_vector=True)
        offset = page["next_page_offset"]
    assert twin.same("delete_points", "c", ["1", "2", "ghost"]) == 2
    twin.same_search("c", pts[1]["vector"], limit=5)
    twin.same("get_collection", "c")
    twin.same("list_collections")
    assert twin.same("delete_collection", "c") is True
    assert twin.same("delete_collection", "c") is False
    twin.same("list_collections")


def test_errors_match_jax(twin):
    twin.same("create_collection", "c", {"size": 4})
    twin.same("create_collection", "nodim")
    for op, args, kw in (
            ("create_collection", ("c",), {}),
            ("create_collection", ("bad", {"size": 2, "distance": "Manhattan"}), {}),
            ("upsert_points", ("c", [{"id": "1", "vector": [1.0, 2.0]}]), {}),
            ("upsert_points", ("c", [{"vector": [1.0, 2.0, 3.0, 4.0]}]), {}),
            ("upsert_points", ("c", [{"id": "1", "vector": [1.0, "x", 3.0, 4.0]}]), {}),
            ("upsert_points", ("nodim", [{"id": "1", "vector": [1.0, 0.0]},
                                         {"id": "2", "vector": [1.0]}]), {}),
            ("search_points", ("c", []), {}),
            ("search_points", ("c", [1.0, 2.0]), {}),
            ("count_points", ("ghost",), {}),
            ("get_collection", ("ghost",), {}),
            ("search_points", ("ghost", [1.0]), {}),
            ("retrieve_points", ("ghost", ["1"]), {}),
            ("scroll_points", ("ghost",), {}),
            ("delete_points", ("ghost", ["1"]), {}),
            ("upsert_points", ("ghost", []), {})):
        out = twin.same(op, *args, **kw)
        assert isinstance(out, tuple) and out[1] == "QdrantError", (op, out)
    assert twin.same("count_points", "c") == twin.same("count_points", "nodim") == 0


def test_aliases_match_jax(twin):
    for name in ("blue", "green"):
        twin.same("create_collection", name, {"size": D})
    twin.same("upsert_points", "blue", _points(10, seed=1))
    twin.same("upsert_points", "green", _points(10, seed=2))
    for actions in (
            [{"create": {"alias": "live", "collection": "blue"}}],
            [{"create": {"alias": "x", "collection": "ghost"}}],
            [{"create": {"alias": "green", "collection": "blue"}}],
            [{"rename": {"old": "nope", "new": "y"}}],
            [{"delete": {"alias": "nope"}}],
            [{"bogus": {}}],
            [{"delete": {"alias": "live"}}, {"create": {"alias": "live", "collection": "green"}}],
            [{"create": {"alias": "old", "collection": "blue"}}],
            [{"rename": {"old": "old", "new": "new"}}]):
        twin.same("update_aliases", actions)
        twin.same("list_aliases")
        twin.same("list_aliases", "blue")
    twin.same_search("live", _points(1, seed=2)[0]["vector"], limit=3)
    twin.same("count_points", "new")
    twin.same("resolve", "live")
    twin.same("delete_collection", "blue")
    twin.same("list_aliases")


def _snap_shape(out):
    """A snapshot answer without its clock: the name's time stamp, the
    creation time."""
    if isinstance(out, dict):
        return {k: ("<t>" if k == "creation_time" else
                    v.rsplit("-", 1)[0] if k == "name" else v) for k, v in out.items()}
    if isinstance(out, list):
        return [_snap_shape(x) for x in out]
    return out


def test_snapshots_match_jax(twin, tmp_path):
    base = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    twin.same("create_collection", "c", {"size": D, "distance": "Dot"})
    twin.same("upsert_points", "c", _points(12, int_ids=True))
    twin.same("update_aliases", [{"create": {"alias": "a", "collection": "c"}}])

    def both(op, *args):
        j = Twin._run(twin.j, op, args + (base["jax"],), {})
        t = Twin._run(twin.t, op, args + (base["port"],), {})
        assert _snap_shape(t) == _snap_shape(j), op
        return j, t

    j, t = both("create_snapshot", "a")
    both("list_snapshots", "c")
    twin.same("delete_points", "c", [0, 1, 2])
    jr = twin.j.recover_snapshot("c", j["name"], base["jax"])
    tr = twin.t.recover_snapshot("c", t["name"], base["port"])
    assert jr == tr == 12
    twin.same("list_aliases")
    twin.same("scroll_points", "c", limit=100, with_vector=True)
    twin.same_search("a", _points(1)[0]["vector"], limit=4)
    for bad in ("../x", "a/b", "", "..", "x\x00y"):
        both("delete_snapshot", "c", bad)
    jf, tf = both("create_full_snapshot")
    both("list_full_snapshots")
    assert twin.j.delete_full_snapshot(jf["name"], base["jax"]) is True
    assert twin.t.delete_full_snapshot(tf["name"], base["port"]) is True
    both("delete_full_snapshot", "ghost.snapshot")
    assert twin.j.delete_snapshot("c", j["name"], base["jax"]) is True
    assert twin.t.delete_snapshot("c", t["name"], base["port"]) is True
    both("list_snapshots", "c")
    # a snapshot file either package wrote recovers in the other
    j2 = twin.j.create_snapshot("c", base["jax"])
    os.makedirs(os.path.join(base["port"], "collections", "c"), exist_ok=True)
    os.replace(os.path.join(base["jax"], "collections", "c", j2["name"]),
               os.path.join(base["port"], "collections", "c", j2["name"]))
    assert twin.t.recover_snapshot("c", j2["name"], base["port"]) == 12
    twin.same("scroll_points", "c", limit=100, with_vector=True)


def test_match_filter_matches_jax():
    rng = np.random.default_rng(3)
    pts = _points(40)
    conds = [c for f in FILTERS if f for group in f.values() for c in group]
    conds += [{"key": "rank", "range": {"gt": 3, "lte": 9}}, {"key": "missing"},
              {"key": "city"}, {"key": "city", "range": {"gt": 1}},
              {"is_null": "note"}, {"is_empty": "tags"}, {"has_id": [1, "2"]}]
    for _ in range(200):
        picks = [conds[i] for i in rng.integers(0, len(conds), 3)]
        flt = {"must": picks[:1], "should": picks[1:2], "must_not": picks[2:]}
        for p in pts:
            assert tq._match_filter(p["payload"], flt, p["id"]) == \
                jq._match_filter(p["payload"], flt, p["id"])
            for c in picks:
                assert tq._match_condition(p["payload"], c, p["id"]) == \
                    jq._match_condition(p["payload"], c, p["id"])


def test_search_cache_and_generation_match_jax(twin):
    twin.same("create_collection", "c", {"size": D})
    pts = _points(20)
    twin.same("upsert_points", "c", pts)
    gens = [(twin.j.cache_gen, twin.t.cache_gen)]
    first = twin.same_search("c", pts[4]["vector"], limit=3)
    again = twin.same_search("c", pts[4]["vector"], limit=3)
    assert again == first and again is not first
    again[0]["payload"]["rank"] = -1  # a caller's edit never reaches the cache
    assert twin.t.search_points("c", pts[4]["vector"], limit=3)[0]["payload"]["rank"] == 4
    twin.same("upsert_points", "c", [{"id": "new", "vector": pts[4]["vector"]}])
    twin.same_search("c", pts[4]["vector"], limit=3)
    gens.append((twin.j.cache_gen, twin.t.cache_gen))
    assert gens[1][0] - gens[0][0] == gens[1][1] - gens[0][1] > 0


def test_selective_filter_fills_its_limit_through_the_widening_rounds(twin):
    twin.same("create_collection", "wide", {"size": 4})
    rng = np.random.default_rng(0)
    pts = [{"id": str(i), "vector": [float(x) for x in rng.standard_normal(4)],
            "payload": {"rare": i % 100 == 0}} for i in range(2000)]
    twin.same("upsert_points", "wide", pts)
    hits = twin.same_search("wide", pts[0]["vector"], limit=20,
                            query_filter={"must": [{"key": "rare", "match": {"value": True}}]})
    assert len(hits) == 20 and all(h["payload"]["rare"] for h in hits)


def test_convoy_of_concurrent_upserts_lands_as_jax(twin):
    twin.same("create_collection", "c", {"size": D})
    pts = _points(64, seed=5)
    errors = []

    def writer(compat, part):
        try:
            for i in range(part, 64, 8):
                compat.upsert_points_coalesced("c", [pts[i]])
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(twin.t, p)) for p in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors and not any(th.is_alive() for th in threads)
    twin.j.upsert_points("c", pts)  # the reference's one ordered apply
    assert twin.t._upsert_coalescer.batches >= 1
    twin.same("count_points", "c")
    twin.same("scroll_points", "c", limit=100, with_vector=True)
    for p in pts[::9]:
        twin.same_search("c", p["vector"], limit=5)


@pytest.fixture
def dbs():
    pair = [nornicdb_tpu.open(embedder=JHash()),
            nornicdb_tpu_torch.open(device="cpu", embedder=THash())]
    yield pair
    for db in pair:
        db.close()


def test_a_cypher_write_invalidates_a_collection_as_jax(dbs):
    twin = Twin()
    twin.j, twin.t = dbs[0].qdrant_compat, dbs[1].qdrant_compat
    assert dbs[1].qdrant_compat is twin.t
    twin.same("create_collection", "c", {"size": 4, "distance": "Cosine"})
    twin.same("upsert_points", "c", [{"id": "a", "vector": [1.0, 0.0, 0.0, 0.0]},
                                     {"id": "b", "vector": [0.0, 1.0, 0.0, 0.0]},
                                     {"id": "c", "vector": [0.7, 0.7, 0.0, 0.0]}])
    q = [1.0, 0.0, 0.0, 0.0]
    twin.same_search("c", q, limit=3)
    for stmt in ("MATCH (n) WHERE n._point_id = 'b' SET n._vector = [1.0, 0.1, 0.0, 0.0]",
                 "MATCH (n) WHERE n._point_id = 'a' DELETE n",
                 "MATCH (n) WHERE n._point_id = 'c' SET n.payload = {k: 1}"):
        for db in dbs:
            db.cypher(stmt)
        twin.same_search("c", q, limit=3)
        twin.same("count_points", "c")
    # qdrant points are neither embedded nor indexed by the native search
    for db in dbs:
        db.flush()
    assert len(dbs[1].search.vectors) == len(dbs[0].search.vectors) == 0


def _strip_time(body):
    if isinstance(body, dict):
        return {k: ("<t>" if k in ("time", "creation_time") else
                    v.rsplit("-", 1)[0] if k == "name" and isinstance(v, str)
                    and v.endswith(".snapshot") else _strip_time(v))
                for k, v in body.items()}
    if isinstance(body, list):
        return [_strip_time(v) for v in body]
    return body


REST = [
    ("PUT", "/collections/docs", {"vectors": {"size": 4, "distance": "Cosine"}}),
    ("PUT", "/collections/dot", {"vectors": {"size": 4, "distance": "Dot"}}),
    ("PUT", "/collections/docs", {"vectors": {"size": 4}}),
    ("GET", "/collections", None),
    ("GET", "/collections/docs", None),
    ("PUT", "/collections/docs/points", {"points": [
        {"id": i, "vector": [float(np.cos(i)), float(np.sin(i)), 0.5, i % 3 - 1.0],
         "payload": {"t": f"p{i}", "odd": bool(i % 2)}} for i in range(30)]}),
    ("PUT", "/collections/dot/points", {"points": [
        {"id": f"d{i}", "vector": [i, 1, 0, -i]} for i in range(6)]}),
    ("POST", "/collections/docs/points/search", {"vector": [1, 0, 0.5, 0], "limit": 5}),
    ("POST", "/collections/docs/points/search", {"vector": [1, 0, 0.5, 0], "limit": 4,
                                                 "filter": {"must": [{"key": "odd", "match":
                                                                      {"value": True}}]},
                                                 "with_vector": True, "score_threshold": 0.2}),
    ("POST", "/collections/dot/points/search", {"vector": [1, 0, 0, 0], "limit": 3}),
    ("POST", "/collections/docs/points/query", {"query": {"nearest": [0, 1, 0.5, 0]},
                                                "limit": 2}),
    ("POST", "/collections/docs/points/query", {"query": [0, 1, 0.5, 0], "limit": 2}),
    ("POST", "/collections/docs/points", {"ids": [1, 2, 99], "with_vector": True}),
    ("POST", "/collections/docs/points/count", {}),
    ("POST", "/collections/docs/points/scroll", {"limit": 7}),
    ("POST", "/collections/docs/points/scroll", {"limit": 7, "offset": "15"}),
    ("POST", "/collections/docs/points/delete", {"points": [1, 3]}),
    ("POST", "/collections/docs/points/count", {}),
    ("POST", "/collections/aliases", {"actions": [
        {"create_alias": {"alias_name": "live", "collection_name": "docs"}},
        {"create_alias": {"alias_name": "old", "collection_name": "dot"}},
        {"rename_alias": {"old_alias_name": "old", "new_alias_name": "older"}},
        {"delete_alias": {"alias_name": "older"}}]}),
    ("GET", "/collections/aliases", None),
    ("GET", "/collections/docs/aliases", None),
    ("POST", "/collections/live/points/search", {"vector": [0, 0, 1, 0], "limit": 3}),
    ("POST", "/collections/docs/snapshots", None),
    ("GET", "/collections/docs/snapshots", None),
    ("DELETE", "/collections/docs/snapshots/..", None),
    ("GET", "/collections/ghost", None),
    ("POST", "/collections/ghost/points/search", {"vector": [1, 0, 0, 0]}),
    ("PUT", "/collections/docs/points", {"points": [{"id": 1, "vector": [1, 2]}]}),
    ("POST", "/collections/docs/points/bogus", {}),
    ("DELETE", "/collections/dot", None),
    ("GET", "/collections", None),
]


def test_rest_routes_match_jax(tmp_path):
    dbs = [nornicdb_tpu.open(str(tmp_path / "jax"), embedder=JHash()),
           nornicdb_tpu_torch.open(str(tmp_path / "port"), device="cpu", embedder=THash())]
    servers = []
    try:
        from nornicdb_tpu.api.http_server import HttpServer as JServer
        from nornicdb_tpu_torch.api.http_server import HttpServer as TServer

        servers = [JServer(dbs[0], port=0).start(), TServer(dbs[1], port=0).start()]
        for method, path, body in REST:
            (sj, bj, _), (st, bt, _) = [request(s.port, path, method, body) for s in servers]
            assert st == sj, (method, path, bj, bt)
            bj, bt = _strip_time(bj), _strip_time(bt)
            if path.endswith(("/search", "/query")) and st == 200:
                hits = lambda b: b["result"]["points"] if isinstance(b["result"], dict) \
                    else b["result"]  # noqa: E731
                _same_hits(hits(bj), hits(bt))
            else:
                assert bt == bj, (method, path)
        # the snapshot landed under each data dir
        for name in ("jax", "port"):
            assert os.listdir(tmp_path / name / "qdrant-snapshots" / "collections" / "docs")
    finally:
        for s in servers:
            s.stop()
        for db in dbs:
            db.close()


def _write_collections(db):
    q = db.qdrant_compat
    q.create_collection("docs", {"size": D, "distance": "Cosine"})
    q.create_collection("eu", {"size": D, "distance": "Euclid"})
    q.upsert_points("docs", _points(40, seed=8))
    q.upsert_points("eu", _points(15, seed=9, int_ids=True))
    q.delete_points("docs", ["3"])
    q.update_aliases([{"create": {"alias": "live", "collection": "docs"}}])


def _answers(db):
    q = db.qdrant_compat
    pts = _points(5, seed=10)
    return {"collections": q.list_collections(), "aliases": q.list_aliases(),
            "counts": [q.count_points("docs"), q.count_points("live"), q.count_points("eu")],
            "scroll": q.scroll_points("docs", limit=100, with_vector=True),
            "eu": [q.search_points("eu", p["vector"], limit=4) for p in pts],
            "docs": [q.search_points("live", p["vector"], limit=6,
                                     query_filter=FILTERS[i % len(FILTERS)])
                     for i, p in enumerate(pts)],
            "info": q.get_collection("docs")}


def _same_answers(a, b):
    for key in ("collections", "aliases", "counts", "scroll", "eu", "info"):
        assert b[key] == a[key], key
    for ha, hb in zip(a["docs"], b["docs"]):
        _same_hits(ha, hb)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("engine", ["python", "native"])
def test_a_data_dir_with_collections_opens_in_the_other_package(tmp_path, writer, engine):
    d = str(tmp_path / "data")
    open_j = functools.partial(nornicdb_tpu.open, d, embedder=JHash(), engine=engine)
    open_t = functools.partial(nornicdb_tpu_torch.open, d, device="cpu", embedder=THash(),
                               engine=engine)
    first, second = (open_j, open_t) if writer == "jax" else (open_t, open_j)
    db = first()
    try:
        _write_collections(db)
        before = _answers(db)
    finally:
        db.close()
    db = second()
    try:
        _same_answers(before, _answers(db))
    finally:
        db.close()


# -- the reference's own cases, against the port ----------------------------


@pytest.fixture
def port_names(monkeypatch):
    """The reference test modules' names pointed at the port's."""
    compat = functools.partial(tq.QdrantCompat, device="cpu")
    for mod in (ref_qg, ref_rq):
        monkeypatch.setattr(mod, "QdrantCompat", compat)
        monkeypatch.setattr(mod, "QdrantError", tq.QdrantError)
        monkeypatch.setattr(mod, "MemoryEngine", TMemory)
    monkeypatch.setattr(ref_qg, "NamespacedEngine", TNamespaced)
    monkeypatch.setattr(ref_qg, "_match_filter", tq._match_filter)


COMPAT_CASES = [
    (ref_qg.TestQdrantCompat, name) for name in (
        "test_collection_lifecycle", "test_upsert_search_roundtrip",
        "test_upsert_rejects_wrong_dims", "test_filtered_search",
        "test_retrieve_delete_scroll", "test_index_rebuilt_after_restart",
        "test_missing_collection_404")] + [
    (ref_qg.TestReviewRegressions, name) for name in (
        "test_dot_and_euclid_distances", "test_unsupported_distance_rejected",
        "test_upsert_batch_atomic_validation", "test_upsert_infers_dims_when_unconfigured",
        "test_selective_filter_fills_limit", "test_empty_vector_is_validation_error")] + [
    (ref_qg.TestGrpcErrorMapping, "test_raw_cache_invalidated_on_upsert")]


@pytest.mark.parametrize("cls,name", COMPAT_CASES, ids=[n for _, n in COMPAT_CASES])
def test_reference_compat_case_on_the_port(port_names, cls, name):
    getattr(cls(), name)(ref_qg.QdrantCompat(TNamespaced(TMemory(), "test")))


@pytest.mark.parametrize("name", ["test_range_and_must_not", "test_nested_key"])
def test_reference_filter_case_on_the_port(port_names, name):
    getattr(ref_qg.TestQdrantFilters(), name)()


RACES = [(ref_rq.TestAliasFlipRaces, "test_alias_flip_storm_searches_never_404"),
         (ref_rq.TestAliasFlipRaces, "test_upserts_through_flipping_alias_land_exactly_once"),
         (ref_rq.TestCollectionChurnVsSearch, "test_create_delete_churn_isolated"),
         (ref_rq.TestWireCacheVsUpserts, "test_search_results_never_regress_after_acked_upsert")]


@pytest.mark.parametrize("cls,name", RACES, ids=[n for _, n in RACES])
def test_reference_race_on_the_port(port_names, cls, name):
    getattr(cls(), name)()


def test_points_are_exempt_from_the_embed_queue_and_the_native_search():
    from nornicdb_tpu_torch.embed.queue import embed_exempt
    from nornicdb_tpu_torch.search.service import SearchService
    from nornicdb_tpu_torch.storage.types import Node

    point = Node(id="qdrant/c/1", labels=["_Qdrant:c"], properties={"payload": {"x": 1}})
    assert embed_exempt(point)
    svc = SearchService(TNamespaced(TMemory(), "t"), device="cpu")
    svc.index_node(point)
    assert len(svc.vectors) == 0 and svc.stats.indexed_docs == 0


# -- the port's own pins -------------------------------------------------------


def test_the_layer_runs_on_its_device_and_defaults_to_cuda():
    t = tq.QdrantCompat(TMemory(), device="cpu")
    t.create_collection("c", {"size": 4})
    t.upsert_points("c", [{"id": 1, "vector": [1.0, 0.0, 0.0, 0.0]}])
    t.search_points("c", [1.0, 0.0, 0.0, 0.0])
    space = t.vector_registry.get(t._space_key("c"))
    assert space.backend == "brute" and str(space.index.device) == "cpu"
    assert str(t.device) == "cpu" and t._microbatchers["c"].batches == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tq.QdrantCompat(TMemory())


def _sampling_on(monkeypatch, audit_mod):
    monkeypatch.setattr(audit_mod, "sampling_active", lambda: True)
    monkeypatch.setattr(audit_mod, "last_served", lambda: "vector_brute")

    def ref_raises(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    calls = []

    def maybe_sample(*a, ref=None, **k):
        calls.append(1)
        ref()

    monkeypatch.setattr(audit_mod, "maybe_sample", maybe_sample)
    return ref_raises, calls


def test_a_device_fault_in_the_shadow_audit_propagates_where_jax_swallows(monkeypatch, twin):
    """C42: the audit's offer is best effort in the reference; the port
    lets a device fault through (any other error is still swallowed)."""
    twin.same("create_collection", "c", {"size": 4})
    twin.same("upsert_points", "c", [{"id": 1, "vector": [1.0, 0.0, 0.0, 0.0]}])
    for mod, compat in ((jq, twin.j), (tq, twin.t)):
        boom, calls = _sampling_on(monkeypatch, mod._audit)
        monkeypatch.setattr(compat._index("c"), "search_batch",
                            lambda *a, _real=compat._index("c").search_batch, **k:
                            boom() if k.get("exact") else _real(*a, **k))
    assert twin.j.search_points("c", [1.0, 0.0, 0.0, 0.0])[0]["id"] == 1
    with pytest.raises(RuntimeError, match="CUDA error"):
        twin.t.search_points("c", [1.0, 0.0, 0.0, 0.0], limit=2)
    monkeypatch.setattr(tq._audit, "maybe_sample",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("not a fault")))
    assert twin.t.search_points("c", [1.0, 0.0, 0.0, 0.0], limit=3)[0]["id"] == 1
