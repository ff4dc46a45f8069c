"""The port's gRPC surfaces (``api/grpc_server.py``,
``api/qdrant_official_grpc.py``, ``api/proto/*``) against the JAX
package's: both packages' ``GrpcServer`` on port 0, over DBs holding the
same data (the port on ``device="cpu"``), get the same request bytes, and
the responses' fields are equal with the ``time`` / ``took_ms`` fields
blanked. Covered: the official ``qdrant.Collections``, ``qdrant.Points``
and ``qdrant.Snapshots`` services, the native ``nornic.v1.QdrantService``
and ``nornic.v1.SearchService`` (``Search``, ``Hybrid``, ``SearchStream``),
status codes (``NOT_FOUND``, ``INVALID_ARGUMENT``), the shared response
bytes cache and its invalidation by every write surface, concurrent
upserts through the convoy, the bearer token, an admission shed's
``RESOURCE_EXHAUSTED`` with its retry pushback; and the port's pin (C42):
a device fault answers ``INTERNAL`` where the reference's handler lets it
escape (``UNKNOWN``).

The two packages' generated modules are byte for byte the same file, so
they register one descriptor in protobuf's default pool and share their
message classes. One pair of servers serves each module fixture, stopped
in a ``finally``; every RPC carries a client deadline."""

import json
import threading

import numpy as np
import pytest
import torch

grpc = pytest.importorskip("grpc")

import nornicdb_tpu  # noqa: E402
import nornicdb_tpu_torch  # noqa: E402
from nornicdb_tpu import admission as j_adm  # noqa: E402
from nornicdb_tpu.api import grpc_server as jgs  # noqa: E402
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash  # noqa: E402
from nornicdb_tpu_torch import admission as t_adm  # noqa: E402
from nornicdb_tpu_torch.api import grpc_server as tgs  # noqa: E402
from nornicdb_tpu_torch.api.proto import nornic_pb2 as pb  # noqa: E402
from nornicdb_tpu_torch.api.proto import qdrant_pb2 as q  # noqa: E402
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash  # noqa: E402

torch.set_num_threads(1)

DEADLINE_S = 30.0
SCORE_ATOL = 1e-5
D = 8
DOCS = [("oslo", "oslo is the capital of norway"),
        ("bergen", "bergen is a rainy city on the west coast of norway"),
        ("kyoto", "kyoto was the imperial capital of japan"),
        ("graph", "graph databases store nodes and relationships"),
        ("tea", "green tea is grown on the hills of uji near kyoto")]


def _open(side, **kw):
    if side == "jax":
        db = nornicdb_tpu.open(embedder=JHash(), **kw)
    else:
        db = nornicdb_tpu_torch.open(device="cpu", embedder=THash(), **kw)
    for nid, text in DOCS:
        db.store(text, node_id=nid)
    db.flush()
    db.search.build_indexes()
    return db


class Stack:
    """A JAX server and a port server on port 0, one channel to each."""

    def __init__(self, tmp, **server_kw):
        self.dbs, self.servers, self.channels = [], [], []
        try:
            for side, mod in (("jax", jgs), ("port", tgs)):
                db = _open(side)
                self.dbs.append(db)
                srv = mod.GrpcServer(db, port=0, snapshot_dir=str(tmp / side), **server_kw)
                self.servers.append(srv.start())
                self.channels.append(grpc.insecure_channel(srv.address))
        except BaseException:
            self.close()
            raise

    def call(self, i, method, request, resp_cls, metadata=None):
        rpc = self.channels[i].unary_unary(
            method, request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)
        try:
            return rpc(request, timeout=DEADLINE_S, metadata=metadata)
        except grpc.RpcError as e:
            return ("rpc_error", e.code(), e.details())

    def both(self, method, request, resp_cls, metadata=None):
        return [self.call(i, method, request, resp_cls, metadata) for i in (0, 1)]

    def close(self):
        for ch in self.channels:
            ch.close()
        for srv in self.servers:
            srv.stop()
        for db in self.dbs:
            db.close()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = Stack(tmp_path_factory.mktemp("grpc"))
    try:
        yield s
    finally:
        s.close()


def _fields(msg):
    """A response's fields as plain values, its clock fields blanked (and
    a snapshot name's time stamp)."""
    if isinstance(msg, tuple):
        return msg
    from google.protobuf.json_format import MessageToDict

    def blank(v):
        if isinstance(v, dict):
            return {k: ("<t>" if k in ("time", "took_ms", "creation_time") else
                        x.rsplit("-", 1)[0] if k == "name" and str(x).endswith(".snapshot")
                        else blank(x)) for k, x in v.items()}
        if isinstance(v, list):
            return [blank(x) for x in v]
        return v

    return blank(MessageToDict(msg, preserving_proto_field_name=True))


def _same(stack, method, request, resp_cls, metadata=None):
    j, t = stack.both(method, request, resp_cls, metadata)
    assert _fields(t) == _fields(j), method
    return t


def _scored_close(j, t, id_key, score_key="score"):
    """Scored lists: scores within SCORE_ATOL, ids tie-aware."""
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert abs(a[score_key] - b[score_key]) <= SCORE_ATOL
        if a[id_key] != b[id_key]:
            assert any(h[id_key] == b[id_key] and abs(h[score_key] - a[score_key])
                       <= 2 * SCORE_ATOL for h in j)


def _vec(i, dims=D):
    return [float(x) for x in np.random.default_rng(i).standard_normal(dims)]


def _create(name, size=D, distance=q.Cosine):
    req = q.CreateCollection(collection_name=name)
    req.vectors_config.params.size = size
    req.vectors_config.params.distance = distance
    return req


def _upsert(name, ids, offset=0):
    up = q.UpsertPoints(collection_name=name)
    for i in ids:
        p = up.points.add()
        p.id.num = i
        p.vectors.vector.data.extend(_vec(i + offset))
        p.payload["rank"].integer_value = i
        p.payload["city"].string_value = ("oslo", "bergen", "kyoto")[i % 3]
        p.payload["odd"].bool_value = bool(i % 2)
    return up


def test_official_collections_and_points_match_jax(stack):
    C, P = "/qdrant.Collections/", "/qdrant.Points/"
    for req in (_create("docs"), _create("dot", distance=q.Dot), _create("docs")):
        _same(stack, C + "Create", req, q.CollectionOperationResponse)
    _same(stack, C + "List", q.ListCollectionsRequest(), q.ListCollectionsResponse)
    _same(stack, C + "Get", q.GetCollectionInfoRequest(collection_name="docs"),
          q.GetCollectionInfoResponse)
    _same(stack, C + "Get", q.GetCollectionInfoRequest(collection_name="ghost"),
          q.GetCollectionInfoResponse)
    _same(stack, C + "CollectionExists", q.CollectionExistsRequest(collection_name="dot"),
          q.CollectionExistsResponse)
    _same(stack, P + "Upsert", _upsert("docs", range(40)), q.PointsOperationResponse)
    _same(stack, P + "Upsert", _upsert("dot", range(10), 100), q.PointsOperationResponse)
    bad = q.UpsertPoints(collection_name="docs")
    bad.points.add().id.num = 1
    bad.points[0].vectors.vector.data.extend([1.0, 2.0])
    _same(stack, P + "Upsert", bad, q.PointsOperationResponse)
    alias = q.ChangeAliases()
    alias.actions.add().create_alias.CopyFrom(q.CreateAlias(alias_name="live",
                                                            collection_name="docs"))
    _same(stack, C + "UpdateAliases", alias, q.CollectionOperationResponse)
    _same(stack, C + "ListAliases", q.ListAliasesRequest(), q.ListAliasesResponse)
    _same(stack, C + "ListCollectionAliases",
          q.ListCollectionAliasesRequest(collection_name="docs"), q.ListAliasesResponse)
    searches = [q.SearchPoints(collection_name="live", vector=_vec(3), limit=5),
                q.SearchPoints(collection_name="dot", vector=_vec(7), limit=4)]
    flt = q.SearchPoints(collection_name="docs", vector=_vec(5), limit=4, offset=1)
    cond = flt.filter.must.add()
    cond.field.key = "city"
    cond.field.match.keyword = "bergen"
    flt.with_vectors.enable = True
    searches.append(flt)
    thr = q.SearchPoints(collection_name="docs", vector=_vec(8), limit=10, score_threshold=0.2)
    thr.with_payload.enable = False
    searches.append(thr)
    for req in searches:
        j, t = (_fields(x) for x in stack.both(P + "Search", req, q.SearchResponse))
        _scored_close(j["result"], t["result"], "id")
        assert [{k: v for k, v in h.items() if k != "score"} for h in t["result"]] == \
            [{k: v for k, v in h.items() if k != "score"} for h in j["result"]] or \
            req.collection_name != "dot"
    ghost = q.SearchPoints(collection_name="ghost", vector=_vec(1), limit=3)
    out = _same(stack, P + "Search", ghost, q.SearchResponse)
    assert out[1] == grpc.StatusCode.NOT_FOUND
    wrong = q.SearchPoints(collection_name="docs", vector=[1.0, 2.0], limit=3)
    assert _same(stack, P + "Search", wrong, q.SearchResponse)[1] == \
        grpc.StatusCode.INVALID_ARGUMENT
    get = q.GetPoints(collection_name="docs")
    for i in (1, 5, 999):
        get.ids.add().num = i
    get.with_vectors.enable = True
    _same(stack, P + "Get", get, q.GetResponse)
    scroll = q.ScrollPoints(collection_name="docs", limit=7)
    _same(stack, P + "Scroll", scroll, q.ScrollResponse)
    scroll.offset.num = 15
    cond = scroll.filter.must.add()
    cond.field.key = "odd"
    cond.field.match.boolean = True
    _same(stack, P + "Scroll", scroll, q.ScrollResponse)
    count = q.CountPoints(collection_name="docs")
    _same(stack, P + "Count", count, q.CountResponse)
    rng = count.filter.must.add()
    rng.field.key = "rank"
    rng.field.range.gte = 10
    _same(stack, P + "Count", count, q.CountResponse)
    dele = q.DeletePoints(collection_name="docs")
    dele.points.points.ids.add().num = 2
    _same(stack, P + "Delete", dele, q.PointsOperationResponse)
    dele = q.DeletePoints(collection_name="docs")
    c = dele.points.filter.must.add()
    c.field.key = "city"
    c.field.match.keyword = "kyoto"
    _same(stack, P + "Delete", dele, q.PointsOperationResponse)
    _same(stack, P + "Count", q.CountPoints(collection_name="docs"), q.CountResponse)
    _same(stack, C + "Delete", q.DeleteCollection(collection_name="dot"),
          q.CollectionOperationResponse)
    _same(stack, C + "List", q.ListCollectionsRequest(), q.ListCollectionsResponse)


def test_snapshots_match_jax(stack):
    S = "/qdrant.Snapshots/"
    _same(stack, "/qdrant.Collections/Create", _create("snap"), q.CollectionOperationResponse)
    _same(stack, "/qdrant.Points/Upsert", _upsert("snap", range(6)), q.PointsOperationResponse)
    made = _same(stack, S + "Create", q.CreateSnapshotRequest(collection_name="snap"),
                 q.CreateSnapshotResponse)
    _same(stack, S + "List", q.ListSnapshotsRequest(collection_name="snap"),
          q.ListSnapshotsResponse)
    _same(stack, S + "Delete", q.DeleteSnapshotRequest(collection_name="snap",
                                                       snapshot_name="../escape"),
          q.DeleteSnapshotResponse)
    j, t = stack.both(S + "CreateFull", q.CreateFullSnapshotRequest(), q.CreateSnapshotResponse)
    assert _fields(t) == _fields(j)
    _same(stack, S + "ListFull", q.ListFullSnapshotsRequest(), q.ListSnapshotsResponse)
    for i, resp in enumerate((j, t)):
        stack.call(i, S + "DeleteFull", q.DeleteFullSnapshotRequest(
            snapshot_name=resp.snapshot_description.name), q.DeleteSnapshotResponse)
    _same(stack, S + "ListFull", q.ListFullSnapshotsRequest(), q.ListSnapshotsResponse)
    assert made.snapshot_description.size > 0


def test_native_qdrant_service_matches_jax(stack):
    S = "/nornic.v1.QdrantService/"
    _same(stack, S + "CreateCollection",
          pb.CreateCollectionRequest(collection="g", vector_size=4), pb.AckResponse)
    _same(stack, S + "CreateCollection",
          pb.CreateCollectionRequest(collection="g", vector_size=4), pb.AckResponse)
    _same(stack, S + "Upsert", pb.UpsertRequest(collection="g", points=[
        pb.Point(id="p1", vector=[1, 0, 0, 0], payload_json='{"k": 1}'),
        pb.Point(id="p2", vector=[0, 1, 0, 0]),
        pb.Point(id="p3", vector=[0.6, 0.8, 0, 0], payload_json='{"k": 3}')]), pb.AckResponse)
    for req in (pb.SearchPointsRequest(collection="g", vector=[1, 0, 0, 0], limit=2,
                                       with_payload=True),
                pb.SearchPointsRequest(collection="g", vector=[0, 1, 0, 0], limit=3,
                                       with_vector=True, has_score_threshold=True,
                                       score_threshold=0.5,
                                       filter_json='{"must_not": [{"key": "k", '
                                                   '"match": {"value": 3}}]}')):
        j, t = (_fields(x) for x in stack.both(S + "SearchPoints", req, pb.SearchPointsResponse))
        _scored_close(j["points"], t["points"], "id")
    _same(stack, S + "CountPoints", pb.CollectionRequest(collection="g"), pb.CountResponse)
    _same(stack, S + "CountPoints", pb.CollectionRequest(collection="ghost"), pb.CountResponse)
    _same(stack, S + "GetCollection", pb.CollectionRequest(collection="g"),
          pb.CollectionInfoResponse)
    _same(stack, S + "GetCollection", pb.CollectionRequest(collection="ghost"),
          pb.CollectionInfoResponse)
    _same(stack, S + "ListCollections", pb.Empty(), pb.ListCollectionsResponse)
    _same(stack, S + "DeletePoints", pb.DeletePointsRequest(collection="g", ids=["p2"]),
          pb.AckResponse)
    _same(stack, S + "DeleteCollection", pb.CollectionRequest(collection="g"), pb.AckResponse)


def test_native_search_service_matches_jax(stack):
    S = "/nornic.v1.SearchService/"
    target = stack.dbs[1].storage.get_node("kyoto").embedding
    assert target == stack.dbs[0].storage.get_node("kyoto").embedding
    direct = stack.dbs[1].search.vector_search_candidates(np.asarray(target, np.float32), k=3)
    for req, method in ((pb.SearchRequest(vector=target, limit=3), "Search"),
                        (pb.HybridRequest(query="capital of japan", limit=4), "Hybrid"),
                        (pb.HybridRequest(query="tea", vector=target, limit=2), "Hybrid")):
        resp_cls = pb.SearchResponse
        j, t = stack.both(S + method, req, resp_cls)
        jf, tf = _fields(j), _fields(t)
        _scored_close(jf["hits"], tf["hits"], "node_id")
        assert [h.get("payload_json") for h in tf["hits"]] == \
            [h.get("payload_json") for h in jf["hits"]]
        if method == "Search":
            assert [(h.node_id, h.score) for h in t.hits] == \
                [(i, pytest.approx(s, abs=1e-6)) for i, s in direct]
    # the streaming RPC answers each request in order
    reqs = [pb.SearchRequest(vector=stack.dbs[1].storage.get_node(n).embedding, limit=1)
            for n, _ in DOCS]
    for i, ch in enumerate(stack.channels):
        stream = ch.stream_stream(S + "SearchStream",
                                  request_serializer=lambda m: m.SerializeToString(),
                                  response_deserializer=pb.SearchResponse.FromString)
        tops = [r.hits[0].node_id for r in stream(iter(reqs), timeout=DEADLINE_S)]
        assert tops == [n for n, _ in DOCS], i


def test_wire_cache_is_invalidated_by_every_write_surface(stack):
    """tests/test_races_qdrant.py's named regression, on both servers."""
    P = "/qdrant.Points/"
    _same(stack, "/qdrant.Collections/Create", _create("inv", size=4),
          q.CollectionOperationResponse)

    def up(pid, vec):
        req = q.UpsertPoints(collection_name="inv")
        p = req.points.add()
        p.id.num = pid
        p.vectors.vector.data.extend(vec)
        _same(stack, P + "Upsert", req, q.PointsOperationResponse)

    sr = q.SearchPoints(collection_name="inv", vector=[1.0, 0.0, 0.0, 0.0], limit=1)

    def top():
        answers = stack.both(P + "Search", sr, q.SearchResponse)
        tops = [[int(p.id.num) for p in a.result] for a in answers]
        assert tops[0] == tops[1]
        return tops[1]

    up(1, [1.0, 0.0, 0.0, 0.0])
    assert top() == [1]
    hits = [s.wire_cache.stats()["hits"] for s in stack.servers]
    assert top() == [1]
    assert [s.wire_cache.stats()["hits"] for s in stack.servers] == [h + 1 for h in hits]
    up(2, [0.0, 1.0, 0.0, 0.0])
    up(3, [0.9, 0.1, 0.0, 0.0])
    dp = q.DeletePoints(collection_name="inv")
    dp.points.points.ids.add().num = 1
    _same(stack, P + "Delete", dp, q.PointsOperationResponse)
    assert top() == [3]
    for db in stack.dbs:
        db.cypher("MATCH (n) WHERE n._point_id = 2 SET n._vector = [1.0, 0.0, 0.0, 0.0]")
    assert top() == [2]
    for db in stack.dbs:
        db.cypher("MATCH (n) WHERE n._point_id = 2 DETACH DELETE n")
    assert top() == [3]


def test_concurrent_upserts_land_exactly_once_through_the_convoy(stack):
    _same(stack, "/qdrant.Collections/Create", _create("conv"), q.CollectionOperationResponse)
    errors = []

    def writer(i, part):
        try:
            for pid in range(part, 96, 8):
                out = stack.call(i, "/qdrant.Points/Upsert", _upsert("conv", [pid]),
                                 q.PointsOperationResponse)
                assert not isinstance(out, tuple), out
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(i, p)) for i in (0, 1) for p in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    out = _same(stack, "/qdrant.Points/Count", q.CountPoints(collection_name="conv"),
                q.CountResponse)
    assert out.result.count == 96
    _same(stack, "/qdrant.Points/Scroll", q.ScrollPoints(collection_name="conv", limit=200),
          q.ScrollResponse)


def test_an_admission_shed_answers_resource_exhausted(stack, monkeypatch):
    for adm in (j_adm, t_adm):
        monkeypatch.setattr(adm.CONTROLLER, "refresh", lambda now=None, force=False: "shed_hard")
        monkeypatch.setattr(adm.CONTROLLER, "posture", "shed_hard")
    try:
        codes = []
        for i, ch in enumerate(stack.channels):
            rpc = ch.unary_unary("/qdrant.Points/Count",
                                 request_serializer=lambda m: m.SerializeToString(),
                                 response_deserializer=q.CountResponse.FromString)
            with pytest.raises(grpc.RpcError) as exc:
                rpc(q.CountPoints(collection_name="docs", exact=True), timeout=DEADLINE_S)
            md = dict(exc.value.trailing_metadata() or ())
            codes.append((exc.value.code(), "grpc-retry-pushback-ms" in md))
        assert codes[0] == codes[1] == (grpc.StatusCode.RESOURCE_EXHAUSTED, True)
        # a metadata read is never shed
        _same(stack, "/qdrant.Collections/List", q.ListCollectionsRequest(),
              q.ListCollectionsResponse)
    finally:
        monkeypatch.undo()
        for adm in (j_adm, t_adm):
            adm.CONTROLLER.reset()


@pytest.fixture(scope="module")
def secured(tmp_path_factory):
    s = Stack(tmp_path_factory.mktemp("grpc_auth"), auth_token="s3cret")
    try:
        yield s
    finally:
        s.close()


def test_the_bearer_token_guards_every_method(secured):
    vec = secured.dbs[1].storage.get_node("oslo").embedding
    good = (("authorization", "Bearer s3cret"),)
    for method, req, cls in (("/nornic.v1.QdrantService/ListCollections", pb.Empty(),
                              pb.ListCollectionsResponse),
                             ("/qdrant.Collections/List", q.ListCollectionsRequest(),
                              q.ListCollectionsResponse),
                             ("/nornic.v1.SearchService/Search",
                              pb.SearchRequest(vector=vec, limit=1), pb.SearchResponse)):
        for md in (None, (("authorization", "Bearer wrong"),), (("authorization", "s3cret"),)):
            out = _same(secured, method, req, cls, metadata=md)
            assert out[1] == grpc.StatusCode.UNAUTHENTICATED
        j, t = secured.both(method, req, cls, good)
        assert not isinstance(j, tuple) and not isinstance(t, tuple)
        if cls is pb.SearchResponse:
            assert [h.node_id for h in t.hits] == [h.node_id for h in j.hits] == ["oslo"]
        else:
            assert _fields(t) == _fields(j)


def test_a_device_fault_answers_internal_where_jax_answers_unknown(stack, monkeypatch):
    """C42: the reference lets a RuntimeError escape its aio handler
    (``UNKNOWN``); the port answers a device fault ``INTERNAL`` with its
    message. A ``QdrantError`` keeps its mapped status in both."""
    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    for srv in stack.servers:
        monkeypatch.setattr(srv.official_points.compat, "count_points", boom)
        monkeypatch.setattr(srv.search_servicer.db.search, "vector_search_candidates", boom)
    for method, req, cls in (("/qdrant.Points/Count", q.CountPoints(collection_name="docs"),
                              q.CountResponse),
                             ("/nornic.v1.SearchService/Search",
                              pb.SearchRequest(vector=[0.5] * 16, limit=2), pb.SearchResponse)):
        j, t = stack.both(method, req, cls)
        assert j[1] == grpc.StatusCode.UNKNOWN
        assert t[1] == grpc.StatusCode.INTERNAL and "CUDA error" in t[2]


def test_hit_payload_lookup_lets_a_device_fault_through(monkeypatch):
    """C42: ``SearchServicer._hit`` answers an empty payload on any error in
    the reference; the port raises a device fault (answered INTERNAL by the
    handler) and keeps ``{}`` for any other error."""
    class Storage:
        def __init__(self, exc):
            self.exc = exc

        def get_node(self, node_id):
            raise self.exc

    db = type("DB", (), {})()
    for exc, want in ((KeyError("n1"), "{}"), (ValueError("bad"), "{}")):
        db.storage = Storage(exc)
        assert tgs.SearchServicer(db)._hit("n1", 0.5).payload_json == want
        assert jgs.SearchServicer(db)._hit("n1", 0.5).payload_json == want
    db.storage = Storage(RuntimeError("CUDA error: device-side assert triggered"))
    assert jgs.SearchServicer(db)._hit("n1", 0.5).payload_json == "{}"
    with pytest.raises(RuntimeError, match="CUDA error"):
        tgs.SearchServicer(db)._hit("n1", 0.5)


def test_servers_share_the_db_s_compat_with_rest():
    db = nornicdb_tpu_torch.open(device="cpu", embedder=THash())
    srv = None
    try:
        from nornicdb_tpu_torch.api.http_server import HttpServer

        http = HttpServer(db, port=0)
        srv = tgs.GrpcServer(db, port=0)
        assert http.qdrant is srv.qdrant_servicer.compat is srv.official_points.compat \
            is db.qdrant_compat
        assert json.loads(json.dumps(srv.address.split(":")[0])) == "127.0.0.1"
    finally:
        if srv is not None:
            srv.stop()
        db.close()
