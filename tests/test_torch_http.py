"""The port's HTTP server (``nornicdb_tpu_torch/api/http_server.py``, with
``api/openapi.py``) against the JAX package's: the same requests against
the JAX ``HttpServer`` over a JAX DB and the port's over a DB on
``device="cpu"`` give equal status codes and bodies, apart from
transaction ids and times. Routes: ``/health``, ``/``, ``/status``,
``/openapi.json``, the Neo4j transaction API over the fast-path parity
corpus and with explicit transactions, ``/nornicdb/search`` in each mode,
``store``, ``similar``, ``embed``, GDPR, ``/auth/login`` with 401 and 403
under an ``Authenticator``, ``/admin/flags``, MCP at ``/mcp`` and
``/v1/chat/completions`` on the tiny decoder. Error answers: 429 under a
forced shed, 504 on an expired deadline. ``/graphql`` and ``/collections``,
once 501s (ROADMAP C38), answer as the reference's and authorize first.
Then the port's own pins: C39's device faults (a readiness probe re-raises
one, and a request answers it with 500), and an ``EmbedHTTPError`` that is
not a device fault. Every server binds port 0, every client has a
timeout, and every server stops in a fixture."""

import base64
import gc
import json
import types
import urllib.error
import urllib.request

import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu.admission as j_adm
import nornicdb_tpu.obs as j_obs
import nornicdb_tpu_torch
import nornicdb_tpu_torch.admission as t_adm
import nornicdb_tpu_torch.obs as t_obs
import test_fastpath_parity as parity
from nornicdb_tpu.api import http_server as j_http
from nornicdb_tpu.api import openapi as j_openapi
from nornicdb_tpu.auth import Authenticator as JAuth
from nornicdb_tpu.config import flags as j_flags
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu_torch import errors as t_errors
from nornicdb_tpu_torch.api import http_server as t_http
from nornicdb_tpu_torch.api import openapi as t_openapi
from nornicdb_tpu_torch.auth import Authenticator as TAuth
from nornicdb_tpu_torch.config import flags as t_flags
from nornicdb_tpu_torch.embed.embedder import HashEmbedder

JAX = types.SimpleNamespace(name="jax", http=j_http, adm=j_adm, obs=j_obs, Auth=JAuth,
                            flags=j_flags)
PORT = types.SimpleNamespace(name="port", http=t_http, adm=t_adm, obs=t_obs, Auth=TAuth,
                             flags=t_flags)
SIDES = (JAX, PORT)

DOCS = [
    ("oslo", "oslo is the capital of norway", ["City"]),
    ("bergen", "bergen is a rainy city on the west coast of norway", ["City"]),
    ("kyoto", "kyoto was the imperial capital of japan", ["City"]),
    ("graph", "graph databases store nodes and relationships", ["Fact"]),
    ("vector", "vector search ranks documents by cosine similarity", ["Fact"]),
    ("bm25", "bm25 ranks documents by term frequency and rarity", ["Fact"]),
    ("tea", "green tea is grown on the hills of uji near kyoto", ["Fact"]),
    ("fjord", "a fjord is a long narrow inlet with steep sides", ["Fact"]),
]

torch.set_num_threads(1)


def _open(side):
    if side is JAX:
        return nornicdb_tpu.open(embedder=JHash())
    return nornicdb_tpu_torch.open(device="cpu", embedder=HashEmbedder())


def request(port, path, method="GET", body=None, headers=None):
    """(status, parsed body, headers) of one request; never raises on a
    status."""
    data = body if isinstance(body, bytes) else (
        json.dumps(body).encode() if body is not None else None)
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                               headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            status, raw, hdrs = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), dict(e.headers)
    try:
        parsed = json.loads(raw)
    except json.JSONDecodeError:
        parsed = raw.decode()
    return status, parsed, hdrs


class Pair:
    """A JAX server and a port server over DBs holding the same data."""

    def __init__(self, docs=True, **kw):
        self.dbs, self.servers = [], []
        try:
            for side in SIDES:
                db = _open(side)
                self.dbs.append(db)
                if docs:
                    for nid, text, labels in DOCS:
                        db.store(text, labels=labels, node_id=nid)
                    db.link("oslo", "bergen", "NEAR", properties={"km": 463})
                    db.flush()
                srv_kw = {k: (v(side) if callable(v) else v) for k, v in kw.items()}
                self.servers.append(side.http.HttpServer(db, port=0, **srv_kw).start())
        except BaseException:
            self.close()
            raise

    def both(self, path, method="GET", body=None, headers=None):
        return [request(s.port, path, method, body, headers) for s in self.servers]

    def close(self):
        for s in self.servers:
            s.stop()
        for db in self.dbs:
            db.close()


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _fresh_state():
    # the resource registries hold their objects weakly: collect the
    # cycles an earlier test left (a Qdrant layer's batchers close over
    # it), so /readyz counts only this test's live structures
    gc.collect()
    for side in SIDES:
        side.adm.CONTROLLER.reset()
        side.flags.reset()
    yield
    for side in SIDES:
        side.adm.CONTROLLER.reset()
        side.flags.reset()


def _strip(body, keys=("commit", "transaction", "id", "created", "exported_at_ms",
                       "created_at", "updated_at")):
    if isinstance(body, dict):
        return {k: ("<var>" if k in keys else _strip(v, keys)) for k, v in body.items()}
    if isinstance(body, list):
        return [_strip(v, keys) for v in body]
    return body


def _same(answers, strip=False, ids=None):
    """Equal status and body; ``ids`` (the JAX side's, the port's) are
    transaction ids to blank out of the bodies' text."""
    (sj, bj, _), (st, bt, _) = answers
    if strip:
        bj, bt = _strip(bj), _strip(bt)
    if ids:
        bj, bt = (json.loads(json.dumps(b).replace(i, "<tx>")) for b, i in zip((bj, bt), ids))
    assert (st, bt) == (sj, bj)
    return st, bt


# -- public routes -------------------------------------------------------------


@pytest.mark.parametrize("path", ["/health", "/", "/status", "/nope", "/readyz"])
def test_public_routes_match(pair, path):
    _same(pair.both(path))


def test_openapi_spec_equals_the_reference(pair, monkeypatch):
    monkeypatch.setattr(t_openapi, "API_VERSION", j_openapi.API_VERSION)
    assert t_openapi.openapi_spec() == j_openapi.openapi_spec()
    st, spec = _same(pair.both("/openapi.json"))
    assert st == 200 and spec["openapi"].startswith("3.")
    assert t_openapi.docs_page() == j_openapi.docs_page()
    _same(pair.both("/docs"))
    _same(pair.both("/browser"))


# -- Neo4j transaction API -----------------------------------------------------


class _Recorder:
    """Stands in for the parity graph's executor: keeps the statements."""

    statements = []

    def __init__(self, *_a, **_k):
        self.enable_query_cache = True

    def execute(self, q, params=None):
        _Recorder.statements.append({"statement": q, "parameters": params or {}})

    def invalidate_caches(self):
        pass


@pytest.fixture(scope="module")
def corpus_pair():
    mp = pytest.MonkeyPatch()
    _Recorder.statements = []
    mp.setattr(parity, "CypherExecutor", _Recorder)
    try:
        parity.graph.__wrapped__()
    finally:
        mp.undo()
    p = Pair(docs=False)
    try:
        stmts = _Recorder.statements
        for i in range(0, len(stmts), 200):
            answers = p.both("/db/neo4j/tx/commit", "POST", {"statements": stmts[i:i + 200]})
            st, body = _same(answers)
            assert st == 200 and body["errors"] == [], body["errors"]
        yield p
    finally:
        p.close()


def _rows_norm(body, ordered):
    """Whole nodes carry random ids: compare them without; an unordered
    result compares as a multiset of rows."""
    def node_free(v):
        if isinstance(v, dict) and "labels" in v and "properties" in v:
            return {"labels": v["labels"], "properties": node_free(v["properties"])}
        if isinstance(v, dict):
            return {k: node_free(x) for k, x in v.items()}
        if isinstance(v, list):
            return [node_free(x) for x in v]
        return v

    out = []
    for res in body["results"]:
        rows = [json.dumps(node_free(d["row"]), sort_keys=True) for d in res["data"]]
        out.append((res["columns"], rows if ordered else sorted(rows), res["stats"]))
    return out, body["errors"]


@pytest.mark.parametrize("idx", range(len(parity.CORPUS)))
def test_tx_commit_parity_corpus(corpus_pair, idx):
    query, params, ordered = parity.CORPUS[idx]
    (sj, bj, _), (st, bt, _) = corpus_pair.both(
        "/db/neo4j/tx/commit", "POST", {"statements": [{"statement": query, "parameters": params}]})
    assert st == sj == 200
    assert _rows_norm(bt, ordered) == _rows_norm(bj, ordered)


def test_tx_commit_errors_match(pair):
    for stmts in ([{"statement": "THIS IS NOT CYPHER"}],
                  [{"statement": "RETURN 1 AS a"}, {"statement": "RETURN nope(1)"},
                   {"statement": "RETURN 2"}],
                  [{"statement": "CREATE (n:W {v: 1}) RETURN n.v"}]):
        _same(pair.both("/db/neo4j/tx/commit", "POST", {"statements": stmts}))
    _same(pair.both("/db/neo4j/tx/commit", "POST", b"{not json"))
    _same(pair.both("/db/other/tx/commit", "POST", {"statements": [{"statement": "RETURN 1"}]}))


def test_explicit_transactions_match(pair):
    st, body = _same(pair.both("/db/neo4j/tx", "POST", {"statements": [
        {"statement": "CREATE (n:Tx {v: $v}) RETURN n.v", "parameters": {"v": 7}}]}), strip=True)
    assert st == 201 and body["commit"] == "<var>"
    tx = [request(s.port, "/db/neo4j/tx", "POST", {"statements": []})[1]["transaction"]["id"]
          for s in pair.servers]
    # the begin above left its tx open; these are second transactions
    run = [request(s.port, f"/db/neo4j/tx/{t}", "POST", {"statements": [
        {"statement": "CREATE (n:Gone {v: 1})"},
        {"statement": "MATCH (n:Gone) RETURN count(n)"}]}) for s, t in zip(pair.servers, tx)]
    _same(run)
    _same([request(s.port, f"/db/neo4j/tx/{t}", "DELETE") for s, t in zip(pair.servers, tx)])
    _same(pair.both("/db/neo4j/tx/commit", "POST", {"statements": [
        {"statement": "MATCH (n:Gone) RETURN count(n)"}]}))  # rolled back: not seen
    tx = [request(s.port, "/db/neo4j/tx", "POST", {"statements": [
        {"statement": "CREATE (n:Kept {v: 2})"}]})[1]["transaction"]["id"] for s in pair.servers]
    _same([request(s.port, f"/db/neo4j/tx/{t}/commit", "POST", {"statements": [
        {"statement": "MATCH (n:Kept) RETURN n.v"}]}) for s, t in zip(pair.servers, tx)])
    st, body = _same(pair.both("/db/neo4j/tx/commit", "POST", {"statements": [
        {"statement": "MATCH (n:Kept) RETURN count(n)"}]}))
    assert body["results"][0]["data"][0]["row"] == [1]
    _same([request(s.port, f"/db/neo4j/tx/{t}/commit", "POST", {"statements": []})
           for s, t in zip(pair.servers, tx)], ids=tx)  # committed: gone
    _same(pair.both("/db/neo4j/tx/ffff/commit", "POST", {"statements": []}))


# -- REST ----------------------------------------------------------------------


def _hits_close(j, t):
    assert [h["id"] for h in t["results"]] == [h["id"] for h in j["results"]]
    for hj, ht in zip(j["results"], t["results"]):
        assert ht.keys() == hj.keys()
        for k in hj:
            if isinstance(hj[k], float):
                assert ht[k] == pytest.approx(hj[k], abs=1e-6), k
            else:
                assert ht[k] == hj[k], k


@pytest.mark.parametrize("mode", [None, "hybrid", "text", "vector"])
@pytest.mark.parametrize("query", ["capital city", "ranks documents", "kyoto tea"])
def test_search_modes_match(pair, mode, query):
    body = {"query": query, "limit": 4}
    if mode:
        body["mode"] = mode
    for _ in range(2):  # the second answer comes from the response-bytes cache
        (sj, bj, _), (st, bt, _) = pair.both("/nornicdb/search", "POST", body)
        assert st == sj == 200
        _hits_close(bj, bt)
    # the port's scores reach the JSON as the floats recall returns
    direct = pair.dbs[1].recall(query, limit=4, **({"mode": mode} if mode else {}))
    assert [(h["id"], h["score"]) for h in bt["results"]] == \
        [(h["id"], h["score"]) for h in direct]


@pytest.mark.parametrize("body", [
    {"query": "x", "mode": "fuzzy"}, {"query": "x", "weights": [1]},
    {"query": "capital", "weights": [0.2, 0.8], "limit": 3}])
def test_search_options_match(pair, body):
    answers = pair.both("/nornicdb/search", "POST", body)
    if answers[0][0] == 200:
        _hits_close(answers[0][1], answers[1][1])
    else:
        _same(answers)


def test_store_similar_embed_gdpr_match(pair):
    st, body = _same(pair.both("/nornicdb/store", "POST", {
        "content": "trondheim has a cathedral", "id": "trd", "labels": ["City"],
        "properties": {"email": "t@x"}}))
    assert st == 201 and body == {"id": "trd"}
    for db in pair.dbs:
        db.flush()
    (sj, bj, _), (st, bt, _) = pair.both("/nornicdb/similar", "POST", {"node_id": "oslo", "limit": 3})
    assert st == sj == 200
    _hits_close(bj, bt)
    (sj, bj, _), (st, bt, _) = pair.both("/nornicdb/embed", "POST", {"texts": ["a b", "c"]})
    assert st == sj == 200
    assert torch.allclose(torch.tensor(bt["embeddings"]), torch.tensor(bj["embeddings"]), atol=1e-6)
    st, body = _same(pair.both("/nornicdb/gdpr/export", "POST", {"property": "email", "value": "t@x"}),
                     strip=True)
    assert [n["id"] for n in body["nodes"]] == ["<var>"]
    _same(pair.both("/nornicdb/gdpr/delete", "POST", {"property": "email", "value": "t@x"}))
    _same(pair.both("/nornicdb/nope", "POST", {}))


# -- auth, admin, MCP, chat ----------------------------------------------------


@pytest.fixture
def secured():
    def auth(side):
        a = side.Auth(jwt_secret="fixed")
        a.create_user("root", "rootpw", roles=["admin"])
        a.create_user("reader", "rpw", roles=["reader"])
        return a

    p = Pair(authenticator=auth)
    yield p
    p.close()


def _basic(user, pw):
    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode()}


def test_auth_401_403_and_login_match(secured):
    _same(secured.both("/status"))  # 401
    _same(secured.both("/status", headers=_basic("root", "wrong")))
    _same(secured.both("/status", headers={"Authorization": "Bearer not.a.token"}))
    st, _ = _same(secured.both("/db/neo4j/tx/commit", "POST", {"statements": [
        {"statement": "CREATE (n:X)"}]}, headers=_basic("reader", "rpw")))
    assert st == 403
    _same(secured.both("/admin/flags", headers=_basic("reader", "rpw")))  # 403
    _same(secured.both("/db/neo4j/tx/commit", "POST", {"statements": [
        {"statement": "MATCH (n) RETURN count(n)"}]}, headers=_basic("reader", "rpw")))
    _same(secured.both("/auth/login", "POST", {"username": "root", "password": "nope"}))
    answers = secured.both("/auth/login", "POST", {"username": "root", "password": "rootpw"})
    assert [a[0] for a in answers] == [200, 200]
    for (_, body, _), srv in zip(answers, secured.servers):
        st, doc, _ = request(srv.port, "/status", headers={"Authorization": f"Bearer {body['token']}"})
        assert st == 200 and doc["counts"]["nodes"] == len(DOCS)


def test_admin_flags_match(secured):
    hdrs = _basic("root", "rootpw")
    _same(secured.both("/admin/flags", headers=hdrs))
    st, body = _same(secured.both("/admin/flags", "PUT", {"parser": "strict", "x": 1},
                                  headers=hdrs))
    assert st == 200 and body["parser"] == "strict"
    _same(secured.both("/admin/nope", headers=hdrs))
    _same(secured.both("/admin/databases", headers=hdrs))  # multi-database not enabled


def test_mcp_over_http_matches(pair):
    for payload in ({"jsonrpc": "2.0", "id": 1, "method": "initialize"},
                    {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
                    {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
                        "name": "recall", "arguments": {"query": "capital", "limit": 2}}},
                    {"jsonrpc": "2.0", "method": "notifications/initialized"}):
        answers = pair.both("/mcp", "POST", payload)
        if payload.get("id") == 3:
            assert [a[0] for a in answers] == [200, 200]
            hits = [json.loads(a[1]["result"]["content"][0]["text"]) for a in answers]
            assert [h["id"] for h in hits[1]] == [h["id"] for h in hits[0]]
        else:
            _same(answers)


def test_chat_completions_on_the_tiny_decoder_match(pair):
    body = {"messages": [{"role": "user", "content": "name a city"}], "max_tokens": 12}
    st, doc = _same(pair.both("/v1/chat/completions", "POST", body), strip=True)
    assert st == 200 and doc["model"] == "heimdall-slm"
    (sj, bj, _), (st, bt, _) = pair.both("/heimdall/models")
    # the one difference: the port names its in-process backend "torch"
    assert [m.pop("backend") for m in bj["models"]] == ["jax"]
    assert [m.pop("backend") for m in bt["models"]] == ["torch"]
    assert (st, bt) == (sj, bj)


# -- sheds and deadlines -------------------------------------------------------


def _force(monkeypatch, posture):
    for side in SIDES:
        monkeypatch.setattr(side.adm.CONTROLLER, "refresh", lambda now=None, force=False: posture)
        monkeypatch.setattr(side.adm.CONTROLLER, "posture", posture)


@pytest.mark.parametrize("path,body", [
    ("/nornicdb/search", {"query": "fjord", "limit": 3}),
    ("/db/neo4j/tx/commit", {"statements": [{"statement": "RETURN 1"}]}),
    ("/nornicdb/store", {"content": "shed me"})])
def test_forced_shed_answers_429_with_retry_after(pair, monkeypatch, path, body):
    _force(monkeypatch, "shed_hard")
    answers = pair.both(path, "POST", body)
    st, _ = _same(answers)
    assert st == 429
    assert answers[0][2]["Retry-After"] == answers[1][2]["Retry-After"]
    _same(pair.both("/health"))  # probes are exempt


def test_expired_deadline_answers_504(pair):
    hdrs = {t_adm.DEADLINE_HEADER: "0.001"}
    assert t_adm.DEADLINE_HEADER == j_adm.DEADLINE_HEADER
    for mode in ("vector", "hybrid"):
        st, body = _same(pair.both("/nornicdb/search", "POST",
                                   {"query": "capital", "limit": 5, "mode": mode}, headers=hdrs))
        assert st == 504 and body["errors"][0]["code"].endswith("DeadlineExceeded")


# -- the port's own: C38 and C39 -----------------------------------------------


def _no_time(body):
    if isinstance(body, dict):
        return {k: ("<t>" if k == "time" else _no_time(v)) for k, v in body.items()}
    if isinstance(body, list):
        return [_no_time(v) for v in body]
    return body


@pytest.mark.parametrize("method,path", [
    ("GET", "/graphql"), ("POST", "/graphql"), ("GET", "/collections"),
    ("PUT", "/collections/c1"), ("POST", "/collections/c1/points/search")])
def test_unported_routes_answer_501(pair, method, path):
    """The routes that answered 501 before GraphQL and the Qdrant REST
    surface were ported (ROADMAP C38) now answer as the reference's, 501
    nowhere; the same request twice, so a created collection is seen."""
    body = {"query": "{ nodeCount }", "vectors": {"size": 4},
            "vector": [1.0, 0.0, 0.0, 0.0]} if method != "GET" else None
    for _ in range(2):
        (sj, bj, _), (st, bt, _) = pair.both(path, method, body)
        assert (st, _no_time(bt)) == (sj, _no_time(bj)) and st != 501


def test_unported_routes_authorize_first(secured):
    """``/collections`` (once a 501, C38) still authorizes first, as the
    reference's: no credentials 401, a reader's write 403, a reader's read
    200."""
    for path, method, headers in (("/collections", "GET", None),
                                  ("/collections/c1", "PUT", _basic("reader", "rpw")),
                                  ("/collections", "GET", _basic("reader", "rpw"))):
        (sj, bj, _), (st, bt, _) = secured.both(path, method, {} if method == "PUT" else None,
                                                headers)
        assert (st, _no_time(bt)) == (sj, _no_time(bj))
        assert st == {None: 401, "PUT": 403}.get(headers and method, 200)


@pytest.mark.parametrize("probe", ["parity_breaches", "get_slo_engine", "reconcile"])
def test_device_fault_in_a_readiness_probe_reraises(pair, monkeypatch, probe):
    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    target = t_obs.device if probe == "reconcile" else t_obs
    monkeypatch.setattr(target, probe, boom)
    srv = pair.servers[1]
    with pytest.raises(RuntimeError, match="CUDA error"):
        srv._readyz()
    st, body, _ = request(srv.port, "/readyz")  # the request answers it
    assert st == 500 and body["errors"][0]["code"] == "Neo.DatabaseError.General.UnknownError"
    assert "CUDA error" in body["errors"][0]["message"]
    # the reference swallows the same error in its probe
    jtarget = j_obs.device if probe == "reconcile" else j_obs
    monkeypatch.setattr(jtarget, probe, boom)
    assert request(pair.servers[0].port, "/readyz")[0] == 200


def test_device_fault_in_the_scrape_counts_reraises(pair, monkeypatch):
    def boom():
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(pair.dbs[1].storage, "count_nodes", boom)
    with pytest.raises(RuntimeError):
        pair.servers[1]._metric_snapshot()
    assert request(pair.servers[1].port, "/metrics")[0] == 500


@pytest.mark.parametrize("exc", [ValueError("bad env"),
                                 t_errors.EmbedHTTPError("POST http://x -> HTTP 503"),
                                 t_errors.DeadlineExceeded("late")])
def test_other_errors_in_a_probe_keep_the_reference_behaviour(pair, monkeypatch, exc):
    def boom(*a, **k):
        raise exc

    monkeypatch.setattr(t_obs, "parity_breaches", boom)
    st, body, _ = request(pair.servers[1].port, "/readyz")
    assert st == 200 and body["status"] == "ready"
    assert not t_errors.is_device_fault(exc)


def test_device_fault_in_a_request_answers_500(pair, monkeypatch):
    svc = pair.dbs[1].search

    def boom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(svc, "search", boom)
    st, body, _ = request(pair.servers[1].port, "/nornicdb/search", "POST", {"query": "oslo!"})
    assert st == 500 and "out of memory" in body["errors"][0]["message"]


def test_embed_http_error_from_the_embedder_answers_as_the_reference(pair, monkeypatch):
    """An HTTP embedder that fails is not a device fault: the reranker's
    query embed fails open to its lexical ranking, as the reference's."""
    from nornicdb_tpu.embed.http_providers import EmbedHTTPError as JErr
    from nornicdb_tpu.search.rerank import LocalReranker as JRerank
    from nornicdb_tpu_torch.search.rerank import LocalReranker as TRerank

    assert issubclass(t_errors.EmbedHTTPError, RuntimeError)
    assert not t_errors.is_device_fault(t_errors.EmbedHTTPError("x"))

    class Failing:
        def __init__(self, err):
            self.err = err

        def embed(self, text):
            raise self.err("POST http://127.0.0.1:9/api/embeddings failed")

    cands = [{"id": "a", "score": 0.5, "properties": {"content": "oslo capital"}},
             {"id": "b", "score": 0.4, "properties": {"content": "tea"}}]
    got = [R(embedder=Failing(E)).rerank("oslo capital", [dict(c) for c in cands], limit=2)
           for R, E in ((JRerank, JErr), (TRerank, t_errors.EmbedHTTPError))]
    assert got[1] == got[0] and [h["id"] for h in got[1]] == ["a", "b"]
    # a device fault in the same place fails the rerank (ROADMAP C29)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRerank(embedder=Failing(lambda m: RuntimeError("CUDA error: " + m))).rerank(
            "oslo capital", [dict(c) for c in cands], limit=2)


# -- JSON of device values -----------------------------------------------------


@pytest.mark.parametrize("value", [
    torch.tensor(0.1, dtype=torch.float32), torch.tensor(7), torch.tensor([1.5, 2.25]),
    torch.tensor([[1, 2]], dtype=torch.int32), torch.tensor(True)])
def test_json_of_torch_values_is_the_numpy_json(value):
    as_np = value.numpy()
    as_np = as_np[()] if as_np.ndim == 0 else as_np
    want = json.dumps({"v": as_np, "l": [as_np]}, default=j_http._json_default)
    got = json.dumps({"v": value, "l": [value]}, default=t_http._json_default)
    assert got == want
    if value.dtype != torch.bool:  # the reference's _jsonable leaves a numpy bool as is
        assert json.dumps(t_http._jsonable({"v": [value]})) == \
            json.dumps(j_http._jsonable({"v": [as_np]}))
    if value.ndim == 0 and value.dtype == torch.float32:
        assert json.loads(got)["v"] == float(as_np)

