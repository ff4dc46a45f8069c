"""The port's GraphQL API (``api/graphql.py``) against the JAX package's:
the documents of ``tests/test_graphql.py`` and more of the schema go to
both packages' ``GraphQLAPI`` over DBs holding the same data (the port on
``device="cpu"``), and ``data`` and ``errors`` come back equal. Node ids a
mutation draws from ``uuid4`` are mapped side to side; ``search`` and
``similar`` scores, which each package's vector tier sums in its own
order, agree within ``SCORE_ATOL`` with ids tie-aware, and the port's
equal its own ``db.search`` on the same arguments. Over HTTP: the
playground, ``POST /graphql`` and its response-bytes cache (a repeated
query is served from the cache until a write through any surface). Then
the port's pin: where the reference's resolvers swallow an error into
``null`` or ``false``, a device fault is answered as an error (C42)."""

import gc
import json

import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.api import graphql as jg
from nornicdb_tpu.api import http_server as j_http
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu_torch.api import graphql as tg
from nornicdb_tpu_torch.api import http_server as t_http
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from test_torch_http import request

torch.set_num_threads(1)

SCORE_ATOL = 1e-5

# tests/test_graphql.py's graph, with fixed ids (Cypher would draw uuid4s)
SEED_NODES = [("alice", ["Person"], {"name": "Alice", "age": 30}),
              ("bob", ["Person"], {"name": "Bob", "age": 25}),
              ("initech", ["Company"], {"name": "Initech"})]
SEED_EDGES = [("w1", "alice", "initech", "WORKS_AT", {"since": 2020}),
              ("w2", "bob", "initech", "WORKS_AT", {"since": 2021}),
              ("k1", "alice", "bob", "KNOWS", {})]

MEMORIES = [("m1", "oslo is the capital of norway"),
            ("m2", "bergen is a rainy city in norway"),
            ("m3", "kyoto was the imperial capital of japan"),
            ("m4", "green tea grows near kyoto"),
            ("m5", "graph databases store nodes and relationships")]


def _open(side):
    if side == "jax":
        from nornicdb_tpu.storage.types import Edge, Node

        db = nornicdb_tpu.open(embedder=JHash())
    else:
        from nornicdb_tpu_torch.storage.types import Edge, Node

        db = nornicdb_tpu_torch.open(device="cpu", embedder=THash())
    for nid, labels, props in SEED_NODES:
        db.storage.create_node(Node(id=nid, labels=labels, properties=props))
    for eid, a, b, kind, props in SEED_EDGES:
        db.storage.create_edge(Edge(id=eid, start_node=a, end_node=b, type=kind,
                                    properties=props))
    for nid, text in MEMORIES:
        db.store(text, labels=["Memory"], node_id=nid)
    db.flush()
    return db


@pytest.fixture(autouse=True)
def _collect_cycles():
    """The resource registries hold objects weakly, and a Qdrant layer's
    batchers close over it: collect the cycles a test leaves, so later
    tests' readiness counts see only their own structures."""
    yield
    gc.collect()


@pytest.fixture
def apis():
    dbs = [_open("jax"), _open("port")]
    yield jg.GraphQLAPI(dbs[0]), tg.GraphQLAPI(dbs[1])
    for db in dbs:
        db.close()


# the documents of tests/test_graphql.py, in its order, then more of the schema
DOCS = [
    ("{ nodeCount relationshipCount }", None),
    ("""{ nodesByLabel(label: "Person") { id properties
          relationships(direction: OUTGOING, type: "WORKS_AT") {
            type properties endNode { properties } } } }""", None),
    ("""query People($lbl: String!) { folks: nodesByLabel(label: $lbl) { id __typename } }""",
     {"lbl": "Person"}),
    ("""query Q($yes: Boolean = true) { nodeCount @include(if: $yes)
          relationshipCount @skip(if: $yes) }""", None),
    ("""{ cypher(query: "MATCH (p:Person) RETURN p.name ORDER BY p.name") { columns rows } }""",
     None),
    ("{ bogusField }", None),
    # before any node with a uuid4 id exists (allNodes orders by id)
    ("""query GetStuff($n: Int = 3) { allNodes(limit: $n) { id ...Props } }
        fragment Props on Node { labels properties }""", None),
    ("""{ allNodes(label: "Memory", limit: 2, offset: 1) { id ... on Node { labels } } }""",
     None),
    ("""mutation { createNode(input: {labels: ["City"], properties: {name: "Oslo"}}) {
          id labels } }""", None),
    ("""mutation Up($id: ID!) { updateNode(id: $id, input: {properties: {pop: 700000}}) {
          properties } }""", {"id": "<created>"}),
    ("mutation D($id: ID!) { deleteNode(id: $id) }", {"id": "<created>"}),
    ("""mutation { a: createNode(input: {id: "x1", labels: ["T"]}) { id }
          b: createNode(input: {id: "x2", labels: ["T"]}) { id } }""", None),
    ("""mutation { createRelationship(input: {startNodeId: "x1", endNodeId: "x2",
          type: "LINKS"}) { type startNodeId endNodeId } }""", None),
    ("""mutation { bulkCreateNodes(input: [{id: "b1", labels: ["B"]}, {id: "b2", labels: ["B"]}])
          { id } mergeNode(input: {id: "b1", properties: {seen: true}}) { properties }
          bulkDeleteNodes(ids: ["b2"]) }""", None),
    ('{ cypher(query: "CREATE (n:Pwned)") { rows } }', None),
    ('{ cypher(query: "MATCH (n:Pwned) RETURN count(n)") { rows } }', None),
    ('mutation { executeCypher(query: "CREATE (n:Ok)") { nodesCreated } }', None),
    ('mutation { createNode(input: {id: "café", labels: ["T"], '
     'properties: {name: "Žižek \\u00e9"}}) { id properties } }', None),
    ('{ node(id: "café") { id } }', None),
    ('{ node(id: "missing") { id } }', None),
    ("{ labels relationshipTypes stats { nodeCount relationshipCount labels } }", None),
    ('{ searchByProperty(property: "name", value: "Alice") { id properties } }', None),
    ('{ neighborhood(id: "x1", depth: 2) { nodes { id } relationships { type } } }', None),
    ("""{ p: shortestPath(startId: "x1", endId: "x2") { length nodes { id } }
          a: allPaths(startId: "x1", endId: "x2") { length } }""", None),
    ('mutation { deleteRelationship(id: "nope") }', None),
    ('mutation { bulkDeleteRelationships(ids: ["nope", "nada"]) }', None),
    ('mutation { clearAll }', None),
    ("query A { nodeCount } query B { relationshipCount }", None),
    ("query { node( }", None),
]


def _run(api, query, variables, created):
    if variables:
        variables = {k: (created if v == "<created>" else v) for k, v in variables.items()}
    return api.execute(query, variables)


def test_documents_answer_as_jax(apis):
    created = [None, None]
    for query, variables in DOCS:
        outs = [_run(api, query, variables, created[i]) for i, api in enumerate(apis)]
        data = [o.get("data") or {} for o in outs]
        for i, d in enumerate(data):
            if "createNode" in d and isinstance(d["createNode"], dict) \
                    and d["createNode"].get("labels") == ["City"]:
                created[i] = d["createNode"]["id"]
        if created[0] and created[1]:
            outs[1] = json.loads(json.dumps(outs[1]).replace(created[1], created[0]))
        assert outs[1] == outs[0], query


def test_operation_name_and_kind_match_jax(apis):
    multi = "query A { nodeCount } mutation B { deleteNode(id: \"m5\") } query C { labels }"
    for name in ("A", "C", "nope", None):
        assert apis[1].execute(multi, operation_name=name) == \
            apis[0].execute(multi, operation_name=name)
    for doc, name in (("# c\nmutation { deleteNode(id: \"x\") }", None), (multi, "B"),
                      (multi, "A"), ("{ nodeCount }", None)):
        assert tg.GraphQLAPI.operation_kind(doc, name) == jg.GraphQLAPI.operation_kind(doc, name)
    for bad in ("query { node( }", "{ a } }", 'mutation M($x: Int = ) { a }'):
        with pytest.raises(tg.GraphQLError) as t_exc:
            tg._Parser(bad).parse_document()
        with pytest.raises(jg.GraphQLError) as j_exc:
            jg._Parser(bad).parse_document()
        assert str(t_exc.value) == str(j_exc.value)
    doc = """query GetStuff($n: Int = 5, $s: [String!] = ["a", "b"]) {
        allNodes(limit: $n) { id ...Props } x: node(id: "1") @skip(if: false) { id } }
        fragment Props on Node { labels properties }"""
    assert tg._Parser(doc).parse_document() == jg._Parser(doc).parse_document()


def _hits_close(j, t):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert abs(a["score"] - b["score"]) <= SCORE_ATOL
        if a["node"]["id"] != b["node"]["id"]:
            assert any(h["node"]["id"] == b["node"]["id"] and
                       abs(h["score"] - a["score"]) <= 2 * SCORE_ATOL for h in j)


@pytest.mark.parametrize("query", ["capital city", "kyoto tea", "graph nodes"])
def test_search_and_similar_answer_as_jax_and_as_the_port_s_db(apis, query):
    doc = """query S($q: String!, $id: ID!) {
        search(query: $q, limit: 4) { score bm25Score vectorScore node { id labels } }
        similar(id: $id, limit: 3) { score node { id } } }"""
    outs = [api.execute(doc, {"q": query, "id": "m3"}) for api in apis]
    assert "errors" not in outs[0] and "errors" not in outs[1]
    for field in ("search", "similar"):
        _hits_close(outs[0]["data"][field], outs[1]["data"][field])
    db = apis[1].db
    direct = db.search.search(query=query, limit=4)
    assert [h["node"]["id"] for h in outs[1]["data"]["search"]] == [r["id"] for r in direct]
    assert [h["score"] for h in outs[1]["data"]["search"]] == [r["score"] for r in direct]
    similar = db.search.similar("m3", limit=3)
    assert [h["node"]["id"] for h in outs[1]["data"]["similar"]] == [r["id"] for r in similar]


@pytest.fixture
def servers():
    dbs = [_open("jax"), _open("port")]
    srvs = [j_http.HttpServer(dbs[0], port=0).start(), t_http.HttpServer(dbs[1], port=0).start()]
    yield dbs, srvs
    for s in srvs:
        s.stop()
    for db in dbs:
        db.close()


def test_playground_and_post_over_http_match_jax(servers):
    dbs, srvs = servers
    (sj, bj, hj), (st, bt, ht) = [request(s.port, "/graphql") for s in srvs]
    assert (st, bt) == (sj, bj) and ht["Content-Type"].startswith("text/html")
    assert bt == tg.PLAYGROUND_HTML == jg.PLAYGROUND_HTML
    for body in ({"query": "{ nodeCount }"}, {"query": "{ bogus }"},
                 {"query": "query A { nodeCount } query B { labels }", "operationName": "B"},
                 {"query": "{ node( }"},
                 {"query": 'mutation { createNode(input: {id: "h1"}) { id } }'}):
        (sj, bj, _), (st, bt, _) = [request(s.port, "/graphql", "POST", body) for s in srvs]
        assert (st, bt) == (sj, bj), body


def test_response_bytes_cache_serves_repeats_until_a_write(servers, monkeypatch):
    dbs, srvs = servers
    body = {"query": "{ nodeCount }"}
    calls = [0, 0]
    for i, (srv, mod) in enumerate(zip(srvs, (jg, tg))):
        real = srv.graphql.execute

        def counted(*a, _i=i, _real=real, **k):
            calls[_i] += 1
            return _real(*a, **k)

        monkeypatch.setattr(srv.graphql, "execute", counted)
    first = [request(s.port, "/graphql", "POST", body)[1] for s in srvs]
    again = [request(s.port, "/graphql", "POST", body)[1] for s in srvs]
    assert first == again and first[0] == first[1] and calls == [1, 1]
    for db in dbs:  # a write through another surface invalidates
        db.cypher("CREATE (:Fresh)")
    after = [request(s.port, "/graphql", "POST", body)[1] for s in srvs]
    assert after[0] == after[1] and after[1]["data"]["nodeCount"] == \
        first[1]["data"]["nodeCount"] + 1 and calls == [2, 2]
    mutation = {"query": 'mutation { deleteNode(id: "m1") }'}
    for _ in range(2):  # mutations are never cached
        assert [request(s.port, "/graphql", "POST", mutation)[1] for s in srvs][1] is not None
    assert calls == [4, 4]


def test_a_device_fault_in_a_swallowing_resolver_is_answered(apis, monkeypatch):
    """C42: ``node`` answers null and ``deleteNode`` false on any error in
    the reference; the port answers a device fault as a GraphQL error and
    keeps the reference's answer for any other error."""
    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    for api in apis:
        monkeypatch.setattr(api.db.storage, "get_node", boom)
        monkeypatch.setattr(api.db.storage, "delete_node", boom)
    doc = 'mutation { deleteNode(id: "m1") }'
    assert apis[0].execute('{ node(id: "m1") { id } }') == {"data": {"node": None}}
    assert apis[0].execute(doc) == {"data": {"deleteNode": False}}
    for q in ('{ node(id: "m1") { id } }', doc):
        out = apis[1].execute(q)
        assert out["data"] is None and "CUDA error" in out["errors"][0]["message"]

    def not_found(*a, **k):
        raise KeyError("m1")

    monkeypatch.setattr(apis[1].db.storage, "delete_node", not_found)
    assert apis[1].execute(doc) == {"data": {"deleteNode": False}}
