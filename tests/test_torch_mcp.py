"""The port's MCP server (``nornicdb_tpu_torch/api/mcp.py``) and HTTP embedding
providers (``embed/http_providers.py``) against the JAX package's:
JSON-RPC ``initialize``, ``tools/list`` and every ``tools/call`` give the
reference's answers over DBs holding the same data; the Heimdall
``ToolLoop`` drives the ported server as the reference's drives its own;
``OllamaEmbedder`` and ``OpenAIEmbedder`` send the same payloads, headers
and retries to a stub HTTP server on localhost and raise the same errors.
Then the port's pin of ROADMAP C39: a device fault in a notification,
which has no reply to carry it, re-raises."""

import json
import threading
import types
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu.embed as j_embed
import nornicdb_tpu.heimdall as jh
import nornicdb_tpu_torch
import nornicdb_tpu_torch.embed as t_embed
import nornicdb_tpu_torch.heimdall as th
from nornicdb_tpu.api import mcp as j_mcp
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu_torch.api import mcp as t_mcp
from nornicdb_tpu_torch.embed.embedder import HashEmbedder

JAX = types.SimpleNamespace(name="jax", mcp=j_mcp, h=jh, embed=j_embed)
PORT = types.SimpleNamespace(name="port", mcp=t_mcp, h=th, embed=t_embed)

torch.set_num_threads(1)


def _open(side):
    if side is JAX:
        db = nornicdb_tpu.open(embedder=JHash())
    else:
        db = nornicdb_tpu_torch.open(device="cpu", embedder=HashEmbedder())
    for nid, text in [("oslo", "oslo is the capital of norway"),
                      ("bergen", "bergen is a rainy city in norway"),
                      ("tea", "green tea grows near kyoto")]:
        db.store(text, labels=["Fact"], node_id=nid)
    db.link("oslo", "bergen", "NEAR")
    db.flush()
    return db


@pytest.fixture
def servers():
    dbs = []
    try:
        for side in (JAX, PORT):
            dbs.append(_open(side))
        yield [side.mcp.McpServer(db) for side, db in zip((JAX, PORT), dbs)]
    finally:
        for db in dbs:
            db.close()


CALLS = [
    {"jsonrpc": "2.0", "id": 1, "method": "initialize"},
    {"jsonrpc": "2.0", "id": "s", "method": "ping"},
    {"jsonrpc": "2.0", "method": "notifications/initialized"},
    {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
    {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
        "name": "store", "arguments": {"content": "a fjord is a narrow inlet", "node_id": "fjord",
                                       "labels": ["Fact"], "properties": {"k": 1}}}},
    {"jsonrpc": "2.0", "id": 4, "method": "tools/call", "params": {
        "name": "recall", "arguments": {"query": "norway capital", "limit": 2}}},
    {"jsonrpc": "2.0", "id": 5, "method": "tools/call", "params": {
        "name": "link", "arguments": {"from_id": "fjord", "to_id": "bergen",
                                      "rel_type": "IN", "properties": {"w": 2}}}},
    {"jsonrpc": "2.0", "id": 6, "method": "tools/call", "params": {
        "name": "discover", "arguments": {"node_id": "oslo", "limit": 2}}},
    {"jsonrpc": "2.0", "id": 7, "method": "tools/call", "params": {
        "name": "discover", "arguments": {"node_id": "nope"}}},
    {"jsonrpc": "2.0", "id": 8, "method": "tools/call", "params": {
        "name": "task", "arguments": {"title": "write tests", "id": "t1"}}},
    {"jsonrpc": "2.0", "id": 9, "method": "tools/call", "params": {
        "name": "task", "arguments": {"title": "write tests", "id": "t1", "status": "done"}}},
    {"jsonrpc": "2.0", "id": 10, "method": "tools/call", "params": {
        "name": "task", "arguments": {"title": "review", "id": "t2"}}},
    {"jsonrpc": "2.0", "id": 11, "method": "tools/call", "params": {
        "name": "tasks", "arguments": {"status": "done"}}},
    {"jsonrpc": "2.0", "id": 12, "method": "tools/call", "params": {"name": "tasks"}},
    {"jsonrpc": "2.0", "id": 13, "method": "tools/call", "params": {
        "name": "cypher", "arguments": {"query": "MATCH (n:Fact) RETURN n.content ORDER BY n.content"}}},
    {"jsonrpc": "2.0", "id": 14, "method": "tools/call", "params": {
        "name": "cypher", "arguments": {"query": "MATCH (n {_id: $i}) RETURN n", "params": {"i": "oslo"}}}},
    {"jsonrpc": "2.0", "id": 15, "method": "tools/call", "params": {
        "name": "cypher", "arguments": {"query": "CREATE (n:Evil)"}}},
    {"jsonrpc": "2.0", "id": 16, "method": "tools/call", "params": {
        "name": "cypher", "arguments": {"query": "THIS IS NOT CYPHER"}}},
    {"jsonrpc": "2.0", "id": 17, "method": "tools/call", "params": {"name": "nope"}},
    {"jsonrpc": "2.0", "id": 18, "method": "bogus/method"},
    {"jsonrpc": "2.0", "method": "bogus/notification"},
    {"jsonrpc": "2.0", "method": "tools/call", "params": {"name": "nope"}},
]


def _uuid_free(v):
    """Generated edge ids (uuid4) blanked."""
    if isinstance(v, dict):
        return {k: ("<uuid>" if k == "id" and isinstance(x, str) and len(x) == 36
                    and x.count("-") == 4 else _uuid_free(x)) for k, x in v.items()}
    if isinstance(v, list):
        return [_uuid_free(x) for x in v]
    return v


def _norm(resp):
    """A response with the recall/discover scores rounded (the two
    packages' cosines agree to float32 rounding, not bit for bit) and
    generated edge ids blanked."""
    if resp is None or "result" not in resp or "content" not in resp.get("result", {}):
        return resp
    doc = json.loads(resp["result"]["content"][0]["text"])

    def rnd(v):
        if isinstance(v, dict):
            return {k: (round(x, 5) if k == "score" and isinstance(x, float) else rnd(x))
                    for k, x in v.items()}
        if isinstance(v, list):
            return [rnd(x) for x in v]
        return v

    out = dict(resp)
    out["result"] = dict(resp["result"], content=[{"type": "text", "text": _uuid_free(rnd(doc))}])
    return out


@pytest.mark.parametrize("i", range(len(CALLS)))
def test_jsonrpc_answers_match(servers, i):
    sj, st = servers
    for payload in CALLS[:i]:  # the calls before set up the state
        for srv in servers:
            srv.handle_jsonrpc(dict(payload))
            srv.db.flush()  # a stored memory is embedded before the next call
    j, t = sj.handle_jsonrpc(dict(CALLS[i])), st.handle_jsonrpc(dict(CALLS[i]))
    assert _norm(t) == _norm(j)
    if "id" not in CALLS[i]:
        assert t is None


def test_server_constants_and_tool_schemas_match(servers):
    assert t_mcp.PROTOCOL_VERSION == j_mcp.PROTOCOL_VERSION
    assert t_mcp.SERVER_INFO == j_mcp.SERVER_INFO
    assert servers[1]._tools == servers[0]._tools


def test_device_fault_in_a_notification_reraises(servers):
    st = servers[1]

    def boom(args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    st._handlers["store"] = boom
    note = {"jsonrpc": "2.0", "method": "tools/call",
            "params": {"name": "store", "arguments": {"content": "x"}}}
    with pytest.raises(RuntimeError, match="CUDA error"):
        st.handle_jsonrpc(note)
    # a request carries it in its answer, as the reference's does
    resp = st.handle_jsonrpc(dict(note, id=1))
    assert resp["error"]["code"] == -32603 and "CUDA error" in resp["error"]["message"]
    # a notification's other errors are swallowed, as the reference does
    st._handlers["store"] = lambda a: (_ for _ in ()).throw(ValueError("bad"))
    assert st.handle_jsonrpc(note) is None


# -- the Heimdall tool loop -----------------------------------------------------


_SCRIPT = [
    'TOOL {"tool": "store", "args": {"content": "note one about graphs", "node_id": "n1"}}',
    'TOOL {"tool": "recall", "args": {"query": "graphs note", "limit": 3}}',
    'TOOL {"tool": "link", "args": {"from_id": "n1", "to_id": "oslo"}}',
    'TOOL {"tool": "discover", "args": {"node_id": "n1"}}',
    'TOOL {"tool": "nope", "args": {}}',
    'TOOL {"tool": "cypher", "args": {"query": "MATCH (n) RETURN count(n)"}}',
    "all done",
]


def _tool_run(side):
    db = _open(side)
    try:
        mgr = side.h.Manager()
        mgr.bifrost = side.h.Bifrost()
        sub = mgr.bifrost.subscribe()
        mgr.register(side.h.ModelSpec(name="t", backend="echo", options={"replies": list(_SCRIPT)}))
        server = side.mcp.McpServer(db)
        store = server._handlers["store"]

        def store_then_flush(args):  # the memory is embedded before the next round
            out = store(args)
            db.flush()
            return out

        server._handlers["store"] = store_then_flush
        res = mgr.generate_with_tools("store then recall", server, model="t", max_rounds=8)
        events = [m["event"] for m in mgr.bifrost.events(sub, timeout=0.05)]
        calls = json.loads(json.dumps(res.tool_calls, default=str))
        for c in calls:  # scores: float32 rounding apart
            if c["tool"] in ("recall", "discover"):
                c["result"] = json.loads(json.dumps(c["result"]), parse_float=lambda x: round(float(x), 5))
        return res.text, _uuid_free(calls), events, db.storage.has_node("n1"), len(db.storage.get_node_edges("n1"))
    finally:
        db.close()


def test_tool_loop_drives_the_ported_server_as_the_reference():
    j, t = _tool_run(JAX), _tool_run(PORT)
    assert t == j
    text, calls, events, stored, n_edges = t
    assert text == "all done" and stored and n_edges == 1 and len(calls) == 6
    assert calls[1]["result"][0]["id"] == "n1"
    assert calls[4]["result"]["error"].startswith("unknown tool")
    assert events == ["tool_call"] * 6


# -- HTTP embedding providers against a local stub ------------------------------


@pytest.fixture(scope="module")
def stub():
    state = {"fail": 0, "status": 503, "seen": [], "reorder": False}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            state["seen"].append((self.path, body, self.headers.get("Authorization"),
                                  self.headers.get("Content-Type")))
            if state["fail"] > 0:
                state["fail"] -= 1
                self.send_response(state["status"])
                self.end_headers()
                self.wfile.write(b"upstream says no")
                return
            if self.path.endswith("/api/embeddings"):
                doc = {"embedding": [float(len(body["prompt"])), 0.5, -1.0]}
            elif self.path.endswith("/embeddings"):
                data = [{"index": i, "embedding": [float(len(x)), float(i)]}
                        for i, x in enumerate(body["input"])]
                doc = {"data": data[::-1] if state["reorder"] else data}
            elif self.path.endswith("/garbage"):
                raw = b"<html>proxy error</html>"
                self.send_response(200)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)
                return
            else:
                doc = {"nothing": True}
            raw = json.dumps(doc).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    th_ = threading.Thread(target=srv.serve_forever, daemon=True)
    th_.start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}", state
    finally:
        srv.shutdown()
        srv.server_close()


def _provider_run(side, url, state):
    e = side.embed
    out = []

    def attempt(fn):
        try:
            out.append(("ok", fn()))
        except e.EmbedHTTPError as exc:
            out.append(("err", str(exc).replace(url, "<url>")))

    state.update(fail=0, status=503, reorder=False)
    state["seen"].clear()
    ol = e.OllamaEmbedder(base_url=url + "/", model="nomic", timeout=5, retries=2)
    attempt(lambda: (ol.embed("hello"), ol.embed_batch(["a", "bb"]), ol.dims))
    state.update(fail=2)  # two 5xx, then an answer: retried
    attempt(lambda: ol.embed("retry me"))
    state.update(fail=3)  # past the retries
    attempt(lambda: ol.embed("give up"))
    state.update(fail=1, status=400)  # a 4xx is permanent
    attempt(lambda: ol.embed("bad model"))
    oa = e.OpenAIEmbedder(api_key="sk-1", base_url=url + "/v1", model="te3", timeout=5,
                          retries=1, batch_size=2)
    attempt(lambda: (oa.embed_batch(["x", "yy", "zzz"]), oa.dims, oa.embed("q")))
    state.update(reorder=True)
    attempt(lambda: oa.embed_batch(["p", "qq"]))
    state.update(reorder=False)
    bad = e.OpenAIEmbedder(base_url=url + "/none", model="m", timeout=5, retries=0)
    attempt(lambda: bad.embed("x"))
    garbage = e.OllamaEmbedder(base_url=url + "/garbage/x", timeout=5, retries=0)
    garbage.base_url = url + "/garbage"
    attempt(lambda: garbage.embed_batch([]))
    from importlib import import_module

    post = import_module(side.embed.__name__ + ".http_providers")._post_json
    attempt(lambda: post(url + "/garbage", {"a": 1}, retries=1, backoff_s=0.0))
    made = [type(e.make_http_embedder(p, base_url=url)).__name__ for p in ("ollama", "openai")]
    try:
        e.make_http_embedder("nope")
        made.append("no error")
    except ValueError as exc:
        made.append(str(exc))
    return out, [(p, b, a, c) for p, b, a, c in state["seen"]], made


def test_http_embedders_send_the_same_requests_and_retries(stub, monkeypatch):
    import time

    monkeypatch.setattr(time, "sleep", lambda s: None)  # the retries' backoff
    url, state = stub
    j = _provider_run(JAX, url, state)
    t = _provider_run(PORT, url, state)
    assert t == j
    out, seen, made = t
    assert out[0][1][0] == [5.0, 0.5, -1.0] and out[0][1][2] == 3
    assert out[1][0] == "ok" and out[2][0] == "err" and "HTTP 400" in out[3][1]
    assert seen[0][2] is None and any(a == "Bearer sk-1" for _, _, a, _ in seen)
    assert made[:2] == ["OllamaEmbedder", "OpenAIEmbedder"]


def test_embed_http_error_is_one_class_and_no_device_fault():
    from nornicdb_tpu_torch import errors
    from nornicdb_tpu_torch.embed import http_providers

    assert t_embed.EmbedHTTPError is http_providers.EmbedHTTPError is errors.EmbedHTTPError
    assert not errors.is_device_fault(errors.EmbedHTTPError("x"))
    assert errors.is_device_fault(RuntimeError("CUDA error"))
    assert {"OllamaEmbedder", "OpenAIEmbedder", "make_http_embedder", "EmbedHTTPError"} <= set(dir(t_embed))
