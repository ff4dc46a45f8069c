"""OpenAPI 3 description of the HTTP surface + self-contained docs page
(counterpart of ``nornicdb_tpu/api/openapi.py``).

Reference: cmd/swagger-ui (serves interactive API docs for the server).
Zero-egress environment: instead of the CDN-loaded swagger bundle, the
docs page is a single self-contained HTML explorer rendered from
``/openapi.json`` with inline JavaScript — same capability (browse
endpoints, schemas, try-it-out via fetch), no external assets.
"""

from __future__ import annotations

import json
from typing import Any, Dict

from nornicdb_tpu_torch.api.http_server import API_VERSION


def openapi_spec() -> Dict[str, Any]:
    def op(summary, tag, request=None, response=None, params=None):
        out: Dict[str, Any] = {"summary": summary, "tags": [tag],
                               "responses": {"200": {
                                   "description": "OK",
                                   **({"content": {"application/json": {
                                       "schema": response}}}
                                      if response else {})}}}
        if request:
            out["requestBody"] = {"content": {"application/json": {
                "schema": request}}}
        if params:
            out["parameters"] = [
                {"name": n, "in": where, "schema": {"type": t},
                 "required": where == "path"}
                for n, where, t in params]
        return out

    obj = {"type": "object"}
    stmt_req = {"type": "object", "properties": {
        "statements": {"type": "array", "items": {
            "type": "object", "properties": {
                "statement": {"type": "string"},
                "parameters": obj}}}}}

    return {
        "openapi": "3.0.3",
        "info": {"title": "nornicdb-tpu HTTP API",
                 "version": API_VERSION,
                 "description": "Neo4j-compatible transaction API, REST "
                                "search, Qdrant-compatible REST, GraphQL, "
                                "MCP, and ops endpoints."},
        "paths": {
            "/health": {"get": op("Liveness probe", "ops")},
            "/readyz": {"get": op(
                "Readiness probe: 503 while index rebuilds are pending, "
                "changelogs near overrun, or batching queues saturated",
                "ops", response={"type": "object", "properties": {
                    "status": {"type": "string",
                               "enum": ["ready", "degraded"]},
                    "reasons": {"type": "array",
                                "items": {"type": "string"}},
                    "checks": {"type": "object"}}})},
            "/status": {"get": op("Server status + search stats", "ops")},
            "/metrics": {"get": op("Prometheus metrics", "ops")},
            "/admin/slo": {"get": op(
                "SLO budgets + multi-window burn rates per surface "
                "(admin)", "ops", response={"type": "object"})},
            "/admin/degrades": {"get": op(
                "Unified degrade ledger: structured (from_tier, "
                "to_tier, reason, versions) records of every serving "
                "ladder step-down, newest first (admin)", "ops",
                response={"type": "object", "properties": {
                    "recorded": {"type": "integer"},
                    "capacity": {"type": "integer"},
                    "by_reason": {"type": "object"},
                    "degrades": {"type": "array",
                                 "items": {"type": "object"}}}})},
            "/admin/events": {"get": op(
                "Unified incident timeline: causally-ordered, "
                "trace-id-linked degrade/drain/admit/failover/"
                "quarantine/SLO-breach events (admin)", "ops",
                response={"type": "object", "properties": {
                    "recorded": {"type": "integer"},
                    "capacity": {"type": "integer"},
                    "by_kind": {"type": "object"},
                    "events": {"type": "array",
                               "items": {"type": "object"}}}})},
            "/admin/scheduler": {"get": op(
                "Admission-control actuator state: per-lane in-flight "
                "depth + drain rates, deadline-miss counters, shed "
                "totals and the current admission posture (admin)",
                "ops",
                response={"type": "object", "properties": {
                    "posture": {"type": "string",
                                "enum": ["admit", "degrade", "shed",
                                         "shed_hard"]},
                    "lanes": {"type": "object"},
                    "deadline": {"type": "object"},
                    "shed": {"type": "object"},
                    "limits": {"type": "object"}}})},
            "/admin/fleet": {"get": op(
                "Fleet telemetry aggregator: merged worker/plane/"
                "replica registries — per-node lag (ops AND "
                "apply-delay seconds), tier mix, failovers, source "
                "health (admin)", "ops",
                response={"type": "object", "properties": {
                    "sources": {"type": "object"},
                    "workers": {"type": "number"},
                    "replicas": {"type": "object"},
                    "failovers": {"type": "object"},
                    "tiers": {"type": "object"},
                    "events": {"type": "object"}}})},
            "/openapi.json": {"get": op("This document", "ops")},
            "/debug/profile": {"post": op(
                "Profile one Cypher statement (admin)", "ops",
                request={"type": "object", "properties": {
                    "statement": {"type": "string"},
                    "parameters": {"type": "object"},
                    "repeat": {"type": "integer"}}},
                response={"type": "object"})},
            "/auth/login": {"post": op(
                "Exchange credentials for a JWT", "auth",
                request={"type": "object", "properties": {
                    "username": {"type": "string"},
                    "password": {"type": "string"}}},
                response={"type": "object", "properties": {
                    "token": {"type": "string"}}})},
            "/db/{database}/tx/commit": {"post": op(
                "Run Cypher statements in an auto-commit transaction",
                "cypher", request=stmt_req, response=obj,
                params=[("database", "path", "string")])},
            "/db/{database}/tx": {"post": op(
                "Open an explicit transaction", "cypher",
                request=stmt_req, params=[("database", "path",
                                           "string")])},
            "/nornicdb/search": {"post": op(
                "Hybrid search (BM25 + vector + weighted RRF; "
                "device-fused pipeline on large corpora)", "search",
                request={"type": "object", "properties": {
                    "query": {"type": "string"},
                    "limit": {"type": "integer"},
                    "mode": {"type": "string",
                             "enum": ["hybrid", "text", "vector"]},
                    "weights": {
                        "type": "array", "minItems": 2, "maxItems": 2,
                        "items": {"type": "number"},
                        "description": "[lexical, vector] RRF weights"}}},
                response=obj)},
            "/nornicdb/store": {"post": op(
                "Store content (auto-embeds via the queue)", "search",
                request={"type": "object", "properties": {
                    "content": {"type": "string"},
                    "labels": {"type": "array",
                               "items": {"type": "string"}},
                    "properties": obj}},
                response=obj)},
            "/nornicdb/similar": {"post": op(
                "Find nodes similar to an existing node", "search",
                request={"type": "object", "properties": {
                    "node_id": {"type": "string"},
                    "limit": {"type": "integer"}}},
                response=obj)},
            "/nornicdb/graph_search": {"post": op(
                "Fused graph+vector query: expand 1-2 relationship "
                "hops from the anchor, rank the distinct frontier by "
                "cosine similarity (one device dispatch when the graph "
                "plane is enabled)", "search",
                request={"type": "object", "properties": {
                    "anchor_id": {"type": "string"},
                    "hops": {"type": "array", "minItems": 1,
                             "maxItems": 2, "items": {},
                             "description": "relationship types; a "
                             "string means outgoing, [type, 'in'|'out'] "
                             "sets direction"},
                    "vector": {"type": "array",
                               "items": {"type": "number"}},
                    "limit": {"type": "integer"}}},
                response=obj)},
            "/graphql": {"post": op("GraphQL endpoint", "graphql",
                                    request=obj, response=obj)},
            "/mcp": {"post": op("Model Context Protocol endpoint", "mcp",
                                request=obj, response=obj)},
            "/v1/chat/completions": {"post": op(
                "Heimdall chat completions (OpenAI-compatible)",
                "heimdall", request=obj, response=obj)},
            "/collections/{name}/points": {"put": op(
                "Qdrant-compatible point upsert", "qdrant", request=obj,
                params=[("name", "path", "string")])},
            "/collections/{name}/points/search": {"post": op(
                "Qdrant-compatible vector search", "qdrant",
                request=obj, params=[("name", "path", "string")])},
            "/nornicdb/gdpr/export": {"post": op(
                "GDPR subject data export by property match", "gdpr",
                request={"type": "object", "properties": {
                    "property": {"type": "string"},
                    "value": {}}},
                response=obj)},
        },
    }


def docs_page() -> str:
    """Single-file API explorer (no external assets)."""
    spec = json.dumps(openapi_spec())
    return """<!doctype html><html><head><meta charset="utf-8">
<title>nornicdb-tpu API</title><style>
body{font-family:system-ui,sans-serif;margin:0;background:#f7f7f9;color:#1b1b20}
header{background:#20222b;color:#fff;padding:14px 24px;font-size:18px}
main{max-width:960px;margin:24px auto;padding:0 16px}
.ep{background:#fff;border:1px solid #e2e2ea;border-radius:8px;margin:10px 0;overflow:hidden}
.ep>summary{padding:10px 14px;cursor:pointer;display:flex;gap:12px;align-items:center}
.m{font-weight:700;border-radius:4px;padding:2px 10px;color:#fff;font-size:12px;min-width:44px;text-align:center}
.get{background:#2f7d4f}.post{background:#2456a8}.put{background:#9a6b1f}.delete{background:#a83232}
.body{padding:0 14px 14px}.tag{color:#666;font-size:12px;margin-left:auto}
pre{background:#f1f1f6;padding:10px;border-radius:6px;overflow:auto;font-size:12px}
button{background:#20222b;color:#fff;border:0;border-radius:5px;padding:6px 14px;cursor:pointer}
textarea{width:100%;min-height:70px;font-family:monospace;font-size:12px}
</style></head><body><header>nornicdb-tpu HTTP API</header><main id="eps"></main>
<script>
const SPEC = SPEC_JSON;
const root = document.getElementById('eps');
for (const [path, methods] of Object.entries(SPEC.paths)) {
  for (const [method, op] of Object.entries(methods)) {
    const d = document.createElement('details'); d.className = 'ep';
    const hasBody = !!op.requestBody;
    d.innerHTML = `<summary><span class="m ${method}">${method.toUpperCase()}</span>`
      + `<code>${path}</code><span>${op.summary||''}</span>`
      + `<span class="tag">${(op.tags||[]).join(', ')}</span></summary>`
      + `<div class="body">`
      + (hasBody ? `<p>Request schema:</p><pre>${JSON.stringify(op.requestBody.content['application/json'].schema, null, 2)}</pre>`
                   + `<textarea placeholder='{"statements": []}'></textarea><br>` : '')
      + `<button>Try it</button><pre class="out">(no response yet)</pre></div>`;
    d.querySelector('button').onclick = async () => {
      const out = d.querySelector('.out');
      const ta = d.querySelector('textarea');
      try {
        const res = await fetch(path.replaceAll(/\\{[^}]+\\}/g, 'neo4j'), {
          method: method.toUpperCase(),
          headers: {'Content-Type': 'application/json'},
          body: hasBody ? (ta && ta.value || '{}') : undefined});
        const text = await res.text();
        out.textContent = res.status + '\\n' + text.slice(0, 4000);
      } catch (e) { out.textContent = 'error: ' + e; }
    };
    root.appendChild(d);
  }
}
</script></body></html>""".replace("SPEC_JSON", spec)
