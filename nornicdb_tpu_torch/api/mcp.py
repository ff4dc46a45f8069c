"""Model Context Protocol (MCP) server, streamable HTTP transport
(counterpart of ``nornicdb_tpu/api/mcp.py``; the same tools and
JSON-RPC answers).

JSON-RPC 2.0 with the tools ``store``, ``recall``, ``discover``,
``link``, ``task``, ``tasks`` and ``cypher``. The handler is
transport-agnostic (``handle_jsonrpc``) and is mounted on the HTTP server
at ``/mcp``; initialize/list/call follow the 2024-11-05 MCP revision. A
request's error is answered (-32603 for any exception, a device fault
among them); a notification's error, which the reference swallows, is
re-raised when it is a device fault (ROADMAP C39).
"""

from __future__ import annotations

import json
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

from nornicdb_tpu_torch.errors import is_device_fault

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "nornicdb-tpu", "version": "1.0"}


class McpError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class McpServer:
    """JSON-RPC MCP server over one DB."""

    def __init__(self, db):
        self.db = db
        self._tasks: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._tools: Dict[str, Dict[str, Any]] = {}
        self._handlers: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
        self._register_tools()

    # -- tool registry (reference: tools.go:87-363) ----------------------

    def _register_tools(self) -> None:
        self._add_tool(
            "store",
            "Store a memory with optional labels and properties.",
            {"type": "object", "properties": {
                "content": {"type": "string"},
                "labels": {"type": "array", "items": {"type": "string"}},
                "properties": {"type": "object"},
                "node_id": {"type": "string"},
            }, "required": ["content"]},
            self._tool_store,
        )
        self._add_tool(
            "recall",
            "Hybrid search over stored memories.",
            {"type": "object", "properties": {
                "query": {"type": "string"},
                "limit": {"type": "integer", "default": 10},
            }, "required": ["query"]},
            self._tool_recall,
        )
        self._add_tool(
            "discover",
            "Explore the neighborhood of a node: its relationships and similar nodes.",
            {"type": "object", "properties": {
                "node_id": {"type": "string"},
                "limit": {"type": "integer", "default": 10},
            }, "required": ["node_id"]},
            self._tool_discover,
        )
        self._add_tool(
            "link",
            "Create a relationship between two nodes.",
            {"type": "object", "properties": {
                "from_id": {"type": "string"},
                "to_id": {"type": "string"},
                "rel_type": {"type": "string", "default": "RELATES_TO"},
                "properties": {"type": "object"},
            }, "required": ["from_id", "to_id"]},
            self._tool_link,
        )
        self._add_tool(
            "task",
            "Create or update a task memory (status: open|done).",
            {"type": "object", "properties": {
                "title": {"type": "string"},
                "id": {"type": "string"},
                "status": {"type": "string", "enum": ["open", "done"]},
            }, "required": ["title"]},
            self._tool_task,
        )
        self._add_tool(
            "tasks",
            "List task memories, optionally filtered by status.",
            {"type": "object", "properties": {
                "status": {"type": "string", "enum": ["open", "done"]},
            }},
            self._tool_tasks,
        )
        self._add_tool(
            "cypher",
            "Run a read-only Cypher query.",
            {"type": "object", "properties": {
                "query": {"type": "string"},
                "params": {"type": "object"},
            }, "required": ["query"]},
            self._tool_cypher,
        )

    def _add_tool(self, name: str, description: str, schema: Dict[str, Any],
                  handler: Callable[[Dict[str, Any]], Any]) -> None:
        self._tools[name] = {"name": name, "description": description,
                             "inputSchema": schema}
        self._handlers[name] = handler

    # -- tool implementations --------------------------------------------

    def _tool_store(self, args: Dict[str, Any]) -> Dict[str, Any]:
        node = self.db.store(
            args.get("content", ""),
            labels=args.get("labels"),
            properties=args.get("properties"),
            node_id=args.get("node_id"),
        )
        return {"id": node.id, "labels": node.labels}

    def _tool_recall(self, args: Dict[str, Any]) -> List[Dict[str, Any]]:
        hits = self.db.recall(args.get("query", ""),
                              limit=int(args.get("limit", 10)))
        out = []
        for h in hits:
            d = {"id": h.get("id"), "score": h.get("score")}
            props = h.get("properties") or {}
            if props:
                d["content"] = props.get("content")
            if h.get("labels"):
                d["labels"] = h["labels"]
            out.append(d)
        return out

    def _tool_discover(self, args: Dict[str, Any]) -> Dict[str, Any]:
        node_id = args.get("node_id", "")
        limit = int(args.get("limit", 10))
        try:
            node = self.db.storage.get_node(node_id)
        except KeyError:
            raise McpError(-32602, f"node not found: {node_id}")
        edges = self.db.storage.get_node_edges(node_id)[:limit]
        similar = self.db.search.similar(node_id, limit=limit)
        return {
            "node": {"id": node.id, "labels": node.labels,
                     "properties": node.properties},
            "relationships": [
                {"id": e.id, "type": e.type, "start": e.start_node,
                 "end": e.end_node} for e in edges],
            "similar": [{"id": s.get("id"), "score": s.get("score")}
                        for s in similar],
        }

    def _tool_link(self, args: Dict[str, Any]) -> Dict[str, Any]:
        edge = self.db.link(
            args.get("from_id", ""), args.get("to_id", ""),
            rel_type=args.get("rel_type", "RELATES_TO"),
            properties=args.get("properties"),
        )
        return {"id": edge.id, "type": edge.type}

    def _tool_task(self, args: Dict[str, Any]) -> Dict[str, Any]:
        task_id = args.get("id") or f"task-{uuid.uuid4().hex[:8]}"
        status = args.get("status", "open")
        try:
            node = self.db.storage.get_node(task_id)
            node.properties["status"] = status
            node.properties["title"] = args.get("title", node.properties.get("title"))
            self.db.storage.update_node(node)
        except KeyError:
            self.db.store(args.get("title", ""), labels=["Task"],
                          properties={"title": args.get("title", ""),
                                      "status": status},
                          node_id=task_id)
        return {"id": task_id, "status": status}

    def _tool_tasks(self, args: Dict[str, Any]) -> List[Dict[str, Any]]:
        status = args.get("status")
        out = []
        for node in self.db.storage.get_nodes_by_label("Task"):
            if status and node.properties.get("status") != status:
                continue
            out.append({"id": node.id,
                        "title": node.properties.get("title"),
                        "status": node.properties.get("status")})
        return out

    def _tool_cypher(self, args: Dict[str, Any]) -> Dict[str, Any]:
        query = args.get("query", "")
        from nornicdb_tpu_torch.api.http_server import _is_write, _jsonable

        if _is_write(query):
            raise McpError(-32602, "only read-only Cypher is allowed here")
        r = self.db.cypher(query, args.get("params") or {})
        return {"columns": r.columns,
                "rows": [[_jsonable(v) for v in row] for row in r.rows]}

    # -- JSON-RPC dispatch -----------------------------------------------

    def handle_jsonrpc(self, payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Handle one JSON-RPC request; returns the response (None for
        notifications)."""
        req_id = payload.get("id")
        method = payload.get("method", "")
        params = payload.get("params") or {}
        is_notification = "id" not in payload
        try:
            result = self._dispatch(method, params)
        except McpError as e:
            if is_notification:
                return None
            return {"jsonrpc": "2.0", "id": req_id,
                    "error": {"code": e.code, "message": e.message}}
        except Exception as e:  # noqa: BLE001 — protocol boundary
            if is_notification:
                if is_device_fault(e):
                    raise  # no reply would carry it (C39)
                return None
            return {"jsonrpc": "2.0", "id": req_id,
                    "error": {"code": -32603, "message": str(e)}}
        if is_notification:
            return None
        return {"jsonrpc": "2.0", "id": req_id, "result": result}

    def _dispatch(self, method: str, params: Dict[str, Any]) -> Any:
        if method == "initialize":
            return {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {"tools": {}},
                "serverInfo": SERVER_INFO,
            }
        if method in ("notifications/initialized", "initialized"):
            return {}
        if method == "ping":
            return {}
        if method == "tools/list":
            return {"tools": list(self._tools.values())}
        if method == "tools/call":
            name = params.get("name", "")
            handler = self._handlers.get(name)
            if handler is None:
                raise McpError(-32601, f"unknown tool: {name}")
            result = handler(params.get("arguments") or {})
            return {"content": [{"type": "text",
                                 "text": json.dumps(result, default=str)}],
                    "isError": False}
        raise McpError(-32601, f"method not found: {method}")
