"""Agentic tool loop: the model drives MCP tools between generations (a
copy of ``nornicdb_tpu/heimdall/tools.py``).

The SLM emits tool invocations, the loop executes them against an MCP
server's handlers (any object with ``_tools`` and ``_handlers``: store,
recall, discover, link, cypher), and the results feed back into the
context until the model answers.

Protocol (prompted, model-agnostic): the model emits a line
``TOOL {"tool": "recall", "args": {"query": "..."}}``; anything else is
the final answer. Each round publishes a Bifrost event so UIs can
stream the agent's progress.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

_TOOL_RE = re.compile(r"^\s*TOOL\s+(\{.*\})\s*$", re.MULTILINE | re.DOTALL)

_SYSTEM = """You can call database tools. To call one, reply with a single
line: TOOL {"tool": "<name>", "args": {...}}
Available tools: %s
When you have the answer, reply with plain text (no TOOL line)."""


class ToolLoop:
    def __init__(self, generator, mcp, bifrost=None):
        self.generator = generator
        self.mcp = mcp
        self.bifrost = bifrost

    def _tool_names(self) -> List[str]:
        return sorted(self.mcp._tools.keys())

    def _execute(self, name: str, args: Dict[str, Any]) -> Any:
        handler = self.mcp._handlers.get(name)
        if handler is None:
            return {"error": f"unknown tool {name!r}"}
        try:
            return handler(args or {})
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def run(self, prompt: str, max_rounds: int = 4,
            max_tokens: int = 256) -> Tuple[str, List[Dict[str, Any]]]:
        context = (_SYSTEM % ", ".join(self._tool_names())
                   + f"\n\nuser: {prompt}\nassistant:")
        calls: List[Dict[str, Any]] = []
        text = ""
        for round_no in range(max_rounds):
            text = self.generator.generate(context, max_tokens=max_tokens)
            m = _TOOL_RE.search(text or "")
            if m is None:
                break
            try:
                req = json.loads(m.group(1))
            except json.JSONDecodeError:
                break  # malformed tool call: treat as final text
            name = req.get("tool", "")
            args = req.get("args") or {}
            result = self._execute(name, args)
            calls.append({"tool": name, "args": args, "result": result})
            if self.bifrost is not None:
                self.bifrost.publish("tool_call", {
                    "round": round_no, "tool": name, "args": args})
            context += (
                f" TOOL {json.dumps(req)}\n"
                f"tool_result: {json.dumps(result, default=str)[:2000]}\n"
                "assistant:"
            )
        return (text or "").strip(), calls
