"""API surfaces around one DB: HTTP (with MCP at ``/mcp``) and Bolt
(counterpart of ``nornicdb_tpu/api``). GraphQL, the Qdrant surfaces and
gRPC are not ported yet (ROADMAP C38).
"""
