"""CLI entrypoint: serve / version / import / export (counterpart of
``nornicdb_tpu/cli.py``; the same commands, flags and files).

Run as ``python -m nornicdb_tpu_torch.cli <command>``. ``serve`` opens the
DB and starts the HTTP server (MCP at ``/mcp``, GraphQL at ``/graphql``,
the Qdrant REST routes at ``/collections``) and the Bolt server over it;
``--grpc-port`` other than 0 also starts the gRPC server
(``api/grpc_server.py``: the native search and Qdrant services and the
official Qdrant ones, on ``grpc.aio``), behind a bearer token when
``--grpc-auth-token`` is given. ``--device`` names the device the DB runs
on and defaults to ``cuda``: without a card, ``serve``, ``import`` and
``export`` raise unless given ``--device cpu``. What the port has no
module for yet raises ``NotPortedError`` when asked (ROADMAP C38):
``--plugins-dir``, ``eval`` and ``oauth-provider``.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from typing import Any, Dict, List, Optional

from nornicdb_tpu_torch.errors import NotPortedError

VERSION = "0.1.0"
# command -> what it needs that the port does not have yet
NOT_PORTED = {
    "oauth-provider": "the OAuth provider (api/oauth_provider.py)",
    "eval": "the eval harness (eval.py)",
}


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nornicdb-tpu",
        description="TPU-native NornicDB-capability graph database",
    )
    sub = p.add_subparsers(dest="command")

    serve = sub.add_parser("serve", help="start the server")
    serve.add_argument("--data-dir", default=None,
                       help="persistent data directory (in-memory if unset)")
    serve.add_argument("--http-port", type=int, default=7474)
    serve.add_argument("--bolt-port", type=int, default=7687)
    serve.add_argument("--grpc-port", type=int, default=0,
                       help="gRPC port (0 = disabled)")
    serve.add_argument("--grpc-auth-token", default=None,
                       help="require this bearer token on every gRPC "
                            "call (parity with the REST surface's write "
                            "authorization)")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--database", default="neo4j")
    serve.add_argument("--plugins-dir", default=None)
    serve.add_argument("--ann-quality", default=None,
                       choices=["fast", "balanced", "accurate",
                                "compressed"])
    serve.add_argument("--device", default="cuda",
                       help="the device the DB runs on (cuda; cpu only "
                            "when asked)")

    sub.add_parser("version", help="print version")

    imp = sub.add_parser("import", help="import nodes/edges from JSONL")
    imp.add_argument("file")
    imp.add_argument("--data-dir", default=None)
    imp.add_argument("--database", default="neo4j")
    imp.add_argument("--device", default="cuda")

    exp = sub.add_parser("export", help="export the graph as JSONL")
    exp.add_argument("file")
    exp.add_argument("--data-dir", default=None)
    exp.add_argument("--database", default="neo4j")
    exp.add_argument("--device", default="cuda")

    # the commands whose modules come later (C38): their flags come with
    # them, and main() raises before it reads any
    for name, text in NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported yet: {text}")
    return p


def _open_db(data_dir: Optional[str], database: str = "neo4j",
             device: str = "cuda"):
    import nornicdb_tpu_torch

    return nornicdb_tpu_torch.open(data_dir, device=device, database=database)


def cmd_serve(args) -> int:
    import os

    # refused before anything opens (C38)
    if args.plugins_dir:
        raise NotPortedError("plugins (plugins.py) are not ported yet")
    if args.ann_quality:
        os.environ["NORNICDB_VECTOR_ANN_QUALITY"] = args.ann_quality
    db = _open_db(args.data_dir, args.database, args.device)
    from nornicdb_tpu_torch.api.bolt import BoltServer
    from nornicdb_tpu_torch.api.http_server import HttpServer

    http = HttpServer(db, host=args.host, port=args.http_port,
                      database_manager=db.multidb_manager()).start()
    bolt = BoltServer(db, host=args.host, port=args.bolt_port).start()
    grpc_srv = None
    if args.grpc_port:
        from nornicdb_tpu_torch.api.grpc_server import GrpcServer

        grpc_srv = GrpcServer(db, host=args.host, port=args.grpc_port,
                              auth_token=args.grpc_auth_token).start()
    print(f"nornicdb-tpu {VERSION}")
    print(f"  http  : http://{args.host}:{http.port}")
    print(f"  bolt  : bolt://{args.host}:{bolt.port}")
    if grpc_srv is not None:
        auth = " (bearer auth)" if args.grpc_auth_token else ""
        print(f"  grpc  : {grpc_srv.address} (aio){auth}")
    print(f"  data  : {args.data_dir or '(in-memory)'}")
    print(f"  device: {db.device}", flush=True)
    stop = threading.Event()

    def _sig(*_):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    stop.wait()
    print("shutting down")
    if grpc_srv is not None:
        grpc_srv.stop()
    bolt.stop()
    http.stop()
    db.close()
    return 0


def cmd_import(args) -> int:
    """JSONL rows: {"type": "node", "id", "labels", "properties",
    "embedding"} or {"type": "edge", "id", "start", "end", "edge_type",
    "properties"}."""
    from nornicdb_tpu_torch.storage.types import Edge, Node

    db = _open_db(args.data_dir, args.database, args.device)
    nodes = edges = 0
    try:
        with open(args.file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                from nornicdb_tpu_torch.query.temporal_types import decode_map

                row = json.loads(line, object_hook=decode_map)
                if row.get("type", "node") == "node":
                    db.storage.create_node(Node(
                        id=row["id"], labels=row.get("labels", []),
                        properties=row.get("properties", {}),
                        embedding=row.get("embedding")))
                    nodes += 1
                else:
                    db.storage.create_edge(Edge(
                        id=row["id"], start_node=row["start"],
                        end_node=row["end"],
                        type=row.get("edge_type", "RELATED"),
                        properties=row.get("properties", {})))
                    edges += 1
        print(f"imported {nodes} nodes, {edges} edges")
        return 0
    finally:
        db.close()


def cmd_export(args) -> int:
    db = _open_db(args.data_dir, args.database, args.device)
    from nornicdb_tpu_torch.query.temporal_types import encode_value

    def _default(v):
        # typed property values keep their tag; anything else becomes str
        try:
            return encode_value(v)
        except TypeError:
            return str(v)

    try:
        with open(args.file, "w", encoding="utf-8") as f:
            n = e = 0
            for node in db.storage.all_nodes():
                row: Dict[str, Any] = {
                    "type": "node", "id": node.id, "labels": node.labels,
                    "properties": node.properties,
                }
                if node.embedding is not None:
                    row["embedding"] = node.embedding
                f.write(json.dumps(row, default=_default) + "\n")
                n += 1
            for edge in db.storage.all_edges():
                f.write(json.dumps({
                    "type": "edge", "id": edge.id,
                    "start": edge.start_node, "end": edge.end_node,
                    "edge_type": edge.type,
                    "properties": edge.properties,
                }, default=_default) + "\n")
                e += 1
        print(f"exported {n} nodes, {e} edges")
        return 0
    finally:
        db.close()


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.command in NOT_PORTED:
        raise NotPortedError(f"{NOT_PORTED[args.command]} is not ported yet")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.command == "serve":
        return cmd_serve(args)
    if args.command == "version":
        print(f"nornicdb-tpu {VERSION}")
        return 0
    if args.command == "import":
        return cmd_import(args)
    if args.command == "export":
        return cmd_export(args)
    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
