"""The port's command line (``nornicdb_tpu_torch/cli.py``) against the JAX
package's: ``serve --device cpu`` in a subprocess answers ``/health``, a
transaction commit and a search over HTTP and Bolt, and with
``--grpc-port`` the gRPC server behind its bearer token; ``serve`` without
``--device`` and without a card raises; the commands the port has no
module for yet raise ``NotPortedError`` (ROADMAP C38); and the files that
``import`` reads and ``export`` writes are the reference CLI's. Every
subprocess is stopped in a ``finally`` and every client has a timeout."""

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from nornicdb_tpu import cli as j_cli
from nornicdb_tpu_torch import cli as t_cli
from nornicdb_tpu_torch.errors import NotPortedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(port, path, body):
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                               method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _serve(args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"NORNICDB_TPU_EMBEDDER": "hash", **(env_extra or {})})
    return subprocess.Popen(
        [sys.executable, "-m", "nornicdb_tpu_torch.cli", "serve", "--http-port", "0",
         "--bolt-port", "0", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _ports(proc, timeout_s=240.0):
    """The http and bolt ports the server printed, once it is up."""
    ports, t0 = {}, time.time()
    while time.time() - t0 < timeout_s:
        line = proc.stdout.readline()
        if not line:
            break
        for name in ("http", "bolt", "grpc"):
            if line.strip().startswith(f"{name} ") and ":" in line:
                ports[name] = int(line.rsplit(":", 1)[1].split()[0])
        if line.strip().startswith("device"):
            return ports, line.split(":", 1)[1].strip()
    raise AssertionError(f"the server did not come up: {proc.stderr.read()[-2000:]}")


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _bolt_count(port):
    from nornicdb_tpu_torch.api.bolt import (BOLT_MAGIC, MSG_HELLO, MSG_PULL, MSG_RECORD,
                                             MSG_RUN, read_message, write_message)
    from nornicdb_tpu_torch.api.packstream import Packer, Structure, Unpacker

    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.settimeout(30)
        s.sendall(struct.pack(">I", BOLT_MAGIC) + struct.pack(">I", 0x0404) + b"\x00" * 12)
        assert struct.unpack(">I", s.recv(4))[0] & 0xFF == 4
        records = []
        for sig, fields in ((MSG_HELLO, [{"scheme": "none"}]),
                            (MSG_RUN, ["MATCH (n) RETURN count(n) AS c", {}, {}]),
                            (MSG_PULL, [{"n": -1}])):
            p = Packer()
            p.pack(Structure(sig, fields))
            write_message(s, p.data())
            while True:
                msg = Unpacker(read_message(s)).unpack()
                if msg.tag != MSG_RECORD:
                    break
                records.append(msg.fields[0])
        return records


def test_serve_on_the_cpu_answers_http_and_bolt(tmp_path):
    proc = _serve(["--device", "cpu", "--data-dir", str(tmp_path / "data")])
    try:
        (ports, device) = _ports(proc)
        assert device == "cpu"
        with urllib.request.urlopen(f"http://127.0.0.1:{ports['http']}/health", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        for i in range(4):
            st, body = _post(ports["http"], "/nornicdb/store",
                             {"content": f"document {i} about fjords", "id": f"d{i}"})
            assert (st, body) == (201, {"id": f"d{i}"})
        st, body = _post(ports["http"], "/db/neo4j/tx/commit", {"statements": [
            {"statement": "MATCH (n) RETURN count(n)"}]})
        assert st == 200 and body["results"][0]["data"][0]["row"] == [4]
        for attempt in range(600):  # the embed queue is asynchronous
            # each attempt's weights make a new body, which no cache holds
            st, body = _post(ports["http"], "/nornicdb/search",
                             {"query": "fjords document", "mode": "vector", "limit": 10,
                              "weights": [1.0, 1.0 + attempt * 1e-6]})
            if len(body["results"]) == 4:
                break
            time.sleep(0.05)
        assert sorted(h["id"] for h in body["results"]) == ["d0", "d1", "d2", "d3"]
        assert _bolt_count(ports["bolt"]) == [[4]]
    finally:
        _stop(proc)
    assert proc.returncode == 0
    assert os.path.isdir(tmp_path / "data")


def test_serve_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("NORNICDB_TPU_EMBEDDER", "hash")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["serve", "--http-port", "0", "--bolt-port", "0"])
    args = t_cli._build_parser().parse_args(["serve"])
    assert args.device == "cuda"
    for cmd in ("import", "export"):
        assert t_cli._build_parser().parse_args([cmd, "f"]).device == "cuda"


def test_serve_without_a_card_in_a_fresh_process():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    proc = _serve([])
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        _stop(proc)
    assert proc.returncode != 0 and "CUDA" in err


@pytest.mark.parametrize("argv", [
    ["serve", "--device", "cpu", "--grpc-port", "50051", "--plugins-dir", "/nonexistent"],
    ["serve", "--device", "cpu", "--plugins-dir", "/nonexistent"],
    ["eval", "suite.jsonl"],
    ["eval", "suite.jsonl", "--corpus", "corpus.jsonl", "--mrr", "0.9"],
    ["oauth-provider"],
    ["oauth-provider", "--port", "8888", "--client-id", "x"]])
def test_unported_commands_raise(argv):
    with pytest.raises(NotPortedError, match="not ported"):
        t_cli.main(argv)


@pytest.mark.parametrize("argv", [
    ["serve", "--device", "cpu", "--grpc-token", "secret"],
    ["import", "rows.jsonl", "--device", "cpu", "--bogus"]])
def test_flags_nothing_reads_are_refused(argv, capsys):
    # a flag the port would ignore is an argparse error, not a silent no-op
    with pytest.raises(SystemExit) as exc:
        t_cli.main(argv)
    assert exc.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err


def test_grpc_flags_parse_as_the_reference():
    argv = ["serve", "--grpc-port", "50051", "--grpc-auth-token", "secret"]
    t_args = t_cli._build_parser().parse_args(argv)
    j_args = j_cli._build_parser().parse_args(argv)
    assert (t_args.grpc_port, t_args.grpc_auth_token) == (j_args.grpc_port,
                                                          j_args.grpc_auth_token) == (50051, "secret")
    assert t_cli._build_parser().parse_args(["serve"]).grpc_port == 0


def test_serve_grpc_port_starts_the_grpc_server_behind_its_token():
    grpc = pytest.importorskip("grpc")
    from nornicdb_tpu_torch.api.proto import qdrant_pb2 as q

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    proc = _serve(["--device", "cpu", "--grpc-port", str(free), "--grpc-auth-token", "secret"])
    try:
        ports, device = _ports(proc)
        assert device == "cpu" and ports["grpc"] == free
        with grpc.insecure_channel(f"127.0.0.1:{free}") as ch:
            create = ch.unary_unary("/qdrant.Collections/Create",
                                    request_serializer=q.CreateCollection.SerializeToString,
                                    response_deserializer=q.CollectionOperationResponse.FromString)
            listing = ch.unary_unary("/qdrant.Collections/List",
                                     request_serializer=q.ListCollectionsRequest.SerializeToString,
                                     response_deserializer=q.ListCollectionsResponse.FromString)
            with pytest.raises(grpc.RpcError) as exc:
                listing(q.ListCollectionsRequest(), timeout=30)
            assert exc.value.code() == grpc.StatusCode.UNAUTHENTICATED
            md = (("authorization", "Bearer secret"),)
            assert create(q.CreateCollection(collection_name="c"), timeout=30, metadata=md).result
            got = listing(q.ListCollectionsRequest(), timeout=30, metadata=md)
            assert [c.name for c in got.collections] == ["c"]
    finally:
        _stop(proc)
    assert proc.returncode == 0


def test_version_and_help_match(capsys):
    assert t_cli.main(["version"]) == j_cli.main(["version"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and t_cli.VERSION == j_cli.VERSION
    assert t_cli.main([]) == j_cli.main([]) == 2


def _import_rows():
    rows = [{"type": "node", "id": f"n{i}", "labels": ["Doc"] + (["Hot"] if i % 2 else []),
             "properties": {"title": f"t{i}", "rank": i, "score": i / 7},
             "embedding": [float(i), 1.0, -0.5, 0.25]} for i in range(6)]
    rows.append({"type": "node", "id": "when", "labels": ["Event"],
                 "properties": {"at": None}, "embedding": [0.0, 0.0, 1.0, 0.0]})
    rows += [{"type": "edge", "id": f"e{i}", "start": f"n{i}", "end": f"n{i + 1}",
              "edge_type": "NEXT", "properties": {"w": i}} for i in range(5)]
    rows.append({"type": "edge", "id": "e9", "start": "n0", "end": "when"})
    return rows


def test_import_and_export_files_equal_the_reference(tmp_path, monkeypatch, capsys):
    from nornicdb_tpu.query.temporal_types import encode_value, make_date

    monkeypatch.setenv("NORNICDB_TPU_EMBEDDER", "hash")
    rows = _import_rows()
    rows[6]["properties"]["at"] = encode_value(make_date("2024-02-29"))
    src = tmp_path / "in.jsonl"
    src.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    outs = {}
    for name, main, extra in (("jax", j_cli.main, []), ("port", t_cli.main, ["--device", "cpu"])):
        d = str(tmp_path / name)
        assert main(["import", str(src), "--data-dir", d, *extra]) == 0
        assert main(["export", str(tmp_path / f"{name}.jsonl"), "--data-dir", d, *extra]) == 0
        outs[name] = (tmp_path / f"{name}.jsonl").read_text()
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == printed[2] == "imported 7 nodes, 6 edges"
    assert printed[1] == printed[3] == "exported 7 nodes, 6 edges"
    assert sorted(outs["port"].splitlines()) == sorted(outs["jax"].splitlines())
    # and each package imports the other's export
    for name, main, extra in (("jax", t_cli.main, ["--device", "cpu"]), ("port", j_cli.main, [])):
        d = str(tmp_path / f"re-{name}")
        assert main(["import", str(tmp_path / f"{name}.jsonl"), "--data-dir", d, *extra]) == 0
        assert main(["export", str(tmp_path / f"re-{name}.jsonl"), "--data-dir", d, *extra]) == 0
        assert sorted((tmp_path / f"re-{name}.jsonl").read_text().splitlines()) == \
            sorted(outs["jax"].splitlines())
