"""The port's PackStream codec and Bolt server (``nornicdb_tpu_torch/api/packstream.py``,
``api/bolt.py``) against the JAX package's: packing is bitwise the
reference's over a value corpus that covers every type the executor
returns (nodes, relationships, lists, maps, ints at each width boundary,
floats, bytes, strings at each length boundary, and the temporal and
point types), a torch value packs as the numpy value the reference packs,
and one Bolt session (HELLO, RUN and PULL, BEGIN / COMMIT / ROLLBACK,
FAILURE then IGNORED then RESET) against both servers gives the same
messages, records and codes. Every server binds port 0 and every client
socket has a timeout."""

import socket
import struct
import types

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.api import bolt as j_bolt
from nornicdb_tpu.api import packstream as j_ps
from nornicdb_tpu.auth import Authenticator as JAuth
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.query import temporal_types as j_tt
from nornicdb_tpu.storage.types import Edge as JEdge
from nornicdb_tpu.storage.types import Node as JNode
from nornicdb_tpu_torch.api import bolt as t_bolt
from nornicdb_tpu_torch.api import packstream as t_ps
from nornicdb_tpu_torch.auth import Authenticator as TAuth
from nornicdb_tpu_torch.embed.embedder import HashEmbedder
from nornicdb_tpu_torch.query import temporal_types as t_tt
from nornicdb_tpu_torch.storage import Edge, Node

JAX = types.SimpleNamespace(name="jax", ps=j_ps, bolt=j_bolt, tt=j_tt, Node=JNode, Edge=JEdge,
                            Auth=JAuth)
PORT = types.SimpleNamespace(name="port", ps=t_ps, bolt=t_bolt, tt=t_tt, Node=Node, Edge=Edge,
                             Auth=TAuth)

INT_BOUNDS = [0, 1, -1, -16, -17, 127, 128, -128, -129, 255, 256, 32767, 32768, -32768,
              -32769, 2**31 - 1, 2**31, -2**31, -2**31 - 1, 2**63 - 1, -2**63]
STR_LENS = [0, 1, 15, 16, 255, 256, 65535, 65536]


def _corpus(side):
    tt = side.tt
    node = side.Node("n1", labels=["Person", "Dev"],
                     properties={"name": "ada", "age": 36, "tags": ["x"], "_id": "kept"})
    edge = side.Edge("e1", "KNOWS", "n1", "n2", properties={"since": 2020})
    values = [None, True, False]
    values += INT_BOUNDS
    values += [0.0, -0.0, 1.1, -2.5e-300, 1e308, float("inf"), float("-inf")]
    values += ["é" * 3, "日本"] + ["x" * n for n in STR_LENS]
    values += [b"", b"\x00\xff", bytes(range(256)), b"z" * 70000]
    values += [[], [1, "a", None], list(range(15)), list(range(16)), list(range(256)),
               {}, {"a": 1}, {f"k{i}": i for i in range(16)}, {"nested": [{"d": [1.5]}]}]
    values += [node, edge, [node, {"e": edge}], side.ps.Structure(0x50, [[node], [edge], []])]
    values += [
        tt.make_date("2024-02-29"), tt.make_date("1969-12-31"),
        tt.make_localtime("12:34:56.789"), tt.make_time("23:59:59+05:30"),
        tt.make_localdatetime("2024-01-02T03:04:05.006"),
        tt.make_datetime("2024-01-02T03:04:05.006-07:00"),
        tt.make_datetime("1960-06-01T00:00:00Z"),
        tt.parse_duration("P1Y2M3DT4H5M6.007S"), tt.parse_duration("-PT1S"),
        tt.make_point({"x": 1.5, "y": -2.0}), tt.make_point({"x": 1, "y": 2, "z": 3}),
        tt.make_point({"latitude": 59.9, "longitude": 10.7}),
        tt.make_point({"latitude": 59.9, "longitude": 10.7, "height": 12.0}),
    ]
    values += [np.int64(-129), np.int32(70000), np.float32(0.1), np.float64(2.5)]
    return values


def test_corpus_lengths_match():
    assert len(_corpus(JAX)) == len(_corpus(PORT)) == 75


@pytest.mark.parametrize("i", range(len(_corpus(JAX))))
def test_packing_is_bitwise_the_reference(i):
    vj, vt = _corpus(JAX)[i], _corpus(PORT)[i]
    bj = j_ps.pack(vj)
    bt = t_ps.pack(vt)
    assert bt == bj
    # and each side decodes the other's bytes to the same structure
    uj, ut = j_ps.unpack(bt), t_ps.unpack(bj)
    assert repr(ut) == repr(uj)


def test_whole_corpus_in_one_stream():
    bj = j_ps.pack(*_corpus(JAX))
    bt = t_ps.pack(*_corpus(PORT))
    assert bt == bj
    assert [repr(v) for v in t_ps.unpack_all(bj)] == [repr(v) for v in j_ps.unpack_all(bt)]


@pytest.mark.parametrize("value,numpy_value", [
    (torch.tensor(0.1, dtype=torch.float32), np.float32(0.1)),
    (torch.tensor(-129), np.int64(-129)),
    (torch.tensor(2**40, dtype=torch.int64), np.int64(2**40)),
    (torch.tensor([1.5, 2.0]), [1.5, 2.0]),
    (torch.tensor([[1, 2], [3, 4]], dtype=torch.int32), [[1, 2], [3, 4]])])
def test_torch_values_pack_as_the_reference_packs_numpy(value, numpy_value):
    assert t_ps.pack(value) == j_ps.pack(numpy_value)


@pytest.mark.parametrize("bad", [object(), {1, 2}])
def test_unpackable_values_raise_alike(bad):
    with pytest.raises(j_ps.PackStreamError) as ej:
        j_ps.pack(bad)
    with pytest.raises(t_ps.PackStreamError) as et:
        t_ps.pack(bad)
    assert str(et.value) == str(ej.value)


def test_to_packable_and_node_ids_match():
    assert t_ps.node_id_to_int("abc") == j_ps.node_id_to_int("abc")
    nj, nt = JNode("a", labels=["L"], properties={"p": 1}), Node("a", labels=["L"], properties={"p": 1})
    assert t_ps.pack(t_ps.to_packable({"x": [nt]})) == j_ps.pack(j_ps.to_packable({"x": [nj]}))


# -- the Bolt session ------------------------------------------------------------


class BoltClient:
    def __init__(self, side, port):
        self.side = side
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        self.sock.settimeout(30)
        self.sock.sendall(struct.pack(">I", side.bolt.BOLT_MAGIC))
        self.sock.sendall(struct.pack(">I", (4 << 8) | 4) + b"\x00" * 12)
        self.version = struct.unpack(">I", self.sock.recv(4))[0]

    def send(self, sig, *fields):
        p = self.side.ps.Packer()
        p.pack(self.side.ps.Structure(sig, list(fields)))
        self.side.bolt.write_message(self.sock, p.data())

    def recv(self):
        msg = self.side.ps.Unpacker(self.side.bolt.read_message(self.sock)).unpack()
        return msg.tag, msg.fields

    def exchange(self, sig, *fields):
        """Send one message; every reply up to its SUCCESS, FAILURE or
        IGNORED, with the volatile fields blanked."""
        self.send(sig, *fields)
        out = []
        while True:
            tag, f = self.recv()
            out.append((tag, _blank(f)))
            if tag != self.side.bolt.MSG_RECORD:
                return out

    def close(self):
        self.sock.close()


def _blank(fields):
    out = []
    for f in fields:
        if isinstance(f, dict):
            f = {k: ("<var>" if k in ("connection_id", "bookmark") else v) for k, v in f.items()}
        out.append(f)
    return out


def _session(side, auth=False):
    if side is JAX:
        db = nornicdb_tpu.open(embedder=JHash())
    else:
        db = nornicdb_tpu_torch.open(device="cpu", embedder=HashEmbedder())
    authenticator = None
    if auth:
        authenticator = side.Auth(jwt_secret="k")
        authenticator.create_user("ada", "pw", roles=["admin"])
    srv = side.bolt.BoltServer(db, port=0, authenticator=authenticator).start()
    b = side.bolt
    log = []
    try:
        db.store("the capital of norway is oslo", labels=["City"], node_id="oslo",
                 properties={"pop": 700000})
        db.store("bergen is rainy", labels=["City"], node_id="bergen")
        db.link("oslo", "bergen", "NEAR", properties={"km": 463})
        db.flush()
        c = BoltClient(side, srv.port)
        try:
            log.append(c.version)
            if auth:
                log += c.exchange(b.MSG_HELLO, {"scheme": "basic", "principal": "ada",
                                                "credentials": "wrong"})
                c.close()
                c = BoltClient(side, srv.port)
                log += c.exchange(b.MSG_RUN, "RETURN 1", {}, {})  # before HELLO
                c.close()
                c = BoltClient(side, srv.port)
                log += c.exchange(b.MSG_HELLO, {"scheme": "basic", "principal": "ada",
                                                "credentials": "pw"})
            else:
                log += c.exchange(b.MSG_HELLO, {"user_agent": "test/1.0", "scheme": "none"})
            for q, params in [
                    ("MATCH (n:City) RETURN n ORDER BY n.content", {}),
                    ("MATCH (a {_id: 'oslo'})-[r:NEAR]->(b) RETURN a.content, r, b.pop", {}),
                    ("MATCH (n:City) RETURN count(n) AS c, collect(n.content) AS cs", {}),
                    ("RETURN $x + 1 AS y, $s AS s, [1, 2.5, 'x', null] AS l", {"x": 41, "s": "é"}),
                    ("RETURN date('2024-02-29') AS d, duration('P1DT2H') AS du, "
                     "point({x: 1, y: 2}) AS p", {}),
                    ("UNWIND range(1, 5) AS x RETURN x", {})]:
                log += c.exchange(b.MSG_RUN, q, params, {})
                log += c.exchange(b.MSG_PULL, {"n": 2})
                log += c.exchange(b.MSG_PULL, {"n": -1})
            log += c.exchange(b.MSG_RUN, "UNWIND range(1, 3) AS x RETURN x", {}, {})
            log += c.exchange(b.MSG_DISCARD, {"n": -1})
            log += c.exchange(b.MSG_PULL, {"n": -1})  # nothing left to pull: FAILURE
            log += c.exchange(b.MSG_RESET)
            # an explicit transaction: a write not seen outside it, then committed
            log += c.exchange(b.MSG_BEGIN, {})
            log += c.exchange(b.MSG_BEGIN, {})  # already open: FAILURE
            log += c.exchange(b.MSG_RESET)
            log += c.exchange(b.MSG_BEGIN, {})
            log += c.exchange(b.MSG_RUN, "CREATE (n:Tx {v: 1}) RETURN n.v", {}, {})
            log += c.exchange(b.MSG_PULL, {"n": -1})
            log.append(db.cypher("MATCH (n:Tx) RETURN count(n)").rows)
            log += c.exchange(b.MSG_RUN, "MATCH (n:Tx) RETURN count(n)", {}, {})
            log += c.exchange(b.MSG_PULL, {"n": -1})
            log += c.exchange(b.MSG_COMMIT)
            log.append(db.cypher("MATCH (n:Tx) RETURN count(n)").rows)
            log += c.exchange(b.MSG_COMMIT)  # none open: FAILURE
            log += c.exchange(b.MSG_RESET)
            # a rolled-back write is not seen
            log += c.exchange(b.MSG_BEGIN, {})
            log += c.exchange(b.MSG_RUN, "CREATE (n:Gone)", {}, {})
            log += c.exchange(b.MSG_PULL, {"n": -1})
            log += c.exchange(b.MSG_ROLLBACK)
            log.append(db.cypher("MATCH (n:Gone) RETURN count(n)").rows)
            # FAILURE, then IGNORED until RESET
            log += c.exchange(b.MSG_RUN, "THIS IS NOT CYPHER", {}, {})
            log += c.exchange(b.MSG_RUN, "RETURN 1", {}, {})
            log += c.exchange(b.MSG_PULL, {"n": -1})
            log += c.exchange(b.MSG_RESET)
            log += c.exchange(b.MSG_RUN, "MATCH (n {_id: 'nope'}) DELETE n RETURN 1", {}, {})
            log += c.exchange(b.MSG_PULL, {"n": -1})
            log += c.exchange(0x55)  # an unknown message
            log += c.exchange(b.MSG_RESET)
            c.send(b.MSG_GOODBYE)
        finally:
            c.close()
    finally:
        srv.stop()
        db.close()
    return log


@pytest.mark.parametrize("auth", [False, True])
def test_bolt_session_matches_the_reference(auth):
    j, t = _session(JAX, auth), _session(PORT, auth)
    assert len(t) == len(j)
    for k, (a, b) in enumerate(zip(j, t)):
        assert repr(b) == repr(a), k
    tags = [m[0] for m in t if isinstance(m, tuple)]
    assert t_bolt.MSG_FAILURE in tags and t_bolt.MSG_IGNORED in tags and t_bolt.MSG_RECORD in tags


def test_bolt_constants_match():
    for name in ("BOLT_MAGIC", "SUPPORTED_VERSIONS", "MSG_HELLO", "MSG_RUN", "MSG_PULL",
                 "MSG_DISCARD", "MSG_BEGIN", "MSG_COMMIT", "MSG_ROLLBACK", "MSG_RESET",
                 "MSG_GOODBYE", "MSG_SUCCESS", "MSG_FAILURE", "MSG_IGNORED", "MSG_RECORD",
                 "SERVER_AGENT"):
        assert getattr(t_bolt, name) == getattr(j_bolt, name), name
