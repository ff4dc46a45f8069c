"""The port's compliance audit log (``nornicdb_tpu_torch/audit.py``) and
retention module (``nornicdb_tpu_torch/retention.py``) against the JAX
package's: ``AuditLog`` records are equal apart from their timestamps,
in memory and in a JSONL file either package reads; retention sweeps,
legal holds and the GDPR export and delete give the same results on the
same graph. (``tests/test_torch_audit.py`` covers ``obs/audit.py``.)"""

import json
import types

import pytest

import nornicdb_tpu.audit as j_audit
import nornicdb_tpu.retention as j_ret
import nornicdb_tpu_torch.audit as t_audit
import nornicdb_tpu_torch.retention as t_ret
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage.types import Edge as JEdge
from nornicdb_tpu.storage.types import Node as JNode
from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node

JAX = types.SimpleNamespace(audit=j_audit, ret=j_ret, Memory=JMemory, Node=JNode, Edge=JEdge)
PORT = types.SimpleNamespace(audit=t_audit, ret=t_ret, Memory=MemoryEngine, Node=Node, Edge=Edge)

DAY = 86_400_000
NOW = 1_800_000_000_000


def _no_time(ev):
    d = dict(ev.__dict__)
    d.pop("timestamp_ms")
    return d


def _record_all(log, audit):
    log.record(audit.AUTH, "login", actor="ada")
    log.record(audit.AUTH, "login", actor="bob", success=False, reason="bad password")
    log.record(audit.DATA_WRITE, "store", actor="ada", database="neo4j", target="n1")
    log.record(audit.GDPR, "delete", actor="root", details={"deleted": 3})
    log.record(audit.ADMIN_ACTION, "create_database", actor="root", target="t1")
    return log


@pytest.mark.parametrize("where", ["memory", "file"])
def test_audit_records_equal_apart_from_timestamps(where, tmp_path):
    got = {}
    for name, side in (("jax", JAX), ("port", PORT)):
        path = str(tmp_path / f"{name}.jsonl") if where == "file" else None
        log = _record_all(side.audit.AuditLog(path=path), side.audit)
        got[name] = [[_no_time(e) for e in log.events(category=c, actor=a)]
                     for c, a in [(None, None), (side.audit.AUTH, None), (None, "root"),
                                  (side.audit.GDPR, "ada")]]
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 5 and got["port"][0][1]["details"] == {"reason": "bad password"}
    for name in ("AUTH", "DATA_READ", "DATA_WRITE", "DATA_DELETE", "ADMIN_ACTION", "GDPR"):
        assert getattr(t_audit, name) == getattr(j_audit, name)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_audit_file_reads_in_the_other_package(writer, tmp_path):
    path = str(tmp_path / "audit.jsonl")
    first, second = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    _record_all(first.audit.AuditLog(path=path), first.audit)
    with open(path, "a") as f:
        f.write('{"torn": ')  # a torn tail line is skipped, not fatal
    want = [e.__dict__ for e in first.audit.AuditLog(path=path).events()]
    got = [e.__dict__ for e in second.audit.AuditLog(path=path).events()]
    assert got == want and len(got) == 5


@pytest.mark.parametrize("where", ["memory", "file"])
def test_audit_retention_and_disabled_log(where, tmp_path):
    out = []
    for name, side in (("jax", JAX), ("port", PORT)):
        path = str(tmp_path / f"{name}.jsonl") if where == "file" else None
        log = side.audit.AuditLog(path=path, retention_days=30)
        for age_days in (40, 31, 10, 0):
            ev = log.record(side.audit.AUTH, "login", actor=f"u{age_days}")
            if path is None:
                ev.timestamp_ms = NOW - age_days * DAY
        if path is not None:
            rows = [json.loads(line) for line in open(path)]
            for row, age_days in zip(rows, (40, 31, 10, 0)):
                row["timestamp_ms"] = NOW - age_days * DAY
            with open(path, "w") as f:
                f.writelines(json.dumps(r, separators=(",", ":")) + "\n" for r in rows)
        removed = log.apply_retention(now_ms=NOW)
        off = side.audit.AuditLog(enabled=False)
        out.append((removed, [e.actor for e in log.events()],
                    off.record(side.audit.AUTH, "x"), list(off.events()),
                    side.audit.AuditLog(path=path).apply_retention(now_ms=NOW)))
    assert out[0] == out[1] == (2, ["u10", "u0"], None, [], 0)


# -- retention and GDPR --------------------------------------------------------


def _graph(side):
    eng = side.Memory()
    rows = [("p1", ["PII"], {"email": "a@x", "name": "ada"}, 4 * 365),
            ("p2", ["PII"], {"email": "b@x"}, 10),
            ("p3", ["PII"], {"email": "a@x", "case": "lit-7"}, 5 * 365),
            ("h1", ["Health"], {"email": "a@x"}, 7 * 365),
            ("f1", ["Financial"], {"email": "c@x"}, 8 * 365),
            ("r1", ["Record"], {}, 0)]
    for nid, labels, props, age in rows:
        eng.create_node(side.Node(nid, labels=labels, properties=props))
        n = eng.get_node(nid)
        n.created_at = n.updated_at = NOW - age * DAY
        eng._nodes[nid] = n  # the node's age, which update_node would reset
    eng.create_edge(side.Edge("e1", "KNOWS", "p1", "p2", properties={"since": 2020}))
    eng.create_edge(side.Edge("e2", "CARES", "h1", "p1"))
    eng.create_edge(side.Edge("e3", "PAYS", "f1", "r1"))
    return eng


def _state(eng):
    return (sorted((n.id, n.properties) for n in eng.all_nodes()),
            sorted((e.id, e.start_node, e.end_node) for e in eng.all_edges()))


def _gdpr(side):
    eng = _graph(side)
    exp = side.ret.gdpr_export(eng, "email", "a@x")
    exp.pop("exported_at_ms")
    exp["nodes"] = sorted(exp["nodes"], key=lambda d: d["id"])
    exp["edges"] = sorted(({k: v for k, v in e.items() if k not in ("created_at", "updated_at")}
                           for e in exp["edges"]), key=lambda d: d["id"])  # the clock apart
    none = side.ret.gdpr_export(eng, "email", "nobody")
    none.pop("exported_at_ms")
    mgr = side.ret.RetentionManager(eng)
    mgr.add_legal_hold("case", "lit-7")
    deleted = side.ret.gdpr_delete(eng, "email", "a@x", retention=mgr)
    return exp, none, deleted, _state(eng)


def test_gdpr_export_and_delete_match():
    j, t = _gdpr(JAX), _gdpr(PORT)
    assert t == j
    exp, none, deleted, (nodes, edges) = t
    assert [n["id"] for n in exp["nodes"]] == ["h1", "p1", "p3"] and none["nodes"] == []
    assert deleted == 2 and [n[0] for n in nodes] == ["f1", "p2", "p3", "r1"]


def _sweep(side):
    eng = _graph(side)
    archived = []
    mgr = side.ret.RetentionManager(eng, archive_callback=lambda d: archived.append(d["id"]))
    for p in side.ret.default_policies():
        mgr.add_policy(p)
    mgr.add_legal_hold("case", "lit-7")
    mgr.add_legal_hold("case", "lit-8")
    holds = mgr.legal_holds()
    released = (mgr.release_legal_hold("case", "lit-8"), mgr.release_legal_hold("case", "zz"))
    res = mgr.sweep(now=NOW)
    again = mgr.sweep(now=NOW)
    try:
        mgr.add_policy(side.ret.RetentionPolicy(name="bad", max_age_days=1, action="shred"))
        bad = None
    except ValueError as exc:
        bad = str(exc)
    return (res.__dict__, again.__dict__, archived, holds, released, bad,
            [p.to_dict() for p in mgr.policies()], _state(eng))


def test_retention_sweep_matches(tmp_path):
    j, t = _sweep(JAX), _sweep(PORT)
    assert t == j
    res, again, archived = t[:3]
    assert res == {"scanned": 6, "archived": 2, "deleted": 1, "held": 1}
    assert again["archived"] == 0 and archived == ["p1"]
    # policies saved by one package load in the other
    path = str(tmp_path / "policies.json")
    mj = j_ret.RetentionManager(JMemory())
    for p in j_ret.default_policies():
        mj.add_policy(p)
    mj.save_policies(path)
    mt = t_ret.RetentionManager(MemoryEngine())
    assert mt.load_policies(path) == 5
    assert [p.to_dict() for p in mt.policies()] == [p.to_dict() for p in mj.policies()]
