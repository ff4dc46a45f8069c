"""Persistence of the port against the JAX package: index files each
package loads from the other, the search service's snapshot and resume
cases (``tests/test_index_persistence.py``), DB data dirs reopened across
packages with the same answers, a SIGKILLed writer that loses no
acknowledged write, the embedder sidecar, and the parts the port refuses
(``NotPortedError``)."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.search.bm25 import BM25Index as JBM25
from nornicdb_tpu.search.cagra import CagraIndex as JCagra
from nornicdb_tpu.search.hnsw import HNSWIndex as JHNSW
from nornicdb_tpu.search.service import SearchService as JService
from nornicdb_tpu.search.vector_index import BruteForceIndex as JIndex
from nornicdb_tpu.storage import DurableEngine as JDurable
from nornicdb_tpu.storage import NamespacedEngine as JNamespaced
from nornicdb_tpu.storage.disk import DiskEngine as JDisk
from nornicdb_tpu_torch.embed.embedder import HashEmbedder
from nornicdb_tpu_torch.errors import NotPortedError
from nornicdb_tpu_torch.ops.topk import topk_agree
from nornicdb_tpu_torch.search.bm25 import BM25Index
from nornicdb_tpu_torch.search.cagra import CagraIndex
from nornicdb_tpu_torch.search.hnsw import HNSWIndex
from nornicdb_tpu_torch.search.rrf import rrf_fuse
from nornicdb_tpu_torch.search.service import SearchService
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex
from nornicdb_tpu_torch.storage import MemoryEngine, NamespacedEngine, Node
from nornicdb_tpu_torch.storage.disk import DiskEngine
from nornicdb_tpu_torch.storage.wal_engine import DurableEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 1e-5  # cosine scores of the same unit vectors, summed in another order

torch.set_num_threads(1)


def _hits_agree(a, b):
    if len(a) != len(b):
        return False
    return not a or topk_agree([[i for i, _ in a]], [[s for _, s in a]],
                               [[i for i, _ in b]], [[s for _, s in b]], SCORE_ATOL)


def _words(rng, n=300):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, rng.integers(3, 9))) for _ in range(n)]


def _corpus(seed, n_docs):
    rng = np.random.default_rng(seed)
    vocab = _words(rng)
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = [" ".join(vocab[w] for w in rng.choice(len(vocab), rng.integers(5, 30), p=p))
            for _ in range(n_docs)]
    for i in range(0, 30, 3):  # exact duplicates -> exact vector ties
        docs[n_docs - 1 - i] = docs[i]
    queries = [" ".join(vocab[w] for w in rng.choice(len(vocab), rng.integers(2, 5), p=p))
               for _ in range(10)]
    return docs, queries + [docs[0], docs[9]]


# -- index files --------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_brute_index_files_load_in_the_other_package(writer, tmp_path):
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((1500, 32)).astype(np.float32)
    idx = BruteForceIndex(device="cpu") if writer == "port" else JIndex()
    for i, v in enumerate(vecs):
        idx.add(f"n{i}", v)
    for i in range(0, 300, 3):
        idx.remove(f"n{i}")
    path = str(tmp_path / "vectors.npz")
    idx.save(path)
    other = JIndex.load(path) if writer == "port" else BruteForceIndex.load(path, device="cpu")
    again = type(idx).load(path) if writer == "jax" else BruteForceIndex.load(path, device="cpu")
    m, valid, ids = other.snapshot()
    m2, valid2, ids2 = again.snapshot()
    np.testing.assert_array_equal(m, m2)
    np.testing.assert_array_equal(valid, valid2)
    assert ids == ids2 and len(other) == 1400 and ids[0] == "n1"
    live = [i for i, e in enumerate(idx.snapshot()[2]) if e is not None]
    np.testing.assert_array_equal(m[:1400], idx.snapshot()[0][live])  # verbatim rows


def test_empty_brute_index_round_trips(tmp_path):
    path = str(tmp_path / "v.npz")
    BruteForceIndex(device="cpu").save(path)
    assert len(JIndex.load(path)) == 0 and len(BruteForceIndex.load(path, device="cpu")) == 0


def _hnsw_pair(n=600, d=24):
    rng = np.random.default_rng(4)
    items = [(f"n{i}", rng.standard_normal(d).astype(np.float32)) for i in range(n)]
    t, j = HNSWIndex(), JHNSW()
    t.build(items)
    j.build(items)
    for idx in (t, j):
        for i in range(0, 60, 7):
            idx.remove(f"n{i}")
    return t, j, items


def _graph(idx):
    return ([[idx._neighbors_of(s, lv).tolist() for lv in range(idx._levels[s] + 1)]
             for s in range(idx._count)],
            idx._ext_ids, idx._alive, idx._entry, idx._max_level)


def test_hnsw_files_load_in_the_other_package(tmp_path):
    t, j, items = _hnsw_pair()
    assert _graph(t) == _graph(j)  # the same graph from the same inputs
    t.save(str(tmp_path / "port"))
    j.save(str(tmp_path / "jax"))
    from_port = JHNSW.load(str(tmp_path / "port.npz"))
    from_jax = HNSWIndex.load(str(tmp_path / "jax.npz"))
    assert _graph(from_port) == _graph(t) and _graph(from_jax) == _graph(j)
    np.testing.assert_array_equal(from_jax._vectors[:from_jax._count], j._vectors[:j._count])
    assert (from_jax.m, from_jax.ef_search, len(from_jax)) == (j.m, j.ef_search, len(j))
    for _, v in items[:20]:
        assert from_jax.search(v, 10) == t.search(v, 10)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cagra_files_hold_the_vectors_only(writer, tmp_path):
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    idx = CagraIndex(device="cpu", min_n=64) if writer == "port" else JCagra(min_n=64)
    for i, v in enumerate(vecs):
        idx.add(f"n{i}", v)
    path = str(tmp_path / "cagra.npz")
    idx.save(path)
    loaded = JCagra.load(path) if writer == "port" else CagraIndex.load(path, device="cpu", min_n=64)
    assert not loaded.graph_built and len(loaded._brute) == 300
    np.testing.assert_array_equal(loaded._brute.snapshot()[0][:300], idx._brute.snapshot()[0][:300])


def test_bm25_dicts_are_json_equal_and_load_in_the_other_package():
    docs, queries = _corpus(5, 400)
    t, j = BM25Index(), JBM25()
    for idx in (t, j):
        for i, text in enumerate(docs):
            idx.index(f"d{i}", text)
        for i in range(0, 60, 4):
            idx.index(f"d{i}", docs[i + 1])
            idx.remove(f"d{i + 2}")
    td, jd = t.to_dict(), j.to_dict()
    assert json.dumps(td) == json.dumps(jd)
    t2 = BM25Index.from_dict(json.loads(json.dumps(jd)))
    j2 = JBM25.from_dict(json.loads(json.dumps(td)))
    assert len(t2) == len(j) and sorted(t2.ids()) == sorted(j.ids())
    for q in queries:
        assert t2.search(q, 20) == j.search(q, 20) == j2.search(q, 20)
    t2.index("fresh", "alpha beta")  # the restored index keeps indexing
    assert t2.search("alpha beta", 1)[0][0] == "fresh"


# -- the service: tests/test_index_persistence.py on the port ----------------


def _mk_node(i, dim=8):
    rng = np.random.default_rng(i)
    return Node(id=f"n{i}", labels=["Doc"],
                properties={"content": f"document number {i} about topic{i % 5}"},
                embedding=list(rng.standard_normal(dim).astype(float)))


def _service(eng, tmp_path, **kw):
    return SearchService(eng, persist_dir=str(tmp_path / "idx"), device="cpu", **kw)


def test_service_save_and_load_roundtrip(tmp_path):
    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path)
    for i in range(20):
        n = _mk_node(i)
        eng.create_node(n)
        svc.index_node(eng.get_node(n.id))
    before = svc.search("document topic1", limit=5)
    assert svc.save_indexes()
    assert svc.save_stats["saves"] == 1 and svc.save_stats["last_bytes"]["vectors.npz"] > 0
    svc2 = _service(eng, tmp_path)
    assert svc2.build_indexes() == 0, "a resumed build skips unchanged nodes"
    assert [r["id"] for r in svc2.search("document topic1", limit=5)] == [r["id"] for r in before]
    assert svc2.load_stats["total_s"] > 0
    svc.close()
    svc2.close()


def test_service_resume_indexes_only_new_and_updated(tmp_path):
    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path)
    for i in range(10):
        n = _mk_node(i)
        eng.create_node(n)
        svc.index_node(eng.get_node(n.id))
    svc.save_indexes()
    time.sleep(0.01)
    eng.create_node(_mk_node(100))
    upd = eng.get_node("n3")
    upd.properties["content"] = "freshly changed content xyzzy"
    eng.update_node(upd)
    eng.delete_node("n7")
    svc2 = _service(eng, tmp_path)
    assert svc2.build_indexes() == 2  # n100 and n3 only
    hits = svc2.search("xyzzy", limit=3)
    assert hits and hits[0]["id"] == "n3"
    assert "n7" not in svc2.vectors and "n7" not in svc2.bm25
    svc.close()
    svc2.close()


def test_service_format_version_mismatch_falls_back(tmp_path):
    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path)
    eng.create_node(_mk_node(1))
    svc.index_node(eng.get_node("n1"))
    svc.save_indexes()
    meta = tmp_path / "idx" / "meta.json"
    doc = json.loads(meta.read_text())
    doc["format"] = 999
    meta.write_text(json.dumps(doc))
    svc2 = _service(eng, tmp_path)
    assert not svc2.load_indexes()
    assert svc2.build_indexes() == 1  # full rebuild


@pytest.mark.parametrize("victim", ["vectors.npz", "bm25.json", "meta.json"])
def test_service_corrupt_snapshot_falls_back(tmp_path, victim):
    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path)
    eng.create_node(_mk_node(1))
    svc.index_node(eng.get_node("n1"))
    svc.save_indexes()
    (tmp_path / "idx" / victim).write_bytes(b"garbage")
    svc2 = _service(eng, tmp_path)
    assert not svc2.load_indexes()
    assert svc2.build_indexes() == 1


def test_service_hnsw_persisted_and_restored(tmp_path):
    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path, hnsw_threshold=50)
    for i in range(60):
        n = _mk_node(i)
        eng.create_node(n)
        svc.index_node(eng.get_node(n.id))
    assert svc.hnsw is not None
    svc.save_indexes()
    svc2 = _service(eng, tmp_path, hnsw_threshold=50)
    assert svc2.load_indexes()
    assert svc2.hnsw is not None and svc2.stats.strategy == "hnsw"
    assert svc2.stats.hnsw_builds == 0
    q = eng.get_node("n5").embedding
    assert svc2.vector_search_candidates(q, 10) == svc.vector_search_candidates(q, 10)


def test_service_load_rebinds_the_batchers_and_drops_derived_tiers(tmp_path, monkeypatch):
    """After a load, both micro-batchers dispatch into the restored
    indexes; the fused tier and any graph over the replaced index are
    dropped, and the result cache's generation moves on."""
    monkeypatch.setenv("NORNICDB_HYBRID_MIN_N", "8")
    monkeypatch.setenv("NORNICDB_HYBRID_INLINE_BUILD", "1")
    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path)
    for i in range(40):
        n = _mk_node(i)
        eng.create_node(n)
        svc.index_node(eng.get_node(n.id))
    qv = np.asarray(eng.get_node("n3").embedding, np.float32)
    first = svc.search("document topic3", query_embedding=qv, limit=5)
    assert svc._fused is not None
    svc.save_indexes()
    old_vectors, gen = svc.vectors, svc.generation
    assert svc.load_indexes()
    assert svc.vectors is not old_vectors and svc._fused is None and svc.cagra is None
    assert svc.generation > gen
    assert svc._microbatch.search(qv, 5) == old_vectors.search_batch(qv[None], 5)[0]
    assert svc.search("document topic3", query_embedding=qv, limit=5) == first
    assert svc._fused is not None and svc._fused.brute is svc.vectors


def test_service_prune_missing(tmp_path):
    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path)
    for i in range(6):
        eng.create_node(_mk_node(i))
        svc.index_node(eng.get_node(f"n{i}"))
    eng.inner.delete_node("test:n2")  # under the namespace: no event reaches the service
    assert svc.prune_missing() == 1
    assert "n2" not in svc.vectors and "n2" not in svc.bm25


def test_service_debounced_saves_keep_one_timer(tmp_path):
    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path, save_debounce_s=0.2)
    for i in range(30):
        eng.create_node(_mk_node(i))
        svc.index_node(eng.get_node(f"n{i}"))
    assert svc._save_timer is not None
    deadline = time.time() + 10
    while svc.save_stats["timer_saves"] < 1 and time.time() < deadline:
        time.sleep(0.05)
    assert svc.save_stats["timer_saves"] == 1 and svc._save_timer is None
    svc.index_node(eng.get_node("n2"))  # a write after the timer's save
    svc.close()
    assert svc.save_stats["saves"] == 2 and svc.save_stats["failed"] == 0
    svc.index_node(eng.get_node("n1"))  # no timer after close
    assert svc._save_timer is None
    svc2 = _service(eng, tmp_path)
    assert svc2.build_indexes() == 0
    svc2.close()  # nothing written since the load: nothing saved
    assert svc2.save_stats["saves"] == 0


def test_service_close_waits_for_a_save_in_flight(tmp_path, monkeypatch):
    """A close while the timer's save is being written waits for it, and
    no timer thread (each holds the service) outlives the close."""
    import threading

    eng = NamespacedEngine(MemoryEngine(), "test")
    svc = _service(eng, tmp_path, save_debounce_s=0.05)
    real = svc._save_indexes_locked
    started = threading.Event()

    def slow():
        started.set()
        time.sleep(0.5)
        return real()

    monkeypatch.setattr(svc, "_save_indexes_locked", slow)
    eng.create_node(_mk_node(1))
    svc.index_node(eng.get_node("n1"))
    assert started.wait(10)
    timers = list(svc._timers)
    svc.close()  # the timer's save captured the write: nothing left to save
    assert svc.save_stats["saves"] == 1 and svc.save_stats["timer_saves"] == 1
    assert timers and not any(t.is_alive() for t in timers)
    assert (tmp_path / "idx" / "meta.json").exists()


def test_db_restart_skips_reembed_and_rebuild(tmp_path):
    data_dir = str(tmp_path / "db")
    db = nornicdb_tpu_torch.open(data_dir, device="cpu")
    for i in range(8):
        db.store(f"note number {i} about tigers", node_id=f"m{i}")
    db.flush()
    before = [h["id"] for h in db.recall("tigers note")]
    assert before
    db.close()
    db2 = nornicdb_tpu_torch.open(data_dir, device="cpu")
    calls = {"n": 0}
    real_embed = db2._embedder.embed

    def counting(text):
        calls["n"] += 1
        return real_embed(text)

    db2._embedder.embed = counting
    svc = db2.search
    assert [h["id"] for h in db2.recall("tigers note")] == before
    assert calls["n"] <= 1  # the query's embedding only
    assert db2._embed_queue.embedded_count == 0 and svc.stats.indexed_docs == 8
    db2.close()


# -- DB data dirs across packages ---------------------------------------------

N_DB_DOCS = 3000


def _answers(db, queries, overfetch=30):
    """Per query: text ids, vector hits, hybrid ids, and the hybrid's own
    candidate lists."""
    svc = db.search
    out = {}
    for q in queries:
        qv = np.asarray(db._embedder.embed(q), np.float32)
        out[q] = {
            "text": [h["id"] for h in db.recall(q, mode="text")],
            "vector": [(h["id"], h["score"]) for h in db.recall(q, mode="vector")],
            "hybrid": [h["id"] for h in db.recall(q, mode="hybrid")],
            "lex": svc.bm25.search(q, overfetch),
            "vec": svc.vector_search_candidates(qv, overfetch),
        }
    return out


def _same_answers(after, before):
    for q, a in after.items():
        b = before[q]
        assert a["text"] == b["text"] and a["lex"] == b["lex"], q
        assert _hits_agree(a["vector"], b["vector"]) and _hits_agree(a["vec"], b["vec"]), q
        # the hybrid is bitwise the RRF of its own lists
        fused = rrf_fuse([a["lex"], a["vec"]], limit=30)
        assert a["hybrid"] == [i for i, _ in fused][:len(a["hybrid"])], q
        if a["vec"] == b["vec"]:
            assert a["hybrid"] == b["hybrid"], q


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_db_data_dirs_reopen_in_the_other_package(writer, engine, tmp_path):
    docs, queries = _corpus(11, N_DB_DOCS)
    d = str(tmp_path / "db")

    def jax_db():
        return nornicdb_tpu.open(d, engine=engine, embedder=JHash())

    def port_db():
        return nornicdb_tpu_torch.open(d, device="cpu", engine=engine, embedder=HashEmbedder())

    first, second = (jax_db, port_db) if writer == "jax" else (port_db, jax_db)
    db = first()
    for i, text in enumerate(docs):
        db.store(text, labels=["Doc"], node_id=f"d{i}")
    db.flush()
    db.forget("d5")
    before = _answers(db, queries)
    db.close()
    assert os.path.exists(os.path.join(d, "search", "meta.json"))
    assert os.path.isdir(os.path.join(d, "kv")) == (engine == "native")
    db2 = second()
    try:
        assert db2.storage.count_nodes() == N_DB_DOCS - 1
        after = _answers(db2, queries)
        assert db2._embed_queue.embedded_count == 0
        assert db2.search.stats.indexed_docs == N_DB_DOCS - 1
        _same_answers(after, before)
        assert all("d5" not in a["text"] + a["hybrid"] for a in after.values())
    finally:
        db2.close()


# -- a writer killed mid-stream --------------------------------------------

_CHILD = """
import sys
import nornicdb_tpu_torch as nt
from nornicdb_tpu_torch.embed.embedder import HashEmbedder
db = nt.open(sys.argv[1], device="cpu", engine=sys.argv[2], sync_every_write=True,
             auto_embed=False, embedder=HashEmbedder())
print("open", flush=True)
for i in range(100000):
    db.store(f"write number {i}", node_id=f"w{i}")
    print(f"w{i}", flush=True)
"""


@pytest.mark.parametrize("engine", ["native", "python"])
def test_a_killed_writer_loses_no_acknowledged_write(engine, tmp_path):
    d = str(tmp_path / "db")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, d, engine], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, text=True)
    acked = []
    try:
        assert proc.stdout.readline().strip() == "open"
        while len(acked) < 150:
            line = proc.stdout.readline().strip()
            assert line, "the writer died"
            acked.append(line)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait()
    db = nornicdb_tpu_torch.open(d, device="cpu", engine=engine, auto_embed=False,
                                 embedder=HashEmbedder())
    try:
        assert all(db.storage.has_node(i) for i in acked)
        n_port = db.storage.count_nodes()
    finally:
        db.close()
    # the port's close snapshotted (python) or left the store as it was
    base = (JDisk if engine == "native" else JDurable)(d)
    ns = JNamespaced(base, "neo4j")
    try:
        assert all(ns.has_node(i) for i in acked)
        assert ns.count_nodes() == n_port >= len(acked)
    finally:
        base.close()


# -- sidecar and refusals -----------------------------------------------------


def test_sidecar_matches_jax_and_is_kept(tmp_path):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    nornicdb_tpu.open(jd, auto_embed=False).close()
    nornicdb_tpu_torch.open(td, device="cpu", auto_embed=False).close()
    j = json.loads(open(os.path.join(jd, "embedder.json")).read())
    t = json.loads(open(os.path.join(td, "embedder.json")).read())
    assert t == j == {"kind": "encoder-mini", "dims": 160}
    # a hash store stays hash, at its recorded dims, in both packages
    for d in (jd, td):
        with open(os.path.join(d, "embedder.json"), "w") as f:
            json.dump({"kind": "hash", "dims": 64}, f)
    db = nornicdb_tpu_torch.open(td, device="cpu", auto_embed=False)
    jdb = nornicdb_tpu.open(jd, auto_embed=False)
    assert db._embedder.dims == jdb._embedder.dims == 64
    assert isinstance(db._embedder.inner, HashEmbedder)
    db.close()
    jdb.close()


def test_unreadable_or_hf_sidecar_raises(tmp_path, monkeypatch):
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "embedder.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError, match="unreadable"):
        nornicdb_tpu_torch.open(d, device="cpu", engine="python")
    with pytest.raises(ValueError, match="unreadable"):
        nornicdb_tpu.open(d, engine="python")
    with open(os.path.join(d, "embedder.json"), "w") as f:
        json.dump({"kind": "hf", "dims": 384}, f)
    with pytest.raises(NotPortedError, match="hf"):
        nornicdb_tpu_torch.open(d, device="cpu", engine="python")
    monkeypatch.setenv("NORNICDB_TPU_EMBEDDER", "hash")  # the escape hatch
    db = nornicdb_tpu_torch.open(d, device="cpu", engine="python", auto_embed=False)
    assert isinstance(db._embedder.inner, HashEmbedder)
    db.close()


@pytest.mark.parametrize("kw", [{"passphrase": "secret"}, {"replication": object()}])
def test_unported_db_options_raise(kw, tmp_path):
    with pytest.raises(NotPortedError):
        nornicdb_tpu_torch.open(str(tmp_path), device="cpu", **kw)


@pytest.mark.parametrize("kw,err", [({"engine": "disk"}, ValueError),
                                    ({"engine": "native", "data_dir": None}, ValueError)])
def test_db_engine_argument_checks(kw, err):
    with pytest.raises(err):
        nornicdb_tpu_torch.DB(device="cpu", **kw)


@pytest.mark.parametrize("engine,cls", [("auto", DiskEngine), ("native", DiskEngine),
                                        ("python", DurableEngine), ("memory", MemoryEngine)])
def test_db_builds_the_reference_chain(engine, cls, tmp_path):
    db = nornicdb_tpu_torch.open(str(tmp_path), device="cpu", engine=engine, auto_embed=False,
                                 embedder=HashEmbedder(), async_writes=True)
    try:
        assert isinstance(db._base, cls)
        ns = db.storage.inner
        assert isinstance(ns, NamespacedEngine) and ns.database == "neo4j"
        assert type(ns.inner).__name__ == "AsyncEngine" and ns.inner.inner is db._base
        db.store("hello", node_id="a")
        assert db.storage.get_node("a").properties["content"] == "hello"
    finally:
        db.close()
    if engine != "memory":
        db = nornicdb_tpu_torch.open(str(tmp_path), device="cpu", auto_embed=False,
                                     embedder=HashEmbedder())
        assert isinstance(db._base, cls) and db.storage.has_node("a")
        assert db._base.has_node("neo4j:a")
        db.close()


def test_forget_removes_from_storage_and_indexes(tmp_path):
    db = nornicdb_tpu_torch.open(str(tmp_path), device="cpu", auto_embed=False,
                                 embedder=HashEmbedder(dims=3))
    for i in range(5):
        db.store(f"alpha doc {i}", node_id=f"a{i}", embedding=[1.0, float(i), 0.0])
    assert len(db.recall("alpha", mode="text")) == 5
    db.forget("a2")
    assert not db.storage.has_node("a2") and "a2" not in db.search.vectors
    assert "a2" not in [h["id"] for h in db.recall("alpha")]
    db.close()


def test_rescan_embeds_nodes_that_missed_the_event_path(tmp_path):
    db = nornicdb_tpu_torch.open(str(tmp_path), device="cpu", engine="python",
                                 embedder=HashEmbedder())
    db._base.create_node(Node("neo4j:quiet", properties={"content": "missed event"}))
    q = db._embed_queue
    assert q.rescan_interval_s == 900.0 and q.rescans == 0  # no sweep at start
    db.close()
    from nornicdb_tpu_torch.embed.queue import EmbedQueue

    db = nornicdb_tpu_torch.open(str(tmp_path), device="cpu", auto_embed=False,
                                 embedder=HashEmbedder())
    assert db.storage.get_node("quiet").embedding is None
    q = EmbedQueue(db.storage, db._embedder, rescan_interval_s=0.05)
    q.start()
    deadline = time.time() + 10
    while q.embedded_count < 1 and time.time() < deadline:
        time.sleep(0.02)
    q.stop()
    assert q.rescans >= 1 and db.storage.get_node("quiet").embedding is not None
    db.close()


# -- C26: the database argument; C27: flush waits and raises ----------------------


@pytest.mark.parametrize("engine", ["native", "python"])
def test_database_argument_opens_what_jax_wrote_under_it(engine, tmp_path):
    d = str(tmp_path)
    jdb = nornicdb_tpu.open(d, database="t", engine=engine, auto_embed=False, embedder=JHash())
    for i in range(5):
        jdb.store(f"doc {i}", node_id=f"n{i}")
    jdb.link("n0", "n1", "KNOWS")
    jdb.close()
    db = nornicdb_tpu_torch.open(d, device="cpu", database="t", engine=engine,
                                 auto_embed=False, embedder=HashEmbedder())
    try:
        assert db.database == "t" and db.storage.inner.database == "t"
        assert sorted(n.id for n in db.storage.all_nodes()) == [f"n{i}" for i in range(5)]
        assert [e.type for e in db.storage.all_edges()] == ["KNOWS"]
        mgr = db.multidb_manager()
        assert [x.name for x in mgr.list_databases() if x.default] == ["t"]
        assert mgr.counts("t") == {"nodes": 5, "edges": 1}
    finally:
        db.close()
    for db in (nornicdb_tpu.open(d, engine=engine, auto_embed=False, embedder=JHash()),
               nornicdb_tpu_torch.open(d, device="cpu", engine=engine, auto_embed=False,
                                       embedder=HashEmbedder())):
        try:  # the default database sees none of them, in both packages
            assert db.database == "neo4j" and db.storage.count_nodes() == 0
        finally:
            db.close()


def test_database_is_keyword_only_so_a_positional_name_reaches_the_device(tmp_path):
    with pytest.raises(RuntimeError):
        nornicdb_tpu_torch.DB(str(tmp_path), "t")


class _FakeTime:
    """A clock for an embed queue's ``drain``: each sleep advances it 10 s,
    and once it reaches ``done_at`` the stuck node leaves the queue."""

    def __init__(self, q, done_at):
        self.q, self.done_at, self.t = q, done_at, 0.0

    def time(self):
        return self.t

    def sleep(self, _dt):
        self.t += 10.0
        if self.t >= self.done_at:
            with self.q._lock:
                self.q._pending.discard("stuck")


@pytest.mark.parametrize("case", ["slow_worker", "worker_gone"])
def test_flush_waits_without_a_limit_and_raises_without_a_worker(case, monkeypatch):
    """C27: the port's flush waits past the reference's 60 s and raises when
    the worker is gone with work pending; the reference's returns at 60 s
    without a word in both cases."""
    import nornicdb_tpu.embed.queue as jqueue
    import nornicdb_tpu_torch.embed.queue as tqueue

    for mod, db in ((jqueue, nornicdb_tpu.DB(embedder=JHash())),
                    (tqueue, nornicdb_tpu_torch.DB(device="cpu", embedder=HashEmbedder()))):
        q = db._embed_queue
        try:
            if case == "worker_gone":
                q.stop()
            clock = _FakeTime(q, done_at=150.0 if case == "slow_worker" else float("inf"))
            monkeypatch.setattr(mod, "time", clock)
            with q._lock:
                q._pending.add("stuck")  # a node the worker has not embedded yet
            if mod is jqueue:
                db.flush()
                assert 60.0 <= clock.t < 150.0 and "stuck" in q._pending
            elif case == "slow_worker":
                db.flush()
                assert clock.t >= 150.0 and not q._pending
            else:
                with pytest.raises(RuntimeError, match="worker stopped with work pending"):
                    db.flush()
        finally:
            monkeypatch.undo()
            db.close()
