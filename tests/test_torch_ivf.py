"""The port's IVF-PQ, IVF-HNSW and vector-space registry
(``search/{util,ivfpq,ivf_hnsw}.py``, ``vectorspace.py``) against the JAX
package's, the port on ``device="cpu"``.

IVF-PQ is host NumPy in both packages, trained through the same
``euclid_kmeans`` and ``train_subspace_codebooks``: the same sample and
``seed_ids`` give the same coarse centroids, codebooks, codes, ids and
scores bit for bit, with and without the refine store, and a file either
package saves loads in the other and answers the same. IVF-HNSW
partitions with ``kmeans_fit``, whose seeds differ between the packages
(ROADMAP C22, C41): through the ``seam`` fixture (the port's partitioner
returns the JAX package's result) routing and search are bitwise the
reference's; from the port's own init it is held to recall@10 >= 0.95
against exact search. The registry builds every backend as the
reference's does, on its device, and the search service opens the
reference's spaces."""

import threading

import numpy as np
import pytest

from nornicdb_tpu import vectorspace as jvs
from nornicdb_tpu.ops import kmeans as jk
from nornicdb_tpu.search import ivf_hnsw as jih
from nornicdb_tpu.search import ivfpq as jpq
from nornicdb_tpu.search import util as jutil
from nornicdb_tpu_torch import vectorspace as tvs
from nornicdb_tpu_torch.search.ann_quality import CAGRA_ITOPK, CAGRA_WIDTH
from nornicdb_tpu_torch.search import ivf_hnsw as tih
from nornicdb_tpu_torch.search import ivfpq as tpq
from nornicdb_tpu_torch.search import util as tutil

D = 32


def _clustered(n_per=60, n_clusters=6, dims=D, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dims)) * 3
    items = []
    for c in range(n_clusters):
        pts = centers[c] + rng.standard_normal((n_per, dims)) * spread
        items += [(f"c{c}-{i}", p.astype(np.float32)) for i, p in enumerate(pts)]
    return items


def _queries(items, n, seed, noise=0.2):
    rng = np.random.default_rng(seed)
    rows = rng.choice(len(items), n, replace=False)
    return [(items[r][1] + noise * rng.standard_normal(D)).astype(np.float32) for r in rows]


@pytest.fixture
def seam(monkeypatch):
    """The port's IVF-HNSW partitioner returns the JAX package's k-means."""
    def fit(vectors, k=None, **kw):
        kw.pop("device", None)
        return jk.kmeans_fit(vectors, k=k, **kw)

    monkeypatch.setattr(tih, "kmeans_fit", fit)
    return monkeypatch


def test_normalize_rows_is_the_reference_s():
    x = np.random.default_rng(1).standard_normal((17, 9)).astype(np.float32)
    x[3] = 0.0
    assert np.array_equal(tutil.normalize_rows(x), jutil.normalize_rows(x))
    assert np.array_equal(tutil.normalize_rows(x[0]), jutil.normalize_rows(x[0]))


# -- IVF-PQ ---------------------------------------------------------------


def _pq_pair(keep_vectors, **kw):
    kw = {"n_subspaces": 8, "n_clusters": 6, "nprobe": 3, **kw}
    return (jpq.IVFPQIndex(keep_vectors=keep_vectors, **kw),
            tpq.IVFPQIndex(keep_vectors=keep_vectors, **kw))


def _pq_state(idx):
    return (idx.dims, idx.coarse, idx.codebooks, idx._ids, idx._codes, idx._assign,
            idx._alive, idx._vecs, dict(idx._id_pos))


def _assert_same_state(a, b):
    for x, y in zip(_pq_state(a), _pq_state(b)):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("keep_vectors", [False, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_ivfpq_matches_jax_bitwise(keep_vectors, seeded):
    items = _clustered()
    sample = np.asarray([v for _, v in items[::2]])
    seed_ids = [5, 77, 5, 140, 999] if seeded else None  # out-of-range rows ignored
    j, t = _pq_pair(keep_vectors)
    j.train(sample, seed_ids=seed_ids)
    t.train(sample, seed_ids=seed_ids)
    for batch in (items[:200], items[150:] + [items[3]], [items[7], items[7]]):
        j.add_batch(batch)
        t.add_batch(batch)
    assert j.remove("c1-4") and t.remove("c1-4")
    assert not j.remove("c1-4") and not t.remove("c1-4")
    assert len(j) == len(t) == len(items) - 1
    _assert_same_state(j, t)
    for i, q in enumerate(_queries(items, 24, seed=3)):
        k = (1, 5, 10, 40)[i % 4]
        nprobe = (None, 1, 6)[i % 3]
        assert t.search(q, k=k, nprobe=nprobe) == j.search(q, k=k, nprobe=nprobe)
    qs = np.asarray(_queries(items, 12, seed=4))
    truth = [[e for e, _ in j.search(q, k=10, nprobe=6)] for q in qs] + [["nope", "c2-1"]]
    qs = np.vstack([qs, qs[:1]])
    for nprobe in (None, 1, 2):
        assert t.coarse_hit_rate(qs, truth, nprobe) == j.coarse_hit_rate(qs, truth, nprobe)


@pytest.mark.parametrize("keep_vectors", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ivfpq_save_files_load_in_both_packages(tmp_path, keep_vectors, writer):
    items = _clustered(n_per=30)
    j, t = _pq_pair(keep_vectors)
    for idx in (j, t):
        idx.train(np.asarray([v for _, v in items]))
        idx.add_batch(items)
        idx.remove("c0-0")
    path = str(tmp_path / "pq.npz")
    (j if writer == "jax" else t).save(path)
    lj, lt = jpq.IVFPQIndex.load(path), tpq.IVFPQIndex.load(path)
    _assert_same_state(lj, lt)
    _assert_same_state(lt, t)
    assert (lt.nprobe, lt.refine_factor, lt.min_refine_pool, lt.keep_vectors) == \
        (lj.nprobe, lj.refine_factor, lj.min_refine_pool, lj.keep_vectors)
    for q in _queries(items, 8, seed=5):
        assert lt.search(q, k=10) == lj.search(q, k=10) == t.search(q, k=10)


def test_ivfpq_trained_but_empty_saves_and_loads_alike(tmp_path):
    j, t = _pq_pair(False, n_clusters=2, n_subspaces=4)
    sample = np.random.default_rng(0).standard_normal((20, 16)).astype(np.float32)
    for idx in (j, t):
        idx.train(sample)
        idx.add_batch([])
    assert len(j) == len(t) == 0
    t.save(str(tmp_path / "t"))
    j.save(str(tmp_path / "j"))
    for path in ("t", "j"):
        lj = jpq.IVFPQIndex.load(str(tmp_path / path))
        lt = tpq.IVFPQIndex.load(str(tmp_path / path))
        _assert_same_state(lj, lt)
        assert lt.search(sample[0]) == lj.search(sample[0]) == []


@pytest.mark.parametrize("case", ["untrained_add", "untrained_save", "dims", "duplicates"])
def test_ivfpq_edge_cases_match_jax(case):
    outs = []
    for mod in (jpq, tpq):
        if case == "untrained_add":
            with pytest.raises(RuntimeError) as exc:
                mod.IVFPQIndex().add_batch([("a", [1.0, 2.0])])
            outs.append(str(exc.value))
        elif case == "untrained_save":
            with pytest.raises(RuntimeError) as exc:
                mod.IVFPQIndex().save("/nonexistent/never")
            outs.append((str(exc.value), mod.IVFPQIndex().search([1.0, 2.0])))
        elif case == "dims":
            with pytest.raises(ValueError) as exc:
                mod.IVFPQIndex(n_subspaces=7).train(
                    np.random.default_rng(0).standard_normal((10, 32)))
            outs.append(str(exc.value))
        else:
            v = np.ones((50, 16), dtype=np.float32)
            idx = mod.IVFPQIndex(n_subspaces=4, n_clusters=2)
            idx.train(v)
            idx.add_batch([(f"d{i}", v[i]) for i in range(50)])
            outs.append((idx.search(v[0], k=3), idx.codebooks.tolist()))
    assert outs[0] == outs[1]


# -- IVF-HNSW -------------------------------------------------------------


def _hnsw_pair(**kw):
    kw = {"n_clusters": 6, "nprobe": 2, **kw}
    return jih.IVFHNSWIndex(**kw), tih.IVFHNSWIndex(device="cpu", **kw)


def test_ivf_hnsw_through_the_seam_matches_jax_bitwise(seam, tmp_path):
    items = _clustered()
    seeds = [items[i][0] for i in range(0, len(items), 17)]
    j, t = _hnsw_pair()
    j.build(items, seed_ids=seeds)
    t.build(items, seed_ids=seeds)
    assert np.array_equal(t.centroids, j.centroids) and t._where == j._where
    assert sorted(t.clusters) == sorted(j.clusters)
    qs = _queries(items, 24, seed=6)
    for i, q in enumerate(qs):
        lex = [items[r][0] for r in range(i, len(items), 53)] if i % 2 else None
        nprobe = (None, 1, 4)[i % 3]
        assert np.array_equal(np.sort(t.route(q, nprobe, lexical_doc_ids=lex)),
                              np.sort(j.route(q, nprobe, lexical_doc_ids=lex)))
        assert t.search(q, k=10, nprobe=nprobe, lexical_doc_ids=lex) == \
            j.search(q, k=10, nprobe=nprobe, lexical_doc_ids=lex)
    # incremental writes: a move between clusters, a new id, a removal
    fresh = np.random.default_rng(7).standard_normal(D).astype(np.float32)
    for idx in (j, t):
        idx.add("c0-1", items[200][1])
        idx.add("fresh", fresh)
    assert j.remove("c3-3") == t.remove("c3-3") is True
    assert j.remove("missing") == t.remove("missing") is False
    assert len(j) == len(t) and t._where == j._where
    for q in qs[:8]:
        assert t.search(q, k=10) == j.search(q, k=10)
    # the saved directories load in both packages
    for writer, idx in (("jax", j), ("port", t)):
        d = str(tmp_path / writer)
        idx.save(d)
        lj, lt = jih.IVFHNSWIndex.load(d), tih.IVFHNSWIndex.load(d, device="cpu")
        assert lt._where == lj._where == t._where
        for q in qs[:6]:
            assert lt.search(q, k=10) == lj.search(q, k=10) == t.search(q, k=10)


def test_ivf_hnsw_save_clears_stale_clusters_as_jax(seam, tmp_path):
    for mod, extra in ((jih, {}), (tih, {"device": "cpu"})):
        d = str(tmp_path / mod.__name__)
        idx = mod.IVFHNSWIndex(n_clusters=4, nprobe=4, **extra)
        idx.build(_clustered(n_per=10, n_clusters=4))
        idx.save(d)
        small = [(f"new-{i}", v) for i, (_, v) in
                 enumerate(_clustered(n_per=5, n_clusters=2, seed=9))]
        idx2 = mod.IVFHNSWIndex(n_clusters=2, nprobe=2, **extra)
        idx2.build(small)
        idx2.save(d)
        loaded = mod.IVFHNSWIndex.load(d, **extra)
        assert len(loaded) == len(small) and all(e.startswith("new-") for e in loaded._where)


def test_ivf_hnsw_from_its_own_init_holds_recall():
    """From the port's own k-means++ draw (C22, C41): recall@10 >= 0.95
    against exact cosine search."""
    items = _clustered(n_per=150, n_clusters=8, spread=0.6)
    idx = tih.IVFHNSWIndex(n_clusters=8, nprobe=3, device="cpu")
    idx.build(items)
    assert idx.device.type == "cpu" and len(idx) == len(items)
    vn = tutil.normalize_rows(np.asarray([v for _, v in items]))
    hits = 0
    qs = _queries(items, 64, seed=11)
    for q in qs:
        qn = tutil.normalize_rows(q)
        want = {items[i][0] for i in np.argsort(-(vn @ qn))[:10]}
        hits += len({e for e, _ in idx.search(q, k=10)} & want)
    assert hits / (10 * len(qs)) >= 0.95


def test_ivf_hnsw_device_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tih.IVFHNSWIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        tvs.VectorSpaceRegistry()


# -- the registry -----------------------------------------------------------


@pytest.mark.parametrize("backend", ["brute", "hnsw", "ivf_hnsw", "ivfpq", "cagra", "auto"])
@pytest.mark.parametrize("profile", ["balanced", "compressed", "cagra"])
def test_registry_builds_every_backend_as_jax(backend, profile, monkeypatch):
    monkeypatch.setenv("NORNICDB_VECTOR_ANN_QUALITY", profile)
    jreg, treg = jvs.VectorSpaceRegistry(), tvs.VectorSpaceRegistry(device="cpu")
    js = jreg.get_or_create(database="x", vector_name="v", dims=16, backend=backend)
    ts = treg.get_or_create(database="x", vector_name="v", dims=16, backend=backend)
    assert ts.key.__dict__ == js.key.__dict__ and ts.backend == js.backend
    ji, ti = js.ensure_index(), ts.ensure_index()
    assert type(ti).__name__ == type(ji).__name__
    assert ts.ensure_index() is ti
    fields = ("dims", "m", "ef_construction", "ef_search", "nprobe", "n_clusters",
              "n_codes", "keep_vectors", "refine_factor", "degree", "itopk",
              "search_width", "min_n", "n_shards")
    want = {f: getattr(ji, f) for f in fields if hasattr(ji, f)}
    if type(ti).__name__ == "CagraIndex":  # the walk's breadth (ROADMAP C14)
        want.update(itopk=CAGRA_ITOPK, search_width=CAGRA_WIDTH)
    assert {f: getattr(ti, f) for f in fields if hasattr(ji, f)} == want
    dev = getattr(ti, "device", None)
    assert dev is None or str(dev) == "cpu"


def test_registry_refine_knob_and_errors_match_jax(monkeypatch):
    monkeypatch.setenv("NORNICDB_VECTOR_PQ_REFINE", "0")
    for reg in (jvs.VectorSpaceRegistry(), tvs.VectorSpaceRegistry(device="cpu")):
        assert reg.get_or_create(backend="ivfpq").ensure_index().keep_vectors is False
        with pytest.raises(ValueError, match="unknown backend"):
            reg.register(type(reg.get_or_create().key)(), backend="warp-drive")
        sp = reg.get_or_create(vector_name="late")
        sp.backend = "warp-drive"
        with pytest.raises(ValueError, match="unknown backend"):
            sp.ensure_index()


def test_registry_bookkeeping_matches_jax():
    outs = []
    for mod, reg in ((jvs, jvs.VectorSpaceRegistry()),
                     (tvs, tvs.VectorSpaceRegistry(device="cpu"))):
        sp = reg.get_or_create(database="db1", dims=128)
        same = reg.get_or_create(database="db1", dims=128) is sp and reg.get(sp.key) is sp
        chunk = reg.get_or_create(database="db1", vector_name=mod.CHUNK_VECTOR_NAME, dims=128)
        other = reg.get_or_create(database="db2")
        listed = [(k.database, k.vector_name) for k in reg.list("db1")]
        everything = len(reg.list())
        dropped = (reg.drop(other.key), reg.drop(other.key), reg.drop_database("db1"))
        outs.append((same, chunk is not sp, listed, everything, dropped, reg.list()))
    assert outs[0] == outs[1]


def test_registry_concurrent_ensure_index_builds_once():
    sp = tvs.VectorSpaceRegistry(device="cpu").get_or_create(database="r", backend="brute")
    got, barrier = [], threading.Barrier(8)

    def grab():
        barrier.wait()
        got.append(sp.ensure_index())

    threads = [threading.Thread(target=grab) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert len(got) == 8 and all(g is got[0] for g in got)


@pytest.mark.parametrize("tier", ["brute", "hnsw", "cagra"])
def test_service_opens_the_reference_s_spaces(tier, monkeypatch):
    from nornicdb_tpu.search.service import SearchService as JService
    from nornicdb_tpu_torch.search.service import SearchService as TService
    from nornicdb_tpu_torch.storage.types import Node as TNode
    from nornicdb_tpu.storage.types import Node as JNode

    if tier == "cagra":
        monkeypatch.setenv("NORNICDB_VECTOR_ANN_QUALITY", "cagra")
    kw = {"hnsw_threshold": 40} if tier != "brute" else {}
    items = _clustered(n_per=10)
    spaces = []
    for svc, node in ((JService(**kw), JNode), (TService(device="cpu", **kw), TNode)):
        for eid, v in items:
            svc.index_node(node(id=eid, labels=["Doc"], properties={"content": eid},
                                embedding=[float(x) for x in v]))
        reg = svc.vector_registry
        keys = sorted((k.database, k.entity_type, k.vector_name, k.dims, k.metric)
                      for k in reg.list())
        doc = reg.get(type(reg.list()[0])(database="neo4j"))
        named = {k.vector_name: reg.get(k).index for k in reg.list()}
        assert doc.index is svc.vectors and doc.backend == "brute"
        if tier == "hnsw":
            assert named["embedding_hnsw"] is svc.hnsw is not None
        if tier == "cagra":
            assert named["embedding_cagra"] is svc.cagra is not None
        spaces.append((keys, svc.stats.strategy,
                       [e for e, _ in svc.vector_search_candidates(items[3][1], 5)]))
    assert spaces[0] == spaces[1]


def test_service_shares_a_registry_and_its_device():
    from nornicdb_tpu_torch.search.service import SearchService as TService

    reg = tvs.VectorSpaceRegistry(device="cpu")
    a = TService(device="cpu", vector_registry=reg, database="a")
    b = TService(device="cpu", vector_registry=reg, database="b")
    assert a.vector_registry is b.vector_registry is reg
    assert a.vectors is not b.vectors and str(a.vectors.device) == "cpu"
    assert sorted(k.database for k in reg.list()) == ["a", "b"]
