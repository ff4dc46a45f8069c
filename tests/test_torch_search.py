"""The port's search stack (BruteForceIndex, BM25Index, rrf_fuse,
SearchService through DB) against the JAX package on the same inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.embed.embedder import CachedEmbedder, JaxEncoderEmbedder
from nornicdb_tpu.models import encoder as jenc
from nornicdb_tpu.models import pretrain as jpre
from nornicdb_tpu.search.bm25 import BM25Index as JBM25
from nornicdb_tpu.search.rrf import rrf_fuse as j_rrf
from nornicdb_tpu.search.vector_index import BruteForceIndex as JIndex
from nornicdb_tpu_torch.embed.embedder import CachedEmbedder as TCached
from nornicdb_tpu_torch.models import checkpoint as tckpt
from nornicdb_tpu_torch.ops.topk import topk_agree
from nornicdb_tpu_torch.search.bm25 import BM25Index as TBM25
from nornicdb_tpu_torch.search.rrf import rrf_fuse as t_rrf
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex as TIndex

# cosine scores of the same unit vectors, summed in another order
SCORE_ATOL = 1e-5

# one intra-op thread: these tests run beside the suite's other workers on
# shared cores, and timing-sensitive tests there must not be starved
torch.set_num_threads(1)


def _words(rng, n_words=400):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, rng.integers(3, 9))) for _ in range(n_words)]


def _corpus(seed, n_docs=300):
    rng = np.random.default_rng(seed)
    vocab = _words(rng)
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = [" ".join(vocab[w] for w in rng.choice(len(vocab), rng.integers(10, 61), p=p))
            for _ in range(n_docs)]
    for i in range(0, 30, 3):  # exact duplicates -> exact vector ties
        docs[n_docs - 1 - i] = docs[i]
    queries = [" ".join(vocab[w] for w in rng.choice(len(vocab), rng.integers(2, 6), p=p))
               for _ in range(12)]
    return docs, queries + [docs[0], docs[7]]


def _hits_agree(a, b):
    """Tie-aware agreement of two [(id, score)] lists."""
    if len(a) != len(b):
        return False
    if not a:
        return True
    return topk_agree([[i for i, _ in a]], [[s for _, s in a]],
                      [[i for i, _ in b]], [[s for _, s in b]], SCORE_ATOL)


def _fill_both(rng, n, d, dup=True):
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        vecs[n // 2: n // 2 + 16] = vecs[:16]
    j, t = JIndex(), TIndex(device="cpu")
    for i, v in enumerate(vecs):
        j.add(f"n{i}", v)
        t.add(f"n{i}", v)
    return j, t, vecs


@pytest.mark.parametrize("n,d", [(300, 64), (2000, 160)])
def test_brute_force_index_matches_jax(n, d):
    """(300, 64) stays on the small-host rung; (2000, 160) clears it and
    goes through the fused top-k wrapper (its plain version here)."""
    rng = np.random.default_rng(n)
    j, t, vecs = _fill_both(rng, n, d)
    for idx in (j, t):  # removes, slot reuse and in-place updates
        for i in range(0, 40, 4):
            idx.remove(f"n{i}")
        idx.add("fresh", vecs[5] * 2.0)
        idx.add("n1", vecs[2])
    assert len(t) == len(j) and ("n0" in t) == ("n0" in j) and "fresh" in t
    np.testing.assert_array_equal(t.get("n1"), j.get("n1"))
    tm, tv, tid = t.snapshot()
    jm, jv, jid = j.snapshot()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    assert tid == jid
    queries = rng.standard_normal((6, d)).astype(np.float32)
    queries[:2] = vecs[[0, 17]]
    for k in (1, 10, 30):
        for a, b in zip(t.search_batch(queries, k), j.search_batch(queries, k)):
            assert _hits_agree(a, b)


def test_removes_compact_the_index_as_jax_does():
    """3,000 rows, 1,500 removed: both indexes compact at the 1,500th
    removal (1,024 dead rows and half the slots), so a row added after it
    lands behind every live row, and its exact tie with a live row T
    orders T first; capacity shrinks to pad_dim(1,500)."""
    rng = np.random.default_rng(12)
    j, t, vecs = _fill_both(rng, 3000, 160, dup=False)
    for idx in (j, t):
        for i in range(1499):
            idx.remove(f"n{i}")
        assert idx._capacity == 4096
        idx.remove("n1499")  # the last removed slot, 1,499, lies below T's
        assert idx._free == []
        idx.add("twin", vecs[2000])  # equal to T = n2000
    assert t._capacity == j._capacity == 2048
    assert t._slot_of["twin"] == j._slot_of["twin"] == 1500
    assert t._slot_of == j._slot_of and len(t) == len(j) == 1501
    queries = np.concatenate([vecs[[2000, 2999]], rng.standard_normal((4, 160))]).astype(np.float32)
    for k in (2, 10):
        tt, jj = t.search_batch(queries, k), j.search_batch(queries, k)
        assert [i for i, _ in tt[0][:2]] == [i for i, _ in jj[0][:2]] == ["n2000", "twin"]
        for a, b in zip(tt, jj):
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=SCORE_ATOL)
    assert t.compactions == j.compactions == 1
    assert not t.compact() and not j.compact()  # nothing dead left


def test_add_batch_equals_sequential_adds():
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((600, 32)).astype(np.float32)
    seq, bat = TIndex(device="cpu"), TIndex(device="cpu")
    for i, v in enumerate(vecs):
        seq.add(f"n{i % 500}", v)
    bat.add_batch([(f"n{i % 500}", v) for i, v in enumerate(vecs)])
    for a, b in zip(seq.snapshot(), bat.snapshot()):
        np.testing.assert_array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))


def test_index_rejects_dims_mismatch():
    t = TIndex(device="cpu")
    t.add("a", [1.0, 0.0])
    with pytest.raises(ValueError, match="dims mismatch"):
        t.add("b", [1.0, 0.0, 0.0])


def test_empty_index_answers_empty():
    assert TIndex(device="cpu").search_batch(np.ones((2, 4), np.float32), 5) == [[], []]


def test_bm25_matches_jax():
    docs, queries = _corpus(3, 400)
    j, t = JBM25(), TBM25()
    for idx in (j, t):
        for i, text in enumerate(docs):
            idx.index(f"d{i}", text)
        for i in range(0, 50, 5):  # updates and removes
            idx.index(f"d{i}", docs[i + 1])
            idx.remove(f"d{i + 2}")
    assert len(t) == len(j)
    assert all((f"d{i}" in t) == (f"d{i}" in j) for i in range(len(docs)))
    for q in queries:
        for k in (5, 30):
            assert t.search(q, k) == j.search(q, k)


def test_bm25_compaction_matches_jax():
    j, t = JBM25(), TBM25()
    for idx in (j, t):
        for rnd in range(3):
            for i in range(700):
                idx.index(f"d{i}", f"alpha beta{i % 7} gamma{rnd} term{i % 13}")
    for q in ("beta3 gamma2", "term5", "alpha"):
        assert t.search(q, 20) == j.search(q, 20)


def test_rrf_matches_jax():
    rng = np.random.default_rng(5)
    ids = [f"x{i}" for i in range(60)]
    for trial in range(20):
        lists = [[(i, float(rng.random())) for i in rng.choice(ids, rng.integers(0, 40),
                                                             replace=False)]
                 for _ in range(int(rng.integers(1, 4)))]
        weights = [] if trial % 2 else list(rng.random(len(lists)) + 0.5)
        for limit in (5, 90):
            assert (t_rrf(lists, weights=weights, limit=limit)
                    == j_rrf(lists, weights=weights, limit=limit))


@pytest.fixture(scope="module")
def two_dbs():
    """The same corpus in both packages, each with the mini checkpoint in
    float32 (both defaults run it in bf16), so vector scores agree to
    float32 sums."""
    path = jpre.default_checkpoint_path()
    jcfg, jparams = jpre.load_checkpoint(path)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    jdb = nornicdb_tpu.open(engine="memory", embedder=CachedEmbedder(
        JaxEncoderEmbedder(model=jenc.Encoder(jcfg), params=jparams, cfg=jcfg)))
    tdb = nornicdb_tpu_torch.open(device="cpu", embedder=TCached(
        tckpt.load_default_embedder(device="cpu", dtype=torch.float32)))
    docs, queries = _corpus(7)
    for db in (jdb, tdb):
        for i, text in enumerate(docs):
            db.store(text, labels=["Doc"], node_id=f"d{i}")
        db.flush()
    yield jdb, tdb, queries
    jdb.close()
    tdb.close()


@pytest.mark.parametrize("mode", ["vector", "text", "hybrid"])
def test_search_matches_jax_end_to_end(two_dbs, mode):
    jdb, tdb, queries = two_dbs
    for q in queries:
        for limit in (5, 10):
            th = tdb.search.search(q, limit=limit, mode=mode)
            jh = jdb.search.search(q, limit=limit, mode=mode)
            assert th, (mode, q)
            assert all(h["properties"]["content"] and h["labels"] == ["Doc"] for h in th)
            if mode == "vector":
                assert _hits_agree([(h["id"], h["score"]) for h in th],
                                   [(h["id"], h["score"]) for h in jh])
            else:
                assert [h["id"] for h in th] == [h["id"] for h in jh], (mode, q)


def test_recall_min_score_and_labels_match_jax(two_dbs):
    jdb, tdb, queries = two_dbs
    for q in queries[:4]:
        for kw in ({"min_score": 0.5}, {"labels": ["Nope"]}, {"weights": [2.0, 0.5]}):
            assert ([h["id"] for h in tdb.recall(q, **kw)]
                    == [h["id"] for h in jdb.recall(q, **kw)]), kw


def test_db_store_remove_and_explicit_embeddings():
    db = nornicdb_tpu_torch.open(device="cpu", auto_embed=False)
    try:
        db.store("alpha beta", node_id="a", embedding=[1.0, 0.0, 0.0])
        db.store("gamma delta", node_id="b", embedding=[0.0, 1.0, 0.0])
        assert [h["id"] for h in db.recall("alpha", mode="text")] == ["a"]
        db.store("alpha again", node_id="c", embedding=[0.9, 0.1, 0.0])
        hits = db.search.search(query_embedding=[1.0, 0.0, 0.0], mode="vector")
        assert [h["id"] for h in hits] == ["a", "c", "b"]
        db.storage.delete_node("a")
        db.search.remove_node("a")
        assert [h["id"] for h in db.recall("alpha", mode="text")] == ["c"]
        # an unknown mode reads neither source, as in the reference
        assert db.recall("alpha", mode="bogus") == []
    finally:
        db.close()


def test_unknown_mode_answers_empty_and_cached_like_jax():
    """ROADMAP C12: both DBs on the same stores answer an unknown mode
    with ``[]``, and a repeat is a cache hit in both."""
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False)
    jdb = nornicdb_tpu.open(auto_embed=False)
    try:
        for db in (tdb, jdb):
            db.store("alpha beta", node_id="a", embedding=[1.0, 0.0, 0.0])
            db.store("alpha gamma", node_id="b", embedding=[0.0, 1.0, 0.0])
            assert [h["id"] for h in db.recall("alpha", mode="text")]
            hits0 = db.search.stats.cache_hits
            assert db.recall("alpha", mode="bogus") == []
            assert db.recall("alpha", mode="bogus") == []
            assert db.search.stats.cache_hits == hits0 + 1
            assert db.search.search(query_embedding=[1.0, 0.0, 0.0], mode="bogus") == []
        assert tdb.search.stats.searches == jdb.search.stats.searches
    finally:
        tdb.close()
        jdb.close()


class _RaisingEmbedder:
    dims = 3

    def embed(self, text):
        raise RuntimeError("embedder down")

    def embed_batch(self, texts):
        raise RuntimeError("embedder down")


def test_a_failing_query_embed_raises_where_jax_answers_text():
    """ROADMAP C5 (divergence by design): the reference fails open to
    text-only hits when the query embed raises; the port raises, so a
    fault on the card cannot hide behind a text answer."""
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False, embedder=_RaisingEmbedder())
    jdb = nornicdb_tpu.open(auto_embed=False, embedder=_RaisingEmbedder())
    try:
        for db in (tdb, jdb):
            db.store("alpha beta", node_id="a", embedding=[1.0, 0.0, 0.0])
            db.store("gamma delta", node_id="b", embedding=[0.0, 1.0, 0.0])
        assert [h["id"] for h in jdb.recall("alpha")] == ["a"]
        assert [h["id"] for h in jdb.recall("alpha", mode="vector")] == []
        for mode in ("hybrid", "vector"):
            with pytest.raises(RuntimeError, match="embedder down"):
                tdb.recall("alpha", mode=mode)
        # text mode and explicit embeddings never call the embedder
        for kw in ({"mode": "text"}, {"query_embedding": [0.0, 1.0, 0.0]}):
            assert ([h["id"] for h in tdb.recall("gamma", **kw)]
                    == [h["id"] for h in jdb.recall("gamma", **kw)]), kw
    finally:
        tdb.close()
        jdb.close()


def test_a_raising_switch_under_store_raises_where_jax_returns_the_node(monkeypatch, tmp_path):
    """ROADMAP C13 (divergence by design): the write that crosses the
    HNSW threshold switches tiers, and here the host library cannot be
    built. The reference's loader takes its Python path and its store
    returns the node; the port's build raises through ``DB.store`` after
    the node is stored and indexed in BM25 and brute force, and the
    result cache is still invalidated."""
    from nornicdb_tpu.search import hnsw_native as jnative
    from nornicdb_tpu_torch.ops import _build
    from nornicdb_tpu_torch.search import hnsw_native as tnative

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_host_failed", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    rng = np.random.default_rng(38)
    vecs = rng.standard_normal((400, 8)).astype(np.float32)  # past HNSW's bootstrap
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False)
    jdb = nornicdb_tpu.open(auto_embed=False)
    try:
        for db in (tdb, jdb):
            db.recall("warm", mode="text")  # builds the search service
            for i, v in enumerate(vecs[:-1]):
                db.store(f"doc {i}", node_id=f"d{i}", embedding=[float(x) for x in v])
            db.search.hnsw_threshold = len(vecs)
        last = [float(x) for x in vecs[-1]]
        node = jdb.store("alpha crossing", node_id="c", embedding=last)
        assert node.id == "c" and jdb.search.stats.strategy == "hnsw"
        svc = tdb.search
        gen = svc.generation
        with pytest.raises(RuntimeError, match=r"no host C\+\+ compiler"):
            tdb.store("alpha crossing", node_id="c", embedding=last)
        assert tdb.storage.get_node("c").embedding == last
        assert "c" in svc.vectors and svc.hnsw is None and svc.stats.strategy == "brute"
        assert svc.generation == gen + 1
        for db in (tdb, jdb):
            assert [h["id"] for h in db.recall("alpha", mode="text")] == ["c"]
    finally:
        tdb.close()
        jdb.close()


def test_db_store_of_a_mismatched_embedding_matches_jax():
    """An explicit embedding of another width than the built index is
    indexed best-effort, as the reference does: the node is stored and
    returned, stays recallable by text, and the vector index is unchanged."""
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False)
    jdb = nornicdb_tpu.open(auto_embed=False)
    try:
        for db in (tdb, jdb):
            db.store("alpha", node_id="a", embedding=[1.0, 0.0, 0.0, 0.0])
            db.recall("alpha", mode="text")  # builds the search service
            node = db.store("beta", node_id="b", embedding=[1.0, 0.0, 0.0])
            assert node.id == "b" and node.embedding == [1.0, 0.0, 0.0]
        assert ([h["id"] for h in tdb.recall("beta", mode="text")]
                == [h["id"] for h in jdb.recall("beta", mode="text")] == ["b"])
        assert len(tdb.search.vectors) == len(jdb.search.vectors) == 1
    finally:
        tdb.close()
        jdb.close()


# -- the strategy machine, HNSW tier and result cache ------------------------

from nornicdb_tpu.search.service import SearchService as JService  # noqa: E402
from nornicdb_tpu.storage.memory import MemoryEngine as JEngine  # noqa: E402
from nornicdb_tpu.storage.types import Node as JNode  # noqa: E402
from nornicdb_tpu_torch.search import cagra as t_cagra  # noqa: E402
from nornicdb_tpu_torch.search.service import HNSW_EF_SEARCH  # noqa: E402
from nornicdb_tpu_torch.search.service import SearchService as TService  # noqa: E402
from nornicdb_tpu_torch.storage.memory import MemoryEngine as TEngine  # noqa: E402
from nornicdb_tpu_torch.storage.types import Node as TNode  # noqa: E402

HNSW_THRESHOLD = 256
HNSW_D = 32
# both packages' HNSW compute the same float32 sums in the same order
HNSW_SCORE_ATOL = 1e-6


def _zipf_corpus(seed, n_docs):
    rng = np.random.default_rng(seed)
    vocab = _words(rng, 600)
    p = 1.0 / np.arange(1, len(vocab) + 1) ** 1.1
    p /= p.sum()
    return [" ".join(vocab[w] for w in rng.choice(len(vocab), rng.integers(5, 40), p=p))
            for _ in range(n_docs)]


@pytest.mark.parametrize("corpus", ["parity300", "zipf"])
def test_bm25_seed_doc_ids_match_jax(corpus):
    docs = _corpus(7)[0] if corpus == "parity300" else _zipf_corpus(21, 2500)
    j, t = JBM25(), TBM25()
    for idx in (j, t):
        for i, text in enumerate(docs):
            idx.index(f"d{i}", text)
        for i in range(0, 60, 6):  # updates and removes change df
            idx.index(f"d{i}", docs[i + 1])
            idx.remove(f"d{i + 3}")
    for kw in ({}, {"max_seeds": 64, "n_terms": 16}, {"max_seeds": 500, "per_term": 3}):
        seeds = t.seed_doc_ids(**kw)
        assert seeds == j.seed_doc_ids(**kw), kw
        assert seeds and len(seeds) == len(set(seeds))
    assert TBM25().seed_doc_ids() == []


def _hnsw_corpus(n_docs, seed=31):
    """Clustered vectors with texts that share a topic word per cluster."""
    rng = np.random.default_rng(seed)
    docs = _zipf_corpus(seed, n_docs)
    centers = rng.standard_normal((24, HNSW_D)).astype(np.float32) * 3.0
    topic = rng.integers(0, 24, n_docs)
    vecs = (centers[topic] + rng.standard_normal((n_docs, HNSW_D))).astype(np.float32)
    docs = [f"topic{c} {text}" for c, text in zip(topic, docs)]
    queries = (centers[rng.integers(0, 24, 12)]
               + rng.standard_normal((12, HNSW_D)).astype(np.float32))
    texts = [f"topic{int(c)} {docs[int(i)].split()[1]}" for c, i in
             zip(rng.integers(0, 24, 12), rng.integers(0, n_docs, 12))]
    return docs, vecs, queries.astype(np.float32), texts


def _node(cls, i, text, vec):
    return cls(id=f"d{i}", labels=["Doc"], properties={"content": text},
               embedding=[float(x) for x in vec])


def _both_services(**kw):
    """Both services at the port's query beam (its default differs from
    the reference's 64, ROADMAP C11; the graph does not)."""
    kw.setdefault("hnsw_ef_search", HNSW_EF_SEARCH)
    return (JService(JEngine(), hnsw_threshold=HNSW_THRESHOLD, **kw),
            TService(TEngine(), device="cpu", hnsw_threshold=HNSW_THRESHOLD, **kw))


def _index_both(pair, docs, vecs, start=0):
    """Live writes, one node at a time; returns the write each service
    switched at."""
    switched = [None, None]
    for i in range(start, len(docs)):
        for s, (svc, cls) in enumerate(zip(pair, (JNode, TNode))):
            node = _node(cls, i, docs[i], vecs[i])
            svc.storage.create_node(node)
            svc.index_node(node)
            if switched[s] is None and svc.stats.strategy == "hnsw":
                switched[s] = i
    return switched


def _index_port(svc, docs, vecs):
    for i, (text, v) in enumerate(zip(docs, vecs)):
        node = _node(TNode, i, text, v)
        svc.storage.create_node(node)
        svc.index_node(node)


def _assert_hits_close(a, b):
    assert [i for i, _ in a] == [i for i, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=HNSW_SCORE_ATOL)


def _assert_service_parity(pair, queries, texts):
    j, t = pair
    for qv, text in zip(queries, texts):
        for k in (10, 30):
            _assert_hits_close(t.vector_search_candidates(qv, k),
                               j.vector_search_candidates(qv, k))
        for mode, kw in (("vector", {"query_embedding": qv}), ("text", {"query": text}),
                         ("hybrid", {"query": text, "query_embedding": qv})):
            th = t.search(mode=mode, limit=10, **kw)
            jh = j.search(mode=mode, limit=10, **kw)
            assert [h["id"] for h in th] == [h["id"] for h in jh], (mode, text)
            np.testing.assert_allclose([h["score"] for h in th], [h["score"] for h in jh],
                                       atol=HNSW_SCORE_ATOL)
            assert all(h["properties"]["content"] for h in th)


@pytest.fixture(scope="module", params=[HNSW_EF_SEARCH, 64], ids=["port_ef", "reference_ef"])
def hnsw_services(request):
    docs, vecs, queries, texts = _hnsw_corpus(600)
    pair = _both_services(hnsw_ef_search=request.param)
    switched = _index_both(pair, docs, vecs)
    assert pair[1].hnsw.ef_search == pair[0].hnsw.ef_search == request.param
    return pair, docs, vecs, queries, texts, switched


def test_services_switch_to_hnsw_at_the_same_write(hnsw_services):
    pair, docs, vecs, queries, texts, switched = hnsw_services
    assert switched == [HNSW_THRESHOLD - 1, HNSW_THRESHOLD - 1]
    for svc in pair:
        assert svc.stats.strategy == "hnsw" and svc.stats.hnsw_builds == 1
        assert len(svc.hnsw) == len(docs)
    # the build is the reference's graph: BM25 seeds, slot order, RNG
    j, t = pair
    for lv in range(len(j.hnsw._nbrL)):
        np.testing.assert_array_equal(t.hnsw._nbrL[lv], j.hnsw._nbrL[lv])
    assert t.hnsw._levels == j.hnsw._levels


def test_service_hnsw_answers_match_jax(hnsw_services):
    pair, docs, vecs, queries, texts, _ = hnsw_services
    _assert_service_parity(pair, queries, texts)


def test_service_exact_takes_brute_force(hnsw_services):
    pair, docs, vecs, queries, texts, _ = hnsw_services
    j, t = pair
    for qv in queries:
        exact = t.vector_search_candidates(qv, 20, exact=True)
        assert _hits_agree(exact, t.vectors.search_batch(qv[None, :], 20)[0])
        assert _hits_agree(exact, j.vector_search_candidates(qv, 20, exact=True))
    # HNSW answers hold recall@10 >= 0.95 against exact
    hit = sum(len({i for i, _ in t.vector_search_candidates(qv, 10)}
                  & {i for i, _ in t.vector_search_candidates(qv, 10, exact=True)})
              for qv in queries)
    assert hit / (10 * len(queries)) >= 0.95


def test_service_result_cache_matches_jax():
    docs, vecs, queries, texts = _hnsw_corpus(300, seed=32)
    pair = _both_services()
    _index_both(pair, docs, vecs)
    for svc in pair:
        first = svc.search(texts[0], limit=5, mode="text")
        hits0 = svc.stats.cache_hits
        again = svc.search(texts[0], limit=5, mode="text")
        assert again == first and svc.stats.cache_hits == hits0 + 1
        again[0]["properties"]["content"] = "mutated"
        assert svc.search(texts[0], limit=5, mode="text") == first
        # an explicit query embedding bypasses the cache
        svc.search(mode="vector", query_embedding=queries[0], limit=5)
        svc.search(mode="vector", query_embedding=queries[0], limit=5)
        assert svc.stats.cache_hits == hits0 + 2
    gens = [svc.generation for svc in pair]
    _index_both(pair, docs + [texts[0]], np.concatenate([vecs, queries[:1]]), start=len(docs))
    for svc, gen in zip(pair, gens):
        hits = svc.stats.cache_hits
        assert svc.generation == gen + 1
        assert "d300" in [h["id"] for h in svc.search(texts[0], limit=5, mode="text")]
        assert svc.stats.cache_hits == hits  # the write invalidated it
    assert pair[0].stats.searches == pair[1].stats.searches


def test_service_removes_force_a_tombstone_rebuild_matching_jax():
    docs, vecs, queries, texts = _hnsw_corpus(600, seed=33)
    pair = _both_services()
    _index_both(pair, docs, vecs)
    for i in range(0, 600, 4):  # a quarter of the vectors: past 0.2
        for svc in pair:
            svc.remove_node(f"d{i}")
            svc.storage.delete_node(f"d{i}")
    for svc in pair:
        assert svc.stats.hnsw_builds == 2 and svc.stats.strategy == "hnsw"
        assert not svc.hnsw.should_rebuild()
    assert pair[0].hnsw._levels == pair[1].hnsw._levels
    _assert_service_parity(pair, queries, texts)
    for qv in queries:
        hits = pair[1].vector_search_candidates(qv, 30)
        assert not {f"d{i}" for i in range(0, 600, 4)} & {i for i, _ in hits}


def test_service_diag_timings(monkeypatch):
    docs, vecs, queries, texts = _hnsw_corpus(64, seed=34)
    svc = TService(TEngine(), device="cpu")
    _index_port(svc, docs, vecs)
    monkeypatch.setenv("NORNICDB_TPU_SEARCH_DIAG", "1")
    svc.search(texts[0], query_embedding=queries[0], mode="hybrid")
    assert set(svc.stats.last_timings) == {"embed_ms", "bm25_ms", "vector_ms",
                                           "fuse_ms", "enrich_rerank_ms"}
    monkeypatch.delenv("NORNICDB_TPU_SEARCH_DIAG")
    svc.search(texts[0], mode="text")
    assert svc.stats.last_timings == {}


def _launch_failed(*args, **kw):
    raise RuntimeError("cosine_topk kernel: launch failed")


def test_service_raises_on_the_cagra_profile(monkeypatch):
    """Under the cagra profile a graph build whose B1 launch fails raises
    at the crossing write; no graph serves and the strategy stays brute."""
    monkeypatch.setenv("NORNICDB_VECTOR_ANN_QUALITY", "cagra")
    monkeypatch.setattr(t_cagra, "fused_cosine_topk", _launch_failed)
    docs, vecs, _, _ = _hnsw_corpus(HNSW_THRESHOLD, seed=35)
    svc = TService(TEngine(), device="cpu", hnsw_threshold=HNSW_THRESHOLD)
    with pytest.raises(RuntimeError, match="launch failed"):
        _index_port(svc, docs, vecs)
    assert svc.hnsw is None and svc.cagra is None and svc.stats.strategy == "brute"


def test_a_raising_switch_still_invalidates_the_cache(monkeypatch):
    """The crossing write is in the indexes even when the switch raises,
    so the cache generation must move with it."""
    docs, vecs, _, texts = _hnsw_corpus(HNSW_THRESHOLD, seed=37)
    svc = TService(TEngine(), device="cpu", hnsw_threshold=HNSW_THRESHOLD)
    _index_port(svc, docs[:-1], vecs[:-1])
    first = svc.search(texts[0], limit=5, mode="text")
    svc.search(texts[0], limit=5, mode="text")
    hits, gen = svc.stats.cache_hits, svc.generation
    assert hits == 1
    monkeypatch.setenv("NORNICDB_VECTOR_ANN_QUALITY", "cagra")
    monkeypatch.setattr(t_cagra, "fused_cosine_topk", _launch_failed)
    last = len(docs) - 1
    node = _node(TNode, last, texts[0], vecs[last])
    svc.storage.create_node(node)
    with pytest.raises(RuntimeError, match="launch failed"):
        svc.index_node(node)
    assert svc.generation == gen + 1 and svc.hnsw is None and svc.cagra is None
    again = svc.search(texts[0], limit=5, mode="text")
    assert svc.stats.cache_hits == hits  # a miss, not the stale entry
    assert f"d{last}" in [h["id"] for h in again] and again != first
    storage = TEngine()
    storage.create_node(node)
    backfill = TService(storage, device="cpu", hnsw_threshold=1)
    gen = backfill.generation
    with pytest.raises(RuntimeError, match="launch failed"):
        backfill.build_indexes()
    assert backfill.generation > gen


def test_backfill_switches_once_and_builds_once():
    docs, vecs, queries, _ = _hnsw_corpus(900, seed=36)
    storage = TEngine()
    for i, (text, v) in enumerate(zip(docs, vecs)):
        storage.create_node(_node(TNode, i, text, v))
    svc = TService(storage, device="cpu", hnsw_threshold=HNSW_THRESHOLD)
    assert svc.build_indexes() == len(docs)
    assert svc.stats.strategy == "hnsw" and svc.stats.hnsw_builds == 1
    assert len(svc.hnsw) == len(docs) == svc.stats.indexed_vectors
    hit = sum(len({i for i, _ in svc.vector_search_candidates(qv, 10)}
                  & {i for i, _ in svc.vector_search_candidates(qv, 10, exact=True)})
              for qv in queries)
    assert hit / (10 * len(queries)) >= 0.95
    # a live write after the backfill is one insert, not a rebuild
    node = _node(TNode, 900, "late doc", queries[0])
    storage.create_node(node)
    svc.index_node(node)
    assert svc.stats.hnsw_builds == 1 and "d900" in svc.hnsw
    assert svc.vector_search_candidates(queries[0], 1)[0][0] == "d900"


# -- the cagra profile and the walk tier ---------------------------------------

CAGRA_DOCS = 1500


@pytest.fixture(params=["reference", "port"])
def cagra_env(request, monkeypatch):
    """Both services under the cagra profile at one walk setting, the
    reference's (64, 1) or the port's defaults (ROADMAP C14), with the
    k-NN edges of the JAX package (held tie-aware in test_torch_cagra.py)."""
    from nornicdb_tpu.search import ann_quality as jann
    from nornicdb_tpu.search import cagra as j_cagra
    from nornicdb_tpu_torch.search import ann_quality as tann

    monkeypatch.setenv("NORNICDB_VECTOR_ANN_QUALITY", "cagra")
    setting = (64, 1) if request.param == "reference" else (tann.CAGRA_ITOPK, tann.CAGRA_WIDTH)
    for mod in (jann, tann):
        for name in ("cagra", "balanced"):
            monkeypatch.setitem(mod.PROFILES, name, dataclasses.replace(
                mod.PROFILES[name], cagra_itopk=setting[0], cagra_width=setting[1]))
    monkeypatch.setattr(t_cagra, "knn_forward",
                        lambda m, degree: j_cagra._knn_forward(m.cpu().numpy(), degree))
    return request.param, setting


def _cagra_services():
    return (JService(JEngine(), hnsw_threshold=CAGRA_DOCS),
            TService(TEngine(), device="cpu", hnsw_threshold=CAGRA_DOCS))


def test_service_cagra_profile_builds_once_and_walks_as_jax(cagra_env):
    name, (itopk, width) = cagra_env
    docs, vecs, queries, texts = _hnsw_corpus(CAGRA_DOCS, seed=39)
    pair = _cagra_services()
    _index_both(pair, docs[:-1], vecs[:-1])
    assert all(svc.cagra is None and svc.stats.strategy == "brute" for svc in pair)
    _index_both(pair, docs, vecs, start=len(docs) - 1)  # the crossing write
    for svc in pair:
        assert svc.stats.strategy == "cagra" and svc.stats.cagra_builds == 1
        assert svc.hnsw is None and svc.cagra.graph_built and svc.cagra._brute is svc.vectors
    j, t = pair
    assert (t.cagra.itopk, t.cagra.search_width) == (itopk, width)
    np.testing.assert_array_equal(t.cagra._graph["adj"].numpy(), np.asarray(j.cagra._graph["adj"]))
    for qv in queries:
        for k in (10, 30):
            assert _hits_agree(t.vector_search_candidates(qv, k), j.vector_search_candidates(qv, k))
    # every vector query rode the batcher into the walk
    assert t.cagra.counts["walk"] == t.microbatch_stats()["batches"] == 2 * len(queries)
    for qv, text in zip(queries, texts):
        for mode, kw in (("vector", {"query_embedding": qv}),
                         ("hybrid", {"query": text, "query_embedding": qv})):
            th = t.search(mode=mode, limit=10, **kw)
            jh = j.search(mode=mode, limit=10, **kw)
            assert [h["id"] for h in th] == [h["id"] for h in jh], (mode, text)
    # exact=True takes brute force, never the walk
    walks = t.cagra.counts["walk"]
    for qv in queries:
        assert _hits_agree(t.vector_search_candidates(qv, 10, exact=True),
                           j.vector_search_candidates(qv, 10, exact=True))
    assert t.cagra.counts["walk"] == walks
    if name == "port":  # ROADMAP C14: recall@10 >= 0.95 against exact
        hit = sum(len({i for i, _ in t.vector_search_candidates(qv, 10)}
                      & {i for i, _ in t.vector_search_candidates(qv, 10, exact=True)})
                  for qv in queries)
        assert hit / (10 * len(queries)) >= 0.95


def test_walk_tier_shares_the_cagra_strategys_graph_as_jax(cagra_env, monkeypatch):
    """Below the threshold the fused tier walks a graph of its own; the
    strategy's graph, once built, is rebound into it in place."""
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_WALK_F32

    for key, value in (("HYBRID_MIN_N", "50"), ("HYBRID_INLINE_BUILD", "1"),
                       ("HYBRID_WALK_MIN_N", "1000")):
        monkeypatch.setenv("NORNICDB_" + key, value)
    docs, vecs, queries, texts = _hnsw_corpus(CAGRA_DOCS, seed=40)
    pair = _cagra_services()
    _index_both(pair, docs[:-1], vecs[:-1])
    answers = [[svc.search(text, limit=10, query_embedding=qv) for svc in pair]
               for text, qv in zip(texts, queries)]
    own = pair[1]._fused.cagra
    assert own is not None and own.graph_built and pair[1].cagra is None
    _index_both(pair, docs, vecs, start=len(docs) - 1)
    for text, qv in zip(texts, queries):
        answers.append([svc.search(text, limit=10, query_embedding=qv) for svc in pair])
    for svc in pair:
        assert svc._fused.cagra is svc.cagra and svc.stats.cagra_builds == 1
    for jh, th in answers:
        assert [h["id"] for h in th] == [h["id"] for h in jh]
    fused = pair[1]._fused
    assert fused.counts["walk_dispatch"] == 2 * len(texts) and fused.counts["dispatch"] == 0
    assert fused.counts[TIER_WALK_F32] + fused.counts["host"] == 2 * len(texts)
    assert pair[1].cagra.builds == 1 and own.builds == 1


def test_hybrid_walk_off_keeps_the_brute_tier(monkeypatch):
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_BRUTE_F32, TIER_WALK_F32

    for key, value in (("HYBRID_MIN_N", "50"), ("HYBRID_INLINE_BUILD", "1"),
                       ("HYBRID_WALK_MIN_N", "100"), ("HYBRID_WALK", "0")):
        monkeypatch.setenv("NORNICDB_" + key, value)
    docs, vecs, queries, texts = _hnsw_corpus(300, seed=41)
    svc = TService(TEngine(), device="cpu")
    _index_port(svc, docs, vecs)
    off = svc.search(texts[0], limit=10, query_embedding=queries[0])
    assert svc._fused.walk_min_n is None and svc._fused.cagra is None
    assert svc._fused.counts[TIER_BRUTE_F32] == 1
    # read when the tier is created, as the reference does
    monkeypatch.delenv("NORNICDB_HYBRID_WALK")
    svc._fused = None
    on = svc.search(texts[0], limit=10, query_embedding=queries[0])
    assert svc._fused.walk_min_n == 100 and svc._fused.counts[TIER_WALK_F32] == 1
    assert [h["id"] for h in on] == [h["id"] for h in off]
