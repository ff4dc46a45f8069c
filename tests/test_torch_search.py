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
        with pytest.raises(ValueError):
            db.recall("alpha", mode="bogus")
    finally:
        db.close()


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
