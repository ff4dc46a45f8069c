"""The search service's stage-2 reranker (``nornicdb_tpu_torch/search/
rerank.py``, ``SearchService(reranker=...)``) and ``SearchService.similar``
against the JAX package's on the same inputs.

``LocalReranker`` must give the same order and ``rerank_score`` within
1e-6, and equal its formula recomputed in numpy; ``LLMReranker`` is driven
by a stub manager answering good, partial, fenced, bad and no JSON, and
one that raises. ``similar`` answers tie-aware ids with scores within
1e-5 below the HNSW threshold (B1's route; its plain version here) and
the reference's graph walk above it (threshold lowered, as
``tests/test_torch_search.py`` does). The C29 pins show a ``RuntimeError``
of the rerank stage propagating in the port where the JAX package
answers the fused order."""

import numpy as np
import pytest
import torch

from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.search import rerank as jrerank
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from nornicdb_tpu_torch.search import rerank as trerank
from test_torch_search import (HNSW_SCORE_ATOL, HNSW_THRESHOLD, JService,
                               TService, _both_services, _hits_agree, _hnsw_corpus,
                               _index_both, _words)

torch.set_num_threads(1)

RERANK_ATOL = 1e-6


def _candidates(seed, n=24, dims=32, with_embeddings=True):
    """Fused candidates as the service hands them over: ids, properties,
    some with a vector score, some with their own embedding."""
    rng = np.random.default_rng(seed)
    vocab = _words(rng, 60)
    out = []
    for i in range(n):
        c = {"id": f"c{i}", "score": float(1.0 / (60 + i)),
             "properties": {"content": " ".join(rng.choice(vocab, 8)), "n": int(i)},
             "labels": ["Doc"]}
        if i % 3:
            c["vector_score"] = float(rng.uniform(-1, 1))
        if with_embeddings and i % 4 == 0:
            c["_embedding"] = rng.standard_normal(dims).astype(np.float32).tolist()
        out.append(c)
    query = " ".join(rng.choice(vocab, 3))
    return query, out, rng.standard_normal(dims).astype(np.float32)


def _formula(query, cands, qv, alpha):
    """The LocalReranker's scores, recomputed in numpy."""
    import re

    def terms(t):
        return set(re.findall(r"[a-z0-9]+", t.lower()))

    q = terms(query)
    lex = np.array([len(q & terms(" ".join(str(v) for v in c["properties"].values()))) / len(q)
                    if q else 0.0 for c in cands], np.float32)
    cos = np.zeros(len(cands), np.float32)
    if qv is not None:
        qn = qv / max(np.linalg.norm(qv), 1e-12)
        for i, c in enumerate(cands):
            if "_embedding" in c:
                v = np.asarray(c["_embedding"], np.float32)
                cos[i] = float((v / max(np.linalg.norm(v), 1e-12)) @ qn)
            else:
                cos[i] = float(c.get("vector_score") or 0.0)
    return alpha * cos + (1.0 - alpha) * lex


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alpha", [0.7, 0.3])
@pytest.mark.parametrize("source", ["query_embedding", "embedder", "lexical"])
@pytest.mark.parametrize("limit", [None, 5])
def test_local_reranker_matches_jax(seed, alpha, source, limit):
    query, cands, qv = _candidates(seed, dims=256 if source == "embedder" else 32)
    kw = {"limit": limit}
    if source == "query_embedding":
        kw["query_embedding"] = qv
    jr = jrerank.LocalReranker(JHash() if source == "embedder" else None, alpha=alpha)
    tr = trerank.LocalReranker(THash() if source == "embedder" else None, alpha=alpha)
    want = jr.rerank(query, [dict(c) for c in cands], **kw)
    got = tr.rerank(query, [dict(c) for c in cands], **kw)
    assert [c["id"] for c in got] == [c["id"] for c in want]
    np.testing.assert_allclose([c["rerank_score"] for c in got],
                               [c["rerank_score"] for c in want], atol=RERANK_ATOL, rtol=0)
    assert len(got) == (limit or len(cands))
    qref = {"query_embedding": qv, "embedder": np.asarray(THash().embed(query), np.float32),
            "lexical": None}[source]
    scores = _formula(query, cands, qref, alpha)
    by_id = {c["id"]: s for c, s in zip(cands, scores)}
    np.testing.assert_allclose([c["rerank_score"] for c in got],
                               [by_id[c["id"]] for c in got], atol=RERANK_ATOL, rtol=0)
    assert all(a["rerank_score"] >= b["rerank_score"] for a, b in zip(got, got[1:]))


def test_local_reranker_empty_and_untouched_input():
    for mod in (jrerank, trerank):
        assert mod.LocalReranker().rerank("q", []) == []
    query, cands, qv = _candidates(5)
    before = [dict(c) for c in cands]
    trerank.LocalReranker().rerank(query, cands, query_embedding=qv)
    assert cands == before  # copies out, the fused list stays as it was


class _Reply:
    def __init__(self, text):
        self.text = text


class _StubManager:
    """Answers each generate with the next reply (a string, or an
    exception to raise); records the prompts."""

    def __init__(self, *replies):
        self.replies = list(replies)
        self.calls = []

    def generate(self, prompt, model=None, max_tokens=None):
        self.calls.append((prompt, model, max_tokens))
        r = self.replies.pop(0)
        if isinstance(r, Exception):
            raise r
        return _Reply(r)


LLM_REPLIES = {
    "good": '["c3", "c1", "c0", "c2", "c5", "c4"]',
    "partial": 'Sure: ["c4", "c2"] are best.',
    "unknown_ids": '["zz", "c5", 7]',
    "fenced": '```json\n["c5",\n "c0"]\n```',
    "bad_json": '["c1", "c2"',
    "no_json": "I cannot rank these.",
    "empty_list": "[]",
    "raises": ValueError("backend down"),
}


@pytest.mark.parametrize("reply", list(LLM_REPLIES), ids=list(LLM_REPLIES))
@pytest.mark.parametrize("limit", [None, 3])
def test_llm_reranker_matches_jax(reply, limit):
    """Good output reorders (ids the model forgot keep their order);
    partial, fenced and unknown ids are handled alike; bad or no output
    and a raising backend leave the fused order (the fail-open contract
    on model output, kept in the port)."""
    _, cands, _ = _candidates(9, n=6, with_embeddings=False)
    jm, tm = _StubManager(LLM_REPLIES[reply]), _StubManager(LLM_REPLIES[reply])
    want = jrerank.LLMReranker(jm, model="m").rerank("q", [dict(c) for c in cands], limit=limit)
    got = trerank.LLMReranker(tm, model="m").rerank("q", [dict(c) for c in cands], limit=limit)
    assert got == want
    assert tm.calls == jm.calls and tm.calls[0][1:] == ("m", 256)
    if reply in ("bad_json", "no_json", "empty_list", "raises"):
        assert [c["id"] for c in got] == [c["id"] for c in cands][: limit or 6]


def test_llm_reranker_skips_the_model_under_two_candidates():
    m = _StubManager()
    _, cands, _ = _candidates(9, n=1, with_embeddings=False)
    assert trerank.LLMReranker(m).rerank("q", cands) == cands and m.calls == []


# -- the service with a reranker --------------------------------------------------


@pytest.fixture(scope="module")
def brute_services():
    """Both services below the HNSW threshold (exact brute force)."""
    docs, vecs, queries, texts = _hnsw_corpus(200, seed=41)
    pair = _both_services()
    _index_both(pair, docs, vecs)
    assert [s.stats.strategy for s in pair] == ["brute", "brute"]
    return pair, docs, vecs, queries, texts


@pytest.mark.parametrize("alpha", [0.7, 0.2])
def test_service_rerank_matches_jax(brute_services, alpha):
    """The whole fused overfetch is reranked with the query embedding the
    service computed, then cut to the limit; uncached."""
    (j, t), docs, vecs, queries, texts = brute_services
    try:
        j.reranker = jrerank.LocalReranker(alpha=alpha)
        t.reranker = trerank.LocalReranker(alpha=alpha)
        searches = t.stats.searches
        for qv, text in zip(queries, texts):
            for limit in (5, 10):
                kw = {"query": text, "query_embedding": qv, "limit": limit}
                th, jh = t.search(**kw), j.search(**kw)
                assert [h["id"] for h in th] == [h["id"] for h in jh], text
                np.testing.assert_allclose([h["rerank_score"] for h in th],
                                           [h["rerank_score"] for h in jh],
                                           atol=RERANK_ATOL, rtol=0)
                assert len(th) == limit
        assert t.stats.cache_hits == 0 and t.stats.searches == searches + 2 * len(queries)
    finally:
        j.reranker = t.reranker = None


def test_service_rerank_reorders_beyond_the_limit(brute_services):
    """A reranker that reverses the list surfaces candidates the fused
    order ranked below the limit: it is handed the whole fused list (whose
    head is the plain answer) and the query embedding, in both packages."""
    (j, t), docs, vecs, queries, texts = brute_services

    class Reverse:
        def __init__(self):
            self.seen = []

        def rerank(self, query, candidates, query_embedding=None, limit=None):
            self.seen.append(([c["id"] for c in candidates], query_embedding is not None))
            return list(reversed(candidates))[: limit or len(candidates)]

    kw = {"query": texts[0], "query_embedding": queries[0], "limit": 5}
    plain = [h["id"] for h in t.search(**kw)]
    rj, rt = Reverse(), Reverse()
    try:
        j.reranker, t.reranker = rj, rt
        th, jh = t.search(**kw), j.search(**kw)
    finally:
        j.reranker = t.reranker = None
    (seen, had_qv), = rt.seen
    assert rt.seen == rj.seen and had_qv and len(seen) > 5 and seen[:5] == plain
    assert [h["id"] for h in th] == [h["id"] for h in jh] == seen[::-1][:5]


class _DeviceFaultReranker:
    def rerank(self, *a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory")


class _ValueFaultReranker:
    def rerank(self, *a, **k):
        raise ValueError("bad candidate")


def test_service_rerank_device_fault_raises_where_jax_answers(brute_services):
    """ROADMAP C29: the reference fails open to the fused order on any
    rerank error; the port raises a RuntimeError (CUDA, out of memory,
    not ported) and keeps the fail-open for every other error."""
    (j, t), docs, vecs, queries, texts = brute_services
    kw = {"query": texts[1], "query_embedding": queries[1], "limit": 7}
    plain = [h["id"] for h in t.search(**kw)]
    try:
        j.reranker = t.reranker = _DeviceFaultReranker()
        assert [h["id"] for h in j.search(**kw)] == plain
        with pytest.raises(torch.OutOfMemoryError):
            t.search(**kw)
        j.reranker = t.reranker = _ValueFaultReranker()
        assert [h["id"] for h in t.search(**kw)] == [h["id"] for h in j.search(**kw)] == plain
    finally:
        j.reranker = t.reranker = None


class _FaultEmbedder:
    dims = 256

    def __init__(self, exc):
        self.exc = exc

    def embed(self, text):
        raise self.exc


def test_local_reranker_embed_fault_raises_where_jax_ranks_by_terms():
    """ROADMAP C29: a device fault in the reranker's own query embed
    raises in the port; the reference ranks by terms alone. Any other
    embed error keeps the reference's lexical-only rerank."""
    query, cands, _ = _candidates(3, with_embeddings=False)
    fault = torch.OutOfMemoryError("CUDA out of memory")
    want = jrerank.LocalReranker(_FaultEmbedder(fault)).rerank(query, cands)
    assert want and want == jrerank.LocalReranker().rerank(query, cands)
    with pytest.raises(torch.OutOfMemoryError):
        trerank.LocalReranker(_FaultEmbedder(fault)).rerank(query, cands)
    other = _FaultEmbedder(KeyError("no such token"))
    assert trerank.LocalReranker(other).rerank(query, cands) == \
        jrerank.LocalReranker(other).rerank(query, cands) == want


# -- similar ----------------------------------------------------------------------


def _similar_agree(got, want, graph=False):
    """Brute tier: tie-aware ids, scores within SCORE_ATOL; the HNSW
    graph (the same in both packages): the same ids, scores within its
    tolerance."""
    assert [h["vector_score"] for h in got] == [h["score"] for h in got]
    assert all(h["properties"]["content"] and h["labels"] == ["Doc"] for h in got)
    if graph:
        assert [h["id"] for h in got] == [h["id"] for h in want]
        np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                                   atol=HNSW_SCORE_ATOL)
    else:
        assert _hits_agree([(h["id"], h["score"]) for h in got],
                           [(h["id"], h["score"]) for h in want])


@pytest.mark.parametrize("limit", [1, 10, 30])
def test_similar_below_the_hnsw_threshold_matches_jax(brute_services, limit):
    """Below the threshold ``similar`` rides the brute tier (B1's plain
    version on the CPU): tie-aware ids, scores within 1e-5, never the
    node itself."""
    (j, t), docs, vecs, queries, texts = brute_services
    brute = t.vector_routes["brute"]
    for i in range(0, len(docs), 13):
        nid = f"d{i}"
        got, want = t.similar(nid, limit), j.similar(nid, limit)
        assert len(got) == len(want) == limit and nid not in {h["id"] for h in got}
        _similar_agree(got, want)
        # the node's own nearest rows, itself left out
        exact = [(h, s) for h, s in t.vector_search_candidates(vecs[i], limit + 1, exact=True)
                 if h != nid][:limit]
        assert _hits_agree([(h["id"], h["score"]) for h in got], exact)
    assert t.vector_routes["brute"] > brute


def test_similar_of_a_missing_or_unembedded_node_is_empty(brute_services):
    (j, t), *_ = brute_services
    from nornicdb_tpu.storage.types import Node as JNode
    from nornicdb_tpu_torch.storage.types import Node as TNode

    j.storage.create_node(JNode(id="bare", labels=["Doc"], properties={"content": "x"}))
    t.storage.create_node(TNode(id="bare", labels=["Doc"], properties={"content": "x"}))
    for nid in ("nosuch", "bare"):
        assert t.similar(nid) == j.similar(nid) == []


def test_similar_through_a_chunk_embedding_matches_jax(brute_services):
    (j, t), docs, vecs, *_ = brute_services
    from nornicdb_tpu.storage.types import Node as JNode
    from nornicdb_tpu_torch.storage.types import Node as TNode

    chunk = (vecs[3] + 0.01).tolist()
    j.storage.create_node(JNode(id="chunked", labels=["Doc"], chunk_embeddings=[chunk]))
    t.storage.create_node(TNode(id="chunked", labels=["Doc"], chunk_embeddings=[chunk]))
    got, want = t.similar("chunked", 5), j.similar("chunked", 5)
    assert got[0]["id"] == "d3"
    _similar_agree(got, want)


@pytest.fixture(scope="module")
def hnsw_pair():
    docs, vecs, queries, texts = _hnsw_corpus(2 * HNSW_THRESHOLD, seed=43)
    pair = _both_services()
    _index_both(pair, docs, vecs)
    assert [s.stats.strategy for s in pair] == ["hnsw", "hnsw"]
    return pair, docs, vecs


def test_similar_above_the_hnsw_threshold_matches_jax(hnsw_pair):
    """Above the threshold ``similar`` walks the HNSW graph, which is the
    reference's: the same ids, scores within the graph's tolerance, and
    recall@10 >= 0.95 against exact."""
    (j, t), docs, vecs = hnsw_pair
    hnsw = t.vector_routes["hnsw"]
    hit = total = 0
    for i in range(0, len(docs), 17):
        nid = f"d{i}"
        got, want = t.similar(nid, 10), j.similar(nid, 10)
        _similar_agree(got, want, graph=True)
        exact = {h for h, _ in t.vector_search_candidates(vecs[i], 11, exact=True) if h != nid}
        hit += len({h["id"] for h in got} & exact)
        total += 10
    assert t.vector_routes["hnsw"] > hnsw
    assert hit / total >= 0.95


def test_services_take_a_reranker_at_construction():
    r = trerank.LocalReranker()
    assert TService(device="cpu", reranker=r).reranker is r
    assert TService(device="cpu").reranker is None
    assert JService(reranker=r).reranker is r
