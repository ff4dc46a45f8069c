"""The port's CAGRA graph ANN (``search/cagra.py``) and the brute index's
changelog against the JAX package's, on the same seeded inputs, the port
on ``device="cpu"``.

Every parity test runs at two settings of the walk's search breadth: the
reference's (itopk 64, width 1) and the port's defaults (128, 8; ROADMAP
C14), passed to both packages. Tolerances: ``rank_reorder`` is bitwise;
the k-NN edges and walk rows are equal where no float tie decides them
(ids tie-aware), and scores agree within 1e-6 (the batched products sum
in another order than XLA's)."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.search import cagra as jc
from nornicdb_tpu.search.vector_index import BruteForceIndex as JIndex
from nornicdb_tpu_torch.ops.topk import topk_agree
from nornicdb_tpu_torch.search import cagra as tc
from nornicdb_tpu_torch.search.ann_quality import CAGRA_ITOPK, CAGRA_WIDTH
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex as TIndex

torch.set_num_threads(1)

SCORE_ATOL = 1e-6
D = 32
SETTINGS = [(64, 1), (CAGRA_ITOPK, CAGRA_WIDTH)]
SETTING_IDS = ["reference", "port"]


def _clustered(n, d=D, centers=12, seed=0, dup=0):
    rng = np.random.default_rng(seed)
    cent = (rng.standard_normal((centers, d)) * 2.0).astype(np.float32)
    x = cent[rng.integers(0, centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        x[n - dup:] = x[:dup]  # exact duplicates: tied cosines
    return x


def _queries(x, nq, seed=9, noise=0.3):
    rng = np.random.default_rng(seed)
    rows = rng.choice(len(x), nq, replace=False)
    return (x[rows] + noise * rng.standard_normal((nq, x.shape[1]))).astype(np.float32)


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _hits_agree(a, b, atol=SCORE_ATOL):
    if len(a) != len(b):
        return False
    return not a or topk_agree([[i for i, _ in a]], [[s for _, s in a]],
                               [[i for i, _ in b]], [[s for _, s in b]], atol)


# ---------------------------------------------------------------------------
# the brute index's changelog
# ---------------------------------------------------------------------------


def test_changelog_and_contains_many_match_jax():
    rng = np.random.default_rng(1)
    j, t = JIndex(), TIndex(device="cpu")
    seqs = []
    for step in range(60):
        eid = f"v{int(rng.integers(0, 20))}"
        for idx in (j, t):
            if step % 7 == 3:
                idx.remove(eid)
            else:
                idx.add(eid, rng.standard_normal(4).astype(np.float32))
        assert j.mutations == t.mutations
        seqs.append(j.mutations)
    for seq in [0] + seqs:
        assert t.changed_since(seq) == j.changed_since(seq), seq
    ids = [f"v{i}" for i in range(25)]
    assert t.contains_many(ids) == j.contains_many(ids)


def test_changelog_cap_moves_the_floor_as_jax():
    j, t = JIndex(), TIndex(device="cpu")
    items = [(f"v{i}", np.full(2, i + 1.0, np.float32)) for i in range(5000)]
    j.add_batch(items)
    t.add_batch(items)
    assert t.changelog_cap() == j.changelog_cap() == 4096
    assert t._changelog_floor == j._changelog_floor > 0
    for seq in (0, j._changelog_floor - 1, j._changelog_floor, 4990, 5000):
        assert t.changed_since(seq) == j.changed_since(seq), seq
    assert t.changed_since(0) is None


# ---------------------------------------------------------------------------
# the pieces of the graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [12, 16, 20])
def test_hash_matches_jax(bits):
    ids = np.arange(1 << 20, dtype=np.int32)
    want = np.asarray((jnp.asarray(ids).astype(jnp.uint32) * jc._HASH_MULT)
                      >> np.uint32(32 - bits)).astype(np.int64)
    got = tc.hash_bucket(torch.from_numpy(ids), bits).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,degree,dup", [(1500, 32, 40), (700, 16, 0), (40, 32, 5)])
def test_knn_forward_matches_jax(n, degree, dup):
    """Duplicate vectors tie with their copies (the self-match may rank
    anywhere among them); both drop self and keep rank order."""
    x = _unit(_clustered(n, seed=n, dup=dup))
    want = jc._knn_forward(x, degree)
    got = tc.knn_forward(torch.from_numpy(x), degree)
    assert got.shape == want.shape and got.dtype == np.int32
    assert not (got == np.arange(n)[:, None]).any()
    # tie-aware: each rank's cosine agrees, ids wherever no tie decides
    cos = [np.einsum("nkd,nd->nk", x[f], x) for f in (got, want)]
    np.testing.assert_allclose(cos[0], cos[1], rtol=0, atol=SCORE_ATOL)
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("n,deg,degree", [(1, 1, 32), (2, 1, 32), (5, 4, 32), (600, 32, 32),
                                          (600, 17, 17), (300, 8, 3)])
def test_rank_reorder_is_bitwise_jax(n, deg, degree):
    """On the same forward edges: tiny graphs (n <= 1), rows shorter than
    the degree (padded with their best edge), odd degrees."""
    rng = np.random.default_rng(n + deg)
    if n <= 1:
        fwd = np.zeros((n, deg), np.int32)
    else:
        x = _unit(_clustered(n, seed=n))
        fwd = jc._knn_forward(x, deg)
    np.testing.assert_array_equal(tc.rank_reorder(fwd, degree), jc._rank_reorder(fwd, degree))
    # arbitrary edges, with repeats and self-loops
    if n > 1:
        fwd = rng.integers(0, n, (n, deg)).astype(np.int32)
        np.testing.assert_array_equal(tc.rank_reorder(fwd, degree),
                                      jc._rank_reorder(fwd, degree))


def _graph(n, invalid=0, seed=3):
    """A JAX-built graph, padded to the capacity, with ``invalid`` live
    rows masked out, and queries near stored rows."""
    x = _unit(_clustered(n, seed=seed, dup=10))
    cap = tc.pad_dim(n)
    mat = np.zeros((cap, D), np.float32)
    mat[:n] = x
    adj = np.zeros((cap, 32), np.int32)
    adj[:n] = jc._rank_reorder(jc._knn_forward(x, 32), 32)
    validf = np.zeros(cap, np.float32)
    validf[:n] = 1.0
    validf[np.random.default_rng(seed).choice(n, invalid, replace=False)] = 0.0
    return mat, adj, validf, _unit(_queries(x, 8, seed=seed))


@pytest.mark.parametrize("itopk,width", SETTINGS, ids=SETTING_IDS)
@pytest.mark.parametrize("n,invalid", [(3000, 200), (500, 0)], ids=["c4096", "c512"])
@pytest.mark.parametrize("b,k", [(1, 1), (3, 10), (8, 64)])
def test_walk_body_matches_jax(b, k, n, invalid, itopk, width):
    """The same graph and queries through both walks; the 512-row graph
    is smaller than the seed round (1,024), so its seed ids wrap."""
    mat, adj, validf, q = _graph(n, invalid)
    iters = max(8, int(np.ceil(0.75 * np.log2(n))))
    args = dict(k=k, iters=iters, width=width, itopk=itopk, hash_bits=16, n_seeds=1024)
    s_j, i_j = jc._cagra_walk(*(jnp.asarray(a) for a in (q[:b], mat, adj, validf)), **args)
    s_t, i_t = tc.walk_body(*(torch.from_numpy(a) for a in (q[:b], mat, adj, validf)),
                            **args)
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    assert s_t.shape == (b, k) and i_t.dtype == torch.int32
    assert topk_agree(i_t.numpy(), s_t.numpy(), i_j, s_j, SCORE_ATOL)
    found = i_t.numpy()[s_t.numpy() > -1e29]
    assert validf[found].all()  # masked rows never surface
    for row in i_t.numpy():
        assert len(set(row.tolist())) == k  # no id twice


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------


@pytest.fixture
def same_edges(monkeypatch):
    """Both indexes on the JAX package's k-NN edges: the two matmuls sum
    in another order, so a near-tie (a few edges in 10^5) may rank the
    other way and give another, equally valid graph. The edges are held
    tie-aware in ``test_knn_forward_matches_jax``; here the rest of the
    index is held to the reference on one graph."""
    monkeypatch.setattr(tc, "knn_forward",
                        lambda m, degree: jc._knn_forward(m.cpu().numpy(), degree))


def _pair(x, itopk, width, **kw):
    kw.setdefault("min_n", 256)
    j = jc.CagraIndex(itopk=itopk, search_width=width, **kw)
    t = tc.CagraIndex(itopk=itopk, search_width=width, device="cpu", **kw)
    items = [(f"v{i}", x[i]) for i in range(len(x))]
    j.add_batch(items)
    t.add_batch(items)
    return j, t


def _assert_same_answers(j, t, qs, k):
    got, want = t.search_batch(qs, k), j.search_batch(qs, k)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _hits_agree(g, w), (g[:3], w[:3])
    return got


@pytest.mark.parametrize("itopk,width", SETTINGS, ids=SETTING_IDS)
def test_index_matches_jax_across_writes(same_edges, itopk, width):
    x = _clustered(1500, seed=4, dup=20)
    j, t = _pair(x, itopk, width)
    assert j.build() and t.build()
    np.testing.assert_array_equal(t._graph["adj"].numpy(), np.asarray(j._graph["adj"]))
    assert t._graph["iters"] == j._graph["iters"] and t._graph["row_ids"] == j._graph["row_ids"]
    assert t.stats() == {k: v for k, v in j.stats().items() if k != "shards"}
    qs = _queries(x, 12)
    for k in (1, 10, 30):
        _assert_same_answers(j, t, qs, k)
    # writes after the build: adds and updates merge exactly, deletes filter
    for idx in (j, t):
        idx.add("fresh", np.full(D, 30.0, np.float32))
        idx.add("v3", -x[3])
        for i in range(20, 60):
            idx.remove(f"v{i}")
    assert t.builds == j.builds == 1
    got = _assert_same_answers(j, t, np.concatenate([qs, x[3:4], np.full((1, D), 30.0)]), 10)
    assert got[-1][0][0] == "fresh"
    assert all(not {f"v{i}" for i in range(20, 60)} & {e for e, _ in hits} for hits in got)
    assert t.counts["delta_merge"] >= 1 and t.counts["walk"] >= 4


@pytest.mark.parametrize("itopk,width", SETTINGS, ids=SETTING_IDS)
def test_index_steps_down_to_brute_as_jax(same_edges, itopk, width):
    x = _clustered(1500, seed=6)
    j, t = _pair(x, itopk, width)
    qs = _queries(x, 6)
    # itopk exceeded: the pool cannot hold k
    _assert_same_answers(j, t, qs, itopk + 1)
    assert t.counts["fallback_itopk_exceeded"] == 1
    # under-fill: deletes around one query drain its pool
    victims = [e for e, _ in t.search(x[50], k=min(itopk, 60))]
    for idx in (j, t):
        for v in victims:
            idx.remove(v)
    hits = _assert_same_answers(j, t, x[50:51], 10)[0]
    assert len(hits) == 10 and not set(victims) & {e for e, _ in hits}
    assert t.counts["fallback_underfill"] == 1
    # changelog overrun: the log no longer reaches the build
    for idx in (j, t):
        idx.add("late", x[0])
        idx._brute._changelog_floor = idx._brute.mutations
        idx._delta_cache = None
    _assert_same_answers(j, t, qs, 10)
    assert t.counts["fallback_changelog_overrun"] == 1
    assert t.builds == j.builds == 1


def test_index_below_min_n_answers_from_brute():
    x = _clustered(300, seed=7)
    j, t = _pair(x, 64, 1, min_n=400)
    assert not t.build() and not j.build() and not t.graph_built
    _assert_same_answers(j, t, _queries(x, 5), 10)
    assert t.counts["walk"] == 0


@pytest.mark.parametrize("itopk,width", SETTINGS, ids=SETTING_IDS)
def test_churn_starts_one_background_rebuild(itopk, width):
    x = _clustered(1200, seed=8)
    t = tc.CagraIndex(itopk=itopk, search_width=width, min_n=256, rebuild_stale_frac=0.05,
                      device="cpu")
    t.add_batch([(f"v{i}", x[i]) for i in range(len(x))])
    assert t.build()
    seq = t._graph["build_seq"]
    extra = _clustered(200, seed=77) + 25.0  # a far-away cluster
    t.add_batch([(f"new{i}", extra[i]) for i in range(len(extra))])
    # visible at once through the delta merge, while the rebuild runs
    assert t.search(extra[0], k=5)[0][0].startswith("new")
    deadline = time.time() + 30
    while t.builds < 2 and time.time() < deadline:
        time.sleep(0.02)
    assert t.builds == 2 and t.counts["background_rebuild"] == 1
    assert t._graph["build_seq"] > seq and t._graph["n"] == 1400
    assert t.search(extra[0], k=5)[0][0].startswith("new")


def test_pending_first_build_answers_from_brute():
    x = _clustered(600, seed=10)
    t = tc.CagraIndex(min_n=256, build_inline=False, device="cpu")
    t.add_batch([(f"v{i}", x[i]) for i in range(len(x))])
    hits = t.search(x[0], k=5)  # starts the build, brute answers
    assert hits[0][0] == "v0"
    deadline = time.time() + 30
    while not t.graph_built and time.time() < deadline:
        time.sleep(0.02)
    assert t.graph_built and t.builds == 1


def test_failed_background_build_raises_and_is_not_retried(monkeypatch):
    calls = []

    def launch_failed(*args, **kw):
        calls.append(1)
        raise RuntimeError("B1 launch failed")

    monkeypatch.setattr(tc, "fused_cosine_topk", launch_failed)
    x = _clustered(600, seed=10)
    t = tc.CagraIndex(min_n=256, build_inline=False, device="cpu")
    t.add_batch([(f"v{i}", x[i]) for i in range(len(x))])
    t.search(x[0], k=5)  # starts the build, brute answers
    deadline = time.time() + 30
    while t._build_error is None and time.time() < deadline:
        time.sleep(0.02)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="background build failed") as err:
            t.search(x[0], k=5)
        assert "B1 launch failed" in str(err.value.__cause__)
    assert len(calls) == 1 and t.counts["background_rebuild"] == 1 and not t.graph_built


def test_recall_at_port_defaults_on_a_clustered_corpus():
    """ROADMAP C14: recall@10 >= 0.95 against exact search."""
    x = _clustered(3000, seed=0)
    t = tc.CagraIndex(min_n=256, device="cpu")
    assert (t.itopk, t.search_width) == (CAGRA_ITOPK, CAGRA_WIDTH)
    t.add_batch([(f"v{i}", x[i]) for i in range(len(x))])
    qs = _queries(x, 32)
    xn, qn = _unit(x), _unit(qs)
    truth = np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :10]
    got = t.search_batch(qs, 10)
    hit = sum(len({f"v{j}" for j in truth[r]} & {e for e, _ in got[r]}) for r in range(len(qs)))
    assert hit / (10 * len(qs)) >= 0.95
    assert t.counts["walk"] == 1


def test_merge_delta_hits_matches_jax():
    hits = [("a", 0.9), ("b", 0.8), ("c", 0.5)]
    for ids, scores in ((["b", "d"], [0.95, 0.6]), ([], []), (["e"], [0.1])):
        assert tc.merge_delta_hits(hits, ids, scores, 3) == jc.merge_delta_hits(
            hits, ids, scores, 3)


# ---------------------------------------------------------------------------
# the quantized graph base (NORNICDB_VECTOR_QUANT)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "pq"])
@pytest.mark.parametrize("itopk,width", SETTINGS, ids=SETTING_IDS)
def test_quantized_index_matches_jax(same_edges, monkeypatch, mode, itopk, width):
    """The int8 (head prefilter + full dot) and PQ (ADC, 4x pool) walks,
    their pools re-scored exactly on the host rows, against the JAX
    package's; the card holds the compressed base only."""
    monkeypatch.setenv("NORNICDB_VECTOR_QUANT", mode)
    x = _clustered(1500, seed=21, dup=20)
    j, t = _pair(x, itopk, width)
    assert j.build() and t.build()
    q_t, q_j = t._graph["quant"], j._graph["quant"]
    assert q_t["mode"] == q_j["mode"] == mode
    np.testing.assert_array_equal(q_t["codes"].numpy(), np.asarray(q_j["codes"]))
    if mode == "int8":
        assert q_t["keep"] == q_j["keep"] == max(8, (3 * width * 32) // 4)
        np.testing.assert_array_equal(q_t["scale"].numpy(), np.asarray(q_j["scale"]))
    assert isinstance(t._graph["matrix"], np.ndarray)
    f32 = t._graph["matrix"].nbytes + t._graph["adj"].numel() * 4 + t._graph["validf"].numel() * 4
    assert 0 < t.device_bytes() < f32
    qs = _queries(x, 12)
    for k in (1, 10, 30):
        got = _assert_same_answers(j, t, qs, k)
    xn = _unit(x)
    for r, hits in enumerate(got):  # answered scores are exact cosines
        for eid, s in hits:
            assert s == pytest.approx(float(_unit(qs[r:r + 1])[0] @ xn[int(eid[1:])]),
                                      abs=SCORE_ATOL)
    assert t.counts["walk"] == 3


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_quantized_recall_at_port_defaults(monkeypatch, mode):
    monkeypatch.setenv("NORNICDB_VECTOR_QUANT", mode)
    x = _clustered(3000, seed=0)
    t = tc.CagraIndex(min_n=256, device="cpu")
    t.add_batch([(f"v{i}", x[i]) for i in range(len(x))])
    qs = _queries(x, 32)
    xn, qn = _unit(x), _unit(qs)
    truth = np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :10]
    got = t.search_batch(qs, 10)
    assert t._graph["quant"]["mode"] == mode
    hit = sum(len({f"v{j}" for j in truth[r]} & {e for e, _ in got[r]}) for r in range(len(qs)))
    assert hit / (10 * len(qs)) >= 0.95
