"""The port's k-means (``ops/kmeans.py``) and quantized planes
(``search/device_quant.py``, the brute index's quant rung) against the
JAX package's, on the same seeded inputs, the port on ``device="cpu"``.

Tolerances: the host trainers (``euclid_kmeans``,
``train_subspace_codebooks``, ``fit_rotation``), the int8 codes and scales
and the PQ codes are bitwise; int8 and ADC scores within 1e-5 (float sums
in another order), top-k ids tie-aware; Lloyd from a shared init gives
equal assignments, centroids within 1e-5. ``kmeans_fit`` draws its seeds
from a ``torch.Generator`` (ROADMAP C22), so where a plane clusters (PQ
above ``sample_n`` rows) the test hands the port the JAX package's
k-means result; then the planes answer alike: ids tie-aware, scores
within 1e-5. A plane that raises propagates (C23), and each named
freshness gap steps down and is counted."""

import functools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.ops import kmeans as jk
from nornicdb_tpu.search import cagra as jc
from nornicdb_tpu.search import device_quant as jq
from nornicdb_tpu.search.vector_index import BruteForceIndex as JIndex
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from nornicdb_tpu_torch.ops import kmeans as tk
from nornicdb_tpu_torch.ops.similarity import (
    keys_topk,
    order_keys,
    pad_dim,
    topk_stable,
    unpack_keys,
)
from nornicdb_tpu_torch.ops.topk import topk_agree
from nornicdb_tpu_torch.search import device_quant as tq
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex as TIndex

torch.set_num_threads(1)

SCORE_ATOL = 1e-5
D = 32


def _clustered(n, d=D, centers=16, seed=0, dup=0):
    rng = np.random.default_rng(seed)
    cent = (rng.standard_normal((centers, d)) * 3.0).astype(np.float32)
    x = cent[rng.integers(0, centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        x[n - dup:] = x[:dup]  # exact duplicates: tied scores
    return x.astype(np.float32)


def _unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)).astype(np.float32)


def _queries(x, nq, seed=9, noise=0.1):
    rng = np.random.default_rng(seed)
    rows = rng.choice(len(x), nq, replace=False)
    return (x[rows] + noise * rng.standard_normal((nq, x.shape[1]))).astype(np.float32)


def _hits_agree(got, want):
    if len(got) != len(want):
        return False
    return all(len(a) == len(b) and (not a or topk_agree(
        [[e for e, _ in a]], [[s for _, s in a]], [[e for e, _ in b]], [[s for _, s in b]],
        SCORE_ATOL)) for a, b in zip(got, want))


def _pair(x):
    j, t = JIndex(dims=x.shape[1]), TIndex(dims=x.shape[1], device="cpu")
    items = [(f"e{i}", x[i]) for i in range(len(x))]
    j.add_batch(items)
    t.add_batch(items)
    return j, t


def _planes(j, t, mode, **kw):
    kw.setdefault("build_inline", True)
    kw.setdefault("rebuild_stale_frac", 1e9)  # the tests drive rebuilds
    return jq.QuantizedBrutePlane(j, mode=mode, **kw), tq.QuantizedBrutePlane(t, mode=mode, **kw)


def _jax_kmeans_fit(vectors, k=None, **kw):
    """The JAX package's ``kmeans_fit`` behind the port's signature: the
    seam that gives both packages the same partitions (C22)."""
    kw.pop("device", None)
    return jk.kmeans_fit(vectors, k=k, **kw)


# ---------------------------------------------------------------------------
# the keyed top-k (ties to the lower index without a sort)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_keyed_topk_is_the_stable_topk(seed):
    g = torch.Generator().manual_seed(seed)
    ties = torch.randint(-4, 5, (6, 700), generator=g).to(torch.float32) / 3
    ties[0, :40] = -1e30
    for s in (ties, torch.randn((3, 2000), generator=g), -torch.rand((2, 50), generator=g)):
        for k in (1, 7, 64, s.shape[1]):
            a, b = unpack_keys(keys_topk(order_keys(s), k)), topk_stable(s, k)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 50, 999, 1000, 20_000, 5_000_000])
def test_optimal_k_matches_jax(n):
    assert tk.optimal_k(n) == jk.optimal_k(n)


@pytest.mark.parametrize("k,seed_ids,constant", [(64, None, False), (16, [3, 3, 900, 7], False),
                                                 (300, None, False), (32, None, True)])
def test_euclid_kmeans_is_bitwise_jax(k, seed_ids, constant):
    x = _clustered(800, d=4, seed=k)
    if constant:  # coinciding rows: the uniform fallback of the init
        x[:] = x[0]
    want = jk.euclid_kmeans(x, k, seed_ids=seed_ids, seed=5)
    got = tk.euclid_kmeans(x, k, seed_ids=seed_ids, seed=5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("m,n_codes,n", [(8, 256, 600), (16, 64, 1200), (4, 256, 100)])
def test_train_subspace_codebooks_is_bitwise_jax(m, n_codes, n):
    x = _clustered(n, seed=m)
    np.testing.assert_array_equal(tk.train_subspace_codebooks(x, m, n_codes),
                                  jk.train_subspace_codebooks(x, m, n_codes))
    with pytest.raises(ValueError):
        tk.train_subspace_codebooks(x[:, :30], 8)


@pytest.mark.parametrize("k,invalid", [(12, 0), (40, 7), (3, 2)])
def test_lloyd_from_a_shared_init_matches_jax(k, invalid):
    x = _unit(_clustered(3000, seed=k))
    valid = np.ones(len(x), bool)
    if invalid:
        valid[::invalid] = False
    init = x[np.random.default_rng(k).choice(len(x), k, replace=False)]
    cj, aj, itj, inj = jk._lloyd(jnp.asarray(x), jnp.asarray(valid), jnp.asarray(init), k, 50,
                                 1e-6)
    ct, at, itt, int_ = tk._lloyd(torch.from_numpy(x), torch.from_numpy(valid),
                                  torch.from_numpy(init), k, 50, 1e-6)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=SCORE_ATOL)
    assert itt == int(itj) and int_ == pytest.approx(float(inj), rel=1e-5)
    assert (at.numpy()[~valid] == -1).all()
    # assignment and the single-vector reassignment against the same centroids
    c = np.array(cj)
    np.testing.assert_array_equal(
        tk.kmeans_assign(torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(c)).numpy(),
        np.asarray(jk.kmeans_assign(jnp.asarray(x), jnp.asarray(valid), jnp.asarray(c))))
    for row in x[:20]:
        bj, sj = jk.reassign_single(jnp.asarray(row), jnp.asarray(c))
        bt, st = tk.reassign_single(torch.from_numpy(row), torch.from_numpy(c))
        assert int(bt) == int(bj) and float(st) == pytest.approx(float(sj), abs=SCORE_ATOL)


def test_kmeans_fit_clusters_the_valid_rows():
    """Its own draws (C22): the contract is a clustering, checked here by
    its shape and by inertia no worse than the reference's by much."""
    x = _clustered(2000, centers=8, seed=4)
    valid = np.ones(len(x), bool)
    valid[:300] = False
    res = tk.kmeans_fit(x, k=8, valid=valid, seed=0, device="cpu")
    ref = jk.kmeans_fit(x, k=8, valid=valid, seed=0)
    assert res.centroids.shape == (8, D) and res.assignments.dtype == np.int32
    assert (res.assignments[:300] == -1).all() and (res.assignments[300:] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(res.centroids, axis=1), 1.0, atol=1e-5)
    assert res.converged and res.inertia <= 1.1 * ref.inertia
    # k clamps to the valid rows; random init and preferred seeds run
    assert tk.kmeans_fit(x[:5], k=50, device="cpu").centroids.shape[0] == 5
    assert tk.kmeans_fit(x, k=4, init="random", device="cpu").assignments.max() <= 3
    again = tk.kmeans_fit(x, k=8, preferred_seed_indices=[1, 2], seed=3, device="cpu")
    np.testing.assert_array_equal(
        again.assignments,
        tk.kmeans_fit(x, k=8, preferred_seed_indices=[1, 2], seed=3, device="cpu").assignments)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 50.0)])
def test_int8_encode_is_bitwise_jax(seed, scale):
    x = np.random.default_rng(seed).standard_normal((2048, 48)).astype(np.float32) * scale
    x[5] = 0.0  # a zero row: scale 1e-12 / 127
    x[9, :] = 0.5 * scale  # a constant row: half-way roundings
    cj, sj = jq.int8_encode(x)
    ct, st = tq.int8_encode(x, device="cpu")
    assert ct.dtype == np.int8 and st.dtype == np.float32
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("chunk_cells", [1 << 25, 4096])
@pytest.mark.parametrize("b,k", [(1, 1), (5, 64), (8, 512)])
def test_int8_scores_and_topk_match_jax(b, k, chunk_cells, monkeypatch):
    """The coarse top-k over the codes in column chunks (a small chunk
    cap merges 64 chunks) is the reference's over the whole row."""
    monkeypatch.setattr(tq, "_INT8_CHUNK_CELLS", chunk_cells)
    x = _unit(_clustered(4096, seed=b, dup=64))
    codes, scale = (np.array(a) for a in jq.int8_encode(x))
    codes_t = np.ascontiguousarray(codes.T)
    valid = np.ones(len(x), bool)
    valid[::11] = False
    q = _unit(_queries(x, b, seed=b))
    want = np.asarray(jq._int8_scores(jnp.asarray(q), jnp.asarray(codes_t), jnp.asarray(scale)))
    got = tq._int8_scores(torch.from_numpy(q), torch.from_numpy(codes_t),
                          torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    sj, ij = jq._int8_topk_impl(jnp.asarray(q), jnp.asarray(codes_t), jnp.asarray(scale),
                                jnp.asarray(valid), k=k)
    st, it = tq._int8_topk_impl(torch.from_numpy(q), torch.from_numpy(codes_t),
                                torch.from_numpy(scale), torch.from_numpy(valid), k)
    assert it.shape == (b, k)
    assert topk_agree(it.numpy(), st.numpy(), np.asarray(ij), np.asarray(sj), SCORE_ATOL)
    assert valid[it.numpy()].all()


# ---------------------------------------------------------------------------
# PQ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n_codes", [(8, 256), (16, 64)])
def test_pq_train_encode_and_adc_match_jax(m, n_codes):
    x = _unit(_clustered(3000, seed=m, dup=30))
    cj = jq.train_pq(x, m, n_codes)  # 3,000 <= sample_n: no device k-means
    ct = tq.train_pq(x, m, n_codes, device="cpu")
    np.testing.assert_array_equal(ct, cj)
    codes_j = jq.encode_pq(x, cj)
    codes_t = tq.encode_pq(x, cj, device="cpu")
    assert codes_t.dtype == np.uint8
    np.testing.assert_array_equal(codes_t, codes_j)
    q = _unit(_queries(x, 6))
    ct_t = np.ascontiguousarray(codes_j.T)
    want = np.asarray(jq._pq_adc_scores(jnp.asarray(q), jnp.asarray(ct_t), jnp.asarray(cj)))
    got = tq._pq_adc_scores(torch.from_numpy(q), torch.from_numpy(ct_t),
                            torch.from_numpy(cj)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    valid = np.ones(len(x), bool)
    valid[1::9] = False
    for k in (1, 10, 256):
        sj, ij = jq._pq_topk_impl(jnp.asarray(q), jnp.asarray(ct_t), jnp.asarray(cj),
                                  jnp.asarray(valid), k=k)
        st, it = tq._pq_topk_impl(torch.from_numpy(q), torch.from_numpy(ct_t),
                                  torch.from_numpy(cj), torch.from_numpy(valid), k)
        assert topk_agree(it.numpy(), st.numpy(), np.asarray(ij), np.asarray(sj), SCORE_ATOL)


def test_train_pq_above_sample_n_through_the_kmeans_seam(monkeypatch):
    """Above ``sample_n`` the sample depends on a device k-means: given the
    reference's, the codebooks are bitwise."""
    monkeypatch.setattr(tq, "kmeans_fit", _jax_kmeans_fit)
    x = _unit(_clustered(4096, seed=3))
    np.testing.assert_array_equal(tq.train_pq(x, 8, 64, sample_n=1024, device="cpu"),
                                  jq.train_pq(x, 8, 64, sample_n=1024))


@pytest.mark.parametrize("n", [500, 9000])
def test_fit_rotation_is_bitwise_jax(n):
    x = _clustered(n, d=24, seed=n)
    rot = tq.fit_rotation(x)
    np.testing.assert_array_equal(rot, jq.fit_rotation(x))
    np.testing.assert_allclose(rot @ rot.T, np.eye(24), atol=1e-4)


# ---------------------------------------------------------------------------
# the quantized walks and graph base
# ---------------------------------------------------------------------------

WALK_SETTINGS = [(64, 1), (128, 8)]  # the reference's breadth, the port's (C14)


def _graph(n=3000, seed=3):
    x = _unit(_clustered(n, seed=seed, dup=10))
    cap = pad_dim(n)
    mat = np.zeros((cap, D), np.float32)
    mat[:n] = x
    adj = np.zeros((cap, 32), np.int32)
    adj[:n] = jc._rank_reorder(jc._knn_forward(x, 32), 32)
    validf = np.zeros(cap, np.float32)
    validf[:n] = 1.0
    validf[np.random.default_rng(seed).choice(n, 100, replace=False)] = 0.0
    return mat, adj, validf, _unit(_queries(x, 8, seed=seed))


@pytest.mark.parametrize("itopk,width", WALK_SETTINGS, ids=["reference", "port"])
def test_int8_graph_base_and_walk_match_jax(itopk, width):
    mat, adj, validf, q = _graph()
    jb = jq.quantize_graph_base(mat, mode="int8")
    tb = tq.quantize_graph_base(mat, torch.device("cpu"), mode="int8")
    np.testing.assert_array_equal(tb["rot"], jb["rot"])
    for key in ("codes", "codes_head", "scale"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    assert tb["head_dims"] == jb["head_dims"] == 8
    keep = (3 * width * 32) // 4
    args = dict(iters=12, width=width, itopk=itopk, hash_bits=16, n_seeds=1024)
    qp = q @ jb["rot"]
    sj, ij = jq._quant_walk(jnp.asarray(qp), jb["codes"], jb["codes_head"], jb["scale"],
                            jnp.asarray(adj), jnp.asarray(validf), k=itopk, keep=keep, **args)
    st, it = tq._walk_body_quant(torch.from_numpy(qp), tb["codes"], tb["codes_head"],
                                 tb["scale"], torch.from_numpy(adj), torch.from_numpy(validf),
                                 itopk, keep=keep, **args)
    assert topk_agree(it.numpy(), st.numpy(), np.asarray(ij), np.asarray(sj), SCORE_ATOL)
    found = it.numpy()[st.numpy() > -1e29]
    assert validf[found].all()


@functools.lru_cache(maxsize=None)
def _pq_bases():
    """Both packages' PQ graph bases over one graph, trained once."""
    mat, adj, validf, q = _graph(seed=5)
    return (mat, adj, validf, q, jq.quantize_graph_base(mat, mode="pq"),
            tq.quantize_graph_base(mat, torch.device("cpu"), mode="pq"))


@pytest.mark.parametrize("itopk,width", WALK_SETTINGS, ids=["reference", "port"])
def test_pq_graph_base_and_walk_match_jax(itopk, width):
    mat, adj, validf, q, jb, tb = _pq_bases()
    assert tb["pq_m"] == jb["pq_m"] == 16 and tb["pq_codes"] == 256
    np.testing.assert_array_equal(tb["codebooks"].numpy(), np.asarray(jb["codebooks"]))
    np.testing.assert_array_equal(tb["codes"].numpy(), np.asarray(jb["codes"]))
    args = dict(iters=12, width=width, itopk=4 * itopk, hash_bits=16, n_seeds=1024)
    sj, ij = jq._pq_walk(jnp.asarray(q), jb["codes"], jb["codebooks"], jnp.asarray(adj),
                         jnp.asarray(validf), k=4 * itopk, **args)
    st, it = tq._walk_body_pq(torch.from_numpy(q), tb["codes"], tb["codebooks"],
                              torch.from_numpy(adj), torch.from_numpy(validf), 4 * itopk,
                              **args)
    assert topk_agree(it.numpy(), st.numpy(), np.asarray(ij), np.asarray(sj), SCORE_ATOL)
    # too few live rows for honest codebooks: both give the float32 base
    assert tq.quantize_graph_base(mat[:512], torch.device("cpu"), mode="pq") is None
    assert jq.quantize_graph_base(mat[:512], mode="pq") is None


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _built_planes(mode):
    """Both packages' planes over one corpus, built once per mode."""
    x = _clustered(3000, seed=11, dup=20)
    j, t = _pair(x)
    jp, tp = _planes(j, t, mode)
    assert jp.build() and tp.build()
    return x, t, jp, tp


@pytest.mark.parametrize("mode", ["int8", "pq"])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_plane_matches_jax(mode, k):
    x, t, jp, tp = _built_planes(mode)
    qs = _queries(x, 12)
    dispatched = tp.counts["dispatch"]
    assert _hits_agree(tp.search_batch(qs, k), jp.search_batch(qs, k))
    assert tp.pool_for(k, tp._snap) == jp.pool_for(k, jp._snap)
    assert tp.counts["dispatch"] == dispatched + 1 and tp.builds == 1
    # answered scores are exact float32 cosines
    for r, hits in enumerate(tp.search_batch(qs, k)):
        for eid, s in hits:
            assert s == pytest.approx(float(_unit(qs[r:r + 1])[0] @ t.get(eid)), abs=1e-5)
    assert t._dev_matrix is None  # the float32 pair never went up


def test_pq_plane_above_sample_n_matches_jax_through_the_kmeans_seam(monkeypatch):
    """Above ``sample_n`` rows the PQ sample comes from a k-means; the port
    gets the reference's result (C22), and then answers as it does."""
    small = functools.partial(jq.train_pq, sample_n=1024)
    monkeypatch.setattr(jq, "train_pq", small)
    monkeypatch.setattr(tq, "train_pq", functools.partial(tq.train_pq, sample_n=1024))
    monkeypatch.setattr(tq, "kmeans_fit", _jax_kmeans_fit)
    x = _clustered(4000, seed=12)
    j, t = _pair(x)
    jp, tp = _planes(j, t, "pq", pq_m=8, pq_codes=64)
    assert jp.build() and tp.build()
    np.testing.assert_array_equal(tp._snap["codebooks"].numpy(),
                                  np.asarray(jp._snap["codebooks"]))
    qs = _queries(x, 10, seed=4)
    assert _hits_agree(tp.search_batch(qs, 10), jp.search_batch(qs, 10))


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_plane_reads_its_writes_as_jax(mode):
    x = _clustered(2000, seed=13)
    j, t = _pair(x)
    jp, tp = _planes(j, t, mode)
    assert jp.build() and tp.build()
    rng = np.random.default_rng(3)
    qs = _queries(x, 6)
    target = _unit(rng.standard_normal((1, D)).astype(np.float32))[0]
    for idx in (j, t):
        idx.remove("e7")  # filtered at the rerank gather
        idx.add("fresh", target)  # scored exactly from the changelog
        idx.add("e3", -x[3])  # an update supersedes its stale codes
    qs = np.concatenate([qs, target[None, :], x[7:8], -x[3:4]])
    got = tp.search_batch(qs, 10)
    assert _hits_agree(got, jp.search_batch(qs, 10))
    assert _hits_agree(got, t.search_batch(qs, 10, exact=True))
    assert got[-3][0][0] == "fresh" and got[-1][0][0] == "e3"
    assert all("e7" not in {e for e, _ in hits} for hits in got)
    assert tp.counts["delta_merge"] == 1 and tp.builds == 1


def test_plane_named_gaps_step_down_and_are_counted():
    """compaction, changelog overrun, a rerank race, an under-filled pool,
    and a plane not built yet: None on both sides, counted by reason."""
    x = _clustered(1200, seed=14)
    j, t = _pair(x)
    jp, tp = _planes(j, t, "int8", overfetch=1, min_pool=16)
    assert jp.build() and tp.build()
    q = x[50:51]
    # under-fill: the whole pool of one query removed
    for eid in [e for e, _ in tp.search_batch(q, 16)[0]]:
        j.remove(eid)
        t.remove(eid)
    assert tp.search_batch(q, 16) is None and jp.search_batch(q, 16) is None
    assert tp.counts["degrade_underfill"] == 1
    # a compaction landing between the coarse dispatch and the rerank
    real = t.rows_for_slots
    t.rows_for_slots = lambda *a, **kw: None
    assert tp.search_batch(q, 5) is None
    t.rows_for_slots = real
    assert tp.counts["degrade_rerank_race"] == 1
    # changelog overrun
    for idx, plane in ((j, jp), (t, tp)):
        idx._changelog_floor = idx.mutations + 1
        assert plane.search_batch(q, 5) is None
    assert tp.counts["degrade_changelog_overrun"] == 1
    # compaction: the slots moved
    for idx, plane in ((j, jp), (t, tp)):
        idx._changelog_floor = 0
        for i in range(300, 900):
            idx.remove(f"e{i}")
        assert idx.compact()
        assert plane.search_batch(q, 5) is None
    assert tp.counts["degrade_compaction"] == 1
    # not built yet (a build in flight): the float32 tier serves meanwhile
    lazy = tq.QuantizedBrutePlane(t, mode="int8", build_inline=False)
    lazy._rebuilding = True
    assert lazy.search_batch(q, 5) is None
    assert lazy.counts["degrade_pending_build"] == 1 and lazy.builds == 0


@pytest.fixture
def quant_env(monkeypatch):
    monkeypatch.setenv("NORNICDB_QUANT_MIN_N", "64")
    monkeypatch.setenv("NORNICDB_QUANT_INLINE_BUILD", "1")
    return monkeypatch


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_index_ladder_serves_the_plane_as_jax(mode, quant_env):
    quant_env.setenv("NORNICDB_VECTOR_QUANT", mode)
    x = _clustered(2500, seed=15)
    j, t = _pair(x)
    qs = _queries(x, 8)
    got = t.search_batch(qs, 10)
    assert _hits_agree(got, j.search_batch(qs, 10))
    plane = t.quant_plane()
    assert plane is t._quant and plane.counts["dispatch"] == 1
    assert t._dev_matrix is None  # a quant-served batch never uploads f32
    assert plane.device_bytes() == j._quant._snap["device_bytes"]
    exact = t.search_batch(qs, 10, exact=True)  # bypasses the plane
    assert plane.counts["dispatch"] == 1 and _hits_agree(exact, j.search_batch(qs, 10, exact=True))
    # off, unknown, or below the floor: no plane
    quant_env.setenv("NORNICDB_VECTOR_QUANT", "int4")
    assert tq.quant_mode() == jq.quant_mode() == "off" and t.quant_plane() is None
    quant_env.setenv("NORNICDB_VECTOR_QUANT", mode)
    quant_env.setenv("NORNICDB_QUANT_MIN_N", "5000")
    assert t.quant_plane() is None and j.quant_plane() is None


def test_a_raising_plane_propagates_where_jax_answers_float32(quant_env):
    """ROADMAP C23: the reference catches every exception of a plane and
    serves float32; the port raises."""
    quant_env.setenv("NORNICDB_VECTOR_QUANT", "int8")
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False, embedder=THash())
    jdb = nornicdb_tpu.open(engine="memory", auto_embed=False, embedder=JHash())
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((150, D)).astype(np.float32)
    try:
        for db in (tdb, jdb):
            db.recall("warm", mode="text")
            for i, v in enumerate(vecs):
                db.store(f"doc {i}", node_id=f"n{i}", embedding=[float(a) for a in v])
        qv = vecs[3] + 0.1
        th = tdb.search.search("", query_embedding=qv, mode="vector", limit=5)
        jh = jdb.search.search("", query_embedding=qv, mode="vector", limit=5)
        assert [h["id"] for h in th] == [h["id"] for h in jh]
        assert tdb.search.vectors._quant.counts["dispatch"] == 1

        def boom(*a, **kw):
            raise RuntimeError("quant plane: device fault")

        quant_env.setattr(tq.QuantizedBrutePlane, "search_batch", boom)
        quant_env.setattr(jq.QuantizedBrutePlane, "search_batch", boom)
        jh2 = jdb.search.search("", query_embedding=qv + 0.01, mode="vector", limit=5)
        assert [h["id"] for h in jh2] == [h["id"] for h in jh]
        with pytest.raises(RuntimeError, match="device fault"):
            tdb.search.search("", query_embedding=qv + 0.01, mode="vector", limit=5)
    finally:
        tdb.close()
        jdb.close()


def test_background_build_then_serves(quant_env):
    """Float32 serves while the first build runs in the background (held
    here until the first search returned), then the plane."""
    quant_env.setenv("NORNICDB_VECTOR_QUANT", "int8")
    quant_env.delenv("NORNICDB_QUANT_INLINE_BUILD")
    gate = threading.Event()
    build = tq.QuantizedBrutePlane.build

    def held(self):
        gate.wait(30)
        return build(self)

    quant_env.setattr(tq.QuantizedBrutePlane, "build", held)
    x = _clustered(600, seed=16)
    _, t = _pair(x)
    qs = _queries(x, 3)
    first = t.search_batch(qs, 5)  # starts the build; float32 answers
    plane = t._quant
    assert plane.counts["degrade_pending_build"] == 1 and not plane.plane_built
    assert _hits_agree(first, t.search_batch(qs, 5, exact=True))
    gate.set()
    deadline = time.time() + 30
    while not plane.plane_built and time.time() < deadline:
        time.sleep(0.01)
    assert plane.plane_built and plane.counts["background_rebuild"] == 1
    assert _hits_agree(t.search_batch(qs, 5), first)
    assert plane.counts["dispatch"] == 1
