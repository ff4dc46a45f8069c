"""The port's single-device shard layouts (``NORNICDB_HYBRID_SHARDS``,
``NORNICDB_CAGRA_SHARDS``, ``NORNICDB_QUANT_SHARDS``) against the JAX
package's, the port on ``device="cpu"``.

Contracts:

- **Exact tiers** (lexical, the exact fused tier, int8): the port's loop
  gives the JAX package's loop's ids, called directly on the same inputs,
  tie-aware, with the scores within the tolerances of each module's
  one-shard parity tests (lexical a relative 1e-5, cosine 1e-5); and the
  same through each entry point against the JAX package's, which here runs
  its mesh path over ``tests/conftest.py``'s eight CPU devices (bitwise
  its loop). At 2 shards the port also answers its own one-shard ids.
- **Walks**: on the JAX package's k-NN edges (``same_edges``: both packages
  walk the same graphs) the port's loops give the JAX loops' ids,
  tie-aware with scores within 1e-6; on the port's own edges the sharded
  walks keep recall@10 >= 0.95 against exact search.
- **Gaps**: only the reference's named gaps step down, each counted
  (``unshardable``, ``shard_mismatch``, quant to float32 on a sharded
  snapshot, int8 at a capacity that does not split).

Knobs are set only through ``monkeypatch.setenv``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.ops import similarity as jsim
from nornicdb_tpu.search import cagra as j_cagra
from nornicdb_tpu.search import device_quant as jq
from nornicdb_tpu.search.device_bm25 import DeviceBM25 as JDeviceBM25
from nornicdb_tpu.search.hybrid_fused import FusedHybrid as JFused
from nornicdb_tpu.search.service import SearchService as JService
from nornicdb_tpu.storage.memory import MemoryEngine as JEngine
from nornicdb_tpu.storage.types import Node as JNode
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from nornicdb_tpu_torch.obs import audit as t_audit
from nornicdb_tpu_torch.ops import similarity as tsim
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree
from nornicdb_tpu_torch.search import ann_quality as tann
from nornicdb_tpu_torch.search import cagra as t_cagra
from nornicdb_tpu_torch.search import device_quant as tq
from nornicdb_tpu_torch.search import hybrid_fused as t_hybrid
from nornicdb_tpu_torch.search.bm25 import BM25Index as TBM25, tokenize
from nornicdb_tpu_torch.search.device_bm25 import (
    DeviceBM25 as TDeviceBM25,
    topk_shards,
)
from nornicdb_tpu_torch.search.hybrid_fused import (
    TIER_BRUTE_F32,
    TIER_WALK_F32,
    FusedHybrid as TFused,
)
from nornicdb_tpu_torch.search.rrf import rrf_fuse
from nornicdb_tpu_torch.search.service import SearchService as TService
from nornicdb_tpu_torch.storage.memory import MemoryEngine as TEngine
from nornicdb_tpu_torch.storage.types import Node as TNode
from test_torch_cagra import _clustered, _hits_agree, _queries
from test_torch_hybrid import (
    COS_ATOL,
    D,
    LEX_RTOL,
    PARITY_QUERIES,
    VOCAB,
    WALK_MIN_N,
    Pair,
    _assert_parity,
    _assert_walk_rows,
    _lex_agree,
    _rows,
    _store_corpus,
    _vec_agree,
)
from test_torch_quant import _pair as _index_pair, _planes
from test_torch_search import _node

torch.set_num_threads(1)

WALK_ATOL = 1e-6  # the walks' batched products sum in another order than XLA's
SHARDS = [2, 4]


@pytest.fixture
def same_edges(monkeypatch):
    """Both packages on the JAX package's k-NN edges, shard by shard: two
    matmuls sum in another order, so a near-tie may rank the other way
    and give another, equally valid graph (the edges are held tie-aware in
    ``tests/test_torch_cagra.py``)."""
    monkeypatch.setattr(t_cagra, "knn_forward",
                        lambda m, degree: j_cagra._knn_forward(m.cpu().numpy(), degree))
    return monkeypatch


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows_agree(ids_t, s_t, ids_j, s_j, rtol=0.0, atol=0.0):
    """Row-wise tie-aware agreement of two [B, k] top-k blocks, the
    tolerance relative to each row's largest finite score when ``rtol``."""
    ids_t, s_t, ids_j, s_j = (_np(x) for x in (ids_t, s_t, ids_j, s_j))
    assert ids_t.shape == ids_j.shape
    for r in range(len(ids_t)):
        finite = s_j[r][s_j[r] > -1e29]
        tol = atol + rtol * max([1.0] + [abs(float(x)) for x in finite])
        if not topk_agree(ids_t[r:r + 1], s_t[r:r + 1], ids_j[r:r + 1], s_j[r:r + 1], tol):
            return False
    return True


def _lex_rows_agree(rows_t, rows_j):
    return all(_lex_agree(t, j) for t, j in zip(rows_t, rows_j))


# ---------------------------------------------------------------------------
# concat_topk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 9, 12])
def test_concat_topk_breaks_ties_by_concatenated_position_as_jax(k):
    """Ties across shards go to the lower concatenated position, not the
    lower id: shard 1's ids are lower than shard 0's here."""
    rng = np.random.default_rng(5)
    scores = [np.round(rng.random((3, 4)), 1).astype(np.float32) for _ in range(3)]
    scores[0][:, 0] = scores[1][:, 0] = scores[2][:, 0] = 1.5  # the top score, in every shard
    ids = [np.arange(4)[None, :].repeat(3, 0) + base for base in (100, 10, 50)]
    s_j, i_j = jsim.concat_topk([jnp.asarray(s) for s in scores],
                                [jnp.asarray(i, jnp.int32) for i in ids], k)
    s_t, i_t = tsim.concat_topk([torch.from_numpy(s) for s in scores],
                                [torch.from_numpy(i) for i in ids], k)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert i_t[0, 0] == 100  # shard 0's tied entry first, though id 10 is lower


# ---------------------------------------------------------------------------
# device BM25
# ---------------------------------------------------------------------------


def _tiny_pair():
    """Nine documents: at 4 shards of ceil(9 / 4) = 3 rows the last shard
    is empty."""
    pair = Pair(0, seed=1, text_only=0, vec_only=0)
    rng = np.random.default_rng(4)
    for i in range(9):
        pair.index(f"d{i}", " ".join(rng.choice(VOCAB[:8], size=int(rng.integers(2, 6)))))
    return pair


def _bm25_pair(pair, s):
    jd = JDeviceBM25(pair.jb, n_shards=s, min_n=1)
    td = TDeviceBM25(pair.tb, n_shards=s, min_n=1, device="cpu")
    assert jd.build() and td.build()
    return jd, td


def _widened(x):
    x = _np(x)
    if x.dtype == np.int16:  # the port's 16-bit count bits
        return x.view(np.uint16).astype(np.float32)
    return x.astype(np.float32)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("corpus", ["pair400", "tiny9"])
def test_bm25_shard_layout_matches_jax(corpus, s):
    pair = Pair(400, seed=7) if corpus == "pair400" else _tiny_pair()
    jd, td = _bm25_pair(pair, s)
    js, ts = jd._snap, td._snap
    assert ts["shards"] == js["shards"] == s and ts["c_local"] == js["c_local"]
    assert ts["c"] == s * js["c_local"] == len(ts["row_ids"])
    np.testing.assert_array_equal(ts["off_sh"], js["off_sh"])
    np.testing.assert_array_equal(_np(ts["post_doc"]), np.asarray(js["post_doc"]))
    for key in ("post_tf", "doc_len"):
        np.testing.assert_array_equal(_widened(ts[key]), _widened(js[key]))
    np.testing.assert_array_equal(_np(ts["alive"]), np.asarray(js["alive"]) > 0)
    np.testing.assert_array_equal(ts["slots"], js["slots"])
    assert ts["row_ids"] == js["row_ids"]
    assert all(ts["row_of"][e] == r for r, e in enumerate(ts["row_ids"]) if e is not None)
    if corpus == "tiny9" and s == 4:
        c_local = ts["c_local"]
        assert not ts["alive_np"][3 * c_local:].any()  # the empty last shard
    # resource_stats report the sharded layout's real bytes
    stats = td.resource_stats()
    assert stats["capacity"] == jd.resource_stats()["capacity"] == ts["c"]
    assert stats["device_bytes"] == sum(
        ts[k].numel() * ts[k].element_size() for k in ("post_doc", "post_tf", "doc_len", "alive"))


@pytest.mark.parametrize("s", SHARDS)
def test_bm25_shard_loop_matches_jax_loop_and_search(s):
    """``topk_shards`` against the JAX package's ``_topk_shards_single_device``
    on the same plan, then ``search_batch`` against the JAX package's (its
    mesh path), the host index and the port's one-shard snapshot, before
    and after writes (the alive refresh and the delta side-scan)."""
    pair = Pair(400, seed=11)
    jd, td = _bm25_pair(pair, s)
    toks = [tokenize(q) for q in PARITY_QUERIES]
    for k in (8, 32):
        jsnap, tsnap = jd._snap, td._snap
        ptr, urow, sel, avgdl = jd.plan(jsnap, toks, len(toks))
        jargs = (jnp.asarray(ptr), jnp.asarray(urow), jnp.asarray(sel), jsnap["post_doc"],
                 jsnap["post_tf"], jsnap["doc_len"], jsnap["alive"], jnp.float32(avgdl))
        s_j, i_j = jd._topk_shards_single_device(jsnap, jargs, k)
        s_t, i_t = topk_shards(tsnap, td.device_args(tsnap, *td.plan(tsnap, toks)), k)
        assert _rows_agree(i_t, s_t, i_j, s_j, rtol=LEX_RTOL)
    one = TDeviceBM25(pair.tb, min_n=1, device="cpu")
    for step in range(2):
        rows_t = td.search_batch(PARITY_QUERIES, 15)
        assert _lex_rows_agree(rows_t, jd.search_batch(PARITY_QUERIES, 15))
        assert _lex_rows_agree(rows_t, pair.tb.search_batch(PARITY_QUERIES, 15))
        assert _lex_rows_agree(rows_t, one.search_batch(PARITY_QUERIES, 15))
        if step == 0:  # a tombstone, an update, an add
            pair.remove("d3")
            pair.index("d5", "term1 term2 term9")
            pair.index("fresh", "term1 term2 term3")
    assert td.builds == 1 and td.events["delta_merge"] >= 1


# ---------------------------------------------------------------------------
# the exact fused tier
# ---------------------------------------------------------------------------


def _assert_loop_out(out_t, out_j):
    """(lexical scores, rows, vector scores, ids, fused scores, positions)
    of two loops: each list tie-aware, and where both lists match id for
    id the fuse bitwise."""
    ls_t, lg_t, vs_t, vi_t, fs_t, fp_t = (_np(x) for x in out_t)
    ls_j, lg_j, vs_j, vi_j, fs_j, fp_j = (_np(x) for x in out_j)
    assert _rows_agree(lg_t, ls_t, lg_j, ls_j, rtol=LEX_RTOL)
    assert _rows_agree(vi_t, vs_t, vi_j, vs_j, atol=COS_ATOL)
    same = (lg_t == lg_j).all(1) & (vi_t == vi_j).all(1)
    assert same.any()
    np.testing.assert_array_equal(fs_t[same], fs_j[same])
    np.testing.assert_array_equal(fp_t[same], fp_j[same])


def _tail_t(b, n_cand):
    return (torch.full((b,), n_cand), torch.ones(b), torch.ones(b))


def _tail_j(b, n_cand):
    return (jnp.asarray(np.full(b, n_cand, np.int32)), jnp.ones(b, jnp.float32),
            jnp.ones(b, jnp.float32))


@pytest.mark.parametrize("s", SHARDS)
def test_fused_shard_loop_matches_jax_loop(s):
    pair = Pair(600, seed=23)
    jf, tf = pair.fused(n_shards=s)
    qs = PARITY_QUERIES
    embs = pair.embs(len(qs))
    toks = [tokenize(q) for q in qs]
    b, kq = len(qs), 32
    jsnap, tsnap = jf.lex._snap, tf.lex._snap
    jview, tview = pair.jv.device_view(), pair.tv.device_view()
    jl2v, tl2v = jf._ensure_map(jsnap, jview[3]), tf._ensure_map(tsnap, tview[3])
    ptr, urow, sel, avgdl = jf.lex.plan(jsnap, toks, b)
    jargs = (jnp.asarray(ptr), jnp.asarray(urow), jnp.asarray(sel), jsnap["post_doc"],
             jsnap["post_tf"], jsnap["doc_len"], jsnap["alive"], jl2v, jnp.float32(avgdl),
             jsim.l2_normalize(jnp.asarray(embs)))
    out_j = jf._shard_loop(jsnap, jargs, jview[0], jview[1], _tail_j(b, 30), kq)
    lex_args = tf.lex.device_args(tsnap, *tf.lex.plan(tsnap, toks))
    qn = tsim.l2_normalize(torch.from_numpy(embs))
    out_t = tf._shard_loop(tsnap, lex_args, tl2v, qn, tview[0], tview[1], _tail_t(b, 30), kq)
    _assert_loop_out(out_t, out_j)


@pytest.mark.parametrize("s", SHARDS)
def test_fused_sharded_tier_matches_jax_host_and_one_shard(monkeypatch, s):
    """The exact tier at ``s`` shards through ``search_batch``: against the
    JAX package's tier (its mesh path) and the host path, and the same
    ids as the port's one-shard tier; each vector shard is one B1 call."""
    pair = Pair(600, seed=29)
    jf, tf = pair.fused(n_shards=s)
    _, one = pair.fused()
    embs = pair.embs(len(PARITY_QUERIES))
    calls = []

    def counted(*args):
        calls.append(args[1].shape[0])
        return fused_cosine_topk(*args)

    monkeypatch.setattr(t_hybrid, "fused_cosine_topk", counted)
    for weights in ((1.0, 1.0), (2.0, 0.5)):
        rows_t = _assert_parity(pair, jf, tf, PARITY_QUERIES, embs, 30, weights)
        rows_1 = _rows(one, PARITY_QUERIES, embs, 30, weights)
        for r, r1 in zip(rows_t, rows_1):
            assert _lex_agree(r["lex"], r1["lex"]) and _vec_agree(r["vec"], r1["vec"])
    assert tf.lex._snap["shards"] == s and jf.lex._snap["shards"] == s
    assert tf.counts["dispatch"] == 2 and tf.counts[TIER_BRUTE_F32] == 2 * len(PARITY_QUERIES)
    assert tf.handoffs() == 0
    capacity = pair.tv.device_view()[0].shape[0]
    # one B1 call a vector shard a dispatch (three tiers: the port at s
    # shards twice, its one-shard tier twice), over equal slices
    assert sorted(calls) == sorted([capacity // s] * (2 * s) + [capacity] * 2)


def test_fused_shard_merge_keeps_shard_order_on_exact_ties():
    """Shard 1 a copy of shard 0 (256 documents and vectors, then the same
    256 again): every score ties with its copy, and the merge keeps shard
    0's first, by concatenated position, in both halves, with the JAX
    package's ids."""
    rng = np.random.default_rng(37)
    pair = Pair(0, seed=2, text_only=0, vec_only=0)
    texts = [" ".join(rng.choice(VOCAB, size=int(rng.integers(3, 9)))) for _ in range(256)]
    vecs = rng.standard_normal((256, D)).astype(np.float32)
    for copy in "ab":
        for i in range(256):
            pair.index(f"{copy}{i}", texts[i])
            pair.add(f"{copy}{i}", vecs[i])
    jf, tf = pair.fused(n_shards=2)
    assert tf.lex._snap["c_local"] == 256 and pair.tv.device_view()[0].shape[0] == 512
    embs = rng.standard_normal((len(PARITY_QUERIES), D)).astype(np.float32)
    rows_t = _rows(tf, PARITY_QUERIES, embs, 16)
    rows_j = _rows(jf, PARITY_QUERIES, embs, 16)
    for rt, rj in zip(rows_t, rows_j):
        for key in ("lex", "vec"):
            ids = [e for e, _ in rt[key]]
            assert ids == [e for e, _ in rj[key]]
            # a copy never ranks before its original from shard 0
            assert all("a" + e[1:] in ids[:p] for p, e in enumerate(ids) if e[0] == "b")
    assert any(rt["lex"] for rt in rows_t)


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------


def _cagra_pair(x, s, **kw):
    kw.setdefault("min_n", 256)
    j = j_cagra.CagraIndex(n_shards=s, **kw)
    t = t_cagra.CagraIndex(n_shards=s, device="cpu", **kw)
    items = [(f"v{i}", x[i]) for i in range(len(x))]
    j.add_batch(items)
    t.add_batch(items)
    assert j.build() and t.build()
    return j, t


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("itopk,width", [(64, 1), (tann.CAGRA_ITOPK, tann.CAGRA_WIDTH)],
                         ids=["reference", "port"])
def test_walk_shards_single_device_matches_jax(same_edges, s, itopk, width):
    x = _clustered(1500, seed=4)
    j, t = _cagra_pair(x, s, itopk=itopk, search_width=width)
    jg, tg = j._graph, t._graph
    assert tg["shards"] == jg["shards"] == s and tg["rows_per_shard"] == jg["rows_per_shard"]
    np.testing.assert_array_equal(tg["adj"].numpy(), np.asarray(jg["adj"]))
    np.testing.assert_array_equal(tg["validf"].numpy(), np.asarray(jg["validf"]))
    assert tg["row_ids"] == jg["row_ids"] and t.stats() == j.stats()
    assert t.resource_stats()["capacity"] == j.resource_stats()["capacity"]
    qs = _queries(x, 12, seed=9)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    for kb in (1, 16, 64):
        s_t, i_t = t._walk_shards_single_device(tg, torch.from_numpy(qn), kb, tg["iters"],
                                                width, itopk)
        s_j, i_j = j._walk_shards_single_device(jg, jnp.asarray(qn), kb, jg["iters"],
                                                width, itopk)
        assert _rows_agree(i_t, s_t, i_j, s_j, atol=WALK_ATOL)
    for k in (1, 10, 30):
        for a, b in zip(t.search_batch(qs, k), j.search_batch(qs, k)):
            assert _hits_agree(a, b)
    assert t.counts["walk"] == 3


def test_walk_on_an_empty_last_shard_matches_jax(same_edges):
    """Nine rows at 4 shards: the last shard holds none."""
    x = _clustered(9, seed=8)
    j, t = _cagra_pair(x, 4, min_n=1, degree=4)
    assert not t._graph["validf"][3 * t._graph["rows_per_shard"]:].any()
    for a, b in zip(t.search_batch(x[:4], 5), j.search_batch(x[:4], 5)):
        assert _hits_agree(a, b) and len(a) == 5


def _walk_fused_pair(pair, s):
    kw = dict(itopk=tann.CAGRA_ITOPK, search_width=tann.CAGRA_WIDTH, min_n=WALK_MIN_N,
              n_shards=s)
    jg = j_cagra.CagraIndex(brute=pair.jv, **kw)
    tg = t_cagra.CagraIndex(brute=pair.tv, **kw)
    jf = JFused(pair.jb, pair.jv, n_shards=s, min_n=1, walk_min_n=WALK_MIN_N, cagra=jg)
    tf = TFused(pair.tb, pair.tv, n_shards=s, min_n=1, walk_min_n=WALK_MIN_N)
    assert tf.rebind_cagra(tg)
    assert jf.build() and tf.build() and jg.build() and tg.build()
    return jf, tf


@pytest.mark.parametrize("s", SHARDS)
def test_walk_shard_loop_matches_jax(same_edges, s):
    pair = Pair(1500, seed=61)
    jf, tf = _walk_fused_pair(pair, s)
    qs = PARITY_QUERIES[:8]
    embs = pair.embs(len(qs))
    toks = [tokenize(q) for q in qs]
    b = len(qs)
    jsnap, tsnap = jf.lex._snap, tf.lex._snap
    jg, tg = jf.cagra._graph, tf.cagra._graph
    wctx = {"iters": jg["iters"], "width": tf.cagra.search_width, "itopk": tf.cagra.itopk,
            "hash_bits": tf.cagra.hash_bits, "n_seeds": tf.cagra.n_seeds}
    kp = tf.cagra.itopk
    ptr, urow, sel, avgdl = jf.lex.plan(jsnap, toks, b)
    lex_base = (jnp.asarray(ptr), jnp.asarray(urow), jnp.asarray(sel), jsnap["post_doc"],
                jsnap["post_tf"], jsnap["doc_len"], jsnap["alive"])
    out_j = jf._walk_shard_loop(jsnap, jg, lex_base, jf._ensure_walk_map(jsnap, jg), avgdl,
                                jsim.l2_normalize(jnp.asarray(embs)), _tail_j(b, 30), kp, wctx)
    lex_args = tf.lex.device_args(tsnap, *tf.lex.plan(tsnap, toks))
    out_t = tf._walk_shard_loop(tsnap, tg, lex_args, tf._ensure_walk_map(tsnap, tg),
                                tsim.l2_normalize(torch.from_numpy(embs)), _tail_t(b, 30),
                                kp, wctx)
    ls_t, lg_t, vs_t, vi_t, fs_t, fp_t = (_np(x) for x in out_t)
    ls_j, lg_j, vs_j, vi_j, fs_j, fp_j = (_np(x) for x in out_j)
    assert _rows_agree(lg_t, ls_t, lg_j, ls_j, rtol=LEX_RTOL)
    assert _rows_agree(vi_t, vs_t, vi_j, vs_j, atol=WALK_ATOL)
    # and through search_batch, against the JAX tier's rows (its mesh path)
    embs = pair.embs(len(PARITY_QUERIES))
    rows_t = _rows(tf, PARITY_QUERIES, embs, 30)
    _assert_walk_rows(rows_t, _rows(jf, PARITY_QUERIES, embs, 30), 30)
    assert all(r["served_by"] == TIER_WALK_F32 for r in rows_t)
    assert tf.counts["walk_dispatch"] == 1 and tf.counts["dispatch"] == 0


def _recall10(got, want):
    truth = {e for e, _ in want[:10]}
    return len({e for e, _ in got[:10]} & truth) / max(len(truth), 1)


def test_sharded_walks_hold_recall_on_the_ports_own_edges():
    """Without shared edges: the sharded index and the sharded fused walk
    at recall@10 >= 0.95 against exact search (and walk-parity against the
    host hybrid ranking)."""
    x = _clustered(3000, seed=66)
    t = t_cagra.CagraIndex(n_shards=2, device="cpu", min_n=256)
    t.add_batch([(f"d{i}", x[i]) for i in range(len(x))])
    assert t.build() and t._graph["shards"] == 2
    qs = _queries(x, 24, seed=3)
    exact = t._brute.search_batch(qs, 10, exact=True)
    assert np.mean([_recall10(a, e) for a, e in zip(t.search_batch(qs, 10), exact)]) >= 0.95
    rng = np.random.default_rng(67)
    bm25 = TBM25()
    for i in range(len(x)):
        bm25.index(f"d{i}", " ".join(rng.choice(VOCAB, size=int(rng.integers(3, 12)))))
    tf = TFused(bm25, t._brute, n_shards=2, min_n=1, walk_min_n=WALK_MIN_N)
    assert tf.rebind_cagra(t) and tf.build()
    qs = _queries(x, len(PARITY_QUERIES), seed=4)
    rows = _rows(tf, PARITY_QUERIES, qs, 30)
    assert all(r["served_by"] == TIER_WALK_F32 for r in rows)
    host = [rrf_fuse([lx, vx], limit=30) for lx, vx in
            zip(bm25.search_batch(PARITY_QUERIES, 30), t._brute.search_batch(qs, 30, exact=True))]
    assert np.mean([_recall10(r["fused"], h) for r, h in zip(rows, host)]) >= 0.95
    assert np.mean([_recall10(r["vec"], e) for r, e in
                    zip(rows, t._brute.search_batch(qs, 10, exact=True))]) >= 0.95


# ---------------------------------------------------------------------------
# the int8 plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("k", [1, 16, 100])
def test_int8_shard_loop_matches_jax_loop(s, k):
    rng = np.random.default_rng(16)
    c, d, b = 512, 24, 8
    mat = rng.standard_normal((c, d)).astype(np.float32)
    mat[200:216] = mat[:16]  # duplicate rows: tied coarse scores across shards
    codes, scale = tq.int8_encode(mat, "cpu")
    valid = np.ones(c, dtype=bool)
    valid[10:30] = False
    qn = (rng.standard_normal((b, d))).astype(np.float32)
    codes_t = np.ascontiguousarray(codes.T)
    s_j, i_j = jq.int8_topk_shard_reference(jnp.asarray(qn), jnp.asarray(codes_t),
                                            jnp.asarray(scale), jnp.asarray(valid), k, s)
    args = (torch.from_numpy(qn), torch.from_numpy(codes_t), torch.from_numpy(scale),
            torch.from_numpy(valid))
    s_t, i_t = tq.int8_topk_shards(*args, k, s)
    assert _rows_agree(i_t, s_t, i_j, s_j, atol=COS_ATOL)
    s_1, i_1 = tq._int8_topk_impl(*args, k)  # the one-shard coarse pool
    assert _rows_agree(i_t, s_t, i_1, s_1, atol=COS_ATOL)


@pytest.mark.parametrize("s", SHARDS)
def test_int8_sharded_plane_matches_jax_and_one_shard(s):
    x = _clustered(2000, seed=17)
    j, t = _index_pair(x)
    jp, tp = _planes(j, t, "int8", n_shards=s)
    one = _planes(j, t, "int8")[1]
    qs = _queries(x, 16, seed=5)
    for k in (1, 10, 30):
        got = tp.search_batch(qs, k)
        for a, b, c in zip(got, jp.search_batch(qs, k), one.search_batch(qs, k)):
            assert _hits_agree(a, b, COS_ATOL) and _hits_agree(a, c, COS_ATOL)
    assert tp._snap["shards"] == jp._snap["shards"] == s
    assert tp.counts["dispatch"] == 3 and not any(key.startswith("degrade_") for key in tp.counts)


# ---------------------------------------------------------------------------
# the named gaps
# ---------------------------------------------------------------------------


def test_unshardable_capacity_hands_off_as_jax():
    """3 shards of a 512-row brute capacity: the exact tier hands the
    batch to the host, as the reference's mesh path does."""
    pair = Pair(400, seed=31)
    jf, tf = pair.fused(n_shards=3)
    assert pair.tv.device_view()[0].shape[0] % 3
    embs = pair.embs(4)
    assert _rows(tf, PARITY_QUERIES[:4], embs, 10) == [None] * 4
    assert _rows(jf, PARITY_QUERIES[:4], embs, 10) == [None] * 4
    assert tf.counts["handoff_unshardable"] == 1 and tf.counts["dispatch"] == 0
    assert t_audit.LEDGER.snapshot(1)[0]["reason"] == "unshardable"


def test_walk_shard_mismatch_steps_down_as_jax(same_edges):
    """A 2-shard snapshot over a 1-shard graph: the walk batch goes to the
    exact tier, counted, with the JAX package's answers."""
    pair = Pair(1500, seed=41)
    kw = dict(itopk=tann.CAGRA_ITOPK, search_width=tann.CAGRA_WIDTH, min_n=WALK_MIN_N)
    jg = j_cagra.CagraIndex(brute=pair.jv, **kw)
    tg = t_cagra.CagraIndex(brute=pair.tv, **kw)
    jf = JFused(pair.jb, pair.jv, n_shards=2, min_n=1, walk_min_n=WALK_MIN_N, cagra=jg)
    tf = TFused(pair.tb, pair.tv, n_shards=2, min_n=1, walk_min_n=WALK_MIN_N)
    assert tf.rebind_cagra(tg) and jf.build() and tf.build() and jg.build() and tg.build()
    embs = pair.embs(len(PARITY_QUERIES))
    rows_t = _assert_parity(pair, jf, tf, PARITY_QUERIES, embs, 30)
    assert all(r["served_by"] == TIER_BRUTE_F32 for r in rows_t)
    assert tf.counts["walk_shard_mismatch"] == 1 and tf.counts["walk_dispatch"] == 0
    assert t_audit.LEDGER.snapshot(1)[0]["reason"] == "shard_mismatch"


def test_quant_keeps_float32_on_a_sharded_snapshot_and_graph(monkeypatch):
    """Under ``NORNICDB_VECTOR_QUANT=int8`` a sharded snapshot keeps the
    float32 exact tier and a sharded graph a float32 base, as the
    reference's; each step counted."""
    for key, value in (("VECTOR_QUANT", "int8"), ("QUANT_MIN_N", "64"),
                       ("QUANT_INLINE_BUILD", "1")):
        monkeypatch.setenv("NORNICDB_" + key, value)
    pair = Pair(600, seed=43)
    jf, tf = pair.fused(n_shards=2)
    embs = pair.embs(len(PARITY_QUERIES))
    rows_t = _assert_parity(pair, jf, tf, PARITY_QUERIES, embs, 30)
    assert all(r["served_by"] == TIER_BRUTE_F32 for r in rows_t)
    assert tf.counts["quant_shards"] == 1 and tf.counts["quant_dispatch"] == 0
    x = _clustered(600, seed=44)
    j, t = _cagra_pair(x, 2)
    assert t._graph["quant"] is None and j._graph["quant"] is None
    assert t.counts["quant_shards"] == 1


@pytest.mark.parametrize("mode,s,key", [("int8", 3, "shards_unshardable"),
                                        ("pq", 2, "shards_pq")])
def test_quant_plane_keeps_one_shard_where_it_cannot_split(mode, s, key):
    """int8 at a capacity that ``s`` does not divide (512 rows, 3 shards)
    builds one shard, as the reference's; PQ's ADC scan is one shard."""
    x = _clustered(500, seed=18)
    j, t = _index_pair(x)
    kw = dict(mode=mode, build_inline=True, pq_codes=16)
    tp = tq.QuantizedBrutePlane(t, n_shards=s, **kw)
    qs = _queries(x, 4, seed=6)
    got = tp.search_batch(qs, 10)
    assert tp._snap["shards"] == 1 and tp.counts[key] == 1
    if mode == "int8":
        jp = jq.QuantizedBrutePlane(j, n_shards=s, **kw)
        assert all(_hits_agree(a, b, COS_ATOL) for a, b in zip(got, jp.search_batch(qs, 10)))
        assert jp._snap["shards"] == 1


# ---------------------------------------------------------------------------
# the knobs, through the services
# ---------------------------------------------------------------------------


def test_hybrid_shards_knob_through_the_db_matches_jax(monkeypatch):
    for key, value in (("HYBRID_SHARDS", "2"), ("HYBRID_MIN_N", "50"),
                       ("HYBRID_INLINE_BUILD", "1")):
        monkeypatch.setenv("NORNICDB_" + key, value)
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False, embedder=THash())
    jdb = nornicdb_tpu.open(engine="memory", auto_embed=False, embedder=JHash())
    try:
        for db in (tdb, jdb):
            db.recall("warm", mode="text")
            rng = _store_corpus(db)
        qvs = rng.standard_normal((len(PARITY_QUERIES), D)).astype(np.float32)
        for q, qv in zip(PARITY_QUERIES, qvs):
            for kw in ({}, {"weights": (2.0, 0.5)}):
                th = tdb.search.search(q, limit=10, query_embedding=qv, **kw)
                jh = jdb.search.search(q, limit=10, query_embedding=qv, **kw)
                assert [h["id"] for h in th] == [h["id"] for h in jh], (q, kw)
        tf, jf = tdb.search._fused, jdb.search._fused
        assert tf.lex._snap["shards"] == jf.lex._snap["shards"] == 2
        assert tf.counts[TIER_BRUTE_F32] == 2 * len(PARITY_QUERIES) and tf.handoffs() == 0
    finally:
        tdb.close()
        jdb.close()


def _fill_services(pair, n, seed):
    x = _clustered(n, seed=seed)
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(VOCAB, size=int(rng.integers(3, 10)))) for _ in range(n)]
    for svc, cls in zip(pair, (JNode, TNode)):
        for i in range(n):
            svc.storage.create_node(_node(cls, i, texts[i], x[i]))
        svc.build_indexes()
    return x


def test_cagra_shards_knob_through_the_service_matches_jax(same_edges):
    same_edges.setenv("NORNICDB_VECTOR_ANN_QUALITY", "cagra")
    same_edges.setenv("NORNICDB_CAGRA_SHARDS", "2")
    pair = (JService(JEngine(), hnsw_threshold=1000),
            TService(TEngine(), device="cpu", hnsw_threshold=1000))
    x = _fill_services(pair, 1200, seed=51)
    j, t = pair
    assert t.stats.strategy == "cagra" and t.cagra._graph["shards"] == j.cagra._graph["shards"] == 2
    for qv in _queries(x, 12, seed=7):
        for k in (10, 30):
            assert _hits_agree(t.vector_search_candidates(qv, k), j.vector_search_candidates(qv, k))
    assert t.cagra.counts["walk"] == 24


def test_quant_shards_knob_through_the_service_matches_jax(monkeypatch):
    for key, value in (("VECTOR_QUANT", "int8"), ("QUANT_SHARDS", "2"), ("QUANT_MIN_N", "64"),
                       ("QUANT_INLINE_BUILD", "1")):
        monkeypatch.setenv("NORNICDB_" + key, value)
    pair = (JService(JEngine(), hnsw_threshold=10_000),
            TService(TEngine(), device="cpu", hnsw_threshold=10_000))
    x = _fill_services(pair, 1500, seed=52)
    j, t = pair
    for qv in _queries(x, 12, seed=8):
        for k in (10, 30):
            assert _hits_agree(t.vector_search_candidates(qv, k),
                               j.vector_search_candidates(qv, k), COS_ATOL)
    tp, jp = t.vectors._quant, j.vectors._quant
    assert tp._snap["shards"] == jp._snap["shards"] == 2 and tp.counts["dispatch"] == 24


@pytest.mark.parametrize("value", [None, "0", "junk", "-3", "2"])
def test_shard_knobs_parse_as_jax(monkeypatch, value):
    """Each knob read where the reference reads it: a value below 1 or not
    a number reads as one shard."""
    for key in ("HYBRID_SHARDS", "CAGRA_SHARDS", "QUANT_SHARDS"):
        if value is None:
            monkeypatch.delenv("NORNICDB_" + key, raising=False)
        else:
            monkeypatch.setenv("NORNICDB_" + key, value)
    for key, val in (("HYBRID_MIN_N", "50"), ("HYBRID_INLINE_BUILD", "1"),
                     ("VECTOR_QUANT", "int8"), ("QUANT_MIN_N", "1"),
                     ("VECTOR_ANN_QUALITY", "cagra")):
        monkeypatch.setenv("NORNICDB_" + key, val)
    pair = (JService(JEngine(), hnsw_threshold=300),
            TService(TEngine(), device="cpu", hnsw_threshold=300))
    _fill_services(pair, 300, seed=53)
    j, t = pair
    want = 2 if value == "2" else 1
    assert t._ensure_fused() is not None and j._ensure_fused() is not None
    assert t._fused.n_shards == j._fused.n_shards == want
    assert t.cagra.n_shards == j.cagra.n_shards == want
    assert t.vectors.quant_plane().n_shards == j.vectors.quant_plane().n_shards == want
