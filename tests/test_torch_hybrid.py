"""The port's hybrid serving tier (DeviceBM25, FusedHybrid, MicroBatcher
and the service's fused path) against the JAX package, on the
reference's hybrid parity corpus (``tests/test_hybrid_fused.py``): the
same documents, vectors and queries in both packages, the JAX tier with
``min_n=1`` and an inline build, the port on ``device="cpu"``.

Tolerances: lexical and vector lists agree with the reference's and the
host path's tie-aware (``topk_agree``), lexical scores within a relative
1e-5 (the dense product adds a doc's terms in another order than the
host, so a score may move by a rounding step), cosine scores within
1e-5; fused RRF scores are bitwise equal to the host ``rrf_fuse`` over
the same two lists."""

import threading
import time

import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.search.bm25 import BM25Index as JBM25
from nornicdb_tpu.search.device_bm25 import DeviceBM25 as JDeviceBM25
from nornicdb_tpu.search import cagra as j_cagra
from nornicdb_tpu.search.hybrid_fused import FusedHybrid as JFused
from nornicdb_tpu.search.vector_index import BruteForceIndex as JIndex
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from nornicdb_tpu_torch.ops.topk import topk_agree
from nornicdb_tpu_torch.search import cagra as t_cagra
from nornicdb_tpu_torch.search import hybrid_fused as t_hybrid
from nornicdb_tpu_torch.search.ann_quality import CAGRA_ITOPK, CAGRA_WIDTH
from nornicdb_tpu_torch.search.bm25 import BM25Index as TBM25, tokenize
from nornicdb_tpu_torch.search.device_bm25 import (
    DeviceBM25 as TDeviceBM25,
    PlanOverflow,
    SnapshotStale,
)
from nornicdb_tpu_torch.search.hybrid_fused import (
    TIER_BRUTE_F32,
    TIER_WALK_F32,
    TIER_WALK_QUANT,
    FusedHybrid as TFused,
    quant_tier,
)
from nornicdb_tpu_torch.search.microbatch import MicroBatcher, pow2_bucket
from nornicdb_tpu_torch.search.rrf import rrf_fuse
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex as TIndex

torch.set_num_threads(1)

VOCAB = [f"term{i}" for i in range(64)]
D = 32
LEX_RTOL = 1e-5
COS_ATOL = 1e-5

PARITY_QUERIES = [
    "term1 term2 term3",
    "term4 term9 term11 term12",
    "term7 term8",
    "term0 term63",
    "term5 term5 term5 term6",      # repeated terms
    "term13 term14 term15 term16 term17",
    "term20",
    "term21 term22",
    "term23 term24 term25",
    "term30 term31 term32 term33",
    "term40 term41",
    "term42 term43 term44",
    "term50 term51 term52",
    "term60 term61 term62",
    "term2 textonly0",
    "term1 textonly1 term3",
    "zzz qqq nothing",              # empty lexical side
    "the and of is",                # stopword-only -> no tokens
    "term6 missingword",
    "term18 term19 term26 term27 term28 term29",
    "term34 term35",
    "term36 term37 term38 term39",
]


class Pair:
    """The same corpus in both packages: ``j*`` the JAX package's
    indexes, ``t*`` the port's."""

    def __init__(self, n=400, seed=7, text_only=12, vec_only=12):
        rng = np.random.default_rng(seed)
        self.jb, self.jv = JBM25(), JIndex()
        self.tb, self.tv = TBM25(), TIndex(device="cpu")
        for i in range(n):
            self.index(f"d{i}", " ".join(rng.choice(VOCAB, size=int(rng.integers(3, 12)))))
            self.add(f"d{i}", rng.standard_normal(D).astype(np.float32))
        for i in range(text_only):
            self.index(f"t{i}", f"term1 term2 textonly{i % 3}")
        for i in range(vec_only):
            self.add(f"v{i}", rng.standard_normal(D).astype(np.float32))
        self.rng = rng

    def index(self, doc_id, text):
        self.jb.index(doc_id, text)
        self.tb.index(doc_id, text)

    def add(self, doc_id, vec):
        self.jv.add(doc_id, vec)
        self.tv.add(doc_id, vec)

    def remove(self, doc_id, text=True, vec=True):
        if text:
            self.jb.remove(doc_id)
            self.tb.remove(doc_id)
        if vec:
            self.jv.remove(doc_id)
            self.tv.remove(doc_id)

    def fused(self, **kw):
        jf = JFused(self.jb, self.jv, min_n=1, **kw)
        tf = TFused(self.tb, self.tv, min_n=1, **kw)
        assert jf.build() and tf.build()
        return jf, tf

    def embs(self, n):
        return self.rng.standard_normal((n, D)).astype(np.float32)


def _lex_agree(a, b):
    """Tie-aware agreement of two BM25 [(id, score)] lists."""
    if len(a) != len(b):
        return False
    if not a:
        return True
    atol = LEX_RTOL * max(1.0, max(abs(s) for _, s in a))
    return topk_agree([[i for i, _ in a]], [[s for _, s in a]],
                      [[i for i, _ in b]], [[s for _, s in b]], atol)


def _vec_agree(a, b):
    if len(a) != len(b):
        return False
    return not a or topk_agree([[i for i, _ in a]], [[s for _, s in a]],
                               [[i for i, _ in b]], [[s for _, s in b]], COS_ATOL)


def _rows(fh, queries, embs, overfetch, weights=(1.0, 1.0)):
    extras = [{"tokens": tokenize(q), "n_cand": overfetch, "w": tuple(weights)}
              for q in queries]
    return fh.search_batch(np.asarray(embs, np.float32), pow2_bucket(overfetch), extras)


def _assert_parity(pair, jf, tf, queries, embs, overfetch, weights=(1.0, 1.0)):
    """Port rows against the JAX tier's rows and the port's host path."""
    rows_t = _rows(tf, queries, embs, overfetch, weights)
    rows_j = _rows(jf, queries, embs, overfetch, weights)
    host_lex = pair.tb.search_batch(queries, overfetch)
    host_vec = pair.tv.search_batch(embs, overfetch)
    for qi, (rt, rj, li, vi) in enumerate(zip(rows_t, rows_j, host_lex, host_vec)):
        assert rt is not None and rj is not None, qi
        assert _lex_agree(rt["lex"], li) and _lex_agree(rt["lex"], rj["lex"]), qi
        assert _vec_agree(rt["vec"], vi) and _vec_agree(rt["vec"], rj["vec"]), qi
        if rt["lex"] and rt["vec"]:
            # bitwise the host fuse over the same two lists
            assert rt["fused"] == rrf_fuse([rt["lex"], rt["vec"]],
                                           weights=list(weights), limit=overfetch), qi
            same = ([x[0] for x in rt["lex"]] == [x[0] for x in rj["lex"]]
                    and [x[0] for x in rt["vec"]] == [x[0] for x in rj["vec"]])
            if same:
                assert ([x[0] for x in rt["fused"]] == [x[0] for x in rj["fused"]]), qi
                assert ([x[1] for x in rt["fused"]] == [x[1] for x in rj["fused"]]), qi
    return rows_t


# ---------------------------------------------------------------------------
# host index: what the snapshot reads
# ---------------------------------------------------------------------------


def test_bm25_snapshot_support_matches_jax():
    pair = Pair(150, seed=3)
    for b in (pair.jb, pair.tb):
        b.remove("d3")
        b.index("d5", "term1 term9 rewritten")
    js, ts = pair.jb.csr_snapshot(), pair.tb.csr_snapshot()
    for key in ("offsets", "post_doc", "post_tf", "doc_len", "slots"):
        np.testing.assert_array_equal(ts[key], js[key])
    assert ts["row_ids"] == js["row_ids"] and ts["vocab"] == js["vocab"]
    assert pair.tb.mut_gen == pair.jb.mut_gen
    assert sorted(pair.tb.ids()) == sorted(pair.jb.ids())
    toks = sorted({"term1", "term9", "nope"})
    assert pair.tb.term_stats(toks) == pair.jb.term_stats(toks)
    assert pair.tb.search_batch(PARITY_QUERIES, 12) == pair.jb.search_batch(PARITY_QUERIES, 12)
    some = [f"d{i}" for i in range(0, 60, 3)]
    assert (pair.tb.score_docs(tokenize("term1 term2 term9"), some)
            == pair.jb.score_docs(tokenize("term1 term2 term9"), some))
    slots = list(range(-1, 160))
    np.testing.assert_array_equal(pair.tb.alive_slots(slots), pair.jb.alive_slots(slots))
    assert pair.tb.alive_slots(slots, expect_compactions=1) is None


def test_changelog_and_compaction_floor_match_jax():
    j, t = JBM25(), TBM25()
    for idx in (j, t):
        idx.index("a", "one")
    gen = t.mut_gen
    for idx in (j, t):
        idx.index("b", "two")
        idx.index("a", "one updated")
    assert t.changed_since(gen) == j.changed_since(gen) and set(t.changed_since(gen)) == {"a", "b"}
    assert t.changed_since(t.mut_gen) == []
    for idx in (j, t):
        for i in range(1200):
            idx.index(f"d{i}", "bulk")
        for i in range(1100):
            idx.remove(f"d{i}")
        idx.index("trigger", "compact me")
    assert t.compactions == j.compactions == 1
    assert t.changed_since(gen) is None and j.changed_since(gen) is None


def test_slots_of_and_views_pin_the_generation():
    t = TIndex(device="cpu")
    assert t.view_meta() is None and t.device_view() is None
    t.add("a", np.ones(4, np.float32))
    gen = t.mutations
    assert t.slots_of(["a", "zz"], expect_mutations=gen) == [0, -1]
    m, valid, ids, mutations = t.device_view()
    assert mutations == gen == t.view_meta() and ids[0] == "a" and bool(valid[0])
    t.add("b", np.ones(4, np.float32))
    assert t.slots_of(["a"], expect_mutations=gen) is None


def test_posting_arrays_convert_appended_entries_only():
    from nornicdb_tpu_torch.search.bm25 import _Posting

    p = _Posting()
    views = []
    for i in range(40):
        p.doc_ids.append(3 * i)
        p.tfs.append(i % 5 + 1)
        if i % 7 == 0:
            views.append((i + 1, *p.arrays()))
    for n, ids, tfs in views + [(40, *p.arrays())]:
        np.testing.assert_array_equal(ids, np.asarray(p.doc_ids[:n], np.int64))
        np.testing.assert_array_equal(tfs, np.asarray(p.tfs[:n], np.float32))
        assert ids.dtype == np.int64 and tfs.dtype == np.float32


def test_device_arrays_copy_written_rows_into_a_fresh_pair():
    rng = np.random.default_rng(5)
    t = TIndex(device="cpu")
    t.add_batch([(f"v{i}", rng.standard_normal(8)) for i in range(64)])
    m0, valid0 = t.device_view()[:2]
    held = (m0.clone(), valid0.clone())
    t.remove("v3")
    t.add("v3b", rng.standard_normal(8))  # takes the freed slot
    t.add("v7", rng.standard_normal(8))  # rewrites a row in place
    t.add("v64", rng.standard_normal(8))  # a new slot
    m1, valid1 = t.device_view()[:2]
    assert m1 is not m0 and valid1 is not valid0
    assert torch.equal(m0, held[0]) and torch.equal(valid0, held[1])  # readers keep theirs
    full = t.snapshot()
    np.testing.assert_array_equal(m1.numpy(), full[0])
    np.testing.assert_array_equal(valid1.numpy(), full[1])
    assert t.device_view()[0] is m1  # no write since: the same pair
    for i in range(80):  # past the capacity: regrown and copied whole
        t.add(f"w{i}", rng.standard_normal(8))
    m2 = t.device_view()[0]
    np.testing.assert_array_equal(m2.numpy(), t.snapshot()[0])


def test_alive_refresh_waits_for_a_tombstone():
    pair = Pair(200, seed=59, text_only=0, vec_only=0)
    jd, td = _dev_pair(pair)
    snap = td._snap
    alive0 = snap["alive"]
    pair.index("fresh", "term1 term2")  # no snapshot row changes
    td.refresh_alive(snap)
    assert snap["alive"] is alive0
    pair.index("d4", "term9")  # an update retires d4's row
    pair.remove("d5")
    td.refresh_alive(snap)
    row_of = snap["row_of"]
    assert not snap["alive"][row_of["d4"]] and not snap["alive"][row_of["d5"]]
    assert int(snap["alive"].sum()) == 198
    _assert_dev_parity(pair, jd, td, ["term9", "term1 term2"], 10)


def test_slots_changed_since_logs_slot_changes_only():
    t = TIndex(device="cpu")
    t._SLOT_LOG_CAP = 2
    t.add("a", np.ones(4, np.float32))
    gen = t.mutations
    t.add("a", np.full(4, 2.0, np.float32))  # same slot: not logged
    t.add("b", np.ones(4, np.float32))
    t.remove("a")
    assert t.slots_changed_since(gen, t.mutations) == {"a": -1, "b": 1}
    assert t.slots_changed_since(gen, t.mutations - 1) is None  # pinned generation
    for i in range(4):
        t.add(f"x{i}", np.ones(4, np.float32))
    assert t.slots_changed_since(gen, t.mutations) is None  # trimmed past gen
    assert t.slots_changed_since(t.mutations - 1, t.mutations) == {"x3": 4}


# ---------------------------------------------------------------------------
# device BM25
# ---------------------------------------------------------------------------


def _dev_pair(pair, **kw):
    jd = JDeviceBM25(pair.jb, min_n=1, **kw)
    td = TDeviceBM25(pair.tb, min_n=1, device="cpu", **kw)
    assert jd.build() and td.build()
    return jd, td


def _assert_dev_parity(pair, jd, td, queries, k):
    host = pair.tb.search_batch(queries, k)
    for h, j, t in zip(host, jd.search_batch(queries, k), td.search_batch(queries, k)):
        assert _lex_agree(t, h) and _lex_agree(t, j)
        for (_, hs), (_, ts) in zip(h, t):
            assert ts == pytest.approx(hs, rel=LEX_RTOL)


def test_device_bm25_matches_jax_and_host():
    pair = Pair(300)
    jd, td = _dev_pair(pair)
    _assert_dev_parity(pair, jd, td, PARITY_QUERIES, 15)
    assert td.builds == 1 and not td.events
    # the 16-bit count columns hold the counts exactly
    snap = td._snap
    assert snap["post_tf"].dtype == torch.int16 and snap["doc_len"].dtype == torch.int16
    base = pair.tb.csr_snapshot()
    np.testing.assert_array_equal(
        (snap["post_tf"].to(torch.int32) & 0xFFFF).numpy(), base["post_tf"])
    assert td.device_bytes() == sum(
        snap[key].numel() * snap[key].element_size()
        for key in ("post_doc", "post_tf", "doc_len", "alive"))


def test_device_bm25_tombstones_correct_df():
    pair = Pair(300)
    jd, td = _dev_pair(pair, rebuild_stale_frac=1.0)  # 60 removes: no rebuild
    for i in range(0, 120, 2):
        pair.remove(f"d{i}", vec=False)
    _assert_dev_parity(pair, jd, td, PARITY_QUERIES[:8], 15)
    assert td.builds == 1  # filtered, not rebuilt


def test_device_bm25_reads_its_writes():
    pair = Pair(300)
    jd, td = _dev_pair(pair)
    pair.index("fresh", "term1 term2 uniquefresh")
    pair.index("d0", "term1 updated content")  # an update takes a new slot
    qs = ["term1 uniquefresh", "term1 term2"]
    _assert_dev_parity(pair, jd, td, qs, 20)
    assert any(e == "fresh" for e, _ in td.search_batch(qs, 20)[0])
    assert td.events["delta_merge"] >= 1 and td.builds == 1


def test_device_bm25_below_min_n_serves_host():
    b = TBM25()
    for i in range(10):
        b.index(f"d{i}", "tiny corpus term1")
    td = TDeviceBM25(b, min_n=64, device="cpu")
    assert not td.build() and td.ensure_snapshot() is None
    assert td.search_batch(["term1"], 5) == b.search_batch(["term1"], 5)


def test_device_bm25_k_larger_than_corpus():
    pair = Pair(60, text_only=0, vec_only=0)
    jd, td = _dev_pair(pair)
    _assert_dev_parity(pair, jd, td, ["term1 term2"], 500)


# ---------------------------------------------------------------------------
# the fused tier on the parity corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["default", "weights", "tombstones", "k_over_corpus",
                                  "small_k"])
def test_fused_parity_with_jax_and_host(case):
    pair = Pair(**({"n": 80, "seed": 17, "text_only": 4, "vec_only": 4}
                   if case == "k_over_corpus" else {"seed": {"default": 7, "weights": 11,
                                                              "tombstones": 13,
                                                              "small_k": 19}[case]}))
    jf, tf = pair.fused()
    qs = PARITY_QUERIES
    if case == "tombstones":
        for i in range(0, 150, 3):
            pair.remove(f"d{i}")
    embs = pair.embs(len(qs))
    if case == "weights":
        for w in ((2.0, 0.5), (0.3, 3.0)):
            _assert_parity(pair, jf, tf, qs[:10], embs[:10], 30, weights=w)
    else:
        overfetch = {"k_over_corpus": 500, "small_k": 4}.get(case, 30)
        _assert_parity(pair, jf, tf, qs, embs, overfetch)
    assert tf.handoffs() == 0
    assert tf.counts[TIER_BRUTE_F32] == (20 if case == "weights" else len(qs))


def test_fused_rows_are_batch_invariant():
    """A query's row is the same alone as inside a batch of 22."""
    pair = Pair()
    _, tf = pair.fused()
    embs = pair.embs(len(PARITY_QUERIES))
    batch = _rows(tf, PARITY_QUERIES, embs, 30)
    for qi in (0, 5, 14):
        alone = _rows(tf, [PARITY_QUERIES[qi]], embs[qi:qi + 1], 30)[0]
        assert _lex_agree(alone["lex"], batch[qi]["lex"])
        assert _vec_agree(alone["vec"], batch[qi]["vec"])


def test_fused_empty_vector_index_hands_off():
    pair = Pair(100, text_only=0, vec_only=0)
    tf = TFused(pair.tb, TIndex(device="cpu"), min_n=1)
    assert tf.build()
    assert _rows(tf, ["term1 term2"], pair.embs(1), 10) == [None]
    assert tf.counts["handoff_vec_empty"] == 1 and tf.counts["dispatch"] == 0


def test_device_fuse_matches_host_rrf_on_ties():
    """Candidates at equal ranks of the two lists tie exactly; the device
    fuse orders them by first position, as the host does, and joins a
    doc found by both sources into one candidate."""
    kq = 4
    ls = torch.tensor([[5.0, 4.0, 3.0, -1e30]])
    lgrow = torch.tensor([[0, 1, 2, 0]])
    lid = torch.tensor([[10, -1, 12, 0]])  # b has no vector
    vs = torch.tensor([[0.9, 0.8, 0.7, 0.6]])
    vi = torch.tensor([[11, 13, 14, 10]])  # x, y, z, then a again
    fs, fpos = t_hybrid.rrf_fuse_device(
        ls, lid, lgrow, vs, vi, torch.tensor([4]), torch.tensor([1.0]),
        torch.tensor([1.0]), 60, 100)
    names = {0: "a", 1: "b", 2: "c", kq: "x", kq + 1: "y", kq + 2: "z", kq + 3: "a"}
    got = [(names[int(p)], float(s)) for s, p in zip(fs[0], fpos[0]) if s > -1e29]
    want = rrf_fuse([[("a", 5.0), ("b", 4.0), ("c", 3.0)],
                     [("x", .9), ("y", .8), ("z", .7), ("a", .6)]], limit=8)
    assert got == want
    assert [n for n, _ in got] == ["a", "x", "b", "y", "c", "z"]


# ---------------------------------------------------------------------------
# freshness rungs
# ---------------------------------------------------------------------------


def test_fused_reads_its_writes_without_rebuild():
    pair = Pair(seed=31)
    jf, tf = pair.fused()
    pair.index("fresh", "term1 term2 veryfreshterm")
    pair.add("fresh", pair.rng.standard_normal(D).astype(np.float32))
    pair.index("d1", "term50 term51 replacedcontent")  # an update: new slot
    qs = ["term1 veryfreshterm", "term50 replacedcontent", "term1 term2 term3"]
    embs = pair.embs(len(qs))
    rows = _assert_parity(pair, jf, tf, qs, embs, 25)
    assert any(e == "fresh" for e, _ in rows[0]["lex"])
    for row in rows:
        ids = [e for e, _ in row["lex"]]
        assert len(ids) == len(set(ids)) and row["served_by"] == "host"
    assert tf.lex.builds == 1 and tf.counts["host"] == len(qs)


def _wait_builds(dev_bm25, n, timeout=20.0):
    deadline = time.time() + timeout
    while dev_bm25.builds < n and time.time() < deadline:
        time.sleep(0.02)
    assert dev_bm25.builds >= n


def test_churn_starts_one_background_rebuild():
    pair = Pair(200, seed=41, text_only=0, vec_only=0)
    jf, tf = pair.fused(rebuild_stale_frac=0.05)
    for i in range(60):
        pair.index(f"churn{i}", f"term1 churnword{i % 5}")
    embs = pair.embs(1)
    _rows(tf, ["term1"], embs, 10)
    _wait_builds(tf.lex, 2)
    _assert_parity(pair, jf, tf, ["term1 churnword0"], embs, 10)
    assert tf.lex._snap["built_gen"] == pair.tb.mut_gen
    assert _rows(tf, ["term1 churnword0"], embs, 10)[0]["served_by"] == TIER_BRUTE_F32


def test_changelog_overrun_hands_off_then_rebuilds():
    pair = Pair(200, seed=43, text_only=0, vec_only=0)
    jf, tf = pair.fused()
    for i in range(4200):  # past the 4,096-entry changelog cap
        pair.tb.index(f"bulk{i}", f"term{i % 64} bulkword")
    embs = pair.embs(1)
    assert tf.lex.delta_block(tf.lex._snap) is None
    assert _rows(tf, ["term1"], embs, 10) == [None]
    assert tf.counts["handoff_changelog"] == 1
    _wait_builds(tf.lex, 2)
    row = _rows(tf, ["term1 bulkword"], embs, 10)[0]
    assert row["served_by"] == TIER_BRUTE_F32
    assert _lex_agree(row["lex"], pair.tb.search("term1 bulkword", 10))


def test_compaction_mid_request_hands_off():
    pair = Pair(200, seed=71, text_only=0, vec_only=0)
    _, tf = pair.fused()
    snap = tf.lex._snap
    pair.tb.remove("d0")
    with pair.tb._lock:
        pair.tb.compactions += 1  # the slot space moved under the snapshot
    with pytest.raises(SnapshotStale):
        tf.lex.refresh_alive(snap)
    assert _rows(tf, ["term1 term2"], pair.embs(1), 10) == [None]
    assert tf.counts["handoff_compaction"] == 1
    td = TDeviceBM25(pair.tb, min_n=1, device="cpu")
    td._snap = snap
    assert td.search_batch(["term1 term2"], 10) == pair.tb.search_batch(["term1 term2"], 10)
    assert td.events["host_compaction"] == 1


def test_plan_overflow_hands_off():
    pair = Pair(120, seed=73, text_only=0, vec_only=0)
    jd, td = _dev_pair(pair)
    _, tf = pair.fused()
    for snap in (td._snap, tf.lex._snap):
        snap["c"] = 2**31 - 1
    with pytest.raises(PlanOverflow):
        td.plan(td._snap, [("term1",)])
    assert td.search_batch(["term1 term2"], 10) == pair.tb.search_batch(["term1 term2"], 10)
    assert td.events["host_overflow"] == 1
    assert _rows(tf, ["term1"], pair.embs(1), 10) == [None]
    assert tf.counts["handoff_overflow"] == 1


def test_vector_write_racing_the_join_hands_off():
    pair = Pair(200, seed=47, text_only=0, vec_only=0)
    _, tf = pair.fused()
    snap = tf.lex._snap
    stale = pair.tv.mutations
    pair.tv.add("late", np.ones(D, np.float32))
    assert tf._ensure_map(snap, stale) is None
    real = pair.tv.device_view
    pair.tv.device_view = lambda: (*real()[:3], stale)  # a view from before the write
    try:
        assert _rows(tf, ["term1"], pair.embs(1), 10) == [None]
    finally:
        del pair.tv.device_view
    assert tf.counts["handoff_vec_race"] == 1
    assert _rows(tf, ["term1"], pair.embs(1), 10)[0]["served_by"] == TIER_BRUTE_F32


def test_join_map_patched_after_writes_equals_full_derivation():
    pair = Pair(200, seed=53, text_only=6, vec_only=0)
    _, tf = pair.fused()
    snap = tf.lex._snap
    embs = pair.embs(3)
    queries = ["term1 term2", "term3 textonly0", "term5"]

    def full():
        ids = ["" if e is None else e for e in snap["row_ids"]]
        return pair.tv.slots_of(ids)

    assert tf._ensure_map(snap, pair.tv.mutations).tolist() == full()
    pair.tv.remove("d3")  # frees a slot ...
    pair.tv.add("t0", np.ones(D, np.float32))  # ... that a text-only doc takes
    pair.tv.add("d5", np.ones(D, np.float32))  # same slot, new vector
    pair.tv.add("novel", np.ones(D, np.float32))  # no lexical row
    prev = snap["row_maps"]["l2v"][1]
    patched = tf._ensure_map(snap, pair.tv.mutations)
    assert patched is not prev and patched.tolist() == full()
    assert (tf.counts["join_full"], tf.counts["join_patch"]) == (1, 1)
    for rt, li, vi in zip(_rows(tf, queries, embs, 30), pair.tb.search_batch(queries, 30),
                          pair.tv.search_batch(embs, 30)):
        assert rt["served_by"] == TIER_BRUTE_F32
        assert _lex_agree(rt["lex"], li) and _vec_agree(rt["vec"], vi)
        assert rt["fused"] == rrf_fuse([rt["lex"], rt["vec"]], limit=30)
    pair.tv._SLOT_LOG_CAP = 1  # the log stops reaching back: derive in full
    for i in range(4):
        pair.tv.remove(f"d{10 + i}")
    assert pair.tv.slots_changed_since(snap["row_maps"]["l2v"][0], pair.tv.mutations) is None
    assert tf._ensure_map(snap, pair.tv.mutations).tolist() == full()
    assert (tf.counts["join_full"], tf.counts["join_patch"]) == (2, 1)


def test_compaction_remaps_the_join_in_full_as_jax():
    """Removes that compact the brute index (both packages at the same
    removal, the floor lowered) move every slot: the fused tier derives
    its join afresh instead of patching it, reads a new device pair, and
    its rows agree with the JAX tier's and the host path."""
    pair = Pair(400, seed=61, text_only=6, vec_only=6)
    for idx in (pair.jv, pair.tv):
        idx.compact_min_dead = 32
    jf, tf = pair.fused()
    queries = ["term1 term2", "term3 textonly0", "term5", "term7 term8"]
    embs = pair.embs(len(queries))
    _assert_parity(pair, jf, tf, queries, embs, 30)
    old_pair = pair.tv.device_view()[0]
    before = pair.tv.mutations
    for i in range(0, 400, 2):
        pair.remove(f"d{i}", text=False)
    for i in range(1, 20, 2):  # past half the used slots
        pair.remove(f"d{i}", text=False)
    assert pair.tv.compactions == pair.jv.compactions == 1
    assert pair.tv._capacity == pair.jv._capacity
    assert pair.tv.slots_changed_since(before, pair.tv.mutations) is None
    joins = tf.counts["join_full"]
    _assert_parity(pair, jf, tf, queries, embs, 30)
    assert tf.counts["join_full"] == joins + 1
    assert pair.tv.device_view()[0] is not old_pair


# ---------------------------------------------------------------------------
# the walk tier
# ---------------------------------------------------------------------------

WALK_SETTINGS = [(64, 1), (CAGRA_ITOPK, CAGRA_WIDTH)]  # the reference's, the port's
WALK_IDS = ["reference", "port"]
WALK_MIN_N = 1000


@pytest.fixture
def same_edges(monkeypatch):
    """Both graphs on the JAX package's k-NN edges (a near-tie may rank
    the other way under another summation order; the edges are held
    tie-aware in tests/test_torch_cagra.py)."""
    monkeypatch.setattr(t_cagra, "knn_forward",
                        lambda m, degree: j_cagra._knn_forward(m.cpu().numpy(), degree))
    return monkeypatch


def _walk_fused(pair, itopk, width, **kw):
    """Both packages' fused tiers with the walk at WALK_MIN_N, over graphs
    at (itopk, width) with ``kw``, snapshots and graphs built inline."""
    kw.update(itopk=itopk, search_width=width, min_n=WALK_MIN_N)
    jg = j_cagra.CagraIndex(brute=pair.jv, **kw)
    tg = t_cagra.CagraIndex(brute=pair.tv, **kw)
    jf = JFused(pair.jb, pair.jv, min_n=1, walk_min_n=WALK_MIN_N, cagra=jg)
    tf = TFused(pair.tb, pair.tv, min_n=1, walk_min_n=WALK_MIN_N)
    assert tf.rebind_cagra(tg)
    assert jf.build() and tf.build() and jg.build() and tg.build()
    return jf, tf


def _assert_walk_rows(rows_t, rows_j, overfetch, weights=(1.0, 1.0)):
    for qi, (rt, rj) in enumerate(zip(rows_t, rows_j)):
        assert rt is not None and rj is not None, qi
        assert rt["served_by"] == rj["served_by"] and rt["tier"] == rj["tier"], qi
        assert _lex_agree(rt["lex"], rj["lex"]) and _vec_agree(rt["vec"], rj["vec"]), qi
        if rt["lex"] and rt["vec"]:
            assert rt["fused"] == rrf_fuse([rt["lex"], rt["vec"]], weights=list(weights),
                                           limit=overfetch), qi
            if ([x[0] for x in rt["lex"]] == [x[0] for x in rj["lex"]]
                    and [x[0] for x in rt["vec"]] == [x[0] for x in rj["vec"]]):
                assert rt["fused"] == rj["fused"], qi


@pytest.mark.parametrize("itopk,width", WALK_SETTINGS, ids=WALK_IDS)
def test_walk_tier_matches_jax(same_edges, itopk, width):
    """Lexical lists, walk lists, fused lists and each row's tier against
    the JAX package's walk tier, and walk-parity against the host path."""
    pair = Pair(1500, seed=61)
    jf, tf = _walk_fused(pair, itopk, width)
    np.testing.assert_array_equal(tf.cagra._graph["adj"].numpy(),
                                  np.asarray(jf.cagra._graph["adj"]))
    embs = pair.embs(len(PARITY_QUERIES))
    for weights in ((1.0, 1.0), (2.0, 0.5)):
        rows_t = _rows(tf, PARITY_QUERIES, embs, 30, weights)
        rows_j = _rows(jf, PARITY_QUERIES, embs, 30, weights)
        _assert_walk_rows(rows_t, rows_j, 30, weights)
        assert all(r["served_by"] == TIER_WALK_F32 for r in rows_t)
    assert tf.counts["walk_dispatch"] == 2 and tf.counts["dispatch"] == 0
    assert tf.counts[TIER_WALK_F32] == 2 * len(PARITY_QUERIES)


def test_walk_tier_holds_walk_parity_at_the_port_defaults():
    """ROADMAP C14: the fused top 10 against the host hybrid ranking,
    recall@10 >= 0.95, on clustered vectors with queries near stored rows."""
    rng = np.random.default_rng(66)
    centers = rng.standard_normal((12, D)).astype(np.float32) * 2.0
    vecs = centers[rng.integers(0, 12, 3000)] + rng.standard_normal((3000, D)).astype(np.float32)
    bm25, brute = TBM25(), TIndex(device="cpu")
    for i in range(len(vecs)):
        bm25.index(f"d{i}", " ".join(rng.choice(VOCAB, size=int(rng.integers(3, 12)))))
    brute.add_batch([(f"d{i}", vecs[i]) for i in range(len(vecs))])
    tf = TFused(bm25, brute, min_n=1, walk_min_n=WALK_MIN_N)
    assert tf.build()
    embs = vecs[rng.choice(len(vecs), len(PARITY_QUERIES), replace=False)]
    embs = embs + 0.3 * rng.standard_normal(embs.shape).astype(np.float32)
    rows = _rows(tf, PARITY_QUERIES, embs, 30)
    assert all(r["served_by"] == TIER_WALK_F32 for r in rows)
    host = [rrf_fuse([lx, vx], limit=30) for lx, vx in
            zip(bm25.search_batch(PARITY_QUERIES, 30), brute.search_batch(embs, 30))]
    recall = np.mean([len({e for e, _ in r["fused"][:10]} & {e for e, _ in h[:10]})
                      / min(10, len(h)) for r, h in zip(rows, host)])
    assert recall >= 0.95


@pytest.mark.parametrize("itopk,width", WALK_SETTINGS, ids=WALK_IDS)
def test_walk_tier_reads_its_writes_as_jax(same_edges, itopk, width):
    """After the graph build: a new vector and an update are scored
    exactly and merged, removed docs are filtered; those rows re-fuse on
    the host (``host``), the others stay on the walk."""
    pair = Pair(1500, seed=62)
    jf, tf = _walk_fused(pair, itopk, width)
    embs = pair.embs(len(PARITY_QUERIES))
    embs[0] = pair.tv.get("d5") * 3.0
    gone = [e for e, _ in _rows(tf, PARITY_QUERIES[1:2], embs[1:2], 30)[0]["vec"][:5]]
    pair.add("novel", embs[2])
    pair.index("novel", "term7 term8 novelword")
    pair.add("d5", -embs[0])  # an update far from its old place
    for e in gone:
        pair.remove(e)
    rows_t = _rows(tf, PARITY_QUERIES, embs, 30)
    rows_j = _rows(jf, PARITY_QUERIES, embs, 30)
    _assert_walk_rows(rows_t, rows_j, 30)
    assert rows_t[2]["vec"][0][0] == "novel"
    assert "d5" not in [e for e, _ in rows_t[0]["vec"][:10]]
    assert not set(gone) & {e for r in rows_t for e, _ in r["vec"]}
    served = [r["served_by"] for r in rows_t]
    assert "host" in served and tf.counts["walk_dispatch"] == 2
    assert tf.cagra.builds == 1


@pytest.mark.parametrize("itopk,width", WALK_SETTINGS, ids=WALK_IDS)
def test_walk_tier_steps_down_to_the_brute_tier_as_jax(same_edges, itopk, width):
    pair = Pair(1500, seed=63)
    # no rebuild while the deletes below drain a pool
    jf, tf = _walk_fused(pair, itopk, width, rebuild_stale_frac=1.0)
    embs = pair.embs(4)
    queries = PARITY_QUERIES[:4]
    # a request deeper than the pool
    deep = 2 * itopk
    rows_t = _rows(tf, queries, embs, deep)
    _assert_walk_rows(rows_t, _rows(jf, queries, embs, deep), deep)
    assert all(r["served_by"] == TIER_BRUTE_F32 for r in rows_t)
    assert tf.counts["walk_itopk_exceeded"] == 1
    # a row the live filter leaves short: the batch re-runs on the exact tier
    victims = [e for e, _ in pair.tv.search_batch(embs[:1], 2 * itopk)[0]]
    for e in victims:
        pair.remove(e, text=False)
    rows_t = _rows(tf, queries, embs, 30)
    _assert_walk_rows(rows_t, _rows(jf, queries, embs, 30), 30)
    assert tf.counts["walk_underfill"] == 1 and tf.counts["walk_dispatch"] == 1
    assert rows_t[0]["tier"] == "brute" and tf.counts["dispatch"] == 2
    # the changelog no longer reaches the graph's build
    for idx in (pair.jv, pair.tv):
        idx._changelog_floor = idx.mutations
    for g in (jf.cagra, tf.cagra):
        g._delta_cache = None
    rows_t = _rows(tf, queries, embs, 30)
    _assert_walk_rows(rows_t, _rows(jf, queries, embs, 30), 30)
    assert tf.counts["walk_changelog_overrun"] == 1
    assert all(r["tier"] == "brute" for r in rows_t)
    # below walk_min_n live vectors the walk is off
    tf.walk_min_n = len(pair.tv) + 1
    assert _rows(tf, queries, embs, 30)[0]["tier"] == "brute"
    assert tf.handoffs() == 0


def test_walk_tier_pending_build_serves_the_brute_tier():
    pair = Pair(1200, seed=64)
    tf = TFused(pair.tb, pair.tv, min_n=1, walk_min_n=WALK_MIN_N, build_inline=False)
    assert (tf.cagra.itopk, tf.cagra.search_width) == (CAGRA_ITOPK, CAGRA_WIDTH)
    assert tf.build()
    embs = pair.embs(2)
    rows = _rows(tf, PARITY_QUERIES[:2], embs, 30)
    assert all(r["served_by"] == TIER_BRUTE_F32 for r in rows)
    assert tf.counts["walk_pending_build"] == 1
    deadline = time.time() + 30
    while not tf.cagra.graph_built and time.time() < deadline:
        time.sleep(0.02)
    assert all(r["served_by"] == TIER_WALK_F32 for r in _rows(tf, PARITY_QUERIES[:2], embs, 30))


def test_fused_tier_refuses_a_graph_over_another_index():
    pair = Pair(300, seed=65)
    other = t_cagra.CagraIndex(device="cpu")
    tf = TFused(pair.tb, pair.tv, min_n=1, walk_min_n=100)
    own = tf.cagra
    assert own is not None and own._brute is pair.tv
    assert not tf.rebind_cagra(other) and tf.cagra is own
    shared = t_cagra.CagraIndex(brute=pair.tv)
    assert tf.rebind_cagra(shared) and tf.cagra is shared


# ---------------------------------------------------------------------------
# the quantized tiers (NORNICDB_VECTOR_QUANT)
# ---------------------------------------------------------------------------


@pytest.fixture
def quant_env(monkeypatch):
    monkeypatch.setenv("NORNICDB_QUANT_MIN_N", "64")
    monkeypatch.setenv("NORNICDB_QUANT_INLINE_BUILD", "1")
    return monkeypatch


def _assert_quant_rows(rows_t, rows_j, overfetch, tier, weights=(1.0, 1.0)):
    """Quantized rows against the JAX package's: lists tie-aware, every
    row re-fused on the host (bitwise ``rrf_fuse`` of its own lists) and
    served by the quantized tier."""
    for qi, (rt, rj) in enumerate(zip(rows_t, rows_j)):
        assert rt is not None and rj is not None, qi
        assert rt["served_by"] == rj["served_by"] == tier, qi
        assert _lex_agree(rt["lex"], rj["lex"]) and _vec_agree(rt["vec"], rj["vec"]), qi
        if rt["lex"] and rt["vec"]:
            assert rt["fused"] == rrf_fuse([rt["lex"], rt["vec"]], weights=list(weights),
                                           limit=overfetch), qi
            if ([x[0] for x in rt["lex"]] == [x[0] for x in rj["lex"]]
                    and [x[0] for x in rt["vec"]] == [x[0] for x in rj["vec"]]):
                assert rt["fused"] == rj["fused"], qi


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_quant_brute_tier_matches_jax(quant_env, mode):
    """The quantized brute tier (walk off): the coarse pool, the exact
    rerank and the host re-fuse, against the JAX package's and the exact
    host path; the float32 pair never goes up."""
    quant_env.setenv("NORNICDB_VECTOR_QUANT", mode)
    pair = Pair(1500, seed=71)
    jf, tf = pair.fused()
    embs = pair.embs(len(PARITY_QUERIES))
    for weights in ((1.0, 1.0), (2.0, 0.5)):
        rows_t = _rows(tf, PARITY_QUERIES, embs, 30, weights)
        _assert_quant_rows(rows_t, _rows(jf, PARITY_QUERIES, embs, 30, weights), 30,
                           quant_tier(mode), weights)
    assert tf.counts["quant_dispatch"] == 2 and tf.counts["dispatch"] == 0
    assert tf.counts[quant_tier(mode)] == 2 * len(PARITY_QUERIES)
    assert pair.tv._dev_matrix is None
    if mode == "int8":  # the pool covers the rerank: the exact lists
        host = pair.tv.search_batch(embs, 30, exact=True)
        assert all(_vec_agree(r["vec"], h) for r, h in zip(rows_t, host))
    # writes since the plane's build: scored exactly and merged
    pair.add("fresh", embs[3])
    pair.index("fresh", "term4 term9 fresh")
    rows_t = _rows(tf, PARITY_QUERIES, embs, 30)
    _assert_quant_rows(rows_t, _rows(jf, PARITY_QUERIES, embs, 30), 30, quant_tier(mode))
    assert rows_t[3]["vec"][0][0] == "fresh"


def test_quant_brute_tier_steps_down_to_float32_as_jax(quant_env):
    quant_env.setenv("NORNICDB_VECTOR_QUANT", "int8")
    pair = Pair(1500, seed=72)
    jf, tf = pair.fused()
    embs = pair.embs(4)
    queries = PARITY_QUERIES[:4]
    assert all(r["served_by"] == quant_tier("int8") for r in _rows(tf, queries, embs, 30))
    for plane in (pair.jv.quant_plane(), pair.tv.quant_plane()):
        plane.rebuild_stale_frac = 1e9  # keep the stale plane
    # a compaction: the plane's slots address another layout
    for i in range(1100):
        pair.remove(f"d{i}", text=False)
    assert pair.tv.compactions == pair.jv.compactions == 1
    rows_t = _rows(tf, queries, embs, 30)
    _assert_parity(pair, jf, tf, queries, embs, 30)
    assert all(r["served_by"] == TIER_BRUTE_F32 for r in rows_t)
    assert tf.counts["quant_compaction"] >= 1
    # a plane whose build is in flight: float32 serves meanwhile
    plane = pair.tv.quant_plane()
    plane._snap, plane._rebuilding = None, True
    quant_env.delenv("NORNICDB_QUANT_INLINE_BUILD")
    plane.build_inline = False
    assert all(r["served_by"] == TIER_BRUTE_F32 for r in _rows(tf, queries, embs, 30))
    assert tf.counts["quant_pending_build"] == 1 and tf.handoffs() == 0


@pytest.mark.parametrize("mode", ["int8", "pq"])
@pytest.mark.parametrize("itopk,width", WALK_SETTINGS, ids=WALK_IDS)
def test_quant_walk_tier_matches_jax(same_edges, quant_env, mode, itopk, width):
    """The walk over a quantized graph base (int8: head prefilter + full
    dot; PQ: ADC over a 4x pool), its pool re-scored exactly and re-fused
    on the host, against the JAX package's."""
    quant_env.setenv("NORNICDB_VECTOR_QUANT", mode)
    pair = Pair(1500, seed=73)
    jf, tf = _walk_fused(pair, itopk, width)
    assert tf.cagra._graph["quant"]["mode"] == mode
    assert isinstance(tf.cagra._graph["matrix"], np.ndarray)  # f32 stays on the host
    embs = pair.embs(len(PARITY_QUERIES))
    rows_t = _rows(tf, PARITY_QUERIES, embs, 30)
    _assert_quant_rows(rows_t, _rows(jf, PARITY_QUERIES, embs, 30), 30, TIER_WALK_QUANT)
    assert all(r["tier"] == "walk" for r in rows_t)
    assert tf.counts["walk_dispatch"] == 1 and tf.counts[TIER_WALK_QUANT] == len(PARITY_QUERIES)
    qn = embs / np.linalg.norm(embs, axis=1, keepdims=True)
    for r, row in enumerate(rows_t):  # served scores are exact cosines
        for eid, sc in row["vec"]:
            assert sc == pytest.approx(float(qn[r] @ pair.tv.get(eid)), abs=COS_ATOL)


# ---------------------------------------------------------------------------
# the micro-batcher
# ---------------------------------------------------------------------------


def _index(n=500, d=32, seed=0):
    rng = np.random.default_rng(seed)
    idx = TIndex(device="cpu")
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx.add_batch([(f"v{i}", vecs[i]) for i in range(n)])
    return idx, vecs


def _run_threads(n, fn):
    barrier = threading.Barrier(n)

    def run(t):
        barrier.wait()
        fn(t)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)


def test_pow2_bucket():
    assert [pow2_bucket(n) for n in (0, 1, 2, 3, 30, 32, 33, 258)] == [1, 1, 2, 4, 32, 32, 64, 512]


def test_microbatcher_coalesces_concurrent_riders():
    idx, vecs = _index()

    def dispatch(queries, k):
        time.sleep(0.002)  # a dispatch takes time, so riders queue behind it
        return idx.search_batch(queries, k)

    mb = MicroBatcher(dispatch)
    rng = np.random.default_rng(1)
    queries = [vecs[rng.integers(0, len(vecs))]
               + 0.05 * rng.standard_normal(vecs.shape[1]).astype(np.float32)
               for _ in range(128)]
    expected = [idx.search_batch(q[None, :], 5)[0] for q in queries]
    results = [None] * len(queries)

    def worker(t):
        for j in range(t, len(queries), 16):
            results[j] = mb.search(queries[j], 5)

    _run_threads(16, worker)
    for got, want in zip(results, expected):
        assert _vec_agree(got, want)
    assert mb.batched_queries == len(queries) == sum(b * n for b, n in mb.sizes.items())
    assert mb.batches < len(queries) and max(mb.sizes) > 1


def test_microbatcher_single_query_is_direct():
    idx, vecs = _index()
    mb = MicroBatcher(idx.search_batch)
    q = vecs[7] + 0.01
    assert mb.search(q, 5) == idx.search_batch(q[None, :], 5)[0]
    assert (mb.batches, dict(mb.sizes)) == (1, {1: 1})


def test_microbatcher_truncates_mixed_k():
    idx, vecs = _index()
    seen_k = []

    def dispatch(queries, k):
        seen_k.append(k)
        time.sleep(0.2)  # hold the batch open so the riders meet
        return idx.search_batch(queries, k)

    mb = MicroBatcher(dispatch)
    out = {}

    def worker(t):
        out[t] = mb.search(vecs[0], (3, 9, 5, 9)[t])

    _run_threads(4, worker)
    assert [len(out[t]) for t in range(4)] == [3, 9, 5, 9]
    for t, k in ((0, 3), (2, 5), (3, 9)):
        assert _vec_agree(out[t], out[1][:k])
    assert all(k in (4, 8, 16) for k in seen_k) and mb.batches < 4


def test_microbatcher_error_reaches_every_rider():
    calls = []

    def boom(queries, k):
        calls.append(len(queries))
        time.sleep(0.01)
        raise RuntimeError("device fell over")

    mb = MicroBatcher(boom)
    errors = []

    def worker(t):
        try:
            mb.search(np.zeros(8, np.float32), 5)
        except RuntimeError as exc:
            errors.append(str(exc))

    _run_threads(8, worker)
    assert errors == ["device fell over"] * 8
    with pytest.raises(RuntimeError):  # still usable after an error
        mb.search(np.zeros(8, np.float32), 5)


def test_microbatcher_malformed_rider_fails_alone():
    idx, vecs = _index()

    def dispatch(queries, k):
        time.sleep(0.02)
        return idx.search_batch(queries, k)

    mb = MicroBatcher(dispatch)
    out, errors = {}, {}

    def worker(t):
        vec = vecs[t] if t else np.ones(7, np.float32)  # rider 0 has the wrong width
        try:
            out[t] = mb.search(vec, 3)
        except ValueError as exc:
            errors[t] = exc

    _run_threads(6, worker)
    assert list(errors) == [0] and sorted(out) == [1, 2, 3, 4, 5]
    for t in out:
        assert _vec_agree(out[t], idx.search_batch(vecs[t][None, :], 3)[0])


def test_fused_tier_through_the_hybrid_batcher():
    """Hybrid riders coalesce into fused dispatches; each gets its own row."""
    pair = Pair()
    _, tf = pair.fused()
    mb = MicroBatcher(tf.search_batch, pass_extras=True)
    embs = pair.embs(len(PARITY_QUERIES))
    expected = _rows(tf, PARITY_QUERIES, embs, 30)
    got = [None] * len(PARITY_QUERIES)

    def worker(t):
        for j in range(t, len(PARITY_QUERIES), 8):
            got[j] = mb.search(embs[j], 30, extra={
                "tokens": tuple(tokenize(PARITY_QUERIES[j])), "n_cand": 30, "w": (1.0, 1.0)})

    _run_threads(8, worker)
    for g, e in zip(got, expected):
        assert _lex_agree(g["lex"], e["lex"]) and _vec_agree(g["vec"], e["vec"])
        assert g["fused"] == rrf_fuse([g["lex"], g["vec"]], limit=30)
    assert mb.batched_queries == len(PARITY_QUERIES)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


def _store_corpus(db, n=400, seed=5):
    rng = np.random.default_rng(seed)
    for i in range(n):
        text = " ".join(rng.choice(VOCAB, size=int(rng.integers(3, 10))))
        db.store(text, labels=["Doc"], node_id=f"n{i}",
                 embedding=[float(x) for x in rng.standard_normal(D).astype(np.float32)])
    return rng


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("NORNICDB_HYBRID_MIN_N", "50")
    monkeypatch.setenv("NORNICDB_HYBRID_INLINE_BUILD", "1")
    return monkeypatch


def test_service_fused_matches_jax_db_and_host(fused_env):
    tdb = nornicdb_tpu_torch.open(device="cpu", auto_embed=False, embedder=THash())
    jdb = nornicdb_tpu.open(engine="memory", auto_embed=False, embedder=JHash())
    try:
        for db in (tdb, jdb):
            db.recall("warm", mode="text")  # build the services first
            rng = _store_corpus(db)
        qvs = rng.standard_normal((len(PARITY_QUERIES), D)).astype(np.float32)
        fused = {}
        for q, qv in zip(PARITY_QUERIES, qvs):
            for kw in ({}, {"weights": (2.0, 0.5)}, {"min_score": 0.5}, {"labels": ["Nope"]}):
                th = tdb.search.search(q, limit=10, query_embedding=qv, **kw)
                jh = jdb.search.search(q, limit=10, query_embedding=qv, **kw)
                assert [h["id"] for h in th] == [h["id"] for h in jh], (q, kw)
                if (any("bm25_score" in h for h in th)
                        and any("vector_score" in h for h in th)):
                    # fused RRF scores: bitwise
                    assert [h["score"] for h in th] == [h["score"] for h in jh], (q, kw)
                else:  # one source's raw scores
                    assert [h["score"] for h in th] == pytest.approx(
                        [h["score"] for h in jh], rel=LEX_RTOL, abs=COS_ATOL), (q, kw)
                fused[(q, str(kw))] = th
        svc = tdb.search
        assert svc._fused is not None and svc._fused.ready
        assert jdb.search._fused is not None and jdb.search._fused.ready
        # every query with tokens and a vector rode the fused tier
        assert svc._fused.counts[TIER_BRUTE_F32] == 4 * len(PARITY_QUERIES)
        assert svc._fused.handoffs() == 0
        fused_env.setenv("NORNICDB_HYBRID_FUSED", "0")
        for q, qv in zip(PARITY_QUERIES, qvs):
            host = svc.search(q, limit=10, query_embedding=qv)
            assert [h["id"] for h in host] == [h["id"] for h in fused[(q, "{}")]], q
        assert svc._fused is None
    finally:
        tdb.close()
        jdb.close()


def test_recall_through_the_fused_tier_matches_the_jax_db(fused_env):
    """Both DBs embed with the mini checkpoint in float32 and answer
    ``recall`` through their fused tiers."""
    import dataclasses

    import jax.numpy as jnp

    from nornicdb_tpu.embed.embedder import CachedEmbedder, JaxEncoderEmbedder
    from nornicdb_tpu.models import encoder as jenc
    from nornicdb_tpu.models import pretrain as jpre
    from nornicdb_tpu_torch.embed.embedder import CachedEmbedder as TCached
    from nornicdb_tpu_torch.models import checkpoint as tckpt

    jcfg, jparams = jpre.load_checkpoint(jpre.default_checkpoint_path())
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    jdb = nornicdb_tpu.open(engine="memory", embedder=CachedEmbedder(
        JaxEncoderEmbedder(model=jenc.Encoder(jcfg), params=jparams, cfg=jcfg)))
    tdb = nornicdb_tpu_torch.open(device="cpu", embedder=TCached(
        tckpt.load_default_embedder(device="cpu", dtype=torch.float32)))
    rng = np.random.default_rng(9)
    docs = [" ".join(rng.choice(VOCAB, size=int(rng.integers(3, 12)))) for _ in range(200)]
    try:
        for db in (jdb, tdb):
            for i, text in enumerate(docs):
                db.store(text, labels=["Doc"], node_id=f"d{i}")
            db.flush()
        for q in PARITY_QUERIES:
            for limit in (5, 10):
                th, jh = tdb.recall(q, limit=limit), jdb.recall(q, limit=limit)
                assert [h["id"] for h in th] == [h["id"] for h in jh], (q, limit)
        fused = tdb.search._fused
        assert fused is not None and jdb.search._fused is not None
        # every query rode the fused tier, the stopword-only one too (no
        # lexical terms, a vector list)
        assert fused.counts[TIER_BRUTE_F32] == 2 * len(PARITY_QUERIES)
        assert fused.handoffs() == 0
    finally:
        tdb.close()
        jdb.close()


def test_service_below_min_n_serves_host(monkeypatch):
    monkeypatch.setenv("NORNICDB_HYBRID_INLINE_BUILD", "1")
    db = nornicdb_tpu_torch.open(device="cpu", auto_embed=False, embedder=THash())
    try:
        db.recall("warm", mode="text")
        rng = _store_corpus(db, n=120)
        qv = rng.standard_normal(D).astype(np.float32)
        assert db.search.search("term1 term2", query_embedding=qv)
        assert db.search._fused is None  # 120 < 4,096
        monkeypatch.setenv("NORNICDB_HYBRID_MIN_N", "100")
        assert db.search.search("term1 term2", query_embedding=qv)
        assert db.search._fused.counts[TIER_BRUTE_F32] == 1
    finally:
        db.close()


def test_service_raises_when_the_dispatch_raises(fused_env):
    db = nornicdb_tpu_torch.open(device="cpu", auto_embed=False, embedder=THash())
    try:
        db.recall("warm", mode="text")
        rng = _store_corpus(db, n=120)
        qv = rng.standard_normal(D).astype(np.float32)
        assert db.search.search("term1 term2", query_embedding=qv)

        def launch_failed(*args, **kw):
            raise RuntimeError("cosine_topk kernel: launch failed")

        fused_env.setattr(t_hybrid, "fused_cosine_topk", launch_failed)
        with pytest.raises(RuntimeError, match="launch failed"):
            db.search.search("term1 term2", query_embedding=qv)
        # text mode never touches the fused tier
        assert db.search.search("term1 term2", mode="text")
    finally:
        db.close()


def test_service_vector_queries_ride_the_batcher():
    db = nornicdb_tpu_torch.open(device="cpu", auto_embed=False, embedder=THash())
    try:
        db.recall("warm", mode="text")
        rng = _store_corpus(db, n=120)
        svc = db.search
        qvs = rng.standard_normal((32, D)).astype(np.float32)
        want = [svc.vectors.search_batch(q[None, :], 7)[0] for q in qvs]
        got = [None] * len(qvs)

        def worker(t):
            for j in range(t, len(qvs), 8):
                got[j] = svc.vector_search_candidates(qvs[j], 7)

        _run_threads(8, worker)
        assert all(_vec_agree(g, w) for g, w in zip(got, want))
        stats = svc.microbatch_stats()
        assert stats["batched_queries"] == 32 and stats["batches"] <= 32
        assert stats["mean_batch"] == 32 / stats["batches"]
    finally:
        db.close()
