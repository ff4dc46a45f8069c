"""The port's tiered plane (``search/tiered_store.py``) and partition store
(``storage/partition_store.py``) against the JAX package's, the port on
``device="cpu"``.

Both planes partition the corpus with ``kmeans_fit``, whose seeds differ
between the packages (ROADMAP C22), so every parity test hands the port
the JAX package's k-means result (the ``seam`` fixture): then both build
the same partitions, slabs and codebooks, route alike, and answer alike
(ids tie-aware, scores within 1e-5); cold partitions are scanned exactly
(parity 1.0 with an exact scan of the probed rows), and the residency
LRU moves as the reference's. The recall test runs the port's own
k-means: recall@10 >= 0.95 against exact search."""

import time

import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import kmeans as jk
from nornicdb_tpu.search import tiered_store as jts
from nornicdb_tpu.search.vector_index import BruteForceIndex as JIndex
from nornicdb_tpu.storage.partition_store import PartitionStore as JStore
from nornicdb_tpu_torch.ops.topk import topk_agree
from nornicdb_tpu_torch.search import service as t_service
from nornicdb_tpu_torch.search import tiered_store as tts
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex as TIndex
from nornicdb_tpu_torch.storage.partition_store import PartitionStore as TStore

torch.set_num_threads(1)

SCORE_ATOL = 1e-5
D = 32


def _index_pair(n=2048, d=D, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 3
    vecs = (centers[rng.integers(0, 8, n)] + rng.standard_normal((n, d))).astype(np.float32)
    j, t = JIndex(dims=d), TIndex(dims=d, device="cpu")
    items = [(f"e{i}", vecs[i]) for i in range(n)]
    j.add_batch(items)
    t.add_batch(items)
    return j, t, vecs, rng


def _queries(vecs, rng, nq, noise=0.05):
    rows = rng.integers(0, len(vecs), nq)
    return (vecs[rows] + noise * rng.standard_normal((nq, vecs.shape[1]))).astype(np.float32)


def _hits_agree(got, want):
    if len(got) != len(want):
        return False
    return all(len(a) == len(b) and (not a or topk_agree(
        [[e for e, _ in a]], [[s for _, s in a]], [[e for e, _ in b]], [[s for _, s in b]],
        SCORE_ATOL)) for a, b in zip(got, want))


def _recall(got, want, k=10):
    return np.mean([len({e for e, _ in a[:k]} & {e for e, _ in b[:k]}) / max(min(k, len(b)), 1)
                    for a, b in zip(got, want)])


@pytest.fixture
def seam(monkeypatch):
    """The port's partitioner returns the JAX package's k-means result."""
    def fit(vectors, k=None, **kw):
        kw.pop("device", None)
        return jk.kmeans_fit(vectors, k=k, **kw)

    monkeypatch.setattr(tts, "kmeans_fit", fit)
    return monkeypatch


def _stores(j, t, tmp_path, **kw):
    kw.setdefault("build_inline", True)
    kw.setdefault("min_n", 64)
    kw.setdefault("parts", 8)
    kw.setdefault("nprobe", 4)
    kw.setdefault("rebuild_stale_frac", 1e9)  # the tests drive rebuilds
    js = jts.TieredStore(j, root_dir=str(tmp_path / "jax"), **kw)
    ts = tts.TieredStore(t, root_dir=str(tmp_path / "port"), **kw)
    assert js.build() and ts.build()
    return js, ts


def _wait_pager(*stores, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not any(s._paging for s in stores):
            return
        time.sleep(0.01)
    raise AssertionError("the pager did not finish")


def _same_residency(js, ts):
    a, b = js._snap, ts._snap
    assert a["resident"] == b["resident"] and a["lru"] == b["lru"]
    assert a["slab_pid"] == b["slab_pid"]
    np.testing.assert_array_equal(a["slab_slots"], b["slab_slots"])
    np.testing.assert_array_equal(ts._snap["codes_t"].numpy(), np.asarray(js._snap["codes_t"]))
    np.testing.assert_array_equal(ts._snap["slab_valid"].numpy(),
                                  np.asarray(js._snap["slab_valid"]))


# ---------------------------------------------------------------------------
# the partition store
# ---------------------------------------------------------------------------


def test_partition_store_round_trips_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    slots = np.arange(10, 40, dtype=np.int64)
    ids = [f"e{i}" for i in slots] + []
    rows = rng.standard_normal((30, 8)).astype(np.float32)
    codes = rng.integers(0, 256, (30, 4)).astype(np.uint8)
    t, j = TStore(str(tmp_path)), JStore(str(tmp_path))
    t.save_partition(3, slots, ids, rows, codes)
    for store in (t, j):
        got = store.load_partition(3)
        np.testing.assert_array_equal(got["slots"], slots)
        np.testing.assert_array_equal(got["rows"], rows)
        np.testing.assert_array_equal(got["codes"], codes)
        assert got["ext_ids"] == ids
    j.save_partition(5, slots[:2], ids[:2], rows[:2], codes[:2])
    assert t.partition_ids() == [3, 5] and t.has_partition(5)
    assert t.disk_bytes() == j.disk_bytes() > 0
    # corrupt or missing: None, never garbage
    with open(tmp_path / "part_7.npz", "wb") as f:
        f.write(b"not-an-npz")
    assert t.load_partition(7) is None and t.load_partition(99) is None
    assert t.delete_partition(5) and not t.delete_partition(5)
    t.clear()
    assert t.partition_ids() == []
    own = TStore()
    own.save_partition(0, slots, ids, rows, codes)
    root = own.root_dir
    own.close()
    assert not (tmp_path / root).exists()


# ---------------------------------------------------------------------------
# build, routing, answers
# ---------------------------------------------------------------------------


def test_build_matches_jax(seam, tmp_path):
    j, t, vecs, rng = _index_pair(seed=1)
    js, ts = _stores(j, t, tmp_path, resident_max=3)
    a, b = js._snap, ts._snap
    for key in ("capacity", "dims", "rows", "parts", "slab_rows", "r_slabs", "pq_m", "pq_codes"):
        assert a[key] == b[key], key
    np.testing.assert_array_equal(b["codebooks"].numpy(), np.asarray(a["codebooks"]))
    for pa, pb in zip(a["part_slots"], b["part_slots"]):
        np.testing.assert_array_equal(pa, pb)
    assert a["pid_of_ext"] == b["pid_of_ext"]
    _same_residency(js, ts)
    assert b["device_bytes"] == a["device_bytes"]
    assert ts.resource_stats_extra()["partitions"] == 8
    assert ts.store.partition_ids() == list(range(8))
    for pid in range(8):
        pj, pt = js.store.load_partition(pid), ts.store.load_partition(pid)
        for key in ("slots", "rows", "codes"):
            np.testing.assert_array_equal(pt[key], pj[key])
        assert pt["ext_ids"] == pj["ext_ids"]
    qn = vecs[:6] / np.linalg.norm(vecs[:6], axis=1, keepdims=True)
    hints = [None, ["e5", "e900"], [], ["nope"], ["e1", "e2"], None]
    np.testing.assert_array_equal(ts.route(qn, b, hints), js.route(qn, a, hints))
    # below min_n: no plane
    small = tts.TieredStore(t, min_n=len(t) + 1, root_dir=str(tmp_path / "small"))
    assert not small.build() and small.search_batch(vecs[:1]) is None


@pytest.mark.parametrize("resident_max,nprobe", [(0, 4), (3, 4), (1, 8)])
def test_answers_match_jax(seam, tmp_path, resident_max, nprobe):
    """All partitions resident, some cold, and nearly all cold."""
    j, t, vecs, rng = _index_pair(seed=2)
    js, ts = _stores(j, t, tmp_path, resident_max=resident_max, nprobe=nprobe)
    qs = _queries(vecs, rng, 12)
    hints = [[f"e{i}" for i in rng.integers(0, len(vecs), 5)] for _ in range(12)]
    for k in (1, 10):
        got = ts.search_batch(qs, k, lex_hints=hints)
        assert _hits_agree(got, js.search_batch(qs, k, lex_hints=hints))
        _wait_pager(js, ts)
        _same_residency(js, ts)
    assert ts.cold_scans == js.cold_scans and ts.promotions == js.promotions
    assert ts.evictions == js.evictions
    assert ts.counts["dispatch"] == 2


def test_cold_partitions_are_scanned_exactly(seam, tmp_path):
    """Every answer drawn from cold partitions is the exact scan of those
    partitions' rows (parity 1.0): with one slab and a pool over the
    whole slab, the answers are the exact top-k over the probed rows."""
    j, t, vecs, rng = _index_pair(seed=5)
    js, ts = _stores(j, t, tmp_path, resident_max=1, min_pool=4096, nprobe=8)
    qs = _queries(vecs, rng, 8)
    got = ts.search_batch(qs, 10)
    assert _hits_agree(got, js.search_batch(qs, 10))
    assert _hits_agree(got, t.search_batch(qs, 10, exact=True))
    assert ts.cold_scans == 1 and ts.counts["cold_scan"] == 1


def test_pager_promotes_and_the_lru_evicts_as_jax(seam, tmp_path):
    j, t, vecs, rng = _index_pair(seed=8)
    js, ts = _stores(j, t, tmp_path, resident_max=2, nprobe=1)
    cold = [p for p in range(8) if p not in ts._snap["resident"]]
    victim = ts._snap["lru"][0]
    for s in (js, ts):
        assert s.promote_inline([cold[0]]) == 1
    assert victim not in ts._snap["resident"] and ts.evictions == 1
    for s in (js, ts):
        assert s.promote_inline([victim]) == 1
    _same_residency(js, ts)
    assert ts._snap["residency_gen"] == js._snap["residency_gen"] == 2
    # a probe moves its partition to the LRU's back
    head = ts._snap["lru"][0]
    q = ts._snap["centroids"][head][None, :]
    for s in (js, ts):
        assert s.search_batch(q, 5) is not None
    assert ts._snap["lru"][-1] == head
    _same_residency(js, ts)
    # a cold probe is queued; the pager promotes it in the background,
    # and the same query is then served from the slabs
    far = [p for p in range(8) if p not in ts._snap["resident"]][0]
    q = ts._snap["centroids"][far][None, :]
    before = ts.cold_scans
    first = ts.search_batch(q, 5)
    assert ts.cold_scans == before + 1
    _wait_pager(ts)
    assert far in ts._snap["resident"]
    second = ts.search_batch(q, 5)
    assert ts.cold_scans == before + 1 and len(second[0]) == len(first[0]) == 5
    # a partition whose payload is gone stays cold; the host scan answers
    gone = [p for p in range(8) if p not in ts._snap["resident"]][0]
    ts.store.delete_partition(gone)
    assert ts.promote_inline([gone]) == 0 and ts.counts["promote_miss"] == 1


def test_freshness_as_jax(seam, tmp_path):
    j, t, vecs, rng = _index_pair(n=512, seed=10)
    js, ts = _stores(j, t, tmp_path, parts=4, nprobe=4)
    qs = _queries(vecs, rng, 6)
    top = ts.search_batch(qs, 5)[0][0][0]
    target = (qs[1] / np.linalg.norm(qs[1])).astype(np.float32)
    for idx in (j, t):
        idx.remove(top)
        idx.add("fresh", target)
        idx.add("e3", -vecs[3])
    qs = np.concatenate([qs, -vecs[3:4]])
    got = ts.search_batch(qs, 5)
    assert _hits_agree(got, js.search_batch(qs, 5))
    assert _hits_agree(got, t.search_batch(qs, 5, exact=True))
    assert top not in {e for e, _ in got[0]} and got[1][0][0] == "fresh"
    assert got[-1][0][0] == "e3" and ts.counts["delta_merge"] == 1


def test_named_gaps_step_down_and_are_counted(seam, tmp_path, monkeypatch):
    j, t, vecs, rng = _index_pair(seed=11)
    js, ts = _stores(j, t, tmp_path, resident_max=4)
    q = vecs[:2]
    # a promotion or eviction landing while the batch is in flight
    real = tts._tiered_topk_impl

    def racing(*a, **kw):
        out = real(*a, **kw)
        with ts._res_lock:
            ts._snap["residency_gen"] += 1
        return out

    monkeypatch.setattr(tts, "_tiered_topk_impl", racing)
    assert ts.search_batch(q, 10) is None and ts.counts["degrade_paging_race"] == 1
    monkeypatch.setattr(tts, "_tiered_topk_impl", real)
    # a compaction under the rerank gather
    real_rows = t.rows_for_slots
    t.rows_for_slots = lambda *a, **kw: None
    assert ts.search_batch(q, 10) is None and ts.counts["degrade_rerank_race"] == 1
    t.rows_for_slots = real_rows
    # changelog overrun
    for idx, s in ((j, js), (t, ts)):
        idx._changelog_floor = idx.mutations + 1
        assert s.search_batch(q, 10) is None
    assert ts.counts["degrade_changelog_overrun"] == 1
    # compaction
    for idx, s in ((j, js), (t, ts)):
        idx._changelog_floor = 0
        for i in range(1000, 1500):
            idx.remove(f"e{i}")
        assert idx.compact()
        assert s.search_batch(q, 10) is None
    assert ts.counts["degrade_compaction"] == 1
    # under-fill: one partition probed, its rows removed
    j2, t2, vecs2, _ = _index_pair(n=1024, seed=12)
    js2, ts2 = _stores(j2, t2, tmp_path / "u", nprobe=1)
    q = ts2._snap["centroids"][:1]
    pid = ts2.route(q, ts2._snap)[0][0]
    for idx in (j2, t2):
        for slot in ts2._snap["part_slots"][pid]:
            idx.remove(f"e{slot}")
    assert ts2.search_batch(q, 10) is None and js2.search_batch(q, 10) is None
    assert ts2.counts["degrade_underfill"] == 1
    # not built yet (a build in flight)
    lazy = tts.TieredStore(t2, min_n=64, root_dir=str(tmp_path / "lazy"))
    lazy._rebuilding = True
    assert lazy.search_batch(q, 10) is None and lazy.counts["degrade_pending_build"] == 1


@pytest.mark.parametrize("n,nprobe,floor", [(1024, 8, 0.95), (4096, 4, None)])
def test_recall_with_its_own_kmeans(tmp_path, n, nprobe, floor):
    """The port's partitions (its own draws, C22) with half of them
    resident: recall@10 against exact search >= 0.95 where every partition
    is probed (the reference's own acceptance shape), and within 0.05 of
    the JAX package's plane on its own partitions where half are."""
    j, t, vecs, rng = _index_pair(n=n, seed=13)
    kw = dict(min_n=64, parts=8, nprobe=nprobe, resident_max=4, build_inline=True)
    ts = tts.TieredStore(t, root_dir=str(tmp_path / "port"), **kw)
    js = jts.TieredStore(j, root_dir=str(tmp_path / "jax"), **kw)
    assert ts.build() and js.build()
    qs = _queries(vecs, rng, 32)
    want = t.search_batch(qs, 10, exact=True)
    got = _recall(ts.search_batch(qs, 10), want)
    assert got >= (floor if floor else _recall(js.search_batch(qs, 10), want) - 0.05)
    stats = ts.resource_stats_extra()
    assert stats["resident_partitions"] == 4
    assert n < 4096 or stats["tiered_capacity_ratio"] >= 4.0  # codebooks dominate below
    ts.close()


@pytest.fixture
def tiered_env(monkeypatch, tmp_path):
    monkeypatch.setenv("NORNICDB_VECTOR_TIERED", "1")
    monkeypatch.setenv("NORNICDB_TIERED_MIN_N", "64")
    monkeypatch.setenv("NORNICDB_TIERED_INLINE_BUILD", "1")
    monkeypatch.setenv("NORNICDB_TIERED_PARTS", "8")
    monkeypatch.setenv("NORNICDB_TIERED_NPROBE", "4")
    monkeypatch.setenv("NORNICDB_TIERED_RESIDENT", "4")
    monkeypatch.setenv("NORNICDB_TIERED_DIR", str(tmp_path / "tiered"))
    return monkeypatch


def test_the_ladder_and_the_service_route_as_jax(seam, tiered_env):
    j, t, vecs, rng = _index_pair(seed=14)
    qs = _queries(vecs, rng, 6)
    got = t.search_batch(qs, 10)
    assert _hits_agree(got, j.search_batch(qs, 10))
    plane = t.tiered_plane()
    # no promotion lands while a later batch is in flight (paging_race)
    _wait_pager(plane, j.tiered_plane())
    assert plane is t._tiered and plane.counts["dispatch"] == 1 and plane.nprobe == 4
    assert plane.resident_max == 4 and t._dev_matrix is None
    exact = t.search_batch(qs, 10, exact=True)
    assert plane.counts["dispatch"] == 1 and _hits_agree(exact, j.search_batch(qs, 10, exact=True))
    # the service: lexical hints route directly; exact never takes the plane
    svc = t_service.SearchService(device="cpu", hnsw_threshold=len(t) + 1)
    svc.vectors = t
    hints = [f"e{i}" for i in range(5)]
    hits = svc.vector_search_candidates(qs[0], 10, lexical_doc_ids=hints)
    assert _hits_agree([hits], j._tiered_search_batch(qs[:1], 10, lex_hints=[hints]))
    _wait_pager(plane, j.tiered_plane())
    svc.vector_search_candidates(qs[0], 10, exact=True)
    svc.vector_search_candidates(qs[0], 10)
    assert dict(svc.vector_routes) == {"tiered_route": 1, "exact": 1, "brute": 1}
    assert plane.counts["dispatch"] == 3
    tiered_env.setenv("NORNICDB_VECTOR_TIERED", "0")
    assert t.tiered_plane() is None
    plane.close()


def test_a_raising_plane_propagates(seam, tiered_env):
    """ROADMAP C23: the reference serves float32 when its plane raises."""
    j, t, vecs, rng = _index_pair(seed=15)
    qs = _queries(vecs, rng, 2)
    want = j.search_batch(qs, 5, exact=True)

    def boom(*a, **kw):
        raise RuntimeError("tiered plane: device fault")

    tiered_env.setattr(tts.TieredStore, "search_batch", boom)
    tiered_env.setattr(jts.TieredStore, "search_batch", boom)
    assert _hits_agree(j.search_batch(qs, 5), want)
    with pytest.raises(RuntimeError, match="device fault"):
        t.search_batch(qs, 5)


def test_nprobe_is_the_reference_s_and_its_knob_sets_it(monkeypatch, tmp_path):
    """Both packages probe 8 partitions a query by default, and
    NORNICDB_TIERED_NPROBE, read when the plane is created, sets it in
    both."""
    monkeypatch.setenv("NORNICDB_VECTOR_TIERED", "1")
    monkeypatch.setenv("NORNICDB_TIERED_MIN_N", "64")
    monkeypatch.setenv("NORNICDB_TIERED_DIR", str(tmp_path))
    j, t, _, _ = _index_pair(n=512, seed=16)
    assert tts.TIERED_NPROBE == 8 and t.tiered_plane().nprobe == 8
    assert j.tiered_plane().nprobe == 8
    monkeypatch.setenv("NORNICDB_TIERED_NPROBE", "20")
    t._tiered, j._tiered = None, None
    assert t.tiered_plane().nprobe == 20 and j.tiered_plane().nprobe == 20
