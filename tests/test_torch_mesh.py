"""The port's serving mesh (``nornicdb_tpu_torch/parallel/mesh.py`` and the
mesh bodies of device BM25, the fused tiers, the CAGRA walk and the int8
plane) against the JAX package's mesh paths, the port on ``device="cpu"``
with ``member_devices`` listing ``s`` CPU members, the JAX package over
``tests/conftest.py``'s eight CPU devices.

Contracts:

- **Against the JAX package** (its mesh path at 2, 4 and 8 devices): the
  exact tiers' ids tie-aware with the tolerances of
  ``tests/test_torch_shards.py`` (lexical a relative 1e-5, cosine 1e-5);
  the walks on the JAX package's k-NN edges (``same_edges``) with ids
  tie-aware and scores within 1e-6.
- **Against the port's loops**: every mesh path bitwise the loop over the
  same layout (the same operations, merged in the same order).
- **Selection**: the mesh at ``len(devices()) >= s``, the loops below it;
  the named gaps step down as on the loops, each counted; a member's
  fault propagates.
- ``best_mesh``/``make_mesh`` and §A11's ``euclidean_topk``,
  ``batch_dot`` and ``filter_by_similarity`` as the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import similarity as jsim
from nornicdb_tpu.parallel import mesh as jmesh
from nornicdb_tpu.search import cagra as j_cagra
from nornicdb_tpu.search.device_bm25 import DeviceBM25 as JDeviceBM25
from nornicdb_tpu.search.hybrid_fused import FusedHybrid as JFused
from nornicdb_tpu_torch.ops import similarity as tsim
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree
from nornicdb_tpu_torch.parallel import mesh as tmesh
from nornicdb_tpu_torch.search import ann_quality as tann
from nornicdb_tpu_torch.search import cagra as t_cagra
from nornicdb_tpu_torch.search import device_quant as tq
from nornicdb_tpu_torch.search import hybrid_fused as t_hybrid
from nornicdb_tpu_torch.search.bm25 import tokenize
from nornicdb_tpu_torch.search.device_bm25 import (
    DeviceBM25 as TDeviceBM25,
    topk_mesh,
    topk_shards,
)
from nornicdb_tpu_torch.search.hybrid_fused import (
    TIER_BRUTE_F32,
    TIER_WALK_F32,
    FusedHybrid as TFused,
)
from test_torch_cagra import _clustered, _hits_agree, _queries
from test_torch_hybrid import (
    COS_ATOL,
    PARITY_QUERIES,
    WALK_MIN_N,
    Pair,
    _assert_parity,
    _assert_walk_rows,
    _lex_agree,
    _rows,
)
from test_torch_quant import _pair as _index_pair, _planes
from test_torch_shards import WALK_ATOL, _rows_agree, same_edges  # noqa: F401

torch.set_num_threads(1)

SHARDS = [2, 4, 8]
CPU = torch.device("cpu")


def _members(s):
    return tmesh.member_devices([CPU] * s)


def _mesh_counts():
    return dict(tmesh.counts)


def _grew(before, kind):
    return tmesh.counts[kind] - before.get(kind, 0)


def _rows_equal(rows_a, rows_b):
    """Bitwise: the same ids and scores in every list, the same tier."""
    keys = ("lex", "vec", "fused", "served_by")
    return [tuple(r[k] for k in keys) for r in rows_a] == [tuple(r[k] for k in keys)
                                                           for r in rows_b]


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_best_mesh_and_make_mesh_match_jax(n):
    spec_t, spec_j = tmesh.best_mesh(n), jmesh.best_mesh(n)
    assert (spec_t.dp, spec_t.tp, spec_t.sp, spec_t.size) == \
        (spec_j.dp, spec_j.tp, spec_j.sp, spec_j.size)
    mesh_t = tmesh.make_mesh(spec_t, [CPU] * n)
    mesh_j = jmesh.make_mesh(spec_j, jax.devices()[:n])
    assert mesh_t.axis_names == tuple(mesh_j.axis_names)
    assert mesh_t.shape == dict(mesh_j.shape)
    assert mesh_t.devices.shape == mesh_j.devices.shape
    with pytest.raises(ValueError):
        tmesh.make_mesh(tmesh.MeshSpec(dp=n + 1), [CPU] * n)
    with pytest.raises(ValueError):
        jmesh.make_mesh(jmesh.MeshSpec(dp=n + 1), jax.devices()[:n])
    with _members(n):
        assert tmesh.make_mesh().shape == {"dp": n, "tp": 1, "sp": 1}
        assert tmesh.data_mesh().shape == dict(jmesh.data_mesh(n).shape) == {"data": n}
        assert tmesh.data_mesh(1).shape == {"data": 1}


def test_devices_and_the_member_list():
    """``devices()`` lists the one CPU for a CPU service; ``member_devices``
    replaces the list (a device may repeat) and restores it; the layout
    rule gives members at ``s`` devices or more only."""
    assert tmesh.devices("cpu") == [CPU]
    with _members(3) as devs:
        assert tmesh.devices("cpu") == devs == [CPU] * 3
        assert tmesh.mesh_members(3, "cpu") == [CPU] * 3
        assert tmesh.mesh_members(2, "cpu") == [CPU] * 2
        assert tmesh.mesh_members(4, "cpu") is None
        assert tmesh.mesh_members(1, "cpu") is None
    assert tmesh.devices("cpu") == [CPU]
    assert tmesh.mesh_members(2, "cpu") is None
    with pytest.raises(ValueError):
        with tmesh.member_devices([]):
            pass


# ---------------------------------------------------------------------------
# sharded_cosine_topk
# ---------------------------------------------------------------------------


def _topk_case(case):
    """The three calls of ``tests/test_ops.py``'s sharded top-k tests:
    (capacity, valid rows, D, B, k)."""
    return {"padded": (1024, 1000, 32, 4, 10), "k_over_shard": (256, 256, 16, 2, 50),
            "uneven": (1024, 30, 16, 3, 64)}[case]


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("case", ["padded", "k_over_shard", "uneven"])
def test_sharded_cosine_topk_matches_jax(s, case):
    cap, n, d, b, k = _topk_case(case)
    rng = np.random.default_rng(cap + n + s)
    m = np.zeros((cap, d), np.float32)
    m[:n] = rng.standard_normal((n, d))
    m[n // 2:n // 2 + 4] = m[:4]  # duplicate rows: tied scores across shards
    m = np.array(jsim.l2_normalize(jnp.asarray(m)))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    q = np.array(jsim.l2_normalize(jnp.asarray(rng.standard_normal((b, d)).astype(np.float32))))
    s_j, i_j = jmesh.sharded_cosine_topk(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), k,
                                         mesh=jmesh.data_mesh(s))
    args = (torch.from_numpy(q), torch.from_numpy(m), torch.from_numpy(valid))
    before = _mesh_counts()
    with _members(s):
        s_t, i_t = tmesh.sharded_cosine_topk(*args, k)
    assert _grew(before, "cosine_topk") == 1
    assert _rows_agree(i_t, s_t, i_j, s_j, atol=COS_ATOL)
    # the loop over the same row blocks, merged in shard order: bitwise
    rows = cap // s
    parts = [fused_cosine_topk(args[0], args[1][sh * rows:(sh + 1) * rows],
                               args[2][sh * rows:(sh + 1) * rows], min(k, rows))
             for sh in range(s)]
    s_l, i_l = tsim.concat_topk([p[0] for p in parts],
                                [p[1] + sh * rows for sh, p in enumerate(parts)], k)
    assert torch.equal(s_t, s_l) and torch.equal(i_t, i_l)
    # and one exact top-k over all rows; padding never surfaces
    s_1, i_1 = fused_cosine_topk(*args, k)
    assert _rows_agree(i_t, s_t, i_1, s_1, atol=COS_ATOL)
    finite = s_t.numpy() > -1e29
    assert valid[i_t.numpy()[finite]].all()


@pytest.mark.parametrize("s", [3, 5, 7])
def test_sharded_cosine_topk_refuses_an_unsplittable_capacity_as_jax(s):
    q, m = torch.ones((1, 4)), torch.ones((256, 4))
    with _members(s):
        with pytest.raises(ValueError, match="not divisible"):
            tmesh.sharded_cosine_topk(q, m, torch.ones(256, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.sharded_cosine_topk(jnp.ones((1, 4)), jnp.ones((256, 4)), jnp.ones(256, bool), 4,
                                  mesh=jmesh.data_mesh(s))


# ---------------------------------------------------------------------------
# device BM25
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
def test_bm25_mesh_matches_jax_and_the_loop(s):
    """The placed snapshot (one block a member) through ``search_batch``
    against the JAX package's (its mesh path) and the host index; its
    ``topk_mesh`` bitwise the loop's ``topk_shards`` on the same plan;
    through a tombstone, an update and an add."""
    pair = Pair(400, seed=11)
    jd = JDeviceBM25(pair.jb, n_shards=s, min_n=1)
    loop = TDeviceBM25(pair.tb, n_shards=s, min_n=1, device="cpu")
    assert jd.build() and loop.build() and "members" not in loop._snap
    with _members(s):
        td = TDeviceBM25(pair.tb, n_shards=s, min_n=1, device="cpu")
        assert td.build()
        snap = td._snap
        assert snap["members"] == [CPU] * s and len(snap["post_doc"]) == s
        assert td.device_bytes() == loop.device_bytes()
        toks = [tokenize(q) for q in PARITY_QUERIES]
        for step in range(2):
            before = _mesh_counts()
            rows_t = td.search_batch(PARITY_QUERIES, 15)
            assert _grew(before, "bm25") == 1
            rows_j = jd.search_batch(PARITY_QUERIES, 15)
            assert all(_lex_agree(a, b) for a, b in zip(rows_t, rows_j))
            assert all(_lex_agree(a, b) for a, b in
                       zip(rows_t, pair.tb.search_batch(PARITY_QUERIES, 15)))
            assert rows_t == loop.search_batch(PARITY_QUERIES, 15)
            for k in (8, 32):
                plan = td.plan(td._snap, toks)
                s_m, i_m = topk_mesh(td._snap, plan, k)
                s_l, i_l = topk_shards(loop._snap, loop.device_args(loop._snap, *plan), k)
                assert torch.equal(s_m, s_l) and torch.equal(i_m, i_l)
            if step == 0:
                pair.remove("d3")
                pair.index("d5", "term1 term2 term9")
                pair.index("fresh", "term1 term2 term3")
    assert td.builds == 1 and td.events["delta_merge"] >= 1


# ---------------------------------------------------------------------------
# the exact fused tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
def test_exact_tier_mesh_matches_jax_and_the_loop(monkeypatch, s):
    """The exact tier's mesh body through ``search_batch``: against the JAX
    package's tier (its mesh path) and the host path, bitwise the port's
    loop; one B1 launch a member a dispatch; the brute matrix's blocks
    placed once."""
    pair = Pair(600, seed=29)
    jf, loop = pair.fused(n_shards=s)
    embs = pair.embs(len(PARITY_QUERIES))
    calls = []

    def counted(*args):
        calls.append(args[1].shape[0])
        return fused_cosine_topk(*args)

    with _members(s):
        tf = TFused(pair.tb, pair.tv, n_shards=s, min_n=1)
        assert tf.build() and tf.lex._snap["members"] == [CPU] * s
        monkeypatch.setattr(t_hybrid, "fused_cosine_topk", counted)
        before = _mesh_counts()
        for weights in ((1.0, 1.0), (2.0, 0.5)):
            rows_t = _assert_parity(pair, jf, tf, PARITY_QUERIES, embs, 30, weights)
            assert _rows_equal(rows_t, _rows(loop, PARITY_QUERIES, embs, 30, weights))
        placed = tf._vec_placed
        assert _grew(before, "hybrid_fused") == tf.counts["dispatch"] == 2
    capacity = pair.tv.device_view()[0].shape[0]
    assert sorted(calls) == [capacity // s] * (4 * s)  # 2 dispatches each side
    assert tf.counts[TIER_BRUTE_F32] == 2 * len(PARITY_QUERIES) and tf.handoffs() == 0
    assert placed[0] is pair.tv.device_view()[0] and len(placed[2]) == s


@pytest.mark.parametrize("s", [2, 4])
def test_exact_tier_mesh_reads_its_writes_as_the_loop(s):
    """Writes after the build: the alive refresh reaches each member's
    block, the brute matrix's blocks are placed again for its new
    generation, and the rows stay bitwise the loop's."""
    pair = Pair(600, seed=31)
    _, loop = pair.fused(n_shards=s)
    with _members(s):
        tf = TFused(pair.tb, pair.tv, n_shards=s, min_n=1)
        assert tf.build()
        embs = pair.embs(8)
        first = _rows(tf, PARITY_QUERIES[:8], embs, 30)
        assert _rows_equal(first, _rows(loop, PARITY_QUERIES[:8], embs, 30))
        pair.remove("d7")
        pair.remove("d11", vec=False)
        pair.add("d13", pair.embs(1)[0])
        rows_t = _rows(tf, PARITY_QUERIES[:8], embs, 30)
        assert _rows_equal(rows_t, _rows(loop, PARITY_QUERIES[:8], embs, 30))
        assert tf._vec_placed[0] is pair.tv.device_view()[0]


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------


def _cagra(x, s, **kw):
    kw.setdefault("min_n", 256)
    t = t_cagra.CagraIndex(n_shards=s, device="cpu", **kw)
    t.add_batch([(f"v{i}", x[i]) for i in range(len(x))])
    assert t.build()
    return t


@pytest.mark.parametrize("s", SHARDS)
def test_cagra_mesh_walk_matches_jax_and_the_loop(same_edges, s):  # noqa: F811
    x = _clustered(1500, seed=4)
    kw = dict(itopk=tann.CAGRA_ITOPK, search_width=tann.CAGRA_WIDTH)
    j = j_cagra.CagraIndex(n_shards=s, min_n=256, **kw)
    j.add_batch([(f"v{i}", x[i]) for i in range(len(x))])
    assert j.build() and "mesh" in j._graph
    loop = _cagra(x, s, **kw)
    with _members(s):
        t = _cagra(x, s, **kw)
        g = t._graph
        assert g["members"] == [CPU] * s and g["matrix"] is None
        assert t.device_bytes() == loop.device_bytes()
        qs = _queries(x, 12, seed=9)
        qn = torch.from_numpy(qs / np.linalg.norm(qs, axis=1, keepdims=True))
        for kb in (1, 16, 64):
            args = (qn, kb, g["iters"], t.search_width, t.itopk)
            s_m, i_m = t._walk_mesh(g, *args)
            s_l, i_l = loop._walk_shards_single_device(loop._graph, *args)
            assert torch.equal(s_m, s_l) and torch.equal(i_m, i_l)
        before = _mesh_counts()
        for k in (1, 10, 30):
            got = t.search_batch(qs, k)
            assert got == loop.search_batch(qs, k)
            assert all(_hits_agree(a, b, WALK_ATOL) for a, b in zip(got, j.search_batch(qs, k)))
        assert _grew(before, "cagra_walk") == 3


def _walk_pair(pair, s):
    kw = dict(itopk=tann.CAGRA_ITOPK, search_width=tann.CAGRA_WIDTH, min_n=WALK_MIN_N,
              n_shards=s)
    tg = t_cagra.CagraIndex(brute=pair.tv, **kw)
    tf = TFused(pair.tb, pair.tv, n_shards=s, min_n=1, walk_min_n=WALK_MIN_N)
    assert tf.rebind_cagra(tg) and tf.build() and tg.build()
    return tf


@pytest.mark.parametrize("s", SHARDS)
def test_walk_tier_mesh_matches_jax_and_the_loop(same_edges, s):  # noqa: F811
    pair = Pair(1500, seed=61)
    kw = dict(itopk=tann.CAGRA_ITOPK, search_width=tann.CAGRA_WIDTH, min_n=WALK_MIN_N,
              n_shards=s)
    jg = j_cagra.CagraIndex(brute=pair.jv, **kw)
    jf = JFused(pair.jb, pair.jv, n_shards=s, min_n=1, walk_min_n=WALK_MIN_N, cagra=jg)
    assert jf.build() and jg.build() and "mesh" in jg._graph
    loop = _walk_pair(pair, s)
    embs = pair.embs(len(PARITY_QUERIES))
    with _members(s):
        tf = _walk_pair(pair, s)
        assert "members" in tf.lex._snap and "members" in tf.cagra._graph
        before = _mesh_counts()
        rows_t = _rows(tf, PARITY_QUERIES, embs, 30)
        assert _grew(before, "hybrid_walk") == 1
    assert all(r["served_by"] == TIER_WALK_F32 for r in rows_t)
    assert _rows_equal(rows_t, _rows(loop, PARITY_QUERIES, embs, 30))
    _assert_walk_rows(rows_t, _rows(jf, PARITY_QUERIES, embs, 30), 30)
    assert tf.counts["walk_dispatch"] == 1 and tf.counts["dispatch"] == 0


# ---------------------------------------------------------------------------
# the int8 plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", SHARDS)
def test_int8_mesh_matches_jax_and_the_loop(s):
    """Each member's rows encoded on it (the column block of the JAX
    package's codes), the coarse scan one shard a member bitwise the
    loop's, answers tie-aware the JAX package's plane (its mesh path)."""
    x = _clustered(2000, seed=17)
    j, t = _index_pair(x)
    jp, loop = _planes(j, t, "int8", n_shards=s)
    assert loop.build() and jp.build() and "members" not in loop._snap
    with _members(s):
        tp = _planes(j, t, "int8", n_shards=s)[1]
        assert tp.build()
        snap = tp._snap
        assert snap["members"] == [CPU] * s and "mesh" in jp._snap
        codes = np.concatenate([c.numpy() for c in snap["codes_t"]], axis=1)
        np.testing.assert_array_equal(codes, np.asarray(jp._snap["codes_t"]))
        assert all(c.is_contiguous() for c in snap["codes_t"])
        assert tp.device_bytes() == loop.device_bytes()
        qs = _queries(x, 16, seed=5)
        qn = torch.from_numpy(qs / np.linalg.norm(qs, axis=1, keepdims=True))
        for k in (1, 16, 100):
            s_m, i_m = tq.int8_topk_mesh(qn, snap["codes_t"], snap["scale"], snap["valid"], k,
                                         snap["members"])
            lsnap = loop._snap
            s_l, i_l = tq.int8_topk_shards(qn, lsnap["codes_t"], lsnap["scale"], lsnap["valid"],
                                           k, s)
            assert torch.equal(s_m, s_l) and torch.equal(i_m, i_l)
        before = _mesh_counts()
        for k in (1, 10, 30):
            got = tp.search_batch(qs, k)
            assert got == loop.search_batch(qs, k)
            assert all(_hits_agree(a, b, COS_ATOL) for a, b in zip(got, jp.search_batch(qs, k)))
        assert _grew(before, "int8") == 3
    assert tp.counts["dispatch"] == 3 and not any(k.startswith("degrade_") for k in tp.counts)


# ---------------------------------------------------------------------------
# selection, gaps and faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("listed", [1, 2, 3])
def test_fewer_devices_than_shards_build_the_loop_layout(listed):
    """Below ``s`` listed devices every tier builds the loop's layout and no
    mesh dispatch runs; at ``s`` and above it places its members."""
    s = 3 if listed < 3 else 2
    pair = Pair(400, seed=5)
    x = _clustered(600, seed=7)
    j, t = _index_pair(x)
    with _members(listed):
        tf = TFused(pair.tb, pair.tv, n_shards=s, min_n=1)
        cg = _cagra(x, s)
        plane = _planes(j, t, "int8", n_shards=2)[1]
        assert tf.build() and plane.build()
        placed = listed >= s
        assert ("members" in tf.lex._snap) == placed
        assert ("members" in cg._graph) == placed
        assert ("members" in plane._snap) == (listed >= 2)
        before = _mesh_counts()
        tf.lex.search_batch(PARITY_QUERIES[:4], 10)
        cg.search_batch(_queries(x, 4), 10)
        assert _grew(before, "bm25") == _grew(before, "cagra_walk") == int(placed)


def test_a_placed_layout_takes_the_loop_once_fewer_devices_are_listed(same_edges):  # noqa: F811
    """The dispatch reads the list again, as the reference reads
    ``jax.devices()``: a snapshot, graphs and an int8 plane placed on two
    members answer through the loop once one device is listed, with the
    same bits."""
    pair = Pair(1500, seed=62)
    embs = pair.embs(8)
    x = _clustered(1500, seed=63)
    j, t = _index_pair(x)
    qs = _queries(x, 8)
    with _members(2):
        tf = _walk_pair(pair, 2)
        cg = _cagra(x, 2)
        plane = _planes(j, t, "int8", n_shards=2)[1]
        assert plane.build() and "members" in plane._snap and "members" in cg._graph
        mesh_out = [_rows(tf, PARITY_QUERIES[:8], embs, 30),
                    tf.lex.search_batch(PARITY_QUERIES, 10), cg.search_batch(qs, 10),
                    plane.search_batch(qs, 10)]
        tf.walk_min_n = None
        mesh_out.append(_rows(tf, PARITY_QUERIES[:8], embs, 30))
    before = _mesh_counts()
    tf.walk_min_n = WALK_MIN_N
    loop_out = [_rows(tf, PARITY_QUERIES[:8], embs, 30), tf.lex.search_batch(PARITY_QUERIES, 10),
                cg.search_batch(qs, 10), plane.search_batch(qs, 10)]
    tf.walk_min_n = None
    loop_out.append(_rows(tf, PARITY_QUERIES[:8], embs, 30))
    assert _mesh_counts() == before
    assert _rows_equal(mesh_out[0], loop_out[0]) and _rows_equal(mesh_out[4], loop_out[4])
    assert mesh_out[1:4] == loop_out[1:4]


def test_unshardable_capacity_hands_off_on_the_mesh():
    """3 members and 3 shards over a 512-row brute capacity: the exact
    tier hands the batch to the host, counted, as the reference's mesh
    path does."""
    pair = Pair(400, seed=31)
    with _members(3):
        tf = TFused(pair.tb, pair.tv, n_shards=3, min_n=1)
        assert tf.build() and "members" in tf.lex._snap
        assert pair.tv.device_view()[0].shape[0] % 3
        before = _mesh_counts()
        assert _rows(tf, PARITY_QUERIES[:4], pair.embs(4), 10) == [None] * 4
    assert tf.counts["handoff_unshardable"] == 1 and _grew(before, "hybrid_fused") == 0


def test_walk_shard_mismatch_and_quant_step_down_on_the_mesh(same_edges, monkeypatch):  # noqa: F811
    """A placed 2-shard snapshot over a 1-shard graph sends the walk batch
    to the exact tier's mesh body (``walk_shard_mismatch``); under quant a
    placed sharded snapshot keeps float32 (``quant_shards``); each counted."""
    pair = Pair(1500, seed=41)
    kw = dict(itopk=tann.CAGRA_ITOPK, search_width=tann.CAGRA_WIDTH, min_n=WALK_MIN_N)
    embs = pair.embs(len(PARITY_QUERIES))
    with _members(2):
        tg = t_cagra.CagraIndex(brute=pair.tv, **kw)
        tf = TFused(pair.tb, pair.tv, n_shards=2, min_n=1, walk_min_n=WALK_MIN_N)
        assert tf.rebind_cagra(tg) and tf.build() and tg.build()
        before = _mesh_counts()
        rows = _rows(tf, PARITY_QUERIES, embs, 30)
        assert _grew(before, "hybrid_fused") == 1
        for key, value in (("VECTOR_QUANT", "int8"), ("QUANT_MIN_N", "64"),
                           ("QUANT_INLINE_BUILD", "1")):
            monkeypatch.setenv("NORNICDB_" + key, value)
        tf.walk_min_n = None
        quant_rows = _rows(tf, PARITY_QUERIES, embs, 30)
    assert all(r["served_by"] == TIER_BRUTE_F32 for r in rows + quant_rows)
    assert tf.counts["walk_shard_mismatch"] == 1 and tf.counts["walk_dispatch"] == 0
    assert tf.counts["quant_shards"] == 1 and tf.counts["quant_dispatch"] == 0
    assert _rows_equal(rows, quant_rows)


def test_a_members_fault_propagates(monkeypatch):
    """An error in the second member's B1 call reaches the caller of
    ``search_batch``: no hand-off, no step down, nothing served."""
    pair = Pair(600, seed=33)
    calls = []

    def faulting(q, m, valid, k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("member 1 failed")
        return fused_cosine_topk(q, m, valid, k)

    with _members(2):
        tf = TFused(pair.tb, pair.tv, n_shards=2, min_n=1)
        assert tf.build()
        monkeypatch.setattr(t_hybrid, "fused_cosine_topk", faulting)
        with pytest.raises(RuntimeError, match="member 1 failed"):
            _rows(tf, PARITY_QUERIES[:4], pair.embs(4), 10)
    assert len(calls) == 2
    assert sorted(k for k in tf.counts if k != "join_full") == []


# ---------------------------------------------------------------------------
# §A11: the remaining similarity functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 17])
def test_euclidean_topk_matches_jax_with_ties(k):
    rng = np.random.default_rng(k)
    m = np.round(rng.standard_normal((64, 8)), 1).astype(np.float32)
    m[40:48] = m[:8]  # duplicate rows: equal distances, the lower index first
    q = np.concatenate([m[:3], np.round(rng.standard_normal((2, 8)), 1)]).astype(np.float32)
    valid = rng.random(64) < 0.9
    valid[:8] = valid[40:48] = True
    d_j, i_j = jsim.euclidean_topk(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), k)
    d_t, i_t = tsim.euclidean_topk(torch.from_numpy(q), torch.from_numpy(m),
                                   torch.from_numpy(valid), k)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-4)
    assert topk_agree(i_t.numpy(), -d_t.numpy(), np.asarray(i_j), -np.asarray(d_j), 1e-4)
    assert (i_t[:3, 0].numpy() == np.arange(3)).all()  # a row's own copy, the lower index
    assert valid[i_t.numpy()].all()


@pytest.mark.parametrize("threshold,is_min", [(0.0, True), (0.5, True), (0.25, False),
                                              (0.5, False)])
def test_batch_dot_and_filter_by_similarity_match_jax(threshold, is_min):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 12)).astype(np.float32)
    b = rng.standard_normal((16, 12)).astype(np.float32)
    np.testing.assert_allclose(tsim.batch_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jsim.batch_dot(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-5)
    m = np.round(rng.standard_normal((40, 4)) / 2, 2).astype(np.float32)
    query = np.array([1.0, 0.0, 0.0, 0.0], np.float32)  # exact scores: ties sit on the threshold
    m[:5, 0] = threshold
    valid = rng.random(40) < 0.8
    got = tsim.filter_by_similarity(torch.from_numpy(query), torch.from_numpy(m),
                                    torch.from_numpy(valid), threshold, is_min)
    want = jsim.filter_by_similarity(jnp.asarray(query), jnp.asarray(m), jnp.asarray(valid),
                                     threshold, threshold_is_min=is_min)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:5].numpy().tolist() == valid[:5].tolist()  # on the threshold: kept either way
