"""The port's background device plane (``background/device_plane.py``)
and its ops (``ops/{decay,linkpredict,fastrp}.py``) against the JAX
package's, on the same seeded inputs, the port on ``device="cpu"``.

Tolerances. Ops: decay scores, Kalman estimates and errors within 1e-6
(float32, ``exp2`` and the sums may round differently), the float64
band re-check bitwise; link-prediction ids tie-aware, values exact for
common neighbors (small-integer sums) and within 1e-6 for the weighted
scorers (float32 sums in another order), distinct counts equal; host
FastRP bitwise, device FastRP rows at cosine >= 0.999 against the JAX
package's device and host versions. The plane, on the 300-node graph of
``tests/test_background_plane.py``: decay verdicts and every
link-prediction list equal to the JAX plane's and to the host loops'
(the plane's contract is exact, so parity is 1.0), FastRP cosine
>= 0.999. The named step-downs are counted, and a raising dispatch
propagates where the JAX plane answers from the host (ROADMAP C25)."""

import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu import linkpredict as jlp
from nornicdb_tpu.background import device_plane as jdp
from nornicdb_tpu.decay import DecayManager as JDecay
from nornicdb_tpu.inference import InferenceEngine as JInference
from nornicdb_tpu.ops import decay as jod
from nornicdb_tpu.ops import fastrp as jof
from nornicdb_tpu.ops import linkpredict as jol
from nornicdb_tpu.query.columnar import ColumnarCatalog as JCatalog
from nornicdb_tpu.search.service import SearchService as JService
from nornicdb_tpu.storage import Edge as JEdge
from nornicdb_tpu.storage import MemoryEngine as JMemory
from nornicdb_tpu.storage import Node as JNode
from nornicdb_tpu_torch import linkpredict as tlp
from nornicdb_tpu_torch.background import device_plane as tdp
from nornicdb_tpu_torch.decay import DecayManager as TDecay
from nornicdb_tpu_torch.inference import InferenceEngine as TInference
from nornicdb_tpu_torch.ops import decay as tod
from nornicdb_tpu_torch.ops import fastrp as tof
from nornicdb_tpu_torch.ops import linkpredict as tol
from nornicdb_tpu_torch.ops.topk import topk_agree
from nornicdb_tpu_torch.query.columnar import ColumnarCatalog as TCatalog
from nornicdb_tpu_torch.search.service import SearchService as TService
from nornicdb_tpu_torch.storage import Edge as TEdge
from nornicdb_tpu_torch.storage import MemoryEngine as TMemory
from nornicdb_tpu_torch.storage import Node as TNode

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECAY_ATOL = 1e-6
LP_ATOL = 1e-6
FASTRP_COS = 0.999
METHODS = ("common_neighbors", "adamic_adar", "resource_allocation")

# tests/test_background_plane.py's graph: 300 nodes, 1,200 edges over
# three types, importance uniform, one node in three accessed in the last
# 40 days, archive threshold 0.45
N = 300
E = 1_200
DAY = 86_400_000
NOW = 1_700_000_000_000

PORT = (TMemory, TNode, TEdge, TDecay, TCatalog)
JAX = (JMemory, JNode, JEdge, JDecay, JCatalog)


def _engine(side, seed=7):
    mem, node, edge = side[:3]
    rng = random.Random(seed)
    eng = mem()
    for i in range(N):
        eng.create_node(node(id=f"n{i}", labels=["T"], properties={"importance": rng.random()},
                             created_at=NOW - rng.randrange(0, 80 * DAY)))
    for j in range(E):
        eng.create_edge(edge(id=f"e{j}", type=("KNOWS", "LIKES", "FOLLOWS")[j % 3],
                             start_node=f"n{rng.randrange(N)}", end_node=f"n{rng.randrange(N)}"))
    return eng


def _decay(side, eng):
    dm = side[3](eng, archive_threshold=0.45)
    rng = random.Random(3)
    for i in range(0, N, 3):
        dm.record_access(f"n{i}", at_ms=NOW - rng.randrange(0, 40 * DAY))
    return dm


def _archived(eng):
    return sorted(n.id for n in eng.all_nodes() if n.properties.get("_archived"))


def _port_plane(**kw):
    eng = _engine(PORT)
    cat = TCatalog(eng)
    return eng, cat, tdp.BackgroundDevicePlane(eng, cat, device="cpu", **kw)


# -- ops: decay ------------------------------------------------------------


def _decay_columns(m, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 90 * DAY, m).astype(np.float32),
            rng.choice([7 * DAY, 69 * DAY, 693 * DAY], m).astype(np.float32),
            rng.integers(0, 40, m).astype(np.float32),
            rng.random(m).astype(np.float32),
            rng.random(m).astype(np.float32),
            rng.uniform(0.01, 1.0, m).astype(np.float32),
            rng.random(m) < 0.6)


@pytest.mark.parametrize("weights,q,r", [((0.5, 0.3, 0.2), 1e-3, 1e-1),
                                         ((0.6, 0.2, 0.2), 1e-2, 0.5),
                                         ((1.0, 0.0, 0.0), 1e-4, 1e-2)])
def test_decay_scores_match_jax(weights, q, r):
    cols = _decay_columns(4096, seed=int(q * 1e4))
    want = jod.decay_scores(*cols, weights, q, r)
    got = tod.decay_scores(*cols, weights, q, r, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.max(np.abs(a.astype(np.float64) - b)) <= DECAY_ATOL


@pytest.mark.parametrize("init", [False, True])
def test_decay_score_host_f64_is_bitwise_jax(init):
    rng = np.random.default_rng(int(init))
    for _ in range(200):
        args = (float(rng.uniform(0, 1e10)), float(rng.choice([7, 69, 693]) * DAY),
                float(rng.integers(0, 50)), float(rng.random()), float(rng.random()),
                float(rng.random()), init, (0.5, 0.3, 0.2), 1e-3, 1e-1)
        assert tod.decay_score_host_f64(*args) == jod.decay_score_host_f64(*args)


# -- ops: link prediction --------------------------------------------------


@pytest.fixture(scope="module")
def union_csr():
    """The port plane's union CSR of the 300-node graph (the JAX plane's
    is the same arrays: pinned by test_union_snapshot_matches_jax)."""
    _, _, plane = _port_plane()
    snap = plane._union_snapshot()
    return snap


def test_union_snapshot_matches_jax(union_csr):
    eng = _engine(JAX)
    jsnap = jdp.BackgroundDevicePlane(eng, JCatalog(eng))._union_snapshot()
    for key in ("indptr", "nbr"):
        assert np.array_equal(union_csr[key], jsnap[key])
    assert union_csr["ids"] == jsnap["ids"]
    assert union_csr["max_deg"] == jsnap["max_deg"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("f1", [8, 16, 32])
def test_linkpredict_topk_matches_jax(union_csr, method, f1):
    indptr, nbr, n = union_csr["indptr"], union_csr["nbr"], union_csr["n"]
    deg = indptr[1:] - indptr[:-1]
    f2 = 1 << int(np.ceil(np.log2(max(1, union_csr["max_deg"]))))
    # this bucket's seeds: the rows whose degree fits f1, and two pads
    rows = [r for r in range(n) if deg[r] <= f1][:30] + [-1, -1]
    seeds = np.asarray(rows, np.int32)
    w = tol.degree_weights(method, indptr)
    assert np.array_equal(w, jol.degree_weights(method, indptr))
    kp = min(32, f1 * f2)
    jv, js, jd = jol.linkpredict_topk(seeds, jnp.asarray(indptr), jnp.asarray(nbr),
                                      jnp.asarray(w), n, f1, f2, kp)
    tv, ts, td = tol.linkpredict_topk(
        seeds, torch.from_numpy(indptr.astype(np.int64)),
        torch.from_numpy(nbr.astype(np.int64)), torch.from_numpy(w), n, f1, f2, kp)
    assert np.array_equal(td, jd)
    assert tv.dtype == np.float32 and tv.shape == jv.shape
    live = np.isfinite(jv)
    assert np.array_equal(np.isfinite(tv), live)
    if method == "common_neighbors":
        assert np.array_equal(tv[live], jv[live])
    # masked (-inf) slots compare by score only
    tvm, jvm = np.where(live, tv, -1e30), np.where(live, jv, -1e30)
    assert topk_agree(ts, tvm, js, jvm, atol=LP_ATOL)


def test_linkpredict_topk_on_an_edgeless_graph():
    indptr = torch.zeros(5, dtype=torch.int64)
    vals, sel, distinct = tol.linkpredict_topk(
        np.asarray([0, 3, -1]), indptr, torch.zeros(0, dtype=torch.int64),
        torch.ones(4), 4, 8, 1, 8)
    assert np.all(np.isneginf(vals)) and distinct.tolist() == [0, 0, 0]


@pytest.mark.parametrize("m", [2, 8, 32])
def test_sum_error_bound_covers_every_order(m):
    """float32 sums of m rounded weights, in shuffled orders, stay within
    ``sum_error_bound`` of the exact float64 sum."""
    rng = np.random.default_rng(m)
    for _ in range(300):
        exact = 1.0 / np.log(rng.integers(2, 50, m).astype(np.float64))
        w32 = exact.astype(np.float32)
        s = np.float32(0.0)
        for x in w32[rng.permutation(m)]:
            s = np.float32(s + x)
        assert abs(float(s) - exact.sum()) <= tol.sum_error_bound(m, exact.max())


# -- ops: FastRP -------------------------------------------------------------


def _edges(seed, n=120, e=400):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("kw", [{}, {"dim": 16, "iteration_weights": (1.0, 0.5, 0.25, 0.1)},
                                {"dim": 48, "normalization_strength": -0.5, "seed": 3}],
                         ids=["default", "weights", "beta"])
def test_fastrp_host_is_bitwise_and_device_agrees_with_jax(kw):
    src, dst = _edges(len(kw))
    host = tof.fastrp_embeddings(120, src, dst, **kw)
    assert np.array_equal(host, jof.fastrp_embeddings(120, src, dst, **kw))
    dev = tof.fastrp_embeddings_device(120, src, dst, device="cpu", **kw)
    jdev = jof.fastrp_embeddings_device(120, src, dst, **kw)
    assert dev.dtype == np.float32 and dev.shape == host.shape
    for ref in (host, jdev):
        live = (np.linalg.norm(ref, axis=1) > 1e-9)
        assert np.array_equal(np.linalg.norm(dev, axis=1) > 1e-9, live)
        assert np.sum(dev[live] * ref[live], axis=1).min() >= FASTRP_COS


def test_fastrp_device_edge_cases_match_jax():
    for n, src, dst in ((0, [], []), (5, [], [])):
        got = tof.fastrp_embeddings_device(n, np.asarray(src), np.asarray(dst), dim=8,
                                           device="cpu")
        assert np.array_equal(got, jof.fastrp_embeddings_device(
            n, np.asarray(src), np.asarray(dst), dim=8))


# -- the plane: decay --------------------------------------------------------


def test_decay_sweep_verdicts_match_the_jax_plane_and_the_host_loop():
    """Three identical graphs: the port's plane, the JAX plane, the
    port's host loop. (scored, archived), the archived sets and the
    Kalman states agree across a cold sweep and a warm one a day later."""
    te, je, he = _engine(PORT), _engine(JAX), _engine(PORT)
    tdm, jdm, hdm = _decay(PORT, te), _decay(JAX, je), _decay(PORT, he)
    tplane = tdp.BackgroundDevicePlane(te, TCatalog(te), decay=tdm, device="cpu")
    jdp.BackgroundDevicePlane(je, JCatalog(je), decay=jdm)
    for k, now in enumerate((NOW, NOW + DAY)):
        res = tdm.sweep(now)
        assert res == jdm.sweep(now) == hdm.sweep(now)
        assert _archived(te) == _archived(je) == _archived(he)
        assert tplane.dispatches == k + 1
        for nid in hdm._state:
            kt, kj, kh = (dm._state[nid].kalman for dm in (tdm, jdm, hdm))
            assert kt.initialized == kj.initialized == kh.initialized
            assert abs(kt.estimate - kj.estimate) <= DECAY_ATOL
            # after the cold sweep's archive writes, the host loop ages a
            # never-accessed archived node from the write's wall-clock
            # updated_at, and both planes from the catalog's resident node
            if k == 0 or hdm._state[nid].last_access_ms:
                assert abs(kt.estimate - kh.estimate) < 1e-5
    assert tplane.counts == {"decay_sweep_device": 2}


def test_decay_sweep_mid_sweep_write_steps_down_as_stale_snapshot(monkeypatch):
    eng = _engine(PORT)
    dm = _decay(PORT, eng)
    cat = TCatalog(eng)
    plane = tdp.BackgroundDevicePlane(eng, cat, decay=dm, device="cpu")
    real = tod.decay_scores

    def racing(*args, **kwargs):
        out = real(*args, **kwargs)
        node = TNode(id="racer", labels=["T"], properties={})
        eng.create_node(node)
        cat.apply_node_created(node)
        return out

    monkeypatch.setattr(tod, "decay_scores", racing)
    res = dm.sweep(NOW)
    assert plane.counts["degrade_stale_snapshot"] == 1
    assert "decay_sweep_device" not in plane.counts
    clean = _engine(PORT)
    scored, archived = _decay(PORT, clean).sweep(NOW)
    assert res == (scored + 1, archived)  # the host loop saw the write


def test_decay_sweep_archives_fresh_copies():
    eng = _engine(PORT)
    dm = _decay(PORT, eng)
    tdp.BackgroundDevicePlane(eng, TCatalog(eng), decay=dm, device="cpu")
    probe = _engine(PORT)
    _decay(PORT, probe).sweep(NOW)
    victim = next(n.id for n in probe.all_nodes() if n.properties.get("_archived"))
    node = eng.get_node(victim)
    node.properties["post_snapshot_field"] = "survives"
    eng.update_node(node)
    dm.sweep(NOW)
    after = eng.get_node(victim)
    assert after.properties.get("_archived") is True
    assert after.properties.get("post_snapshot_field") == "survives"


# -- the plane: link prediction -----------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_linkpredict_lists_match_the_jax_plane_and_host(method, monkeypatch):
    eng, _, plane = _port_plane()
    jeng = _engine(JAX)
    jplane = jdp.BackgroundDevicePlane(jeng, JCatalog(jeng))
    host_calls = [0]
    real = jlp.predict_links

    def counted(*a, **k):
        host_calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(jdp._lp, "predict_links", counted)
    seeds = [f"n{i}" for i in range(N)] + ["missing-node"]
    got = plane.linkpredict_topk(seeds, method=method, limit=10)
    want = jplane.linkpredict_topk(seeds, method=method, limit=10)
    assert got == want
    for s in seeds:
        assert got[s] == tlp.predict_links(eng, s, method=method, limit=10), s
    assert got["missing-node"] == []
    # the same seeds step down: exact counts decide the cut alike, and the
    # weighted guard is wider than the JAX plane's (any summation order)
    stepped = plane.counts["degrade_exactness"]
    if method == "common_neighbors":
        assert stepped == host_calls[0]
    else:
        assert stepped >= host_calls[0]
    assert plane.counts["linkpredict_partial" if stepped else "linkpredict_device"] == 1


def test_linkpredict_overflow_refusal_is_served_by_the_host(monkeypatch):
    eng, _, plane = _port_plane()
    monkeypatch.setattr(tdp, "_MAX_EXPANSION", 64)
    seeds = [f"n{i}" for i in range(16)]
    got = plane.linkpredict_topk(seeds, limit=10)
    for s in seeds:
        assert got[s] == tlp.predict_links(eng, s, limit=10), s
    assert plane.counts["degrade_overflow"] == 16  # every seed is refused at 64
    assert plane.counts["linkpredict_partial"] == 1


def test_linkpredict_mid_dispatch_write_steps_down_as_stale_snapshot(monkeypatch):
    eng, cat, plane = _port_plane()
    real = tol.linkpredict_topk

    def racing(*args, **kwargs):
        out = real(*args, **kwargs)
        e = TEdge(id=f"race{plane.dispatches}", type="KNOWS", start_node="n1", end_node="n2")
        eng.create_edge(e)
        cat.apply_edge_created(e)
        return out

    monkeypatch.setattr(tol, "linkpredict_topk", racing)
    assert plane.linkpredict_topk(["n0", "n3"], limit=5) is None
    assert plane.counts["degrade_stale_snapshot"] == 1


def test_unsupported_scorer_steps_down():
    _, _, plane = _port_plane()
    assert plane.linkpredict_topk(["n0"], method="jaccard") is None
    assert plane.counts == {"degrade_unsupported_scorer": 1}


def test_per_etype_deltas_keep_other_slices_live():
    """An etype-A edge write bumps only A's delta generation: B's cached
    slice is reused by identity, and prediction over the union stays
    exact."""
    eng, cat, plane = _port_plane()
    plane.linkpredict_topk(["n0"], limit=5)
    sl_likes = plane._etype_slice("LIKES")
    v_likes = cat.etype_version("LIKES")
    e = TEdge(id="late-edge", type="KNOWS", start_node="n0", end_node="n5")
    eng.create_edge(e)
    cat.apply_edge_created(e)
    assert cat.etype_version("LIKES") == v_likes
    assert plane._etype_slice("LIKES") is sl_likes
    n_knows = sum(1 for ed in eng.all_edges() if ed.type == "KNOWS")
    assert len(plane._etype_slice("KNOWS")["src"]) == n_knows
    got = plane.linkpredict_topk(["n0", "n5"], limit=5)
    for s in ("n0", "n5"):
        assert got[s] == tlp.predict_links(eng, s, limit=5), s
    stats = plane.resource_stats()
    dev = plane._union["dev"]
    assert stats["device_bytes"] == sum(t.numel() * t.element_size()
                                        for t in [dev["indptr"], dev["nbr"], *dev["w"].values()])
    assert stats["rows"] == len(plane._union["nbr"]) and stats["mutation_gap"] == 0


# -- the plane: FastRP and inference -------------------------------------------


def test_fastrp_matches_host_and_the_jax_plane():
    _, _, plane = _port_plane()
    ids, emb = plane.fastrp(dim=32)
    jeng = _engine(JAX)
    jids, jemb = jdp.BackgroundDevicePlane(jeng, JCatalog(jeng)).fastrp(dim=32)
    assert ids == jids and emb.shape == (N, 32)
    src, dst = plane.fastrp_edges(plane._union_snapshot())
    host = tof.fastrp_embeddings(N, src, dst, dim=32)
    for ref in (host, jemb):
        live = (np.linalg.norm(emb, axis=1) > 1e-9) & (np.linalg.norm(ref, axis=1) > 1e-9)
        assert live.sum() > 0
        assert np.sum(emb[live] * ref[live], axis=1).min() > FASTRP_COS
    assert plane.counts == {"fastrp_device": 1}


def _inference_pair():
    out = []
    for mem, node, svc_of, inf_of, plane_of, cat_of in (
            (JMemory, JNode, JService, JInference,
             lambda e, c, i: jdp.BackgroundDevicePlane(e, c, inference=i), JCatalog),
            (TMemory, TNode, lambda e: TService(e, device="cpu"), TInference,
             lambda e, c, i: tdp.BackgroundDevicePlane(e, c, inference=i, device="cpu"),
             TCatalog)):
        eng = mem()
        svc = svc_of(eng)
        for i in range(40):
            v = np.random.default_rng(i).normal(size=16)
            n = node(id=f"m{i}", labels=["M"], properties={},
                     embedding=(v / np.linalg.norm(v)).tolist())
            eng.create_node(n)
            svc.index_node(n)
        inf = inf_of(eng, svc, similarity_threshold=0.1)
        plane = plane_of(eng, cat_of(eng), inf)
        out.append((eng, inf, plane))
    return out


def test_on_store_batch_through_the_plane_matches_per_node_and_jax(monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    (je, jinf, _), (te, tinf, tplane) = _inference_pair()
    assert tinf.device_plane is tplane
    fresh = [f"m{i}" for i in range(6)]
    got = tinf.on_store_batch([te.get_node(i) for i in fresh])
    want = jinf.on_store_batch([je.get_node(i) for i in fresh])

    def key(res):
        return {k: [(s.from_id, s.to_id, s.rel_type, round(s.confidence, 5)) for s in v]
                for k, v in res.items()}

    assert key(got) == key(want)
    assert tplane.counts == {"infer_candidates_device": 1}
    # the per-node path on a fresh pair gives the same suggestions
    (_, _, _), (te2, tinf2, _) = _inference_pair()
    tinf2.device_plane = None
    per_node = tinf2.on_store_batch([te2.get_node(i) for i in fresh])
    assert key(per_node) == key(got)


# -- named step-downs and fail-closed (C25) ---------------------------------------


def test_mode_off_steps_every_job_down(monkeypatch):
    eng, cat, _ = _port_plane()
    dm = _decay(PORT, eng)
    plane = tdp.BackgroundDevicePlane(eng, cat, decay=dm, device="cpu")
    monkeypatch.setenv("NORNICDB_BG_DEVICE", "off")
    assert tdp.bg_device_mode() == "off"
    assert plane.linkpredict_topk(["n0"], limit=5) is None
    assert plane.fastrp(dim=8) is None
    assert dm.sweep(NOW)[0] == N  # the host loop served
    assert plane.dispatches == 0
    assert plane.counts == {"degrade_off": 3}
    monkeypatch.setenv("NORNICDB_BG_DEVICE", "bogus")
    assert tdp.bg_device_mode() == "auto"


def _boom(*a, **k):
    raise RuntimeError("device fault")


@pytest.mark.parametrize("job", ["decay", "linkpredict", "fastrp"])
def test_a_raising_dispatch_propagates_where_jax_answers_from_the_host(job, monkeypatch):
    """ROADMAP C25: the JAX plane catches the error and serves the host
    path; the port raises it."""
    jeng, teng = _engine(JAX), _engine(PORT)
    jdm, tdm = _decay(JAX, jeng), _decay(PORT, teng)
    jplane = jdp.BackgroundDevicePlane(jeng, JCatalog(jeng), decay=jdm)
    tplane = tdp.BackgroundDevicePlane(teng, TCatalog(teng), decay=tdm, device="cpu")
    name = {"decay": "decay_scores", "linkpredict": "linkpredict_topk",
            "fastrp": "fastrp_embeddings_device"}[job]
    jmod, tmod = {"decay": (jod, tod), "linkpredict": (jol, tol), "fastrp": (jof, tof)}[job]
    monkeypatch.setattr(jmod, name, _boom)
    monkeypatch.setattr(tmod, name, _boom)
    calls = {"decay": (lambda p, dm: dm.sweep(NOW)),
             "linkpredict": (lambda p, dm: p.linkpredict_topk(["n0", "n1"], limit=5)),
             "fastrp": (lambda p, dm: p.fastrp(dim=8))}[job]
    answer = calls(jplane, jdm)
    if job == "decay":
        assert answer == _decay(PORT, _engine(PORT)).sweep(NOW)  # the host loop's
    else:
        assert answer is None  # the caller's host path serves
    with pytest.raises(RuntimeError, match="device fault"):
        calls(tplane, tdm)
    assert not any(k.startswith("degrade") for k in tplane.counts)


def test_demote_to_background_priority_in_a_child_process():
    """It demotes its whole caller, so it runs in a child of its own."""
    code = ("import os; from nornicdb_tpu_torch.background.device_plane import "
            "demote_to_background_priority as d; prev = d(); "
            "print(prev is None or len(prev) == 2, "
            "prev is None or os.sched_getscheduler(0) == os.SCHED_IDLE)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=REPO)
    assert out.stdout.split() == ["True", "True"]
