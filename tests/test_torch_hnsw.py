"""The port's HNSW (``search/hnsw.py`` and its host library
``csrc/hnsw_host.cpp``) against the JAX package's, on the same seeded
vectors: the graph (adjacency, degrees, levels, entry, top level) is
bitwise the reference's on the Python path and on the native path, and
so are the answers. Recall@10 against exact search is held to >= 0.95
(the statistical tier's contract)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nornicdb_tpu.search import hnsw as jhnsw
from nornicdb_tpu.search import hnsw_native as jnative
from nornicdb_tpu_torch.ops import _build
from nornicdb_tpu_torch.search import hnsw as thnsw
from nornicdb_tpu_torch.search import hnsw_native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# both packages compute the same float32 sums in the same order
SCORE_ATOL = 1e-6
RECALL_MIN = 0.95


def _vectors(seed, n, d, clusters=0):
    rng = np.random.default_rng(seed)
    if not clusters:
        return rng.standard_normal((n, d)).astype(np.float32), rng
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 3.0
    labels = rng.integers(0, clusters, n)
    x = centers[labels] + rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32), rng


@pytest.fixture
def python_path(monkeypatch):
    """Both packages on their Python paths, as the reference's own
    native-vs-Python tests select it."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)


def _build_both(x, seed_ids=None, efc=96):
    items = [(f"v{i}", x[i]) for i in range(len(x))]
    out = []
    for mod in (jhnsw, thnsw):
        idx = mod.HNSWIndex(ef_construction=efc)
        idx.build(items, seed_ids=seed_ids)
        out.append(idx)
    return out


def _assert_same_graph(j, t):
    assert len(t._nbrL) == len(j._nbrL)
    for lv in range(len(j._nbrL)):
        np.testing.assert_array_equal(t._nbrL[lv], j._nbrL[lv])
        np.testing.assert_array_equal(t._cntL[lv], j._cntL[lv])
    assert t._levels == j._levels
    assert (t._entry, t._max_level, t._count) == (j._entry, j._max_level, j._count)
    np.testing.assert_array_equal(t._vectors, j._vectors)


def _assert_same_answers(j, t, queries, k=10):
    for q in queries:
        a, b = t.search(q, k), j.search(q, k)
        assert [i for i, _ in a] == [i for i, _ in b]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=SCORE_ATOL)
    for a, b in zip(t.search_batch(queries, k), j.search_batch(queries, k)):
        assert [i for i, _ in a] == [i for i, _ in b]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=SCORE_ATOL)


def _seeds(rng, n, count=300):
    return [f"v{i}" for i in rng.choice(n, count, replace=False)]


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
def test_python_path_graph_matches_jax(python_path, seeded):
    x, rng = _vectors(1, 3000, 64)
    j, t = _build_both(x, _seeds(rng, len(x)) if seeded else None)
    _assert_same_graph(j, t)
    _assert_same_answers(j, t, rng.standard_normal((16, 64)).astype(np.float32))


def test_python_path_removes_and_adds_match_jax(python_path):
    x, rng = _vectors(2, 600, 32)
    j, t = _build_both(x, efc=64)
    extra = rng.standard_normal((40, 32)).astype(np.float32)
    for step in range(240):
        i = int(rng.integers(0, len(x)))
        for idx in (j, t):
            if step % 4 == 3:
                idx.add(f"x{step}", extra[step % 40])
            elif step % 4 == 2:
                idx.add(f"v{i}", x[i] * 0.5 + extra[step % 40])  # re-insert
            else:
                idx.remove(f"v{i}")
        assert t.tombstone_ratio == j.tombstone_ratio
        assert t.should_rebuild() == j.should_rebuild()
        assert len(t) == len(j) and (f"v{i}" in t) == (f"v{i}" in j)
    assert t.should_rebuild()  # the sequence crossed the 0.2 threshold
    _assert_same_graph(j, t)
    assert sorted(t._slot_of) == sorted(j._slot_of)
    _assert_same_answers(j, t, rng.standard_normal((8, 32)).astype(np.float32))


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
def test_native_path_graph_matches_jax(seeded):
    assert jnative.get_lib() is not None  # the reference's build of the same C++
    x, rng = _vectors(3, 3000, 64)
    j, t = _build_both(x, _seeds(rng, len(x)) if seeded else None)
    _assert_same_graph(j, t)
    _assert_same_answers(j, t, rng.standard_normal((16, 64)).astype(np.float32))
    # live inserts after the build take the single-insert Python path
    for i in range(20):
        v = rng.standard_normal(64).astype(np.float32)
        j.add(f"late{i}", v)
        t.add(f"late{i}", v)
    _assert_same_graph(j, t)


def test_native_recall_on_a_clustered_corpus():
    x, rng = _vectors(4, 4000, 64, clusters=40)
    idx = thnsw.HNSWIndex()
    ids = [f"v{i}" for i in range(len(x))]
    idx.build(list(zip(ids, x)), seed_ids=_seeds(rng, len(x), 400))
    q = x[rng.choice(len(x), 100, replace=False)] + 0.3 * rng.standard_normal(
        (100, 64)).astype(np.float32)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    truth = np.argsort(-(qn @ xn.T), axis=1, kind="stable")[:, :10]
    got = idx.search_batch(q, 10)
    hit = sum(len({f"v{i}" for i in truth[r]} & {e for e, _ in got[r]})
              for r in range(len(q)))
    assert hit / truth.size >= RECALL_MIN
    assert [e for e, _ in idx.search(q[0], 10)] == [e for e, _ in got[0]]


def test_native_and_python_queries_agree_on_one_graph(monkeypatch):
    """The query kernel and the Python heap search walk the same graph to
    the same answers."""
    x, rng = _vectors(5, 1500, 32)
    idx = thnsw.HNSWIndex(ef_construction=64)
    idx.build([(f"v{i}", x[i]) for i in range(len(x))])
    for i in range(0, 300, 3):
        idx.remove(f"v{i}")
    q = rng.standard_normal((12, 32)).astype(np.float32)
    native = [idx.search(v, 10) for v in q]
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    python = [idx.search(v, 10) for v in q]
    for a, b in zip(native, python):
        assert [i for i, _ in a] == [i for i, _ in b]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=1e-5)


def test_empty_and_tiny_indexes_answer():
    idx = thnsw.HNSWIndex()
    assert idx.search(np.ones(8, np.float32), 5) == []
    assert idx.search_batch(np.ones((2, 8), np.float32), 5) == [[], []]
    idx.add("a", np.ones(8, np.float32))
    assert [i for i, _ in idx.search(np.ones(8, np.float32), 5)] == ["a"]
    with pytest.raises(ValueError, match="dims mismatch"):
        idx.add("b", np.ones(4, np.float32))


def test_library_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: without a compiler the HNSW build raises."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_host_failed", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"no host C\+\+ compiler"):
        tnative.get_lib()
    idx = thnsw.HNSWIndex()
    x, _ = _vectors(6, 400, 8)
    with pytest.raises(RuntimeError, match=r"no host C\+\+ compiler"):
        idx.build([(f"v{i}", x[i]) for i in range(len(x))])


def test_library_build_failure_is_remembered(monkeypatch, tmp_path):
    """A failed build runs the compiler once; later callers (one per
    write, under the service's lock) raise the same error at once."""
    runs = []

    def failing_run(cmd, **kw):
        runs.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, stdout="syntax error")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_host_failed", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: "/usr/bin/c++")
    monkeypatch.setattr(_build.subprocess, "run", failing_run)
    for _ in range(3):
        with pytest.raises(RuntimeError, match="exited 1"):
            tnative.get_lib()
    assert len(runs) == 1


def test_host_library_is_keyed_by_source_flags_and_cpu(monkeypatch):
    path = _build.host_library_path("hnsw_host")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(_build, "_cpu_flags", lambda: "another instruction set")
    assert _build.host_library_path("hnsw_host") != path
    monkeypatch.undo()
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ["-g"])
    assert _build.host_library_path("hnsw_host") != path


_PROBE = """
import json, numpy as np
from nornicdb_tpu_torch.search.hnsw import HNSWIndex
x = np.random.default_rng(0).standard_normal((400, 16)).astype(np.float32)
idx = HNSWIndex()
idx.build([(f"v{i}", x[i]) for i in range(len(x))])
idx.search(x[0], 5)
maps = open("/proc/self/maps").read()
print(json.dumps({"port": "libhnsw_host-" in maps, "reference": "libnornichnsw" in maps}))
"""


def test_port_loads_its_own_library_and_not_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"port": True, "reference": False}
