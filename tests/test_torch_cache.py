"""The port's result cache (``nornicdb_tpu_torch/cache.py``) and ANN
profiles (``search/ann_quality.py``) against the JAX package's, op by op
on the same seeded sequences, with one monkeypatched clock driving both."""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from nornicdb_tpu import cache as jcache
from nornicdb_tpu.search import ann_quality as jann
from nornicdb_tpu.search.service import _copy_hit as j_copy_hit
from nornicdb_tpu_torch import cache as tcache
from nornicdb_tpu_torch.search import ann_quality as tann
from nornicdb_tpu_torch.search.service import _copy_hit as t_copy_hit


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    # both modules read time.monotonic through the shared time module
    monkeypatch.setattr(time, "monotonic", c)
    return c


def _hit(rng, i):
    return {"id": f"n{i}", "score": float(rng.random()),
            "labels": ["Doc"], "properties": {"content": f"text {i}",
                                              "tags": [int(i), {"k": int(i)}]}}


@pytest.mark.parametrize("seed", range(4))
def test_result_cache_op_sequence_matches_jax(clock, seed):
    """Hits, misses, expiry, LRU eviction, generation bumps and puts that
    raced a bump: the same results and stats after every op."""
    rng = np.random.default_rng(seed)
    caches = [jcache.ResultCache(j_copy_hit, max_size=8, ttl_seconds=30.0),
              tcache.ResultCache(t_copy_hit, max_size=8, ttl_seconds=30.0)]
    keys = [("q", k) for k in range(12)]
    for step in range(300):
        op = rng.integers(0, 6)
        key = keys[int(rng.integers(0, len(keys)))]
        if op == 0:
            hits = [_hit(rng, step * 10 + j) for j in range(int(rng.integers(0, 4)))]
            # a compute that read the state before a bump (or not)
            stale = bool(rng.random() < 0.3)
            outs = []
            for c in caches:
                gen = c.generation
                if stale:
                    c.bump_generation()
                outs.append(c.put_guarded(key, hits, gen))
            assert outs[0] == outs[1] == hits
        elif op in (1, 2):
            assert caches[0].get_hits(key) == caches[1].get_hits(key)
        elif op == 3:
            clock.now += float(rng.choice([1.0, 10.0, 31.0]))
        elif op == 4 and rng.random() < 0.2:
            for c in caches:
                c.bump_generation()
        else:  # a plain put refreshes the entry's LRU place and TTL
            hits = [_hit(rng, step * 10)]
            for c in caches:
                c.put(key, hits)
        assert caches[0].stats() == caches[1].stats()
        assert caches[0].generation == caches[1].generation
        assert len(caches[0]) == len(caches[1])


@pytest.mark.parametrize("which", ["jax", "port"])
def test_result_cache_hits_are_copies(which):
    c = (jcache.ResultCache(j_copy_hit) if which == "jax"
         else tcache.ResultCache(t_copy_hit))
    props = {"content": "alpha", "tags": ["a", {"k": 1}]}
    hits = [{"id": "a", "score": 1.0, "labels": ["Doc"], "properties": props}]
    out = c.put_guarded("k", hits, c.generation)
    out[0]["properties"]["tags"][1]["k"] = 99
    out[0]["labels"].append("Mutated")
    got = c.get_hits("k")
    got[0]["properties"]["content"] = "changed"
    got[0]["score"] = -1.0
    again = c.get_hits("k")
    assert again == [{"id": "a", "score": 1.0, "labels": ["Doc"],
                      "properties": {"content": "alpha", "tags": ["a", {"k": 1}]}}]
    assert again[0]["properties"] is not props
    assert c.stats()["hits"] == 2


def test_lru_cache_matches_jax(clock):
    caches = [jcache.LRUCache(max_size=3, ttl_seconds=5.0),
              tcache.LRUCache(max_size=3, ttl_seconds=5.0)]
    for c in caches:
        c.put("a", 1)
        c.put("b", 2, ttl_seconds=0.0)  # never expires
        c.put("c", 3)
        c.get("a")  # a is now the most recent
        c.put("d", 4)  # evicts b, the least recent
    assert [c.get("b") for c in caches] == [None, None]
    clock.now += 6.0
    assert [c.get("a") for c in caches] == [None, None]  # expired
    assert [c.get("d", "missing") for c in caches] == ["missing", "missing"]
    for c in caches:
        c.put("e", 5)
    assert [c.get("e") for c in caches] == [5, 5]
    assert caches[0].stats() == caches[1].stats()
    for c in caches:
        c.clear()
    assert caches[0].stats() == caches[1].stats()
    assert len(caches[1]) == 0


def test_racing_put_guarded_never_keeps_a_stale_entry():
    """Writers bump the generation while readers put results computed
    before it: no entry put with an older generation may survive a bump."""
    c = tcache.ResultCache(t_copy_hit, max_size=64)
    stop = threading.Event()
    errors = []

    def writer():
        while not stop.is_set():
            c.bump_generation()

    def reader(t):
        try:
            for i in range(400):
                gen = c.generation
                c.put_guarded(("k", t, i % 8), [{"id": str(gen), "score": 0.0}], gen)
                with c._lock:
                    live = c._generation
                    stale = [k for k, (v, _) in c._data.items() if int(v[0]["id"]) != live]
                if stale:
                    errors.append(stale)
        except BaseException as exc:  # noqa: BLE001 -- re-raised below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(t,)) for t in range(12)]
        w = threading.Thread(target=writer)
        w.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        stop.set()
        w.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not w.is_alive()
    assert errors == []


def _with_port_walk(profile):
    """A JAX profile as the port keeps it: the CAGRA walk's pool and
    width are the port's (ROADMAP C14), every other field the same."""
    return dict(dataclasses.asdict(profile), cagra_itopk=tann.CAGRA_ITOPK,
                cagra_width=tann.CAGRA_WIDTH)


@pytest.mark.parametrize("name", sorted(jann.PROFILES))
def test_ann_profiles_match_jax(name):
    assert (dataclasses.asdict(tann.PROFILES[name])
            == _with_port_walk(jann.PROFILES[name]))
    assert (tann.CAGRA_ITOPK, tann.CAGRA_WIDTH) == (128, 8)
    assert (jann.PROFILES[name].cagra_itopk, jann.PROFILES[name].cagra_width) == (64, 1)
    assert sorted(tann.PROFILES) == sorted(jann.PROFILES)
    assert tann.ENV_VAR == jann.ENV_VAR


@pytest.mark.parametrize("env", [None, "fast", " ACCURATE ", "cagra", "compressed", "bogus", ""])
def test_current_profile_env_selection_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(jann.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(jann.ENV_VAR, env)
    assert (dataclasses.asdict(tann.current_profile())
            == _with_port_walk(jann.current_profile()))
    assert tann.current_profile("fast") == tann.PROFILES["fast"]


@pytest.mark.parametrize("env", [None, "4", "0", "x"])
def test_cagra_shards_from_env_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("NORNICDB_CAGRA_SHARDS", raising=False)
    else:
        monkeypatch.setenv("NORNICDB_CAGRA_SHARDS", env)
    for default in (1, 3):
        assert tann.cagra_shards_from_env(default) == jann.cagra_shards_from_env(default)
