"""Quantized device planes: int8 and PQ coarse scoring with an exact rerank
(counterpart of ``nornicdb_tpu/search/device_quant.py``, one device).

The brute index's float32 matrix stays on the host, the source of truth;
the card holds a compressed copy:

- **int8** (1 byte a cell + a float32 scale a row): symmetric per-row
  quantization, ``scale = max|x| / 127``, ``codes = round(x / scale)``
  (round half to even in both packages, and the reference's operation
  order, so codes and scales are bitwise the reference's). Coarse scores
  are ``q @ codes * scale`` in float32, over column chunks of the
  ``[D, C]`` codes cast to float32 one chunk at a time
  (``_int8_chunks``), so the float32 block never lives whole.
- **PQ** (M bytes a row): codebooks trained density-aware (a device
  k-means picks a sqrt-size sample from every cluster, then the host
  trainer of ``ops/kmeans.py``), ADC scores accumulated one subspace at a
  time from ``[B, 256]`` lookup tables, never a ``[B, M, C]`` block.

A coarse top-``pool`` on the card (ties to the lower index, as
``lax.top_k``: ``ops/similarity.py:order_keys``) is re-scored exactly on
the host's float32 rows, so every answered score is an exact cosine.
The graph walks over a quantized base (``_walk_body_quant``, a PCA head
prefilter then the full int8 dot; ``_walk_body_pq``, ADC) follow
``cagra.walk_body``: PyTorch ops, no kernel.

``QuantizedBrutePlane`` is a mutation-generation snapshot of its
``BruteForceIndex``: adds and updates since the build ride the changelog
into an exact float32 side-scan, deletes are filtered at the rerank
gather. Its named freshness gaps (not built yet, a compaction, a
changelog overrun, a rerank race, an under-filled pool) return None, so
the float32 tier serves the batch, each counted in ``counts``; any other
error propagates (ROADMAP C23: the reference catches every exception and
serves float32). Selected by ``NORNICDB_VECTOR_QUANT={off,int8,pq}``.
The sharded int8 plane waits for the multi-device slice (ROADMAP §A10),
the audit, admission and cost calls for §A12.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.config import env_int, env_str
from nornicdb_tpu_torch.ops.kmeans import kmeans_fit, train_subspace_codebooks
from nornicdb_tpu_torch.ops.similarity import (
    NEG_INF,
    keys_topk,
    l2_normalize,
    order_keys,
    topk_stable,
    unpack_keys,
)
from nornicdb_tpu_torch.search.microbatch import pow2_bucket

MODES = ("off", "int8", "pq")

# one build sequence over every plane: consumers key derived state on it
_BUILD_SEQ = itertools.count(1)

# float32 cells of one chunk of cast codes (128 MiB); at least 4 chunks,
# as the reference's scan
_INT8_CHUNK_CELLS = 1 << 25
_ENCODE_ROWS = 65_536  # rows uploaded and encoded at a time
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quant_mode() -> str:
    """NORNICDB_VECTOR_QUANT={off,int8,pq}; unknown values read as off."""
    mode = env_str("VECTOR_QUANT", "off").strip().lower()
    return mode if mode in MODES else "off"


def quant_min_n() -> int:
    """Corpus floor below which the quantized plane never engages."""
    return max(1, env_int("QUANT_MIN_N", 8192))


# ---------------------------------------------------------------------------
# int8 plane
# ---------------------------------------------------------------------------


def _int8_encode_impl(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows [N, D] f32 -> (codes int8 [N, D], scale f32 [N]); a zero row
    gets scale 1e-12 / 127, so dequantization stays finite. The reference
    writes ``/ 127.0``, which XLA turns into a product with the float32
    reciprocal: so does this, for bitwise scales."""
    amax = torch.amax(torch.abs(rows), dim=1)
    scale = torch.clamp_min(amax, 1e-12) * _INV_127
    codes = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def int8_encode_t(rows: np.ndarray, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column-major codes ``[D, N]`` int8 and scales ``[N]`` on ``device``,
    encoded there ``_ENCODE_ROWS`` rows at a time (no float32 copy of the
    whole matrix on the card)."""
    n, d = rows.shape
    codes_t = torch.empty((d, n), dtype=torch.int8, device=device)
    scale = torch.empty((n,), dtype=torch.float32, device=device)
    for lo in range(0, n, _ENCODE_ROWS):
        hi = min(lo + _ENCODE_ROWS, n)
        c, s = _int8_encode_impl(torch.from_numpy(
            np.ascontiguousarray(rows[lo:hi], np.float32)).to(device))
        codes_t[:, lo:hi] = c.T
        scale[lo:hi] = s
    return codes_t, scale


def int8_encode(rows: np.ndarray, device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """(codes int8 [N, D], scale f32 [N]) as host arrays."""
    codes_t, scale = int8_encode_t(np.asarray(rows, np.float32), resolve_device(device))
    return codes_t.T.cpu().numpy(), scale.cpu().numpy()


def _int8_chunks(d: int, c: int) -> int:
    """Columns per chunk of the coarse scan: a quarter of ``c`` (the
    reference's four-step scan), halved while a chunk's float32 cast would
    exceed ``_INT8_CHUNK_CELLS``."""
    n = next((n for n in (4, 2) if c % n == 0), 1)
    while d * (c // n) > _INT8_CHUNK_CELLS and c % (2 * n) == 0:
        n *= 2
    return c // n


def _int8_scores(qn, codes_t, scale, lo: int = 0, hi: Optional[int] = None):
    """De-scaled coarse scores [B, hi - lo] over columns lo:hi of the
    int8 codes ``[D, C]``; the float32 cast lives for this block only."""
    hi = codes_t.shape[1] if hi is None else hi
    return (qn @ codes_t[:, lo:hi].to(torch.float32)) * scale[None, lo:hi]


def _chunked_topk(score: Callable[[int, int], torch.Tensor], valid, c: int, width: int,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of ``score(lo, hi)`` over column chunks of ``width``,
    columns where ``valid`` ([C], or [B, C] per query) is False at
    NEG_INF, merged by keys: ``lax.top_k`` over the whole row (ties to the
    lower column)."""
    best = None
    for lo in range(0, c, width):
        hi = min(lo + width, c)
        s = score(lo, hi)
        s = torch.where(valid[..., lo:hi], s, torch.full_like(s, NEG_INF))
        keys = keys_topk(order_keys(s, lo), k)
        best = keys if best is None else keys_topk(torch.cat([best, keys], dim=1), k)
    return unpack_keys(best)


def _int8_topk_impl(qn, codes_t, scale, valid, k):
    d, c = codes_t.shape
    return _chunked_topk(lambda lo, hi: _int8_scores(qn, codes_t, scale, lo, hi),
                         valid, c, _int8_chunks(d, c), min(k, c))


# ---------------------------------------------------------------------------
# PQ plane
# ---------------------------------------------------------------------------


def train_pq(matrix: np.ndarray, m: int, n_codes: int = 256, sample_n: int = 16384,
             seed: int = 0, device: DeviceLike = None) -> np.ndarray:
    """Density-aware PQ codebooks [M, n_codes, D/M]: above ``sample_n``
    rows a device k-means clusters the corpus and the training sample
    takes a sqrt(cluster size) quota from every cluster; the per-subspace
    Lloyd is the host trainer (``train_subspace_codebooks``)."""
    matrix = np.asarray(matrix, dtype=np.float32)
    n = len(matrix)
    if n > sample_n:
        k = min(64, max(8, n // 2048))
        assign = kmeans_fit(matrix, k=k, seed=seed, device=device).assignments
        rng = np.random.default_rng(seed)
        counts = np.bincount(assign[assign >= 0], minlength=k)
        quota = np.sqrt(np.maximum(counts, 0))
        quota = (quota / max(quota.sum(), 1e-12) * sample_n).astype(int)
        picks: List[np.ndarray] = []
        for c in range(k):
            members = np.nonzero(assign == c)[0]
            if members.size == 0 or quota[c] == 0:
                continue
            take = min(members.size, max(int(quota[c]), 1))
            picks.append(rng.choice(members, size=take, replace=False))
        sample = matrix[np.concatenate(picks)] if picks else matrix
    else:
        sample = matrix
    return train_subspace_codebooks(sample, m, n_codes)


def _pq_encode_chunk(rows: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """rows [n, D] -> codes uint8 [M, n]: the nearest codebook entry per
    subspace by squared L2 (ties to the lower code, as ``argmin``)."""
    n = rows.shape[0]
    m, _, ds = codebooks.shape
    sub = rows.reshape(n, m, ds).transpose(0, 1)  # [M, n, ds]
    d2 = (torch.sum(sub * sub, dim=2)[:, :, None]
          - 2.0 * torch.bmm(sub, codebooks.transpose(1, 2))
          + torch.sum(codebooks * codebooks, dim=2)[:, None, :])
    return torch.argmin(d2, dim=2).to(torch.uint8)


def encode_pq_t(rows: np.ndarray, codebooks: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Column-major PQ codes ``[M, N]`` uint8 on the codebooks' device,
    ``chunk`` rows at a time (the [M, chunk, K] distances bound memory)."""
    n = len(rows)
    out = torch.empty((codebooks.shape[0], n), dtype=torch.uint8, device=codebooks.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = torch.from_numpy(np.ascontiguousarray(rows[lo:hi], np.float32))
        out[:, lo:hi] = _pq_encode_chunk(block.to(codebooks.device), codebooks)
    return out


def encode_pq(rows: np.ndarray, codebooks: np.ndarray, chunk: int = 4096,
              device: DeviceLike = None) -> np.ndarray:
    """PQ codes uint8 [N, M] as a host array."""
    cb = torch.from_numpy(np.asarray(codebooks, np.float32)).to(resolve_device(device))
    return encode_pq_t(np.asarray(rows, np.float32), cb, chunk).T.cpu().numpy()


def _pq_adc_scores(qn, codes_t, codebooks, lo: int = 0, hi: Optional[int] = None):
    """ADC scores [B, hi - lo]: per subspace a [B, K] lookup table, then a
    gather of its code row added to the accumulator, subspace by subspace
    (the reference's scan order); codes widen one subspace at a time."""
    hi = codes_t.shape[1] if hi is None else hi
    b = qn.shape[0]
    m, _, ds = codebooks.shape
    tables = torch.bmm(qn.reshape(b, m, ds).transpose(0, 1),
                       codebooks.transpose(1, 2))  # [M, B, K]
    acc = torch.zeros((b, hi - lo), dtype=torch.float32, device=qn.device)
    for j in range(m):
        acc += torch.index_select(tables[j], 1, codes_t[j, lo:hi].to(torch.int64))
    return acc


def _pq_topk_impl(qn, codes_t, codebooks, valid, k):
    c = codes_t.shape[1]
    return _chunked_topk(lambda lo, hi: _pq_adc_scores(qn, codes_t, codebooks, lo, hi),
                         valid, c, c, min(k, c))


# ---------------------------------------------------------------------------
# PCA rotation and the quantized walks
# ---------------------------------------------------------------------------


def fit_rotation(rows: np.ndarray, sample_n: int = 8192, seed: int = 0) -> np.ndarray:
    """Orthogonal energy-compacting rotation [D, D]: the PCA basis of a
    sample covariance, eigenvalues descending. Full dots are unchanged;
    the leading dims carry most of the energy, which makes the walk's
    head prefilter an honest estimate."""
    rows = np.asarray(rows, dtype=np.float32)
    if len(rows) > sample_n:
        rng = np.random.default_rng(seed)
        rows = rows[rng.choice(len(rows), sample_n, replace=False)]
    cov = rows.T @ rows / max(len(rows), 1)
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    return np.ascontiguousarray(vecs[:, ::-1], dtype=np.float32)


def _walk_start(score_seeds, adj, validf, b, p, hash_bits, n_seeds, dev):
    """The seed round shared by the quantized walks (as ``walk_body``'s):
    the pool, its rows, the explored flags and the visited bitmask."""
    from nornicdb_tpu_torch.search.cagra import hash_bucket

    c = adj.shape[0]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    s0 = max(n_seeds, p)
    stride = max(1, c // s0)
    seed_n = torch.arange(s0, device=dev)
    seed_ids = ((seed_n * stride) % c).to(adj.dtype)
    seed_ok = (seed_n < c) & (validf[seed_ids] > 0.0)
    seed_s = torch.where(seed_ok[None, :], score_seeds(seed_ids), neg)
    pool_s, pos0 = topk_stable(seed_s, p)
    pool_i = seed_ids[pos0]
    explored = torch.zeros((b, p), dtype=torch.bool, device=dev)
    visited = torch.zeros((b, 1 << hash_bits), dtype=torch.uint8, device=dev)
    visited[:, hash_bucket(seed_ids, hash_bits)] = 1
    return pool_s, pool_i, explored, visited


def _walk_frontier(pool_s, pool_i, explored, visited, adj, validf, width, hash_bits, neg):
    """One expansion's candidates: (explored, fresh neighbours [B, m],
    their fresh mask), with the fresh ones marked visited."""
    from nornicdb_tpu_torch.search.cagra import hash_bucket

    b, p = pool_s.shape
    deg = adj.shape[1]
    m = width * deg
    dev = pool_s.device
    slot = torch.arange(p, device=dev)
    mcol = torch.arange(m, device=dev)
    f_s, f_pos = topk_stable(torch.where(explored, neg, pool_s), width)
    f_ids = torch.gather(pool_i, 1, f_pos)
    explored = explored | (slot[None, None, :] == f_pos[:, :, None]).any(1)
    f_ok = f_s > 0.5 * NEG_INF
    nbrs = adj[f_ids].reshape(b, m)
    h = hash_bucket(nbrs, hash_bits)
    seen = torch.gather(visited, 1, h) > 0
    dup = ((nbrs[:, :, None] == nbrs[:, None, :])
           & (mcol[None, :] < mcol[:, None])[None]).any(2)
    fresh = f_ok.repeat_interleave(deg, dim=1) & ~seen & ~dup & (validf[nbrs] > 0.0)
    # every fresh candidate counts as visited: a prefilter reject is a
    # prune, not a deferral
    visited.scatter_reduce_(1, h, fresh.to(torch.uint8), "amax")
    return explored, nbrs, fresh


def _walk_merge(pool_s, pool_i, explored, scores, ids, p):
    pool_s, pos = topk_stable(torch.cat([pool_s, scores], 1), p)
    pool_i = torch.gather(torch.cat([pool_i, ids], 1), 1, pos)
    explored = torch.gather(torch.cat([explored, torch.zeros_like(ids, dtype=torch.bool)], 1),
                            1, pos)
    return pool_s, pool_i, explored


def _walk_body_quant(
    queries_p: torch.Tensor,  # [B, D] PCA-projected, L2-normalized
    codes: torch.Tensor,  # [C, D] int8 projected rows
    codes_head: torch.Tensor,  # [C, P] leading projected dims
    scale: torch.Tensor,  # [C] f32
    adj: torch.Tensor,  # [C, deg] int32
    validf: torch.Tensor,  # [C] f32 {0, 1}
    k: int, iters: int, width: int, itopk: int, hash_bits: int, n_seeds: int, keep: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy walk over an int8 base with a two-stage frontier scorer:
    each candidate is scored on the leading ``P`` projected dims first, and
    only the best ``keep`` pay the full-row int8 dot. Scores are
    approximate (callers rerank the pool exactly)."""
    b = queries_p.shape[0]
    dev = queries_p.device
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    keep = min(keep, width * adj.shape[1])
    q_head = queries_p[:, :codes_head.shape[1]]

    def score_seeds(ids):
        return (queries_p @ codes[ids].to(torch.float32).T) * scale[ids][None, :]

    pool_s, pool_i, explored, visited = _walk_start(score_seeds, adj, validf, b, itopk,
                                                    hash_bits, n_seeds, dev)
    for _ in range(iters):
        explored, nbrs, fresh = _walk_frontier(pool_s, pool_i, explored, visited, adj,
                                               validf, width, hash_bits, neg)
        # stage 1: the partial dot over the head dims
        head = codes_head[nbrs].to(torch.float32)  # [B, m, P]
        part = torch.bmm(head, q_head[:, :, None])[:, :, 0] * scale[nbrs]
        keep_s, keep_pos = topk_stable(torch.where(fresh, part, neg), keep)
        keep_ids = torch.gather(nbrs, 1, keep_pos)
        keep_ok = torch.gather(fresh, 1, keep_pos) & (keep_s > 0.5 * NEG_INF)
        # stage 2: the full int8 dot, survivors only
        full = codes[keep_ids].to(torch.float32)  # [B, keep, D]
        scores = torch.bmm(full, queries_p[:, :, None])[:, :, 0] * scale[keep_ids]
        pool_s, pool_i, explored = _walk_merge(pool_s, pool_i, explored,
                                               torch.where(keep_ok, scores, neg), keep_ids,
                                               itopk)
    top_s, pos = topk_stable(pool_s, k)
    return top_s, torch.gather(pool_i, 1, pos)


def _walk_body_pq(
    qn: torch.Tensor,  # [B, D] L2-normalized (original basis)
    codes: torch.Tensor,  # [C, M] uint8
    codebooks: torch.Tensor,  # [M, K, D/M] f32
    adj: torch.Tensor,  # [C, deg] int32
    validf: torch.Tensor,  # [C] f32 {0, 1}
    k: int, iters: int, width: int, itopk: int, hash_bits: int, n_seeds: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy walk over a PQ base: per-query ADC tables [B, M*K] built
    once, then each candidate costs M gathers and a sum."""
    b = qn.shape[0]
    dev = qn.device
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    m_sub, n_codes, ds = codebooks.shape
    tflat = torch.einsum("bms,mks->bmk", qn.reshape(b, m_sub, ds),
                         codebooks).reshape(b, m_sub * n_codes)
    offs = torch.arange(m_sub, device=dev) * n_codes

    def score_seeds(ids):  # ids shared by the batch -> [B, X]
        idx = codes[ids].to(torch.int64) + offs[None, :]
        return tflat[:, idx].sum(dim=-1)

    def adc_rows(ids):  # [B, X] per-query ids -> [B, X]
        idx = codes[ids].to(torch.int64) + offs  # [B, X, M]
        return torch.gather(tflat, 1, idx.reshape(b, -1)).reshape(idx.shape).sum(dim=-1)

    pool_s, pool_i, explored, visited = _walk_start(score_seeds, adj, validf, b, itopk,
                                                    hash_bits, n_seeds, dev)
    for _ in range(iters):
        explored, nbrs, fresh = _walk_frontier(pool_s, pool_i, explored, visited, adj,
                                               validf, width, hash_bits, neg)
        scores = torch.where(fresh, adc_rows(nbrs), neg)
        pool_s, pool_i, explored = _walk_merge(pool_s, pool_i, explored, scores, nbrs, itopk)
    top_s, pos = topk_stable(pool_s, k)
    return top_s, torch.gather(pool_i, 1, pos)


def quantize_graph_base(rows: np.ndarray, device: torch.device,
                        mode: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The compressed base a quantized walk reads, on ``device``; ``mode``
    defaults to ``quant_mode()``.

    - ``int8``: PCA-projected int8 codes, their head column and per-row
      scales; the rotation stays on the host too (``rot``).
    - ``pq``: codes and codebooks (2 dims a subspace). None when the split
      or the training sample does not allow honest codebooks (the float32
      graph serves)."""
    d = rows.shape[1]
    mode = quant_mode() if mode is None else mode
    if mode == "pq":
        # denser than the plane's split: ADC scores steer the walk
        m = max(4, min(64, d // 2))
        while m > 1 and d % m != 0:
            m -= 1
        # dead graph slots are zero rows, which would soak up codebook mass
        live = rows[np.abs(rows).sum(axis=1) > 0.0]
        if m < 2 or len(live) < 1024:
            return None
        codebooks = torch.from_numpy(train_pq(live, m, 256, device=device)).to(device)
        return {"mode": "pq", "pq_m": m, "pq_codes": 256,
                "codes": encode_pq_t(rows, codebooks).T.contiguous(),
                "codebooks": codebooks}
    rot = fit_rotation(rows)
    codes_t, scale = int8_encode_t(rows @ rot, device)
    head_dims = min(d, max(8, d // 4))
    codes = codes_t.T.contiguous()
    return {"mode": "int8", "rot": rot, "rot_dev": torch.from_numpy(rot).to(device),
            "codes": codes, "codes_head": codes[:, :head_dims].contiguous(),
            "scale": scale, "head_dims": head_dims}


# ---------------------------------------------------------------------------
# the serving plane over a BruteForceIndex
# ---------------------------------------------------------------------------


def usable_ids(ids: List[Optional[str]], alive: np.ndarray, skip) -> np.ndarray:
    """[n] bool: live rows with an id outside ``skip`` (ids the delta
    side-scan supersedes)."""
    return alive & np.fromiter((e is not None and e not in skip for e in ids), bool, len(ids))


def rank_candidates(eids: np.ndarray, scores: np.ndarray, slots: np.ndarray,
                    k: int) -> List[Tuple[str, float]]:
    """The top ``k`` of distinct candidates by (exact score descending,
    slot ascending): the float32 path's tie order. Delta rows carry slots
    past the capacity, so they lose ties to indexed rows."""
    order = np.lexsort((slots, -scores))[:k]
    return [(eids[i], float(scores[i])) for i in order]


class QuantizedBrutePlane:
    """Compressed device snapshot of a ``BruteForceIndex`` with
    coarse-then-exact serving, on the index's device.

    ``counts``: ``build``, ``background_rebuild``, ``dispatch`` and
    ``delta_merge`` per event; ``degrade_<reason>`` per batch handed to the
    float32 tier at a named gap (``pending_build``, ``compaction``,
    ``changelog_overrun``, ``rerank_race``, ``underfill``). ``build_s``
    splits the latest build by part (``snapshot``, ``kmeans`` and
    ``codebooks`` for PQ, ``encode``, ``total``)."""

    def __init__(
        self,
        brute,
        mode: Optional[str] = None,
        rebuild_stale_frac: float = 0.1,
        build_inline: bool = False,
        pq_m: Optional[int] = None,
        pq_codes: int = 256,
        overfetch: int = 8,
        min_pool: int = 128,
    ):
        self.brute = brute
        self.device = brute.device
        self._mode = mode
        self.rebuild_stale_frac = rebuild_stale_frac
        self.build_inline = build_inline
        self.pq_m = pq_m
        self.pq_codes = pq_codes
        # rerank pool: max(overfetch * k, min_pool) coarse winners
        self.overfetch = max(1, overfetch)
        self.min_pool = max(1, min_pool)
        self._snap: Optional[Dict[str, Any]] = None
        self._build_lock = threading.Lock()
        self._rebuilding = False
        self._rebuild_flag_lock = threading.Lock()
        self.builds = 0
        self.build_s: Dict[str, float] = {}
        self.counts: Counter = Counter()

    @property
    def mode(self) -> str:
        return self._mode or quant_mode()

    def pool_for(self, k: int, snap: Dict[str, Any]) -> int:
        """Rerank pool for depth ``k``: max(overfetch * k, min_pool), PQ
        floored at capacity / n_codes (ADC rank noise grows with the
        corpus and with coarser codebooks), pow2-bucketed, at most the
        capacity."""
        floor = max(k * self.overfetch, self.min_pool)
        if snap["mode"] == "pq":
            floor = max(floor, snap["capacity"] // min(snap["pq_codes"], 256))
        return min(pow2_bucket(floor), snap["capacity"])

    # -- build ------------------------------------------------------------

    def _pq_m_for(self, d: int) -> int:
        """Subspaces: requested, else d/4 clamped to [4, 64] and rounded
        down to a divisor of d."""
        m = self.pq_m or max(4, min(64, d // 4))
        while m > 1 and d % m != 0:
            m -= 1
        return max(1, m)

    def build(self) -> bool:
        with self._build_lock:
            return self._build_locked()

    def _build_locked(self) -> bool:
        mode = self.mode
        if mode == "off":
            self._snap = None
            return False
        brute = self.brute
        mutations = brute.mutations
        snap = self._snap
        if snap is not None and snap["built_mutations"] == mutations and snap["mode"] == mode:
            return True  # raced another builder
        t0 = time.perf_counter()
        matrix, valid, _ = brute.snapshot()
        n_alive = int(valid.sum())
        if n_alive < 1:
            self._snap = None
            return False
        cap, d = matrix.shape
        dev = self.device
        snap = {"mode": mode, "capacity": cap, "dims": d, "rows": n_alive,
                "built_mutations": mutations, "built_compactions": brute.compactions,
                "build_seq": next(_BUILD_SEQ)}
        t1 = time.perf_counter()
        split = {"snapshot": t1 - t0}
        if mode == "int8":
            # column-major: the coarse product streams code columns
            snap["codes_t"], snap["scale"] = int8_encode_t(matrix, dev)
            snap["device_bytes"] = cap * d + cap * 4 + cap
        else:
            m = self._pq_m_for(d)
            live_rows = matrix[valid] if n_alive < cap else matrix
            codebooks = train_pq(live_rows, m, self.pq_codes, device=dev)
            t2 = time.perf_counter()
            split["codebooks"] = t2 - t1
            t1 = t2
            snap["pq_m"] = m
            snap["pq_codes"] = self.pq_codes
            snap["codebooks"] = torch.from_numpy(codebooks).to(dev)
            snap["codes_t"] = encode_pq_t(matrix, snap["codebooks"])
            snap["device_bytes"] = m * cap + codebooks.nbytes + cap
        snap["valid"] = torch.from_numpy(valid).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        split.update(encode=t3 - t1, total=t3 - t0)
        self._snap = snap
        self.builds += 1
        self.build_s = split
        self.counts["build"] += 1
        return True

    def _kick_background_rebuild(self) -> None:
        with self._rebuild_flag_lock:
            if self._rebuilding:
                return
            self._rebuilding = True
        self.counts["background_rebuild"] += 1

        def run():
            try:
                self.build()
            finally:
                with self._rebuild_flag_lock:
                    self._rebuilding = False

        threading.Thread(target=run, name="quant-rebuild", daemon=True).start()

    def ensure(self) -> Optional[Dict[str, Any]]:
        """The current snapshot under the rebuild policy, or None while the
        float32 tier must serve."""
        if self.mode == "off":
            return None
        snap = self._snap
        if snap is not None and snap["mode"] == self.mode:
            churn = self.brute.mutations - snap["built_mutations"]
            if churn > self.rebuild_stale_frac * max(snap["rows"], 1):
                self._kick_background_rebuild()
            return snap
        if not self.build_inline:
            self._kick_background_rebuild()
            return self._snap
        self.build()
        return self._snap

    @property
    def plane_built(self) -> bool:
        return self._snap is not None

    def device_bytes(self) -> int:
        """Bytes of the plane's device arrays (0 before a build)."""
        snap = self._snap
        return 0 if snap is None else snap["device_bytes"]

    # -- serving ----------------------------------------------------------

    def _coarse(self, snap: Dict[str, Any], qn: torch.Tensor, pool: int):
        """One coarse dispatch: (scores, slots) host arrays [B, pool]."""
        if snap["mode"] == "int8":
            s, i = _int8_topk_impl(qn, snap["codes_t"], snap["scale"], snap["valid"], pool)
        else:
            s, i = _pq_topk_impl(qn, snap["codes_t"], snap["codebooks"], snap["valid"], pool)
        return s.cpu().numpy(), i.cpu().numpy()

    def search_batch(self, queries: np.ndarray, k: int = 10
                     ) -> Optional[List[List[Tuple[str, float]]]]:
        """Coarse-then-exact batched search, or None when the float32 tier
        must serve this batch. Every answered score is an exact float32
        cosine of a live row; approximate scores only rank the pool."""
        brute = self.brute
        snap = self.ensure()
        if snap is None:
            self.counts["degrade_pending_build"] += 1
            return None
        if snap["built_compactions"] != brute.compactions:
            # a compaction remapped the slots the plane's codes address
            return self._degrade("compaction", rebuild=True)
        delta = brute.changed_since(snap["built_mutations"])
        if delta is None:
            return self._degrade("changelog_overrun", rebuild=True)
        n_alive = len(brute)
        if n_alive == 0:
            return [[] for _ in range(len(queries))]
        k_eff = min(k, n_alive)
        b = len(queries)
        pool = self.pool_for(k, snap)
        qn_t = l2_normalize(torch.from_numpy(np.array(queries, np.float32)).to(self.device))
        s, slots = self._coarse(snap, qn_t.contiguous(), pool)
        qn = qn_t.cpu().numpy()
        # exact rerank on the host rows, current values, under one lock
        # hold; None: a compaction landed mid-flight
        uniq = np.unique(slots)
        got = brute.rows_for_slots(uniq, expect_compactions=snap["built_compactions"])
        if got is None:
            return self._degrade("rerank_race")
        rows_u, alive_u, ids_u = got
        exact_u = qn @ rows_u.T  # one [B, U] product
        inv = np.searchsorted(uniq, slots)
        d_ids, d_mat = brute.delta_vectors(delta) if delta else ([], None)
        d_scores = qn @ d_mat.T if d_ids else np.zeros((b, 0), np.float32)
        d_eids = np.asarray(d_ids, dtype=object)
        d_slots = snap["capacity"] + np.arange(len(d_ids))
        # removed rows, and rows the delta supersedes, drop out
        ok_u = usable_ids(ids_u, alive_u, set(d_ids))
        ids_u = np.asarray(ids_u, dtype=object)
        out: List[List[Tuple[str, float]]] = []
        for r in range(b):
            j = inv[r][s[r] >= 0.5 * NEG_INF]  # the coarse pool, unique slots
            j = j[ok_u[j]]
            out.append(rank_candidates(np.concatenate([ids_u[j], d_eids]),
                                       np.concatenate([exact_u[r, j], d_scores[r]]),
                                       np.concatenate([uniq[j], d_slots]), k_eff))
        if any(len(hits) < k_eff for hits in out):
            # deletes around a query can empty its pool though live rows remain
            return self._degrade("underfill")
        self.counts["dispatch"] += 1
        if d_ids:
            self.counts["delta_merge"] += 1
        return out

    def _degrade(self, reason: str, rebuild: bool = False) -> None:
        self.counts["degrade_" + reason] += 1
        if rebuild:
            self._kick_background_rebuild()
        return None
