"""k-means (counterpart of ``nornicdb_tpu/ops/kmeans.py``).

Two trainers, as in the reference:

- ``euclid_kmeans`` and ``train_subspace_codebooks``: Euclidean Lloyd with
  a seeded incremental k-means++ on the host, NumPy, copied line for line
  but for the centroid update, which gathers each cluster's rows by one
  stable sort instead of a mask per centroid (the same rows in the same
  order). The PQ codebooks of ``search/device_quant.py`` train through
  them, so they are bitwise the reference's on the same sample;
- ``kmeans_fit``: cosine k-means on the device of its tensors, the
  partitioner of the tiered plane and the PQ plane's density-aware
  sampler. The assignment is one [N, K] product, the centroid update a
  one-hot [K, N] x [N, D] product, as the reference's; the Lloyd loop
  stops when the centroids' drift falls to ``tol`` (one host read per
  iteration).

The reference draws the k-means++ seeds from ``jax.random`` (threefry,
``categorical``); the port draws them from a ``torch.Generator`` seeded
from ``seed`` (``torch.multinomial``), so its partitions differ from the
reference's on the same rows (ROADMAP C22). Given the same initial
centroids, ``_lloyd``, ``kmeans_assign`` and ``reassign_single`` give the
reference's assignments, centroids within float rounding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.similarity import l2_normalize


@dataclass
class KMeansResult:
    centroids: np.ndarray  # [K, D], L2-normalized
    assignments: np.ndarray  # [N] int32, -1 for invalid rows
    iterations: int
    converged: bool
    inertia: float


def optimal_k(n: int) -> int:
    """Heuristic cluster count = f(n)."""
    if n < 1000:
        return max(1, n // 100)
    return max(8, min(4096, int(math.sqrt(n / 2))))


def euclid_kmeans(
    x: np.ndarray, k: int, iters: int = 25,
    seed_ids: Optional[Sequence[int]] = None, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Euclidean Lloyd with k-means++ init (optionally seeded rows first),
    on the host: the PQ codebook trainer. Rows are not normalized (PQ
    subvectors need true L2 geometry)."""
    rng = np.random.default_rng(seed)
    n = len(x)
    k = max(1, min(k, n))
    chosen: list = list(dict.fromkeys(
        int(i) for i in (seed_ids or []) if 0 <= int(i) < n))[:k]
    if not chosen:
        chosen = [int(rng.integers(n))]
    # incremental k-means++: the running min distance to the chosen rows,
    # updated against the newest one only
    d2 = np.full(n, np.inf, dtype=np.float64)
    for i in chosen:
        d2 = np.minimum(d2, np.sum((x - x[i]) ** 2, axis=1))
    while len(chosen) < k:
        total = d2.sum()
        if total <= 1e-12:
            # every remaining row coincides with a centroid: uniform picks
            nxt = int(rng.integers(n))
        else:
            nxt = int(rng.choice(n, p=d2 / total))
        chosen.append(nxt)
        d2 = np.minimum(d2, np.sum((x - x[nxt]) ** 2, axis=1))
    cent = x[chosen].copy()
    assign = np.zeros(n, dtype=np.int64)
    for it in range(iters):
        dist = (
            np.sum(x**2, axis=1, keepdims=True)
            - 2.0 * x @ cent.T
            + np.sum(cent**2, axis=1)[None, :]
        )
        new_assign = np.argmin(dist, axis=1)
        if it > 0 and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        # each centroid is the mean of its members in row order; one
        # stable sort gathers them, in place of a row mask per centroid
        # (the same rows in the same order, so the same means)
        order = np.argsort(assign, kind="stable")
        members = x[order]
        bounds = np.searchsorted(assign[order], np.arange(k + 1))
        for j in range(k):
            if bounds[j + 1] > bounds[j]:
                cent[j] = members[bounds[j]:bounds[j + 1]].mean(axis=0)
    return cent.astype(np.float32), assign


def train_subspace_codebooks(
    sample: np.ndarray, m: int, n_codes: int = 256,
) -> np.ndarray:
    """Per-subspace PQ codebooks ``[M, n_codes, D/M]``; short codebooks
    pad by repeating their last entry, so the shape is fixed."""
    n, d = sample.shape
    if d % m != 0:
        raise ValueError(f"dims {d} not divisible by M={m}")
    sub = sample.reshape(n, m, d // m)
    codes_k = min(n_codes, n)
    books = []
    for j in range(m):
        cb, _ = euclid_kmeans(
            np.ascontiguousarray(sub[:, j, :]), codes_k, seed=j + 1)
        if cb.shape[0] < n_codes:
            pad = np.repeat(cb[-1:], n_codes - cb.shape[0], axis=0)
            cb = np.concatenate([cb, pad], axis=0)
        books.append(cb)
    return np.stack(books)


def _categorical(weights: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index drawn with probability proportional to ``weights + 1e-30``
    (the reference's ``categorical(log(w + 1e-30))``), as a [1] tensor on
    the weights' device: no host read."""
    return torch.multinomial(weights + 1e-30, 1, generator=generator)


def _kmeanspp_seeded_init(
    x: torch.Tensor,  # [N, D] normalized
    valid: torch.Tensor,  # [N] bool
    seed_scores: torch.Tensor,  # [N] preferred-seed bonus (0 if none)
    generator: torch.Generator,
    k: int,
) -> torch.Tensor:
    """k-means++ whose D^2 weights are multiplied by exp(seed_score), so
    preferred rows (BM25 seeds) anchor the first centroids."""
    vf = valid.to(x.dtype)
    boost = torch.exp(seed_scores)
    c = x[_categorical(boost * vf, generator)]  # [1, D]
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = c[0]
    min_d2 = torch.sum((x - c) ** 2, dim=1)
    for j in range(1, k):
        w = min_d2 * boost * vf
        # all-zero weights (every valid row chosen): uniform over valid
        w = torch.where(w.sum() > 0, w, vf)
        c = x[_categorical(w, generator)]
        centroids[j] = c[0]
        min_d2 = torch.minimum(min_d2, torch.sum((x - c) ** 2, dim=1))
    return centroids


def kmeans_assign(x: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row (cosine; inputs normalized); invalid rows
    get -1."""
    a = torch.argmax(x @ centroids.T, dim=1).to(torch.int32)
    return torch.where(valid, a, torch.full_like(a, -1))


def _norm_rows(c: torch.Tensor) -> torch.Tensor:
    nrm = torch.sqrt(torch.sum(c * c, dim=1, keepdim=True))
    return c / torch.clamp_min(nrm, 1e-12)


def _lloyd(
    x: torch.Tensor,  # [N, D] normalized
    valid: torch.Tensor,  # [N] bool
    init_centroids: torch.Tensor,  # [K, D]
    k: int,
    max_iters: int,
    tol: float,
) -> Tuple[torch.Tensor, torch.Tensor, int, float]:
    """Lloyd iterations until the largest centroid move (squared) is at
    most ``tol`` or ``max_iters`` ran. Returns (centroids, assignments,
    iterations, inertia)."""
    vf = valid.to(x.dtype)[:, None]
    xv = x * vf
    centroids = _norm_rows(init_centroids)
    it, drift = 0, 1e9
    while it < max_iters and drift > tol:
        a = torch.argmax(xv @ centroids.T, dim=1)
        onehot = torch.nn.functional.one_hot(a, k).to(x.dtype) * vf
        sums = onehot.T @ xv  # [K, D]: the update as one product
        counts = onehot.sum(dim=0)
        new_c = sums / torch.clamp_min(counts[:, None], 1.0)
        # an empty cluster keeps its centroid
        new_c = _norm_rows(torch.where(counts[:, None] > 0, new_c, centroids))
        drift = float(torch.max(torch.sum((new_c - centroids) ** 2, dim=1)))
        centroids = new_c
        it += 1
    sims = x @ centroids.T
    a = torch.where(valid, torch.argmax(sims, dim=1).to(torch.int32),
                    torch.full((x.shape[0],), -1, dtype=torch.int32, device=x.device))
    best = torch.max(sims, dim=1).values
    inertia = float(torch.sum(torch.where(valid, 1.0 - best, torch.zeros_like(best))))
    return centroids, a, it, inertia


def kmeans_fit(
    vectors: np.ndarray,
    k: Optional[int] = None,
    *,
    valid: Optional[np.ndarray] = None,
    preferred_seed_indices: Optional[Sequence[int]] = None,
    max_iters: int = 50,
    tol: float = 1e-6,
    seed: int = 0,
    init: str = "kmeans++",
    device: DeviceLike = None,
) -> KMeansResult:
    """Cosine k-means of ``vectors`` [N, D] on ``device``;
    ``preferred_seed_indices`` bias k-means++ toward those rows."""
    dev = resolve_device(device)
    x = l2_normalize(torch.as_tensor(np.asarray(vectors, np.float32)).to(dev))
    n = x.shape[0]
    n_valid = int(np.sum(valid)) if valid is not None else n
    if k is None:
        k = optimal_k(n_valid)
    # k above the valid rows would seed centroids from padding
    k = max(1, min(k, n_valid))
    v = (torch.as_tensor(np.asarray(valid, bool)).to(dev) if valid is not None
         else torch.ones((n,), dtype=torch.bool, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    seed_scores = np.zeros((n,), dtype=np.float32)
    if preferred_seed_indices is not None and len(preferred_seed_indices) > 0:
        seed_scores[np.asarray(list(preferred_seed_indices), dtype=np.int64)] = 4.0
    if init == "random":
        probs = v.to(torch.float32)
        init_c = x[torch.multinomial(probs / probs.sum(), k, replacement=False,
                                     generator=gen)]
    else:
        init_c = _kmeanspp_seeded_init(x, v, torch.from_numpy(seed_scores).to(dev), gen, k)
    centroids, a, iters, inertia = _lloyd(x, v, init_c, k, max_iters, tol)
    return KMeansResult(
        centroids=centroids.cpu().numpy(),
        assignments=a.cpu().numpy(),
        iterations=iters,
        converged=iters < max_iters,
        inertia=inertia,
    )


def reassign_single(
    vector: torch.Tensor, centroids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Incremental single-vector reassignment on ingest: (best centroid
    int32, its similarity)."""
    sims = centroids @ vector
    best = torch.argmax(sims)
    return best.to(torch.int32), sims[best]
