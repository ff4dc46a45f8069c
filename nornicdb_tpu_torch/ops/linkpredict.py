"""Device link prediction: masked sparse 2-hop expansion + weighted
segment reduction + top-k over a batch of seeds (counterpart of
``nornicdb_tpu/ops/linkpredict.py``).

A seed's candidates are its 2-hop neighborhood; the score of pair
``(u, v)`` is ``sum_z w(z)`` over common neighbors ``z`` — ``w`` encodes
the scorer (common-neighbors: 1, Adamic–Adar: 1/ln(deg z),
resource-allocation: 1/deg z). The host loop intersects Python sets per
candidate pair; here a whole batch of seeds runs as PyTorch ops over a
CSR snapshot on its device, batched over a leading seed axis where the
reference ``vmap``s one seed's program:

1. gather the sorted 1-hop row of each seed (width ``f1``, sentinel
   ``n`` pads, so a padded row stays sorted);
2. expand to the full 2-hop multiset (width ``f1*f2`` — COMPLETE
   coverage; the caller refuses a seed, never truncates it, when its
   bucket would overflow), carrying ``w(mid)`` per element;
3. a stable sort by candidate id that carries the weights, run heads,
   then a segment sum of the weights and each run's id;
4. mask sentinels, the seed itself, and existing neighbors (a
   ``searchsorted`` membership probe against the sorted 1-hop row);
5. top-``kp`` of the masked scores, ties to the lower slot as
   ``lax.top_k`` (``ops/similarity.py:order_keys``), and the count of
   distinct candidates.

Exactness: common-neighbors scores are small-integer sums in float32
(exact below 2^24, whatever the order). The weighted scorers' segment sum
(``scatter_add_``) adds in any order on CUDA, so the caller's guard uses
:func:`sum_error_bound`, which holds for every order; it re-scores the
kept candidates exactly on the host and steps down when an excluded
candidate could reach the cut (``background/device_plane.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.ops.similarity import keys_topk, order_keys, unpack_keys

_F32_UNIT = 2.0 ** -24  # float32 unit roundoff


def sum_error_bound(n_terms: int, w_max: float) -> float:
    """Bound on |float32 sum - exact sum| for at most ``n_terms``
    nonnegative terms, each an exact value at most ``w_max`` rounded once
    to float32, added in ANY order: each rounded term is off by at most
    ``u/2`` of itself, and any order of ``m`` additions by at most
    ``(m - 1) u`` of the terms' sum (Higham, Accuracy and Stability of
    Numerical Algorithms, eq. 4.4), so ``u (m (m - 1) + m / 2) w_max``
    with ``u = 2^-24``, taken as ``m^2 u w_max`` with a margin of 1% for
    second-order terms and the host's float64 sum."""
    m = float(max(1, n_terms))
    return 1.01 * m * m * _F32_UNIT * float(w_max)


def linkpredict_topk_t(
    seeds: torch.Tensor,   # [b] int64, -1 pads
    indptr: torch.Tensor,  # [n+1] int64 CSR row starts
    nbr: torch.Tensor,     # [E] int64, sorted within each row
    w: torch.Tensor,       # [n] float32 per-mid weight
    n: int, f1: int, f2: int, kp: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-seed top-``kp`` (scores [b, kp] float32, candidate rows [b, kp]
    int64) plus the exact distinct-candidate count [b] int64, on the
    tensors' device. ``kp`` <= ``f1 * f2``."""
    dev = seeds.device
    b = seeds.shape[0]
    width = f1 * f2
    if nbr.numel() == 0:  # every gather below then reads one sentinel
        nbr = torch.full((1,), n, dtype=torch.int64, device=dev)
    last = nbr.numel() - 1
    valid = seeds >= 0
    sc = torch.where(valid, seeds, 0)
    start1 = indptr[sc]
    deg1 = indptr[sc + 1] - start1
    j = torch.arange(f1, dtype=torch.int64, device=dev)
    take1 = valid[:, None] & (j[None, :] < deg1[:, None])           # [b, f1]
    h1 = torch.where(take1, nbr[(start1[:, None] + j).clamp(0, last)], n)
    # 2-hop expansion: mid = h1[j]; every neighbor of mid is a candidate
    # scored by w[mid]
    midc = torch.where(take1, h1, 0)
    start2 = indptr[midc]
    deg2 = indptr[midc + 1] - start2
    ll = torch.arange(f2, dtype=torch.int64, device=dev)
    take2 = take1[:, :, None] & (ll[None, None, :] < deg2[:, :, None])  # [b, f1, f2]
    flat = (start2[:, :, None] + ll).clamp(0, last)
    cand = torch.where(take2, nbr[flat], n).reshape(b, width)
    wt = torch.where(take2, w[midc][:, :, None], 0.0).reshape(b, width)
    # group equal candidates: stable sort by id carrying the weights,
    # flag run heads, segment-sum the weights per run
    cand_s, order = torch.sort(cand, dim=1, stable=True)
    wt_s = torch.gather(wt, 1, order)
    first = torch.ones_like(cand_s, dtype=torch.bool)
    first[:, 1:] = cand_s[:, 1:] != cand_s[:, :-1]
    run_id = torch.cumsum(first, dim=1) - 1
    scores = torch.zeros((b, width), dtype=torch.float32, device=dev)
    scores.scatter_add_(1, run_id, wt_s)
    # every element of a run holds the run's id: a plain scatter is exact
    cand_of = torch.full((b, width), n, dtype=torch.int64, device=dev)
    cand_of.scatter_(1, run_id, cand_s)
    live = torch.arange(width, device=dev)[None, :] <= run_id[:, -1:]
    # mask sentinels, the seed, and existing 1-hop neighbors
    pos = torch.searchsorted(h1.contiguous(), cand_of.contiguous()).clamp(max=f1 - 1)
    in_hop1 = torch.gather(h1, 1, pos) == cand_of
    keep = live & (cand_of < n) & (cand_of != seeds[:, None]) & ~in_hop1
    masked = torch.where(keep, scores, float("-inf"))
    vals, idx = unpack_keys(keys_topk(order_keys(masked), kp))
    sel = torch.gather(cand_of, 1, idx)
    return vals, sel, keep.sum(dim=1)


def degree_weights(method: str, indptr: np.ndarray) -> np.ndarray:
    """Per-mid weight column for the scorer ``method``, computed on
    the host in f64 then narrowed to f32 (one column per snapshot, not
    per call). A common neighbor always has degree >= 2, so the
    Adamic–Adar log is never <= 0 where it matters; degree<=1 rows get
    weight 0 (they contribute no pairs anyway)."""
    deg = (indptr[1:] - indptr[:-1]).astype(np.float64)
    if method == "common_neighbors":
        w = np.ones_like(deg)
    elif method == "adamic_adar":
        with np.errstate(divide="ignore"):
            w = np.where(deg > 1.0, 1.0 / np.log(np.maximum(deg, 2.0)),
                         0.0)
    elif method == "resource_allocation":
        with np.errstate(divide="ignore"):
            w = np.where(deg > 0.0, 1.0 / np.maximum(deg, 1.0), 0.0)
    else:
        raise ValueError(f"unsupported device scorer: {method}")
    return w.astype(np.float32)


def linkpredict_topk(
    seeds: np.ndarray,      # [b] int (-1 pads allowed)
    indptr: torch.Tensor,   # [n+1] int64 on the snapshot's device
    nbr: torch.Tensor,      # [E] int64 (row-sorted), same device
    w: torch.Tensor,        # [n] float32, same device
    n: int,
    f1: int, f2: int, kp: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One pass on the snapshot's device: per-seed top-``kp`` (scores,
    candidates) plus the exact distinct-candidate count (the caller's
    coverage guard), as host arrays."""
    s = torch.as_tensor(np.asarray(seeds, dtype=np.int64), device=indptr.device)
    vals, sel, distinct = linkpredict_topk_t(s, indptr, nbr, w, n, f1, f2, kp)
    return vals.cpu().numpy(), sel.cpu().numpy(), distinct.cpu().numpy()
