"""Cosine similarity + top-k, plain PyTorch (counterpart of
``nornicdb_tpu/ops/similarity.py:27-145``).

These are the plain versions that the fused top-k kernel
(``ops/topk.py``) is held against, and what its wrapper runs for tensors
on the CPU. Capacity-padded matrices with validity masks keep shapes
stable as the index grows; the chunked variant bounds memory for large C
by never holding the full [B, C] score matrix.

Ties resolve to the lower index, as ``lax.top_k`` does: every top-k here
is a stable descending sort, or a top-k of ``order_keys`` (the quantized
planes' wide scans, where a sort of every score would cost more).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30

# above this row count, route to the chunked scan to bound memory
CHUNKED_THRESHOLD = 262_144


def pad_dim(n: int, minimum: int = 256) -> int:
    """Round capacity up to the next power-of-two multiple of ``minimum``."""
    if n <= minimum:
        return minimum
    capacity = minimum
    while capacity < n:
        capacity *= 2
    return capacity


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize so cosine similarity reduces to a dot product."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; equal scores keep the lower index first."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


_LOW32 = 0xFFFFFFFF


def order_keys(scores: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """int64 keys of float32 ``scores`` [..., C] whose descending order is
    (score descending, column + ``offset`` ascending): the score's bits
    mapped to an order-preserving int32 in the high half, the complement
    of the index in the low half. Distinct keys make ``torch.topk``'s
    answer unique, so top-k by keys gives ``lax.top_k``'s ties without a
    full sort; scans of column chunks merge by taking the top-k of their
    keys together."""
    bits = scores.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    idx = torch.arange(offset, offset + scores.shape[-1], device=scores.device)
    return ordered * (1 << 32) + (_LOW32 - idx)


def keys_topk(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest keys along the last axis, largest first."""
    return torch.topk(keys, min(k, keys.shape[-1]), dim=-1).values


def unpack_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float32 scores, int64 indices) of ``order_keys`` keys, bitwise."""
    ordered = torch.div(keys, 1 << 32, rounding_mode="floor")
    bits = torch.where(ordered >= 0, ordered, ordered ^ 0x7FFFFFFF)
    scores = bits.to(torch.int32).contiguous().view(torch.float32)
    return scores, _LOW32 - (keys & _LOW32)


def _cosine_topk_impl(queries, matrix, valid, k):
    scores = queries @ matrix.T
    scores = torch.where(valid[None, :], scores, torch.full_like(scores, NEG_INF))
    return topk_stable(scores, k)


def cosine_topk(
    queries: torch.Tensor, matrix: torch.Tensor, valid: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k. Inputs must be L2-normalized. Returns
    (scores [B,k], indices [B,k]); masked-out rows score NEG_INF."""
    k = min(k, matrix.shape[0])
    return _cosine_topk_impl(queries, matrix, valid, k)


def _cosine_topk_chunked_impl(queries, matrix, valid, k, chunk):
    b = queries.shape[0]
    best_s = torch.full((b, k), NEG_INF, dtype=queries.dtype, device=queries.device)
    best_i = torch.zeros((b, k), dtype=torch.int64, device=queries.device)
    for start in range(0, matrix.shape[0], chunk):
        s = queries @ matrix[start:start + chunk].T
        s = torch.where(valid[None, start:start + chunk], s,
                        torch.full_like(s, NEG_INF))
        idx = torch.arange(start, start + chunk, device=queries.device)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, idx.expand(b, chunk)], dim=1)
        best_s, pos = topk_stable(cat_s, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i


def cosine_topk_chunked(
    queries: torch.Tensor, matrix: torch.Tensor, valid: torch.Tensor, k: int,
    chunk: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k scanning C in chunks with a running [B, k] best
    set. The running set starts as (NEG_INF, index 0), so a row with
    fewer than k valid entries carries index 0 in its NEG_INF tail, as
    the JAX scan does."""
    c = matrix.shape[0]
    k = min(k, c)
    if c <= chunk:
        return _cosine_topk_impl(queries, matrix, valid, k)
    # pad_dim capacities are power-of-two multiples of 256, so a
    # power-of-two chunk divides them; other capacities go dense
    while c % chunk != 0 and chunk >= 512:
        chunk //= 2
    if c % chunk != 0:
        return _cosine_topk_impl(queries, matrix, valid, k)
    return _cosine_topk_chunked_impl(queries, matrix, valid, k, chunk)


def cosine_topk_auto(
    queries: torch.Tensor, matrix: torch.Tensor, valid: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense below CHUNKED_THRESHOLD rows, chunked above."""
    if matrix.shape[0] > CHUNKED_THRESHOLD:
        return cosine_topk_chunked(queries, matrix, valid, k)
    return cosine_topk(queries, matrix, valid, k)
