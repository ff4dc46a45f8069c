"""Fused exact cosine top-k: wrapper of ``csrc/cosine_topk.cu``.

Counterpart of ``nornicdb_tpu/ops/pallas_topk.py:fused_cosine_topk``. On
a CUDA tensor with 1 <= k <= ``MAX_K`` the wrapper launches the kernel or
raises; its plain version (``ops/similarity.py:cosine_topk_auto``, a
matmul + mask + stable top-k) runs only for tensors on the CPU. Unlike
the TPU kernel it takes any B and any D, so there is no fallback on a
shape miss.

For k > ``MAX_K`` the wrapper takes the route the reference takes above
its Pallas limit (``pallas_topk.py:fused_cosine_topk`` returns
``cosine_topk_auto`` for k > 128): a plain matrix product plus a stable
top-k, on any device. That route is the reference's XLA branch, not the
kernel; it is chosen on k alone, before any launch, and counted in
``fused_cosine_topk.wide_k_calls``.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.ops import _build
from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto

MAX_K = 256
_GRIDS: Dict[tuple, int] = {}  # stage-1 blocks per call shape, read once


def _lib() -> ctypes.CDLL:
    return bind(_build.library("cosine_topk"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded ``cosine_topk`` library."""
    if lib.nornic_cosine_topk.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.nornic_cosine_topk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.nornic_cosine_topk.restype = ctypes.c_int
        lib.nornic_cosine_topk_grid.argtypes = [p, p, i, i, i, i]
        lib.nornic_cosine_topk_grid.restype = ctypes.c_int
    return lib


def fused_cosine_topk(
    queries: torch.Tensor, matrix: torch.Tensor, valid: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k over L2-normalized inputs: queries [B, D] f32,
    matrix [C, D] f32, valid [C] bool. Returns (scores [B, k'] f32,
    indices [B, k'] int64) with k' = min(k, C); masked rows score -1e30
    and ties go to the lower row index. k > ``MAX_K`` takes the wide-k
    route (module docstring)."""
    if queries.ndim != 2 or matrix.ndim != 2 or queries.shape[1] != matrix.shape[1]:
        raise ValueError(
            f"queries {tuple(queries.shape)} and matrix {tuple(matrix.shape)} "
            "must be [B, D] and [C, D]")
    b, d = queries.shape
    c = matrix.shape[0]
    if valid.shape != (c,):
        raise ValueError(f"valid must be [{c}], got {tuple(valid.shape)}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if c == 0:
        raise ValueError("matrix has no rows")
    k_eff = min(k, c)
    dev = queries.device
    if matrix.device != dev or valid.device != dev:
        raise ValueError("queries, matrix and valid must be on one device")
    if k > MAX_K:
        fused_cosine_topk.wide_k_calls += 1
        return cosine_topk_auto(queries, matrix, valid.to(torch.bool), k_eff)
    if dev.type == "cpu":
        return cosine_topk_auto(queries, matrix, valid.to(torch.bool), k_eff)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if queries.dtype != torch.float32 or matrix.dtype != torch.float32:
        raise ValueError("queries and matrix must be float32")
    if valid.dtype != torch.bool:
        raise ValueError("valid must be bool")
    if not (queries.is_contiguous() and matrix.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("queries, matrix and valid must be contiguous")
    if b == 0:
        return (torch.empty((0, k_eff), dtype=torch.float32, device=dev),
                torch.empty((0, k_eff), dtype=torch.int64, device=dev))
    out = launch(_lib(), _GRIDS, queries, matrix, valid, k_eff)
    fused_cosine_topk.launches += 1
    fused_cosine_topk.launch_sizes[b] += 1
    return out


fused_cosine_topk.launches = 0
fused_cosine_topk.launch_sizes = Counter()  # launches by query count B
fused_cosine_topk.wide_k_calls = 0


def launch(
    lib: ctypes.CDLL, grids: Dict[tuple, int], queries: torch.Tensor,
    matrix: torch.Tensor, valid: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of ``lib``'s kernel on checked CUDA inputs with B >= 1 and
    1 <= k <= min(C, ``MAX_K``); ``grids`` caches the stage-1 grid of
    this library by call shape. Counts nothing."""
    b, d = queries.shape
    c = matrix.shape[0]
    dev = queries.device
    args = (queries.data_ptr(), matrix.data_ptr())
    # the grid depends on the shapes, the bases' 16-byte alignment and the card
    grid_key = (dev.index, b, c, d, k, (args[0] | args[1]) % 16 == 0)
    g = grids.get(grid_key)
    if g is None:
        g = lib.nornic_cosine_topk_grid(*args, b, c, d, k)
        if g < 0:
            _build.check(lib, -g, "cosine_topk grid")
        grids[grid_key] = g
    # one allocation, in int32 words: indices [B, k] int64, scores [B, k],
    # then the scratch: partial scores and indices [G, B, k] each and one
    # u32 key per query
    n = b * k
    buf = torch.empty(3 * n + 2 * g * n + b, dtype=torch.int32, device=dev)
    out_i = buf[:2 * n].view(torch.int64).view(b, k)
    out_s = buf[2 * n:3 * n].view(torch.float32).view(b, k)
    err = lib.nornic_cosine_topk(
        *args, valid.data_ptr(), buf.data_ptr() + 12 * n, out_s.data_ptr(), out_i.data_ptr(),
        b, c, d, k, g, torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, err, "cosine_topk kernel")
    return out_s, out_i


def topk_agree(
    ids_a: Sequence[Sequence[int]], scores_a: Sequence[Sequence[float]],
    ids_b: Sequence[Sequence[int]], scores_b: Sequence[Sequence[float]],
    atol: float,
) -> bool:
    """Tie-aware agreement of two exact top-k answers, row by row: scores
    agree position by position within ``atol``, and where the ids differ,
    A's id sits in B's answer at a score within ``atol`` of its own, or
    ties B's last score (the cut may fall inside a tie group). Entries
    that carry the masked score (< -1e29) compare by score only."""
    sa, sb = np.asarray(scores_a, np.float64), np.asarray(scores_b, np.float64)
    ia, ib = np.asarray(ids_a), np.asarray(ids_b)
    if sa.shape != sb.shape or ia.shape != ib.shape or sa.shape != ia.shape:
        return False
    if not np.allclose(sa, sb, rtol=0.0, atol=atol):
        return False
    for row in range(sa.shape[0]):
        row_a, row_b = ia[row].tolist(), ib[row].tolist()
        pos_b = {x: p for p, x in enumerate(row_b)}
        for p in range(sa.shape[1]):
            if sa[row, p] < -1e29 or row_a[p] == row_b[p]:
                continue
            q = pos_b.get(row_a[p])
            if q is not None and abs(sb[row, q] - sa[row, p]) <= atol:
                continue
            if abs(sa[row, p] - sb[row, -1]) <= atol:
                continue
            return False
    return True
