"""Fused exact cosine top-k: wrapper of ``csrc/cosine_topk.cu``.

Counterpart of ``nornicdb_tpu/ops/pallas_topk.py:fused_cosine_topk``. On
a CUDA tensor the wrapper launches the kernel or raises; its plain
version (``ops/similarity.py:cosine_topk_auto``, a matmul + mask +
stable top-k) runs only for tensors on the CPU. Unlike the TPU kernel it
takes any B and any D, so there is no fallback on a shape miss.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.ops import _build
from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto

MAX_K = 256
_TILE_ROWS = 64  # rows per tile in the kernel's stage 1


def _lib() -> ctypes.CDLL:
    lib = _build.library("cosine_topk")
    if lib.nornic_cosine_topk.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.nornic_cosine_topk.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.nornic_cosine_topk.restype = ctypes.c_int
        lib.nornic_cosine_topk_group.argtypes = [i]
        lib.nornic_cosine_topk_group.restype = ctypes.c_int
    return lib


def fused_cosine_topk(
    queries: torch.Tensor, matrix: torch.Tensor, valid: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k over L2-normalized inputs: queries [B, D] f32,
    matrix [C, D] f32, valid [C] bool. Returns (scores [B, k'] f32,
    indices [B, k'] int64) with k' = min(k, C); masked rows score -1e30
    and ties go to the lower row index. 1 <= k <= 256."""
    if queries.ndim != 2 or matrix.ndim != 2 or queries.shape[1] != matrix.shape[1]:
        raise ValueError(
            f"queries {tuple(queries.shape)} and matrix {tuple(matrix.shape)} "
            "must be [B, D] and [C, D]")
    b, d = queries.shape
    c = matrix.shape[0]
    if valid.shape != (c,):
        raise ValueError(f"valid must be [{c}], got {tuple(valid.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if c == 0:
        raise ValueError("matrix has no rows")
    k_eff = min(k, c)
    dev = queries.device
    if matrix.device != dev or valid.device != dev:
        raise ValueError("queries, matrix and valid must be on one device")
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
    out_s = torch.empty((b, k_eff), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k_eff), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i.long()
    lib = _lib()
    groups = -(-b // lib.nornic_cosine_topk_group(b))
    n_tiles = -(-c // _TILE_ROWS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = max(1, min(n_tiles, -(-2 * sms // groups)))
    part_s = torch.empty((g, b, k_eff), dtype=torch.float32, device=dev)
    part_i = torch.empty((g, b, k_eff), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nornic_cosine_topk(
        queries.data_ptr(), matrix.data_ptr(), valid.data_ptr(),
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        b, c, d, k_eff, g, stream)
    _build.check(lib, err, "cosine_topk kernel")
    fused_cosine_topk.launches += 1
    return out_s, out_i.long()


fused_cosine_topk.launches = 0


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
