"""ctypes binding of the host HNSW kernels (``csrc/hnsw_host.cpp``;
counterpart of ``nornicdb_tpu/search/hnsw_native.py``).

The library is built with ``c++`` at first use (``ops/_build.py``).
Unlike the reference's loader, a build failure raises: the HNSW build and
query never drop to their Python path quietly. ``HNSWIndex`` takes its
Python path only where ``get_lib`` is replaced to return None, as the
tests that pin the two paths against each other do.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The bound library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            from nornicdb_tpu_torch.ops._build import host_library

            lib = host_library("hnsw_host")
            p = ctypes.POINTER
            lib.hnsw_connect.argtypes = [
                p(ctypes.c_float),   # vectors
                ctypes.c_int64,      # dims
                p(ctypes.c_int32),   # nbr
                p(ctypes.c_int32),   # cnt
                ctypes.c_int64,      # width
                ctypes.c_int64,      # m_forward
                ctypes.c_int64,      # level_cap
                p(ctypes.c_int64),   # wave_slots
                p(ctypes.c_int64),   # cand_off
                p(ctypes.c_int64),   # cand_slots
                p(ctypes.c_float),   # cand_dists
                ctypes.c_int64,      # n_wave
            ]
            lib.hnsw_connect.restype = None
            lib.hnsw_wave_search.argtypes = [
                p(ctypes.c_float),   # vectors
                ctypes.c_int64,      # dims
                p(ctypes.c_void_p),  # nbr level pointers
                p(ctypes.c_void_p),  # cnt level pointers
                p(ctypes.c_int64),   # widths
                ctypes.c_int64,      # n_levels
                p(ctypes.c_float),   # queries
                ctypes.c_int64,      # B
                p(ctypes.c_int64),   # query_levels
                ctypes.c_int64,      # entry_slot
                ctypes.c_int64,      # ef
                ctypes.c_int64,      # capacity
                p(ctypes.c_int64),   # out_slots
                p(ctypes.c_float),   # out_dists
            ]
            lib.hnsw_wave_search.restype = None
            _lib = lib
        return _lib


def _check(a: np.ndarray, dtype, what: str) -> None:
    if a.dtype != dtype or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what} must be C-contiguous {np.dtype(dtype)}")


def wave_search(lib, vectors: np.ndarray, nbr_levels, cnt_levels,
                queries: np.ndarray, query_levels: np.ndarray,
                entry_slot: int, ef: int,
                capacity: int) -> "tuple[np.ndarray, np.ndarray]":
    """Run the native wave layer-search. Returns (dists, slots) shaped
    [B, n_levels, ef] (+inf / -1 padded), ascending per (query, level).
    Every array the kernel reads is held here until it returns."""
    p = ctypes.POINTER
    n_levels = len(nbr_levels)
    B = queries.shape[0]
    _check(vectors, np.float32, "vectors")
    _check(queries, np.float32, "queries")
    if vectors.shape[0] < capacity or queries.shape[1] != vectors.shape[1]:
        raise ValueError("vectors must hold capacity rows of the queries' width")
    for a, c in zip(nbr_levels, cnt_levels):
        _check(a, np.int32, "adjacency")
        _check(c, np.int32, "degree counts")
    nbr_ptrs = (ctypes.c_void_p * n_levels)(
        *[a.ctypes.data for a in nbr_levels])
    cnt_ptrs = (ctypes.c_void_p * n_levels)(
        *[a.ctypes.data for a in cnt_levels])
    widths = np.asarray([a.shape[1] for a in nbr_levels], np.int64)
    levels = np.ascontiguousarray(query_levels, np.int64)
    out_slots = np.empty((B, n_levels, ef), np.int64)
    out_dists = np.empty((B, n_levels, ef), np.float32)
    lib.hnsw_wave_search(
        vectors.ctypes.data_as(p(ctypes.c_float)),
        vectors.shape[1],
        nbr_ptrs,
        cnt_ptrs,
        widths.ctypes.data_as(p(ctypes.c_int64)),
        n_levels,
        queries.ctypes.data_as(p(ctypes.c_float)),
        B,
        levels.ctypes.data_as(p(ctypes.c_int64)),
        entry_slot,
        ef,
        capacity,
        out_slots.ctypes.data_as(p(ctypes.c_int64)),
        out_dists.ctypes.data_as(p(ctypes.c_float)),
    )
    return out_dists, out_slots


def connect_wave(lib, vectors: np.ndarray, nbr: np.ndarray,
                 cnt: np.ndarray, m_forward: int, level_cap: int,
                 wave_slots: np.ndarray, cand_off: np.ndarray,
                 cand_slots: np.ndarray, cand_dists: np.ndarray) -> None:
    """Link one wave at one level; adjacency (nbr/cnt) is mutated in
    place."""
    p = ctypes.POINTER
    _check(vectors, np.float32, "vectors")
    _check(nbr, np.int32, "adjacency")
    _check(cnt, np.int32, "degree counts")
    for a, dtype, what in ((wave_slots, np.int64, "wave_slots"),
                           (cand_off, np.int64, "cand_off"),
                           (cand_slots, np.int64, "cand_slots"),
                           (cand_dists, np.float32, "cand_dists")):
        _check(a, dtype, what)
    lib.hnsw_connect(
        vectors.ctypes.data_as(p(ctypes.c_float)),
        vectors.shape[1],
        nbr.ctypes.data_as(p(ctypes.c_int32)),
        cnt.ctypes.data_as(p(ctypes.c_int32)),
        nbr.shape[1],
        m_forward,
        level_cap,
        wave_slots.ctypes.data_as(p(ctypes.c_int64)),
        cand_off.ctypes.data_as(p(ctypes.c_int64)),
        cand_slots.ctypes.data_as(p(ctypes.c_int64)),
        cand_dists.ctypes.data_as(p(ctypes.c_float)),
        len(wave_slots),
    )
