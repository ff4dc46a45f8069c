"""Shared numpy helpers for the search package (counterpart of
``nornicdb_tpu/search/util.py``)."""

from __future__ import annotations

import numpy as np


def normalize_rows(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Row-L2-normalize; zero rows stay (near-)zero instead of NaN."""
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)
