"""Vectorized decay scoring: one device pass over the columnar
access/age/importance state replaces N per-node ``score()`` calls
(counterpart of ``nornicdb_tpu/ops/decay.py``).

Per node the host computes ``recency = 0.5^(age/half_life)``,
``frequency = 1 - exp(-accesses/10)``, a weighted sum with the importance
prior, then a scalar Kalman update (``filters.py``). All of it is
elementwise, so the sweep is a handful of float32 PyTorch ops on the
columns' device; the Kalman recurrence is replicated EXACTLY (same branch
structure, same constants) so a device sweep and a host sweep walk the
same state machine. Only float32-vs-float64 rounding differs (and
``torch.exp2`` may differ from XLA's by an ulp), which the caller
resolves by re-scoring the verdict-boundary band in float64 on the host
(``background/device_plane.py``). The reference jits one program per
weight and noise setting; here the same ops run eagerly.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device


def decay_scores_t(
    age_ms: torch.Tensor, half_life: torch.Tensor, accesses: torch.Tensor,
    importance: torch.Tensor, est: torch.Tensor, err: torch.Tensor,
    init: torch.Tensor, weights: Tuple[float, float, float],
    process_noise: float, measurement_noise: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(score, new Kalman estimate, new Kalman error), float32 [m] each, on
    the columns' device; the new estimate is the score itself. Columns are
    float32 [m] but ``init`` (bool)."""
    w_recency, w_frequency, w_importance = (float(w) for w in weights)
    recency = torch.exp2(-age_ms / half_life)
    frequency = 1.0 - torch.exp(-accesses / 10.0)
    raw = (w_recency * recency + w_frequency * frequency
           + w_importance * importance)
    # KalmanFilter.update, elementwise (filters.py:update)
    err1 = err + float(process_noise)
    gain = err1 / (err1 + float(measurement_noise))
    est_u = est + gain * (raw - est)
    err_u = err1 * (1.0 - gain)
    score = torch.where(init, est_u, raw)
    return score, score, torch.where(init, err_u, err)


def decay_scores(
    age_ms: np.ndarray, half_life: np.ndarray, accesses: np.ndarray,
    importance: np.ndarray, est: np.ndarray, err: np.ndarray,
    init: np.ndarray, weights: Tuple[float, float, float],
    process_noise: float, measurement_noise: float,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One pass over the whole sweep's columns on ``device`` (None =
    cuda); returns (score, new_kalman_estimate, new_kalman_error) as host
    float32 arrays."""
    dev = resolve_device(device)

    def col(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    out = decay_scores_t(col(age_ms), col(half_life), col(accesses),
                         col(importance), col(est), col(err),
                         col(init, torch.bool), weights, process_noise,
                         measurement_noise)
    return tuple(t.cpu().numpy() for t in out)


def decay_score_host_f64(age_ms: float, half_life: float,
                         accesses: float, importance: float,
                         est: float, err: float, init: bool,
                         weights: Tuple[float, float, float],
                         q: float, r: float) -> float:
    """f64 reference for ONE node from the same pre-sweep state — the
    device plane's boundary-band re-check. Pure: does not advance any
    live KalmanFilter (decay.score() would mutate it a second time)."""
    recency = math.pow(0.5, age_ms / half_life)
    frequency = 1.0 - math.exp(-accesses / 10.0)
    raw = (weights[0] * recency + weights[1] * frequency
           + weights[2] * importance)
    if not init:
        return raw
    err1 = err + q
    gain = err1 / (err1 + r)
    return est + gain * (raw - est)
