"""Kalman filters used by decay/temporal/inference smoothing (a copy of
``nornicdb_tpu/filters.py``; ``query/kalman_fns.py`` holds only the Cypher
functions).

Reference: pkg/filter — kalman.go (basic), kalman_adaptive.go,
kalman_velocity.go (1,561 LoC). Scalar filters; the math is identical, in
a fraction of the code.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class KalmanFilter:
    """1-D constant-state Kalman filter."""

    process_noise: float = 1e-3  # Q
    measurement_noise: float = 1e-1  # R
    estimate: float = 0.0
    error: float = 1.0  # P
    initialized: bool = False

    def update(self, measurement: float) -> float:
        if not self.initialized:
            self.estimate = measurement
            self.initialized = True
            return self.estimate
        # predict
        self.error += self.process_noise
        # update
        gain = self.error / (self.error + self.measurement_noise)
        self.estimate += gain * (measurement - self.estimate)
        self.error *= 1.0 - gain
        return self.estimate


@dataclass
class AdaptiveKalmanFilter(KalmanFilter):
    """Adapts measurement noise to the innovation magnitude
    (reference: kalman_adaptive.go)."""

    adapt_rate: float = 0.05

    def update(self, measurement: float) -> float:
        if self.initialized:
            innovation = abs(measurement - self.estimate)
            self.measurement_noise = (
                (1.0 - self.adapt_rate) * self.measurement_noise
                + self.adapt_rate * innovation * innovation
            )
            self.measurement_noise = max(self.measurement_noise, 1e-6)
        return super().update(measurement)


class VelocityKalmanFilter:
    """2-state (position, velocity) filter for access-rate trends
    (reference: kalman_velocity.go)."""

    def __init__(self, process_noise: float = 1e-3, measurement_noise: float = 1e-1):
        self.q = process_noise
        self.r = measurement_noise
        self.pos = 0.0
        self.vel = 0.0
        # covariance
        self.p00, self.p01, self.p10, self.p11 = 1.0, 0.0, 0.0, 1.0
        self.initialized = False
        self._last_t: float | None = None

    def update(self, measurement: float, t: float) -> tuple[float, float]:
        if not self.initialized:
            self.pos = measurement
            self.initialized = True
            self._last_t = t
            return self.pos, self.vel
        last = self._last_t if self._last_t is not None else t
        dt = max(t - last, 1e-9)
        self._last_t = t
        # predict
        self.pos += self.vel * dt
        self.p00 += dt * (self.p10 + self.p01 + dt * self.p11) + self.q
        self.p01 += dt * self.p11
        self.p10 += dt * self.p11
        self.p11 += self.q
        # update position measurement — the covariance update must use the
        # PRIOR (predicted) values throughout, or the gain stays inflated
        innovation = measurement - self.pos
        s = self.p00 + self.r
        k0 = self.p00 / s
        k1 = self.p10 / s
        self.pos += k0 * innovation
        self.vel += k1 * innovation
        p00, p01, p10, p11 = self.p00, self.p01, self.p10, self.p11
        self.p00 = (1 - k0) * p00
        self.p01 = (1 - k0) * p01
        self.p10 = p10 - k1 * p00
        self.p11 = p11 - k1 * p01
        return self.pos, self.vel
