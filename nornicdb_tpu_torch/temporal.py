"""Temporal access tracking: velocity, sessions, co-access patterns
(counterpart of ``nornicdb_tpu/temporal.py``; every recording and query
method takes an injected time, ``at=`` or ``now=``).

Reference: pkg/temporal — Tracker (tracker.go:216), RecordAccess (:419),
session detection, pattern detector, relationship evolution (3,347 LoC).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.filters import VelocityKalmanFilter

SESSION_GAP_S = 1800.0  # 30 min of silence ends a session
CO_ACCESS_WINDOW_S = 300.0  # accesses within 5 min are "together"


@dataclass
class AccessRecord:
    node_id: str
    at: float


@dataclass
class NodeAccessStats:
    count: int = 0
    first_at: float = 0.0
    last_at: float = 0.0
    velocity: float = 0.0  # accesses/hour trend (Kalman-smoothed)


class TemporalTracker:
    def __init__(self, history_limit: int = 10_000):
        self._lock = threading.Lock()
        self._history: Deque[AccessRecord] = deque(maxlen=history_limit)
        self._stats: Dict[str, NodeAccessStats] = {}
        self._filters: Dict[str, VelocityKalmanFilter] = {}
        self._session_id = 0
        self._session_start: Optional[float] = None
        self._session_last: Optional[float] = None
        self._session_nodes: List[str] = []
        self._session_times: List[Tuple[str, float]] = []
        # integrated sub-trackers (reference: the Tracker owns pattern
        # detection and relationship evolution, tracker.go:216)
        self.patterns = PatternDetector()
        self.evolution = RelationshipEvolution()

    # -- recording ---------------------------------------------------------

    def record_access(self, node_id: str, at: Optional[float] = None) -> None:
        at = at if at is not None else time.time()
        with self._lock:
            self._history.append(AccessRecord(node_id, at))
            st = self._stats.setdefault(node_id, NodeAccessStats(first_at=at))
            st.count += 1
            st.last_at = at
            kf = self._filters.setdefault(node_id, VelocityKalmanFilter())
            _, vel = kf.update(float(st.count), at)
            st.velocity = vel * 3600.0  # per hour
            # session tracking
            if self._session_last is None or at - self._session_last > SESSION_GAP_S:
                self._session_id += 1
                self._session_start = at
                self._session_nodes = []
            self._session_last = at
            # only accesses inside the co-access window count as
            # "together" (CO_ACCESS_WINDOW_S — same definition as
            # co_accessed()); session membership alone can span hours
            recent = {
                n for n, t in self._session_times[-8:]
                if n != node_id and at - t <= CO_ACCESS_WINDOW_S
            }
            self._session_nodes.append(node_id)
            self._session_times.append((node_id, at))
            del self._session_times[:-8]
        # feed the integrated sub-trackers outside the main lock (they
        # lock themselves): access histogram + co-access edge strengths
        self.patterns.record_access(node_id, at)
        for other in recent:
            self.evolution.record_co_access(node_id, other, at=at)

    def detect_patterns(self, node_id: str,
                        now: Optional[float] = None) -> List["DetectedPattern"]:
        """Patterns for a node, fed with its current Kalman velocity.
        Pass ``now`` when analyzing replayed/historical timestamps so
        burst detection judges against the data's clock."""
        st = self.stats(node_id)
        vel = st.velocity if st else 0.0
        return self.patterns.detect_patterns(node_id, velocity=vel, now=now)

    # -- queries -----------------------------------------------------------

    def stats(self, node_id: str) -> Optional[NodeAccessStats]:
        with self._lock:
            st = self._stats.get(node_id)
            return NodeAccessStats(**vars(st)) if st else None

    @property
    def session(self) -> Tuple[int, List[str]]:
        with self._lock:
            return self._session_id, list(self._session_nodes)

    def co_accessed(
        self, node_id: str, window_s: float = CO_ACCESS_WINDOW_S
    ) -> List[Tuple[str, int]]:
        """Nodes accessed within ``window_s`` of any access to ``node_id``,
        with co-occurrence counts (feeds inference co-access suggestions)."""
        with self._lock:
            times = [r.at for r in self._history if r.node_id == node_id]
            if not times:
                return []
            counts: Dict[str, int] = {}
            for r in self._history:
                if r.node_id == node_id:
                    continue
                if any(abs(r.at - t) <= window_s for t in times):
                    counts[r.node_id] = counts.get(r.node_id, 0) + 1
            return sorted(counts.items(), key=lambda kv: -kv[1])

    def hot_nodes(self, limit: int = 10) -> List[Tuple[str, float]]:
        """Highest access-velocity nodes."""
        with self._lock:
            ranked = sorted(
                ((nid, st.velocity) for nid, st in self._stats.items()),
                key=lambda kv: -kv[1],
            )
            return ranked[:limit]


# -- pattern detection ----------------------------------------------------


@dataclass
class DetectedPattern:
    """One detected access pattern (reference: pattern_detector.go:39-59;
    types none/daily/weekly/burst/decaying/growing)."""

    type: str
    confidence: float
    peak_hour: Optional[int] = None
    peak_day: Optional[int] = None


class PatternDetector:
    """Periodic/burst/trend pattern detection over per-node access
    histograms (reference: pkg/temporal/pattern_detector.go:99-392).

    Daily/weekly periodicity is judged by concentration of accesses in
    hour-of-day / day-of-week histograms; bursts by the share of recent
    accesses in a short trailing window; growing/decaying by the
    Kalman-filtered access velocity."""

    def __init__(self, min_accesses: int = 6, history_limit: int = 512,
                 daily_threshold: float = 0.35, weekly_threshold: float = 0.4,
                 burst_window_s: float = 3600.0, burst_share: float = 0.5,
                 trend_velocity: float = 0.01):
        self.min_accesses = min_accesses
        self.history_limit = history_limit
        self.daily_threshold = daily_threshold
        self.weekly_threshold = weekly_threshold
        self.burst_window_s = burst_window_s
        self.burst_share = burst_share
        self.trend_velocity = trend_velocity
        self._times: Dict[str, Deque[float]] = {}
        self._lock = threading.Lock()

    def record_access(self, node_id: str, at: Optional[float] = None) -> None:
        at = time.time() if at is None else at
        with self._lock:
            dq = self._times.get(node_id)
            if dq is None:
                dq = deque(maxlen=self.history_limit)
                self._times[node_id] = dq
            dq.append(at)

    def detect_patterns(self, node_id: str,
                        velocity: float = 0.0,
                        now: Optional[float] = None) -> List[DetectedPattern]:
        now = time.time() if now is None else now
        with self._lock:
            times = list(self._times.get(node_id, ()))
        out: List[DetectedPattern] = []
        if len(times) >= self.min_accesses:
            hours = [int((t % 86400) // 3600) for t in times]
            hour_hist = [0] * 24
            for h in hours:
                hour_hist[h] += 1
            # concentration in the best 3 contiguous hours; the reported
            # peak is the histogram argmax (a window tie would otherwise
            # shift the center off the true peak hour)
            best3 = 0
            for h in range(24):
                c = sum(hour_hist[(h + i) % 24] for i in range(3))
                if c > best3:
                    best3 = c
            peak_hour = hour_hist.index(max(hour_hist))
            daily_conc = best3 / len(times)
            # require spread over >= 3 distinct days, else "daily" is
            # just one busy afternoon
            days_spanned = (max(times) - min(times)) / 86400.0
            if daily_conc >= self.daily_threshold and days_spanned >= 2.0:
                out.append(DetectedPattern(
                    "daily", confidence=round(min(daily_conc, 1.0), 3),
                    peak_hour=peak_hour))
            dows = [int((t // 86400 + 4) % 7) for t in times]  # epoch day 0 = Thu
            dow_hist = [0] * 7
            for d in dows:
                dow_hist[d] += 1
            weekly_conc = max(dow_hist) / len(times)
            if weekly_conc >= self.weekly_threshold and days_spanned >= 13.0:
                out.append(DetectedPattern(
                    "weekly", confidence=round(min(weekly_conc, 1.0), 3),
                    peak_day=int(dow_hist.index(max(dow_hist)))))
            recent = sum(1 for t in times if now - t <= self.burst_window_s)
            if recent >= self.min_accesses and (
                recent / len(times) >= self.burst_share
            ):
                out.append(DetectedPattern(
                    "burst", confidence=round(recent / len(times), 3)))
        if velocity > self.trend_velocity:
            out.append(DetectedPattern(
                "growing", confidence=min(1.0, velocity / (10 * self.trend_velocity))))
        elif velocity < -self.trend_velocity:
            out.append(DetectedPattern(
                "decaying", confidence=min(1.0, -velocity / (10 * self.trend_velocity))))
        return out

    def has_pattern(self, node_id: str, pattern_type: str,
                    velocity: float = 0.0) -> bool:
        return any(p.type == pattern_type
                   for p in self.detect_patterns(node_id, velocity))

    def peak_access_time(self, node_id: str) -> Tuple[int, int, float]:
        """(hour, day_of_week, confidence) of the busiest slot
        (reference: GetPeakAccessTime pattern_detector.go:344)."""
        with self._lock:
            times = list(self._times.get(node_id, ()))
        if not times:
            return 0, 0, 0.0
        hour_hist = [0] * 24
        dow_hist = [0] * 7
        for t in times:
            hour_hist[int((t % 86400) // 3600)] += 1
            dow_hist[int((t // 86400 + 4) % 7)] += 1
        hour = hour_hist.index(max(hour_hist))
        day = dow_hist.index(max(dow_hist))
        conf = (max(hour_hist) / len(times) + max(dow_hist) / len(times)) / 2
        return hour, day, round(conf, 3)

    def reset_node(self, node_id: str) -> None:
        with self._lock:
            self._times.pop(node_id, None)

    def reset(self) -> None:
        with self._lock:
            self._times.clear()


# -- relationship evolution -----------------------------------------------


@dataclass
class RelationshipTrend:
    """(reference: relationship_evolution.go:78-100)"""

    source_id: str
    target_id: str
    current_strength: float
    velocity: float
    predicted_strength: float  # 5 steps ahead
    trend: str  # strengthening | weakening | stable


class RelationshipEvolution:
    """Kalman-filtered edge strength tracking (reference:
    pkg/temporal/relationship_evolution.go:145-430). Each co-access
    bumps an edge's strength measurement; the velocity filter smooths it
    and exposes whether the relationship is strengthening, weakening,
    emerging, or prunable."""

    def __init__(self, strengthen_threshold: float = 0.01,
                 weaken_threshold: float = -0.01,
                 emerging_max_age_s: float = 7 * 86400.0,
                 decay_per_day: float = 0.02,
                 max_edges: int = 50_000):
        self.strengthen_threshold = strengthen_threshold
        self.weaken_threshold = weaken_threshold
        self.emerging_max_age_s = emerging_max_age_s
        self.decay_per_day = decay_per_day
        self.max_edges = max_edges
        self._edges: Dict[Tuple[str, str], Dict] = {}
        self._lock = threading.Lock()

    def _evict_locked(self) -> None:
        """Bound per-pair state: on overflow drop the least-recently
        bumped 10% (the tracker feeds this from the access hot path, so
        unbounded growth would be O(accessed-pairs) memory)."""
        if len(self._edges) < self.max_edges:
            return
        by_age = sorted(self._edges.items(), key=lambda kv: kv[1]["last_at"])
        for k, _ in by_age[: max(1, self.max_edges // 10)]:
            del self._edges[k]

    @staticmethod
    def _key(a: str, b: str) -> Tuple[str, str]:
        return (a, b) if a <= b else (b, a)

    def record_co_access(self, source_id: str, target_id: str,
                         weight: float = 1.0,
                         at: Optional[float] = None) -> None:
        at = time.time() if at is None else at
        key = self._key(source_id, target_id)
        with self._lock:
            tr = self._edges.get(key)
            if tr is None:
                self._evict_locked()
                tr = {"filter": VelocityKalmanFilter(), "raw": 0.0,
                      "first_at": at, "last_at": at}
                self._edges[key] = tr
            # decay the raw strength for the silence since last access
            silent_days = max(0.0, (at - tr["last_at"]) / 86400.0)
            tr["raw"] = max(0.0, tr["raw"] - self.decay_per_day * silent_days)
            tr["raw"] += weight
            tr["last_at"] = at
            tr["filter"].update(tr["raw"], at)

    def update_weight(self, source_id: str, target_id: str,
                      new_weight: float, at: Optional[float] = None) -> None:
        at = time.time() if at is None else at
        key = self._key(source_id, target_id)
        with self._lock:
            tr = self._edges.get(key)
            if tr is None:
                self._evict_locked()
                tr = {"filter": VelocityKalmanFilter(), "raw": new_weight,
                      "first_at": at, "last_at": at}
                self._edges[key] = tr
            tr["raw"] = new_weight
            tr["last_at"] = at
            tr["filter"].update(new_weight, at)

    def _trend_locked(self, key: Tuple[str, str]) -> Optional[RelationshipTrend]:
        tr = self._edges.get(key)
        if tr is None:
            return None
        f = tr["filter"]
        vel = f.vel
        if vel > self.strengthen_threshold:
            label = "strengthening"
        elif vel < self.weaken_threshold:
            label = "weakening"
        else:
            label = "stable"
        return RelationshipTrend(
            source_id=key[0], target_id=key[1],
            current_strength=round(f.pos, 6), velocity=round(vel, 6),
            predicted_strength=round(max(0.0, f.pos + 5 * vel), 6),
            trend=label,
        )

    def get_trend(self, source_id: str, target_id: str) -> Optional[RelationshipTrend]:
        with self._lock:
            return self._trend_locked(self._key(source_id, target_id))

    def predict_strength(self, source_id: str, target_id: str,
                         steps: int = 5) -> float:
        with self._lock:
            tr = self._edges.get(self._key(source_id, target_id))
            if tr is None:
                return 0.0
            f = tr["filter"]
            return max(0.0, f.pos + steps * f.vel)

    def _ranked(self, predicate) -> List[RelationshipTrend]:
        with self._lock:
            trends = [self._trend_locked(k) for k in self._edges]
        return [t for t in trends if t is not None and predicate(t)]

    def strengthening(self, limit: int = 10) -> List[RelationshipTrend]:
        out = self._ranked(lambda t: t.trend == "strengthening")
        out.sort(key=lambda t: -t.velocity)
        return out[:limit]

    def weakening(self, limit: int = 10) -> List[RelationshipTrend]:
        out = self._ranked(lambda t: t.trend == "weakening")
        out.sort(key=lambda t: t.velocity)
        return out[:limit]

    def emerging(self, limit: int = 10,
                 now: Optional[float] = None) -> List[RelationshipTrend]:
        """Young relationships that are strengthening
        (reference: GetEmergingRelationships :368)."""
        now = time.time() if now is None else now
        with self._lock:
            young = [
                k for k, tr in self._edges.items()
                if now - tr["first_at"] <= self.emerging_max_age_s
            ]
            trends = [self._trend_locked(k) for k in young]
        out = [t for t in trends if t is not None and t.velocity > 0]
        out.sort(key=lambda t: -t.velocity)
        return out[:limit]

    def should_prune(self, source_id: str, target_id: str,
                     threshold: float = 0.1) -> bool:
        with self._lock:
            tr = self._edges.get(self._key(source_id, target_id))
            if tr is None:
                return True
            f = tr["filter"]
        return f.pos < threshold and f.vel <= 0
