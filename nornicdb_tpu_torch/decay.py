"""Tiered memory decay (counterpart of ``nornicdb_tpu/decay.py``).

Reference: pkg/decay — tiers with half-lives EPISODIC 7d / SEMANTIC 69d /
PROCEDURAL 693d (decay.go:77 Tier, :977 HalfLife), score =
recency x frequency x importance weights (:329 Manager), promotion between
tiers, archive threshold, Kalman-smoothed scores (kalman_adapter.go).
Wired into the DB at open (reference db.go:1011-1028). The reference runs
the host sweep on its background admission lane; the port has no
admission lanes yet (ROADMAP §A12), so the sweep runs on the caller's
thread.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nornicdb_tpu_torch.filters import KalmanFilter
from nornicdb_tpu_torch.storage.types import Engine, Node, now_ms

DAY_MS = 86_400_000


class Tier:
    EPISODIC = "EPISODIC"
    SEMANTIC = "SEMANTIC"
    PROCEDURAL = "PROCEDURAL"


HALF_LIFE_MS = {
    Tier.EPISODIC: 7 * DAY_MS,
    Tier.SEMANTIC: 69 * DAY_MS,
    Tier.PROCEDURAL: 693 * DAY_MS,
}

# promotion: access count thresholds to climb tiers (reference promotion)
PROMOTE_ACCESSES = {Tier.EPISODIC: 5, Tier.SEMANTIC: 25}


@dataclass
class DecayScore:
    node_id: str
    score: float
    recency: float
    frequency: float
    importance: float
    tier: str


@dataclass
class _NodeState:
    tier: str = Tier.EPISODIC
    access_count: int = 0
    last_access_ms: int = 0
    kalman: KalmanFilter = field(default_factory=lambda: KalmanFilter())


class DecayManager:
    """Computes decay scores and archives below-threshold memories."""

    def __init__(
        self,
        storage: Engine,
        recency_weight: float = 0.5,
        frequency_weight: float = 0.3,
        importance_weight: float = 0.2,
        archive_threshold: float = 0.05,
        use_kalman: bool = True,
        half_life_ms: Optional[Dict[str, int]] = None,
    ):
        self.storage = storage
        self.w_recency = recency_weight
        self.w_frequency = frequency_weight
        self.w_importance = importance_weight
        self.archive_threshold = archive_threshold
        self.use_kalman = use_kalman
        self.half_life_ms = dict(half_life_ms or HALF_LIFE_MS)
        self._state: Dict[str, _NodeState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # a BackgroundDevicePlane attaches itself here; when present,
        # sweep() runs as ONE device pass (the host loop serves the
        # plane's named step-downs)
        self.device_plane = None

    # -- access tracking ---------------------------------------------------

    def record_access(self, node_id: str, at_ms: Optional[int] = None) -> None:
        at = at_ms if at_ms is not None else now_ms()
        with self._lock:
            st = self._state.setdefault(node_id, _NodeState())
            st.access_count += 1
            st.last_access_ms = at
            self._maybe_promote(st)

    def _maybe_promote(self, st: _NodeState) -> None:
        """Frequently-accessed memories climb tiers (longer half-lives)."""
        if st.tier == Tier.EPISODIC and st.access_count >= PROMOTE_ACCESSES[Tier.EPISODIC]:
            st.tier = Tier.SEMANTIC
        elif st.tier == Tier.SEMANTIC and st.access_count >= PROMOTE_ACCESSES[Tier.SEMANTIC]:
            st.tier = Tier.PROCEDURAL

    def tier_of(self, node_id: str) -> str:
        with self._lock:
            return self._state.get(node_id, _NodeState()).tier

    # -- scoring -----------------------------------------------------------

    def score(self, node: Node, now: Optional[int] = None) -> DecayScore:
        now = now if now is not None else now_ms()
        with self._lock:
            st = self._state.setdefault(node.id, _NodeState())
            last = st.last_access_ms or node.updated_at or node.created_at or now
            age_ms = max(now - last, 0)
            half_life = self.half_life_ms[st.tier]
            recency = math.pow(0.5, age_ms / half_life)
            frequency = 1.0 - math.exp(-st.access_count / 10.0)
            try:
                importance = float(node.properties.get("importance", 0.5))
            except (TypeError, ValueError):
                importance = 0.5  # non-numeric importance must not abort sweeps
            importance = min(max(importance, 0.0), 1.0)
            raw = (
                self.w_recency * recency
                + self.w_frequency * frequency
                + self.w_importance * importance
            )
            if self.use_kalman:
                raw = st.kalman.update(raw)
            return DecayScore(
                node_id=node.id, score=raw, recency=recency,
                frequency=frequency, importance=importance, tier=st.tier,
            )

    def scores(self, now: Optional[int] = None) -> List[DecayScore]:
        return [self.score(n, now) for n in self.storage.all_nodes()]

    # -- archive sweep -------------------------------------------------------

    def sweep(self, now: Optional[int] = None) -> Tuple[int, int]:
        """Mark below-threshold nodes archived (property flag — the
        reference archives rather than deletes). Returns (scored, archived).

        With a device plane attached the sweep is one vectorized
        score-and-verdict pass; the plane returns None only at its named
        step-downs (mode off, a write during the dispatch), and then the
        host loop below serves — verdict parity is the plane's contract."""
        plane = self.device_plane
        if plane is not None:
            res = plane.decay_sweep(now)
            if res is not None:
                return res
        return self._sweep_background(now)

    def _sweep_background(self, now: Optional[int]) -> Tuple[int, int]:
        scored = archived = 0
        for node in self.storage.all_nodes():
            s = self.score(node, now)
            scored += 1
            if s.score < self.archive_threshold and not node.properties.get("_archived"):
                node.properties["_archived"] = True
                node.properties["_archived_at"] = now or now_ms()
                try:
                    self.storage.update_node(node)
                    archived += 1
                except KeyError:
                    pass
        return scored, archived

    def half_life(self, tier: str) -> int:
        """Reference: HalfLife (decay.go:977)."""
        return self.half_life_ms[tier]

    def stop(self) -> None:
        self._stop.set()
