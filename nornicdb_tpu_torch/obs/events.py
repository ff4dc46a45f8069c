"""Unified incident timeline: one causally-ordered event journal.

Incidents on a serving fleet — tier degrades, replica
drains/re-admissions, failovers, quarantine step-downs, SLO breaches —
were scattered across per-concern ledgers (the degrade ring, the
router's drain state, failover counters, flight-recorder files) with
no single stream an operator could replay to answer "what happened, in
what order". This module is that stream: a bounded ring of structured
event records, each stamped with a process-monotone sequence number
(assigned under the ring lock, so journal order IS observation order)
and linked to the originating request's trace id when one is active —
including trace ids PROPAGATED across the broker ring or an HTTP hop
(obs/tracing.py), so a degrade on the device plane joins the wire
worker's trace in the timeline.

Served at ``GET /admin/events`` (api/http_server.py), merged across
worker/plane processes by the worker's own ``/admin/events`` route
(api/wire_plane.py), and included in every SLO flight-recorder dump
(``kind: events``).

Producers (wired in this PR):

- ``degrade`` — every :func:`obs.audit.record_degrade` (and broker
  replays, marked ``via: broker``);
- ``drain`` / ``admit`` — fleet-router rotation transitions
  (api/fleet_router.py records the transition, never the steady state);
- ``failover`` — a replica promoted to primary
  (replication/read_fleet.py);
- ``fence_rejected`` — a replica refused a stale-epoch WAL batch;
- ``quarantine`` / ``quarantine_lift`` — the shadow-parity auditor
  stepping a tier down / recovering it (obs/audit.py);
- ``slo_breach`` — a breach-triggered flight-recorder dump
  (obs/slo.py).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.obs import metrics as _m
from nornicdb_tpu_torch.obs.metrics import REGISTRY
from nornicdb_tpu_torch.obs.tracing import current_trace_id

# tenant stamping: obs/tenant.py registers its resolver so
# every journal event carries the active request's tenant — this
# module stays importable without the tenant layer.
_tenant_provider = None


def set_tenant_provider(fn) -> None:
    global _tenant_provider
    _tenant_provider = fn

# the documented event-kind vocabulary — scripts/check_metrics_catalog
# lints each value against docs/observability.md (tier/reason
# precedent)
KINDS: Tuple[str, ...] = (
    "degrade",          # a serving ladder step-down (the degrade ledger)
    "drain",            # a replica left the read rotation
    "admit",            # a replica (re)joined the read rotation
    "failover",         # a standby promoted to primary
    "fence_rejected",   # a stale-epoch stream batch was refused
    "quarantine",       # the parity auditor stepped a tier down
    "quarantine_lift",  # the quarantined tier recovered
    "slo_breach",       # a breach-triggered flight-recorder dump
    "shed",             # admission rejected a query (429/exhausted)
                        # or failed it fast past its deadline budget
    "posture",          # the admission posture transitioned
    "lease_grant",      # a replica at the primary watermark was leased
                        # for read-your-writes routing
    "lease_lapse",      # a leader lease expired or was revoked
    "noisy_neighbor",   # one tenant held over the cost-share threshold
                        # of the rolling window while posture >= degrade
                        # (advisory — no actuation)
    "recompile",        # a compile observed after the dispatch kind was
                        # warm: bucket churn at serve time
)

_EVENTS_C = REGISTRY.counter(
    "nornicdb_events_total",
    "Incident-timeline events recorded, by kind",
    labels=("kind",))


def _ring_capacity() -> int:
    try:
        return max(16, int(os.environ.get("NORNICDB_EVENT_RING", "1024")))
    except ValueError:
        return 1024


class EventJournal:
    """Bounded, monotonically-ordered ring of incident events.

    ``record`` assigns the sequence number and appends under ONE lock,
    so two racing producers can never interleave seq order vs ring
    order — the stream replays causally even under 16-thread churn
    (pinned by tests/test_fleet_truth.py). Records are plain dicts,
    fully JSON-able."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self.capacity = capacity or _ring_capacity()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.recorded = 0

    def record(self, kind: str, node: str = "", surface: str = "",
               reason: str = "", detail: Optional[Dict[str, Any]] = None,
               trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Append one event. ``trace_id`` defaults to the active trace
        (including one propagated across a process boundary); ``seq``
        is assigned under the ring lock. Never raises, never blocks
        beyond the one short lock hold."""
        if trace_id is None:
            trace_id = current_trace_id()
        rec: Dict[str, Any] = {
            "ts": round(time.time(), 6),
            "kind": str(kind),
        }
        if node:
            rec["node"] = str(node)
        if surface:
            rec["surface"] = str(surface)
        if reason:
            rec["reason"] = str(reason)
        if trace_id:
            rec["trace_id"] = str(trace_id)
        if _tenant_provider is not None:
            tenant = _tenant_provider()
            if tenant:
                rec["tenant"] = str(tenant)
        if detail:
            rec["detail"] = dict(detail)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            self.recorded += 1
        if _m.enabled():
            _EVENTS_C.labels(rec["kind"]).inc()
        return rec

    def snapshot(self, limit: int = 100,
                 kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """The most recent ``limit`` events in STREAM order (ascending
        seq — the timeline reads top-to-bottom), optionally filtered by
        kind."""
        with self._lock:
            items = list(self._ring)
        if kind is not None:
            items = [r for r in items if r["kind"] == kind]
        return items[-max(0, limit):]

    def by_kind(self) -> Dict[str, int]:
        with self._lock:
            items = list(self._ring)
        out: Dict[str, int] = {}
        for rec in items:
            out[rec["kind"]] = out.get(rec["kind"], 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


JOURNAL = EventJournal()


def record_event(kind: str, node: str = "", surface: str = "",
                 reason: str = "", detail: Optional[Dict[str, Any]] = None,
                 trace_id: Optional[str] = None) -> None:
    """Module-level convenience over the process journal; a disabled
    telemetry layer records nothing."""
    if not _m.enabled():
        return
    JOURNAL.record(kind, node=node, surface=surface, reason=reason,
                   detail=detail, trace_id=trace_id)


def event_snapshot(limit: int = 100,
                   kind: Optional[str] = None) -> List[Dict[str, Any]]:
    return JOURNAL.snapshot(limit=limit, kind=kind)


def event_summary() -> Dict[str, Any]:
    """The ``/admin/events`` envelope (the caller appends the ring)."""
    return {
        "recorded": JOURNAL.recorded,
        "capacity": JOURNAL.capacity,
        "by_kind": JOURNAL.by_kind(),
    }
