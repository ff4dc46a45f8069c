"""Per-request stage attribution: where did the latency actually go?

The surface latency histograms record ONE end-to-end number per
request; a p99 spike there cannot say whether the request was slow
because it *queued* (coalesce wait behind a busy batch leader) or
because it *computed* (device dispatch). This module splits every
request into the stages the serving path already times:

- ``parse`` — wire bytes -> request message (protobuf ``FromString``,
  HTTP ``json.loads``);
- ``coalesce_wait`` — enqueue into a MicroBatcher/BatchCoalescer until
  the batch leader sealed our batch (the QUEUE-DELAY component);
- ``device_dispatch`` — the shared batched device call (each rider
  attributes the full interval: that is the latency it experienced);
- ``merge`` — post-dispatch truncation/result delivery;
- ``apply`` — a write convoy's merged storage apply;
- ``serialize`` — response message -> wire bytes.

Each lands in ``nornicdb_request_stage_seconds{surface,stage}``
(surface is a bounded, code-chosen name: ``grpc``, ``http``,
``service:vector``, ``service:hybrid``, ``qdrant``,
``qdrant:upsert_convoy``) and the same intervals already ride each
request's trace as spans, so one slow trace and the fleet-wide
histogram tell the same story.

``stage_summary()`` derives the QUEUEING FRACTION per surface —
coalesce-wait seconds over total attributed seconds — the single
number that answers "slow because queued or slow because compute".
Served in ``/admin/telemetry`` (``stages``) and in every SLO
flight-recorder dump.
"""

from __future__ import annotations

from typing import Dict, Optional

from nornicdb_tpu_torch.obs import metrics as _m
from nornicdb_tpu_torch.obs.metrics import LATENCY_BUCKETS, REGISTRY, Registry

# canonical stage names (call sites may add new ones; the catalog in
# docs/observability.md documents the family, not each stage value)
STAGE_PARSE = "parse"
STAGE_COALESCE_WAIT = "coalesce_wait"
STAGE_DISPATCH = "device_dispatch"
STAGE_MERGE = "merge"
STAGE_APPLY = "apply"
STAGE_SERIALIZE = "serialize"

# queue-delay stages for the queueing-fraction rollup
_QUEUE_STAGES = (STAGE_COALESCE_WAIT,)

_STAGE_H = REGISTRY.histogram(
    "nornicdb_request_stage_seconds",
    "Per-request latency attribution by serving stage",
    labels=("surface", "stage"), buckets=LATENCY_BUCKETS)


def record_stage(surface: str, stage: str, seconds: float) -> None:
    """One stage interval of one request. Negative intervals (clock
    skew between the enqueue stamp and a leader stamp) clamp to 0."""
    if not _m.enabled():
        return
    _STAGE_H.labels(surface, stage).observe(
        seconds if seconds > 0.0 else 0.0)


def stage_summary(registry: Optional[Registry] = None) -> Dict[str, Dict]:
    """Per-surface stage decomposition from the stage histograms:

    ``{surface: {"stages": {stage: {"count", "total_ms", "mean_ms"}},
                 "queueing_fraction": wait_s / total_s | None}}``

    Scrape-time work only — reads histogram sums, never the hot path.
    """
    reg = registry if registry is not None else REGISTRY
    fam = reg.get("nornicdb_request_stage_seconds")
    out: Dict[str, Dict] = {}
    if fam is None:
        return out
    for key, child in sorted(fam.children().items()):
        surface, stage = key
        snap = child.snapshot()
        if not snap["count"]:
            continue
        doc = out.setdefault(
            surface, {"stages": {}, "queueing_fraction": None})
        doc["stages"][stage] = {
            "count": snap["count"],
            "total_ms": round(snap["sum"] * 1e3, 3),
            "mean_ms": round(snap["sum"] / snap["count"] * 1e3, 4),
        }
    for doc in out.values():
        total = sum(s["total_ms"] for s in doc["stages"].values())
        if total > 0:
            waited = sum(doc["stages"][s]["total_ms"]
                         for s in _QUEUE_STAGES if s in doc["stages"])
            doc["queueing_fraction"] = round(waited / total, 4)
    return out
