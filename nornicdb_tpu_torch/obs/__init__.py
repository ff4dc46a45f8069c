"""Unified telemetry for the port's serving stack (a copy of
``nornicdb_tpu/obs/__init__.py`` but for the audit, SLO and fleet
layers, which come with admission).

Dependency-free counters/gauges/histograms with real Prometheus
exposition, contextvar span tracing with a slow-request ring buffer,
and the device-dispatch bucket instrument. Every hot layer records into
the process-wide ``REGISTRY``/``TRACES``.

``obs/resources.py`` derives per-index device-memory and freshness-lag
gauges on scrape from weakly registered index/queue objects;
``obs/stages.py`` attributes each request's latency to serving stages
(queue wait vs device compute); ``obs/cost.py`` prices every device
dispatch in FLOPs/bytes per query; ``obs/tenant.py`` splits them per
tenant; ``obs/events.py`` journals incidents; ``obs/device.py``
calibrates the cost model against measured dispatch seconds and
reconciles the resources' device bytes against the CUDA allocator.

Overhead discipline: a record call is a branch + dict probe + striped
add (counters) or bisect + locked bucket increment (histograms); spans
allocate one small object each; resource work happens only at scrape
time. ``set_enabled(False)`` no-ops the whole layer —
tests/test_torch_obs.py pins the instrumented:bare ratio.
"""

from nornicdb_tpu_torch.obs.dispatch import (
    compile_universe,
    declare_kind,
    record_dispatch,
)
from nornicdb_tpu_torch.obs.metrics import (
    LATENCY_BUCKETS,
    REGISTRY,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    enabled,
    exemplars_enabled,
    get_registry,
    latency_summary,
    set_enabled,
    set_exemplars_enabled,
)
from nornicdb_tpu_torch.obs import cost  # noqa: F401 — registers cost counters
from nornicdb_tpu_torch.obs import device  # noqa: F401 — registers calibration
from nornicdb_tpu_torch.obs import events  # noqa: F401 — registers event counter
from nornicdb_tpu_torch.obs import resources  # noqa: F401 — registers collector
from nornicdb_tpu_torch.obs import stages  # noqa: F401 — registers stage family
from nornicdb_tpu_torch.obs import tenant  # noqa: F401 — registers tenant families
from nornicdb_tpu_torch.obs.cost import cost_summary, record_query_cost
from nornicdb_tpu_torch.obs.device import (
    calibration_summary,
    device_summary,
    predict_ms,
)
from nornicdb_tpu_torch.obs.events import (
    event_snapshot,
    event_summary,
    record_event,
)
from nornicdb_tpu_torch.obs.resources import register as register_resource
from nornicdb_tpu_torch.obs.resources import snapshot as resource_snapshot
from nornicdb_tpu_torch.obs.stages import record_stage, stage_summary
from nornicdb_tpu_torch.obs.tenant import (
    TENANT_HEADER,
    current_tenant,
    tenant_scope,
    tenants_summary,
)
from nornicdb_tpu_torch.obs.tracing import (
    TRACE_HEADER,
    TRACES,
    Span,
    TraceBuffer,
    annotate,
    attach_span,
    attach_span_tree,
    current_span,
    current_trace_id,
    export_span,
    pack_context,
    propagated_trace,
    span,
    trace,
    trace_context,
    unpack_context,
)

__all__ = [
    "LATENCY_BUCKETS",
    "REGISTRY",
    "SIZE_BUCKETS",
    "TRACE_HEADER",
    "TRACES",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "TraceBuffer",
    "annotate",
    "attach_span",
    "attach_span_tree",
    "calibration_summary",
    "compile_universe",
    "cost",
    "cost_summary",
    "device",
    "device_summary",
    "predict_ms",
    "current_span",
    "current_trace_id",
    "enabled",
    "event_snapshot",
    "event_summary",
    "events",
    "exemplars_enabled",
    "export_span",
    "get_registry",
    "latency_summary",
    "pack_context",
    "propagated_trace",
    "record_dispatch",
    "record_event",
    "record_query_cost",
    "record_stage",
    "register_resource",
    "resource_snapshot",
    "resources",
    "set_enabled",
    "set_exemplars_enabled",
    "span",
    "stage_summary",
    "stages",
    "TENANT_HEADER",
    "current_tenant",
    "tenant",
    "tenant_scope",
    "tenants_summary",
    "trace",
    "trace_context",
    "unpack_context",
]
