"""Device-dispatch instrumentation: the dispatch-bucket universe, observed
(a copy of ``nornicdb_tpu/obs/dispatch.py``).

Every batched device dispatch is recorded by (kind, B, k), B and k the
power-of-two buckets (``microbatch.pow2_bucket``) the reference pads to.
The FIRST call at a bucket is counted as its "compile" and later calls as
steady-state dispatches; ``/metrics`` exposes the universe as labeled
series, and new buckets at serve time show as compile-counter growth.

In the port there is no XLA compile: the first call of a (kind, b, k)
bucket carries the kernel library's load at first use (``ops/_build.py``
builds and loads each kernel once per process) and the caching
allocator's growth for the bucket's buffers. The family names stay the
reference's (``nornicdb_device_compile_total``,
``nornicdb_device_first_call_seconds``) so dashboards read both.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.obs import metrics as _m
from nornicdb_tpu_torch.obs.metrics import REGISTRY

_lock = threading.Lock()
# the device-truth calibration plane (obs/device.py)
# registers itself here; every recorded dispatch is forwarded. Held as
# a module global (not an import) so this module stays importable
# first in the obs package.
_observer: Optional[Callable[[str, int, int, float, bool], None]] = None
# (kind, b, k) -> {"dispatches": int, "first_call_s": float,
#                  "total_s": float}
_shapes: Dict[Tuple[str, int, int], Dict[str, Any]] = {}
# kinds announced by their owning module at import — the compile-cache
# accounting carries these series from process start (a dashboard can
# tell "tier exists, zero traffic" from "tier doesn't exist")
_declared: set = set()

_DISPATCH_C = REGISTRY.counter(
    "nornicdb_device_dispatch_total",
    "Batched device dispatches by compile bucket",
    labels=("kind", "b", "k"))
_COMPILE_C = REGISTRY.counter(
    "nornicdb_device_compile_total",
    "First-touch compiles by dispatch kind", labels=("kind",))
_LATENCY_H = REGISTRY.histogram(
    "nornicdb_device_dispatch_seconds",
    "Device dispatch wall time (first call includes compile)",
    labels=("kind",))
_FIRST_G = REGISTRY.gauge(
    "nornicdb_device_first_call_seconds",
    "Wall time of the first call per bucket: compile AND execute "
    "conflated (the calibrated split is nornicdb_device_compile_seconds)",
    labels=("kind", "b", "k"))


def set_observer(
        fn: Optional[Callable[[str, int, int, float, bool], None]]) -> None:
    """Register the per-dispatch observer (obs/device.py): called as
    ``fn(kind, b, k, seconds, first)`` after this module's own
    recording, outside its lock."""
    global _observer
    _observer = fn


def declare_kind(kind: str) -> None:
    """Pre-register a dispatch kind in the compile universe. The shape
    table still fills lazily on first dispatch; declaring only seeds
    ``bucket_counts`` (-> ``nornicdb_compile_cache_entries{kind=...}``)
    with a zero entry so the series exists before first traffic."""
    with _lock:
        _declared.add(kind)


def record_dispatch(kind: str, b: int, k: int, seconds: float) -> None:
    """Record one batched device call at pow2-bucketed shape (b, k)."""
    if not _m.enabled():
        return
    key = (kind, int(b), int(k))
    first = False
    with _lock:
        entry = _shapes.get(key)
        if entry is None:
            first = True
            entry = {"dispatches": 0, "first_call_s": seconds,
                     "total_s": 0.0}
            _shapes[key] = entry
        entry["dispatches"] += 1
        entry["total_s"] += seconds
    _DISPATCH_C.labels(kind, b, k).inc()
    _LATENCY_H.labels(kind).observe(seconds)
    if first:
        _COMPILE_C.labels(kind).inc()
        _FIRST_G.labels(kind, b, k).set(seconds)
    obs_fn = _observer
    if obs_fn is not None:
        obs_fn(kind, int(b), int(k), seconds, first)


def compile_universe() -> List[Dict[str, Any]]:
    """Every (kind, B, k) shape seen since process start — the admin
    view of how many distinct dispatch buckets serving has paid for."""
    with _lock:
        items = sorted(_shapes.items())
    return [
        {"kind": kind, "b": b, "k": k,
         "dispatches": e["dispatches"],
         "first_call_ms": round(e["first_call_s"] * 1e3, 3),
         "mean_ms": round(e["total_s"] / max(e["dispatches"], 1) * 1e3, 4)}
        for (kind, b, k), e in items
    ]


def bucket_counts() -> Dict[str, int]:
    """Distinct compiled (B, k) buckets per dispatch kind — the size of
    each compile cache. The resource accounting layer exposes this as
    ``nornicdb_compile_cache_entries{kind=...}``; growth at serve time
    is the bucket-churn signal the sentinel gates on."""
    with _lock:
        out: Dict[str, int] = {kind: 0 for kind in sorted(_declared)}
        for (kind, _b, _k) in _shapes:
            out[kind] = out.get(kind, 0) + 1
    return out


def reset() -> None:
    """Test helper: forget the shape universe (registry counters keep
    their monotone totals)."""
    with _lock:
        _shapes.clear()
