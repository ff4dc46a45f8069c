"""Contextvar span tracing + slow-request ring buffer.

One request = one root :class:`Span`; layers underneath open child
spans (``span("coalesce.wait")``) or graft already-timed intervals
(``attach_span`` — the MicroBatcher leader times the device dispatch
once and every rider of that batch grafts the same interval into its
own trace). The current span rides a ``contextvars.ContextVar``, so it
crosses the grpc.aio event-loop -> executor-thread boundary whenever
the caller runs the work under ``contextvars.copy_context()`` (the aio
wire layer does).

Completed root spans land in the process-wide :class:`TraceBuffer` — a
bounded ring holding the most recent requests slower than
``NORNICDB_OBS_SLOW_MS`` (default 0: every request qualifies, the ring
bound keeps memory flat). The HTTP admin surface exposes it at
``/admin/traces``.

Cross-process propagation: a trace minted in a wire worker
must not die at the shared-memory ring or an HTTP hop to a replica.
:func:`trace_context` captures the active trace as a compact dict,
:func:`pack_context`/:func:`unpack_context` move it over a wire seam
(a few bytes in a broker slot header, or the ``X-Nornic-Trace`` HTTP
header), and :func:`propagated_trace` opens a root span on the REMOTE
side bound to the propagated trace id instead of minting a new one —
so degrade records, exemplars and ring entries produced over there
join the originating request's trace. The remote side exports its
span tree (:func:`export_span`) in the response and the originating
side grafts it (:func:`attach_span_tree`) into the live root, so
``/admin/traces`` on the ingress worker shows the full
wire -> ring -> coalesce -> device.dispatch -> merge chain.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

from nornicdb_tpu_torch.obs import metrics as _m

# trace-id generation: a per-process random prefix + monotone counter.
# Cheaper than uuid4 on the hot path (every request mints one) and
# unique across processes with overwhelming probability — the id only
# needs to join a /metrics exemplar to a ring entry on the same node.
_TRACE_PREFIX = os.urandom(4).hex()
_trace_seq = itertools.count(1)


def _new_trace_id() -> str:
    return f"{_TRACE_PREFIX}{next(_trace_seq):08x}"


class Span:
    __slots__ = ("name", "t0", "t1", "attrs", "children", "trace_id")

    def __init__(self, name: str, t0: Optional[float] = None,
                 **attrs: Any) -> None:
        self.name = name
        self.t0 = time.time() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs
        self.children: List["Span"] = []
        # set on ROOT spans only (trace()); None on children
        self.trace_id: Optional[str] = None

    def finish(self, t1: Optional[float] = None) -> None:
        self.t1 = time.time() if t1 is None else t1

    @property
    def duration_ms(self) -> float:
        end = self.t1 if self.t1 is not None else time.time()
        return (end - self.t0) * 1e3

    def annotate(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def to_dict(self) -> Dict[str, Any]:
        doc = {
            "name": self.name,
            "start_ms": round(self.t0 * 1e3, 3),
            "duration_ms": round(self.duration_ms, 3),
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }
        if self.trace_id is not None:
            doc["trace_id"] = self.trace_id
        return doc

    def span_names(self) -> List[str]:
        """Flattened names, depth-first — test/diagnostic helper."""
        out = [self.name]
        for c in self.children:
            out.extend(c.span_names())
        return out


_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "nornicdb_obs_span", default=None)
# the ROOT span's trace id, visible to every layer under it (exemplar
# tagging reads this on histogram observes without walking the tree)
_current_tid: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "nornicdb_obs_trace_id", default=None)


def current_trace_id() -> Optional[str]:
    """Trace id of the active request, or None outside any trace — the
    exemplar provider the metrics layer reads on histogram observes."""
    return _current_tid.get()


class TraceBuffer:
    """Bounded ring of completed root spans, slowest-aware snapshot."""

    def __init__(self, capacity: int = 256,
                 slow_ms: Optional[float] = None) -> None:
        if slow_ms is None:
            try:
                slow_ms = float(os.environ.get("NORNICDB_OBS_SLOW_MS", "0"))
            except ValueError:
                slow_ms = 0.0
        self.capacity = capacity
        self.slow_ms = slow_ms
        self._lock = threading.Lock()
        self._ring: List[Span] = []
        self._pos = 0
        self.recorded = 0

    def record(self, root: Span) -> None:
        if root.duration_ms < self.slow_ms:
            return
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(root)
            else:
                self._ring[self._pos] = root
                self._pos = (self._pos + 1) % self.capacity
            self.recorded += 1

    def snapshot(self, limit: int = 50,
                 name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Most recent first (ties to the ring write order), converted
        to plain dicts outside the lock."""
        with self._lock:
            spans = list(self._ring)
        if name is not None:
            spans = [s for s in spans if s.name == name
                     or s.attrs.get("method") == name]
        spans.sort(key=lambda s: s.t0, reverse=True)
        return [s.to_dict() for s in spans[:limit]]

    def slowest(self, limit: int = 10) -> List[Dict[str, Any]]:
        with self._lock:
            spans = list(self._ring)
        spans.sort(key=lambda s: s.duration_ms, reverse=True)
        return [s.to_dict() for s in spans[:limit]]

    def clear(self) -> None:
        with self._lock:
            self._ring = []
            self._pos = 0


TRACES = TraceBuffer()


def current_span() -> Optional[Span]:
    return _current.get()


class _ActiveSpan:
    """Context manager binding a span as the contextvar current.

    ``tid`` pins a PROPAGATED trace id (minted in another process) on a
    root span instead of minting a fresh one — the cross-process
    propagation path (:func:`propagated_trace`)."""

    __slots__ = ("span", "_token", "_root", "_tid_token", "_tid")

    def __init__(self, span: Span, root: bool,
                 tid: Optional[str] = None) -> None:
        self.span = span
        self._root = root
        self._token = None
        self._tid_token = None
        self._tid = tid

    def __enter__(self) -> Span:
        self._token = _current.set(self.span)
        if self._root:
            self.span.trace_id = self._tid or _new_trace_id()
            self._tid_token = _current_tid.set(self.span.trace_id)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        self.span.finish()
        if exc_type is not None:
            self.span.attrs.setdefault("error", f"{exc_type.__name__}")
        _current.reset(self._token)
        if self._root:
            _current_tid.reset(self._tid_token)
            TRACES.record(self.span)


class _NullSpan:
    """No-op stand-in when tracing is disabled or there is no active
    trace to attach a child to."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def annotate(self, **attrs: Any) -> None:
        pass


_NULL = _NullSpan()


def trace(name: str, **attrs: Any):
    """Open a ROOT span (one per request). On exit it is recorded into
    the slow-request ring."""
    if not _m.enabled():
        return _NULL
    return _ActiveSpan(Span(name, **attrs), root=True)


def span(name: str, **attrs: Any):
    """Open a child of the current span; no-op when no trace is active
    (layers stay instrumented without requiring a surface above them)."""
    if not _m.enabled():
        return _NULL
    parent = _current.get()
    if parent is None:
        return _NULL
    child = Span(name, **attrs)
    parent.children.append(child)
    return _ActiveSpan(child, root=False)


def attach_span(name: str, t0: float, t1: float, **attrs: Any) -> None:
    """Graft an already-timed interval into the current trace — used
    when the timing was captured by another thread (the batch leader's
    device dispatch) but belongs in this request's story."""
    if not _m.enabled():
        return
    parent = _current.get()
    if parent is None:
        return
    child = Span(name, t0=t0, **attrs)
    child.t1 = t1
    parent.children.append(child)


def annotate(**attrs: Any) -> None:
    cur = _current.get()
    if cur is not None:
        cur.attrs.update(attrs)


# -- cross-process trace propagation ---------------------------------------

# the HTTP header carrying a packed trace context across node hops
# (FleetRouter -> RemoteReplica; any reverse proxy can forward it)
TRACE_HEADER = "X-Nornic-Trace"

# tenant propagation rides the trace context: obs/tenant.py
# registers its resolver here so trace_context() carries the tenant
# across the ring slot header and the X-Nornic-Trace hop WITHOUT this
# module importing the tenant layer.
_tenant_provider = None


def set_tenant_provider(fn) -> None:
    global _tenant_provider
    _tenant_provider = fn


def trace_context() -> Optional[Dict[str, str]]:
    """The active trace as a compact propagation dict
    (``{"trace_id", "surface", "span"[, "tenant"]}``), or None outside
    any trace. Cheap: two contextvar reads + one small dict — safe on
    the per-request wire path (no trace -> no allocation beyond the
    gets)."""
    tid = _current_tid.get()
    if tid is None:
        return None
    ctx: Dict[str, str] = {"trace_id": tid}
    cur = _current.get()
    if cur is not None:
        ctx["span"] = cur.name
        surface = cur.attrs.get("surface") or cur.attrs.get("transport")
        if surface:
            ctx["surface"] = str(surface)
    if _tenant_provider is not None:
        tenant = _tenant_provider()
        if tenant:
            ctx["tenant"] = str(tenant)
    return ctx


def pack_context(ctx: Optional[Dict[str, str]]) -> str:
    """``trace_id|surface|span[|tenant]`` — the one wire format for
    both the broker ring slots and the ``X-Nornic-Trace`` HTTP header.
    The tenant field is appended only when present, so pre-18 peers
    (which split to 3) keep parsing the prefix unchanged."""
    if not ctx or not ctx.get("trace_id"):
        return ""
    fields = [ctx.get("trace_id", ""), ctx.get("surface", ""),
              ctx.get("span", "")]
    if ctx.get("tenant"):
        fields.append(ctx["tenant"])
    return "|".join(fields)


_TID_RE = re.compile(r"^[0-9a-fA-F]{8,64}$")
_FIELD_RE = re.compile(r"^[\w.:/-]{1,64}$")
# tenant names: header-reachable, so tighter than span fields (no
# slash/colon — must match obs.tenant's label charset)
_TENANT_RE = re.compile(r"^[\w.-]{1,64}$")


def unpack_context(packed: Optional[str]) -> Optional[Dict[str, str]]:
    """Inverse of :func:`pack_context`; None on empty/garbage input
    (a missing or malformed context degrades to an unlinked local
    trace, never an error). Fields are charset-validated — the HTTP
    header is client-reachable, and an arbitrary string must not land
    in span attrs shown on the admin surface: trace ids must look like
    the hex ids this process mints, surface/span names like code-
    chosen identifiers."""
    if not packed:
        return None
    parts = (str(packed).split("|") + ["", "", ""])[:4]
    if not _TID_RE.match(parts[0]):
        return None
    ctx = {"trace_id": parts[0].lower()}
    if parts[1] and _FIELD_RE.match(parts[1]):
        ctx["surface"] = parts[1]
    if parts[2] and _FIELD_RE.match(parts[2]):
        ctx["span"] = parts[2]
    if parts[3] and _TENANT_RE.match(parts[3]):
        ctx["tenant"] = parts[3]
    return ctx


def propagated_trace(name: str, ctx: Optional[Dict[str, str]],
                     **attrs: Any):
    """Open a root span bound to a PROPAGATED trace context: the span
    records into this process's ring like any root (so the device
    plane's own ``/admin/traces`` shows plane-side chains), but carries
    the ORIGINATING request's trace id — degrade records, exemplar
    tags and child spans opened under it all join that trace. Falls
    back to a normal :func:`trace` root when no context came across
    the seam."""
    if not _m.enabled():
        return _NULL
    if not ctx or not ctx.get("trace_id"):
        return _ActiveSpan(Span(name, **attrs), root=True)
    span = Span(name, remote=True, **attrs)
    if ctx.get("span"):
        span.attrs.setdefault("parent_span", ctx["span"])
    if ctx.get("surface"):
        span.attrs.setdefault("origin_surface", ctx["surface"])
    return _ActiveSpan(span, root=True, tid=ctx["trace_id"])


def export_span(span: Span) -> Dict[str, Any]:
    """Wire-shape export (raw ``t0``/``t1`` floats, not the rendered
    ``to_dict``) so a remote side can graft the tree with original
    timing intact."""
    return {
        "name": span.name,
        "t0": span.t0,
        "t1": span.t1 if span.t1 is not None else time.time(),
        "attrs": dict(span.attrs),
        "children": [export_span(c) for c in span.children],
    }


def _span_from_export(doc: Dict[str, Any]) -> Span:
    t0 = float(doc.get("t0", 0.0) or 0.0)
    span = Span(str(doc.get("name", "remote")), t0=t0)
    span.attrs.update(doc.get("attrs") or {})
    span.t1 = float(doc.get("t1", t0) or t0)
    for child in doc.get("children", ()) or ():
        span.children.append(_span_from_export(child))
    return span


def attach_span_tree(doc: Optional[Dict[str, Any]]) -> None:
    """Graft an exported remote span tree into the current trace —
    the worker-side half of the ring/HTTP propagation: the plane's
    ``ring.claim``/``plane.coalesce``/``device.dispatch`` spans land
    as children of the live root. No-op without an active trace or
    on malformed input (propagation must never fail a request)."""
    if not _m.enabled() or not doc:
        return
    parent = _current.get()
    if parent is None:
        return
    try:
        parent.children.append(_span_from_export(doc))
    except (TypeError, ValueError):
        pass


# exemplar wiring: histograms ask "what trace is observing right now?"
# via this provider. Registered here (not in metrics.py) because
# metrics must stay importable without tracing.
_m.set_exemplar_provider(current_trace_id)
