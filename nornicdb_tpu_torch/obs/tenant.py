"""Tenant truth: end-to-end per-tenant attribution.

ROADMAP item 5's actuator — per-tenant weighted fair queueing and
cost-priced quotas — needs the serving stack to *see* tenants first
(the cost-then-admission pattern: load-truth observability before the
admission actuator). This module is that identity layer:

- **Resolution** at every ingress: the ``X-Nornic-Tenant`` HTTP header
  (or ``x-nornic-tenant`` gRPC metadata) wins; a tenant PROPAGATED in
  the trace context (``X-Nornic-Trace`` / broker slot) counts as
  explicit too; otherwise the multidb namespace (``/db/{name}/...``,
  default DB elsewhere); qdrant ops refine a non-explicit tenant from
  the collection->tenant mapping (``NORNICDB_TENANT_COLLECTIONS``,
  the ``tenant__collection`` prefix convention, else the collection
  name itself).
- **A contextvar cell** carried across the executor hop exactly like
  the trace context and the deadline budget. The cell is one shared
  mutable object, so a refinement made inside a ``copy_context()``-run
  executor thread (where the collection name first becomes known) is
  visible to the ingress scope that records the request.
- **Cardinality-capped label registry** (the metrics precedent): past
  ``NORNICDB_TENANT_MAX`` distinct tenants, new names fold into
  ``__other__`` and tick ``nornicdb_tenant_folded_total`` — client-
  chosen header values can never blow up the exposition.
- **Per-tenant families**: requests, request latency, served tier,
  degrades, sheds, and the cumulative cost meter (FLOPs/bytes/queries
  — the billing surface the quota PR will price against).
- **The leader->rider batch channel** (``audit.note_batch_tier``
  precedent): a batch leader binds the riders' tenant mix around the
  dispatch so ``obs.cost.record_query_cost`` splits the PADDED
  dispatch cost across riders by tenant.
- **Noisy-neighbor detector**: a rolling window of per-tenant cost;
  while the admission posture is >= degrade, a tenant holding more
  than ``NORNICDB_TENANT_NOISY_SHARE`` of the window's cost emits one
  advisory ``noisy_neighbor`` journal event with evidence (share,
  window totals, posture). No actuation — that is the next PR.
- **Rollups**: :func:`tenants_summary` (top-K by cost/qps/p99/shed)
  serves ``GET /admin/tenants``, joins ``/admin/fleet`` and
  ``/admin/telemetry``, and rides SLO flight-recorder dumps. It reads
  a ``dump_state``-shaped family map, so the wire-plane worker can
  feed it the MERGED local+plane state (exactly-once discipline).

Per-request functions here (:func:`resolve`, :func:`refine`,
:func:`record_served`, :func:`record_cost`) are lint-registered hot
paths — config is env-read once (``cfg``/``reload``), never on the
request path.
"""

from __future__ import annotations

import contextvars
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.obs import events as _events
from nornicdb_tpu_torch.obs import metrics as _m
from nornicdb_tpu_torch.obs import tracing as _tracing
from nornicdb_tpu_torch.obs.metrics import REGISTRY

# the HTTP header an explicit tenant rides in (gRPC: the lowercase
# metadata key — gRPC metadata keys are always lowercase on the wire)
TENANT_HEADER = "X-Nornic-Tenant"
GRPC_METADATA_KEY = "x-nornic-tenant"

# the namespace fallback when nothing resolves (the multidb default DB
# is the caller's namespace; surfaces without one land here)
DEFAULT_TENANT = "default"
# fold target past the registry cap (obs.metrics `__other__`)
OTHER_TENANT = "__other__"
# a record produced OUTSIDE any tenant scope (internal/background
# work) — the attribution-completeness metric counts these
UNATTRIBUTED = "__unattributed__"

# client-reachable header values must look like code-chosen names
# before they land in metric labels or admin surfaces
_TENANT_RE = re.compile(r"^[\w.-]{1,64}$")


# ---------------------------------------------------------------------------
# cached configuration (env read once; per-request paths read the dict)
# ---------------------------------------------------------------------------

_cfg_lock = threading.Lock()
_cfg: Optional[Dict[str, Any]] = None


def _load_cfg() -> Dict[str, Any]:
    from nornicdb_tpu_torch.config import env_float, env_int, env_str

    cmap: Dict[str, str] = {}
    for part in env_str("TENANT_COLLECTIONS", "").split(","):
        if ":" not in part:
            continue
        coll, ten = part.split(":", 1)
        coll, ten = coll.strip(), ten.strip()
        if coll and _TENANT_RE.match(ten):
            cmap[coll] = ten
    return {
        # distinct tenant label values before folding into __other__
        "max_tenants": max(1, env_int("TENANT_MAX", 64)),
        # rollup size at /admin/tenants (top-K by cost)
        "top_k": max(1, env_int("TENANT_TOP_K", 20)),
        # noisy-neighbor rolling window + advisory thresholds
        "noisy_window_s": max(1.0, env_float("TENANT_NOISY_WINDOW_S",
                                             30.0)),
        "noisy_share": min(1.0, max(0.0, env_float("TENANT_NOISY_SHARE",
                                                   0.5))),
        "noisy_cooldown_s": max(0.0, env_float("TENANT_NOISY_COOLDOWN_S",
                                               30.0)),
        # evidence floor: below this much windowed cost the detector
        # stays silent (an idle box has no neighbors to be noisy to)
        "noisy_min_flops": max(0.0, env_float("TENANT_NOISY_MIN_FLOPS",
                                              1e6)),
        # explicit collection->tenant assignments ("coll:tenant,...")
        "collection_map": cmap,
    }


def cfg() -> Dict[str, Any]:
    global _cfg
    c = _cfg
    if c is None:
        with _cfg_lock:
            if _cfg is None:
                _cfg = _load_cfg()
            c = _cfg
    return c


def reload() -> None:
    """Drop the cached env config AND the registry/detector state
    (tests; the metric counters themselves are monotone and stay)."""
    global _cfg
    with _cfg_lock:
        _cfg = None
    with _reg_lock:
        _known.clear()
    DETECTOR.reset()
    _RATES.reset()


# ---------------------------------------------------------------------------
# the tenant context cell
# ---------------------------------------------------------------------------


class _Cell:
    """One request's tenant identity. A single MUTABLE object shared by
    every context copy of the request (executor hops run under
    ``contextvars.copy_context()`` — a plain contextvar set inside the
    copy would never reach the ingress scope that records the request;
    mutating the shared cell does)."""

    __slots__ = ("tenant", "explicit")

    def __init__(self, tenant: Optional[str], explicit: bool) -> None:
        self.tenant = tenant
        self.explicit = explicit


_ctx_cell: "contextvars.ContextVar[Optional[_Cell]]" = \
    contextvars.ContextVar("nornicdb_tenant", default=None)


def current_tenant() -> Optional[str]:
    """The resolved tenant of the current request, or None outside any
    tenant scope. Cheap: one contextvar read + one attribute read."""
    cell = _ctx_cell.get()
    return cell.tenant if cell is not None else None


def current_label() -> str:
    """The METRIC label for the current context: the admitted (cap-
    folded) tenant, or ``__unattributed__`` outside any scope."""
    cell = _ctx_cell.get()
    if cell is None or not cell.tenant:
        return UNATTRIBUTED
    return _admit(cell.tenant)


class _TenantScope:
    __slots__ = ("_cell", "_token")

    def __init__(self, cell: _Cell) -> None:
        self._cell = cell
        self._token = None

    def __enter__(self) -> _Cell:
        self._token = _ctx_cell.set(self._cell)
        return self._cell

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _ctx_cell.reset(self._token)


def tenant_scope(tenant: Optional[str],
                 explicit: bool = False) -> _TenantScope:
    """Bind a tenant for the dynamic extent of a request (the
    ``lane_scope`` pattern). ``tenant=None`` still binds a cell so a
    later :func:`refine` (qdrant collection mapping) can fill it."""
    return _TenantScope(_Cell(tenant, explicit and tenant is not None))


def scope_from_context(ctx: Optional[Dict[str, str]]) -> _TenantScope:
    """A scope from a propagated trace context dict (broker ring /
    ``X-Nornic-Trace``): the origin node already resolved the tenant,
    so it binds as explicit."""
    t = (ctx or {}).get("tenant")
    return _TenantScope(_Cell(t, bool(t)))


def refine(candidate: Optional[str]) -> None:
    """Late-bind a DERIVED tenant (qdrant collection mapping, a route
    that learns its namespace mid-parse). An explicit tenant (header,
    metadata, propagated) always wins; a derived one fills the gap.
    Mutates the shared cell, so refinement inside an executor hop is
    visible at the ingress scope."""
    if not candidate:
        return
    cell = _ctx_cell.get()
    if cell is None:
        # no scope at all (direct library use): stay unattributed — a
        # bare contextvar set here would outlive the request in a
        # long-lived caller context (no scope exit resets it) and
        # silently attribute every LATER unscoped op to this tenant
        return
    if not cell.explicit:
        cell.tenant = candidate


def resolve(header_value: Optional[str],
            ctx: Optional[Dict[str, str]],
            namespace: Optional[str]) -> Tuple[Optional[str], bool]:
    """Ingress resolution order: explicit header > tenant propagated in
    the trace context > multidb namespace > :data:`DEFAULT_TENANT`.
    Returns ``(tenant, explicit)``. A malformed header value is
    DROPPED (charset-validated — it becomes a label and an admin
    surface string), falling through to the namespace."""
    if header_value:
        h = str(header_value).strip()
        if _TENANT_RE.match(h):
            return h, True
    t = (ctx or {}).get("tenant")
    if t:
        return t, True
    if namespace and _TENANT_RE.match(str(namespace)):
        return str(namespace), False
    return DEFAULT_TENANT, False


def tenant_for_collection(collection: str) -> Optional[str]:
    """qdrant collection -> tenant: the explicit map
    (``NORNICDB_TENANT_COLLECTIONS``) wins; a ``tenant__collection``
    name yields its prefix; otherwise the collection IS the tenant
    (per-collection namespacing, capped by the registry like any
    client-chosen value)."""
    if not collection:
        return None
    c = cfg()
    mapped = c["collection_map"].get(collection)
    if mapped:
        return mapped
    if "__" in collection:
        prefix = collection.split("__", 1)[0]
        if prefix and _TENANT_RE.match(prefix):
            return prefix
    return collection if _TENANT_RE.match(collection) else None


# ---------------------------------------------------------------------------
# cardinality-capped tenant registry (fold-to-__other__ precedent)
# ---------------------------------------------------------------------------

_reg_lock = threading.Lock()
_known: Dict[str, None] = {}

_FOLDED_C = REGISTRY.counter(
    "nornicdb_tenant_folded_total",
    "Tenant names folded into __other__ past NORNICDB_TENANT_MAX")

REGISTRY.gauge(
    "nornicdb_tenant_registry_size",
    "Distinct tenant label values admitted (cap: NORNICDB_TENANT_MAX)",
    fn=lambda: float(len(_known)))


def _admit(name: str) -> str:
    """The label a tenant name materializes under: itself while the
    registry has room, ``__other__`` past the cap. Known names stay
    stable forever (dict membership is the fast path — no lock)."""
    if name in _known:
        return name
    if name in (OTHER_TENANT, UNATTRIBUTED):
        return name
    with _reg_lock:
        if name in _known:
            return name
        if len(_known) >= cfg()["max_tenants"]:
            _FOLDED_C.inc()
            return OTHER_TENANT
        _known[name] = None
        return name


def known_tenants() -> List[str]:
    return list(_known)


# ---------------------------------------------------------------------------
# per-tenant metric families (declared in lint/config.py
# TENANT_FAMILIES — the nornic-lint tenant-label rule)
# ---------------------------------------------------------------------------

_T_REQ_C = REGISTRY.counter(
    "nornicdb_tenant_requests_total",
    "Requests attributed per tenant (served + shed), by surface",
    labels=("tenant", "surface"))
_T_LAT_H = REGISTRY.histogram(
    "nornicdb_tenant_request_seconds",
    "Request wall time per tenant, by surface",
    labels=("tenant", "surface"))
_T_SERVED_C = REGISTRY.counter(
    "nornicdb_tenant_served_tier_total",
    "Serving-ladder rung that answered, per tenant",
    labels=("tenant", "surface", "tier"))
_T_DEGRADE_C = REGISTRY.counter(
    "nornicdb_tenant_degrade_total",
    "Serving-ladder step-downs attributed per tenant",
    labels=("tenant", "surface", "reason"))
_T_SHED_C = REGISTRY.counter(
    "nornicdb_tenant_shed_total",
    "Admission sheds attributed per tenant",
    labels=("tenant", "surface", "reason"))
_T_FLOPS_C = REGISTRY.counter(
    "nornicdb_tenant_cost_flops_total",
    "Cumulative priced dispatch FLOPs attributed per tenant (batched "
    "dispatches split the padded cost across riders by tenant)",
    labels=("tenant",))
_T_BYTES_C = REGISTRY.counter(
    "nornicdb_tenant_cost_bytes_total",
    "Cumulative priced dispatch bytes attributed per tenant",
    labels=("tenant",))
_T_QUERIES_C = REGISTRY.counter(
    "nornicdb_tenant_cost_queries_total",
    "Priced queries attributed per tenant (real pre-pad counts)",
    labels=("tenant",))
_T_DEVICE_S_C = REGISTRY.counter(
    "nornicdb_tenant_device_seconds_total",
    "MEASURED device dispatch wall seconds attributed per tenant "
    "(metering in seconds, not just analytic FLOPs; batched "
    "dispatches split wall time across riders by tenant)",
    labels=("tenant",))


# ---------------------------------------------------------------------------
# the leader->rider tenant mix channel (audit.note_batch_tier pattern)
# ---------------------------------------------------------------------------

_tls = threading.local()


class _BatchScope:
    """Bind a batch's tenant mix on the LEADER thread around the
    dispatch: ``record_query_cost`` calls inside split the padded cost
    across the mix; ``record_served(n=b)`` distributes serves the same
    way. Nests (restores the previous mix on exit) — a fused dispatch
    that re-enters a nested coalescer keeps the outer mix."""

    __slots__ = ("_mix", "_prev")

    def __init__(self, mix: Dict[str, int]) -> None:
        self._mix = mix

    def __enter__(self) -> Dict[str, int]:
        self._prev = getattr(_tls, "batch_mix", None)
        _tls.batch_mix = self._mix
        return self._mix

    def __exit__(self, *exc) -> None:
        _tls.batch_mix = self._prev


def batch_scope(tenants: List[Optional[str]]) -> _BatchScope:
    """Scope for a leader dispatching ``tenants``' riders (one entry
    per rider; None = unattributed). Labels are admitted (cap-folded)
    here, once per batch, not per record."""
    mix: Dict[str, int] = {}
    for t in tenants:
        label = _admit(t) if t else UNATTRIBUTED
        mix[label] = mix.get(label, 0) + 1
    return _BatchScope(mix)


def batch_mix() -> Optional[Dict[str, int]]:
    return getattr(_tls, "batch_mix", None)


# ---------------------------------------------------------------------------
# recording hooks (called from obs.audit / obs.cost / admission)
# ---------------------------------------------------------------------------


def record_served(surface: str, tier: str,
                  seconds: Optional[float] = None, n: int = 1) -> None:
    """Per-tenant side of ``audit.record_served``: requests + served
    tier (+ latency when known). Under an active batch mix the ``n``
    serves distribute across the riders' tenants; otherwise the
    current context's tenant takes all ``n``."""
    if not _m.enabled():
        return
    mix = getattr(_tls, "batch_mix", None)
    if mix:
        total = sum(mix.values()) or 1
        for t, c in mix.items():
            share = n * c / total
            _T_REQ_C.labels(t, surface).inc(share)
            _T_SERVED_C.labels(t, surface, tier).inc(share)
            _RATES.note(t, share)
        if seconds is not None:
            for t in mix:
                _T_LAT_H.labels(t, surface).observe(seconds)
        return
    t = current_label()
    _T_REQ_C.labels(t, surface).inc(n)
    _T_SERVED_C.labels(t, surface, tier).inc(n)
    _RATES.note(t, n)
    if seconds is not None:
        _T_LAT_H.labels(t, surface).observe(seconds)


def record_degrade(surface: str, reason: str) -> None:
    if not _m.enabled():
        return
    _T_DEGRADE_C.labels(current_label(), surface, reason).inc()


def record_shed(surface: str, reason: str) -> None:
    if not _m.enabled():
        return
    _T_SHED_C.labels(current_label(), surface, reason).inc()


def record_cost(queries: float, flops: float, bytes_: float) -> None:
    """Per-tenant side of ``obs.cost.record_query_cost``: split the
    padded-dispatch cost across the active batch mix by rider count
    (the leader->rider channel), else attribute it whole to the
    current context's tenant. Feeds the noisy-neighbor window."""
    if not _m.enabled():
        return
    mix = getattr(_tls, "batch_mix", None)
    if mix:
        total = sum(mix.values()) or 1
        for t, c in mix.items():
            frac = c / total
            f = flops * frac
            _T_FLOPS_C.labels(t).inc(f)
            _T_BYTES_C.labels(t).inc(bytes_ * frac)
            _T_QUERIES_C.labels(t).inc(queries * frac)
            DETECTOR.note(t, f)
        return
    t = current_label()
    _T_FLOPS_C.labels(t).inc(flops)
    _T_BYTES_C.labels(t).inc(bytes_)
    _T_QUERIES_C.labels(t).inc(queries)
    DETECTOR.note(t, flops)


def record_device_seconds(seconds: float) -> None:
    """Per-tenant side of the measured dispatch bracket:
    split one dispatch's wall seconds across the active batch mix by
    rider count — the bill in device time, not analytic FLOPs. Outside
    a mix the current context's tenant pays whole."""
    if not _m.enabled():
        return
    mix = getattr(_tls, "batch_mix", None)
    if mix:
        total = sum(mix.values()) or 1
        for t, c in mix.items():
            _T_DEVICE_S_C.labels(t).inc(seconds * c / total)
        return
    _T_DEVICE_S_C.labels(current_label()).inc(seconds)


# ---------------------------------------------------------------------------
# request-rate window (the qps column of the rollup)
# ---------------------------------------------------------------------------


class _RateWindow:
    """Two-bucket per-tenant request rate: O(1) per note, qps derived
    from the closed previous bucket (a full bucket of signal) plus the
    live one — no unbounded deque under a flood."""

    BUCKET_S = 10.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._t0 = 0.0
        self._cur: Dict[str, float] = {}
        self._prev: Dict[str, float] = {}

    def note(self, tenant: str, n: float = 1.0) -> None:
        now = time.time()
        with self._lock:
            if now - self._t0 >= self.BUCKET_S:
                self._prev = self._cur if now - self._t0 < \
                    2 * self.BUCKET_S else {}
                self._cur = {}
                self._t0 = now
            self._cur[tenant] = self._cur.get(tenant, 0.0) + n

    def rates(self) -> Dict[str, float]:
        now = time.time()
        with self._lock:
            live_s = max(now - self._t0, 1e-3)
            if live_s >= 2 * self.BUCKET_S:
                return {}
            out: Dict[str, float] = {}
            span = min(live_s, self.BUCKET_S) + (
                self.BUCKET_S if self._prev else 0.0)
            for t in set(self._cur) | set(self._prev):
                total = self._cur.get(t, 0.0) + self._prev.get(t, 0.0)
                out[t] = total / max(span, 1e-3)
            return out

    def reset(self) -> None:
        with self._lock:
            self._cur = {}
            self._prev = {}
            self._t0 = 0.0


_RATES = _RateWindow()


# ---------------------------------------------------------------------------
# noisy-neighbor detector (advisory; actuation is the next PR)
# ---------------------------------------------------------------------------

# injected by admission.py at import (provider pattern — this module
# must not import the actuator): returns the posture LEVEL (index into
# admission.POSTURES; >= 1 means degrade or worse)
_posture_provider: Optional[Callable[[], int]] = None


def set_posture_provider(fn: Callable[[], int]) -> None:
    global _posture_provider
    _posture_provider = fn


class NoisyNeighborDetector:
    """Rolling-window per-tenant cost share. While the admission
    posture is >= degrade, the tenant holding more than
    ``noisy_share`` of the window's priced FLOPs emits ONE advisory
    ``noisy_neighbor`` journal event per cooldown, with evidence: its
    share, windowed flops, the window total, qps, and the posture that
    armed the check. Costs attributed to ``__other__`` or
    ``__unattributed__`` never accuse anyone."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ring: "deque[Tuple[float, str, float]]" = deque()
        self._totals: Dict[str, float] = {}
        self._last_emit: Dict[str, float] = {}
        self.emitted = 0

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._totals.clear()
            self._last_emit.clear()

    def _prune(self, now: float, window_s: float) -> None:
        ring, totals = self._ring, self._totals
        while ring and ring[0][0] < now - window_s:
            _ts, t, f = ring.popleft()
            left = totals.get(t, 0.0) - f
            if left <= 1e-9:
                totals.pop(t, None)
            else:
                totals[t] = left

    def note(self, tenant: str, flops: float) -> None:
        if flops <= 0.0:
            return
        c = cfg()
        now = time.time()
        with self._lock:
            self._ring.append((now, tenant, flops))
            self._totals[tenant] = self._totals.get(tenant, 0.0) + flops
            self._prune(now, c["noisy_window_s"])
            level = _posture_provider() if _posture_provider else 0
            if level < 1:
                return
            total = sum(self._totals.values())
            if total < c["noisy_min_flops"]:
                return
            top, top_f = max(self._totals.items(), key=lambda kv: kv[1])
            share = top_f / total
            if share < c["noisy_share"] \
                    or top in (OTHER_TENANT, UNATTRIBUTED):
                return
            if now - self._last_emit.get(top, 0.0) \
                    < c["noisy_cooldown_s"]:
                return
            self._last_emit[top] = now
            self.emitted += 1
            evidence = {
                "tenant": top,
                "cost_share": round(share, 4),
                "window_s": c["noisy_window_s"],
                "window_flops": round(top_f, 1),
                "window_total_flops": round(total, 1),
                "qps": round(_RATES.rates().get(top, 0.0), 2),
                "posture_level": level,
            }
        # journal write outside the window lock (the journal has its
        # own lock; never hold two)
        _events.record_event("noisy_neighbor", surface="admission",
                             reason="cost_share", detail=evidence)

    def snapshot(self) -> Dict[str, Any]:
        c = cfg()
        now = time.time()
        with self._lock:
            self._prune(now, c["noisy_window_s"])
            total = sum(self._totals.values())
            shares = {t: round(f / total, 4)
                      for t, f in self._totals.items()} if total else {}
            return {
                "window_s": c["noisy_window_s"],
                "share_threshold": c["noisy_share"],
                "window_total_flops": round(total, 1),
                "shares": shares,
                "emitted": self.emitted,
            }


DETECTOR = NoisyNeighborDetector()


# ---------------------------------------------------------------------------
# rollups — /admin/tenants, /admin/fleet, /admin/telemetry, SLO dumps
# ---------------------------------------------------------------------------


def _quantile_from_snapshot(snap: Dict[str, Any],
                            q: float) -> Optional[float]:
    """Bucket-interpolated quantile over a dump_state histogram
    snapshot (the obs.fleet math, over the same wire shape)."""
    total = snap.get("count", 0)
    if not total:
        return None
    bounds = snap["buckets"]
    rank = q * total
    cum = 0.0
    for i, c in enumerate(snap["counts"]):
        prev = cum
        cum += c
        if cum >= rank:
            if i >= len(bounds):
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            if c == 0:
                return hi
            return lo + (hi - lo) * (rank - prev) / c
    return bounds[-1] if bounds else None


def _fam_children(state: Dict[str, Dict], name: str) -> Dict:
    fam = state.get(name)
    return fam["children"] if fam else {}


def attribution_completeness(
        state: Optional[Dict[str, Dict]] = None) -> Optional[float]:
    """Share of attributed requests carrying a REAL tenant (not
    ``__unattributed__``) — the truth metric the multi-tenant bench
    sentinel gates ABSOLUTELY at 1.0. None when no requests were
    recorded at all."""
    if state is None:
        state = {f["name"]: f for f in _m.dump_state()}
    total = attributed = 0.0
    for key, v in _fam_children(
            state, "nornicdb_tenant_requests_total").items():
        total += v
        if key[0] != UNATTRIBUTED:
            attributed += v
    if total <= 0.0:
        return None
    return attributed / total


def tenants_summary(state: Optional[Dict[str, Dict]] = None,
                    top: Optional[int] = None) -> Dict[str, Any]:
    """The ``GET /admin/tenants`` payload: per-tenant requests, qps,
    p99, served-tier mix, sheds, degrades and the cumulative cost
    meter — top-K by windowed+cumulative cost. ``state`` accepts a
    merged ``dump_state`` family map (wire-plane workers pass
    local+plane merged state so per-tenant counters appear exactly
    once); None reads the local registry."""
    local = state is None
    if state is None:
        state = {f["name"]: f for f in _m.dump_state()}
    c = cfg()
    k = top or c["top_k"]
    docs: Dict[str, Dict[str, Any]] = {}

    def doc(t: str) -> Dict[str, Any]:
        return docs.setdefault(t, {"tenant": t})

    for key, v in _fam_children(
            state, "nornicdb_tenant_requests_total").items():
        d = doc(key[0])
        d["requests"] = d.get("requests", 0.0) + v
    for key, v in _fam_children(
            state, "nornicdb_tenant_served_tier_total").items():
        d = doc(key[0]).setdefault("tiers", {})
        d[key[2]] = d.get(key[2], 0.0) + v
    for key, v in _fam_children(
            state, "nornicdb_tenant_shed_total").items():
        d = doc(key[0])
        d["shed"] = d.get("shed", 0.0) + v
        reasons = d.setdefault("shed_reasons", {})
        reasons[key[2]] = reasons.get(key[2], 0.0) + v
    for key, v in _fam_children(
            state, "nornicdb_tenant_degrade_total").items():
        d = doc(key[0])
        d["degrades"] = d.get("degrades", 0.0) + v
    for name, field in (("nornicdb_tenant_cost_flops_total", "flops"),
                        ("nornicdb_tenant_cost_bytes_total", "bytes"),
                        ("nornicdb_tenant_cost_queries_total",
                         "queries"),
                        ("nornicdb_tenant_device_seconds_total",
                         "device_seconds")):
        for key, v in _fam_children(state, name).items():
            d = doc(key[0]).setdefault("cost", {})
            d[field] = d.get(field, 0.0) + v
    for key, snap in _fam_children(
            state, "nornicdb_tenant_request_seconds").items():
        if not isinstance(snap, dict) or not snap.get("count"):
            continue
        d = doc(key[0])
        best = d.get("_lat")
        if best is None or snap.get("count", 0) > best.get("count", 0):
            d["_lat"] = snap
    rates = _RATES.rates()
    total_flops = sum(d.get("cost", {}).get("flops", 0.0)
                      for d in docs.values())
    for t, d in docs.items():
        lat = d.pop("_lat", None)
        if lat is not None:
            p99 = _quantile_from_snapshot(lat, 0.99)
            p50 = _quantile_from_snapshot(lat, 0.5)
            d["p50_ms"] = None if p50 is None else round(p50 * 1e3, 3)
            d["p99_ms"] = None if p99 is None else round(p99 * 1e3, 3)
        if t in rates:
            d["qps"] = round(rates[t], 2)
        if total_flops > 0.0 and "cost" in d:
            d["cost_share"] = round(
                d["cost"].get("flops", 0.0) / total_flops, 4)

    def rank(d: Dict[str, Any]) -> Tuple[float, float]:
        return (d.get("cost", {}).get("flops", 0.0),
                d.get("requests", 0.0))

    ordered = sorted(docs.values(), key=rank, reverse=True)
    out: Dict[str, Any] = {
        "cap": c["max_tenants"],
        "known": len(_known),
        "tenants": ordered[:k],
        "total": len(ordered),
        "attribution_completeness": attribution_completeness(state),
        "noisy_neighbor": DETECTOR.snapshot(),
    }
    if not local:
        # qps/noisy window are process-local; flag the merged view so
        # an operator reads the cumulative columns as fleet-wide and
        # the windowed ones as this node's
        out["merged"] = True
    return out


# tenant propagation: the trace context carries the tenant across the
# broker ring and the X-Nornic-Trace node hop (pack_context field 4);
# the journal stamps it on every incident event. Providers registered
# here (not in tracing/events) so those modules stay importable
# without the tenant layer.
_tracing.set_tenant_provider(current_tenant)
_events.set_tenant_provider(current_tenant)
