"""Low-overhead metric primitives + Prometheus text exposition.

Dependency-free (stdlib only) so every layer — storage, search, wire —
can record without import cycles. Three metric kinds:

- :class:`Counter` — monotone float, lock-striped by thread id so N
  handler threads incrementing one hot counter don't serialize on a
  single lock (the reference surfaces run 8-16 worker threads).
- :class:`Gauge` — last-write-wins scalar, or callback-backed for
  values that are cheaper to read on scrape than to maintain (node
  counts, cache sizes).
- :class:`Histogram` — fixed upper-bound buckets with the full
  Prometheus exposition contract (``_bucket`` with ``le`` labels
  including ``+Inf``, ``_sum``, ``_count``) and bucket-interpolated
  quantile estimation for the bench/admin summaries.

Metrics are registered in a :class:`Registry`; label sets materialize
child series on first use (``labels(...)``) keyed by the label-value
tuple, so the hot path after the first request is one dict probe + one
striped add. ``set_enabled(False)`` turns every record call into a
no-op branch — the overhead-guard test measures the delta.
"""

from __future__ import annotations

import os
import threading
import time
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_STRIPES = 8

_enabled = True

# label-cardinality cap per metric family: past this many materialized
# children, new label-value tuples fold into one "__other__" series and
# tick the dropped-labels counter — per-collection labels (multidb
# churn, qdrant collections) can then never blow up the exposition
_DEFAULT_MAX_LABEL_CHILDREN = 256


def default_max_label_children() -> int:
    try:
        return int(os.environ.get("NORNICDB_OBS_MAX_LABELS",
                                  _DEFAULT_MAX_LABEL_CHILDREN))
    except ValueError:
        return _DEFAULT_MAX_LABEL_CHILDREN


def set_enabled(value: bool) -> None:
    """Process-wide kill switch. Record calls become a single branch;
    already-registered metrics keep their accumulated values."""
    global _enabled
    _enabled = value


def enabled() -> bool:
    return _enabled


# -- exemplars ---------------------------------------------------------------
#
# Histograms optionally remember, per bucket, the trace id of the most
# recent observation that landed there — so a p99 spike on a dashboard
# links to a concrete trace in /admin/traces. The trace id comes from a
# provider callback (registered by obs/tracing at import; metrics stays
# importable standalone). Exemplars surface ONLY in the OpenMetrics
# exposition (content-negotiated at /metrics); the classic Prometheus
# text stays byte-identical with tagging on or off.

_exemplar_provider: Optional[Callable[[], Optional[str]]] = None


def _env_exemplars_default() -> bool:
    return os.environ.get("NORNICDB_OBS_EXEMPLARS", "1").lower() \
        not in ("0", "false", "off")


_exemplars_enabled = _env_exemplars_default()


def set_exemplar_provider(fn: Optional[Callable[[], Optional[str]]]) -> None:
    global _exemplar_provider
    _exemplar_provider = fn


def set_exemplars_enabled(value: bool) -> None:
    """Runtime toggle (initial state from NORNICDB_OBS_EXEMPLARS,
    default on). Off = observe() skips the provider call entirely."""
    global _exemplars_enabled
    _exemplars_enabled = bool(value)


def exemplars_enabled() -> bool:
    return _exemplars_enabled


# request-latency buckets (seconds): 50us floor (cache-hit wire replies
# land there) to 10s ceiling, roughly x2-x2.5 steps — 17 buckets
LATENCY_BUCKETS: Tuple[float, ...] = (
    50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3, 100e-3, 250e-3, 500e-3,
    1.0, 2.5, 5.0, 10.0,
)

# batch/queue-size buckets: powers of two, matching the pow2 compile
# bucketing of the device dispatch path
SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Optional[Tuple[str, str]] = None) -> str:
    parts = [f'{n}="{_escape_label(str(v))}"'
             for n, v in zip(names, values)]
    if extra is not None:
        parts.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotone counter, lock-striped across threads."""

    __slots__ = ("_locks", "_values")

    def __init__(self) -> None:
        self._locks = [threading.Lock() for _ in range(_STRIPES)]
        self._values = [0.0] * _STRIPES

    def inc(self, value: float = 1.0) -> None:
        if not _enabled:
            return
        s = threading.get_ident() % _STRIPES
        with self._locks[s]:
            self._values[s] += value

    @property
    def value(self) -> float:
        return sum(self._values)


class Gauge:
    """Last-write-wins scalar, or callback-backed (read on scrape)."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — scrape must never fail
                return 0.0
        return self._value


class Histogram:
    """Fixed-bucket histogram. ``observe`` is a bisect + one locked
    bucket increment; cumulative counts are computed at render time."""

    __slots__ = ("_bounds", "_lock", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket")
        self._bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        # per-bucket (trace_id, value, ts) of the latest traced
        # observation; allocated lazily on the first tagged observe so
        # untraced histograms pay nothing
        self._exemplars: Optional[List[Optional[Tuple[str, float, float]]]] \
            = None

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        i = bisect_left(self._bounds, value)
        tid = None
        if _exemplars_enabled and _exemplar_provider is not None:
            tid = _exemplar_provider()
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if tid is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * len(self._counts)
                self._exemplars[i] = (tid, value, time.time())

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            return {"buckets": list(self._bounds), "counts": counts,
                    "sum": self._sum, "count": self._count}

    def exemplars(self) -> List[Optional[Tuple[str, float, float]]]:
        """Per-bucket (trace_id, value, ts) or None — same slot order as
        ``snapshot()['counts']`` (+Inf last)."""
        with self._lock:
            if self._exemplars is None:
                return [None] * len(self._counts)
            return list(self._exemplars)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (Prometheus
        histogram_quantile semantics); None when empty."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return None
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank:
                if i >= len(self._bounds):  # +Inf bucket: clamp to top
                    return self._bounds[-1]
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i]
                if c == 0:
                    return hi
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self._bounds[-1]


class _Family:
    """One metric name with 0+ label dimensions; children materialize
    per label-value tuple, capped at ``max_children`` distinct tuples —
    overflow folds into one ``__other__`` series (and ticks the
    registry's dropped-labels counter) so client-driven label values
    can never grow the exposition without bound."""

    def __init__(self, name: str, kind: str, help_text: str,
                 label_names: Tuple[str, ...],
                 make: Callable[[], object],
                 max_children: Optional[int] = None,
                 on_drop: Optional[Callable[[str], None]] = None) -> None:
        self.name = name
        self.kind = kind
        self.help = help_text
        self.label_names = label_names
        self._make = make
        self._max_children = max_children
        self._on_drop = on_drop
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not label_names:
            self._children[()] = make()

    @property
    def _overflow_key(self) -> Tuple[str, ...]:
        return ("__other__",) * len(self.label_names)

    def labels(self, *values: object):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {key}")
        child = self._children.get(key)
        if child is None:
            dropped = False
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    cap = self._max_children
                    if (cap is not None and key != self._overflow_key
                            and len(self._children) >= cap):
                        # fold: the overflow child is exempt from the
                        # cap so it can always materialize
                        key = self._overflow_key
                        child = self._children.get(key)
                        if child is None:
                            child = self._children[key] = self._make()
                        dropped = True
                    else:
                        child = self._children[key] = self._make()
                        dropped = False
            if dropped and self._on_drop is not None:
                self._on_drop(self.name)
        return child

    def remove(self, key: Tuple[str, ...]) -> None:
        """Drop one child series (used by gauge collectors whose label
        source — an index, a queue — has been garbage-collected, so the
        exposition doesn't carry dead series forever)."""
        with self._lock:
            self._children.pop(tuple(str(v) for v in key), None)

    def child(self):
        """The unlabeled child (only valid for label-less families)."""
        return self._children[()]

    def _maybe_child(self):
        return self._children.get(())

    # convenience passthroughs for label-less families
    def inc(self, value: float = 1.0) -> None:
        self.child().inc(value)

    def set(self, value: float) -> None:
        self.child().set(value)

    def observe(self, value: float) -> None:
        self.child().observe(value)

    @property
    def value(self) -> float:
        return self.child().value

    def quantile(self, q: float):
        """None (not a raise) on a labeled family with no unlabeled
        child or an empty histogram — percentile math over new/idle
        series must degrade to nulls, never to a 500."""
        child = self._maybe_child()
        return None if child is None else child.quantile(q)

    def snapshot(self):
        child = self._maybe_child()
        if child is None:
            return {"buckets": [], "counts": [], "sum": 0.0, "count": 0}
        return child.snapshot()

    def children(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._children)

    def render(self, out: List[str]) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for key, child in sorted(self.children().items()):
            if self.kind == "histogram":
                snap = child.snapshot()
                cum = 0
                for bound, c in zip(snap["buckets"], snap["counts"]):
                    cum += c
                    lbl = _fmt_labels(self.label_names, key,
                                      ("le", _fmt_float(bound)))
                    out.append(f"{self.name}_bucket{lbl} {cum}")
                cum += snap["counts"][-1]
                lbl = _fmt_labels(self.label_names, key, ("le", "+Inf"))
                out.append(f"{self.name}_bucket{lbl} {cum}")
                base = _fmt_labels(self.label_names, key)
                out.append(f"{self.name}_sum{base} {_fmt_float(snap['sum'])}")
                out.append(f"{self.name}_count{base} {snap['count']}")
            else:
                lbl = _fmt_labels(self.label_names, key)
                out.append(f"{self.name}{lbl} {_fmt_float(child.value)}")

    def render_openmetrics(self, out: List[str]) -> None:
        """OpenMetrics exposition of this family. Differences from the
        classic text: counter families are named WITHOUT the ``_total``
        suffix in TYPE/HELP (samples keep it, per the OM spec), bucket
        ``le`` values are canonical floats, and histogram bucket lines
        carry ``# {trace_id=...} value ts`` exemplars when tagged."""
        name = self.name
        if self.kind == "counter":
            base = name[:-6] if name.endswith("_total") else name
            out.append(f"# TYPE {base} counter")
            if self.help:
                out.append(f"# HELP {base} {self.help}")
            sample = base + "_total" if name.endswith("_total") else name
            for key, child in sorted(self.children().items()):
                lbl = _fmt_labels(self.label_names, key)
                out.append(f"{sample}{lbl} {_fmt_float(child.value)}")
            return
        out.append(f"# TYPE {name} {self.kind}")
        if self.help:
            out.append(f"# HELP {name} {self.help}")
        for key, child in sorted(self.children().items()):
            if self.kind == "histogram":
                snap = child.snapshot()
                exemplars = child.exemplars()
                cum = 0
                bounds = list(snap["buckets"]) + [None]  # None = +Inf
                for i, bound in enumerate(bounds):
                    cum += snap["counts"][i]
                    le = "+Inf" if bound is None else repr(float(bound))
                    lbl = _fmt_labels(self.label_names, key, ("le", le))
                    line = f"{name}_bucket{lbl} {cum}"
                    ex = exemplars[i]
                    if ex is not None:
                        tid, val, ts = ex
                        line += (f' # {{trace_id="{_escape_label(tid)}"}}'
                                 f" {_fmt_float(val)} {ts:.3f}")
                    out.append(line)
                base_l = _fmt_labels(self.label_names, key)
                out.append(
                    f"{name}_sum{base_l} {_fmt_float(snap['sum'])}")
                out.append(f"{name}_count{base_l} {snap['count']}")
            else:
                lbl = _fmt_labels(self.label_names, key)
                out.append(f"{name}{lbl} {_fmt_float(child.value)}")


def _fmt_float(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Registry:
    """Named metric families; ``render()`` emits the Prometheus text
    exposition. get-or-create is idempotent so call sites can resolve
    their metrics lazily without coordinating registration order.

    ``max_label_children`` caps the per-family label cardinality
    (default from ``NORNICDB_OBS_MAX_LABELS``); overflow folds into an
    ``__other__`` series counted by
    ``nornicdb_metric_labels_dropped_total{metric=...}``.

    Collectors (``add_collector``) run at the start of every
    ``render()`` — callback hooks for gauge families whose values are
    derived on scrape (index memory/freshness accounting, SLO burn
    rates) rather than maintained on the hot path."""

    def __init__(self, max_label_children: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []
        self.max_label_children = (
            default_max_label_children() if max_label_children is None
            else max_label_children)
        self.started_at = time.time()

    def _note_dropped(self, metric_name: str) -> None:
        # bounded by the number of families, so this family itself can
        # never meaningfully overflow its own cap
        self.counter(
            "nornicdb_metric_labels_dropped_total",
            "Label tuples folded into __other__ by the cardinality cap",
            labels=("metric",)).labels(metric_name).inc()

    def _get_or_create(self, name: str, kind: str, help_text: str,
                       label_names: Tuple[str, ...],
                       make: Callable[[], object]) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name} already registered as {fam.kind}")
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_text, label_names, make,
                              max_children=self.max_label_children,
                              on_drop=self._note_dropped)
                self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._get_or_create(name, "counter", help_text,
                                   tuple(labels), Counter)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = (),
              fn: Optional[Callable[[], float]] = None) -> _Family:
        return self._get_or_create(name, "gauge", help_text,
                                   tuple(labels), lambda: Gauge(fn))

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> _Family:
        return self._get_or_create(name, "histogram", help_text,
                                   tuple(labels),
                                   lambda: Histogram(buckets))

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except RuntimeError:
                # a device fault (CUDA error, OOM, NotPortedError) is
                # never hidden behind a scrape
                raise
            except Exception:  # noqa: BLE001 — a scrape must never fail
                pass

    def render(self, extra_gauges: Optional[Dict[str, float]] = None) -> str:
        self.run_collectors()
        out: List[str] = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            fam.render(out)
        for name, value in sorted((extra_gauges or {}).items()):
            out.append(f"# TYPE {name} gauge")
            out.append(f"{name} {_fmt_float(value)}")
        return "\n".join(out) + "\n"

    OPENMETRICS_CONTENT_TYPE = (
        "application/openmetrics-text; version=1.0.0; charset=utf-8")

    def render_openmetrics(
            self, extra_gauges: Optional[Dict[str, float]] = None) -> str:
        """OpenMetrics 1.0 exposition (exemplars included, ``# EOF``
        terminated). Served at /metrics under content negotiation; the
        classic ``render()`` text is untouched by exemplar tagging."""
        self.run_collectors()
        out: List[str] = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            fam.render_openmetrics(out)
        for name, value in sorted((extra_gauges or {}).items()):
            out.append(f"# TYPE {name} gauge")
            out.append(f"{name} {_fmt_float(value)}")
        out.append("# EOF")
        return "\n".join(out) + "\n"


# the process-wide registry every layer records into; tests that need
# isolation construct private Registry instances instead
REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY


def dump_state(registry: Optional[Registry] = None) -> List[Dict]:
    """Picklable snapshot of every family (collectors run first) — the
    device plane ships this across the broker so each frontend
    worker's /metrics scrape can include the shared-plane series
    exactly once. Shape per family: ``{"name", "kind",
    "help", "labels", "children": {label_tuple: float |
    histogram-snapshot}}``."""
    reg = registry if registry is not None else REGISTRY
    reg.run_collectors()
    out: List[Dict] = []
    for fam in reg.families():
        children: Dict[Tuple[str, ...], object] = {}
        for key, child in fam.children().items():
            if fam.kind == "histogram":
                snap = child.snapshot()
                # exemplars ride the snapshot so a worker's OpenMetrics
                # scrape can still join a shared-plane p99 bucket to a
                # trace — without this the plane's bucket exemplars are
                # silently dropped at the merge
                ex = child.exemplars()
                if any(e is not None for e in ex):
                    snap = {**snap, "exemplars": ex}
                children[key] = snap
            else:
                children[key] = float(child.value)
        out.append({"name": fam.name, "kind": fam.kind, "help": fam.help,
                    "labels": tuple(fam.label_names),
                    "children": children})
    return out


def merge_states(local_state: List[Dict],
                 remote_states: Sequence[List[Dict]]) -> Dict[str, Dict]:
    """Merge ``dump_state`` snapshots under the multi-worker "exactly
    once" contract (counters/histograms SUM per label tuple, remote
    gauges win on conflict, union otherwise). Shared by
    :func:`render_merged` (a worker's /metrics scrape) and the fleet
    telemetry aggregator (obs/fleet.py)."""
    merged: Dict[str, Dict] = {}
    for fam_state in local_state:
        merged[fam_state["name"]] = {
            **fam_state, "children": dict(fam_state["children"])}
    for state in remote_states:
        for fam in state:
            mine = merged.get(fam["name"])
            if mine is None or mine["kind"] != fam["kind"]:
                merged[fam["name"]] = {
                    **fam, "children": dict(fam["children"])}
                continue
            for key, rv in fam["children"].items():
                lv = mine["children"].get(key)
                if lv is None:
                    mine["children"][key] = rv
                elif fam["kind"] == "counter":
                    mine["children"][key] = float(lv) + float(rv)
                elif fam["kind"] == "gauge":
                    mine["children"][key] = rv  # shared plane wins
                else:  # histogram: sum counts when bounds agree
                    if lv["buckets"] == rv["buckets"]:
                        mine["children"][key] = {
                            "buckets": lv["buckets"],
                            "counts": [a + b for a, b in
                                       zip(lv["counts"], rv["counts"])],
                            "sum": lv["sum"] + rv["sum"],
                            "count": lv["count"] + rv["count"],
                            "exemplars": _merge_exemplars(
                                lv.get("exemplars"),
                                rv.get("exemplars"),
                                len(lv["counts"])),
                        }
                    else:
                        mine["children"][key] = rv
    return merged


def _merge_exemplars(a, b, n: int):
    """Per-bucket newest-wins exemplar merge; None when neither side
    tagged anything (keeps the merged snapshot lean)."""
    if not a and not b:
        return None
    out = []
    for i in range(n):
        ea = a[i] if a and i < len(a) else None
        eb = b[i] if b and i < len(b) else None
        if ea is not None and eb is not None:
            out.append(ea if ea[2] >= eb[2] else eb)
        else:
            out.append(ea if ea is not None else eb)
    return out


def render_merged(remote_states: Sequence[List[Dict]],
                  registry: Optional[Registry] = None,
                  extra_gauges: Optional[Dict[str, float]] = None,
                  openmetrics: bool = False) -> str:
    """Prometheus exposition of the LOCAL registry merged with remote
    ``dump_state`` snapshots. Merge discipline (the "exactly once"
    contract of the multi-worker wire plane):

    - counters and histograms SUM per label tuple — a family the
      worker registered at import but never observed contributes 0, so
      the shared plane's series appear once with the true value;
    - gauges: the remote (shared-plane) value wins on a label-tuple
      conflict — index memory/freshness/compile-universe gauges are
      owned by the device plane, a worker-local zero must not mask
      them — and union otherwise.

    ``openmetrics=True`` renders the OpenMetrics 1.0 exposition
    instead (counter TYPE sans ``_total``, ``# EOF``, and bucket
    exemplars — newest wins per bucket across the merged sides), so a
    worker scrape under content negotiation keeps the shared plane's
    trace-id exemplar joins.
    """
    reg = registry if registry is not None else REGISTRY
    merged = merge_states(dump_state(reg), remote_states)
    return render_state(merged, extra_gauges=extra_gauges,
                        openmetrics=openmetrics)


def render_state(merged: Dict[str, Dict],
                 extra_gauges: Optional[Dict[str, float]] = None,
                 openmetrics: bool = False) -> str:
    """Render a merged family map (:func:`merge_states`) as the classic
    or OpenMetrics text exposition."""
    out: List[str] = []
    for name in sorted(merged):
        fam = merged[name]
        label_names = tuple(fam["labels"])
        if openmetrics and fam["kind"] == "counter":
            base = name[:-6] if name.endswith("_total") else name
            out.append(f"# TYPE {base} counter")
            if fam["help"]:
                out.append(f"# HELP {base} {fam['help']}")
        else:
            if openmetrics:
                out.append(f"# TYPE {name} {fam['kind']}")
                if fam["help"]:
                    out.append(f"# HELP {name} {fam['help']}")
            else:
                out.append(f"# HELP {name} {fam['help']}")
                out.append(f"# TYPE {name} {fam['kind']}")
        for key in sorted(fam["children"]):
            val = fam["children"][key]
            if fam["kind"] == "histogram":
                exemplars = val.get("exemplars") if openmetrics else None
                cum = 0
                bounds = list(val["buckets"]) + [None]  # None = +Inf
                for i, bound in enumerate(bounds):
                    cum += val["counts"][i]
                    if openmetrics:
                        le = ("+Inf" if bound is None
                              else repr(float(bound)))
                    else:
                        le = ("+Inf" if bound is None
                              else _fmt_float(bound))
                    lbl = _fmt_labels(label_names, key, ("le", le))
                    line = f"{name}_bucket{lbl} {cum}"
                    ex = (exemplars[i] if exemplars
                          and i < len(exemplars) else None)
                    if ex is not None:
                        tid, v, ts = ex
                        line += (f' # {{trace_id="{_escape_label(tid)}"}}'
                                 f" {_fmt_float(v)} {ts:.3f}")
                    out.append(line)
                base_l = _fmt_labels(label_names, key)
                out.append(f"{name}_sum{base_l} {_fmt_float(val['sum'])}")
                out.append(f"{name}_count{base_l} {val['count']}")
            else:
                lbl = _fmt_labels(label_names, key)
                out.append(f"{name}{lbl} {_fmt_float(val)}")
    for name, value in sorted((extra_gauges or {}).items()):
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name} {_fmt_float(value)}")
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def latency_summary(registry: Optional[Registry] = None,
                    quantiles: Sequence[float] = (0.5, 0.95, 0.99),
                    include_empty: bool = False,
                    ) -> Dict[str, Dict[str, float]]:
    """p50/p95/p99 (ms) + count for every ``*_seconds`` histogram
    series — one flat dict keyed ``name{label=value,...}``. Shared by
    the /admin/telemetry endpoint and bench.py's percentile stage.

    ``include_empty=True`` also lists series with zero observations
    (count 0, null percentiles) — brand-new histograms must read as
    nulls on the admin surface, never raise or silently vanish."""
    out: Dict[str, Dict[str, float]] = {}
    reg = registry if registry is not None else REGISTRY
    for fam in reg.families():
        if fam.kind != "histogram" or not fam.name.endswith("_seconds"):
            continue
        children = sorted(fam.children().items())
        if not children and include_empty:
            out[fam.name] = {"count": 0}
            for qv in quantiles:
                out[fam.name][f"p{int(qv * 100)}_ms"] = None
            continue
        for key, child in children:
            snap = child.snapshot()
            if not snap["count"] and not include_empty:
                continue
            series = fam.name + _fmt_labels(fam.label_names, key)
            entry: Dict[str, float] = {"count": snap["count"]}
            for qv in quantiles:
                est = child.quantile(qv) if snap["count"] else None
                entry[f"p{int(qv * 100)}_ms"] = (
                    None if est is None else round(est * 1e3, 3))
            out[series] = entry
    return out
