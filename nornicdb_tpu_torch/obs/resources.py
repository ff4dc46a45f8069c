"""Resource & freshness accounting: device memory and staleness gauges.

The port holds three device-resident structures on the card — the brute-force
matrix, the CAGRA graph (+ reorder maps), and the device-BM25 CSR
columns — with zero operational visibility into their footprint or how
far behind the live indexes their snapshots run. This module closes
that: any index/queue object registers itself here (weakly — a dropped
collection's series disappear instead of lingering at their last
value), and a registry collector derives labeled gauges on every
scrape from each object's ``resource_stats()``:

- ``nornicdb_index_device_bytes{family,index}`` / ``_host_bytes`` —
  per-index accelerator / host-mirror footprint;
- ``nornicdb_index_rows`` / ``_capacity`` / ``_dead_fraction`` —
  liveness vs the padded slot space (compaction pressure);
- ``nornicdb_index_changelog_depth`` / ``_changelog_cap`` — how close
  the read-your-writes changelog is to overrun (overrun degrades the
  device path to host-exact serving);
- ``nornicdb_index_mutation_gap`` — mutation generations between the
  live index and the device snapshot it serves from;
- ``nornicdb_index_rebuild_in_flight`` / ``_rebuild_backlog_seconds``
  — background rebuild state and how long the backlog has been open;
- ``nornicdb_queue_depth{queue}`` — live MicroBatcher queue depth;
- ``nornicdb_compile_cache_entries{kind}`` — distinct compiled (B, k)
  buckets per dispatch kind (obs/dispatch.py's shape universe).

``/readyz`` (api/http_server.py) reads the same ``snapshot()`` to
decide readiness: pending rebuilds, near-overrun changelogs and
saturated queues degrade the node before they degrade answers.

Everything is scrape-time work: the hot path pays nothing; each
``resource_stats()`` is one short lock hold on its index.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

from nornicdb_tpu_torch.obs import dispatch as _dispatch
from nornicdb_tpu_torch.obs.metrics import REGISTRY

# gauge key -> (metric family name, stat key); every stat an index
# reports under one of these keys becomes a labeled gauge series
_INDEX_GAUGES: Tuple[Tuple[str, str], ...] = (
    ("nornicdb_index_device_bytes", "device_bytes"),
    ("nornicdb_index_host_bytes", "host_bytes"),
    ("nornicdb_index_rows", "rows"),
    ("nornicdb_index_capacity", "capacity"),
    ("nornicdb_index_dead_fraction", "dead_fraction"),
    ("nornicdb_index_changelog_depth", "changelog_depth"),
    ("nornicdb_index_changelog_cap", "changelog_cap"),
    ("nornicdb_index_mutation_gap", "mutation_gap"),
    ("nornicdb_index_rebuild_in_flight", "rebuild_in_flight"),
    ("nornicdb_index_rebuild_backlog_seconds", "rebuild_backlog_s"),
    ("nornicdb_index_quant_device_bytes", "quant_device_bytes"),
    ("nornicdb_index_compression_ratio", "compression_ratio"),
    ("nornicdb_index_partitions", "partitions"),
    ("nornicdb_index_resident_partitions", "resident_partitions"),
    ("nornicdb_index_tiered_device_bytes", "tiered_device_bytes"),
    ("nornicdb_index_disk_bytes", "disk_bytes"),
)

_HELP = {
    "nornicdb_index_device_bytes":
        "Device-resident bytes held by this index structure",
    "nornicdb_index_host_bytes":
        "Host-side bytes of the index's mirrors/tables",
    "nornicdb_index_rows": "Live rows in the index",
    "nornicdb_index_capacity": "Padded slot capacity of the index",
    "nornicdb_index_dead_fraction":
        "Tombstoned fraction of used slots (compaction pressure)",
    "nornicdb_index_changelog_depth":
        "Entries currently held in the read-your-writes changelog",
    "nornicdb_index_changelog_cap":
        "Changelog length cap (overrun degrades to host-exact serving)",
    "nornicdb_index_mutation_gap":
        "Mutation generations between live index and device snapshot",
    "nornicdb_index_rebuild_in_flight":
        "1 while a background snapshot/graph rebuild is running",
    "nornicdb_index_rebuild_backlog_seconds":
        "Age of the open background-rebuild backlog",
    "nornicdb_index_quant_device_bytes":
        "Device bytes of the index's quantized (int8/PQ) plane",
    "nornicdb_index_compression_ratio":
        "float32 bytes replaced / quantized device bytes",
    "nornicdb_index_partitions":
        "k-means partitions in the tiered plane's corpus layout",
    "nornicdb_index_resident_partitions":
        "Partitions currently holding a device slab (LRU residency)",
    "nornicdb_index_tiered_device_bytes":
        "Device bytes of the tiered plane's resident PQ slabs",
    "nornicdb_index_disk_bytes":
        "On-disk bytes of the cold partition spill store",
}

_lock = threading.Lock()
# (family, name) -> weakref to the registered object
_objects: Dict[Tuple[str, str], "weakref.ref[Any]"] = {}
# gauge series previously materialized by the collector, so series
# whose object died are removed from the exposition, not frozen
_live_series: Dict[str, set] = {}


def register(family: str, name: str, obj: Any) -> None:
    """Track one index/queue object for resource accounting. The object
    must expose ``resource_stats() -> dict`` (indexes) or
    ``queue_depth() -> int`` (queues). Registration replaces any prior
    object under the same (family, name) — index reloads re-register —
    and re-registering the SAME object is a no-op, so a second wire
    worker booting over shared structures can never churn
    the weakref or momentarily drop the series from a racing scrape."""
    with _lock:
        prior = _objects.get((str(family), str(name)))
        if prior is not None and prior() is obj:
            return
    try:
        # stamp the registration identity so the cost accounting
        # (obs/cost.py) labels per-dispatch prices with the same name
        # as the memory/freshness gauges; best-effort (slotted or
        # foreign objects simply price as 'unregistered')
        obj._obs_resource_name = str(name)
    except Exception:  # noqa: BLE001
        pass
    with _lock:
        _objects[(str(family), str(name))] = weakref.ref(obj)


def unregister(family: str, name: str) -> None:
    with _lock:
        _objects.pop((str(family), str(name)), None)


def _live_objects() -> List[Tuple[str, str, Any]]:
    dead: List[Tuple[str, str]] = []
    out: List[Tuple[str, str, Any]] = []
    with _lock:
        for (family, name), ref in _objects.items():
            obj = ref()
            if obj is None:
                dead.append((family, name))
            else:
                out.append((family, name, obj))
        for key in dead:
            _objects.pop(key, None)
    return out


def snapshot() -> List[Dict[str, Any]]:
    """Per-object resource/freshness stats for every live registered
    structure — the JSON the admin surface, /readyz and bench.py read.
    A failing stats call yields an ``error`` entry; a device fault
    (a ``RuntimeError``: CUDA errors, OOM) raises."""
    out: List[Dict[str, Any]] = []
    for family, name, obj in _live_objects():
        entry: Dict[str, Any] = {"family": family, "index": name}
        try:
            if hasattr(obj, "resource_stats"):
                entry.update(obj.resource_stats())
            elif hasattr(obj, "queue_depth"):
                entry["queue_depth"] = obj.queue_depth()
                entry["max_batch"] = getattr(obj, "_max_batch", None)
        except RuntimeError:
            raise  # a device fault (CUDA error, OOM) propagates
        except Exception as exc:  # noqa: BLE001 — scrape must not fail
            entry["error"] = f"{type(exc).__name__}: {exc}"[:200]
        out.append(entry)
    return out


def update_gauges(registry=None) -> None:
    """Collector body: derive every resource gauge from the live
    objects. Registered on the process registry, so each /metrics
    scrape (and each explicit ``run_collectors``) reflects the current
    structures; series of dead objects are dropped."""
    reg = registry if registry is not None else REGISTRY
    seen: Dict[str, set] = {}

    def set_gauge(metric: str, labels: Tuple[str, ...], value) -> None:
        if value is None:
            return
        fam = reg.gauge(metric, _HELP.get(metric, ""),
                        labels=("family", "index")
                        if metric.startswith("nornicdb_index_")
                        else (("queue",) if metric == "nornicdb_queue_depth"
                              else ("kind",)))
        fam.labels(*labels).set(float(value))
        seen.setdefault(metric, set()).add(labels)

    for entry in snapshot():
        family, name = entry["family"], entry["index"]
        if "queue_depth" in entry and "rows" not in entry:
            set_gauge("nornicdb_queue_depth", (name,),
                      entry["queue_depth"])
            continue
        for metric, key in _INDEX_GAUGES:
            if key in entry:
                set_gauge(metric, (family, name), entry.get(key))
    for kind, count in _dispatch.bucket_counts().items():
        set_gauge("nornicdb_compile_cache_entries", (kind,), count)

    # retire series whose object vanished since the last collection
    # (tracked only for the process registry; private test registries
    # are throwaway and must not disturb the shared bookkeeping)
    if reg is REGISTRY:
        global _live_series
        for metric, keys in _live_series.items():
            fam = reg.get(metric)
            if fam is None:
                continue
            for stale in keys - seen.get(metric, set()):
                fam.remove(stale)
        _live_series = seen


_HELP["nornicdb_queue_depth"] = \
    "Live pending requests in a MicroBatcher queue"
_HELP["nornicdb_compile_cache_entries"] = \
    "Distinct compiled (B, k) buckets per dispatch kind"

REGISTRY.add_collector(update_gauges)
