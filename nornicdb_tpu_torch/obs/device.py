"""Device-truth calibration plane: measured dispatch timing, cost-model
calibration, and device-memory reconciliation (a copy of
``nornicdb_tpu/obs/device.py`` but for its two device seams).

The cost layer (obs/cost.py) prices dispatches from padded shapes, the
dispatch-bucket instrument (obs/dispatch.py) folds first-use cost into
first-call wall time, and the ``nornicdb_index_device_bytes`` gauges
are shape-derived assertions, not measurements. This module closes the
loop three ways:

1. **Measured service-time models.** Every ``record_dispatch`` feeds a
   per-(kind, pow2-batch-bucket) EWMA of steady-state execute seconds.
   Steady updates are sampled (``NORNICDB_DEVICE_TIMING_SAMPLE``) so
   the 2x+1ms overhead guard holds; first calls always record. The
   steady-state estimate subtracts out of first-call wall time —
   ``nornicdb_device_compile_seconds`` is the calibrated first-use
   split, and a first call appearing after a kind is warm is an
   *unexpected recompile* (counter + ``recompile`` journal event):
   bucket churn caught as an incident, not a latency mystery.

2. **Calibration.** Measurements join the analytic FLOPs/bytes into
   effective FLOPs/s, bytes/s and padding efficiency (real rows /
   padded rows) per kind — the roofline view: effective rates tell
   compute- from bandwidth-bound dispatches apart on the card.
   Cost recorded while a :func:`dispatch_scope` is active credits the
   *serving* dispatch kind (a brute plane priced under a MicroBatcher
   credits ``microbatch``), so the join divides like with like.

3. **Device-memory ledger.** The shape-derived gauges are reconciled
   against the CUDA caching allocator's own accounting
   (``torch.cuda.memory_allocated`` of the module's device). On the
   CPU :func:`backend_bytes` is None and reconciliation abstains:
   PyTorch keeps no live-tensor ledger (the reference sums
   ``jax.live_arrays()`` there). Sustained drift past
   ``NORNICDB_DEVICE_MEM_DRIFT_BYTES`` is a leak verdict with its own
   metric family.

The two device seams let device faults through: a sampled
:func:`maybe_sync` synchronizes the streams of the result's CUDA
tensors and raises what the sync raises, and :func:`backend_bytes`
raises what ``memory_allocated`` raises. Only a result with no tensor
on the card is never synchronized.

:func:`predict_ms` gives admission a calibrated per-query cost
estimate — confidence-gated (below ``NORNICDB_DEVICE_MIN_SAMPLES`` it
returns None: the caller falls back to queue-wait-only, never a guess).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from nornicdb_tpu_torch._device import resolve_device
from nornicdb_tpu_torch.config import env_float, env_int
from nornicdb_tpu_torch.errors import is_device_fault
from nornicdb_tpu_torch.obs import metrics as _m
from nornicdb_tpu_torch.obs.metrics import REGISTRY

_lock = threading.Lock()
_tls = threading.local()

# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------

_COMPILE_S_G = REGISTRY.gauge(
    "nornicdb_device_compile_seconds",
    "Calibrated compile time per bucket: first-call wall time minus "
    "the steady-state execute estimate (set once the bucket's EWMA is "
    "confident)", labels=("kind", "b", "k"))
_RECOMPILE_C = REGISTRY.counter(
    "nornicdb_device_unexpected_recompile_total",
    "Compiles observed after the kind was warm (bucket churn at serve "
    "time)", labels=("kind",))
_EFF_FLOPS_G = REGISTRY.gauge(
    "nornicdb_device_eff_flops_per_s",
    "Effective FLOPs/s per dispatch kind: analytic padded-shape FLOPs "
    "over measured execute seconds", labels=("kind",))
_EFF_BYTES_G = REGISTRY.gauge(
    "nornicdb_device_eff_bytes_per_s",
    "Effective bytes/s per dispatch kind: analytic padded-shape bytes "
    "over measured execute seconds", labels=("kind",))
_PAD_EFF_G = REGISTRY.gauge(
    "nornicdb_device_padding_efficiency",
    "Real rows / padded rows per dispatch kind (1.0 = no pow2-pad "
    "waste)", labels=("kind",))
_MEM_LEDGER_G = REGISTRY.gauge(
    "nornicdb_device_mem_ledger_bytes",
    "Shape-derived device bytes: what the resource accounting claims "
    "is resident")
_MEM_BACKEND_G = REGISTRY.gauge(
    "nornicdb_device_mem_backend_bytes",
    "Backend-reported device bytes (torch.cuda.memory_allocated of the "
    "ledger's device)")
_MEM_DRIFT_G = REGISTRY.gauge(
    "nornicdb_device_mem_drift_bytes",
    "backend - ledger: positive means bytes the accounting cannot "
    "name (the leak direction)")
_MEM_LEAK_C = REGISTRY.counter(
    "nornicdb_device_mem_leak_total",
    "Sustained-drift episodes: |drift| stayed past the bound for the "
    "full detection window")

# ---------------------------------------------------------------------------
# cached configuration (env read once; per-request paths read the dict)
# ---------------------------------------------------------------------------

_cfg_lock = threading.Lock()
_cfg: Optional[Dict[str, Any]] = None


def _load_cfg() -> Dict[str, Any]:
    sample = env_float("DEVICE_TIMING_SAMPLE", 1.0)
    sample = min(max(sample, 0.0), 1.0)
    return {
        # fraction of steady-state dispatches that update the EWMA (and
        # pay the explicit block_until_ready at seams that use
        # maybe_sync); internally a 1-in-N tick so the decision is a
        # modulo, not an RNG draw
        "sample_every": 0 if sample <= 0.0 else max(1, round(1.0 / sample)),
        "ewma_alpha": env_float("DEVICE_EWMA_ALPHA", 0.2),
        # predict_ms confidence gate: below this many steady samples
        # the model abstains (admission falls back to queue-wait-only)
        "min_samples": env_int("DEVICE_MIN_SAMPLES", 8),
        # dispatches per kind after which a new (b, k) shape counts as
        # an unexpected recompile
        "recompile_warmup": env_int("DEVICE_RECOMPILE_WARMUP", 32),
        "mem_drift_bytes": env_int("DEVICE_MEM_DRIFT_BYTES", 64 << 20),
        "mem_drift_s": env_float("DEVICE_MEM_DRIFT_S", 60.0),
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
    """Drop the cached env-derived config (tests; admin flags)."""
    global _cfg
    with _cfg_lock:
        _cfg = None


# ---------------------------------------------------------------------------
# per-kind / per-bucket state
# ---------------------------------------------------------------------------

# kind -> {"dispatches", "top_dispatches", "measured_s", "padded_rows",
#          "real_rows", "flops", "bytes"}
_kinds: Dict[str, Dict[str, float]] = {}
# (kind, b) -> {"n": steady samples ingested, "ewma_s": execute est}
_models: Dict[Tuple[str, int], Dict[str, float]] = {}
# (kind, b, k) -> first-call wall seconds (the conflated compile+execute)
_first: Dict[Tuple[str, int, int], float] = {}
_tick = 0

# memory-ledger episode state
_drift_since: Optional[float] = None
_leak_flagged = False
_backend_probe: Optional[Callable[[], Optional[float]]] = None
# the device whose allocator backend_bytes reads (ledger_device)
_backend_device: Optional[torch.device] = None


def _kind_entry(kind: str) -> Dict[str, float]:
    e = _kinds.get(kind)
    if e is None:
        e = {"dispatches": 0, "top_dispatches": 0, "measured_s": 0.0,
             "padded_rows": 0, "real_rows": 0.0, "flops": 0.0,
             "bytes": 0.0}
        _kinds[kind] = e
    return e


# ---------------------------------------------------------------------------
# the record_dispatch seam
# ---------------------------------------------------------------------------


class _DispatchScope:
    __slots__ = ("_kind", "_prev")

    def __init__(self, kind: str) -> None:
        self._kind = kind

    def __enter__(self) -> "_DispatchScope":
        self._prev = getattr(_tls, "scope", None)
        _tls.scope = self._kind
        return self

    def __exit__(self, *exc) -> None:
        _tls.scope = self._prev


def dispatch_scope(kind: str) -> _DispatchScope:
    """Bind the *serving* dispatch kind around a batched dispatch:
    cost priced inside the scope credits ``kind`` (a brute plane under
    a MicroBatcher prices as ``microbatch``), and inner
    ``record_dispatch`` calls are tagged nested so coverage counts
    top-level serving kinds only. Outermost scope wins."""
    return _DispatchScope(kind)


# how deep maybe_sync looks for tensors: a batch (0) of rows (1) of
# fields (2). The port's batched results are host lists, so every level
# more is a walk over (id, score) pairs that finds nothing.
_SYNC_DEPTH = 2


# items that are never tensors, skipped by their exact type (a
# ``torch.Tensor`` isinstance check costs a metaclass call)
_PLAIN = frozenset((str, int, float, bool, type(None), tuple, list, dict))


def _cuda_devices(x: Any, depth: int, devices: Dict[Any, None]) -> None:
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return
    for y in x:
        if type(y) in _PLAIN:
            if depth + 1 < _SYNC_DEPTH and type(y) in (tuple, list, dict):
                _cuda_devices(y, depth + 1, devices)
        elif isinstance(y, torch.Tensor):
            if y.is_cuda:
                devices[y.device] = None
        elif depth + 1 < _SYNC_DEPTH:
            _cuda_devices(y, depth + 1, devices)


def _cuda_streams(result: Any) -> List[Any]:
    """The current stream of every CUDA device a tensor of ``result``
    lives on: the result itself, its items, and their items (lists,
    tuples and dict values), down to ``_SYNC_DEPTH``."""
    devices: Dict[Any, None] = {}
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            devices[result.device] = None
    else:
        _cuda_devices(result, 0, devices)
    return [torch.cuda.current_stream(d) for d in devices]


def maybe_sync(result: Any = None) -> bool:
    """The sampled timing bracket: decide whether THIS dispatch is a
    calibration sample and, when it is, synchronize the streams of the
    result's CUDA tensors so the caller's ``t1`` measures device
    completion, not enqueue. A CUDA error at that sync propagates.
    Callers that materialize results to host anyway pay nothing extra
    (no tensor on the card, no sync); the decision is stashed
    thread-locally for the ``record_dispatch`` observer to consume."""
    global _tick
    if not _m.enabled():
        return False
    every = cfg()["sample_every"]
    if every <= 0:
        _tls.sampled = False
        return False
    with _lock:
        _tick += 1
        sampled = (_tick % every) == 0
    _tls.sampled = sampled
    if sampled and result is not None:
        for stream in _cuda_streams(result):
            stream.synchronize()
    return sampled


def _consume_sample_decision() -> Optional[bool]:
    s = getattr(_tls, "sampled", None)
    if s is not None:
        _tls.sampled = None
    return s


def observe_dispatch(kind: str, b: int, k: int, seconds: float,
                     first: bool) -> None:
    """Observer registered with obs.dispatch: every recorded dispatch
    lands here (telemetry already gated by the caller)."""
    global _tick
    c = cfg()
    scope = getattr(_tls, "scope", None)
    nested = scope is not None and scope != kind
    recompile = False
    with _lock:
        e = _kind_entry(kind)
        warm = e["dispatches"] >= c["recompile_warmup"]
        e["dispatches"] += 1
        e["measured_s"] += seconds
        e["padded_rows"] += int(b)
        if not nested:
            e["top_dispatches"] += 1
        key = (kind, int(b))
        mdl = _models.get(key)
        if mdl is None:
            mdl = {"n": 0, "ewma_s": 0.0}
            _models[key] = mdl
        if first:
            _first[(kind, int(b), int(k))] = seconds
            recompile = warm
        else:
            sampled = _consume_sample_decision()
            if sampled is None:
                every = c["sample_every"]
                if every > 0:
                    _tick += 1
                    sampled = (_tick % every) == 0
                else:
                    sampled = False
            if sampled:
                if mdl["n"] == 0:
                    mdl["ewma_s"] = seconds
                else:
                    a = c["ewma_alpha"]
                    mdl["ewma_s"] += a * (seconds - mdl["ewma_s"])
                mdl["n"] += 1
    if recompile:
        _RECOMPILE_C.labels(kind).inc()
        from nornicdb_tpu_torch.obs import events as _events

        _events.record_event(
            "recompile", surface=kind, reason="bucket_churn",
            detail={"b": int(b), "k": int(k),
                    "first_call_ms": round(seconds * 1e3, 3)})
    # per-tenant device-seconds: the measured wall
    # time splits across the batch riders by tenant, the same rider-mix
    # channel the FLOPs meter uses
    from nornicdb_tpu_torch.obs import tenant as _tenant

    _tenant.record_device_seconds(seconds)


def note_real_rows(rows: float) -> None:
    """Pin the REAL (pre-padding) rider count for the cost about to be
    priced under the active :func:`dispatch_scope`. The self-aligned
    device modules price ``queries`` pre-padding already; a coalescer
    hands its inner plane the PADDED array, so without this note the
    padding-efficiency join would read the pad rows as real work."""
    _tls.real_rows = rows


def note_cost(kind: str, queries: float, flops: float,
              bytes_: float) -> None:
    """Observer registered with obs.cost: analytic cost credited to the
    active dispatch scope (the serving kind) or, absent one, to the
    cost kind itself (the self-aligned device modules)."""
    credit = getattr(_tls, "scope", None) or kind
    rr = getattr(_tls, "real_rows", None)
    if rr is not None:
        _tls.real_rows = None
    with _lock:
        e = _kind_entry(credit)
        e["flops"] += flops
        e["bytes"] += bytes_
        e["real_rows"] += queries if rr is None else rr


# ---------------------------------------------------------------------------
# prediction (the admission consumer)
# ---------------------------------------------------------------------------


def predict_ms(kind: str, b: int) -> Optional[float]:
    """Calibrated steady-state service-time estimate for one dispatch
    of ``kind`` at batch bucket ``b`` — or None below the confidence
    floor (the caller must fall back, never guess). Per-request hot
    path: one dict read under the lock, no env access."""
    min_n = cfg()["min_samples"]
    with _lock:
        mdl = _models.get((kind, int(b)))
        if mdl is None or mdl["n"] < min_n:
            return None
        return mdl["ewma_s"] * 1e3


# ---------------------------------------------------------------------------
# calibration summaries
# ---------------------------------------------------------------------------


def _kind_doc_locked(kind: str, min_n: int) -> Dict[str, Any]:
    e = _kinds[kind]
    compile_s = 0.0
    compile_shapes = 0
    for (fk, fb, fkk), first_s in _first.items():
        if fk != kind:
            continue
        mdl = _models.get((fk, fb))
        if mdl is not None and mdl["n"] >= min_n:
            compile_s += max(first_s - mdl["ewma_s"], 0.0)
            compile_shapes += 1
    execute_s = max(e["measured_s"] - compile_s, 0.0)
    flops, byts = e["flops"], e["bytes"]
    eff_flops = flops / execute_s if flops > 0 and execute_s > 0 else None
    eff_bytes = byts / execute_s if byts > 0 and execute_s > 0 else None
    pad_eff = (min(e["real_rows"] / e["padded_rows"], 1.0)
               if e["padded_rows"] and e["real_rows"] else None)
    buckets = {}
    for (mk, mb), mdl in _models.items():
        if mk != kind:
            continue
        buckets[str(mb)] = {
            "samples": mdl["n"],
            "execute_ms": (round(mdl["ewma_s"] * 1e3, 4)
                           if mdl["n"] else None),
            "confident": mdl["n"] >= min_n,
        }
    return {
        "dispatches": int(e["dispatches"]),
        "top_dispatches": int(e["top_dispatches"]),
        "measured_s": round(e["measured_s"], 6),
        "compile_s_est": round(compile_s, 6),
        "compile_shapes_split": compile_shapes,
        "execute_s": round(execute_s, 6),
        "flops": flops,
        "bytes": byts,
        "eff_flops_per_s": eff_flops,
        "eff_bytes_per_s": eff_bytes,
        "padding_efficiency": (round(pad_eff, 4)
                               if pad_eff is not None else None),
        "buckets": buckets,
    }


def _calibrated(doc: Dict[str, Any]) -> bool:
    return (doc["eff_flops_per_s"] is not None
            and doc["padding_efficiency"] is not None
            and any(bk["confident"] for bk in doc["buckets"].values()))


def calibration_summary() -> Dict[str, Any]:
    """Per-kind roofline view + the coverage verdict the sentinel
    gates: every top-level served dispatch kind must carry effective
    FLOPs/s and padding efficiency."""
    min_n = cfg()["min_samples"]
    with _lock:
        kinds = {k: _kind_doc_locked(k, min_n) for k in sorted(_kinds)}
    served = [k for k, d in kinds.items() if d["top_dispatches"] > 0]
    calibrated = [k for k in served if _calibrated(kinds[k])]
    coverage = (len(calibrated) / len(served)) if served else 1.0
    return {
        "kinds": kinds,
        "served_kinds": served,
        "calibrated_kinds": calibrated,
        "calibration_coverage": round(coverage, 4),
        "unexpected_recompiles": int(sum(
            ch.value for ch in _RECOMPILE_C.children().values())),
        "min_samples": min_n,
        "sample_every": cfg()["sample_every"],
    }


# ---------------------------------------------------------------------------
# device-memory ledger
# ---------------------------------------------------------------------------


def set_backend_probe(
        fn: Optional[Callable[[], Optional[float]]]) -> None:
    """Override the backend live-bytes probe (tests inject drift; a
    remote-backend deployment can plug its own accounting)."""
    global _backend_probe
    _backend_probe = fn


# PyTorch's default cuBLAS workspace: 32 MiB on sm90 (Hopper), else
# 2 x 4 MiB + 8 x 16 KiB (at::cuda::getChosenWorkspaceSize)
_CUBLAS_WS_SM90 = 4096 * 8 * 1024
_CUBLAS_WS_OTHER = 4096 * 1024 * 2 + 16 * 1024 * 8


def cublas_workspace_size(capability: Tuple[int, int],
                          config: Optional[str] = None) -> int:
    """The bytes of one cuBLAS workspace, as PyTorch chooses them:
    ``CUBLAS_WORKSPACE_CONFIG``'s ``:SIZE_KiB:COUNT`` pairs summed, else the
    default of the card's architecture."""
    import os
    import re

    config = os.environ.get("CUBLAS_WORKSPACE_CONFIG") if config is None else config
    if config is not None:
        pairs = re.findall(r":([0-9]+):([0-9]+)", config)
        return sum(int(size) * 1024 * int(count) for size, count in pairs)
    return _CUBLAS_WS_SM90 if tuple(capability) == (9, 0) else _CUBLAS_WS_OTHER


# how far the walk over a resource's attributes looks for the tensors it
# holds: snapshots keep theirs in dicts, lists and tuples a few levels
# down; a container of more entries than _HELD_ITEMS is an id map, not a
# set of device arrays, and is not entered
_HELD_DEPTH = 4
_HELD_ITEMS = 256


def _held(value: Any, depth: int, out: set) -> None:
    if isinstance(value, torch.Tensor):
        if value.layout == torch.strided:
            out.add(value.untyped_storage().data_ptr())
        return
    if depth == 0 or not isinstance(value, (dict, list, tuple)) or len(value) > _HELD_ITEMS:
        return
    for item in list(value.values() if isinstance(value, dict) else value):
        _held(item, depth - 1, out)


def held_storage_ptrs(skip: Any = None) -> set:
    """The storage addresses of the tensors that the live registered
    resources (``skip`` aside) hold in their attributes, or in dicts,
    lists and tuples there, ``_HELD_DEPTH`` levels down."""
    from nornicdb_tpu_torch.obs import resources as _resources

    out: set = set()
    for _family, _name, obj in _resources._live_objects():
        if obj is skip:
            continue
        for value in list(getattr(obj, "__dict__", {}).values()):
            _held(value, _HELD_DEPTH, out)
    return out


class CublasWorkspaces:
    """The cuBLAS workspaces of one card as a resource of the ledger.

    PyTorch gives every (cuBLAS handle, stream) pair that runs a product a
    workspace of its own, held by the caching allocator for the life of
    the process; a handle belongs to a thread while it lives, so a server
    whose threads run products holds one workspace per thread that ever
    ran one at a time (32 MiB each on Hopper). They are bytes the indexes'
    gauges cannot name, so the drift would read them as a leak (ROADMAP
    C40). This resource reads them from the allocator's state: the
    active blocks of the card whose requested size is one workspace, less
    the blocks that hold a tensor of another registered resource (an
    index's matrix can be exactly one workspace: 1,024 dims at 8,192
    rows). The blocks come from ``torch.cuda.memory_snapshot()``, read
    again only once the allocator has allocated or freed since the last
    read; it never clears them. Where there is no CUDA allocator it reads
    0."""

    def __init__(self, device: torch.device):
        self.device = device  # as resolve_device gave it (the ledger's device)
        self._lock = threading.Lock()
        self._read: Optional[Tuple[Any, ...]] = None  # the allocator's counters at the last read
        self._blocks: frozenset = frozenset()  # addresses of the blocks of one workspace's size

    def _sized_blocks(self, index: int, size: int) -> frozenset:
        stats = torch.cuda.memory_stats(index)
        read = (stats.get("allocation.all.allocated"), stats.get("allocation.all.freed"), size)
        with self._lock:
            if read == self._read:
                return self._blocks
        found = set()
        for seg in torch.cuda.memory_snapshot():
            if seg.get("device") != index:
                continue
            address = seg.get("address", 0)
            for block in seg.get("blocks", ()):
                if block.get("state") == "active_allocated" \
                        and block.get("requested_size", block.get("size")) == size:
                    found.add(block.get("address", address))
                address += block.get("size", 0)
        with self._lock:
            self._read, self._blocks = read, frozenset(found)
        return self._blocks

    def workspaces(self) -> Tuple[int, int]:
        """(count, bytes of one) of the live workspaces on the card."""
        if not torch.cuda.is_available():
            return 0, 0
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        size = cublas_workspace_size(torch.cuda.get_device_capability(index))
        blocks = self._sized_blocks(index, size)
        if blocks:
            blocks = blocks - held_storage_ptrs(skip=self)
        return len(blocks), size

    def resource_stats(self) -> Dict[str, float]:
        count, size = self.workspaces()
        return {"device_bytes": count * size, "workspaces": count,
                "workspace_bytes": size}


_workspaces: Dict[int, CublasWorkspaces] = {}


def track_cublas_workspaces(device: torch.device) -> None:
    """Register the card's cuBLAS workspaces with the resource ledger
    (once per card; ``resolve_device`` calls it for every CUDA device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _lock:
        res = _workspaces.get(index)
        if res is None:
            res = _workspaces[index] = CublasWorkspaces(device)
    from nornicdb_tpu_torch.obs import resources as _resources

    _resources.register("cublas", f"workspaces:cuda:{index}", res)


def ledger_bytes() -> float:
    """Shape-derived device bytes: every ``*device_bytes`` stat the
    resource accounting carries (brute/quant/tiered slabs, graph
    snapshots, background plane)."""
    from nornicdb_tpu_torch.obs import resources as _resources

    total = 0.0
    for entry in _resources.snapshot():
        for key, val in entry.items():
            if not isinstance(val, (int, float)):
                continue
            if key == "device_bytes" or key.endswith("_device_bytes"):
                total += float(val)
    return total


def ledger_device() -> Optional[torch.device]:
    """The device the ledger reconciles: the ``device`` instance
    attribute of the first registered resource that has one (a lazily
    resolving ``device`` property is never forced), else the port's
    default (``resolve_device``) when a card is present. None on a
    CPU-only host with nothing registered: CUDA is never touched where
    the caller asked for the CPU. Learned once, until ``reset``."""
    global _backend_device
    dev = _backend_device
    if dev is not None:
        return dev
    from nornicdb_tpu_torch.obs import resources as _resources

    for _family, _name, obj in _resources._live_objects():
        found = getattr(obj, "__dict__", {}).get("device")
        if isinstance(found, (str, torch.device)):
            _backend_device = torch.device(found)
            return _backend_device
    if torch.cuda.is_available():
        return resolve_device(None)
    return None


def backend_bytes() -> Optional[float]:
    """The backend's own accounting: ``torch.cuda.memory_allocated`` of
    the ledger's device, raising what it raises. None on the CPU, so
    reconciliation abstains rather than reporting a fake zero drift
    (PyTorch has no live-tensor sum; the reference's ``live_arrays``
    has no counterpart). An injected probe wins."""
    probe = _backend_probe
    if probe is not None:
        return probe()
    dev = ledger_device()
    if dev is None or dev.type != "cuda":
        return None
    return float(torch.cuda.memory_allocated(dev))


def reconcile(now: Optional[float] = None) -> Dict[str, Any]:
    """One ledger pass: publish the three gauges and run the sustained
    -drift leak detector. |drift| must sit past the bound for the full
    window before the episode counts — a transient allocation burst
    (mid-rebuild double residency) is not a leak."""
    global _drift_since, _leak_flagged
    c = cfg()
    now = time.time() if now is None else now
    ledger = ledger_bytes()
    backend = backend_bytes()
    drift = (backend - ledger) if backend is not None else None
    _MEM_LEDGER_G.set(ledger)
    if backend is not None:
        _MEM_BACKEND_G.set(backend)
        _MEM_DRIFT_G.set(drift)
    sustained_s = 0.0
    if drift is not None and abs(drift) > c["mem_drift_bytes"]:
        if _drift_since is None:
            _drift_since = now
        sustained_s = now - _drift_since
        if sustained_s >= c["mem_drift_s"] and not _leak_flagged:
            _leak_flagged = True
            _MEM_LEAK_C.inc()
    else:
        _drift_since = None
        _leak_flagged = False
    return {
        "ledger_bytes": int(ledger),
        "backend_bytes": None if backend is None else int(backend),
        "drift_bytes": None if drift is None else int(drift),
        "bound_bytes": int(c["mem_drift_bytes"]),
        "window_s": c["mem_drift_s"],
        "sustained_s": round(sustained_s, 3),
        "leak_suspected": bool(_leak_flagged),
    }


# ---------------------------------------------------------------------------
# the admin payload + scrape-time collector
# ---------------------------------------------------------------------------


def device_summary() -> Dict[str, Any]:
    """The ``GET /admin/device`` payload: calibration roofline, compile
    split, and the memory ledger in one document."""
    cal = calibration_summary()
    cal["memory"] = reconcile()
    return cal


def _collect() -> None:
    """Scrape-time publication: calibrated gauges + the memory ledger.
    Runs on every /metrics render (the resources.update_gauges
    precedent) — never on the request path."""
    if not _m.enabled():
        return
    min_n = cfg()["min_samples"]
    with _lock:
        kinds = {k: _kind_doc_locked(k, min_n) for k in _kinds}
        firsts = dict(_first)
        models = {k: dict(v) for k, v in _models.items()}
    for kind, doc in kinds.items():
        if doc["eff_flops_per_s"] is not None:
            _EFF_FLOPS_G.labels(kind).set(doc["eff_flops_per_s"])
        if doc["eff_bytes_per_s"] is not None:
            _EFF_BYTES_G.labels(kind).set(doc["eff_bytes_per_s"])
        if doc["padding_efficiency"] is not None:
            _PAD_EFF_G.labels(kind).set(doc["padding_efficiency"])
    # the calibrated compile split (the first-call conflation, fixed): only
    # shapes whose bucket has a confident steady-state estimate
    for (kind, b, k), first_s in firsts.items():
        mdl = models.get((kind, b))
        if mdl is not None and mdl["n"] >= min_n:
            _COMPILE_S_G.labels(kind, b, k).set(
                max(first_s - mdl["ewma_s"], 0.0))
    try:
        reconcile()
    except Exception as exc:  # noqa: BLE001 — a probe failure must not fail scrape
        if is_device_fault(exc):
            raise  # a device fault (CUDA error, OOM) is never a quiet scrape


REGISTRY.add_collector(_collect)


def reset() -> None:
    """Test/bench helper: forget models, joins and ledger episode state
    (registry counters keep their monotone totals)."""
    global _tick, _drift_since, _leak_flagged, _backend_device
    with _lock:
        _kinds.clear()
        _models.clear()
        _first.clear()
        _tick = 0
    _drift_since = None
    _leak_flagged = False
    _backend_device = None


# hook registration: dispatch/cost call these per record; device.py
# imports them (not vice versa) so obs/__init__'s import order stays
# dispatch -> cost -> tenant -> device with no cycle
from nornicdb_tpu_torch.obs import cost as _cost  # noqa: E402
from nornicdb_tpu_torch.obs import dispatch as _dispatch  # noqa: E402

_dispatch.set_observer(observe_dispatch)
_cost.set_observer(note_cost)
