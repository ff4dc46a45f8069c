"""Micro-batching of concurrent single queries (counterpart of the
coalescing core of ``nornicdb_tpu/search/microbatch.py``: ``MicroBatcher``
and ``BatchCoalescer``).

A single query cannot fill the card, and a serving workload is many
concurrent single queries. The first idle request leads the next batch
and runs at once (no added latency when the service is idle); requests
arriving while a batch is in flight queue up and the next leader drains
them as ONE batched call. When the previous batch was concurrent, a
leader first waits up to ``GATHER_WINDOW_S`` for riders returning from
it; a batch holds at most ``MAX_BATCH`` requests.

Both classes record what the reference's record: batch-size, queue-depth
and convoy histograms, each rider's stage split
(``nornicdb_request_stage_seconds{surface, stage}``: ``coalesce_wait``,
``device_dispatch`` and ``merge``, or ``apply`` for a convoy) with the
same intervals as trace spans, and the riders' tenant mix around the
dispatch. A ``MicroBatcher`` dispatch runs under
``dispatch_scope("microbatch")`` and is recorded as
``record_dispatch("microbatch", pow2_bucket(B), k_max, seconds)``.
Admission lanes, deadlines and tier attribution wait for a later slice.

The batch is not padded to a power of two (that padding bounds XLA's
compile cache; the kernels here take any batch), and the answers are the
same either way. The dispatch is still recorded at its power-of-two
bucket, the reference's label, while the inner planes price the B rows
they run, so the calibration's padding efficiency reads B / bucket: the
bucket's fill, not pad rows run.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Callable, List, Sequence

import numpy as np

from nornicdb_tpu_torch.obs import (
    REGISTRY,
    SIZE_BUCKETS,
    attach_span,
    record_dispatch,
    record_stage,
)
from nornicdb_tpu_torch.obs import device as _device
from nornicdb_tpu_torch.obs import tenant as _tenant

MAX_BATCH = 64  # requests per batched call
GATHER_WINDOW_S = 0.0005  # a leader's wait for riders after a concurrent batch

# one metric family set shared by every batcher instance: the registry
# is process-global and get-or-create is idempotent
_BATCH_H = REGISTRY.histogram(
    "nornicdb_microbatch_batch_size",
    "Coalesced queries per device dispatch", buckets=SIZE_BUCKETS)
_QUEUE_H = REGISTRY.histogram(
    "nornicdb_microbatch_queue_depth",
    "Requests still pending when a batch sealed", buckets=SIZE_BUCKETS)
_CONVOY_H = REGISTRY.histogram(
    "nornicdb_convoy_batch_size",
    "Coalesced items per merged apply (write convoys)",
    buckets=SIZE_BUCKETS)
# batches sealed early for a rider's deadline: the family exists as in
# the reference; nothing increments it until deadlines are ported
_EARLY_C = REGISTRY.counter(
    "nornicdb_deadline_early_dispatch_total",
    "Batches sealed early because a rider's deadline budget was tight",
    labels=("surface",))


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b <<= 1
    return b


class _Req:
    __slots__ = ("vec", "k", "extra", "done", "result", "error",
                 "dispatch_t0", "dispatch_t1", "batch_size", "tenant")

    def __init__(self, vec: np.ndarray, k: int, extra: Any = None):
        self.vec = vec
        self.k = k
        self.extra = extra
        self.done = False
        self.result: Any = None
        self.error: Any = None
        # stamped by the batch leader: the one shared dispatch interval
        # every rider grafts into its own trace and stage split
        self.dispatch_t0 = 0.0
        self.dispatch_t1 = 0.0
        self.batch_size = 0
        # captured at enqueue: the leader binds the riders' tenant mix
        self.tenant: "str | None" = None


class MicroBatcher:
    """Coalesces concurrent ``search(vec, k)`` calls into
    ``search_batch(queries [B, D], k_max)`` calls, ``k_max`` the power of
    two at or above the batch's largest k.

    ``search_batch`` returns one result per query row, a ranked list cut
    to each request's own k. With ``pass_extras`` it is called as
    ``search_batch(queries, k_max, extras)`` with one opaque item per
    request (the hybrid path's tokens and fusion options), and each row
    comes back whole: the caller shaped it. An exception in a batched
    call replays each request alone, so a malformed request fails only
    itself and a failing dispatch reaches every rider.

    ``surface`` is the bounded, code-chosen label of the stage split
    (``service:vector``, ``service:hybrid``)."""

    def __init__(
        self,
        search_batch: Callable[..., List[Any]],
        pass_extras: bool = False,
        surface: str = "search",
    ):
        self._search_batch = search_batch
        self._pass_extras = pass_extras
        self._surface = surface
        self._max_batch = MAX_BATCH
        self._last_batch = 1
        self._cond = threading.Condition()
        self._pending: List[_Req] = []
        self._busy = False
        self.batches = 0
        self.batched_queries = 0
        self.sizes: Counter = Counter()  # batches by size

    def queue_depth(self) -> int:
        """Requests not yet claimed by a leader (the resource gauges'
        ``nornicdb_queue_depth``)."""
        with self._cond:
            return len(self._pending)

    def search(self, vec: Sequence[float], k: int, extra: Any = None) -> Any:
        t_enq = time.time()
        req = _Req(np.asarray(vec, np.float32), k, extra)
        req.tenant = _tenant.current_tenant()
        with self._cond:
            self._pending.append(req)
        while True:
            with self._cond:
                while not req.done and self._busy:
                    self._cond.wait(timeout=30.0)
                if req.done:
                    break
                # the previous batch was concurrent: give its returning
                # clients one short window to re-enqueue before sealing
                if (self._last_batch >= 2
                        and len(self._pending) < min(self._last_batch, MAX_BATCH)):
                    self._cond.wait(timeout=GATHER_WINDOW_S)
                    if req.done:
                        break
                    if self._busy:
                        continue  # another thread led while we waited
                batch = self._pending[:MAX_BATCH]
                del self._pending[:MAX_BATCH]
                if not batch:
                    continue
                _QUEUE_H.observe(len(self._pending))
                self._busy = True
            try:
                self._run(batch)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
            if req.done:
                break
            # our request was queued behind the batch we led: go again
        self._trace_req(req, t_enq)
        if req.error is not None:
            raise req.error
        return req.result

    def _trace_req(self, req: _Req, t_enq: float) -> None:
        """This rider's coalescing story in the stage histograms and the
        active trace: the wait from enqueue to the leader's dispatch, the
        shared dispatch interval and the post-dispatch merge. The
        histogram half runs without an active trace too. Nothing when the
        request failed before a dispatch."""
        if not req.dispatch_t1:
            return
        t_done = time.time()
        record_stage(self._surface, "coalesce_wait", req.dispatch_t0 - t_enq)
        record_stage(self._surface, "device_dispatch",
                     req.dispatch_t1 - req.dispatch_t0)
        record_stage(self._surface, "merge", t_done - req.dispatch_t1)
        attach_span("coalesce.wait", t_enq, req.dispatch_t0,
                    surface=self._surface, batch=req.batch_size)
        attach_span("device.dispatch", req.dispatch_t0, req.dispatch_t1,
                    surface=self._surface, batch=req.batch_size, k=req.k)
        attach_span("merge", req.dispatch_t1, t_done)

    def _dispatch(self, batch: List[_Req], k: int) -> List[Any]:
        """One batched call under the riders' tenant mix and the
        ``microbatch`` dispatch scope, timed to device completion on a
        sampled call, recorded at its power-of-two bucket."""
        b = len(batch)
        queries = np.stack([r.vec for r in batch])
        t0 = time.time()
        with _tenant.batch_scope([r.tenant for r in batch]):
            with _device.dispatch_scope("microbatch"):
                _device.note_real_rows(float(b))
                if self._pass_extras:
                    results = self._search_batch(queries, k, [r.extra for r in batch])
                else:
                    results = self._search_batch(queries, k)
                _device.maybe_sync(results)
                t1 = time.time()
            record_dispatch("microbatch", pow2_bucket(b), k, t1 - t0)
        for r in batch:
            r.dispatch_t0, r.dispatch_t1 = t0, t1
            r.batch_size = b
        return results

    def _deliver(self, r: _Req, res: Any, k: int) -> None:
        r.result = res if self._pass_extras or r.k >= k else res[: r.k]

    def _run(self, batch: List[_Req]) -> None:
        self.batches += 1
        self.batched_queries += len(batch)
        self.sizes[len(batch)] += 1
        self._last_batch = len(batch)
        _BATCH_H.observe(len(batch))
        try:
            k_max = pow2_bucket(max(r.k for r in batch))
            for r, res in zip(batch, self._dispatch(batch, k_max)):
                self._deliver(r, res, k_max)
        except Exception:  # noqa: BLE001 -- replayed per request below
            for r in batch:
                try:
                    k1 = pow2_bucket(max(r.k, 1))
                    self._deliver(r, self._dispatch([r], k1)[0], k1)
                except Exception as exc:  # noqa: BLE001 -- raised to its owner
                    r.error = exc
        finally:
            for r in batch:
                r.done = True


class _Item:
    __slots__ = ("value", "done", "result", "error", "apply_t0", "apply_t1",
                 "batch_size", "tenant")

    def __init__(self, value: Any):
        self.value = value
        self.done = False
        self.result: Any = None
        self.error: Any = None
        # stamped by the convoy leader: the shared merged-apply interval
        self.apply_t0 = 0.0
        self.apply_t1 = 0.0
        self.batch_size = 0
        self.tenant: "str | None" = None


class BatchCoalescer:
    """Leader-elected coalescer for any batchable operation (the device
    graph plane's chain lookups): N concurrent ``submit`` calls become one
    ``apply_batch(values) -> results`` call, one result per value, run on
    the leader's thread.

    An exception in ``apply_batch`` reaches every waiter of that batch,
    unless ``apply_single`` is given: then each value is applied alone, so
    one poisoned value fails only its own caller. ``surface`` labels the
    stage split (``coalesce_wait``, ``apply``)."""

    def __init__(self, apply_batch: Callable[[List[Any]], List[Any]],
                 apply_single: Callable[[Any], Any] = None, max_batch: int = MAX_BATCH,
                 surface: str = "convoy"):
        self._apply_batch = apply_batch
        self._apply_single = apply_single
        self._max_batch = max_batch
        self._surface = surface
        self._cond = threading.Condition()
        self._pending: List[_Item] = []
        self._busy = False
        self.batches = 0
        self.batched_items = 0

    def queue_depth(self) -> int:
        """Items not yet claimed by a leader."""
        with self._cond:
            return len(self._pending)

    def submit(self, value: Any) -> Any:
        t_enq = time.time()
        item = _Item(value)
        item.tenant = _tenant.current_tenant()
        with self._cond:
            self._pending.append(item)
        while True:
            with self._cond:
                while not item.done and self._busy:
                    self._cond.wait(timeout=30.0)
                if item.done:
                    break
                batch = self._pending[:self._max_batch]
                del self._pending[:self._max_batch]
                if not batch:
                    continue  # taken by another leader, not done yet
                self._busy = True
            try:
                self._run(batch)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
            if item.done:
                break
        if item.apply_t1:
            # the wait from enqueue to the leader sealing our convoy, and
            # the shared merged apply every convoy-mate experienced
            record_stage(self._surface, "coalesce_wait", item.apply_t0 - t_enq)
            record_stage(self._surface, "apply", item.apply_t1 - item.apply_t0)
            attach_span("coalesce.wait", t_enq, item.apply_t0,
                        surface=self._surface, batch=item.batch_size)
            attach_span("apply", item.apply_t0, item.apply_t1,
                        surface=self._surface, batch=item.batch_size)
        if item.error is not None:
            raise item.error
        return item.result

    def _run(self, batch: List[_Item]) -> None:
        self.batches += 1
        self.batched_items += len(batch)
        _CONVOY_H.observe(len(batch))
        t0 = time.time()
        for item in batch:
            item.apply_t0 = t0
            item.batch_size = len(batch)
        try:
            # the riders' tenant mix binds around the merged apply, so any
            # cost recorded inside splits per tenant
            with _tenant.batch_scope([i.tenant for i in batch]):
                results = self._apply_batch([i.value for i in batch])
            for item, res in zip(batch, results):
                item.result = res
        except Exception as exc:  # noqa: BLE001 -- delivered to each waiter
            if self._apply_single is None or len(batch) == 1:
                for item in batch:
                    item.error = exc
            else:
                for item in batch:
                    try:
                        with _tenant.batch_scope([item.tenant]):
                            item.result = self._apply_single(item.value)
                    except Exception as single_exc:  # noqa: BLE001
                        item.error = single_exc
        except BaseException as exc:  # an interrupt: no waiter may read a None
            for item in batch:
                item.error = exc
            raise
        finally:
            t1 = time.time()
            for item in batch:
                item.apply_t1 = t1
                item.done = True
