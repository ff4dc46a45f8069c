"""Micro-batching of concurrent single queries (counterpart of the
coalescing core of ``nornicdb_tpu/search/microbatch.py``: ``MicroBatcher``
and ``BatchCoalescer``).

A single query cannot fill the card, and a serving workload is many
concurrent single queries. The first idle request leads the next batch
and runs at once (no added latency when the service is idle); requests
arriving while a batch is in flight queue up and the next leader drains
them as ONE batched call. When the previous batch was concurrent, a
leader first waits up to ``GATHER_WINDOW_S`` for riders returning from
it; a batch holds at most ``MAX_BATCH`` requests. Admission lanes,
deadlines, tenants, stage tracing and tier attribution wait for later
slices, in both classes.
The batch is not padded to a power of two (that padding bounds XLA's
compile cache; the kernels here take any batch), and the answers are the
same either way.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Any, Callable, List, Sequence

import numpy as np

MAX_BATCH = 64  # requests per batched call
GATHER_WINDOW_S = 0.0005  # a leader's wait for riders after a concurrent batch


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b <<= 1
    return b


class _Req:
    __slots__ = ("vec", "k", "extra", "done", "result", "error")

    def __init__(self, vec: np.ndarray, k: int, extra: Any = None):
        self.vec = vec
        self.k = k
        self.extra = extra
        self.done = False
        self.result: Any = None
        self.error: Any = None


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
    itself and a failing dispatch reaches every rider."""

    def __init__(
        self,
        search_batch: Callable[..., List[Any]],
        pass_extras: bool = False,
    ):
        self._search_batch = search_batch
        self._pass_extras = pass_extras
        self._last_batch = 1
        self._cond = threading.Condition()
        self._pending: List[_Req] = []
        self._busy = False
        self.batches = 0
        self.batched_queries = 0
        self.sizes: Counter = Counter()  # batches by size

    def search(self, vec: Sequence[float], k: int, extra: Any = None) -> Any:
        req = _Req(np.asarray(vec, np.float32), k, extra)
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
        if req.error is not None:
            raise req.error
        return req.result

    def _dispatch(self, batch: List[_Req], k: int) -> List[Any]:
        queries = np.stack([r.vec for r in batch])
        if self._pass_extras:
            return self._search_batch(queries, k, [r.extra for r in batch])
        return self._search_batch(queries, k)

    def _deliver(self, r: _Req, res: Any, k: int) -> None:
        r.result = res if self._pass_extras or r.k >= k else res[: r.k]

    def _run(self, batch: List[_Req]) -> None:
        self.batches += 1
        self.batched_queries += len(batch)
        self.sizes[len(batch)] += 1
        self._last_batch = len(batch)
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
    __slots__ = ("value", "done", "result", "error")

    def __init__(self, value: Any):
        self.value = value
        self.done = False
        self.result: Any = None
        self.error: Any = None


class BatchCoalescer:
    """Leader-elected coalescer for any batchable operation (the device
    graph plane's chain lookups): N concurrent ``submit`` calls become one
    ``apply_batch(values) -> results`` call, one result per value, run on
    the leader's thread.

    An exception in ``apply_batch`` reaches every waiter of that batch,
    unless ``apply_single`` is given: then each value is applied alone, so
    one poisoned value fails only its own caller."""

    def __init__(self, apply_batch: Callable[[List[Any]], List[Any]],
                 apply_single: Callable[[Any], Any] = None, max_batch: int = MAX_BATCH):
        self._apply_batch = apply_batch
        self._apply_single = apply_single
        self._max_batch = max_batch
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
        item = _Item(value)
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
        if item.error is not None:
            raise item.error
        return item.result

    def _run(self, batch: List[_Item]) -> None:
        self.batches += 1
        self.batched_items += len(batch)
        try:
            for item, res in zip(batch, self._apply_batch([i.value for i in batch])):
                item.result = res
        except Exception as exc:  # noqa: BLE001 -- delivered to each waiter
            if self._apply_single is None or len(batch) == 1:
                for item in batch:
                    item.error = exc
            else:
                for item in batch:
                    try:
                        item.result = self._apply_single(item.value)
                    except Exception as single_exc:  # noqa: BLE001
                        item.error = single_exc
        except BaseException as exc:  # an interrupt: no waiter may read a None
            for item in batch:
                item.error = exc
            raise
        finally:
            for item in batch:
                item.done = True
