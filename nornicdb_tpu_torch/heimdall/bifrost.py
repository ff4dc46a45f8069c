"""Bifrost: the push channel streaming Heimdall events to clients (a copy
of ``nornicdb_tpu/heimdall/bifrost.py``).

A thread-safe pub/sub hub with bounded per-subscriber queues, and the
Server-Sent Events rendering an HTTP server streams. Slow subscribers
drop their oldest events rather than block publishers.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Any, Dict, Iterator, Optional


class Bifrost:
    def __init__(self, max_queue: int = 256):
        self._subs: Dict[int, "queue.Queue[dict]"] = {}
        self._next = 0
        self._lock = threading.Lock()
        self.max_queue = max_queue
        self.events_published = 0

    def subscribe(self) -> int:
        with self._lock:
            sid = self._next
            self._next += 1
            self._subs[sid] = queue.Queue(maxsize=self.max_queue)
            return sid

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)

    def publish(self, event: str, data: Dict[str, Any]) -> int:
        """Fan out to all subscribers; never blocks (drops oldest)."""
        msg = {"event": event, "data": data, "ts": time.time()}
        with self._lock:
            subs = list(self._subs.values())
            self.events_published += 1
        for q in subs:
            try:
                q.put_nowait(msg)
            except queue.Full:
                try:
                    q.get_nowait()
                    q.put_nowait(msg)
                except (queue.Empty, queue.Full):
                    pass
        return len(subs)

    def events(self, sid: int, timeout: float = 1.0,
               max_events: Optional[int] = None) -> Iterator[dict]:
        """Drain events for a subscriber; stops on timeout gaps."""
        q = self._subs.get(sid)
        if q is None:
            return
        n = 0
        while max_events is None or n < max_events:
            try:
                yield q.get(timeout=timeout)
                n += 1
            except queue.Empty:
                return

    @staticmethod
    def sse(msg: dict) -> str:
        """Render one event in Server-Sent Events wire format."""
        return (f"event: {msg['event']}\n"
                f"data: {json.dumps(msg['data'], default=str)}\n\n")
