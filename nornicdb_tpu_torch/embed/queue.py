"""Background embed queue: embeds un-embedded nodes and triggers indexing
(counterpart of ``nornicdb_tpu/embed/queue.py``; the periodic rescan and
the clustering trigger wait for a later slice).

It is a ``MutationListener``: the listenable engine feeds it node ids,
one worker thread embeds them in batches and writes the vectors back.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, List, Optional

from nornicdb_tpu_torch.storage.types import Engine, MutationListener, Node

logger = logging.getLogger(__name__)

CHUNK_THRESHOLD_CHARS = 2000  # texts longer than this get chunk embeddings


def build_embedding_text(node: Node) -> str:
    from nornicdb_tpu_torch.search.service import extract_text

    return extract_text(node)


def embed_exempt(node: Node) -> bool:
    """System-owned nodes (any label starting with ``_``) are never
    embedded by the queue."""
    return any(lbl.startswith("_") for lbl in node.labels)


class EmbedQueue(MutationListener):
    def __init__(
        self,
        storage: Engine,
        embedder,
        on_embedded: Optional[Callable[[Node], None]] = None,
        batch_size: int = 16,
        max_retries: int = 3,
    ):
        self.storage = storage
        self.embedder = embedder
        self.on_embedded = on_embedded
        self.batch_size = batch_size
        self.max_retries = max_retries
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._pending = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self.embedded_count = 0
        self.failed_count = 0

    # -- MutationListener ------------------------------------------------

    def on_node_upsert(self, node: Node) -> None:
        if (
            node.embedding is None
            and not embed_exempt(node)
            and build_embedding_text(node)
        ):
            self.enqueue(node.id)

    def on_node_delete(self, node_id: str) -> None:
        with self._lock:
            self._pending.discard(node_id)

    # -- queue -----------------------------------------------------------

    def enqueue(self, node_id: str) -> None:
        with self._lock:
            if node_id in self._pending:
                return
            self._pending.add(node_id)
        self._q.put(node_id)

    def start(self) -> None:
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, name="embed-queue", daemon=True
            )
            self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
        if self._worker is not None:
            self._worker.join(timeout=10)

    def drain(self, timeout_s: Optional[float] = 60.0) -> bool:
        """Block until all currently-pending nodes are embedded (no limit
        when ``timeout_s`` is None). False if the timeout passed first or
        no worker is running to empty the queue."""
        deadline = None if timeout_s is None else time.time() + timeout_s
        while deadline is None or time.time() < deadline:
            with self._lock:
                if not self._pending:
                    return True
            if self._worker is None or not self._worker.is_alive():
                return False
            time.sleep(0.02)
        return False

    # -- worker ----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            batch: List[str] = []
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            if item is None:
                break
            batch.append(item)
            while len(batch) < self.batch_size:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                batch.append(nxt)
            try:
                self._process_batch(batch)
            except Exception:
                logger.exception("embed batch failed")
                with self._lock:
                    self._pending.difference_update(batch)

    def _process_batch(self, node_ids: List[str]) -> None:
        nodes = []
        for nid in node_ids:
            try:
                node = self.storage.get_node(nid)
            except KeyError:
                with self._lock:
                    self._pending.discard(nid)
                continue
            if node.embedding is not None:
                with self._lock:
                    self._pending.discard(nid)
                continue
            nodes.append(node)
        if not nodes:
            return
        texts = [build_embedding_text(n) for n in nodes]
        vectors = self._embed_with_retry(texts)
        if vectors is None:
            self.failed_count += len(nodes)
            with self._lock:
                self._pending.difference_update(n.id for n in nodes)
            return
        for node, text, vec in zip(nodes, texts, vectors):
            # per-node isolation: one failing write must not wedge the
            # rest of the batch in _pending
            try:
                try:
                    fresh = self.storage.get_node(node.id)
                except KeyError:
                    continue
                fresh.embedding = list(vec)
                if len(text) > CHUNK_THRESHOLD_CHARS and hasattr(
                    self.embedder, "embed_chunks"
                ):
                    try:
                        fresh.chunk_embeddings = self.embedder.embed_chunks(text)
                    except Exception:
                        logger.exception("chunk embed failed for %s", node.id)
                try:
                    self.storage.update_node(fresh)
                except KeyError:
                    continue  # deleted concurrently
                self.embedded_count += 1
                if self.on_embedded is not None:
                    try:
                        self.on_embedded(fresh)
                    except Exception:
                        logger.exception("on_embedded callback failed")
            except Exception:
                logger.exception("embed write failed for %s", node.id)
                self.failed_count += 1
            finally:
                with self._lock:
                    self._pending.discard(node.id)

    def _embed_with_retry(self, texts: List[str]):
        """Retries with backoff, fail-open."""
        delay = 0.1
        for attempt in range(self.max_retries):
            try:
                return self.embedder.embed_batch(texts)
            except Exception:
                logger.exception("embed attempt %d failed", attempt + 1)
                if attempt + 1 < self.max_retries:  # no sleep after the last try
                    time.sleep(delay)
                    delay *= 4
        return None
