"""DB facade: open / store / link / neighbors / cypher / flush / search /
recall / remember / forget / close (counterpart of
``nornicdb_tpu/db.py:DB``).

The engine chain is the reference's: a base engine (``MemoryEngine``
without a data dir; with one, the native KV ``DiskEngine`` or the WAL +
snapshot ``DurableEngine``, chosen by ``engine``), then ``AsyncEngine``
when ``async_writes``, then ``NamespacedEngine(chain, "neo4j")``, then
the listener layer. So a data dir holds the reference's files, and each
package opens the other's. The embed queue embeds stored nodes with the
default embedder (the committed mini encoder, or ``HashEmbedder`` when no
checkpoint exists), whose identity a data dir records in
``embedder.json`` and keeps on reopen. The search service indexes them
and, with a data dir, persists its indexes under ``data_dir/search``.
``cypher`` runs the Cypher executor over the same storage; its
``db.index.vector.queryNodes`` reads the search service, and writes
arriving outside Cypher invalidate the executor's caches through a
storage listener. ``multidb_manager`` hosts more databases on the chain
below the namespace. The AI-native memory plane is built on first use:
``decay`` (``DecayManager``), ``temporal`` (``TemporalTracker``) and
``inference`` (``InferenceEngine`` over the search service, with an
evidence buffer ahead of co-access edges); ``store(auto_link=True)``
infers ``SIMILAR_TO`` edges for an explicit embedding, and ``remember``
records an access for decay, the temporal tracker and co-access
inference. ``graph_vector_search`` expands one or two hops from an
anchor and ranks the distinct frontier by cosine against a query vector
over the search service's index: one dispatch on the executor's device
graph plane, or its host version where the plane answers None.
``database`` names the namespace the DB's records live under
(``"neo4j"``). ``passphrase`` encrypts a data dir at rest with the
reference's keys and record bytes (``encryption.py``; it needs the
``cryptography`` package, which is imported only then). Replication
waits for a later slice: ``replication`` raises ``NotPortedError``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.errors import NotPortedError, is_device_fault
from nornicdb_tpu_torch.storage import (
    DEFAULT_DB,
    AsyncEngine,
    Direction,
    DurableEngine,
    Edge,
    Engine,
    ListenableEngine,
    MemoryEngine,
    MutationListener,
    NamespacedEngine,
    Node,
    make_persistent_engine,
)

log = logging.getLogger(__name__)

ENGINES = ("auto", "native", "python", "memory")


class DB:
    """One logical database instance."""

    def __init__(
        self,
        data_dir: Optional[str] = None,
        device: DeviceLike = None,
        async_writes: bool = False,
        sync_every_write: bool = False,
        embedder: Optional[Any] = None,
        auto_embed: bool = True,
        engine: str = "auto",
        replication: Optional[Any] = None,
        passphrase: Optional[str] = None,
        *,
        database: str = DEFAULT_DB,
    ):
        self.device = resolve_device(device)
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        if engine in ("native", "python") and not data_dir:
            raise ValueError(f"engine={engine!r} requires data_dir")
        if replication is not None:
            raise NotPortedError("replication is not ported yet")
        self._data_dir = data_dir if engine != "memory" else None
        if self._data_dir:
            # at-rest encryption: a PBKDF2 key from the passphrase and the
            # salt file in the data dir
            from nornicdb_tpu_torch.encryption import make_encryptor

            encryptor = make_encryptor(passphrase, data_dir)
            if engine == "python":
                base: Engine = DurableEngine(data_dir, sync_every_write=sync_every_write,
                                             encryptor=encryptor)
            elif engine == "native":
                from nornicdb_tpu_torch.storage.disk import DiskEngine

                base = DiskEngine(data_dir, sync_every_write=sync_every_write,
                                  encryptor=encryptor)
            else:
                base = make_persistent_engine(data_dir, sync_every_write=sync_every_write,
                                              encryptor=encryptor)
        else:
            base = MemoryEngine()
        self._base = base
        chain: Engine = AsyncEngine(base) if async_writes else base
        self._chain = chain  # below the namespace: multidb roots here
        # the listener layer sits on top, so callbacks carry logical ids
        self._listenable = ListenableEngine(NamespacedEngine(chain, database))
        self.storage = self._listenable
        self.database = database
        self._lock = threading.Lock()
        self._closed = False
        self._db_manager = None
        self._executor = None
        self._search = None
        self._decay = None
        self._temporal = None
        self._inference = None
        if embedder is None:
            try:
                embedder = self._default_embedder()
            except BaseException:
                self._listenable.close()  # release the open store
                raise
        self._embedder = embedder
        self._embed_queue = None
        if auto_embed:
            from nornicdb_tpu_torch.embed.queue import EmbedQueue

            self._embed_queue = EmbedQueue(
                self.storage, self._embedder, on_embedded=self._on_embedded)
            self._listenable.add_listener(self._embed_queue)
            self._embed_queue.start()

    def _default_embedder(self):
        """The default embedder behind an LRU: the committed mini encoder,
        or ``HashEmbedder`` when the checkpoint is absent or
        ``NORNICDB_TPU_EMBEDDER=hash`` forces it. A data dir records the
        choice (``embedder.json``: kind and dims) and keeps it on reopen,
        as the reference's does, so a store keeps its embedding space. A
        sidecar that cannot be read raises (unless hash is forced). The
        ``hf`` kind is an imported HF encoder (``models/hf_import.py``):
        ``NORNICDB_TPU_MODEL_DIR`` naming a model dir selects it for a new
        store, ahead of the mini encoder. A kind that cannot be built (no
        model dir, no ``transformers``) falls back to the hash embedder
        with a warning, as the reference's does; a device fault raises."""
        from nornicdb_tpu_torch.embed.embedder import CachedEmbedder, HashEmbedder
        from nornicdb_tpu_torch.models.checkpoint import load_default_embedder

        env_force = os.environ.get("NORNICDB_TPU_EMBEDDER", "")
        sidecar = os.path.join(self._data_dir, "embedder.json") if self._data_dir else None
        recorded = None
        sidecar_unreadable = False
        if sidecar and os.path.exists(sidecar):
            try:
                with io.open(sidecar, encoding="utf-8") as f:
                    recorded = json.load(f)
            except Exception as exc:
                # a corrupt sidecar is not "no recorded identity": the
                # default embedder could write vectors of another space
                sidecar_unreadable = True
                if env_force != "hash":
                    raise ValueError(
                        f"embedder sidecar {sidecar} is unreadable ({exc}); fix or "
                        "remove the file to re-bind the store's embedding space, or "
                        "force NORNICDB_TPU_EMBEDDER=hash to open anyway") from exc
                log.error("embedder sidecar %s is unreadable (%s); forced hash "
                          "embedder is active", sidecar, exc)
        from nornicdb_tpu_torch.models.hf_import import default_model_dir

        if env_force == "hash":
            want = "hash"  # the escape hatch always wins
        elif default_model_dir() is not None:
            want = "hf"  # imported weights beat the mini encoder
        else:
            want = "encoder-mini"
        kind = want
        if recorded and env_force != "hash":
            kind = recorded.get("kind", want)
        inner = None
        if kind == "hf":
            try:
                d = default_model_dir()
                if d is None:
                    raise FileNotFoundError(
                        "NORNICDB_TPU_MODEL_DIR not set or not a model dir, but the "
                        "store was created with an imported-weights embedder")
                from nornicdb_tpu_torch.models.hf_import import HFEncoderEmbedder

                inner = HFEncoderEmbedder(d, device=self.device)
            except Exception as exc:
                if is_device_fault(exc):
                    raise
                log.warning("the hf embedder is unavailable (%s); falling back to the "
                            "hash embedder (another embedding space)", exc)
                kind = "hash"
        if kind == "encoder-mini":
            inner = load_default_embedder(self.device)
            if inner is None:
                log.warning("the encoder checkpoint is missing; falling back to the "
                            "hash embedder (another embedding space)")
                kind = "hash"
        if kind == "hash":
            # recorded dims apply only to a hash store
            dims = 256
            if recorded and recorded.get("kind") == "hash":
                dims = int(recorded.get("dims", 256))
            inner = HashEmbedder(dims=dims)
        if recorded and recorded.get("kind") != kind:
            log.warning("store was created with embedder %r but %r is active; "
                        "reindex to migrate", recorded.get("kind"), kind)
        if sidecar and recorded is None and not sidecar_unreadable:
            with io.open(sidecar, "w", encoding="utf-8") as f:
                json.dump({"kind": kind, "dims": inner.dims}, f)
        return CachedEmbedder(inner)

    @property
    def executor(self):
        """The Cypher executor, built on first use. Writes arriving
        outside Cypher (``store``, ``link``, the embed queue's write-backs)
        invalidate its query cache and columnar snapshot through a storage
        listener; the executor skips its own writes there."""
        with self._lock:
            if self._executor is None:
                from nornicdb_tpu_torch.query.executor import CypherExecutor

                ex = CypherExecutor(self.storage, device=self.device)
                if self._search is not None:
                    ex.set_search_service(self._search)
                self._listenable.add_listener(_CacheInvalidator(ex))
                self._executor = ex
            return self._executor

    @property
    def search(self):
        """The search service, built on first use and backfilled from
        storage (nodes stored before it existed)."""
        with self._lock:
            if self._search is None:
                from nornicdb_tpu_torch.search.service import SearchService

                persist = (os.path.join(self._data_dir, "search")
                           if self._data_dir else None)
                svc = SearchService(self.storage, embedder=self._embedder,
                                    device=self.device, persist_dir=persist)
                # publish before the backfill so an embed finishing
                # meanwhile lands through _on_embedded (index_node is
                # idempotent)
                self._search = svc
                try:
                    svc.build_indexes()
                except BaseException:
                    self._search = None
                    raise
                if self._executor is not None:
                    self._executor.set_search_service(svc)
            return self._search

    @property
    def qdrant_compat(self):
        """The one Qdrant translation layer of this DB, on its device,
        built on first use: the REST and gRPC surfaces share its
        per-collection index cache. Points are ordinary storage nodes, so
        a write through any other surface (a Cypher ``SET`` or
        ``DELETE``, a GDPR delete) invalidates the collection too."""
        with self._lock:
            if getattr(self, "_qdrant_compat", None) is None:
                from nornicdb_tpu_torch.api.qdrant import QdrantCompat

                compat = QdrantCompat(self.storage, device=self.device)
                if hasattr(self.storage, "add_listener"):
                    self.storage.add_listener(_QdrantInvalidationListener(compat))
                self._qdrant_compat = compat
            return self._qdrant_compat

    @property
    def decay(self):
        """The decay manager, built on first use."""
        if self._decay is None:
            from nornicdb_tpu_torch.decay import DecayManager

            self._decay = DecayManager(self.storage)
        return self._decay

    @property
    def temporal(self):
        """The temporal access tracker, built on first use."""
        if self._temporal is None:
            from nornicdb_tpu_torch.temporal import TemporalTracker

            self._temporal = TemporalTracker()
        return self._temporal

    @property
    def inference(self):
        """The inference engine over the search service, built on first
        use; co-access edges materialize only after accumulated evidence
        (the reference's evidence buffer ahead of Auto-TLP edges)."""
        if self._inference is None:
            from nornicdb_tpu_torch.inference import EvidenceBuffer, InferenceEngine

            self._inference = InferenceEngine(
                self.storage, self.search, evidence=EvidenceBuffer())
        return self._inference

    def _on_embedded(self, node: Node) -> None:
        if self._search is not None:
            self._search.index_node(node)

    # -- public API ------------------------------------------------------

    def store(
        self,
        content: str,
        labels: Optional[Sequence[str]] = None,
        properties: Optional[Dict[str, Any]] = None,
        node_id: Optional[str] = None,
        embedding: Optional[List[float]] = None,
        auto_link: bool = False,
    ) -> Node:
        """Store a memory node; with ``auto_link`` and an explicit
        ``embedding``, infer ``SIMILAR_TO`` edges to its nearest stored
        memories (``inference.on_store``)."""
        nid = node_id or str(uuid.uuid4())
        props = dict(properties or {})
        props.setdefault("content", content)
        node = Node(id=nid, labels=list(labels or ["Memory"]),
                    properties=props, embedding=embedding)
        self.storage.create_node(node)
        if embedding is not None and self._search is not None:
            # explicit embeddings bypass the embed queue, so an already
            # built search service indexes them here. Best-effort, as in
            # the reference: the node is stored and BM25-indexed before
            # the vector add, and an embedding of another width than the
            # index's was never indexable, so it stays recallable by text.
            # Only that dims mismatch is caught; a kernel fault on the
            # card still raises on the query path.
            from nornicdb_tpu_torch.search.vector_index import DimsMismatch

            try:
                self._search.index_node(self.storage.get_node(nid))
            except DimsMismatch:
                pass
        if auto_link and embedding is not None:
            self.inference.on_store(node)
        return self.storage.get_node(nid)

    def link(
        self,
        from_id: str,
        to_id: str,
        rel_type: str = "RELATES_TO",
        properties: Optional[Dict[str, Any]] = None,
        edge_id: Optional[str] = None,
    ) -> Edge:
        """Create a relationship between two stored nodes."""
        eid = edge_id or str(uuid.uuid4())
        self.storage.create_edge(Edge(id=eid, type=rel_type, start_node=from_id,
                                      end_node=to_id, properties=dict(properties or {})))
        return self.storage.get_edge(eid)

    def neighbors(self, node_id: str, direction: str = Direction.BOTH) -> List[Node]:
        ids = self.storage.neighbors(node_id, direction)
        return [n for n in self.storage.batch_get_nodes(ids) if n is not None]

    def cypher(self, query: str, params: Optional[Dict[str, Any]] = None) -> Any:
        """Execute a Cypher query; a ``CypherResult``."""
        return self.executor.execute(query, params or {})

    def graph_vector_search(
        self,
        anchor_id: str,
        hops: Sequence[Any],
        query_vector: Sequence[float],
        k: int = 10,
    ) -> List[Tuple[str, float]]:
        """Fused graph+vector query: expand ``hops`` (1 or 2 (etype,
        direction) stages; a bare string means outgoing) from the anchor
        node, then rank the distinct frontier nodes by cosine similarity to
        ``query_vector`` over the search service's vector index. Top-k
        ``(node_id, score)``, score descending; ``[]`` for an unknown
        anchor."""
        import numpy as np

        ex = self.executor
        cat = ex.columnar
        hops_n: List[Tuple[str, str]] = []
        for h in hops:
            if isinstance(h, str):
                hops_n.append((h, "out"))
            elif isinstance(h, (list, tuple)) and len(h) == 2:
                etype, direction = h
                if direction not in ("out", "in"):
                    raise ValueError(f"bad hop direction {direction!r}")
                hops_n.append((str(etype), direction))
            else:
                raise ValueError(
                    "each hop must be a relationship type or a "
                    "[type, 'in'|'out'] pair")
        if not hops_n or len(hops_n) > 2:
            raise ValueError("graph_vector_search supports 1 or 2 hops")
        row = cat.node_row(anchor_id)
        if row is None:
            return []
        q = np.asarray(query_vector, dtype=np.float32)
        if q.ndim != 1 or q.size == 0:
            raise ValueError("query_vector must be a flat float vector")
        index = self.search.vectors
        dims = getattr(index, "dims", None)
        if dims and q.shape[0] != dims:
            raise ValueError(
                f"query_vector has {q.shape[0]} dims, index has {dims}")
        q = q[None, :]
        plane = ex.device_graph
        import time as _time

        from nornicdb_tpu_torch.obs import audit as _audit

        t0 = _time.time()
        hits = plane.traverse_rank([row], hops_n, q, k, index)
        if hits is None:
            hits = plane.traverse_rank_host([row], hops_n, q, k, index)
            _audit.record_served("graph", "host", seconds=_time.time() - t0)
        else:
            _audit.record_served("graph", "graph_traverse_rank_device",
                                 seconds=_time.time() - t0)
            if _audit.sampling_active():
                # shadow parity: the auditor replays the host version and
                # compares row ids

                def versions_now():
                    return {"catalog_version": cat.version,
                            "index_mutations": getattr(index, "mutations", 0)}

                _audit.maybe_sample(
                    "graph", "graph_traverse_rank_device", [r for r, _ in hits[0]],
                    k=min(10, k),
                    ref=lambda: [r for r, _ in plane.traverse_rank_host(
                        [row], hops_n, q, k, index)[0]],
                    versions=versions_now(), versions_now=versions_now,
                    query={"anchor": anchor_id, "hops": hops_n, "k": k})
        nodes = cat.nodes()
        return [(nodes[r].id, s) for r, s in hits[0]]

    def multidb_manager(self, max_databases: int = 64):
        """The multi-database manager, built on first use over the chain
        this DB namespaces, so other databases share its durability."""
        with self._lock:
            if self._db_manager is None:
                from nornicdb_tpu_torch.multidb import DatabaseManager

                self._db_manager = DatabaseManager(
                    self._chain, default_database=self.database,
                    max_databases=max_databases)
            return self._db_manager

    def recall(self, query: str, limit: int = 10, **kw) -> List[Dict[str, Any]]:
        """Hybrid search over stored memories."""
        return self.search.search(query, limit=limit, **kw)

    def remember(self, node_id: str) -> Node:
        """Fetch a node and record the access for decay and temporal
        tracking; repeated co-access accumulates evidence toward inferred
        edges. Co-access inference runs only once the inference engine
        exists (a read must not build the search stack), and, as in the
        reference, a failure there never fails the read: that path is
        host work (the temporal tracker, the evidence buffer and an edge
        write), so it hides no device fault."""
        node = self.storage.get_node(node_id)
        self.decay.record_access(node_id)
        self.temporal.record_access(node_id)
        if self._inference is not None:
            try:
                self._inference.on_access(self._temporal, node_id)
            except Exception:  # noqa: BLE001 — inference must never fail a read
                log.exception("co-access inference failed for %s", node_id)
        return node

    def forget(self, node_id: str) -> None:
        """Delete a node (and its edges) and drop it from the indexes."""
        self.storage.delete_node(node_id)
        if self._search is not None:
            self._search.remove_node(node_id)

    def flush(self) -> None:
        """Wait until every stored node is embedded (and indexed)."""
        if self._embed_queue is not None and not self._embed_queue.drain(None):
            raise RuntimeError("embed queue worker stopped with work pending")
        self.storage.flush()

    def close(self) -> None:
        """Stop the embed queue, make the search service's final index
        save, stop the decay manager, then close storage (which snapshots
        the Python engine)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            if self._embed_queue is not None:
                self._embed_queue.stop()
            if self._search is not None:
                self._search.close()
            if self._decay is not None:
                self._decay.stop()
        finally:
            self.storage.close()

    def __enter__(self) -> "DB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _QdrantInvalidationListener(MutationListener):
    """Routes node mutations from any surface into the Qdrant layer's
    invalidation (``QdrantCompat._on_external_mutation``, which filters
    out the layer's own writes)."""

    def __init__(self, compat):
        self._compat = compat

    def on_node_upsert(self, node: Node) -> None:
        self._compat._on_external_mutation(node.id)

    def on_node_delete(self, node_id: str) -> None:
        self._compat._on_external_mutation(node_id)


class _CacheInvalidator(MutationListener):
    """Drops the executor's caches on writes from outside Cypher."""

    def __init__(self, executor):
        self._ex = executor

    def on_node_upsert(self, node: Node) -> None:
        self._ex.on_external_node_upsert(node)

    def on_node_delete(self, node_id: str) -> None:
        self._ex.on_external_mutation()

    def on_edge_upsert(self, edge: Edge) -> None:
        self._ex.on_external_mutation()

    def on_edge_delete(self, edge_id: str) -> None:
        self._ex.on_external_mutation()


def open(data_dir: Optional[str] = None, device: DeviceLike = None, **kw) -> DB:  # noqa: A001
    """Open a database on ``device`` (None = cuda): durable in
    ``data_dir``, in memory without one."""
    return DB(data_dir=data_dir, device=device, **kw)
