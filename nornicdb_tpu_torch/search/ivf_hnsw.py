"""IVF-HNSW: k-means centroid routing over per-cluster HNSW graphs
(counterpart of ``nornicdb_tpu/search/ivf_hnsw.py``).

The vector set is partitioned by cosine k-means and each cluster gets
its own HNSW graph; queries probe the ``nprobe`` nearest clusters'
graphs. The partitioner is ``ops/kmeans.py:kmeans_fit`` on the index's
device (one [N, K] product an iteration); routing is one host product
against the K centroids, and the graph walks stay on the host
(``search/hnsw.py``, pointer chasing).

``kmeans_fit`` draws its k-means++ seeds from a ``torch.Generator``, the
reference's from ``jax.random`` (ROADMAP C22), so the two packages
partition the same rows differently. From the same partition (the
tests' ``kmeans_fit`` seam) routing and search are the reference's bit
for bit; from its own init the index is held to recall@10 against exact
search (ROADMAP C41). ``save``/``load`` use the reference's files.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.kmeans import kmeans_fit
from nornicdb_tpu_torch.search.hnsw import HNSWIndex
from nornicdb_tpu_torch.search.util import normalize_rows as _normalize


class IVFHNSWIndex:
    def __init__(self, n_clusters: int = 16, nprobe: int = 3,
                 m: int = 16, ef_construction: int = 100,
                 ef_search: int = 64, device: DeviceLike = None):
        self.device = resolve_device(device)  # where kmeans_fit partitions
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.m = m
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.centroids: Optional[np.ndarray] = None  # [K, D] normalized
        self.clusters: Dict[int, HNSWIndex] = {}
        self._where: Dict[str, int] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._where)

    # -- build -----------------------------------------------------------

    def build(
        self,
        items: Sequence[Tuple[str, Sequence[float]]],
        seed_ids: Optional[Sequence[str]] = None,
    ) -> None:
        """Partition by cosine k-means, build one HNSW per cluster
        (seed-first insertion within each, reference BM25-seeded
        order)."""
        if not items:
            return
        vecs = _normalize(np.asarray([v for _, v in items],
                                     dtype=np.float32))
        k = min(self.n_clusters, len(items))
        res = kmeans_fit(vecs, k=k, device=self.device)
        self.centroids = _normalize(
            np.asarray(res.centroids, dtype=np.float32))
        assign = np.asarray(res.assignments)
        seeds = set(seed_ids or [])
        with self._lock:
            self.clusters = {}
            self._where = {}
            for c in range(self.centroids.shape[0]):
                members = [
                    (items[i][0], vecs[i])
                    for i in np.nonzero(assign == c)[0]
                ]
                if not members:
                    continue
                idx = HNSWIndex(m=self.m,
                                ef_construction=self.ef_construction,
                                ef_search=self.ef_search)
                idx.build(members,
                          seed_ids=[e for e, _ in members if e in seeds])
                self.clusters[int(c)] = idx
                for ext_id, _ in members:
                    self._where[ext_id] = int(c)

    # -- incremental -----------------------------------------------------

    def add(self, ext_id: str, vector: Sequence[float]) -> None:
        if self.centroids is None:
            raise RuntimeError("IVFHNSWIndex.build() first")
        v = _normalize(np.asarray(vector, dtype=np.float32))
        c = int(np.argmax(self.centroids @ v))
        with self._lock:
            old = self._where.get(ext_id)
            if old is not None and old != c:
                self.clusters[old].remove(ext_id)
            idx = self.clusters.get(c)
            if idx is None:
                idx = HNSWIndex(m=self.m,
                                ef_construction=self.ef_construction,
                                ef_search=self.ef_search)
                self.clusters[c] = idx
            self._where[ext_id] = c
            # insert under the lock: a concurrent remove() between the
            # map write and the graph insert would leave a ghost entry
            idx.add(ext_id, v)

    def remove(self, ext_id: str) -> bool:
        with self._lock:
            c = self._where.pop(ext_id, None)
            if c is None:
                return False
            idx = self.clusters.get(c)
            # tombstone under the same lock as add(): an interleaved
            # add() would otherwise get its fresh insert tombstoned
            return idx.remove(ext_id) if idx is not None else False

    # -- search ----------------------------------------------------------

    def route(
        self, query: Sequence[float], nprobe: Optional[int] = None,
        lexical_doc_ids: Optional[Sequence[str]] = None,
        lexical_weight: float = 0.3,
    ) -> np.ndarray:
        """Pick the clusters to probe. With ``lexical_doc_ids`` (e.g.
        BM25 top hits) the semantic centroid similarity is blended with
        each cluster's share of the lexical hits — hybrid cluster routing
        (reference: hybrid_cluster_routing.go:248-256): a cluster full of
        keyword-matching docs gets probed even when its centroid is not
        among the cosine-nearest."""
        assert self.centroids is not None
        nprobe = min(nprobe or self.nprobe, self.centroids.shape[0])
        q = _normalize(np.asarray(query, dtype=np.float32))
        sims = self.centroids @ q  # [-1, 1]
        if lexical_doc_ids:
            lex = np.zeros(self.centroids.shape[0], np.float32)
            with self._lock:
                for ext_id in lexical_doc_ids:
                    c = self._where.get(ext_id)
                    if c is not None:
                        lex[c] += 1.0
            if lex.sum() > 0:
                lex /= lex.sum()
                # lexical share scaled to [0, 2] so a keyword-dominant
                # cluster can outrank a max-similarity centroid (1.0)
                sims = (1.0 - lexical_weight) * sims + lexical_weight * 2.0 * lex
        return np.argpartition(-sims, nprobe - 1)[:nprobe]

    def search(
        self, query: Sequence[float], k: int = 10,
        nprobe: Optional[int] = None, ef: Optional[int] = None,
        lexical_doc_ids: Optional[Sequence[str]] = None,
    ) -> List[Tuple[str, float]]:
        if self.centroids is None:
            return []
        q = _normalize(np.asarray(query, dtype=np.float32))
        probe = self.route(q, nprobe, lexical_doc_ids=lexical_doc_ids)
        hits: List[Tuple[str, float]] = []
        for c in probe:
            idx = self.clusters.get(int(c))
            if idx is not None:
                hits.extend(idx.search(q, k=k, ef=ef or self.ef_search))
        hits.sort(key=lambda t: -t[1])
        return hits[:k]

    # -- persistence (reference: SaveIVFHNSW hnsw_index.go:636) ----------

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        # clear stale cluster files first — load() globs cluster-*.npz,
        # so leftovers from a previous save would resurrect old vectors
        for name in os.listdir(directory):
            if name.startswith("cluster-") and name.endswith(".npz"):
                os.unlink(os.path.join(directory, name))
        with self._lock:
            np.savez_compressed(
                os.path.join(directory, "routing"),
                centroids=self.centroids,
                nprobe=self.nprobe, m=self.m,
                ef_construction=self.ef_construction,
                ef_search=self.ef_search,
            )
            for c, idx in self.clusters.items():
                idx.save(os.path.join(directory, f"cluster-{c}.npz"))

    @classmethod
    def load(cls, directory: str, device: DeviceLike = None) -> "IVFHNSWIndex":
        z = np.load(os.path.join(directory, "routing.npz"))
        idx = cls(nprobe=int(z["nprobe"]), m=int(z["m"]),
                  ef_construction=int(z["ef_construction"]),
                  ef_search=int(z["ef_search"]) if "ef_search" in z else 64,
                  device=device)
        idx.centroids = z["centroids"]
        idx.n_clusters = idx.centroids.shape[0]
        for name in os.listdir(directory):
            if name.startswith("cluster-") and name.endswith(".npz"):
                c = int(name[len("cluster-"):-len(".npz")])
                sub = HNSWIndex.load(os.path.join(directory, name))
                idx.clusters[c] = sub
                for ext_id in sub.ids():
                    idx._where[ext_id] = c
        return idx
