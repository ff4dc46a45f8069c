"""IVF-PQ: compressed ANN via coarse quantization + product quantization
(counterpart of ``nornicdb_tpu/search/ivfpq.py``). Selected by
``NORNICDB_VECTOR_ANN_QUALITY=compressed`` (``ann_quality.py``) through a
vector space's ``ivfpq`` backend (``vectorspace.py``).

Host NumPy, as the reference computes it: training is two levels of
Euclidean k-means (``ops/kmeans.py:euclid_kmeans`` for the coarse
centroids, ``train_subspace_codebooks`` for the per-subspace codebooks,
both bitwise the reference's on the same sample and seeds); query-time
scanning is asymmetric distance computation (ADC), one [M, 256] lookup
table per probed cluster, then a gather and sum over the cluster's codes.
Codes live in RAM as uint8 [N, M]. With ``keep_vectors`` an fp16 copy
re-scores the ADC pool by exact cosine. Given the same sample and
``seed_ids`` the coarse centroids, codes, ids and scores are the
reference's bit for bit, and ``save``/``load`` write and read the same
``np.savez_compressed`` fields, so each package loads the other's file.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nornicdb_tpu_torch.ops.kmeans import (
    euclid_kmeans as _euclid_kmeans,
    optimal_k,
    train_subspace_codebooks,
)
from nornicdb_tpu_torch.search.util import normalize_rows as _normalize

# the device PQ plane (search/device_quant.py) trains through the same
# euclid_kmeans, so host IVF-PQ and device PQ codebooks stay bit-identical
# given the same sample and seed


class IVFPQIndex:
    def __init__(
        self,
        n_subspaces: int = 16,
        n_codes: int = 256,
        n_clusters: Optional[int] = None,
        nprobe: int = 8,
        keep_vectors: bool = False,
        refine_factor: int = 4,
        min_refine_pool: int = 128,
    ):
        """``keep_vectors`` retains an fp16 copy of every vector for an
        exact-rerank refinement stage: ADC ranks a candidate pool of
        ``max(refine_factor * k, min_refine_pool)``, then true cosine
        re-scores it. PQ codes alone cap recall hard (8-32 bytes cannot
        separate near neighbors); rerank buys back exactness for
        2 bytes/dim — the standard IVFPQ+refine design (the reference
        keeps a vector cache alongside its IVFPQ tier,
        pkg/search/vector_index_cache.go). Default OFF: the compressed
        tier exists for the memory budget, and a silent fp16 copy would
        multiply it ~30x; quality-critical callers opt in."""
        self.m = n_subspaces
        self.n_codes = n_codes
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.keep_vectors = keep_vectors
        self.refine_factor = max(1, refine_factor)
        self.min_refine_pool = max(1, min_refine_pool)

        self.dims: Optional[int] = None
        self.coarse: Optional[np.ndarray] = None  # [K, D]
        self.codebooks: Optional[np.ndarray] = None  # [M, 256, D/M]
        self._ids: List[str] = []
        self._codes: Optional[np.ndarray] = None  # [N, M] uint8
        self._assign: Optional[np.ndarray] = None  # [N] coarse cluster
        self._vecs: Optional[np.ndarray] = None  # [N, D] fp16 (refine)
        self._id_pos: Dict[str, int] = {}
        self._alive: Optional[np.ndarray] = None  # [N] bool
        self._lock = threading.Lock()
        # search-snapshot cache: (mut_gen, codes, assign, alive); any
        # mutation bumps _mut_gen, invalidating it
        self._mut_gen = 0
        self._snap = None

    # -- training --------------------------------------------------------

    @property
    def trained(self) -> bool:
        return self.codebooks is not None

    def train(
        self,
        sample: np.ndarray,
        seed_ids: Optional[Sequence[int]] = None,
    ) -> None:
        """Train coarse centroids + per-subspace codebooks. ``seed_ids``
        (row indices, e.g. BM25-picked) steer k-means++ initialization
        the way the reference seeds its training sample
        (ivfpq_build.go:16)."""
        sample = _normalize(np.asarray(sample, dtype=np.float32))
        n, d = sample.shape
        if d % self.m != 0:
            raise ValueError(f"dims {d} not divisible by M={self.m}")
        self.dims = d
        k = self.n_clusters or max(1, optimal_k(n))
        self.coarse, assign = _euclid_kmeans(sample, k, seed_ids=seed_ids)
        residuals = sample - self.coarse[assign]
        self.codebooks = train_subspace_codebooks(
            residuals, self.m, self.n_codes)  # [M, 256, D/M]

    # -- encode / add ----------------------------------------------------

    def _encode(self, vecs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """vecs [B, D] → (coarse assignment [B], codes [B, M] uint8)."""
        d = self.dims
        dist = (
            np.sum(vecs**2, axis=1, keepdims=True)
            - 2.0 * vecs @ self.coarse.T
            + np.sum(self.coarse**2, axis=1)[None, :]
        )
        assign = np.argmin(dist, axis=1)
        residual = vecs - self.coarse[assign]
        sub = residual.reshape(len(vecs), self.m, d // self.m)
        codes = np.empty((len(vecs), self.m), dtype=np.uint8)
        for j in range(self.m):
            cb = self.codebooks[j]  # [256, D/M]
            dj = (
                np.sum(sub[:, j, :] ** 2, axis=1, keepdims=True)
                - 2.0 * sub[:, j, :] @ cb.T
                + np.sum(cb**2, axis=1)[None, :]
            )
            codes[:, j] = np.argmin(dj, axis=1).astype(np.uint8)
        return assign, codes

    def add_batch(
        self, items: Sequence[Tuple[str, Sequence[float]]]
    ) -> None:
        if not self.trained:
            raise RuntimeError("IVFPQIndex.train() first")
        if not items:
            return
        vecs = _normalize(np.asarray([v for _, v in items],
                                     dtype=np.float32))
        assign, codes = self._encode(vecs)
        with self._lock:
            self._mut_gen += 1
            existing = 0 if self._codes is None else len(self._codes)
            new_rows: List[int] = []
            staged: Dict[str, int] = {}  # ext_id -> index into new_rows
            for row, (ext_id, _) in enumerate(items):
                pos = self._id_pos.get(ext_id)
                if pos is not None and pos < existing:
                    self._assign[pos] = assign[row]
                    self._codes[pos] = codes[row]
                    self._alive[pos] = True
                elif ext_id in staged:
                    # duplicate id within this batch whose first occurrence
                    # is only staged — overwrite the staged row instead of
                    # indexing arrays it hasn't been appended to yet
                    new_rows[staged[ext_id]] = row
                else:
                    self._id_pos[ext_id] = len(self._ids)
                    self._ids.append(ext_id)
                    staged[ext_id] = len(new_rows)
                    new_rows.append(row)
            for row, (ext_id, _) in enumerate(items):
                pos = self._id_pos.get(ext_id)
                if (self.keep_vectors and pos is not None
                        and pos < existing):
                    self._vecs[pos] = vecs[row].astype(np.float16)
            if new_rows:
                # one concatenate per batch, not per item (O(N*B) -> O(B))
                nc = codes[new_rows]
                na = assign[new_rows]
                nv = np.ones(len(new_rows), dtype=bool)
                if self._codes is None:
                    self._codes, self._assign, self._alive = (
                        nc.copy(), na.copy(), nv)
                    if self.keep_vectors:
                        self._vecs = vecs[new_rows].astype(np.float16)
                else:
                    self._codes = np.vstack([self._codes, nc])
                    self._assign = np.concatenate([self._assign, na])
                    self._alive = np.concatenate([self._alive, nv])
                    if self.keep_vectors:
                        self._vecs = np.vstack([
                            self._vecs,
                            vecs[new_rows].astype(np.float16)])

    def remove(self, ext_id: str) -> bool:
        with self._lock:
            pos = self._id_pos.get(ext_id)
            if pos is None or not self._alive[pos]:
                return False
            self._mut_gen += 1
            self._alive[pos] = False
            return True

    def __len__(self) -> int:
        with self._lock:
            return 0 if self._alive is None else int(self._alive.sum())

    # -- search (ADC) ----------------------------------------------------

    def search(
        self, query: Sequence[float], k: int = 10,
        nprobe: Optional[int] = None,
    ) -> List[Tuple[str, float]]:
        """Approximate top-k: ADC over the nprobe nearest clusters ranks
        a refine_factor*k candidate pool; when vectors are kept, exact
        cosine reranks the pool (scores = cosine). Without the refine
        store, scores are negated squared residual-ADC distances."""
        if not self.trained or self._codes is None:
            return []
        q = _normalize(np.asarray(query, dtype=np.float32))
        nprobe = min(nprobe or self.nprobe, self.coarse.shape[0])
        cd = np.sum((self.coarse - q[None, :]) ** 2, axis=1)
        probe = np.argpartition(cd, nprobe - 1)[:nprobe]
        d_sub = self.dims // self.m
        out_scores: List[np.ndarray] = []
        out_pos: List[np.ndarray] = []
        with self._lock:
            # snapshot by value: add_batch/remove mutate rows in place,
            # so reference-only snapshots could read torn code rows.
            # The copy is generation-cached — copying 50k x 32 codes per
            # QUERY was the ADC path's single biggest cost
            if self._snap is None or self._snap[0] != self._mut_gen:
                self._snap = (self._mut_gen, self._codes.copy(),
                              self._assign.copy(), self._alive.copy())
            _g, codes, assign, alive = self._snap
            has_refine = self._vecs is not None
        for c in probe:
            mask = (assign == c) & alive
            pos = np.nonzero(mask)[0]
            if pos.size == 0:
                continue
            residual_q = (q - self.coarse[c]).reshape(self.m, d_sub)
            # ADC table [M, 256]: one einsum per probe
            table = (
                np.sum(residual_q**2, axis=1)[:, None]
                - 2.0 * np.einsum("ms,mcs->mc", residual_q, self.codebooks)
                + np.sum(self.codebooks**2, axis=2)
            )
            cand = codes[pos]  # [n_c, M]
            dist = table[np.arange(self.m)[None, :], cand].sum(axis=1)
            out_scores.append(-dist)
            out_pos.append(pos)
        if not out_pos:
            return []
        scores = np.concatenate(out_scores)
        pos = np.concatenate(out_pos)
        if has_refine:
            # refinement: exact cosine over the ADC top pool. The pool
            # floor matters — ADC ordering is noisy exactly when refine
            # is needed, so k*refine_factor alone under-collects
            pool = min(max(k * self.refine_factor, self.min_refine_pool),
                       len(pos))
            keep = np.argpartition(-scores, pool - 1)[:pool]
            cand_pos = pos[keep]
            with self._lock:
                # copy the candidate rows under the lock: add_batch
                # overwrites re-added ids' rows in place, and a torn
                # fp16 row would mis-rank that candidate
                exact = self._vecs[cand_pos].astype(np.float32) @ q
            k_eff = min(k, pool)
            top = np.argpartition(-exact, k_eff - 1)[:k_eff]
            top = top[np.argsort(-exact[top])]
            return [(self._ids[int(cand_pos[i])], float(exact[i]))
                    for i in top]
        k_eff = min(k, len(pos))
        top = np.argpartition(-scores, k_eff - 1)[:k_eff]
        top = top[np.argsort(-scores[top])]
        return [(self._ids[int(pos[i])], float(scores[i])) for i in top]

    # -- diagnostics ------------------------------------------------------

    def coarse_hit_rate(
        self, queries: np.ndarray, true_ids: Sequence[Sequence[str]],
        nprobe: Optional[int] = None,
    ) -> float:
        """Fraction of ground-truth neighbors whose assigned cluster is
        among the probed clusters — separates 'coarse index misses the
        right cluster' (fix: more nprobe / better k-means) from 'PQ
        codes cannot rank inside the cluster' (fix: more subspaces /
        rerank). A flat recall curve becomes diagnosable."""
        if not self.trained or self._assign is None:
            return 0.0
        qn = _normalize(np.asarray(queries, dtype=np.float32))
        nprobe = min(nprobe or self.nprobe, self.coarse.shape[0])
        hits = total = 0
        for qi in range(len(qn)):
            cd = np.sum((self.coarse - qn[qi][None, :]) ** 2, axis=1)
            probed = set(np.argpartition(cd, nprobe - 1)[:nprobe].tolist())
            for tid in true_ids[qi]:
                pos = self._id_pos.get(tid)
                if pos is None:
                    continue
                total += 1
                if int(self._assign[pos]) in probed:
                    hits += 1
        return hits / max(total, 1)

    # -- persistence (reference: ivfpq_persist.go:169) -------------------

    def save(self, path: str) -> None:
        if not self.trained:
            raise RuntimeError("cannot save an untrained IVFPQIndex")
        with self._lock:
            # trained-but-empty saves use (0, M) arrays — np.savez would
            # pickle None as a 0-d object array that poisons load()
            codes = (self._codes if self._codes is not None
                     else np.zeros((0, self.m), np.uint8))
            assign = (self._assign if self._assign is not None
                      else np.zeros(0, np.int64))
            alive = (self._alive if self._alive is not None
                     else np.zeros(0, bool))
            extra = {}
            if self.keep_vectors and self._vecs is not None:
                extra["vecs"] = self._vecs
            np.savez_compressed(
                path,
                m=self.m, n_codes=self.n_codes, nprobe=self.nprobe,
                refine_factor=self.refine_factor,
                min_refine_pool=self.min_refine_pool,
                dims=self.dims, coarse=self.coarse,
                codebooks=self.codebooks,
                ids=np.asarray(self._ids, dtype=object),
                codes=codes, assign=assign, alive=alive, **extra,
            )

    @classmethod
    def load(cls, path: str) -> "IVFPQIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=True)
        idx = cls(n_subspaces=int(z["m"]), n_codes=int(z["n_codes"]),
                  nprobe=int(z["nprobe"]),
                  keep_vectors="vecs" in z.files,
                  refine_factor=int(z["refine_factor"])
                  if "refine_factor" in z.files else 4,
                  min_refine_pool=int(z["min_refine_pool"])
                  if "min_refine_pool" in z.files else 128)
        idx.dims = int(z["dims"])
        idx.coarse = z["coarse"]
        idx.codebooks = z["codebooks"]
        idx._ids = list(z["ids"])
        idx._codes = z["codes"]
        idx._assign = z["assign"]
        idx._alive = z["alive"]
        idx._vecs = z["vecs"] if "vecs" in z.files else None
        idx._id_pos = {e: i for i, e in enumerate(idx._ids)}
        return idx
