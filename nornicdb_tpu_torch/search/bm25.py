"""BM25 fulltext index (Okapi BM25, compact postings): a copy of the parts
of ``nornicdb_tpu/search/bm25.py`` the main path uses (index, remove,
search, idf, compaction). Scoring stays on the host, vectorized with
NumPy over the postings arrays, in float32 with terms in sorted order.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# minimal english stopword set
STOPWORDS = frozenset(
    """a an and are as at be by for from has he in is it its of on that the
    to was were will with this these those i you your not or but if then
    than so we they them there here what which who whom when where how"""
    .split()
)

K1 = 1.2
B = 0.75


def tokenize(text: str, min_len: int = 2, max_len: int = 40) -> List[str]:
    """Lowercase alphanumeric tokens, stopword- and length-filtered."""
    out = []
    for tok in _TOKEN_RE.findall(text.lower()):
        if len(tok) < min_len or len(tok) > max_len:
            continue
        if tok in STOPWORDS:
            continue
        out.append(tok)
    return out


class _Posting:
    __slots__ = ("doc_ids", "tfs", "_np_ids", "_np_tfs")

    def __init__(self):
        self.doc_ids: List[int] = []
        self.tfs: List[int] = []
        self._np_ids: Optional[np.ndarray] = None
        self._np_tfs: Optional[np.ndarray] = None

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Cached numpy views, keyed by list length (postings only
        append; compaction swaps in fresh postings)."""
        if self._np_ids is None or self._np_ids.size != len(self.doc_ids):
            self._np_ids = np.asarray(self.doc_ids, dtype=np.int64)
            self._np_tfs = np.asarray(self.tfs, dtype=np.float32)
        return self._np_ids, self._np_tfs


class BM25Index:
    """Incremental BM25 index over (doc_id -> text). Thread-safe."""

    def __init__(self):
        self._lock = threading.RLock()
        self._postings: Dict[str, _Posting] = {}
        self._doc_len: List[int] = []  # internal idx -> token count
        self._ext_ids: List[str] = []  # internal idx -> external id
        self._int_of: Dict[str, int] = {}
        self._alive: List[bool] = []
        self._total_len = 0
        self._n_alive = 0
        # per-term LIVE document frequency, kept on add/remove
        self._df: Dict[str, int] = {}
        # slot -> unique terms of that doc, so a tombstone can decrement df
        self._doc_terms: List[Optional[Tuple[str, ...]]] = []
        self._mut_gen = 0
        self._np_gen = -1
        self._np_doc_len: Optional[np.ndarray] = None
        self._np_alive: Optional[np.ndarray] = None

    def _np_state(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._np_gen != self._mut_gen:
            self._np_doc_len = np.asarray(self._doc_len, dtype=np.float32)
            self._np_alive = np.asarray(self._alive, dtype=bool)
            self._np_gen = self._mut_gen
        return self._np_doc_len, self._np_alive

    # -- indexing --------------------------------------------------------

    def index(self, doc_id: str, text: str) -> None:
        with self._lock:
            if doc_id in self._int_of:
                self._remove_locked(doc_id)
            self._maybe_compact_locked()
            self._mut_gen += 1
            toks = tokenize(text)
            idx = len(self._ext_ids)
            self._ext_ids.append(doc_id)
            self._int_of[doc_id] = idx
            self._doc_len.append(len(toks))
            self._alive.append(True)
            self._total_len += len(toks)
            self._n_alive += 1
            counts: Dict[str, int] = {}
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
            for t, c in counts.items():
                p = self._postings.get(t)
                if p is None:
                    p = self._postings[t] = _Posting()
                p.doc_ids.append(idx)
                p.tfs.append(c)
                self._df[t] = self._df.get(t, 0) + 1
            self._doc_terms.append(tuple(counts))

    def _remove_locked(self, doc_id: str) -> None:
        idx = self._int_of.pop(doc_id, None)
        if idx is None or not self._alive[idx]:
            return
        self._mut_gen += 1
        self._alive[idx] = False
        self._total_len -= self._doc_len[idx]
        self._n_alive -= 1
        for t in self._doc_terms[idx] or ():
            left = self._df.get(t, 0) - 1
            if left > 0:
                self._df[t] = left
            else:
                self._df.pop(t, None)
        self._doc_terms[idx] = None

    def remove(self, doc_id: str) -> None:
        with self._lock:
            self._remove_locked(doc_id)

    def _maybe_compact_locked(self) -> None:
        """Re-indexing tombstones the old slot; rebuild in place once dead
        slots dominate so hot updates do not grow postings without bound."""
        n_slots = len(self._ext_ids)
        if n_slots < 1024 or self._n_alive * 2 > n_slots:
            return
        remap: Dict[int, int] = {}
        new_ext: List[str] = []
        new_len: List[int] = []
        new_terms: List[Optional[Tuple[str, ...]]] = []
        for old_idx, ext in enumerate(self._ext_ids):
            if self._alive[old_idx]:
                remap[old_idx] = len(new_ext)
                new_ext.append(ext)
                new_len.append(self._doc_len[old_idx])
                new_terms.append(self._doc_terms[old_idx])
        new_postings: Dict[str, _Posting] = {}
        new_df: Dict[str, int] = {}
        for t, p in self._postings.items():
            np_post = _Posting()
            for did, tf in zip(p.doc_ids, p.tfs):
                new_idx = remap.get(did)
                if new_idx is not None:
                    np_post.doc_ids.append(new_idx)
                    np_post.tfs.append(tf)
            if np_post.doc_ids:
                new_postings[t] = np_post
                new_df[t] = len(np_post.doc_ids)
        self._ext_ids = new_ext
        self._doc_len = new_len
        self._alive = [True] * len(new_ext)
        self._int_of = {e: i for i, e in enumerate(new_ext)}
        self._postings = new_postings
        self._df = new_df
        self._doc_terms = new_terms
        self._mut_gen += 1

    def __contains__(self, doc_id: str) -> bool:
        with self._lock:
            idx = self._int_of.get(doc_id)
            return idx is not None and self._alive[idx]

    def __len__(self) -> int:
        return self._n_alive

    # -- scoring ---------------------------------------------------------

    def _idf(self, df: int) -> float:
        n = max(self._n_alive, 1)
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def search(self, query: str, k: int = 10) -> List[Tuple[str, float]]:
        """Top-k (doc_id, bm25_score)."""
        with self._lock:
            return self._search_locked(tokenize(query), k)

    def _search_locked(self, toks_seq: Sequence[str],
                       k: int) -> List[Tuple[str, float]]:
        # terms in SORTED order, idf cast to float32: per-doc accumulation
        # order and precision are fixed, so rankings are reproducible
        toks = sorted(set(toks_seq))
        if not toks or self._n_alive == 0:
            return []
        n_docs = len(self._ext_ids)
        avgdl = max(self._total_len / max(self._n_alive, 1), 1.0)
        scores = np.zeros(n_docs, dtype=np.float32)
        doc_len, alive = self._np_state()
        touched = np.zeros(n_docs, dtype=bool)
        for t in toks:
            p = self._postings.get(t)
            if p is None:
                continue
            ids, tfs = p.arrays()
            live = alive[ids]
            ids, tfs = ids[live], tfs[live]
            df = self._df.get(t, 0)
            if df == 0 or ids.size == 0:
                continue
            idf = np.float32(self._idf(df))
            dl = doc_len[ids]
            tf_norm = tfs * (K1 + 1.0) / (tfs + K1 * (1.0 - B + B * dl / avgdl))
            scores[ids] += idf * tf_norm
            touched[ids] = True
        cand = np.nonzero(touched & alive)[0]
        if cand.size == 0:
            return []
        order = cand[np.argsort(-scores[cand], kind="stable")][:k]
        return [(self._ext_ids[i], float(scores[i])) for i in order]
