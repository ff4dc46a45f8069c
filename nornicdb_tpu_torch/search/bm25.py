"""BM25 fulltext index (Okapi BM25, compact postings): a copy of the parts
of ``nornicdb_tpu/search/bm25.py`` the main path uses (index, remove,
search, idf, compaction), the seeds of the HNSW build (``seed_doc_ids``)
and what the device snapshot (``search/device_bm25.py``) reads: the
mutation generation, the capped changelog, live term statistics, exact
scoring of chosen documents, the CSR flattening and per-slot liveness,
and ``to_dict``/``from_dict``, JSON-equal to the reference's for the
same inserts and deletes. Host scoring stays vectorized with NumPy over the postings arrays, in
float32 with terms in sorted order.
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
    __slots__ = ("doc_ids", "tfs", "_np_ids", "_np_tfs", "_np_n")

    def __init__(self):
        self.doc_ids: List[int] = []
        self.tfs: List[int] = []
        self._np_ids = np.zeros(0, dtype=np.int64)
        self._np_tfs = np.zeros(0, dtype=np.float32)
        self._np_n = 0  # entries converted so far

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Numpy views of the lists. Postings only append (compaction
        swaps in fresh postings), so only the entries appended since the
        last call are converted, into buffers that grow by doubling; a
        view handed out earlier keeps its length and values."""
        n, have = len(self.doc_ids), self._np_n
        if have != n:
            if self._np_ids.size < n:
                cap = max(n, 2 * have, 16)
                ids = np.empty(cap, dtype=np.int64)
                tfs = np.empty(cap, dtype=np.float32)
                ids[:have] = self._np_ids[:have]
                tfs[:have] = self._np_tfs[:have]
                self._np_ids, self._np_tfs = ids, tfs
            self._np_ids[have:n] = self.doc_ids[have:n]
            self._np_tfs[have:n] = self.tfs[have:n]
            self._np_n = n
        return self._np_ids[:n], self._np_tfs[:n]


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
        # posting entries held, kept incrementally (resource_stats)
        self._n_postings = 0
        self._np_gen = -1
        self._np_doc_len: Optional[np.ndarray] = None
        self._np_alive: Optional[np.ndarray] = None
        # (mutation gen, ext_id) of adds/updates, capped; the device
        # snapshot exact-scores these between rebuilds. _changelog_floor
        # marks how far back it reaches; compaction remaps slots, so it
        # moves the floor past every outstanding marker
        self._changelog: List[Tuple[int, str]] = []
        self._changelog_floor = 0
        # slot ids mean something only between compactions
        self.compactions = 0
        # bumped when a slot dies (a removal, or the update that retires
        # a doc's old slot) and on compaction: slot liveness moves only then
        self.tombstones = 0

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
            self._n_postings += len(counts)
            self._log_change_locked(doc_id)

    def changelog_cap(self) -> int:
        return max(4096, len(self._ext_ids) // 4)

    def resource_stats(self) -> Dict[str, float]:
        """Memory and freshness accounting for obs/resources.py: postings
        footprint (the incremental entry count, never a walk of the
        vocabulary), tombstone pressure, and changelog depth against its
        cap. A host index: the device CSR snapshot reports its own."""
        with self._lock:
            n_slots = len(self._ext_ids)
            return {
                "rows": self._n_alive,
                "capacity": n_slots,
                "device_bytes": 0,
                # ~16 B per posting entry (a doc id and a tf), 24 B a slot
                "host_bytes": self._n_postings * 16 + n_slots * 24,
                "dead_fraction": round((n_slots - self._n_alive) / max(n_slots, 1), 6),
                "changelog_depth": len(self._changelog),
                "changelog_cap": self.changelog_cap(),
                "mutations": self._mut_gen,
                "postings": self._n_postings,
                "terms": len(self._postings),
            }

    def _log_change_locked(self, doc_id: str) -> None:
        self._changelog.append((self._mut_gen, doc_id))
        limit = self.changelog_cap()
        if len(self._changelog) > limit:
            cut = len(self._changelog) - limit
            self._changelog_floor = self._changelog[cut - 1][0]
            del self._changelog[:cut]

    def changed_since(self, seq: int) -> Optional[List[str]]:
        """ext_ids added or updated after mutation ``seq`` (latest first,
        deduped; deletes are not reported). None when the changelog was
        trimmed, or slots remapped by compaction, past ``seq``."""
        with self._lock:
            if seq < self._changelog_floor:
                return None
            out: List[str] = []
            for s, eid in reversed(self._changelog):
                if s <= seq:
                    break
                out.append(eid)
        return list(dict.fromkeys(out))

    def _remove_locked(self, doc_id: str) -> None:
        idx = self._int_of.pop(doc_id, None)
        if idx is None or not self._alive[idx]:
            return
        self._mut_gen += 1
        self.tombstones += 1
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
        self._n_postings = sum(len(p.doc_ids) for p in new_postings.values())
        self._mut_gen += 1
        self.compactions += 1
        self.tombstones += 1
        # slots were remapped: every outstanding snapshot marker is void
        self._changelog.clear()
        self._changelog_floor = self._mut_gen

    def __contains__(self, doc_id: str) -> bool:
        with self._lock:
            idx = self._int_of.get(doc_id)
            return idx is not None and self._alive[idx]

    def __len__(self) -> int:
        return self._n_alive

    def ids(self) -> List[str]:
        """Live (non-tombstoned) document ids."""
        with self._lock:
            return [e for e, i in self._int_of.items() if self._alive[i]]

    @property
    def mut_gen(self) -> int:
        """Mutation generation, bumped on every add/update/remove/
        compaction; the device snapshot keys its freshness on it."""
        return self._mut_gen

    # -- scoring ---------------------------------------------------------

    def _idf(self, df: int) -> float:
        n = max(self._n_alive, 1)
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def term_stats(self, terms: Sequence[str]) -> Tuple[Dict[str, int], int, float]:
        """(live df per term, n_alive, avgdl) under one lock hold."""
        with self._lock:
            avgdl = max(self._total_len / max(self._n_alive, 1), 1.0)
            return ({t: self._df.get(t, 0) for t in terms},
                    self._n_alive, avgdl)

    def search(self, query: str, k: int = 10) -> List[Tuple[str, float]]:
        """Top-k (doc_id, bm25_score)."""
        with self._lock:
            return self._search_locked(tokenize(query), k)

    def search_batch(
        self, queries: Sequence[str], k: int = 10
    ) -> List[List[Tuple[str, float]]]:
        """One ``search`` per query under one lock hold: the contract the
        device path (``DeviceBM25.search_batch``) shares."""
        with self._lock:
            return [self._search_locked(tokenize(q), k) for q in queries]

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

    def score_docs(
        self, tokens: Sequence[str], doc_ids: Sequence[str]
    ) -> Dict[str, float]:
        """Exact BM25 scores of chosen live docs for a tokenized query
        (only docs matching a term appear): the device snapshot's
        read-your-writes side-scan of docs indexed after its build."""
        with self._lock:
            toks = sorted(set(tokens))
            want: Dict[int, str] = {}
            for eid in doc_ids:
                idx = self._int_of.get(eid)
                if idx is not None and self._alive[idx]:
                    want[idx] = eid
            if not toks or not want:
                return {}
            avgdl = max(self._total_len / max(self._n_alive, 1), 1.0)
            want_idx = sorted(want)
            out: Dict[str, float] = {}
            for t in toks:
                p = self._postings.get(t)
                df = self._df.get(t, 0)
                if p is None or df == 0:
                    continue
                idf = np.float32(self._idf(df))
                ids, tfs = p.arrays()
                # postings append in increasing slot order: binary search
                pos = np.searchsorted(ids, want_idx)
                for idx, j in zip(want_idx, pos):
                    if j >= ids.size or int(ids[j]) != idx:
                        continue
                    eid = want[idx]
                    tf = np.float32(tfs[j])
                    dl = np.float32(self._doc_len[idx])
                    tf_norm = tf * np.float32(K1 + 1.0) / (
                        tf + np.float32(K1) * np.float32(1.0 - B + B * dl / avgdl))
                    out[eid] = float(np.float32(out.get(eid, 0.0))
                                     + idf * tf_norm)
            return out

    def csr_snapshot(self) -> Dict[str, object]:
        """The live postings flattened for the device scorer: sorted
        terms, per-term offset ranges over (doc_row, tf) columns in a dense
        live-row space (tombstones dropped), doc lengths, row ext ids and
        each row's slot."""
        with self._lock:
            doc_len, alive = self._np_state()
            rows = np.nonzero(alive)[0]
            remap = np.full(len(self._ext_ids), -1, dtype=np.int32)
            remap[rows] = np.arange(len(rows), dtype=np.int32)
            terms = sorted(self._postings)
            doc_parts: List[np.ndarray] = []
            tf_parts: List[np.ndarray] = []
            offsets = np.zeros(len(terms) + 1, dtype=np.int64)
            total = 0
            for ti, t in enumerate(terms):
                ids, tfs = self._postings[t].arrays()
                live = alive[ids]
                doc_parts.append(remap[ids[live]])
                tf_parts.append(tfs[live])
                total += int(live.sum())
                offsets[ti + 1] = total
            return {
                "gen": self._mut_gen,
                "compactions": self.compactions,
                "tombstones": self.tombstones,
                "vocab": {t: i for i, t in enumerate(terms)},
                "offsets": offsets,
                "post_doc": (np.concatenate(doc_parts)
                             if doc_parts else np.zeros(0, np.int32)),
                "post_tf": (np.concatenate(tf_parts).astype(np.float32)
                            if tf_parts else np.zeros(0, np.float32)),
                "doc_len": doc_len[rows].astype(np.float32),
                "row_ids": [self._ext_ids[int(s)] for s in rows],
                # consumers live-filter by SLOT: an update tombstones the
                # old slot while the ext id stays live at a new one
                "slots": rows.astype(np.int64),
            }

    def alive_slots(
        self, slots: Sequence[int], expect_compactions: Optional[int] = None,
    ) -> Optional[np.ndarray]:
        """Bool per slot id: still live? None when a compaction remapped
        the slot space since ``expect_compactions`` (read and check under
        one lock hold)."""
        with self._lock:
            if expect_compactions is not None \
                    and self.compactions != expect_compactions:
                return None
            _, alive = self._np_state()
            sl = np.asarray(slots, dtype=np.int64)
            ok = (sl >= 0) & (sl < alive.size)
            out = np.zeros(sl.shape, dtype=bool)
            out[ok] = alive[sl[ok]]
            return out

    # -- seed selection (BM25-seeded builds) ------------------------------

    def seed_doc_ids(
        self, max_seeds: int = 2048, n_terms: int = 256, per_term: Optional[int] = None
    ) -> List[str]:
        """Lexically discriminative docs: take the ``n_terms`` highest-IDF
        terms (ignoring hapax noise) and collect their top-tf docs, up to
        ``max_seeds``, highest-signal first. They anchor the HNSW build's
        insertion order."""
        with self._lock:
            if self._n_alive == 0:
                return []
            ranked_terms = []
            for t in self._postings:
                df = self._df.get(t, 0)
                if df < 2:  # hapax terms don't discriminate clusters
                    continue
                ranked_terms.append((self._idf(df), t))
            ranked_terms.sort(reverse=True)
            per_term = per_term or max(1, max_seeds // max(n_terms, 1))
            seen: Dict[int, None] = {}
            for _, t in ranked_terms[:n_terms]:
                p = self._postings[t]
                order = np.argsort(-np.asarray(p.tfs))[:per_term]
                for j in order:
                    idx = p.doc_ids[int(j)]
                    if self._alive[idx]:
                        seen.setdefault(idx, None)
                if len(seen) >= max_seeds:
                    break
            return [self._ext_ids[i] for i in list(seen)[:max_seeds]]

    # -- persistence ------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "ext_ids": list(self._ext_ids),
                "doc_len": list(self._doc_len),
                "alive": [bool(a) for a in self._alive],
                "postings": {
                    t: {"ids": list(p.doc_ids), "tfs": list(p.tfs)}
                    for t, p in self._postings.items()
                },
            }

    @classmethod
    def from_dict(cls, d: dict) -> "BM25Index":
        idx = cls()
        idx._ext_ids = list(d["ext_ids"])
        idx._doc_len = list(d["doc_len"])
        idx._alive = list(d["alive"])
        idx._int_of = {e: i for i, e in enumerate(idx._ext_ids) if idx._alive[i]}
        terms_per_doc: List[List[str]] = [[] for _ in idx._ext_ids]
        for t, p in d["postings"].items():
            post = _Posting()
            post.doc_ids = list(p["ids"])
            post.tfs = list(p["tfs"])
            idx._postings[t] = post
            df = 0
            for did in post.doc_ids:
                if idx._alive[did]:
                    df += 1
                    terms_per_doc[did].append(t)
            if df:
                idx._df[t] = df
        idx._doc_terms = [tuple(ts) if idx._alive[i] else None
                          for i, ts in enumerate(terms_per_doc)]
        idx._total_len = sum(n for n, a in zip(idx._doc_len, idx._alive) if a)
        idx._n_alive = sum(1 for a in idx._alive if a)
        idx._n_postings = sum(len(p.doc_ids) for p in idx._postings.values())
        return idx
