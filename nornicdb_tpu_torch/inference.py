"""Auto-relationship inference engine (counterpart of
``nornicdb_tpu/inference.py``).

Reference: pkg/inference — Engine (inference.go:219), OnStoreBestOfChunks
(:544, similarity via injected vector search), OnAccess co-access windows
(:778), SuggestTransitive (:835), cooldown table (cooldown.go), evidence
buffer (evidence.go). Suggested edges are created best-effort with typed
provenance properties, exactly like the reference's Store() wiring
(db.go:1997-2016).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from nornicdb_tpu_torch.storage.types import Edge, Engine, Node

SIMILAR_TO = "SIMILAR_TO"
CO_ACCESSED_WITH = "CO_ACCESSED_WITH"
RELATES_TO = "RELATES_TO"


@dataclass
class Suggestion:
    from_id: str
    to_id: str
    rel_type: str
    confidence: float
    reason: str


class InferenceEngine:
    def __init__(
        self,
        storage: Engine,
        search_service=None,
        similarity_threshold: float = 0.75,
        max_links_per_store: int = 3,
        cooldown_s: float = 300.0,
        min_confidence: float = 0.5,
        evidence: Optional["EvidenceBuffer"] = None,
        qc: Optional["HeimdallQC"] = None,
    ):
        self.storage = storage
        self.search = search_service
        self.similarity_threshold = similarity_threshold
        self.max_links_per_store = max_links_per_store
        self.cooldown_s = cooldown_s
        self.min_confidence = min_confidence
        # optional gates ahead of edge creation (reference: evidence.go
        # buffer + heimdall_qc.go batch review)
        self.evidence = evidence
        self.qc = qc
        self._cooldown: Dict[Tuple[str, str], float] = {}
        self._lock = threading.Lock()
        self.created_count = 0
        # a BackgroundDevicePlane attaches itself here; when present,
        # on_store_batch takes its batched candidate generation instead
        # of per-node searches
        self.device_plane = None

    # -- cooldown (reference: cooldown.go) --------------------------------

    def _on_cooldown(self, a: str, b: str) -> bool:
        """Check AND arm the cooldown (creation paths)."""
        key = (min(a, b), max(a, b))
        with self._lock:
            t = self._cooldown.get(key)
            if t is not None and time.time() - t < self.cooldown_s:
                return True
            self._cooldown[key] = time.time()
            return False

    def _peek_cooldown(self, a: str, b: str) -> bool:
        """Cooldown state without arming it (pure)."""
        key = (min(a, b), max(a, b))
        with self._lock:
            t = self._cooldown.get(key)
            return t is not None and time.time() - t < self.cooldown_s

    def _already_linked(self, a: str, b: str) -> bool:
        for e in self.storage.get_node_edges(a):
            if b in (e.start_node, e.end_node):
                return True
        return False

    # -- on store: similarity links (reference: OnStoreBestOfChunks :544) --

    def on_store(self, node: Node) -> List[Suggestion]:
        """Suggest (and create) SIMILAR_TO edges for a newly stored node.
        Uses best-of-chunks similarity when chunk embeddings exist."""
        if self.search is None:
            return []
        query_vectors: List[List[float]] = []
        if node.chunk_embeddings:
            query_vectors = list(node.chunk_embeddings)
        elif node.embedding is not None:
            query_vectors = [node.embedding]
        if not query_vectors:
            return []
        # best-of-chunks: keep each candidate's best similarity over chunks
        best: Dict[str, float] = {}
        for qv in query_vectors:
            for nid, score in self.search.vector_search_candidates(
                qv, k=self.max_links_per_store * 3
            ):
                if nid == node.id:
                    continue
                if score > best.get(nid, -1.0):
                    best[nid] = score
        candidates: List[Suggestion] = []
        for nid, score in sorted(best.items(), key=lambda kv: -kv[1]):
            if len(candidates) >= self.max_links_per_store:
                break
            if score < self.similarity_threshold:
                continue
            if self._on_cooldown(node.id, nid) or self._already_linked(node.id, nid):
                continue
            candidates.append(
                Suggestion(node.id, nid, SIMILAR_TO, float(score), "similarity"))
        if self.qc is not None and candidates:
            candidates = self.qc.review_batch(self.storage, candidates)
        suggestions: List[Suggestion] = []
        for sug in candidates:
            if self._create(sug):
                suggestions.append(sug)
        return suggestions

    def on_store_batch(self, nodes: List[Node]) -> Dict[str, List[Suggestion]]:
        """Batched similarity inference: candidate generation for the
        WHOLE batch of newly stored nodes rides the background device
        plane — one pass through the search service's own vector tiers —
        then each node runs the same threshold/cooldown/QC/create
        pipeline as :meth:`on_store`. Parity with the per-node path
        holds by construction (same search service, same filters);
        without a plane, or with its mode off, the per-node path
        serves."""
        if self.search is None:
            return {n.id: [] for n in nodes}
        plane = self.device_plane
        per_node: Dict[str, List[List[float]]] = {}
        items: List[Tuple[str, List[float]]] = []
        for node in nodes:
            if node.chunk_embeddings:
                qvs = list(node.chunk_embeddings)
            elif node.embedding is not None:
                qvs = [node.embedding]
            else:
                qvs = []
            per_node[node.id] = qvs
            for j, qv in enumerate(qvs):
                items.append((f"{node.id}\x00{j}", qv))
        cands = None
        if plane is not None and items:
            cands = plane.infer_candidates(
                items, k=self.max_links_per_store * 3)
        if cands is None:
            return {n.id: self.on_store(n) for n in nodes}
        out: Dict[str, List[Suggestion]] = {}
        for node in nodes:
            best: Dict[str, float] = {}
            for j in range(len(per_node[node.id])):
                for nid, score in cands.get(f"{node.id}\x00{j}", []):
                    if nid == node.id:
                        continue
                    if score > best.get(nid, -1.0):
                        best[nid] = score
            candidates: List[Suggestion] = []
            for nid, score in sorted(best.items(), key=lambda kv: -kv[1]):
                if len(candidates) >= self.max_links_per_store:
                    break
                if score < self.similarity_threshold:
                    continue
                if self._on_cooldown(node.id, nid) \
                        or self._already_linked(node.id, nid):
                    continue
                candidates.append(Suggestion(
                    node.id, nid, SIMILAR_TO, float(score), "similarity"))
            if self.qc is not None and candidates:
                candidates = self.qc.review_batch(self.storage, candidates)
            out[node.id] = [s for s in candidates if self._create(s)]
        return out

    # -- on access: co-access links (reference: OnAccess :778) --------------

    def on_access(self, temporal_tracker, node_id: str, min_count: int = 3) -> List[Suggestion]:
        out: List[Suggestion] = []
        for other, count in temporal_tracker.co_accessed(node_id):
            if count < min_count:
                continue
            conf = min(0.5 + count / 20.0, 0.95)
            if self._already_linked(node_id, other):
                continue
            if self.evidence is not None:
                # buffer the signal; only a threshold crossing proceeds.
                # TemporalTracker.session is a property returning
                # (session_id, nodes); tolerate method-style trackers too.
                sess = getattr(temporal_tracker, "session", None)
                if callable(sess):
                    sess = sess()
                session = str(sess[0]) if isinstance(sess, tuple) else "s0"
                ready = self.evidence.add(node_id, other, CO_ACCESSED_WITH,
                                          conf, signal="coaccess",
                                          session=session)
                if ready is None:
                    continue
                if self._peek_cooldown(node_id, other):
                    # crossing landed inside a cooldown window: keep the
                    # accumulated evidence instead of dropping it
                    self.evidence.restore(ready)
                    continue
                conf = min(0.95, ready.score_avg)
            if self._on_cooldown(node_id, other):
                continue
            sug = Suggestion(node_id, other, CO_ACCESSED_WITH, conf, "co-access")
            if self._create(sug):
                out.append(sug)
        return out

    # -- transitive (reference: SuggestTransitive :835) ---------------------

    def suggest_transitive(self, node_id: str, limit: int = 5) -> List[Suggestion]:
        """A-[SIMILAR]->B-[SIMILAR]->C implies A~C (not auto-created —
        lower confidence; the caller decides)."""
        out: List[Suggestion] = []
        first_hop = set()
        for e in self.storage.get_node_edges(node_id):
            other = e.end_node if e.start_node == node_id else e.start_node
            if e.type in (SIMILAR_TO, RELATES_TO):
                first_hop.add(other)
        seen = set(first_hop) | {node_id}
        for mid in first_hop:
            for e in self.storage.get_node_edges(mid):
                far = e.end_node if e.start_node == mid else e.start_node
                if far in seen or e.type not in (SIMILAR_TO, RELATES_TO):
                    continue
                seen.add(far)
                out.append(
                    Suggestion(node_id, far, RELATES_TO, 0.4, f"transitive via {mid}")
                )
                if len(out) >= limit:
                    return out
        return out

    # -- edge creation ------------------------------------------------------

    def _create(self, sug: Suggestion) -> bool:
        if sug.confidence < self.min_confidence:
            return False
        edge = Edge(
            id=str(uuid.uuid4()),
            type=sug.rel_type,
            start_node=sug.from_id,
            end_node=sug.to_id,
            properties={
                "confidence": sug.confidence,
                "inferred": True,
                "reason": sug.reason,
            },
        )
        try:
            self.storage.create_edge(edge)
            self.created_count += 1
            return True
        except KeyError:
            return False


# -- evidence buffer ------------------------------------------------------


@dataclass
class EvidenceThreshold:
    """When accumulated evidence is sufficient to materialize an edge
    (reference: evidence.go:141-147)."""

    min_count: int = 3
    min_score: float = 1.5
    min_sessions: int = 1
    max_age_s: float = 7 * 86400.0


@dataclass
class Evidence:
    """Accumulated signals for one potential edge
    (reference: evidence.go:128-139)."""

    src: str
    dst: str
    label: str
    count: int = 0
    score_sum: float = 0.0
    first_ts: float = 0.0
    last_ts: float = 0.0
    sessions: set = None  # type: ignore[assignment]
    signals: list = None  # type: ignore[assignment]

    @property
    def score_avg(self) -> float:
        return self.score_sum / self.count if self.count else 0.0


class EvidenceBuffer:
    """Accumulates relationship signals before materialization, so a
    single weak signal never creates an edge (reference:
    evidence.go:148-200 EvidenceBuffer; wired ahead of edge creation the
    way the reference buffers Auto-TLP suggestions)."""

    def __init__(self, thresholds: Optional[Dict[str, EvidenceThreshold]] = None,
                 default: Optional[EvidenceThreshold] = None):
        self._entries: Dict[Tuple[str, str, str], Evidence] = {}
        self._thresholds = thresholds or {}
        self._default = default or EvidenceThreshold()
        self._lock = threading.Lock()
        self.total_added = 0
        self.total_materialized = 0
        self.total_expired = 0

    def set_threshold(self, label: str, threshold: EvidenceThreshold) -> None:
        with self._lock:
            self._thresholds[label] = threshold

    def _threshold(self, label: str) -> EvidenceThreshold:
        return self._thresholds.get(label, self._default)

    def add(self, src: str, dst: str, label: str, score: float,
            signal: str = "similarity", session: str = "",
            at: Optional[float] = None) -> Optional[Evidence]:
        """Record one signal; returns the Evidence iff it just crossed
        its threshold (caller materializes the edge)."""
        at = time.time() if at is None else at
        key = (src, dst, label)
        th = self._threshold(label)
        with self._lock:
            ev = self._entries.get(key)
            if ev is not None and at - ev.first_ts > th.max_age_s:
                del self._entries[key]
                self.total_expired += 1
                ev = None
            if ev is None:
                ev = Evidence(src=src, dst=dst, label=label, first_ts=at,
                              last_ts=at, sessions=set(), signals=[])
                self._entries[key] = ev
            before = self._sufficient(ev, th)
            ev.count += 1
            ev.score_sum += score
            ev.last_ts = at
            if session:
                ev.sessions.add(session)
            if signal not in ev.signals:
                ev.signals.append(signal)
            self.total_added += 1
            if not before and self._sufficient(ev, th):
                self.total_materialized += 1
                del self._entries[key]
                return ev
            return None

    def restore(self, ev: Evidence) -> None:
        """Put crossed-but-unconsumed evidence back (e.g. the edge
        creation was deferred by a cooldown)."""
        with self._lock:
            self._entries[(ev.src, ev.dst, ev.label)] = ev
            self.total_materialized -= 1

    @staticmethod
    def _sufficient(ev: Evidence, th: EvidenceThreshold) -> bool:
        return (ev.count >= th.min_count
                and ev.score_sum >= th.min_score
                and len(ev.sessions or ()) >= th.min_sessions)

    def expire(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        with self._lock:
            doomed = [
                k for k, ev in self._entries.items()
                if now - ev.first_ts > self._threshold(ev.label).max_age_s
            ]
            for k in doomed:
                del self._entries[k]
            self.total_expired += len(doomed)
            return len(doomed)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            rate = (self.total_materialized / self.total_added
                    if self.total_added else 0.0)
            return {
                "entries": len(self._entries),
                "added": self.total_added,
                "materialized": self.total_materialized,
                "expired": self.total_expired,
                "materialize_rate": round(rate, 4),
            }


# -- Heimdall QC ----------------------------------------------------------


class HeimdallQC:
    """SLM review of suggested edges before creation (reference:
    heimdall_qc.go:196 HeimdallQC.ReviewBatch — approve/reject/retype).

    ``generate_fn(prompt) -> str`` is any Heimdall generator (the JAX
    decoder, an HTTP backend, or a stub). The prompt asks for one verdict
    letter per suggestion; unparseable output fails open (all approved),
    matching the reference's fail-open posture for QC outages."""

    def __init__(self, generate_fn, min_confidence_to_skip: float = 0.9,
                 cache_ttl_s: float = 300.0):
        self.generate = generate_fn
        self.min_confidence_to_skip = min_confidence_to_skip
        self.cache_ttl_s = cache_ttl_s
        self._cache: Dict[str, Tuple[float, List[bool]]] = {}
        self._lock = threading.Lock()
        self.batches = 0
        self.suggestions_in = 0
        self.suggestions_out = 0
        self.cache_hits = 0
        self.errors = 0

    def _describe(self, storage: Engine, node_id: str) -> str:
        try:
            n = storage.get_node(node_id)
        except KeyError:
            return node_id
        content = str(n.properties.get("content", ""))[:80]
        return f"{'/'.join(n.labels)}: {content or node_id}"

    def review_batch(self, storage: Engine,
                     suggestions: List[Suggestion]) -> List[Suggestion]:
        """Returns the approved subset. High-confidence suggestions skip
        review; the rest are judged in one generation call. The reference
        runs this on its background admission lane; the port has no
        lanes yet (ROADMAP §A12)."""
        self.batches += 1
        self.suggestions_in += len(suggestions)
        skip = [s for s in suggestions
                if s.confidence >= self.min_confidence_to_skip]
        to_review = [s for s in suggestions
                     if s.confidence < self.min_confidence_to_skip]
        if not to_review:
            self.suggestions_out += len(skip)
            return skip
        lines = [
            f"{i + 1}. ({self._describe(storage, s.from_id)}) "
            f"-[{s.rel_type}]-> ({self._describe(storage, s.to_id)}) "
            f"confidence={s.confidence:.2f} reason={s.reason}"
            for i, s in enumerate(to_review)
        ]
        prompt = (
            "Review proposed graph relationships. Answer with one letter "
            "per line, Y to approve or N to reject:\n" + "\n".join(lines)
            + "\nAnswers:"
        )
        key = prompt
        now = time.time()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and now - hit[0] < self.cache_ttl_s:
                self.cache_hits += 1
                verdicts = hit[1]
            else:
                verdicts = None
        if verdicts is None:
            try:
                reply = self.generate(prompt)
                # one verdict per line: first standalone Y/N token of each
                # non-empty line (prose like an echoed "Answers:" header
                # must not contribute stray letters)
                letters = []
                for line in reply.splitlines():
                    token = line.strip().upper()[:1]
                    if token in ("Y", "N"):
                        letters.append(token)
                if len(letters) < len(to_review):
                    raise ValueError("short verdict")
                verdicts = [c == "Y" for c in letters[: len(to_review)]]
                with self._lock:
                    if len(self._cache) >= 256:
                        # drop expired, then oldest
                        for k in [k for k, (t, _) in self._cache.items()
                                  if now - t >= self.cache_ttl_s]:
                            del self._cache[k]
                        while len(self._cache) >= 256:
                            del self._cache[next(iter(self._cache))]
                    self._cache[key] = (now, verdicts)
            except Exception:
                self.errors += 1
                # fail open but do NOT cache: the next identical batch
                # must retry QC once the model recovers
                verdicts = [True] * len(to_review)
        approved = skip + [s for s, ok in zip(to_review, verdicts) if ok]
        self.suggestions_out += len(approved)
        return approved
