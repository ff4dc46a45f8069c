"""Columnar graph snapshot for vectorized query execution (counterpart
of ``nornicdb_tpu/query/columnar.py``: numpy on the host, as there).

The reference parallelizes hot query shapes by chunking node/edge slices
across cores (pkg/cypher/parallel.go:99-403) and serves LDBC/Northwind
shapes through specialized executors over indexed storage
(optimized_executors.go:25-282, storage_fastpaths.go:14-54). The
TPU-native redesign replaces both with *columnar* execution: the graph is
snapshotted into flat arrays (a global node table, per-edge-type CSR
adjacency, lazily materialized property columns and hash property
indexes) and query shapes compile to batched array ops — numpy for the
small/latency-bound shapes, with the same layout streaming to the device
data plane (ops/) for large scans. SURVEY §2.8 row 1 maps the
reference's multicore chunk parallelism to exactly this design.

The catalog is invalidated wholesale on updates/deletes via
`invalidate()`, wired to executor write stats and to storage mutation
listeners in db.py. Pure creations are *incremental*: node/edge create
deltas extend the snapshot, the per-(etype, direction, label) degree
arrays, and two families of materialized aggregate views in place —
the count-store analog of the reference's single-hop fast aggregations
(pkg/cypher/traversal_fast_agg.go:15,57) and hand-written co-occurrence
executors (optimized_executors.go:25-282):

- `_StripView`: per-anchor-node sums of terminal-hop filtered degrees,
  grouped by the adjacent node over one relationship type — answers the
  "avg friends per city" family in O(#groups) per query.
- `_GramView`: the co-occurrence Gram matrix C = Ma^T @ Mb with the
  same-edge diagonal correction folded in — answers the "tag
  co-occurrence" family in O(nnz(C)) per query.

Without these, both shapes re-run O(edges) array work per query, which
is fine at 10^3 nodes and hopeless at 10^5 (the scale of the LDBC
social graph, 50,000 persons and 1 M KNOWS edges).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from nornicdb_tpu_torch.storage.types import Direction, Edge, Engine, Node


class EdgeTable:
    """All edges of one type, as parallel arrays over global node rows."""

    __slots__ = (
        "etype", "src", "dst", "edges",
        "_csr_out", "_csr_in", "_prop_cols", "_edge_ids",
        "_buf_src", "_buf_dst",
    )

    def __init__(self, etype: str, src: np.ndarray, dst: np.ndarray,
                 edges: List[Edge]):
        self.etype = etype
        # src/dst are exact-length views over capacity buffers so appends
        # are amortized O(1) (a write-heavy compound loop would otherwise
        # pay an O(len) array copy per created edge). Readers snapshot
        # the views; the region behind a view is never rewritten.
        self._buf_src = src
        self._buf_dst = dst
        self.src = src  # int32[ne] global node row of start
        self.dst = dst  # int32[ne] global node row of end
        self.edges = edges  # Edge objects aligned with src/dst
        self._csr_out: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._csr_in: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._prop_cols: Dict[str, np.ndarray] = {}
        self._edge_ids = {e.id for e in edges}

    def __len__(self) -> int:
        return len(self.edges)

    def csr(self, direction: str, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr, order): edge rows grouped by src (out) or dst (in).

        ``order`` is a permutation of edge rows; edges with source node g
        occupy order[indptr[g]:indptr[g+1]] (for direction 'out').
        """
        if direction == "out":
            if self._csr_out is None:
                self._csr_out = _build_csr(self.src, n_nodes)
            return self._csr_out
        if direction == "in":
            if self._csr_in is None:
                self._csr_in = _build_csr(self.dst, n_nodes)
            return self._csr_in
        raise ValueError(f"bad direction {direction}")

    def prop_col(self, name: str) -> np.ndarray:
        """Object array of edge property ``name`` aligned with edge rows."""
        col = self._prop_cols.get(name)
        if col is None:
            col = np.empty(len(self.edges), dtype=object)
            for i, e in enumerate(self.edges):
                col[i] = e.properties.get(name)
            self._prop_cols[name] = col
        return col

    def append_edge(self, src_row: int, dst_row: int, edge: Edge) -> None:
        """Create-delta append; drops derived caches (CSR, prop cols).

        Idempotent: a lazy table build that raced the write may have
        already read this edge from storage before the create listener
        fired — appending again would duplicate it in every join and
        degree count."""
        if edge.id in self._edge_ids:
            return
        self._edge_ids.add(edge.id)
        n = len(self.src)
        if n == len(self._buf_src):
            cap = max(16, 2 * n)
            grown = np.empty(cap, dtype=np.int32)
            grown[:n] = self._buf_src
            self._buf_src = grown
            grown = np.empty(cap, dtype=np.int32)
            grown[:n] = self._buf_dst
            self._buf_dst = grown
        self._buf_src[n] = src_row
        self._buf_dst[n] = dst_row
        self.src = self._buf_src[:n + 1]
        self.dst = self._buf_dst[:n + 1]
        self.edges.append(edge)
        self._csr_out = None
        self._csr_in = None
        self._prop_cols.clear()


class _StripView:
    """Materialized two-hop grouped degree aggregation.

    For a chain (g)-[:ETYPE1]-(p:PLabel)-[:ETYPE2]-(f:FLabel) where the
    terminal f is consumed only by count(), the per-g aggregates are
    maintained densely over ALL global node rows (g's label filter is a
    query-time row selection, so it is not part of the key):

    - ``deg[p]``: # ETYPE2 edges of p in dir2 whose far end has FLabel
      (a private copy — updates must read the pre-increment value)
    - ``sum_deg[g]``: sum of deg[p] over ETYPE1 edges (g, p) with p
      carrying PLabel == count(f) per g == count(p) per g (weighted)
    - ``nnz[g]``: # *distinct* p with PLabel, an ETYPE1 edge to g, and
      deg[p] > 0 == count(DISTINCT p) per g

    Incrementally maintained on edge creates of either type; the catalog
    drops the view when it cannot update exactly (unknown node rows,
    missing adjacency, over-budget probes). Updates are in-place single
    int64 stores — aligned and untearable for concurrent readers; node
    creates extend arrays copy-on-write (np.append).
    """

    __slots__ = ("deg", "sum_deg", "nnz")

    def __init__(self, deg: np.ndarray, sum_deg: np.ndarray, nnz: np.ndarray):
        self.deg = deg
        self.sum_deg = sum_deg
        self.nnz = nnz


class _SortedAdjacency:
    """Materialized segment-sorted adjacency strip.

    CSR-like layout over ALL global node rows: the far ends of one edge
    type's edges, grouped by the near-side node, each segment pre-sorted
    by a NUMERIC property of the far node — descending, with nulls
    first (Cypher DESC null semantics, mirroring fastpaths's
    _order_from_keys null -> +inf convention).

    This answers the "recent messages of friends" family in O(friends *
    k): per-friend top-k is a head slice of the friend's segment, and
    the global top-k is a merge of those heads — no per-query expansion
    over every message, no per-query sort of the full candidate set.
    The strip is dropped (lazy rebuild) on any create of its edge type:
    inserting into sorted segments in place would cost O(E) per create,
    which is the wrong trade for a read-hot view.
    """

    __slots__ = ("indptr", "nbr", "keys")

    def __init__(self, indptr: np.ndarray, nbr: np.ndarray,
                 keys: np.ndarray):
        self.indptr = indptr  # int64[n_nodes+1]
        self.nbr = nbr        # int32[n_usable_edges] far rows, seg-sorted
        self.keys = keys      # float64 sort keys aligned with nbr


class _GramView:
    """Materialized co-occurrence Gram matrix for (a)<-[:T]-(mid)-[:T]->(b).

    ``C[i, j]`` = # mids with an edge to a-candidate i and a *different*
    edge to b-candidate j (the same-edge diagonal correction is folded
    in at build). ``far_lists`` maps mid global row -> list of far
    global rows of its existing usable edges, so an edge create updates
    C in O(deg(mid)) with in-place (untearable) int64 stores.

    ``coo()`` is the pre-aggregated sparse decomposition the query path
    consumes (pre-aggregation, not a per-query nonzero):
    recomputed only when ``gen`` moved, i.e. after a C mutation.
    """

    __slots__ = ("C", "a_cands", "b_cands", "a_pos", "b_pos", "far_lists",
                 "gen", "_coo_gen", "_coo")

    def __init__(self, C, a_cands, b_cands, a_pos, b_pos, far_lists):
        self.C = C
        self.a_cands = a_cands
        self.b_cands = b_cands
        self.a_pos = a_pos
        self.b_pos = b_pos
        self.far_lists = far_lists
        self.gen = 0
        self._coo_gen = -1
        self._coo = None

    def coo(self):
        """(ii, jj, weights, a_rows_i32, b_rows_i32) of positive cells.

        Maintained across the view's in-place updates via ``gen``; a
        torn read (concurrent writer bumping gen mid-extract) yields a
        value consistent with SOME interleaving of single int64 cell
        stores — same guarantee the raw C reads already give — and is
        simply not cached."""
        g0 = self.gen
        cached = self._coo
        if cached is not None and self._coo_gen == g0:
            return cached
        c = self.C
        ii, jj = np.nonzero(c > 0)
        out = (
            ii, jj, c[ii, jj],
            self.a_cands[ii].astype(np.int32, copy=False),
            self.b_cands[jj].astype(np.int32, copy=False),
        )
        if self.gen == g0:
            self._coo = out
            self._coo_gen = g0
        return out


def _build_csr(keys: np.ndarray, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(keys, kind="stable").astype(np.int32)
    counts = np.bincount(keys, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, order


class ColumnarCatalog:
    """Versioned columnar snapshot of a storage.Engine.

    Everything is built lazily on first use and discarded wholesale on
    ``invalidate()``. Thread-safe for concurrent readers; builds are
    serialized under a lock.
    """

    def __init__(self, storage: Engine):
        self._storage = storage
        self._lock = threading.Lock()
        self._version = 0
        # Per-etype delta generations. `_version` stales on
        # EVERY write; background device jobs that only consume one
        # edge-type's slice key their snapshots on
        # ``(struct_gen, etype_gen[etype])`` instead, so a write to
        # etype A leaves etype B's device snapshot live. `_struct_gen`
        # moves on anything that changes the node axis or is not a pure
        # edge append (invalidate, node creates); `_etype_gen[et]`
        # moves only on edge appends of that type.
        self._struct_gen = 0
        self._etype_gen: Dict[str, int] = {}
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._nodes: Optional[List[Node]] = None
        self._node_pos: Optional[Dict[str, int]] = None
        self._label_rows: Dict[str, np.ndarray] = {}
        self._label_mask: Dict[str, np.ndarray] = {}
        self._node_prop_cols: Dict[str, np.ndarray] = {}
        self._prop_index: Dict[Tuple[str, str], Dict[Any, np.ndarray]] = {}
        self._edge_tables: Dict[str, EdgeTable] = {}
        self._all_edge_types: Optional[List[str]] = None
        self._filtered_deg: Dict[Tuple[str, str, Optional[str]], np.ndarray] = {}
        self._mid_axis: Dict[Tuple[str, str, Optional[str]], Any] = {}
        self._incidence: Dict[Tuple[str, str, Optional[str], Optional[str]], Any] = {}
        # materialized aggregate views (see module docstring)
        self._strip_views: Dict[Tuple, _StripView] = {}
        self._gram_views: Dict[Tuple, Optional[_GramView]] = {}
        # segment-sorted adjacency strips (per-friend top-k family);
        # a cached None records "order prop not numeric here"
        self._sorted_adj: Dict[Tuple, Optional[_SortedAdjacency]] = {}
        # (prop, id(cands)) -> (cands ref, verdict): is prop injective,
        # non-null and scalar over the candidate rows? The ref pins the
        # id; property writes invalidate() the whole catalog, and any
        # candidate-set change allocates a new array -> new id.
        self._injective: Dict[Tuple[str, int], Tuple[np.ndarray, bool]] = {}

    @property
    def version(self) -> int:
        return self._version

    def etype_version(self, etype: str) -> Tuple[int, int]:
        """Delta-snapshot key for one edge type: ``(struct_gen,
        etype_gen)``. Unchanged by writes to OTHER edge types, so a
        consumer keyed on this tuple survives unrelated edge appends
        (the whole-catalog :attr:`version` moves on every write)."""
        with self._lock:
            return (self._struct_gen, self._etype_gen.get(etype, 0))

    def etype_versions(self, etypes) -> Tuple[Tuple[int, int], ...]:
        """One consistent read of several etype keys (single lock
        acquisition — no torn tuple across a racing write)."""
        with self._lock:
            return tuple((self._struct_gen, self._etype_gen.get(et, 0))
                         for et in etypes)

    @property
    def storage(self) -> Engine:
        return self._storage

    # -- device-plane install hooks (query/device_graph.py) --------------
    #
    # The device graph plane builds the SAME materialized views the
    # host builds (verified-exact integer arrays) and installs them
    # here, so downstream reads and the incremental maintenance
    # machinery run unchanged regardless of which backend built them.

    def peek_strip_view(self, key: Tuple) -> Optional[_StripView]:
        with self._lock:
            return self._strip_views.get(key)

    def install_strip_view(self, key: Tuple, sv: _StripView,
                           v0: int) -> bool:
        """Install a view built at version ``v0``; refused when the
        catalog has moved (the build raced a write — installing would
        resurrect a stale snapshot)."""
        with self._lock:
            if self._version != v0:
                return False
            self._strip_views[key] = sv
            return True

    def invalidate(self) -> None:
        with self._lock:
            self._version += 1
            # updates/deletes are not attributable to one etype: every
            # per-etype delta key moves with the structural generation
            self._struct_gen += 1
            self._etype_gen.clear()
            self._reset_locked()

    # -- create deltas ----------------------------------------------------
    #
    # Pure creations extend the snapshot in place instead of discarding
    # it — the write-heavy compound shapes (MATCH…CREATE, reference
    # Northwind write bench) would otherwise rebuild O(N) structures on
    # every statement. Updates/deletes still invalidate wholesale.
    # Appends are O(existing) array copies: fine for the sizes where the
    # catalog wins; gigantic stores amortize via the usual lazy rebuild.

    def apply_node_created(self, node: Node) -> None:
        with self._lock:
            self._version += 1
            # the node axis grew: every etype's CSR indptr length moves,
            # so the structural generation (shared by all etype keys)
            # bumps rather than each per-etype generation
            self._struct_gen += 1
            # mid-axis/incidence candidate sets are label-dependent and
            # cheap to rebuild; the maintained views below extend instead
            self._mid_axis.clear()
            self._incidence.clear()
            if self._nodes is None:
                return  # nothing built yet; lazy build sees the node
            if node.id in self._node_pos:
                return  # lazy build raced the write and already has it
            # a brand-new node has no edges: degree/aggregate arrays gain
            # a zero slot (np.append = copy-on-write for live readers)
            for key, deg in list(self._filtered_deg.items()):
                self._filtered_deg[key] = np.append(deg, np.int64(0))
            for sv in self._strip_views.values():
                sv.deg = np.append(sv.deg, np.int64(0))
                sv.sum_deg = np.append(sv.sum_deg, np.int64(0))
                sv.nnz = np.append(sv.nnz, np.int64(0))
            # an edgeless new node extends each strip's indptr with a
            # repeat of the last offset (same treatment as cached CSRs)
            for sa in self._sorted_adj.values():
                if sa is not None:
                    sa.indptr = np.append(sa.indptr, sa.indptr[-1])
            for key, gv in list(self._gram_views.items()):
                if gv is None:
                    continue  # over budget; creates only grow the graph
                _etype, _orient, _mid_l, a_l, b_l = key
                if (a_l is None or b_l is None
                        or a_l in node.labels or b_l in node.labels):
                    # candidate axes grow: rebuild lazily. The rebuild
                    # allocates fresh candidate arrays, so drop the
                    # injectivity memo too — it's id-keyed and would
                    # otherwise pin the dead arrays forever
                    self._gram_views.pop(key)
                    self._injective.clear()
                else:
                    gv.a_pos = np.append(gv.a_pos, np.int64(-1))
                    gv.b_pos = np.append(gv.b_pos, np.int64(-1))
            i = len(self._nodes)
            self._nodes.append(node)
            self._node_pos[node.id] = i
            for lbl, rows in self._label_rows.items():
                if lbl in node.labels:
                    self._label_rows[lbl] = np.append(rows, np.int32(i))
            for lbl, mask in list(self._label_mask.items()):
                self._label_mask[lbl] = np.append(mask, lbl in node.labels)
            for name, col in list(self._node_prop_cols.items()):
                ext = np.empty(1, dtype=object)
                ext[0] = node.properties.get(name)
                self._node_prop_cols[name] = np.concatenate([col, ext])
            for (lbl, prop), idx in self._prop_index.items():
                if lbl in node.labels:
                    v = node.properties.get(prop)
                    if v is not None and not isinstance(v, (list, dict)):
                        rows = idx.get(v)
                        idx[v] = (np.append(rows, np.int32(i))
                                  if rows is not None
                                  else np.asarray([i], dtype=np.int32))
            # CSR indptr arrays are indexed by node row and sized
            # n_nodes+1: the new (edgeless) node extends each cached
            # indptr with a repeat of its last offset (copy-on-write)
            for tbl in self._edge_tables.values():
                if tbl._csr_out is not None:
                    indptr, order = tbl._csr_out
                    tbl._csr_out = (np.append(indptr, indptr[-1]), order)
                if tbl._csr_in is not None:
                    indptr, order = tbl._csr_in
                    tbl._csr_in = (np.append(indptr, indptr[-1]), order)

    def apply_edge_created(self, edge: Edge) -> None:
        with self._lock:
            self._version += 1
            et = edge.type
            # pure edge append: only THIS etype's delta generation moves
            self._etype_gen[et] = self._etype_gen.get(et, 0) + 1
            # per-etype drop of the (non-maintained) incidence caches
            for key in [k for k in self._mid_axis if k[0] == et]:
                self._mid_axis.pop(key)
            for key in [k for k in self._incidence if k[0] == et]:
                self._incidence.pop(key)
            # sorted strips rebuild lazily: a sorted-segment insert
            # would be O(E) in place, the rebuild is one lexsort on read
            for key in [k for k in self._sorted_adj if k[0] == et]:
                self._sorted_adj.pop(key)

            tbl = self._edge_tables.get(et)
            s = d = None
            if self._node_pos is not None:
                s = self._node_pos.get(edge.start_node)
                d = self._node_pos.get(edge.end_node)
            if s is None or d is None:
                # endpoints unseen by the snapshot: every structure
                # derived from this etype is unmaintainable — drop them
                self._edge_tables.pop(et, None)
                self._drop_etype_aggregates_locked(et)
            else:
                # Freshness gate: every maintained structure (degree
                # arrays, strip/gram views) is built FROM the edge table,
                # whose appends dedupe by edge id. A lazy build that
                # raced this write may already include the edge; in that
                # case incrementing again would double count. The table's
                # id set is the single source of truth.
                fresh = tbl is not None and edge.id not in tbl._edge_ids
                if tbl is None:
                    # no table ⇒ no table-derived caches can exist for
                    # this etype (builds force the table; pops drop them)
                    self._drop_etype_aggregates_locked(et)
                elif fresh:
                    # view updates FIRST: they read pre-increment degrees
                    # and the pre-append adjacency of the edge table
                    self._update_strip_views_locked(et, int(s), int(d))
                    self._update_gram_views_locked(et, int(s), int(d))
                    self._update_degrees_locked(et, int(s), int(d))
                if tbl is not None:
                    tbl.append_edge(int(s), int(d), edge)
            if (self._all_edge_types is not None
                    and et not in self._all_edge_types):
                self._all_edge_types.append(et)
                self._all_edge_types.sort()

    # -- incremental maintenance helpers (call with self._lock held) ------

    def _drop_etype_aggregates_locked(self, et: str) -> None:
        for key in [k for k in self._filtered_deg if k[0] == et]:
            self._filtered_deg.pop(key)
        for key in [k for k in self._sorted_adj if k[0] == et]:
            self._sorted_adj.pop(key)
        for key in [k for k in self._strip_views
                    if k[0] == et or k[3] == et]:
            self._strip_views.pop(key)
        for key in [k for k in self._gram_views if k[0] == et]:
            self._gram_views.pop(key)
            self._injective.clear()  # id-keyed on the views' cand arrays

    # a view update without a CSR falls back to one vectorized scan of
    # the etype1 table; past this size, dropping the view (lazy rebuild
    # on next read) is cheaper than scanning per create
    NEIGHBOR_SCAN_MAX_EDGES = 200_000

    def _update_degrees_locked(self, et: str, s: int, d: int) -> None:
        """In-place += on cached (etype, direction, label) degrees.
        Single aligned int64 stores can't tear for concurrent readers;
        cross-array consistency during a write is no weaker than the
        copy-on-write alternative (arrays swap independently either
        way) and this keeps per-create cost O(1) instead of O(n)."""
        for key in [k for k in self._filtered_deg if k[0] == et]:
            _et, kdir, klabel = key
            row, far = (s, d) if kdir == "out" else (d, s)
            if klabel is None or klabel in self._nodes[far].labels:
                self._filtered_deg[key][row] += 1

    def _table_neighbors_locked(
        self, tbl: EdgeTable, probe_side: str, row: int
    ) -> Optional[np.ndarray]:
        """Rows on the OTHER side of ``tbl`` edges whose ``probe_side``
        ('src'|'dst') endpoint is ``row`` — with multiplicity. Uses the
        cached CSR when built, else one vectorized scan of the table;
        None when the table is too big to scan per create (the caller
        drops its view)."""
        if probe_side == "src":
            csr, keys, other = tbl._csr_out, tbl.src, tbl.dst
        else:
            csr, keys, other = tbl._csr_in, tbl.dst, tbl.src
        if csr is not None:
            indptr, order = csr
            return other[order[indptr[row]:indptr[row + 1]]]
        if len(keys) > self.NEIGHBOR_SCAN_MAX_EDGES:
            return None
        return other[keys == row]

    def _update_strip_views_locked(self, et: str, s: int, d: int) -> None:
        for key in list(self._strip_views):
            etype1, g_side, p_label, etype2, dir2, f_label = key
            sv = self._strip_views[key]
            if et == etype1:
                g, p = (s, d) if g_side == "src" else (d, s)
                if p_label is not None and p_label not in self._nodes[p].labels:
                    continue
                dp = int(sv.deg[p])
                if dp == 0:
                    continue  # zero-degree p adds nothing to sum or nnz
                tbl1 = self._edge_tables.get(etype1)
                if tbl1 is None:
                    self._strip_views.pop(key)
                    continue
                # nnz counts DISTINCT p per g: a second parallel edge
                # (g, p) must not re-count p
                p_side = "dst" if g_side == "src" else "src"
                known_gs = self._table_neighbors_locked(tbl1, p_side, p)
                if known_gs is None:
                    self._strip_views.pop(key)  # too big to probe
                    continue
                sv.sum_deg[g] += dp
                if not (known_gs == g).any():
                    sv.nnz[g] += 1
            elif et == etype2:
                p, f = (s, d) if dir2 == "out" else (d, s)
                if f_label is not None and f_label not in self._nodes[f].labels:
                    continue
                old = int(sv.deg[p])
                sv.deg[p] += 1
                if p_label is not None and p_label not in self._nodes[p].labels:
                    continue
                tbl1 = self._edge_tables.get(etype1)
                if tbl1 is None:
                    self._strip_views.pop(key)
                    continue
                p_side = "dst" if g_side == "src" else "src"
                gs = self._table_neighbors_locked(tbl1, p_side, p)
                if gs is None:
                    self._strip_views.pop(key)  # too big to probe
                    continue
                if len(gs) == 0:
                    continue
                np.add.at(sv.sum_deg, gs, 1)
                if old == 0:
                    sv.nnz[np.unique(gs)] += 1

    def _update_gram_views_locked(self, et: str, s: int, d: int) -> None:
        for key in list(self._gram_views):
            etype, orientation, mid_label, _a_l, _b_l = key
            if et != etype:
                continue
            gv = self._gram_views[key]
            if gv is None:
                continue  # over budget; creates only grow the graph
            mid, far = (s, d) if orientation == "mid_src" else (d, s)
            if (mid_label is not None
                    and mid_label not in self._nodes[mid].labels):
                continue
            fa = int(gv.a_pos[far]) >= 0
            fb = int(gv.b_pos[far]) >= 0
            if not (fa or fb):
                continue
            lst = gv.far_lists.get(mid)
            if lst:
                gv.gen += 1  # invalidate coo() BEFORE the cells move
                C = gv.C  # in-place: single int64 cells can't tear
                for f2 in lst:
                    if fb:
                        ap = int(gv.a_pos[f2])
                        if ap >= 0:
                            C[ap, int(gv.b_pos[far])] += 1
                    if fa:
                        bp = int(gv.b_pos[f2])
                        if bp >= 0:
                            C[int(gv.a_pos[far]), bp] += 1
                gv.gen += 1
            if lst is None:
                gv.far_lists[mid] = [far]
            else:
                lst.append(far)

    def note_external_upsert(self, node: Node) -> bool:
        """Absorb an out-of-band node upsert without wholesale
        invalidation when possible. Three cases:

        - known node, query-visible content (labels, properties)
          unchanged — the embed queue's embedding write-backs — swap the
          snapshot's object in place;
        - unseen node (e.g. created by a statement still running, whose
          deltas apply at end-of-query) — append it as a create delta;
        - known node with changed content — return False, the caller
          must invalidate.

        Wholesale invalidation here would force a full snapshot rebuild
        per index probe while bulk ingest races the embed worker."""
        with self._lock:
            if self._nodes is None:
                return True  # nothing built; nothing can be stale
            i = self._node_pos.get(node.id) if self._node_pos else None
            if i is not None:
                cur = self._nodes[i]
                try:
                    same = (cur.labels == node.labels
                            and bool(cur.properties == node.properties))
                except (TypeError, ValueError):
                    same = False  # e.g. numpy-valued property __eq__
                if same:
                    # defensive copy: the listener hands us the writer's
                    # live object; the snapshot must own its nodes
                    self._nodes[i] = node.copy()
                    return True
                return False
            if len(self._nodes) >= self.EXTERNAL_APPEND_MAX_NODES:
                # appending extends every cached O(N) array; past this
                # size one wholesale invalidation + lazy rebuild is
                # cheaper than per-create array copies
                return False
        self.apply_node_created(node.copy())  # idempotent; own lock
        return True

    # -- node table -------------------------------------------------------

    def _ensure_nodes(self) -> List[Node]:
        if self._nodes is None:
            nodes = list(self._storage.all_nodes())
            pos = {n.id: i for i, n in enumerate(nodes)}
            self._nodes = nodes
            self._node_pos = pos
        return self._nodes

    def nodes(self) -> List[Node]:
        with self._lock:
            return self._ensure_nodes()

    def n_nodes(self) -> int:
        with self._lock:
            return len(self._ensure_nodes())

    def node_row(self, node_id: str) -> Optional[int]:
        with self._lock:
            self._ensure_nodes()
            return self._node_pos.get(node_id)

    def label_rows(self, label: str) -> np.ndarray:
        """Global row indices of nodes carrying ``label`` (int32, sorted)."""
        with self._lock:
            rows = self._label_rows.get(label)
            if rows is None:
                nodes = self._ensure_nodes()
                rows = np.asarray(
                    [i for i, n in enumerate(nodes) if label in n.labels],
                    dtype=np.int32,
                )
                self._label_rows[label] = rows
            return rows

    def label_mask(self, label: str) -> np.ndarray:
        """bool[n_nodes] membership mask for ``label``."""
        with self._lock:
            mask = self._label_mask.get(label)
            if mask is None:
                nodes = self._ensure_nodes()
                mask = np.zeros(len(nodes), dtype=bool)
                rows = self._label_rows.get(label)
                if rows is not None:
                    mask[rows] = True
                else:
                    for i, n in enumerate(nodes):
                        if label in n.labels:
                            mask[i] = True
                self._label_mask[label] = mask
            return mask

    def node_prop_col(self, name: str) -> np.ndarray:
        """Object array of node property ``name`` over ALL global rows."""
        with self._lock:
            col = self._node_prop_cols.get(name)
            if col is None:
                nodes = self._ensure_nodes()
                col = np.empty(len(nodes), dtype=object)
                for i, n in enumerate(nodes):
                    col[i] = n.properties.get(name)
                self._node_prop_cols[name] = col
            return col

    def prop_index(self, label: str, prop: str) -> Dict[Any, np.ndarray]:
        """Hash index value -> global rows, over nodes with ``label``.

        The reference reaches point lookups like LDBC "message content
        lookup" through indexed property access (storage_fastpaths.go);
        this is the columnar equivalent.
        """
        with self._lock:
            key = (label, prop)
            idx = self._prop_index.get(key)
            if idx is None:
                nodes = self._ensure_nodes()
                rows = self._label_rows.get(label)
                if rows is None:
                    rows = np.asarray(
                        [i for i, n in enumerate(nodes) if label in n.labels],
                        dtype=np.int32,
                    )
                    self._label_rows[label] = rows
                buckets: Dict[Any, List[int]] = {}
                for i in rows.tolist():
                    v = nodes[i].properties.get(prop)
                    if v is not None and not isinstance(v, (list, dict)):
                        buckets.setdefault(v, []).append(i)
                idx = {
                    v: np.asarray(lst, dtype=np.int32)
                    for v, lst in buckets.items()
                }
                self._prop_index[key] = idx
            return idx

    # -- edge tables ------------------------------------------------------

    def edge_table(self, etype: str) -> EdgeTable:
        with self._lock:
            tbl = self._edge_tables.get(etype)
            if tbl is None:
                self._ensure_nodes()
                pos = self._node_pos
                src: List[int] = []
                dst: List[int] = []
                edges: List[Edge] = []
                for e in self._storage.get_edges_by_type(etype):
                    s = pos.get(e.start_node)
                    d = pos.get(e.end_node)
                    if s is None or d is None:
                        continue  # dangling edge: invisible to matching
                    src.append(s)
                    dst.append(d)
                    edges.append(e)
                tbl = EdgeTable(
                    etype,
                    np.asarray(src, dtype=np.int32),
                    np.asarray(dst, dtype=np.int32),
                    edges,
                )
                self._edge_tables[etype] = tbl
            return tbl

    def filtered_degree(
        self, etype: str, direction: str, label: Optional[str]
    ) -> np.ndarray:
        """int64[n_nodes]: per-node count of ``etype`` edges in
        ``direction`` whose far end carries ``label`` (or any node when
        label is None).

        This is the degree store behind terminal-hop aggregation pushdown
        (reference: degree-based fast aggregations,
        pkg/cypher/traversal_fast_agg.go:15,57): count(f) over a hop that
        is otherwise unused equals a degree sum, so the join expansion
        can be skipped entirely. Cached per (etype, direction, label)
        until any mutation."""
        key = (etype, direction, label)
        with self._lock:
            deg = self._filtered_deg.get(key)
            if deg is not None:
                return deg
            v0 = self._version
        # build outside the (non-reentrant) lock: edge_table/label_mask
        # take it themselves; a racy double-build is harmless, but a
        # build that raced a mutation must not be stored (the mutation
        # already cleared the cache — storing would resurrect a stale
        # snapshot), hence the version check. Ordering matters: src/dst
        # are snapshotted under the lock (no torn pair), and the label
        # mask is fetched AFTER the snapshot — cached masks are extended
        # on node create, so a mask taken after the snapshot always
        # covers every row the snapshot references.
        tbl = self.edge_table(etype)
        with self._lock:
            if direction == "out":
                keys, far = tbl.src, tbl.dst
            else:
                keys, far = tbl.dst, tbl.src
        n = self.n_nodes()
        if label is not None:
            keys = keys[self.label_mask(label)[far]]
        deg = np.bincount(keys, minlength=n).astype(np.int64)
        with self._lock:
            if self._version == v0:
                self._filtered_deg[key] = deg
        return deg

    # dense-matrix budget for one cached incidence matrix (float32 cells;
    # 32 MB at the cap). Bigger label/edge combinations return None and
    # the query falls back to join expansion. Sized so LDBC-scale
    # co-occurrence (100k messages x 40 tags) stays comfortably inside —
    # the incidence matrix is a build-time input to the maintained Gram
    # view, so the cost is one-time, not per-query.
    INCIDENCE_MAX_CELLS = 8_000_000
    # above this snapshot size, external unseen-node upserts invalidate
    # wholesale instead of create-delta appending (each append copies
    # every cached O(N) array)
    EXTERNAL_APPEND_MAX_NODES = 20_000

    def incidence(
        self,
        etype: str,
        orientation: str,
        mid_label: Optional[str],
        far_label: Optional[str],
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Dense incidence matrix for co-occurrence matmuls.

        orientation 'mid_src': edges run middle -> far (middle is tbl.src);
        'mid_dst': far -> middle. Returns (M, far_cands, usable, far_pos):

        - M: float32[n_mid, n_far], M[mc, fc] = #edges between middle
          ``mc`` and far candidate ``fc`` (middle filtered by mid_label,
          far end by far_label)
        - far_cands: int32 global rows of far candidates (column order)
        - usable: bool[n_edges] — edge contributes to M
        - far_pos: int64[n_nodes] — global row -> column (or -1)

        The *middle axis* (row order) depends only on (etype, orientation,
        mid_label), so two incidence matrices with different far labels
        share rows and can be contracted against each other — the tag
        co-occurrence family is ``Ma.T @ Mb`` (BASELINE.md row 4; the
        reference hand-writes this family in optimized_executors.go).
        Cached until any mutation; returns None over the size budget."""
        key = (etype, orientation, mid_label, far_label)
        with self._lock:
            if key in self._incidence:
                return self._incidence[key]
            v0 = self._version
        # Ordering vs concurrent writers: snapshot src/dst under the lock
        # (no torn pair), derive every length from the snapshot itself,
        # and fetch masks/candidate rows AFTER the snapshot — those
        # caches are extended on node create, so post-snapshot fetches
        # always cover every row the snapshot references.
        tbl = self.edge_table(etype)
        with self._lock:
            if orientation == "mid_src":
                mid_e, far_e = tbl.src, tbl.dst
            else:
                mid_e, far_e = tbl.dst, tbl.src
        ne = len(mid_e)
        n = self.n_nodes()
        # shared middle axis; a cached axis is usable only if it was
        # built from a same-length (hence identical: appends-only +
        # wholesale invalidation) edge snapshot
        axis_key = (etype, orientation, mid_label)
        with self._lock:
            axis = self._mid_axis.get(axis_key)
        if axis is None or len(axis[2]) != ne:
            emask = (self.label_mask(mid_label)[mid_e]
                     if mid_label is not None
                     else np.ones(ne, dtype=bool))
            flags = np.zeros(n, dtype=bool)
            flags[mid_e[emask]] = True
            uniq_mid = np.nonzero(flags)[0]
            mid_lut = np.zeros(n, dtype=np.int64)
            mid_lut[uniq_mid] = np.arange(len(uniq_mid))
            axis = (uniq_mid, mid_lut, emask)
            with self._lock:
                if self._version == v0:
                    self._mid_axis[axis_key] = axis
        uniq_mid, mid_lut, emask = axis
        far_cands = (self.label_rows(far_label) if far_label is not None
                     else np.arange(n, dtype=np.int32))
        result = None
        if len(uniq_mid) * max(len(far_cands), 1) <= self.INCIDENCE_MAX_CELLS:
            far_pos = np.full(n, -1, dtype=np.int64)
            far_pos[far_cands] = np.arange(len(far_cands))
            usable = emask & (far_pos[far_e] >= 0)
            m = np.zeros((len(uniq_mid), len(far_cands)), dtype=np.float32)
            np.add.at(
                m, (mid_lut[mid_e[usable]], far_pos[far_e[usable]]), 1.0
            )
            result = (m, far_cands, usable, far_pos)
        with self._lock:
            if self._version == v0:
                self._incidence[key] = result
        return result

    def strip_view(
        self,
        etype1: str,
        g_side: str,
        p_label: Optional[str],
        etype2: str,
        dir2: str,
        f_label: Optional[str],
    ) -> Optional[_StripView]:
        """Materialized two-hop grouped degree aggregation (see
        _StripView). g_side is the group node's side of ETYPE1 edges
        ('src'|'dst'); dir2 is the terminal hop's direction from p.
        Returns None when a concurrent write tore the build (callers
        fall back to per-query chain expansion)."""
        if etype1 == etype2:
            # relationship uniqueness: the same edge could serve both
            # hops, which degree products cannot see — and the update
            # path's etype dispatch would silently stop maintaining deg.
            # Callers (fastpaths._analyze_strip) reject this shape.
            raise ValueError("strip_view requires distinct edge types")
        key = (etype1, g_side, p_label, etype2, dir2, f_label)
        with self._lock:
            sv = self._strip_views.get(key)
            if sv is not None:
                return sv
            v0 = self._version
        try:
            tbl = self.edge_table(etype1)
            with self._lock:
                g_e = tbl.src if g_side == "src" else tbl.dst
                p_e = tbl.dst if g_side == "src" else tbl.src
            # private copy: incremental updates must read pre-increment
            # values even if the shared degree array advances
            deg = self.filtered_degree(etype2, dir2, f_label).copy()
            n = len(deg)
            if p_label is not None:
                pmask = self.label_mask(p_label)[p_e]
                gm = g_e[pmask].astype(np.int64)
                pm = p_e[pmask].astype(np.int64)
            else:
                gm = g_e.astype(np.int64)
                pm = p_e.astype(np.int64)
            w = deg[pm]
            sum_deg = np.bincount(
                gm, weights=w.astype(np.float64), minlength=n
            ).astype(np.int64)
            act = w > 0
            pairs = np.unique(gm[act] * n + pm[act])  # DISTINCT (g, p)
            nnz = np.bincount(pairs // n, minlength=n).astype(np.int64)
        except (IndexError, ValueError):
            return None  # torn build under a concurrent write
        sv = _StripView(deg, sum_deg, nnz)
        with self._lock:
            if self._version == v0:
                self._strip_views[key] = sv
        return sv

    def sorted_adjacency(
        self,
        etype: str,
        group_side: str,
        order_prop: str,
        far_label: Optional[str],
    ) -> Optional[_SortedAdjacency]:
        """Materialized segment-sorted adjacency (see _SortedAdjacency).

        ``group_side`` is the NEAR node's side of ``etype`` edges
        ('src'|'dst'); segments hold the far rows (optionally filtered
        by ``far_label``) sorted by the far node's ``order_prop``
        descending, nulls first. Returns None — and caches the verdict —
        when any non-null value of the order prop is non-numeric (the
        general comparator lane must order those), or transiently when a
        concurrent write tore the build."""
        key = (etype, group_side, order_prop, far_label)
        with self._lock:
            if key in self._sorted_adj:
                return self._sorted_adj[key]
            v0 = self._version
        # snapshot src/dst under the lock (no torn pair); masks/prop
        # columns are fetched after and are extended on node create, so
        # they always cover every row the snapshot references
        tbl = self.edge_table(etype)
        with self._lock:
            grp = tbl.src if group_side == "src" else tbl.dst
            far = tbl.dst if group_side == "src" else tbl.src
        n = self.n_nodes()
        result: Optional[_SortedAdjacency] = None
        try:
            if far_label is not None:
                fmask = self.label_mask(far_label)[far]
                grp = grp[fmask]
                far = far[fmask]
            vals = self.node_prop_col(order_prop)[far]
            # one C-pass conversion (the _as_float recipe): astype maps
            # None -> nan and raises on strings; the type scan rejects
            # bools (Cypher orders them as a TYPE, not numerically) and
            # the nan audit distinguishes nulls (-> +inf, Cypher DESC
            # null-first) from genuine float('nan') values
            numeric = True
            keys = None
            try:
                keys = vals.astype(np.float64)
            except (TypeError, ValueError):
                numeric = False
            if numeric:
                types = set(map(type, vals.tolist()))
                if bool in types or np.bool_ in types:
                    numeric = False
                elif type(None) in types:
                    nanpos = np.isnan(keys)
                    if nanpos.any():
                        tl = vals.tolist()
                        for i in np.flatnonzero(nanpos).tolist():
                            if tl[i] is None:
                                keys[i] = np.inf
            if numeric:
                # stable grouped desc sort: group is the primary key,
                # negated value secondary; equal keys keep edge-table
                # order — exactly the general path's tie order
                perm = np.lexsort((-keys, grp))
                counts = np.bincount(grp, minlength=n)
                indptr = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(counts, out=indptr[1:])
                result = _SortedAdjacency(
                    indptr,
                    far[perm].astype(np.int32, copy=False),
                    keys[perm],
                )
        except (IndexError, ValueError):
            return None  # torn build under a concurrent write
        with self._lock:
            if self._version == v0:
                self._sorted_adj[key] = result
        return result

    def cooc_gram(
        self,
        etype: str,
        orientation: str,
        mid_label: Optional[str],
        a_label: Optional[str],
        b_label: Optional[str],
        device_plane=None,
    ) -> Optional[_GramView]:
        """Materialized co-occurrence Gram matrix (see _GramView).
        Returns None when the incidence matrices are over the dense
        budget (cached: the verdict can only flip via invalidate()) or
        when a concurrent write tore the build. With ``device_plane``
        the exact-range contraction runs on device (query/device_graph
        — f32 0/1-integer matmuls are exact below 2^24 on both
        backends, so the integers are equal either way)."""
        key = (etype, orientation, mid_label, a_label, b_label)
        with self._lock:
            if key in self._gram_views:
                return self._gram_views[key]
            v0 = self._version
        inc_a = self.incidence(etype, orientation, mid_label, a_label)
        inc_b = (inc_a if b_label == a_label
                 else self.incidence(etype, orientation, mid_label, b_label))
        result = None
        if inc_a is not None and inc_b is not None:
            ma, a_c, ea, a_pos = inc_a
            mb, b_c, eb, b_pos = inc_b
            if ma.shape[0] != mb.shape[0] or len(ea) != len(eb):
                return None  # mismatched snapshots (raced a write)
            # float32 loses integer exactness past 2^24; cheap upper
            # bound on any per-pair count is n_mid * max(ma) * max(mb)
            if ma.size and mb.size and (
                float(ma.shape[0]) * float(ma.max()) * float(mb.max())
                >= 2.0 ** 24
            ):
                c = ma.astype(np.float64).T @ mb.astype(np.float64)
            else:
                c = None
                if device_plane is not None:
                    c_dev = device_plane.gram_matmul(ma, mb)
                    if c_dev is not None:
                        c = c_dev.astype(np.float64)
                if c is None:
                    c = (ma.T @ mb).astype(np.float64)
            tbl = self.edge_table(etype)
            with self._lock:
                if orientation == "mid_src":
                    mid_e, far_e = tbl.src, tbl.dst
                else:
                    mid_e, far_e = tbl.dst, tbl.src
            if len(far_e) != len(ea):
                return None  # edge table raced a write
            # relationship uniqueness: a match may not use one edge for
            # both hops; such pairs land at (far, far) of each
            # doubly-usable edge
            both = ea & eb
            if both.any():
                flat = a_pos[far_e[both]] * c.shape[1] + b_pos[far_e[both]]
                c -= np.bincount(flat, minlength=c.size).reshape(c.shape)
            try:
                usable = (a_pos[far_e] >= 0) | (b_pos[far_e] >= 0)
                if mid_label is not None:
                    usable &= self.label_mask(mid_label)[mid_e]
                far_lists: Dict[int, List[int]] = {}
                for m_row, f_row in zip(
                    mid_e[usable].tolist(), far_e[usable].tolist()
                ):
                    far_lists.setdefault(m_row, []).append(f_row)
            except (IndexError, ValueError):
                return None
            result = _GramView(
                np.rint(c).astype(np.int64), a_c, b_c, a_pos, b_pos,
                far_lists,
            )
        with self._lock:
            if self._version == v0:
                self._gram_views[key] = result
        return result

    def prop_injective_over(self, prop: str, cands: np.ndarray) -> bool:
        """True when ``prop`` is non-null, scalar and pairwise-distinct
        over candidate rows ``cands`` — the check that lets aggregation
        treat co-occurrence rows as ready-made groups. Memoized per
        candidate array (identity-keyed; see ``_injective``)."""
        key = (prop, id(cands))
        with self._lock:
            hit = self._injective.get(key)
        if hit is not None and hit[0] is cands:
            return hit[1]
        vals = self.node_prop_col(prop)[cands].tolist()
        seen = set()
        verdict = True
        for v in vals:
            if v is None or isinstance(v, (list, dict)) or v in seen:
                verdict = False
                break
            seen.add(v)
        with self._lock:
            self._injective[key] = (cands, verdict)
        return verdict

    def edge_types(self) -> List[str]:
        with self._lock:
            if self._all_edge_types is None:
                types = set()
                for e in self._storage.all_edges():
                    types.add(e.type)
                self._all_edge_types = sorted(types)
            return self._all_edge_types


def expand_hop(
    table: EdgeTable,
    frontier: np.ndarray,
    direction: str,
    n_nodes: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand one relationship hop for every row of ``frontier``.

    frontier: int array of global node rows (the current binding column).
    direction: 'out' (frontier is edge source) or 'in' (frontier is edge
    target). Returns (row_repeat, edge_rows, targets):

    - row_repeat: for each produced match, the index into ``frontier`` it
      came from (so sibling binding columns can be np.take'd).
    - edge_rows: the edge-table row of the traversed edge.
    - targets: the global node row reached.

    Fully vectorized (no per-row Python loop): the classic
    repeat/cumsum-offset trick over CSR ranges.
    """
    indptr, order = table.csr(direction, n_nodes)
    starts = indptr[frontier]
    counts = indptr[frontier + 1] - starts
    total = int(counts.sum())
    if total == 0:
        empty = np.empty(0, dtype=np.int32)
        return empty, empty, empty
    row_repeat = np.repeat(
        np.arange(len(frontier), dtype=np.int32), counts
    )
    grp_start = np.repeat(starts, counts)
    grp_off = np.repeat(np.cumsum(counts) - counts, counts)
    within = np.arange(total, dtype=np.int64) - grp_off
    edge_rows = order[grp_start + within]
    if direction == "out":
        targets = table.dst[edge_rows]
    else:
        targets = table.src[edge_rows]
    return row_repeat, edge_rows.astype(np.int32), targets


def group_codes(cols: List[np.ndarray]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Encode rows of ``cols`` (parallel arrays) into dense group codes.

    Returns (codes[int64 per row], uniques-per-col) where equal rows get
    equal codes in [0, n_groups). Mixed-type object columns are handled
    by per-column np.unique on a sort-stable key.
    """
    if not cols:
        return np.zeros(0, dtype=np.int64), []
    inv_total = np.zeros(len(cols[0]), dtype=np.int64)
    uniques: List[np.ndarray] = []
    for col in cols:
        uniq, inv = _unique_inverse(col)
        uniques.append(uniq)
        inv_total = inv_total * max(len(uniq), 1) + inv
    # re-densify combined codes
    _, codes = np.unique(inv_total, return_inverse=True)
    return codes, uniques


def _unique_inverse(col: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if col.dtype != object:
        return np.unique(col, return_inverse=True)
    # object column: hash via Python dict (stable, handles mixed types)
    table: Dict[Any, int] = {}
    inv = np.empty(len(col), dtype=np.int64)
    uniq: List[Any] = []
    for i, v in enumerate(col.tolist()):
        key = (type(v).__name__, v) if not isinstance(v, (list, dict)) else (
            "repr", repr(v)
        )
        j = table.get(key)
        if j is None:
            j = len(uniq)
            table[key] = j
            uniq.append(v)
        inv[i] = j
    u = np.empty(len(uniq), dtype=object)
    for i, v in enumerate(uniq):
        u[i] = v
    return u, inv
