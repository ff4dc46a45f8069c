"""Device-resident columnar graph plane (counterpart of
``nornicdb_tpu/query/device_graph.py``): the LDBC Cypher fast-path shapes
as PyTorch programs over device snapshots of one ``ColumnarCatalog``.

- **chain top-k** (``recent_messages_friends``): anchors -> CSR friend
  gather -> per-friend strip heads -> one top-k merge, B anchors per
  dispatch. Concurrent point lookups coalesce through a ``BatchCoalescer``
  into one dispatch. The merge key is a dense tie-sharing rank of the
  order key times the candidate width plus the candidate's position, so
  valid keys are distinct and the device answer is the host's stable
  ``argsort`` row for row (the float64 order keys never leave the host).
- **strip aggregation** (``avg_friends_per_city``): the materialized
  two-hop grouped-degree view (deg / sum_deg / nnz) as device segment sums
  and a sort of distinct (g, p) pairs, installed into the catalog, whose
  reads and incremental maintenance then run unchanged. Integer counts
  and float32 sums of integers below 2^24 are exact in any order, so the
  arrays are the host build's bit for bit.
- **co-occurrence Gram** (``tag_cooccurrence``): ``Ma^T @ Mb`` as a
  device matmul (TF32 off) under the 2^24 exactness bound the caller
  holds.
- **fused traverse-then-rank**: chain expansion, frontier dedup, a gather
  of the vector index's device rows, cosine scores and a top-k whose ties
  go to the lower row (``ops/similarity.py:order_keys``), in one dispatch
  (``DB.graph_vector_search``).
- **PageRank / degree counts**: a whole-graph edge snapshot cached per
  catalog version with its device copy (``ops/graph.py``).

Freshness: every snapshot is keyed on the catalog's per-edge-type
generations (``etype_versions``) or its ``version``; a write stales it,
the next read is served by the host path while the snapshot rebuilds, and
a write that lands during a dispatch is caught by a recheck after the
result reached the host.

Routing: ``NORNICDB_GRAPH_DEVICE`` = ``off`` | ``auto`` (default) | ``on``.
``auto`` keeps catalogs below ``NORNICDB_GRAPH_DEVICE_MIN_N`` structure
entries on the host, dispatches chain lookups only when at least
``NORNICDB_GRAPH_DEVICE_MIN_B`` concurrent riders coalesce, and engages
only when the plane's device is CUDA. The device is resolved at the first
read that passes these gates (``device=None`` means CUDA and raises
without a card), so an executor that never routes to the device never
resolves one. ``on`` dispatches every read.

Unlike the reference, the plane fails closed (ROADMAP C28): an error in a
dispatch propagates to the caller, and through the coalescer to every
rider of its batch. Only the reference's named gaps step down to the host
path, each counted in ``counts``: ``degrade_off``, ``batch_below_min_b``,
``degrade_stale``, ``degrade_rank_overflow``, ``degrade_exactness``,
``snapshot_raced``, ``degrade_torn`` (a catalog read torn by a concurrent
write) and ``degrade_no_iteration`` (an engine that cannot list its
records). The reference's metrics registry, audit ledger, cost records and
dispatch accounting are not ported (ROADMAP §A12).
"""

from __future__ import annotations

import functools
import os
import threading
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.similarity import keys_topk, order_keys, unpack_keys
from nornicdb_tpu_torch.search.microbatch import BatchCoalescer, pow2_bucket

_I32_MAX = 2 ** 31 - 1
_EXACT_F32 = float(2 ** 24)  # integer-exactness bound for f32 sums


def graph_device_mode() -> str:
    mode = os.environ.get("NORNICDB_GRAPH_DEVICE", "auto").lower()
    return mode if mode in ("off", "auto", "on") else "auto"


def graph_device_min_n() -> int:
    try:
        return int(os.environ.get("NORNICDB_GRAPH_DEVICE_MIN_N", "200000"))
    except ValueError:
        return 200_000


def graph_device_min_b() -> int:
    try:
        return int(os.environ.get("NORNICDB_GRAPH_DEVICE_MIN_B", "4"))
    except ValueError:
        return 4


# -- the programs --------------------------------------------------------------
#
# Each takes the reference's power-of-two buckets (f, kp, npad, ...) as
# plain ints: the guards read them, so routing is the reference's, and the
# padded rows never reach an answer.


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` along the first axis for an index of any shape, as one
    ``index_select`` (PyTorch's CPU advanced indexing is far slower on
    large indices)."""
    out = torch.index_select(src, 0, idx.reshape(-1).long())
    return out.reshape(tuple(idx.shape) + tuple(src.shape[1:]))


def _chain_topk(anchors, kh, indptr1, far1, s_indptr, s_nbr, s_rank, mid_ok, f, kp):
    """Per anchor [B] (-1 pads): its friends over the CSR (``indptr1``,
    ``far1``) that pass ``mid_ok``, each friend's first ``kh`` strip
    entries, and the ``kp`` best of them all by (rank, candidate order).
    Returns (friend rows [B, kp], terminal rows [B, kp], valid [B, kp])."""
    dev = anchors.device
    b = anchors.shape[0]
    a = torch.clamp_min(anchors, 0).long()
    a_valid = anchors >= 0
    start = _take(indptr1, a).long()
    cnt = _take(indptr1, a + 1).long() - start
    fi = torch.arange(f, device=dev)
    fpos = start[:, None] + fi[None, :]
    fvalid = (fi[None, :] < cnt[:, None]) & a_valid[:, None]
    friends = _take(far1, torch.clamp(fpos, 0, max(far1.shape[0] - 1, 0))).long()
    fvalid = fvalid & _take(mid_ok, friends)
    sstart = _take(s_indptr, friends).long()
    scnt = torch.clamp_max(_take(s_indptr, friends + 1).long() - sstart, kh)
    ci = torch.arange(kp, device=dev)
    cpos = sstart[..., None] + ci[None, None, :]
    cvalid = (ci[None, None, :] < scnt[..., None]) & fvalid[..., None]
    cpos_c = torch.clamp(cpos, 0, max(s_nbr.shape[0] - 1, 0))
    width = f * kp
    rank = _take(s_rank, cpos_c).reshape(b, width).long()
    order_idx = torch.arange(width, device=dev)
    # dense tie-sharing key rank (ascending == key DESC), then candidate
    # order (friend-major, head-position minor): the host's stable order
    combined = torch.where(cvalid.reshape(b, width), rank * width + order_idx[None, :],
                           _I32_MAX)
    vals, sel = torch.topk(combined, kp, dim=1, largest=False, sorted=True)
    sel_valid = vals < _I32_MAX
    sel_f = torch.gather(friends, 1, torch.div(sel, kp, rounding_mode="floor"))
    sel_t = torch.gather(_take(s_nbr, cpos_c).reshape(b, width), 1, sel)
    return sel_f, sel_t, sel_valid


def _strip_agg(g_e, p_e, pmask_e, keys2, fmask2, npad):
    """deg (int32 segment sum over the terminal hop), sum_deg (float32
    weighted group sums), nnz (distinct (g, p) with deg[p] > 0 per g), and
    the maxima of deg and sum_deg, all [npad]."""
    dev = g_e.device
    deg = torch.zeros(npad, dtype=torch.int32, device=dev).index_add_(
        0, keys2.long(), fmask2.to(torch.int32))
    deg_p = _take(deg, p_e)
    w = torch.where(pmask_e, deg_p.to(torch.float32), 0.0)
    sum_deg = torch.zeros(npad, dtype=torch.float32, device=dev).index_add_(0, g_e.long(), w)
    valid = pmask_e & (deg_p > 0)
    g_s = torch.where(valid, g_e.long(), npad - 1)
    p_s = torch.where(valid, p_e.long(), npad - 1)
    # lexicographic (g, p) as one int64 key: g * npad + p never overflows
    key = torch.sort(g_s * npad + p_s).values
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev), key[:-1]])
    g_sorted = torch.div(key, npad, rounding_mode="floor")
    first = (key != prev) & (g_sorted < npad - 1)
    nnz = torch.zeros(npad, dtype=torch.int32, device=dev).index_add_(
        0, g_sorted, first.to(torch.int32))
    return deg, sum_deg, nnz, deg.max(), sum_deg.max()


def _gram(ma, mb):
    """0/1-integer float32 contraction: exact below 2^24 (caller-guarded)."""
    return ma.T @ mb


def _traverse_rank(anchors, q, indptr1, far1, indptr2, far2, slot_of_row, matrix, valid,
                   n_nodes, f1, f2, kp):
    """Per anchor: the 1- or 2-hop frontier (f2 == 0: one hop), deduped
    by a sort with the sentinel ``n_nodes``, joined to index slots, scored
    by cosine against the normalised query, and its ``kp`` best (ties to
    the lower row). Returns (scores [B, kp], rows [B, kp]); -inf marks no
    hit."""
    dev = anchors.device
    b = anchors.shape[0]
    a = torch.clamp_min(anchors, 0).long()
    a_valid = anchors >= 0
    start = _take(indptr1, a).long()
    cnt = _take(indptr1, a + 1).long() - start
    fi = torch.arange(f1, device=dev)
    fpos = start[:, None] + fi[None, :]
    fvalid = (fi[None, :] < cnt[:, None]) & a_valid[:, None]
    rows = _take(far1, torch.clamp(fpos, 0, far1.shape[0] - 1)).long()
    if f2 > 0:
        s2 = _take(indptr2, rows).long()
        c2 = _take(indptr2, rows + 1).long() - s2
        gi = torch.arange(f2, device=dev)
        gpos = s2[..., None] + gi[None, None, :]
        gvalid = (gi[None, None, :] < c2[..., None]) & fvalid[..., None]
        rows = _take(far2, torch.clamp(gpos, 0, far2.shape[0] - 1)).long().reshape(b, f1 * f2)
        rvalid = gvalid.reshape(b, f1 * f2)
    else:
        rvalid = fvalid
    rows_s = torch.sort(torch.where(rvalid, rows, n_nodes), dim=1).values
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.int64, device=dev),
                      rows_s[:, :-1]], dim=1)
    keep = (rows_s != prev) & (rows_s < n_nodes)
    slots = _take(slot_of_row, torch.clamp(rows_s, 0, slot_of_row.shape[0] - 1)).long()
    ok = keep & (slots >= 0)
    slots_c = torch.clamp_min(slots, 0)
    ok = ok & _take(valid, slots_c)
    vecs = _take(matrix, slots_c)  # [B, F, D] frontier gather
    qn = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-12)
    scores = torch.einsum("bd,bfd->bf", qn, vecs)
    scores = torch.where(ok, scores, float("-inf"))
    vals, idx = unpack_keys(keys_topk(order_keys(scores), kp))
    return vals, torch.gather(rows_s, 1, idx)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# -- the plane ---------------------------------------------------------------


class DeviceGraphPlane:
    """Versioned device snapshots of one ``ColumnarCatalog`` and the
    programs over them. One per executor. Every public read returns None
    to mean "serve on the host path"."""

    # refuse device arrays past this many entries per structure (int32
    # indices everywhere)
    MAX_ENTRIES = _I32_MAX - 2

    def __init__(self, catalog, device: DeviceLike = None):
        self.catalog = catalog
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self._lock = threading.Lock()
        self._snaps: Dict[Any, Dict[str, Any]] = {}
        self._batchers: Dict[Any, BatchCoalescer] = {}
        # auto mode's demand signal: chain reads in flight, under its own
        # lock (a lost decrement would pin the gate)
        self.inflight = 0
        self._inflight_lock = threading.Lock()
        self.dispatches = 0
        self.counts: Counter = Counter()
        self._counts_lock = threading.Lock()
        # the forced-mode flag of the per-query pre-gate, re-read from the
        # environment every 256 calls; a stale value only costs one
        # coalescer submit (the leader reads the mode again)
        self._forced: Optional[bool] = None
        self._gate_tick = 0

    @property
    def device(self) -> torch.device:
        """The plane's device, resolved at first use."""
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    def _on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _event(self, name: str) -> None:
        with self._counts_lock:
            self.counts[name] += 1

    def _dispatched(self) -> None:
        with self._counts_lock:  # leaders of different batches run at once
            self.dispatches += 1

    def _int32(self, arr) -> torch.Tensor:
        return torch.tensor(np.asarray(arr), dtype=torch.int32, device=self.device)

    # -- snapshot bookkeeping ---------------------------------------------

    def _get_snap(self, key) -> Optional[Dict[str, Any]]:
        """A live snapshot: one keyed on edge types stays live across
        writes to other edge types; a whole-catalog one compares the
        catalog's version."""
        with self._lock:
            snap = self._snaps.get(key)
        if snap is None:
            return None
        etypes = snap.get("etypes")
        if etypes is not None:
            if snap.get("etv") == self.catalog.etype_versions(etypes):
                return snap
            return None
        if snap.get("version") == self.catalog.version:
            return snap
        return None

    def _put_snap(self, key, snap: Dict[str, Any]) -> bool:
        """Install ``snap`` unless the catalog moved past it during the
        build (a raced build must not resurrect a stale snapshot)."""
        etypes = snap.get("etypes")
        if etypes is not None:
            fresh = self.catalog.etype_versions(etypes) == snap.get("etv")
        else:
            fresh = self.catalog.version == snap.get("version")
        if not fresh:
            self._event("snapshot_raced")
            return False
        with self._lock:
            self._snaps[key] = snap
        self._event("snapshot_built")
        return True

    def drop_snapshots(self) -> None:
        with self._lock:
            self._snaps.clear()

    def resource_stats(self) -> Dict[str, float]:
        """Device and host bytes of the snapshots, their rows, and how many
        catalog versions the newest lags."""
        v = self.catalog.version
        dev = host = rows = 0
        newest = None
        with self._lock:
            snaps = list(self._snaps.values())
        for snap in snaps:
            dev += int(snap.get("device_bytes", 0))
            host += int(snap.get("host_bytes", 0))
            rows += int(snap.get("rows", 0))
            sv = snap.get("version")
            if sv is not None and (newest is None or sv > newest):
                newest = sv
        return {
            "device_bytes": dev,
            "host_bytes": host,
            "rows": rows,
            "mutation_gap": 0 if newest is None else max(0, v - newest),
        }

    # -- chain top-k (recent_messages_friends family) ---------------------

    def _chain_snapshot(self, spec: Tuple) -> Optional[Dict[str, Any]]:
        key = ("chain",) + spec
        snap = self._get_snap(key)
        if snap is not None:
            return snap if snap.get("ok") else None
        (etype1, dir1, mid_label, etype2, mid_side, order_prop,
         term_label) = spec
        cat = self.catalog
        v0 = cat.version
        # the program reads these two etypes' CSRs and node-axis arrays,
        # whose changes move the structural generation in the tuple
        etypes = (etype1, etype2)
        etv0 = cat.etype_versions(etypes)
        try:
            sa = cat.sorted_adjacency(etype2, mid_side, order_prop, term_label)
            n = cat.n_nodes()
            tbl1 = cat.edge_table(etype1)
            indptr1, order1 = tbl1.csr(dir1, n)
            far_raw = tbl1.dst if dir1 == "out" else tbl1.src
            if sa is None or len(order1) != len(far_raw):
                # non-numeric order prop / torn build: remember the
                # verdict until a write
                self._put_snap(key, {"version": v0, "etypes": etypes,
                                     "etv": etv0, "ok": False})
                return None
            if (len(sa.nbr) > self.MAX_ENTRIES
                    or len(far_raw) > self.MAX_ENTRIES
                    or len(sa.nbr) == 0 or len(far_raw) == 0
                    or np.isnan(sa.keys).any()):
                # empty structures answer trivially on the host path
                self._put_snap(key, {"version": v0, "etypes": etypes,
                                     "etv": etv0, "ok": False})
                return None
            far1 = far_raw[order1]
            # dense DESC rank with ties sharing a rank: the merge key must
            # order exactly like -keys under a stable argsort
            uniq = np.unique(sa.keys)
            rank = (len(uniq) - 1) - np.searchsorted(uniq, sa.keys)
            if mid_label is not None:
                mid_ok = cat.label_mask(mid_label)
            else:
                mid_ok = np.ones(n, dtype=bool)
            if len(mid_ok) < n or len(indptr1) != n + 1 \
                    or len(sa.indptr) != n + 1:
                self._event("degrade_torn")
                return None  # raced a node create; the next read rebuilds
            arrays = {
                "indptr1": self._int32(indptr1),
                "far1": self._int32(far1),
                "s_indptr": self._int32(sa.indptr),
                "s_nbr": self._int32(sa.nbr),
                "s_rank": self._int32(rank),
                "mid_ok": torch.tensor(np.asarray(mid_ok[:n]), dtype=torch.bool,
                                       device=self.device),
            }
            snap = {
                "version": v0,
                "etypes": etypes,
                "etv": etv0,
                "ok": True,
                "n": n,
                "s": len(sa.nbr),
                "max_deg": int((indptr1[1:] - indptr1[:-1]).max()) if n else 0,
                **arrays,
                "device_bytes": _nbytes(*arrays.values()),
                "host_bytes": rank.nbytes,
                "rows": len(sa.nbr) + len(far1),
            }
        except (IndexError, ValueError):
            self._event("degrade_torn")
            return None  # torn under a concurrent write: host path
        if not self._put_snap(key, snap):
            return None
        return snap

    def chain_enter(self) -> None:
        with self._inflight_lock:
            self.inflight += 1

    def chain_exit(self) -> None:
        with self._inflight_lock:
            self.inflight -= 1

    def maybe_device(self) -> bool:
        """Allocation-free pre-gate of the per-query path: False when the
        device route cannot engage (not forced on, and no other chain read
        in flight). The environment is read once every 256 calls."""
        if self.inflight > 1:
            return True  # demand exists; the batcher decides the rest
        tick = self._gate_tick = (self._gate_tick + 1) & 0xFF
        if tick == 0 or self._forced is None:
            self._forced = os.environ.get("NORNICDB_GRAPH_DEVICE", "auto") == "on"
        return self._forced

    def chain_topk(
        self,
        spec: Tuple,
        anchor: int,
        k_head: int,
        size_hint: int,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The device merge for one anchor of the per-friend top-k family:
        (friend rows, terminal rows), globally ordered and cut to at most
        ``k_head``, or None for the host path. Concurrent calls sharing
        ``spec`` coalesce into one dispatch."""
        mode = graph_device_mode()
        if mode == "off":
            self._event("degrade_off")
            return None
        if k_head <= 0:
            return None
        if mode == "auto":
            if size_hint < graph_device_min_n():
                return None
            # demand gate: a single-stream read never pays a B = 1 dispatch
            if self.inflight <= 1 or not self._on_cuda():
                return None
        return self._chain_batcher(spec).submit((int(anchor), int(k_head)))

    def _chain_batcher(self, spec: Tuple) -> BatchCoalescer:
        key = ("chainb",) + spec
        with self._lock:
            b = self._batchers.get(key)
            if b is None:
                b = BatchCoalescer(functools.partial(self._chain_batch, spec), max_batch=64,
                                   surface="service:graph")
                self._batchers[key] = b
            return b

    def _chain_batch(self, spec: Tuple, items: List[Tuple[int, int]]):
        mode = graph_device_mode()
        none_all = [None] * len(items)
        if mode == "off":
            self._event("degrade_off")
            return none_all
        if mode == "auto" and len(items) < graph_device_min_b():
            self._event("batch_below_min_b")
            return none_all
        snap = self._chain_snapshot(spec)
        if snap is None:
            self._event("degrade_stale")
            return none_all
        kh = max(k for _a, k in items)
        kp = pow2_bucket(kh)
        # frontier bucket: the snapshot's max degree, so batch composition
        # cannot change it
        f = pow2_bucket(max(1, snap["max_deg"]))
        width = f * kp
        # the reference's int32 key guard, kept so routing is the same
        if snap["s"] * width >= _I32_MAX or width > 1 << 20:
            self._event("degrade_rank_overflow")
            return none_all
        bsz = pow2_bucket(len(items))
        anchors = np.full(bsz, -1, dtype=np.int32)
        for i, (a, _k) in enumerate(items):
            anchors[i] = a
        sel_f, sel_t, sel_valid = _chain_topk(
            self._int32(anchors), kh, snap["indptr1"], snap["far1"], snap["s_indptr"],
            snap["s_nbr"], snap["s_rank"], snap["mid_ok"], f, kp)
        # to the host before the freshness recheck
        sel_f = sel_f.cpu().numpy().astype(np.int32)
        sel_t = sel_t.cpu().numpy().astype(np.int32)
        sel_valid = sel_valid.cpu().numpy()
        self._dispatched()
        # a write to this program's etypes (or the node axis) during the
        # dispatch: the host path serves
        if self.catalog.etype_versions(snap["etypes"]) != snap["etv"]:
            self._event("degrade_stale")
            return none_all
        out = []
        for i, (_a, k) in enumerate(items):
            take = min(k, int(sel_valid[i].sum()))
            out.append((sel_f[i, :take].copy(), sel_t[i, :take].copy()))
        return out

    # -- strip aggregation (avg_friends_per_city family) ------------------

    def build_strip_view(
        self,
        etype1: str,
        g_side: str,
        p_label: Optional[str],
        etype2: str,
        dir2: str,
        f_label: Optional[str],
    ):
        """The device-built strip view, installed into the catalog, or
        None (the host builds it). The three arrays are integer counts,
        checked against the 2^24 bound after the dispatch, so they equal
        the host build's."""
        mode = graph_device_mode()
        if mode == "off":
            self._event("degrade_off")
            return None
        if etype1 == etype2:
            return None
        cat = self.catalog
        key = (etype1, g_side, p_label, etype2, dir2, f_label)
        sv = cat.peek_strip_view(key)
        if sv is not None:
            return sv
        v0 = cat.version
        try:
            tbl1 = cat.edge_table(etype1)
            tbl2 = cat.edge_table(etype2)
            n = cat.n_nodes()
            e1, e2 = len(tbl1.src), len(tbl2.src)
            if mode == "auto" and ((e1 + e2) < graph_device_min_n() or not self._on_cuda()):
                return None
            if max(e1, e2, n) > self.MAX_ENTRIES or min(e1, e2) == 0:
                return None
            if e1 >= _EXACT_F32 or e2 >= _EXACT_F32:
                self._event("degrade_exactness")
                return None
            g_e = tbl1.src if g_side == "src" else tbl1.dst
            p_e = tbl1.dst if g_side == "src" else tbl1.src
            keys2 = tbl2.src if dir2 == "out" else tbl2.dst
            far2 = tbl2.dst if dir2 == "out" else tbl2.src
            pmask_e = (cat.label_mask(p_label)[p_e] if p_label is not None
                       else np.ones(e1, dtype=bool))
            fmask2 = (cat.label_mask(f_label)[far2] if f_label is not None
                      else np.ones(e2, dtype=bool))
        except (IndexError, ValueError):
            self._event("degrade_torn")
            return None
        e1p, e2p, npad = pow2_bucket(e1), pow2_bucket(e2), pow2_bucket(n + 2)
        # pads: sentinel rows land on npad - 1 (sliced away below)
        g_pad = np.full(e1p, npad - 1, np.int32)
        g_pad[:e1] = g_e
        p_pad = np.full(e1p, npad - 1, np.int32)
        p_pad[:e1] = p_e
        pm_pad = np.zeros(e1p, bool)
        pm_pad[:e1] = pmask_e
        k2_pad = np.full(e2p, npad - 1, np.int32)
        k2_pad[:e2] = keys2
        fm_pad = np.zeros(e2p, bool)
        fm_pad[:e2] = fmask2
        dev = self.device
        deg_d, sum_d, nnz_d, deg_max, sum_max = _strip_agg(
            torch.from_numpy(g_pad).to(dev), torch.from_numpy(p_pad).to(dev),
            torch.from_numpy(pm_pad).to(dev), torch.from_numpy(k2_pad).to(dev),
            torch.from_numpy(fm_pad).to(dev), npad)
        deg_max = float(deg_max)
        sum_max = float(sum_max)
        deg = deg_d[:n].cpu().numpy().astype(np.int64)
        sum_deg = sum_d[:n].cpu().numpy()
        nnz = nnz_d[:n].cpu().numpy().astype(np.int64)
        if deg_max >= _EXACT_F32 or sum_max >= _EXACT_F32:
            self._event("degrade_exactness")
            return None
        from nornicdb_tpu_torch.query.columnar import _StripView

        sv = _StripView(deg, np.rint(sum_deg).astype(np.int64), nnz)
        if not cat.install_strip_view(key, sv, v0):
            self._event("degrade_stale")
            return None
        self._event("strip_view_device_built")
        return sv

    # -- co-occurrence Gram (tag_cooccurrence family) ---------------------

    def gram_matmul(self, ma: np.ndarray, mb: np.ndarray) -> Optional[np.ndarray]:
        """``Ma^T @ Mb`` on the device, float32, or None (the host
        multiplies). The caller (``columnar.cooc_gram``) holds the 2^24
        bound under which 0/1-integer float32 products are exact."""
        mode = graph_device_mode()
        if mode == "off":
            self._event("degrade_off")
            return None
        nmid = ma.shape[0]
        if mode == "auto" and (nmid < graph_device_min_n() or not self._on_cuda()):
            return None
        if ma.size == 0 or mb.size == 0:
            return None
        # both axes padded to powers of two: zero rows and columns leave
        # the live block of Ma^T @ Mb unchanged
        mp = pow2_bucket(nmid)
        ac, bc = pow2_bucket(ma.shape[1]), pow2_bucket(mb.shape[1])
        ma_p = np.zeros((mp, ac), np.float32)
        ma_p[:nmid, :ma.shape[1]] = ma
        dev = self.device
        ma_d = torch.from_numpy(ma_p).to(dev)
        if mb is ma and bc == ac:
            mb_d = ma_d
        else:
            mb_p = np.zeros((mp, bc), np.float32)
            mb_p[:nmid, :mb.shape[1]] = mb
            mb_d = torch.from_numpy(mb_p).to(dev)
        return _gram(ma_d, mb_d).cpu().numpy()[:ma.shape[1], :mb.shape[1]]

    # -- fused traverse-then-rank (graph+vector) --------------------------

    def _rank_snapshot(self, hops: Tuple[Tuple[str, str], ...],
                       index) -> Optional[Dict[str, Any]]:
        mutations = index.view_meta()
        if mutations is None:
            return None
        key = ("rank", hops, id(index))
        snap = self._get_snap(key)
        if snap is not None and snap.get("mutations") == mutations:
            return snap
        cat = self.catalog
        v0 = cat.version
        etypes = tuple(et for et, _d in hops)
        etv0 = cat.etype_versions(etypes)
        try:
            n = cat.n_nodes()
            nodes = cat.nodes()
            per_hop = []
            for etype, direction in hops:
                tbl = cat.edge_table(etype)
                indptr, order = tbl.csr(direction, n)
                far = (tbl.dst if direction == "out" else tbl.src)[order]
                if len(far) > self.MAX_ENTRIES:
                    return None
                if len(indptr) != n + 1:
                    self._event("degrade_torn")
                    return None
                per_hop.append((indptr, far))
            slots = index.slots_of([nd.id for nd in nodes], expect_mutations=mutations)
            if slots is None:
                return None
        except (IndexError, ValueError):
            self._event("degrade_torn")
            return None
        hops_d = []
        for ip, fr in per_hop:
            # an empty hop keeps one unreachable entry: every count is 0
            hops_d.append((self._int32(ip), self._int32(fr if len(fr) else [0]),
                           int((ip[1:] - ip[:-1]).max()) if n else 0))
        slot_of_row = self._int32(np.asarray(slots, dtype=np.int32))
        snap = {
            "version": v0,
            "etypes": etypes,
            "etv": etv0,
            "mutations": mutations,
            "n": n,
            "hops": hops_d,
            "slot_of_row": slot_of_row,
            "device_bytes": _nbytes(slot_of_row, *(t for ip, fr, _ in hops_d
                                                   for t in (ip, fr))),
            "host_bytes": 0,
            "rows": sum(len(fr) for _ip, fr in per_hop),
        }
        if not self._put_snap(key, snap):
            return None
        return snap

    def traverse_rank(
        self,
        anchors: Sequence[int],
        hops: Sequence[Tuple[str, str]],
        queries: np.ndarray,
        k: int,
        index,
    ) -> Optional[List[List[Tuple[int, float]]]]:
        """One dispatch: expansion from ``anchors`` along ``hops`` (1 or 2
        (etype, direction) stages), frontier dedup, cosine scores against
        the vector index's device matrix, top-k. Per anchor
        [(catalog row, score)], or None for the host path."""
        mode = graph_device_mode()
        if mode == "off":
            self._event("degrade_off")
            return None
        if not hops or len(hops) > 2 or k <= 0:
            return None
        if mode == "auto" and len(anchors) < graph_device_min_b() and not self._on_cuda():
            return None  # off the card, a few anchors are the host's
        hops_t = tuple((str(e), str(d)) for e, d in hops)
        snap = self._rank_snapshot(hops_t, index)
        if snap is None:
            self._event("degrade_stale")
            return None
        dv = index.device_view()
        if dv is None:
            return None
        matrix, valid, _ids, mutations = dv
        if mutations != snap["mutations"]:
            self._event("degrade_stale")
            return None
        if matrix.device.type != self.device.type:
            raise ValueError(f"the vector index lives on {matrix.device}, the graph plane "
                             f"on {self.device}")
        f1 = pow2_bucket(max(1, snap["hops"][0][2]))
        f2 = pow2_bucket(max(1, snap["hops"][1][2])) if len(hops_t) == 2 else 0
        frontier = f1 * max(f2, 1)
        if frontier > 1 << 18:
            self._event("degrade_rank_overflow")
            return None
        kp = pow2_bucket(min(k, max(frontier, 1)))
        bsz = pow2_bucket(len(anchors))
        a = np.full(bsz, -1, dtype=np.int32)
        a[:len(anchors)] = np.asarray(anchors, dtype=np.int32)
        q = np.zeros((bsz, queries.shape[1]), np.float32)
        q[:len(anchors)] = queries
        ip1, fr1, _d1 = snap["hops"][0]
        ip2, fr2 = (snap["hops"][1][:2] if f2 else (ip1, fr1))  # unused at f2 == 0
        vals, sel_rows = _traverse_rank(
            self._int32(a), torch.from_numpy(q).to(self.device), ip1, fr1, ip2, fr2,
            snap["slot_of_row"], matrix, valid, snap["n"], f1, f2, kp)
        # to the host before the freshness recheck
        vals = vals.cpu().numpy()
        sel_rows = sel_rows.cpu().numpy()
        self._dispatched()
        if self.catalog.etype_versions(snap["etypes"]) != snap["etv"] \
                or index.view_meta() != snap["mutations"]:
            self._event("degrade_stale")
            return None
        out: List[List[Tuple[int, float]]] = []
        for i in range(len(anchors)):
            hits = [(int(r), float(v)) for v, r in zip(vals[i], sel_rows[i])
                    if np.isfinite(v)][:k]
            out.append(hits)
        return out

    # -- shared whole-graph snapshot (PageRank / degree counts) -----------

    def pagerank_snapshot(self) -> Optional[Dict[str, Any]]:
        """The whole-graph edge snapshot, built exactly as
        ``ops.graph.graph_snapshot`` builds it (so PageRank is the same as
        without it), cached per catalog version with its device copy."""
        key = ("pagerank",)
        snap = self._get_snap(key)
        if snap is not None:
            return snap
        from nornicdb_tpu_torch.ops.graph import graph_snapshot

        cat = self.catalog
        v0 = cat.version
        try:
            src, dst, ids = graph_snapshot(cat.storage)
        except NotImplementedError:  # an engine that cannot list its records
            self._event("degrade_no_iteration")
            return None
        if len(src) > self.MAX_ENTRIES:
            return None
        dev_src, dev_dst = self._int32(src), self._int32(dst)
        snap = {
            "version": v0,
            "src": src,
            "dst": dst,
            "ids": ids,
            "dev_src": dev_src,
            "dev_dst": dev_dst,
            "device_bytes": _nbytes(dev_src, dev_dst),
            "host_bytes": src.nbytes + dst.nbytes,
            "rows": len(src),
        }
        if not self._put_snap(key, snap):
            return None
        return snap

    def degree_counts(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(out_degree, in_degree) over the shared snapshot, on the
        device."""
        snap = self.pagerank_snapshot()
        if snap is None:
            return None
        from nornicdb_tpu_torch.ops.graph import degree_counts

        out_d, in_d = degree_counts(snap["dev_src"], snap["dev_dst"], len(snap["ids"]))
        return out_d.cpu().numpy(), in_d.cpu().numpy()

    def traverse_rank_host(
        self,
        anchors: Sequence[int],
        hops: Sequence[Tuple[str, str]],
        queries: np.ndarray,
        k: int,
        index,
    ) -> List[List[Tuple[int, float]]]:
        """The host version with the same contract: expand, dedup
        (ascending row order), score exactly, stable top-k."""
        from nornicdb_tpu_torch.query.columnar import expand_hop

        cat = self.catalog
        n = cat.n_nodes()
        nodes = cat.nodes()
        out: List[List[Tuple[int, float]]] = []
        for i, anchor in enumerate(anchors):
            frontier = np.asarray([anchor], dtype=np.int32)
            for etype, direction in hops:
                tbl = cat.edge_table(etype)
                _rep, _erows, frontier = expand_hop(tbl, frontier, direction, n)
            rows = np.unique(frontier)
            if len(rows) == 0:
                out.append([])
                continue
            ids = [nodes[int(r)].id for r in rows]
            vecs = []
            keep_rows = []
            for r, eid in zip(rows.tolist(), ids):
                v = index.get(eid)
                if v is not None:
                    vecs.append(v)
                    keep_rows.append(r)
            if not vecs:
                out.append([])
                continue
            m = np.stack(vecs).astype(np.float32)
            qv = queries[i].astype(np.float32)
            qn = qv / max(float(np.linalg.norm(qv)), 1e-12)
            scores = m @ qn
            order = np.argsort(-scores, kind="stable")[:k]
            out.append([(int(keep_rows[j]), float(scores[j])) for j in order])
        return out
