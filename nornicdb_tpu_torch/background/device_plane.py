"""Device-resident AI-native background plane (counterpart of
``nornicdb_tpu/background/device_plane.py``, one device).

The last host loops of the memory plane — decay scoring (`decay.py`, one
``score()`` call per node), link prediction (`linkpredict.py`, one
Python set intersection per candidate pair), FastRP and inference
candidate generation — become amortized device passes over versioned
columnar snapshots, as PyTorch ops on the plane's device (the reference's
are jitted XLA programs, not TPU kernels, so no kernel is written here).

Snapshot/versioning contract:

- The plane keys its adjacency state on the catalog's **per-etype
  delta generations** (``ColumnarCatalog.etype_versions``): a write to
  edge type A re-extracts only A's slice; B's cached arrays — and any
  device snapshot keyed on B — stay live. The union CSR (link
  prediction's candidate graph spans every etype, matching the host
  ``AdjacencySnapshot``) rebuilds from the cached slices.
- Every job re-checks its snapshot key after the dispatch returns; a
  write that landed mid-job steps the job down to the host path
  (``stale_snapshot``), never a stale answer.

Host-parity contract — the device path is bit/rank-identical or it
does not serve:

- **decay**: verdicts inside the f32 score band around the archive
  threshold are re-scored on the host in f64 from the PRE-sweep Kalman
  state; outside the band f32-vs-f64 cannot flip the comparison.
- **link prediction**: the device pass returns a coarse top-``op``
  superset plus the exact distinct-candidate count; kept candidates
  are re-scored through the SAME host scorer over the SAME shared
  ``AdjacencySnapshot`` the host path uses (bitwise-identical sums),
  and the seed steps down to the full host path whenever an excluded
  candidate could reach the cut (``exactness``). The device sums' error
  bound holds for any summation order (``ops/linkpredict.py:sum_error_bound``):
  CUDA's ``scatter_add_`` promises none.
- **FastRP**: same algorithm, host-identical random init; f32
  accumulation order differs, so parity is tolerance-level (cosine).
- **inference candidates**: the batch rides the search service's own
  vector tiers, so parity holds by construction.

Fail closed (ROADMAP C25): the reference catches every exception of a
device dispatch and serves the host loop; here an error propagates. Only
the reference's named gaps step down, each counted in ``counts`` as
``degrade_<reason>``: ``off`` (``NORNICDB_BG_DEVICE=off``),
``unsupported_scorer``, ``stale_snapshot``, and per seed ``overflow`` (a
refused expansion) and ``exactness`` (an unproven cut). Served jobs count
``<job>_device``, or ``linkpredict_partial`` when some seeds stepped
down. The reference's admission lane, dispatch records, audit ledger,
cost records and ``REGISTRY`` counters wait for ROADMAP §A12.
"""

from __future__ import annotations

import os
import threading
import time
from bisect import insort as _insort
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch import linkpredict as _lp
from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.config import env_str
from nornicdb_tpu_torch.ops import decay as _od
from nornicdb_tpu_torch.ops import fastrp as _ofr
from nornicdb_tpu_torch.ops import linkpredict as _olp
from nornicdb_tpu_torch.search.microbatch import pow2_bucket
from nornicdb_tpu_torch.storage.types import now_ms

# full-coverage 2-hop expansion bound: above this the dispatch is
# refused (the host serves the seed), never truncated — truncation would
# break the completeness the parity proof rests on
_MAX_EXPANSION = 1 << 18
# f32 decay scores within this distance of the archive threshold are
# re-scored on the host in f64 (the f32 arithmetic error on these
# O(1)-magnitude scores is < 1e-6; the band is 100x that)
_DECAY_EPS = 1e-4

_DEVICE_SCORERS = ("common_neighbors", "adamic_adar",
                   "resource_allocation")

# host-side slice width between cooperative yields: a few ms of Python
# loop work
_TICK_EVERY = 4096


def _bg_tick() -> None:
    """Cooperative GIL handoff between background work slices. The
    plane's contract is that a whole-graph sweep never convoys the
    interactive lane, and CPython's preemption alone does not deliver
    it: ``sleep(0)`` lets the releasing thread win the re-acquire
    race, so a waiting interactive request still waits out the full
    switch interval. A real (micro) sleep blocks this thread and
    forces the handoff; at one tick per ~1ms slice the sweep donates
    well under 10% of its runtime to the interactive lane."""
    time.sleep(50e-6)


def demote_to_background_priority() -> "Tuple[int, int] | None":
    """Drop the CALLING PROCESS to the idle scheduling class.

    In-process, ``_bg_tick`` donates the GIL between work slices. Across
    processes (interactive reads served from other processes) the kernel
    scheduler decides who runs, and a whole-graph sweep at normal
    priority earns full CFS timeslices. ``SCHED_IDLE`` removes that
    wait: idle-class tasks are preempted immediately when any
    normal-priority task wakes. Call it only in a dedicated background
    worker process: it demotes every thread of its caller.

    Returns the previous ``(policy, nice)`` so a caller can try to
    restore it — raising priority back needs CAP_SYS_NICE, so the
    restore is best-effort. Returns None when the platform has no
    scheduling classes (non-Linux); callers proceed undemoted and the
    cooperative ticks remain the only mitigation."""
    try:
        prev = (os.sched_getscheduler(0), os.nice(0))
        os.sched_setscheduler(0, os.SCHED_IDLE, os.sched_param(0))
        return prev
    except (AttributeError, OSError):
        try:
            os.nice(19)
            return None
        except OSError:
            return None


def bg_device_mode() -> str:
    """NORNICDB_BG_DEVICE: off | auto | on. Background jobs are not
    request-path hot functions, so the env read happens per job; ``auto``
    and ``on`` both engage the plane."""
    mode = env_str("BG_DEVICE", "auto").lower()
    return mode if mode in ("off", "auto", "on") else "auto"


def _column(vals: List[Any], dtype) -> np.ndarray:
    """One column of the sweep, filled a chunk at a time: one 100k-list
    conversion is a multi-ms C-atomic GIL hold, which the tick contract
    forbids."""
    col = np.empty(len(vals), dtype)
    for off in range(0, len(vals), 4 * _TICK_EVERY):
        hi = min(off + 4 * _TICK_EVERY, len(vals))
        col[off:hi] = vals[off:hi]
        _bg_tick()
    return col


class BackgroundDevicePlane:
    """Device jobs over per-etype delta snapshots, on ``device`` (None =
    cuda).

    Constructed next to a ``ColumnarCatalog``; optionally wired to a
    ``DecayManager`` (whose ``sweep()`` then routes here first) and an
    ``InferenceEngine`` (whose ``on_store_batch`` rides the plane)."""

    def __init__(self, storage, catalog, decay=None, inference=None,
                 device: DeviceLike = None):
        self.storage = storage
        self.catalog = catalog
        self.decay = decay
        self.inference = inference
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # etype -> {"etv": (struct_gen, gen), "src": np, "dst": np}
        self._slices: Dict[str, Dict[str, Any]] = {}
        self._union: Optional[Dict[str, Any]] = None
        self.dispatches = 0
        self.counts: Counter = Counter()
        if decay is not None:
            decay.device_plane = self
        if inference is not None:
            inference.device_plane = self

    def _step_down(self, reason: str, n: int = 1) -> None:
        self.counts["degrade_" + reason] += n

    # -- per-etype delta slices -------------------------------------------

    def _etype_slice(self, et: str) -> Optional[Dict[str, Any]]:
        """This etype's edge arrays, cached on its delta key: a write
        to a DIFFERENT etype leaves this slice (and its cached copy)
        untouched — the re-extraction cost tracks the changed slice,
        not the graph."""
        cat = self.catalog
        etv = cat.etype_version(et)
        with self._lock:
            sl = self._slices.get(et)
        if sl is not None and sl["etv"] == etv:
            return sl
        tbl = cat.edge_table(et)
        # copy: the table's views extend in place under appends
        sl = {"etv": etv,
              "src": np.asarray(tbl.src, dtype=np.int64).copy(),
              "dst": np.asarray(tbl.dst, dtype=np.int64).copy()}
        if cat.etype_version(et) != etv:
            return None  # raced a write mid-extract; caller steps down
        with self._lock:
            self._slices[et] = sl
        return sl

    def _union_snapshot(self) -> Optional[Dict[str, Any]]:
        """Deduplicated undirected union CSR over every etype slice —
        row-for-row the host ``AdjacencySnapshot`` neighbor sets, as
        sorted int arrays. Cached until ANY etype's delta key moves;
        the rebuild re-reads only the changed slices."""
        cat = self.catalog
        etypes = tuple(cat.edge_types())
        etv = cat.etype_versions(etypes)
        with self._lock:
            u = self._union
        if (u is not None and u["etypes"] == etypes
                and u["etv"] == etv):
            return u
        nodes = cat.nodes()
        n = cat.n_nodes()
        parts: List[np.ndarray] = []
        for et in etypes:
            sl = self._etype_slice(et)
            if sl is None:
                return None
            if len(sl["src"]):
                parts.append(sl["src"] * n + sl["dst"])
                parts.append(sl["dst"] * n + sl["src"])
        if parts:
            keys = np.unique(np.concatenate(parts))
            su = keys // n
            nbr = (keys % n).astype(np.int32)
        else:
            su = np.zeros(0, np.int64)
            nbr = np.zeros(0, np.int32)
        indptr = np.searchsorted(su, np.arange(n + 1)).astype(np.int32)
        deg = indptr[1:] - indptr[:-1]
        snap = {
            "etypes": etypes,
            "etv": etv,
            "version": cat.version,
            "n": n,
            "indptr": indptr,
            "nbr": nbr,
            "max_deg": int(deg.max()) if n else 0,
            "ids": [nd.id for nd in nodes],
            "row_of": {nd.id: i for i, nd in enumerate(nodes)},
            "w": {},     # method -> host f32 weight column
            "dev": None,  # lazily transferred device tensors
            "host_bytes": int(indptr.nbytes + nbr.nbytes),
        }
        if cat.etype_versions(etypes) != etv:
            return None  # node axis or an etype moved mid-build
        with self._lock:
            self._union = snap
        return snap

    def _device_arrays(self, snap: Dict[str, Any], method: str):
        """The snapshot's CSR (int64, the index type of PyTorch's
        gathers) and ``method``'s weight column on the plane's device,
        uploaded once per snapshot."""
        with self._lock:
            if snap["dev"] is None:
                snap["dev"] = {
                    "indptr": torch.from_numpy(snap["indptr"].astype(np.int64)).to(self.device),
                    "nbr": torch.from_numpy(snap["nbr"].astype(np.int64)).to(self.device),
                    "w": {},
                }
            w = snap["w"].get(method)
            if w is None:
                w = _olp.degree_weights(method, snap["indptr"])
                snap["w"][method] = w
            dw = snap["dev"]["w"].get(method)
            if dw is None:
                dw = torch.from_numpy(w).to(self.device)
                snap["dev"]["w"][method] = dw
        return snap["dev"]["indptr"], snap["dev"]["nbr"], dw, w

    def resource_stats(self) -> Dict[str, float]:
        """The union snapshot's device bytes (its CSR and weight columns
        as held on the device), host bytes, rows, and how many catalog
        writes it trails."""
        with self._lock:
            u = self._union
        if u is None:
            return {"device_bytes": 0, "host_bytes": 0, "rows": 0,
                    "mutation_gap": 0}
        dev = u["dev"]
        device_bytes = 0
        if dev is not None:
            tensors = [dev["indptr"], dev["nbr"], *dev["w"].values()]
            device_bytes = sum(t.numel() * t.element_size() for t in tensors)
        return {
            "device_bytes": device_bytes,
            "host_bytes": u["host_bytes"],
            "rows": int(len(u["nbr"])),
            "mutation_gap": max(0, self.catalog.version - u["version"]),
        }

    # -- decay: one score-and-verdict pass --------------------------------

    def decay_sweep(self, now: Optional[int] = None
                    ) -> Optional[Tuple[int, int]]:
        """Whole-graph decay sweep as ONE device pass. Returns
        (scored, archived) with verdicts identical to the host sweep,
        or None (caller runs the host loop) at a named step-down.
        Verdicts are applied back through the normal storage write path;
        Kalman state is written back in f32 (the documented device-plane
        contract — the comparison band around the threshold is re-scored
        in f64)."""
        dm = self.decay
        if dm is None:
            return None
        if bg_device_mode() == "off":
            self._step_down("off")
            return None
        v0 = self.catalog.version
        now = now if now is not None else now_ms()
        # the catalog's resident node snapshot, NOT storage.all_nodes():
        # the host loop's O(N) defensive node copies are most of its
        # sweep cost, and the catalog version re-check below is what
        # makes skipping them safe
        nodes = self.catalog.nodes()
        m = len(nodes)
        if m == 0:
            self.counts["decay_sweep_device"] += 1
            return (0, 0)
        from nornicdb_tpu_torch.decay import _NodeState
        from nornicdb_tpu_torch.filters import KalmanFilter as _KF

        q = _KF.process_noise
        r = _KF.measurement_noise
        # column extraction: plain lists + one bulk np conversion;
        # exact f64 values survive in the lists for the boundary band
        ages: List[float] = []
        hls: List[float] = []
        cnts: List[float] = []
        imps: List[float] = []
        ests: List[float] = []
        errs: List[float] = []
        inits: List[bool] = []
        kfs: List[Any] = []
        half = dm.half_life_ms
        use_kalman = dm.use_kalman
        with dm._lock:
            states = dm._state
            for seen, node in enumerate(nodes, 1):
                if not (seen % _TICK_EVERY):
                    _bg_tick()
                nid = node.id
                st = states.get(nid)
                if st is None:
                    st = _NodeState()
                    states[nid] = st
                last = (st.last_access_ms or node.updated_at
                        or node.created_at or now)
                a = now - last
                ages.append(a if a > 0 else 0)
                hls.append(half[st.tier])
                cnts.append(st.access_count)
                try:
                    iv = float(node.properties.get("importance", 0.5))
                except (TypeError, ValueError):
                    iv = 0.5
                imps.append(0.0 if iv < 0.0 else (1.0 if iv > 1.0 else iv))
                k = st.kalman
                ests.append(k.estimate)
                errs.append(k.error)
                inits.append(k.initialized and use_kalman)
                kfs.append(k)
        weights = (dm.w_recency, dm.w_frequency, dm.w_importance)
        scores, new_est, new_err = _od.decay_scores(
            _column(ages, np.float32), _column(hls, np.float32),
            _column(cnts, np.float32), _column(imps, np.float32),
            _column(ests, np.float32), _column(errs, np.float32),
            _column(inits, bool), weights, q, r, device=self.device)
        self.dispatches += 1
        # post-dispatch freshness: a write during the window means the
        # columns no longer describe the store — the host re-runs
        if self.catalog.version != v0:
            self._step_down("stale_snapshot")
            return None
        thr = dm.archive_threshold
        scores = scores.astype(np.float64)
        # verdicts inside the f32 band around the threshold are
        # re-scored in f64 from the PRE-sweep state held in the
        # extraction lists (score() would advance the live filter a
        # second time — decay_score_host_f64 is pure)
        for i in np.nonzero(np.abs(scores - thr) < _DECAY_EPS)[0].tolist():
            scores[i] = _od.decay_score_host_f64(
                ages[i], hls[i], cnts[i], imps[i], ests[i], errs[i],
                inits[i], weights, q, r)
        if use_kalman:
            for off in range(0, m, _TICK_EVERY):
                hi = min(off + _TICK_EVERY, m)
                ne = new_est[off:hi].tolist()
                nv = new_err[off:hi].tolist()
                with dm._lock:
                    for k, e, v in zip(kfs[off:hi], ne, nv):
                        k.estimate = e
                        k.error = v
                        k.initialized = True
                _bg_tick()
        archived = 0
        # archive through the normal write path, on FRESH storage copies
        # (never the catalog's resident objects — pushing those back
        # could clobber fields written since the build)
        for t, i in enumerate(np.nonzero(scores < thr)[0].tolist()):
            if t and not (t % _TICK_EVERY):
                _bg_tick()
            try:
                node = dm.storage.get_node(nodes[i].id)
            except KeyError:
                continue
            if node.properties.get("_archived"):
                continue
            node.properties["_archived"] = True
            node.properties["_archived_at"] = now
            try:
                dm.storage.update_node(node)
                archived += 1
            except KeyError:
                pass
        self.counts["decay_sweep_device"] += 1
        return (m, archived)

    # -- link prediction: masked sparse expansion + top-k -----------------

    def linkpredict_topk(
        self,
        seeds: Sequence[str],
        method: str = "adamic_adar",
        limit: int = 10,
    ) -> Optional[Dict[str, List[Tuple[str, float]]]]:
        """Top-``limit`` predicted links for a batch of seed nodes in
        one device pass per seed-degree bucket, result-identical to
        per-seed host ``predict_links``. Returns None when the whole
        batch must run on the host (mode off / unsupported scorer /
        stale snapshot); individual seeds whose exactness cannot be
        PROVEN step down to the host path inline, so the returned dict
        is always complete and always right."""
        if bg_device_mode() == "off":
            self._step_down("off")
            return None
        if method not in _DEVICE_SCORERS:
            self._step_down("unsupported_scorer")
            return None
        snap = self._union_snapshot()
        if snap is None:
            self._step_down("stale_snapshot")
            return None
        n = snap["n"]
        indptr = snap["indptr"]
        row_of = snap["row_of"]
        rows = [row_of.get(sid, -1) for sid in seeds]
        f2 = pow2_bucket(max(1, snap["max_deg"]))
        op = pow2_bucket(max(2 * limit, 32))
        # seed-degree bucketing: the pass's work is linear in the padded
        # expansion f1*f2, so seeds dispatch in groups sized to their
        # OWN 1-hop width, not the batch max
        groups: Dict[int, List[int]] = {}
        host_set: set = set()
        for i, r in enumerate(rows):
            if r < 0:
                continue
            deg = int(indptr[r + 1] - indptr[r])
            f1g = max(8, pow2_bucket(max(1, deg)))
            if f1g * f2 > _MAX_EXPANSION:
                # full coverage will not fit: this seed is refused
                # (never truncated) and served by the host path
                host_set.add(i)
            else:
                groups.setdefault(f1g, []).append(i)
        if host_set:
            self._step_down("overflow", len(host_set))
        dip, dnbr, dw, w_host = self._device_arrays(snap, method)
        # seed index -> (vals_kept, rows_kept, covered, rawmin, f1g)
        per: Dict[int, Tuple] = {}
        for f1g in sorted(groups):
            idxs = groups[f1g]
            kpg = min(op, f1g * f2)
            seed_rows = np.asarray([rows[i] for i in idxs], np.int64)
            vals, sel, distinct = _olp.linkpredict_topk(
                seed_rows, dip, dnbr, dw, n, f1g, f2, kpg)
            self.dispatches += 1
            for j, i in enumerate(idxs):
                row = vals[j]
                keep = np.isfinite(row) & (row > 0)
                covered = int(distinct[j]) <= kpg
                # when candidates were excluded, the coverage guard
                # needs the TRUE smallest kept device score (including
                # zero-score slots the > 0 filter drops) — excluded
                # candidates sit at or below it
                rawmin = 0.0 if covered else float(row.min())
                per[i] = (row[keep], sel[j][keep], covered, rawmin, f1g)
        # per-etype post-dispatch recheck: only a write touching one of
        # the snapshot's etypes (or the node axis) landed mid-dispatch
        # stales this — the delta-snapshot payoff
        if self.catalog.etype_versions(snap["etypes"]) != snap["etv"]:
            self._step_down("stale_snapshot")
            return None
        is_cn = method == "common_neighbors"
        wmax = float(w_host.max(initial=0.0))
        hsnap = None
        scorer = _lp.SCORERS[method]
        ids = snap["ids"]
        out: Dict[str, List[Tuple[str, float]]] = {}
        unproven = 0
        for i, sid in enumerate(seeds):
            if i and not (i % 32):
                _bg_tick()  # finalize is ~0.1ms/seed of host work
            if rows[i] < 0:
                out[sid] = []  # unknown node: host returns [] too
                continue
            if i in host_set:
                out[sid] = _lp.predict_links(
                    self.storage, sid, method=method, limit=limit,
                    catalog=self.catalog)
                continue
            dvals, crows, covered, rawmin, f1g = per[i]
            dl = dvals.tolist()
            if is_cn:
                # counts are integer-exact in f32: the device values ARE
                # the host float scores — no re-score
                res = [(ids[cr], dv) for cr, dv in zip(crows.tolist(), dl)]
                res.sort(key=lambda kv: (-kv[1], kv[0]))
                result = res[:limit]
                safe = covered or (len(result) >= limit
                                   and rawmin < result[-1][1])
            else:
                # weighted scorers: exact host re-score through the
                # SHARED snapshot (bitwise the host path's f64 sums),
                # lazily in device-rank order — once ``limit`` exact
                # scores are in hand and the next device value plus the
                # f32 accumulation bound cannot reach the cut, no
                # remaining candidate can either
                werr = _olp.sum_error_bound(f1g, wmax)
                if hsnap is None:
                    hsnap = _lp.adjacency_snapshot(self.storage, self.catalog)
                ex: List[Tuple[float, str]] = []  # asc (-score, id)
                cut = None
                for t, cr in enumerate(crows.tolist()):
                    if cut is not None and dl[t] + werr < cut:
                        break
                    c = ids[cr]
                    s = scorer(hsnap, sid, c)
                    if s > 0:
                        _insort(ex, (-s, c))
                        if len(ex) >= limit:
                            cut = -ex[limit - 1][0]
                result = [(c, -ns) for ns, c in ex[:limit]]
                safe = covered or (cut is not None and rawmin + werr < cut)
            if not safe:
                out[sid] = _lp.predict_links(
                    self.storage, sid, method=method, limit=limit,
                    catalog=self.catalog)
                unproven += 1
                continue
            out[sid] = result
        if unproven:
            self._step_down("exactness", unproven)
        if host_set or unproven:
            self.counts["linkpredict_partial"] += 1
        else:
            self.counts["linkpredict_device"] += 1
        return out

    # -- FastRP: the propagation chain over the union CSR -----------------

    def fastrp_edges(self, snap: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        """The union's undirected pairs, each once (self-loops kept), as
        the (src, dst) edge list FastRP propagates both ways — exactly
        the list the host ``fastrp_embeddings`` is given to agree."""
        pairs_src = np.repeat(np.arange(snap["n"], dtype=np.int32),
                              snap["indptr"][1:] - snap["indptr"][:-1])
        pairs_dst = snap["nbr"]
        half = pairs_src < pairs_dst
        loops = pairs_src == pairs_dst
        return (np.concatenate([pairs_src[half], pairs_src[loops]]),
                np.concatenate([pairs_dst[half], pairs_dst[loops]]))

    def fastrp(self, dim: int = 64,
               iteration_weights: Sequence[float] = (0.0, 1.0, 1.0),
               normalization_strength: float = 0.0,
               seed: int = 42
               ) -> Optional[Tuple[List[str], np.ndarray]]:
        """FastRP embeddings for the whole union graph on the device.
        Returns (node_ids, [n, dim] f32) or None (host
        ``ops.fastrp.fastrp_embeddings`` serves). Same algorithm,
        host-identical init; f32 accumulation makes this a
        tolerance-parity surface (see module docstring)."""
        if bg_device_mode() == "off":
            self._step_down("off")
            return None
        snap = self._union_snapshot()
        if snap is None:
            self._step_down("stale_snapshot")
            return None
        src, dst = self.fastrp_edges(snap)
        emb = _ofr.fastrp_embeddings_device(
            snap["n"], src, dst, dim=dim,
            iteration_weights=iteration_weights,
            normalization_strength=normalization_strength, seed=seed,
            device=self.device)
        self.dispatches += 1
        if self.catalog.etype_versions(snap["etypes"]) != snap["etv"]:
            self._step_down("stale_snapshot")
            return None
        self.counts["fastrp_device"] += 1
        return (snap["ids"], emb)

    # -- inference candidate generation -----------------------------------

    def infer_candidates(
        self, items: Sequence[Tuple[str, Sequence[float]]], k: int,
    ) -> Optional[Dict[str, List[Tuple[str, float]]]]:
        """Batched candidate generation for newly stored nodes through
        the search service's own serving ladder (on the card, B1 through
        the vector batcher below the HNSW threshold). Parity holds by
        construction — the candidates come from the same service the
        per-node path calls."""
        inf = self.inference
        if inf is None or inf.search is None:
            return None
        if bg_device_mode() == "off":
            self._step_down("off")
            return None
        out: Dict[str, List[Tuple[str, float]]] = {}
        for nid, vec in items:
            out[nid] = list(inf.search.vector_search_candidates(vec, k=k))
        self.counts["infer_candidates_device"] += 1
        return out
