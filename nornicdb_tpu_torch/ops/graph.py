"""Graph algorithms over columnar edge arrays (counterpart of
``nornicdb_tpu/ops/graph.py``).

Reference: apoc/algo/algo.go:32 (PageRank). The graph is packed into flat
int32 src/dst arrays (a columnar snapshot). ``pagerank_torch`` runs the
power iteration as PyTorch ops on the device of its inputs: the edges are
sorted by destination once, and every iteration is one sorted segment sum
plus the dangling mass. ``_pagerank_host`` is a copy of the reference's
scipy version, the host version the device program is held against.

Where the reference picks the host version by itself on a CPU backend
(``pagerank_arrays``), the port does not: ``pagerank_arrays`` runs the
torch program on the device it is given, and a caller that wants the host
version calls ``_pagerank_host`` by name (ROADMAP C28).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.storage.types import Engine


def pagerank_torch(src: torch.Tensor, dst: torch.Tensor, n: int, iters: int,
                   damping: float = 0.85) -> torch.Tensor:
    """PageRank scores [n] float32 of the edges ``src -> dst`` (int32 or
    int64 tensors on one device), ``iters`` power iterations from the
    uniform vector; dangling mass is spread uniformly."""
    out_deg = torch.bincount(src, minlength=n).to(torch.float32)
    safe_deg = torch.clamp_min(out_deg, 1.0)
    dangle = out_deg == 0
    order = torch.argsort(dst, stable=True)
    dst_s = dst.index_select(0, order).to(torch.int64)
    src_s = src.index_select(0, order).to(torch.int64)
    p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=src.device)
    for _ in range(iters):
        contrib = p / safe_deg
        dangling = torch.where(dangle, p, 0.0).sum()
        acc = torch.zeros(n, dtype=torch.float32, device=src.device).index_add_(
            0, dst_s, contrib.index_select(0, src_s))
        p = (1.0 - damping) / n + damping * (acc + dangling / n)
    return p


def _pagerank_host(
    src: np.ndarray, dst: np.ndarray, n: int, iters: int, damping: float
) -> np.ndarray:
    """Host power iteration over a CSR adjacency built once (a copy of the
    reference's): the scatter is a scipy SpMV per iteration."""
    import scipy.sparse as sp

    deg = np.bincount(src, minlength=n).astype(np.float32)
    safe = np.maximum(deg, 1.0)
    adj = sp.csr_matrix(
        (np.ones(len(src), np.float32), (dst, src)), shape=(n, n))
    dangle = deg == 0
    p = np.full(n, 1.0 / n, np.float32)
    for _ in range(iters):
        contrib = p / safe
        dangling = p[dangle].sum() / n
        p = ((1.0 - damping) / n
             + damping * (adj @ contrib + dangling)).astype(np.float32)
    return p


def pagerank_arrays(
    src: np.ndarray, dst: np.ndarray, n: int, iters: int = 20,
    damping: float = 0.85, dev_src: Optional[torch.Tensor] = None,
    dev_dst: Optional[torch.Tensor] = None, device: DeviceLike = None,
) -> np.ndarray:
    """PageRank of the edges on ``device``, as host float32. ``dev_src``/
    ``dev_dst``: the same edges already on a device (the graph plane's
    cached snapshot), which skips the copy and sets the device."""
    if n == 0:
        return np.zeros((0,), np.float32)
    if len(src) == 0:
        return np.full((n,), 1.0 / n, np.float32)
    if dev_src is None or dev_dst is None:
        dev = resolve_device(device)
        dev_src = torch.as_tensor(np.asarray(src, np.int32), device=dev)
        dev_dst = torch.as_tensor(np.asarray(dst, np.int32), device=dev)
    return pagerank_torch(dev_src, dev_dst, n, iters, damping).cpu().numpy()


def graph_snapshot(storage: Engine) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Columnar edge snapshot: (src[E], dst[E], node_ids) with node ids
    densely indexed."""
    ids: List[str] = [n.id for n in storage.all_nodes()]
    index: Dict[str, int] = {nid: i for i, nid in enumerate(ids)}
    src, dst = [], []
    for e in storage.all_edges():
        si = index.get(e.start_node)
        di = index.get(e.end_node)
        if si is None or di is None:
            continue
        src.append(si)
        dst.append(di)
    return (
        np.asarray(src, dtype=np.int32),
        np.asarray(dst, dtype=np.int32),
        ids,
    )


def pagerank_engine(
    storage: Engine, iters: int = 20, damping: float = 0.85, plane=None,
    device: DeviceLike = None,
) -> List[Tuple[str, float]]:
    """PageRank over the whole stored graph, scores descending.

    With ``plane`` (a ``query/device_graph.DeviceGraphPlane`` over this
    storage's catalog) the edge snapshot and its device copy come from the
    plane's version-keyed cache; the snapshot is built by the same
    ``graph_snapshot`` either way, so the scores are the same."""
    snap = None
    if plane is not None and plane.catalog.storage is storage:
        snap = plane.pagerank_snapshot()
    if snap is not None:
        src, dst, ids = snap["src"], snap["dst"], snap["ids"]
        scores = pagerank_arrays(src, dst, len(ids), iters, damping,
                                 dev_src=snap["dev_src"],
                                 dev_dst=snap["dev_dst"])
    else:
        src, dst, ids = graph_snapshot(storage)
        scores = pagerank_arrays(src, dst, len(ids), iters, damping, device=device)
    order = np.argsort(-scores)
    return [(ids[i], float(scores[i])) for i in order]


def degree_counts(src: torch.Tensor, dst: torch.Tensor, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out_degree[n], in_degree[n]) int32 on the edges' device; integer
    counts, exact in any order."""
    out_d = torch.bincount(src, minlength=n).to(torch.int32)
    in_d = torch.bincount(dst, minlength=n).to(torch.int32)
    return out_d, in_d
