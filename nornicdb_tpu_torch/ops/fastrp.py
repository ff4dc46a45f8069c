"""FastRP node embeddings (Fast Random Projection), counterpart of
``nornicdb_tpu/ops/fastrp.py``.

Reference: pkg/cypher/fastrp.go (802 LoC, gds.fastRP.stream over a
projected graph). Propagation is a handful of dense array ops —
scatter-add over the edge arrays (the same columnar layout as
query/columnar.py) with degree normalization. Algorithm per the FastRP
paper: very sparse random projection init, L2-normalized
neighbor-averaging iterations, weighted sum. ``fastrp_embeddings`` (numpy)
is a copy of the reference's, bitwise; ``fastrp_device`` runs the same
algorithm as PyTorch ops on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device


def _normalize_rows(m: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(m, axis=1, keepdims=True)
    return m / np.maximum(norms, 1e-12)


def sparse_init(n_nodes: int, dim: int, seed: int = 42,
                sparsity: int = 3) -> np.ndarray:
    """The very sparse random projection both paths start from: +/-
    sqrt(s) w.p. 1/2s each, else 0, drawn from ``np.random.default_rng(seed)``
    exactly as :func:`fastrp_embeddings` draws it."""
    rng = np.random.default_rng(seed)
    s = float(sparsity)
    u = rng.random((n_nodes, dim))
    r = np.zeros((n_nodes, dim), np.float32)
    r[u < 1.0 / (2 * s)] = np.sqrt(s)
    r[u > 1.0 - 1.0 / (2 * s)] = -np.sqrt(s)
    return r


def fastrp_embeddings(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    dim: int = 64,
    iteration_weights: Sequence[float] = (0.0, 1.0, 1.0),
    normalization_strength: float = 0.0,
    seed: int = 42,
    sparsity: int = 3,
) -> np.ndarray:
    """[n_nodes, dim] float32 embeddings.

    src/dst: int arrays of edge endpoints (node row indices); edges are
    treated as undirected (both directions propagate), matching
    gds.fastRP defaults.
    """
    r = sparse_init(n_nodes, dim, seed, sparsity)
    deg = np.zeros(n_nodes, np.float64)
    np.add.at(deg, src, 1.0)
    np.add.at(deg, dst, 1.0)
    # degree scaling d^beta (normalization strength, gds default 0)
    with np.errstate(divide="ignore"):
        scale = np.where(deg > 0, deg ** normalization_strength, 0.0)
        inv_deg = np.where(deg > 0, 1.0 / deg, 0.0)

    def propagate(h: np.ndarray) -> np.ndarray:
        out = np.zeros_like(h)
        np.add.at(out, src, h[dst])
        np.add.at(out, dst, h[src])
        out *= inv_deg[:, None]  # mean over neighbors
        out *= scale[:, None]
        return out

    emb = np.zeros((n_nodes, dim), np.float32)
    h = r
    for w in iteration_weights:
        h = propagate(h)
        h = _normalize_rows(h).astype(np.float32)
        if w:
            emb += np.float32(w) * h
    return _normalize_rows(emb).astype(np.float32)


def fastrp_device(r0: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  iteration_weights: Sequence[float] = (0.0, 1.0, 1.0),
                  normalization_strength: float = 0.0) -> torch.Tensor:
    """FastRP on the tensors' device from the init ``r0`` [n, dim] float32
    and the int64 edge endpoints (undirected: both directions
    propagate): degree, propagation by segment sum (``index_add_``), row
    norms and the weighted sum, all float32. [n, dim] float32."""
    n = r0.shape[0]
    both_src = torch.cat([src, dst])
    both_dst = torch.cat([dst, src])
    deg = torch.zeros(n, dtype=torch.float32, device=r0.device)
    deg.index_add_(0, both_src, torch.ones_like(both_src, dtype=torch.float32))
    live = deg > 0
    scale = torch.where(live, deg ** float(normalization_strength), 0.0)
    inv_deg = torch.where(live, 1.0 / deg, 0.0)
    coef = (inv_deg * scale)[:, None]

    def norm_rows(m):
        return m / torch.linalg.vector_norm(m, dim=1, keepdim=True).clamp_min(1e-12)

    emb = torch.zeros_like(r0)
    h = r0
    for w in iteration_weights:
        out = torch.zeros_like(h)
        out.index_add_(0, both_src, h[both_dst])
        h = norm_rows(out * coef)
        if w:
            emb = emb + float(w) * h
    return norm_rows(emb)


def fastrp_embeddings_device(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    dim: int = 64,
    iteration_weights: Sequence[float] = (0.0, 1.0, 1.0),
    normalization_strength: float = 0.0,
    seed: int = 42,
    sparsity: int = 3,
    device: DeviceLike = None,
) -> np.ndarray:
    """Device FastRP: the same algorithm as :func:`fastrp_embeddings`
    on ``device`` (None = cuda). The very-sparse random init is generated
    on the HOST with the identical rng stream and transferred, so the two
    paths start from the same projection; the propagation then runs in
    f32 on device (the host path accumulates the degree column in f64),
    so embeddings agree to f32 tolerance — the parity contract is
    cosine-level, not bitwise."""
    r = sparse_init(n_nodes, dim, seed, sparsity)
    if n_nodes == 0:
        return r
    if len(src) == 0:
        return _normalize_rows(np.zeros((n_nodes, dim), np.float32)) \
            .astype(np.float32)
    dev = resolve_device(device)
    emb = fastrp_device(
        torch.from_numpy(r).to(dev),
        torch.as_tensor(np.asarray(src, np.int64), device=dev),
        torch.as_tensor(np.asarray(dst, np.int64), device=dev),
        iteration_weights, normalization_strength)
    return emb.cpu().numpy()


class GdsGraphCatalog:
    """In-memory projected-graph catalog (reference: gds.graph.project /
    list / drop, fastrp.go:8-26)."""

    def __init__(self):
        self._graphs: Dict[str, Dict] = {}

    def project(self, storage, name: str, node_label: str,
                rel_type: str) -> Dict:
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already exists")
        if node_label in ("*", "", None):
            nodes = list(storage.all_nodes())
        else:
            nodes = storage.get_nodes_by_label(node_label)
        row_of = {n.id: i for i, n in enumerate(nodes)}
        src: List[int] = []
        dst: List[int] = []
        edges = (storage.all_edges() if rel_type in ("*", "", None)
                 else storage.get_edges_by_type(rel_type))
        n_rels = 0
        for e in edges:
            a = row_of.get(e.start_node)
            b = row_of.get(e.end_node)
            if a is None or b is None:
                continue
            src.append(a)
            dst.append(b)
            n_rels += 1
        g = {
            "name": name,
            "node_ids": [n.id for n in nodes],
            "src": np.asarray(src, np.int64),
            "dst": np.asarray(dst, np.int64),
            "nodeCount": len(nodes),
            "relationshipCount": n_rels,
            "nodeProjection": node_label or "*",
            "relationshipProjection": rel_type or "*",
        }
        self._graphs[name] = g
        return g

    def get(self, name: str) -> Optional[Dict]:
        return self._graphs.get(name)

    def drop(self, name: str) -> Optional[Dict]:
        return self._graphs.pop(name, None)

    def list(self) -> List[Dict]:
        return list(self._graphs.values())

    def fastrp(self, name: str, dim: int = 64,
               iteration_weights: Sequence[float] = (0.0, 1.0, 1.0),
               normalization_strength: float = 0.0,
               seed: int = 42) -> Tuple[List[str], np.ndarray]:
        g = self._graphs.get(name)
        if g is None:
            raise KeyError(f"graph {name!r} not found; "
                           "CALL gds.graph.project(...) first")
        emb = fastrp_embeddings(
            g["nodeCount"], g["src"], g["dst"], dim=dim,
            iteration_weights=iteration_weights,
            normalization_strength=normalization_strength, seed=seed,
        )
        return g["node_ids"], emb
