"""Ring attention: exact attention over a sequence sharded across a mesh's
``sp`` axis (counterpart of ``nornicdb_tpu/parallel/ring_attention.py``).

Each member holds S/n positions of q, k and v. The k/v blocks and their
key mask rotate around the ring (``collectives.ppermute``, ``i -> i+1``),
so member ``i`` attends to its own block, then ``i-1``'s, and so on, and
folds each into float32 accumulators with the online softmax. No member
builds the [S, S] scores or holds all of k and v. The result is exact
attention to float tolerance, as the reference's is.

The reference's last rotation, after the n-th block, feeds nothing; the
port rotates n-1 times. Its einsums run in float32 (``q`` is cast, as
``jnp``'s promotion of a bf16 ``q`` against the float32 k/v does), and the
output is cast back to ``q.dtype``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from nornicdb_tpu_torch.parallel import collectives as coll
from nornicdb_tpu_torch.parallel.mesh import Mesh
from nornicdb_tpu_torch.parallel.sharding import NamedSharding, assemble, split

MASKED = -1e30


def _attend_block(q, k, v, kmask, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(kmask[:, None, None, :], s, torch.full_like(s, MASKED))
    m = s.amax(dim=-1, keepdim=True)  # [B, H, Sq, 1]
    p = torch.exp(s - m)
    return torch.einsum("bhqk,bkhd->bqhd", p, v), m[..., 0], p.sum(dim=-1)


def _combine(acc, new):
    o_a, m_a, l_a = acc
    o_n, m_n, l_n = new
    m = torch.maximum(m_a, m_n)
    ca, cn = torch.exp(m_a - m), torch.exp(m_n - m)
    o = o_a * ca.transpose(1, 2)[..., None] + o_n * cn.transpose(1, 2)[..., None]
    return o, m, l_a * ca + l_n * cn


def _ring_attention_local(mesh: Mesh, q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                          v: Sequence[torch.Tensor], mask: Sequence[torch.Tensor],
                          axis_name: str) -> List[torch.Tensor]:
    """The reference's per-device body, for every member at once: ``q``,
    ``k``, ``v`` [B, Sq, H, D] and ``mask`` [B, Sk] a member; returns each
    member's [B, Sq, H, D] output."""
    n = mesh.shape[axis_name]
    perm = [(i, (i + 1) % n) for i in range(n)]
    scale = q[0].shape[-1] ** -0.5
    qf = [x.float() for x in q]
    kv = ([x.float() for x in k], [x.float() for x in v], list(mask))
    accs = []
    for x in q:
        b, sq, h, d = x.shape
        accs.append((torch.zeros(b, sq, h, d, dtype=torch.float32, device=x.device),
                     torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=x.device),
                     torch.zeros(b, h, sq, dtype=torch.float32, device=x.device)))
    for step in range(n):
        ks, vs, ms = kv
        accs = [_combine(acc, _attend_block(qm, km, vm, mm, scale))
                for acc, qm, km, vm, mm in zip(accs, qf, ks, vs, ms)]
        if step < n - 1:
            kv = tuple(coll.ppermute(mesh, xs, axis_name, perm) for xs in kv)
    out = []
    for (o, _, l), x in zip(accs, q):
        l = l.clamp_min(1e-30)
        out.append((o / l.transpose(1, 2)[..., None]).to(x.dtype))
    return out


def ring_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # [B, S] key validity
    mesh: Optional[Mesh] = None,
    axis_name: str = "sp",
    batch_axis: Optional[str] = None,  # mesh axis carrying the batch (dp)
    head_axis: Optional[str] = None,  # mesh axis carrying the heads (tp)
) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis_name``; B over
    ``batch_axis`` and H over ``head_axis`` where given, so the ring only
    rotates over the sequence. Without a mesh, or with the axis at size 1,
    dense attention. The output is gathered back onto ``q``'s device."""
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        return _dense_attention(q, k, v, mask)
    qkv = NamedSharding(mesh, (batch_axis, axis_name, head_axis, None))
    out = _ring_attention_local(mesh, split(q, qkv), split(k, qkv), split(v, qkv),
                                split(mask, NamedSharding(mesh, (batch_axis, axis_name))),
                                axis_name)
    return assemble(out, qkv, q.device)


def _dense_attention(q, k, v, mask):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    s = s.masked_fill(~mask[:, None, None, :], MASKED)
    w = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)
