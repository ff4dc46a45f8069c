"""Sharded values on a mesh: the minimum of ``jax.sharding`` and
``jax.Array`` that the training half of the port needs. No JAX file
corresponds to it.

- A spec is a tuple with one mesh axis name or ``None`` a dimension (the
  reference's ``PartitionSpec``); a shorter spec leaves the rest whole.
- ``NamedSharding(mesh, spec)`` carries ``spec`` and
  ``is_fully_replicated``.
- ``ShardedTensor`` is a global tensor held as blocks. ``shards`` maps a
  block's key (its block number along each dimension) to the one tensor
  that holds it, placed on ``owners[key]``: the first member, in member
  order, whose block it is. Every member that holds the block reads that
  tensor (``blocks``), so a replicated block is stored once a process, and
  its gradient is the sum over its readers. The distinct shards are what
  an optimizer steps.
- ``device_put`` places a host array or a tensor; ``split`` and
  ``assemble`` cut a tensor into its members' blocks and put them back
  together, differentiably, where a ``shard_map``'s in and out specs do.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.parallel.collectives import axis_index, replicated_read
from nornicdb_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]
Key = Tuple[int, ...]


class NamedSharding:
    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]] = ()):
        self.mesh = mesh
        self.spec: Spec = tuple(spec)
        for a in self.spec:
            if a is not None and a not in mesh.shape:
                raise ValueError(f"spec {self.spec} names {a!r}, not an axis of {mesh}")

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None or self.mesh.shape[a] == 1 for a in self.spec)

    def axes(self, ndim: int) -> Spec:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than {ndim} dimensions")
        return self.spec + (None,) * (ndim - len(self.spec))

    def counts(self, ndim: int) -> Key:
        """Blocks along each dimension."""
        return tuple(1 if a is None else self.mesh.shape[a] for a in self.axes(ndim))

    def key(self, m: int, ndim: int) -> Key:
        """Member ``m``'s block."""
        return tuple(0 if a is None else axis_index(self.mesh, a, m) for a in self.axes(ndim))

    def block_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        counts = self.counts(len(shape))
        for n, c, a in zip(shape, counts, self.axes(len(shape))):
            if n % c:
                raise ValueError(f"a dimension of {n} does not divide by {a}={c}")
        return tuple(n // c for n, c in zip(shape, counts))

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh.shape}, spec=P{self.spec})"


def _slices(key: Key, block: Sequence[int]) -> Tuple[slice, ...]:
    return tuple(slice(k * n, (k + 1) * n) for k, n in zip(key, block))


def _join(pieces: Dict[Key, torch.Tensor], counts: Key, device: torch.device) -> torch.Tensor:
    """The blocks ``pieces`` (one a key) concatenated into one tensor on
    ``device``, dimension by dimension."""

    def rec(prefix: Key) -> torch.Tensor:
        d = len(prefix)
        if d == len(counts):
            return pieces[prefix].to(device)
        parts = [rec(prefix + (i,)) for i in range(counts[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return rec(())


class Shard:
    """One member's block (``jax.Shard``'s ``device``, ``index``, ``data``)."""

    __slots__ = ("device", "index", "data")

    def __init__(self, device: torch.device, index: Tuple[slice, ...], data: torch.Tensor):
        self.device, self.index, self.data = device, index, data


class ShardedTensor:
    def __init__(self, sharding: NamedSharding, shape: Sequence[int],
                 shards: Dict[Key, torch.Tensor], owners: Dict[Key, int]):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.shards = shards
        self.owners = owners

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def member_keys(self) -> List[Key]:
        return [self.sharding.key(m, self.ndim) for m in range(len(self.sharding.mesh.members))]

    def blocks(self) -> List[torch.Tensor]:
        """Each member's block, on its device, differentiable to the shard
        that holds it. A shard replicated over a process axis is read
        through ``replicated_read``, once."""
        mesh = self.sharding.mesh
        src = self.shards
        if mesh.process_axis is not None and mesh.process_axis not in self.sharding.spec:
            src = {k: replicated_read(mesh, v) for k, v in src.items()}
        return [src[k].to(dev) for k, dev in zip(self.member_keys(), mesh.members)]

    @property
    def addressable_shards(self) -> List[Shard]:
        block = self.sharding.block_shape(self.shape)
        return [Shard(dev, _slices(k, block), self.shards[k].detach().to(dev))
                for k, dev in zip(self.member_keys(), self.sharding.mesh.members)]

    def _check_addressable(self) -> None:
        mesh = self.sharding.mesh
        if mesh.process_count > 1 and mesh.process_axis in self.sharding.spec:
            raise ValueError("the value spans processes: only its addressable_shards are here")

    def gather(self, device=None, grad: bool = False) -> torch.Tensor:
        """The global value (or the shards' gradients, ``grad=True``) on
        ``device`` (default: the first member's)."""
        self._check_addressable()
        pieces = self.shards
        if grad:
            pieces = {k: v.grad for k, v in pieces.items()}
        dev = torch.device(device) if device is not None else self.sharding.mesh.members[0]
        with torch.no_grad():
            return _join(pieces, self.sharding.counts(self.ndim), dev)

    def __array__(self, dtype=None, copy=None):
        out = self.gather("cpu").numpy()
        return out if dtype is None else out.astype(dtype)

    def requires_grad_(self, flag: bool = True) -> "ShardedTensor":
        for s in self.shards.values():
            s.requires_grad_(flag)
        return self

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={self.shape}, {self.sharding})"


def place(sharding: NamedSharding, shape: Sequence[int],
          block_of: Callable[[Key], torch.Tensor]) -> ShardedTensor:
    """A ``ShardedTensor`` of global ``shape`` whose block ``key`` is a copy
    of ``block_of(key)``, made on its owner."""
    shape = tuple(shape)
    sharding.block_shape(shape)  # divisibility
    shards: Dict[Key, torch.Tensor] = {}
    owners: Dict[Key, int] = {}
    for m, dev in enumerate(sharding.mesh.members):
        k = sharding.key(m, len(shape))
        if k not in shards:
            shards[k] = block_of(k).detach().to(dev, copy=True).contiguous()
            owners[k] = m
    return ShardedTensor(sharding, shape, shards, owners)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, ShardedTensor):
        return x.gather()
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """``x`` (a host array, a tensor or a ``ShardedTensor``) placed by
    ``sharding``: each distinct block copied once, to its owner."""
    t = _as_tensor(x)
    block = sharding.block_shape(t.shape)
    return place(sharding, t.shape, lambda k: t[_slices(k, block)])


def split(x: torch.Tensor, sharding: NamedSharding) -> List[torch.Tensor]:
    """``x``'s block for each member, on the member's device
    (differentiable): a ``shard_map`` in spec."""
    block = sharding.block_shape(x.shape)
    return [x[_slices(sharding.key(m, x.ndim), block)].to(dev)
            for m, dev in enumerate(sharding.mesh.members)]


def member_blocks(x, sharding: NamedSharding) -> List[torch.Tensor]:
    """Each member's block of ``x``: a ``ShardedTensor``'s own blocks when it
    is placed by the same spec on the same mesh, else ``split``."""
    if isinstance(x, ShardedTensor):
        if x.sharding.mesh is sharding.mesh and \
                x.sharding.axes(x.ndim) == sharding.axes(x.ndim):
            return x.blocks()
        x = x.gather()
    return split(_as_tensor(x), sharding)


def assemble(blocks: Sequence[torch.Tensor], sharding: NamedSharding,
             device=None) -> torch.Tensor:
    """The global tensor whose members' blocks are ``blocks``
    (differentiable; the first member holding a block gives it): a
    ``shard_map`` out spec."""
    ndim = blocks[0].ndim
    pieces: Dict[Key, torch.Tensor] = {}
    for m, b in enumerate(blocks):
        pieces.setdefault(sharding.key(m, ndim), b)
    dev = torch.device(device) if device is not None else sharding.mesh.members[0]
    return _join(pieces, sharding.counts(ndim), dev)
