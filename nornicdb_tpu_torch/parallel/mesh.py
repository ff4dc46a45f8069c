"""Device meshes and the sharded exact top-k (counterpart of
``nornicdb_tpu/parallel/mesh.py``).

The reference runs its mesh paths in one controller process: each shard
is placed on its device once, and one ``shard_map`` program computes every
shard's local top-k and merges the winners with an ``all_gather`` and a
``top_k``. Here the same single process drives one **member** device a
shard:

- ``devices()`` is the counterpart of ``jax.devices()``: the service's
  CUDA cards, or the one CPU device. ``member_devices`` replaces that list
  for a scope (the tests' counterpart of ``tests/conftest.py``'s eight
  faked CPU devices); unlike a JAX mesh, the list may repeat one device,
  so that one card runs a two-member mesh (ROADMAP C34).
- ``run_members`` runs one piece of work a member: under
  ``torch.cuda.device(member)``, on that member's own stream, after the
  caller's stream on the lead member (member 0) and the member device's
  own. Its ``[B, k]`` outputs are copied to the lead member, in member
  order, and the caller's stream waits on each member's event before it
  reads them; every tensor that crosses streams is ``record_stream``-ed.
  One host thread launches every member: the launches are asynchronous.
- The merge is ``ops/similarity.py:concat_topk`` over the members' blocks
  in member order, the layout of a tiled ``all_gather``: the mesh path
  equals the single-device loops bitwise (the reference's
  ``ops/similarity.py:148-165``).

``compat_shard_map``, ``mesh_context`` and ``_MeshHolder`` are JAX-version
and jit plumbing with no counterpart here.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.ops.similarity import concat_topk
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk

# mesh dispatches by kind and member works by member position: the mesh
# path's own counts, beside the tiers' (which count a dispatch whichever
# path served it)
counts: Counter = Counter()
member_runs: Counter = Counter()

_members_override: Optional[List[torch.device]] = None
_streams: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


@dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes: ``dp`` data parallel (batch), ``tp`` tensor
    parallel (hidden/heads), ``sp`` sequence parallel."""

    dp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp


def best_mesh(n_devices: int) -> MeshSpec:
    """Factor a device count into (dp, tp, sp), favouring dp: tp takes 2
    when 4 or more devices divide by 2, then sp 2 on the same rule, dp the
    rest."""
    dp, tp, sp = 1, 1, 1
    rem = n_devices
    if rem % 2 == 0 and rem >= 4:
        tp = 2
        rem //= 2
    if rem % 2 == 0 and rem >= 4:
        sp = 2
        rem //= 2
    dp = rem
    return MeshSpec(dp=dp, tp=tp, sp=sp)


class Mesh:
    """A named-axes array of ``torch.device``s: ``devices`` an object array
    of the axes' sizes, ``shape`` the size of each named axis.

    A mesh may span processes (``parallel/multihost.py:hybrid_mesh``):
    then ``process_axis`` names the axis whose rows are split between the
    ``process_count`` processes of the ``torch.distributed`` group, process
    major, ``devices`` holds this process's rows only (its members), and
    ``shape`` gives that axis's global size. ``in_process_group`` says the
    mesh was built inside such a group (a world of one included): its
    reductions over ``process_axis`` then cross the group."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_axis: Optional[str] = None, process_index: int = 0,
                 process_count: int = 1, in_process_group: bool = False):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} axes of devices, names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.process_axis = process_axis
        self.process_index, self.process_count = process_index, process_count
        self.in_process_group = in_process_group
        if process_axis is not None:
            self.shape[process_axis] *= process_count

    @property
    def members(self) -> List[torch.device]:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.members})"


def _device_array(devs: Sequence[torch.device], shape: Tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = list(devs)
    return arr.reshape(shape)


def devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices a mesh may take members from (``jax.devices()``): the
    replacement list inside ``member_devices``, else every CUDA card when
    ``device`` (default ``cuda``) is a CUDA device, else the one CPU."""
    if _members_override is not None:
        return list(_members_override)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


_devices = devices  # make_mesh's argument shadows the name


@contextlib.contextmanager
def member_devices(members: Sequence[DeviceLike]) -> Iterator[List[torch.device]]:
    """Replace ``devices()``'s list for the scope. A device may repeat (one
    card, several members); CUDA devices get their index."""
    global _members_override
    devs = []
    for d in members:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("a mesh needs at least one member")
    prev, _members_override = _members_override, devs
    try:
        yield list(devs)
    finally:
        _members_override = prev


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A (dp, tp, sp) mesh over ``devices`` (default ``devices()``)."""
    devs = list(devices) if devices is not None else _devices()
    if spec is None:
        spec = MeshSpec(dp=len(devs))
    if spec.size != len(devs):
        raise ValueError(f"mesh spec {spec} does not cover {len(devs)} devices")
    return Mesh(_device_array(devs, (spec.dp, spec.tp, spec.sp)), ("dp", "tp", "sp"))


def data_mesh(n: Optional[int] = None, device: DeviceLike = None) -> Mesh:
    """A 1-D ``data`` mesh over the first ``n`` (default all) of
    ``devices(device)``, for row-sharded search."""
    devs = devices(device)
    devs = devs[:n or len(devs)]
    return Mesh(_device_array(devs, (len(devs),)), ("data",))


def mesh_members(n_shards: int, device: DeviceLike = None) -> Optional[List[torch.device]]:
    """The members of an ``n_shards``-shard layout's mesh, or None when
    the layout takes the single-device loop: one shard, or fewer devices
    than shards (the reference's ``len(jax.devices()) >= s`` rule)."""
    if n_shards <= 1:
        return None
    devs = devices(device)
    return devs[:n_shards] if len(devs) >= n_shards else None


def layout_members(layout: dict, device: DeviceLike = None) -> Optional[List[torch.device]]:
    """The members a placed layout (a snapshot, graph or plane holding
    ``members``) is served through, or None when the loop serves it: it
    was not placed, or fewer devices than its shards are listed now (the
    reference checks ``len(jax.devices())`` at each dispatch too)."""
    members = layout.get("members")
    if members is None or len(devices(device)) < layout["shards"]:
        return None
    return members


# ---------------------------------------------------------------------------
# running one piece of work a member
# ---------------------------------------------------------------------------


def _member_stream(position: int, dev: torch.device) -> "torch.cuda.Stream":
    key = (position, dev.index)
    with _streams_lock:
        stream = _streams.get(key)
        if stream is None:
            stream = _streams[key] = torch.cuda.Stream(device=dev)
        return stream


def to_member(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on member device ``dev``, inside ``run_members``'s work: a copy
    on the member's stream, or ``x`` itself, then marked as used on that
    stream so the allocator cannot hand its block out early. Every tensor
    a member reads passes through here: a placed block may be replaced (an
    alive refresh, a new join map or brute matrix) while a member still
    reads it."""
    y = x.to(dev)
    if y is x and dev.type == "cuda":
        x.record_stream(torch.cuda.current_stream(dev))
    return y


def run_members(
    kind: str, members: Sequence[torch.device],
    work: Callable[[int, torch.device], Tuple[torch.Tensor, ...]],
) -> List[Tuple[torch.Tensor, ...]]:
    """``work(m, members[m])`` for each member, each on its device and own
    stream (module docstring); returns the outputs on ``members[0]``, in
    member order, ready for the caller's current stream there. Counted
    under ``counts[kind]``. A fault in any member propagates."""
    counts[kind] += 1
    lead = members[0]
    if lead.type != "cuda":
        outs = []
        for m, dev in enumerate(members):
            member_runs[m] += 1
            outs.append(tuple(t.to(lead) for t in work(m, dev)))
        return outs
    lead_stream = torch.cuda.current_stream(lead)
    outs, events = [], []
    for m, dev in enumerate(members):
        member_runs[m] += 1
        stream = _member_stream(m, dev)
        ambient = torch.cuda.current_stream(dev)
        stream.wait_stream(lead_stream)  # the shared inputs, made on the lead
        if ambient != lead_stream:
            stream.wait_stream(ambient)  # the member's own refreshed state
        with torch.cuda.stream(stream):
            out = tuple(t.to(lead) for t in work(m, dev))
            events.append(stream.record_event())
        for t in out:
            if t.device == dev:  # no copy: the lead's stream reads the member's block
                t.record_stream(lead_stream)
        outs.append(out)
    for event in events:
        lead_stream.wait_event(event)
    return outs


def merge_members(outs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The members' (scores, global ids) blocks merged in member order
    (``concat_topk``), the tiled ``all_gather`` + ``top_k`` of the
    reference's bodies."""
    return concat_topk([o[0] for o in outs], [o[1] for o in outs], k)


def place_rows(x, members: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` (a tensor or a host array) split along its first axis into one
    equal block a member, each on its member (a view where a tensor's block
    is already there)."""
    n = x.shape[0] // len(members)
    if isinstance(x, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(x[m * n:(m + 1) * n])).to(dev)
                for m, dev in enumerate(members)]
    return [x[m * n:(m + 1) * n].to(dev) for m, dev in enumerate(members)]


def sync_members(members: Sequence[torch.device]) -> None:
    """Wait for every member device: placement made on the building
    thread's streams is complete before any member stream reads it."""
    for dev in dict.fromkeys(members):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the sharded exact top-k
# ---------------------------------------------------------------------------


def sharded_cosine_topk(
    queries: torch.Tensor, matrix: torch.Tensor, valid: torch.Tensor, k: int,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-device exact kNN: ``matrix`` row-sharded over the mesh's
    ``data`` axis (default ``data_mesh`` over ``queries``' device kind),
    each member's top ``min(k, C/n)`` by B1 with its rows made global at
    ``m * C/n``, merged in member order. ``matrix.shape[0]`` must divide by
    the shard count (pad with ``ops.similarity.pad_dim`` and mask with
    ``valid``). Returns (scores [B, k], ids [B, k] int64) on the first
    member."""
    mesh = mesh or data_mesh(device=queries.device)
    members = mesh.members
    n = mesh.shape["data"]
    c = matrix.shape[0]
    if c % n != 0:
        raise ValueError(f"capacity {c} not divisible by {n} shards")
    k = min(k, c)
    rows = c // n
    parts = list(zip(place_rows(matrix, members), place_rows(valid, members)))

    def local(m, dev):
        s, i = fused_cosine_topk(*(to_member(x, dev) for x in (queries, *parts[m])),
                                 min(k, rows))
        return s, i + m * rows

    return merge_members(run_members("cosine_topk", members, local), k)
