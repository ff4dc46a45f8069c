"""Multi-process execution: meshes with a leading process axis and
per-process data feeding (counterpart of
``nornicdb_tpu/parallel/multihost.py``).

Every process runs the same program; ``init_distributed`` joins them into
one ``torch.distributed`` group, as ``jax.distributed.initialize`` joins
the reference's. It reads the reference's variables
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
so one launcher's environment starts either package (ROADMAP C36).
Without a coordinator it is a single-process no-op.

``hybrid_mesh`` puts the processes on its leading ``dcn`` axis, so only
reductions over that axis leave a process (the data-parallel gradient
all-reduce); tp/sp stay among a process's own members. In one process the
``dcn`` axis is the local groups of members; across processes its global
size is processes x local groups, process major, and the mesh's members
are this process's devices (``parallel/collectives.py`` says how a
reduction crosses the group).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.parallel.mesh import Mesh, _device_array, devices as _devices
from nornicdb_tpu_torch.parallel.sharding import (
    NamedSharding,
    ShardedTensor,
    _slices,
    device_put,
    place,
)


def _in_group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _group() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) outside one."""
    import torch.distributed as dist

    return (dist.get_rank(), dist.get_world_size()) if _in_group() else (0, 1)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Dict[str, int]:
    """Join the process group at ``tcp://<coordinator_address>``: NCCL when
    the mesh's devices (``devices()``) are CUDA cards, gloo on the CPU.
    Arguments default from the reference's environment variables; with no
    coordinator this is a no-op. Returns the reference's four counts."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address:
        import torch.distributed as dist

        num_processes = int(num_processes or os.environ.get("JAX_NUM_PROCESSES", "1"))
        process_id = int(process_id or os.environ.get("JAX_PROCESS_ID", "0"))
        dev = _devices()[0]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    rank, world = _group()
    local = len(_devices())
    return {"process_index": rank, "process_count": world,
            "local_device_count": local, "global_device_count": local * world}


def hybrid_mesh(ici_axes: Dict[str, int], dcn_axis: str = "dcn",
                devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh with a leading process (DCN) axis and per-process (ICI) axes,
    e.g. ``hybrid_mesh({"tp": 2, "sp": 2})`` over 8 members of one process
    -> Mesh(dcn=2, tp=2, sp=2); over 4 members in each of 2 processes the
    same global shape, each process holding its own ``dcn`` row."""
    devs = list(devices if devices is not None else _devices())
    ici_size = int(np.prod(list(ici_axes.values()), dtype=np.int64))
    if len(devs) % ici_size != 0:
        raise ValueError(f"ici axes {ici_axes} (size {ici_size}) do not divide the "
                         f"{len(devs)} devices per host")
    shape = (len(devs) // ici_size,) + tuple(ici_axes.values())
    rank, world = _group()
    return Mesh(_device_array(devs, shape), (dcn_axis,) + tuple(ici_axes),
                process_axis=dcn_axis, process_index=rank, process_count=world,
                in_process_group=_in_group())


def process_local_batch(mesh: Mesh, local_data: np.ndarray,
                        batch_axis: str = "dcn") -> ShardedTensor:
    """The global batch, sharded over ``batch_axis``, from this process's
    own rows: no process builds the whole batch. In one process
    ``local_data`` is the whole batch."""
    sharding = NamedSharding(mesh, (batch_axis,) + (None,) * (local_data.ndim - 1))
    if mesh.process_count == 1:
        return device_put(local_data, sharding)
    if batch_axis != mesh.process_axis:
        raise ValueError(f"rows split over {batch_axis!r}, not the process axis "
                         f"{mesh.process_axis!r}, need the global batch (device_put)")
    local = torch.from_numpy(np.ascontiguousarray(local_data))
    shape = (local.shape[0] * mesh.process_count,) + tuple(local.shape[1:])
    block = sharding.block_shape(shape)
    first = mesh.process_index * mesh.devices.shape[mesh.axis_names.index(batch_axis)]
    return place(sharding, shape,
                 lambda k: local[_slices((k[0] - first,) + k[1:], block)])


def replicate_to_mesh(mesh: Mesh, value) -> ShardedTensor:
    """``value`` replicated on every member."""
    return device_put(value, NamedSharding(mesh, ()))


def dcn_allreduce_bytes_per_step(param_count: int, dtype_bytes: int = 4,
                                 dcn_size: int = 2) -> Tuple[int, str]:
    """Bytes each host exchanges over DCN per gradient all-reduce (ring:
    2 * (n-1)/n * payload), for capacity planning."""
    payload = param_count * dtype_bytes
    per_host = int(2 * (dcn_size - 1) / dcn_size * payload)
    return per_host, (f"{per_host / 1e6:.1f} MB/host/step over DCN for "
                      f"{param_count / 1e6:.1f}M params at {dtype_bytes}B")
