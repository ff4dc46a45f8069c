"""Parallelism (counterpart of ``nornicdb_tpu/parallel``): device meshes
and the sharded exact top-k (``mesh.py``); the training half's ring
attention, pipeline and expert parallelism and multi-process helpers
(``ring_attention.py``, ``pipeline.py``, ``multihost.py``) over the
port's collectives and sharded values (``collectives.py``,
``sharding.py``)."""

from nornicdb_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    best_mesh,
    data_mesh,
    devices,
    make_mesh,
    member_devices,
    sharded_cosine_topk,
)
