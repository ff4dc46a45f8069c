"""Parallelism: device meshes and the sharded exact top-k (counterpart of
``nornicdb_tpu/parallel``'s serving half; ``parallel/mesh.py``)."""

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
