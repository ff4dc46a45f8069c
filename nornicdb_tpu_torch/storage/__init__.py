"""Storage: the engine contract and its engines.

The DB's chain is ``base -> [AsyncEngine] -> NamespacedEngine("neo4j")
-> ListenableEngine``, as the reference's; the base is ``MemoryEngine``
without a data dir, else one of two durable engines:

- ``DiskEngine`` (``disk.py``), the native KV store of
  ``csrc/kv_host.cpp``;
- ``DurableEngine`` (``wal_engine.py``), ``MemoryEngine`` + WAL +
  snapshots.

Both write the reference's files byte for byte. ``PartitionStore``
(``partition_store.py``) is the tiered vector plane's disk tier.
``ConstrainedEngine`` (``schema.py``) enforces the schema constraints
that ``apoc.schema.*`` declares.
"""

import glob
import os

from nornicdb_tpu_torch.storage.async_engine import AsyncEngine, FlushResult  # noqa: F401
from nornicdb_tpu_torch.storage.composite import CompositeEngine  # noqa: F401
from nornicdb_tpu_torch.storage.memory import MemoryEngine  # noqa: F401
from nornicdb_tpu_torch.storage.namespaced import DEFAULT_DB, NamespacedEngine  # noqa: F401
from nornicdb_tpu_torch.storage.partition_store import PartitionStore  # noqa: F401
from nornicdb_tpu_torch.storage.schema import (  # noqa: F401
    ConstrainedEngine,
    Constraint,
    ConstraintViolation,
    Receipt,
    ReceiptLedger,
    SchemaManager,
)
from nornicdb_tpu_torch.storage.types import (  # noqa: F401
    AlreadyExistsError,
    Direction,
    Edge,
    Engine,
    EngineDecorator,
    ListenableEngine,
    MutationListener,
    Node,
    NotFoundError,
)
from nornicdb_tpu_torch.storage.wal import WAL, ReplayResult, WALCorruptionError  # noqa: F401
from nornicdb_tpu_torch.storage.wal_engine import DurableEngine, WALEngine  # noqa: F401


def make_persistent_engine(data_dir: str, sync_every_write: bool = False) -> Engine:
    """The durable base engine for ``data_dir``: the format already on
    disk wins (``wal-*.log``/``snapshot-*.bin`` reopen as
    ``DurableEngine``, ``kv/`` as ``DiskEngine``), a dir holding both
    raises, and a fresh dir gets the native engine when its library
    builds, else the Python one. An existing store that fails to open
    raises: corruption must not pass for an empty database."""
    from nornicdb_tpu_torch.storage.disk import DiskEngine, native_available

    has_python_format = bool(
        glob.glob(os.path.join(data_dir, "wal-*.log"))
        or glob.glob(os.path.join(data_dir, "snapshot-*.bin"))
    )
    has_native_format = os.path.isdir(os.path.join(data_dir, "kv"))
    if has_python_format and has_native_format:
        raise RuntimeError(
            f"{data_dir} holds BOTH pure-Python (wal-*/snapshot-*) and "
            "native (kv/) stores; refusing to guess — open explicitly with "
            "engine='python' or engine='native'"
        )
    if has_python_format:
        return DurableEngine(data_dir, sync_every_write=sync_every_write)
    if has_native_format or native_available():
        return DiskEngine(data_dir, sync_every_write=sync_every_write)
    return DurableEngine(data_dir, sync_every_write=sync_every_write)
