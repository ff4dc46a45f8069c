from nornicdb_tpu_torch.storage.memory import MemoryEngine  # noqa: F401
from nornicdb_tpu_torch.storage.types import (  # noqa: F401
    AlreadyExistsError,
    Engine,
    ListenableEngine,
    MutationListener,
    Node,
    NotFoundError,
)
