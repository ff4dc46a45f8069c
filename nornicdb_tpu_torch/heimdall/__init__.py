"""Heimdall: reasoning SLMs next to the DB (counterpart of
``nornicdb_tpu/heimdall``).

The in-process decoder (``model.py``, with its training in ``train.py``
and LLaMA-class imports in ``hf_import.py``) runs on the card behind
``TorchGenerator``; ``Manager`` registers, loads and serves generators
within a device-memory budget; ``ToolLoop`` lets a model drive MCP tools;
``Bifrost`` pushes events to subscribers.
"""

from nornicdb_tpu_torch.heimdall.scheduler import (
    GenerationResult,
    Manager,
    ModelSpec,
)
from nornicdb_tpu_torch.heimdall.generators import (
    EchoGenerator,
    Generator,
    OllamaGenerator,
    OpenAIGenerator,
    TorchGenerator,
)
from nornicdb_tpu_torch.heimdall.bifrost import Bifrost
from nornicdb_tpu_torch.heimdall.tools import ToolLoop

__all__ = [
    "Bifrost",
    "EchoGenerator",
    "GenerationResult",
    "Generator",
    "Manager",
    "ModelSpec",
    "OllamaGenerator",
    "OpenAIGenerator",
    "TorchGenerator",
    "ToolLoop",
]
