"""Heimdall manager: model registry, scheduler and generation API
(counterpart of ``nornicdb_tpu/heimdall/scheduler.py``).

``Manager`` owns a registry of models with device-memory estimates,
loads and evicts them against a budget (the SLM and the vector indexes
share the card), and serves ``generate``, ``generate_stream``, ``chat``
and ``generate_with_tools``. Loading is constructing the backend. The
in-process backend is ``"torch"`` (``TorchGenerator``); ``"jax"`` builds
the same, so a registry written for the reference loads.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

from nornicdb_tpu_torch.heimdall.generators import (
    EchoGenerator,
    Generator,
    Message,
    TorchGenerator,
    render_chat,
)


@dataclass
class ModelSpec:
    """Registry entry, with its device-memory estimate."""

    name: str
    backend: str = "torch"  # torch (or jax, the same) | openai | ollama | echo
    memory_bytes: int = 0  # device-memory estimate; 0 = computed at load
    options: Dict[str, Any] = field(default_factory=dict)
    loaded: bool = False


@dataclass
class GenerationResult:
    text: str
    model: str
    took_ms: float
    tool_calls: List[Dict[str, Any]] = field(default_factory=list)


class Manager:
    """Loads models within a device-memory budget and serves generation."""

    def __init__(self, memory_budget_bytes: int = 2 * 1024**3,
                 rbac_check: Optional[Callable[[Optional[str]], None]] = None):
        self._specs: Dict[str, ModelSpec] = {}
        self._loaded: Dict[str, Generator] = {}
        self._loading: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self.memory_budget = memory_budget_bytes
        self.memory_used = 0
        self._rbac_check = rbac_check
        self._plugins: List[Any] = []
        self.bifrost = None  # optional push channel (set by server wiring)

    # -- registry --------------------------------------------------------

    def register(self, spec: ModelSpec) -> None:
        with self._lock:
            self._specs[spec.name] = spec

    def models(self) -> List[ModelSpec]:
        with self._lock:
            return list(self._specs.values())

    def register_plugin(self, plugin: Any) -> None:
        """Heimdall plugins observe/transform generations."""
        self._plugins.append(plugin)

    # -- load/unload -----------------------------------------------------

    def _build(self, spec: ModelSpec) -> Generator:
        if spec.backend in ("torch", "jax"):
            gen = TorchGenerator(name=spec.name, **spec.options)
            if not spec.memory_bytes:
                spec.memory_bytes = gen.param_bytes()
            return gen
        if spec.backend == "openai":
            from nornicdb_tpu_torch.heimdall.generators import OpenAIGenerator

            return OpenAIGenerator(name=spec.name, **spec.options)
        if spec.backend == "ollama":
            from nornicdb_tpu_torch.heimdall.generators import OllamaGenerator

            return OllamaGenerator(name=spec.name, **spec.options)
        if spec.backend == "echo":
            return EchoGenerator(name=spec.name, **spec.options)
        raise ValueError(f"unknown backend {spec.backend!r}")

    def load(self, name: str) -> Generator:
        # per-name loading latch: two concurrent loads of the same model
        # must not both run _build (the second would allocate the model's
        # device memory again and double-count memory_used — a permanent
        # accounting leak causing spurious evictions)
        while True:
            with self._lock:
                if name in self._loaded:
                    return self._loaded[name]
                latch = self._loading.get(name)
                if latch is None:
                    spec = self._specs.get(name)
                    if spec is None:
                        raise KeyError(f"model {name!r} not registered")
                    latch = threading.Event()
                    self._loading[name] = latch
                    break
            latch.wait()  # another thread is building; retry once it's done
        try:
            gen = self._build(spec)
        except BaseException:
            with self._lock:
                del self._loading[name]
            latch.set()
            raise
        need = spec.memory_bytes
        with self._lock:
            del self._loading[name]
            latch.set()
            # evict least-recently-loaded models until it fits
            while (self.memory_used + need > self.memory_budget
                   and self._loaded):
                evict_name, evicted = next(iter(self._loaded.items()))
                del self._loaded[evict_name]
                self._specs[evict_name].loaded = False
                self.memory_used -= self._specs[evict_name].memory_bytes
            if need > self.memory_budget:
                raise MemoryError(
                    f"model {name!r} needs {need} bytes > budget "
                    f"{self.memory_budget}")
            self._loaded[name] = gen
            spec.loaded = True
            self.memory_used += need
            return gen

    def unload(self, name: str) -> bool:
        with self._lock:
            if name not in self._loaded:
                return False
            del self._loaded[name]
            spec = self._specs[name]
            spec.loaded = False
            self.memory_used -= spec.memory_bytes
            return True

    def _default_model(self) -> str:
        with self._lock:
            if self._loaded:
                return next(iter(self._loaded))
            if self._specs:
                return next(iter(self._specs))
        raise RuntimeError("no models registered")

    # -- generation API ---------------------------------------------------

    def generate(self, prompt: str, model: Optional[str] = None,
                 max_tokens: int = 256, temperature: float = 0.0,
                 user: Optional[str] = None) -> GenerationResult:
        if self._rbac_check is not None:
            self._rbac_check(user)
        name = model or self._default_model()
        gen = self.load(name)
        t0 = time.time()
        text = gen.generate(prompt, max_tokens=max_tokens,
                            temperature=temperature)
        for plugin in self._plugins:
            hook = getattr(plugin, "on_generate", None)
            if hook is not None:
                text = hook(prompt, text) or text
        result = GenerationResult(text=text, model=name,
                                  took_ms=(time.time() - t0) * 1e3)
        if self.bifrost is not None:
            self.bifrost.publish("generation", {
                "model": name, "prompt_chars": len(prompt),
                "output_chars": len(text)})
        return result

    def generate_stream(self, prompt: str, model: Optional[str] = None,
                        max_tokens: int = 256, temperature: float = 0.0,
                        user: Optional[str] = None) -> Iterator[str]:
        if self._rbac_check is not None:
            self._rbac_check(user)
        name = model or self._default_model()
        gen = self.load(name)
        yield from gen.generate_stream(prompt, max_tokens=max_tokens,
                                       temperature=temperature)

    def chat(self, messages: List[Message], model: Optional[str] = None,
             max_tokens: int = 256, temperature: float = 0.0,
             user: Optional[str] = None) -> GenerationResult:
        """OpenAI-compatible chat."""
        return self.generate(render_chat(messages), model=model,
                             max_tokens=max_tokens, temperature=temperature,
                             user=user)

    def generate_with_tools(self, prompt: str, mcp, model: Optional[str] = None,
                            max_rounds: int = 4, max_tokens: int = 256,
                            user: Optional[str] = None) -> GenerationResult:
        """Agentic tool loop executing MCP ops (``heimdall/tools.py``)."""
        from nornicdb_tpu_torch.heimdall.tools import ToolLoop

        if self._rbac_check is not None:
            self._rbac_check(user)
        name = model or self._default_model()
        gen = self.load(name)
        loop = ToolLoop(gen, mcp, bifrost=self.bifrost)
        t0 = time.time()
        text, calls = loop.run(prompt, max_rounds=max_rounds,
                               max_tokens=max_tokens)
        return GenerationResult(text=text, model=name,
                                took_ms=(time.time() - t0) * 1e3,
                                tool_calls=calls)
