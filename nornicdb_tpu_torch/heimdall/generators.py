"""Generator backends for Heimdall (counterpart of
``nornicdb_tpu/heimdall/generators.py``).

``TorchGenerator`` is the in-process SLM on the card (the reference's
``JAXGenerator``), beside OpenAI- and Ollama-compatible HTTP backends and
the deterministic ``EchoGenerator`` test double.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Protocol

from nornicdb_tpu_torch._device import DeviceLike

Message = Dict[str, str]  # {"role": ..., "content": ...}


def render_chat(messages: List[Message]) -> str:
    """Flatten a chat transcript into a single prompt."""
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    parts.append("assistant:")
    return "\n".join(parts)


class Generator(Protocol):
    name: str

    def generate(self, prompt: str, max_tokens: int = 256,
                 temperature: float = 0.0) -> str: ...

    def generate_stream(self, prompt: str, max_tokens: int = 256,
                        temperature: float = 0.0) -> Iterator[str]: ...


class EchoGenerator:
    """Deterministic test double; optionally scripted replies."""

    def __init__(self, name: str = "echo",
                 replies: Optional[List[str]] = None):
        self.name = name
        self._replies = list(replies or [])
        self.calls: List[str] = []

    def generate(self, prompt: str, max_tokens: int = 256,
                 temperature: float = 0.0) -> str:
        self.calls.append(prompt)
        if self._replies:
            return self._replies.pop(0)
        return f"echo: {prompt[-200:]}"

    def generate_stream(self, prompt: str, max_tokens: int = 256,
                        temperature: float = 0.0) -> Iterator[str]:
        text = self.generate(prompt, max_tokens, temperature)
        for i in range(0, len(text), 8):
            yield text[i:i + 8]


class TorchGenerator:
    """The in-process SLM on ``device``. Weights resolve in the
    reference's order: explicit params > checkpoint path > an imported
    LLaMA-class model (``NORNICDB_TPU_SLM_DIR``, ``heimdall/hf_import.py``)
    > the committed tiny checkpoint > random init as a last resort."""

    def __init__(self, name: str = "heimdall-slm", cfg=None, params=None,
                 checkpoint: Optional[str] = None, device: DeviceLike = None):
        from nornicdb_tpu_torch.heimdall.model import DecoderModel

        self.name = name
        if params is None and cfg is None and checkpoint is None:
            from nornicdb_tpu_torch.heimdall.hf_import import default_slm_dir

            slm_dir = default_slm_dir()
            if slm_dir is not None:
                from nornicdb_tpu_torch.heimdall.hf_import import HFDecoderModel

                self.model = HFDecoderModel(slm_dir, device=device)
                return
        if params is None:
            from nornicdb_tpu_torch.heimdall.train import (
                default_checkpoint_path,
                load_params,
            )

            # the committed default only applies when the caller didn't
            # pin an architecture: a supplied cfg means "that model"
            path = checkpoint or (
                default_checkpoint_path() if cfg is None else None
            )
            if path is not None:
                try:
                    cfg, params = load_params(path)
                except (OSError, KeyError, ValueError):
                    if checkpoint is not None:
                        raise  # explicit checkpoint must not fail silently
        self.model = DecoderModel(cfg=cfg, params=params, device=device)

    def param_bytes(self) -> int:
        return self.model.param_bytes()

    def generate(self, prompt: str, max_tokens: int = 256,
                 temperature: float = 0.0) -> str:
        return self.model.generate(prompt, max_tokens=max_tokens,
                                   temperature=temperature)

    def generate_stream(self, prompt: str, max_tokens: int = 256,
                        temperature: float = 0.0) -> Iterator[str]:
        # the decode runs to its end; stream in host chunks
        text = self.generate(prompt, max_tokens, temperature)
        for i in range(0, len(text), 16):
            yield text[i:i + 16]


class _HttpGenerator:
    timeout = 60.0
    retries = 1

    def _post(self, url: str, payload: dict, headers: dict) -> dict:
        # the retrying POST of embed/http_providers.py: one HTTP helper
        # for the embedding and the generation backends
        from nornicdb_tpu_torch.embed.http_providers import _post_json

        return _post_json(url, payload, headers=headers,
                          timeout=self.timeout, retries=self.retries)


class OpenAIGenerator(_HttpGenerator):
    """OpenAI-compatible HTTP backend."""

    def __init__(self, base_url: str, model: str, api_key: str = "",
                 name: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.name = name or f"openai:{model}"

    def generate(self, prompt: str, max_tokens: int = 256,
                 temperature: float = 0.0) -> str:
        headers = (
            {"Authorization": f"Bearer {self.api_key}"}
            if self.api_key else {}
        )
        out = self._post(
            f"{self.base_url}/v1/chat/completions",
            {"model": self.model, "max_tokens": max_tokens,
             "temperature": temperature,
             "messages": [{"role": "user", "content": prompt}]},
            headers)
        return out["choices"][0]["message"]["content"]

    def generate_stream(self, prompt: str, max_tokens: int = 256,
                        temperature: float = 0.0) -> Iterator[str]:
        yield self.generate(prompt, max_tokens, temperature)


class OllamaGenerator(_HttpGenerator):
    """Ollama HTTP backend."""

    def __init__(self, base_url: str = "http://127.0.0.1:11434",
                 model: str = "llama3", name: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.name = name or f"ollama:{model}"

    def generate(self, prompt: str, max_tokens: int = 256,
                 temperature: float = 0.0) -> str:
        out = self._post(
            f"{self.base_url}/api/generate",
            {"model": self.model, "prompt": prompt, "stream": False,
             "options": {"num_predict": max_tokens,
                         "temperature": temperature}},
            {})
        return out.get("response", "")

    def generate_stream(self, prompt: str, max_tokens: int = 256,
                        temperature: float = 0.0) -> Iterator[str]:
        yield self.generate(prompt, max_tokens, temperature)
