"""HTTP embedding providers: Ollama and OpenAI-compatible endpoints
(counterpart of ``nornicdb_tpu/embed/http_providers.py``; the same
payloads, headers and retries).

Ollama: POST /api/embeddings {"model","prompt"} -> {"embedding":[...]};
OpenAI: POST /v1/embeddings {"model","input":[...]} ->
{"data":[{"embedding"}...]} with Bearer auth; both with timeouts and
bounded retries. Providers implement the same Embedder protocol as the
local embedders (embed/embedder.py), so they slot into the embed queue
unchanged. A failure after the retries raises ``EmbedHTTPError``, which
``errors.is_device_fault`` does not count as a device fault: a remote
backend that fails is answered or failed open where the reference does.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence


from nornicdb_tpu_torch.errors import EmbedHTTPError  # noqa: F401 -- re-exported


def _post_json(url: str, payload: Dict[str, Any],
               headers: Optional[Dict[str, str]] = None,
               timeout: float = 30.0, retries: int = 2,
               backoff_s: float = 0.5) -> Dict[str, Any]:
    body = json.dumps(payload).encode("utf-8")
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            req = urllib.request.Request(url, data=body, headers=hdrs,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                raw = resp.read()
            try:
                return json.loads(raw)
            except json.JSONDecodeError as e:
                # a 200 with a non-JSON body (proxy error page) is as
                # transient as a 5xx — retry, then wrap
                if attempt == retries:
                    raise EmbedHTTPError(
                        f"POST {url} returned non-JSON body: "
                        f"{raw[:200]!r}") from e
                last = e
                time.sleep(backoff_s * (attempt + 1))
                continue
        except urllib.error.HTTPError as e:
            # 4xx are permanent (bad model name, auth); 5xx retry
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace")[:300]
            except Exception:
                pass
            if e.code < 500 or attempt == retries:
                raise EmbedHTTPError(
                    f"POST {url} -> HTTP {e.code}: {detail}") from e
            last = e
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            last = e
            if attempt == retries:
                raise EmbedHTTPError(f"POST {url} failed: {e}") from e
        time.sleep(backoff_s * (attempt + 1))
    raise EmbedHTTPError(f"POST {url} failed: {last}")


class OllamaEmbedder:
    """Local Ollama server (reference: embed.go:342 NewOllama; request
    shape ollamaRequest{model,prompt} -> ollamaResponse{embedding})."""

    def __init__(self, base_url: str = "http://localhost:11434",
                 model: str = "nomic-embed-text",
                 timeout: float = 30.0, retries: int = 2):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout = timeout
        self.retries = retries
        self._dims: Optional[int] = None

    def embed(self, text: str) -> List[float]:
        doc = _post_json(
            f"{self.base_url}/api/embeddings",
            {"model": self.model, "prompt": text},
            timeout=self.timeout, retries=self.retries,
        )
        emb = doc.get("embedding")
        if not isinstance(emb, list) or not emb:
            raise EmbedHTTPError(
                f"ollama returned no embedding (model {self.model!r})")
        self._dims = len(emb)
        return [float(x) for x in emb]

    def embed_batch(self, texts: Sequence[str]) -> List[List[float]]:
        return [self.embed(t) for t in texts]

    @property
    def dims(self) -> Optional[int]:
        """Provider dimension, discovered from the first embedding (the
        server owns the model config; None until the first call)."""
        return self._dims


class OpenAIEmbedder:
    """OpenAI-compatible /embeddings endpoint (reference: embed.go:640
    NewOpenAI). Works with any server speaking the same contract
    (vLLM, LM Studio, llama.cpp server, Azure with base_url override)."""

    def __init__(self, api_key: str = "",
                 base_url: str = "https://api.openai.com/v1",
                 model: str = "text-embedding-3-small",
                 timeout: float = 30.0, retries: int = 2,
                 batch_size: int = 128):
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.timeout = timeout
        self.retries = retries
        self.batch_size = max(1, batch_size)
        self._dims: Optional[int] = None

    @property
    def dims(self) -> Optional[int]:
        """Discovered from the first embedding; None until then."""
        return self._dims

    def _headers(self) -> Dict[str, str]:
        h = {}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def embed_batch(self, texts: Sequence[str]) -> List[List[float]]:
        out: List[List[float]] = []
        for i in range(0, len(texts), self.batch_size):
            chunk = list(texts[i:i + self.batch_size])
            doc = _post_json(
                f"{self.base_url}/embeddings",
                {"model": self.model, "input": chunk},
                headers=self._headers(),
                timeout=self.timeout, retries=self.retries,
            )
            data = doc.get("data")
            if not isinstance(data, list) or len(data) != len(chunk):
                raise EmbedHTTPError(
                    f"openai returned {len(data or [])} embeddings for "
                    f"{len(chunk)} inputs")
            # the API may reorder; index field is authoritative
            ordered: List[Optional[List[float]]] = [None] * len(chunk)
            try:
                for item in data:
                    ordered[int(item["index"])] = [
                        float(x) for x in item["embedding"]
                    ]
            except (KeyError, IndexError, TypeError, ValueError) as e:
                raise EmbedHTTPError(
                    f"malformed embedding item in response: {e}") from e
            if any(v is None for v in ordered):
                raise EmbedHTTPError("openai response missing indices")
            out.extend(ordered)  # type: ignore[arg-type]
        if out:
            self._dims = len(out[0])
        return out

    def embed(self, text: str) -> List[float]:
        return self.embed_batch([text])[0]


def make_http_embedder(provider: str, **kw) -> Any:
    """Factory mirroring the reference's NewEmbedder provider switch
    (embed.go:816)."""
    provider = provider.lower()
    if provider == "ollama":
        return OllamaEmbedder(**kw)
    if provider in ("openai", "openai-compatible"):
        return OpenAIEmbedder(**kw)
    raise ValueError(f"unknown embedding provider {provider!r}")
