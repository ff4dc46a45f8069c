"""Embedder implementations (counterpart of ``nornicdb_tpu/embed/embedder.py``).

``TorchEncoderEmbedder`` is the local provider over the port's encoder:
token widths pad to power-of-two buckets, up to ``max_batch`` texts ride
one forward, and long texts chunk 512/50 through ``embed_chunks``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Protocol, Sequence

import numpy as np
import torch

from nornicdb_tpu_torch._device import DeviceLike, resolve_device
from nornicdb_tpu_torch.embed.tokenizer import (
    CHUNK_OVERLAP,
    CHUNK_SIZE,
    HashTokenizer,
    chunk_tokens,
)


class Embedder(Protocol):
    dims: int

    def embed(self, text: str) -> List[float]: ...

    def embed_batch(self, texts: Sequence[str]) -> List[List[float]]: ...


class HashEmbedder:
    """Deterministic, dependency-free embedder: token-hash bag of
    features, L2-normalized."""

    def __init__(self, dims: int = 256):
        self.dims = dims
        self._tok = HashTokenizer(vocab_size=1 << 22)

    def embed(self, text: str) -> List[float]:
        v = np.zeros(self.dims, dtype=np.float32)
        ids = self._tok.encode(text, max_len=4096)[1:]  # drop CLS
        for tid in ids:
            v[tid % self.dims] += 1.0
            v[(tid >> 8) % self.dims] += 0.5
        n = np.linalg.norm(v)
        if n > 1e-12:
            v /= n
        return v.tolist()

    def embed_batch(self, texts: Sequence[str]) -> List[List[float]]:
        return [self.embed(t) for t in texts]


class TorchEncoderEmbedder:
    """Local embedder over the port's ``Encoder``.

    - pads token widths to power-of-two buckets (>= 16, capped at
      ``max_len``);
    - batches up to ``max_batch`` texts per forward;
    - ``embed_chunks`` gives per-chunk vectors of long documents (512/50
      windows).
    """

    def __init__(
        self,
        model=None,
        cfg=None,
        max_batch: int = 64,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        from nornicdb_tpu_torch.models.encoder import Encoder, EncoderConfig

        self.device = resolve_device(device)
        if cfg is None:
            cfg = EncoderConfig()
        if model is None:
            model = Encoder(cfg, generator=torch.Generator().manual_seed(seed))
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.dims = cfg.hidden_size
        self.max_batch = max_batch
        self.tokenizer = HashTokenizer(cfg.vocab_size)
        self._lock = threading.Lock()

    @staticmethod
    def _bucket_width(w: int) -> int:
        b = 16
        while b < w:
            b *= 2
        return b

    def _run(self, id_lists: List[List[int]]) -> np.ndarray:
        width = self._bucket_width(max(len(x) for x in id_lists))
        width = min(width, self.cfg.max_len)
        arr = np.zeros((len(id_lists), width), np.int64)
        for i, ids in enumerate(id_lists):
            ids = ids[:width]
            arr[i, : len(ids)] = ids
        with self._lock, torch.inference_mode():
            out = self.model(torch.from_numpy(arr).to(self.device))
            return out.float().cpu().numpy()

    def embed_batch(self, texts: Sequence[str]) -> List[List[float]]:
        out: List[List[float]] = []
        for start in range(0, len(texts), self.max_batch):
            batch = texts[start : start + self.max_batch]
            id_lists = [
                self.tokenizer.encode(t, max_len=self.cfg.max_len) for t in batch
            ]
            out.extend(v.tolist() for v in self._run(id_lists))
        return out

    def embed(self, text: str) -> List[float]:
        return self.embed_batch([text])[0]

    def embed_chunks(self, text: str) -> List[List[float]]:
        """Per-chunk embeddings for long documents (512/50 windows)."""
        ids = self.tokenizer.encode(text, max_len=1_000_000)
        chunks = chunk_tokens(ids, min(CHUNK_SIZE, self.cfg.max_len), CHUNK_OVERLAP)
        vecs: List[List[float]] = []
        for start in range(0, len(chunks), self.max_batch):
            vecs.extend(
                v.tolist() for v in self._run(chunks[start : start + self.max_batch])
            )
        return vecs


class CachedEmbedder:
    """LRU cache decorator over an embedder."""

    def __init__(self, inner: Embedder, capacity: int = 10_000):
        self.inner = inner
        self.capacity = capacity
        self.dims = inner.dims
        self._cache: "OrderedDict[str, List[float]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # the inner chunk path, uncached: chunk texts rarely repeat
        if hasattr(inner, "embed_chunks"):
            self.embed_chunks = inner.embed_chunks

    def embed(self, text: str) -> List[float]:
        with self._lock:
            if text in self._cache:
                self._cache.move_to_end(text)
                self.hits += 1
                return list(self._cache[text])
        v = self.inner.embed(text)
        with self._lock:
            self.misses += 1
            self._cache[text] = list(v)
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
        return v

    def embed_batch(self, texts: Sequence[str]) -> List[List[float]]:
        with self._lock:
            # dedupe: repeated texts cost one forward, not N
            missing = list(dict.fromkeys(t for t in texts if t not in self._cache))
        fresh = dict(zip(missing, self.inner.embed_batch(missing))) if missing else {}
        out = []
        with self._lock:
            self.misses += len(missing)
            for t, v in fresh.items():
                self._cache[t] = list(v)
            for t in texts:
                v = fresh.get(t)
                if v is None:
                    v = self._cache.get(t)
                    if v is None:  # evicted between batches; recompute
                        v = self.inner.embed(t)
                    else:
                        self._cache.move_to_end(t)
                out.append(list(v))
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
        return out
