"""Tokenization + chunking for the embedding pipeline (a copy of
``nornicdb_tpu/embed/tokenizer.py``: the port imports nothing of the JAX
package).

Long documents chunk at 512 tokens with 50-token overlap. The tokenizer
hashes whitespace/punctuation-split subwords into a fixed id space with
blake2s: deterministic and vocabulary-free.
"""

from __future__ import annotations

import hashlib
import re
from typing import List

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

CHUNK_SIZE = 512
CHUNK_OVERLAP = 50


class HashTokenizer:
    """Deterministic hash tokenizer: token -> stable id in [2, vocab)."""

    PAD_ID = 0
    CLS_ID = 1

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def encode(self, text: str, max_len: int = CHUNK_SIZE) -> List[int]:
        ids = [self.CLS_ID]
        for tok in _WORD_RE.findall(text.lower()):
            h = int.from_bytes(
                hashlib.blake2s(tok.encode("utf-8"), digest_size=4).digest(),
                "little",
            )
            ids.append(2 + h % (self.vocab_size - 2))
            if len(ids) >= max_len:
                break
        return ids


def chunk_tokens(
    ids: List[int],
    chunk_size: int = CHUNK_SIZE,
    overlap: int = CHUNK_OVERLAP,
) -> List[List[int]]:
    """Sliding-window chunking (512/50 by default)."""
    if len(ids) <= chunk_size:
        return [ids]
    step = max(chunk_size - overlap, 1)
    chunks = []
    for start in range(0, len(ids), step):
        chunk = ids[start : start + chunk_size]
        if not chunk:
            break
        chunks.append(chunk)
        if start + chunk_size >= len(ids):
            break
    return chunks
