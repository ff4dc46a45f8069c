from nornicdb_tpu_torch.embed.embedder import (  # noqa: F401
    CachedEmbedder,
    HashEmbedder,
    TorchEncoderEmbedder,
)
from nornicdb_tpu_torch.embed.tokenizer import HashTokenizer, chunk_tokens  # noqa: F401
