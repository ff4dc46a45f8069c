"""nornicdb_tpu_torch — the PyTorch/CUDA port of nornicdb_tpu.

The main path is ``open -> store -> flush -> search/recall``: nodes land
in a storage engine (in memory, or durable in ``open(data_dir)``: the
native KV store or WAL + snapshots, the reference's files byte for
byte), the embed queue embeds them with the committed mini encoder
(flash attention kernel, ``csrc/flash_attention.cu``), and search fuses
BM25 with an exact brute-force cosine top-k (fused top-k kernel,
``csrc/cosine_topk.cu``) by reciprocal rank; with a data dir the indexes
are saved beside the data and loaded on reopen.

Entry points take ``device=None``, meaning ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from nornicdb_tpu_torch._device import resolve_device  # noqa: F401
from nornicdb_tpu_torch.db import DB, open  # noqa: F401,E402
