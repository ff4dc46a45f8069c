from nornicdb_tpu_torch.search.bm25 import BM25Index  # noqa: F401
from nornicdb_tpu_torch.search.rrf import rrf_fuse  # noqa: F401
from nornicdb_tpu_torch.search.service import SearchService  # noqa: F401
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex  # noqa: F401
