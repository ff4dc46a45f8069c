"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and
skip without one; run them there with
``python -m pytest -m cuda tests/test_torch_cuda.py``. chip_smoke.py phase
3 holds the same comparisons at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from nornicdb_tpu_torch.ops.attention import flash_attention, reference_attention
from nornicdb_tpu_torch.ops.similarity import cosine_topk
from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree

pytestmark = pytest.mark.cuda

SCORE_ATOL = 1e-5  # float32 sums in another order than cuBLAS
ATTN_ATOL = 2e-5   # float32 softmax sums in another order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nornicdb_tpu_torch import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("b,k", [(1, 10), (7, 256), (64, 30)])
def test_cosine_topk_kernel_matches_plain(dev, b, k):
    rng = np.random.default_rng(b + k)
    m = rng.standard_normal((5000, 160)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    m[4000:4100] = m[:100]
    q = m[rng.integers(0, 100, b)]
    valid = rng.random(5000) < 0.9
    qt, mt, vt = (torch.from_numpy(x).to(dev) for x in (q, m, valid))
    before = fused_cosine_topk.launches
    s_k, i_k = fused_cosine_topk(qt, mt, vt, k)
    assert fused_cosine_topk.launches == before + 1
    s_p, i_p = cosine_topk(qt, mt, vt, k)
    assert topk_agree(i_k.cpu().numpy(), s_k.cpu().numpy(),
                      i_p.cpu().numpy(), s_p.cpu().numpy(), SCORE_ATOL)


@pytest.mark.parametrize("s,h,dh", [(100, 4, 40), (130, 16, 64)])
def test_flash_attention_kernel_matches_plain(dev, s, h, dh):
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, h, dh)).astype(np.float32))
               .to(dev) for _ in range(3))
    mask = torch.ones((2, s), dtype=torch.bool, device=dev)
    mask[1, s // 2:] = False
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention.launches == before + 1
    ref = reference_attention(q, k, v, mask)
    assert (out - ref).abs().max().item() <= ATTN_ATOL
