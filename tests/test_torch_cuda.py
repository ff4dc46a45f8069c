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


def _topk_inputs(dev, seed, c, d, b):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((c, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    m[4000:4100] = m[:100]
    q = m[rng.integers(0, 100, b)]
    valid = rng.random(c) < 0.9
    return (torch.from_numpy(x).to(dev) for x in (q, m, valid))


@pytest.mark.parametrize("b,k,d", [(1, 10, 160), (7, 256, 160), (64, 30, 160),
                                   (2, 30, 160), (4, 128, 160), (1, 30, 33),
                                   (4, 256, 33), (3, 10, 1024)])
def test_cosine_topk_kernel_matches_plain(dev, b, k, d):
    """B <= 4 takes the streaming scan (D = 33 its scalar variant), B >= 5
    the tiled kernel."""
    qt, mt, vt = _topk_inputs(dev, b + k + d, 5000, d, b)
    before = fused_cosine_topk.launches
    s_k, i_k = fused_cosine_topk(qt, mt, vt, k)
    assert fused_cosine_topk.launches == before + 1
    assert i_k.dtype == torch.int64
    s_p, i_p = cosine_topk(qt, mt, vt, k)
    assert topk_agree(i_k.cpu().numpy(), s_k.cpu().numpy(),
                      i_p.cpu().numpy(), s_p.cpu().numpy(), SCORE_ATOL)


@pytest.mark.parametrize("b", [1, 4, 64])
def test_cosine_topk_kernel_is_deterministic(dev, b):
    qt, mt, vt = _topk_inputs(dev, b, 50_000, 160, b)
    first = fused_cosine_topk(qt, mt, vt, 30)
    second = fused_cosine_topk(qt, mt, vt, 30)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_wide_k_takes_the_reference_route(dev):
    qt, mt, vt = _topk_inputs(dev, 300, 5000, 160, 2)
    before = (fused_cosine_topk.launches, fused_cosine_topk.wide_k_calls)
    s_k, i_k = fused_cosine_topk(qt, mt, vt, 300)
    assert (fused_cosine_topk.launches, fused_cosine_topk.wide_k_calls) == (
        before[0], before[1] + 1)
    s_p, i_p = cosine_topk(qt, mt, vt, 300)
    assert s_k.shape == (2, 300)
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
