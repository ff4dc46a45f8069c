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
# bf16: both sides round to bf16 after f32 sums in another order, so an
# output near a rounding midpoint may land one rounding step apart: 4e-3
# below |out| = 1, one step (2^-7 of its power of two) above
ATTN_BF16_ATOL = 4e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nornicdb_tpu_torch import resolve_device

    return resolve_device("cuda")


def _topk_inputs(dev, seed, c, d, b, valid_frac=0.9, misaligned=False):
    """Unit rows with exact duplicates (score ties across distant rows) and
    queries on duplicated rows; ``misaligned`` puts both bases 4 bytes off
    a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((c, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    n_dup = min(100, c // 4)
    m[c - n_dup:] = m[:n_dup]
    q = m[rng.integers(0, max(n_dup, 1), b)]
    valid = rng.random(c) < valid_frac
    if misaligned:
        q, m = (torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(np.float32))
                .to(dev)[1:].view(x.shape) for x in (q, m))
        assert q.data_ptr() % 16 != 0 and m.data_ptr() % 16 != 0
        return q, m, torch.from_numpy(valid).to(dev)
    return (torch.from_numpy(x).to(dev) for x in (q, m, valid))


# (B, k, D, C, share of valid rows, misaligned bases). B <= 4 takes the
# streaming scan (D = 33 its scalar variant); B >= 5 the register-tiled
# kernel, whose query tile is 16, 32 or 64 wide (narrower for a wide k),
# and whose D % 4 != 0 or misaligned bases copy 4 bytes at a time.
_TOPK_CASES = (
    [(1, 10, 160, 5000, 0.9, False), (2, 30, 160, 5000, 0.9, False),
     (64, 30, 160, 5000, 0.9, False),
     (4, 128, 160, 5000, 0.9, False), (1, 30, 33, 5000, 0.9, False),
     (4, 256, 33, 5000, 0.9, False), (3, 10, 1024, 5000, 0.9, False),
     (7, 256, 160, 5000, 0.9, False)]
    + [(b, k, 160, 5000, 0.9, False) for b in (5, 8, 16, 33, 65, 200, 256)
       for k in (1, 30, 64, 65, 256)]
    + [(b, k, d, 5000, 0.9, False) for d in (33, 1024) for b in (5, 33, 64)
       for k in (30, 256)]
    + [(64, 30, 160, 5000, 0.9, True), (64, 256, 33, 5000, 0.9, True),
       (8, 5, 160, 5, 0.9, False),       # C smaller than the query tile
       (64, 10, 160, 40, 0.9, False),
       (16, 30, 160, 3000, 0.0, False),  # every row masked
       (64, 256, 160, 300, 0.3, False)]  # fewer valid rows than k
)


@pytest.mark.parametrize("b,k,d,c,valid_frac,misaligned", _TOPK_CASES)
def test_cosine_topk_kernel_matches_plain(dev, b, k, d, c, valid_frac, misaligned):
    qt, mt, vt = _topk_inputs(dev, b + k + d + c, c, d, b, valid_frac, misaligned)
    before = fused_cosine_topk.launches
    s_k, i_k = fused_cosine_topk(qt, mt, vt, k)
    assert fused_cosine_topk.launches == before + 1
    assert i_k.dtype == torch.int64 and s_k.shape == (b, min(k, c))
    s_p, i_p = cosine_topk(qt, mt, vt, k)
    assert topk_agree(i_k.cpu().numpy(), s_k.cpu().numpy(),
                      i_p.cpu().numpy(), s_p.cpu().numpy(), SCORE_ATOL)


@pytest.mark.parametrize("b", [1, 4, 8, 64, 256])
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


def _attn_inputs(dev, seed, s, h, dh, dtype):
    """Three batch rows: all keys, a ragged half, and every key masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, s, h, dh)).astype(np.float32))
               .to(dev).to(dtype) for _ in range(3))
    mask = torch.ones((3, s), dtype=torch.bool, device=dev)
    mask[1, (s + 1) // 2:] = False
    mask[2] = False
    return q, k, v, mask


@pytest.mark.parametrize("dh", [16, 40, 64])
@pytest.mark.parametrize("s", [1, 33, 64, 100, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, dtype, s, dh):
    q, k, v, mask = _attn_inputs(dev, s + dh, s, 16 if dh == 64 else 4, dh, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = reference_attention(q, k, v, mask)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= ATTN_ATOL
    else:
        step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=1e-30))) - 7)
        assert (diff <= step.clamp(min=ATTN_BF16_ATOL)).all()


def test_flash_attention_bf16_kernel_is_deterministic(dev):
    q, k, v, mask = _attn_inputs(dev, 7, 64, 4, 40, torch.bfloat16)
    assert torch.equal(flash_attention(q, k, v, mask), flash_attention(q, k, v, mask))


def test_flash_attention_bf16_kernel_takes_a_misaligned_base(dev):
    """A contiguous view whose base is not 16-byte aligned is staged into
    an aligned copy for the kernel's 16-byte loads."""
    q, k, v, mask = _attn_inputs(dev, 8, 33, 4, 40, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    qm = flat[1:].view(q.shape)
    qm.copy_(q)
    assert qm.data_ptr() % 16 != 0
    assert torch.equal(flash_attention(qm, k, v, mask), flash_attention(q, k, v, mask))
