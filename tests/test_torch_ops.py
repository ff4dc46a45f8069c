"""The port's ops (nornicdb_tpu_torch.ops) against the JAX package's, on the
same seeded numpy inputs.

On the CPU each kernel wrapper runs its plain version, so these tests pin
the algorithm and the wrapper's contract; the kernels themselves are held
against the same plain versions on the card (chip_smoke.py phase 3 and
tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nornicdb_tpu.ops import similarity as jsim
from nornicdb_tpu.ops.pallas_attention import flash_attention as j_flash
from nornicdb_tpu.ops.pallas_attention import reference_attention as j_reference
from nornicdb_tpu.ops.pallas_topk import fused_cosine_topk as j_fused
from nornicdb_tpu_torch.ops import similarity as tsim
from nornicdb_tpu_torch.ops.attention import flash_attention, reference_attention
from nornicdb_tpu_torch.ops.topk import MAX_K, fused_cosine_topk, topk_agree

# float32 dot products of unit vectors, summed in another order by XLA
# and by torch: the scores differ in the last bits only
SCORE_ATOL = 1e-5
# softmax attention outputs are convex combinations of unit-normal values
ATTN_ATOL = 1e-5

# one intra-op thread: these tests run beside the suite's other workers on
# shared cores, and timing-sensitive tests there must not be starved
torch.set_num_threads(1)


def _topk_case(seed, c, d, b=8, ties=False, valid_frac=0.9):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((c, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    if ties:
        m[c // 2: c // 2 + 64] = m[:64]  # exact duplicates -> exact ties
    valid = rng.random(c) < valid_frac
    valid[:64] = True
    valid[c // 2: c // 2 + 64] = True
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if ties:
        q[: b // 2] = m[rng.integers(0, 64, b // 2)]
    return q, m, valid


def _torch(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _jax(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("c", [2048, 4096])
@pytest.mark.parametrize("d", [128, 256])
def test_fused_topk_matches_jax(d, c, k, ties):
    q, m, valid = _topk_case(d + c + k, c, d, ties=ties)
    s_t, i_t = (x.numpy() for x in fused_cosine_topk(*_torch(q, m, valid), k))
    assert i_t.dtype == np.int64
    refs = [j_fused(*_jax(q, m, valid), k, interpret=True),
            jsim.cosine_topk_auto(*_jax(q, m, valid), k)]
    for s_r, i_r in refs:
        s_r, i_r = np.asarray(s_r), np.asarray(i_r)
        np.testing.assert_allclose(s_t, s_r, rtol=0, atol=SCORE_ATOL)
        if ties:
            assert topk_agree(i_t, s_t, i_r, s_r, SCORE_ATOL)
        else:
            np.testing.assert_array_equal(i_t, i_r)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("b", [5, 64, 200])
def test_fused_topk_batched_matches_jax(b, ties):
    """The batched regime's B (the card's kernel takes B >= 5 in its tiled
    stage 1): the plain version it is held against agrees with the Pallas
    kernel (interpret mode) and the reference's XLA route."""
    q, m, valid = _topk_case(b + 7, 2048, 128, b=b, ties=ties)
    s_t, i_t = (x.numpy() for x in fused_cosine_topk(*_torch(q, m, valid), 30))
    assert s_t.shape == (b, 30) and i_t.dtype == np.int64
    refs = [j_fused(*_jax(q, m, valid), 30, interpret=True),
            jsim.cosine_topk_auto(*_jax(q, m, valid), 30)]
    for s_r, i_r in refs:
        s_r, i_r = np.asarray(s_r), np.asarray(i_r)
        np.testing.assert_allclose(s_t, s_r, rtol=0, atol=SCORE_ATOL)
        if ties:
            assert topk_agree(i_t, s_t, i_r, s_r, SCORE_ATOL)
        else:
            np.testing.assert_array_equal(i_t, i_r)


def test_exact_ties_take_the_lower_index():
    q, m, valid = _topk_case(1, 1024, 128, b=4, ties=True)
    s, i = fused_cosine_topk(*_torch(q, m, valid), 2)
    # each query equals a row that is duplicated 512 rows later
    assert (i[:2, 0] < 64).all() and (i[:2, 1] >= 512).all()
    assert torch.equal(s[:2, 0], s[:2, 1])


def test_masked_tail_matches_jax_dense():
    """Fewer valid rows than k: the tail carries -1e30 on the lowest
    masked indices, as lax.top_k orders them."""
    q, m, valid = _topk_case(2, 256, 128, b=3, valid_frac=0.0)
    valid[:] = False
    valid[[5, 77, 200]] = True
    s_t, i_t = (x.numpy() for x in fused_cosine_topk(*_torch(q, m, valid), 10))
    s_j, i_j = (np.asarray(x) for x in jsim.cosine_topk(*_jax(q, m, valid), 10))
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=SCORE_ATOL)
    assert (s_t[:, 3:] == -1e30).all()


@pytest.mark.parametrize("k,n_valid", [(10, 4096), (64, 20), (30, 0)])
def test_chunked_matches_jax(k, n_valid):
    q, m, valid = _topk_case(3, 4096, 128, b=5)
    valid[:] = False
    valid[np.random.default_rng(4).choice(4096, n_valid, replace=False)] = True
    s_t, i_t = (x.numpy() for x in tsim.cosine_topk_chunked(*_torch(q, m, valid), k,
                                                             chunk=1024))
    s_j, i_j = (np.asarray(x) for x in jsim.cosine_topk_chunked(*_jax(q, m, valid), k,
                                                                chunk=1024))
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(i_t, i_j)


def test_auto_routes_by_threshold(monkeypatch):
    calls = []
    monkeypatch.setattr(tsim, "CHUNKED_THRESHOLD", 1000)
    monkeypatch.setattr(tsim, "cosine_topk_chunked",
                        lambda *a: calls.append("chunked") or tsim.cosine_topk(*a))
    q, m, valid = _topk_case(5, 2048, 128, b=2)
    tsim.cosine_topk_auto(*_torch(q, m, valid), 5)
    tsim.cosine_topk_auto(*_torch(q, m[:512], valid[:512]), 5)
    assert calls == ["chunked"]


@pytest.mark.parametrize("n", [1, 256, 257, 1000, 70_000])
def test_pad_dim_matches_jax(n):
    assert tsim.pad_dim(n) == jsim.pad_dim(n)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(6).standard_normal((7, 33)).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_allclose(tsim.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jsim.l2_normalize(jnp.asarray(x))),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("kwargs,err", [
    ({"k": 0}, "k must be"),
    ({"bad_valid": True}, "valid must be"),
    ({"bad_d": True}, "must be \\[B, D\\]"),
])
def test_fused_topk_rejects_bad_input(kwargs, err):
    q, m, valid = _torch(*_topk_case(7, 512, 64, b=2))
    if kwargs.get("bad_valid"):
        valid = valid[:-1]
    if kwargs.get("bad_d"):
        q = q[:, :32]
    with pytest.raises(ValueError, match=err):
        fused_cosine_topk(q, m, valid, kwargs.get("k", 5))


@pytest.mark.parametrize("k", [MAX_K + 1, 300, 1000])
def test_wide_k_matches_jax(k):
    """k above the kernel's limit takes the reference's own route above
    its Pallas limit (a matmul plus a stable top-k) and is counted apart
    from kernel launches."""
    q, m, valid = _topk_case(k, 2048, 128, b=3)
    before = (fused_cosine_topk.launches, fused_cosine_topk.wide_k_calls)
    s_t, i_t = (x.numpy() for x in fused_cosine_topk(*_torch(q, m, valid), k))
    assert (fused_cosine_topk.launches, fused_cosine_topk.wide_k_calls) == (
        before[0], before[1] + 1)
    assert s_t.shape == (3, k) and i_t.dtype == np.int64
    for s_r, i_r in (j_fused(*_jax(q, m, valid), k, interpret=True),
                     jsim.cosine_topk_auto(*_jax(q, m, valid), k)):
        s_r, i_r = np.asarray(s_r), np.asarray(i_r)
        np.testing.assert_allclose(s_t, s_r, rtol=0, atol=SCORE_ATOL)
        # a thousand scores per row hold near-ties one float32 ulp apart,
        # which the two sum orders may rank either way: ids are equal up
        # to such swaps
        assert topk_agree(i_t, s_t, i_r, s_r, SCORE_ATOL)
        assert (i_t == i_r).mean() > 0.99


def test_topk_agree_rule():
    ids = np.array([[4, 9, 2]])
    s = np.array([[0.9, 0.5, 0.5]])
    assert topk_agree(ids, s, np.array([[4, 2, 9]]), s, 1e-6)  # swap inside a tie
    assert topk_agree(ids, s, np.array([[4, 9, 7]]), s, 1e-6)  # tie cut at the tail
    assert not topk_agree(ids, s, np.array([[9, 4, 2]]),
                          np.array([[0.9, 0.9, 0.5]]), 1e-6)
    assert not topk_agree(np.array([[4, 8, 2]]), np.array([[0.9, 0.6, 0.5]]),
                          ids, np.array([[0.9, 0.6, 0.5]]), 1e-6)


def _attn_case(seed, b, s, h, dh):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3))
    mask = rng.random((b, s)) > 0.2
    mask[:, 0] = True
    mask[-1, s // 2:] = False  # padded keys
    return q, k, v, mask


@pytest.mark.parametrize("s", [100, 130])
@pytest.mark.parametrize("dh", [40, 64])
def test_flash_attention_matches_jax(dh, s):
    q, k, v, mask = _attn_case(dh + s, 2, s, 4, dh)
    out = flash_attention(*_torch(q, k, v, mask)).numpy()
    assert out.shape == q.shape and out.dtype == np.float32
    j_out = j_flash(*_jax(q, k, v, mask), block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(out, np.asarray(j_out), rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(out, np.asarray(j_reference(*_jax(q, k, v, mask))),
                               rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("dh", [16, 40, 64])
@pytest.mark.parametrize("s", [1, 40])
def test_reference_attention_masked_rows_match_jax(s, dh):
    """The plain version against the JAX package's plain version where a
    batch row has every key masked (a uniform average over its S keys) and
    at S = 1. The Pallas kernel is not the comparison here: it averages
    over its block padding too (ROADMAP, divergences by design)."""
    q, k, v, mask = _attn_case(s + dh, 3, s, 4, dh)
    mask[1] = False
    out = reference_attention(*_torch(q, k, v, mask)).numpy()
    ref = np.asarray(j_reference(*_jax(q, k, v, mask)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0), v[1].shape),
                               rtol=0, atol=ATTN_ATOL)
    np.testing.assert_array_equal(flash_attention(*_torch(q, k, v, mask)).numpy(), out)


def test_flash_attention_without_mask_attends_to_all_keys():
    q, k, v, _ = _attn_case(8, 1, 64, 2, 32)
    full = np.ones((1, 64), bool)
    np.testing.assert_allclose(
        flash_attention(*_torch(q, k, v)).numpy(),
        reference_attention(*_torch(q, k, v, full)).numpy(), rtol=0, atol=0)


def test_flash_attention_bf16_keeps_dtype():
    q, k, v, mask = _attn_case(9, 2, 64, 2, 32)
    qb, kb, vb = (x.to(torch.bfloat16) for x in _torch(q, k, v))
    out = flash_attention(qb, kb, vb, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    j_out = j_reference(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                        jnp.asarray(mask))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_out, np.float32),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("bad", ["shape", "mask"])
def test_flash_attention_rejects_bad_input(bad):
    q, k, v, mask = _torch(*_attn_case(10, 2, 16, 2, 16))
    if bad == "shape":
        k = k[:, :8]
    else:
        mask = mask[:, :8]
    with pytest.raises(ValueError):
        flash_attention(q, k, v, mask)
