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
@pytest.mark.parametrize("s", [1, 16, 33, 64, 100, 128, 512])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bf16_kernel_is_deterministic(dev, dtype):
    """Both kernels (the name is the bf16 kernel's, which came first)."""
    q, k, v, mask = _attn_inputs(dev, 7, 64, 4, 40, dtype)
    assert torch.equal(flash_attention(q, k, v, mask), flash_attention(q, k, v, mask))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bf16_kernel_takes_a_misaligned_base(dev, dtype):
    """A contiguous view whose base is not 16-byte aligned is staged into
    an aligned copy for the kernels' 16-byte loads (both kernels; the
    name is the bf16 kernel's, which came first)."""
    q, k, v, mask = _attn_inputs(dev, 8, 33, 4, 40, dtype)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    qm = flat[1:].view(q.shape)
    qm.copy_(q)
    assert qm.data_ptr() % 16 != 0
    assert torch.equal(flash_attention(qm, k, v, mask), flash_attention(q, k, v, mask))


def _fused_pair(dev, n=3000, d=64, seed=5):
    """The same corpus in a fused hybrid tier on the card and on the CPU,
    with exact vector duplicates (cosine ties) and queries on them."""
    from nornicdb_tpu_torch.search.bm25 import BM25Index
    from nornicdb_tpu_torch.search.hybrid_fused import FusedHybrid
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    rng = np.random.default_rng(seed)
    vocab = [f"term{i}" for i in range(64)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(3, 12)))) for _ in range(n)]
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs[n // 2: n // 2 + 50] = vecs[:50]
    tiers = []
    for device in (dev, "cpu"):
        bm25, brute = BM25Index(), BruteForceIndex(device=device)
        for i, text in enumerate(texts):
            bm25.index(f"d{i}", text)
        brute.add_batch([(f"d{i}", vecs[i]) for i in range(n)])
        tier = FusedHybrid(bm25, brute, min_n=1)
        assert tier.build()
        tiers.append(tier)
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(1, 6)))) for _ in range(24)]
    embs = rng.standard_normal((24, d)).astype(np.float32)
    embs[:4] = vecs[:4]
    extras = [{"tokens": tuple(q.split()), "n_cand": 30, "w": (1.0, 1.0)} for q in queries]
    return tiers, embs, extras


def _lists_agree(a, b, atol):
    if len(a) != len(b):
        return False
    return not a or topk_agree([[i for i, _ in a]], [[s for _, s in a]],
                               [[i for i, _ in b]], [[s for _, s in b]], atol)


@pytest.mark.parametrize("b", [1, 24])
def test_fused_hybrid_on_the_card_matches_the_cpu(dev, b):
    """Lexical lists tie-aware within a relative 1e-5 (cuBLAS adds a doc's
    terms in another order), vector lists within 1e-5, and each fused list
    bitwise the host ``rrf_fuse`` of its own two lists."""
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_BRUTE_F32
    from nornicdb_tpu_torch.search.rrf import rrf_fuse

    (card, cpu), embs, extras = _fused_pair(dev)
    before = fused_cosine_topk.launches
    rows = card.search_batch(embs[:b], 32, extras[:b])
    assert fused_cosine_topk.launches == before + 1
    for got, want in zip(rows, cpu.search_batch(embs[:b], 32, extras[:b])):
        assert got["served_by"] == TIER_BRUTE_F32
        top = max([abs(s) for _, s in want["lex"]] or [1.0])
        assert _lists_agree(got["lex"], want["lex"], 1e-5 * max(top, 1.0))
        assert _lists_agree(got["vec"], want["vec"], SCORE_ATOL)
        assert got["fused"] == rrf_fuse([got["lex"], got["vec"]], limit=30)


def test_fused_hybrid_on_the_card_is_deterministic(dev):
    (card, _), embs, extras = _fused_pair(dev, seed=6)
    first = card.search_batch(embs, 32, extras)
    second = card.search_batch(embs, 32, extras)
    for a, b in zip(first, second):
        assert (a["lex"], a["vec"], a["fused"]) == (b["lex"], b["vec"], b["fused"])


def _walk_graph(n=20_000, d=160, seed=11):
    """A CAGRA graph over clustered unit rows, built on the CPU: (matrix,
    adj, validf) padded to the capacity, and queries near stored rows."""
    from nornicdb_tpu_torch.ops.similarity import pad_dim
    from nornicdb_tpu_torch.search.cagra import knn_forward, rank_reorder

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((40, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 40, n)] + rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = pad_dim(n)
    mat = np.zeros((r, d), np.float32)
    mat[:n] = x
    adj = np.zeros((r, 32), np.int32)
    adj[:n] = rank_reorder(knn_forward(torch.from_numpy(x), 32), 32)
    validf = np.zeros(r, np.float32)
    validf[:n] = 1.0
    q = x[rng.integers(0, n, 64)] + 0.3 * rng.standard_normal((64, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return [torch.from_numpy(a) for a in (q, mat, adj, validf)]


@pytest.mark.parametrize("itopk,width", [(64, 1), (128, 8)])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_walk_on_the_card_matches_the_cpu(dev, b, itopk, width):
    """The same graph and queries through ``walk_body`` on the card and on
    the CPU: ids tie-aware, scores within 1e-5 (batched products summed in
    another order)."""
    from nornicdb_tpu_torch.search.cagra import walk_body

    cpu = _walk_graph()
    cpu[0] = cpu[0][:b]
    args = (32, 15, width, itopk, 16, 1024)
    s_c, i_c = walk_body(*cpu, *args)
    s_g, i_g = walk_body(*(t.to(dev) for t in cpu), *args)
    assert s_g.shape == (b, 32) and i_g.dtype == torch.int32
    assert topk_agree(i_g.cpu().numpy(), s_g.cpu().numpy(), i_c.numpy(), s_c.numpy(),
                      SCORE_ATOL)
    again = walk_body(*(t.to(dev) for t in cpu), *args)
    assert torch.equal(again[0], s_g) and torch.equal(again[1], i_g)


def test_knn_forward_launches_b1_per_chunk_and_matches_plain(dev):
    """The graph build's k-NN: one B1 launch per 1,024-row chunk at
    k = 33, each agreeing with the plain version tie-aware."""
    from nornicdb_tpu_torch.search.cagra import knn_forward

    _, mat, _, _ = _walk_graph(n=5000)
    rows = mat[:5000].to(dev)
    valid = torch.ones(5000, dtype=torch.bool, device=dev)
    s_k, i_k = fused_cosine_topk(rows[:1024], rows, valid, 33)
    s_p, i_p = cosine_topk(rows[:1024], rows, valid, 33)
    assert topk_agree(i_k.cpu().numpy(), s_k.cpu().numpy(), i_p.cpu().numpy(),
                      s_p.cpu().numpy(), SCORE_ATOL)
    before = dict(fused_cosine_topk.launch_sizes)
    fwd = knn_forward(rows, 32)
    grew = {b: n - before.get(b, 0) for b, n in fused_cosine_topk.launch_sizes.items()
            if n != before.get(b, 0)}
    assert grew == {1024: 4, 904: 1}
    assert fwd.shape == (5000, 32) and not (fwd == np.arange(5000)[:, None]).any()
    # against the CPU's edges: each rank's cosine agrees within 1e-5, so
    # ids differ only inside float ties
    x = mat[:5000].numpy()
    plain = knn_forward(mat[:5000], 32)
    cos = [np.einsum("nkd,nd->nk", x[f], x) for f in (fwd, plain)]
    assert np.abs(cos[0] - cos[1]).max() <= SCORE_ATOL


def test_device_index_save_and_load_answers_bitwise(dev, tmp_path):
    """A device index saved with dead rows and loaded again (compacted,
    uploaded at once) answers bitwise as before; B1 serves both."""
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((6000, 160)).astype(np.float32)
    vecs[5000:5100] = vecs[:100]  # exact ties across distant rows
    idx = BruteForceIndex(device=dev)
    idx.add_batch([(f"n{i}", v) for i, v in enumerate(vecs)])
    for i in range(100, 400, 3):
        idx.remove(f"n{i}")
    q = np.concatenate([vecs[:8], rng.standard_normal((8, 160))]).astype(np.float32)
    launches = fused_cosine_topk.launches
    before = idx.search_batch(q, 30)
    idx.save(str(tmp_path / "v.npz"))
    loaded = BruteForceIndex.load(str(tmp_path / "v.npz"), device=dev)
    assert loaded._dev_matrix is not None and loaded._dev_matrix.is_cuda
    assert loaded.load_s["upload"] > 0 and len(loaded) == len(idx)
    assert loaded.search_batch(q, 30) == before
    assert fused_cosine_topk.launches == launches + 2


# ---------------------------------------------------------------------------
# the quantized and tiered planes (PyTorch ops on the card)
# ---------------------------------------------------------------------------


def _quant_corpus(n=6000, d=64, seed=21):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, 24, n)] + rng.standard_normal((n, d)).astype(np.float32)
    x[n - 40:] = x[:40]  # exact duplicates: score ties
    q = x[rng.integers(0, n, 64)] + 0.2 * rng.standard_normal((64, d)).astype(np.float32)
    return x, q.astype(np.float32)


def test_int8_encode_on_the_card_is_bitwise_the_cpu(dev):
    from nornicdb_tpu_torch.search.device_quant import int8_encode

    x, _ = _quant_corpus()
    x[3] = 0.0
    for a, b in zip(int8_encode(x, device=dev), int8_encode(x, device="cpu")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["int8", "pq"])
@pytest.mark.parametrize("b,k", [(1, 10), (64, 10), (8, 64)])
def test_quant_plane_on_the_card_matches_the_cpu(dev, mode, b, k):
    """The plane on the card against the same plane on the CPU: the coarse
    top-k on identical codes tie-aware within 1e-5, answers (exact
    reranks) tie-aware within 1e-5; a quant batch never uploads the
    float32 pair."""
    from nornicdb_tpu_torch.search.device_quant import (
        QuantizedBrutePlane,
        _int8_topk_impl,
        _pq_topk_impl,
    )
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    x, q = _quant_corpus()
    planes = []
    for device in (dev, "cpu"):
        idx = BruteForceIndex(device=device)
        idx.add_batch([(f"e{i}", v) for i, v in enumerate(x)])
        plane = QuantizedBrutePlane(idx, mode=mode, build_inline=True)
        assert plane.build()
        planes.append(plane)
    card, cpu = planes
    snap_g, snap_c = card._snap, cpu._snap
    if mode == "pq":
        np.testing.assert_array_equal(snap_g["codebooks"].cpu().numpy(),
                                      snap_c["codebooks"].numpy())
        aux_c = snap_c["codebooks"]
        topk = _pq_topk_impl
    else:
        np.testing.assert_array_equal(snap_g["codes_t"].cpu().numpy(), snap_c["codes_t"].numpy())
        aux_c = snap_c["scale"]
        topk = _int8_topk_impl
    qn = torch.from_numpy(q[:b] / np.linalg.norm(q[:b], axis=1, keepdims=True))
    s_c, i_c = topk(qn, snap_c["codes_t"], aux_c, snap_c["valid"], 128)
    s_g, i_g = topk(qn.to(dev), snap_c["codes_t"].to(dev), aux_c.to(dev),
                    snap_c["valid"].to(dev), 128)
    assert topk_agree(i_g.cpu().numpy(), s_g.cpu().numpy(), i_c.numpy(), s_c.numpy(), SCORE_ATOL)
    got, want = card.search_batch(q[:b], k), cpu.search_batch(q[:b], k)
    hit = np.mean([len({e for e, _ in a} & {e for e, _ in w}) / len(w) for a, w in zip(got, want)])
    assert hit >= (1.0 if mode == "int8" else 0.99)
    if mode == "int8":
        assert all(_lists_agree(a, w, SCORE_ATOL) for a, w in zip(got, want))
    assert card.brute._dev_matrix is None and card.counts["dispatch"] == 1


@pytest.mark.parametrize("b", [1, 64])
def test_tiered_slab_adc_on_the_card_matches_the_cpu(dev, b):
    from nornicdb_tpu_torch.search.device_quant import encode_pq, train_pq
    from nornicdb_tpu_torch.search.tiered_store import _tiered_topk_impl

    x, q = _quant_corpus()
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cb = train_pq(x, 16, 256, device="cpu")
    codes_t = torch.from_numpy(np.ascontiguousarray(encode_pq(x[:4096], cb, device="cpu").T))
    valid = torch.from_numpy(np.random.default_rng(1).random(4096) < 0.9)
    sel = torch.from_numpy(np.random.default_rng(b).random((b, 8)) < 0.5)
    qn = torch.from_numpy(q[:b] / np.linalg.norm(q[:b], axis=1, keepdims=True))
    args = (qn, codes_t, torch.from_numpy(cb), valid, sel)
    s_c, i_c = _tiered_topk_impl(*args, 256)
    s_g, i_g = _tiered_topk_impl(*(a.to(dev) for a in args), 256)
    assert topk_agree(i_g.cpu().numpy(), s_g.cpu().numpy(), i_c.numpy(), s_c.numpy(), SCORE_ATOL)
    slab = i_g.cpu().numpy() // 512
    ok = s_g.cpu().numpy() > -1e29
    assert sel.numpy()[np.arange(b)[:, None].repeat(256, 1)[ok], slab[ok]].all()


@pytest.mark.parametrize("mode", ["int8", "pq"])
@pytest.mark.parametrize("b", [1, 64])
def test_quant_walks_on_the_card_match_the_cpu(dev, mode, b):
    from nornicdb_tpu_torch.search.device_quant import (
        _walk_body_pq,
        _walk_body_quant,
        quantize_graph_base,
    )

    q, mat, adj, validf = _walk_graph()
    base = quantize_graph_base(mat.numpy(), torch.device("cpu"), mode=mode)
    if mode == "int8":
        keys = ("codes", "codes_head", "scale")
        qs = q[:b] @ base["rot_dev"]
        walk, extra = _walk_body_quant, (64, 15, 8, 128, 16, 1024, 192)
    else:
        keys = ("codes", "codebooks")
        qs = q[:b]
        walk, extra = _walk_body_pq, (64, 15, 8, 512, 16, 1024)
    cpu = [qs] + [base[k] for k in keys] + [adj, validf]
    s_c, i_c = walk(*cpu, *extra)
    s_g, i_g = walk(*(t.to(dev) for t in cpu), *extra)
    assert topk_agree(i_g.cpu().numpy(), s_g.cpu().numpy(), i_c.numpy(), s_c.numpy(), SCORE_ATOL)


# -- the background plane's ops (PyTorch ops, no kernel): card vs CPU ---------


def _memory_graph(n=2000, e=6000, seed=5):
    """A random graph in the port's memory engine, as chip_smoke.py phase 9
    builds its own at 100,000 nodes."""
    import random

    from nornicdb_tpu_torch.storage import Edge, MemoryEngine, Node

    rng = random.Random(seed)
    eng = MemoryEngine()
    now = 1_700_000_000_000
    for i in range(n):
        eng.create_node(Node(id=f"n{i}", labels=["T"], properties={"importance": rng.random()},
                             created_at=now - rng.randrange(0, 80 * 86_400_000)))
    for j in range(e):
        eng.create_edge(Edge(id=f"e{j}", type=("KNOWS", "LIKES")[j % 2],
                             start_node=f"n{rng.randrange(n)}", end_node=f"n{rng.randrange(n)}"))
    return eng


def test_decay_scores_on_the_card_match_the_cpu(dev):
    from nornicdb_tpu_torch.ops.decay import decay_scores

    rng = np.random.default_rng(0)
    m = 50_000
    cols = (rng.uniform(0, 8e9, m), rng.choice([6.048e8, 5.9616e9, 5.98752e10], m),
            rng.integers(0, 40, m), rng.random(m), rng.random(m), rng.uniform(0.01, 1, m),
            rng.random(m) < 0.5)
    card = decay_scores(*cols, (0.5, 0.3, 0.2), 1e-3, 1e-1, device=dev)
    cpu = decay_scores(*cols, (0.5, 0.3, 0.2), 1e-3, 1e-1, device="cpu")
    for a, b in zip(card, cpu):
        assert np.max(np.abs(a.astype(np.float64) - b)) <= 1e-6


@pytest.mark.parametrize("method", ["common_neighbors", "adamic_adar", "resource_allocation"])
def test_linkpredict_topk_on_the_card_matches_the_cpu(dev, method):
    from nornicdb_tpu_torch.background.device_plane import BackgroundDevicePlane
    from nornicdb_tpu_torch.ops.linkpredict import linkpredict_topk
    from nornicdb_tpu_torch.query.columnar import ColumnarCatalog

    eng = _memory_graph()
    plane = BackgroundDevicePlane(eng, ColumnarCatalog(eng), device=dev)
    snap = plane._union_snapshot()
    ip, nb, w, _ = plane._device_arrays(snap, method)
    f2 = 1 << (snap["max_deg"] - 1).bit_length()
    for f1 in (8, 16):
        seeds = np.asarray(list(range(0, 2000, 7)) + [-1], np.int64)
        card = linkpredict_topk(seeds, ip, nb, w, snap["n"], f1, f2, 32)
        cpu = linkpredict_topk(seeds, ip.cpu(), nb.cpu(), w.cpu(), snap["n"], f1, f2, 32)
        assert np.array_equal(card[2], cpu[2])
        live = np.isfinite(cpu[0])
        assert np.array_equal(np.isfinite(card[0]), live)
        assert topk_agree(card[1], np.where(live, card[0], -1e30),
                          cpu[1], np.where(live, cpu[0], -1e30), atol=1e-6)


def test_background_plane_on_the_card_equals_the_host_loops(dev):
    from nornicdb_tpu_torch import linkpredict as lp
    from nornicdb_tpu_torch.background.device_plane import BackgroundDevicePlane
    from nornicdb_tpu_torch.decay import DecayManager
    from nornicdb_tpu_torch.ops.fastrp import fastrp_embeddings
    from nornicdb_tpu_torch.query.columnar import ColumnarCatalog

    card_eng, host_eng = _memory_graph(), _memory_graph()
    managers = []
    for eng in (card_eng, host_eng):
        dm = DecayManager(eng, archive_threshold=0.45)
        for i in range(0, 2000, 3):
            dm.record_access(f"n{i}", at_ms=1_700_000_000_000 - i * 1_000_000)
        managers.append(dm)
    cat = ColumnarCatalog(card_eng)
    plane = BackgroundDevicePlane(card_eng, cat, decay=managers[0], device=dev)
    now = 1_700_000_000_000
    assert managers[0].sweep(now) == managers[1].sweep(now)
    seeds = [f"n{i}" for i in range(0, 2000, 9)]
    for method in ("common_neighbors", "adamic_adar", "resource_allocation"):
        got = plane.linkpredict_topk(seeds, method=method, limit=10)
        for s in seeds:
            assert got[s] == lp.predict_links(card_eng, s, method=method, limit=10), (method, s)
    ids, emb = plane.fastrp(dim=64)
    src, dst = plane.fastrp_edges(plane._union_snapshot())
    host = fastrp_embeddings(len(ids), src, dst, dim=64)
    live = np.linalg.norm(host, axis=1) > 1e-9
    assert np.sum(emb[live] * host[live], axis=1).min() > 0.999
    assert plane.counts["decay_sweep_device"] == 1 and plane.counts["fastrp_device"] == 1


# -- the device graph plane --------------------------------------------------------

GRAPH_Q_CHAIN = ("MATCH (p:Person {id: $pid})-[:KNOWS]->(f:Person)<-[:HAS_CREATOR]-(m:Message) "
                 "RETURN f.name, m.content, m.creationDate ORDER BY m.creationDate DESC LIMIT 10")
GRAPH_Q_STRIP = ("MATCH (c:City)<-[:IS_LOCATED_IN]-(p:Person)-[:KNOWS]->(f:Person) "
                 "RETURN c.name, count(f) / count(DISTINCT p) AS avgFriends")
GRAPH_Q_COOC = ("MATCH (t1:Tag)<-[:HAS_TAG]-(m:Message)-[:HAS_TAG]->(t2:Tag) "
                "WHERE t1 <> t2 RETURN t1.name, t2.name, count(m) AS freq")


def _social_graph(n_people=400, n_msgs=1200, knows=6, seed=7):
    """tests/test_device_graph.py's graph shape, larger: creation dates
    repeat every 10 messages (ties the chain merge must order as the
    host does)."""
    import random

    from nornicdb_tpu_torch.storage import Edge, MemoryEngine, NamespacedEngine, Node

    eng = NamespacedEngine(MemoryEngine(), "t")
    rng = random.Random(seed)
    for c in range(6):
        eng.create_node(Node(id=f"c{c}", labels=["City"], properties={"name": f"city{c}"}))
    for t in range(8):
        eng.create_node(Node(id=f"t{t}", labels=["Tag"], properties={"name": f"tag{t}"}))
    for i in range(n_people):
        eng.create_node(Node(id=f"p{i}", labels=["Person"], properties={"id": i, "name": f"p{i}"}))
    seq = iter(range(10 ** 9))
    for i in range(n_people):
        eng.create_edge(Edge(id=f"e{next(seq)}", type="IS_LOCATED_IN", start_node=f"p{i}",
                             end_node=f"c{i % 6}"))
        for j in rng.sample(range(n_people), knows):
            if j != i:
                eng.create_edge(Edge(id=f"e{next(seq)}", type="KNOWS", start_node=f"p{i}",
                                     end_node=f"p{j}"))
    for m in range(n_msgs):
        eng.create_node(Node(id=f"m{m}", labels=["Message"], properties={
            "id": 1000 + m, "content": f"message {m}", "creationDate": 1700000000 + (m % 10) * 37}))
        eng.create_edge(Edge(id=f"e{next(seq)}", type="HAS_CREATOR", start_node=f"m{m}",
                             end_node=f"p{rng.randrange(n_people)}"))
        for t in rng.sample(range(8), rng.randrange(1, 3)):
            eng.create_edge(Edge(id=f"e{next(seq)}", type="HAS_TAG", start_node=f"m{m}",
                                 end_node=f"t{t}"))
    return eng


@pytest.fixture(scope="module")
def social_graph():
    return _social_graph()


@pytest.mark.parametrize("surface", ["chain", "strip", "gram", "rank", "pagerank"])
def test_graph_plane_on_the_card_matches_the_cpu(dev, social_graph, surface, monkeypatch):
    from nornicdb_tpu_torch.ops import graph as tgraph
    from nornicdb_tpu_torch.query.executor import CypherExecutor
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    monkeypatch.setenv("NORNICDB_GRAPH_DEVICE", "on")
    ex = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        ex[name] = CypherExecutor(social_graph, device=d)
        ex[name].enable_query_cache = False
    card, cpu = ex["card"].device_graph, ex["cpu"].device_graph
    if surface == "chain":
        for pid in range(0, 400, 7):
            params = {"pid": pid}
            assert ex["card"].execute(GRAPH_Q_CHAIN, params).rows == \
                ex["cpu"].execute(GRAPH_Q_CHAIN, params).rows
        assert card.dispatches == cpu.dispatches > 0
    elif surface == "strip":
        args = ("IS_LOCATED_IN", "dst", "Person", "KNOWS", "out", "Person")
        a, b = card.build_strip_view(*args), cpu.build_strip_view(*args)
        for name in ("deg", "sum_deg", "nnz"):
            assert np.array_equal(getattr(a, name), getattr(b, name))
        assert sorted(map(repr, ex["card"].execute(GRAPH_Q_STRIP).rows)) == \
            sorted(map(repr, ex["cpu"].execute(GRAPH_Q_STRIP).rows))
    elif surface == "gram":
        inc = ex["cpu"].columnar.incidence("HAS_TAG", "mid_src", "Message", "Tag")[0]
        assert np.array_equal(card.gram_matmul(inc, inc), cpu.gram_matmul(inc, inc))
        assert sorted(map(repr, ex["card"].execute(GRAPH_Q_COOC).rows)) == \
            sorted(map(repr, ex["cpu"].execute(GRAPH_Q_COOC).rows))
    elif surface == "rank":
        cat = ex["cpu"].columnar
        nodes = cat.nodes()
        ids = [nodes[int(r)].id for r in cat.label_rows("Message")]
        rng = np.random.default_rng(3)
        vecs = rng.normal(size=(len(ids), 160)).astype(np.float32)
        idx = {}
        for name, d in (("cpu", "cpu"), ("card", dev)):
            idx[name] = BruteForceIndex(device=d)
            idx[name].add_batch(list(zip(ids, vecs)))
        hops = [("KNOWS", "out"), ("HAS_CREATOR", "in")]
        for b in (1, 16, 64):
            anchors = [int(cat.node_row(f"p{i}")) for i in range(b)]
            q = rng.normal(size=(b, 160)).astype(np.float32)
            got = card.traverse_rank(anchors, hops, q, 10, idx["card"])
            want = cpu.traverse_rank(anchors, hops, q, 10, idx["cpu"])
            host = cpu.traverse_rank_host(anchors, hops, q, 10, idx["cpu"])
            for g, w, h in zip(got, want, host):
                assert len(g) == len(h)
                assert topk_agree([[r for r, _ in g]], [[s for _, s in g]],
                                  [[r for r, _ in h]], [[s for _, s in h]], SCORE_ATOL)
                assert np.allclose([s for _, s in g], [s for _, s in w], atol=SCORE_ATOL)
    else:
        snap = card.pagerank_snapshot()
        n = len(snap["ids"])
        got = tgraph.pagerank_arrays(snap["src"], snap["dst"], n, dev_src=snap["dev_src"],
                                     dev_dst=snap["dev_dst"])
        np.testing.assert_allclose(
            got, tgraph.pagerank_arrays(snap["src"], snap["dst"], n, device="cpu"),
            rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(
            got, tgraph._pagerank_host(snap["src"], snap["dst"], n, 20, 0.85),
            rtol=1e-4, atol=1e-7)
        out_d, in_d = card.degree_counts()
        assert np.array_equal(out_d, np.bincount(snap["src"], minlength=n))
        assert np.array_equal(in_d, np.bincount(snap["dst"], minlength=n))
        assert card.pagerank_snapshot() is snap


def test_apoc_pagerank_on_the_card_matches_the_cpu(dev, social_graph):
    """CALL apoc.algo.pageRank() on a CUDA executor: every node once, the
    scores of the CPU executor's within rtol 1e-4 / atol 1e-7, order
    compared only where the scores differ by more (ROADMAP C28), and a
    second call reuses the plane's snapshot."""
    from nornicdb_tpu_torch.query.executor import CypherExecutor

    q = "CALL apoc.algo.pageRank() YIELD node, score"
    card = CypherExecutor(social_graph, device=dev)
    cpu = CypherExecutor(social_graph, device="cpu")
    got, want = ([(n.id, s) for n, s in ex.execute(q).rows] for ex in (card, cpu))
    assert len(got) == len({r[0] for r in got}) == social_graph.count_nodes()
    want_map = dict(want)
    for nid, score in got:
        assert abs(score - want_map[nid]) <= 1e-7 + 1e-4 * abs(want_map[nid]), nid
    scores = [s for _, s in got]
    assert all(a >= b - (1e-7 + 1e-4 * abs(b)) for a, b in zip(scores, scores[1:]))
    snap = card.device_graph.pagerank_snapshot()
    assert snap["dev_src"].device.type == "cuda"
    card.execute(q)
    assert card.device_graph.pagerank_snapshot() is snap


@pytest.mark.parametrize("n", [3000, 12000])
def test_similar_on_the_card_matches_the_cpu(dev, n):
    """SearchService.similar on a CUDA service: below the HNSW threshold
    (3,000 vectors) it launches B1 at B 1, k = limit + 1; above it
    (12,000) it walks HNSW. Tie-aware ids and scores within 1e-5 of the
    CPU service's, the node itself left out."""
    from nornicdb_tpu_torch.search.service import SearchService
    from nornicdb_tpu_torch.storage import MemoryEngine, Node as TNode

    rng = np.random.default_rng(n)
    vecs = rng.standard_normal((n, 160)).astype(np.float32)  # above the small-host rung
    vecs[n // 2: n // 2 + 50] = vecs[:50]
    svcs = []
    for d in (dev, "cpu"):
        svc = SearchService(MemoryEngine(), device=d)
        for i, v in enumerate(vecs):
            node = TNode(id=f"v{i}", labels=["V"], properties={"content": f"doc {i}"},
                         embedding=v.tolist())
            svc.storage.create_node(node)
            svc.index_node(node)
        svcs.append(svc)
    card, cpu = svcs
    assert card.stats.strategy == cpu.stats.strategy == ("brute" if n < 10_000 else "hnsw")
    before = fused_cosine_topk.launches
    for i in range(0, n, n // 16):
        got, want = card.similar(f"v{i}", 10), cpu.similar(f"v{i}", 10)
        assert f"v{i}" not in {h["id"] for h in got} and len(got) == 10
        assert topk_agree([[h["id"] for h in got]], [[h["score"] for h in got]],
                          [[h["id"] for h in want]], [[h["score"] for h in want]], SCORE_ATOL)
    if n < 10_000:
        assert fused_cosine_topk.launches > before


# ---------------------------------------------------------------------------
# the observability core's device seams (obs/device.py, ROADMAP C30)
# ---------------------------------------------------------------------------


@pytest.fixture
def obs_device(monkeypatch):
    from nornicdb_tpu_torch.obs import device as obs_dev
    from nornicdb_tpu_torch.obs import resources

    monkeypatch.setenv("NORNICDB_DEVICE_TIMING_SAMPLE", "1")
    monkeypatch.setattr(resources, "_objects", {})
    obs_dev.reload()
    obs_dev.reset()
    obs_dev.set_backend_probe(None)
    yield obs_dev
    obs_dev.reset()
    obs_dev.reload()


def test_obs_backend_bytes_is_the_allocators_count(dev, obs_device):
    from nornicdb_tpu_torch.obs import resources
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    rng = np.random.default_rng(3)
    idx = BruteForceIndex(device=dev)
    idx.add_batch([(f"v{i}", rng.standard_normal(64).astype(np.float32))
                   for i in range(20000)])
    idx.search_batch(rng.standard_normal((1, 64)).astype(np.float32), 5)
    resources.register("brute", "cuda-ledger", idx)
    torch.cuda.synchronize(dev)
    assert obs_device.ledger_device() == dev
    assert obs_device.backend_bytes() == float(torch.cuda.memory_allocated(dev))
    rec = obs_device.reconcile()
    assert rec["backend_bytes"] == torch.cuda.memory_allocated(dev)
    assert rec["ledger_bytes"] == idx.resource_stats()["device_bytes"] > 0
    assert rec["drift_bytes"] == rec["backend_bytes"] - rec["ledger_bytes"]


def test_obs_sampled_maybe_sync_waits_for_the_results_stream(dev, obs_device):
    x = torch.ones(1024, device=dev)
    torch.cuda.synchronize(dev)
    done = torch.cuda.Event()
    torch.cuda._sleep(400_000_000)  # ~0.2 s of device time on the current stream
    y = x * 2
    done.record()
    assert not done.query()  # still running: the check below can tell
    assert obs_device.maybe_sync({"rows": [y], "n": 1}) is True
    assert done.query()


_FAULT_PROBE = """
import numpy as np, torch
from nornicdb_tpu_torch.search.microbatch import MicroBatcher
dev = torch.device("cuda")
table = torch.zeros(8, device=dev)

def dispatch(queries, k):
    bad = torch.full((len(queries),), 10**6, dtype=torch.int64, device=dev)
    return [table.index_select(0, bad)]  # out of bounds: a device-side fault

mb = MicroBatcher(dispatch, surface="cuda-fault")
try:
    mb.search(np.ones(4, np.float32), 1)
except Exception as exc:  # the fault must reach the caller
    print("RAISED", type(exc).__name__, str(exc).splitlines()[0])
else:
    print("SWALLOWED")
"""


def test_obs_a_cuda_fault_in_a_bracketed_dispatch_propagates(dev):
    """The fault is asynchronous: it surfaces at the sampled sync inside
    the MicroBatcher's dispatch bracket, and reaches the caller. Run in a
    subprocess: a device-side fault poisons its CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, NORNICDB_DEVICE_TIMING_SAMPLE="1")
    out = subprocess.run([sys.executable, "-c", _FAULT_PROBE], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else out.stderr[-2000:]
    assert last.startswith("RAISED"), last
    assert "CUDA" in last or "device-side" in last, last
