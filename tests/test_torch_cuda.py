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


@pytest.mark.parametrize("dh", [16, 32, 40, 64])
@pytest.mark.parametrize("s", [1, 16, 33, 64, 100, 128, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, dtype, s, dh):
    # heads: bge-m3-like at Dh 64, MiniLM / bge-small at Dh 32
    q, k, v, mask = _attn_inputs(dev, s + dh, s, {64: 16, 32: 12}.get(dh, 4), dh, dtype)
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


def test_flash_attention_refuses_a_call_that_needs_a_gradient(dev):
    q, k, v, mask = _attn_inputs(dev, 9, 16, 4, 40, torch.float32)
    q.requires_grad_(True)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, mask)
    assert flash_attention.launches == before
    with torch.no_grad():
        out = flash_attention(q, k, v, mask)
    assert out.grad_fn is None and flash_attention.launches == before + 1


def test_flash_attention_refuses_other_head_widths(dev):
    q, k, v, mask = _attn_inputs(dev, 10, 16, 4, 24, torch.float32)
    with pytest.raises(ValueError, match="head dim 24"):
        flash_attention(q, k, v, mask)


def test_decoder_on_the_card_matches_the_cpu(dev):
    """The committed checkpoint's greedy text and prefill logits, card
    against CPU (bf16 both: within 3% of the largest logit)."""
    from nornicdb_tpu_torch.heimdall.model import DecoderModel, forward_full, PAD
    from nornicdb_tpu_torch.heimdall.train import DEFAULT_CORPUS, default_checkpoint_path, load_params

    cfg, tree = load_params(default_checkpoint_path())
    card, cpu = DecoderModel(cfg, tree, device=dev), DecoderModel(cfg, tree, device="cpu")
    for line in DEFAULT_CORPUS:
        prompt = " ".join(line.split()[:3])
        assert card.generate(prompt, 40) == cpu.generate(prompt, 40)
    ids = np.full(cfg.max_seq, PAD, np.int64)
    ids[:20] = np.frombuffer(DEFAULT_CORPUS[0][:20].encode(), np.uint8)
    valid = torch.arange(cfg.max_seq) < 20
    with torch.no_grad():
        got, _ = forward_full(cfg, card.params, torch.from_numpy(ids).to(dev), valid.to(dev))
        want, _ = forward_full(cfg, cpu.params, torch.from_numpy(ids), valid)
    assert (got[:20].cpu() - want[:20]).abs().max() <= 0.03 * want[:20].abs().max()


def test_encoder_train_step_on_the_card_matches_the_cpu(dev):
    """One contrastive step (f32, the einsum attention) from the same
    weights: loss within 1e-5, parameters within 1e-5 but the key bias,
    whose gradient is zero in exact arithmetic (Adam scales its rounding
    noise up to the rate)."""
    import dataclasses

    from nornicdb_tpu_torch.models.encoder import EncoderConfig
    from nornicdb_tpu_torch.models.train import contrastive_train_step, create_train_state

    cfg = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)
    rng = np.random.default_rng(3)
    a, p = (rng.integers(2, cfg.vocab_size, (8, 16)) for _ in range(2))
    a[:, 12:] = 0
    mc, sc = create_train_state(cfg, 0, learning_rate=1e-3, device=dev)
    mh, sh = create_train_state(cfg, 0, learning_rate=1e-3, device="cpu")
    _, lc = contrastive_train_step(mc, sc, a, p)
    _, lh = contrastive_train_step(mh, sh, a, p)
    assert abs(float(lc) - float(lh)) <= 1e-5
    host = mh.state_dict()
    for name, t in mc.state_dict().items():
        tol = 2.1e-3 if name.endswith("attn.key.bias") else 1e-5
        assert (t.cpu() - host[name]).abs().max() <= tol, name


def test_hf_encoder_on_the_card_matches_the_cpu(dev):
    from nornicdb_tpu_torch.models import hf_import as hf

    cfg = hf.HFEncoderConfig(vocab_size=500, hidden_size=64, num_layers=2, num_heads=4,
                             intermediate_size=128, max_position_embeddings=96,
                             type_vocab_size=1, pad_token_id=1, arch="roberta")
    gen = torch.Generator().manual_seed(0)
    state = {k: torch.randn(v.shape, generator=gen) * 0.05 + (1.0 if k.endswith("ln.weight") else 0.0)
             for k, v in hf.HFEncoder(cfg).state_dict().items()}
    ids = torch.from_numpy(np.random.default_rng(1).integers(2, 500, (3, 17)))
    ids[1, 10:] = 1
    got = hf.build_encoder(cfg, state, dev)(ids.to(dev)).cpu()
    want = hf.build_encoder(cfg, state, "cpu")(ids)
    assert (got - want).abs().max() <= 1e-5


def _fused_pair(dev, n=3000, d=64, seed=5, **kw):
    """The same corpus in a fused hybrid tier (``kw`` its options) on the
    card and on the CPU, with exact vector duplicates (cosine ties) and
    queries on them."""
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
        tier = FusedHybrid(bm25, brute, min_n=1, **kw)
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
    # the ledger: the index's device pair and the card's cuBLAS workspaces
    # (a resource since ROADMAP C40)
    workspaces = [e for e in resources.snapshot() if e["family"] == "cublas"]
    assert len(workspaces) == 1 and workspaces[0]["device_bytes"] % (32 << 20) == 0
    assert rec["ledger_bytes"] == idx.resource_stats()["device_bytes"] \
        + workspaces[0]["device_bytes"]
    assert idx.resource_stats()["device_bytes"] > 0
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


# ---------------------------------------------------------------------------
# serving control on the card (admission.py, obs/audit.py, ROADMAP C31)
# ---------------------------------------------------------------------------


_AUDIT_FAULT_PROBE = """
import numpy as np, torch
from nornicdb_tpu_torch.obs import audit
dev = torch.device("cuda")
table = torch.zeros(8, device=dev)

def ref():
    bad = torch.full((4,), 10**6, dtype=torch.int64, device=dev)
    return table.index_select(0, bad).cpu().tolist()  # a device-side fault

def ref_errors():
    child = audit._DROPPED_C.children().get(("ref_error",))
    return child.value if child is not None else 0.0

a = audit.ShadowAuditor(rate=1.0, max_qps=1e9)
before = ref_errors()
assert a.maybe_sample("vector", "vector_brute_f32", ["a"], 1, ref)
try:
    a.flush(timeout_s=30.0)
except RuntimeError as exc:
    print("RAISED", ref_errors() - before, str(exc).splitlines()[0])
else:
    print("SWALLOWED", ref_errors() - before)
"""


def test_audit_a_cuda_fault_in_a_replay_surfaces_at_flush(dev):
    """A replay whose reference launches on the card and faults: the
    auditor raises it at ``flush()`` and counts no ``ref_error`` drop. Run in
    a subprocess: a device-side fault poisons its CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _AUDIT_FAULT_PROBE], cwd=repo,
                         env=dict(os.environ), capture_output=True, text=True, timeout=300)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else out.stderr[-2000:]
    assert last.startswith("RAISED 0.0"), last
    assert "CUDA" in last or "device-side" in last, last


def test_audit_an_exact_vector_replay_on_the_card_scores_parity_one(dev):
    """A vector answer served by the card's brute tier (B1 through the
    batcher), sampled and replayed with ``exact=True`` (B1 at B 1): parity
    1.0, and B1 launched for the replay."""
    from nornicdb_tpu_torch.obs import audit
    from nornicdb_tpu_torch.search.service import SearchService

    rng = np.random.default_rng(17)
    svc = SearchService(device=dev)
    svc.vectors.add_batch([(f"v{i}", rng.standard_normal(160).astype(np.float32))
                           for i in range(20_000)])
    audit.AUDITOR.reset()
    audit.AUDITOR.set_sample_rate(1.0)
    try:
        launches0 = fused_cosine_topk.launches
        for _ in range(8):
            svc.vector_search_candidates(rng.standard_normal(160).astype(np.float32), 10)
        audit.AUDITOR.flush(timeout_s=30.0)
        summ = audit.AUDITOR.summary()
    finally:
        audit.AUDITOR.set_sample_rate(None)
        audit.AUDITOR.reset()
    tier = summ["tiers"]["vector:vector_brute_f32"]
    assert summ["sampled"] == 8 and summ["mismatches"] == 0
    assert tier["parity"] == 1.0
    assert fused_cosine_topk.launches - launches0 == 16  # 8 served, 8 replays


def test_admission_degrade_steps_the_walk_down_on_the_card(dev, monkeypatch):
    """Under the ``degrade`` posture the fused tier's walk steps down to the
    exact tier on the card (ledger reason ``admission``), and its answers
    equal the exact tier's."""
    from nornicdb_tpu_torch import admission
    from nornicdb_tpu_torch.obs import audit
    from nornicdb_tpu_torch.search.bm25 import BM25Index, tokenize
    from nornicdb_tpu_torch.search.hybrid_fused import FusedHybrid
    from nornicdb_tpu_torch.search.microbatch import pow2_bucket
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    rng = np.random.default_rng(5)
    vocab = [f"term{i}" for i in range(64)]
    centers = rng.standard_normal((16, 64)).astype(np.float32) * 2.0
    bm25, brute = BM25Index(), BruteForceIndex(device=dev)
    for i in range(6000):
        bm25.index(f"d{i}", " ".join(rng.choice(vocab, size=6)))
        brute.add(f"d{i}", centers[i % 16] + rng.standard_normal(64).astype(np.float32))
    walk = FusedHybrid(bm25, brute, min_n=1, walk_min_n=1000, build_inline=True)
    exact = FusedHybrid(bm25, brute, min_n=1, walk_min_n=None, build_inline=True)
    assert walk.build() and exact.build() and walk.cagra.build()
    extras = [{"tokens": tokenize(f"term{i} term{i + 3}"), "n_cand": 30, "w": (1.0, 1.0)}
              for i in range(8)]
    embs = centers[:8] + 0.3 * rng.standard_normal((8, 64)).astype(np.float32)
    kq = pow2_bucket(30)
    assert all(r["served_by"] == "hybrid_walk_f32" for r in walk.search_batch(embs, kq, extras))
    admission.CONTROLLER.reset()
    monkeypatch.setattr(admission.CONTROLLER, "refresh", lambda now=None, force=False: "degrade")
    monkeypatch.setattr(admission.CONTROLLER, "posture", "degrade")
    n0 = audit.LEDGER.recorded
    held = walk.search_batch(embs, kq, extras)
    want = exact.search_batch(embs, kq, extras)
    assert [r["served_by"] for r in held] == ["hybrid_brute_f32"] * 8
    assert [r["fused"] for r in held] == [r["fused"] for r in want]
    recs = audit.LEDGER.snapshot(limit=audit.LEDGER.recorded - n0)
    assert [(r["from_tier"], r["reason"]) for r in recs] == [("hybrid_walk_f32", "admission")]
    assert walk.counts["walk_admission"] == 1


# ---------------------------------------------------------------------------
# the single-device shard layouts (NORNICDB_*_SHARDS) on the card
# ---------------------------------------------------------------------------


def _cpu_copy(x):
    """A snapshot, graph or argument tuple with every tensor on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu_copy(v) for v in x)
    return x


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_device_bm25_on_the_card_matches_the_cpu(dev, s):
    from nornicdb_tpu_torch.search.bm25 import BM25Index, tokenize
    from nornicdb_tpu_torch.search.device_bm25 import DeviceBM25, topk_shards

    rng = np.random.default_rng(s)
    vocab = [f"term{i}" for i in range(64)]
    bm25 = BM25Index()
    for i in range(5000):
        bm25.index(f"d{i}", " ".join(rng.choice(vocab, size=int(rng.integers(3, 12)))))
    card = DeviceBM25(bm25, n_shards=s, min_n=1, device=dev)
    assert card.build() and card._snap["shards"] == s
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(1, 6)))) for _ in range(16)]
    args = card.device_args(card._snap, *card.plan(card._snap, [tokenize(q) for q in queries]))
    s_g, i_g = topk_shards(card._snap, args, 32)
    s_c, i_c = topk_shards(_cpu_copy(card._snap), _cpu_copy(args), 32)
    top = float(s_c[s_c > -1e29].abs().max())
    assert topk_agree(i_g.cpu().numpy(), s_g.cpu().numpy(), i_c.numpy(), s_c.numpy(),
                      1e-5 * max(top, 1.0))
    cpu = DeviceBM25(bm25, n_shards=s, min_n=1, device="cpu")
    assert cpu.build()
    for got, want in zip(card.search_batch(queries, 20), cpu.search_batch(queries, 20)):
        top = max([abs(x) for _, x in want] or [1.0])
        assert _lists_agree(got, want, 1e-5 * max(top, 1.0))


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("b", [1, 24])
def test_sharded_exact_tier_on_the_card_matches_the_cpu(dev, s, b):
    """One B1 launch a vector shard a dispatch; lists as the one-shard
    card test holds them."""
    from nornicdb_tpu_torch.search.hybrid_fused import TIER_BRUTE_F32
    from nornicdb_tpu_torch.search.rrf import rrf_fuse

    (card, cpu), embs, extras = _fused_pair(dev, n_shards=s)
    assert card.lex._snap["shards"] == s
    before = fused_cosine_topk.launches
    rows = card.search_batch(embs[:b], 32, extras[:b])
    assert fused_cosine_topk.launches == before + s
    for got, want in zip(rows, cpu.search_batch(embs[:b], 32, extras[:b])):
        assert got["served_by"] == TIER_BRUTE_F32
        top = max([abs(x) for _, x in want["lex"]] or [1.0])
        assert _lists_agree(got["lex"], want["lex"], 1e-5 * max(top, 1.0))
        assert _lists_agree(got["vec"], want["vec"], SCORE_ATOL)
        assert got["fused"] == rrf_fuse([got["lex"], got["vec"]], limit=30)


def test_sharded_walks_on_the_card_match_the_cpu(dev):
    """A 2-shard graph built on the card (B1 k-NN per shard, one launch a
    1,024-row chunk), walked by ``_walk_shards_single_device`` and by the
    fused tier's ``_walk_shard_loop``, against the same graph on the CPU:
    ids tie-aware, scores within 1e-5."""
    from nornicdb_tpu_torch.ops.similarity import l2_normalize
    from nornicdb_tpu_torch.search.bm25 import tokenize
    from nornicdb_tpu_torch.search.cagra import CagraIndex
    from nornicdb_tpu_torch.search.hybrid_fused import FusedHybrid

    (tier, _), embs, extras = _fused_pair(dev, n=6000, n_shards=2, walk_min_n=1000)
    before = fused_cosine_topk.launches
    g = tier.cagra.ensure_graph()
    assert g["shards"] == 2 and fused_cosine_topk.launches == before + 2 * 3
    cg = tier.cagra
    qn = l2_normalize(torch.from_numpy(embs).to(dev))
    args = (32, g["iters"], cg.search_width, cg.itopk)
    s_g, i_g = cg._walk_shards_single_device(g, qn, *args)
    s_c, i_c = CagraIndex._walk_shards_single_device(cg, _cpu_copy(g), qn.cpu(), *args)
    assert topk_agree(i_g.cpu().numpy(), s_g.cpu().numpy(), i_c.numpy(), s_c.numpy(),
                      SCORE_ATOL)
    snap = tier.lex._snap
    lex_args = tier.lex.device_args(snap, *tier.lex.plan(snap, [e["tokens"] for e in extras]))
    tail = (torch.full((24,), 30, device=dev), torch.ones(24, device=dev),
            torch.ones(24, device=dev))
    wctx = {"iters": g["iters"], "width": cg.search_width, "itopk": cg.itopk,
            "hash_bits": cg.hash_bits, "n_seeds": cg.n_seeds}
    l2g = tier._ensure_walk_map(snap, g)
    out_g = tier._walk_shard_loop(snap, g, lex_args, l2g, qn, tail, cg.itopk, wctx)
    out_c = FusedHybrid._walk_shard_loop(tier, _cpu_copy(snap), _cpu_copy(g), _cpu_copy(lex_args),
                                         l2g.cpu(), qn.cpu(), _cpu_copy(tail), cg.itopk, wctx)
    ls_g, lg_g, vs_g, vi_g = (x.cpu().numpy() for x in out_g[:4])
    ls_c, lg_c, vs_c, vi_c = (x.numpy() for x in out_c[:4])
    top = float(np.abs(ls_c[ls_c > -1e29]).max())
    assert topk_agree(lg_g, ls_g, lg_c, ls_c, 1e-5 * max(top, 1.0))
    assert topk_agree(vi_g, vs_g, vi_c, vs_c, SCORE_ATOL)
    rows = tier.search_batch(embs, cg.itopk, extras)
    assert all(r["served_by"] == "hybrid_walk_f32" for r in rows)
    assert tier.counts["walk_dispatch"] == 1


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_int8_plane_on_the_card_matches_the_cpu(dev, s):
    from nornicdb_tpu_torch.search.device_quant import QuantizedBrutePlane, int8_topk_shards
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    x, q = _quant_corpus()
    planes = []
    for device in (dev, "cpu"):
        idx = BruteForceIndex(device=device)
        idx.add_batch([(f"e{i}", v) for i, v in enumerate(x)])
        plane = QuantizedBrutePlane(idx, mode="int8", n_shards=s, build_inline=True)
        assert plane.build() and plane._snap["shards"] == s
        planes.append(plane)
    card, cpu = planes
    snap = cpu._snap
    qn = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True))
    cols = (snap["codes_t"], snap["scale"], snap["valid"])
    s_c, i_c = int8_topk_shards(qn, *cols, 128, s)
    s_g, i_g = int8_topk_shards(qn.to(dev), *(t.to(dev) for t in cols), 128, s)
    assert topk_agree(i_g.cpu().numpy(), s_g.cpu().numpy(), i_c.numpy(), s_c.numpy(), SCORE_ATOL)
    for got, want in zip(card.search_batch(q, 10), cpu.search_batch(q, 10)):
        assert _lists_agree(got, want, SCORE_ATOL)
    assert card.counts["dispatch"] == 1 and card.brute._dev_matrix is None


_SHARD_FAULT_PROBE = """
import numpy as np, torch
from nornicdb_tpu_torch.search import hybrid_fused
from nornicdb_tpu_torch.search.bm25 import BM25Index
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex
dev = torch.device("cuda")
rng = np.random.default_rng(3)
vocab = [f"term{i}" for i in range(64)]
bm25, brute = BM25Index(), BruteForceIndex(device=dev)
for i in range(3000):
    bm25.index(f"d{i}", " ".join(rng.choice(vocab, size=6)))
brute.add_batch([(f"d{i}", rng.standard_normal(64).astype(np.float32)) for i in range(3000)])
tier = hybrid_fused.FusedHybrid(bm25, brute, n_shards=2, min_n=1)
assert tier.build()
real, calls = hybrid_fused.fused_cosine_topk, []

def faulting(q, m, valid, k):
    calls.append(1)
    if len(calls) == 2:  # the second shard's launch reads out of bounds
        bad = torch.full((4,), 10**9, dtype=torch.int64, device=q.device)
        m.index_select(0, bad)
    return real(q, m, valid, k)

hybrid_fused.fused_cosine_topk = faulting
extras = [{"tokens": ("term1", "term2"), "n_cand": 10, "w": (1.0, 1.0)}]
try:
    rows = tier.search_batch(rng.standard_normal((1, 64)).astype(np.float32), 16, extras)
    torch.cuda.synchronize()
except Exception as exc:  # the fault must reach the caller
    served = sorted(k for k in tier.counts if k != "join_full")  # the join map's derivation
    print("RAISED", len(calls), served, str(exc).splitlines()[0])
else:
    print("SWALLOWED", rows)
"""


def test_a_cuda_fault_inside_a_sharded_dispatch_propagates(dev):
    """A device-side fault in the second vector shard of the exact tier's
    loop reaches the caller of ``search_batch``: no hand-off, no step down,
    nothing served (the only count is the join map's derivation).
    Run in a subprocess: a device-side fault poisons its CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _SHARD_FAULT_PROBE], cwd=repo,
                         env=dict(os.environ), capture_output=True, text=True, timeout=300)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else out.stderr[-2000:]
    assert last.startswith("RAISED 2 []"), last
    assert "CUDA" in last or "device-side" in last, last


# ---------------------------------------------------------------------------
# the serving mesh: two members on the one card, and the wrappers' streams
# ---------------------------------------------------------------------------


def _corpus_indexes(dev, n, d=64, seed=5):
    """A BM25 index and a brute index on ``dev`` over one seeded corpus,
    with exact vector duplicates (cosine ties)."""
    from nornicdb_tpu_torch.search.bm25 import BM25Index
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    rng = np.random.default_rng(seed)
    vocab = [f"term{i}" for i in range(64)]
    bm25, brute = BM25Index(), BruteForceIndex(device=dev)
    for i in range(n):
        bm25.index(f"d{i}", " ".join(rng.choice(vocab, size=int(rng.integers(3, 12)))))
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs[n // 2: n // 2 + 50] = vecs[:50]
    brute.add_batch([(f"d{i}", vecs[i]) for i in range(n)])
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(1, 6)))) for _ in range(24)]
    embs = rng.standard_normal((24, d)).astype(np.float32)
    embs[:4] = vecs[:4]
    extras = [{"tokens": tuple(q.split()), "n_cand": 30, "w": (1.0, 1.0)} for q in queries]
    return bm25, brute, queries, embs, extras


def _fused_tier(bm25, brute, **kw):
    """A 2-shard fused tier with its snapshot (and its graph, with
    ``walk_min_n``) built."""
    from nornicdb_tpu_torch.search.hybrid_fused import FusedHybrid

    tier = FusedHybrid(bm25, brute, n_shards=2, min_n=1, **kw)
    assert tier.build() and (tier.cagra is None or tier.cagra.build())
    return tier


@pytest.mark.parametrize("tier", ["cosine_topk", "bm25", "exact", "walk", "cagra", "int8"])
def test_mesh_of_two_members_on_one_card_is_bitwise_the_loop(dev, tier):
    """Each mesh body with both members on the card (two streams) against
    the single-device loop over the same layout: ids and scores bitwise,
    one mesh dispatch a batch, one B1 launch a member where B1 runs."""
    from nornicdb_tpu_torch.parallel import mesh
    from nornicdb_tpu_torch.search.cagra import CagraIndex
    from nornicdb_tpu_torch.search.device_bm25 import DeviceBM25, topk_mesh, topk_shards
    from nornicdb_tpu_torch.search.device_quant import (
        QuantizedBrutePlane,
        int8_topk_mesh,
        int8_topk_shards,
    )

    n = 6000 if tier in ("walk", "cagra") else 3000
    bm25, brute, queries, embs, extras = _corpus_indexes(dev, n)
    members = [torch.device("cuda", torch.cuda.current_device())] * 2
    kinds = {"cosine_topk": "cosine_topk", "bm25": "bm25", "exact": "hybrid_fused",
             "walk": "hybrid_walk", "cagra": "cagra_walk", "int8": "int8"}
    before = mesh.counts[kinds[tier]]
    if tier == "cosine_topk":
        m, valid = brute.device_view()[:2]
        qn = torch.nn.functional.normalize(torch.from_numpy(embs).to(dev), dim=1)
        launches = fused_cosine_topk.launches
        with mesh.member_devices(members):
            got = mesh.sharded_cosine_topk(qn, m, valid, 32)
        assert fused_cosine_topk.launches == launches + 2
        rows = m.shape[0] // 2
        parts = [fused_cosine_topk(qn, m[sh * rows:(sh + 1) * rows],
                                   valid[sh * rows:(sh + 1) * rows], 32) for sh in range(2)]
        from nornicdb_tpu_torch.ops.similarity import concat_topk

        want = concat_topk([p[0] for p in parts], [p[1] + sh * rows for sh, p in enumerate(parts)],
                           32)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    elif tier == "bm25":
        loop = DeviceBM25(bm25, n_shards=2, min_n=1, device=dev)
        assert loop.build()
        with mesh.member_devices(members):
            placed = DeviceBM25(bm25, n_shards=2, min_n=1, device=dev)
            assert placed.build() and placed._snap["members"] == members
            assert placed.search_batch(queries, 20) == loop.search_batch(queries, 20)
            plan = placed.plan(placed._snap, [tuple(q.split()) for q in queries])
            got = topk_mesh(placed._snap, plan, 32)
        want = topk_shards(loop._snap, loop.device_args(loop._snap, *plan), 32)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    elif tier in ("exact", "walk"):
        kw = {"walk_min_n": 1000} if tier == "walk" else {}
        loop = _fused_tier(bm25, brute, **kw)
        with mesh.member_devices(members):
            placed = _fused_tier(bm25, brute, **kw)
            assert placed.lex._snap["members"] == members
            launches = fused_cosine_topk.launches
            got = placed.search_batch(embs, 32, extras)
            assert fused_cosine_topk.launches == launches + (2 if tier == "exact" else 0)
        want = loop.search_batch(embs, 32, extras)
        served = "hybrid_brute_f32" if tier == "exact" else "hybrid_walk_f32"
        assert all(r["served_by"] == served for r in got)
        assert [(r["lex"], r["vec"], r["fused"]) for r in got] == \
            [(r["lex"], r["vec"], r["fused"]) for r in want]
    elif tier == "cagra":
        loop = CagraIndex(brute=brute, n_shards=2, min_n=1000)
        assert loop.build()
        with mesh.member_devices(members):
            placed = CagraIndex(brute=brute, n_shards=2, min_n=1000)
            assert placed.build() and placed._graph["members"] == members
            for a, b in zip(placed._graph["shard_slices"], loop._graph["shard_slices"]):
                assert all(torch.equal(x, y) for x, y in zip(a, b))  # the same graphs
            assert placed.search_batch(embs, 10) == loop.search_batch(embs, 10)
    else:
        loop = QuantizedBrutePlane(brute, mode="int8", n_shards=2, build_inline=True)
        assert loop.build()
        with mesh.member_devices(members):
            placed = QuantizedBrutePlane(brute, mode="int8", n_shards=2, build_inline=True)
            assert placed.build() and placed._snap["members"] == members
            assert placed.search_batch(embs, 10) == loop.search_batch(embs, 10)
            qn = torch.nn.functional.normalize(torch.from_numpy(embs).to(dev), dim=1)
            snap, lsnap = placed._snap, loop._snap
            got = int8_topk_mesh(qn, snap["codes_t"], snap["scale"], snap["valid"], 128, members)
        want = int8_topk_shards(qn, lsnap["codes_t"], lsnap["scale"], lsnap["valid"], 128, 2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert mesh.counts[kinds[tier]] > before


_MESH_FAULT_PROBE = """
import numpy as np, torch
from nornicdb_tpu_torch.parallel import mesh
from nornicdb_tpu_torch.search import hybrid_fused
from nornicdb_tpu_torch.search.bm25 import BM25Index
from nornicdb_tpu_torch.search.vector_index import BruteForceIndex
dev = torch.device("cuda", 0)
rng = np.random.default_rng(3)
vocab = [f"term{i}" for i in range(64)]
bm25, brute = BM25Index(), BruteForceIndex(device=dev)
for i in range(3000):
    bm25.index(f"d{i}", " ".join(rng.choice(vocab, size=6)))
brute.add_batch([(f"d{i}", rng.standard_normal(64).astype(np.float32)) for i in range(3000)])
with mesh.member_devices([dev, dev]):
    tier = hybrid_fused.FusedHybrid(bm25, brute, n_shards=2, min_n=1)
    assert tier.build() and "members" in tier.lex._snap
    real, calls = hybrid_fused.fused_cosine_topk, []

    def faulting(q, m, valid, k):
        calls.append(1)
        if len(calls) == 2:  # the second member's launch reads out of bounds
            bad = torch.full((4,), 10**9, dtype=torch.int64, device=q.device)
            m.index_select(0, bad)
        return real(q, m, valid, k)

    hybrid_fused.fused_cosine_topk = faulting
    extras = [{"tokens": ("term1", "term2"), "n_cand": 10, "w": (1.0, 1.0)}]
    try:
        rows = tier.search_batch(rng.standard_normal((1, 64)).astype(np.float32), 16, extras)
        torch.cuda.synchronize()
    except Exception as exc:  # the fault must reach the caller
        served = sorted(k for k in tier.counts if k != "join_full")  # the join map's derivation
        print("RAISED", len(calls), mesh.counts["hybrid_fused"], served,
              str(exc).splitlines()[0])
    else:
        print("SWALLOWED", rows)
"""


def test_a_cuda_fault_inside_one_members_dispatch_propagates(dev):
    """A device-side fault in the second member's B1 call of the exact
    tier's mesh body reaches the caller of ``search_batch``: no hand-off,
    no step down, nothing served. Run in a subprocess: a device-side fault
    poisons its CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _MESH_FAULT_PROBE], cwd=repo,
                         env=dict(os.environ), capture_output=True, text=True, timeout=300)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else out.stderr[-2000:]
    assert last.startswith("RAISED 2 1 []"), last
    assert "CUDA" in last or "device-side" in last, last


@pytest.mark.parametrize("kernel", ["cosine_topk", "flash_attention"])
def test_mesh_kernel_launches_order_with_the_callers_stream(dev, kernel):
    """B1 and B2 launched inside ``torch.cuda.stream(side)`` while another
    stream was current run on ``side``: after a long sleep on ``side`` that
    is followed by the write of their inputs there, they read the written
    inputs (a launch on any other stream would read the zeros)."""
    rng = np.random.default_rng(9)
    other, side = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    if kernel == "cosine_topk":
        m = torch.nn.functional.normalize(
            torch.from_numpy(rng.standard_normal((20000, 64)).astype(np.float32)).to(dev), dim=1)
        valid = torch.ones(20000, dtype=torch.bool, device=dev)
        real = m[:8].clone()
        want = cosine_topk(real, m, valid, 16)
    else:
        real = torch.from_numpy(rng.standard_normal((2, 64, 4, 40)).astype(np.float32)).to(dev)
        mask = torch.ones((2, 64), dtype=torch.bool, device=dev)
        want = reference_attention(real, real, real, mask)
    x = torch.zeros_like(real)
    torch.cuda.synchronize()
    with torch.cuda.stream(other):
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the side stream's clock
            x.copy_(real)
            with torch.no_grad():
                got = (fused_cosine_topk(x, m, valid, 16) if kernel == "cosine_topk"
                       else flash_attention(x, x, x, mask))
    torch.cuda.synchronize()
    if kernel == "cosine_topk":
        assert topk_agree(got[1].cpu().numpy(), got[0].cpu().numpy(), want[1].cpu().numpy(),
                          want[0].cpu().numpy(), SCORE_ATOL)
    else:
        assert float((got - want).abs().max()) <= ATTN_ATOL


# -- the training mesh (select with -k train_mesh) ----------------------------

TRAIN_RING_ATOL = 1e-4  # the reference's ring tolerance (tests/test_models.py:112)


@pytest.mark.parametrize("mask_kind", ["keep_0.8", "first_block"])
@pytest.mark.parametrize("sp", [2, 8])
def test_train_mesh_ring_on_members_of_one_card_matches_dense(dev, sp, mask_kind):
    from nornicdb_tpu_torch.parallel.mesh import Mesh, _device_array
    from nornicdb_tpu_torch.parallel.ring_attention import _dense_attention, ring_attention

    g = torch.Generator(device=dev).manual_seed(sp)
    q, k, v = (torch.randn(2, 512, 4, 64, generator=g, device=dev) for _ in range(3))
    if mask_kind == "keep_0.8":
        mask = torch.rand(2, 512, generator=g, device=dev) > 0.2
    else:
        mask = torch.zeros(2, 512, dtype=torch.bool, device=dev)
        mask[:, :512 // sp] = True
    mesh = Mesh(_device_array([dev] * sp, (sp,)), ("sp",))
    q.requires_grad_()
    got = ring_attention(q, k, v, mask, mesh=mesh)
    want = _dense_attention(q, k, v, mask)
    assert float((got - want).detach().abs().max()) <= TRAIN_RING_ATOL
    (gq,) = torch.autograd.grad(got.square().sum(), q)
    (wq,) = torch.autograd.grad(want.square().sum(), q)
    assert float((gq - wq).abs().max()) <= TRAIN_RING_ATOL


def test_train_mesh_sharded_step_on_the_card_matches_the_single_device_step(dev):
    from nornicdb_tpu_torch.models import train as ttr
    from nornicdb_tpu_torch.models.encoder import EncoderConfig
    from nornicdb_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    cfg = EncoderConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
                        max_len=64, dtype=torch.float32)
    rng = np.random.default_rng(1)
    a, p = (rng.integers(1, 500, (4, 32)) for _ in range(2))
    a[:, 26:] = 0
    model, single = ttr.create_train_state(cfg, 2, learning_rate=1e-3, device=dev)
    state, step = ttr.make_sharded_train_step(model, single, make_mesh(MeshSpec(2, 2, 2),
                                                                       [dev] * 8))
    loss = ttr.sharded_contrastive_loss(state, a, p)
    loss.backward()
    ids = [torch.from_numpy(x).to(dev) for x in (a, p)]
    ref = ttr.info_nce_loss(model(ids[0]), model(ids[1]))
    ref.backward()
    assert abs(float(loss.detach()) - float(ref.detach())) <= 1e-5 * abs(float(ref.detach()))
    for name, q in model.named_parameters():
        assert float((state.params[name].gather(dev, grad=True) - q.grad).abs().max()) <= 1e-5
    state.apply_gradients()  # both first steps, on the gradients compared
    single.apply_gradients()
    for _ in range(2):
        state, loss = step(state, a, p)
        single, ref = ttr.contrastive_train_step(model, single, a, p)
        assert abs(float(loss) - float(ref)) <= 1e-4


_TRAIN_FAULT_PROBE = """
import torch
from nornicdb_tpu_torch.parallel import pipeline as tpipe
dev = torch.device("cuda", 0)
mesh = tpipe.make_pp_ep_mesh(8, [dev] * 8)
init_fn, step = tpipe.make_pp_ep_train_step(mesh, 64, 128, 2, learning_rate=0.1)
params, _ = init_fn(0)
x = torch.randn(32, 64, device=dev)
real, calls = tpipe._stage_block, []

def faulting(p, h):
    calls.append(1)
    if len(calls) == 3:  # the third member's stage reads out of bounds
        h.index_select(0, torch.full((4,), 10**9, dtype=torch.int64, device=h.device))
    return real(p, h)

tpipe._stage_block = faulting
try:
    params, loss = step(params, x, x * 0.5)
    torch.cuda.synchronize()
except Exception as exc:  # the fault must reach the caller
    print("RAISED", len(calls), str(exc).splitlines()[0])
else:
    print("SWALLOWED", float(loss))
"""


def test_train_mesh_a_cuda_fault_inside_one_members_stage_propagates(dev):
    """A device-side fault in one member's pipeline stage reaches the caller
    of the pp x ep step: nothing steps down, nothing is swallowed. Run in a
    subprocess: a device-side fault poisons its CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _TRAIN_FAULT_PROBE], cwd=repo,
                         env=dict(os.environ), capture_output=True, text=True, timeout=300)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else out.stderr[-2000:]
    assert last.startswith("RAISED"), last
    assert "CUDA" in last or "device-side" in last, last


# ---------------------------------------------------------------------------
# the front doors: the HTTP server over a DB on the card
# ---------------------------------------------------------------------------


def _http(port, path, body=None, method="POST"):
    import json
    import urllib.error
    import urllib.request

    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                               data=json.dumps(body).encode() if body is not None else None,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_search_on_the_card_equals_the_direct_recall(dev):
    """``/nornicdb/search`` on a DB on the card answers what ``db.recall``
    answers (ids and scores after the JSON round trip), each computed past
    the result cache, and the requests launch both kernels: B2 for the
    query embeds, B1 for the exact vector search (3,000 documents: above
    the index's small-host rung, below HNSW's and the fused tier's
    floors)."""
    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.api.http_server import HttpServer

    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(300)]
    db = nornicdb_tpu_torch.open(device=dev)
    srv = None
    try:
        for i in range(3000):
            db.store(" ".join(rng.choice(words, size=12)), node_id=f"d{i}")
        db.flush()
        svc = db.search
        srv = HttpServer(db, port=0).start()
        queries = [" ".join(rng.choice(words, size=3)) for _ in range(8)]
        b1, b2 = fused_cosine_topk.launches, flash_attention.launches
        for mode in ("vector", "hybrid", "text"):
            for q in queries:
                svc._clear_result_cache()
                st, body = _http(srv.port, "/nornicdb/search", {"query": q, "mode": mode})
                svc._clear_result_cache()
                direct = db.recall(q, limit=10, mode=mode)
                assert st == 200
                assert [(h["id"], h["score"]) for h in body["results"]] == \
                    [(h["id"], float(h["score"])) for h in direct]
        assert fused_cosine_topk.launches > b1 and flash_attention.launches > b2
    finally:
        if srv is not None:
            srv.stop()
        db.close()


_HTTP_FAULT_PROBE = """
import json, urllib.request, urllib.error
import torch
import nornicdb_tpu_torch
from nornicdb_tpu_torch import obs
from nornicdb_tpu_torch.api.http_server import HttpServer
from nornicdb_tpu_torch.embed.embedder import HashEmbedder

db = nornicdb_tpu_torch.open(device="cuda", embedder=HashEmbedder())
db.store("oslo is the capital", node_id="a")
db.flush()
svc = db.search
srv = HttpServer(db, port=0).start()

def get(path, body=None):
    r = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", method="POST" if body else "GET",
                               data=json.dumps(body).encode() if body else None,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())

def faulting(*a, **k):  # a launch that reads out of bounds
    bad = torch.full((4,), 10**9, dtype=torch.int64, device="cuda")
    torch.zeros(8, device="cuda").index_select(0, bad)
    torch.cuda.synchronize()

svc.search = faulting
st, body = get("/nornicdb/search", {"query": "oslo"})
print("SEARCH", st, body["errors"][0]["code"], "CUDA" in body["errors"][0]["message"])
obs.parity_breaches = lambda: (torch.cuda.synchronize(), [])[1]  # a probe that touches the card
try:
    srv._readyz()
    print("PROBE SWALLOWED")
except RuntimeError as exc:
    print("PROBE RAISED", "CUDA" in str(exc))
st, body = get("/readyz")
print("READYZ", st)
srv.stop()
"""


def test_a_cuda_fault_in_a_request_is_answered_and_reraised_from_a_probe(dev):
    """A device-side fault inside ``/nornicdb/search`` is answered 500 with
    the CUDA error; a readiness probe that meets the poisoned context
    re-raises it (ROADMAP C39), so ``/readyz`` answers 500 too, never a
    silent ``ready``. Run in a subprocess: a device-side fault poisons its
    CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _HTTP_FAULT_PROBE], cwd=repo,
                         env=dict(os.environ), capture_output=True, text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    assert "SEARCH 500 Neo.DatabaseError.General.UnknownError True" in lines, out.stderr[-2000:]
    assert "PROBE RAISED True" in lines and "READYZ 500" in lines, (lines, out.stderr[-2000:])


def test_qdrant_search_on_the_card_equals_the_cpu_port(dev):
    """A Cosine collection on the card answers what the same collection on
    the CPU answers (ids tie-aware, scores within 1e-5), each search a B1
    launch on the card (3,000 points of 160 dims: above the index's
    small-host rung)."""
    from nornicdb_tpu_torch.api.qdrant import QdrantCompat
    from nornicdb_tpu_torch.storage import MemoryEngine

    rng = np.random.default_rng(9)
    pts = [{"id": i, "vector": rng.standard_normal(160).astype(np.float32).tolist(),
            "payload": {"b": i % 10}} for i in range(3000)]
    card, cpu = QdrantCompat(MemoryEngine(), device=dev), QdrantCompat(MemoryEngine(), device="cpu")
    for c in (card, cpu):
        c.create_collection("c", {"size": 160})
        c.upsert_points("c", pts)
    b1 = fused_cosine_topk.launches
    for i in range(16):
        q = pts[i * 97]["vector"]
        flt = {"must": [{"key": "b", "match": {"value": i % 10}}]} if i % 2 else None
        got, want = (c.search_points("c", q, limit=10, query_filter=flt) for c in (card, cpu))
        assert topk_agree([[h["id"] for h in got]], [[h["score"] for h in got]],
                          [[h["id"] for h in want]], [[h["score"] for h in want]], SCORE_ATOL)
    assert fused_cosine_topk.launches - b1 >= 16
    assert card._index("c").device.type == "cuda"


_QDRANT_FAULT_PROBE = """
import json, urllib.request, urllib.error
import torch
import nornicdb_tpu_torch
from nornicdb_tpu_torch import obs
from nornicdb_tpu_torch.api.http_server import HttpServer
from nornicdb_tpu_torch.embed.embedder import HashEmbedder

db = nornicdb_tpu_torch.open(device="cuda", embedder=HashEmbedder())
srv = HttpServer(db, port=0).start()

def call(method, path, body=None):
    r = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", method=method,
                               data=json.dumps(body).encode() if body is not None else None,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())

call("PUT", "/collections/c", {"vectors": {"size": 4}})
call("PUT", "/collections/c/points", {"points": [{"id": 1, "vector": [1, 0, 0, 0]}]})
idx = db.qdrant_compat._index("c")

def faulting(*a, **k):  # a launch that reads out of bounds
    bad = torch.full((4,), 10**9, dtype=torch.int64, device="cuda")
    torch.zeros(8, device="cuda").index_select(0, bad)
    torch.cuda.synchronize()

idx.search_batch = faulting
st, body = call("POST", "/collections/c/points/search", {"vector": [1, 0, 0, 0]})
print("SEARCH", st, body["errors"][0]["code"], "CUDA" in body["errors"][0]["message"])
obs.parity_breaches = lambda: (torch.cuda.synchronize(), [])[1]  # a probe that touches the card
try:
    srv._readyz()
    print("PROBE SWALLOWED")
except RuntimeError as exc:
    print("PROBE RAISED", "CUDA" in str(exc))
srv.stop()
"""


def test_a_cuda_fault_in_a_collection_search_is_answered_500_and_reraised_from_a_probe(dev):
    """A device-side fault inside a Qdrant collection's search is answered
    500 over REST, as the reference answers an error there, and a
    readiness probe that meets the poisoned context re-raises it (C39,
    C42). A subprocess: the fault poisons its CUDA context."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _QDRANT_FAULT_PROBE], cwd=repo,
                         env=dict(os.environ), capture_output=True, text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    assert "SEARCH 500 Neo.DatabaseError.General.UnknownError True" in lines, out.stderr[-2000:]
    assert "PROBE RAISED True" in lines, (lines, out.stderr[-2000:])


def test_readyz_after_the_window_is_ready_with_the_cublas_workspaces_named(dev):
    """ROADMAP C40: the main path's DB at a small size, one product on a
    second stream (a second cuBLAS workspace), then the ledger reconciled
    at a clock and again past the detection window: the workspaces are a
    named resource, the drift stays under the 64 MiB bound and ``/readyz``
    answers 200."""
    import json as _json
    import time
    import urllib.request

    import nornicdb_tpu_torch
    from nornicdb_tpu_torch import obs
    from nornicdb_tpu_torch.api.http_server import HttpServer
    from nornicdb_tpu_torch.obs import device as obs_device

    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(300)]
    db = nornicdb_tpu_torch.open(device=dev)
    srv = None
    try:
        for i in range(2000):
            db.store(" ".join(rng.choice(words, size=12)), node_id=f"d{i}")
        db.flush()
        db.recall("w1 w2", limit=10)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            x = torch.randn(64, 160, device=dev)
            (x @ x.T).sum().item()
        torch.cuda.synchronize()
        srv = HttpServer(db, port=0).start()
        ws = {e["index"]: e for e in obs.resource_snapshot() if e["family"] == "cublas"}
        assert ws and sum(e["workspaces"] for e in ws.values()) >= 2
        c = obs_device.cfg()
        assert (c["mem_drift_bytes"], c["mem_drift_s"]) == (64 << 20, 60.0)
        t = time.time()
        obs_device.reconcile(now=t)
        rec = obs_device.reconcile(now=t + c["mem_drift_s"] + 1.0)
        assert abs(rec["drift_bytes"]) < c["mem_drift_bytes"] and not rec["leak_suspected"], rec
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/readyz", timeout=60) as r:
            assert r.status == 200 and _json.loads(r.read())["status"] == "ready"
    finally:
        if srv is not None:
            srv.stop()
        db.close()


def test_cublas_workspaces_leave_out_an_index_matrix_of_one_workspace(dev):
    """A collection matrix of exactly one workspace's bytes on the card
    (1,024 dims at 4,097 points: capacity 8,192, 32 MiB) is an allocator
    block of that size; the workspace resource does not count it, so the
    ledger names the matrix once, by its index."""
    from nornicdb_tpu_torch.obs import device as obs_device
    from nornicdb_tpu_torch.obs import resources as obs_resources
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    ws = obs_device.cublas_workspace_size(torch.cuda.get_device_capability(dev))
    x = torch.randn(64, 160, device=dev)
    (x @ x.T).sum().item()  # this thread's workspace exists before the count
    res = obs_device.CublasWorkspaces(torch.device(dev))
    before, size = res.workspaces()
    assert size == ws and before >= 1
    rng = np.random.default_rng(5)
    idx = BruteForceIndex(dims=1024, device=dev)
    idx.add_batch([(f"p{i}", row) for i, row in enumerate(
        rng.standard_normal((4097, 1024)).astype(np.float32))])
    idx.search_batch(rng.standard_normal((1, 1024)).astype(np.float32), 5)
    torch.cuda.synchronize()
    with idx._lock:
        matrix, _ = idx._device_arrays_locked()
    assert matrix.numel() * matrix.element_size() == ws
    obs_resources.register("brute", "one_workspace", idx)
    try:
        assert res.workspaces() == (before, ws)
    finally:
        obs_resources.unregister("brute", "one_workspace")
