"""The port's encoder stack (checkpoint reader, weight carry-over, Encoder,
tokenizer, embedders) against the JAX package on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from nornicdb_tpu.embed import embedder as jemb
from nornicdb_tpu.embed import tokenizer as jtok
from nornicdb_tpu.models import encoder as jenc
from nornicdb_tpu.models import pretrain as jpre
from nornicdb_tpu_torch.embed import embedder as temb
from nornicdb_tpu_torch.embed import tokenizer as ttok
from nornicdb_tpu_torch.models import checkpoint as tckpt
from nornicdb_tpu_torch.models.encoder import Encoder, EncoderConfig
from nornicdb_tpu_torch.models.weights import params_from_jax

# float32 forward passes of the same weights; XLA and torch order their
# matmul/LayerNorm/softmax sums differently
COS_MIN = 0.99999
MAX_ABS = 1e-4

# one intra-op thread: these tests run beside the suite's other workers on
# shared cores, and timing-sensitive tests there must not be starved
torch.set_num_threads(1)

TEXTS = [
    "the capital of norway is oslo",
    "Graph databases store nodes and relationships!",
    "a",
    "vector search with brute-force cosine top-k " * 6,
    "BM25 and RRF fuse lexical and semantic candidates; 42 results.",
]


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def mini():
    path = jpre.default_checkpoint_path()
    assert path is not None and path == tckpt.default_checkpoint_path()
    jcfg, jparams = jpre.load_checkpoint(path)
    return path, dataclasses.replace(jcfg, dtype=jnp.float32), jparams


def _ids(cfg_vocab, texts, width):
    tok = jtok.HashTokenizer(cfg_vocab)
    arr = np.zeros((len(texts), width), np.int32)
    for i, t in enumerate(texts):
        ids = tok.encode(t, max_len=width)
        arr[i, : len(ids)] = ids
    return arr


def _assert_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    assert cos.min() >= COS_MIN, cos
    assert np.abs(a - b).max() <= MAX_ABS


def test_msgpack_reader_is_bit_identical_to_flax(mini):
    path, _, jparams = mini
    meta, tree = tckpt.read_checkpoint(path)
    assert meta == [8192, 160, 2, 4, 640, 512]
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_t, flat_j):
        assert a.dtype == np.float16
        np.testing.assert_array_equal(a.astype(np.float32), b)


@pytest.mark.parametrize("value", [
    0, 127, -1, -32, -33, 255, 65535, 2**32 + 5, -(2**40), 1.5, -2.25e300,
    None, True, False, "", "x" * 31, "y" * 32, "z" * 300, "w" * 70000,
    b"", b"\x00" * 300, [], list(range(20)), {"a": {"b": [1, "c"]}},
    {str(i): i for i in range(20)},
])
def test_msgpack_reader_matches_msgpack(value):
    packed = msgpack.packb(value, use_bin_type=True)
    assert tckpt.unpackb(packed) == msgpack.unpackb(packed, raw=False,
                                                    strict_map_key=False)


def test_msgpack_reader_rejects_truncated_data():
    with pytest.raises(ValueError):
        tckpt.unpackb(msgpack.packb([1, 2, 3])[:-1])


def test_encoder_matches_jax_on_mini_checkpoint(mini):
    path, jcfg, jparams = mini
    cfg, state = tckpt.load_checkpoint(path)
    assert cfg == EncoderConfig.mini()
    model = Encoder(cfg)
    model.load_state_dict(state)
    ids = _ids(cfg.vocab_size, TEXTS, 64)
    j_out = jenc.Encoder(jcfg).apply({"params": jparams}, jnp.asarray(ids))
    with torch.no_grad():
        t_out = model(torch.from_numpy(ids).long()).numpy()
    assert t_out.shape == (len(TEXTS), 160)
    _assert_close(t_out, j_out)


def test_encoder_matches_jax_on_tiny_random_init():
    jcfg = dataclasses.replace(jenc.EncoderConfig.tiny(), dtype=jnp.float32)
    ids = _ids(jcfg.vocab_size, TEXTS, 32)
    jmodel = jenc.Encoder(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    cfg = dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32)
    model = Encoder(cfg)
    model.load_state_dict(params_from_jax(_tree_np(jparams)))
    with torch.no_grad():
        t_out = model(torch.from_numpy(ids).long()).numpy()
    _assert_close(t_out, jmodel.apply({"params": jparams}, jnp.asarray(ids)))


def test_params_from_jax_shapes():
    jcfg = dataclasses.replace(jenc.EncoderConfig.tiny(), dtype=jnp.float32)
    jparams = jenc.Encoder(jcfg).init(jax.random.PRNGKey(1),
                                      jnp.ones((1, 8), jnp.int32))["params"]
    sd = params_from_jax(_tree_np(jparams))
    model = Encoder(dataclasses.replace(EncoderConfig.tiny(), dtype=torch.float32))
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name
    q = np.asarray(jparams["layer_0"]["attn"]["query"]["kernel"])  # [d, h, hd]
    np.testing.assert_array_equal(sd["layers.0.attn.query.weight"].numpy(),
                                  q.reshape(q.shape[0], -1).T)


def test_bf16_encoder_runs():
    model = Encoder(EncoderConfig.tiny(), generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_ids(1024, TEXTS, 32)).long()
    with torch.no_grad():
        out = model(ids)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, atol=1e-5)


def test_init_is_seeded_by_the_generator():
    a = Encoder(EncoderConfig.tiny(), generator=torch.Generator().manual_seed(3))
    b = Encoder(EncoderConfig.tiny(), generator=torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("vocab", [1024, 8192, 30522])
def test_tokenizer_ids_identical(vocab):
    jt, tt = jtok.HashTokenizer(vocab), ttok.HashTokenizer(vocab)
    for text in TEXTS + ["ünïcödé tokens — and, punctuation!?", ""]:
        for max_len in (4, 512):
            assert tt.encode(text, max_len) == jt.encode(text, max_len)


@pytest.mark.parametrize("n,size,overlap", [(10, 512, 50), (1500, 512, 50),
                                            (1025, 100, 10), (7, 3, 5)])
def test_chunk_tokens_identical(n, size, overlap):
    ids = list(range(n))
    assert ttok.chunk_tokens(ids, size, overlap) == jtok.chunk_tokens(ids, size, overlap)


def test_bucket_widths_identical():
    for w in range(1, 3000):
        assert (temb.TorchEncoderEmbedder._bucket_width(w)
                == jemb.JaxEncoderEmbedder._bucket_width(w))


def test_embedders_match_jax(mini):
    path, jcfg, jparams = mini
    j = jemb.JaxEncoderEmbedder(model=jenc.Encoder(jcfg), params=jparams, cfg=jcfg)
    t = tckpt.load_default_embedder(device="cpu")
    assert t.dims == j.dims == 160 and t.max_batch == j.max_batch == 64
    _assert_close(t.embed_batch(TEXTS), j.embed_batch(TEXTS))
    long_text = " ".join(f"word{i % 97}" for i in range(1400))
    tc, jc = t.embed_chunks(long_text), j.embed_chunks(long_text)
    assert len(tc) == len(jc) == 3
    _assert_close(tc, jc)


def test_hash_and_cached_embedders_match_jax():
    th, jh = temb.HashEmbedder(64), jemb.HashEmbedder(64)
    for text in TEXTS:
        assert th.embed(text) == jh.embed(text)
    cached = temb.CachedEmbedder(th, capacity=2)
    out = cached.embed_batch(["a b", "a b", "c d"])
    assert out[0] == out[1] == th.embed("a b") and cached.misses == 2
    assert cached.embed("c d") == th.embed("c d") and cached.hits == 1
    assert not hasattr(cached, "embed_chunks")
