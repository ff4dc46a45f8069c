"""The HuggingFace import paths (``nornicdb_tpu_torch/heimdall/hf_import.py``,
``nornicdb_tpu_torch/models/hf_import.py``) and the DB's ``hf`` embedder
against the JAX package's, on the CPU, with random weights at small
shape-real configs (nothing is downloaded).

Tolerances: float32 forwards of the same weights, sums in another order:
LLaMA logits within 1e-4 (the reference holds its own against
``transformers`` within 3e-4 / rtol 1e-3), pooled encoder embeddings
within 2e-5. State-dict reads: bitwise.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nornicdb_tpu
import nornicdb_tpu_torch
from nornicdb_tpu.embed.embedder import HashEmbedder as JHash
from nornicdb_tpu.heimdall import hf_import as jhi
from nornicdb_tpu.models import hf_import as jhf
from nornicdb_tpu_torch.embed.embedder import HashEmbedder as THash
from nornicdb_tpu_torch.heimdall import hf_import as thi
from nornicdb_tpu_torch.models import hf_import as thf

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

LLAMA_ATOL = 1e-4
ENC_ATOL = 2e-5
CPU = "cpu"

LLAMA_SMALL = dict(vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
                   attention_dropout=0.0, tie_word_embeddings=False)
ENC_SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=128, max_position_embeddings=96, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)


def _llama(seed=0, **over):
    hf_cfg = transformers.LlamaConfig(**{**LLAMA_SMALL, **over})
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    tensors = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return model, hf_cfg, tensors


# -- LLaMA-class decoders -----------------------------------------------------------


@pytest.mark.parametrize("seed,kv_heads,tie", [(0, 2, False), (1, 4, False), (2, 1, True)])
def test_llama_forward_matches_jax(seed, kv_heads, tie):
    _, hf_cfg, tensors = _llama(seed, num_key_value_heads=kv_heads, tie_word_embeddings=tie)
    if tie:
        tensors.pop("lm_head.weight", None)
    jcfg = jhi.HFDecoderConfig.from_hf_config(hf_cfg.to_dict())
    tcfg = thi.HFDecoderConfig.from_hf_config(hf_cfg.to_dict())
    assert jcfg.__dict__ == tcfg.__dict__
    jp = jhi.import_hf_decoder_params(tensors, jcfg)
    tp = thi.import_hf_decoder_params(tensors, tcfg, device=CPU)
    for name in ("embed", "norm", "lm_head"):
        assert np.array_equal(np.asarray(jp[name]), tp[name].numpy())
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert all(np.array_equal(np.asarray(jl[k]), tl[k].numpy()) for k in jl)
    ids = np.arange(3 + seed, 23 + seed, dtype=np.int32) * 7 % LLAMA_SMALL["vocab_size"]
    want = np.asarray(jhi.forward(jcfg, jp, jnp.asarray(ids)))
    got = thi.forward(tcfg, tp, torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LLAMA_ATOL)


def test_llama_forward_matches_transformers():
    model, hf_cfg, tensors = _llama(3)
    cfg = thi.HFDecoderConfig.from_hf_config(hf_cfg.to_dict())
    params = thi.import_hf_decoder_params(tensors, cfg, device=CPU)
    ids = np.array([3, 17, 99, 4, 55, 120, 7], np.int64)
    with torch.no_grad():
        want = model(torch.from_numpy(ids[None])).logits[0].numpy()
        got = thi.forward(cfg, params, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LLAMA_ATOL, rtol=1e-3)


def test_llama_missing_tensor_is_loud_alike():
    _, hf_cfg, tensors = _llama()
    del tensors["model.layers.1.mlp.down_proj.weight"]
    msgs = []
    for mod, kw in ((jhi, {}), (thi, {"device": CPU})):
        cfg = mod.HFDecoderConfig.from_hf_config(hf_cfg.to_dict())
        with pytest.raises(KeyError) as e:
            mod.import_hf_decoder_params(tensors, cfg, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "down_proj" in msgs[1]


def _jax_greedy(cfg, params, ids, n, eos=None):
    """The reference's HFDecoderModel loop, without its tokenizer."""
    ids, out = list(ids), []
    for _ in range(n):
        logits = np.asarray(jhi.forward(cfg, params, jnp.asarray(ids[-cfg.max_position:],
                                                                 jnp.int32)))[-1]
        nxt = int(np.argmax(logits))
        if eos is not None and nxt == eos:
            break
        ids.append(nxt)
        out.append(nxt)
    return out


@pytest.mark.parametrize("eos", [None, 5])
def test_generate_ids_matches_the_reference_loop(eos):
    _, hf_cfg, tensors = _llama(4, max_position_embeddings=12)
    jcfg = jhi.HFDecoderConfig.from_hf_config(hf_cfg.to_dict())
    tcfg = thi.HFDecoderConfig.from_hf_config(hf_cfg.to_dict())
    jp = jhi.import_hf_decoder_params(tensors, jcfg)
    tp = thi.import_hf_decoder_params(tensors, tcfg, device=CPU)
    ids = [9, 33, 70, 2]
    want = _jax_greedy(jcfg, jp, ids, 14, eos)
    got = thi.generate_ids(tcfg, tp, ids, 14, eos=eos)
    assert got == want  # the window slides past max_position
    a = thi.generate_ids(tcfg, tp, ids, 6, temperature=0.9, seed=3)
    assert a == thi.generate_ids(tcfg, tp, ids, 6, temperature=0.9, seed=3) and len(a) == 6


def _tokenizer_dir(path, vocab_size):
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "</s>": 1}
    vocab.update({f"w{i}": i for i in range(2, vocab_size)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                                eos_token="</s>")
    fast.save_pretrained(str(path))


def test_hf_decoder_model_matches_the_reference(tmp_path):
    from safetensors.numpy import save_file

    _, hf_cfg, tensors = _llama(5)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    _tokenizer_dir(tmp_path, LLAMA_SMALL["vocab_size"])
    jmodel = jhi.HFDecoderModel(str(tmp_path))
    tmodel = thi.HFDecoderModel(str(tmp_path), device=CPU)
    assert tmodel.param_bytes() == jmodel.param_bytes()
    for prompt in ("w3 w9 w40", "w100", "w7 w7 w7 w7"):
        assert tmodel.generate(prompt, max_tokens=8) == jmodel.generate(prompt, max_tokens=8)


def test_slm_dir_serves_through_the_generator(tmp_path, monkeypatch):
    from safetensors.numpy import save_file

    from nornicdb_tpu_torch.heimdall import TorchGenerator

    _, hf_cfg, tensors = _llama(6)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    _tokenizer_dir(tmp_path, LLAMA_SMALL["vocab_size"])
    monkeypatch.setenv("NORNICDB_TPU_SLM_DIR", str(tmp_path))
    assert thi.default_slm_dir() == jhi.default_slm_dir() == str(tmp_path)
    g = TorchGenerator(device=CPU)
    assert isinstance(g.model, thi.HFDecoderModel)
    from nornicdb_tpu.heimdall.generators import JAXGenerator

    assert g.generate("w3 w4", max_tokens=5) == JAXGenerator().generate("w3 w4", max_tokens=5)
    monkeypatch.setenv("NORNICDB_TPU_SLM_DIR", str(tmp_path / "nowhere"))
    assert thi.default_slm_dir() is None


def test_hf_decoder_entry_points_default_to_cuda(monkeypatch):
    _, hf_cfg, tensors = _llama()
    cfg = thi.HFDecoderConfig.from_hf_config(hf_cfg.to_dict())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        thi.import_hf_decoder_params(tensors, cfg)


# -- BERT / XLM-R encoders ------------------------------------------------------------


def _batch(rng, vocab, pad_id, n=3, width=17):
    ids = rng.integers(max(pad_id + 1, 2), vocab, size=(n, width))
    mask = np.zeros((n, width), bool)
    for i, ln in enumerate([width, width - 5, width - 11]):
        mask[i, :ln] = True
        ids[i, ln:] = pad_id
    return ids.astype(np.int32), mask


def _encoder(kind, seed):
    if kind == "bert":
        hf_cfg = transformers.BertConfig(**ENC_SMALL)
        cls = transformers.BertModel
    else:
        hf_cfg = transformers.XLMRobertaConfig(**ENC_SMALL, type_vocab_size=1, pad_token_id=1)
        cls = transformers.XLMRobertaModel
    torch.manual_seed(seed)
    model = cls(hf_cfg).eval()
    return model, hf_cfg, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kind", ["bert", "xlmr"])
@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_hf_encoder_matches_jax(kind, pooling):
    import dataclasses

    model, hf_cfg, tensors = _encoder(kind, 0)
    jcfg = dataclasses.replace(jhf.HFEncoderConfig.from_hf_config(hf_cfg.to_dict()),
                               pooling=pooling)
    tcfg = dataclasses.replace(thf.HFEncoderConfig.from_hf_config(hf_cfg.to_dict()),
                               pooling=pooling)
    assert tcfg.arch == jcfg.arch == ("bert" if kind == "bert" else "roberta")
    ids, mask = _batch(np.random.default_rng(1), ENC_SMALL["vocab_size"], tcfg.pad_token_id)
    want = np.asarray(jhf.HFEncoder(jcfg).apply(
        {"params": jhf.import_hf_params(tensors, jcfg)}, ids, mask), np.float32)
    enc = thf.build_encoder(tcfg, thf.import_hf_params(tensors, tcfg), CPU)
    with torch.no_grad():
        got = enc(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)).numpy()
        # without a mask the pad id decides, as in the reference
        no_mask = enc(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ENC_ATOL)
    np.testing.assert_allclose(no_mask, got, rtol=0, atol=ENC_ATOL)
    if pooling == "mean":
        with torch.no_grad():
            h = model(input_ids=torch.from_numpy(ids.astype(np.int64)),
                      attention_mask=torch.from_numpy(mask.astype(np.int64))
                      ).last_hidden_state.numpy()
        m = mask[:, :, None].astype(np.float32)
        pooled = (h * m).sum(1) / m.sum(1)
        pooled /= np.linalg.norm(pooled, axis=1, keepdims=True)
        np.testing.assert_allclose(got, pooled, rtol=0, atol=ENC_ATOL)


@pytest.mark.parametrize("prefix", ["", "bert.", "roberta."])
def test_import_hf_params_prefixes_and_missing_tensors(prefix):
    _, hf_cfg, tensors = _encoder("bert", 2)
    tensors = {prefix + k: v for k, v in tensors.items()}
    cfg = thf.HFEncoderConfig.from_hf_config(hf_cfg.to_dict())
    sd = thf.import_hf_params(tensors, cfg)
    jtree = jhf.import_hf_params(tensors, jhf.HFEncoderConfig.from_hf_config(hf_cfg.to_dict()))
    assert np.array_equal(sd["layers.1.mlp_up.weight"].numpy(),
                          jtree["layer_1_mlp_up"]["kernel"].T)
    assert set(sd) == set(thf.HFEncoder(cfg).state_dict())
    del tensors[prefix + "encoder.layer.1.output.dense.weight"]
    msgs = []
    for mod in (jhf, thf):
        with pytest.raises(KeyError) as e:
            mod.import_hf_params(tensors, mod.HFEncoderConfig.from_hf_config(hf_cfg.to_dict()))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "output.dense" in msgs[1]


def test_missing_token_types_are_zero_alike():
    _, hf_cfg, tensors = _encoder("xlmr", 3)
    del tensors["embeddings.token_type_embeddings.weight"]
    cfg = thf.HFEncoderConfig.from_hf_config(hf_cfg.to_dict())
    sd = thf.import_hf_params(tensors, cfg)
    jtree = jhf.import_hf_params(tensors, jhf.HFEncoderConfig.from_hf_config(hf_cfg.to_dict()))
    assert np.array_equal(sd["type_embed.weight"].numpy(), jtree["type_embed"]["embedding"])


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "npz"])
def test_read_checkpoint_tensors_matches(tmp_path, fmt):
    from safetensors.numpy import save_file

    model, _, tensors = _encoder("bert", 4)
    path = str(tmp_path / {"safetensors": "model.safetensors", "bin": "pytorch_model.bin",
                           "npz": "model.npz"}[fmt])
    if fmt == "safetensors":
        save_file(tensors, path)
    elif fmt == "bin":
        torch.save(model.state_dict(), path)
    else:
        np.savez(path, **tensors)
    want = jhf.read_checkpoint_tensors(path)
    got = thf.read_checkpoint_tensors(path)
    assert set(got) == set(want) == set(tensors)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _model_dir(tmp_path, seed=9):
    """The reference test's local model dir: BERT weights and a minimal
    WordPiece vocab, so AutoTokenizer resolves from local files."""
    from safetensors.numpy import save_file

    _, hf_cfg, tensors = _encoder("bert", seed)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "graph", "vector", "search",
             "node", "edge", "a", "b", "the", "and"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    return str(tmp_path)


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_hf_encoder_embedder_matches_jax(tmp_path, pooling):
    d = _model_dir(tmp_path)
    texts = ["graph search", "vector node edge", "the and a b graph " * 3, "unknownword"]
    want = np.asarray(jhf.HFEncoderEmbedder(d, pooling=pooling, max_batch=3).embed_batch(texts))
    emb = thf.HFEncoderEmbedder(d, pooling=pooling, max_batch=3, device=CPU)
    got = np.asarray(emb.embed_batch(texts))
    assert emb.dims == ENC_SMALL["hidden_size"] and emb.max_len == 94
    np.testing.assert_allclose(got, want, rtol=0, atol=ENC_ATOL)
    np.testing.assert_allclose(emb.embed(texts[0]), got[0], rtol=0, atol=1e-6)


def test_load_hf_model_dir_without_weights_raises_alike(tmp_path):
    d = _model_dir(tmp_path)
    (tmp_path / "model.safetensors").unlink()
    for mod in (jhf, thf):
        with pytest.raises(FileNotFoundError, match="no weight file"):
            mod.load_hf_model_dir(d)


# -- the DB's hf embedder (C18) --------------------------------------------------------


def _open_both(data=None, **kw):
    j = nornicdb_tpu.open(data_dir=str(data / "j") if data else None, auto_embed=False, **kw)
    t = nornicdb_tpu_torch.open(str(data / "t") if data else None, device=CPU,
                                auto_embed=False, **kw)
    return j, t


def test_model_dir_makes_hf_the_default_embedder(tmp_path, monkeypatch):
    (tmp_path / "m").mkdir()
    monkeypatch.setenv("NORNICDB_TPU_MODEL_DIR", _model_dir(tmp_path / "m"))
    monkeypatch.delenv("NORNICDB_TPU_EMBEDDER", raising=False)
    j, t = _open_both(tmp_path)
    try:
        assert isinstance(j._embedder.inner, jhf.HFEncoderEmbedder)
        assert isinstance(t._embedder.inner, thf.HFEncoderEmbedder)
        assert t._embedder.dims == j._embedder.dims == ENC_SMALL["hidden_size"]
        np.testing.assert_allclose(t._embedder.embed("graph search"),
                                   j._embedder.embed("graph search"), rtol=0, atol=ENC_ATOL)
    finally:
        j.close()
        t.close()
    for side in ("j", "t"):
        assert json.loads((tmp_path / side / "embedder.json").read_text()) == \
            {"kind": "hf", "dims": ENC_SMALL["hidden_size"]}


def test_hf_sidecar_reopens_with_its_model_dir(tmp_path, monkeypatch):
    (tmp_path / "m").mkdir()
    monkeypatch.setenv("NORNICDB_TPU_MODEL_DIR", _model_dir(tmp_path / "m"))
    monkeypatch.delenv("NORNICDB_TPU_EMBEDDER", raising=False)
    t = nornicdb_tpu_torch.open(str(tmp_path / "t"), device=CPU, auto_embed=False)
    t.close()
    t = nornicdb_tpu_torch.open(str(tmp_path / "t"), device=CPU, auto_embed=False)
    try:
        assert isinstance(t._embedder.inner, thf.HFEncoderEmbedder)
    finally:
        t.close()


def test_hf_sidecar_without_a_model_dir_falls_back_to_hash_alike(tmp_path, monkeypatch, caplog):
    """The reference falls back to the hash embedder (with a warning) when
    the recorded hf kind cannot be built; the port does the same."""
    monkeypatch.delenv("NORNICDB_TPU_MODEL_DIR", raising=False)
    monkeypatch.delenv("NORNICDB_TPU_EMBEDDER", raising=False)
    for side in ("j", "t"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "embedder.json").write_text(json.dumps({"kind": "hf", "dims": 64}))
    with caplog.at_level(logging.WARNING):
        j, t = _open_both(tmp_path, engine="python")
    try:
        assert isinstance(j._embedder.inner, JHash) and isinstance(t._embedder.inner, THash)
        assert t._embedder.dims == j._embedder.dims == 256
        assert any("hf embedder is unavailable" in r.getMessage() for r in caplog.records)
    finally:
        j.close()
        t.close()
    # the sidecar keeps its record
    assert json.loads((tmp_path / "t" / "embedder.json").read_text())["kind"] == "hf"


def test_hash_force_beats_the_model_dir_alike(tmp_path, monkeypatch):
    (tmp_path / "m").mkdir()
    monkeypatch.setenv("NORNICDB_TPU_MODEL_DIR", _model_dir(tmp_path / "m"))
    monkeypatch.setenv("NORNICDB_TPU_EMBEDDER", "hash")
    j, t = _open_both()
    try:
        assert isinstance(j._embedder.inner, JHash) and isinstance(t._embedder.inner, THash)
    finally:
        j.close()
        t.close()


def test_hf_embedder_defaults_to_cuda(tmp_path, monkeypatch):
    d = _model_dir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        thf.HFEncoderEmbedder(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        thf.build_encoder(*thf.load_hf_model_dir(d))
