"""The encoder's training paths (``nornicdb_tpu_torch/models/{train,pretrain}.py``,
the checkpoint writer in ``models/checkpoint.py``) and the B2 head widths
(C6) against the JAX package on the same inputs, on the CPU.

Tolerances:
- ``info_nce_loss``: 1e-6 (float32 sums in another order).
- One ``contrastive_train_step`` from the reference's initial weights
  (carried across, since the port draws its own from a ``torch.Generator``:
  C32), float32: the loss within 1e-5 and every weight within 1e-5, but
  each layer's key bias. Its gradient is zero in exact arithmetic (the
  softmax ignores a per-row constant), so both sides hold rounding noise
  there, which Adam scales up to about the rate: within 2.1x the rate.
  Three steps: losses within 1e-4, weights within 1e-4 (key bias as
  above). In bf16 (the default config) the first loss within 2e-3 relative.
- Gradients of the einsum encoder: within 1e-4 relative to each tensor's
  largest (key bias aside).
- ``warmup_cosine_decay``: optax's schedule within 1e-6 relative.
- ``build_corpus``, ``_window``, ``make_batch``, the msgpack writer:
  bitwise.
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nornicdb_tpu.embed.tokenizer import HashTokenizer as JTok
from nornicdb_tpu.models import encoder as jenc
from nornicdb_tpu.models import pretrain as jpre
from nornicdb_tpu.models import train as jtr
from nornicdb_tpu.ops.pallas_attention import flash_attention as j_flash
from nornicdb_tpu_torch.embed.tokenizer import HashTokenizer as TTok
from nornicdb_tpu_torch.models import checkpoint as tckpt
from nornicdb_tpu_torch.models import encoder as tenc
from nornicdb_tpu_torch.models import pretrain as tpre
from nornicdb_tpu_torch.models import train as ttr
from nornicdb_tpu_torch.models.weights import params_from_jax, params_to_jax
from nornicdb_tpu_torch.ops.attention import HEAD_DIMS, check_kernel_args, flash_attention

torch.set_num_threads(1)

LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _tiny(dtype_j=jnp.float32, dtype_t=torch.float32, **kw):
    return (dataclasses.replace(jenc.EncoderConfig.tiny(), dtype=dtype_j, **kw),
            dataclasses.replace(tenc.EncoderConfig.tiny(), dtype=dtype_t, **kw))


def _batch(seed, vocab=1024, b=8, s=16):
    rng = np.random.default_rng(seed)
    a = rng.integers(2, vocab, (b, s)).astype(np.int32)
    p = rng.integers(2, vocab, (b, s)).astype(np.int32)
    a[:, 12:] = 0
    p[3, 5:] = 0
    return a, p


def _state_close(want_sd, got_sd, atol, key_bias_atol):
    for k, w in want_sd.items():
        tol = key_bias_atol if k.endswith("attn.key.bias") else atol
        assert (w - got_sd[k].detach().cpu()).abs().max() <= tol, k


# -- models/train.py ----------------------------------------------------------


@pytest.mark.parametrize("b,temperature", [(2, 0.05), (8, 0.05), (16, 0.2), (64, 1.0)])
def test_info_nce_loss_matches(b, temperature):
    rng = np.random.default_rng(b)
    a, p = (rng.standard_normal((b, 24)).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    want = float(jtr.info_nce_loss(jnp.asarray(a), jnp.asarray(p), temperature))
    got = float(ttr.info_nce_loss(torch.from_numpy(a), torch.from_numpy(p), temperature))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.fixture(scope="module")
def jax_tiny_state():
    cj, _ = _tiny()
    model, state = jtr.create_train_state(cj, jax.random.PRNGKey(0), learning_rate=LR, seq_len=16)
    return model, state


def test_create_train_state_is_adamw_at_optax_defaults():
    _, ct = _tiny()
    model, state = ttr.create_train_state(ct, 3, learning_rate=LR, device="cpu")
    group = state.optimizer.param_groups[0]
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and state.step == 0
    assert not model.cfg.use_flash_attention and model.training
    again, _ = ttr.create_train_state(ct, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(model.state_dict().values(),
                                                  again.state_dict().values()))


@pytest.mark.parametrize("steps", [1, 3])
def test_contrastive_train_step_matches_f32(jax_tiny_state, steps):
    jmodel, jstate = jax_tiny_state
    _, ct = _tiny()
    a, p = _batch(0)
    tmodel, tstate = ttr.create_train_state(ct, 0, learning_rate=LR, device="cpu",
                                            params=params_from_jax(_np(jstate.params)))
    step = jax.jit(functools.partial(jtr.contrastive_train_step, jmodel))
    for i in range(steps):
        jstate, jl = step(jstate, a, p)
        tstate, tl = ttr.contrastive_train_step(tmodel, tstate, a, p)
        assert abs(float(tl) - float(jl)) <= (1e-5 if i == 0 else 1e-4)
    assert tstate.step == steps == int(jstate.step)
    _state_close(params_from_jax(_np(jstate.params)), tmodel.state_dict(),
                 1e-5 if steps == 1 else 1e-4, 2.1 * LR * steps)


def test_contrastive_train_step_bf16_first_loss():
    cj, ct = _tiny(jnp.bfloat16, torch.bfloat16)
    jmodel, jstate = jtr.create_train_state(cj, jax.random.PRNGKey(1), learning_rate=LR)
    tmodel, tstate = ttr.create_train_state(ct, 0, learning_rate=LR, device="cpu",
                                            params=params_from_jax(_np(jstate.params)))
    a, p = _batch(1)
    _, jl = jtr.contrastive_train_step(jmodel, jstate, a, p)
    _, tl = ttr.contrastive_train_step(tmodel, tstate, a, p)
    assert abs(float(tl) - float(jl)) <= 2e-3 * abs(float(jl))


def test_einsum_encoder_forward_and_gradients_match(jax_tiny_state):
    jmodel, jstate = jax_tiny_state
    _, ct = _tiny(use_flash_attention=False)
    model = tenc.Encoder(ct)
    model.load_state_dict(params_from_jax(_np(jstate.params)))
    a, _ = _batch(2)
    want = np.asarray(jmodel.apply({"params": jstate.params}, a))
    got = model(torch.from_numpy(a.astype(np.int64)))
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5
    # the kernel's path (its plain version on the CPU) gives the same vectors
    infer = tenc.Encoder(dataclasses.replace(ct, use_flash_attention=True))
    infer.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert (infer(torch.from_numpy(a.astype(np.int64))) - got).abs().max() <= 1e-5

    def jloss(params):
        return jnp.sum(jmodel.apply({"params": params}, a)[:, :5] ** 3)

    jgrad = params_from_jax(_np(jax.grad(jloss)(jstate.params)))
    (got[:, :5] ** 3).sum().backward()
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):
            continue
        scale = max(float(jgrad[name].abs().max()), 1e-12)
        assert (p.grad - jgrad[name]).abs().max() <= 1e-4 * scale, name


def test_train_step_refuses_the_kernel_path():
    _, ct = _tiny()
    model = tenc.Encoder(ct)
    _, state = ttr.create_train_state(ct, 0, device="cpu")
    with pytest.raises(ValueError, match="einsum"):
        ttr.contrastive_train_step(model, state, *_batch(3))


def test_train_state_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.create_train_state(_tiny()[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.train_mini(steps=1)


# -- models/pretrain.py ---------------------------------------------------------


@pytest.mark.parametrize("steps", [5, 40, 1000, 3000])
def test_warmup_cosine_decay_matches_optax(steps):
    warmup = min(100, steps // 10)
    peak = 3e-4
    sched = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=peak,
                                               warmup_steps=warmup, decay_steps=steps,
                                               end_value=peak * 0.03)
    for step in range(steps + 3):
        want = float(sched(step))
        got = tpre.warmup_cosine_decay(step, 0.0, peak, warmup, steps, peak * 0.03)
        assert abs(got - want) <= 1e-6 * peak, step
    if warmup:
        assert tpre.warmup_cosine_decay(0, 0.0, peak, warmup, steps) == 0.0


@pytest.fixture(scope="module")
def corpus():
    docs = tpre.build_corpus()
    assert docs == jpre.build_corpus()
    groups = {}
    for g, text in docs:
        groups.setdefault(g, []).append(text.split())
    return groups, sorted(groups)


@pytest.mark.parametrize("seed", [0, 5])
def test_make_batch_and_window_bitwise(corpus, seed):
    groups, names = corpus
    rj, rt = random.Random(seed), random.Random(seed)
    tj, tt_ = JTok(8192), TTok(8192)
    for _ in range(3):
        aj, pj = jpre.make_batch(groups, names, tj, rj, 32, 64)
        at, pt = tpre.make_batch(groups, names, tt_, rt, 32, 64)
        assert aj.dtype == at.dtype and np.array_equal(aj, at) and np.array_equal(pj, pt)
    words = groups[names[0]][0]
    for lo, hi, drop in ((4, 14, 0.3), (16, 48, 0.1), (1, 1, 0.99)):
        assert jpre._window(words, random.Random(seed), lo, hi, drop) == \
            tpre._window(words, random.Random(seed), lo, hi, drop)


def test_train_mini_one_step_matches(corpus):
    """The reference's first step from its own initial weights, carried
    across; at steps=1 the warmup is empty, so the step moves the weights
    at the peak rate. Adam's first update is rate * g / (|g| + 1e-8): where
    |g| is far above 1e-8 it is the rate times g's sign, where |g| comes
    near 1e-8 float noise in g moves it by a part of the rate. So a weight
    whose reference gradient exceeds 1e-6 must match within 1e-5, and
    every weight within 2.1x the rate."""
    groups, names = corpus
    jcfg, jparams, jloss = jpre.train_mini(steps=1, batch=32, seed=2, log_every=0)
    jmodel, init = jtr.create_train_state(jcfg, jax.random.PRNGKey(2), seq_len=64)
    a, p = jpre.make_batch(groups, names, JTok(8192), random.Random(2), 32, 64)
    grads = params_from_jax(_np(jax.grad(lambda prm: jtr.info_nce_loss(
        jmodel.apply({"params": prm}, a), jmodel.apply({"params": prm}, p)))(init.params)))
    losses = []
    tcfg, state, tloss = tpre.train_mini(steps=1, batch=32, seed=2, log_every=0, device="cpu",
                                         params=params_from_jax(_np(init.params)),
                                         losses=losses)
    assert (tcfg.vocab_size, tcfg.hidden_size, tcfg.dtype) == (8192, 160, torch.float32)
    assert losses == [tloss] and abs(tloss - jloss) <= 1e-5
    for k, w in params_from_jax(_np(jparams)).items():
        diff = (w - state[k]).abs()
        assert diff.max() <= 2.1 * 3e-4, k
        clear = diff[grads[k].abs() > 1e-6]
        assert clear.numel() == 0 or clear.max() <= 1e-5, k


# -- the checkpoint writer ---------------------------------------------------------


def test_packb_is_flax_to_bytes():
    from flax import serialization

    cfg, params = jpre.load_checkpoint(jpre.default_checkpoint_path())
    half = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float16), params)
    assert tckpt.packb(half) == serialization.to_bytes(half)
    assert tckpt.unpackb(tckpt.packb({"a": [1, -300, 2.5, None, True, "x" * 40, b"y"]})) == \
        {"a": [1, -300, 2.5, None, True, "x" * 40, b"y"]}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_encoder_checkpoint(tmp_path, writer):
    path = str(tmp_path / "enc.npz")
    cj, ct = _tiny()
    if writer == "port":
        model = tenc.Encoder(ct, generator=torch.Generator().manual_seed(4))
        tpre.save_checkpoint(path, ct, model.state_dict())
        cfg, params = jpre.load_checkpoint(path)
        assert (cfg.vocab_size, cfg.hidden_size, cfg.num_heads) == (1024, 64, 4)
        want = {k: v.half().float() for k, v in model.state_dict().items()}
        got = params_from_jax(_np(params))
    else:
        _, state = jtr.create_train_state(cj, jax.random.PRNGKey(4))
        jpre.save_checkpoint(path, cj, state.params)
        cfg, got = tckpt.load_checkpoint(path)
        assert (cfg.vocab_size, cfg.hidden_size, cfg.num_heads) == (1024, 64, 4)
        want = params_from_jax(_np(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float16), state.params)))
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_params_to_jax_is_the_inverse():
    _, ct = _tiny()
    sd = tenc.Encoder(ct, generator=torch.Generator().manual_seed(1)).state_dict()
    tree = params_to_jax(sd, ct.num_heads)
    assert tree["layer_0"]["attn"]["query"]["kernel"].shape == (64, 4, 16)
    assert tree["layer_1"]["attn"]["out"]["kernel"].shape == (4, 16, 64)
    back = params_from_jax(tree)
    assert all(torch.equal(sd[k], back[k]) for k in sd)


# -- B2's head widths (C6) and the gradient guard ---------------------------------


def _attn(seed, b, s, h, dh):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), bool)
    mask[1, (s + 1) // 2:] = False
    return q, k, v, mask


@pytest.mark.parametrize("s", [1, 16, 33, 64, 130])
def test_flash_attention_at_dh_32_matches_jax(s):
    q, k, v, mask = _attn(s, 2, s, 12, 32)
    out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v, mask))).numpy()
    want = np.asarray(j_flash(*(jnp.asarray(x) for x in (q, k, v, mask)),
                              block_q=64, block_k=64, interpret=True))
    assert out.shape == q.shape
    np.testing.assert_allclose(out, want, rtol=0, atol=2e-5)


def test_head_widths_the_kernels_take():
    """C6: the JAX package answers any head width through its einsum
    path; the port's kernels are compiled for 16, 32, 40 and 64, and its
    wrapper refuses another width before any launch."""
    assert HEAD_DIMS == (16, 32, 40, 64)
    cfg = jenc.EncoderConfig(vocab_size=300, hidden_size=96, num_layers=1, num_heads=4,
                             mlp_dim=64, max_len=32)  # Dh 24
    ids = np.random.default_rng(0).integers(2, 300, (2, 12)).astype(np.int32)
    model = jenc.Encoder(cfg)
    vecs = np.asarray(model.apply(model.init(jax.random.PRNGKey(0), ids), ids))
    assert vecs.shape == (2, 96) and np.isfinite(vecs).all()
    q, k, v, mask = (torch.from_numpy(x) for x in _attn(1, 2, 12, 4, 24))
    with pytest.raises(ValueError, match="head dim 24"):
        check_kernel_args(q, k, v, mask)
    for dh in HEAD_DIMS:
        check_kernel_args(*(torch.from_numpy(x) for x in _attn(2, 2, 12, 4, dh)))


def test_the_kernel_path_refuses_a_gradient():
    q, k, v, mask = (torch.from_numpy(x) for x in _attn(3, 2, 16, 4, 40))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        check_kernel_args(q, k, v, mask)
    with torch.no_grad():
        check_kernel_args(q, k, v, mask)
    with torch.inference_mode():
        check_kernel_args(q.detach(), k, v, mask)


def test_minilm_width_encoder_matches_jax():
    """A 384-wide, 12-head encoder (Dh 32: MiniLM / bge-small) embeds in
    the port as in the reference (float32, weights carried across)."""
    kw = dict(vocab_size=2000, hidden_size=384, num_layers=2, num_heads=12, mlp_dim=512,
              max_len=64)
    cj = jenc.EncoderConfig(dtype=jnp.float32, **kw)
    ct = tenc.EncoderConfig(dtype=torch.float32, **kw)
    ids = np.random.default_rng(5).integers(2, 2000, (3, 20)).astype(np.int32)
    ids[2, 11:] = 0
    jm = jenc.Encoder(cj)
    params = jm.init(jax.random.PRNGKey(1), ids)["params"]
    want = np.asarray(jm.apply({"params": params}, ids))
    model = tenc.Encoder(ct)
    model.load_state_dict(params_from_jax(_np(params)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids.astype(np.int64))).numpy()
    assert np.abs(got - want).max() <= 1e-5
